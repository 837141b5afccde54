"""Multi-hull-type fast path: type-pair-segmented candidates through the
linear-SAT coefficient-matmul narrow phase.

The reference has no collision at all (SURVEY.md §0); the single-type
fast path's parity is pinned by tests/test_hullhull.py — here the
2-type scene (bevel-cube + octahedron hulls) must match the generic
vmapped hull-hull narrow phase through full engine steps.
"""

import numpy as np
import pytest

import jax

from physics_tpu.engine import prepare_contacts, rollout, step_with_metrics
from physics_tpu.scenes import mesh_rain_mixed, rain_config


def _cfgs(n):
    cfg_fast = rain_config(n)
    # generic path: same physics, vmapped per-pair hull manifolds
    cfg_gen = cfg_fast.replace(hull_fast=False)
    return cfg_fast, cfg_gen


def test_mixed_fast_path_engages():
    from physics_tpu.ops.narrowphase import hulls_fast_path

    state = mesh_rain_mixed(16)
    cfg_fast, cfg_gen = _cfgs(16)
    assert state.hulls.verts.shape[0] == 2
    assert hulls_fast_path(state, cfg_fast)
    assert not hulls_fast_path(state, cfg_gen)


@pytest.mark.slow
def test_mixed_hull_fast_matches_generic():
    """Full warm-started engine steps: the segmented fast path tracks
    the generic narrow phase on a contact-rich settling 2-type rain
    (same contact count; float-level state agreement — the paths differ
    only in contact order and f32 op placement)."""
    n = 16
    state = mesh_rain_mixed(n)
    cfg_fast, cfg_gen = _cfgs(n)
    sf = prepare_contacts(state, cfg_fast)
    sg = prepare_contacts(state, cfg_gen)
    stepj = jax.jit(step_with_metrics, static_argnums=1)
    for _ in range(6):
        sf, mf = stepj(sf, cfg_fast)
        sg, mg = stepj(sg, cfg_gen)
    assert int(mf["contact_count"]) > 0
    np.testing.assert_allclose(
        np.asarray(sf.pos), np.asarray(sg.pos), atol=2e-3)
    np.testing.assert_allclose(
        np.asarray(sf.vel), np.asarray(sg.vel), atol=1e-2)


@pytest.mark.slow
def test_mixed_rain_rollout_stable():
    """120 warm-started steps of the 2-type rain stay finite, above the
    ground, and overflow-free (per-segment prefilter caps counted)."""
    n = 24
    cfg, _ = _cfgs(n)
    state = prepare_contacts(mesh_rain_mixed(n), cfg)
    final, _ = rollout(state, cfg, num_steps=120)
    pos = np.asarray(final.pos)
    assert np.all(np.isfinite(pos))
    assert float(pos[:, 1].min()) > 0.0
    _, m = jax.jit(step_with_metrics, static_argnums=1)(final, cfg)
    assert int(m["contact_count"]) > 0
    assert int(m["contact_overflow"]) == 0
    assert int(m["prefilter_overflow"]) == 0
