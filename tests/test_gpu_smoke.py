"""Asserting GPU smoke test for the composed backend-gated subgraphs.

The boxes_only fast paths (`_pair_contacts_boxes`, `_ground_contacts_boxes`
in ops/narrowphase.py) are off on the CPU backend (narrowphase.boxes_fast_path)
because XLA:CPU handles their composed graph pathologically. Their composed
step therefore only runs on an accelerator. These tests assert (not just
print) on that composed graph: finiteness, zero overflow counters,
plausible contact counts, and bodies resting above the ground after a
drop+settle.

They carry the `gpu` marker and skip unless the backend is a GPU; the CPU
suite pins the same behaviour per op (tests/test_boxes_only_path.py).
"""

import numpy as np
import jax
import pytest

from physics_tpu.engine import prepare_contacts, rollout, step_with_metrics
from physics_tpu.io.meshes import box_inertia
from physics_tpu.scene import SceneBuilder
from physics_tpu.scenes import box_pile, pile_config

pytestmark = pytest.mark.gpu


def test_gpu_pile_drop_settle_asserts(gpu):
    """256-body pile through the production config (bucketed sweep +
    boxes_only fast paths + warm-started Jacobi solve): drop, settle,
    assert everything the bench only prints."""
    n = 256
    state = box_pile(n, seed=0)
    cfg = pile_config(n)
    state = prepare_contacts(state, cfg)
    stepm = jax.jit(step_with_metrics, static_argnums=1)
    m = None
    # 240 settle steps: at 120 the loose trench is still mid-avalanche
    # and the median-|v| bound below sits within the chaotic margin
    for _ in range(240):
        state, m = stepm(state, cfg)
    pos = np.asarray(state.pos)
    assert np.all(np.isfinite(pos)), "non-finite positions"
    assert np.all(np.isfinite(np.asarray(state.vel))), "non-finite velocity"
    assert int(m["pair_overflow"]) == 0
    assert int(m["contact_overflow"]) == 0
    # settled pile: everything above the ground plane, nothing launched
    assert pos[:, 1].min() > 0.2, pos[:, 1].min()
    assert pos[:, 1].max() < 30.0, pos[:, 1].max()
    # a settled 256-box pile carries hundreds of active contacts
    assert int(m["contact_count"]) > n // 2
    # the BULK of the pile must be quiescent. A hard max|v| bound is
    # flaky by construction: the loose trench pile keeps avalanching for
    # thousands of steps (individual boxes topple/launch at up to
    # ~7 m/s) — chaotic per-trajectory maxima are not a solver invariant.
    v = np.linalg.norm(np.asarray(state.vel), axis=1)
    assert float(np.median(v)) < 0.15, float(np.median(v))
    assert float(np.percentile(v, 90)) < 1.5, float(np.percentile(v, 90))
    assert float(m["max_penetration"]) < 0.4, float(m["max_penetration"])


def test_gpu_single_box_rest_height(gpu):
    """One box through the backend-gated composed graph rests at y = half
    extent — the direct-call CPU parity tests pin the op, this pins the
    composed dispatch."""
    b = SceneBuilder()
    i = b.add_body(pos=(0.0, 1.5, 0.0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5,) * 3, friction=0.5)
    cfg = pile_config(2).replace(max_contacts=128)
    state = prepare_contacts(b.build(), cfg)
    final, _ = rollout(state, cfg, num_steps=180)
    y = float(np.asarray(final.pos)[0, 1])
    assert abs(y - 0.5) < 0.02, y
    assert float(np.abs(np.asarray(final.vel)).max()) < 0.01
