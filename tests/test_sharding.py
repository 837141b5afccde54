"""Multi-device sharding tests on the fake 8-device CPU mesh (SURVEY.md §4.5)."""

import pytest

pytestmark = pytest.mark.slow
import numpy as np
import jax

from physics_tpu import SceneBuilder, SimConfig
from physics_tpu.engine import step
from physics_tpu.io.meshes import box_inertia
from physics_tpu.parallel.sharding import (
    env_sharded_step,
    hybrid_step,
    make_mesh,
    row_sharded_step,
    shard_envs,
)

CFG = SimConfig(
    compat=False, ground_plane=True, pair_collisions=True,
    dt=1.0 / 120.0, contact_iters=8,
)


def build_scene(seed=0, n=8):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(n):
        i = b.add_body(pos=rng.uniform(-2, 2, 3) + [0, 3, 0],
                       inertia=box_inertia((0.3,) * 3, 1.0))
        b.set_box(i, (0.3, 0.3, 0.3))
    b.fix_to_point(0, (0, 3, 0))
    b.ball_joint(1, 2, (0.3, 0, 0), (-0.3, 0, 0))
    return b.build(joint_capacity=8)


def test_row_sharded_matches_single_device():
    """Rows/pairs sharded over 8 devices ≈ single device (f32 psum-order
    noise only; tolerance covers a 10-step contact-rich horizon)."""
    state = build_scene()
    mesh = make_mesh([8], ["row"])
    rstep = row_sharded_step(CFG, mesh, "row")
    sstep = jax.jit(step, static_argnums=1)

    s_ref, s_sh = state, state
    for _ in range(10):
        s_ref = sstep(s_ref, CFG)
        s_sh = rstep(s_sh)
    err = float(np.max(np.abs(np.asarray(s_ref.pos) - np.asarray(s_sh.pos))))
    assert err < 5e-3, err
    assert np.all(np.isfinite(np.asarray(s_sh.pos)))


def test_env_sharded_batch():
    state = build_scene()
    mesh = make_mesh([8], ["env"])
    batched = jax.vmap(lambda _: state)(np.arange(16))  # 2 envs per device
    batched = shard_envs(batched, mesh)
    estep = env_sharded_step(CFG, mesh)
    out = batched
    for _ in range(5):
        out = estep(out)
    assert out.pos.shape == (16, 8, 3)
    assert np.all(np.isfinite(np.asarray(out.pos)))
    # env sharding preserved on the output
    assert out.pos.sharding.spec[0] == "env"


def test_env_shards_independent():
    """Each env must evolve exactly as it would unbatched."""
    state = build_scene(seed=3)
    mesh = make_mesh([8], ["env"])
    batched = jax.vmap(lambda _: state)(np.arange(8))
    batched = shard_envs(batched, mesh)
    estep = env_sharded_step(CFG, mesh)
    out = estep(batched)

    single = jax.jit(step, static_argnums=1)(state, CFG)
    for e in range(8):
        np.testing.assert_allclose(
            np.asarray(out.pos[e]), np.asarray(single.pos),
            rtol=1e-5, atol=1e-5,
        )


def test_hybrid_mesh_compiles_and_runs():
    state = build_scene(seed=1)
    mesh = make_mesh([4, 2], ["env", "row"])
    batched = jax.vmap(lambda _: state)(np.arange(4))
    hstep = hybrid_step(CFG, mesh)
    out = hstep(batched)
    assert out.pos.shape == (4, 8, 3)
    assert np.all(np.isfinite(np.asarray(out.pos)))


PILE_CFG = SimConfig(
    compat=False, ground_plane=True, pair_collisions=True,
    boxes_only=True, broadphase="sweep", sweep_window=8,
    pair_buckets=True, bucket_block=32, max_pair_candidates=2048,
    max_contacts_per_pair=4, max_contacts=2048,
    contact_iters=8, dt=1.0 / 120.0,
)


def _pile_256(seed=7):
    """256-box grid pile spanning many rank buckets, so the sharded solve
    is exercised on a scene that spans shards."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for k in range(256):
        x, z, layer = k % 16, (k // 16) % 4, k // 64
        pos = (np.array([x * 1.1, 0.55 + 1.1 * layer, z * 1.1])
               + rng.uniform(-0.05, 0.05, 3))
        i = b.add_body(pos=pos, inertia=box_inertia((0.5,) * 3, 1.0))
        b.set_box(i, (0.5, 0.5, 0.5), friction=0.5)
    return b.build()


def test_row_sharded_pile_matches_single_device():
    """Bucketed-sweep box pile with candidates and contacts split across 8
    devices (per-sweep impulse-delta psum) ≈ the single-device step. 256
    bodies so the rank space genuinely spans shards."""
    state = _pile_256()
    mesh = make_mesh([8], ["row"])
    rstep = row_sharded_step(PILE_CFG, mesh, "row")
    sstep = jax.jit(step, static_argnums=1)

    s_ref, s_sh = state, state
    for _ in range(3):
        s_ref = sstep(s_ref, PILE_CFG)
        s_sh = rstep(s_sh)
    err_p = float(np.max(np.abs(np.asarray(s_ref.pos) - np.asarray(s_sh.pos))))
    err_v = float(np.max(np.abs(np.asarray(s_ref.vel) - np.asarray(s_sh.vel))))
    assert np.all(np.isfinite(np.asarray(s_sh.pos)))
    assert err_p < 1e-3, (err_p, err_v)
    assert err_v < 5e-3, (err_p, err_v)
