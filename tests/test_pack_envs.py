"""Packed block-diagonal envs vs vmapped envs: same physics, one scene."""

import pytest

pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp
import numpy as np

from physics_tpu.config import SimConfig
from physics_tpu.engine import step
from physics_tpu.envs import pack_envs, stack_states, unpack_envs
from physics_tpu.scenes import random_env


def _batched(n_envs=4, n_bodies=4):
    base = random_env(0, n_bodies)
    rng = np.random.default_rng(1)
    offsets = jnp.asarray(
        rng.uniform(-1, 1, (n_envs, 1, 3)).astype(np.float32))
    return jax.vmap(lambda o: base.replace(pos=base.pos + o))(offsets)


def test_packed_matches_vmapped_jacobi():
    e, k = 4, 4
    batched = _batched(e, k)
    cfg_v = SimConfig(ground_plane=True, pair_collisions=True,
                      boxes_only=True, contact_iters=8)
    cfg_p = cfg_v.replace(broadphase="env_blocks", env_block_size=k)

    packed = pack_envs(batched)
    assert packed.pos.shape == (e * k, 3)

    sv, sp = batched, packed
    for _ in range(6):
        sv = jax.vmap(lambda s: step(s, cfg_v))(sv)
        sp = step(sp, cfg_p)
    np.testing.assert_allclose(
        np.asarray(sv.pos).reshape(e * k, 3), np.asarray(sp.pos), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(sv.vel).reshape(e * k, 3), np.asarray(sp.vel), atol=1e-3)

    up = unpack_envs(sp, e)
    np.testing.assert_allclose(
        np.asarray(up.pos), np.asarray(sp.pos).reshape(e, k, 3))


def test_packed_joints_match_vmapped():
    """Jointed scenes on the packed path (the reference's demo is jointed,
    src/lib.rs:20-42): per-env body-index offsets make the packed CG solve
    block-diagonal across envs — results match the vmapped per-env step."""
    from physics_tpu.io.meshes import box_inertia
    from physics_tpu.scene import SceneBuilder

    e, k = 3, 2
    b = SceneBuilder()
    i0 = b.add_body(pos=(1.0, 0.0, 0.0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.fix_to_point(i0, (0.0, 0.0, 0.0))
    i1 = b.add_body(pos=(1.0, 2.0, 0.0), inertia=box_inertia((0.3,) * 3, 1.0))
    b.ball_joint(i0, i1, anchor_a=(0, 1, 0), anchor_b=(0, -1, 0))
    base = b.build()
    assert base.joints.capacity > 0

    rng = np.random.default_rng(2)
    offs = jnp.asarray(rng.uniform(-0.1, 0.1, (e, 1, 3)).astype(np.float32))
    batched = jax.vmap(lambda o: base.replace(pos=base.pos + o))(offs)
    # joint world targets must shift with each env's offset
    pr = batched.joints.params
    batched = batched.replace(joints=batched.joints.replace(
        params=pr.at[:, 0, 0:3].add(offs[:, 0, :])))

    cfg = SimConfig(compat=False, dt=1.0 / 120.0)
    packed = pack_envs(batched)
    assert packed.joints.capacity == e * base.joints.capacity
    ba = np.asarray(packed.joints.body_a)
    live = np.asarray(packed.joints.jtype) != 0
    assert np.all(ba[live] < e * k)

    sv, sp = batched, packed
    for _ in range(8):
        sv = jax.vmap(lambda s: step(s, cfg))(sv)
        sp = step(sp, cfg)
    np.testing.assert_allclose(
        np.asarray(sv.pos).reshape(e * k, 3), np.asarray(sp.pos), atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(sv.vel).reshape(e * k, 3), np.asarray(sp.vel), atol=1e-3)


def test_packed_auto_reset():
    from physics_tpu.envs import auto_reset_step_packed, packed_env_ok

    e, k = 4, 4
    batched = _batched(e, k)
    cfg = SimConfig(ground_plane=True, pair_collisions=True,
                    boxes_only=True, contact_iters=4,
                    broadphase="env_blocks", env_block_size=k)
    packed = pack_envs(batched)
    stepped = auto_reset_step_packed(cfg, k)

    # poison env 2 with a diverged (huge but finite) velocity: it resets
    # pre-step (see auto_reset_step_packed docstring), others are untouched
    bad_vel = packed.vel.at[2 * k:3 * k].set(1e8)
    poisoned = packed.replace(vel=bad_vel)
    ok = packed_env_ok(poisoned, k)
    assert not bool(ok[2]) and bool(ok[0])
    out, m = stepped(poisoned, packed)
    assert int(m["resets"]) == 1
    assert np.all(np.isfinite(np.asarray(out.vel)))
    assert np.all(np.abs(np.asarray(out.vel)) < 1e3)
    # a healthy reference env is unaffected by env 2's divergence
    ref, _ = stepped(packed, packed)
    np.testing.assert_allclose(out.pos[:k], ref.pos[:k], atol=1e-6)

