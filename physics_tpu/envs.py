"""Batched environments: failure detection and auto-reset.

The reference's failure story is `unwrap()` panics (SURVEY.md §5); a batched
accelerator simulation can't crash one env without losing the other 4095. Instead,
divergence (NaN/Inf from explosive stacking or bad user forces) is detected
in-step per environment and the offending env is reset to its initial state
— RL-style — while a reset counter surfaces the event in metrics. Pure
function transformations; everything stays inside one jitted program.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig
from physics_tpu.engine import step as _step
from physics_tpu.state import SimState

Array = jnp.ndarray


def env_ok(state: SimState, max_abs: float = 1e6) -> Array:
    """Per-env health mask for a batched state ([E] bool).

    An env is healthy iff its dynamic fields are finite and bounded.
    For an unbatched state returns a scalar bool.
    """

    def field_ok(x: Array) -> Array:
        reduce_axes = tuple(range(1, x.ndim)) if x.ndim > 1 else ()
        finite = jnp.all(jnp.isfinite(x), axis=reduce_axes)
        bounded = jnp.all(jnp.abs(x) < max_abs, axis=reduce_axes)
        return finite & bounded

    return (
        field_ok(state.pos)
        & field_ok(state.vel)
        & field_ok(state.omega)
        & field_ok(state.quat)
    )


def where_env(mask: Array, a: SimState, b: SimState) -> SimState:
    """Per-env select: mask[e] ? a[e] : b[e] across every leaf."""

    def sel(la, lb):
        m = mask.reshape(mask.shape + (1,) * (la.ndim - mask.ndim))
        return jnp.where(m, la, lb)

    return jax.tree_util.tree_map(sel, a, b)


def auto_reset_step(
    cfg: SimConfig,
    step_fn: Callable[[SimState, SimConfig], SimState] = _step,
    max_abs: float = 1e6,
) -> Callable[[SimState, SimState], Tuple[SimState, Dict]]:
    """Build a vmapped batched step with per-env divergence auto-reset.

    Returns f(batched_state, initial_state) -> (batched_state, metrics):
    envs whose post-step state is non-finite/unbounded are replaced by their
    slice of `initial_state`; metrics['resets'] counts them this step.
    """

    def stepped(batched: SimState, initial: SimState):
        out = jax.vmap(lambda s: step_fn(s, cfg))(batched)
        ok = env_ok(out, max_abs)
        out = where_env(ok, out, initial)
        return out, {"resets": jnp.sum(jnp.logical_not(ok).astype(jnp.int32))}

    return stepped


def stack_states(state: SimState, n_envs: int) -> SimState:
    """Tile one scene into a batched [E, ...] state."""
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_envs,) + x.shape), state
    )


def packed_env_ok(state: SimState, env_size: int,
                  max_abs: float = 1e6) -> Array:
    """Per-env health mask ([E] bool) for a block-diagonal packed state."""
    k = env_size
    e = state.num_bodies // k

    def field_ok(x: Array) -> Array:
        xe = x.reshape((e, k) + x.shape[1:])
        axes = tuple(range(1, xe.ndim))
        return (jnp.all(jnp.isfinite(xe), axis=axes)
                & jnp.all(jnp.abs(xe) < max_abs, axis=axes))

    return (field_ok(state.pos) & field_ok(state.vel)
            & field_ok(state.omega) & field_ok(state.quat))


def auto_reset_step_packed(
    cfg: SimConfig,
    env_size: int,
    step_fn: Callable[[SimState, SimConfig], SimState] = _step,
    max_abs: float = 1e6,
) -> Callable[[SimState, SimState], Tuple[SimState, Dict]]:
    """Divergence auto-reset for the block-diagonal packed-env layout.

    Returns f(packed_state, packed_initial) -> (packed_state, metrics).
    The whole batch steps as ONE scene (see pack_envs); diverged envs'
    body slices are restored from `packed_initial`. Solver warm-start
    buffers are left as-is: their slots key to contact features, and keys
    of a reset env's contacts simply stop matching.

    The health check runs BEFORE the step (unlike the vmapped
    `auto_reset_step`): in packed mode every env shares one contact
    buffer (one depth compaction, one warm-start sort), so a diverged
    env is replaced before its values enter those shared operations.
    Divergence normally crosses the `max_abs` bound while still finite,
    so the pre-step reset catches it before NaNs can form.
    """
    k = env_size

    def stepped(packed: SimState, initial: SimState):
        ok = packed_env_ok(packed, k, max_abs)       # [E] pre-step health
        okb = jnp.repeat(ok, k)                      # [E·K] per-body mask

        def sel(la, lb):
            if (la.ndim >= 1 and la.shape[:1] == okb.shape
                    and la is not lb):
                m = okb.reshape(okb.shape + (1,) * (la.ndim - 1))
                return jnp.where(m, la, lb)
            return la

        body_fields = dict(
            pos=sel(packed.pos, initial.pos),
            quat=sel(packed.quat, initial.quat),
            vel=sel(packed.vel, initial.vel),
            omega=sel(packed.omega, initial.omega),
            force=sel(packed.force, initial.force),
            torque=sel(packed.torque, initial.torque),
        )
        out = step_fn(packed.replace(**body_fields), cfg)
        return out, {
            "resets": jnp.sum(jnp.logical_not(ok).astype(jnp.int32))
        }

    return stepped


def pack_envs(batched: SimState) -> SimState:
    """Flatten a vmapped [E, K, ...] state into ONE [E·K]-body scene.

    Block-diagonal packing: body id = e·K + k. With
    `broadphase='env_blocks'` (static per-env pair lists) the whole batch
    steps as one scene — no vmap, so cross-env ops that serialize under
    vmap (sorts, warm-start matching, compaction) run once at full width
    instead of E times. The physics is identical to the vmapped step: envs cannot
    interact (candidate pairs never cross env boundaries).

    Joints pack too (the reference's whole demo is jointed, src/lib.rs:20-42):
    each env's joint slots concatenate with their body indices offset by
    e·K, so the packed scene's ONE CG solve covers every env — J·W·Jᵀ is
    block-diagonal across envs (joints never cross env boundaries), so the
    math matches the vmapped per-env solves exactly; only the convergence
    test (max-residual over ALL envs' rows) and the shared iteration count
    differ, which can only make results more converged. Env-invariant
    leaves (hulls, step counter) are taken from env 0. Contact warm-start
    buffers are reset — call engine.prepare_contacts on the packed state;
    joint warm starts (`lam_joint`) pack slot-aligned.
    """
    e, k = batched.pos.shape[:2]

    def flat(a):
        return a.reshape((e * k,) + a.shape[2:])

    def take0(tree):
        return jax.tree_util.tree_map(lambda a: a[0], tree)

    jn = batched.joints.capacity
    if jn > 0:
        js = batched.joints
        off = (jnp.arange(e, dtype=jnp.int32) * k)[:, None]    # [E, 1]
        joints = js.replace(
            jtype=flat(js.jtype),
            body_a=flat(js.body_a + off),
            body_b=flat(jnp.where(js.body_b >= 0, js.body_b + off, -1)),
            params=flat(js.params),
            ks=flat(js.ks),
            kd=flat(js.kd),
        )
        lam_joint = batched.lam_joint.reshape(-1)   # [E·J·MAX_ROWS]
    else:
        joints = take0(batched.joints)
        lam_joint = batched.lam_joint[0]

    return batched.replace(
        pos=flat(batched.pos), quat=flat(batched.quat),
        vel=flat(batched.vel), omega=flat(batched.omega),
        force=flat(batched.force), torque=flat(batched.torque),
        mass=flat(batched.mass), inv_mass=flat(batched.inv_mass),
        inertia=flat(batched.inertia), inv_inertia=flat(batched.inv_inertia),
        joints=joints, lam_joint=lam_joint,
        shapes=jax.tree_util.tree_map(flat, batched.shapes),
        hulls=take0(batched.hulls),
        contact_key=jnp.zeros((0,), jnp.int32),
        contact_lam=jnp.zeros((3, 0), jnp.float32),
        step_count=batched.step_count[0],
    )


def unpack_envs(state: SimState, n_envs: int) -> SimState:
    """Inverse of `pack_envs` for the per-body fields ([E·K] → [E, K])."""
    e = n_envs
    k = state.num_bodies // e

    def unflat(a):
        return a.reshape((e, k) + a.shape[1:])

    def tile(tree):
        return jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (e,) + a.shape), tree
        )

    return state.replace(
        pos=unflat(state.pos), quat=unflat(state.quat),
        vel=unflat(state.vel), omega=unflat(state.omega),
        force=unflat(state.force), torque=unflat(state.torque),
        mass=unflat(state.mass), inv_mass=unflat(state.inv_mass),
        inertia=unflat(state.inertia), inv_inertia=unflat(state.inv_inertia),
        joints=tile(state.joints),
        lam_joint=jnp.broadcast_to(
            state.lam_joint, (e,) + state.lam_joint.shape),
        shapes=jax.tree_util.tree_map(unflat, state.shapes),
        hulls=tile(state.hulls),
        contact_key=jnp.zeros((e, 0), jnp.int32),
        contact_lam=jnp.zeros((e, 3, 0), jnp.float32),
        step_count=jnp.broadcast_to(state.step_count, (e,)),
    )


def randomize_positions(
    batched: SimState, key: Array, scale: float = 0.5
) -> SimState:
    """Jitter every env's body positions (same scene, different starts)."""
    noise = jax.random.uniform(
        key, batched.pos.shape, minval=-scale, maxval=scale
    )
    return batched.replace(pos=batched.pos + noise)
