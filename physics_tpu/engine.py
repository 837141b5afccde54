"""The simulation step — one pure, jittable function `step(state, cfg)`.

Equivalent of the reference's per-frame physics stack (SURVEY.md §3.2,
reference: src/physics.rs:41-55):

    update(dt):
        apply_gravity()                                  physics.rs:42
        λ, Jᵀλ = constraint_solver.solve_constraints()   physics.rs:43
        force/torque += Jᵀλ  (if CG converged)           physics.rs:45-51
        step(dt)  — semi-implicit Euler                  physics.rs:54

plus the new contact pipeline (broad phase → narrow phase → velocity-level
impulse solve) inserted between the velocity and position integration
phases. Everything is one XLA program; `rollout` wraps it in `lax.scan` so
long horizons never sync to host (SURVEY.md §3.5).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig
from physics_tpu.ops.forces import apply_gravity
from physics_tpu.ops.integrator import integrate_positions, integrate_velocities
from physics_tpu.solver import cg
from physics_tpu.solver.contacts import resolve_contacts
from physics_tpu.solver.joints import j_matvec, jd_matvec, joint_rows, jt_matvec
from physics_tpu.state import SimState

Array = jnp.ndarray


def _w_apply(state: SimState, cfg: SimConfig, x: Array) -> Array:
    """Apply the inverse generalized mass matrix W to x [N, 6].

    compat (quirk Q3, reference constraints.rs:72-78): W = diag(1/m) on all
    six DOFs of each body — angular DOFs use inverse *mass*, not inertia.
    non-compat: linear DOFs scale by inv_mass, angular DOFs by the
    world-frame inverse inertia tensor (statics get exactly zero).
    """
    if cfg.compat:
        inv_m = 1.0 / state.mass
        return x * inv_m[:, None]
    from physics_tpu.maths import quaternion as quat

    lin = x[:, :3] * state.inv_mass[:, None]
    rot = quat.to_matrix(state.quat)
    inv_inertia_w = jnp.einsum("nij,njk,nlk->nil", rot, state.inv_inertia, rot)
    ang = jnp.einsum("nij,nj->ni", inv_inertia_w, x[:, 3:])
    return jnp.concatenate([lin, ang], axis=-1)


def solve_joints(
    state: SimState,
    cfg: SimConfig,
    shard: Tuple[str, int] | None = None,
) -> Tuple[SimState, Dict]:
    """Assemble joint rows, CG-solve J·W·Jᵀ·λ = rhs, apply Jᵀλ as forces.

    rhs formula, exact term order (reference constraints.rs:153-160):
        rhs = −J̇q̇ − J·(W∘F_ext) − ks∘C − kd∘(J q̇)

    `shard=(axis_name, n_shards)` (inside shard_map, body state replicated)
    row-shards the joint table across the mesh axis: each device assembles
    and iterates its row block; Jᵀ products and CG scalars are psum'd.
    """
    jn = state.joints.capacity
    if jn == 0:
        return state, {
            "cg_iters": jnp.int32(0),
            "cg_converged": jnp.bool_(True),
        }

    n = state.num_bodies
    axis_name = shard[0] if shard else None

    if shard:
        from physics_tpu.solver.contacts import _chunk
        from physics_tpu.state import MAX_JOINT_ROWS, Joints

        joints_local = Joints(*[
            _chunk(getattr(state.joints, f), *shard)
            for f in ("jtype", "body_a", "body_b", "params", "ks", "kd")
        ])
        rows = joint_rows(state.replace(joints=joints_local))
        # warm start chunked per joint SLOT so it aligns with the padded
        # joint chunks ([J,3] row-major layout)
        lam0 = _chunk(
            state.lam_joint.reshape(jn, MAX_JOINT_ROWS), *shard
        ).reshape(-1)
    else:
        rows = joint_rows(state)
        lam0 = state.lam_joint

    q_dot = jnp.concatenate([state.vel, state.omega], axis=-1)        # [N,6]
    f_ext = jnp.concatenate([state.force, state.torque], axis=-1)     # [N,6]

    def jt_full(lam: Array) -> Array:
        out = jt_matvec(rows, lam, n)
        return jax.lax.psum(out, axis_name) if axis_name else out

    jd_qd = -jd_matvec(rows, q_dot)
    c_dot = j_matvec(rows, q_dot)
    ks_c = (rows.ks * rows.c).reshape(-1)
    kd_cdot = rows.kd.reshape(-1) * c_dot
    rhs = jd_qd - j_matvec(rows, _w_apply(state, cfg, f_ext)) - ks_c - kd_cdot

    def operator(lam: Array) -> Array:
        return j_matvec(rows, _w_apply(state, cfg, jt_full(lam)))

    lam, converged, iters = cg.solve(
        operator,
        rhs,
        lam0,
        max_iters=cfg.cg_max_iters,
        rel_tol=cfg.cg_rel_tol,
        abs_tol=cfg.cg_abs_tol,
        axis_name=axis_name,
    )

    # Q7: on non-convergence apply no force and keep the stale warm start
    # (reference physics.rs:45-51, sle_solver.rs:45).
    if shard:
        # reassemble the full warm start from the slot-aligned shards
        n_sh = shard[1]
        jn_pad = -(-jn // n_sh) * n_sh
        size = lam.shape[0]
        idx = jax.lax.axis_index(axis_name)
        lam_full = jax.lax.psum(
            jax.lax.dynamic_update_slice_in_dim(
                jnp.zeros((jn_pad * MAX_JOINT_ROWS,), jnp.float32),
                lam, idx * size, 0,
            ),
            axis_name,
        )[: jn * MAX_JOINT_ROWS]
        lam_warm = jnp.where(converged, lam_full, state.lam_joint)
    else:
        lam_warm = jnp.where(converged, lam, state.lam_joint)
    gain = jnp.where(converged, 1.0, 0.0).astype(jnp.float32)

    jtl = jt_full(lam)                                                # [N,6]
    if cfg.compat:
        # Quirk Q1 (reference physics.rs:47-50): the 6N-vector Jᵀλ is
        # iterated as a single column, so only entity 0 ever receives
        # constraint force.
        only0 = (jnp.arange(n) == 0).astype(jnp.float32)[:, None]
        jtl = jtl * only0

    state = state.replace(
        force=state.force + gain * jtl[:, :3],
        torque=state.torque + gain * jtl[:, 3:],
        lam_joint=lam_warm,
    )
    return state, {"cg_iters": iters, "cg_converged": converged}


def step_with_metrics(
    state: SimState,
    cfg: SimConfig,
    shard: Tuple[str, int] | None = None,
) -> Tuple[SimState, Dict]:
    """One simulation step; returns (new_state, metrics dict).

    Metrics are device values computed in-step (SURVEY.md §5 observability
    plan) — fetch them at your own sampling rate.

    `shard=(axis_name, n_shards)`: run inside shard_map with body state
    replicated; constraint rows and contact pairs are sharded across the
    mesh axis (see solve_joints / resolve_contacts).

    Every float32 contraction of the step is traced at full float32
    precision: the step's contractions are small geometric products
    (rotations, SAT supports, one-hot selections) of world coordinates,
    where a reduced-precision matmul mode (TF32 on a GPU) would cost
    ~1e-3 relative — centimetres at the coordinates of a large pile,
    more than a contact depth — and buy no speed at these widths.
    """
    with jax.default_matmul_precision("highest"):
        with jax.named_scope("forces"):
            state = apply_gravity(state, cfg)
        with jax.named_scope("joints"):
            state, joint_metrics = solve_joints(state, cfg, shard=shard)
        with jax.named_scope("integrate_vel"):
            state = integrate_velocities(state, cfg)
        contact_metrics: Dict = {}
        if cfg.ground_plane or cfg.pair_collisions:
            with jax.named_scope("contacts"):
                state, contact_metrics = resolve_contacts(
                    state, cfg, shard=shard)
        with jax.named_scope("integrate_pos"):
            state = integrate_positions(state, cfg)
    return state, {**joint_metrics, **contact_metrics}


def step(state: SimState, cfg: SimConfig) -> SimState:
    """One simulation step (reference PhysicsState::update, physics.rs:41-55)."""
    return step_with_metrics(state, cfg)[0]


def prepare_contacts(state: SimState, cfg: SimConfig) -> SimState:
    """Allocate the contact warm-start buffers for this config.

    Warm starting (impulse caching across steps) activates only when the
    state's `contact_key`/`contact_lam` buffers match the step's contact
    capacity; this sizes them via eval_shape. Optional — without it the
    solver starts each step from zero impulses.
    """
    # the hull fast path (hullhull_batched linear-SAT matmuls) covers a
    # small hull-type library via type-pair-segmented candidates, but
    # needs the OBB prefilter for the segmentation and caps the library
    # at MAX_FAST_HULL_TYPES (H² coefficient-table sets); scenes outside
    # that stay correct on the generic ops/hullhull.py path but run an
    # order of magnitude slower — be loud about losing the fast path
    if cfg.hulls_only and cfg.hull_fast:
        from physics_tpu.ops.narrowphase import (
            MAX_FAST_HULL_TYPES,
            hulls_fast_path,
        )

        n_hulls = state.hulls.verts.shape[0]
        if n_hulls > 1 and not hulls_fast_path(state, cfg):
            import warnings

            why = (f"more than {MAX_FAST_HULL_TYPES} hull types"
                   if n_hulls > MAX_FAST_HULL_TYPES else
                   "cfg.hull_prefilter_cap is 0 (the prefilter performs "
                   "the type-pair segmentation)")
            warnings.warn(
                f"scene registers {n_hulls} distinct hull shapes but "
                f"{why}: falling back to the generic hull-hull narrow "
                "phase (~10x slower). Set hull_prefilter_cap > 0 and "
                f"keep the library ≤ {MAX_FAST_HULL_TYPES} types for "
                "the segmented fast path.",
                stacklevel=2,
            )

    from physics_tpu.solver.contacts import contact_capacity

    c = contact_capacity(state, cfg)
    return state.replace(
        contact_key=jnp.zeros((c,), jnp.int32),
        contact_lam=jnp.zeros((3, c), jnp.float32),
    )


@partial(jax.jit, static_argnames=("cfg", "num_steps", "sample_every"))
def rollout(
    state: SimState, cfg: SimConfig, num_steps: int, sample_every: int = 0
):
    """Run `num_steps` entirely on device via lax.scan.

    Replaces the reference's host-driven frame loop (lib.rs:55-68) — no
    host↔device sync inside the horizon. If `sample_every` > 0, returns
    (final_state, (pos, quat) trajectory sampled every `sample_every` steps);
    otherwise returns (final_state, None).
    """
    if sample_every > 0:
        assert num_steps % sample_every == 0

        def outer(s, _):
            def inner(s2, _):
                return step(s2, cfg), None

            s, _ = jax.lax.scan(inner, s, None, length=sample_every)
            return s, (s.pos, s.quat)

        final, traj = jax.lax.scan(
            outer, state, None, length=num_steps // sample_every
        )
        return final, traj

    def body(s, _):
        return step(s, cfg), None

    final, _ = jax.lax.scan(body, state, None, length=num_steps)
    return final, None
