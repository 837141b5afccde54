"""Semi-implicit (symplectic) Euler integrator, vectorized over bodies.

Reference semantics (reference: src/physics/rigid_body.rs:24-40):
    v += (F / m) · dt                 # velocity first …
    x += v · dt                       # … then position (symplectic)
    ω += I⁻¹ · (τ · dt)               # body-frame I, re-inverted each step (Q4)
    if ω ≠ 0 (exact):                 # zero gate (Q6)
        dq = exp( ω̂ · sin(|ω|·dt / 2) )   # sin(θ/2) rotation-vector quirk (Q2)
        q = dq ⊗ q
    F = 0; τ = 0

compat=True reproduces Q2/Q4/Q6 bit-for-bit (division by mass rather than
multiplication by a stored inverse, body-frame inertia inverted per step via
the same adjugate formula, the sin(θ/2) step, no renormalization).

compat=False is the corrected integrator: precomputed inv_mass /
inv_inertia (statics = 0), world-frame inertia I_w⁻¹ = R·I_b⁻¹·Rᵀ, true
exponential-map rotation dq = exp(ω·dt), optional explicit gyroscopic term,
and quaternion renormalization.

The integrator is split into a velocity phase and a position phase so the
contact solver (velocity-level impulses) can run between them; the two
phases compose to the exact reference op order when contacts are disabled.
"""

from __future__ import annotations

import jax.numpy as jnp

from physics_tpu.config import SimConfig
from physics_tpu.maths import quaternion as quat
from physics_tpu.maths.linalg import inv3x3
from physics_tpu.state import SimState

Array = jnp.ndarray


def integrate_velocities(state: SimState, cfg: SimConfig) -> SimState:
    dt = jnp.float32(cfg.dt)
    if cfg.compat:
        # (F / m) * dt — order matters for bit parity (rigid_body.rs:27)
        vel = state.vel + state.force / state.mass[:, None] * dt
        # ω += I⁻¹ (τ·dt), body-frame I inverted each step (rigid_body.rs:30-31)
        ang_mom = state.torque * dt
        omega = state.omega + jnp.einsum(
            "nij,nj->ni", inv3x3(state.inertia), ang_mom
        )
    else:
        vel = state.vel + state.force * (state.inv_mass[:, None] * dt)
        rot = quat.to_matrix(state.quat)

        def mv(m, v):
            # [N,3,3]·[N,3] as broadcast mul+sum: tiny batched 3×3
            # matmuls lower to poor code, while the matvec chain
            # R·(I⁻¹·(Rᵀ·τ)) is pure elementwise work
            return jnp.sum(m * v[:, None, :], axis=-1)

        def mtv(m, v):
            return jnp.sum(m * v[:, :, None], axis=-2)

        torque = state.torque
        if cfg.gyroscopic:
            l_w = mv(rot, mv(state.inertia, mtv(rot, state.omega)))
            torque = torque - jnp.cross(state.omega, l_w)
        omega = state.omega + mv(
            rot, mv(state.inv_inertia, mtv(rot, torque * dt)))
        if cfg.max_velocity > 0.0:
            vel = jnp.clip(vel, -cfg.max_velocity, cfg.max_velocity)
            omega = jnp.clip(omega, -cfg.max_velocity, cfg.max_velocity)
    return state.replace(vel=vel, omega=omega)


def integrate_positions(state: SimState, cfg: SimConfig) -> SimState:
    dt = jnp.float32(cfg.dt)
    pos = state.pos + state.vel * dt

    if cfg.compat:
        # Quirk Q2: rotation vector ω̂ · sin(θ/2) with θ = |ω|·dt
        # (rigid_body.rs:32-37), gated on ω ≠ exact zero (Q6).
        nonzero = jnp.any(state.omega != 0.0, axis=-1)
        norm = jnp.linalg.norm(state.omega, axis=-1)
        safe_norm = jnp.where(nonzero, norm, 1.0)
        axis = state.omega / safe_norm[:, None]
        theta = norm * dt
        rotvec = axis * jnp.sin(theta * 0.5)[:, None]
        dq = quat.exp_map(rotvec)
        q_new = quat.mul(dq, state.quat)
        q = jnp.where(nonzero[:, None], q_new, state.quat)
    else:
        dq = quat.exp_map(state.omega * dt)
        q = quat.mul(dq, state.quat)
        if cfg.renormalize_quat:
            q = quat.normalize(q)

    return state.replace(
        pos=pos,
        quat=q,
        force=jnp.zeros_like(state.force),
        torque=jnp.zeros_like(state.torque),
        step_count=state.step_count + 1,
    )


def integrate(state: SimState, cfg: SimConfig) -> SimState:
    """Full reference step order (velocities then positions then clear)."""
    return integrate_positions(integrate_velocities(state, cfg), cfg)
