"""Equality-constraint (joint) row generation and matrix-free operators.

Reference architecture (reference: src/physics/constraints.rs:67-169): each
constraint contributes ≤3 rows of C, J, J̇, ks, kd; rows are assembled into a
global block-sparse Jacobian over the 6N generalized coordinates, then
λ = CG-solve(J·W·Jᵀ, rhs) and the constraint force is Jᵀλ.

Accelerator-native redesign: there is **no sparse matrix**. Each joint slot stores
dense per-body 3×6 blocks (fixed capacity, masked), and the two matvecs the
CG solver needs are expressed as gathers + einsums + segment-sums:

    J  · x : gather x[body] per slot  → einsum over the 6-dof blocks
    Jᵀ · λ : einsum per slot → scatter-add back onto bodies

All four joint types are computed unconditionally for every slot and the
result is selected by type (compute-all-select beats lax.switch for such
small kernels; no divergent control flow).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from physics_tpu.maths import quaternion as quat
from physics_tpu.maths.linalg import skew
from physics_tpu.state import (
    JOINT_BALL,
    JOINT_DISTANCE,
    JOINT_FIX_ORIENTATION,
    JOINT_FIX_POINT,
    JOINT_NONE,
    MAX_JOINT_ROWS,
    SimState,
)

Array = jnp.ndarray


class JointRows(NamedTuple):
    """Dense, fixed-capacity constraint rows. R = J_slots × MAX_JOINT_ROWS."""

    c: Array        # [J, 3]   constraint values
    j_a: Array      # [J, 3, 6] Jacobian block for body_a
    j_b: Array      # [J, 3, 6] Jacobian block for body_b
    jd_a: Array     # [J, 3, 6] J̇ block for body_a
    jd_b: Array     # [J, 3, 6] J̇ block for body_b
    ks: Array       # [J, 3]
    kd: Array       # [J, 3]
    rowmask: Array  # [J, 3]  1.0 for live rows
    body_a: Array   # [J] int32 (clamped to valid range)
    body_b: Array   # [J] int32 (clamped; masked by has_b)
    has_b: Array    # [J] float32 1.0 if body_b participates


def _lin_block(m3: Array) -> Array:
    """[...,3,3] → [...,3,6] placing the 3×3 into the linear DOFs."""
    return jnp.concatenate([m3, jnp.zeros_like(m3)], axis=-1)


def _ang_block(m3: Array) -> Array:
    """[...,3,3] → [...,3,6] placing the 3×3 into the angular DOFs."""
    return jnp.concatenate([jnp.zeros_like(m3), m3], axis=-1)


def joint_rows(state: SimState) -> JointRows:
    """Generate constraint rows for every joint slot (vectorized over slots).

    FIX_POINT  (reference: fixed_position_constraint.rs:13-27):
        C = x_a − target, J = [I₃ | 0] on body a, J̇ = 0.
    FIX_ORIENTATION (reference: fixed_orientation_constraint.rs:15-30):
        C = euler(q_a) − target, J = [0 | I₃] on body a, J̇ = 0.
    BALL:  world anchors p_a = x_a + R_a r_a, p_b likewise;
        C = p_a − p_b, J_a = [I₃ | −skew(R_a r_a)], J_b = −[I₃ | −skew(R_b r_b)],
        J̇ from the rotating anchor arms.
    DISTANCE: C = ‖d‖ − L along unit n = d/‖d‖ (single row).
    """
    js = state.joints
    jn = js.capacity
    if jn == 0:
        z3 = jnp.zeros((0, 3), jnp.float32)
        z36 = jnp.zeros((0, 3, 6), jnp.float32)
        zi = jnp.zeros((0,), jnp.int32)
        zf = jnp.zeros((0,), jnp.float32)
        return JointRows(z3, z36, z36, z36, z36, z3, z3, z3, zi, zi, zf)

    n = state.num_bodies
    a_idx = jnp.clip(js.body_a, 0, n - 1)
    b_valid = js.body_b >= 0
    b_idx = jnp.clip(js.body_b, 0, n - 1)

    pos_a = state.pos[a_idx]        # [J,3]
    pos_b = state.pos[b_idx]
    quat_a = state.quat[a_idx]      # [J,4]
    quat_b = state.quat[b_idx]
    om_a = state.omega[a_idx]
    om_b = state.omega[b_idx]

    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (jn, 3, 3))
    zeros36 = jnp.zeros((jn, 3, 6), jnp.float32)

    # --- FIX_POINT ---
    c_fp = pos_a - js.params[:, 0:3]
    ja_fp = _lin_block(eye)

    # --- FIX_ORIENTATION ---
    c_fo = quat.to_euler(quat_a) - js.params[:, 0:3]
    ja_fo = _ang_block(eye)

    # --- BALL ---
    ra_w = quat.rotate(quat_a, js.params[:, 0:3])   # world anchor arm on a
    rb_w = quat.rotate(quat_b, js.params[:, 3:6])
    anchor_a = pos_a + ra_w
    anchor_b = pos_b + rb_w
    c_ball = anchor_a - anchor_b
    ja_ball = jnp.concatenate([eye, -skew(ra_w)], axis=-1)          # [J,3,6]
    jb_ball = jnp.concatenate([-eye, skew(rb_w)], axis=-1)
    jda_ball = _ang_block(-skew(jnp.cross(om_a, ra_w)))
    jdb_ball = _ang_block(skew(jnp.cross(om_b, rb_w)))

    # --- DISTANCE (1 live row) ---
    d = anchor_b - anchor_a
    dist = jnp.linalg.norm(d, axis=-1)
    safe = jnp.maximum(dist, 1e-9)
    ndir = d / safe[:, None]
    c_dist_row = dist - js.params[:, 6]
    c_dist = jnp.stack(
        [c_dist_row, jnp.zeros_like(c_dist_row), jnp.zeros_like(c_dist_row)],
        axis=-1,
    )
    ja_d_row = jnp.concatenate([-ndir, -jnp.cross(ra_w, ndir)], axis=-1)  # [J,6]
    jb_d_row = jnp.concatenate([ndir, jnp.cross(rb_w, ndir)], axis=-1)
    ja_dist = jnp.concatenate([ja_d_row[:, None, :], jnp.zeros((jn, 2, 6))], axis=1)
    jb_dist = jnp.concatenate([jb_d_row[:, None, :], jnp.zeros((jn, 2, 6))], axis=1)

    # --- select by type ---
    t = js.jtype[:, None]
    c = jnp.where(
        t == JOINT_FIX_POINT, c_fp,
        jnp.where(t == JOINT_FIX_ORIENTATION, c_fo,
                  jnp.where(t == JOINT_BALL, c_ball,
                            jnp.where(t == JOINT_DISTANCE, c_dist, 0.0))))

    t6 = js.jtype[:, None, None]
    j_a = jnp.where(
        t6 == JOINT_FIX_POINT, ja_fp,
        jnp.where(t6 == JOINT_FIX_ORIENTATION, ja_fo,
                  jnp.where(t6 == JOINT_BALL, ja_ball,
                            jnp.where(t6 == JOINT_DISTANCE, ja_dist, 0.0))))
    j_b = jnp.where(
        t6 == JOINT_BALL, jb_ball,
        jnp.where(t6 == JOINT_DISTANCE, jb_dist, 0.0))
    jd_a = jnp.where(t6 == JOINT_BALL, jda_ball, 0.0)
    jd_b = jnp.where(t6 == JOINT_BALL, jdb_ball, 0.0)

    nrows = jnp.where(
        js.jtype == JOINT_NONE, 0,
        jnp.where(js.jtype == JOINT_DISTANCE, 1, 3))
    rowmask = (
        jnp.arange(MAX_JOINT_ROWS, dtype=jnp.int32)[None, :] < nrows[:, None]
    ).astype(jnp.float32)

    has_b = (
        b_valid
        & ((js.jtype == JOINT_BALL) | (js.jtype == JOINT_DISTANCE))
    ).astype(jnp.float32)

    # Mask dead rows so they drop out of every matvec.
    c = c * rowmask
    j_a = j_a * rowmask[:, :, None]
    j_b = j_b * (rowmask * has_b[:, None])[:, :, None]
    jd_a = jd_a * rowmask[:, :, None]
    jd_b = jd_b * (rowmask * has_b[:, None])[:, :, None]

    ks = js.ks[:, None] * rowmask
    kd = js.kd[:, None] * rowmask

    return JointRows(
        c=c, j_a=j_a, j_b=j_b, jd_a=jd_a, jd_b=jd_b,
        ks=ks, kd=kd, rowmask=rowmask,
        body_a=a_idx, body_b=b_idx, has_b=has_b,
    )


def j_matvec(rows: JointRows, x: Array) -> Array:
    """y = J · x, x: [N, 6] generalized velocities/forces → y: [J*3].

    Replaces SparseMatrix::multiply_vector (reference: sparse_matrix.rs:25-37)
    with gather + einsum — no sparse structure, fixed shapes.
    """
    xa = x[rows.body_a]                      # [J, 6]
    xb = x[rows.body_b]
    y = jnp.einsum("jrk,jk->jr", rows.j_a, xa) + jnp.einsum(
        "jrk,jk->jr", rows.j_b, xb
    )
    return y.reshape(-1)


def jd_matvec(rows: JointRows, x: Array) -> Array:
    """y = J̇ · x (same layout as j_matvec)."""
    xa = x[rows.body_a]
    xb = x[rows.body_b]
    y = jnp.einsum("jrk,jk->jr", rows.jd_a, xa) + jnp.einsum(
        "jrk,jk->jr", rows.jd_b, xb
    )
    return y.reshape(-1)


def jt_matvec(rows: JointRows, lam: Array, num_bodies: int) -> Array:
    """out = Jᵀ · λ, λ: [J*3] → out: [N, 6].

    Replaces SparseMatrix::tr_multiply_vector (reference:
    sparse_matrix.rs:39-50) with einsum + scatter-add (segment sum).
    """
    lam_r = lam.reshape(-1, MAX_JOINT_ROWS)                    # [J, 3]
    fa = jnp.einsum("jrk,jr->jk", rows.j_a, lam_r)             # [J, 6]
    fb = jnp.einsum("jrk,jr->jk", rows.j_b, lam_r)
    out = jnp.zeros((num_bodies, 6), jnp.float32)
    out = out.at[rows.body_a].add(fa)
    out = out.at[rows.body_b].add(fb)
    return out
