"""Box-box narrow phase: SAT with reference-face clipping (ODE dBoxBox style).

Vertex-face testing alone degenerates for the framework's headline configs
(identical-footprint box stacks: every corner of the upper box lies exactly ON
the lateral face planes of the lower box, so the max-plane signed distance
reports zero depth on a sideways normal). The robust classic is:

  1. SAT over 15 axes (6 face axes, 9 edge-cross axes, with ODE's fudge
     factor biasing face axes to avoid edge-axis jitter),
  2. face case → clip the incident face (4 corners) of the other box against
     the reference face's side planes (Sutherland–Hodgman), keeping
     penetration depth as an interpolated coordinate → up to 8 points,
  3. edge case → closest points of the two witness edges → 1 point.

Everything below is branchless fixed-shape jnp on ONE pair; the narrow phase
vmaps it over all broad-phase candidates. Polygon capacity is 8 (a convex
quad clipped by 4 half-planes has ≤ 8 vertices).

Returned normal points from box B toward box A (the framework's contact
convention, see physics_tpu.ops.narrowphase.Contacts).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray

_CAP = 8          # max manifold points
_FUDGE = 1.05     # ODE face-over-edge preference factor
_PARALLEL_EPS = 1e-6


def _clip_polygon(pts: Array, m: Array, plane: Array) -> Tuple[Array, Array]:
    """Clip an ordered convex polygon against one half-plane.

    pts: [CAP, 3] rows (u, v, sep) — 2D face coords + interpolated separation.
    m:   scalar int32 vertex count (first m rows valid).
    plane: [3] (c_u, c_v, d) keeping points with c_u·u + c_v·v ≤ d.
    Returns (new_pts, new_m).

    The cyclic-neighbor gather and the ordered emission are expressed as
    one-hot einsums, NOT jnp gathers/scatters: this kernel is vmapped over
    every candidate pair in the scene, where batched dynamic scatters
    lower to far slower code than the equivalent tiny contraction.

    Capacity is taken from pts.shape[0] (box-box uses 8; the hull-hull
    narrow phase clips larger polygons).
    """
    cap = pts.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    safe_m = jnp.maximum(m, 1)
    cur_oh = jax.nn.one_hot(idx % safe_m, cap, dtype=pts.dtype)
    nxt_oh = jax.nn.one_hot((idx + 1) % safe_m, cap, dtype=pts.dtype)
    cur = cur_oh @ pts
    nxt = nxt_oh @ pts

    g_cur = plane[0] * cur[:, 0] + plane[1] * cur[:, 1] - plane[2]
    g_nxt = plane[0] * nxt[:, 0] + plane[1] * nxt[:, 1] - plane[2]
    live = idx < m
    inside_cur = (g_cur <= 0.0) & live
    crossing = ((g_cur <= 0.0) != (g_nxt <= 0.0)) & live

    denom = g_cur - g_nxt
    t = jnp.where(jnp.abs(denom) > 1e-12, g_cur / denom, 0.0)
    p_int = cur + t[:, None] * (nxt - cur)

    emit = inside_cur.astype(jnp.int32) + crossing.astype(jnp.int32)
    start = jnp.cumsum(emit) - emit               # exclusive prefix sum
    pos_cur = jnp.where(inside_cur, start, cap)  # cap → one_hot = zeros
    pos_int = jnp.where(
        crossing, start + inside_cur.astype(jnp.int32), cap
    )

    # ordered emission as transposed one-hot matmuls (out-of-range rows
    # vanish: one_hot(cap, cap) == 0)
    out = jnp.einsum(
        "io,ic->oc", jax.nn.one_hot(pos_cur, cap, dtype=pts.dtype), cur
    ) + jnp.einsum(
        "io,ic->oc", jax.nn.one_hot(pos_int, cap, dtype=pts.dtype), p_int
    )
    return out, jnp.minimum(jnp.sum(emit), cap)


def box_box_manifold(
    pos_a: Array, rot_a: Array, half_a: Array,
    pos_b: Array, rot_b: Array, half_b: Array,
) -> Tuple[Array, Array, Array, Array]:
    """SAT + clipping contact manifold for one box pair.

    rot_*: [3,3] world rotation matrices; half_*: [3] half extents.
    Returns (points [8,3] world, normal [8,3] world B→A, depth [8],
    valid [8] bool). All-invalid when separated.
    """
    t_w = pos_b - pos_a
    u = rot_a.T   # u[k] = A's axis k in world
    v = rot_b.T

    # ---- 15 candidate axes (world, unnormalized for edges) ----
    # face axes of A (0..2), of B (3..5)
    axes_face = jnp.concatenate([u, v], axis=0)                      # [6,3]
    # edge cross axes (6..14), order (i,j) row-major
    cross_axes = jnp.reshape(
        jnp.cross(u[:, None, :], v[None, :, :]), (9, 3)
    )
    cross_norm = jnp.linalg.norm(cross_axes, axis=-1)
    cross_ok = cross_norm > _PARALLEL_EPS
    cross_unit = cross_axes / jnp.maximum(cross_norm, _PARALLEL_EPS)[:, None]

    axes = jnp.concatenate([axes_face, cross_unit], axis=0)          # [15,3]

    proj_a = jnp.sum(half_a[None, :] * jnp.abs(axes @ u.T), axis=-1)  # [15]
    proj_b = jnp.sum(half_b[None, :] * jnp.abs(axes @ v.T), axis=-1)
    dist = axes @ t_w                                                # [15]
    sep = jnp.abs(dist) - (proj_a + proj_b)
    sep = jnp.where(
        jnp.concatenate([jnp.ones(6, bool), cross_ok]), sep, -jnp.inf
    )

    separated = jnp.max(sep) > 0.0

    face_sep = sep[:6]
    edge_sep = sep[6:]
    best_face = jnp.argmax(face_sep)
    best_edge = jnp.argmax(edge_sep)
    # One-hot selection throughout this kernel: it is vmapped over every
    # candidate pair, where batched dynamic-index gathers lower to slower
    # code than the equivalent tiny one-hot contraction.
    oh_face = jax.nn.one_hot(best_face, 6, dtype=jnp.float32)
    oh_edge = jax.nn.one_hot(best_edge, 9, dtype=jnp.float32)
    best_face_sep = oh_face @ face_sep
    best_edge_sep = jnp.where(
        jnp.isfinite(edge_sep), edge_sep, 0.0
    ) @ oh_edge + jnp.where(jnp.any(jnp.isfinite(edge_sep)), 0.0, -jnp.inf)
    # ODE fudge: the EDGE separation (negative when overlapping) is scaled by
    # 1.05, so an edge axis only wins when decisively better than every face
    # axis — ties (e.g. axis-aligned stacks, where cross axes duplicate face
    # axes) resolve to the face manifold.
    use_edge = best_edge_sep * _FUDGE > best_face_sep

    # normal pointing A → B along the winning axis
    axis_f = oh_face @ axes[:6]
    dist_f = oh_face @ dist[:6]
    n_face = axis_f * jnp.sign(dist_f + 1e-30)
    axis_e = oh_edge @ axes[6:]
    dist_e = oh_edge @ dist[6:]
    n_edge = axis_e * jnp.sign(dist_e + 1e-30)

    # ---------------- face-contact manifold ----------------
    ref_is_a = best_face < 3
    ref_axis = jnp.where(ref_is_a, best_face, best_face - 3)
    # reference geometry (select A or B wholesale)
    ref_rot = jnp.where(ref_is_a, u, v)          # [3,3] rows = axes
    inc_rot = jnp.where(ref_is_a, v, u)
    ref_half = jnp.where(ref_is_a, half_a, half_b)
    inc_half = jnp.where(ref_is_a, half_b, half_a)
    ref_pos = jnp.where(ref_is_a, pos_a, pos_b)
    inc_pos = jnp.where(ref_is_a, pos_b, pos_a)
    # ref face normal: points from ref box toward the incident box
    ref_n = jnp.where(ref_is_a, n_face, -n_face)

    # ref face frame: axis indices (p, q) = the other two, via a static
    # lookup table contracted with a one-hot (no dynamic gathers)
    pq_table = jnp.array([[1, 2], [0, 2], [0, 1]], jnp.int32)
    oh_axis = jax.nn.one_hot(ref_axis, 3, dtype=jnp.float32)
    pq = jnp.einsum("a,ak->k", oh_axis, pq_table.astype(jnp.float32))
    oh_p = jax.nn.one_hot(pq[0].astype(jnp.int32), 3, dtype=jnp.float32)
    oh_q = jax.nn.one_hot(pq[1].astype(jnp.int32), 3, dtype=jnp.float32)
    u_p = oh_p @ ref_rot
    u_q = oh_q @ ref_rot
    h_p = oh_p @ ref_half
    h_q = oh_q @ ref_half
    c_ref = ref_pos + ref_n * (oh_axis @ ref_half)

    # incident face: the inc-box face most anti-parallel to ref_n
    align = inc_rot @ ref_n                      # [3] = v_k · n
    inc_axis = jnp.argmax(jnp.abs(align))
    oh_inc = jax.nn.one_hot(inc_axis, 3, dtype=jnp.float32)
    inc_sign = -jnp.sign((oh_inc @ align) + 1e-30)
    inc_n_axis = oh_inc @ inc_rot
    c_inc = inc_pos + inc_sign * (oh_inc @ inc_half) * inc_n_axis
    iq = jnp.einsum("a,ak->k", oh_inc, pq_table.astype(jnp.float32))
    oh_ip = jax.nn.one_hot(iq[0].astype(jnp.int32), 3, dtype=jnp.float32)
    oh_iq = jax.nn.one_hot(iq[1].astype(jnp.int32), 3, dtype=jnp.float32)
    w_p = (oh_ip @ inc_rot) * (oh_ip @ inc_half)
    w_q = (oh_iq @ inc_rot) * (oh_iq @ inc_half)

    signs = jnp.array(
        [[1.0, 1.0], [1.0, -1.0], [-1.0, -1.0], [-1.0, 1.0]], jnp.float32
    )
    corners = (
        c_inc[None, :]
        + signs[:, 0:1] * w_p[None, :]
        + signs[:, 1:2] * w_q[None, :]
    )                                             # [4,3] ordered quad

    rel = corners - c_ref[None, :]
    poly = jnp.zeros((_CAP, 3), jnp.float32)
    poly = poly.at[:4].set(
        jnp.stack(
            [rel @ u_p, rel @ u_q, rel @ ref_n], axis=-1
        )  # (u, v, separation): separation ≤ 0 where penetrating
    )
    m = jnp.int32(4)

    planes = jnp.array(
        [[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]],
        jnp.float32,
    )
    plane_d = jnp.stack([h_p, h_p, h_q, h_q])
    for k in range(4):
        plane = jnp.concatenate([planes[k, :2], plane_d[k][None]])
        poly, m = _clip_polygon(poly, m, plane)

    slot = jnp.arange(_CAP)
    face_depth = -poly[:, 2]
    face_valid = (slot < m) & (face_depth > 0.0)
    face_points = (
        c_ref[None, :]
        + poly[:, 0:1] * u_p[None, :]
        + poly[:, 1:2] * u_q[None, :]
        + poly[:, 2:3] * ref_n[None, :]          # on the incident face
    )

    # ---------------- edge-contact point ----------------
    ei = best_edge // 3
    ej = best_edge % 3
    oh_ei = jax.nn.one_hot(ei, 3, dtype=jnp.float32)
    oh_ej = jax.nn.one_hot(ej, 3, dtype=jnp.float32)
    ua = oh_ei @ u
    vb = oh_ej @ v
    # witness edge centers: walk to the corner-edge facing the other box
    sign_a = jnp.sign(u @ n_edge + 1e-30)
    sign_b = jnp.sign(v @ (-n_edge) + 1e-30)
    mask_a = 1.0 - oh_ei
    mask_b = 1.0 - oh_ej
    p_a = pos_a + jnp.sum((sign_a * half_a * mask_a)[:, None] * u, axis=0)
    p_b = pos_b + jnp.sum((sign_b * half_b * mask_b)[:, None] * v, axis=0)
    # closest points of the two witness lines p_a + s·ua, p_b + r·vb
    d_ab = p_b - p_a
    c_uv = ua @ vb
    denom = 1.0 - c_uv * c_uv
    s_par = jnp.where(
        jnp.abs(denom) > 1e-9,
        ((d_ab @ ua) - c_uv * (d_ab @ vb)) / denom,
        0.0,
    )
    r_par = s_par * c_uv - (d_ab @ vb)
    q_a = p_a + s_par * ua
    q_b = p_b + r_par * vb
    edge_point = 0.5 * (q_a + q_b)
    edge_depth = -edge_sep[best_edge]

    # ---------------- combine ----------------
    edge_points = jnp.zeros((_CAP, 3), jnp.float32).at[0].set(edge_point)
    points = jnp.where(use_edge, edge_points, face_points)
    depth = jnp.where(use_edge,
                      jnp.zeros(_CAP).at[0].set(edge_depth), face_depth)
    valid = jnp.where(
        use_edge,
        (slot == 0) & (edge_depth > 0.0),
        face_valid,
    )
    valid = valid & jnp.logical_not(separated)

    # contact normal B → A = −(A→B)
    n_out = -jnp.where(use_edge, n_edge, n_face)
    normals = jnp.broadcast_to(n_out, (_CAP, 3))
    return points, normals, depth, valid
