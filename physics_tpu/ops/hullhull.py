"""Convex-hull vs convex-hull narrow phase: face-SAT + reference-face clipping.

Generalizes the box-box manifold (ops/boxbox.py) to arbitrary convex
polyhedra from the HullSet (OBJ pipeline): candidate separating axes are the
face normals of both hulls (separation evaluated with masked support
points), the winning face becomes the reference face, and the most
anti-parallel face of the other hull is clipped against the reference
face's side planes — Sutherland–Hodgman with depth carried as an
interpolated coordinate, all one-hot einsums (see ops/boxbox.py
_clip_polygon).

Edge-edge separating axes ARE enumerated, over the cross products of the
hulls' unique edge DIRECTIONS (precomputed at scene build into
HullSet.edge_dirs — direction count ≪ edge count for typical meshes, e.g.
a beveled cube has ~100 edges but ~9 directions). When an edge axis wins
(with a face-preference fudge mirroring the box-box SAT), the face-clip
manifold is replaced by the single closest-point contact between the two
supporting edges. Face-dominant contact — resting, stacking — still takes
the exact clipped multi-point manifold. For separated pairs, use
`gjk_distance` (solver-grade distance/witness queries).

Returned normal points from hull B toward hull A (Contacts convention).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from physics_tpu.ops.boxbox import _clip_polygon

Array = jnp.ndarray


class HullData(NamedTuple):
    """One hull's geometry, body frame, padded (see state.HullSet)."""

    verts: Array        # [V, 3]
    vert_mask: Array    # [V] f32
    face_n: Array       # [F, 3]
    face_off: Array     # [F]
    face_mask: Array    # [F] f32
    face_verts: Array   # [F, E] int32
    face_vert_count: Array  # [F]
    edge_dirs: Array    # [D, 3] unique unit edge directions (body frame)
    edge_dir_mask: Array  # [D] f32
    edge_i0: Array      # [E] unique-edge endpoint vertex indices
    edge_i1: Array      # [E]
    edge_mask: Array    # [E] f32


def hull_hull_manifold(
    pos_a: Array, rot_a: Array, ha: HullData,
    pos_b: Array, rot_b: Array, hb: HullData,
) -> Tuple[Array, Array, Array, Array]:
    """Contact manifold for one hull pair.

    Returns (points [CAP,3] world, normals [CAP,3] B→A, depth [CAP],
    valid [CAP]) with CAP = 2·E + 1 (clip capacity + one edge-edge slot).
    """
    e_cap = ha.face_verts.shape[1]
    cap = 2 * e_cap

    # world geometry
    va = pos_a + ha.verts @ rot_a.T                       # [Va,3]
    vb = pos_b + hb.verts @ rot_b.T
    na_w = ha.face_n @ rot_a.T                            # [Fa,3]
    nb_w = hb.face_n @ rot_b.T
    # sanitize padded faces (off = +inf) to 0 — one-hot contractions would
    # otherwise produce 0·inf = NaN; validity is carried by face_mask
    offa_w = jnp.where(
        ha.face_mask > 0, ha.face_off + na_w @ pos_a, 0.0
    )
    offb_w = jnp.where(
        hb.face_mask > 0, hb.face_off + nb_w @ pos_b, 0.0
    )

    # --- face-SAT: separation of each face plane vs the other hull's
    # support point (masked min over vertices) ---
    big = jnp.float32(1e30)
    dots_ab = na_w @ vb.T                                 # [Fa,Vb]
    sep_a = jnp.min(
        jnp.where(hb.vert_mask[None, :] > 0, dots_ab, big), axis=1
    ) - offa_w
    sep_a = jnp.where(ha.face_mask > 0, sep_a, -big)
    dots_ba = nb_w @ va.T
    sep_b = jnp.min(
        jnp.where(ha.vert_mask[None, :] > 0, dots_ba, big), axis=1
    ) - offb_w
    sep_b = jnp.where(hb.face_mask > 0, sep_b, -big)

    sep_all = jnp.concatenate([sep_a, sep_b])             # [Fa+Fb]
    best = jnp.argmax(sep_all)
    face_sep = jnp.max(sep_all)
    fa = sep_a.shape[0]
    ref_is_a = best < fa

    # --- edge-edge SAT over unique-direction cross products ---
    da_w = ha.edge_dirs @ rot_a.T                         # [Da,3]
    db_w = hb.edge_dirs @ rot_b.T                         # [Db,3]
    axes = jnp.cross(da_w[:, None, :], db_w[None, :, :]).reshape(-1, 3)
    ax_mask = (ha.edge_dir_mask[:, None]
               * hb.edge_dir_mask[None, :]).reshape(-1)
    alen = jnp.linalg.norm(axes, axis=-1)
    ax_ok = (ax_mask > 0) & (alen > 1e-6)                 # parallel → skip
    axes = axes / jnp.maximum(alen, 1e-9)[:, None]
    # orient every axis from B toward A
    centers = pos_a - pos_b
    flip = jnp.where(axes @ centers < 0.0, -1.0, 1.0)
    axes = axes * flip[:, None]
    # separation on axis n (B→A): min_A(v·n) − max_B(v·n)
    pa_d = jnp.where(ha.vert_mask[:, None] > 0, va @ axes.T, big)
    pb_d = jnp.where(hb.vert_mask[:, None] > 0, vb @ axes.T, -big)
    sep_e_all = jnp.min(pa_d, axis=0) - jnp.max(pb_d, axis=0)
    sep_e_all = jnp.where(ax_ok, sep_e_all, -big)
    best_e = jnp.argmax(sep_e_all)
    edge_sep = jnp.max(sep_e_all)
    n_edge = jax.nn.one_hot(
        best_e, axes.shape[0], dtype=jnp.float32) @ axes

    separated = jnp.maximum(face_sep, edge_sep) > 0.0
    # face-preference fudge (mirrors the box-box SAT, ops/boxbox.py): an
    # edge axis must be clearly shallower to displace the face manifold
    edge_wins = (~separated) & (
        edge_sep > face_sep + 1e-4 + 0.05 * jnp.abs(face_sep))

    # supporting edges from the precomputed unique-edge list (endpoint
    # index pairs packed at scene build, scene._pack_hulls) — one [E, V]
    # one-hot gather per endpoint instead of the old [F, Ecap, V] runtime
    # derivation from face polygons (which dominated the mesh-rain step)
    def support_edge(verts_w, h, d):
        """Closest edge of one hull in support direction `d` ([2,3])."""
        vcap = verts_w.shape[0]
        p0 = jax.nn.one_hot(h.edge_i0, vcap, dtype=jnp.float32) @ verts_w
        p1 = jax.nn.one_hot(h.edge_i1, vcap, dtype=jnp.float32) @ verts_w
        score = jnp.minimum(p0 @ d, p1 @ d)                # [E]
        score = jnp.where(h.edge_mask > 0, score, -big)
        k = jnp.argmax(score)
        oh = jax.nn.one_hot(k, score.shape[0], dtype=jnp.float32)
        return (oh @ p0, oh @ p1)

    ea0, ea1 = support_edge(va, ha, -n_edge)               # A supports −n
    eb0, eb1 = support_edge(vb, hb, n_edge)                # B supports +n
    # closest points between the two segments
    d1 = ea1 - ea0
    d2 = eb1 - eb0
    r0 = ea0 - eb0
    a11 = d1 @ d1
    a22 = d2 @ d2
    a12 = d1 @ d2
    b1 = d1 @ r0
    b2 = d2 @ r0
    den = a11 * a22 - a12 * a12
    s = jnp.where(jnp.abs(den) > 1e-9, (a12 * b2 - a22 * b1) / den, 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    t = jnp.where(a22 > 1e-9, (b2 + a12 * s) / a22, 0.0)
    t = jnp.clip(t, 0.0, 1.0)
    s = jnp.where(a11 > 1e-9, jnp.clip((a12 * t - b1) / a11, 0.0, 1.0), s)
    pa_c = ea0 + s * d1
    pb_c = eb0 + t * d2
    edge_point = 0.5 * (pa_c + pb_c)
    edge_depth = -edge_sep

    # --- reference face selection (one-hot) ---
    oh_a = jax.nn.one_hot(jnp.where(ref_is_a, best, 0), fa, dtype=jnp.float32)
    oh_b = jax.nn.one_hot(
        jnp.where(ref_is_a, 0, best - fa), sep_b.shape[0], dtype=jnp.float32
    )

    n_ref = jnp.where(ref_is_a, oh_a @ na_w, oh_b @ nb_w)      # ref → inc
    off_ref = jnp.where(ref_is_a, oh_a @ offa_w, oh_b @ offb_w)
    ref_poly_idx_f = jnp.where(
        ref_is_a,
        oh_a @ ha.face_verts.astype(jnp.float32),
        oh_b @ hb.face_verts.astype(jnp.float32),
    )                                                          # [E] float
    ref_poly_cnt = jnp.where(
        ref_is_a,
        jnp.round(oh_a @ ha.face_vert_count.astype(jnp.float32)),
        jnp.round(oh_b @ hb.face_vert_count.astype(jnp.float32)),
    ).astype(jnp.int32)
    # gather ref face polygon vertices (one-hot over the OWNER's verts)
    va_cap = va.shape[0]
    vb_cap = vb.shape[0]
    oh_ref_poly_a = jax.nn.one_hot(
        ref_poly_idx_f.astype(jnp.int32), va_cap, dtype=jnp.float32
    )
    oh_ref_poly_b = jax.nn.one_hot(
        ref_poly_idx_f.astype(jnp.int32), vb_cap, dtype=jnp.float32
    )
    ref_poly = jnp.where(ref_is_a, oh_ref_poly_a @ va, oh_ref_poly_b @ vb)

    # --- incident face: most anti-parallel valid face of the OTHER hull ---
    align_b = jnp.where(hb.face_mask > 0, nb_w @ n_ref, big)
    align_a = jnp.where(ha.face_mask > 0, na_w @ n_ref, big)
    inc_idx = jnp.where(
        ref_is_a, jnp.argmin(align_b), jnp.argmin(align_a)
    )
    oh_inc_b = jax.nn.one_hot(inc_idx, sep_b.shape[0], dtype=jnp.float32)
    oh_inc_a = jax.nn.one_hot(inc_idx, fa, dtype=jnp.float32)
    inc_poly_idx = jnp.where(
        ref_is_a,
        oh_inc_b @ hb.face_verts.astype(jnp.float32),
        oh_inc_a @ ha.face_verts.astype(jnp.float32),
    ).astype(jnp.int32)
    inc_poly_cnt = jnp.where(
        ref_is_a,
        jnp.round(oh_inc_b @ hb.face_vert_count.astype(jnp.float32)),
        jnp.round(oh_inc_a @ ha.face_vert_count.astype(jnp.float32)),
    ).astype(jnp.int32)
    oh_inc_poly_b = jax.nn.one_hot(inc_poly_idx, vb_cap, dtype=jnp.float32)
    oh_inc_poly_a = jax.nn.one_hot(inc_poly_idx, va_cap, dtype=jnp.float32)
    inc_poly = jnp.where(ref_is_a, oh_inc_poly_b @ vb, oh_inc_poly_a @ va)

    # --- 2D frame on the reference face ---
    edge0 = ref_poly[1] - ref_poly[0]
    t1 = edge0 / jnp.maximum(jnp.linalg.norm(edge0), 1e-9)
    t2 = jnp.cross(n_ref, t1)
    p0 = ref_poly[0]

    def to2d(x):
        rel = x - p0
        return jnp.stack(
            [rel @ t1, rel @ t2, x @ n_ref - off_ref], axis=-1
        )  # (u, v, separation below ref face)

    ref2d = to2d(ref_poly)                                # [E,3]
    poly = jnp.zeros((cap, 3), jnp.float32).at[:e_cap].set(to2d(inc_poly))
    m = inc_poly_cnt

    # --- clip against each reference edge's side plane ---
    # CCW polygon (seen from outside, i.e. around +n_ref): interior is to
    # the LEFT of each edge, so keep cross2d(e, x - a) ≥ 0  ⟺
    # e_v·x_u − e_u·x_v ≤ e_v·a_u − e_u·a_v.
    idx_e = jnp.arange(e_cap)
    nxt_oh = jax.nn.one_hot(
        (idx_e + 1) % jnp.maximum(ref_poly_cnt, 1), e_cap, dtype=jnp.float32
    )
    ref2d_next = nxt_oh @ ref2d
    for k in range(e_cap):
        a_uv = ref2d[k, :2]
        e_uv = ref2d_next[k, :2] - a_uv
        plane = jnp.stack(
            [e_uv[1], -e_uv[0], e_uv[1] * a_uv[0] - e_uv[0] * a_uv[1]]
        )
        noop = jnp.array([0.0, 0.0, big], jnp.float32)
        plane = jnp.where(k < ref_poly_cnt, plane, noop)
        poly, m = _clip_polygon(poly, m, plane)

    slot = jnp.arange(cap)
    depth = -poly[:, 2]
    valid = (
        (slot < m) & (depth > 0.0) & jnp.logical_not(separated)
        & jnp.logical_not(edge_wins)
    )
    points = (
        p0[None, :]
        + poly[:, 0:1] * t1[None, :]
        + poly[:, 1:2] * t2[None, :]
        + poly[:, 2:3] * n_ref[None, :]
    )
    # contact normal B → A: n_ref points ref → incident
    n_out = jnp.where(ref_is_a, -n_ref, n_ref)
    normals = jnp.broadcast_to(n_out, (cap, 3))

    # slot cap: the edge-edge closest-point contact (replaces the face
    # manifold when an edge axis is the shallowest separation)
    points = jnp.concatenate([points, edge_point[None, :]])
    normals = jnp.concatenate([normals, n_edge[None, :]])
    depth = jnp.concatenate([depth, edge_depth[None]])
    valid = jnp.concatenate(
        [valid, (edge_wins & (edge_depth > 0.0))[None]])
    return points, normals, depth, valid


# ---------------------------------------------------------------------------
# GJK distance query (fixed-iteration, jit/vmap-safe)
# ---------------------------------------------------------------------------

def _support(verts: Array, mask: Array, d: Array) -> Array:
    """Masked support point of a vertex cloud along direction d."""
    dots = jnp.where(mask > 0, verts @ d, -jnp.float32(1e30))
    oh = jax.nn.one_hot(jnp.argmax(dots), verts.shape[0], dtype=jnp.float32)
    return oh @ verts


def gjk_distance(
    verts_a: Array, mask_a: Array, verts_b: Array, mask_b: Array,
    max_iters: int = 24,
) -> Tuple[Array, Array, Array]:
    """GJK distance between two convex vertex clouds (world frame).

    Fixed-iteration subgradient variant suited to lax loops: tracks the
    closest point v on the Minkowski difference A ⊖ B via Frank-Wolfe style
    updates v ← v + t·(s − v) with exact line search (t clamped to [0,1]),
    which converges to the true distance for disjoint hulls. Returns
    (distance, witness direction (unit, B→A), separated flag). For
    overlapping hulls distance ≈ 0 and `separated` is False — use the
    SAT manifold for penetration depth.
    """

    def mdiff_support(d):
        return _support(verts_a, mask_a, d) - _support(verts_b, mask_b, -d)

    v0 = mdiff_support(jnp.array([1.0, 0.0, 0.0], jnp.float32))

    def body(_, v):
        s = mdiff_support(-v)
        dv = s - v
        denom = dv @ dv
        t = jnp.where(denom > 1e-12, -(v @ dv) / denom, 0.0)
        t = jnp.clip(t, 0.0, 1.0)
        return v + t * dv

    v = jax.lax.fori_loop(0, max_iters, body, v0)
    dist = jnp.linalg.norm(v)
    direction = v / jnp.maximum(dist, 1e-9)
    # separated iff the support along -v cannot pass the origin
    s_final = mdiff_support(-v)
    separated = (s_final @ v) > 1e-6
    return jnp.where(separated, dist, 0.0), direction, separated
