"""Batched component-form box-box SAT + clipping (the boxes fast path).

Same algorithm as ops.boxbox.box_box_manifold (SAT over 15 axes with ODE's
face-preference fudge, reference-face Sutherland–Hodgman clipping, edge-edge
closest points — see that module's docstring for the geometry), but written
for a BATCH of pairs with every scalar as its own 1-D [P] array.

Why a second implementation: vmapping the per-pair kernel materializes
[P, 15, 3] / [P, 8, 8] intermediates with tiny minor dims. In component
form the pair axis is the only array axis, and XLA fuses the whole
manifold into a few elementwise passes over it. The per-pair module stays
as the readable reference; tests assert this one matches it.

All "loops" below are Python-static (15 axes, 8 polygon slots, 4 clip
planes) — they unroll into straight-line elementwise code, no lax control
flow.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax.numpy as jnp

from physics_tpu.maths import vec3c as v3

Array = jnp.ndarray

_CAP = 8
_FUDGE = 1.05
_PARALLEL_EPS = 1e-6


class Manifold(NamedTuple):
    """Batched manifold in component form (lists are static length CAP)."""

    points: List          # CAP × v3 ([P] components), world
    normal: Tuple         # v3 [P] — B → A (shared by all slots of a pair)
    depth: List           # CAP × [P]
    valid: List           # CAP × [P] bool


def _axis_cols(r9):
    """World axes (columns) of a row-major 9-tuple rotation."""
    return [
        (r9[0], r9[3], r9[6]),
        (r9[1], r9[4], r9[7]),
        (r9[2], r9[5], r9[8]),
    ]


def _argmax_unrolled(vals):
    """(best, idx) over a static list of [P] arrays."""
    best = vals[0]
    idx = jnp.zeros_like(vals[0], dtype=jnp.int32)
    for k in range(1, len(vals)):
        take = vals[k] > best
        best = jnp.where(take, vals[k], best)
        idx = jnp.where(take, jnp.int32(k), idx)
    return best, idx


def _select(idx, items):
    """items[idx] for a static list of [P] arrays / v3 tuples."""
    if isinstance(items[0], tuple):
        out = items[0]
        for k in range(1, len(items)):
            out = v3.where(idx == k, items[k], out)
        return out
    out = items[0]
    for k in range(1, len(items)):
        out = jnp.where(idx == k, items[k], out)
    return out


def _clip(pu, pv, ps, m, cu, cv, d):
    """One Sutherland–Hodgman half-plane clip on the 8-slot polygon.

    pu/pv/ps: [CAP, P] slot-major (2-D face coords + interpolated
    separation; CAP is read from the
    input shape — boxes use 8, the batched hull clip 2·E); m: [P] int32
    live count; keep points with cu·u + cv·v ≤ d ([P]). Mirrors
    ops.boxbox._clip_polygon.

    Shaped as a handful of [CAP, P] / [CAP, CAP, P] tensor ops rather than
    per-slot scalars: the fully unrolled form emitted ~800 tiny HLO ops per
    clip, which blew up compile time superlinearly (the multi-device CPU
    backend never finished) and fragmented fusions.
    """
    cap = pu.shape[0]
    slots = jnp.arange(cap, dtype=jnp.int32)[:, None]         # [CAP, 1]
    g = cu * pu + cv * pv - d[None, :]                        # [CAP, P]
    live = slots < m[None, :]

    # cyclic next slot: i+1, wrapping to slot 0 at i+1 == m
    wrap = (slots + 1) == m[None, :]
    nxt = lambda x: jnp.where(wrap, x[0][None, :], jnp.roll(x, -1, axis=0))
    g_nxt = nxt(g)
    u_nxt, v_nxt, s_nxt = nxt(pu), nxt(pv), nxt(ps)

    inside = (g <= 0.0) & live
    crossing = ((g <= 0.0) != (g_nxt <= 0.0)) & live
    denom = g - g_nxt
    t = jnp.where(jnp.abs(denom) > 1e-12, g / denom, 0.0)
    iu = pu + t * (u_nxt - pu)
    iv = pv + t * (v_nxt - pv)
    is_ = ps + t * (s_nxt - ps)

    emit = inside.astype(jnp.int32) + crossing.astype(jnp.int32)
    start = jnp.cumsum(emit, axis=0) - emit            # exclusive prefix sum
    pos_cur = jnp.where(inside, start, cap)
    pos_int = jnp.where(crossing, start + inside.astype(jnp.int32), cap)

    # ordered emission: out[j] = Σ_i (pos_cur[i]==j)·cur[i] + (pos_int[i]==j)·int[i]
    out_slot = jnp.arange(cap, dtype=jnp.int32)[:, None, None]
    oh_c = (pos_cur[None, :, :] == out_slot).astype(jnp.float32)
    oh_i = (pos_int[None, :, :] == out_slot).astype(jnp.float32)
    ou = jnp.sum(oh_c * pu[None], axis=1) + jnp.sum(oh_i * iu[None], axis=1)
    ov = jnp.sum(oh_c * pv[None], axis=1) + jnp.sum(oh_i * iv[None], axis=1)
    os_ = (jnp.sum(oh_c * ps[None], axis=1)
           + jnp.sum(oh_i * is_[None], axis=1))
    new_m = jnp.minimum(jnp.sum(emit, axis=0), cap)
    return ou, ov, os_, new_m


def box_box_manifold_batched(pa, ra9, ha, pb, rb9, hb) -> Manifold:
    """SAT + clipping manifolds for a batch of box pairs, component form.

    pa/pb: v3 of [P] (positions); ra9/rb9: row-major 9-tuples of [P]
    (world rotations); ha/hb: v3 of [P] (half extents).
    Normal points B → A.
    """
    t_w = v3.sub(pb, pa)
    u = _axis_cols(ra9)
    w = _axis_cols(rb9)

    # ---- 15 candidate axes ----
    axes = list(u) + list(w)                              # 6 face axes
    cross_axes, cross_ok = [], []
    for i in range(3):
        for j in range(3):
            cx = v3.cross(u[i], w[j])
            nn = v3.norm(cx)
            ok = nn > _PARALLEL_EPS
            inv = 1.0 / jnp.maximum(nn, _PARALLEL_EPS)
            cross_axes.append(v3.scale(cx, inv))
            cross_ok.append(ok)
    axes = axes + cross_axes                              # 15 total

    def proj(axis, half, cols):
        return (half[0] * jnp.abs(v3.dot(axis, cols[0]))
                + half[1] * jnp.abs(v3.dot(axis, cols[1]))
                + half[2] * jnp.abs(v3.dot(axis, cols[2])))

    dist = [v3.dot(ax, t_w) for ax in axes]
    sep = []
    for k in range(15):
        s = jnp.abs(dist[k]) - (proj(axes[k], ha, u) + proj(axes[k], hb, w))
        if k >= 6:
            s = jnp.where(cross_ok[k - 6], s, -jnp.inf)
        sep.append(s)

    separated = _argmax_unrolled(sep)[0] > 0.0

    best_face_sep, best_face = _argmax_unrolled(sep[:6])
    best_edge_sep, best_edge = _argmax_unrolled(sep[6:])
    any_edge = jnp.zeros_like(best_face_sep, dtype=bool)
    for ok in cross_ok:
        any_edge = any_edge | ok
    best_edge_sep = jnp.where(any_edge, best_edge_sep, -jnp.inf)
    # ODE fudge: an edge axis only wins when decisively better than every
    # face axis — ties (axis-aligned stacks) resolve to the face manifold.
    use_edge = best_edge_sep * _FUDGE > best_face_sep

    axis_f = _select(best_face, axes[:6])
    dist_f = _select(best_face, dist[:6])
    sign_f = jnp.sign(dist_f + 1e-30)
    n_face = v3.scale(axis_f, sign_f)                     # A → B
    axis_e = _select(best_edge, axes[6:])
    dist_e = _select(best_edge, dist[6:])
    n_edge = v3.scale(axis_e, jnp.sign(dist_e + 1e-30))

    # ---------------- face-contact manifold ----------------
    ref_is_a = best_face < 3
    ref_axis = jnp.where(ref_is_a, best_face, best_face - 3)
    ref_cols = [v3.where(ref_is_a, u[k], w[k]) for k in range(3)]
    inc_cols = [v3.where(ref_is_a, w[k], u[k]) for k in range(3)]
    ref_half = [jnp.where(ref_is_a, ha[k], hb[k]) for k in range(3)]
    inc_half = [jnp.where(ref_is_a, hb[k], ha[k]) for k in range(3)]
    ref_pos = v3.where(ref_is_a, pa, pb)
    inc_pos = v3.where(ref_is_a, pb, pa)
    ref_n = v3.where(ref_is_a, n_face, v3.neg(n_face))    # ref → incident

    # (p, q) = the other two axis indices
    p_idx = jnp.where(ref_axis == 0, 1, 0)
    q_idx = jnp.where(ref_axis == 2, 1, 2)
    u_p = _select(p_idx, ref_cols)
    u_q = _select(q_idx, ref_cols)
    h_p = _select(p_idx, ref_half)
    h_q = _select(q_idx, ref_half)
    h_axis = _select(ref_axis, ref_half)
    c_ref = v3.add(ref_pos, v3.scale(ref_n, h_axis))

    # incident face: most anti-parallel to ref_n
    align = [v3.dot(inc_cols[k], ref_n) for k in range(3)]
    _, inc_axis = _argmax_unrolled([jnp.abs(x) for x in align])
    inc_align = _select(inc_axis, align)
    inc_sign = -jnp.sign(inc_align + 1e-30)
    inc_n_axis = _select(inc_axis, inc_cols)
    inc_h = _select(inc_axis, inc_half)
    c_inc = v3.add(inc_pos, v3.scale(inc_n_axis, inc_sign * inc_h))
    ip_idx = jnp.where(inc_axis == 0, 1, 0)
    iq_idx = jnp.where(inc_axis == 2, 1, 2)
    w_p = v3.scale(_select(ip_idx, inc_cols), _select(ip_idx, inc_half))
    w_q = v3.scale(_select(iq_idx, inc_cols), _select(iq_idx, inc_half))

    signs = [(1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0)]
    su = [None] * _CAP
    sv = [None] * _CAP
    ss = [None] * _CAP
    zero = jnp.zeros_like(h_p)
    for k, (sp, sq) in enumerate(signs):
        corner = v3.add(c_inc, v3.add(v3.scale(w_p, sp), v3.scale(w_q, sq)))
        rel = v3.sub(corner, c_ref)
        su[k] = v3.dot(rel, u_p)
        sv[k] = v3.dot(rel, u_q)
        ss[k] = v3.dot(rel, ref_n)     # separation ≤ 0 where penetrating
    for k in range(4, _CAP):
        su[k], sv[k], ss[k] = zero, zero, zero
    m = jnp.full_like(ref_axis, 4)
    pu, pv, ps = jnp.stack(su), jnp.stack(sv), jnp.stack(ss)   # [CAP, P]

    one = jnp.float32(1.0)
    pu, pv, ps, m = _clip(pu, pv, ps, m, one, 0.0, h_p)
    pu, pv, ps, m = _clip(pu, pv, ps, m, -one, 0.0, h_p)
    pu, pv, ps, m = _clip(pu, pv, ps, m, 0.0, one, h_q)
    pu, pv, ps, m = _clip(pu, pv, ps, m, 0.0, -one, h_q)

    face_points, face_depth, face_valid = [], [], []
    for k in range(_CAP):
        pt = v3.add(
            c_ref,
            v3.add(
                v3.add(v3.scale(u_p, pu[k]), v3.scale(u_q, pv[k])),
                v3.scale(ref_n, ps[k]),   # on the incident face
            ),
        )
        face_points.append(pt)
        face_depth.append(-ps[k])
        face_valid.append((jnp.int32(k) < m) & (-ps[k] > 0.0))

    # ---------------- edge-contact point ----------------
    ei = best_edge // 3
    ej = best_edge % 3
    ua = _select(ei, u)
    vb = _select(ej, w)
    p_a, p_b = pa, pb
    for k in range(3):
        sa = jnp.sign(v3.dot(u[k], n_edge) + 1e-30) * (ei != k) * ha[k]
        p_a = v3.add(p_a, v3.scale(u[k], sa))
        sb = jnp.sign(-v3.dot(w[k], n_edge) + 1e-30) * (ej != k) * hb[k]
        p_b = v3.add(p_b, v3.scale(w[k], sb))
    d_ab = v3.sub(p_b, p_a)
    c_uv = v3.dot(ua, vb)
    denom = 1.0 - c_uv * c_uv
    s_par = jnp.where(
        jnp.abs(denom) > 1e-9,
        (v3.dot(d_ab, ua) - c_uv * v3.dot(d_ab, vb)) / denom,
        0.0,
    )
    r_par = s_par * c_uv - v3.dot(d_ab, vb)
    q_a = v3.add(p_a, v3.scale(ua, s_par))
    q_b = v3.add(p_b, v3.scale(vb, r_par))
    edge_point = v3.scale(v3.add(q_a, q_b), 0.5)
    edge_depth = -_select(best_edge, sep[6:])

    # ---------------- combine ----------------
    points, depth, valid = [], [], []
    for k in range(_CAP):
        if k == 0:
            points.append(v3.where(use_edge, edge_point, face_points[k]))
            depth.append(jnp.where(use_edge, edge_depth, face_depth[k]))
            valid.append(
                ((use_edge & (edge_depth > 0.0))
                 | (~use_edge & face_valid[k]))
                & ~separated
            )
        else:
            points.append(face_points[k])
            depth.append(jnp.where(use_edge, 0.0, face_depth[k]))
            valid.append(~use_edge & face_valid[k] & ~separated)

    n_out = v3.neg(v3.where(use_edge, n_edge, n_face))    # B → A
    return Manifold(points=points, normal=n_out, depth=depth, valid=valid)
