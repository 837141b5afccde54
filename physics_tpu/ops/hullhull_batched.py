"""Batched hull-hull narrow phase for single-hull-type scenes (mesh rain).

Batched reformulation of `ops/hullhull.hull_hull_manifold` (which vmaps
per-pair [F,V]/[D,D] tensors — small minor dims and gather-heavy). Key identity:
with one SHARED hull shape, every pairwise SAT quantity is LINEAR in the
9 components of the relative rotation M = R_aᵀ·R_b:

    face-A support   n_f·(M u)            =  (n_f ⊗ u)        : M
    face-B support   n_f·(Mᵀ v)           =  (v ⊗ n_f)        : M
    edge axis (A)    cross(d₁, M d₂)_i    =  (ε_ijk d₁_j d₂_l) : M
    A-vert on axis   cross(d₁, M d₂)·v    =  ((v×d₁) ⊗ d₂)    : M
    B-vert on axis   cross(Mᵀd₁, d₂)·v    =  (d₁ ⊗ (d₂×v))    : M
    face alignment   n_a·(M n_b)          =  (n_a ⊗ n_b)      : M

so ALL pairs' supports fall out of a handful of [rows, 9] × [9, P]
matmuls with P (pairs) as the long dimension, zero per-pair gathers of
geometry. Per-pair positions enter only through two rotated
offsets (dpa = R_aᵀ(p_b−p_a), dpb = R_bᵀ(p_a−p_b)), handled in
component form (maths/vec3c). The coefficient tables are built on device
from the hull's (tiny) geometry arrays each step — a few µs — because the
hull rides the traced SimState.

Face-manifold clipping (reference-face Sutherland–Hodgman) runs fully
batched in slot-major [CAP, P] component form through the shape-generic
`boxbox_batched._clip`; the edge-edge contact is fully component form.
Matches `hull_hull_manifold` outputs (tests/test_hullhull.py parity
test).

The whole pipeline is slot-major/component-form end to end — every
quantity is a [rows, P] tensor or a [P] row; no [P, E, 3] /
[P, CAP, 3] minor-dim-3 tensors anywhere. `shared_hull_manifolds_sm` returns
the raw slot-major pieces (clipped 2-D coords + face frame) so the
hulls_only contact epilogue (ops/narrowphase._pair_contacts_hulls_fast)
can select per-pair top-k slots with [P]-row argmax passes and
reconstruct only the SELECTED points — never materializing per-slot
world points for all slots. `hull_pair_manifolds_shared` keeps the old
[P, S]/[P, S, 3] contract for mixed-shape scenes.

New capability vs the reference (no collision detection there,
SURVEY.md §0). The face normals plus the edge-direction cross products
are a complete SAT axis set for convex polyhedra, so no EPA is needed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from physics_tpu.maths import quaternion as quat
from physics_tpu.maths import vec3c as v3
from physics_tpu.ops.boxbox_batched import _clip

Array = jnp.ndarray

# plain python float, NOT jnp.float32(...): this module is imported
# lazily inside a traced function (ops/narrowphase.pair_contacts), and a
# module-level jnp constant created under an active trace binds as a
# TRACER — it then leaks into every later jaxpr as a phantom const,
# corrupting the jit dispatch path ("Execution supplied 36 buffers but
# compiled program expected 42")
BIG = 1e30


class HullTables(NamedTuple):
    """Device-side coefficient tables for one hull TYPE PAIR (A, B).

    With a single shared hull type both sides coincide (the original
    shared-hull identity); for a small hull-type library the cross
    tables (a_fv/b_fv/l_ax/c_av/c_bv/ff) mix A-side and B-side geometry
    — all shapes are the HullSet's shared padded capacities, so every
    type pair produces identically-shaped tables and the manifold
    pipeline is type-pair-parametric with zero structural change."""

    verts_a: Array      # [V, 3] hull-A local vertices
    verts_b: Array      # [V, 3] hull-B local vertices
    face_n_a: Array     # [F, 3]
    face_n_b: Array     # [F, 3]
    face_off_a: Array   # [F] (+inf padding sanitized to real faces)
    face_off_b: Array   # [F]
    face_mask_a: Array  # [F] f32
    face_mask_b: Array  # [F] f32
    face_verts_a: Array  # [F, E] int32
    face_verts_b: Array  # [F, E] int32
    face_cnt_a: Array    # [F] int32
    face_cnt_b: Array    # [F] int32
    a_fv: Array       # [F·V, 9]  n_f(A) ⊗ u(B)
    b_fv: Array       # [F·V, 9]  v(A) ⊗ n_f(B)
    l_ax: Array       # [D²·3, 9] ε d(A) d(B)
    c_av: Array       # [D²·V, 9] (v(A)×d(A)) ⊗ d(B)
    c_bv: Array       # [D²·V, 9] d(A) ⊗ (d(B)×v(B))
    ff: Array         # [F·F, 9]  n(A) ⊗ n(B)
    ax_mask: Array    # [D²] f32  dmask(A) ⊗ dmask(B)
    edge_i0_a: Array  # [E2] int32 unique-edge endpoints (A's edge list)
    edge_i1_a: Array
    edge_mask_a: Array  # [E2] f32
    edge_i0_b: Array
    edge_i1_b: Array
    edge_mask_b: Array


def build_hull_tables(hulls, idx: int = 0, idx_b: int | None = None
                      ) -> HullTables:
    """Coefficient tables for hull type pair (idx, idx_b) from a HullSet
    (all jnp ops, ~µs). idx_b=None ⇒ the shared-hull case (B = A)."""
    if idx_b is None:
        idx_b = idx

    def side(i):
        v = hulls.verts[i]                                 # [V, 3]
        nf = hulls.face_normals[i]                         # [F, 3]
        off = hulls.face_offsets[i]                        # [F]
        fmask = jnp.isfinite(off).astype(jnp.float32)
        off = jnp.where(fmask > 0, off, 0.0)
        d = hulls.edge_dirs[i]                             # [D, 3]
        dmask = (jnp.arange(d.shape[0])
                 < hulls.edge_dir_count[i]).astype(jnp.float32)
        emask = (jnp.arange(hulls.edge_i0.shape[1])
                 < hulls.edge_count[i]).astype(jnp.float32)
        return v, nf, off, fmask, d, dmask, emask

    va, nfa, offa, fmaska, da, dmaska, emaska = side(idx)
    vb, nfb, offb, fmaskb, db, dmaskb, emaskb = side(idx_b)

    f, vc, dc = nfa.shape[0], va.shape[0], da.shape[0]
    eps = jnp.zeros((3, 3, 3), jnp.float32)
    for (i, j, k, s) in [(0, 1, 2, 1.0), (1, 2, 0, 1.0), (2, 0, 1, 1.0),
                         (0, 2, 1, -1.0), (1, 0, 2, -1.0), (2, 1, 0, -1.0)]:
        eps = eps.at[i, j, k].set(s)

    a_fv = jnp.einsum("fk,ul->fukl", nfa, vb).reshape(f * vc, 9)
    b_fv = jnp.einsum("uk,fl->fukl", va, nfb).reshape(f * vc, 9)
    l_ax = jnp.einsum("ijk,aj,bl->abikl", eps, da, db).reshape(
        dc * dc * 3, 9)
    # c_av[(a,b,u),(k,l)] = (v_u(A) × d_a(A))_k · d_b(B)_l
    vxd = jnp.cross(va[None, :, :], da[:, None, :])   # [D, V, 3] v_u × d_a
    c_av = jnp.einsum("auk,bl->abukl", vxd, db).reshape(dc * dc * vc, 9)
    # c_bv[(a,b,u),(k,l)] = d_a(A)_k · (d_b(B) × v_u(B))_l
    dxv = jnp.cross(db[:, None, :], vb[None, :, :])   # [D, V, 3] d_b × v_u
    c_bv = jnp.einsum("ak,bul->abukl", da, dxv).reshape(dc * dc * vc, 9)
    ff = jnp.einsum("ak,bl->abkl", nfa, nfb).reshape(f * f, 9)
    ax_mask = (dmaska[:, None] * dmaskb[None, :]).reshape(-1)

    return HullTables(
        verts_a=va, verts_b=vb,
        face_n_a=nfa, face_n_b=nfb,
        face_off_a=offa, face_off_b=offb,
        face_mask_a=fmaska, face_mask_b=fmaskb,
        face_verts_a=hulls.face_verts[idx],
        face_verts_b=hulls.face_verts[idx_b],
        face_cnt_a=hulls.face_vert_count[idx],
        face_cnt_b=hulls.face_vert_count[idx_b],
        a_fv=a_fv, b_fv=b_fv, l_ax=l_ax, c_av=c_av, c_bv=c_bv, ff=ff,
        ax_mask=ax_mask,
        edge_i0_a=hulls.edge_i0[idx], edge_i1_a=hulls.edge_i1[idx],
        edge_mask_a=emaska,
        edge_i0_b=hulls.edge_i0[idx_b], edge_i1_b=hulls.edge_i1[idx_b],
        edge_mask_b=emaskb,
    )


def _matT_vec(m: tuple, w) -> v3.V3:
    """Mᵀ·w for a row-major 9-tuple."""
    return (
        m[0] * w[0] + m[3] * w[1] + m[6] * w[2],
        m[1] * w[0] + m[4] * w[1] + m[7] * w[2],
        m[2] * w[0] + m[5] * w[1] + m[8] * w[2],
    )


class SharedManifoldSM(NamedTuple):
    """Slot-major shared-hull manifold pieces — all fields are [P] lane
    rows or [2E, P] slot-major tensors (S = 2E + 1 slots total; slots
    0..2E−1 are the clipped face manifold, slot 2E the edge contact).

    World point of face slot s = p0 + pu[s]·t1 + pv[s]·t2 + ps[s]·n_ref;
    its normal is n_face. `depth` rows are already validity-masked
    (> 0 ⇔ an active contact candidate)."""

    depth: Tuple      # S × [P] rows
    pu: Array         # [2E, P] clipped polygon coords in the ref-face frame
    pv: Array         # [2E, P]
    ps: Array         # [2E, P] signed separation along n_ref
    p0: Tuple         # v3 of [P] — ref-face frame origin
    t1: Tuple         # v3 — ref-face tangent
    t2: Tuple         # v3 — ref-face bitangent
    n_ref: Tuple      # v3 — world ref-face normal (ref → incident)
    n_face: Tuple     # v3 — world face-contact normal, B → A
    edge_point: Tuple # v3 — edge-contact world point
    n_edge: Tuple     # v3 — world edge-contact normal, B → A


def shared_hull_manifolds_sm(state, cand, cfg,
                             types: Tuple[int, int] = (0, 0)
                             ) -> SharedManifoldSM:
    """Slot-major manifolds for all candidate pairs of one hull TYPE
    PAIR: endpoint a of every candidate must be of hull type types[0]
    and endpoint b of types[1] (the multi-type epilogue segments
    candidates by type pair; a single shared hull is types=(0, 0)).

    See the module doc: every support quantity falls out of static
    [rows, 9] × [9, P] matmuls against the relative rotation; selection
    one-hots are built [rows, P] (iota-compare) so every contraction
    keeps P in the lane dimension.
    """
    ht = build_hull_tables(state.hulls, types[0], types[1])
    ia, ib = cand.body_a, cand.body_b
    p = ia.shape[0]
    f = ht.face_n_a.shape[0]
    vc = ht.verts_a.shape[0]
    d2 = ht.ax_mask.shape[0]
    e_cap = ht.face_verts_a.shape[1]
    cap = 2 * e_cap

    qa = state.quat[ia]                                    # [P, 4]
    qb = state.quat[ib]
    m9 = v3.quat_to_mat(quat.mul(quat.conjugate(qa), qb))  # 9 × [P]
    ra9 = v3.quat_to_mat(qa)
    rb9 = v3.quat_to_mat(qb)
    pa = v3.unpack(state.pos[ia])
    pb = v3.unpack(state.pos[ib])
    dp = v3.sub(pb, pa)                                    # p_b − p_a
    dpa = _matT_vec(ra9, dp)                               # R_aᵀ(p_b−p_a)
    dpb = _matT_vec(rb9, v3.neg(dp))                       # R_bᵀ(p_a−p_b)
    m_mat = jnp.stack(m9)                                  # [9, P]
    dpa_m = jnp.stack(dpa)                                 # [3, P]
    dpb_m = jnp.stack(dpb)

    # ---- all supports in a few static matmuls ----
    sa = (ht.a_fv @ m_mat).reshape(f, vc, p)
    sep_a = (jnp.min(sa, axis=1) + ht.face_n_a @ dpa_m
             - ht.face_off_a[:, None])
    sep_a = jnp.where(ht.face_mask_a[:, None] > 0, sep_a, -BIG)  # [F, P]
    sb = (ht.b_fv @ m_mat).reshape(f, vc, p)
    sep_b = (jnp.min(sb, axis=1) + ht.face_n_b @ dpb_m
             - ht.face_off_b[:, None])
    sep_b = jnp.where(ht.face_mask_b[:, None] > 0, sep_b, -BIG)

    s_av = (ht.c_av @ m_mat).reshape(d2, vc, p)
    min_a_e = jnp.min(s_av, axis=1)
    max_a_e = jnp.max(s_av, axis=1)                        # [D², P]
    s_bv = (ht.c_bv @ m_mat).reshape(d2, vc, p)
    min_b_e = jnp.min(s_bv, axis=1)
    max_b_e = jnp.max(s_bv, axis=1)
    axes = (ht.l_ax @ m_mat).reshape(d2, 3, p)
    ax2 = jnp.sum(axes * axes, axis=1)                     # [D², P]
    alen = jnp.sqrt(jnp.maximum(ax2, 1e-18))
    t_ax = -jnp.einsum("aip,ip->ap", axes, dpa_m)          # ax·(p_a−p_b), A frame
    flip = t_ax < 0.0
    sep_num = jnp.where(flip,
                        min_b_e - max_a_e - t_ax,
                        min_a_e - max_b_e + t_ax)
    ax_ok = (ht.ax_mask[:, None] > 0) & (alen > 1e-6)
    sep_e = jnp.where(ax_ok, sep_num / alen, -BIG)         # [D², P]

    # ---- axis choice (same policy as hull_hull_manifold) ----
    sep_faces = jnp.concatenate([sep_a, sep_b], axis=0)    # [2F, P]
    best_f = jnp.argmax(sep_faces, axis=0)                 # [P]
    face_sep = jnp.max(sep_faces, axis=0)
    best_e = jnp.argmax(sep_e, axis=0)
    edge_sep = jnp.max(sep_e, axis=0)
    separated = jnp.maximum(face_sep, edge_sep) > 0.0
    edge_wins = (~separated) & (
        edge_sep > face_sep + 1e-4 + 0.05 * jnp.abs(face_sep))

    ref_is_a = best_f < f
    ref_idx = jnp.where(ref_is_a, best_f, best_f - f)      # [P]
    # selection one-hots are [F, P] (iota-compare) so every contraction
    # below is a [rows, F] × [F, P] matmul or reduction — P stays the
    # minor dimension throughout
    f_iota = jax.lax.broadcasted_iota(jnp.int32, (f, p), 0)
    oh_ref = (f_iota == ref_idx[None, :]).astype(jnp.float32)   # [F, P]

    # ---- incident face: most anti-parallel face of the OTHER hull ----
    # contract the ref one-hot with the STATIC ff coefficients first
    # ([F·9, F] × [F, P] matmuls), then dot the 9 rotation components —
    # never materializing the [F, F, P] alignment tensor
    big_col_a = jnp.where(ht.face_mask_a > 0, 0.0, BIG)
    big_col_b = jnp.where(ht.face_mask_b > 0, 0.0, BIG)
    ff3 = ht.ff.reshape(f, f, 9)

    def align_against_ref(c_tab):
        # c_tab [F_other, F_ref, 9] (contraction over the ref axis)
        ce = jax.lax.dot_general(
            c_tab.transpose(1, 0, 2).reshape(f, f * 9), oh_ref,
            (((0,), (0,)), ((), ())))                      # [F_other·9, P]
        return jnp.sum(ce.reshape(f, 9, p) * m_mat[None, :, :], axis=1)

    # ref on A → other is B: align[a, b] = ff[(a, b)] : M, contract a
    al_b = align_against_ref(ff3.transpose(1, 0, 2)) + big_col_b[:, None]
    # ref on B → other is A: contract b
    al_a = align_against_ref(ff3) + big_col_a[:, None]
    inc_idx = jnp.where(ref_is_a,
                        jnp.argmin(al_b, axis=0), jnp.argmin(al_a, axis=0))
    oh_inc = (f_iota == inc_idx[None, :]).astype(jnp.float32)   # [F, P]

    # ---- owner-frame → world polygons, component form ----
    r_ref = tuple(jnp.where(ref_is_a, ra9[k], rb9[k]) for k in range(9))
    r_inc = tuple(jnp.where(ref_is_a, rb9[k], ra9[k]) for k in range(9))
    p_ref = v3.where(ref_is_a, pa, pb)
    p_inc = v3.where(ref_is_a, pb, pa)

    same = types[0] == types[1]            # static: shared-hull case
    poly_a = ht.verts_a[ht.face_verts_a]                   # [F, E, 3] static
    poly_b = poly_a if same else ht.verts_b[ht.face_verts_b]

    def owner_sel(oh, tab_a, tab_b, ref_side):
        """einsum the one-hot against the ref/inc OWNER's static table:
        A's when (owner is a) else B's — one einsum when types match."""
        ea = jnp.einsum("fec,fp->ecp", tab_a, oh)
        if same:
            return ea
        eb = jnp.einsum("fec,fp->ecp", tab_b, oh)
        return jnp.where(ref_side[None, None, :], ea, eb)

    # [E, 3, P]: one [E·3, F] × [F, P] matmul under the hood — no
    # [P, E, 3] gather
    ref_loc = owner_sel(oh_ref, poly_a, poly_b, ref_is_a)
    inc_loc = owner_sel(oh_inc, poly_a, poly_b, ~ref_is_a)

    def owner_row(oh, row_a, row_b, ref_side):
        ra_v = jnp.einsum("fp,f->p", oh, row_a)
        if same:
            return ra_v
        rb_v = jnp.einsum("fp,f->p", oh, row_b)
        return jnp.where(ref_side, ra_v, rb_v)

    fcnt_a = ht.face_cnt_a.astype(jnp.float32)
    fcnt_b = ht.face_cnt_b.astype(jnp.float32)
    ref_cnt = jnp.round(
        owner_row(oh_ref, fcnt_a, fcnt_b, ref_is_a)).astype(jnp.int32)
    inc_cnt = jnp.round(
        owner_row(oh_inc, fcnt_a, fcnt_b, ~ref_is_a)).astype(jnp.int32)

    def to_world(loc, r, t):
        # loc [E, 3, P] in owner frame → list of E world v3 tuples ([P])
        out = []
        for k in range(loc.shape[0]):
            x, y, z = loc[k, 0], loc[k, 1], loc[k, 2]
            out.append((
                r[0] * x + r[1] * y + r[2] * z + t[0],
                r[3] * x + r[4] * y + r[5] * z + t[1],
                r[6] * x + r[7] * y + r[8] * z + t[2],
            ))
        return out

    ref_w = to_world(ref_loc, r_ref, p_ref)                # E × v3([P])
    inc_w = to_world(inc_loc, r_inc, p_inc)

    n_ref_loc = tuple(
        owner_row(oh_ref, ht.face_n_a[:, c], ht.face_n_b[:, c], ref_is_a)
        for c in range(3)
    )                                                      # owner frame
    n_ref = v3.mat_vec(r_ref, n_ref_loc)                   # world, ref→inc
    off_ref = (owner_row(oh_ref, ht.face_off_a, ht.face_off_b, ref_is_a)
               + v3.dot(n_ref, p_ref))

    # ---- 2-D clip in the reference-face frame (fully batched) ----
    # All pairs clip at once in slot-major [CAP, P] component form via the
    # shape-generic boxbox_batched._clip, not the per-pair vmapped
    # Sutherland–Hodgman (ops.boxbox._clip_polygon over [P, CAP, 3]
    # tensors).
    edge0 = v3.sub(ref_w[1], ref_w[0])
    t1 = v3.scale(edge0, 1.0 / jnp.maximum(v3.norm(edge0), 1e-9))
    t2 = v3.cross(n_ref, t1)
    p0 = ref_w[0]

    ru, rv = [], []
    for k in range(e_cap):
        rel = v3.sub(ref_w[k], p0)
        ru.append(v3.dot(rel, t1))
        rv.append(v3.dot(rel, t2))
    iu_l, iv_l, is_l = [], [], []
    for k in range(e_cap):
        q = inc_w[k]
        rel = v3.sub(q, p0)
        iu_l.append(v3.dot(rel, t1))
        iv_l.append(v3.dot(rel, t2))
        is_l.append(v3.dot(q, n_ref) - off_ref)
    zero_p = jnp.zeros((p,), jnp.float32)
    pad = [zero_p] * e_cap
    pu = jnp.stack(iu_l + pad)                             # [CAP, P]
    pv = jnp.stack(iv_l + pad)
    ps = jnp.stack(is_l + pad)
    m_cnt = inc_cnt

    for k in range(e_cap):
        # ref edge k → k+1 (wrapping to 0 at rcnt); no-op past rcnt
        if k + 1 < e_cap:
            wrapped = (k + 1) == ref_cnt
            ru_n = jnp.where(wrapped, ru[0], ru[k + 1])
            rv_n = jnp.where(wrapped, rv[0], rv[k + 1])
        else:
            ru_n, rv_n = ru[0], rv[0]
        e_u = ru_n - ru[k]
        e_v = rv_n - rv[k]
        on = (k < ref_cnt).astype(jnp.float32)
        cu = e_v * on
        cv = -e_u * on
        d = (e_v * ru[k] - e_u * rv[k]) * on + (1.0 - on) * jnp.float32(1e30)
        pu, pv, ps, m_cnt = _clip(pu, pv, ps, m_cnt, cu, cv, d)

    n_face = v3.where(ref_is_a, v3.neg(n_ref), n_ref)      # B → A

    # ---- edge-edge closest-point contact (component form) ----
    d2_iota = jax.lax.broadcasted_iota(jnp.int32, (d2, p), 0)
    oh_e = (d2_iota == best_e[None, :]).astype(jnp.float32)   # [D², P]
    ax_sel = tuple(
        jnp.einsum("ap,ap->p", oh_e, axes[:, c, :]) for c in range(3)
    )                                                      # A frame, unnorm
    alen_sel = jnp.einsum("ap,ap->p", oh_e, alen)
    flip_sel = jnp.einsum("ap,ap->p", oh_e, flip.astype(jnp.float32)) > 0.5
    sgn = jnp.where(flip_sel, -1.0, 1.0)
    ax_u = v3.scale(ax_sel, sgn / jnp.maximum(alen_sel, 1e-9))  # unit, B→A
    n_edge = v3.mat_vec(ra9, ax_u)                         # world

    # endpoint supports of the SELECTED axis: contract the one-hot with
    # the static coefficient tables FIRST ([V·9, D²] × [D², P] matmul),
    # then dot the 9 rotation components per pair — NOT with the full
    # [D², V, P] support tensors (re-reading s_av/s_bv here was 2×63 MB
    # of HBM per step at 1k rain, the top hot line of the profile)
    def sel_axis_supports(c_tab):
        c3 = c_tab.reshape(d2, vc * 9)                     # static
        ce = jax.lax.dot_general(
            c3, oh_e, (((0,), (0,)), ((), ())))            # [V·9, P]
        return jnp.sum(ce.reshape(vc, 9, p) * m_mat[None, :, :], axis=1)

    sa_sel = sel_axis_supports(ht.c_av)                    # [V, P] A verts
    sb_sel = sel_axis_supports(ht.c_bv)                    # [V, P] B verts
    sa_sel = sa_sel * sgn[None, :]
    sb_sel = sb_sel * sgn[None, :]
    # A supports −n, B supports +n (world); per-edge score = min(endpoints)
    e2 = ht.edge_i0_a.shape[0]
    oh_i0a = jax.nn.one_hot(ht.edge_i0_a, vc, dtype=jnp.float32)  # [E2, V]
    oh_i1a = jax.nn.one_hot(ht.edge_i1_a, vc, dtype=jnp.float32)
    if same:
        oh_i0b, oh_i1b = oh_i0a, oh_i1a
    else:
        oh_i0b = jax.nn.one_hot(ht.edge_i0_b, vc, dtype=jnp.float32)
        oh_i1b = jax.nn.one_hot(ht.edge_i1_b, vc, dtype=jnp.float32)
    sa0 = oh_i0a @ sa_sel
    sa1 = oh_i1a @ sa_sel                                  # [E2, P]
    sb0 = oh_i0b @ sb_sel
    sb1 = oh_i1b @ sb_sel
    edge_pad_a = jnp.where(ht.edge_mask_a[:, None] > 0, 0.0, BIG)
    edge_pad_b = (edge_pad_a if same else
                  jnp.where(ht.edge_mask_b[:, None] > 0, 0.0, BIG))
    score_a = jnp.maximum(sa0, sa1) + edge_pad_a           # support along −n
    score_b = jnp.minimum(sb0, sb1) - edge_pad_b           # support along +n
    ea_idx = jnp.argmin(score_a, axis=0)                   # [P]
    eb_idx = jnp.argmax(score_b, axis=0)
    e2_iota = jax.lax.broadcasted_iota(jnp.int32, (e2, p), 0)
    oh_ea = (e2_iota == ea_idx[None, :]).astype(jnp.float32)  # [E2, P]
    oh_eb = (e2_iota == eb_idx[None, :]).astype(jnp.float32)

    v0e_a = oh_i0a @ ht.verts_a                            # [E2, 3] static
    v1e_a = oh_i1a @ ht.verts_a
    v0e_b = v0e_a if same else oh_i0b @ ht.verts_b
    v1e_b = v1e_a if same else oh_i1b @ ht.verts_b

    def esel(oh, ve):
        # [P] component rows of the selected edge endpoint (owner frame)
        return tuple(
            jnp.einsum("ep,e->p", oh, ve[:, c]) for c in range(3))

    p0a_l = esel(oh_ea, v0e_a)                             # A frame
    p1a_l = esel(oh_ea, v1e_a)
    p0b_l = esel(oh_eb, v0e_b)
    p1b_l = esel(oh_eb, v1e_b)
    ea0 = v3.add(v3.mat_vec(ra9, p0a_l), pa)               # world
    ea1 = v3.add(v3.mat_vec(ra9, p1a_l), pa)
    eb0 = v3.add(v3.mat_vec(rb9, p0b_l), pb)
    eb1 = v3.add(v3.mat_vec(rb9, p1b_l), pb)

    d1 = v3.sub(ea1, ea0)
    d2v = v3.sub(eb1, eb0)
    r0 = v3.sub(ea0, eb0)
    a11 = v3.dot(d1, d1)
    a22 = v3.dot(d2v, d2v)
    a12 = v3.dot(d1, d2v)
    b1 = v3.dot(d1, r0)
    b2 = v3.dot(d2v, r0)
    den = a11 * a22 - a12 * a12
    s = jnp.where(jnp.abs(den) > 1e-9, (a12 * b2 - a22 * b1) / den, 0.0)
    s = jnp.clip(s, 0.0, 1.0)
    t = jnp.where(a22 > 1e-9, (b2 + a12 * s) / a22, 0.0)
    t = jnp.clip(t, 0.0, 1.0)
    s = jnp.where(a11 > 1e-9, jnp.clip((a12 * t - b1) / a11, 0.0, 1.0), s)
    pa_c = v3.add(ea0, v3.scale(d1, s))
    pb_c = v3.add(eb0, v3.scale(d2v, t))
    edge_point = v3.scale(v3.add(pa_c, pb_c), 0.5)
    edge_depth = -edge_sep

    # ---- assemble slot-major depth rows (validity folded in) ----
    face_ok = ~separated & ~edge_wins                      # [P]
    depth_rows = []
    for s_i in range(cap):
        d_row = -ps[s_i]
        ok = (s_i < m_cnt) & (d_row > 0.0) & face_ok
        depth_rows.append(jnp.where(ok, d_row, 0.0))
    depth_rows.append(jnp.where(edge_wins & (edge_depth > 0.0),
                                edge_depth, 0.0))
    return SharedManifoldSM(
        depth=tuple(depth_rows), pu=pu, pv=pv, ps=ps,
        p0=p0, t1=t1, t2=t2, n_ref=n_ref, n_face=n_face,
        edge_point=edge_point, n_edge=n_edge,
    )


def hull_pair_manifolds_shared(
    state, cand, cfg,
) -> Tuple[Array, Array, Array]:
    """Old-contract wrapper over `shared_hull_manifolds_sm` for
    mixed-shape scenes: (depth [P, S], normal [P, S, 3], point [P, S, 3])
    with S = 2E + 1, matching the vmapped hull path's hull_parts. The
    hulls_only fast path bypasses this (it consumes the slot-major
    pieces directly, ops/narrowphase._pair_contacts_hulls_fast)."""
    sm = shared_hull_manifolds_sm(state, cand, cfg)
    cap = sm.pu.shape[0]
    pts = []
    nrm = []
    for s_i in range(cap):
        pts.append(tuple(
            sm.p0[c] + sm.pu[s_i] * sm.t1[c] + sm.pv[s_i] * sm.t2[c]
            + sm.ps[s_i] * sm.n_ref[c]
            for c in range(3)))
        nrm.append(sm.n_face)
    pts.append(sm.edge_point)
    nrm.append(sm.n_edge)
    depth = jnp.stack(sm.depth, axis=1)                    # [P, S]
    normal = jnp.stack([v3.pack(nr) for nr in nrm], axis=1)
    point = jnp.stack([v3.pack(pt) for pt in pts], axis=1)
    return depth, normal, point
