"""Narrow phase: fixed-capacity contact generation.

New capability (the reference has no collision detection, SURVEY.md §0),
designed in the engine's constraint spirit: contacts are rows with a point,
a normal and a depth, consumed by the velocity-level impulse solver.

Accelerator-native design: every collidable body is presented as a *convex* —
a fixed-capacity vertex set plus a fixed-capacity face-plane set:

  * box   → 8 corners, 6 axis faces (generated on the fly from half extents)
  * hull  → preprocessed vertices/faces from the HullSet (OBJ pipeline)
  * sphere→ 1 vertex (the center) with a vertex radius r, 0 faces

Contact generation is then ONE vectorized kernel for every pair type:
vertices of A tested against face planes of B and vice versa (vertex-face
contacts, the dominant mode for resting/stacking), plus an analytic
sphere-sphere special case. Per pair the deepest `max_contacts_per_pair`
candidates are selected with top_k — fixed shapes, no dynamic allocation.

Known approximation (documented): edge-edge contact between deeply crossed
boxes and sphere-vs-corner contacts are not generated; face-region contacts
dominate the benchmark scenes (stacks, piles, rain).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig
from physics_tpu.maths import quaternion as quat
from physics_tpu.ops.boxbox import box_box_manifold
from physics_tpu.ops.broadphase import PairCandidates
from physics_tpu.state import SHAPE_BOX, SHAPE_HULL, SHAPE_SPHERE, SimState

Array = jnp.ndarray

_BOX_SIGNS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    np.float32,
)  # [8, 3]
_BOX_FACE_NORMALS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32,
)  # [6, 3]


class Contacts(NamedTuple):
    """Flat contact buffer. `normal` points from body_b toward body_a;
    a positive impulse pushes body_a along +normal. body_b == -1 ⇒ the
    static world (ground plane)."""

    body_a: Array   # [C] int32
    body_b: Array   # [C] int32
    point: Array    # [3, C] world (xyz-major: minor dim is the contact
                    # axis, see maths.vec3c layout note)
    normal: Array   # [3, C] world, unit (same layout)
    depth: Array    # [C] penetration (> 0 where active)
    active: Array   # [C] bool
    friction: Array # [C]
    restitution: Array  # [C]
    key: Array      # [C] int32 stable feature id for warm-start matching
                    # (pair keys ≥ 0, ground keys < 0; 0 on inactive slots)


class ConvexData(NamedTuple):
    """Per-body convex presentation (body frame), fixed capacity."""

    verts: Array        # [N, Vc, 3]
    vert_mask: Array    # [N, Vc] f32
    vert_radius: Array  # [N] sphere radius (0 for box/hull)
    face_n: Array       # [N, Fc, 3]
    face_off: Array     # [N, Fc]  (n·x ≤ off inside; padded faces off=+inf)
    is_sphere: Array    # [N] bool
    is_box: Array       # [N] bool
    is_hull: Array      # [N] bool
    has_faces: Array    # [N] bool (spheres and empty shapes have none)
    face_verts: Array   # [N, Fc, E] per-face polygon vertex ids (hulls)
    face_vert_count: Array  # [N, Fc]


def convex_data(state: SimState) -> ConvexData:
    """Build the unified convex presentation for all bodies (one per step)."""
    n = state.num_bodies
    hv = state.hulls.verts          # [H, Vh, 3]
    vh = hv.shape[1]
    fh = state.hulls.face_normals.shape[1]
    vc = max(8, vh)
    fc = max(6, fh)

    stype = state.shapes.stype
    params = state.shapes.params
    is_box = stype == SHAPE_BOX
    is_sphere = stype == SHAPE_SPHERE
    is_hull = stype == SHAPE_HULL

    # --- vertices ---
    box_verts = params[:, None, :] * jnp.asarray(_BOX_SIGNS)      # [N, 8, 3]
    box_verts = jnp.pad(box_verts, ((0, 0), (0, vc - 8), (0, 0)))
    hull_idx = jnp.clip(state.shapes.hull_index, 0, hv.shape[0] - 1)
    hull_verts = jnp.pad(hv[hull_idx], ((0, 0), (0, vc - vh), (0, 0)))
    verts = jnp.where(
        is_box[:, None, None], box_verts,
        jnp.where(is_hull[:, None, None], hull_verts, 0.0))

    arange_v = jnp.arange(vc, dtype=jnp.int32)[None, :]
    nvert = jnp.where(
        is_box, 8,
        jnp.where(is_hull, state.hulls.vert_count[hull_idx],
                  jnp.where(is_sphere, 1, 0)))
    vert_mask = (arange_v < nvert[:, None]).astype(jnp.float32)

    # --- faces ---
    box_n = jnp.broadcast_to(jnp.asarray(_BOX_FACE_NORMALS), (n, 6, 3))
    box_off = jnp.concatenate(
        [params[:, 0:1], params[:, 0:1], params[:, 1:2],
         params[:, 1:2], params[:, 2:3], params[:, 2:3]], axis=1)   # [N,6]
    box_n = jnp.pad(box_n, ((0, 0), (0, fc - 6), (0, 0)))
    box_off = jnp.pad(box_off, ((0, 0), (0, fc - 6)),
                      constant_values=jnp.inf)
    hull_n = jnp.pad(state.hulls.face_normals[hull_idx],
                     ((0, 0), (0, fc - fh), (0, 0)))
    hull_off = jnp.pad(state.hulls.face_offsets[hull_idx],
                       ((0, 0), (0, fc - fh)), constant_values=jnp.inf)
    face_n = jnp.where(is_box[:, None, None], box_n,
                       jnp.where(is_hull[:, None, None], hull_n, 0.0))
    face_off = jnp.where(is_box[:, None], box_off,
                         jnp.where(is_hull[:, None], hull_off, jnp.inf))

    radius = jnp.where(is_sphere, params[:, 0], 0.0)
    has_faces = is_box | (is_hull & (state.hulls.face_count[hull_idx] > 0))

    # per-face polygon vertex lists (hull-hull clipping); zeros for boxes
    emax = state.hulls.face_verts.shape[2]
    hull_fverts = jnp.pad(
        state.hulls.face_verts[hull_idx],
        ((0, 0), (0, fc - fh), (0, 0)),
    )
    hull_fvcnt = jnp.pad(
        state.hulls.face_vert_count[hull_idx], ((0, 0), (0, fc - fh))
    )
    face_verts = jnp.where(
        is_hull[:, None, None], hull_fverts, jnp.zeros_like(hull_fverts)
    )
    face_vert_count = jnp.where(
        is_hull[:, None], hull_fvcnt, jnp.zeros_like(hull_fvcnt)
    )

    return ConvexData(
        verts, vert_mask, radius, face_n, face_off, is_sphere, is_box,
        is_hull, has_faces, face_verts, face_vert_count,
    )


def _ground_contacts_boxes(state: SimState, cfg: SimConfig) -> Contacts:
    """boxes_only fast path: the 8 box corners against y = ground_height in
    component form — zero gather/scatter ops, where the generic path runs a
    top_k + take_along_axis over [N, Vc, 3] tensors."""
    from physics_tpu.maths import vec3c as v3
    from physics_tpu.ops.boxbox_batched import _argmax_unrolled, _select

    n = state.num_bodies
    k = min(cfg.max_contacts_per_pair, 8)
    gh = jnp.float32(cfg.ground_height)
    r9 = v3.quat_to_mat(state.quat)                    # 9 × [N]
    hx, hy, hz = (state.shapes.params[:, 0], state.shapes.params[:, 1],
                  state.shapes.params[:, 2])
    px, py, pz = state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]
    movable = state.inv_mass > 0.0
    is_box = state.shapes.stype == SHAPE_BOX

    # corner s: world = pos + R·(signs ∘ half); depth = gh − y
    pts, depth = [], []
    for s, (sx, sy, sz) in enumerate(_BOX_SIGNS):
        wx, wy, wz = sx * hx, sy * hy, sz * hz
        cx = px + r9[0] * wx + r9[1] * wy + r9[2] * wz
        cy = py + r9[3] * wx + r9[4] * wy + r9[5] * wz
        cz = pz + r9[6] * wx + r9[7] * wy + r9[8] * wz
        pts.append((cx, cy, cz))
        depth.append(gh - cy)

    valid_base = movable & is_box
    score = [jnp.where(valid_base & (d > 0.0), d, -jnp.inf) for d in depth]

    body = jnp.arange(n, dtype=jnp.int32)
    sel_d, sel_a, sel_k = [], [], []
    sel_p = [[], [], []]
    for _ in range(k):
        best, bidx = _argmax_unrolled(score)
        active = jnp.isfinite(best) & (best > 0.0)
        pt = _select(bidx, pts)
        for cc in range(3):
            sel_p[cc].append(pt[cc])
        sel_d.append(jnp.where(active, best, 0.0))
        sel_a.append(active)
        # ground feature key: negative range, (body, corner) identity
        sel_k.append(jnp.where(active, -(body * 8 + bidx + 1), 0))
        score = [jnp.where(bidx == s, -jnp.inf, score[s]) for s in range(8)]

    cat = lambda xs: jnp.concatenate(xs)               # slot-major [k·N]
    zeros = jnp.zeros((k * n,), jnp.float32)
    return Contacts(
        body_a=jnp.concatenate([body] * k),
        body_b=jnp.full((k * n,), -1, jnp.int32),
        point=jnp.stack([cat(sel_p[c]) for c in range(3)]),
        normal=jnp.stack([zeros, jnp.ones((k * n,), jnp.float32), zeros]),
        depth=cat(sel_d),
        active=cat(sel_a),
        friction=jnp.concatenate([state.shapes.friction] * k),
        restitution=jnp.concatenate([state.shapes.restitution] * k),
        key=cat(sel_k),
    )


def _ground_contacts_hulls_fast(state: SimState, cfg: SimConfig
                                ) -> Contacts:
    """Ground contacts for hulls_only shared-hull scenes, slot-major:
    vertex heights as ONE [V, N] outer-product table (world y of vertex u
    on body b = pos_y[b] + R_b row 1 · v_u), per-column argmax + one-hot
    contraction for the top-k selection, world points reconstructed only
    for the k SELECTED vertices — no [N, Vc, 3] world-vertex tensor.

    Same contact semantics as the generic `ground_contacts` (deepest-k
    vertices below the plane, point = world vertex, normal +y); keys are
    −(body·V + vertex + 1), the ground range of the path's key space."""
    from physics_tpu.maths import vec3c as v3

    n = state.num_bodies
    n_hulls = state.hulls.verts.shape[0]
    vcap = state.hulls.verts.shape[1]
    r9 = v3.quat_to_mat(state.quat)                    # 9 × [N]
    if n_hulls == 1:
        t_oh = None
    else:
        # per-body hull-type one-hot: each type's [V, N] height table is
        # computed once and masked in (H small — MAX_FAST_HULL_TYPES)
        tidx = jnp.clip(state.shapes.hull_index, 0, n_hulls - 1)
        t_oh = [(tidx == t)[None, :].astype(jnp.float32)
                for t in range(n_hulls)]

    def typed(fn):
        """Σ_t mask_t · fn(type t's vertex table) — [V, N] (or [V, 1])."""
        if t_oh is None:
            return fn(0)
        acc = None
        for t in range(n_hulls):
            term = fn(t) * t_oh[t]
            acc = term if acc is None else acc + term
        return acc

    def vcol(t, c):
        return state.hulls.verts[t][:, c:c + 1]        # [V, 1]

    wy = typed(lambda t: (
        vcol(t, 0) * r9[3][None, :] + vcol(t, 1) * r9[4][None, :]
        + vcol(t, 2) * r9[5][None, :]))
    wy = wy + state.pos[:, 1][None, :]                 # [V, N]
    vmask = typed(lambda t: jnp.broadcast_to(
        (jnp.arange(vcap) < state.hulls.vert_count[t])[:, None]
        .astype(jnp.float32), (vcap, 1))) > 0.0
    depth = jnp.float32(cfg.ground_height) - wy
    valid = (depth > 0.0) & (state.inv_mass > 0.0)[None, :] & vmask
    big_neg = jnp.float32(-1e30)
    score = jnp.where(valid, depth, big_neg)

    k = min(cfg.max_contacts_per_pair, 8, vcap)
    body = jnp.arange(n, dtype=jnp.int32)
    v_iota = jax.lax.broadcasted_iota(jnp.int32, (vcap, n), 0)
    pt_c = [[], [], []]
    d_c, act_c, key_c = [], [], []
    for _ in range(k):
        best = jnp.max(score, axis=0)                  # [N]
        bidx = jnp.argmax(score, axis=0)
        oh = (v_iota == bidx[None, :]).astype(jnp.float32)
        act = best > 0.0
        lx = jnp.sum(oh * typed(lambda t: vcol(t, 0)), axis=0)
        ly = jnp.sum(oh * typed(lambda t: vcol(t, 1)), axis=0)
        lz = jnp.sum(oh * typed(lambda t: vcol(t, 2)), axis=0)
        pt_c[0].append(state.pos[:, 0] + r9[0] * lx + r9[1] * ly
                       + r9[2] * lz)
        pt_c[1].append(state.pos[:, 1] + r9[3] * lx + r9[4] * ly
                       + r9[5] * lz)
        pt_c[2].append(state.pos[:, 2] + r9[6] * lx + r9[7] * ly
                       + r9[8] * lz)
        d_c.append(jnp.where(act, best, 0.0))
        act_c.append(act)
        key_c.append(jnp.where(act, -(body * vcap + bidx + 1), 0))
        score = jnp.where(oh > 0.0, big_neg, score)

    cat = jnp.concatenate
    rep = lambda x: jnp.concatenate([x] * k)
    ck = n * k
    return Contacts(
        body_a=rep(body),
        body_b=jnp.full((ck,), -1, jnp.int32),
        point=jnp.stack([cat(c) for c in pt_c]),
        normal=jnp.stack([jnp.zeros((ck,), jnp.float32),
                          jnp.ones((ck,), jnp.float32),
                          jnp.zeros((ck,), jnp.float32)]),
        depth=cat(d_c),
        active=cat(act_c),
        friction=rep(state.shapes.friction),
        restitution=rep(state.shapes.restitution),
        key=cat(key_c),
    )


def ground_contacts(state: SimState, cvx: ConvexData, cfg: SimConfig
                    ) -> Contacts:
    """Contacts of every body's vertices against the plane y = ground_height.

    Up to min(8, Vc) contacts per body, deepest-first (top_k)."""
    if hulls_fast_path(state, cfg):
        # slot-major shared-hull path (backend-independent XLA ops)
        return _ground_contacts_hulls_fast(state, cfg)
    if boxes_fast_path(cfg):
        return _ground_contacts_boxes(state, cfg)
    n = state.num_bodies
    rot = quat.to_matrix(state.quat)                                   # [N,3,3]
    verts_w = state.pos[:, None, :] + jnp.einsum(
        "nij,nvj->nvi", rot, cvx.verts)                                # [N,Vc,3]
    rho = cvx.vert_radius[:, None]
    depth = (jnp.float32(cfg.ground_height)
             - (verts_w[..., 1] - rho)) * cvx.vert_mask                # [N,Vc]
    movable = (state.inv_mass > 0.0)[:, None]
    valid = (depth > 0.0) & movable & (cvx.vert_mask > 0)

    k = min(cfg.max_contacts_per_pair, depth.shape[1])
    score = jnp.where(valid, depth, -jnp.inf)
    top_score, top_idx = jax.lax.top_k(score, k)                       # [N,k]
    sel = jnp.take_along_axis(verts_w, top_idx[..., None], axis=1)     # [N,k,3]
    active = jnp.isfinite(top_score) & (top_score > 0.0)

    normal = jnp.broadcast_to(
        jnp.array([0.0, 1.0, 0.0], jnp.float32), (n, k, 3))
    rho_sel = jnp.broadcast_to(rho, depth.shape)
    rho_sel = jnp.take_along_axis(rho_sel, top_idx, axis=1)
    point = sel - normal * rho_sel[..., None]

    body_a = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, k))
    mu = jnp.broadcast_to(state.shapes.friction[:, None], (n, k))
    rest = jnp.broadcast_to(state.shapes.restitution[:, None], (n, k))

    # ground feature key: negative range, (body, source-vertex) identity
    vc = verts_w.shape[1]
    key = -(body_a * vc + top_idx + 1)
    key = jnp.where(active, key, 0)

    return Contacts(
        body_a=body_a.reshape(-1),
        body_b=jnp.full((n * k,), -1, jnp.int32),
        point=point.reshape(-1, 3).T,
        normal=normal.reshape(-1, 3).T,
        depth=jnp.where(active, top_score, 0.0).reshape(-1),
        active=active.reshape(-1),
        friction=mu.reshape(-1),
        restitution=rest.reshape(-1),
        key=key.reshape(-1),
    )


def _vertex_face_candidates(
    pos_a, rot_a, verts_a, mask_a, rho_a,
    pos_b, rot_b, face_n_b, face_off_b,
):
    """Vertices of A (world) against face planes of B (world).

    Returns per-vertex (depth [P,Vc], normal B→A [P,Vc,3], point [P,Vc,3]).
    """
    va_w = pos_a[:, None, :] + jnp.einsum("pij,pvj->pvi", rot_a, verts_a)
    nb_w = jnp.einsum("pij,pfj->pfi", rot_b, face_n_b)                 # [P,Fc,3]
    off_w = face_off_b + jnp.einsum("pfi,pi->pf", nb_w, pos_b)         # [P,Fc]

    # signed distance of each vertex to each face plane; sd = max over faces
    sd_all = jnp.einsum("pfi,pvi->pvf", nb_w, va_w) - off_w[:, None, :]
    sd = jnp.max(sd_all, axis=-1)                                      # [P,Vc]
    face_idx = jnp.argmax(sd_all, axis=-1)                             # [P,Vc]
    normal = jnp.take_along_axis(
        nb_w, face_idx[..., None], axis=1)                             # [P,Vc,3]

    # where(mask) rather than *mask: sd is -inf when B has no live faces,
    # and inf·0 would poison the buffer with NaNs
    depth = jnp.where(mask_a > 0, rho_a[:, None] - sd, 0.0)
    depth = jnp.where(jnp.isfinite(depth), depth, 0.0)
    point = va_w - normal * (rho_a[:, None] - 0.5 * depth)[..., None]
    return depth, normal, point


def _pair_contacts_boxes(state: SimState, cand: PairCandidates,
                         cfg: SimConfig) -> Contacts:
    """boxes_only fast path: batched component-form SAT (ops.boxbox_batched)
    with an unrolled top-k slot selection — no [P, slots, 3] tensors are
    ever materialized."""
    from physics_tpu.maths import vec3c as v3
    from physics_tpu.ops.boxbox_batched import (
        _CAP, _argmax_unrolled, _select, box_box_manifold_batched,
    )

    ia, ib = cand.body_a, cand.body_b
    p = ia.shape[0]
    kk = min(cfg.max_contacts_per_pair, _CAP)
    n = state.num_bodies

    # packed per-body table → ONE lane gather per endpoint (2 gather ops
    # replace 36 per-field ones)
    # rows: pos(0:3) | R row-major(3:12) | half(12:15) | friction(15) |
    # restitution(16) | movable(17)
    r9 = v3.quat_to_mat(state.quat)
    table = jnp.stack(
        [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]]
        + list(r9)
        + [state.shapes.params[:, 0], state.shapes.params[:, 1],
           state.shapes.params[:, 2], state.shapes.friction,
           state.shapes.restitution,
           (state.inv_mass > 0).astype(jnp.float32)]
    )                                                  # [18, N]
    from physics_tpu.ops.bodygather import lane_gather

    ta = lane_gather(table, ia)                        # [18, P]
    tb = lane_gather(table, ib)                        # [18, P]

    man = box_box_manifold_batched(
        (ta[0], ta[1], ta[2]), tuple(ta[3 + k] for k in range(9)),
        (ta[12], ta[13], ta[14]),
        (tb[0], tb[1], tb[2]), tuple(tb[3 + k] for k in range(9)),
        (tb[12], tb[13], tb[14]),
    )

    # keep the SAT manifold and the slot selection in separate XLA
    # fusions: fused together, XLA:CPU pathologically hangs compiling (or
    # executing) the combined kernel
    man = jax.tree_util.tree_map(jax.lax.optimization_barrier, man)

    movable = (ta[17] > 0) | (tb[17] > 0)
    base = cand.mask & movable
    score = [
        jnp.where(man.valid[s] & base, man.depth[s], -jnp.inf)
        for s in range(_CAP)
    ]

    mu = jnp.sqrt(ta[15] * tb[15])
    rest = jnp.maximum(ta[16], tb[16])
    amin = jnp.minimum(ia, ib)
    amax = jnp.maximum(ia, ib)
    has_key = n * n * _CAP < 2**31 - 1
    base_key = (amin * n + amax) * _CAP if has_key else None

    sel_d, sel_a, sel_k = [], [], []
    sel_p = [[], [], []]
    for _ in range(kk):
        best, bidx = _argmax_unrolled(score)
        active = jnp.isfinite(best) & (best > 0.0)
        pt = _select(bidx, man.points)
        for c in range(3):
            sel_p[c].append(pt[c])
        sel_d.append(jnp.where(active, best, 0.0))
        sel_a.append(active)
        if has_key:
            sel_k.append(jnp.where(active, base_key + bidx, 0))
        else:
            sel_k.append(jnp.zeros_like(ia))
        # retire the chosen slot
        score = [
            jnp.where(bidx == s, -jnp.inf, score[s]) for s in range(_CAP)
        ]

    cat = lambda xs: jnp.concatenate(xs)                 # slot-major [kk·P]
    point = jnp.stack([cat(sel_p[c]) for c in range(3)])     # [3, kk·P]
    normal = jnp.stack(
        [jnp.concatenate([man.normal[c]] * kk) for c in range(3)]
    )
    rep = lambda x: jnp.concatenate([x] * kk)
    return Contacts(
        body_a=rep(ia),
        body_b=rep(ib),
        point=point,
        normal=normal,
        depth=cat(sel_d),
        active=cat(sel_a),
        friction=rep(mu),
        restitution=rep(rest),
        key=cat(sel_k),
    )


def hull_obb_prefilter(
    state: SimState, cand: PairCandidates, cap2: int
) -> Tuple[PairCandidates, Array]:
    """Two-phase hull narrow phase, phase 1: OBB face-axis SAT.

    Each body's hull is bounded by its local AABB (center co, half
    extents h — padded hull vertices repeat vertex 0, so min/max over
    the full capacity is exact). A pair whose OBBs are separated on one
    of the 6 FACE axes has separated hulls (hull ⊆ OBB) and is dropped;
    survivors compact order-preservingly to `cap2` lanes. Pure component
    form — ~60 [P]-row flops per pair, no vertex factor.

    Multi-hull-type scenes (H > 1): the compaction is SEGMENTED by
    ordered hull-type pair — output lanes [s·(cap2/H²), (s+1)·(cap2/H²))
    hold only (type_a, type_b) = (s // H, s % H) candidates, so each
    downstream manifold segment runs the type pair's own static
    coefficient tables (ops/hullhull_batched.build_hull_tables) at zero
    extra lane cost vs the single-type path. Per-segment survivors
    beyond the segment cap are counted into the returned overflow.

    Returns (compacted candidates [≈cap2], overflow [] int32 — survivors
    dropped, never silent).
    """
    from physics_tpu.maths import vec3c as v3

    hulls = state.hulls
    n_hulls = hulls.verts.shape[0]
    lo = jnp.min(hulls.verts, axis=1)                      # [H, 3]
    hi = jnp.max(hulls.verts, axis=1)
    co_t = (lo + hi) * 0.5                                 # [H, 3] centers
    h_t = (hi - lo) * 0.5                                  # [H, 3] halves

    ia, ib = cand.body_a, cand.body_b
    tidx = jnp.clip(state.shapes.hull_index, 0, n_hulls - 1)
    ta_t = tidx[ia]                                        # [P] type ids
    tb_t = tidx[ib]
    if n_hulls == 1:
        co_a = co_b = tuple(co_t[0, c] for c in range(3))
        h_a = h_b = tuple(h_t[0, c] for c in range(3))
    else:
        co_a = tuple(co_t[ta_t, c] for c in range(3))      # [P] rows
        co_b = tuple(co_t[tb_t, c] for c in range(3))
        h_a = tuple(h_t[ta_t, c] for c in range(3))
        h_b = tuple(h_t[tb_t, c] for c in range(3))
    ra9 = v3.quat_to_mat(state.quat[ia])                   # 9 × [P]
    rb9 = v3.quat_to_mat(state.quat[ib])

    def obb_center(r9, pos, co):
        return tuple(
            pos[:, c] + r9[3 * c] * co[0] + r9[3 * c + 1] * co[1]
            + r9[3 * c + 2] * co[2]
            for c in range(3))

    ca = obb_center(ra9, state.pos[ia], co_a)
    cb = obb_center(rb9, state.pos[ib], co_b)
    t = v3.sub(cb, ca)

    # |column_i(Ra) · column_j(Rb)| — the box face-SAT radii terms
    cabs = [[jnp.abs(ra9[i] * rb9[j] + ra9[3 + i] * rb9[3 + j]
                     + ra9[6 + i] * rb9[6 + j]) for j in range(3)]
            for i in range(3)]
    sep = None
    for i in range(3):
        ut = ra9[i] * t[0] + ra9[3 + i] * t[1] + ra9[6 + i] * t[2]
        rad = (h_a[i] + h_b[0] * cabs[i][0] + h_b[1] * cabs[i][1]
               + h_b[2] * cabs[i][2])
        s = jnp.abs(ut) - rad
        sep = s if sep is None else jnp.maximum(sep, s)
    for j in range(3):
        wt = rb9[j] * t[0] + rb9[3 + j] * t[1] + rb9[6 + j] * t[2]
        rad = (h_b[j] + h_a[0] * cabs[0][j] + h_a[1] * cabs[1][j]
               + h_a[2] * cabs[2][j])
        sep = jnp.maximum(sep, jnp.abs(wt) - rad)

    keep = cand.mask & (sep < 0.0)
    p = keep.shape[0]
    if n_hulls == 1:
        # order-preserving compaction: unique integer keys (kept pairs
        # keep their index, dropped pairs shift past P)
        key = jnp.where(keep, 0, p) + jnp.arange(p, dtype=jnp.int32)
        idx = jnp.argsort(key)[:cap2]
        kept = keep[idx]
        overflow = jnp.maximum(
            jnp.sum(keep.astype(jnp.int32)) - cap2, 0)
    else:
        # segmented compaction: one [H², P] row-keyed sort, first
        # seg_cap survivors per ordered type pair (static bases)
        n_seg = n_hulls * n_hulls
        seg_cap = max(cap2 // n_seg, 1)
        sid = ta_t * n_hulls + tb_t                        # [P]
        idx_p = jnp.arange(p, dtype=jnp.int32)
        seg_iota = jnp.arange(n_seg, dtype=jnp.int32)[:, None]
        keym = jnp.where(keep[None, :] & (sid[None, :] == seg_iota),
                         idx_p[None, :], p)                # [n_seg, P]
        keym_s = jax.lax.sort(keym, dimension=1)[:, :seg_cap]
        idx = jnp.minimum(keym_s, p - 1).reshape(-1)
        kept = (keym_s < p).reshape(-1)
        counts = jnp.sum((keym < p).astype(jnp.int32), axis=1)
        overflow = jnp.sum(jnp.maximum(counts - seg_cap, 0))
    # ONE row-stacked gather for both index fields
    packed = jnp.stack([cand.body_a, cand.body_b])[:, idx]
    packed = jnp.where(kept[None, :], packed, 0)
    return PairCandidates(
        body_a=packed[0],
        body_b=packed[1],
        mask=kept,
        overflow=cand.overflow,
    ), overflow


MAX_FAST_HULL_TYPES = 4   # H² coefficient-table sets + H² segments


def _step_platform() -> str:
    """The platform a step traced now will run on: the `jax.default_device`
    in effect, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def boxes_fast_path(cfg: SimConfig) -> bool:
    """True when boxes_only scenes take the component-form box fast paths
    (`_ground_contacts_boxes`, `_pair_contacts_boxes`) instead of the
    generic convex pipeline. Both produce the same contacts
    (tests/test_boxes_only_path.py). Off on the CPU only: there the fast
    path's composed graph makes XLA:CPU emit pathologically slow code
    (~1000x the generic path), so CPU runs keep the generic path.
    Static: cfg + platform."""
    return bool(cfg.boxes_only) and _step_platform() != "cpu"


def hulls_fast_path(state: SimState, cfg: SimConfig) -> bool:
    """True when pair_contacts routes through the slot-major hull fast
    path (_pair_contacts_hulls_fast). Static: cfg + capacities only.

    Multi-hull-type scenes ride the same path via type-pair-segmented
    candidates, which requires the OBB prefilter (it performs the
    segmentation): H ≤ MAX_FAST_HULL_TYPES and hull_prefilter_cap > 0."""
    n_hulls = state.hulls.verts.shape[0]
    return bool(
        cfg.hulls_only and cfg.hull_fast
        and 1 <= n_hulls <= MAX_FAST_HULL_TYPES
        and (n_hulls == 1 or cfg.hull_prefilter_cap > 0)
        and state.hulls.verts.shape[1] > 1
    )


def _pair_contacts_hulls_fast(state: SimState, cand: PairCandidates,
                              cfg: SimConfig) -> Contacts:
    """Contacts for hulls_only single-shared-hull scenes (mesh rain),
    slot-major end to end: the manifold pieces arrive as [P] component
    rows (ops/hullhull_batched.shared_hull_manifolds_sm), per-pair top-k
    selection is `k` unrolled argmax passes over the S depth rows, and
    ONLY the selected slots' world points are reconstructed (3 slot
    selects + a few flops each) — no [P, S, 3] tensors, no top_k +
    take_along_axis gathers on minor-dim-3 layouts.

    Emits the same feature keys as the generic epilogue
    ((min·n + max)·S + slot — the pre-selection slot id is the stable
    feature identity) so warm-start matching is path-independent;
    contact ORDER differs (slot-major, like _pair_contacts_boxes) which
    downstream consumers never rely on (the depth compaction re-sorts,
    keys are content-based)."""
    n_hulls = state.hulls.verts.shape[0]
    if n_hulls == 1:
        segs = [(cand, (0, 0))]
    else:
        # type-pair-segmented candidates (hull_obb_prefilter): static
        # equal-width segments in ordered type-pair order
        n_seg = n_hulls * n_hulls
        p_tot = cand.body_a.shape[0]
        seg_cap = p_tot // n_seg
        assert seg_cap * n_seg == p_tot, (
            "multi-hull fast path needs type-pair-segmented candidates "
            "(run hull_obb_prefilter: cfg.hull_prefilter_cap > 0)")
        segs = []
        for s in range(n_seg):
            sl = slice(s * seg_cap, (s + 1) * seg_cap)
            c_s = PairCandidates(
                cand.body_a[sl], cand.body_b[sl], cand.mask[sl],
                cand.overflow)
            segs.append((c_s, (s // n_hulls, s % n_hulls)))

    parts = [_hull_fast_select_rows(state, c_s, cfg, types)
             for c_s, types in segs]
    kk = parts[0]["kk"]
    cat = jnp.concatenate

    def slotcat(field):
        # slot-major over the FULL candidate list: slot row k = the
        # segments' k-th rows concatenated
        return cat([cat([pt[field][k] for pt in parts])
                    for k in range(kk)])

    def repcat(field):
        return cat([cat([pt[field] for pt in parts])] * kk)

    return Contacts(
        body_a=repcat("ia"),
        body_b=repcat("ib"),
        point=jnp.stack([slotcat(f"pt{c}") for c in range(3)]),
        normal=jnp.stack([slotcat(f"nm{c}") for c in range(3)]),
        depth=slotcat("d"),
        active=slotcat("act"),
        friction=repcat("mu"),
        restitution=repcat("rest"),
        key=slotcat("key"),
    )


def _hull_fast_select_rows(state: SimState, cand: PairCandidates,
                           cfg: SimConfig, types) -> dict:
    """One type-pair segment of the hull fast path: slot-major manifolds
    + kk argmax selection passes. Returns per-field row lists ([P] lane
    rows; kk entries for slot-major fields)."""
    from physics_tpu.ops.boxbox_batched import _argmax_unrolled, _select
    from physics_tpu.ops.hullhull_batched import shared_hull_manifolds_sm

    ia, ib = cand.body_a, cand.body_b
    p = ia.shape[0]
    sm = shared_hull_manifolds_sm(state, cand, cfg, types=types)
    cap = sm.pu.shape[0]
    ns = cap + 1                                           # slots incl. edge

    # ONE [4, N] row-stacked table gathered once per side, in place of 8
    # latency-bound [P]-row gathers of inv_mass/stype/friction/restitution
    btab = jnp.stack([
        (state.inv_mass > 0).astype(jnp.float32),
        (state.shapes.stype == SHAPE_HULL).astype(jnp.float32),
        state.shapes.friction,
        state.shapes.restitution,
    ])
    ta = btab[:, ia]                                       # [4, P]
    tb = btab[:, ib]
    movable = (ta[0] > 0) | (tb[0] > 0)
    base_valid = cand.mask & movable & (ta[1] > 0) & (tb[1] > 0)

    big_neg = jnp.float32(-1e30)
    score = [jnp.where(base_valid & (sm.depth[s] > 0.0), sm.depth[s],
                       big_neg) for s in range(ns)]

    n = state.num_bodies
    amin = jnp.minimum(ia, ib)
    amax = jnp.maximum(ia, ib)
    has_key = n * n * ns < 2**31 - 1
    base_key = (amin * n + amax) * ns if has_key else None
    out = {
        "ia": ia, "ib": ib,
        "mu": jnp.sqrt(ta[2] * tb[2]),
        "rest": jnp.maximum(ta[3], tb[3]),
        "d": [], "act": [], "key": [], "kk": 0,
    }
    for c in range(3):
        out[f"pt{c}"] = []
        out[f"nm{c}"] = []

    kk = min(cfg.max_contacts_per_pair, ns)
    out["kk"] = kk
    zero_p = jnp.zeros((p,), jnp.float32)
    pu_rows = [sm.pu[s] for s in range(cap)] + [zero_p]
    pv_rows = [sm.pv[s] for s in range(cap)] + [zero_p]
    ps_rows = [sm.ps[s] for s in range(cap)] + [zero_p]
    for _ in range(kk):
        best, bidx = _argmax_unrolled(score)
        act = best > 0.0
        is_edge = bidx == jnp.int32(cap)
        u_sel = _select(bidx, pu_rows)
        v_sel = _select(bidx, pv_rows)
        s_sel = _select(bidx, ps_rows)
        for c in range(3):
            pt_face = (sm.p0[c] + u_sel * sm.t1[c] + v_sel * sm.t2[c]
                       + s_sel * sm.n_ref[c])
            out[f"pt{c}"].append(
                jnp.where(is_edge, sm.edge_point[c], pt_face))
            out[f"nm{c}"].append(
                jnp.where(is_edge, sm.n_edge[c], sm.n_face[c]))
        out["d"].append(jnp.where(act, best, 0.0))
        out["act"].append(act)
        if has_key:
            out["key"].append(jnp.where(act, base_key + bidx, 0))
        else:
            out["key"].append(jnp.zeros((p,), jnp.int32))
        score = [jnp.where(bidx == s, big_neg, score[s])
                 for s in range(ns)]
    return out


def pair_contacts(state: SimState, cvx: ConvexData,
                  cand: PairCandidates, cfg: SimConfig) -> Contacts:
    """Contacts for the broad-phase candidate pairs (fixed [P·K] output)."""
    if hulls_fast_path(state, cfg):
        # single shared hull shape: slot-major manifolds + slot-major
        # top-k epilogue — no [P, S, 3] tensors anywhere in the hot loop
        return _pair_contacts_hulls_fast(state, cand, cfg)
    if boxes_fast_path(cfg):
        return _pair_contacts_boxes(state, cand, cfg)

    ia, ib = cand.body_a, cand.body_b
    p = ia.shape[0]
    k = cfg.max_contacts_per_pair

    rot = quat.to_matrix(state.quat)
    pos_a, pos_b = state.pos[ia], state.pos[ib]
    rot_a, rot_b = rot[ia], rot[ib]

    # SAT + face-clipping manifold for box-box pairs (vertex-face testing
    # degenerates for identical-footprint stacks; see ops/boxbox.py).
    # hulls_only scenes skip it entirely (both_box is all-false there).
    if not cfg.hulls_only:
        both_box = cvx.is_box[ia] & cvx.is_box[ib]
        sat_p, sat_n, sat_d, sat_valid = jax.vmap(box_box_manifold)(
            pos_a, rot_a, state.shapes.params[ia],
            pos_b, rot_b, state.shapes.params[ib],
        )
        sat_d = jnp.where(sat_valid & both_box[:, None], sat_d, 0.0)

    # hull-hull manifolds: face-SAT + clipping (ops/hullhull.py); only
    # traced when the scene actually registers hull geometry
    hull_parts = None
    if not cfg.boxes_only and state.hulls.verts.shape[1] > 1:
        from physics_tpu.ops.hullhull import HullData, hull_hull_manifold

        both_hull = cvx.is_hull[ia] & cvx.is_hull[ib]
        use_hull_fast = cfg.hull_fast and state.hulls.verts.shape[0] == 1
        if use_hull_fast:
            # single shared hull shape: all pairwise SAT supports via
            # static [rows, 9] × [9, P] matmuls against the relative
            # rotation (ops/hullhull_batched.py) — no per-pair geometry
            # gathers, pairs ride the lane axis
            from physics_tpu.ops.hullhull_batched import (
                hull_pair_manifolds_shared,
            )

            hh_d, hh_n, hh_p = hull_pair_manifolds_shared(state, cand, cfg)
            hh_d = jnp.where(both_hull[:, None], hh_d, 0.0)
            hull_parts = (hh_d, hh_n, hh_p, both_hull)
        face_mask = jnp.isfinite(cvx.face_off).astype(jnp.float32)
        hull_idx = jnp.clip(
            state.shapes.hull_index, 0, state.hulls.verts.shape[0] - 1)
        ed = state.hulls.edge_dirs[hull_idx]               # [N, D, 3]
        ed_cnt = state.hulls.edge_dir_count[hull_idx]
        ed_mask = (
            jnp.arange(ed.shape[1])[None, :] < ed_cnt[:, None]
        ).astype(jnp.float32)
        ei0 = state.hulls.edge_i0[hull_idx]                # [N, E]
        ei1 = state.hulls.edge_i1[hull_idx]
        e_cnt = state.hulls.edge_count[hull_idx]
        e_mask = (
            jnp.arange(ei0.shape[1])[None, :] < e_cnt[:, None]
        ).astype(jnp.float32)

        def hdata(idx):
            return HullData(
                verts=cvx.verts[idx],
                vert_mask=cvx.vert_mask[idx],
                face_n=cvx.face_n[idx],
                face_off=cvx.face_off[idx],
                face_mask=face_mask[idx],
                face_verts=cvx.face_verts[idx],
                face_vert_count=cvx.face_vert_count[idx],
                edge_dirs=ed[idx],
                edge_dir_mask=ed_mask[idx],
                edge_i0=ei0[idx],
                edge_i1=ei1[idx],
                edge_mask=e_mask[idx],
            )

        if not use_hull_fast:
            hh_p, hh_n, hh_d, hh_v = jax.vmap(hull_hull_manifold)(
                pos_a, rot_a, hdata(ia), pos_b, rot_b, hdata(ib)
            )
            hh_d = jnp.where(hh_v & both_hull[:, None], hh_d, 0.0)
            hull_parts = (hh_d, hh_n, hh_p, both_hull)

    if cfg.hulls_only:
        # hull manifolds are the only candidate source — no box SAT,
        # sphere analytics, or vertex-face probes to merge/mask out
        if hull_parts is None:
            raise ValueError(
                "cfg.hulls_only but the scene registers no hull geometry")
        depth, normal, point, _ = hull_parts
    else:
        # direction 1: A's vertices vs B's faces (normal outward from B=B→A)
        d1, n1, p1 = _vertex_face_candidates(
            pos_a, rot_a, cvx.verts[ia], cvx.vert_mask[ia],
            cvx.vert_radius[ia], pos_b, rot_b,
            cvx.face_n[ib], cvx.face_off[ib])
        d1 = jnp.where(cvx.has_faces[ib][:, None], d1, 0.0)
        # direction 2: B's vertices vs A's faces (flip normal to keep B→A)
        d2, n2, p2 = _vertex_face_candidates(
            pos_b, rot_b, cvx.verts[ib], cvx.vert_mask[ib],
            cvx.vert_radius[ib], pos_a, rot_a,
            cvx.face_n[ia], cvx.face_off[ia])
        d2 = jnp.where(cvx.has_faces[ia][:, None], d2, 0.0)
        n2 = -n2
        # vertex-face candidates only apply to non-box-box pairs
        d1 = jnp.where(both_box[:, None], 0.0, d1)
        d2 = jnp.where(both_box[:, None], 0.0, d2)

        depth = jnp.concatenate([d1, d2, sat_d], axis=1)     # [P, 2Vc+8]
        normal = jnp.concatenate([n1, n2, sat_n], axis=1)
        point = jnp.concatenate([p1, p2, sat_p], axis=1)

        # sphere-box analytic contact (closest point on the OBB): exact in
        # face, edge AND corner regions — the vertex-face candidate above
        # only handles face regions (its max-over-planes normal is wrong
        # past an edge). Replaces slot 1 for sphere-box pairs.
        sb_ab = cvx.is_sphere[ia] & cvx.is_box[ib]   # A sphere, B box
        sb_ba = cvx.is_box[ia] & cvx.is_sphere[ib]
        sb_any = sb_ab | sb_ba
        s_pos = jnp.where(sb_ab[:, None], pos_a, pos_b)
        s_r = jnp.where(sb_ab, cvx.vert_radius[ia], cvx.vert_radius[ib])
        b_pos = jnp.where(sb_ab[:, None], pos_b, pos_a)
        b_rot = jnp.where(sb_ab[:, None, None], rot_b, rot_a)
        b_half = jnp.where(sb_ab[:, None], state.shapes.params[ib],
                           state.shapes.params[ia])
        loc = jnp.einsum("pji,pj->pi", b_rot, s_pos - b_pos)   # box frame
        clamped = jnp.clip(loc, -b_half, b_half)
        diff = loc - clamped
        dist = jnp.linalg.norm(diff, axis=-1)
        outside = dist > 1e-9
        # outside: push along center→closest-point; inside: push out the
        # face of least penetration
        pen_ax = b_half - jnp.abs(loc)                         # [P,3] ≥ 0 in
        ax = jnp.argmin(pen_ax, axis=-1)
        ax_oh = jax.nn.one_hot(ax, 3, dtype=loc.dtype)
        n_in = ax_oh * jnp.sign(
            jnp.take_along_axis(loc, ax[:, None], -1))
        n_loc = jnp.where(outside[:, None],
                          diff / jnp.maximum(dist, 1e-9)[:, None], n_in)
        sb_depth = jnp.where(
            outside, s_r - dist,
            s_r + jnp.take_along_axis(pen_ax, ax[:, None], -1)[:, 0])
        surf = jnp.where(outside[:, None], clamped,
                         clamped + n_loc * pen_ax)
        n_w_raw = jnp.einsum("pij,pj->pi", b_rot, n_loc)
        # world normal box→sphere; flip when the sphere is body B
        n_w = jnp.where(sb_ab[:, None], n_w_raw, -n_w_raw)
        # contact point: halfway between the two surfaces (matches the
        # sphere-sphere convention)
        p_w = (b_pos + jnp.einsum("pij,pj->pi", b_rot, surf)
               + n_w_raw * (0.5 * sb_depth)[:, None])
        depth = depth.at[:, 1].set(
            jnp.where(sb_any, sb_depth, depth[:, 1]))
        normal = normal.at[:, 1].set(
            jnp.where(sb_any[:, None], n_w, normal[:, 1]))
        point = point.at[:, 1].set(
            jnp.where(sb_any[:, None], p_w, point[:, 1]))
        # a sphere touches a convex at exactly one point; kill the
        # vertex-face duplicates for sphere-box pairs
        sb_kill = sb_any[:, None] & (
            jnp.arange(depth.shape[1])[None, :] != 1)
        depth = jnp.where(sb_kill, 0.0, depth)

        # sphere-sphere analytic contact replaces slot 0 for sphere pairs
        both_sphere = cvx.is_sphere[ia] & cvx.is_sphere[ib]
        delta = pos_a - pos_b
        dist = jnp.linalg.norm(delta, axis=-1)
        rsum = cvx.vert_radius[ia] + cvx.vert_radius[ib]
        ss_n = delta / jnp.maximum(dist, 1e-9)[:, None]
        ss_depth = rsum - dist
        ss_point = pos_b + ss_n * (
            cvx.vert_radius[ib] - 0.5 * ss_depth)[:, None]
        depth = depth.at[:, 0].set(
            jnp.where(both_sphere, ss_depth, depth[:, 0]))
        normal = normal.at[:, 0].set(
            jnp.where(both_sphere[:, None], ss_n, normal[:, 0]))
        point = point.at[:, 0].set(
            jnp.where(both_sphere[:, None], ss_point, point[:, 0]))
        # a sphere pair has exactly one candidate; kill the mirrored ones
        sphere_kill = both_sphere[:, None] & (
            jnp.arange(depth.shape[1])[None, :] > 0)
        depth = jnp.where(sphere_kill, 0.0, depth)

        if hull_parts is not None:
            hh_d, hh_n, hh_p, both_hull = hull_parts
            # the clipped manifold replaces the vertex-face candidates for
            # hull-hull pairs (avoid double-counting the same contact)
            depth = jnp.where(both_hull[:, None], 0.0, depth)
            depth = jnp.concatenate([depth, hh_d], axis=1)
            normal = jnp.concatenate([normal, hh_n], axis=1)
            point = jnp.concatenate([point, hh_p], axis=1)

    movable = (state.inv_mass[ia] > 0) | (state.inv_mass[ib] > 0)
    valid = (depth > 0.0) & cand.mask[:, None] & movable[:, None]

    kk = min(k, depth.shape[1])
    score = jnp.where(valid, depth, -jnp.inf)
    top_score, top_idx = jax.lax.top_k(score, kk)                      # [P,kk]
    sel_n = jnp.take_along_axis(normal, top_idx[..., None], axis=1)
    sel_p = jnp.take_along_axis(point, top_idx[..., None], axis=1)
    active = jnp.isfinite(top_score) & (top_score > 0.0)

    mu = jnp.sqrt(state.shapes.friction[ia] * state.shapes.friction[ib])
    rest = jnp.maximum(state.shapes.restitution[ia],
                       state.shapes.restitution[ib])

    # pair feature key: canonical pair id × candidate width + source slot
    # (the pre-top_k candidate index is a stable feature identity). Only
    # emitted when the id range fits int32 — otherwise warm-start matching
    # is disabled by zero keys.
    n = state.num_bodies
    width = depth.shape[1]
    if n * n * width < 2**31 - 1:
        amin = jnp.minimum(ia, ib)[:, None]
        amax = jnp.maximum(ia, ib)[:, None]
        key = (amin * n + amax) * width + top_idx
        key = jnp.where(active, key, 0)
    else:
        key = jnp.zeros((p, kk), jnp.int32)

    rep = lambda x: jnp.broadcast_to(x[:, None], (p, kk)).reshape(-1)
    return Contacts(
        body_a=rep(ia),
        body_b=rep(ib),
        point=sel_p.reshape(-1, 3).T,
        normal=sel_n.reshape(-1, 3).T,
        depth=jnp.where(active, top_score, 0.0).reshape(-1),
        active=active.reshape(-1),
        friction=rep(mu),
        restitution=rep(rest),
        key=key.reshape(-1),
    )


def concat_contacts(*groups: Contacts) -> Contacts:
    groups = [g for g in groups if g is not None and g.body_a.shape[0] > 0]
    if len(groups) == 1:
        return groups[0]
    return Contacts(*[
        jnp.concatenate(
            [getattr(g, f) for g in groups],
            axis=1 if f in ("point", "normal") else 0,
        )
        for f in Contacts._fields
    ])
