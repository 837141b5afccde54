"""Broad phase: AABB computation and candidate-pair generation.

New capability — the reference has no collision detection at all
(SURVEY.md §0). Three strategies, all with fixed-capacity outputs:

  * 'allpairs' — a static upper-triangular pair list masked by AABB overlap.
    Exact; O(N²) pairs. Right choice for N ≲ 512.
  * 'sweep'    — sort bodies by AABB min-x (XLA sort), each body is paired
    with its next `sweep_window` neighbors in sorted order, masked by
    (a) x-interval overlap and (b) full AABB overlap. Fixed [N·K, 2] output.
    Misses a pair only if more than K bodies' x-intervals start inside a
    body's x-extent — surfaced as `pair_overflow` in metrics, never silent
    (SURVEY.md §7 design stance).
  * 'env_blocks' — batched envs packed block-diagonally into one scene: the
    static per-env upper-triangular pairs, masked by AABB overlap. Exact.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig
from physics_tpu.maths import quaternion as quat
from physics_tpu.state import SHAPE_BOX, SHAPE_HULL, SHAPE_NONE, SHAPE_SPHERE, SimState

Array = jnp.ndarray


class PairCandidates(NamedTuple):
    body_a: Array   # [P] int32
    body_b: Array   # [P] int32
    mask: Array     # [P] bool
    overflow: Array # [] int32 — pairs potentially missed (sweep window)


def body_aabbs(state: SimState) -> Array:
    """World AABBs [N, 2, 3] (min, max) per body.

    Boxes use the |R|·h extent identity; spheres and hulls use their bounding
    radius (hull bounding radius is precomputed into shape params[0] at
    scene-build time).
    """
    stype = state.shapes.stype
    params = state.shapes.params

    rot = quat.to_matrix(state.quat)                       # [N,3,3]
    box_ext = jnp.einsum("nij,nj->ni", jnp.abs(rot), params)  # [N,3]
    radius = params[:, 0]
    sphere_ext = jnp.broadcast_to(radius[:, None], box_ext.shape)

    ext = jnp.where(
        (stype == SHAPE_BOX)[:, None],
        box_ext,
        jnp.where(
            ((stype == SHAPE_SPHERE) | (stype == SHAPE_HULL))[:, None],
            sphere_ext,
            jnp.zeros_like(box_ext),
        ),
    )
    return jnp.stack([state.pos - ext, state.pos + ext], axis=-2)


@lru_cache(maxsize=32)
def _upper_tri_pairs_np(n: int):
    """Static i<j pair list, cached as HOST numpy (a jnp array here would
    leak tracers across jit traces)."""
    iu = np.triu_indices(n, k=1)
    return iu[0].astype(np.int32), iu[1].astype(np.int32)


def _upper_tri_pairs(n: int):
    a, b = _upper_tri_pairs_np(n)
    return jnp.asarray(a), jnp.asarray(b)


def _aabb_overlap(aabbs: Array, ia: Array, ib: Array) -> Array:
    lo = jnp.maximum(aabbs[ia, 0], aabbs[ib, 0])
    hi = jnp.minimum(aabbs[ia, 1], aabbs[ib, 1])
    return jnp.all(lo <= hi, axis=-1)


def allpairs_candidates(state: SimState, aabbs: Array) -> PairCandidates:
    n = state.num_bodies
    ia, ib = _upper_tri_pairs(n)
    collidable = state.shapes.stype != SHAPE_NONE
    mask = _aabb_overlap(aabbs, ia, ib) & collidable[ia] & collidable[ib]
    return PairCandidates(ia, ib, mask, jnp.int32(0))


def sweep_order(state: SimState, aabbs: Array) -> Array:
    """The sweep's body sort order (original body id per sorted rank)."""
    min_x = aabbs[:, 0, 0]
    collidable = state.shapes.stype != SHAPE_NONE
    sort_key = jnp.where(collidable, min_x, jnp.inf)
    return jnp.argsort(sort_key).astype(jnp.int32)


def _sweep_masks(state: SimState, aabbs: Array, k: int):
    """Shared sweep-mask computation: sort by min-x, test each body against
    its next `k` sorted neighbors.

    Returns (order [N], mask [N, k] bool, last_overlap [N]) where
    mask[i, d-1] ⇔ sorted bodies (i, i+d) AABB-overlap and are collidable,
    and last_overlap flags bodies whose furthest window neighbor still
    x-overlaps (⇒ pairs may exist beyond the window).
    """
    n = state.num_bodies
    collidable = state.shapes.stype != SHAPE_NONE
    # non-collidable bodies are pushed to the end of the sorted order
    order = sweep_order(state, aabbs)                      # [N]
    aabb_s = aabbs[order]                                  # [N,2,3] (1 gather)
    coll_s = collidable[order]

    # neighbor j = i+d in sorted order, d = 1..k, shifted padded slices
    pad_aabb = jnp.concatenate(
        [aabb_s, jnp.full((k, 2, 3), jnp.inf, aabb_s.dtype)], axis=0
    )
    pad_coll = jnp.concatenate([coll_s, jnp.zeros((k,), bool)], axis=0)
    nb_aabb = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(pad_aabb, d, n, 0)
         for d in range(1, k + 1)], axis=1)            # [N,k,2,3]
    nb_coll = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(pad_coll, d, n, 0)
         for d in range(1, k + 1)], axis=1)            # [N,k]

    # x-overlap: neighbor's min-x must start before our max-x
    x_overlap = nb_aabb[:, :, 0, 0] <= aabb_s[:, None, 1, 0]
    lo = jnp.maximum(aabb_s[:, None, 0, :], nb_aabb[:, :, 0, :])
    hi = jnp.minimum(aabb_s[:, None, 1, :], nb_aabb[:, :, 1, :])
    full_overlap = jnp.all(lo <= hi, axis=-1)          # [N,k]

    valid = (
        jnp.arange(n)[:, None] + jnp.arange(1, k + 1)[None, :]
    ) < n
    mask = (
        valid & x_overlap & full_overlap
        & coll_s[:, None] & nb_coll
    )
    last_overlap = x_overlap[:, -1] & valid[:, -1] & coll_s
    return order, mask, last_overlap


def sweep_candidates(
    state: SimState, aabbs: Array, window: int
) -> PairCandidates:
    """Sort-by-x sweep-and-prune with a fixed neighbor window.

    Bodies are sorted by AABB min-x once (one gather), then the
    window-neighbor AABBs are obtained by STATIC shifted slices of the
    sorted arrays — zero dynamic gathers in the [N·window] candidate
    emission (dynamic gathers of the full candidate set were the broad
    phase's dominant cost). The candidate tensor is [N·window, 2]
    regardless of scene density.
    """
    n = state.num_bodies
    k = min(window, n - 1)
    order, mask, last_overlap = _sweep_masks(state, aabbs, k)

    pad_order = jnp.concatenate(
        [order, jnp.zeros((k,), jnp.int32)], axis=0
    )
    nb_order = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(pad_order, d, n, 0)
         for d in range(1, k + 1)], axis=1)                # [N,k]

    ia_f = jnp.broadcast_to(order[:, None], (n, k)).reshape(-1)
    ib_f = nb_order.reshape(-1)

    # overflow: window neighbor k (the furthest we look) still x-overlaps →
    # there may be pairs beyond the window.
    overflow = jnp.sum(last_overlap.astype(jnp.int32))
    return PairCandidates(ia_f, ib_f, mask.reshape(-1), overflow)


def bucket_shape(n: int, cfg: SimConfig) -> Tuple[int, int, int]:
    """(block, cap, n_blocks) of the rank-block bucket layout for N bodies.

    `block` ranks per bucket; each bucket keeps at most `cap` candidates
    (cap is rounded up to a multiple of 128). cap derives from max_pair_candidates (total
    candidate budget spread evenly over buckets) unless cfg.bucket_cap
    pins it."""
    block = max(cfg.bucket_block, 1)
    n_blocks = -(-n // block)
    if cfg.bucket_cap > 0:
        cap = cfg.bucket_cap
    else:
        total = cfg.max_pair_candidates if cfg.max_pair_candidates > 0 \
            else 8 * n
        cap = max(total // n_blocks, 128)
    cap = _round_up128(cap)
    k = min(cfg.sweep_window, n - 1)
    cap = min(cap, _round_up128(block * k))
    return block, cap, n_blocks


def _round_up128(x: int) -> int:
    return -(-x // 128) * 128


def sweep_candidates_bucketed(
    state: SimState, aabbs: Array, cfg: SimConfig
) -> PairCandidates:
    """Sweep broad phase with rank-block bucketed candidate compaction.

    The flat sweep emits [N·K] candidates; compact_pairs would compact
    them into one contiguous list with a full-length sort + gather. Here
    compaction happens PER RANK BLOCK: ranks are grouped into buckets of
    `cfg.bucket_block` consecutive ranks, and each bucket keeps its first
    `cap` active candidates (one segmented single-operand uint32 sort — the
    mask rides bit 31, the rank-major slot index the low bits, so
    surviving candidates stay rank-sorted by construction).

    Per-bucket drops are counted into `overflow` (never silent).
    """
    n = state.num_bodies
    k = min(cfg.sweep_window, n - 1)
    block, cap, n_blocks = bucket_shape(n, cfg)
    order, mask, last_overlap = _sweep_masks(state, aabbs, k)

    npad_b = n_blocks * block
    if npad_b != n:
        mask = jnp.pad(mask, ((0, npad_b - n), (0, 0)))
    m2 = mask.reshape(n_blocks, block * k)
    slot = jax.lax.broadcasted_iota(jnp.uint32, (n_blocks, block * k), 1)
    keyu = jnp.where(m2, slot, slot | jnp.uint32(1) << 31)
    kept = jax.lax.sort(keyu, dimension=1)[:, :min(cap, block * k)]
    if kept.shape[1] < cap:     # tiny blocks: pad to the 128-aligned cap
        kept = jnp.pad(kept, ((0, 0), (0, cap - kept.shape[1])),
                       constant_values=np.uint32(1 << 31))
    live = kept < jnp.uint32(1) << 31
    slot_s = (kept & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)

    blk_base = (jnp.arange(n_blocks, dtype=jnp.int32) * block)[:, None]
    rank_a = jnp.minimum(blk_base + slot_s // k, n - 1)    # [NB, cap]
    rank_b = jnp.minimum(rank_a + 1 + slot_s % k, n - 1)
    body_a = order[rank_a.reshape(-1)]
    body_b = order[rank_b.reshape(-1)]

    dropped = jnp.sum(jnp.maximum(
        jnp.sum(m2.astype(jnp.int32), axis=1) - cap, 0))
    overflow = jnp.sum(last_overlap.astype(jnp.int32)) + dropped
    return PairCandidates(body_a, body_b, live.reshape(-1), overflow)


def env_block_candidates(
    state: SimState, aabbs: Array, env_size: int
) -> PairCandidates:
    """Candidate pairs for a block-diagonal packed-env scene.

    Bodies are E envs of `env_size` bodies each (body id = e·K + k, see
    envs.pack_envs); only within-env pairs can collide, so the candidate
    set is the static per-env upper triangle masked by AABB overlap. Zero
    dynamic gathers: the [E, K, K] overlap tensor is pure broadcasting and
    the K(K−1)/2 upper-tri lanes are selected with a compile-time index
    list. Exact (overflow ≡ 0) — every possible pair is tested.
    """
    n = state.num_bodies
    k = env_size
    assert n % k == 0, "env_blocks: num_bodies must be a multiple of K"
    e = n // k
    oi, oj = _upper_tri_pairs_np(k)                         # [Pk] static
    flat = (oi * k + oj).astype(np.int32)

    ae = aabbs.reshape(e, k, 2, 3)
    lo = jnp.maximum(ae[:, :, None, 0], ae[:, None, :, 0])  # [E,K,K,3]
    hi = jnp.minimum(ae[:, :, None, 1], ae[:, None, :, 1])
    ov = jnp.all(lo <= hi, axis=-1)                         # [E,K,K]
    coll = (state.shapes.stype != SHAPE_NONE).reshape(e, k)
    ov = ov & coll[:, :, None] & coll[:, None, :]
    mask = ov.reshape(e, k * k)[:, flat].reshape(-1)        # [E·Pk]

    base = (jnp.arange(e, dtype=jnp.int32) * k)[:, None]
    ia = (base + jnp.asarray(oi)[None, :]).reshape(-1)
    ib = (base + jnp.asarray(oj)[None, :]).reshape(-1)
    return PairCandidates(ia, ib, mask, jnp.int32(0))


def compact_pairs(cand: PairCandidates, max_pairs: int) -> PairCandidates:
    """Keep at most `max_pairs` active candidates (top_k on the mask).

    The sweep emits a fixed [N·K] candidate tensor in which only the
    AABB-overlapping fraction is live; compacting before the (much more
    expensive) narrow phase shrinks the per-pair working set. Active pairs
    beyond capacity are counted into `overflow` — never silently dropped.
    """
    p = cand.body_a.shape[0]
    if max_pairs <= 0 or p <= max_pairs:
        return cand
    # selection by ONE single-operand uint32 sort: the mask rides bit 31,
    # the candidate index the low bits — cheaper than argsort (which sorts
    # a key+payload pair) and stable by construction, so surviving actives
    # keep emission order (the sweep's rank-major order).
    p_idx = jnp.arange(p, dtype=jnp.uint32)
    keyu = jnp.where(cand.mask, p_idx, p_idx | jnp.uint32(1) << 31)
    idx = (jax.lax.sort(keyu)[:max_pairs]
           & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    dropped = jnp.maximum(
        jnp.sum(cand.mask.astype(jnp.int32)) - max_pairs, 0
    )
    packed = jnp.stack(
        [cand.body_a, cand.body_b, cand.mask.astype(jnp.int32)]
    )[:, idx]
    return PairCandidates(
        body_a=packed[0],
        body_b=packed[1],
        mask=packed[2] != 0,
        overflow=cand.overflow + dropped,
    )


def pair_candidates(state: SimState, cfg: SimConfig) -> PairCandidates:
    aabbs = body_aabbs(state)
    if cfg.broadphase == "sweep":
        if cfg.pair_buckets:
            # already compacted per rank block
            return sweep_candidates_bucketed(state, aabbs, cfg)
        cand = sweep_candidates(state, aabbs, cfg.sweep_window)
    elif cfg.broadphase == "env_blocks":
        cand = env_block_candidates(state, aabbs, cfg.env_block_size)
    else:
        cand = allpairs_candidates(state, aabbs)
    return compact_pairs(cand, cfg.max_pair_candidates)
