"""Velocity-level contact resolution: projected Jacobi impulse solver.

New capability (the reference has no contacts, SURVEY.md §0), architected
for a data-parallel accelerator: Gauss-Seidel/PGS is inherently
sequential, so instead every iteration computes impulse corrections for ALL
contacts from the current velocities (one batched kernel) and scatter-adds
them simultaneously (segment-sum). Convergence is kept by mass-splitting:
each contact's correction is scaled by 1/deg, where deg is the number of
active contacts touching its bodies — the classic averaged-projection
trick that makes Jacobi contact iteration contractive.

Per contact, normal impulse λₙ ≥ 0 with a Baumgarte bias velocity
(β·max(depth − slop, 0)/dt) plus restitution, and a friction box-clamp
|λₜ| ≤ μ·λₙ along two tangent directions. All state lives in the fori_loop
carry; the whole solve fuses into the step program.

LAYOUT: all per-contact quantities are component-form 1-D [C] arrays
(maths.vec3c) — no [C, 3] tensors with a minor dim of 3. Contact vector
fields arrive as [3, C] rows (narrowphase convention); body state rides
packed [rows, N] tables so each sweep costs exactly two lane gathers and
one lane scatter (ops/bodygather switches those to dense one-hot
contractions for small vmapped envs).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from physics_tpu.config import SimConfig
from physics_tpu.maths import vec3c as v3
from physics_tpu.ops.bodygather import lane_gather, lane_scatter_add, scatter_add_1d
from physics_tpu.maths import quaternion as quat
from physics_tpu.ops.broadphase import pair_candidates
from physics_tpu.ops.narrowphase import (
    Contacts,
    concat_contacts,
    convex_data,
    ground_contacts,
    pair_contacts,
)
from physics_tpu.state import SimState

Array = jnp.ndarray


def _tangent_basis(n):
    """Orthonormal (t1, t2) ⊥ n, branchless, component form."""
    ax, ay, az = jnp.abs(n[0]), jnp.abs(n[1]), jnp.abs(n[2])
    use_x = (ax <= ay) & (ax <= az)
    use_y = (~use_x) & (ay <= az)
    f = lambda m: m.astype(jnp.float32)
    e = (f(use_x), f(use_y), f(~(use_x | use_y)))
    t1 = v3.cross(n, e)
    inv = 1.0 / jnp.maximum(v3.norm(t1), 1e-9)
    t1 = v3.scale(t1, inv)
    t2 = v3.cross(n, t1)
    return t1, t2


class ContactGeom(NamedTuple):
    """Per-contact solve constants of the impulse solve.

    All vector quantities are component-form tuples of [C] arrays
    (maths.vec3c); iw_* are 9-tuples (row-major world inverse inertia,
    pre-masked by activity), already multiplied by the activity masks the
    way `solve_impulses` consumes them.
    """

    seg_ids: Array          # [2C] scatter ids (a then b; n ⇒ dropped)
    inv_m_a: Array
    inv_m_b: Array
    iw_a: tuple
    iw_b: tuple
    r_a: tuple
    r_b: tuple
    nrm: tuple
    t1: tuple
    t2: tuple
    k_n: Array
    k_t1: Array
    k_t2: Array
    relax: Array
    actf: Array
    has_bf: Array
    v_n0: Array             # pre-solve normal approach velocity


def contact_geometry(
    state: SimState,
    contacts: Contacts,
    cfg: SimConfig,
    axis_name: str | None = None,
) -> ContactGeom:
    """Prologue of the impulse solve: packed body-table gathers → effective
    masses, contact frames, Jacobi relaxation factors. ONE lane gather per
    contact endpoint (see the gather/scatter budget note in
    `solve_impulses`)."""
    n = state.num_bodies

    a = contacts.body_a
    b_raw = contacts.body_b
    has_b = b_raw >= 0
    b = jnp.clip(b_raw, 0, n - 1)
    act = contacts.active
    actf = act.astype(jnp.float32)
    has_bf = (has_b & act).astype(jnp.float32)

    # contact degree per body -> Jacobi relaxation 1/deg (one packed scatter)
    seg_ids = jnp.concatenate([jnp.where(act, a, n),
                               jnp.where(has_b & act, b, n)])
    deg = scatter_add_1d(jnp.ones_like(seg_ids, jnp.float32), seg_ids, n)
    if axis_name:
        deg = jax.lax.psum(deg, axis_name)

    # ---- packed body table: ONE lane gather per endpoint ----
    # rows: pos(0:3) | world inv-inertia row-major (3:12) | inv_mass(12) |
    # deg(13) | vel(14:17) | omega(17:20) | pad(20:24). Gather cost is
    # payload-width independent, so the velocities ride along free — they
    # feed the pre-solve approach velocity (restitution target) that
    # otherwise costs four dedicated gathers.
    r9 = v3.quat_to_mat(state.quat)                  # 9 x [N]
    iw9 = v3.sandwich(r9, v3.mat_unpack(state.inv_inertia))  # world I^-1
    zn = jnp.zeros((n,), jnp.float32)
    table = jnp.stack(
        [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2]]
        + list(iw9)
        + [state.inv_mass, deg,
           state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
           state.omega[:, 0], state.omega[:, 1], state.omega[:, 2],
           zn, zn, zn, zn]
    )                                                 # [24, N]
    ta = lane_gather(table, a)                        # [24, C]
    tb = lane_gather(table, b)                        # [24, C]

    inv_m_a = ta[12] * actf
    inv_m_b = tb[12] * has_bf
    iw_a = tuple(ta[3 + k] * actf for k in range(9))
    iw_b = tuple(tb[3 + k] * has_bf for k in range(9))

    p = (contacts.point[0], contacts.point[1], contacts.point[2])
    nrm = (contacts.normal[0], contacts.normal[1], contacts.normal[2])
    r_a = v3.sub(p, (ta[0], ta[1], ta[2]))
    r_b = v3.sub(p, (tb[0], tb[1], tb[2]))
    t1, t2 = _tangent_basis(nrm)

    def eff_mass(d):
        # k = sum 1/m + d.((I^-1 (r x d)) x r) for each body
        term_a = v3.dot(d, v3.cross(v3.mat_vec(iw_a, v3.cross(r_a, d)), r_a))
        term_b = v3.dot(d, v3.cross(v3.mat_vec(iw_b, v3.cross(r_b, d)), r_b))
        return inv_m_a + inv_m_b + term_a + term_b

    k_n = jnp.maximum(eff_mass(nrm), 1e-9)
    k_t1 = jnp.maximum(eff_mass(t1), 1e-9)
    k_t2 = jnp.maximum(eff_mass(t2), 1e-9)

    deg_c = jnp.maximum(jnp.maximum(ta[13], jnp.where(has_b, tb[13], 0.0)),
                        1.0)
    relax = jnp.float32(cfg.contact_relaxation) / deg_c

    # pre-solve normal approach velocity (restitution reference)
    va0 = v3.add((ta[14], ta[15], ta[16]),
                 v3.cross((ta[17], ta[18], ta[19]), r_a))
    vb0 = v3.scale(
        v3.add((tb[14], tb[15], tb[16]),
               v3.cross((tb[17], tb[18], tb[19]), r_b)),
        has_bf,
    )
    v_n0 = v3.dot(nrm, v3.sub(va0, vb0))

    return ContactGeom(
        seg_ids=seg_ids, inv_m_a=inv_m_a, inv_m_b=inv_m_b,
        iw_a=iw_a, iw_b=iw_b, r_a=r_a, r_b=r_b, nrm=nrm, t1=t1, t2=t2,
        k_n=k_n, k_t1=k_t1, k_t2=k_t2, relax=relax, actf=actf,
        has_bf=has_bf, v_n0=v_n0,
    )


def warm_start_lambda(
    contacts: Contacts, warm: Tuple[Array, Array], c: int
) -> Tuple[Array, Array, Array]:
    """Match previous-step impulses to this step's contacts by feature key.

    sort-merge key matching: two multi-operand sorts and no gathers
    (jnp.searchsorted would lower to a ~15-iteration binary-search while
    loop of gathers). Composite sort key (key·2 + tag) keeps each
    previous-step entry immediately before any current entry with the
    same feature key; pair keys < n²·8 so the ·2 stays in int32.

    Returns (lam0_n, lam0_t1, lam0_t2), already masked to active keyed
    contacts.
    """
    keys, active = contacts.key, contacts.active
    prev_keys, prev_lam = warm
    kp = prev_keys.shape[0]
    comb = jnp.concatenate([prev_keys, keys])
    tag = jnp.concatenate([
        jnp.zeros((kp,), jnp.int32), jnp.ones((c,), jnp.int32)
    ])
    slot = jnp.concatenate([
        jnp.arange(kp, dtype=jnp.int32), jnp.arange(c, dtype=jnp.int32)
    ])
    zc = jnp.zeros((c,), jnp.float32)
    # multi-operand lax.sort: tag/slot AND the previous impulses ride the
    # sort as payloads — no post-sort gathers at all
    sk2, st, sslot, pl0, pl1, pl2 = jax.lax.sort(
        (comb * 2 + tag, tag, slot,
         jnp.concatenate([prev_lam[0], zc]),
         jnp.concatenate([prev_lam[1], zc]),
         jnp.concatenate([prev_lam[2], zc])),
        num_keys=1,
    )
    prev_tag = jnp.concatenate([jnp.ones((1,), jnp.int32), st[:-1]])
    prev_sk2 = jnp.concatenate([sk2[:1] - 2, sk2[:-1]])
    match = (st == 1) & (prev_tag == 0) & (sk2 == prev_sk2 + 1) & (sk2 != 1)
    mf = match.astype(jnp.float32)

    def pred(x):  # predecessor's payload (the matching prev entry's λ)
        return jnp.concatenate([x[:1], x[:-1]]) * mf

    # delivery sort: every CURRENT entry (matched or not) keyed by its own
    # slot, prev entries keyed past the end — the first c outputs are the
    # slots in order, i.e. a scatter expressed as a payload sort
    dkey = jnp.where(st == 1, sslot, kp + c)
    _, l0, l1, l2 = jax.lax.sort(
        (dkey, pred(pl0), pred(pl1), pred(pl2)), num_keys=1)
    actf3 = (active & (keys != 0)).astype(jnp.float32)
    return l0[:c] * actf3, l1[:c] * actf3, l2[:c] * actf3


def solve_impulses(
    state: SimState,
    contacts: Contacts,
    cfg: SimConfig,
    axis_name: str | None = None,
    warm: Tuple[Array, Array] | None = None,
):
    """Iteratively resolve contacts.

    Returns (vel, omega, pseudo_vel, pseudo_omega, lam3, metrics): vel/omega
    and the pseudo velocities come back as [N, 3] arrays (packed once); the
    pseudo velocities are the split-impulse position correction (integrate
    them into pos/quat over one dt, outside the momentum state); lam3 [3, C]
    holds the converged real impulses (λn, λt1, λt2) per slot.

    `warm=(prev_keys_sorted, prev_lam3)` warm-starts the solve: each
    contact's feature key is matched against the previous step's sorted key
    table (one-argsort sort-merge) and the matched impulses are applied up
    front, so the Jacobi sweeps only correct the *change* since last step —
    the standard impulse-caching trick, which roughly halves the sweeps
    needed for resting stacks.

    With `axis_name` (inside shard_map) the contact buffer is sharded across
    that mesh axis while body velocities stay replicated: every impulse
    scatter becomes a local delta followed by a psum, which keeps the Jacobi
    iteration mathematically identical to the single-device solve.

    GATHER/SCATTER BUDGET (the design driver — a gather or scatter op
    costs per index far more than per payload byte, so ops are PACKED,
    not element-wise): per sweep exactly TWO lane gathers (one
    [rows, N] -> [rows, C] per body endpoint, velocities and angular
    velocities ride the same table) and ONE lane scatter-add
    ([rows, 2C] -> [rows, N+1]), where a per-component form would issue
    24 gather/scatter ops per sweep.
    """
    n = state.num_bodies
    c = contacts.body_a.shape[0]
    dt = jnp.float32(cfg.dt)

    g = contact_geometry(state, contacts, cfg, axis_name=axis_name)
    seg_ids = g.seg_ids
    inv_m_a, inv_m_b = g.inv_m_a, g.inv_m_b
    iw_a, iw_b = g.iw_a, g.iw_b
    r_a, r_b = g.r_a, g.r_b
    nrm, t1, t2 = g.nrm, g.t1, g.t2
    k_n, k_t1, k_t2 = g.k_n, g.k_t1, g.k_t2
    relax, actf, has_bf = g.relax, g.actf, g.has_bf
    act = contacts.active
    a = contacts.body_a
    b = jnp.clip(contacts.body_b, 0, n - 1)

    # ---- packed solver state z [16, N]: rows 0:6 = real (vel, omega),
    # rows 8:14 = split-impulse pseudo (vel, omega). The velocity pass and
    # the position pass are INDEPENDENT systems (the position bias uses
    # pre-solve depths), so both ride the SAME per-sweep lane gather and
    # lane scatter — halving the step's gather/scatter budget.
    vw0 = jnp.concatenate(
        [state.vel.T, state.omega.T, jnp.zeros((10, n), jnp.float32)]
    )                                                 # [16, N]

    def rel_vel_from(ga, gb, base=0):
        """Relative velocity at the contact from gathered endpoint rows."""
        va = v3.add((ga[base + 0], ga[base + 1], ga[base + 2]),
                    v3.cross((ga[base + 3], ga[base + 4], ga[base + 5]), r_a))
        vb = v3.add((gb[base + 0], gb[base + 1], gb[base + 2]),
                    v3.cross((gb[base + 3], gb[base + 4], gb[base + 5]), r_b))
        vb = v3.scale(vb, has_bf)
        return v3.sub(va, vb)

    zero_c = jnp.zeros((c,), jnp.float32)

    def delta_from(imp, pimp=None):
        """Real impulse ±imp and pseudo impulse ±pimp (v3 [C]) → packed
        state delta [16, N] via ONE lane scatter-add (psum'd when sharded)."""
        rows = []

        def endpoint_rows(im):
            dv_a = v3.scale(im, inv_m_a)
            dw_a = v3.mat_vec(iw_a, v3.cross(r_a, im))
            dv_b = v3.scale(im, -inv_m_b)
            dw_b = v3.neg(v3.mat_vec(iw_b, v3.cross(r_b, im)))
            return (
                [jnp.concatenate([dv_a[k], dv_b[k]]) for k in range(3)]
                + [jnp.concatenate([dw_a[k], dw_b[k]]) for k in range(3)]
            )

        zero_row = jnp.zeros((2 * c,), jnp.float32)
        rows = endpoint_rows(imp) + [zero_row, zero_row]
        if pimp is not None:
            rows += endpoint_rows(pimp) + [zero_row, zero_row]
        else:
            rows += [zero_row] * 8
        contrib = jnp.stack(rows)                     # [16, 2C]
        delta = lane_scatter_add(contrib, seg_ids, n)
        if axis_name:
            delta = jax.lax.psum(delta, axis_name)
        return delta

    # restitution uses the pre-solve approach velocity. SPLIT IMPULSE:
    # the velocity solve targets restitution only -- penetration is fixed by
    # the parallel pseudo-velocity position rows, so the cached real
    # impulses contain no Baumgarte energy (safe to warm start).
    v_n0 = g.v_n0   # pre-solve approach velocity (rides the geometry table)
    bias = (
        jnp.float32(cfg.baumgarte)
        / dt
        * jnp.maximum(contacts.depth - jnp.float32(cfg.penetration_slop), 0.0)
    )
    bounce = contacts.restitution * jnp.maximum(-v_n0, 0.0)
    # warm-started solves use split impulse (bias handled positionally);
    # cold solves keep classic Baumgarte bias in the velocity target, which
    # reaches force balance in far fewer sweeps when starting from lambda = 0
    use_split = warm is not None
    v_target = bounce if use_split else jnp.maximum(bias, bounce)
    n_pos_iters = cfg.position_iters if use_split else 0
    total_iters = max(cfg.contact_iters, n_pos_iters)

    def iteration(i, carry):
        z, lam_n, lam_t1, lam_t2, lam_b = carry
        ga, gb = lane_gather(z, a), lane_gather(z, b)
        vel_on = (i < cfg.contact_iters).astype(jnp.float32)
        pos_on = (i < n_pos_iters).astype(jnp.float32)

        # one velocity snapshot per sweep: normal and friction corrections
        # are computed together and applied in a single scatter pass (pure
        # Jacobi; the friction clamp uses this sweep's updated lambda_n)
        v = rel_vel_from(ga, gb)
        v_n = v3.dot(nrm, v)
        d_lam = (v_target - v_n) / k_n * relax * actf * vel_on
        lam_n_new = jnp.maximum(lam_n + d_lam, 0.0)

        lim = contacts.friction * lam_n_new
        v_t1 = v3.dot(t1, v)
        lam_t1_new = jnp.clip(
            lam_t1 - v_t1 / k_t1 * relax * actf * vel_on, -lim, lim)
        v_t2 = v3.dot(t2, v)
        lam_t2_new = jnp.clip(
            lam_t2 - v_t2 / k_t2 * relax * actf * vel_on, -lim, lim)

        imp = v3.add(
            v3.add(
                v3.scale(nrm, lam_n_new - lam_n),
                v3.scale(t1, lam_t1_new - lam_t1),
            ),
            v3.scale(t2, lam_t2_new - lam_t2),
        )

        # position (split-impulse) rows: pseudo velocities vs Baumgarte bias
        pv_n = v3.dot(nrm, rel_vel_from(ga, gb, base=8))
        d_lam_b = (bias - pv_n) / k_n * relax * actf * pos_on
        lam_b_new = jnp.maximum(lam_b + d_lam_b, 0.0)
        pimp = v3.scale(nrm, lam_b_new - lam_b)

        z = z + delta_from(imp, pimp)
        return (z, lam_n_new, lam_t1_new, lam_t2_new, lam_b_new)

    lam0_n, lam0_t1, lam0_t2 = zero_c, zero_c, zero_c
    z = vw0
    if warm is not None:
        lam0_n, lam0_t1, lam0_t2 = warm_start_lambda(contacts, warm, c)
        imp0 = v3.add(
            v3.add(v3.scale(nrm, lam0_n), v3.scale(t1, lam0_t1)),
            v3.scale(t2, lam0_t2),
        )
        z = z + delta_from(imp0)

    z, lam_n, lam_t1, lam_t2, _ = jax.lax.fori_loop(
        0,
        total_iters,
        iteration,
        (z, lam0_n, lam0_t1, lam0_t2, zero_c),
    )
    lam3 = jnp.stack([lam_n, lam_t1, lam_t2])                       # [3, C]
    vw = z[:8]
    pvw = z[8:]

    count = jnp.sum(act.astype(jnp.int32))
    max_pen = jnp.max(jnp.where(act, contacts.depth, 0.0), initial=0.0)
    imp_sum = jnp.sum(lam_n)
    if axis_name:
        count = jax.lax.psum(count, axis_name)
        max_pen = jax.lax.pmax(max_pen, axis_name)
        imp_sum = jax.lax.psum(imp_sum, axis_name)
    metrics = {
        "contact_count": count,
        "max_penetration": max_pen,
        "normal_impulse_sum": imp_sum,
    }
    return (
        vw[:3].T,
        vw[3:6].T,
        pvw[:3].T,
        pvw[3:6].T,
        lam3,
        metrics,
    )


_VEC_FIELDS = ("point", "normal")  # [3, C] fields of Contacts


def _field_gather(contacts: Contacts, idx: Array) -> Contacts:
    """Reorder every Contacts field by `idx` with ONE packed lane gather.

    Gather cost is per op × per index, so all 14 logical rows ride ONE
    [14, C] f32 table. Int fields are encoded as exact-in-f32 non-negative
    values (body ids < 2²⁴, +1 bias for the −1 ghost id; the key's uint32
    bits split into two 16-bit halves) — NOT bit-cast, which would form
    NaN payloads that a device may canonicalize in transit.
    """
    key_u = jax.lax.bitcast_convert_type(contacts.key, jnp.uint32)
    f32 = lambda x: x.astype(jnp.float32)
    rows = [
        contacts.point[0], contacts.point[1], contacts.point[2],
        contacts.normal[0], contacts.normal[1], contacts.normal[2],
        contacts.depth,
        contacts.friction,
        contacts.restitution,
        f32(contacts.body_a + 1),
        f32(contacts.body_b + 1),
        f32(contacts.active),
        f32(key_u & jnp.uint32(0xFFFF)),
        f32(key_u >> 16),
    ]
    packed = jnp.stack(rows)[:, idx]             # ONE [14, C] lane gather
    i32 = lambda r: r.astype(jnp.int32)
    key = jax.lax.bitcast_convert_type(
        (i32(packed[13]).astype(jnp.uint32) << 16)
        | i32(packed[12]).astype(jnp.uint32),
        jnp.int32,
    )
    return Contacts(
        body_a=i32(packed[9]) - 1,
        body_b=i32(packed[10]) - 1,
        point=packed[0:3],
        normal=packed[3:6],
        depth=packed[6],
        active=packed[11] != 0,
        friction=packed[7],
        restitution=packed[8],
        key=key,
    )


def compact_contacts(
    contacts: Contacts, max_contacts: int
) -> Tuple[Contacts, Array]:
    """Keep the `max_contacts` deepest active contacts (top_k gather).

    Most contact slots are inactive padding (masked broad-phase candidates);
    compacting before the iterative solve shrinks the hot loop's working set
    from O(pair_capacity) to O(max_contacts). Returns (contacts, overflow):
    overflow counts *active* contacts dropped — surfaced, never silent.
    """
    c = contacts.body_a.shape[0]
    if max_contacts <= 0 or c <= max_contacts:
        return contacts, jnp.int32(0)
    # argsort+slice instead of lax.top_k: k is thousands here, and one
    # sort costs the same whatever k is
    score = jnp.where(contacts.active, contacts.depth, -jnp.inf)
    idx = jnp.argsort(-score)[:max_contacts]
    overflow = jnp.maximum(
        jnp.sum(contacts.active.astype(jnp.int32)) - max_contacts, 0
    )
    return _field_gather(contacts, idx), overflow


def contact_capacity(state: SimState, cfg: SimConfig) -> int:
    """Total contact-slot count of one step under `cfg` (static), via
    eval_shape on the generation pipeline — used to size the warm-start
    buffers (engine.prepare_contacts)."""

    def gen(s):
        from physics_tpu.ops.narrowphase import (
            boxes_fast_path,
            hull_obb_prefilter,
            hulls_fast_path,
        )

        fast = boxes_fast_path(cfg) or hulls_fast_path(s, cfg)
        cvx = None if fast else convex_data(s)
        groups = []
        if cfg.ground_plane:
            groups.append(ground_contacts(s, cvx, cfg))
        if cfg.pair_collisions and s.num_bodies > 1:
            cand = pair_candidates(s, cfg)
            if hulls_fast_path(s, cfg) and cfg.hull_prefilter_cap > 0:
                # mirror resolve_contacts' prefilter so the warm-start
                # buffer capacity matches the runtime contact shape
                cand, _ = hull_obb_prefilter(s, cand,
                                             cfg.hull_prefilter_cap)
            groups.append(pair_contacts(s, cvx, cand, cfg))
        if not groups:
            return jnp.zeros((0,), jnp.int32)
        contacts = concat_contacts(*groups)
        contacts, _ = compact_contacts(contacts, cfg.max_contacts)
        return contacts.key

    return int(jax.eval_shape(gen, state).shape[0])


def _pad_axis(arr: Array, multiple: int, axis: int) -> Array:
    """Zero-pad `axis` up to a multiple (False/0 ⇒ inactive)."""
    rem = arr.shape[axis] % multiple
    if rem == 0:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, multiple - rem)
    return jnp.pad(arr, pad)


def _chunk(
    arr: Array, axis_name: str, n_shards: int, axis: int = 0
) -> Array:
    """This device's contiguous slice of an `axis`-sharded array
    (padded with inactive slots if not evenly divisible)."""
    arr = _pad_axis(arr, n_shards, axis)
    size = arr.shape[axis] // n_shards
    idx = jax.lax.axis_index(axis_name)
    return jax.lax.dynamic_slice_in_dim(arr, idx * size, size, axis)


def _chunk_contacts(
    contacts: Contacts, axis_name: str, n_shards: int
) -> Contacts:
    return Contacts(*[
        _chunk(getattr(contacts, f), axis_name, n_shards,
               axis=1 if f in _VEC_FIELDS else 0)
        for f in Contacts._fields
    ])


def resolve_contacts(
    state: SimState,
    cfg: SimConfig,
    shard: Tuple[str, int] | None = None,
) -> Tuple[SimState, Dict]:
    """Broad phase → narrow phase → impulse solve. Pure function of state.

    `shard=(axis_name, n_shards)` (inside shard_map, body state replicated)
    splits the broad-phase candidate list and the narrow-phase work across
    the mesh axis; the Jacobi solve psums impulse deltas each sweep so the
    result matches the single-device solve.
    """
    from physics_tpu.ops.narrowphase import boxes_fast_path, hulls_fast_path

    hulls_fast = hulls_fast_path(state, cfg)
    # the convex presentation ([N, Vc, 3] vertex/face tensors) is only read
    # by the GENERIC narrow-phase paths — the slot-major fast paths (boxes,
    # shared-hull scenes) never touch it; skip the build entirely
    need_cvx = not (hulls_fast or boxes_fast_path(cfg))
    cvx = convex_data(state) if need_cvx else None
    groups = []
    metrics: Dict = {}
    axis_name = shard[0] if shard else None

    if cfg.ground_plane:
        gc = ground_contacts(state, cvx, cfg)
        if shard:
            gc = _chunk_contacts(gc, *shard)
        groups.append(gc)
    if cfg.pair_collisions and state.num_bodies > 1:
        cand = pair_candidates(state, cfg)
        if (hulls_fast and shard is not None
                and state.hulls.verts.shape[0] > 1):
            raise ValueError(
                "multi-hull-type fast path needs the type-pair-"
                "segmenting OBB prefilter, which does not run under "
                "shard=: set hull_fast=False (generic path) for "
                "sharded multi-type hull scenes")
        if hulls_fast and cfg.hull_prefilter_cap > 0 and shard is None:
            # two-phase hull narrow phase: OBB face-SAT prefilter drops
            # separated pairs and compacts survivors before the full
            # hull-SAT support matmuls (whose cost scales with candidate
            # lanes)
            from physics_tpu.ops.narrowphase import hull_obb_prefilter

            cand, pre_ovf = hull_obb_prefilter(
                state, cand, cfg.hull_prefilter_cap)
            metrics["prefilter_overflow"] = pre_ovf
        if shard:
            from physics_tpu.ops.broadphase import PairCandidates

            cand = PairCandidates(
                _chunk(cand.body_a, *shard),
                _chunk(cand.body_b, *shard),
                _chunk(cand.mask, *shard),
                cand.overflow,
            )
        groups.append(pair_contacts(state, cvx, cand, cfg))
        metrics["pair_overflow"] = cand.overflow

    if not groups:
        return state, metrics

    contacts = concat_contacts(*groups)
    max_c = cfg.max_contacts // (shard[1] if shard else 1)
    contacts, dropped = compact_contacts(contacts, max_c)
    if cfg.max_contacts > 0:
        if axis_name:
            dropped = jax.lax.psum(dropped, axis_name)
        metrics["contact_overflow"] = dropped
    c_total = contacts.key.shape[0]
    use_warm = (
        shard is None
        and state.contact_key.shape[0] == c_total
        and c_total > 0
    )
    warm = (state.contact_key, state.contact_lam) if use_warm else None

    vel, omega, pvel, pomega, lam3, solve_metrics = solve_impulses(
        state, contacts, cfg, axis_name=axis_name, warm=warm
    )
    # split-impulse position correction: pseudo velocities integrate into
    # the pose immediately and never enter the momentum state
    dt = jnp.float32(cfg.dt)
    new_pos = state.pos + pvel * dt
    dq = quat.exp_map(pomega * dt)
    new_quat = quat.normalize(quat.mul(dq, state.quat))
    state = state.replace(vel=vel, omega=omega, pos=new_pos, quat=new_quat)
    if use_warm:
        # multi-operand sort: impulses ride the key sort as payloads (no
        # post-sort gathers)
        key_s, l0, l1, l2 = jax.lax.sort(
            (contacts.key, lam3[0], lam3[1], lam3[2]), num_keys=1
        )
        state = state.replace(
            contact_key=key_s,
            contact_lam=jnp.stack([l0, l1, l2]),
        )
    return state, {**metrics, **solve_metrics}
