"""Hull-hull narrow phase (face-SAT + clipping) and GJK distance tests."""

import pytest
import numpy as np
import jax.numpy as jnp

from physics_tpu import SceneBuilder, SimConfig
from physics_tpu.engine import rollout
from physics_tpu.io.meshes import convex_hull_face_polygons, mesh_inertia
from physics_tpu.io.primitives import beveled_cube_mesh, box_mesh
from physics_tpu.ops.hullhull import HullData, gjk_distance, hull_hull_manifold


def make_hull_data(verts):
    verts = np.asarray(verts, np.float32)
    normals, offsets, polys = convex_hull_face_polygons(verts)
    f = len(normals)
    e = max(len(p) for p in polys)
    fverts = np.zeros((f, e), np.int32)
    fcnt = np.zeros(f, np.int32)
    for i, p in enumerate(polys):
        fverts[i, : len(p)] = p
        fverts[i, len(p):] = p[0]
        fcnt[i] = len(p)
    dirs = []
    edges = set()
    for p in polys:
        for a, b in zip(p, list(p[1:]) + [p[0]]):
            edges.add((a, b) if a < b else (b, a))
            d = verts[b] - verts[a]
            d = d / max(np.linalg.norm(d), 1e-9)
            if not any(abs(float(d @ e)) > 1 - 1e-5 for e in dirs):
                dirs.append(d)
    dirs = np.asarray(dirs, np.float32)
    edges = sorted(edges)
    return HullData(
        verts=jnp.asarray(verts),
        vert_mask=jnp.ones(len(verts), jnp.float32),
        face_n=jnp.asarray(normals),
        face_off=jnp.asarray(offsets),
        face_mask=jnp.ones(f, jnp.float32),
        face_verts=jnp.asarray(fverts),
        face_vert_count=jnp.asarray(fcnt),
        edge_dirs=jnp.asarray(dirs),
        edge_dir_mask=jnp.ones(len(dirs), jnp.float32),
        edge_i0=jnp.asarray([e[0] for e in edges], jnp.int32),
        edge_i1=jnp.asarray([e[1] for e in edges], jnp.int32),
        edge_mask=jnp.ones(len(edges), jnp.float32),
    )


I3 = jnp.eye(3)


def test_cube_hulls_stacked_manifold():
    h = make_hull_data(box_mesh((0.5, 0.5, 0.5))[0])
    pts, n, d, v = hull_hull_manifold(
        jnp.array([0.0, 0.98, 0.0]), I3, h, jnp.array([0.0, 0.0, 0.0]), I3, h
    )
    v = np.asarray(v)
    assert v.sum() == 4
    np.testing.assert_allclose(np.asarray(d)[v], 0.02, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n)[v], [[0, 1, 0]] * 4, atol=1e-5)
    xs = sorted(p[0] for p in np.asarray(pts)[v])
    np.testing.assert_allclose(xs, [-0.5, -0.5, 0.5, 0.5], atol=1e-4)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return jnp.asarray(
        np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32))


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return jnp.asarray(
        np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32))


def test_edge_edge_crossed_cubes():
    """A rotated 45° about x over B rotated 45° about z: the true contact
    normal (+y) is the cross of the two supporting edge directions and is
    NOT any face normal of either cube — requires the edge-edge SAT."""
    h = make_hull_data(box_mesh((0.5, 0.5, 0.5))[0])
    r = 0.5 * np.sqrt(2.0)
    depth_want = 0.05
    pos_a = jnp.array([0.0, 2 * r - depth_want, 0.0])
    pts, n, d, v = hull_hull_manifold(
        pos_a, _rot_x(np.pi / 4), h, jnp.zeros(3), _rot_z(np.pi / 4), h
    )
    v = np.asarray(v)
    assert v.sum() == 1, v.sum()
    k = int(np.argmax(v))
    np.testing.assert_allclose(np.asarray(d)[k], depth_want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(n)[k], [0, 1, 0], atol=1e-5)
    p = np.asarray(pts)[k]
    np.testing.assert_allclose(p[0], 0.0, atol=1e-5)
    np.testing.assert_allclose(p[2], 0.0, atol=1e-5)
    np.testing.assert_allclose(p[1], r - 0.5 * depth_want, atol=1e-3)


def test_face_case_unchanged_by_edge_axes():
    """Resting face contact still returns the 4-point clipped manifold."""
    h = make_hull_data(box_mesh((0.5, 0.5, 0.5))[0])
    pts, n, d, v = hull_hull_manifold(
        jnp.array([0.0, 0.98, 0.0]), I3, h, jnp.zeros(3), I3, h
    )
    assert np.asarray(v).sum() == 4


@pytest.mark.slow
def test_deep_penetration_vs_support_oracle():
    """Deep-overlap stress (evidence for the no-EPA design). Hulls overlapping by up to a full half-extent at randomized
    orientations: the SAT manifold's (normal, depth) must match a
    brute-force support-function oracle — depth along the returned normal
    equals max_B(v·n) − min_A(v·n) (the overlap extent on that axis), and
    the returned axis must be within 2% of the globally shallowest axis
    over a dense direction fan. The face+edge-direction axis set is
    COMPLETE for convex polytopes, so the SAT minimum IS the exact MTV —
    EPA adds nothing; this test pins that claim at depth, not just for
    shallow contacts."""
    rng = np.random.default_rng(7)
    verts = box_mesh((0.5, 0.5, 0.5))[0]
    h = make_hull_data(verts)
    v_np = np.asarray(verts, np.float64)

    # dense direction fan for the oracle's global MTV search
    k = np.arange(2048, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    z = 1.0 - 2.0 * (k + 0.5) / len(k)
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    fan = np.stack([r * np.cos(golden * k), r * np.sin(golden * k), z], 1)

    def rand_rot():
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, zq = q
        return np.array([
            [1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq),
             2 * (x * zq + w * y)],
            [2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq),
             2 * (y * zq - w * x)],
            [2 * (x * zq - w * y), 2 * (y * zq + w * x),
             1 - 2 * (x * x + y * y)],
        ])

    checked = 0
    for _ in range(24):
        ra, rb = rand_rot(), rand_rot()
        # offset magnitude chosen to force DEEP overlap (≥ half-extent)
        off = rng.standard_normal(3)
        off *= rng.uniform(0.2, 0.6) / np.linalg.norm(off)
        pts, nrm, dep, val = hull_hull_manifold(
            jnp.asarray(off, jnp.float32), jnp.asarray(ra, jnp.float32), h,
            jnp.zeros(3, jnp.float32), jnp.asarray(rb, jnp.float32), h,
        )
        val = np.asarray(val)
        if not val.any():
            continue
        va = v_np @ ra.T + off
        vb = v_np @ rb.T
        kbest = int(np.argmax(np.where(val, np.asarray(dep), -1.0)))
        n_got = np.asarray(nrm, np.float64)[kbest]
        d_got = float(np.asarray(dep)[kbest])
        # overlap extent along the returned axis (B → A): how far A must
        # move along +n to separate
        ext = (vb @ n_got).max() - (va @ n_got).min()
        assert ext > 0.2, ext            # genuinely deep
        # contact points lie inside the clipped face-overlap region, so
        # their depth is ≤ the axis extent (equality when the deepest
        # incident vertex survives clipping) and within a few % of it
        assert d_got <= ext + 5e-3, (d_got, ext)
        assert d_got >= 0.5 * ext, (d_got, ext)
        # the chosen axis must be the global MTV direction up to the
        # face-preference fudge (1e-4 + 5% of depth, ops/hullhull.py)
        exts = np.maximum(
            (vb @ fan.T).max(0) - (va @ fan.T).min(0), 0.0)
        mtv = float(exts.min())
        assert ext <= mtv * 1.06 + 2e-3, (ext, mtv)
        checked += 1
    assert checked >= 20, checked       # deep overlaps actually exercised


def test_separated_hulls_no_manifold():
    h = make_hull_data(beveled_cube_mesh(0.5, 0.08)[0])
    _, _, _, v = hull_hull_manifold(
        jnp.array([0.0, 3.0, 0.0]), I3, h, jnp.zeros(3), I3, h
    )
    assert not np.any(np.asarray(v))


def test_gjk_distance_exact_for_cubes():
    v, _ = box_mesh((0.5, 0.5, 0.5))
    va = jnp.asarray(v)
    mask = jnp.ones(len(v))
    d, direction, sep = gjk_distance(va + jnp.array([2.0, 0, 0]), mask, va, mask)
    assert bool(sep)
    np.testing.assert_allclose(float(d), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(direction), [1, 0, 0], atol=1e-5)


def test_gjk_detects_overlap():
    v, _ = box_mesh((0.5, 0.5, 0.5))
    va = jnp.asarray(v)
    mask = jnp.ones(len(v))
    d, _, sep = gjk_distance(va + jnp.array([0.3, 0.2, 0.0]), mask, va, mask)
    assert not bool(sep)
    assert float(d) == 0.0


def test_gjk_diagonal_direction():
    v, _ = box_mesh((0.5, 0.5, 0.5))
    va = jnp.asarray(v)
    mask = jnp.ones(len(v))
    d, direction, sep = gjk_distance(
        va + jnp.array([2.0, 2.0, 0.0]), mask, va, mask
    )
    assert bool(sep)
    np.testing.assert_allclose(float(d), np.sqrt(2.0), rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(direction), [np.sqrt(0.5), np.sqrt(0.5), 0], atol=1e-4
    )


@pytest.mark.slow
def test_beveled_hull_stack_stable():
    """Flat-face hull stacking — the degenerate case vertex-face can't do."""
    hv, ht = beveled_cube_mesh(0.5, 0.08)
    m, _, inertia = mesh_inertia(hv, ht)
    b = SceneBuilder()
    h = b.add_hull(hv)
    for k in range(3):
        i = b.add_body(pos=(0, 0.5 + 1.0 * k + 0.002 * k, 0),
                       mass=float(m), inertia=inertia)
        b.set_hull(i, h, friction=0.6)
    cfg = SimConfig(compat=False, ground_plane=True, pair_collisions=True,
                    contact_iters=32, dt=1.0 / 120.0)
    final, _ = rollout(b.build(), cfg, num_steps=480)
    y = np.sort(np.asarray(final.pos[:, 1]))
    gaps = np.diff(y)
    assert np.all(gaps > 0.9) and np.all(gaps < 1.1), y
    assert float(np.max(np.abs(np.asarray(final.vel)))) < 0.01


@pytest.mark.slow
def test_cube_drop_rests_on_ground():
    """The cube-drop scene: single cube.obj hull dropped onto the ground
    (scenes.cube_drop — real res/cube.obj hull when mounted, procedural
    bevel cube otherwise). It must come to rest with its lowest face on
    the plane: resting height ≈ size (bevel shaves a few mm) and
    negligible residual velocity."""
    from physics_tpu.engine import rollout
    from physics_tpu.scenes import cube_drop, drop_config

    final, _ = rollout(cube_drop(height=1.5, size=0.5), drop_config(),
                       num_steps=480)
    y = float(final.pos[0, 1])
    assert 0.40 < y < 0.55, y
    assert float(np.max(np.abs(np.asarray(final.vel)))) < 0.02
    assert np.all(np.isfinite(np.asarray(final.quat)))


_HULL_FAST_PARITY_SCRIPT = r"""
import dataclasses
import numpy as np
import jax

from physics_tpu import engine
from physics_tpu.ops import narrowphase as nph
from physics_tpu.ops.broadphase import pair_candidates
from physics_tpu.scenes import mesh_rain, rain_config

# contact-rich WITHOUT stepping (a jitted settle would cost minutes of
# XLA:CPU compile): compress the rain state into a tight grid of
# randomly-oriented overlapping hulls
state = mesh_rain(24, seed=0)
rng = np.random.default_rng(3)
g = np.stack(np.meshgrid(*[np.arange(3) * 0.72] * 2, np.arange(3) * 0.72,
                         indexing="ij"), -1).reshape(-1, 3)[:24]
q = rng.normal(size=(24, 4)).astype(np.float32)
q /= np.linalg.norm(q, axis=1, keepdims=True)
s = state.replace(
    pos=jax.numpy.asarray(
        (g + rng.uniform(-0.05, 0.05, (24, 3))).astype(np.float32)),
    quat=jax.numpy.asarray(q))
# the synthetic grid is far denser than a settled rain: widen the pair /
# contact capacities so nothing overflows — under contact overflow the
# drop-by-lowest-rank policy keeps a different (order-dependent) subset
# per emission layout, which is documented behavior, not a parity bug
cfg = dataclasses.replace(rain_config(24), max_contacts=768,
                          max_pair_candidates=768, hull_prefilter_cap=768)
cfg_slow = dataclasses.replace(cfg, hull_fast=False)
assert cfg.hull_fast  # default ON for single-hull-type scenes

cand = pair_candidates(s, cfg)
cvx = nph.convex_data(s)


# the fast paths emit contacts slot-major, the generic paths pair-/body-
# major; match by feature key ((pair, slot) / (body, vertex) stable ids —
# identical formulas in both epilogues), which no downstream consumer
# depends on the order of
def match(c_fast, c_slow, what, min_active):
    kf = np.asarray(c_fast.key)
    ks = np.asarray(c_slow.key)
    af = kf != 0
    asl = ks != 0
    assert af.sum() >= min_active, (what, af.sum())
    assert sorted(kf[af].tolist()) == sorted(ks[asl].tolist()), what
    of = np.argsort(kf[af])
    osl = np.argsort(ks[asl])
    np.testing.assert_allclose(np.asarray(c_fast.depth)[af][of],
                               np.asarray(c_slow.depth)[asl][osl],
                               atol=1e-5, err_msg=what)
    for fld in ("normal", "point"):
        a = np.moveaxis(np.asarray(getattr(c_fast, fld)), 0, -1)[af][of]
        b = np.moveaxis(np.asarray(getattr(c_slow, fld)), 0, -1)[asl][osl]
        np.testing.assert_allclose(a, b, atol=1e-4,
                                   err_msg=what + " " + fld)


match(nph.pair_contacts(s, cvx, cand, cfg),
      nph.pair_contacts(s, cvx, cand, cfg_slow), "pairs", 20)

# ground contacts: lower the grid so vertices cross the plane
s2 = s.replace(pos=s.pos - jax.numpy.asarray([0.0, 0.45, 0.0]))
cvx2 = nph.convex_data(s2)
match(nph.ground_contacts(s2, cvx2, cfg),
      nph.ground_contacts(s2, cvx2, cfg_slow), "ground", 10)

# composed-step parity, EAGER (a jitted step program for each config
# costs 10+ min of XLA:CPU compile on this box): impulses must land on
# the same bodies through the slot-major rank-carry layout — a
# misaligned layout diverges to O(1) within a step, while legitimate
# f32 op-order differences between the two paths stay ~1e-5
sf = ss = s
for _ in range(3):
    sf = engine.step(sf, cfg)
    ss = engine.step(ss, cfg_slow)
assert np.abs(np.asarray(sf.pos) - np.asarray(ss.pos)).max() < 1e-3
assert np.isfinite(np.asarray(sf.pos)).all()
print("HULL_FAST_PARITY_OK")
"""


@pytest.mark.slow
def test_batched_hull_fast_path_matches_vmapped():
    """ops/hullhull_batched (single-shared-hull SAT via static [rows, 9]
    coefficient matmuls against the relative rotation) must reproduce the
    vmapped `hull_hull_manifold` narrow phase: same active contact set,
    float-level (depth, normal, point) agreement on a contact-rich rain
    state, and matching trajectories through the full step.

    Runs in a SINGLE-device-CPU subprocess like
    tests/test_boxes_only_path.py: under the suite's 8-virtual-device
    backend, programs of this size nondeterministically hit an XLA:CPU
    dispatch bug ("Execution supplied 36 buffers but compiled program
    expected 42")."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _HULL_FAST_PARITY_SCRIPT],
        env=env, capture_output=True, text=True, timeout=1800,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "HULL_FAST_PARITY_OK" in out.stdout


@pytest.mark.slow
def test_hull_obb_prefilter():
    """Phase-1 OBB face-SAT prefilter (cfg.hull_prefilter_cap): the
    compacted candidate set yields the IDENTICAL active contact set when
    the cap doesn't overflow (conservative: only OBB-separated pairs are
    dropped), and a fully separated scene keeps nothing."""
    import dataclasses

    from physics_tpu.ops import narrowphase as nph
    from physics_tpu.ops.broadphase import pair_candidates
    from physics_tpu.ops.narrowphase import hull_obb_prefilter
    from physics_tpu.scenes import mesh_rain, rain_config

    state = mesh_rain(24, seed=0)
    rng = np.random.default_rng(3)
    g = np.stack(np.meshgrid(*[np.arange(3) * 0.72] * 2,
                             np.arange(3) * 0.72,
                             indexing="ij"), -1).reshape(-1, 3)[:24]
    q = rng.normal(size=(24, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    import jax.numpy as jnp
    tight = state.replace(
        pos=jnp.asarray((g + rng.uniform(-0.05, 0.05, (24, 3))
                         ).astype(np.float32)),
        quat=jnp.asarray(q))
    cfg = dataclasses.replace(rain_config(24), max_pair_candidates=768,
                              hull_prefilter_cap=0)

    cand = pair_candidates(tight, cfg)
    cand2, ovf = hull_obb_prefilter(tight, cand, 512)
    assert int(ovf) == 0
    c_full = nph.pair_contacts(tight, None, cand, cfg)
    c_pre = nph.pair_contacts(tight, None, cand2, cfg)
    kf = np.asarray(c_full.key)
    kp = np.asarray(c_pre.key)
    assert (kf != 0).sum() > 20
    assert sorted(kf[kf != 0].tolist()) == sorted(kp[kp != 0].tolist())
    # depths travel with the keys
    df = np.asarray(c_full.depth)[kf != 0]
    dp = np.asarray(c_pre.depth)[kp != 0]
    np.testing.assert_allclose(np.sort(df), np.sort(dp), atol=1e-6)

    # the pairs rode the compaction: active slots hold distinct bodies
    m2 = np.asarray(cand2.mask)
    assert np.all(np.asarray(cand2.body_a)[m2]
                  != np.asarray(cand2.body_b)[m2])

    # fully separated grid: every pair's OBBs are disjoint -> zero kept
    spread = tight.replace(pos=tight.pos * 10.0)
    cand_s = pair_candidates(spread, cfg)
    cand_s2, ovf_s = hull_obb_prefilter(spread, cand_s, 512)
    assert int(ovf_s) == 0
    assert int(np.asarray(cand_s2.mask).sum()) == 0

    # tiny cap: overflow is counted, never silent
    _, ovf_t = hull_obb_prefilter(tight, cand, 128)
    assert int(ovf_t) > 0
