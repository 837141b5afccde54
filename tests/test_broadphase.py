"""Broad-phase unit tests: AABBs, all-pairs, and sweep-window equivalence."""

import numpy as np
import jax.numpy as jnp

from physics_tpu import SceneBuilder, SimConfig
from physics_tpu.ops.broadphase import (
    allpairs_candidates,
    body_aabbs,
    sweep_candidates,
)
from physics_tpu.maths import quaternion as quat


def random_scene(n, seed, spread=5.0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for k in range(n):
        i = b.add_body(pos=rng.uniform(-spread, spread, 3),
                       euler=rng.uniform(-1, 1, 3))
        if k % 3 == 0:
            b.set_sphere(i, rng.uniform(0.2, 0.8))
        else:
            b.set_box(i, rng.uniform(0.2, 0.8, 3))
    return b.build()


def pairs_set(cand):
    a = np.asarray(cand.body_a)
    b = np.asarray(cand.body_b)
    m = np.asarray(cand.mask)
    return {tuple(sorted((int(x), int(y)))) for x, y, mm in zip(a, b, m) if mm}


def test_sphere_aabb():
    b = SceneBuilder()
    i = b.add_body(pos=(1, 2, 3))
    b.set_sphere(i, 0.5)
    aabbs = np.asarray(body_aabbs(b.build()))
    np.testing.assert_allclose(aabbs[0, 0], [0.5, 1.5, 2.5])
    np.testing.assert_allclose(aabbs[0, 1], [1.5, 2.5, 3.5])


def test_rotated_box_aabb_conservative():
    b = SceneBuilder()
    i = b.add_body(pos=(0, 0, 0), euler=(0.0, 0.0, np.pi / 4))
    b.set_box(i, (1.0, 1.0, 1.0))
    state = b.build()
    aabbs = np.asarray(body_aabbs(state))
    # the AABB must contain every rotated corner
    rot = np.asarray(quat.to_matrix(state.quat))[0]
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    )
    world = corners @ rot.T
    assert np.all(world >= aabbs[0, 0] - 1e-5)
    assert np.all(world <= aabbs[0, 1] + 1e-5)
    # 45° about z: x/y extent = √2
    np.testing.assert_allclose(aabbs[0, 1, 0], np.sqrt(2), rtol=1e-5)


def test_allpairs_finds_overlaps_only():
    b = SceneBuilder()
    for x in (0.0, 0.9, 5.0):
        i = b.add_body(pos=(x, 0, 0))
        b.set_sphere(i, 0.5)
    state = b.build()
    cand = allpairs_candidates(state, body_aabbs(state))
    assert pairs_set(cand) == {(0, 1)}


def test_sweep_matches_allpairs_random():
    state = random_scene(64, seed=0)
    aabbs = body_aabbs(state)
    truth = pairs_set(allpairs_candidates(state, aabbs))
    sweep = sweep_candidates(state, aabbs, window=63)
    assert pairs_set(sweep) == truth
    assert int(sweep.overflow) == 0


def test_sweep_window_overflow_detected():
    # 40 bodies all overlapping at the origin: window 8 cannot cover them
    b = SceneBuilder()
    for _ in range(40):
        i = b.add_body(pos=(0, 0, 0))
        b.set_sphere(i, 1.0)
    state = b.build()
    sweep = sweep_candidates(state, body_aabbs(state), window=8)
    assert int(sweep.overflow) > 0  # loudly reported, never silent


def test_noncollidable_bodies_ignored():
    b = SceneBuilder()
    b.add_body(pos=(0, 0, 0))            # no shape
    i = b.add_body(pos=(0.1, 0, 0))
    b.set_sphere(i, 1.0)
    state = b.build()
    cand = allpairs_candidates(state, body_aabbs(state))
    assert pairs_set(cand) == set()


def test_sweep_window_masks_match_oracle():
    """The shifted-slice window masks of the sweep (sorted ranks i, i+d,
    d = 1..k, AABB overlap, both collidable) match a NumPy oracle; bodies
    without a shape sort to the end and pair with nothing."""
    from physics_tpu.ops.broadphase import _sweep_masks

    rng = np.random.default_rng(0)
    n, k = 96, 8
    b = SceneBuilder()
    for i in range(n):
        j = b.add_body(pos=rng.uniform([-6, 0, -1], [6, 2, 1]))
        if rng.uniform() > 0.1:
            b.set_box(j, tuple(rng.uniform(0.1, 0.8, 3)))
    state = b.build()
    aabbs_j = body_aabbs(state)
    order, mask, last = _sweep_masks(state, aabbs_j, k)

    aabbs = np.asarray(aabbs_j)
    coll = np.asarray(state.shapes.stype) != 0
    key = np.where(coll, aabbs[:, 0, 0], np.inf)
    ref_order = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(np.asarray(order), ref_order)
    a_s, c_s = aabbs[ref_order], coll[ref_order]
    ref = np.zeros((n, k), bool)
    for d in range(1, k + 1):
        lo = np.maximum(a_s[:n - d, 0], a_s[d:, 0])
        hi = np.minimum(a_s[:n - d, 1], a_s[d:, 1])
        ref[:n - d, d - 1] = (np.all(lo <= hi, axis=-1)
                              & c_s[:n - d] & c_s[d:])
    np.testing.assert_array_equal(np.asarray(mask), ref)
    # overflow flag: the furthest window neighbor still x-overlaps
    ref_last = np.zeros(n, bool)
    ref_last[:n - k] = (a_s[k:, 0, 0] <= a_s[:n - k, 1, 0]) & c_s[:n - k]
    np.testing.assert_array_equal(np.asarray(last), ref_last)
