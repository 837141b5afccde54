"""Contact pipeline integration tests (ground plane, pairs, stacks).

Kept deliberately small-N / short-horizon: each distinct SimConfig is a new
XLA program and this environment has one CPU core for compilation.
"""

import numpy as np
import jax

from physics_tpu import SceneBuilder, SimConfig
from physics_tpu.engine import rollout, step_with_metrics
from physics_tpu.io.meshes import box_inertia, sphere_inertia

CFG_GROUND = SimConfig(
    compat=False, ground_plane=True, dt=1.0 / 120.0, contact_iters=16
)
CFG_FULL = SimConfig(
    compat=False, ground_plane=True, pair_collisions=True,
    dt=1.0 / 120.0, contact_iters=32,
)


def test_box_rests_on_ground():
    b = SceneBuilder()
    i = b.add_body(pos=(0, 2.0, 0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5, 0.5, 0.5))
    final, _ = rollout(b.build(), CFG_GROUND, num_steps=480)
    y = float(final.pos[0, 1])
    assert abs(y - 0.5) < 0.02, y
    assert float(np.max(np.abs(np.asarray(final.vel)))) < 1e-3


def test_sphere_rests_on_ground():
    b = SceneBuilder()
    i = b.add_body(pos=(0.3, 2.0, -0.2), inertia=sphere_inertia(0.25, 1.0))
    b.set_sphere(i, 0.25)
    final, _ = rollout(b.build(), CFG_GROUND, num_steps=480)
    assert abs(float(final.pos[0, 1]) - 0.25) < 0.02


def test_restitution_bounces():
    b = SceneBuilder()
    i = b.add_body(pos=(0, 1.0, 0), inertia=sphere_inertia(0.1, 1.0))
    b.set_sphere(i, 0.1, restitution=0.8)
    cfg = CFG_GROUND.replace(restitution=0.8)
    state = b.build()
    max_y_after_bounce = 0.0
    hit = False
    step_fn = jax.jit(lambda s: step_with_metrics(s, cfg)[0])
    for _ in range(240):
        state = step_fn(state)
        y = float(state.pos[0, 1])
        if float(state.vel[0, 1]) > 0:
            hit = True
        if hit:
            max_y_after_bounce = max(max_y_after_bounce, y)
    assert hit
    # e=0.8 → rebound height ≈ e² · h₀ = 0.64 · 0.9 ≈ 0.58 (measured from r)
    assert max_y_after_bounce > 0.35, max_y_after_bounce


def test_friction_stops_sliding_box():
    b = SceneBuilder()
    i = b.add_body(pos=(0, 0.5, 0), vel=(2.0, 0, 0),
                   inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5, 0.5, 0.5), friction=0.8)
    final, _ = rollout(b.build(), CFG_GROUND, num_steps=240)
    # μ=0.8 decelerates 2 m/s in ~0.26 s; after 2 s the box must be stopped
    assert abs(float(final.vel[0, 0])) < 0.05
    # and it must have slid some distance before stopping, not teleported
    assert 0.05 < float(final.pos[0, 0]) < 1.0


def test_frictionless_box_keeps_sliding():
    b = SceneBuilder()
    i = b.add_body(pos=(0, 0.5, 0), vel=(2.0, 0, 0),
                   inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5, 0.5, 0.5), friction=0.0)
    final, _ = rollout(b.build(), CFG_GROUND, num_steps=240)
    assert float(final.vel[0, 0]) > 1.9


def test_sphere_sphere_head_on():
    b = SceneBuilder()
    a1 = b.add_body(pos=(-1.0, 0, 0), vel=(2.0, 0, 0),
                    inertia=sphere_inertia(0.5, 1.0))
    b.set_sphere(a1, 0.5)
    a2 = b.add_body(pos=(1.0, 0, 0), vel=(-2.0, 0, 0),
                    inertia=sphere_inertia(0.5, 1.0))
    b.set_sphere(a2, 0.5)
    cfg = SimConfig(compat=False, pair_collisions=True,
                    gravity=(0, 0, 0), dt=1.0 / 120.0)
    final, _ = rollout(b.build(), cfg, num_steps=120)
    p = np.asarray(final.pos)
    v = np.asarray(final.vel)
    assert np.all(np.isfinite(p))
    # symmetric: momentum zero, bodies separated
    np.testing.assert_allclose(v[0], -v[1], atol=1e-4)
    assert p[1, 0] - p[0, 0] >= 1.0 - 1e-3  # not interpenetrating


def test_five_box_stack_stable():
    b = SceneBuilder()
    h = 0.5
    for k in range(5):
        i = b.add_body(pos=(0, h + 2 * h * k + 0.001 * k, 0),
                       inertia=box_inertia((h, h, h), 1.0))
        b.set_box(i, (h, h, h), friction=0.6)
    final, _ = rollout(b.build(), CFG_FULL, num_steps=600)
    y = np.sort(np.asarray(final.pos[:, 1]))
    # boxes remain distinct layers roughly 1 apart (allow Baumgarte sag)
    gaps = np.diff(y)
    assert np.all(gaps > 0.9), y
    assert np.all(gaps < 1.1), y
    # resting: negligible velocity
    assert float(np.max(np.abs(np.asarray(final.vel)))) < 0.01
    # no lateral drift
    assert float(np.max(np.abs(np.asarray(final.pos[:, [0, 2]])))) < 0.05


def test_static_body_as_obstacle():
    b = SceneBuilder()
    s = b.add_body(pos=(0, 0.5, 0), static=True)
    b.set_box(s, (1.0, 0.5, 1.0))
    i = b.add_body(pos=(0.2, 2.5, 0), inertia=box_inertia((0.3,) * 3, 1.0))
    b.set_box(i, (0.3, 0.3, 0.3))
    cfg = SimConfig(compat=False, pair_collisions=True, dt=1.0 / 120.0,
                    contact_iters=16)
    final, _ = rollout(b.build(), cfg, num_steps=480)
    # static platform does not move; box rests on top of it (y = 1 + 0.3)
    np.testing.assert_allclose(np.asarray(final.pos[0]), [0, 0.5, 0], atol=1e-6)
    assert abs(float(final.pos[1, 1]) - 1.3) < 0.03


def test_contact_metrics_surfaced():
    b = SceneBuilder()
    i = b.add_body(pos=(0, 0.4, 0), inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5, 0.5, 0.5))
    state = b.build()
    _, metrics = jax.jit(step_with_metrics, static_argnums=1)(state, CFG_GROUND)
    assert int(metrics["contact_count"]) == 4  # 4 corners penetrate
    assert float(metrics["max_penetration"]) > 0.05


def test_warm_start_key_matching_sort_merge():
    """The sort-merge warm matcher must recover exactly the impulses cached
    under matching feature keys (NumPy oracle over random key tables)."""
    import jax.numpy as jnp
    from physics_tpu.ops.narrowphase import Contacts
    from physics_tpu.solver.contacts import solve_impulses
    from physics_tpu.io.meshes import box_inertia

    rng = np.random.default_rng(7)
    # two bodies resting: one contact each against ground, synthetic keys
    b = SceneBuilder()
    for k in range(2):
        i = b.add_body(pos=(k * 2.0, 0.45, 0),
                       inertia=box_inertia((0.5,) * 3, 1.0))
        b.set_box(i, (0.5, 0.5, 0.5))
    state = b.build()

    c = 8
    keys = np.array([5, 9, 0, 3, 12, 0, 7, 1], np.int32)
    active = keys != 0
    contacts = Contacts(
        body_a=jnp.zeros(c, jnp.int32),
        body_b=jnp.full((c,), -1, jnp.int32),
        point=jnp.zeros((3, c), jnp.float32),
        normal=jnp.stack([jnp.zeros(c), jnp.ones(c), jnp.zeros(c)]),
        depth=jnp.full((c,), 0.01, jnp.float32),
        active=jnp.asarray(active),
        friction=jnp.full((c,), 0.5, jnp.float32),
        restitution=jnp.zeros(c, jnp.float32),
        key=jnp.asarray(keys),
    )
    prev_keys = np.array([0, 0, 1, 3, 6, 9, 12, 40], np.int32)  # sorted
    prev_lam = rng.standard_normal((3, 8)).astype(np.float32)
    cfg = SimConfig(contact_iters=0, position_iters=0)
    _, _, _, _, lam3, _ = jax.jit(
        lambda s, ct: solve_impulses(
            s, ct, cfg,
            warm=(jnp.asarray(prev_keys), jnp.asarray(prev_lam)))
    )(state, contacts)
    lam3 = np.asarray(lam3)
    # oracle: for each active nonzero cur key present in prev_keys, the
    # cached lam must come through; else zero (contact_iters=0 keeps values)
    for i, k in enumerate(keys):
        if k != 0 and active[i] and k in prev_keys:
            j = int(np.where(prev_keys == k)[0][0])
            np.testing.assert_allclose(lam3[:, i], prev_lam[:, j],
                                       rtol=1e-6, err_msg=str(i))
        else:
            np.testing.assert_allclose(lam3[:, i], 0.0)


def test_ten_box_stack_stable():
    """The box-stack scene at its named scale: ten boxes (the five-box
    test above keeps a cheap-compile variant; this pins the actual
    scene)."""
    from physics_tpu.scenes import box_stack

    final, _ = rollout(box_stack(10), CFG_FULL, num_steps=600)
    y = np.sort(np.asarray(final.pos[:, 1]))
    gaps = np.diff(y)
    assert np.all(gaps > 0.9), y
    assert np.all(gaps < 1.1), y
    assert float(np.max(np.abs(np.asarray(final.vel)))) < 0.01
    assert float(np.max(np.abs(np.asarray(final.pos[:, [0, 2]])))) < 0.05
