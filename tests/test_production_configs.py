"""The production configs (scenes.pile_config, rain_config, packed_config)
through the user entry points on the CPU: drop and settle, warm starting,
and overflow that is counted, never silent."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from physics_tpu.config import SimConfig
from physics_tpu.engine import prepare_contacts, rollout, step, step_with_metrics
from physics_tpu.envs import pack_envs
from physics_tpu.scenes import (
    box_pile,
    box_stack,
    mesh_rain,
    packed_config,
    pile_config,
    rain_config,
    random_env,
)


def _pile():
    return box_pile(48, seed=1), pile_config(48), 0.5


def _rain():
    return mesh_rain(24, seed=1), rain_config(24), 0.5


def _packed():
    base = random_env(0, 8)
    offsets = np.random.default_rng(1).uniform(-1, 1, (6, 1, 3))
    batched = jax.vmap(lambda o: base.replace(pos=base.pos + o))(
        jnp.asarray(offsets, jnp.float32))
    return pack_envs(batched), packed_config(8, 6), 0.4


@pytest.mark.parametrize("scene", [_pile, _rain, _packed],
                         ids=["pile", "rain", "packed"])
def test_production_config_drop_settles(scene):
    """Drop + settle: finite, nothing through the ground, the lowest
    bodies at rest height (their half extent), the bulk at rest, and every
    overflow counter at 0."""
    state, cfg, half = scene()
    state = prepare_contacts(state, cfg)
    state, _ = rollout(state, cfg, num_steps=240)
    state, m = jax.jit(step_with_metrics, static_argnums=1)(state, cfg)
    pos = np.asarray(state.pos)
    assert np.all(np.isfinite(pos))
    assert np.all(np.isfinite(np.asarray(state.vel)))
    # the lowest bodies rest at their half extent, less the penetration
    # a 16-sweep Jacobi solve leaves under a 4-layer pile (~0.06)
    assert abs(pos[:, 1].min() - half) < 0.1, pos[:, 1].min()
    v = np.linalg.norm(np.asarray(state.vel), axis=1)
    assert float(np.median(v)) < 0.1, float(np.median(v))
    assert int(m["contact_count"]) > 0
    for k in ("pair_overflow", "contact_overflow", "prefilter_overflow"):
        assert int(m.get(k, 0)) == 0, (k, int(m[k]))


def _stack_cfg(**kw):
    base = dict(
        ground_plane=True, pair_collisions=True, broadphase="sweep",
        sweep_window=8, contact_iters=8, position_iters=8, boxes_only=True,
        max_contacts=128,
    )
    base.update(kw)
    return SimConfig(**base)


def test_warm_start_capacity_and_parity():
    """prepare_contacts sizes the warm buffers to the step's compacted
    contact count; after a few steps they hold sorted keys with impulses,
    and the sort-merge matcher hands every active keyed contact of the
    next step exactly the impulse stored under its key."""
    from physics_tpu.ops.narrowphase import (
        concat_contacts, convex_data, ground_contacts, pair_contacts)
    from physics_tpu.ops.broadphase import pair_candidates
    from physics_tpu.solver.contacts import compact_contacts, warm_start_lambda

    cfg = _stack_cfg()
    state = prepare_contacts(box_stack(6), cfg)
    assert state.contact_key.shape == (cfg.max_contacts,)
    assert state.contact_lam.shape == (3, cfg.max_contacts)
    step_fn = jax.jit(step, static_argnums=1)
    for _ in range(30):
        state = step_fn(state, cfg)
    keys = np.asarray(state.contact_key)
    lam = np.asarray(state.contact_lam)
    assert np.all(np.diff(keys) >= 0)
    assert float(lam[0].sum()) > 0.0

    def contacts_of(s):
        cvx = convex_data(s)
        c = concat_contacts(
            ground_contacts(s, cvx, cfg),
            pair_contacts(s, cvx, pair_candidates(s, cfg), cfg))
        return compact_contacts(c, cfg.max_contacts)[0]

    contacts = jax.jit(contacts_of)(state)
    c = contacts.key.shape[0]
    assert c == cfg.max_contacts
    got = np.asarray(jnp.stack(warm_start_lambda(
        contacts, (state.contact_key, state.contact_lam), c)))
    stored = {int(k): lam[:, i] for i, k in enumerate(keys) if k != 0}
    ck = np.asarray(contacts.key)
    act = np.asarray(contacts.active)
    matched = 0
    for i in range(c):
        if act[i] and ck[i] != 0 and int(ck[i]) in stored:
            np.testing.assert_array_equal(got[:, i], stored[int(ck[i])])
            matched += 1
        else:
            np.testing.assert_array_equal(got[:, i], 0.0)
    # a resting stack keeps (nearly) all of its contact features
    assert matched >= 0.9 * int(act.sum()), (matched, int(act.sum()))


@pytest.mark.parametrize("which", ["contact_overflow", "pair_overflow"])
def test_overflow_counted_not_silent(which):
    """Contacts beyond max_contacts, and candidate pairs beyond the sweep
    window or a bucket's capacity, are counted in the step metrics."""
    state = box_pile(64, seed=2)
    if which == "contact_overflow":
        cfg = pile_config(64).replace(max_contacts=16)
    else:
        cfg = pile_config(64).replace(sweep_window=2)
    full = pile_config(64)
    _, m = jax.jit(step_with_metrics, static_argnums=1)(state, cfg)
    _, m_full = jax.jit(step_with_metrics, static_argnums=1)(state, full)
    assert int(m_full[which]) == 0
    assert int(m[which]) > 0
    if which == "contact_overflow":
        # exactly the active contacts beyond the cap
        assert int(m["contact_count"]) == 16
        assert int(m[which]) == int(m_full["contact_count"]) - 16
