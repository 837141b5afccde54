"""Golden trajectory parity: demo scene vs NumPy oracle.

The parity metric is the max position error of the
single-cube demo scene (reference: src/lib.rs:20-42) vs the reference
semantics, stepped at fixed dt (SURVEY.md §4 item 2).
"""

import numpy as np
import jax

from physics_tpu import scene
from physics_tpu.config import compat_config
from physics_tpu.engine import step, step_with_metrics
from physics_tpu.oracle import reference as oracle

DT = 1.0 / 60.0


def test_demo_scene_construction_matches_reference():
    state = scene.demo_scene()
    ora = oracle.demo_scene()
    np.testing.assert_allclose(
        np.asarray(state.pos[0]), ora.bodies[0].position
    )
    np.testing.assert_allclose(
        np.asarray(state.quat[0]), ora.bodies[0].rotation, rtol=1e-6
    )
    assert state.joints.capacity == 2


def test_single_step_parity():
    state = scene.demo_scene()
    cfg = compat_config(dt=DT)
    ora = oracle.demo_scene()

    state1, metrics = jax.jit(step_with_metrics, static_argnums=1)(state, cfg)
    ora.update(DT)

    assert bool(metrics["cg_converged"])
    np.testing.assert_allclose(
        np.asarray(state1.pos[0]), ora.bodies[0].position, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(state1.vel[0]), ora.bodies[0].lin_velocity, rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(state1.omega[0]), ora.bodies[0].angular_velocity,
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(state1.quat[0]), ora.bodies[0].rotation, rtol=1e-5, atol=1e-6
    )
    # warm start captured like previous_solution (reference physics.rs:45-46)
    assert ora.previous_solution is not None
    np.testing.assert_allclose(
        np.asarray(state1.lam_joint), ora.previous_solution, rtol=1e-4, atol=1e-5
    )


def test_300_step_trajectory_parity():
    """5 seconds of the swinging-cube demo; max position error is the metric."""
    state = scene.demo_scene()
    cfg = compat_config(dt=DT)
    ora = oracle.demo_scene()

    step_fn = jax.jit(step, static_argnums=1)

    max_pos_err = 0.0
    for i in range(300):
        state = step_fn(state, cfg)
        ora.update(DT)
        err = float(
            np.max(np.abs(np.asarray(state.pos[0]) - ora.bodies[0].position))
        )
        max_pos_err = max(max_pos_err, err)

    assert np.all(np.isfinite(np.asarray(state.pos)))
    # f32 op-order drift only; must stay at float-noise scale over 300 steps
    assert max_pos_err < 1e-3, f"max position error {max_pos_err}"
    # and the quaternion trajectory must also track
    qerr = float(
        np.max(np.abs(np.asarray(state.quat[0]) - ora.bodies[0].rotation))
    )
    assert qerr < 1e-2, f"quaternion error {qerr}"


def test_constraint_pulls_body_toward_origin():
    """Physical sanity: the FixToPoint constraint must bound the drift."""
    state = scene.demo_scene()
    cfg = compat_config(dt=DT)
    step_fn = jax.jit(step, static_argnums=1)
    for _ in range(600):
        state = step_fn(state, cfg)
    # Baumgarte ks=10/kd=1 keeps the cube within a bounded region of origin
    dist = float(np.linalg.norm(np.asarray(state.pos[0])))
    assert dist < 3.0, f"cube ran away: |x| = {dist}"
