"""The boxes_only fast path (batched component SAT + component ground
contacts — the benchmark pipeline) must agree with the generic convex
pipeline: same ground-contact sets and the same resting behavior."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from physics_tpu import SceneBuilder, SimConfig
from physics_tpu.engine import rollout, step
from physics_tpu.io.meshes import box_inertia
from physics_tpu.ops.narrowphase import (
    _ground_contacts_boxes,
    convex_data,
    ground_contacts,
)


def _scene(n=6, seed=3):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for k in range(n):
        i = b.add_body(
            pos=rng.uniform([-1.5, 0.2, -1.5], [1.5, 2.5, 1.5]),
            euler=rng.uniform(-0.6, 0.6, 3),
            inertia=box_inertia((0.4, 0.3, 0.5), 1.0),
        )
        b.set_box(i, (0.4, 0.3, 0.5), friction=0.6, restitution=0.1)
    return b.build()


def _rows(c):
    """Canonical active contact rows (body, point, depth, key)."""
    pt = np.asarray(c.point)
    rows = []
    for i in range(c.body_a.shape[0]):
        if bool(c.active[i]):
            rows.append((
                int(c.body_a[i]),
                tuple(np.round(pt[:, i], 4)),
                round(float(c.depth[i]), 4),
                int(c.key[i]),
            ))
    return sorted(rows)


@pytest.mark.parametrize("backend, on_cpu_device, boxes_only, want", [
    ("cpu", False, True, False),
    ("gpu", False, True, True),
    ("gpu", False, False, False),
    ("gpu", True, True, False),
], ids=["cpu", "gpu", "gpu-not-boxes", "gpu-backend-cpu-device"])
def test_boxes_fast_path_gate(backend, on_cpu_device, boxes_only, want,
                              monkeypatch):
    """The box fast path runs wherever the step runs, except on the CPU:
    the default backend decides, unless a jax.default_device says where
    the step will run."""
    from physics_tpu.ops import narrowphase

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = SimConfig(boxes_only=boxes_only)
    if on_cpu_device:
        with jax.default_device(jax.devices("cpu")[0]):
            assert narrowphase.boxes_fast_path(cfg) is want
    else:
        assert narrowphase.boxes_fast_path(cfg) is want


def test_ground_fast_path_matches_generic():
    state = _scene()
    cfg = SimConfig(ground_plane=True, boxes_only=True,
                    max_contacts_per_pair=4)
    fast = jax.jit(lambda s: _ground_contacts_boxes(s, cfg))(state)
    slow = jax.jit(
        lambda s: ground_contacts(s, convex_data(s), cfg)
    )(state)
    assert _rows(fast) == _rows(slow)


_STACK_SCRIPT = r"""
import os

import numpy as np
import jax
from physics_tpu import SceneBuilder, SimConfig
from physics_tpu.engine import step
from physics_tpu.io.meshes import box_inertia

b = SceneBuilder()
for k in range(3):
    i = b.add_body(pos=(0, 0.55 + 1.12 * k, 0),
                   inertia=box_inertia((0.5,) * 3, 1.0))
    b.set_box(i, (0.5, 0.5, 0.5))
state = b.build()
cfg = SimConfig(ground_plane=True, pair_collisions=True,
                dt=1.0 / 120.0, contact_iters=24, boxes_only=True)
step_fn = jax.jit(lambda s: jax.lax.scan(
    lambda s2, _: (step(s2, cfg), None), s, None, length=240)[0])
fast = step_fn(state)
y = np.asarray(fast.pos)[:, 1]
print("y:", sorted(np.round(y, 4).tolist()),
      "maxv:", float(np.max(np.abs(np.asarray(fast.vel)))))
np.testing.assert_allclose(sorted(y), [0.5, 1.5, 2.5], atol=0.05)
# cold 24-sweep Jacobi leaves the stack at the settling margin; the exact
# residual varies with XLA fusion order — assert boundedness, not rest
assert float(np.max(np.abs(np.asarray(fast.vel)))) < 0.15
print("STACK_OK")
"""


def test_boxes_only_stack_rests():
    """The full boxes_only pipeline (the benchmark config) holds a 3-box
    stack at rest.

    Runs in a SINGLE-device-CPU subprocess: the
    xla_force_host_platform_device_count=8 backend the suite uses for the
    sharding tests has a nondeterministic compile/exec deadlock on programs
    of this size (XLA CPU runtime bug — the same program runs in ~20 s on
    one CPU device)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _STACK_SCRIPT],
        env=env, capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "STACK_OK" in out.stdout
