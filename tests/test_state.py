"""The state containers are plain frozen dataclasses registered as JAX
pytrees: they flatten and rebuild, `.replace` returns an updated copy, and
they pass through jit, vmap and the npz checkpoint."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from physics_tpu import scene
from physics_tpu.io import checkpoint
from physics_tpu.state import HullSet, Joints, Shapes, SimState


def _joints():
    return Joints.empty(3).replace(ks=jnp.arange(3, dtype=jnp.float32))


def _shapes():
    return Shapes.none(4)


def _hulls():
    return HullSet.empty()


def _sim_state():
    return scene.demo_scene()


CASES = [(Joints, _joints, "ks"), (Shapes, _shapes, "friction"),
         (HullSet, _hulls, "face_offsets"), (SimState, _sim_state, "vel")]


@pytest.mark.parametrize("cls, make, field", CASES,
                         ids=[c[0].__name__ for c in CASES])
def test_state_dataclass_pytree(cls, make, field, tmp_path):
    obj = make()
    assert isinstance(obj, cls)

    # flatten / unflatten round trip
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert len(leaves) > 0
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, cls)
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # replace: a new object, the original untouched, frozen fields
    old = np.asarray(getattr(obj, field))
    new = obj.replace(**{field: getattr(obj, field) + 1})
    assert isinstance(new, cls)
    np.testing.assert_array_equal(np.asarray(getattr(new, field)), old + 1)
    np.testing.assert_array_equal(np.asarray(getattr(obj, field)), old)
    with pytest.raises(Exception):
        setattr(obj, field, old)

    # jit: a pytree in, a pytree out
    doubled = jax.jit(lambda o: jax.tree_util.tree_map(lambda x: x * 2, o))(
        obj)
    assert isinstance(doubled, cls)
    np.testing.assert_array_equal(np.asarray(getattr(doubled, field)),
                                  old * 2)

    # vmap over a stacked batch of two
    batch = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), obj)
    out = jax.vmap(lambda o: getattr(o, field).sum())(batch)
    np.testing.assert_allclose(np.asarray(out), [old.sum()] * 2)

    # npz checkpoint round trip
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, obj)
    loaded = checkpoint.load(path, make())
    assert isinstance(loaded, cls)
    for a, b in zip(jax.tree_util.tree_leaves(obj),
                    jax.tree_util.tree_leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_package_imports_without_flax():
    """The package and its step never import flax; with flax made
    unimportable the engine still builds and steps a scene."""
    code = (
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "import jax\n"
        "import physics_tpu\n"
        "from physics_tpu.engine import step\n"
        "from physics_tpu.scene import demo_scene\n"
        "from physics_tpu.config import compat_config\n"
        "s = jax.jit(step, static_argnums=1)(demo_scene(), compat_config())\n"
        "assert bool(jax.numpy.all(jax.numpy.isfinite(s.pos)))\n"
        "assert sys.modules['flax'] is None\n"
        "print('NO_FLAX_OK')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO_FLAX_OK" in out.stdout
