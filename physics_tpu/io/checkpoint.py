"""Checkpoint / resume.

The reference has none — state lives only in RAM (SURVEY.md §5,
reference: src/physics.rs:25-31). Because SimState is a pytree of arrays this
framework gets it nearly for free: flatten → savez / load → unflatten.
The CG warm start (`lam_joint`, the analogue of `previous_solution`,
reference physics.rs:29) and contact warm start round-trip with it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from physics_tpu.state import SimState


def save(path: str, state: SimState) -> None:
    leaves, treedef = jax.tree_util.tree_flatten(state)
    np.savez(
        path,
        __treedef__=np.frombuffer(repr(treedef).encode(), dtype=np.uint8),
        **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)},
    )


def load(path: str, like: SimState) -> SimState:
    """Load a checkpoint into the structure of `like` (same scene shapes).

    The stored treedef repr is validated against `like`'s treedef so a
    checkpoint cannot silently load into a structurally different (but
    same-shaped) scene."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves, treedef = jax.tree_util.tree_flatten(like)
    if "__treedef__" in data:
        stored = bytes(data["__treedef__"]).decode()
        if stored != repr(treedef):
            raise ValueError(
                "checkpoint treedef does not match the target scene structure:\n"
                f"  stored: {stored[:200]}...\n  target: {repr(treedef)[:200]}..."
            )
    new_leaves = []
    for i, leaf in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if arr.shape != np.shape(leaf):
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != scene {np.shape(leaf)}"
            )
        new_leaves.append(jnp.asarray(arr))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def save_orbax(path: str, state: SimState) -> None:
    """Save via orbax (async-capable, multi-host-aware production
    checkpointing); `path` must be a directory.

    Zero-size leaves (empty warm-start buffers etc.) are skipped — orbax
    refuses them — and restored from the `like` template on load."""
    import os

    import orbax.checkpoint as ocp

    leaves, _ = jax.tree_util.tree_flatten(state)
    payload = {
        f"leaf_{i}": leaf for i, leaf in enumerate(leaves)
        if np.size(leaf) > 0
    }
    with ocp.StandardCheckpointer() as ckpt:
        ckpt.save(os.path.abspath(path), payload, force=True)


def load_orbax(path: str, like: SimState) -> SimState:
    import os

    import orbax.checkpoint as ocp

    leaves, treedef = jax.tree_util.tree_flatten(like)
    template = {
        f"leaf_{i}": leaf for i, leaf in enumerate(leaves)
        if np.size(leaf) > 0
    }
    with ocp.StandardCheckpointer() as ckpt:
        data = ckpt.restore(os.path.abspath(path), template)
    new_leaves = [
        data.get(f"leaf_{i}", leaf) for i, leaf in enumerate(leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
