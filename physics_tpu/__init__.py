"""physics_tpu — a rigid-body simulation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
Rust/wgpu engine (martingoe/physics): 6-DOF rigid bodies, equality-constraint
dynamics (Baraff-style J·W·Jᵀ·λ solved by matrix-free conjugate gradient),
semi-implicit Euler integration — extended with a full collision pipeline
(broad phase, narrow phase, impulse-based contacts), batched environments via
`vmap`, and multi-device scaling via `jax.sharding`.

Design stance (see SURVEY.md §7):
  * State is a pytree of SoA f32 arrays; the entire step is one jitted,
    pure function `step(state, cfg) -> state`.
  * Fixed capacities everywhere (joints, contact slots); validity masks
    instead of dynamic shapes.
  * `compat=True` reproduces the reference's exact numerical semantics,
    including its quirks (SURVEY.md §2b Q1–Q10), for trajectory parity;
    `compat=False` is the physically-correct path.
"""

from physics_tpu.config import SimConfig
from physics_tpu.state import SimState, Joints, Shapes
from physics_tpu.engine import step, step_with_metrics, rollout
from physics_tpu.scene import SceneBuilder

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "SimState",
    "Joints",
    "Shapes",
    "SceneBuilder",
    "step",
    "step_with_metrics",
    "rollout",
]
