"""Multi-device scaling via jax.sharding / shard_map over a device Mesh.

The reference is strictly single-process, single-thread, no distributed
communication of any kind (SURVEY.md §2a). This framework scales along
two axes, both with XLA collectives over the device interconnect:

  * **env axis (data parallel)** — batched independent environments, state
    sharded on the leading env dimension. No cross-device communication at
    all; each device steps its shard. This is the RL/throughput axis
    (e.g. 4096 batched randomized scenes per device).

  * **row axis (the model/tensor-parallel analogue)** — ONE giant scene:
    body state replicated, constraint rows and contact pairs sharded. The
    solvers psum impulse/force deltas and CG scalars each iteration
    (physics_tpu.solver.cg / solver.contacts), which XLA lowers to
    all-reduces. This is how a scene too contact-heavy for one device
    scales.
    Note: results match the single-device step up to f32 reduction order
    (per-shard partial sums + psum vs one scatter) — bit-identical per-step
    semantics, ~1e-5-scale numeric noise, which chaotic contact scenes
    amplify over long horizons exactly as any reduction reordering would.

  * **hybrid** — a 2-D mesh ('env', 'row') combines both.

Multi-host: call jax.distributed.initialize() before building the mesh and
these functions work unchanged across hosts (the mesh covers the global
device set).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from physics_tpu.config import SimConfig
from physics_tpu.engine import step, step_with_metrics
from physics_tpu.state import SimState

from jax import shard_map


def make_mesh(
    axis_sizes: Sequence[int],
    axis_names: Sequence[str],
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over the available devices (row-major reshape of the
    device list: every device reaches every other, so the mesh follows the
    algorithm's axes and assumes no torus)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    grid = devices[: int(np.prod(axis_sizes))].reshape(tuple(axis_sizes))
    return Mesh(grid, tuple(axis_names))


def shard_envs(batched_state: SimState, mesh: Mesh, axis: str = "env"
               ) -> SimState:
    """Place a [E, ...] batched state with the env axis sharded on `axis`."""
    sharding = NamedSharding(mesh, P(axis))

    def put(leaf):
        return jax.device_put(leaf, sharding)

    return jax.tree_util.tree_map(put, batched_state)


def env_sharded_step(cfg: SimConfig, mesh: Mesh, axis: str = "env"):
    """jit-compiled vmapped step over an env-sharded batched state.

    Envs are independent → XLA compiles to pure shard-local compute, no
    collectives. Returns a function batched_state → batched_state.
    """
    sharding = NamedSharding(mesh, P(axis))

    @partial(jax.jit, in_shardings=sharding, out_shardings=sharding,
             donate_argnums=0)
    def stepped(batched: SimState) -> SimState:
        return jax.vmap(lambda s: step(s, cfg))(batched)

    return stepped


def row_sharded_step(cfg: SimConfig, mesh: Mesh, axis: str = "row"):
    """Single giant scene: bodies replicated, rows/pairs sharded on `axis`.

    Capacity requirements (asserted at trace time): the joint capacity, the
    broad-phase candidate count, and every contact group's slot count must
    be divisible by the axis size.
    """
    n_shards = mesh.shape[axis]

    @jax.jit
    def stepped(state: SimState) -> SimState:
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=P(),      # replicated body state in
            out_specs=P(),     # replicated state out
            check_vma=False,
        )
        def inner(s: SimState) -> SimState:
            out, _ = step_with_metrics(s, cfg, shard=(axis, n_shards))
            return out

        return inner(state)

    return stepped


def hybrid_step(cfg: SimConfig, mesh: Mesh, env_axis: str = "env",
                row_axis: str = "row"):
    """2-D mesh: env shards on one axis, each env's rows/pairs on the other."""
    n_rows = mesh.shape[row_axis]

    @jax.jit
    def stepped(batched: SimState) -> SimState:
        @partial(
            shard_map,
            mesh=mesh,
            in_specs=P(env_axis),
            out_specs=P(env_axis),
            check_vma=False,
        )
        def inner(local: SimState) -> SimState:
            def one(s: SimState) -> SimState:
                out, _ = step_with_metrics(s, cfg, shard=(row_axis, n_rows))
                return out

            return jax.vmap(one)(local)

        return inner(batched)

    return stepped
