"""Multi-host (DCN) scale-out helpers.

The reference is strictly single-process (SURVEY.md §2a: no NCCL/MPI/Gloo
anywhere); this framework's scale-out story is JAX-native: intra-pod
sharding rides ICI via `jax.sharding` (see parallel/sharding.py), and
multi-host pods connect over DCN through `jax.distributed` — no custom
communication backend.

Typical use on a multi-host pod:

    from physics_tpu.parallel import multihost, sharding
    multihost.initialize()                  # no-op on single host
    mesh = sharding.make_mesh([jax.device_count()], ["env"])
    step = sharding.env_sharded_step(cfg, mesh, "env")

Checkpointing in multi-host runs: every host must call io.checkpoint.save
with the same path template + its process_index (fully replicated state
needs only process 0 to write).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed for a multi-host run; returns True if a
    multi-process runtime was started.

    With no arguments, auto-detects from the cluster environment (SLURM /
    JAX_COORDINATOR_ADDRESS etc., as jax.distributed does) and
    silently no-ops when the process is alone — safe to call
    unconditionally at program start.
    """
    explicit = coordinator_address is not None
    env_hint = any(
        v in os.environ
        for v in (
            "JAX_COORDINATOR_ADDRESS",
            "COORDINATOR_ADDRESS",
            "MEGASCALE_COORDINATOR_ADDRESS",
        )
    )
    if not (explicit or env_hint):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that should write checkpoints/logs."""
    return jax.process_index() == 0


def local_env_slice(n_envs: int) -> slice:
    """This host's contiguous slice of a globally batched env axis
    (hosts × local devices lay envs out process-major)."""
    per = n_envs // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)
