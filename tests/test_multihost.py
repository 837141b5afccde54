"""Two-process jax.distributed bootstrap test (multi-host scale-out path).

Spawns two REAL OS processes on this machine, each a separate JAX runtime
with 2 virtual CPU devices, connected through `multihost.initialize` (the
same `jax.distributed` path a multi-host cluster uses —
SURVEY.md §2a's scale-out row). Each process steps its local slice of a
4-env batch through `env_sharded_step` over the GLOBAL 4-device mesh and
verifies a cross-process collective agrees with the single-process
answer. Marked slow: two full JAX runtimes + a distributed service.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

_WORKER = r"""
import os, sys
import numpy as np

proc_id = int(sys.argv[1])
coord = sys.argv[2]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax
jax.config.update("jax_platforms", "cpu")

import jax.tree_util as jtu

from physics_tpu.parallel import multihost, sharding
from physics_tpu.config import SimConfig
from physics_tpu.scenes import random_env

started = multihost.initialize(
    coordinator_address=coord, num_processes=2, process_id=proc_id)
assert started, "expected a 2-process runtime"
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2
assert multihost.is_primary() == (proc_id == 0)

cfg = SimConfig(compat=False, ground_plane=True, pair_collisions=True,
                contact_iters=4, dt=1.0 / 60.0)
envs = [random_env(seed, n_bodies=2) for seed in range(4)]
batched = jtu.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                       *envs)

mesh = sharding.make_mesh([4], ["env"])
sl = multihost.local_env_slice(4)
assert (sl.stop - sl.start) == 2

# globally-sharded batch: each process contributes its local slice
from jax.sharding import NamedSharding, PartitionSpec as P

def make_global(leaf):
    shard = NamedSharding(mesh, P("env"))
    local = np.asarray(leaf)[sl]
    local_parts = np.split(local, 2, axis=0)
    arrs = [jax.device_put(p, d)
            for p, d in zip(local_parts, mesh.local_devices)]
    return jax.make_array_from_single_device_arrays(
        leaf.shape, shard, arrs)

gbatch = jtu.tree_map(make_global, batched)
stepped = sharding.env_sharded_step(cfg, mesh, "env")
out = stepped(gbatch)

# cross-process agreement: a psum-style global reduction of positions
tot = float(jax.jit(
    lambda s: jax.numpy.sum(s.pos),
    out_shardings=NamedSharding(mesh, P()))(out).addressable_data(0))
print(f"WORKER{proc_id} TOTAL {tot:.6f}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_env_sharded_step(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), coord],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True, cwd=os.path.dirname(os.path.dirname(__file__)),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)

    totals = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("WORKER"):
                pid, tot = line.split()[0], float(line.split()[-1])
                totals[pid] = tot
    assert set(totals) == {"WORKER0", "WORKER1"}, outs
    # the global reduction must agree bit-for-bit across processes
    assert totals["WORKER0"] == totals["WORKER1"], totals

    # single-process oracle: same 4 envs, one step, unsharded
    from physics_tpu.config import SimConfig
    from physics_tpu.engine import step
    from physics_tpu.scenes import random_env
    import jax
    import jax.tree_util as jtu

    cfg = SimConfig(compat=False, ground_plane=True, pair_collisions=True,
                    contact_iters=4, dt=1.0 / 60.0)
    envs = [random_env(seed, n_bodies=2) for seed in range(4)]
    batched = jtu.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *envs)
    out = jax.vmap(lambda s: step(s, cfg))(batched)
    expect = float(np.sum(np.asarray(jax.device_get(out.pos))))
    assert totals["WORKER0"] == pytest.approx(expect, rel=1e-5), (
        totals, expect)
