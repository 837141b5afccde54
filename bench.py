#!/usr/bin/env python
"""Benchmark harness. Prints one JSON line per workload:

    {"metric": ..., "value": N, "unit": "body-steps/sec/chip", ...}

Primary metric: body-steps/sec on the 4k-body box pile (ground plane +
pair collisions + sweep broad phase + SAT narrow phase + projected-Jacobi
impulse solve), printed first. The secondary workloads (1k/16k/65k piles,
4096x8 packed envs, mesh rain at 128/1024 and mixed-type 128) follow with
smaller timing windows (BENCH_SECONDARY=0 skips them). A workload that
fails stops the run with a non-zero exit.

Every line names the device it ran on (platform, device_kind, count) and
the card's name and power limit, since a card set below its maximum power
runs slower under load.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from functools import partial

import jax
import numpy as np

from physics_tpu.engine import step
from physics_tpu.scenes import box_pile, pile_config
from physics_tpu.utils.compile_cache import enable_compile_cache

# steps per compiled scan chunk: one host dispatch per chunk, so longer
# chunks measure device throughput rather than dispatch latency (rollout
# runs long horizons on device too)
CHUNK = 480


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_chunk_runner(cfg, chunk: int = CHUNK):
    """A jitted `chunk`-step scan of `step` (input state donated)."""
    @partial(jax.jit, donate_argnums=0)
    def run(s):
        out, _ = jax.lax.scan(lambda s2, _: (step(s2, cfg), None), s, None,
                              length=chunk)
        return out

    return run


def device_fields() -> dict:
    """What every JSON line says about the hardware it measured."""
    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except OSError:
        card = None
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def timed_chunks_of(run, state, n_bodies: int, tag: str,
                    settle_chunks: int, timed_chunks: int,
                    chunk: int = CHUNK):
    """Compile + settle, then time `timed_chunks` chunks of `run`, each
    ended by block_until_ready. Returns body-steps/s."""
    t0 = time.perf_counter()
    state = run(state)  # compile + first (settle) chunk
    jax.block_until_ready(state.pos)
    log(f"{tag}: compile+first chunk {time.perf_counter()-t0:.1f}s")
    for _ in range(settle_chunks):
        state = run(state)
    jax.block_until_ready(state.pos)

    sc0 = int(jax.device_get(state.step_count))
    t0 = time.perf_counter()
    for _ in range(timed_chunks):
        state = run(state)
    jax.block_until_ready(state.pos)
    dt = time.perf_counter() - t0
    # progress check: step_count is carried in-state, so a window whose
    # compute did not run cannot pass for a fast one
    sc1 = int(jax.device_get(state.step_count))
    if sc1 - sc0 != timed_chunks * chunk:
        raise RuntimeError(
            f"{tag}: timed window did not advance the state: step_count "
            f"{sc0}->{sc1}, expected +{timed_chunks * chunk}")
    if not np.all(np.isfinite(np.asarray(state.pos))):
        raise RuntimeError(f"{tag}: non-finite positions")
    sps = timed_chunks * chunk / dt
    log(f"{tag}: {n_bodies * sps / 1e6:.3f}M body-steps/s, "
        f"{1e3 / sps:.3f} ms/step")
    return n_bodies * sps


def bench_pile(n_bodies: int, settle_chunks: int = 1,
               timed_chunks: int = 10) -> float:
    """Box pile: body-steps/s. BENCH_CHUNKS overrides timed_chunks."""
    from physics_tpu.engine import prepare_contacts

    timed_chunks = int(os.environ.get("BENCH_CHUNKS", timed_chunks))
    # density-preserving trench: widen the x-aspect with N so each sorted
    # x-slice keeps ~32 bodies regardless of scale (the 16k/65k rows are
    # weak scaling along the trench — otherwise the sweep window
    # overflows)
    state = box_pile(n_bodies, x_aspect=max(16.0, n_bodies / 256))
    cfg = pile_config(n_bodies)
    state = prepare_contacts(state, cfg)
    return timed_chunks_of(make_chunk_runner(cfg), state, n_bodies,
                           f"pile[{n_bodies}]", settle_chunks, timed_chunks)


def bench_rain(n_bodies: int, chunk: int = 240, timed_chunks: int = 4,
               mixed: bool = False) -> float:
    """Mesh rain: cube.obj hulls (or, mixed=True, alternating bevel-cube
    and octahedron hulls) raining onto the ground."""
    from physics_tpu.engine import prepare_contacts
    from physics_tpu.scenes import mesh_rain, mesh_rain_mixed, rain_config

    cfg = rain_config(n_bodies)
    scene = mesh_rain_mixed(n_bodies) if mixed else mesh_rain(n_bodies)
    state = prepare_contacts(scene, cfg)
    tag = f"rain_mixed[{n_bodies}]" if mixed else f"rain[{n_bodies}]"
    return timed_chunks_of(make_chunk_runner(cfg, chunk), state, n_bodies,
                           tag, 1, timed_chunks, chunk=chunk)


def bench_batched_envs(n_envs: int = 4096, n_bodies: int = 8) -> float:
    """Block-diagonal packed envs: n_envs random box envs in one scene."""
    from physics_tpu.engine import prepare_contacts
    from physics_tpu.envs import pack_envs
    from physics_tpu.scenes import packed_config, random_env

    cfg = packed_config(n_bodies, n_envs)
    base = random_env(0, n_bodies)
    rng = np.random.default_rng(1)
    offsets = rng.uniform(-1, 1, (n_envs, 1, 3)).astype(np.float32)
    batched = jax.vmap(lambda o: base.replace(pos=base.pos + o))(offsets)
    packed = prepare_contacts(pack_envs(batched), cfg)
    return timed_chunks_of(make_chunk_runner(cfg), packed,
                           n_envs * n_bodies,
                           f"packed[{n_envs}x{n_bodies}]", 0, 1)


def main() -> None:
    enable_compile_cache()
    dev = device_fields()
    log(f"devices: {jax.devices()}")

    def emit(metric, thunk):
        v = thunk()
        print(json.dumps({"metric": metric, "value": round(float(v), 1),
                          "unit": "body-steps/sec/chip", **dev}),
              flush=True)

    emit("body_steps_per_sec_4k_pile", lambda: bench_pile(4096))
    if os.environ.get("BENCH_SECONDARY", "1") == "0":
        return
    emit("body_steps_per_sec_1k_pile",
         lambda: bench_pile(1024, timed_chunks=4))
    emit("body_steps_per_sec_16k_pile",
         lambda: bench_pile(16384, timed_chunks=4))
    emit("body_steps_per_sec_65k_pile",
         lambda: bench_pile(65536, timed_chunks=2))
    emit("body_steps_per_sec_packed_envs_4096x8", bench_batched_envs)
    emit("body_steps_per_sec_mesh_rain_128", lambda: bench_rain(128))
    emit("body_steps_per_sec_mesh_rain_1024", lambda: bench_rain(1024))
    emit("body_steps_per_sec_mesh_rain_mixed_128",
         lambda: bench_rain(128, mixed=True))


if __name__ == "__main__":
    main()
