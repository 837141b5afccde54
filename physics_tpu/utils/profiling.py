"""Tracing / profiling utilities (SURVEY.md §5: the reference's only
performance surface is an imgui FPS readout, src/rendering.rs:463; here the
step is instrumented with jax.named_scope phases — forces/joints/contacts/
integrate, see engine.step_with_metrics — and these helpers capture and
summarize device traces).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Tuple

import jax


@contextlib.contextmanager
def trace(path: str):
    """Capture a device trace (perfetto/xplane) under `path`.

    View in TensorBoard's profile plugin, Perfetto, or summarize with
    `summarize_trace` below.
    """
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn: Callable, *args, iters: int = 10) -> float:
    """Wall-clock seconds per call of a jitted `fn`, each timed window
    ended by block_until_ready (the first, compiling call is untimed)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def summarize_trace(trace_dir: str, top: int = 20) -> Dict[str, Tuple[float, int]]:
    """Aggregate device time by source line from a captured trace.

    Returns {source: (milliseconds, op_count)} sorted by time. Reads the
    per-event `device_duration_ps` field of the trace; events without it
    are ignored.

    Only LEAF events are counted. Container events (jit_*, while, and
    `lax.cond` conditionals) carry their children's device time, so
    summing every event double-counts. Name-prefix filtering can't
    enumerate every container kind, so containment is detected
    structurally: within one (pid, tid) track, an event whose time
    interval strictly contains another event's start is a container and
    is skipped.
    """
    import collections
    import glob
    import gzip
    import json

    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with gzip.open(paths[-1]) as fh:
        tr = json.load(fh)
    # whole-program container events (jit_<fn>) live on their own "XLA
    # Modules" track, where per-track containment can't see their
    # children (those are on the "XLA Ops" track) — identify module
    # tracks from the thread_name metadata and drop them outright
    module_tracks = {
        (e.get("pid"), e.get("tid"))
        for e in tr.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "thread_name"
        and "Modules" in (e.get("args") or {}).get("name", "")
    }
    # bucket candidate events per device track so containment is local
    tracks = collections.defaultdict(list)
    for e in tr.get("traceEvents", []):
        args = e.get("args")
        if e.get("ph") != "X" or not args or "device_duration_ps" not in args:
            continue
        key = (e.get("pid"), e.get("tid"))
        if key in module_tracks or e.get("name", "").startswith("jit_"):
            continue  # program-level container (metadata or name match)
        tracks[key].append(e)
    by_src = collections.Counter()
    by_cnt = collections.Counter()
    for events in tracks.values():
        # sort by (start asc, duration desc): a container sorts before
        # its first child, so "next event starts before I end" flags
        # exactly the containers (device ops on one track never overlap
        # otherwise). Nested containers (while→cond→fusion) are each
        # flagged in turn; leaves survive.
        events.sort(key=lambda e: (e.get("ts", 0), -e.get("dur", 0)))
        for i, e in enumerate(events):
            end = e.get("ts", 0) + e.get("dur", 0)
            if i + 1 < len(events) and events[i + 1].get("ts", 0) < end:
                continue  # container: carries children's device time
            args = e["args"]
            src = args.get("source", args.get("tf_op", e.get("name", "")))
            by_src[src] += int(args["device_duration_ps"])
            by_cnt[src] += 1
    return {
        src: (ps / 1e9, by_cnt[src]) for src, ps in by_src.most_common(top)
    }
