"""Profiling/multi-host utility tests (single-process paths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_fence_and_time_fn():
    """time_fn waits for the device with block_until_ready."""
    from physics_tpu.utils.profiling import time_fn

    calls = []

    def f(x):
        calls.append(1)
        return jax.jit(lambda y: y * 2.0)(x)

    x = jnp.ones((128,))
    dt = time_fn(f, x, iters=3)
    assert dt > 0
    assert len(calls) == 4          # one untimed warm-up call + 3 timed


def test_trace_and_summarize(tmp_path):
    from physics_tpu.utils.profiling import summarize_trace, trace

    f = jax.jit(lambda x: jnp.sin(x) @ jnp.cos(x).T)
    x = jnp.ones((64, 64))
    _ = f(x)
    with trace(str(tmp_path)):
        np.asarray(f(x))
    summary = summarize_trace(str(tmp_path))
    assert isinstance(summary, dict)


def test_summarize_trace_skips_containers(tmp_path):
    """Container events (jit_, while, AND lax.cond conditionals) carry
    their children's device time; summing them double-counts. The
    summarizer must detect containment structurally, not by name
    prefix."""
    import gzip
    import json
    import os

    from physics_tpu.utils.profiling import summarize_trace

    def ev(name, ts, dur, ps, src=None):
        args = {"device_duration_ps": ps}
        if src:
            args["source"] = src
        return {"ph": "X", "pid": 1, "tid": 2, "name": name,
                "ts": ts, "dur": dur, "args": args}

    events = [
        # jit container wrapping everything (1000 ps = children's sum)
        ev("jit_run", 0, 100, 1000),
        # a while container inside it
        ev("while", 0, 60, 600),
        # a conditional container inside the while: its name has no
        # jit_/while prefix but it still double-counts
        ev("conditional.1", 0, 40, 400, src="contacts.py:1069"),
        # leaves inside the conditional
        ev("fusion.1", 0, 20, 250, src="kernel_a.py:1"),
        ev("fusion.2", 25, 15, 150, src="kernel_b.py:2"),
        # leaf inside the while but outside the cond
        ev("fusion.3", 45, 15, 200, src="kernel_c.py:3"),
        # leaf directly inside jit_run
        ev("fusion.4", 70, 30, 400, src="kernel_d.py:4"),
        # an event missing device_duration_ps is ignored entirely
        {"ph": "X", "pid": 1, "tid": 2, "name": "host", "ts": 0,
         "dur": 5, "args": {}},
    ]
    d = tmp_path / "plugins" / "profile" / "run1"
    os.makedirs(d)
    with gzip.open(d / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": events}, fh)

    summary = summarize_trace(str(tmp_path), top=100)
    total_ps = sum(ms * 1e9 for ms, _ in summary.values())
    # leaves only: 250 + 150 + 200 + 400 = 1000 ps
    assert total_ps == 1000.0
    assert "contacts.py:1069" not in summary  # the cond container
    assert summary["kernel_a.py:1"] == (250 / 1e9, 1)


def test_multihost_single_process_noop():
    from physics_tpu.parallel import multihost

    assert multihost.initialize() is False   # no cluster env → no-op
    assert multihost.is_primary()
    assert multihost.local_env_slice(64) == slice(0, 64)


def test_dense_onehot_gather_scatter_exact():
    """The N<=64 dense one-hot gather/scatter (ops/bodygather.py) must be
    numerically EXACT — it is a gather expressed as a matmul. A reduced
    precision matmul mode (TF32 on a GPU) would round the gathered values,
    which is why the einsums pin precision=HIGHEST."""
    from physics_tpu.ops.bodygather import lane_gather, lane_scatter_add

    rng = np.random.default_rng(0)
    table = jnp.asarray(
        rng.uniform(-1, 1, (6, 24)).astype(np.float32) * 150.0)
    idx = jnp.asarray(rng.integers(0, 24, 97).astype(np.int32))
    out = jax.jit(lane_gather)(table, idx)
    np.testing.assert_array_equal(
        np.asarray(out), np.asarray(table)[:, np.asarray(idx)])

    contrib = jnp.asarray(rng.uniform(-1, 1, (6, 97)).astype(np.float32))
    got = np.asarray(jax.jit(
        lambda c, i: lane_scatter_add(c, i, 24))(contrib, idx))
    want = np.zeros((6, 24), np.float32)
    # accumulate in the same lane order the matmul contracts (index order)
    for j, i in enumerate(np.asarray(idx)):
        want[:, i] += np.asarray(contrib)[:, j]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir_rule(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as given and nothing else is set;
    without it the cache sits at .jax_cache in the checkout."""
    import os

    from physics_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert compile_cache.cache_dir() == want
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
