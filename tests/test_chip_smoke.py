"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions, called directly at tiny sizes, drive the same code paths
the card run does."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["cpu-platform", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """Under JAX_PLATFORMS=cpu, and in a directory holding nothing of the
    repo but the script, it exits non-zero and prints no result line."""
    env = dict(os.environ)
    if where == "cpu-platform":
        env["JAX_PLATFORMS"] = "cpu"
        cwd, script = REPO, os.path.join(REPO, "chip_smoke.py")
    else:
        env.pop("JAX_PLATFORMS", None)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
        env["PYTHONPATH"] = ""
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_workload_phases_tiny():
    """pile, rain and packed through run_workload at tiny sizes: finite,
    above the ground, counters reported."""
    _, pile = chip_smoke.phase_pile(32, chunk=8, timed_chunks=1)
    _, rain = chip_smoke.phase_rain(16, chunk=8, timed_chunks=1)
    _, packed = chip_smoke.phase_packed(4, 8, chunk=8, timed_chunks=1)
    for f, n in ((pile, 32), (rain, 16), (packed, 32)):
        assert f["bodies"] == n
        assert f["finite"] and f["min_y"] > 0.0
        assert f["body_steps_per_s"] > 0
        assert f["max_contact_overflow"] == 0
    assert "max_prefilter_overflow" in rain


def test_checks_tiny():
    """Checks (a)-(c) run end to end at tiny sizes (on the CPU, (b)
    compares the CPU with itself)."""
    from physics_tpu.engine import prepare_contacts, rollout
    from physics_tpu.scenes import box_pile, pile_config

    a = chip_smoke.check_compat_demo(steps=20)
    assert a["max_pos_err"] < 1e-3
    b = chip_smoke.check_cpu_parity(n=32)
    assert b["max_dpos"] == 0.0
    cfg = pile_config(16)
    state = prepare_contacts(box_pile(16, seed=3), cfg)
    state, _ = rollout(state, cfg, num_steps=60)
    c = chip_smoke.check_fast_vs_generic(state, cfg)
    assert c["pair_rows_fast"] == c["pair_rows_generic"] > 0
    assert c["ground_mismatched_groups"] == c["pair_mismatched_groups"] == 0


def _rows(points, depths):
    """A group-major contact buffer [G·k] from per-group lists of
    (point, depth) rows; a depth of 0 marks an inactive slot."""
    from physics_tpu.ops.narrowphase import Contacts

    pt = np.asarray(points, np.float32).reshape(-1, 3)
    d = np.asarray(depths, np.float32).reshape(-1)
    c = d.shape[0]
    nrm = np.tile(np.array([[0.0], [1.0], [0.0]], np.float32), (1, c))
    return Contacts(
        body_a=jnp.zeros((c,), jnp.int32), body_b=jnp.zeros((c,), jnp.int32),
        point=jnp.asarray(pt.T), normal=jnp.asarray(nrm),
        depth=jnp.asarray(d), active=jnp.asarray(d > 0),
        friction=jnp.zeros((c,)), restitution=jnp.zeros((c,)),
        key=jnp.zeros((c,), jnp.int32))


def _slot_major(c, groups, k):
    """The same buffer reordered slot-major (row s·G + g)."""
    idx = np.arange(groups * k).reshape(groups, k).T.reshape(-1)
    return jax.tree_util.tree_map(
        lambda x: x[..., idx] if x.ndim else x, c)


@pytest.mark.parametrize("case", ["same", "tie", "shallow", "mismatch"])
def test_compare_contact_rows(case):
    """Row matching between the fast (slot-major) and generic
    (group-major) layouts: equal rows match; a swap between two rows of
    equal depth is a tie; a row shallower than the tolerance may be
    missing; anything else is a mismatch."""
    p = [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]]
    generic = _rows(p, [0.02, 0.01, 0.03, 0.0])
    if case == "same":
        fast_rows = _rows(p, [0.02, 0.01, 0.03, 0.0])
    elif case == "tie":
        # group 0 keeps a different point of the same depth
        fast_rows = _rows([[0, 0, 0], [5, 0, 0], [2, 0, 0], [3, 0, 0]],
                          [0.02, 0.01, 0.03, 0.0])
    elif case == "shallow":
        fast_rows = _rows(p, [0.02, 0.01, 0.03, 0.0002])
    else:
        fast_rows = _rows([[0, 0, 0], [5, 0, 0], [2, 0, 0], [3, 0, 0]],
                          [0.02, 0.015, 0.03, 0.0])
    fast = _slot_major(fast_rows, 2, 2)
    out = chip_smoke.compare_contact_rows(fast, generic, groups=2, k=2)
    assert out["mismatched_groups"] == (1 if case == "mismatch" else 0)
    assert out["tie_groups"] == (1 if case == "tie" else 0)


def test_sharded_phase_tiny():
    """The four-card phase on four of the suite's virtual CPU devices:
    env-sharded and row-sharded steps against the single-device step."""
    assert len(jax.devices()) >= 4
    chip_smoke.phase_sharded(4, envs_per_device=4, pile_n=256)
