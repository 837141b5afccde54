#!/usr/bin/env python
"""Smoke run of the contact pipeline on a GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # four cards: the sharded paths only

With one card the phases run in this order, and the run stops at the first
that fails:

  gpu-tests  `pytest -m gpu tests/` in a child process, before this process
             imports JAX, so that one process holds the card at a time
  pile       box_pile(4096) with pile_config(4096)
  rain       mesh_rain(1024) with rain_config(1024)
  packed     4096 envs of 8 boxes packed into one scene (packed_config)
  check      (a) the compat demo against the NumPy oracle for 300 steps,
             (b) one 1,024-body pile step on the GPU against the same step
             on the CPU, (c) the boxes fast path's contacts against the
             generic convex path's on the settled 4k pile

Each workload phase goes through the user's entry points (prepare_contacts,
step_with_metrics): it compiles a 480-step lax.scan of step_with_metrics,
runs one chunk (the drop), times two more ended by block_until_ready, and
checks that every body is finite and above the ground and that no contact
or prefilter survivor was dropped in any step.

`--devices 4` runs only the env-sharded and the row-sharded step over four
cards, each against the single-device step.

The last line printed is {"ok": true, "device": {...}}. Any failure exits
non-zero without printing it; so does a run without a GPU.
"""

from __future__ import annotations

import argparse
import importlib.metadata
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHUNK = 480            # steps per timed rollout chunk
TIMED_CHUNKS = 2
OVERFLOW_KEYS = ("pair_overflow", "contact_overflow", "prefilter_overflow")


class SmokeFailure(Exception):
    """A phase found something wrong."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def report(phase: str, **fields) -> None:
    print(f"phase {phase}: " + json.dumps(fields), flush=True)


def gpu_allowed_by_env() -> bool:
    """False when JAX_PLATFORMS is set and names no GPU platform."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if not plats:
        return True
    return bool({"cuda", "gpu", "rocm"} & {p.strip() for p in plats.split(",")})


def card_description() -> str:
    """`name, power.limit` of every card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def package_versions() -> dict:
    found = {}
    for name in ("jax", "jaxlib", "jax-cuda12-plugin", "jax-cuda12-pjrt",
                 "jax-cuda13-plugin", "jax-cuda13-pjrt"):
        try:
            found[name] = importlib.metadata.version(name)
        except importlib.metadata.PackageNotFoundError:
            pass
    return found


def phase_gpu_tests() -> None:
    """The repo's `gpu`-marked tests, in a child that exits before this
    process touches the card."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env=env)
    report("gpu-tests", rc=out.returncode,
           seconds=round(time.perf_counter() - t0, 1))
    require(out.returncode == 0, f"pytest -m gpu exited {out.returncode}")


# --------------------------------------------------------------- workloads
def run_workload(name: str, state, cfg, chunk: int = CHUNK,
                 timed_chunks: int = TIMED_CHUNKS):
    """Drive one scene through prepare_contacts and chunks of
    step_with_metrics under lax.scan: one untimed chunk (the drop), then
    `timed_chunks` chunks ended by block_until_ready. Prints what it
    measured and returns (final_state, fields)."""
    import jax
    import numpy as np

    from physics_tpu.engine import prepare_contacts, step_with_metrics

    n = state.num_bodies
    state = prepare_contacts(state, cfg)

    def chunk_fn(s):
        return jax.lax.scan(lambda c, _: step_with_metrics(c, cfg), s, None,
                            length=chunk)

    t0 = time.perf_counter()
    run = jax.jit(chunk_fn, donate_argnums=0).lower(state).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, m0 = run(state)                 # untimed chunk: the drop
    jax.block_until_ready(state.pos)
    first_chunk_s = time.perf_counter() - t0
    sc0 = int(state.step_count)
    ms = []
    t0 = time.perf_counter()
    for _ in range(timed_chunks):
        state, m = run(state)
        ms.append(m)
    jax.block_until_ready(state.pos)
    wall = time.perf_counter() - t0
    steps = timed_chunks * chunk
    require(int(state.step_count) - sc0 == steps,
            f"{name}: the timed window did not advance step_count")

    ms = jax.device_get([m0] + ms)
    pos = np.asarray(state.pos)
    finite = bool(np.all(np.isfinite(pos))
                  and np.all(np.isfinite(np.asarray(state.vel)))
                  and np.all(np.isfinite(np.asarray(state.quat))))
    stats = jax.devices()[0].memory_stats() or {}
    fields = dict(
        bodies=n,
        compile_s=round(compile_s, 2),
        first_chunk_s=round(first_chunk_s, 2),
        ms_per_step=1e3 * wall / steps,
        body_steps_per_s=n * steps / wall,
        peak_bytes_in_use=stats.get("peak_bytes_in_use"),
        contact_count=int(ms[-1]["contact_count"][-1]),
        max_penetration=float(ms[-1]["max_penetration"][-1]),
        finite=finite,
        min_y=float(pos[:, 1].min()) if finite else None,
        max_y=float(pos[:, 1].max()) if finite else None,
        **{f"max_{k}": int(max(np.max(m[k]) for m in ms))
           for k in OVERFLOW_KEYS if k in ms[0]},
    )
    report(name, **fields)
    require(finite, f"{name}: non-finite state")
    require(fields["min_y"] > cfg.ground_height,
            f"{name}: a body fell through the ground "
            f"(min y {fields['min_y']})")
    # the first H100 runs dropped no contact and no prefilter survivor in
    # any workload; pair_overflow (sweep-window misses) is only reported
    for k in ("contact_overflow", "prefilter_overflow"):
        require(fields.get(f"max_{k}", 0) == 0,
                f"{name}: {k} {fields.get(f'max_{k}')}")
    return state, fields


def phase_pile(n: int = 4096, **kw):
    from physics_tpu.scenes import box_pile, pile_config

    return run_workload("pile", box_pile(n, x_aspect=16), pile_config(n),
                        **kw)


def phase_rain(n: int = 1024, **kw):
    from physics_tpu.scenes import mesh_rain, rain_config

    return run_workload("rain", mesh_rain(n), rain_config(n), **kw)


def packed_scene(n_envs: int, env_size: int):
    """`n_envs` copies of one random box env, each shifted by a random
    offset, stacked [E, K, ...] (the unit of the packed and env-sharded
    scenes)."""
    import jax
    import numpy as np

    from physics_tpu.scenes import random_env

    base = random_env(0, env_size)
    rng = np.random.default_rng(1)
    offsets = rng.uniform(-1, 1, (n_envs, 1, 3)).astype(np.float32)
    return jax.vmap(lambda o: base.replace(pos=base.pos + o))(offsets)


def phase_packed(n_envs: int = 4096, env_size: int = 8, **kw):
    from physics_tpu.envs import pack_envs
    from physics_tpu.scenes import packed_config

    return run_workload("packed", pack_envs(packed_scene(n_envs, env_size)),
                        packed_config(env_size, n_envs), **kw)


# ------------------------------------------------------------------ checks
def check_compat_demo(steps: int = 300) -> dict:
    """(a) The reference demo (swinging cube, compat semantics) against
    the NumPy oracle, step by step. Tolerances are those of
    tests/test_demo_parity.py: f32 operation-order drift over 300 steps."""
    import jax
    import numpy as np

    from physics_tpu import scene
    from physics_tpu.config import compat_config
    from physics_tpu.engine import step
    from physics_tpu.oracle import reference as oracle

    dt = 1.0 / 60.0
    cfg = compat_config(dt=dt)
    state = scene.demo_scene()
    ora = oracle.demo_scene()
    step_fn = jax.jit(step, static_argnums=1)
    pos_err = 0.0
    for _ in range(steps):
        state = step_fn(state, cfg)
        ora.update(dt)
        pos_err = max(pos_err, float(np.max(np.abs(
            np.asarray(state.pos[0]) - ora.bodies[0].position))))
    quat_err = float(np.max(np.abs(
        np.asarray(state.quat[0]) - ora.bodies[0].rotation)))
    out = dict(max_pos_err=pos_err, quat_err=quat_err)
    require(pos_err < 1e-3, f"compat demo position error {pos_err}")
    require(quat_err < 1e-2, f"compat demo quaternion error {quat_err}")
    return out


def check_cpu_parity(n: int = 1024) -> dict:
    """(b) One production pile step on the default device against the
    same jitted step on the CPU, from the same prepared state, both at
    float32 matmul precision. One step, because the trajectory is chaotic.

    The CPU traces the generic convex narrow phase (the boxes fast path is
    off there, narrowphase.boxes_fast_path); check (c) compares the two
    paths directly. Tolerances: 1e-4 m / 1e-4 on positions and
    quaternions, 1e-3 m/s and rad/s on velocities — f32 rounding (the
    scatter-adds' summation order, transcendental ulps, two narrow-phase
    implementations agreeing to ~1e-6 relative) carried through 16
    Jacobi sweeps; 1e-3 m/s is under 1% of one step of gravity."""
    import jax
    import numpy as np

    from physics_tpu.engine import prepare_contacts, step
    from physics_tpu.scenes import box_pile, pile_config

    cfg = pile_config(n)
    state = prepare_contacts(box_pile(n), cfg)
    cpu = jax.devices("cpu")[0]
    step_fn = jax.jit(step, static_argnums=1)
    with jax.default_matmul_precision("highest"):
        dev_out = jax.device_get(step_fn(state, cfg))
        with jax.default_device(cpu):
            cpu_out = jax.device_get(
                step_fn(jax.device_put(state, cpu), cfg))
    err = {f: float(np.max(np.abs(np.asarray(getattr(dev_out, f))
                                  - np.asarray(getattr(cpu_out, f)))))
           for f in ("pos", "quat", "vel", "omega")}
    tol = dict(pos=1e-4, quat=1e-4, vel=1e-3, omega=1e-3)
    for f, e in err.items():
        require(e <= tol[f], f"cpu parity: max |d{f}| {e} > {tol[f]}")
    return {f"max_d{f}": e for f, e in err.items()}


def _unmatched_rows(pt_a, d_a, n_a, act_a, pt_b, d_b, n_b, act_b,
                    tol_pt, tol_d, tol_n):
    """Rows of set A ([G, K] per group) with no row of B in the same group
    at the same point (inf-norm ≤ tol_pt), depth and normal."""
    import numpy as np

    dp = np.max(np.abs(pt_a[:, :, None, :] - pt_b[:, None, :, :]), -1)
    dd = np.abs(d_a[:, :, None] - d_b[:, None, :])
    dn = np.max(np.abs(n_a[:, :, None, :] - n_b[:, None, :, :]), -1)
    ok = ((dp <= tol_pt) & (dd <= tol_d) & (dn <= tol_n)
          & act_b[:, None, :])
    return act_a & ~np.any(ok, axis=2)


def compare_contact_rows(fast, generic, groups: int, k: int,
                         tol_pt: float = 1e-3, tol_d: float = 1e-3,
                         tol_n: float = 1e-3) -> dict:
    """Match the active rows of a fast-path contact buffer (slot-major,
    row s·G + g) against a generic one (group-major, row g·k + s) group by
    group (a group is one body for ground contacts, one candidate pair for
    pair contacts).

    Two row differences are decided within rounding and are not errors:
    a row shallower than tol_d may be missing on either side (activity at
    depth ≈ 0), and when the k deepest of a group's candidates include
    two of equal depth (within tol_d) at the cut, the paths may keep
    either — a group whose unmatched rows pair up by depth within tol_d
    counts as such a tie. Every other unmatched row is a mismatch."""
    import numpy as np

    def arrange(c, slot_major):
        def rows(x):
            x = np.asarray(x)
            return x.reshape(k, groups).T if slot_major else \
                x.reshape(groups, k)

        def vec(x):
            x = np.asarray(x)
            return (x.reshape(3, k, groups).transpose(2, 1, 0) if slot_major
                    else x.reshape(3, groups, k).transpose(1, 2, 0))

        return (vec(c.point), rows(c.depth), vec(c.normal),
                rows(c.active).astype(bool))

    pf, df, nf, af = arrange(fast, True)
    pg, dg, ng, ag = arrange(generic, False)
    miss_f = _unmatched_rows(pf, df, nf, af, pg, dg, ng, ag,
                             tol_pt, tol_d, tol_n) & (df >= tol_d)
    miss_g = _unmatched_rows(pg, dg, ng, ag, pf, df, nf, af,
                             tol_pt, tol_d, tol_n) & (dg >= tol_d)
    ties = mismatched = 0
    for g in np.nonzero(miss_f.any(1) | miss_g.any(1))[0]:
        uf = np.sort(df[g][miss_f[g]])
        ug = np.sort(dg[g][miss_g[g]])
        if uf.shape == ug.shape and np.all(np.abs(uf - ug) <= tol_d):
            ties += 1
        else:
            mismatched += 1
    return dict(
        rows_fast=int(af.sum()), rows_generic=int(ag.sum()),
        unmatched_rows=int(miss_f.sum() + miss_g.sum()),
        tie_groups=ties, mismatched_groups=mismatched,
    )


def check_fast_vs_generic(state, cfg) -> dict:
    """(c) On a settled pile: the active contact rows of the boxes fast
    path (_ground_contacts_boxes, _pair_contacts_boxes) against those of
    the generic convex path, as tests/test_boxes_only_path.py compares
    them (compare_contact_rows). Tolerance 1e-3 (m, and unit normal
    components): two f32 implementations of one SAT + clip at coordinates
    up to ~170 m, where f32 spacing is 1.5e-5; 1e-3 m is a fifth of the
    penetration slop."""
    import jax

    from physics_tpu.ops.broadphase import pair_candidates
    from physics_tpu.ops.narrowphase import (
        _ground_contacts_boxes,
        _pair_contacts_boxes,
        convex_data,
        ground_contacts,
        pair_contacts,
    )

    k = cfg.max_contacts_per_pair
    gen_cfg = cfg.replace(boxes_only=False)

    def both(s):
        cand = pair_candidates(s, cfg)
        cvx = convex_data(s)
        return (_ground_contacts_boxes(s, cfg),
                ground_contacts(s, cvx, gen_cfg),
                _pair_contacts_boxes(s, cand, cfg),
                pair_contacts(s, cvx, cand, gen_cfg))

    with jax.default_matmul_precision("highest"):
        gf, gg, pf, pg = jax.device_get(jax.jit(both)(state))
    ground = compare_contact_rows(gf, gg, state.num_bodies, k)
    pairs = compare_contact_rows(pf, pg, pf.depth.shape[0] // k, k)
    out = {f"ground_{a}": b for a, b in ground.items()}
    out.update({f"pair_{a}": b for a, b in pairs.items()})
    require(ground["rows_fast"] > 0 and pairs["rows_fast"] > 0,
            "fast vs generic: the settled pile has no contacts to compare")
    require(ground["mismatched_groups"] == 0
            and pairs["mismatched_groups"] == 0,
            f"fast vs generic: mismatched groups: ground "
            f"{ground['mismatched_groups']}, pairs "
            f"{pairs['mismatched_groups']}")
    return out


def phase_check(pile_state, pile_cfg, parity_n: int = 1024,
                demo_steps: int = 300) -> None:
    t0 = time.perf_counter()
    a = check_compat_demo(demo_steps)
    report("check-a-compat-demo", **a)
    b = check_cpu_parity(parity_n)
    report("check-b-cpu-parity", bodies=parity_n, **b)
    c = check_fast_vs_generic(pile_state, pile_cfg)
    report("check-c-fast-vs-generic", bodies=pile_state.num_bodies, **c)
    report("check", seconds=round(time.perf_counter() - t0, 1))


# ------------------------------------------------------------ four cards
def phase_sharded(n_devices: int, envs_per_device: int = 4096,
                  env_size: int = 8, pile_n: int = 4096) -> None:
    """The env-sharded step (envs_per_device envs of env_size boxes on
    each device) against the single-device vmapped step on shard 0, and
    the row-sharded step on a pile against the single-device step."""
    import jax
    import numpy as np

    from physics_tpu.engine import step
    from physics_tpu.parallel.sharding import (
        env_sharded_step,
        make_mesh,
        row_sharded_step,
        shard_envs,
    )
    from physics_tpu.scenes import box_pile, packed_config, pile_config

    devices = jax.devices()[:n_devices]
    require(len(devices) == n_devices,
            f"need {n_devices} devices, have {len(jax.devices())}")

    # env-sharded: independent envs, no collectives — each shard must
    # step exactly as the same envs do on one device (tolerance as
    # tests/test_sharding.py::test_env_shards_independent)
    cfg = packed_config(env_size, 1)
    batched = packed_scene(n_devices * envs_per_device, env_size)
    shard0 = jax.tree_util.tree_map(lambda x: x[:envs_per_device], batched)
    single = jax.jit(jax.vmap(lambda s: step(s, cfg)))
    ref = jax.device_get(single(jax.device_put(shard0, devices[0])))
    mesh = make_mesh([n_devices], ["env"], devices=devices)
    t0 = time.perf_counter()
    out = env_sharded_step(cfg, mesh)(shard_envs(batched, mesh))
    jax.block_until_ready(out.pos)
    env_s = time.perf_counter() - t0
    pos = np.asarray(out.pos)
    env_err = float(np.max(np.abs(pos[:envs_per_device]
                                  - np.asarray(ref.pos))))
    report("sharded-env", devices=n_devices,
           envs=n_devices * envs_per_device, env_size=env_size,
           compile_and_step_s=round(env_s, 2), max_dpos_shard0=env_err,
           finite=bool(np.all(np.isfinite(pos))))
    require(bool(np.all(np.isfinite(pos))), "env-sharded: non-finite state")
    require(np.allclose(pos[:envs_per_device], np.asarray(ref.pos),
                        rtol=1e-5, atol=1e-5),
            f"env-sharded: shard 0 differs from one device by {env_err}")

    # row-sharded: bodies replicated, candidates and contacts split over
    # the devices, impulse deltas psum'd every sweep. The psum changes the
    # summation order, so positions agree within 1e-3 over 3 steps
    # (tests/test_sharding.py). Both sides start unprepared (cold solve):
    # the sharded step does not warm start.
    cfg = pile_config(pile_n)
    state = box_pile(pile_n)
    for what, count in (("ground contacts", pile_n * cfg.max_contacts_per_pair),
                        ("pair candidates", cfg.max_pair_candidates),
                        ("max_contacts", cfg.max_contacts)):
        require(count % n_devices == 0,
                f"row-sharded: {what} ({count}) not divisible by "
                f"{n_devices}")
    rmesh = make_mesh([n_devices], ["row"], devices=devices)
    rstep = row_sharded_step(cfg, rmesh, "row")
    sstep = jax.jit(step, static_argnums=1)
    s_ref = jax.device_put(state, devices[0])
    s_sh = state
    t0 = time.perf_counter()
    for _ in range(3):
        s_ref = sstep(s_ref, cfg)
        s_sh = rstep(s_sh)
    jax.block_until_ready((s_ref.pos, s_sh.pos))
    row_s = time.perf_counter() - t0
    err_p = float(np.max(np.abs(np.asarray(s_ref.pos)
                                - np.asarray(s_sh.pos))))
    err_v = float(np.max(np.abs(np.asarray(s_ref.vel)
                                - np.asarray(s_sh.vel))))
    finite = bool(np.all(np.isfinite(np.asarray(s_sh.pos))))
    report("sharded-row", devices=n_devices, bodies=pile_n, steps=3,
           compile_and_steps_s=round(row_s, 2), max_dpos=err_p,
           max_dvel=err_v, finite=finite)
    require(finite, "row-sharded: non-finite state")
    require(err_p < 1e-3, f"row-sharded: max |dpos| {err_p} >= 1e-3")


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="4: run only the sharded paths over 4 cards")
    args = parser.parse_args(argv)

    try:
        require(gpu_allowed_by_env(),
                f"no GPU: JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS')}")
        print(card_description(), flush=True)
        print("versions: " + json.dumps(package_versions()), flush=True)
        print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}", flush=True)
        if args.devices == 1:
            phase_gpu_tests()

        import jax

        from physics_tpu.utils.compile_cache import enable_compile_cache

        print(f"compile cache: {enable_compile_cache()}", flush=True)
        dev = jax.devices()[0]
        require(dev.platform == "gpu",
                f"no GPU: JAX's first device is {dev.platform}")
        require(len(jax.devices()) >= args.devices,
                f"--devices {args.devices} but JAX sees "
                f"{len(jax.devices())}")
        if args.devices == 1:
            from physics_tpu.scenes import pile_config

            pile_state, _ = phase_pile()
            phase_rain()
            phase_packed()
            phase_check(pile_state, pile_config(pile_state.num_bodies))
        else:
            phase_sharded(args.devices)
    except (SmokeFailure, OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
