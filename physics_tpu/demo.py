"""The built-in demo app — headless equivalent of the reference's `run()`.

Reference behavior (src/lib.rs:17-108): build the single-cube scene (cube
at (1,0,0), euler(1,0,0), FixToPoint(origin) + FixedOrientation(0,0,0)),
then a winit frame loop stepping physics at wall-clock dt and rendering with
an imgui FPS overlay.

Here: fixed-dt device-side rollout (SURVEY.md Q8 — the rebuild uses fixed
dt), a steps/sec readout replacing the FPS overlay (rendering.rs:463), and
optional offline-rasterized frames via the native renderer replacing the
wgpu pass.

Run:  python -m physics_tpu.demo [--steps N] [--render-every K]
                                 [--out DIR] [--dt DT] [--correct]
                                 [--live]

`--live` is the live-viewer equivalent of the reference's winit loop
(src/lib.rs:44-106): the sim steps while each frame is rasterized by the
native renderer and drawn to the terminal (ANSI half-block cells), with
WASD/space/shift camera motion and arrow-key look routed to the same
CameraController math as the reference (src/rendering/camera.rs:73-183),
plus the steps/s readout standing in for the imgui FPS window. On a
non-tty stdin the loop still runs (no input) so the mode is testable
headlessly.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--dt", type=float, default=1.0 / 60.0)
    parser.add_argument("--render-every", type=int, default=0,
                        help="rasterize a frame every K steps (0 = off)")
    parser.add_argument("--out", default="demo_frames")
    parser.add_argument("--width", type=int, default=800)
    parser.add_argument("--height", type=int, default=600)
    parser.add_argument("--textured", action="store_true",
                        help="render the unlit textured look of the "
                             "reference viewer (procedural checkerboard "
                             "diffuse; shader.wgsl samples a texture)")
    parser.add_argument("--correct", action="store_true",
                        help="use the corrected physics instead of "
                             "reference-compat semantics")
    parser.add_argument("--live", action="store_true",
                        help="live terminal viewer: step + rasterize + "
                             "present each frame with WASD/arrow camera "
                             "input (the reference's winit loop, "
                             "src/lib.rs:44-106)")
    parser.add_argument("--fps", type=float, default=30.0,
                        help="target present rate for --live")
    parser.add_argument("--wall-dt", action="store_true",
                        help="pace --live by wall-clock time (Q8, "
                             "reference src/lib.rs:56-58): each frame "
                             "consumes the elapsed wall time in fixed-dt "
                             "substeps (a traced per-frame dt would "
                             "recompile the jitted step)")
    args = parser.parse_args(argv)

    import jax

    from physics_tpu.config import SimConfig, compat_config
    from physics_tpu.engine import step
    from physics_tpu.scene import demo_scene
    from physics_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.correct:
        cfg = SimConfig(
            compat=False, gravity_offset=(0.0, 0.0, 1.5),
            gravity_scale_by_mass=False, dt=args.dt,
        )
    else:
        cfg = compat_config(dt=args.dt)

    state = demo_scene()
    step_fn = jax.jit(step, static_argnums=1)

    if args.live:
        from physics_tpu.io.primitives import beveled_cube_mesh
        from physics_tpu.render.live import run_live
        from physics_tpu.render.rasterizer import render_state

        v, t = beveled_cube_mesh(1.0, 0.1)
        state = step_fn(state, cfg)  # compile before the frame loop

        def render_frame(s, view_proj):
            return render_state(s, v, t, view_proj=view_proj,
                                width=320, height=240)

        final = run_live(state, lambda s: step_fn(s, cfg), render_frame,
                         steps=args.steps, target_fps=args.fps,
                         wall_clock=args.wall_dt, sim_dt=cfg.dt)
        pos = np.asarray(final.pos[0])
        print(f"cube position: ({pos[0]:+.4f}, {pos[1]:+.4f}, "
              f"{pos[2]:+.4f})")
        return

    mesh = None
    if args.render_every > 0:
        from physics_tpu.io.primitives import beveled_cube_mesh, box_mesh_uv
        from physics_tpu.render.rasterizer import render_state, save_png
        from physics_tpu.render.texture import checkerboard

        if args.textured:
            # prefer the REAL reference assets (res/cube.obj +
            # cube-diffuse.jpg, reference src/lib.rs:39 + resources.rs:58);
            # procedural equivalents keep the demo standalone without them
            mesh = None
            try:
                from physics_tpu.io.assets import load_cube_asset
                from physics_tpu.render.texture import load_texture

                asset = load_cube_asset()
                m0 = asset.model.meshes[0]
                tex = (load_texture(asset.diffuse_texture)
                       if asset.diffuse_texture else checkerboard(128))
                mesh = (m0.positions, m0.triangles, m0.tex_coords, tex)
                print(f"textured demo: real assets "
                      f"({m0.positions.shape[0]} verts)")
            except Exception as e:  # missing res/ or PIL
                print(f"real assets unavailable ({e}); procedural fallback")
            if mesh is None:
                verts, uvs, tris = box_mesh_uv((1.0, 1.0, 1.0))
                mesh = (verts, tris, uvs, checkerboard(128))
        else:
            v, t = beveled_cube_mesh(1.0, 0.1)
            mesh = (v, t, None, None)
        os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    state = step_fn(state, cfg)  # compile
    jax.block_until_ready(state.pos)
    print(f"compiled in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    for k in range(1, args.steps):
        state = step_fn(state, cfg)
        if args.render_every and k % args.render_every == 0:
            img = render_state(state, mesh[0], mesh[1],
                               width=args.width, height=args.height,
                               uvs=mesh[2], texture=mesh[3],
                               light_strength=0.0 if args.textured else 1.0)
            save_png(os.path.join(args.out, f"frame_{k:05d}.png"), img)
    jax.block_until_ready(state.pos)
    wall = time.perf_counter() - t0

    pos = np.asarray(state.pos[0])
    # steps/sec readout — the imgui FPS window analogue (rendering.rs:463)
    print(f"{args.steps} steps in {wall:.2f}s -> {args.steps / wall:.1f} steps/s")
    print(f"cube position: ({pos[0]:+.4f}, {pos[1]:+.4f}, {pos[2]:+.4f})")
    if args.render_every:
        print(f"frames written to {args.out}/")


if __name__ == "__main__":
    main()
