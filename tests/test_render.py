"""Native rasterizer + camera tests (viewer path, host-only)."""

import numpy as np
import pytest

from physics_tpu.io.primitives import beveled_cube_mesh, box_mesh
from physics_tpu.render.camera import (
    Camera,
    Projection,
    default_view_proj,
    look_at_rh,
    perspective_gl,
)


def test_look_at_places_eye_at_origin():
    m = look_at_rh((0, 0, 20), (0, 0, 0))
    eye_view = m @ np.array([0, 0, 20, 1], np.float32)
    np.testing.assert_allclose(eye_view[:3], 0.0, atol=1e-5)
    # looking down -z: the origin should be 20 in front (negative z in view)
    origin_view = m @ np.array([0, 0, 0, 1], np.float32)
    np.testing.assert_allclose(origin_view[:3], [0, 0, -20], atol=1e-5)


def test_projection_depth_remap_wgpu():
    """OPENGL_TO_WGPU maps NDC z from [-1,1] to [0,1] (camera.rs:7-13)."""
    p = Projection(800, 600, np.pi / 8, 0.1, 100.0).matrix()
    near = p @ np.array([0, 0, -0.1, 1], np.float32)
    far = p @ np.array([0, 0, -100.0, 1], np.float32)
    np.testing.assert_allclose(near[2] / near[3], 0.0, atol=1e-5)
    np.testing.assert_allclose(far[2] / far[3], 1.0, atol=1e-5)


def test_default_camera_sees_origin():
    vp = default_view_proj(800, 600)
    clip = vp @ np.array([0, 0, 0, 1], np.float32)
    ndc = clip[:3] / clip[3]
    assert -1 < ndc[0] < 1 and -1 < ndc[1] < 1 and 0 < ndc[2] < 1


@pytest.fixture(scope="module")
def raster():
    from physics_tpu.render import rasterizer

    try:
        rasterizer.ensure_built()
    except Exception as e:  # g++ unavailable → skip, not fail
        pytest.skip(f"native build unavailable: {e}")
    return rasterizer


def test_rasterizer_draws_cube(raster):
    v, t = beveled_cube_mesh(1.0, 0.1)
    mats = np.eye(4, dtype=np.float32)[None]
    img = raster.rasterize(v, t, mats, default_view_proj(160, 120), 160, 120)
    assert img.shape == (120, 160, 3)
    lit = int(np.sum(img.sum(axis=2) > 0))
    assert lit > 50  # the cube is visible
    assert lit < 160 * 120 / 2  # and doesn't fill the frame


def test_rasterizer_depth_ordering(raster):
    """A nearer box must occlude a farther one."""
    v, t = box_mesh((1, 1, 1))
    mats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mats[0, :3, 3] = [0, 0, 0]    # far box at origin
    mats[1, :3, 3] = [0, 0, 10]   # near box (camera at z=20)
    colors = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    img = raster.rasterize(
        v, t, mats, default_view_proj(160, 120), 160, 120, colors=colors
    )
    reds = int(np.sum((img[..., 0] > 100) & (img[..., 1] < 60)))
    greens = int(np.sum((img[..., 1] > 100) & (img[..., 0] < 60)))
    assert greens > 0          # near green box visible
    assert reds < greens / 4   # far red box mostly occluded


def test_render_state_helper(raster, tmp_path):
    from physics_tpu.render.rasterizer import render_state, save_ppm
    from physics_tpu.scene import demo_scene

    v, t = beveled_cube_mesh(1.0, 0.1)
    img = render_state(demo_scene(), v, t, width=160, height=120)
    assert img.shape == (120, 160, 3)
    out = tmp_path / "frame.ppm"
    save_ppm(str(out), img)
    data = out.read_bytes()
    assert data.startswith(b"P6\n160 120\n255\n")
    assert len(data) == len(b"P6\n160 120\n255\n") + 160 * 120 * 3


def test_textured_rasterize_checkerboard():
    """Textured path: a checkerboard cube must show BOTH tile colors, and
    the untextured call must still work (legacy ABI)."""
    from physics_tpu.io.primitives import box_mesh_uv
    from physics_tpu.render.rasterizer import rasterize
    from physics_tpu.render.texture import checkerboard

    verts, uvs, tris = box_mesh_uv((1.0, 1.0, 1.0))
    model = np.eye(4, dtype=np.float32).reshape(1, 16)
    vp = default_view_proj(160, 120)
    tex = checkerboard(64, tiles=4, color_a=(255, 0, 0), color_b=(0, 0, 255))

    img = rasterize(verts, tris, model, vp, width=160, height=120,
                    uvs=uvs, texture=tex, light_strength=0.0)
    # unlit: every non-background pixel is exactly one of the two colors
    nonbg = img[np.any(img != 0, axis=-1)]
    assert len(nonbg) > 100
    reds = np.sum((nonbg[:, 0] > 200) & (nonbg[:, 2] < 50))
    blues = np.sum((nonbg[:, 2] > 200) & (nonbg[:, 0] < 50))
    assert reds > 10 and blues > 10, (reds, blues)

    flat = rasterize(verts, tris, model, vp, width=160, height=120)
    assert np.any(flat != 0)


def test_texture_loaders():
    from physics_tpu.render.texture import checkerboard, load_texture, solid, uv_grid

    for tex in (checkerboard(32), uv_grid(32), solid()):
        assert tex.dtype == np.uint8 and tex.shape[-1] == 4

    # PIL round-trip
    import tempfile, os
    from PIL import Image

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.png")
        Image.fromarray(checkerboard(16)).save(p)
        back = load_texture(p)
        np.testing.assert_array_equal(back, checkerboard(16))


def test_camera_controller_reference_semantics():
    """Controller math mirrors the reference (camera.rs:152-182): forward
    follows yaw, scroll follows pitch ('scrollward'), pitch clamps at
    ±(π/2 − 1e-4), per-frame rotation deltas reset."""
    from physics_tpu.render.camera import Camera, CameraController

    cam = Camera(position=(0.0, 0.0, 0.0), yaw=0.0, pitch=0.0)
    ctl = CameraController(speed=4.0, sensitivity=0.4)

    assert ctl.process_keyboard("W", True)
    assert not ctl.process_keyboard("q", True)
    ctl.update_camera(cam, 0.5)
    # yaw 0 → forward = (cos 0, 0, sin 0) = +x; 4.0 · 0.5 = 2
    np.testing.assert_allclose(cam.position, [2.0, 0.0, 0.0], atol=1e-6)
    ctl.process_keyboard("w", False)

    # vertical axis
    ctl.process_keyboard("space", True)
    ctl.update_camera(cam, 0.25)
    np.testing.assert_allclose(cam.position[1], 1.0, atol=1e-6)
    ctl.process_keyboard("space", False)

    # mouse look: dy raises pitch by dy·sens·dt, then resets
    ctl.process_mouse(1.0, 2.0)
    ctl.update_camera(cam, 0.5)
    np.testing.assert_allclose(cam.yaw, 0.2, atol=1e-6)
    np.testing.assert_allclose(cam.pitch, 0.4, atol=1e-6)
    ctl.update_camera(cam, 0.5)  # deltas consumed
    np.testing.assert_allclose(cam.pitch, 0.4, atol=1e-6)

    # scroll moves along the pitched view direction (line delta ×100)
    p0 = np.asarray(cam.position).copy()
    ctl.process_scroll(lines=1.0)
    ctl.update_camera(cam, 0.1)
    d = np.asarray(cam.position) - p0
    expect_dir = np.array([np.cos(0.4) * np.cos(0.2), np.sin(0.4),
                           np.cos(0.4) * np.sin(0.2)])
    d_norm = d / np.linalg.norm(d)
    np.testing.assert_allclose(d_norm, -expect_dir, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(d), 100 * 4.0 * 0.4 * 0.1,
                               rtol=1e-5)

    # pitch clamp
    ctl.process_mouse(0.0, 1e6)
    ctl.update_camera(cam, 1.0)
    assert abs(cam.pitch - (np.pi / 2 - 0.0001)) < 1e-6


def test_live_viewer_headless_loop():
    """--live (render/live.py): the input→camera→present loop runs
    headlessly (non-tty stdin disables input, frames still render), the
    ANSI presenter emits valid half-block rows, and the sim advances —
    the reference's winit live loop (src/lib.rs:44-106) equivalent."""
    import io

    import jax

    from physics_tpu.config import compat_config
    from physics_tpu.engine import step
    from physics_tpu.io.primitives import beveled_cube_mesh
    from physics_tpu.render.live import ansi_frame, run_live
    from physics_tpu.render.rasterizer import render_state
    from physics_tpu.scene import demo_scene

    img = np.zeros((24, 32, 3), np.uint8)
    img[:12] = (255, 0, 0)
    s = ansi_frame(img, cols=16, rows=6)
    assert s.count("▀") == 16 * 6
    assert "38;2;255;0;0m" in s and "48;2;0;0;0m" in s

    cfg = compat_config(dt=1.0 / 60.0)
    state = demo_scene()
    step_fn = jax.jit(step, static_argnums=1)
    v, t = beveled_cube_mesh(1.0, 0.1)

    def render_frame(st, view_proj):
        return render_state(st, v, t, view_proj=view_proj,
                            width=64, height=48)

    out = io.StringIO()
    p0 = np.asarray(state.pos[0]).copy()
    final = run_live(state, lambda st: step_fn(st, cfg), render_frame,
                     steps=3, cols=16, rows=6, target_fps=1000.0, out=out)
    text = out.getvalue()
    assert "steps/s" in text and text.count("▀") >= 3 * 16 * 6
    assert not np.allclose(np.asarray(final.pos[0]), p0)


def test_live_viewer_wall_clock_pacing():
    """wall_clock=True (Q8, reference src/lib.rs:56-58): sim time tracks
    wall time via fixed-dt substeps — the substep counter must consume
    exactly `steps` substeps, stay bounded per frame, and advance the
    sim identically to the fixed-dt loop (same step_fn, same dt)."""
    import io

    import jax

    from physics_tpu.config import compat_config
    from physics_tpu.engine import step
    from physics_tpu.io.primitives import beveled_cube_mesh
    from physics_tpu.render.live import run_live
    from physics_tpu.render.rasterizer import render_state
    from physics_tpu.scene import demo_scene

    cfg = compat_config(dt=1.0 / 60.0)
    state = demo_scene()
    step_fn = jax.jit(step, static_argnums=1)
    v, t = beveled_cube_mesh(1.0, 0.1)

    def render_frame(st, view_proj):
        return render_state(st, v, t, view_proj=view_proj,
                            width=32, height=24)

    out = io.StringIO()
    final = run_live(state, lambda st: step_fn(st, cfg), render_frame,
                     steps=6, cols=8, rows=4, target_fps=1000.0,
                     wall_clock=True, sim_dt=cfg.dt, out=out)
    # exactly 6 substeps consumed -> bit-identical to 6 fixed-dt steps
    ref = state
    for _ in range(6):
        ref = step_fn(ref, cfg)
    np.testing.assert_array_equal(np.asarray(final.pos),
                                  np.asarray(ref.pos))
    assert "steps/s" in out.getvalue()


def test_live_viewer_zoom_keys(monkeypatch):
    """+/- are the scroll-wheel analogue (reference camera.rs:146-150):
    a '+' tap must move the camera forward along its look direction via
    CameraController.process_scroll (mouse-look/scroll zoom in the live
    viewer)."""
    import io

    import jax

    from physics_tpu.config import compat_config
    from physics_tpu.engine import step
    from physics_tpu.io.primitives import beveled_cube_mesh
    from physics_tpu.render import live
    from physics_tpu.render.rasterizer import render_state
    from physics_tpu.scene import demo_scene

    taps = iter([["+"], [], []])

    class FakeInput:
        enabled = False

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def poll(self):
            return next(taps, [])

    monkeypatch.setattr(live, "_RawInput", FakeInput)
    cfg = compat_config(dt=1.0 / 60.0)
    state = demo_scene()
    step_fn = jax.jit(step, static_argnums=1)
    v, t = beveled_cube_mesh(1.0, 0.1)

    def render_frame(st, view_proj):
        return render_state(st, v, t, view_proj=view_proj,
                            width=32, height=24)

    cam_z = []
    orig = live.ansi_frame

    def spy_frame(img, cols, rows):
        return orig(img, cols, rows)

    out = io.StringIO()
    # capture the camera by wrapping render_frame's view_proj is
    # indirect; instead assert through the controller: scroll moves the
    # camera toward the scene (z decreases from the spawn at z=8)
    from physics_tpu.render.camera import Camera

    moved = {}
    orig_vm = Camera.view_matrix

    def spy_vm(self):
        moved["z1"] = float(self.position[2])
        return orig_vm(self)

    monkeypatch.setattr(Camera, "view_matrix", spy_vm)
    live.run_live(state, lambda st: step_fn(st, cfg), render_frame,
                  steps=3, cols=8, rows=4, target_fps=1000.0, out=out)
    # camera spawns at z=8 looking toward -z; a '+' tap zooms in
    assert moved["z1"] < 8.0, moved
