"""Mesh pipeline tests: primitives, hulls, inertia, OBJ round trip, hull sim."""

import pytest
import os

import numpy as np

from physics_tpu.io.meshes import (
    box_inertia,
    convex_hull,
    convex_hull_faces,
    mesh_inertia,
    sphere_inertia,
)
from physics_tpu.io.objloader import combined_positions, load_obj
from physics_tpu.io.primitives import (
    beveled_cube_mesh,
    box_mesh,
    save_obj,
    uv_sphere_mesh,
)


def test_box_mesh_inertia_matches_analytic():
    v, t = box_mesh((0.5, 0.3, 0.7))
    m, com, inertia = mesh_inertia(v, t)
    vol = 8 * 0.5 * 0.3 * 0.7
    np.testing.assert_allclose(m, vol, rtol=1e-5)
    np.testing.assert_allclose(com, 0.0, atol=1e-6)
    np.testing.assert_allclose(
        inertia, box_inertia((0.5, 0.3, 0.7), vol), rtol=1e-4, atol=1e-6
    )


def test_sphere_mesh_inertia_approaches_analytic():
    v, t = uv_sphere_mesh(1.0, 24, 32)
    m, _, inertia = mesh_inertia(v, t)
    vol = 4.0 / 3.0 * np.pi
    assert abs(m - vol) / vol < 0.02  # discretization error only
    expect = sphere_inertia(1.0, m)
    np.testing.assert_allclose(inertia, expect, rtol=0.03, atol=1e-4)


def test_beveled_cube_has_26_hull_planes():
    v, _ = beveled_cube_mesh(1.0, 0.1)
    assert v.shape == (24, 3)
    normals, offsets = convex_hull_faces(v)
    assert normals.shape[0] == 26  # 6 faces + 12 edge bevels + 8 corners
    # every vertex satisfies n·x ≤ off (+eps) for every plane
    sd = v @ normals.T - offsets[None, :]
    assert float(sd.max()) < 1e-4


def test_convex_hull_of_cube_with_interior_points():
    rng = np.random.default_rng(0)
    corners = box_mesh((1, 1, 1))[0]
    interior = rng.uniform(-0.9, 0.9, (50, 3)).astype(np.float32)
    pts = np.concatenate([corners, interior])
    used, faces = convex_hull(pts)
    assert set(used.tolist()) == set(range(8))  # only corners on the hull
    normals, offsets = convex_hull_faces(pts)
    assert normals.shape[0] == 6


def test_obj_round_trip(tmp_path):
    v, t = beveled_cube_mesh(1.0, 0.1)
    path = os.path.join(tmp_path, "bevel.obj")
    save_obj(path, v, t)
    model = load_obj(path)
    assert len(model.meshes) == 1
    mesh = model.meshes[0]
    # inertia computed from the reloaded mesh matches the original
    m0, _, i0 = mesh_inertia(v, t)
    m1, _, i1 = mesh_inertia(mesh.positions, mesh.triangles)
    np.testing.assert_allclose(m1, m0, rtol=1e-5)
    np.testing.assert_allclose(i1, i0, rtol=1e-4)
    np.testing.assert_allclose(
        np.sort(combined_positions(model), axis=0), np.sort(v, axis=0),
        atol=1e-5,
    )


def test_obj_parses_quads_and_materials(tmp_path):
    obj = tmp_path / "quad.obj"
    mtl = tmp_path / "quad.mtl"
    mtl.write_text(
        "newmtl mat1\nKd 0.5 0.25 0.125\nmap_Kd tex.jpg\nmap_Bump nrm.png\n"
    )
    obj.write_text(
        "mtllib quad.mtl\nusemtl mat1\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n"
    )
    model = load_obj(str(obj))
    mesh = model.meshes[0]
    assert mesh.triangles.shape == (2, 3)  # fan triangulation
    mat = model.materials[mesh.material]
    assert mat.diffuse_texture == "tex.jpg"
    assert mat.normal_texture == "nrm.png"
    np.testing.assert_allclose(mat.diffuse_color, (0.5, 0.25, 0.125))


@pytest.mark.slow
def test_hull_bodies_rest_on_ground():
    from physics_tpu import SceneBuilder, SimConfig
    from physics_tpu.engine import rollout

    v, t = beveled_cube_mesh(0.5, 0.08)
    m, _, inertia = mesh_inertia(v, t)
    b = SceneBuilder()
    h = b.add_hull(v)
    i = b.add_body(pos=(0, 2.0, 0), euler=(0.3, 0.5, 0.1),
                   mass=float(m), inertia=inertia)
    b.set_hull(i, h)
    cfg = SimConfig(compat=False, ground_plane=True, dt=1.0 / 120.0,
                    contact_iters=16)
    final, _ = rollout(b.build(), cfg, num_steps=600)
    y = float(final.pos[0, 1])
    # rests on a flat face: height = half extent 0.5 (minus slop/sag)
    assert 0.42 < y < 0.55, y
    assert float(np.max(np.abs(np.asarray(final.vel)))) < 0.05


@pytest.mark.slow
def test_mesh_rain_scene_builds_and_steps():
    from physics_tpu.scenes import mesh_rain, rain_config
    from physics_tpu.engine import step
    import jax

    state = mesh_rain(12, size=0.4)
    assert int(np.sum(np.asarray(state.shapes.stype) == 3)) == 12  # hulls
    cfg = rain_config(12).replace(contact_iters=8)
    from physics_tpu.engine import prepare_contacts

    state = prepare_contacts(state, cfg)  # warm-start buffers
    out = jax.jit(lambda s: step(s, cfg))(state)
    assert bool(np.all(np.isfinite(np.asarray(out.pos))))
