"""Prebuilt benchmark/test scenes and their solver configs."""

from __future__ import annotations

import numpy as np

from physics_tpu.config import SimConfig
from physics_tpu.io.meshes import box_inertia, sphere_inertia
from physics_tpu.scene import SceneBuilder
from physics_tpu.state import SimState


def box_stack(n_boxes: int = 10, half: float = 0.5) -> SimState:
    """Vertical box stack (resting-contact stability)."""
    b = SceneBuilder()
    for k in range(n_boxes):
        i = b.add_body(
            pos=(0.0, half + 2 * half * k + 0.001 * k, 0.0),
            inertia=box_inertia((half,) * 3, 1.0),
        )
        b.set_box(i, (half,) * 3, friction=0.6)
    return b.build()


def box_pile(
    n_bodies: int = 4096,
    half: float = 0.5,
    seed: int = 0,
    layers: int = 4,
    x_aspect: float = 16.0,
) -> SimState:
    """N-body box pile dropped above the ground plane.

    Laid out as a long trench (x-extent ≫ z-extent) so the sort-by-x sweep
    broad phase keeps a low per-window density; this is the scene-design
    analogue of choosing a good sharding layout.
    """
    rng = np.random.default_rng(seed)
    per_layer = n_bodies // layers
    nz = max(int(np.sqrt(per_layer / x_aspect)), 1)
    nx = per_layer // nz
    spacing = 2.6 * half

    b = SceneBuilder()
    count = 0
    layer = 0
    while count < n_bodies:
        k = count - layer * nx * nz
        if k >= nx * nz:
            layer += 1
            k = 0
        ix, iz = k % nx, k // nx
        jitter = rng.uniform(-0.3 * half, 0.3 * half, 3)
        pos = (
            ix * spacing + jitter[0],
            half + layer * 2.2 * half + 0.01 * layer + abs(jitter[1]),
            iz * spacing + jitter[2],
        )
        i = b.add_body(
            pos=pos,
            euler=rng.uniform(-0.2, 0.2, 3),
            inertia=box_inertia((half,) * 3, 1.0),
        )
        b.set_box(i, (half,) * 3, friction=0.5)
        count += 1
    return b.build()


def pile_config(n_bodies: int, dt: float = 1.0 / 60.0) -> SimConfig:
    """Solver/broad-phase capacities for the box-pile scenes: the sorted
    sweep with per-rank-block candidate compaction, the boxes-only
    narrow phase, and a depth-compacted contact buffer of 6 contacts per
    body for the warm-started Jacobi solve."""
    return SimConfig(
        compat=False,
        ground_plane=True,
        pair_collisions=True,
        boxes_only=True,
        broadphase="sweep",
        # the trench layout (box_pile) keeps the pile's sorted x-slices
        # sparse enough that 48 neighbors cover nearly every overlap
        # (misses are counted in pair_overflow)
        sweep_window=48,
        max_pair_candidates=8 * n_bodies,
        pair_buckets=True,
        bucket_block=128,
        max_contacts_per_pair=4,
        max_contacts=6 * n_bodies,
        contact_iters=16,
        dt=dt,
    )


def cube_drop(height: float = 2.0, size: float = 0.5,
              real_assets: bool | None = None) -> SimState:
    """A single cube.obj hull dropped onto the ground
    plane under gravity (distinct from the reference's swinging-cube demo
    scene, which is jointed and has no ground — reference src/lib.rs:20-42
    has no collision at all; this is the new-capability drop config).

    The hull and inertia come from the real reference res/cube.obj when
    the asset directory resolves (io/assets.py), mirroring how the
    reference derives its render mesh from that file
    (src/resources.rs:32-120); otherwise the procedural bevel-cube stands
    in. `size` scales the file's ±1 extent."""
    from physics_tpu.io.primitives import beveled_cube_mesh

    asset = None
    if real_assets is not False:
        try:
            from physics_tpu.io.assets import load_cube_asset

            asset = load_cube_asset()
        except FileNotFoundError:
            if real_assets:
                raise
    if asset is not None:
        verts = asset.collision_verts * size
        inertia = asset.inertia * size**2
    else:
        verts, _ = beveled_cube_mesh(size=size, bevel=0.1 * size / 0.5)
        inertia = box_inertia((size,) * 3, 1.0)
    b = SceneBuilder()
    hull = b.add_hull(verts)
    i = b.add_body(pos=(0.0, height, 0.0), euler=(0.4, 0.2, 0.1),
                   inertia=inertia)
    b.set_hull(i, hull, friction=0.5, restitution=0.05)
    return b.build()


def drop_config(dt: float = 1.0 / 120.0) -> SimConfig:
    """Solver config for the single-hull drop (`cube_drop`)."""
    return SimConfig(
        compat=False, ground_plane=True, pair_collisions=True,
        contact_iters=16, dt=dt,
    )


def sphere_rain(n_bodies: int = 256, seed: int = 0) -> SimState:
    """Mixed-size spheres raining onto the ground."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for k in range(n_bodies):
        r = float(rng.uniform(0.2, 0.5))
        i = b.add_body(
            pos=(rng.uniform(-10, 10), 2 + 0.1 * k, rng.uniform(-10, 10)),
            inertia=sphere_inertia(r, 1.0),
        )
        b.set_sphere(i, r, friction=0.4, restitution=0.2)
    return b.build()


def random_env(seed: int, n_bodies: int = 8) -> SimState:
    """One randomized small scene (the unit of the packed-env scenes)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(n_bodies):
        i = b.add_body(
            pos=rng.uniform([-3, 1, -3], [3, 6, 3]),
            euler=rng.uniform(-1, 1, 3),
            inertia=box_inertia((0.4,) * 3, 1.0),
        )
        b.set_box(i, (0.4,) * 3, friction=0.5)
    return b.build()


def mesh_rain(n_bodies: int = 128, seed: int = 0, size: float = 0.5,
              bevel: float = 0.1, real_assets: bool | None = None
              ) -> SimState:
    """Convex-hull meshes raining onto the ground (the mesh-rain config,
    SURVEY.md §7 M2): every body is the reference demo's bevel-edged cube
    as a convex hull, randomly oriented, falling from a column.

    real_assets: derive the hull + inertia from the actual reference
    res/cube.obj (reference src/resources.rs:32-120) scaled to `size`,
    instead of the procedural bevel approximation. None = auto (use the
    real files when the asset directory resolves, else procedural).
    """
    from physics_tpu.io.primitives import beveled_cube_mesh

    asset = None
    if real_assets is not False:
        try:
            from physics_tpu.io.assets import load_cube_asset

            asset = load_cube_asset()
        except FileNotFoundError:
            if real_assets:
                raise

    rng = np.random.default_rng(seed)
    if asset is not None:
        verts = asset.collision_verts * size          # file cube spans ±1
        inertia = asset.inertia * size**2             # I ∝ m·L² at fixed m
    else:
        verts, _ = beveled_cube_mesh(size=size, bevel=bevel)
        inertia = box_inertia((size,) * 3, 1.0)
    b = SceneBuilder()
    hull = b.add_hull(verts)
    side = max(1, int(np.ceil(np.sqrt(n_bodies / 4))))
    count = 0
    for layer in range(10**9):
        if count >= n_bodies:
            break
        for gx in range(side):
            for gz in range(side):
                if count >= n_bodies:
                    break
                jitter = rng.uniform(-0.2, 0.2, 3)
                i = b.add_body(
                    pos=(
                        (gx - side / 2) * 2.5 * size + jitter[0],
                        1.5 * size + layer * 3.0 * size + jitter[1],
                        (gz - side / 2) * 2.5 * size + jitter[2],
                    ),
                    euler=rng.uniform(-1.5, 1.5, 3),
                    inertia=inertia,
                )
                b.set_hull(i, hull, friction=0.4, restitution=0.05)
                count += 1
    return b.build()


def mesh_rain_mixed(n_bodies: int = 128, seed: int = 0, size: float = 0.5,
                    real_assets: bool | None = None,
                    n_types: int = 2) -> SimState:
    """Multi-hull-type rain: bodies cycle through `n_types` distinct hull
    shapes (bevel cube, octahedron, and at n_types=3 a wedge prism)
    falling onto the ground — the multi-hull-type fast-path
    benchmark/test scene (type-pair-segmented candidates through the
    linear-SAT coefficient matmuls, ops/narrowphase.hull_obb_prefilter)."""
    from physics_tpu.io.primitives import beveled_cube_mesh

    asset = None
    if real_assets is not False:
        try:
            from physics_tpu.io.assets import load_cube_asset

            asset = load_cube_asset()
        except FileNotFoundError:
            if real_assets:
                raise

    rng = np.random.default_rng(seed)
    if asset is not None:
        cube_verts = asset.collision_verts * size
        cube_inertia = asset.inertia * size**2
    else:
        cube_verts, _ = beveled_cube_mesh(size=size, bevel=0.1 * size / 0.5)
        cube_inertia = box_inertia((size,) * 3, 1.0)
    s = 1.3 * size
    octa_verts = np.array(
        [[s, 0, 0], [-s, 0, 0], [0, s, 0], [0, -s, 0],
         [0, 0, s], [0, 0, -s]], np.float32)
    octa_inertia = sphere_inertia(0.7 * s, 1.0)
    # third type (n_types=3): a wedge prism — 6 verts, 5 faces, a face
    # structure distinct from both the cube (quads + bevels) and the
    # octahedron (triangles only)
    wedge_verts = np.array(
        [[s, -0.5 * s, 0.8 * s], [s, -0.5 * s, -0.8 * s],
         [-s, -0.5 * s, 0.8 * s], [-s, -0.5 * s, -0.8 * s],
         [s, 0.7 * s, 0.0], [-s, 0.7 * s, 0.0]], np.float32)
    wedge_inertia = box_inertia((s, 0.6 * s, 0.8 * s), 1.0)
    if not 2 <= n_types <= 3:
        raise ValueError(f"mesh_rain_mixed supports 2-3 types, got {n_types}")

    b = SceneBuilder()
    cube = b.add_hull(cube_verts)
    octa = b.add_hull(octa_verts)
    hull_ids = [cube, octa]
    inertias = [cube_inertia, octa_inertia]
    if n_types >= 3:
        hull_ids.append(b.add_hull(wedge_verts))
        inertias.append(wedge_inertia)
    side = max(1, int(np.ceil(np.sqrt(n_bodies / 4))))
    count = 0
    for layer in range(10**9):
        if count >= n_bodies:
            break
        for gx in range(side):
            for gz in range(side):
                if count >= n_bodies:
                    break
                jitter = rng.uniform(-0.2, 0.2, 3)
                t = count % n_types
                i = b.add_body(
                    pos=(
                        (gx - side / 2) * 2.5 * size + jitter[0],
                        1.5 * size + layer * 3.0 * size + jitter[1],
                        (gz - side / 2) * 2.5 * size + jitter[2],
                    ),
                    euler=rng.uniform(-1.5, 1.5, 3),
                    inertia=inertias[t],
                )
                b.set_hull(i, hull_ids[t],
                           friction=0.4, restitution=0.05)
                count += 1
    return b.build()


def rain_config(n_bodies: int, dt: float = 1.0 / 60.0) -> SimConfig:
    """Solver/broad-phase settings for the mesh-rain hull scenes.

    hulls_only skips the box-SAT/sphere/vertex-face candidate generation;
    single- and few-type hull libraries take the shared-hull fast path
    (ops/hullhull_batched.py) behind the OBB prefilter."""
    return SimConfig(
        compat=False,
        ground_plane=True,
        pair_collisions=True,
        hulls_only=True,
        broadphase="sweep",
        # the square rain column is denser per x-slice than the trench
        # pile: the window misses some settled AABB overlaps, counted in
        # pair_overflow (never silent)
        sweep_window=32,
        max_pair_candidates=12 * n_bodies,
        # two-phase narrow phase: OBB face-SAT prefilter compacts the
        # AABB candidates to the ~true-overlap set (≈3/body settled)
        # before the full hull-SAT support matmuls; overflow-counted
        # (metrics prefilter_overflow)
        hull_prefilter_cap=4 * n_bodies,
        # 4 manifold points per pair (same as the box pile): the standard
        # stable-stacking budget
        max_contacts_per_pair=4,
        max_contacts=16 * n_bodies,
        contact_iters=8,
        dt=dt,
    )


def packed_config(env_size: int, n_envs: int,
                  dt: float = 1.0 / 60.0) -> SimConfig:
    """Settings for `n_envs` box envs of `env_size` bodies packed into one
    block-diagonal scene (envs.pack_envs): the static per-env pair
    triangle as the broad phase, the boxes-only narrow phase, and 48
    contact slots per env."""
    return SimConfig(
        compat=False,
        ground_plane=True,
        pair_collisions=True,
        boxes_only=True,
        broadphase="env_blocks",
        env_block_size=env_size,
        max_contacts=48 * n_envs,
        contact_iters=8,
        dt=dt,
    )
