"""Host-side scene construction.

The reference hard-codes its scene inside `run()` (reference: src/lib.rs:20-42:
one cube at (1,0,0) with euler(1,0,0), a FixToPointConstraint to the origin
and a FixedOrientationConstraint to euler (0,0,0)). SceneBuilder replaces
that with a small imperative API that assembles padded, fixed-capacity device
arrays — the host-side equivalent of PhysicsState construction.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from physics_tpu.state import (
    JOINT_BALL,
    JOINT_DISTANCE,
    JOINT_FIX_ORIENTATION,
    JOINT_FIX_POINT,
    SHAPE_BOX,
    SHAPE_HULL,
    SHAPE_NONE,
    SHAPE_SPHERE,
    HullSet,
    Joints,
    Shapes,
    SimState,
    make_state,
)

import jax.numpy as jnp


def _from_euler_np(roll, pitch, yaw) -> np.ndarray:
    """NumPy mirror of maths.quaternion.from_euler (nalgebra
    UnitQuaternion::from_euler_angles, R = Rz·Ry·Rx), (w, x, y, z)."""
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    sr, cr = np.sin(hr), np.cos(hr)
    sp, cp = np.sin(hp), np.cos(hp)
    sy, cy = np.sin(hy), np.cos(hy)
    return np.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        np.float32,
    )


class SceneBuilder:
    """Accumulates bodies/joints/shapes on host, then `build()`s a SimState."""

    def __init__(self):
        self._pos = []
        self._quat = []
        self._vel = []
        self._omega = []
        self._mass = []
        self._inertia = []
        self._stype = []
        self._sparams = []
        self._hull_index = []
        self._friction = []
        self._restitution = []
        self._joints = []  # (type, a, b, params[8], ks, kd)
        self._hulls: list = []  # list of (verts [V,3], normals [F,3], offsets [F])

    # ------------------------------------------------------------------ bodies
    def add_body(
        self,
        pos=(0.0, 0.0, 0.0),
        quat=None,
        euler=None,
        vel=(0.0, 0.0, 0.0),
        omega=(0.0, 0.0, 0.0),
        mass: float = 1.0,
        inertia=None,
        static: bool = False,
    ) -> int:
        """Add a rigid body; returns its index.

        Defaults mirror RigidBody::new (reference: src/physics/rigid_body.rs:64-76):
        mass 1, identity inertia, identity orientation.
        """
        if quat is not None and euler is not None:
            raise ValueError("give either quat or euler, not both")
        if euler is not None:
            # host-side numpy (same formula as maths.quaternion.from_euler)
            # — a per-body device dispatch here makes large scene builds
            # slow
            q = _from_euler_np(*np.asarray(euler, np.float32))
        elif quat is not None:
            q = np.asarray(quat, np.float32)
        else:
            q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)

        if static:
            mass = np.inf
            inertia = np.full((3, 3), np.inf, np.float32)
        if inertia is None:
            inertia = np.eye(3, dtype=np.float32)

        self._pos.append(np.asarray(pos, np.float32))
        self._quat.append(q)
        self._vel.append(np.asarray(vel, np.float32))
        self._omega.append(np.asarray(omega, np.float32))
        self._mass.append(np.float32(mass))
        self._inertia.append(np.asarray(inertia, np.float32))
        self._stype.append(SHAPE_NONE)
        self._sparams.append(np.zeros(3, np.float32))
        self._hull_index.append(-1)
        self._friction.append(0.5)
        self._restitution.append(0.0)
        return len(self._pos) - 1

    # ------------------------------------------------------------------ shapes
    def set_sphere(self, body: int, radius: float, friction=0.5, restitution=0.0):
        self._stype[body] = SHAPE_SPHERE
        self._sparams[body] = np.array([radius, 0, 0], np.float32)
        self._friction[body] = friction
        self._restitution[body] = restitution

    def set_box(self, body: int, half_extents, friction=0.5, restitution=0.0):
        self._stype[body] = SHAPE_BOX
        self._sparams[body] = np.asarray(half_extents, np.float32)
        self._friction[body] = friction
        self._restitution[body] = restitution

    def add_hull(self, verts) -> int:
        """Register a convex hull (body-frame vertices); returns hull id."""
        from physics_tpu.io.meshes import convex_hull_face_polygons

        verts = np.asarray(verts, np.float32)
        normals, offsets, polys = convex_hull_face_polygons(verts)
        self._hulls.append((verts, normals, offsets, polys))
        return len(self._hulls) - 1

    def set_hull(self, body: int, hull_id: int, friction=0.5, restitution=0.0):
        verts = self._hulls[hull_id][0]
        # bounding radius stored for the broad phase
        r = float(np.max(np.linalg.norm(verts, axis=1)))
        self._stype[body] = SHAPE_HULL
        self._sparams[body] = np.array([r, 0, 0], np.float32)
        self._hull_index[body] = hull_id
        self._friction[body] = friction
        self._restitution[body] = restitution

    # ------------------------------------------------------------------ joints
    def fix_to_point(self, body: int, target, ks=10.0, kd=1.0):
        """FixToPointConstraint (reference: fixed_position_constraint.rs)."""
        p = np.zeros(8, np.float32)
        p[0:3] = target
        self._joints.append((JOINT_FIX_POINT, body, -1, p, ks, kd))

    def fix_orientation(self, body: int, euler_target, ks=10.0, kd=1.0):
        """FixedOrientationConstraint (reference: fixed_orientation_constraint.rs)."""
        p = np.zeros(8, np.float32)
        p[0:3] = euler_target
        self._joints.append((JOINT_FIX_ORIENTATION, body, -1, p, ks, kd))

    def ball_joint(self, body_a: int, body_b: int, anchor_a, anchor_b, ks=10.0, kd=1.0):
        p = np.zeros(8, np.float32)
        p[0:3] = anchor_a
        p[3:6] = anchor_b
        self._joints.append((JOINT_BALL, body_a, body_b, p, ks, kd))

    def distance_joint(
        self, body_a: int, body_b: int, anchor_a, anchor_b, length: float,
        ks=10.0, kd=1.0,
    ):
        p = np.zeros(8, np.float32)
        p[0:3] = anchor_a
        p[3:6] = anchor_b
        p[6] = length
        self._joints.append((JOINT_DISTANCE, body_a, body_b, p, ks, kd))

    # ------------------------------------------------------------------ build
    def build(self, joint_capacity: Optional[int] = None,
              mixed_as_hulls: bool = True) -> SimState:
        """Build the immutable SimState.

        mixed_as_hulls (default True): when the scene registers BOTH box
        and hull colliders, every box is converted to an equivalent
        8-vertex convex hull (same half extents, friction, restitution,
        inertia) so box↔hull pairs ride the complete hull-hull SAT
        manifold (face axes + edge-edge, ops/hullhull.py) instead of the
        vertex-face-only generic path, which misses edge-edge contacts
        between deeply crossed shapes. Pure-box and pure-hull scenes are
        unaffected (their dedicated fast paths stay engaged). Pass False
        to keep raw boxes in a mixed scene (the generic path then applies
        and is approximate for crossed pairs)."""
        n = len(self._pos)
        if n == 0:
            raise ValueError("scene has no bodies")

        stypes = np.asarray(self._stype, np.int32)
        if (mixed_as_hulls and self._hulls
                and np.any(stypes == SHAPE_BOX)):
            import logging

            logging.getLogger(__name__).info(
                "mixed box+hull scene: converting %d boxes to 8-vertex "
                "hulls for a uniform convex narrow phase "
                "(build(mixed_as_hulls=False) keeps raw boxes)",
                int(np.sum(stypes == SHAPE_BOX)),
            )
            box_hull_ids = {}
            for body in range(n):
                if self._stype[body] != SHAPE_BOX:
                    continue
                he = tuple(float(x) for x in self._sparams[body])
                if he not in box_hull_ids:
                    hx, hy, hz = he
                    corners = np.array(
                        [(sx * hx, sy * hy, sz * hz)
                         for sx in (-1, 1) for sy in (-1, 1)
                         for sz in (-1, 1)], np.float32)
                    box_hull_ids[he] = self.add_hull(corners)
                self.set_hull(body, box_hull_ids[he],
                              friction=float(self._friction[body]),
                              restitution=float(self._restitution[body]))

        jn = len(self._joints)
        cap = joint_capacity if joint_capacity is not None else jn
        if cap < jn:
            raise ValueError(f"joint_capacity {cap} < {jn} joints")

        joints = Joints.empty(cap)
        if jn:
            jt = np.zeros(cap, np.int32)
            ja = np.zeros(cap, np.int32)
            jb = np.full(cap, -1, np.int32)
            jp = np.zeros((cap, 8), np.float32)
            jks = np.zeros(cap, np.float32)
            jkd = np.zeros(cap, np.float32)
            for i, (t, a, b, p, ks, kd) in enumerate(self._joints):
                jt[i], ja[i], jb[i] = t, a, b
                jp[i] = p
                jks[i], jkd[i] = ks, kd
            joints = Joints(
                jtype=jt, body_a=ja, body_b=jb, params=jp, ks=jks, kd=jkd,
            )

        # plain numpy: make_state ships the whole state in one device_put
        shapes = Shapes(
            stype=np.asarray(self._stype, np.int32),
            params=np.stack(self._sparams),
            hull_index=np.asarray(self._hull_index, np.int32),
            friction=np.asarray(self._friction, np.float32),
            restitution=np.asarray(self._restitution, np.float32),
        )

        hulls = _pack_hulls(self._hulls) if self._hulls else HullSet.empty()

        return make_state(
            pos=np.stack(self._pos),
            quat=np.stack(self._quat),
            vel=np.stack(self._vel),
            omega=np.stack(self._omega),
            mass=np.asarray(self._mass),
            inertia=np.stack(self._inertia),
            joints=joints,
            shapes=shapes,
            hulls=hulls,
        )


def _pack_hulls(hulls: Sequence) -> HullSet:
    vmax = max(h[0].shape[0] for h in hulls)
    fmax = max(h[1].shape[0] for h in hulls)
    emax = max(
        (len(p) for h in hulls for p in h[3]), default=1
    )
    hcount = len(hulls)
    verts = np.zeros((hcount, vmax, 3), np.float32)
    vcount = np.zeros(hcount, np.int32)
    normals = np.zeros((hcount, fmax, 3), np.float32)
    offsets = np.zeros((hcount, fmax), np.float32)
    fcount = np.zeros(hcount, np.int32)
    fverts = np.zeros((hcount, fmax, emax), np.int32)
    fvcount = np.zeros((hcount, fmax), np.int32)
    for i, (v, fn, fo, polys) in enumerate(hulls):
        verts[i, : v.shape[0]] = v
        # pad with vertex 0 so padded support-point lookups stay in-hull
        verts[i, v.shape[0]:] = v[0]
        vcount[i] = v.shape[0]
        normals[i, : fn.shape[0]] = fn
        offsets[i, : fo.shape[0]] = fo
        # pad faces with far-away planes so padded faces never bind
        offsets[i, fo.shape[0]:] = 1e30
        fcount[i] = fn.shape[0]
        for f, poly in enumerate(polys):
            fverts[i, f, : len(poly)] = poly
            fverts[i, f, len(poly):] = poly[0]  # pad by repeating
            fvcount[i, f] = len(poly)

    # unique (up to sign) unit edge directions per hull — the edge-edge
    # separating-axis candidates for the hull-hull SAT (ops/hullhull.py) —
    # and the unique undirected edge list (endpoint index pairs), the
    # support-edge candidates for edge-edge contact generation (replaces
    # the old per-pair face-polygon edge derivation, which one-hot
    # gathered [F, E, V] tensors at runtime)
    dir_lists = []
    edge_lists = []
    for v, fn, fo, polys in hulls:
        dirs: list = []
        edges: set = set()
        for poly in polys:
            for a, b in zip(poly, list(poly[1:]) + [poly[0]]):
                d = v[b] - v[a]
                nrm = np.linalg.norm(d)
                if nrm < 1e-9:
                    continue
                edges.add((a, b) if a < b else (b, a))
                d = d / nrm
                if not any(abs(float(d @ e)) > 1.0 - 1e-5 for e in dirs):
                    dirs.append(d)
        dir_lists.append(np.asarray(dirs, np.float32).reshape(-1, 3))
        edge_lists.append(sorted(edges))
    dmax = max((d.shape[0] for d in dir_lists), default=1) or 1
    edirs = np.zeros((hcount, dmax, 3), np.float32)
    edcount = np.zeros(hcount, np.int32)
    for i, d in enumerate(dir_lists):
        edirs[i, : d.shape[0]] = d
        edcount[i] = d.shape[0]
    gmax = max((len(e) for e in edge_lists), default=1) or 1
    ei0 = np.zeros((hcount, gmax), np.int32)
    ei1 = np.zeros((hcount, gmax), np.int32)
    ecount = np.zeros(hcount, np.int32)
    for i, es in enumerate(edge_lists):
        for k, (a, b) in enumerate(es):
            ei0[i, k] = a
            ei1[i, k] = b
        if es:
            ei0[i, len(es):] = es[0][0]
            ei1[i, len(es):] = es[0][1]
        ecount[i] = len(es)

    return HullSet(
        verts=verts, vert_count=vcount, face_normals=normals,
        face_offsets=offsets, face_count=fcount, face_verts=fverts,
        face_vert_count=fvcount, edge_dirs=edirs, edge_dir_count=edcount,
        edge_i0=ei0, edge_i1=ei1, edge_count=ecount,
    )


def demo_scene() -> SimState:
    """The reference's built-in demo scene (reference: src/lib.rs:20-42):
    one cube at (1,0,0), orientation euler(1,0,0), FixToPoint(origin) +
    FixedOrientation(0,0,0), Baumgarte ks=10 kd=1."""
    b = SceneBuilder()
    i = b.add_body(pos=(1.0, 0.0, 0.0), euler=(1.0, 0.0, 0.0))
    b.fix_to_point(i, (0.0, 0.0, 0.0))
    b.fix_orientation(i, (0.0, 0.0, 0.0))
    return b.build()
