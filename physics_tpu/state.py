"""Simulation state: pytrees of SoA f32 arrays.

The reference keeps an array-of-structs `Vec<Entity>` with per-body nalgebra
vectors (reference: src/physics.rs:16-31, src/physics/rigid_body.rs:6-21).
Here the state is structure-of-arrays so every step phase is a batched
vector op over the body axis; the whole `SimState` is a pytree, so it can be
vmapped over an environment axis, donated, checkpointed (it is just arrays),
and sharded with `jax.sharding`.

Quaternions are (w, x, y, z); see physics_tpu.maths.quaternion.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def pytree_dataclass(cls):
    """Frozen dataclass registered as a JAX pytree (every field a leaf),
    with `.replace(**changes)` returning an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)

# ---------------------------------------------------------------------------
# Joint (equality constraint) type codes.
# The reference ships two concrete constraints (FixToPoint, FixedOrientation;
# reference: src/physics/constraints.rs:33-37); BALL and DISTANCE are new
# two-body joints built on the same row-generation architecture.
# ---------------------------------------------------------------------------
JOINT_NONE = 0
JOINT_FIX_POINT = 1        # C = x_a − target            (3 rows)
JOINT_FIX_ORIENTATION = 2  # C = euler(q_a) − target     (3 rows)
JOINT_BALL = 3             # C = p_a(anchor) − p_b(anchor) (3 rows)
JOINT_DISTANCE = 4         # C = ‖d‖ − L                 (1 row)

MAX_JOINT_ROWS = 3  # rows per joint slot (reference MAX_CONSTRAINT_COUNT,
                    # src/physics/constraints.rs:15)

# Shape type codes for the collision pipeline (new capability).
SHAPE_NONE = 0
SHAPE_SPHERE = 1   # params[0] = radius
SHAPE_BOX = 2      # params[0:3] = half extents
SHAPE_HULL = 3     # hull_index selects into HullSet


@pytree_dataclass
class Joints:
    """Fixed-capacity joint table. Slot j is live iff jtype[j] != JOINT_NONE.

    params layout by type:
      FIX_POINT:       params[0:3] = world target point
      FIX_ORIENTATION: params[0:3] = target euler angles (roll, pitch, yaw)
      BALL:            params[0:3] = anchor in body-a frame,
                       params[3:6] = anchor in body-b frame
      DISTANCE:        params[0:3], params[3:6] = local anchors,
                       params[6]   = rest length
    """

    jtype: Array    # [J] int32
    body_a: Array   # [J] int32
    body_b: Array   # [J] int32, -1 = world / unused
    params: Array   # [J, 8] float32
    ks: Array       # [J] float32  Baumgarte stiffness (reference KS=10)
    kd: Array       # [J] float32  Baumgarte damping   (reference KD=1)

    @property
    def capacity(self) -> int:
        return self.jtype.shape[-1]

    @classmethod
    def empty(cls, capacity: int) -> "Joints":
        return cls(
            jtype=jnp.zeros((capacity,), jnp.int32),
            body_a=jnp.zeros((capacity,), jnp.int32),
            body_b=jnp.full((capacity,), -1, jnp.int32),
            params=jnp.zeros((capacity, 8), jnp.float32),
            ks=jnp.zeros((capacity,), jnp.float32),
            kd=jnp.zeros((capacity,), jnp.float32),
        )


@pytree_dataclass
class Shapes:
    """Per-body collision geometry (fixed arrays; SHAPE_NONE = no collision)."""

    stype: Array       # [N] int32
    params: Array      # [N, 3] float32
    hull_index: Array  # [N] int32 (index into a HullSet; -1 = none)
    friction: Array    # [N] float32 per-body friction coefficient
    restitution: Array # [N] float32

    @classmethod
    def none(cls, n: int) -> "Shapes":
        return cls(
            stype=jnp.zeros((n,), jnp.int32),
            params=jnp.zeros((n, 3), jnp.float32),
            hull_index=jnp.full((n,), -1, jnp.int32),
            friction=jnp.full((n,), 0.5, jnp.float32),
            restitution=jnp.zeros((n,), jnp.float32),
        )


@pytree_dataclass
class HullSet:
    """A library of convex hulls, padded to fixed vertex/face capacity.

    verts:       [H, Vmax, 3] body-frame vertices (padding repeats vertex 0)
    vert_count:  [H] int32
    face_normals:[H, Fmax, 3] outward unit normals (padded with zeros)
    face_offsets:[H, Fmax]    plane offsets: n·x <= offset inside
    face_count:  [H] int32
    face_verts:  [H, Fmax, Emax] per-face polygon vertex indices, ordered
                 counter-clockwise seen from outside (padding repeats the
                 first vertex)
    face_vert_count: [H, Fmax] int32
    edge_dirs:   [H, Dmax, 3] unique (up to sign) unit edge directions —
                 the edge-edge separating-axis candidates (padded zeros)
    edge_dir_count: [H] int32
    edge_i0/i1:  [H, Emax] endpoint vertex indices of the unique
                 (undirected) hull edges — the support-edge candidates for
                 edge-edge contact generation (padding repeats edge 0)
    edge_count:  [H] int32
    """

    verts: Array
    vert_count: Array
    face_normals: Array
    face_offsets: Array
    face_count: Array
    face_verts: Array
    face_vert_count: Array
    edge_dirs: Array
    edge_dir_count: Array
    edge_i0: Array
    edge_i1: Array
    edge_count: Array

    @classmethod
    def empty(cls) -> "HullSet":
        return cls(
            verts=jnp.zeros((1, 1, 3), jnp.float32),
            vert_count=jnp.zeros((1,), jnp.int32),
            face_normals=jnp.zeros((1, 1, 3), jnp.float32),
            face_offsets=jnp.zeros((1, 1), jnp.float32),
            face_count=jnp.zeros((1,), jnp.int32),
            face_verts=jnp.zeros((1, 1, 1), jnp.int32),
            face_vert_count=jnp.zeros((1, 1), jnp.int32),
            edge_dirs=jnp.zeros((1, 1, 3), jnp.float32),
            edge_dir_count=jnp.zeros((1,), jnp.int32),
            edge_i0=jnp.zeros((1, 1), jnp.int32),
            edge_i1=jnp.zeros((1, 1), jnp.int32),
            edge_count=jnp.zeros((1,), jnp.int32),
        )


@pytree_dataclass
class SimState:
    """Complete simulation state — one pytree, one jitted step.

    Equivalent of the reference's PhysicsState + per-body RigidBody fields
    (reference: src/physics.rs:25-31, src/physics/rigid_body.rs:6-21) plus
    the CG warm start (`previous_solution`, src/physics.rs:29).
    """

    # body state [N, ...]
    pos: Array          # [N, 3]
    quat: Array         # [N, 4] (w, x, y, z)
    vel: Array          # [N, 3]
    omega: Array        # [N, 3]
    force: Array        # [N, 3] accumulated, cleared each step
    torque: Array       # [N, 3]
    mass: Array         # [N]
    inv_mass: Array     # [N]      0 = static body (non-compat path)
    inertia: Array      # [N, 3, 3] body-frame inertia tensor
    inv_inertia: Array  # [N, 3, 3] body-frame inverse inertia

    # constraints
    joints: Joints
    lam_joint: Array    # [J * MAX_JOINT_ROWS] CG warm start (Q7 semantics)

    # collision
    shapes: Shapes
    hulls: HullSet
    # contact warm start: per-slot feature keys and impulses (λn, λt1, λt2)
    # from the previous step; empty ([0]) disables warm starting — call
    # engine.prepare_contacts(state, cfg) to allocate the right capacity
    contact_key: Array  # [K] int32
    contact_lam: Array  # [3, K] (xyz-major, see ops.narrowphase.Contacts)

    # bookkeeping
    step_count: Array   # [] int32

    @property
    def num_bodies(self) -> int:
        return self.pos.shape[-2]

    def body_active(self) -> Array:
        """Dynamic-body mask ([N]): inv_mass > 0."""
        return self.inv_mass > 0.0


def make_state(
    pos,
    quat=None,
    vel=None,
    omega=None,
    mass=None,
    inertia=None,
    joints: Optional[Joints] = None,
    shapes: Optional[Shapes] = None,
    hulls: Optional[HullSet] = None,
    max_contacts: int = 0,
) -> SimState:
    """Assemble a SimState from plain arrays, filling reference defaults
    (mass=1, inertia=I₃, identity orientation; reference:
    src/physics/rigid_body.rs:64-76)."""
    # Assembled entirely in NumPy and shipped with ONE jax.device_put:
    # per-field jnp conversions would compile a tiny fill/convert program
    # each, which makes large scene builds slow.
    import numpy as np

    pos = np.asarray(pos, np.float32)
    n = pos.shape[0]
    if quat is None:
        quat = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    if vel is None:
        vel = np.zeros((n, 3), np.float32)
    if omega is None:
        omega = np.zeros((n, 3), np.float32)
    if mass is None:
        mass = np.ones((n,), np.float32)
    mass = np.asarray(mass, np.float32)
    if inertia is None:
        inertia = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    inertia = np.asarray(inertia, np.float32)
    if joints is None:
        joints = Joints.empty(0)
    if shapes is None:
        shapes = Shapes.none(n)
    if hulls is None:
        hulls = HullSet.empty()

    inv_mass = np.where(np.isinf(mass), 0.0, 1.0 / mass).astype(np.float32)
    # static bodies (inv_mass == 0) get zero inverse inertia; same adjugate
    # formula as maths.linalg.inv3x3 (np.linalg.inv matches to f32 precision)
    safe = inertia.copy()
    safe[inv_mass == 0] = np.eye(3, dtype=np.float32)
    inv_inertia = np.where(
        (inv_mass > 0)[:, None, None],
        np.linalg.inv(safe).astype(np.float32),
        np.zeros((n, 3, 3), np.float32),
    )

    state = SimState(
        pos=pos,
        quat=np.asarray(quat, np.float32),
        vel=np.asarray(vel, np.float32),
        omega=np.asarray(omega, np.float32),
        force=np.zeros((n, 3), np.float32),
        torque=np.zeros((n, 3), np.float32),
        mass=mass,
        inv_mass=inv_mass,
        inertia=inertia,
        inv_inertia=inv_inertia,
        joints=joints,
        lam_joint=np.zeros((joints.capacity * MAX_JOINT_ROWS,), np.float32),
        shapes=shapes,
        hulls=hulls,
        contact_key=np.zeros((max(max_contacts, 0),), np.int32),
        contact_lam=np.zeros((3, max(max_contacts, 0)), np.float32),
        step_count=np.zeros((), np.int32),
    )
    return jax.device_put(state)
