"""Simulation configuration.

The reference hard-codes all tuning as compile-time constants (SURVEY.md §5:
MAX_CONSTRAINT_* in src/physics/constraints.rs:14-15, CG iteration/tolerance
constants in src/physics/sle_solver.rs:5-7, per-constraint Baumgarte gains in
src/physics/constraints/fixed_position_constraint.rs:5-6) and uses raw
wall-clock dt (src/lib.rs:56-58). Here everything is an explicit, hashable
frozen dataclass passed as a *static* argument to `jax.jit` — changing a
config value recompiles the step, exactly like the reference's compile-time
constants, but user-controllable.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters (hashable; safe as a jit static arg).

    compat=True reproduces the reference's exact numerical semantics,
    including its quirks Q1–Q10 (SURVEY.md §2b). compat=False is the
    physically-correct mode (world-frame inertia, per-body constraint force
    scatter, mass-scaled gravity, renormalized quaternions).
    """

    # --- time stepping ---
    dt: float = 1.0 / 60.0

    # --- gravity (reference: src/physics.rs:87-94 applies force
    #     (0,-9.81,0) at body-local offset (0,0,1.5) each update; the force
    #     is NOT scaled by mass — quirk Q5) ---
    gravity: tuple = (0.0, -9.81, 0.0)
    gravity_offset: tuple = (0.0, 0.0, 0.0)
    gravity_scale_by_mass: bool = True

    # --- behavior flags ---
    compat: bool = False

    # --- equality-constraint (joint) solver: matrix-free CG
    #     (reference: src/physics/sle_solver.rs:5-7) ---
    cg_max_iters: int = 1000
    cg_rel_tol: float = 1e-2   # MAX_ERROR
    cg_abs_tol: float = 1e-3   # MIN_ERROR

    # --- contact pipeline (new capability; reference has none,
    #     SURVEY.md §0) ---
    ground_plane: bool = False          # y = ground_height, normal +y
    ground_height: float = 0.0
    pair_collisions: bool = False       # body-body contacts via broad phase
    contact_iters: int = 24             # projected-Jacobi velocity sweeps
    position_iters: int = 8             # split-impulse position sweeps
    contact_relaxation: float = 1.0     # SOR factor (auto-scaled by degree)
    baumgarte: float = 0.2              # penetration fraction corrected by
                                        # the position pass per step
    penetration_slop: float = 0.005
    restitution: float = 0.0
    friction: float = 0.5
    max_contacts_per_pair: int = 8      # corner contacts for box-box
    max_contacts: int = 0               # compact to this many deepest
                                        # contacts before solving (0 = off)
    # narrow phase: skip the generic convex vertex-face + sphere paths when
    # the scene is known to contain only boxes (pile/stack workloads) —
    # the SAT manifold covers everything
    boxes_only: bool = False
    # narrow phase: skip box-SAT + sphere + vertex-face candidate
    # generation when the scene's colliders are all convex hulls (the
    # mesh-rain workload) — the hull-hull clipped manifold + ground
    # contacts cover everything
    hulls_only: bool = False
    # single-hull-type fast path (ops/hullhull_batched.py): all pairwise
    # SAT supports via static [rows, 9] × [9, P] matmuls against the
    # relative rotation — only taken when the scene registers exactly one
    # hull shape; ignored otherwise
    hull_fast: bool = True
    # two-phase hull narrow phase (hulls_only shared-hull scenes): an OBB
    # face-axis SAT prefilter (the shared hull's local AABB, ~60 flops
    # per pair, no vertex factor) drops candidates whose bounding boxes
    # are separated, and the survivors compact to this many lanes before
    # the full hull SAT — whose support matmuls ([D²·V, 9] × [9, P])
    # scale with candidate lanes.
    # Conservative: hull ⊆ OBB, so an OBB separation is a hull
    # separation. Survivors beyond the cap are dropped lowest-pair-first
    # and counted (metrics prefilter_overflow). 0 = off.
    hull_prefilter_cap: int = 0
    # broad phase: 'allpairs' for small N, 'sweep' (sorted x-axis window),
    # 'env_blocks' (batched envs packed into one block-diagonal scene —
    # static per-env upper-triangular pairs, see envs.pack_envs)
    broadphase: str = "allpairs"
    sweep_window: int = 32              # neighbor window for 'sweep'
    max_pair_candidates: int = 0        # 0 → derived from N
    env_block_size: int = 0             # bodies per env for 'env_blocks'
    # rank-block bucketed candidate compaction (sweep only): candidates are
    # compacted per block of `bucket_block` consecutive body ranks (capacity
    # per bucket derives from max_pair_candidates, or bucket_cap pins it,
    # rounded to a multiple of 128) by one segmented sort, in place of the
    # full-list compact_pairs sort + gather. See ops/broadphase.py.
    pair_buckets: bool = False
    bucket_block: int = 64              # body ranks per bucket
    bucket_cap: int = 0                 # candidates kept per bucket (0=auto)

    # --- integrator extras (non-compat mode) ---
    renormalize_quat: bool = True
    gyroscopic: bool = False            # add -ω×(Iω) term (explicit)
    max_velocity: float = 0.0           # 0 → no clamp

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def compat_config(**overrides) -> SimConfig:
    """Config reproducing the reference demo semantics exactly.

    Gravity as unscaled force at offset (0,0,1.5)
    (reference: src/physics.rs:89-92), no ground plane, no renormalization.
    """
    base = dict(
        compat=True,
        gravity=(0.0, -9.81, 0.0),
        gravity_offset=(0.0, 0.0, 1.5),
        gravity_scale_by_mass=False,
        renormalize_quat=False,
        ground_plane=False,
    )
    base.update(overrides)
    return SimConfig(**base)
