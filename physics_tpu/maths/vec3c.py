"""Component-form 3-vector math (tuples of same-shaped arrays).

Layout note (the reason this module exists): a rank-2 [C, 3] tensor has a
minor dimension of 3, which accelerator memory layouts pad and which breaks
vectorization along the contact axis. Representing each component as its
own 1-D [C] array (or [.., C] row) keeps the contact axis contiguous and
lets XLA fuse entire contact-math chains into a few elementwise passes.

A "v3" is any tuple/list of three equally-shaped arrays (x, y, z).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

Array = jnp.ndarray
V3 = Tuple[Array, Array, Array]


def splat(v) -> V3:
    """Constant/broadcastable [3] vector → component tuple."""
    return (jnp.float32(v[0]), jnp.float32(v[1]), jnp.float32(v[2]))


def unpack(arr: Array, axis: int = -1) -> V3:
    """[.., 3, ..] array → component tuple (3 slices; one fused read)."""
    xs = jnp.moveaxis(arr, axis, 0)
    return (xs[0], xs[1], xs[2])


def pack(v: Sequence[Array], axis: int = -1) -> Array:
    """Component tuple → [.., 3] array (one padded write — do this once at
    a boundary, never inside a hot loop)."""
    return jnp.moveaxis(jnp.stack(v), 0, axis)


def add(a, b) -> V3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b) -> V3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a, s) -> V3:
    return (a[0] * s, a[1] * s, a[2] * s)


def neg(a) -> V3:
    return (-a[0], -a[1], -a[2])


def dot(a, b) -> Array:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b) -> V3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def norm(a, eps: float = 0.0) -> Array:
    return jnp.sqrt(jnp.maximum(dot(a, a), eps))


def where(mask, a, b) -> V3:
    return (
        jnp.where(mask, a[0], b[0]),
        jnp.where(mask, a[1], b[1]),
        jnp.where(mask, a[2], b[2]),
    )


def gather(a, idx) -> V3:
    """Per-component 1-D gather."""
    return (a[0][idx], a[1][idx], a[2][idx])


# ---- 3×3 matrices as 9-tuples (row-major m[3*i + j]) ----

def mat_unpack(m: Array) -> tuple:
    """[.., 3, 3] → 9-tuple (one fused read)."""
    return tuple(m[..., i, j] for i in range(3) for j in range(3))


def mat_vec(m: tuple, v) -> V3:
    """Row-major 9-tuple × v3."""
    return (
        m[0] * v[0] + m[1] * v[1] + m[2] * v[2],
        m[3] * v[0] + m[4] * v[1] + m[5] * v[2],
        m[6] * v[0] + m[7] * v[1] + m[8] * v[2],
    )


def mat_gather(m: tuple, idx) -> tuple:
    return tuple(c[idx] for c in m)


def quat_to_mat(q: Array) -> tuple:
    """Quaternion [.., 4] (w, x, y, z — the package convention) → row-major
    9-tuple. Exactly maths.quaternion.to_matrix's nalgebra expansion
    (ww+xx−yy−zz diagonal form), in component form."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    xy = x * y * 2.0
    wz = w * z * 2.0
    wy = w * y * 2.0
    xz = x * z * 2.0
    yz = y * z * 2.0
    wx = w * x * 2.0
    return (
        ww + xx - yy - zz, xy - wz, wy + xz,
        wz + xy, ww - xx + yy - zz, yz - wx,
        xz - wy, wx + yz, ww - xx - yy + zz,
    )


def sandwich(r: tuple, m: tuple) -> tuple:
    """R · M · Rᵀ for row-major 9-tuples (world-frame inertia transport)."""
    # t = R · M
    t = [
        sum(r[3 * i + k] * m[3 * k + j] for k in range(3))
        for i in range(3) for j in range(3)
    ]
    # out = t · Rᵀ  → out[i][j] = Σ_k t[i][k] · r[j][k]
    return tuple(
        sum(t[3 * i + k] * r[3 * j + k] for k in range(3))
        for i in range(3) for j in range(3)
    )
