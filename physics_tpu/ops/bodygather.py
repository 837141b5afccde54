"""Body-table gather/scatter with a size-based strategy switch.

Two regimes:

* LARGE body tables (one big scene): a real lane gather/scatter.
* SMALL tables under `vmap` (thousands of tiny envs): a vmapped
  gather/scatter can lower to a per-index loop that dominates the step.
  With N ≤ 64 the same operation as a dense one-hot contraction is a tiny
  matmul that vectorizes across the env batch (0 gathers in the whole
  program).

The threshold is static (shapes), so the choice is made at trace time and
both paths stay jit/vmap/shard_map-compatible.

PRECISION: the one-hot contractions run with precision=HIGHEST. At default
precision an accelerator's matmul units may round f32 operands (bf16 or
TF32), turning the "gather" into a value-quantizing op (~2⁻⁸ relative for
bf16 — 0.5 absolute for a body at x≈150, larger than a typical contact
depth). HIGHEST keeps full f32 semantics — a 0/1 one-hot contraction is
then an exact gather — and costs nothing at the ≤64-wide shapes this path
handles.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray

DENSE_MAX_N = 64


def lane_gather(table: Array, idx: Array) -> Array:
    """table [R, N], idx [C] → [R, C] (rows of the table per index)."""
    n = table.shape[-1]
    if n <= DENSE_MAX_N:
        oh = jax.nn.one_hot(idx, n, dtype=table.dtype)      # [C, N]
        return jnp.einsum("rn,cn->rc", table, oh,
                          precision=jax.lax.Precision.HIGHEST)
    return table[:, idx]


def lane_scatter_add(contrib: Array, ids: Array, n: int) -> Array:
    """contrib [R, C], ids [C] with values in [0, n] (n ⇒ dropped) → [R, n].

    Duplicate ids accumulate.
    """
    if n + 1 <= DENSE_MAX_N:
        oh = jax.nn.one_hot(ids, n + 1, dtype=contrib.dtype)  # [C, n+1]
        return jnp.einsum("rc,cn->rn", contrib, oh,
                          precision=jax.lax.Precision.HIGHEST)[:, :n]
    return jnp.zeros(
        (contrib.shape[0], n + 1), contrib.dtype
    ).at[:, ids].add(contrib)[:, :n]


def scatter_add_1d(contrib: Array, ids: Array, n: int) -> Array:
    """contrib [C], ids [C] with values in [0, n] (n ⇒ dropped) → [n].

    Routed through the 2-D lane scatter, so both share one lowering.
    """
    if n + 1 <= DENSE_MAX_N:
        oh = jax.nn.one_hot(ids, n + 1, dtype=contrib.dtype)
        return jnp.einsum("c,cn->n", contrib, oh,
                          precision=jax.lax.Precision.HIGHEST)[:n]
    return lane_scatter_add(contrib[None, :], ids, n)[0]
