"""Block-sparse matrix utility — the reference's only unit-tested component,
kept at the API level as SURVEY.md §2 prescribes.

The reference (src/physics/sparse_matrix.rs:3-58) stores a list of dense
blocks (row, col, data) and implements y = A·x / y = Aᵀ·x by iterating the
blocks. That layout is scatter-hostile on an accelerator, so this equivalent keeps the
same *interface* (`add_block`, `multiply_vector`, `tr_multiply_vector`,
reference sparse_matrix.rs:16-50) over a batched representation: a fixed
[B, bm, bn] block tensor plus int32 origin arrays, with both matvecs as one
batched einsum followed by a segment-sum over block rows (or columns) —
no global dense materialization, no dynamic shapes once `finalize`d.

Blocks are appended on host (scene-build time); the finalized matvecs are
pure jittable functions of (blocks, x). Overlapping blocks accumulate,
matching the reference's `+=` into the dense target.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

Array = jnp.ndarray


class BlockSparse(NamedTuple):
    """Finalized block-sparse matrix of uniform [bm, bn] blocks.

    rows/cols are the ROW/COL origin (element offset) of each block, as in
    the reference's `MatrixBlock { i, j, .. }` (sparse_matrix.rs:52-58).
    """

    data: Array      # [B, bm, bn] f32
    rows: Array      # [B] int32 — element row origin of each block
    cols: Array      # [B] int32 — element col origin of each block
    shape: tuple     # (n_rows, n_cols) of the full matrix

    @property
    def block_shape(self) -> tuple:
        return self.data.shape[1], self.data.shape[2]


class BlockSparseBuilder:
    """Host-side accumulation of blocks (reference `add_block`,
    sparse_matrix.rs:16-24). All blocks must share one [bm, bn] shape so the
    finalized tensor is static."""

    def __init__(self, n_rows: int, n_cols: int, block_shape: tuple):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.block_shape = (int(block_shape[0]), int(block_shape[1]))
        self._data: list = []
        self._rows: list = []
        self._cols: list = []

    def add_block(self, row: int, col: int, data: np.ndarray) -> None:
        data = np.asarray(data, np.float32)
        if data.shape != self.block_shape:
            raise ValueError(
                f"block shape {data.shape} != builder's {self.block_shape}"
            )
        bm, bn = self.block_shape
        if row + bm > self.n_rows or col + bn > self.n_cols:
            raise ValueError("block exceeds matrix bounds")
        self._data.append(data)
        self._rows.append(int(row))
        self._cols.append(int(col))

    def finalize(self) -> BlockSparse:
        bm, bn = self.block_shape
        b = max(len(self._data), 1)
        data = np.zeros((b, bm, bn), np.float32)
        rows = np.zeros((b,), np.int32)
        cols = np.zeros((b,), np.int32)
        if self._data:
            data[:] = np.stack(self._data)
            rows[:] = np.asarray(self._rows, np.int32)
            cols[:] = np.asarray(self._cols, np.int32)
        return BlockSparse(
            jnp.asarray(data), jnp.asarray(rows), jnp.asarray(cols),
            (self.n_rows, self.n_cols),
        )


def multiply_vector(m: BlockSparse, x: Array) -> Array:
    """y = A·x (reference sparse_matrix.rs:25-37).

    One batched block·segment einsum + a segment-sum scatter of the [B, bm]
    partials into block-row origins. Gathers/scatters run over B·bm elements
    (B is small and static), never over the dense matrix.
    """
    bm, bn = m.block_shape
    # gather each block's x segment: [B, bn]
    seg_idx = m.cols[:, None] + jnp.arange(bn)[None, :]
    x_seg = x[seg_idx]
    part = jnp.einsum("bij,bj->bi", m.data, x_seg)          # [B, bm]
    out_idx = (m.rows[:, None] + jnp.arange(bm)[None, :]).reshape(-1)
    return jnp.zeros((m.shape[0],), x.dtype).at[out_idx].add(part.reshape(-1))


def tr_multiply_vector(m: BlockSparse, x: Array) -> Array:
    """y = Aᵀ·x (reference sparse_matrix.rs:39-50) — same blocks, roles of
    rows/cols swapped."""
    bm, bn = m.block_shape
    seg_idx = m.rows[:, None] + jnp.arange(bm)[None, :]
    x_seg = x[seg_idx]                                       # [B, bm]
    part = jnp.einsum("bij,bi->bj", m.data, x_seg)           # [B, bn]
    out_idx = (m.cols[:, None] + jnp.arange(bn)[None, :]).reshape(-1)
    return jnp.zeros((m.shape[1],), x.dtype).at[out_idx].add(part.reshape(-1))


def to_dense(m: BlockSparse) -> Array:
    """Dense [n_rows, n_cols] materialization (tests/debugging only)."""
    bm, bn = m.block_shape
    out = jnp.zeros(m.shape, m.data.dtype)
    ri = (m.rows[:, None] + jnp.arange(bm)[None, :])         # [B, bm]
    ci = (m.cols[:, None] + jnp.arange(bn)[None, :])         # [B, bn]
    flat = (ri[:, :, None] * m.shape[1] + ci[:, None, :]).reshape(-1)
    return out.reshape(-1).at[flat].add(m.data.reshape(-1)).reshape(m.shape)
