"""Block-COO operators: uniform block size, arbitrary block sparsity.

Every operator on contiguous 1D levels is block-tridiagonal
(:mod:`.block_tridiag`); the ONE construct in the reference that breaks that
structure is its arbitrary-partition agglomeration ctor
``AgglomeratedDgMesh1(mP, agg::Vector{Vector{Int64}}, mesh, baseMesh)``
(``src/agglomerated_dg_mesh.jl:400-495``): a *non-contiguous* agglomerate
couples, through its interface vertices, to every agglomerate adjacent to any
of its runs — a general (if still very sparse) block graph.  The reference
holds those operators in CSC; the format here is SoA block COO:

* ``rows`` / ``cols``  (nnz,) int32 block coordinates, row-major sorted and
  coalesced (construction helpers below enforce this),
* ``blocks``           (bs_r, bs_c, nnz) dense blocks on the lane axis.

The matvec is one gather + one batched block product + one ``segment_sum`` —
the standard XLA sparse recipe (cf. ``jax.experimental.sparse`` BCOO, whose
layout this mirrors with the element axis last).  Products with
block-diagonal matrices and general SpGEMM run on the host at setup, exactly
like every other coarse-level factorization in this framework.

These operators only ever appear on (small) agglomerated coarse levels; the
fine-level fast paths are untouched.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .block_diag import BlockDiag
from .block_tridiag import BlockTridiag


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("rows", "cols", "blocks"),
    meta_fields=("n_rows", "n_cols"),
)
@dataclasses.dataclass(frozen=True)
class BlockCOO:
    rows: jax.Array  # (nnz,) int32, row-major sorted
    cols: jax.Array  # (nnz,) int32
    blocks: jax.Array  # (bs_r, bs_c, nnz)
    n_rows: int  # static block-row count
    n_cols: int  # static block-col count

    @property
    def bs_row(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_col(self) -> int:
        return self.blocks.shape[1]

    @property
    def nnz(self) -> int:
        return self.blocks.shape[2]

    @property
    def block_size(self) -> int:
        if self.blocks.shape[0] != self.blocks.shape[1]:
            raise ValueError("non-square blocks have no single block_size")
        return self.blocks.shape[0]

    @property
    def n_blocks(self) -> int:
        """Block-row count (matches the ``BlockTridiag`` property name so the
        hierarchy's level plumbing can treat either operator uniformly)."""
        return self.n_rows

    @property
    def n_dof(self) -> int:
        return self.n_rows * self.blocks.shape[0]


def _small_block_contract(blocks: jax.Array, xg: jax.Array) -> jax.Array:
    """``out[a, k] = sum_b blocks[a, b, k] * xg[b, k]`` as an unrolled
    broadcast sum (same rationale as ``block_tridiag.block_mul``: einsum over a
    tiny contracted axis batched over the element axis becomes a batched
    dot_general with a batch-major relayout)."""
    bs_c = blocks.shape[1]
    out = blocks[:, 0, :] * xg[0][None, :]
    for b in range(1, bs_c):
        out = out + blocks[:, b, :] * xg[b][None, :]
    return out


def bcoo_matvec(a: BlockCOO, x: jax.Array) -> jax.Array:
    """``(bs_c, n_cols) -> (bs_r, n_rows)``."""
    xg = x[:, a.cols]  # (bs_c, nnz)
    contrib = _small_block_contract(a.blocks, xg)  # (bs_r, nnz)
    return jax.ops.segment_sum(
        contrib.T, a.rows, num_segments=a.n_rows, indices_are_sorted=True
    ).T


def bcoo_matvec_t(a: BlockCOO, r: jax.Array) -> jax.Array:
    """``A^T r``: ``(bs_r, n_rows) -> (bs_c, n_cols)`` without materializing
    the transpose (rows are sorted; cols are not, so the scatter is unsorted)."""
    rg = r[:, a.rows]  # (bs_r, nnz)
    bs_r = a.blocks.shape[0]
    contrib = a.blocks[0, :, :] * rg[0][None, :]
    for b in range(1, bs_r):
        contrib = contrib + a.blocks[b, :, :] * rg[b][None, :]
    return jax.ops.segment_sum(contrib.T, a.cols, num_segments=a.n_cols).T


# ---------------------------------------------------------------------------
# Host-side construction / algebra (setup only, NumPy)
# ---------------------------------------------------------------------------


class _HostCOO(NamedTuple):
    rows: np.ndarray
    cols: np.ndarray
    blocks: np.ndarray  # (bs_r, bs_c, nnz)


def bcoo_coalesce(
    rows, cols, blocks, n_rows: int, n_cols: int, *, prune_tol: float = 0.0
) -> BlockCOO:
    """Sort row-major, sum duplicate coordinates, drop all-zero blocks."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    blocks = np.asarray(blocks)
    if rows.size == 0:
        return BlockCOO(
            rows=jnp.zeros((0,), jnp.int32),
            cols=jnp.zeros((0,), jnp.int32),
            blocks=jnp.zeros(blocks.shape[:2] + (0,), blocks.dtype),
            n_rows=n_rows,
            n_cols=n_cols,
        )
    key = rows * n_cols + cols
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq, inv_start = np.unique(key, return_index=True)
    # segment-sum duplicates: np.add.reduceat over the sorted runs
    summed = np.add.reduceat(blocks[:, :, order], inv_start, axis=2)
    keep = np.abs(summed).max(axis=(0, 1)) > prune_tol
    # always keep at least the diagonal structure if everything pruned to zero
    if not keep.any():
        keep[:] = True
    uniq, summed = uniq[keep], summed[:, :, keep]
    return BlockCOO(
        rows=jnp.asarray(uniq // n_cols, jnp.int32),
        cols=jnp.asarray(uniq % n_cols, jnp.int32),
        blocks=jnp.asarray(summed),
        n_rows=n_rows,
        n_cols=n_cols,
    )


def _host(a: BlockCOO) -> _HostCOO:
    return _HostCOO(
        np.asarray(a.rows, np.int64), np.asarray(a.cols, np.int64), np.asarray(a.blocks)
    )


def bcoo_from_bt(a: BlockTridiag) -> BlockCOO:
    """Block-tridiagonal -> block-COO (tests / mixed-structure Galerkin)."""
    bs, n = a.block_size, a.n_blocks
    k = np.arange(n)
    rows = np.concatenate([k, k[1:], k[:-1]])
    cols = np.concatenate([k, k[1:] - 1, k[:-1] + 1])
    blocks = np.concatenate(
        [
            np.asarray(a.diag),
            np.asarray(a.lower[:, :, 1:]),
            np.asarray(a.upper[:, :, :-1]),
        ],
        axis=2,
    )
    return bcoo_coalesce(rows, cols, blocks, n, n)


def bcoo_to_dense(a: BlockCOO) -> jax.Array:
    """Materialize dense (tests / coarse-level factorization only); same
    block-index-major DoF order as ``bt_to_dense`` (dof = k * bs + i)."""
    h = _host(a)
    bs_r, bs_c = a.bs_row, a.bs_col
    dense = np.zeros((a.n_rows * bs_r, a.n_cols * bs_c), dtype=h.blocks.dtype)
    for t in range(h.rows.size):
        r, c = h.rows[t], h.cols[t]
        dense[r * bs_r : (r + 1) * bs_r, c * bs_c : (c + 1) * bs_c] += h.blocks[:, :, t]
    return jnp.asarray(dense)


def bcoo_scale_cols(a: BlockCOO, d: BlockDiag | jax.Array) -> BlockCOO:
    """``A @ blockdiag(D)``: right-multiply each block by ``D[cols[t]]``.
    ``d`` is ``(bs_c, bs_c, n_cols)`` (or a BlockDiag holding it)."""
    db = d.blocks if isinstance(d, BlockDiag) else d
    h = _host(a)
    dg = np.asarray(db)[:, :, h.cols]  # (bs_c, bs_c, nnz)
    blocks = np.einsum("abt,bct->act", h.blocks, dg)
    return BlockCOO(
        rows=a.rows, cols=a.cols, blocks=jnp.asarray(blocks),
        n_rows=a.n_rows, n_cols=a.n_cols,
    )


def bcoo_spgemm(a: BlockCOO, b: BlockCOO) -> BlockCOO:
    """``A @ B`` (host, vectorized join on ``a.cols == b.rows``).  Setup-time
    only — the solve path never multiplies sparse operators."""
    if a.n_cols != b.n_rows or a.bs_col != b.bs_row:
        raise ValueError("bcoo_spgemm: inner dimensions do not match")
    ha, hb = _host(a), _host(b)
    # b grouped by row: counts/starts per inner index k
    counts = np.bincount(hb.rows, minlength=a.n_cols)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    order = np.argsort(hb.rows, kind="stable")  # already sorted, but be safe
    rep = counts[ha.cols]  # (nnz_a,) matches per a-entry
    a_idx = np.repeat(np.arange(ha.rows.size), rep)
    # b indices: for a-entry t, the run starts[a.cols[t]] .. +rep[t]
    run_starts = starts[ha.cols]
    offs = np.arange(rep.sum()) - np.repeat(np.cumsum(rep) - rep, rep)
    b_idx = order[np.repeat(run_starts, rep) + offs]
    blocks = np.einsum("abt,bct->act", ha.blocks[:, :, a_idx], hb.blocks[:, :, b_idx])
    return bcoo_coalesce(
        ha.rows[a_idx], hb.cols[b_idx], blocks, a.n_rows, b.n_cols
    )


def bcoo_add(a: BlockCOO, b: BlockCOO, *, beta: float = 1.0) -> BlockCOO:
    """``A + beta * B`` (host coalesce)."""
    if (a.n_rows, a.n_cols) != (b.n_rows, b.n_cols):
        raise ValueError("bcoo_add: shape mismatch")
    ha, hb = _host(a), _host(b)
    rows = np.concatenate([ha.rows, hb.rows])
    cols = np.concatenate([ha.cols, hb.cols])
    blocks = np.concatenate([ha.blocks, beta * hb.blocks], axis=2)
    return bcoo_coalesce(rows, cols, blocks, a.n_rows, a.n_cols)


def bcoo_diag_blocks(a: BlockCOO) -> jax.Array:
    """(bs, bs, n_rows) diagonal blocks (zero where absent) — smoother setup."""
    if a.n_rows != a.n_cols:
        raise ValueError("diagonal of a non-square operator")
    h = _host(a)
    out = np.zeros((a.bs_row, a.bs_col, a.n_rows), dtype=h.blocks.dtype)
    on_diag = h.rows == h.cols
    out[:, :, h.rows[on_diag]] = h.blocks[:, :, on_diag]
    return jnp.asarray(out)
