"""Block-diagonal operators with a uniform block size, in SoA layout.

Replacement for the reference's ``BlockDiagonal`` /
``BlockDiagonalLU`` types (``src/block_diagonal.jl:11-21``).  Blocks are stored
as ``(bs, bs, n)`` with the element axis trailing (contiguous); a matvec is
then ``bs^2`` fused multiply-adds over n-vectors (bandwidth-bound, one
elementwise pass) instead of n tiny LAPACK calls.

Instead of an LU factorization per block (``block_diagonal.jl:47-58``) we
precompute the explicit block inverses once at setup: blocks are tiny
(bs <= 9) symmetric positive-definite mass matrices or diagonally-dominant
smoother blocks, so the inverse is numerically safe in f64, and applying it is
a pure batched matmul — the single hottest op in every smoother sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BlockDiag(NamedTuple):
    """Uniform block-diagonal operator; ``blocks[i, j, k]`` = entry (i, j) of block k."""

    blocks: jax.Array  # (bs, bs, n)

    @property
    def block_size(self) -> int:
        return self.blocks.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_dof(self) -> int:
        return self.blocks.shape[0] * self.blocks.shape[2]


def bd_from_dense_blocks(blocks_nij: jax.Array) -> BlockDiag:
    """Build from ``(n, bs, bs)`` (batch-leading) block stack."""
    return BlockDiag(jnp.moveaxis(jnp.asarray(blocks_nij), 0, -1))


def bd_to_dense_blocks(bd: BlockDiag) -> jax.Array:
    """Return blocks as ``(n, bs, bs)``."""
    return jnp.moveaxis(bd.blocks, -1, 0)


def bd_matvec(bd: BlockDiag, x: jax.Array) -> jax.Array:
    """``y[:, k] = blocks[:, :, k] @ x[:, k]`` for ``x`` of shape ``(bs, n)``."""
    return jnp.einsum("ijn,jn->in", bd.blocks, x)


def bd_inverse(bd: BlockDiag) -> BlockDiag:
    """Explicit per-block inverse.

    Setup-time only and computed on the host (native C++ batched Gauss-Jordan
    when built, NumPy LAPACK otherwise): these factorizations happen in f64
    for parity with the reference's LAPACK/UMFPACK solves.
    """
    import numpy as np

    from .native import batched_inv

    inv = batched_inv(np.asarray(bd_to_dense_blocks(bd)))
    return BlockDiag(jnp.asarray(np.moveaxis(inv, 0, -1)))


def bd_solve(bd: BlockDiag, x: jax.Array) -> jax.Array:
    """Solve ``blocks @ y = x`` per block, ``x`` of shape ``(bs, n)`` (host, setup-time)."""
    import numpy as np

    sol = np.linalg.solve(np.asarray(bd_to_dense_blocks(bd)), np.asarray(x).T[..., None])[..., 0]
    return jnp.asarray(sol.T)


def bd_solve_mat(bd: BlockDiag, rhs_nij: jax.Array) -> jax.Array:
    """Per-block solve with matrix rhs ``(n, bs, m)`` -> ``(n, bs, m)`` (host, setup-time)."""
    import numpy as np

    return jnp.asarray(np.linalg.solve(np.asarray(bd_to_dense_blocks(bd)), np.asarray(rhs_nij)))


def bd_to_dense(bd: BlockDiag) -> jax.Array:
    """Materialize the full dense matrix (testing / coarse solves only)."""
    bs, n = bd.block_size, bd.n_blocks
    dense = jnp.zeros((n * bs, n * bs), dtype=bd.blocks.dtype)
    blocks = bd_to_dense_blocks(bd)
    idx = jnp.arange(n)[:, None, None]
    rows = idx * bs + jnp.arange(bs)[None, :, None]
    cols = idx * bs + jnp.arange(bs)[None, None, :]
    return dense.at[rows, cols].set(blocks)
