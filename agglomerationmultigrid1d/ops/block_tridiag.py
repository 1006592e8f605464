"""Block-tridiagonal operators with uniform block size, in SoA layout.

This is the format for every DG / agglomerated-DG operator in the
framework (G, D, C, Schur stiffness A = C - D M^-1 G, and their Galerkin coarse
versions).  In the reference these are general CSC sparse matrices
(``src/dg_mesh.jl:328-333``); in 1D their structure is exactly block-tridiagonal
(vertex flux terms couple only face-adjacent elements), so we store three dense
diagonals of shape ``(bs, bs, n)``:

* ``lower[:, :, k]`` couples block-row ``k`` to block-col ``k - 1`` (entry 0 unused),
* ``diag [:, :, k]`` the diagonal block,
* ``upper[:, :, k]`` couples block-row ``k`` to block-col ``k + 1`` (entry n-1 unused).

All products below are closed over this structure for the patterns the solver
needs (mass is block-diagonal; prolongations are block-aligned), so no general
SpGEMM ever appears — everything is batched small matmuls over the lane axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .block_diag import BlockDiag
from .shifts import shift


class BlockTridiag(NamedTuple):
    lower: jax.Array  # (bs, bs, n)
    diag: jax.Array  # (bs, bs, n)
    upper: jax.Array  # (bs, bs, n)

    @property
    def block_size(self) -> int:
        return self.diag.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.diag.shape[2]

    @property
    def n_dof(self) -> int:
        return self.diag.shape[0] * self.diag.shape[2]


def bt_zeros(bs: int, n: int, dtype=jnp.float64) -> BlockTridiag:
    z = jnp.zeros((bs, bs, n), dtype=dtype)
    return BlockTridiag(z, z, z)


def block_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched per-block product ``C[:, :, k] = A[:, :, k] @ B[:, :, k]`` on
    ``(bs, bs, n)`` SoA tensors.

    Deliberately NOT ``jnp.einsum("ijn,jkn->ikn", ...)``: that lowers to a
    dot_general with the tiny bs-contraction batched over n, which can force a
    batch-major relayout of every operand.  The unrolled broadcast sum keeps
    n as the contiguous axis and fuses to bs^2 elementwise FMAs."""
    bs = a.shape[0]
    acc = a[:, 0, None, :] * b[None, 0, :, :]
    for j in range(1, bs):
        acc = acc + a[:, j, None, :] * b[None, j, :, :]
    return acc


def bt_matvec(a: BlockTridiag, x: jax.Array) -> jax.Array:
    """``y[:, k] = lower_k x_{k-1} + diag_k x_k + upper_k x_{k+1}``; x is ``(bs, n)``."""
    y = jnp.einsum("ijn,jn->in", a.diag, x)
    y = y + jnp.einsum("ijn,jn->in", a.lower, shift(x, -1))
    y = y + jnp.einsum("ijn,jn->in", a.upper, shift(x, +1))
    return y


def bt_add(a: BlockTridiag, b: BlockTridiag) -> BlockTridiag:
    return BlockTridiag(a.lower + b.lower, a.diag + b.diag, a.upper + b.upper)


def bt_sub(a: BlockTridiag, b: BlockTridiag) -> BlockTridiag:
    return BlockTridiag(a.lower - b.lower, a.diag - b.diag, a.upper - b.upper)


def bt_scale(a: BlockTridiag, s) -> BlockTridiag:
    return BlockTridiag(s * a.lower, s * a.diag, s * a.upper)


def bd_mul_bt(m: BlockDiag, a: BlockTridiag) -> BlockTridiag:
    """``M @ A`` with M block-diagonal: scales every diagonal by the row block."""
    mm = m.blocks
    return BlockTridiag(
        block_mul(mm, a.lower),
        block_mul(mm, a.diag),
        block_mul(mm, a.upper),
    )


def bt_mul_bd(a: BlockTridiag, m: BlockDiag) -> BlockTridiag:
    """``A @ M`` with M block-diagonal: (AM)[k, k+d] = A[k, k+d] M[k+d]."""
    mm = m.blocks
    return BlockTridiag(
        block_mul(a.lower, shift(mm, -1)),
        block_mul(a.diag, mm),
        block_mul(a.upper, shift(mm, +1)),
    )


def bt_mul_bt(a: BlockTridiag, b: BlockTridiag) -> BlockTridiag:
    """``A @ B`` assuming the result is still block-tridiagonal.

    This is structurally guaranteed for the solver's one use of it,
    ``D @ (M^-1 G)`` (cf. ``src/mesh_heirarchy.jl:71-72``): D has only diag+upper
    and M^-1 G only diag+lower, so the distance-2 products vanish.  The general
    distance-2 terms are simply not formed; use ``bt_mul_bt_checked`` in tests.
    """
    #  C[k,k]   = L_a[k] U_b[k-1] + D_a[k] D_b[k] + U_a[k] L_b[k+1]
    diag = (
        block_mul(a.lower, shift(b.upper, -1))
        + block_mul(a.diag, b.diag)
        + block_mul(a.upper, shift(b.lower, +1))
    )
    #  C[k,k-1] = L_a[k] D_b[k-1] + D_a[k] L_b[k]
    lower = block_mul(a.lower, shift(b.diag, -1)) + block_mul(a.diag, b.lower
    )
    #  C[k,k+1] = D_a[k] U_b[k] + U_a[k] D_b[k+1]
    upper = block_mul(a.diag, b.upper) + block_mul(a.upper, shift(b.diag, +1)
    )
    return BlockTridiag(lower, diag, upper)


def bt_distance2_residual(a: BlockTridiag, b: BlockTridiag) -> jax.Array:
    """Max |distance-2 blocks| of A @ B — must be ~0 for ``bt_mul_bt`` to be exact."""
    lo2 = block_mul(a.lower, shift(b.lower, -1))
    up2 = block_mul(a.upper, shift(b.upper, +1))
    return jnp.maximum(jnp.max(jnp.abs(lo2)), jnp.max(jnp.abs(up2)))


def bt_diagonal(a: BlockTridiag) -> jax.Array:
    """Scalar main diagonal as ``(bs, n)``."""
    bs = a.block_size
    return a.diag[jnp.arange(bs), jnp.arange(bs), :]


def bt_diag_blocks(a: BlockTridiag) -> BlockDiag:
    return BlockDiag(a.diag)


def bt_to_dense(a: BlockTridiag) -> jax.Array:
    """Materialize dense (tests / coarse-level factorization only)."""
    bs, n = a.block_size, a.n_blocks
    dense = jnp.zeros((n * bs, n * bs), dtype=a.diag.dtype)
    ii = jnp.arange(bs)
    k = jnp.arange(n)[:, None, None]
    rows = k * bs + ii[None, :, None]
    colsd = k * bs + ii[None, None, :]
    dense = dense.at[rows, colsd].set(jnp.moveaxis(a.diag, -1, 0))
    if n > 1:
        kl = jnp.arange(1, n)[:, None, None]
        dense = dense.at[kl * bs + ii[None, :, None], (kl - 1) * bs + ii[None, None, :]].set(
            jnp.moveaxis(a.lower[:, :, 1:], -1, 0)
        )
        ku = jnp.arange(n - 1)[:, None, None]
        dense = dense.at[ku * bs + ii[None, :, None], (ku + 1) * bs + ii[None, None, :]].set(
            jnp.moveaxis(a.upper[:, :, :-1], -1, 0)
        )
    return dense


def bt_from_dense(dense: jax.Array, bs: int) -> BlockTridiag:
    """Inverse of :func:`bt_to_dense` (testing utility; off-band entries ignored)."""
    nd = dense.shape[0]
    n = nd // bs
    blocks = dense.reshape(n, bs, n, bs)
    k = jnp.arange(n)
    diag = jnp.moveaxis(blocks[k, :, k, :], 0, -1)
    lower = jnp.zeros((bs, bs, n), dense.dtype)
    upper = jnp.zeros((bs, bs, n), dense.dtype)
    if n > 1:
        kl = jnp.arange(1, n)
        lower = lower.at[:, :, 1:].set(jnp.moveaxis(blocks[kl, :, kl - 1, :], 0, -1))
        ku = jnp.arange(n - 1)
        upper = upper.at[:, :, :-1].set(jnp.moveaxis(blocks[ku, :, ku + 1, :], 0, -1))
    return BlockTridiag(lower, diag, upper)
