"""Smoothers, applied as  x += alpha * S * r  (counterpart of ``src/smoother.jl``).

Four smoother families, all batched:

* :class:`JacobiSmoother`      — pointwise diagonal scaling (``smoother.jl:52-58``);
  works on both CG node vectors ``(n_nodes,)`` and block vectors ``(bs, n)``.
* :class:`BlockJacobiSmoother` — per-element block solve on DG/agg levels
  (``smoother.jl:64-81``); the per-block LU backsolves of the reference become
  one batched matmul with precomputed block inverses.
* :class:`SchwarzSmoother`     — overlapping element-block solves on CG levels:
  additive (overlaps summed, ``smoother.jl:1-18``) or hybrid (divided by node
  multiplicity, ``smoother.jl:24-46``) depending on ``mult_inv``.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

from ..ops.block_diag import BlockDiag, bd_matvec
from ..ops.block_tridiag import BlockTridiag, block_mul, bt_diag_blocks, bt_diagonal
from ..ops.cg_operator import (
    CgOperator,
    cg_assembled_windows,
    cg_diagonal,
    cg_node_multiplicity,
)


class JacobiSmoother(NamedTuple):
    inv_diag: jax.Array  # same shape as the level's vectors


class BlockJacobiSmoother(NamedTuple):
    inv: jax.Array  # (bs, bs, n) inverse diagonal blocks
    # M-form streams for the fused Pallas multisweep kernels (f32 fast path
    # only): ml = inv @ a.lower, mu = inv @ a.upper, precomputed once at setup
    # so the kernel streams 3 operators instead of 4 and skips the diagonal
    # contraction (S^-1 A_D = I).  None on parity (f64) levels and for
    # non-block-tridiagonal operators; the kernels recompute on the fly then.
    ml: jax.Array | None = None
    mu: jax.Array | None = None


class SchwarzSmoother(NamedTuple):
    inv_windows: jax.Array  # (w, w, n_el) inverses of assembled element windows
    mult_inv: jax.Array | None  # (n_nodes,): set => hybrid, None => additive

    @property
    def p(self) -> int:
        return self.inv_windows.shape[0] - 1

    @property
    def n_el(self) -> int:
        return self.inv_windows.shape[2]


class ChebyshevSmoother(NamedTuple):
    """Chebyshev-accelerated smoothing over a base smoother (an
    extension; the reference has only stationary damped smoothers).

    ``k`` applications target the interval ``[lam_lo, lam_hi]`` of the
    preconditioned spectrum ``S A``: a degree-k Chebyshev polynomial damps the
    upper part of the spectrum far faster than k fixed-damping sweeps
    (the standard multigrid smoothing of Adams et al.), typically cutting
    V-cycle counts ~2x at identical per-sweep cost.  ``lam_hi`` comes from a
    few power iterations at setup; ``base`` is any stationary smoother."""

    base: "Smoother"
    lam_lo: jax.Array  # scalar, lower edge of the damped interval
    lam_hi: jax.Array  # scalar estimate of lambda_max(S A), slightly inflated


Smoother = Union[JacobiSmoother, BlockJacobiSmoother, SchwarzSmoother, ChebyshevSmoother]


def apply_smoother(s: Smoother, r: jax.Array, alpha: float = 1.0) -> jax.Array:
    """``alpha * S r`` (cf. the four ``apply_smoother`` methods, ``smoother.jl``)."""
    if isinstance(s, JacobiSmoother):
        return alpha * (s.inv_diag * r)
    if isinstance(s, BlockJacobiSmoother):
        return alpha * bd_matvec(BlockDiag(s.inv), r)
    if isinstance(s, SchwarzSmoother):
        p, n_el = s.p, s.n_el
        idx = p * jnp.arange(n_el)[None, :] + jnp.arange(p + 1)[:, None]
        r_win = r[idx]  # (w, n_el)
        y_win = jnp.einsum("abn,bn->an", s.inv_windows, r_win)
        y = jnp.zeros_like(r).at[idx].add(y_win)
        if s.mult_inv is not None:
            y = y * s.mult_inv
        return alpha * y
    raise TypeError(f"unknown smoother {type(s)}")


@jax.jit
def _inv_windows_2x2(w: jax.Array) -> jax.Array:
    """Fused cofactor inverse on the SoA ``(2, 2, n)`` layout (any backend)."""
    a, b, c, d = w[0, 0], w[0, 1], w[1, 0], w[1, 1]
    idet = 1.0 / (a * d - b * c)
    return jnp.stack(
        [jnp.stack([d, -b]), jnp.stack([-c, a])]
    ) * idet


def _invert_windows(windows: jax.Array) -> jax.Array:
    """(w, w, n) -> per-slice inverse, same layout.

    Block sizes 1/2 use the closed-form cofactor inverse, jitted directly on
    the SoA layout (no transposes or host round trips — both dominated setup
    at 10^7+ elements); larger blocks go through the native C++ batched
    Gauss-Jordan (NumPy LAPACK fallback) on the host in f64 — these are the counterparts of the reference's per-block
    ``la.lu`` factorizations (``smoother.jl:112,:127,:160``)."""
    import numpy as np

    from ..ops.native import batched_inv

    bs = windows.shape[0]
    if bs == 1:
        return 1.0 / jnp.asarray(windows)
    if bs == 2:
        return _inv_windows_2x2(jnp.asarray(windows))
    w = np.asarray(windows)
    inv = batched_inv(np.moveaxis(w, -1, 0))
    return jnp.asarray(np.moveaxis(inv, 0, -1))


def cg_smoother(a: CgOperator, kind: str = "jac") -> Smoother:
    """Factory for CG levels (cf. ``smoother.jl:88-139``)."""
    if kind == "jac":
        return JacobiSmoother(inv_diag=1.0 / cg_diagonal(a))
    if kind in ("addSchwarz", "hybridSchwarz"):
        inv_win = _invert_windows(cg_assembled_windows(a))
        mult_inv = None
        if kind == "hybridSchwarz":
            mult_inv = 1.0 / cg_node_multiplicity(a.p, a.n_el, dtype=a.band.dtype)
        return SchwarzSmoother(inv_windows=inv_win, mult_inv=mult_inv)
    raise ValueError(f"unknown CG smoother kind {kind!r}")


def dg_smoother(a, kind: str = "blockJac") -> Smoother:
    """Factory for DG / agglomerated levels (cf. ``smoother.jl:142-168``).

    ``a`` is block-tridiagonal, block-pentadiagonal, or block-COO (scattered
    agglomeration levels); the block-Jacobi data is the inverted diagonal
    blocks in every case."""
    from ..ops.block_coo import BlockCOO, bcoo_diag_blocks

    if isinstance(a, BlockCOO):
        d = bcoo_diag_blocks(a)
        if kind == "jac":
            bs = d.shape[0]
            return JacobiSmoother(inv_diag=1.0 / jnp.stack([d[i, i] for i in range(bs)]))
        if kind == "blockJac":
            return BlockJacobiSmoother(inv=_invert_windows(d))
        raise ValueError(f"unknown DG smoother kind {kind!r}")
    if kind == "jac":
        return JacobiSmoother(inv_diag=1.0 / bt_diagonal(a))
    if kind == "blockJac":
        inv = _invert_windows(bt_diag_blocks(a).blocks)
        ml = mu = None
        if isinstance(a, BlockTridiag) and a.diag.dtype == jnp.float32:
            # fast-path level: precompute the M-form streams for the fused
            # Pallas kernels (f64 parity levels skip this — they never hit
            # the kernels, and hierarchy.prepare_fast_smoothers fills these
            # in after the f32 cast)
            ml = block_mul(inv, a.lower)
            mu = block_mul(inv, a.upper)
        return BlockJacobiSmoother(inv=inv, ml=ml, mu=mu)
    raise ValueError(f"unknown DG smoother kind {kind!r}")
