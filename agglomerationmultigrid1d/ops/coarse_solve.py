"""Coarsest-level direct solve (replaces the reference's UMFPACK ``A \\ b``).

Two factorizations, both host-side at setup, both applied on-device:

* :class:`CoarseSolver` — explicit dense inverse + one iterative-refinement
  step (MXU-friendly matvecs).  Used for small coarsest levels (every
  reference configuration) and for CG coarsest levels.
* :class:`BTCoarseSolver` — **block cyclic reduction** of a block-tridiagonal
  coarsest operator (``solvers.jl:39`` relies on UMFPACK handling any size;
  this is the equivalent for large coarse levels).  Setup is
  O(n bs^3) host NumPy; the solve is ~2 log2(n) stages of batched small
  matmuls with O(n bs^2) memory — no dense matrix is ever formed, so there is
  no size cliff.  One refinement step against the stored block-tridiagonal
  operator restores direct-solve accuracy for the penalty-dominated
  (CDir = 1000 n) agglomerated coarse operators.

Under multi-chip sharding the coarsest level is replicated either way.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .block_tridiag import BlockTridiag, bt_matvec


class CoarseSolver(NamedTuple):
    a_dense: jax.Array  # (n, n)
    a_inv: jax.Array  # (n, n) host-computed inverse

    @property
    def n(self) -> int:
        return self.a_dense.shape[0]


def make_coarse_solver(a_dense: jax.Array) -> CoarseSolver:
    inv = np.linalg.inv(np.asarray(a_dense))
    return CoarseSolver(a_dense=jnp.asarray(a_dense), a_inv=jnp.asarray(inv))


def _dense_solve(f: CoarseSolver, b: jax.Array) -> jax.Array:
    """``A^-1 b`` with one iterative-refinement correction."""
    x = f.a_inv @ b
    r = b - f.a_dense @ x
    return x + f.a_inv @ r


class BTCoarseSolver(NamedTuple):
    """Block-cyclic-reduction factorization of a :class:`BlockTridiag`.

    Per reduction level ``l`` (n -> ceil(n/2) even-position blocks):
    ``f``/``g`` fold the odd neighbors into the even rows on the way down,
    ``dinv_odd``/``l_odd``/``u_odd`` recover the odd unknowns on the way up.
    ``root_inv`` inverts the final single block; ``a`` is kept for one
    refinement step.
    """

    f: tuple  # of (bs, bs, ne) — L_even @ Dinv_odd(left), zero at j = 0
    g: tuple  # of (bs, bs, ne) — U_even @ Dinv_odd(right), zero past the end
    dinv_odd: tuple  # of (bs, bs, no)
    l_odd: tuple  # of (bs, bs, no)
    u_odd: tuple  # of (bs, bs, no)
    root_inv: jax.Array  # (bs, bs, 1)
    a: BlockTridiag

    @property
    def n(self) -> int:
        return self.a.n_dof


def _bmm(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(bs, bs, m) @ (bs, bs, m) batched over the trailing axis."""
    return np.einsum("ijm,jkm->ikm", x, y)


def _inv_soa(d: np.ndarray) -> np.ndarray:
    """Batched inverse of (bs, bs, m) blocks, staying in SoA layout."""
    bs = d.shape[0]
    if bs == 1:
        return 1.0 / d
    if bs == 2:
        a, b, c, dd = d[0, 0], d[0, 1], d[1, 0], d[1, 1]
        idet = 1.0 / (a * dd - b * c)
        out = np.empty_like(d)
        out[0, 0] = dd * idet
        out[0, 1] = -b * idet
        out[1, 0] = -c * idet
        out[1, 1] = a * idet
        return out
    from .native import batched_inv

    return np.moveaxis(batched_inv(np.moveaxis(d, -1, 0)), 0, -1)


def make_bt_coarse_solver(a: BlockTridiag) -> BTCoarseSolver:
    """Factorize a block-tridiagonal operator by cyclic reduction (host f64)."""
    bs = a.block_size
    dd = np.array(a.diag, dtype=np.float64)
    ll = np.array(a.lower, dtype=np.float64)
    uu = np.array(a.upper, dtype=np.float64)
    # enforce the BlockTridiag convention (entry 0 of lower / n-1 of upper
    # unused) — the reduction reads them as real couplings
    ll[:, :, 0] = 0.0
    uu[:, :, -1] = 0.0

    fs, gs, dinvs, lodds, uodds = [], [], [], [], []
    n = dd.shape[2]
    while n > 1:
        ne, no = (n + 1) // 2, n // 2
        d_e, l_e, u_e = dd[:, :, 0::2], ll[:, :, 0::2], uu[:, :, 0::2]
        d_o, l_o, u_o = dd[:, :, 1::2], ll[:, :, 1::2], uu[:, :, 1::2]
        dinv_o = _inv_soa(d_o)

        # F_j = L_e[j] Dinv_o[j-1] (j >= 1); G_j = U_e[j] Dinv_o[j] (j < no)
        f = np.zeros((bs, bs, ne))
        f[:, :, 1:] = _bmm(l_e[:, :, 1:], dinv_o[:, :, : ne - 1])
        g = np.zeros((bs, bs, ne))
        g[:, :, :no] = _bmm(u_e[:, :, :no], dinv_o)

        # odd-neighbor couplings shifted onto the even index space
        u_o_left = np.zeros((bs, bs, ne))
        u_o_left[:, :, 1:] = u_o[:, :, : ne - 1]
        l_o_left = np.zeros((bs, bs, ne))
        l_o_left[:, :, 1:] = l_o[:, :, : ne - 1]
        l_o_pad = np.zeros((bs, bs, ne))
        l_o_pad[:, :, :no] = l_o
        u_o_pad = np.zeros((bs, bs, ne))
        u_o_pad[:, :, :no] = u_o

        fs.append(f)
        gs.append(g)
        dinvs.append(dinv_o)
        lodds.append(l_o)
        uodds.append(u_o)

        dd = d_e - _bmm(f, u_o_left) - _bmm(g, l_o_pad)
        ll = -_bmm(f, l_o_left)
        uu = -_bmm(g, u_o_pad)
        n = ne

    root_inv = _inv_soa(dd)
    as_j = lambda arrs: tuple(jnp.asarray(x) for x in arrs)  # noqa: E731
    return BTCoarseSolver(
        f=as_j(fs), g=as_j(gs), dinv_odd=as_j(dinvs), l_odd=as_j(lodds),
        u_odd=as_j(uodds), root_inv=jnp.asarray(root_inv), a=a,
    )


def _bcr_apply(s: BTCoarseSolver, b: jax.Array) -> jax.Array:
    """One cyclic-reduction solve; ``b`` is (bs, n) in the level's SoA layout."""
    mm = lambda m, v: jnp.einsum("ijm,jm->im", m, v)  # noqa: E731

    # downsweep: fold odd rhs into even rows, remember the odd rhs per level
    b_odds = []
    for f, g in zip(s.f, s.g):
        ne = f.shape[2]
        b_e, b_o = b[:, 0::2], b[:, 1::2]
        no = b_o.shape[1]
        b_o_left = jnp.zeros_like(b_e).at[:, 1:].set(b_o[:, : ne - 1])
        b_o_pad = jnp.zeros_like(b_e).at[:, :no].set(b_o)
        b_odds.append(b_o)
        b = b_e - mm(f, b_o_left) - mm(g, b_o_pad)

    x = mm(s.root_inv, b)

    # upsweep: recover the odd unknowns, interleave
    for f, dinv_o, l_o, u_o, b_o in zip(
        reversed(s.f), reversed(s.dinv_odd), reversed(s.l_odd),
        reversed(s.u_odd), reversed(b_odds),
    ):
        ne, no = f.shape[2], b_o.shape[1]
        n = ne + no
        x_right = jnp.zeros((x.shape[0], no), x.dtype).at[:, : ne - 1].set(x[:, 1:])
        x_o = mm(dinv_o, b_o - mm(l_o, x[:, :no]) - mm(u_o, x_right))
        x = (
            jnp.zeros((x.shape[0], n), x.dtype)
            .at[:, 0::2].set(x)
            .at[:, 1::2].set(x_o)
        )
    return x


def _bt_solve(s: BTCoarseSolver, b: jax.Array) -> jax.Array:
    """Cyclic-reduction solve + one refinement step; flat DoF vector in/out."""
    bs = s.a.block_size
    n = s.a.n_blocks
    b2 = b.reshape(n, bs).T
    x = _bcr_apply(s, b2)
    r = b2 - bt_matvec(s.a, x)
    x = x + _bcr_apply(s, r)
    return x.T.reshape(-1)


class PaddedBTCoarseSolver(NamedTuple):
    """A :class:`BTCoarseSolver` of a pair-merged pentadiagonal operator whose
    original block count was odd: the flat rhs is zero-padded by one fine
    block before the merged solve and the solution cropped back (the padding
    row is the identity, so the padded unknowns are exactly zero)."""

    inner: BTCoarseSolver
    n_dof: int  # real (unpadded) DoF count


def make_penta_coarse_solver(a) -> "PaddedBTCoarseSolver | BTCoarseSolver":
    """Cyclic-reduction factorization of a :class:`~.block_penta.BlockPenta`
    coarsest operator via pair-merging to block size ``2 bs``."""
    from .block_penta import bp5_pair_merge

    inner = make_bt_coarse_solver(bp5_pair_merge(a))
    if a.n_blocks % 2 == 0:
        return inner
    return PaddedBTCoarseSolver(inner=inner, n_dof=a.n_dof)


def coarse_solve(f, b: jax.Array) -> jax.Array:
    """Direct solve dispatch on the factorization type (flat vector in/out)."""
    if isinstance(f, PaddedBTCoarseSolver):
        pad = f.inner.a.n_dof - f.n_dof
        return _bt_solve(f.inner, jnp.pad(b, (0, pad)))[: f.n_dof]
    if isinstance(f, BTCoarseSolver):
        return _bt_solve(f, b)
    return _dense_solve(f, b)
