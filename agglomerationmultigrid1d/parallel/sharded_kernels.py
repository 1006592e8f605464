"""Fused smoother sweeps *inside* ``jax.shard_map``.

Each device runs the temporally-blocked multisweep (``ops.pallas.block_kernels``)
on its local shard of an element-sharded block level, with real neighbour data:

1. exchange ``kernel_halo`` columns of x, b and the operator streams the
   kernel reads (M-form: ml, mu, s_inv [, diag]) with the two ring neighbours
   via ``lax.ppermute`` (devices without a source keep zeros — exactly the
   global boundary);
2. run the fused pass on the local shard with those ghosts, so the shard's
   columns are exact.

Where :func:`..ops.pallas.use_multisweep_kernel` sends the local shape to XLA
(f64 parity runs, block sizes the kernel does not take), and on any device
but a GPU (:func:`..ops.pallas.block_kernels.on_gpu`), the local function is
a halo-aware XLA sweep built on :func:`..parallel.halo.halo_shift` — the
same numerics without the fused pass.

The reference is a serial solver (no distributed code to mirror,
``SURVEY.md`` §2 "Parallelism strategies — NONE").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..ops.block_tridiag import BlockTridiag, block_mul
from ..ops.pallas import block_kernels
from ..ops.pallas.block_kernels import (
    kernel_halo,
    pallas_block_jacobi_multisweep,
    pallas_chebyshev_multisweep,
    use_multisweep_kernel,
)
from .halo import halo_shift


def _edge_ghosts(arr: jax.Array, axis: str, width: int) -> jax.Array:
    """(…, 2 * width): left neighbour's last ``width`` columns | right
    neighbour's first.  Ring-edge devices keep zero fill (= the global
    zero-Dirichlet boundary the kernels assume beyond the domain)."""
    n_dev = lax.axis_size(axis)
    to_right = [(i, i + 1) for i in range(n_dev - 1)]
    to_left = [(i, i - 1) for i in range(1, n_dev)]
    left = lax.ppermute(arr[..., -width:], axis, to_right)
    right = lax.ppermute(arr[..., :width], axis, to_left)
    return jnp.concatenate([left, right], axis=-1)


def _gather_ghosts(ops, x, b, axis, width):
    """Ghosts for exactly the operator streams the kernel reads."""
    gops = jnp.stack([_edge_ghosts(m, axis, width) for m in ops])
    gvec = jnp.stack([_edge_ghosts(x, axis, width), _edge_ghosts(b, axis, width)])
    return gops, gvec


def _halo_matvec(ad, al, au, x, axis):
    y = jnp.einsum("ijn,jn->in", ad, x)
    y = y + jnp.einsum("ijn,jn->in", al, halo_shift(x, -1, axis))
    y = y + jnp.einsum("ijn,jn->in", au, halo_shift(x, +1, axis))
    return y


def _local_smooth(
    coef, ad, al, au, binv, ml, mu, x, b,
    *, axis, steps, alpha, emit_residual, use_pallas, interpret,
):
    """One shard's fused pass (kernel with ghosts) or halo-aware XLA sweeps;
    ``coef`` given selects Chebyshev, else damped Jacobi with ``alpha``."""
    bs, n_local = x.shape
    xla = functools.partial(
        _local_smooth_xla, coef, ad, al, au, binv,
        axis=axis, steps=steps, alpha=alpha, emit_residual=emit_residual,
    )
    if not (use_pallas and use_multisweep_kernel(bs, n_local, x.dtype)):
        return xla(x, b)

    def kernel(x, b):
        ops = (ml, mu, binv) + ((ad,) if emit_residual else ())
        ghosts = _gather_ghosts(ops, x, b, axis, kernel_halo(steps, emit_residual))
        a = BlockTridiag(lower=al, diag=ad, upper=au)
        kw = dict(interpret=interpret, emit_residual=emit_residual, ghosts=ghosts,
                  ml=ml, mu=mu)
        if coef is not None:
            return pallas_chebyshev_multisweep(a, binv, x, b, coef, steps, **kw)
        return pallas_block_jacobi_multisweep(
            a, binv, x, b, n_sweeps=steps, alpha=alpha, **kw
        )

    return block_kernels.on_gpu(kernel, xla, x, b, interpret=interpret)


def _local_smooth_xla(coef, ad, al, au, binv, x, b, *, axis, steps, alpha, emit_residual):
    """Halo-aware XLA sweeps: the same numerics as the fused pass."""
    if coef is not None:
        cf = coef.astype(x.dtype)
        d = jnp.zeros_like(x)
        for s in range(steps):
            z = jnp.einsum("ijn,jn->in", binv, b - _halo_matvec(ad, al, au, x, axis))
            d = cf[s, 0] * d + cf[s, 1] * z
            x = x + d
    else:
        for _ in range(steps):
            r = b - _halo_matvec(ad, al, au, x, axis)
            x = x + alpha * jnp.einsum("ijn,jn->in", binv, r)
    if emit_residual:
        return x, b - _halo_matvec(ad, al, au, x, axis)
    return x


def _sharded_smooth(mesh, axis, a, s_inv, x, b, coef, *, steps, alpha,
                    emit_residual, use_pallas, interpret, ml, mu):
    if use_pallas and x.dtype == jnp.float32:
        ml = block_mul(s_inv, a.lower) if ml is None else ml
        mu = block_mul(s_inv, a.upper) if mu is None else mu
    else:
        # paths that never take the kernel get inert aliases: shard_map needs
        # array args, and an alias of ``a.diag`` costs no memory or traffic
        ml = a.diag if ml is None else ml
        mu = a.diag if mu is None else mu
    if coef is None:
        coef = jnp.zeros((steps, 2), jnp.float32)
        cheb = False
    else:
        cheb = True
    m = P(None, None, axis)
    v = P(None, axis)

    def fn(cf, *arrs):
        return _local_smooth(
            cf if cheb else None, *arrs, axis=axis, steps=steps, alpha=alpha,
            emit_residual=emit_residual, use_pallas=use_pallas, interpret=interpret,
        )

    return jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(None, None), m, m, m, m, m, m, v, v),
        out_specs=(v, v) if emit_residual else v,
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )(coef, a.diag, a.lower, a.upper, s_inv, ml, mu, x, b)


def sharded_multisweep(
    mesh, axis: str, a: BlockTridiag, s_inv: jax.Array, x: jax.Array, b: jax.Array,
    *, n_sweeps: int = 3, alpha: float = 2.0 / 3.0, emit_residual: bool = False,
    use_pallas: bool = True, interpret: bool = False, ml=None, mu=None,
):
    """``n_sweeps`` fused damped block-Jacobi sweeps on an element-sharded
    operator: the fused pass per shard plus one ``kernel_halo``-column
    ppermute ghost exchange per side (optionally also emitting
    ``r = b - A x_new``).  ``ml``/``mu`` are the setup-time M-form streams
    (``S^-1 A_lower/upper``); computed here (sharded, elementwise — no
    communication) when not supplied."""
    return _sharded_smooth(
        mesh, axis, a, s_inv, x, b, None, steps=n_sweeps, alpha=alpha,
        emit_residual=emit_residual, use_pallas=use_pallas, interpret=interpret,
        ml=ml, mu=mu,
    )


def sharded_chebyshev_multisweep(
    mesh, axis: str, a: BlockTridiag, s_inv: jax.Array, x: jax.Array, b: jax.Array,
    coef: jax.Array, *, degree: int = 3, emit_residual: bool = False,
    use_pallas: bool = True, interpret: bool = False, ml=None, mu=None,
):
    """Degree-``degree`` Chebyshev smoothing, sharded (see
    :func:`sharded_multisweep`)."""
    return _sharded_smooth(
        mesh, axis, a, s_inv, x, b, coef, steps=degree, alpha=None,
        emit_residual=emit_residual, use_pallas=use_pallas, interpret=interpret,
        ml=ml, mu=mu,
    )
