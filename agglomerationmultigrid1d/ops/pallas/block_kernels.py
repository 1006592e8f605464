"""Fused smoother kernels for the V-cycle's hot loop (Pallas, Triton route).

The V-cycle applies ``n_pre`` (= 3) smoother sweeps back to back on every
block level.  Each sweep is memory-bound, so these kernels fuse all the sweeps
into ONE pass over device memory: every program loads a window of the operator
streams once, iterates the sweeps on it in registers, and writes the centre of
the window (trapezoidal temporal blocking).  After sweep ``s`` only window
columns ``[s, W - s)`` are exact, so a halo of ``n_steps`` (+1 for the emitted
residual) columns per side keeps the written centre exact.

The sweeps run in *M-form*.  The block-Jacobi smoother ``S`` is exactly the
block diagonal of ``A`` (``S^-1 A_D = I``), so the damped sweep is

    x' = x + alpha S^-1 (b - A x) = x + alpha (c - x - ML x_{-1} - MU x_{+1}),

with ``c = S^-1 b`` (computed once per launch) and ``ML = S^-1 A_lower``,
``MU = S^-1 A_upper`` (precomputed at setup).  That reads three operator
streams instead of four and does half the block contractions.  The optional
restrict-side residual also reads ``A_D`` and uses
``A x = A_D (x + ML x_{-1} + MU x_{+1})``.

REQUIREMENT: ``s_inv`` must be the exact inverse of ``a.diag`` (what
``smoothers.dg_smoother(a, "blockJac")`` produces).  A mismatched
preconditioner would silently smooth with ``S = A_D``.

Layout on the card: a program owns ``tile = W - 2 * halo`` output columns and
loads a power-of-two window of ``W`` columns around them with masked loads at
an offset into the whole-array refs; nothing outside ``[0, n)`` is read.  The
bs x bs contractions are unrolled in registers.  Triton has no register shift,
so the +-1 neighbour columns of the updated iterate come from a per-program
scratch window in global memory (store, barrier, two shifted loads), which
stays in L1/L2 while the program runs.  That scratch is an extra output of
``(grid, bs, W + 2)`` f32, about 1.04 times the size of the iterate (70 MB at
bs = 4, n = 2^22; 419 MB at bs = 2, n = 3 * 2^24), allocated on every call;
what of it is written back to device memory is not measured.  Shard ghosts
(``ghosts=(gops, gvec)``) fill the window columns beyond ``[0, n)`` under
``shard_map``; without them those columns are zero, which is the global
zero-Dirichlet boundary.

Which inputs take the kernel and which take XLA is decided by
:func:`use_multisweep_kernel` alone; :func:`on_gpu` then sends the program to
the kernel where it is lowered for a GPU and to the XLA sweeps elsewhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..block_tridiag import BlockTridiag, block_mul

# Block sizes the kernel was measured at: the DG p = 1 / agglomerated p = 1
# levels (bs = 2) and the DG p = 3 level (bs = 4).  Others take XLA.
KERNEL_BLOCK_SIZES = (2, 4)
# Window width (power of two) and warps per program: one window column per
# thread.  Chosen on an H100 over W in {128..1024} x warps in {2..16} at both
# kernel shapes of ``chip_smoke.py`` phase 2 (W = 256 with 8 warps was the
# fastest or within 2% of it; 2-4x slower configurations spill registers).
WINDOW = 256
NUM_WARPS = 8


def use_multisweep_kernel(bs: int, n: int, dtype, min_blocks: int = 0) -> bool:
    """Whether a smoother pass on a ``(bs, n)`` level of ``dtype`` takes the
    fused kernel (True) or the plain XLA sweeps (False).  ``min_blocks`` is
    the caller's size threshold (the solvers' int ``use_pallas``)."""
    return jnp.dtype(dtype) == jnp.float32 and bs in KERNEL_BLOCK_SIZES and n >= min_blocks


def on_gpu(kernel, xla, *args, interpret: bool = False):
    """``kernel(*args)`` in a program lowered for an NVIDIA GPU, ``xla(*args)``
    on any other platform: the Triton kernel lowers only there.  The branch
    is picked when the program is lowered for its device, and the other one
    is dropped.  With ``interpret`` set (tests only) it always takes
    ``kernel``."""
    if interpret:
        return kernel(*args)
    return jax.lax.platform_dependent(*args, cuda=kernel, default=xla)


def kernel_halo(n_steps: int, emit_residual: bool) -> int:
    """Halo columns per side (and shard-ghost width) the fused pass needs."""
    return n_steps + (1 if emit_residual else 0)


def chebyshev_coefficients(lam_lo, lam_hi, degree: int):
    """(degree, 2) recurrence coefficients [c_d, c_z] for the classic Chebyshev
    smoother on [lam_lo, lam_hi] (traced scalars are fine)."""
    theta = 0.5 * (lam_hi + lam_lo)
    delta = 0.5 * (lam_hi - lam_lo)
    sigma = theta / delta
    rows = []
    rho = 1.0 / sigma
    rows.append(jnp.stack([jnp.zeros_like(theta), 1.0 / theta]))
    for _ in range(1, degree):
        rho_new = 1.0 / (2.0 * sigma - rho)
        rows.append(jnp.stack([rho_new * rho, 2.0 * rho_new / delta]))
        rho = rho_new
    return jnp.stack(rows).astype(jnp.float32)


def _mat(m, v):
    """``y[r] = sum_c m[r][c] * v[c]`` over lists of (W,) vectors."""
    out = []
    for row in m:
        acc = row[0] * v[0]
        for c in range(1, len(v)):
            acc = acc + row[c] * v[c]
        out.append(acc)
    return out


def _multisweep_kernel(*refs, bs, n, steps, alpha, halo, width, emit_residual,
                       chebyshev, ghosted, barrier):
    """One window: load the operator streams once, run ``steps`` M-form sweeps
    (damped Jacobi, or Chebyshev with ``coef``), write the centre columns.

    ``refs`` = [coef,] [gops, gvec,] ML, MU, S^-1 [, A_D], x, b, out [, res],
    scratch."""
    refs = list(refs)
    coef = refs.pop(0) if chebyshev else None
    gops, gvec = (refs.pop(0), refs.pop(0)) if ghosted else (None, None)
    n_ops = 4 if emit_residual else 3
    op_refs, (x_ref, b_ref), outs = refs[:n_ops], refs[n_ops:n_ops + 2], refs[n_ops + 2:]
    scratch = outs.pop()

    i = pl.program_id(0)
    tile = width - 2 * halo
    start = i * tile - halo
    j = jax.lax.broadcasted_iota(jnp.int32, (width,), 0)
    col = start + j
    inside = (col >= 0) & (col < n)
    left = (col < 0) & (col >= -halo)
    right = (col >= n) & (col < n + halo)

    def load(ref, idx, g_ref=None, g_idx=()):
        v = plgpu.load(ref.at[idx + (col,)], mask=inside, other=0.0)
        if g_ref is not None:
            # ghost columns: [0, halo) left neighbour, [halo, 2 halo) right
            v += plgpu.load(g_ref.at[g_idx + (col + halo,)], mask=left, other=0.0)
            v += plgpu.load(g_ref.at[g_idx + (col + halo - n,)], mask=right, other=0.0)
        return v

    def load_vec(ref, k):
        return [load(ref, (r,), gvec, (k, r)) for r in range(bs)]

    def load_op(ref, s):
        return [[load(ref, (r, c), gops, (s, r, c)) for c in range(bs)] for r in range(bs)]

    def shifted(v):
        """(v_{-1}, v_{+1}) across the window: zero beyond its ends."""
        # 32-bit starts: interpret mode discharges these with x64 on
        at = lambda r, k: scratch.at[i, r, pl.ds(jnp.int32(k), width)]  # noqa: E731
        for r in range(bs):
            plgpu.store(at(r, 1), v[r])
        barrier()
        vm = [plgpu.load(at(r, 0), mask=j >= 1, other=0.0) for r in range(bs)]
        vp = [plgpu.load(at(r, 2), mask=j < width - 1, other=0.0) for r in range(bs)]
        barrier()
        return vm, vp

    def offdiag(v):
        """``ML v_{-1} + MU v_{+1}``."""
        vm, vp = shifted(v)
        return [lo + up for lo, up in zip(_mat(ml, vm), _mat(mu, vp))]

    ml, mu, si = (load_op(op_refs[s], s) for s in range(3))
    x = load_vec(x_ref, 0)
    b = load_vec(b_ref, 1)
    c = _mat(si, b)
    if chebyshev:
        d = [jnp.zeros_like(v) for v in x]
        for s in range(steps):
            t = offdiag(x)
            cd, cz = coef[s, 0], coef[s, 1]
            d = [cd * d[r] + cz * (c[r] - x[r] - t[r]) for r in range(bs)]
            x = [x[r] + d[r] for r in range(bs)]
    else:
        for _ in range(steps):
            t = offdiag(x)
            x = [x[r] + alpha * (c[r] - x[r] - t[r]) for r in range(bs)]

    written = (j >= halo) & (j < width - halo) & (col < n)
    for r in range(bs):
        plgpu.store(outs[0].at[r, col], x[r], mask=written)
    if emit_residual:
        ad = load_op(op_refs[3], 3)
        t = offdiag(x)
        ax = _mat(ad, [x[r] + t[r] for r in range(bs)])
        for r in range(bs):
            plgpu.store(outs[1].at[r, col], b[r] - ax[r], mask=written)


def _mform_ops(a: BlockTridiag, s_inv: jax.Array, ml, mu):
    """``ML = S^-1 A_lower``, ``MU = S^-1 A_upper`` — precomputed at setup by
    ``smoothers.dg_smoother`` / ``hierarchy.prepare_fast_smoothers`` and passed
    through; computed here (one batched einsum each) only when a caller does
    not supply them."""
    if ml is None:
        ml = block_mul(s_inv, a.lower)
    if mu is None:
        mu = block_mul(s_inv, a.upper)
    return ml, mu


def _fused_pass(a, s_inv, x, b, *, steps, alpha, coef, emit_residual, ghosts,
                ml, mu, interpret):
    bs, _, n = a.diag.shape
    if x.dtype != jnp.float32 or bs & (bs - 1):
        raise ValueError(
            f"fused multisweep needs f32 and a power-of-two block size "
            f"(got dtype={x.dtype}, bs={bs}); route through use_multisweep_kernel"
        )
    halo = kernel_halo(steps, emit_residual)
    width = WINDOW
    tile = width - 2 * halo
    grid = pl.cdiv(n, tile)
    ml, mu = _mform_ops(a, s_inv, ml, mu)
    ops = (ml, mu, s_inv) + ((a.diag,) if emit_residual else ())
    args = ([coef] if coef is not None else []) + (list(ghosts) if ghosts else [])
    args += list(ops) + [x, b]
    vec = jax.ShapeDtypeStruct((bs, n), x.dtype)
    out_shape = [vec, vec] if emit_residual else [vec]
    out_shape.append(jax.ShapeDtypeStruct((grid, bs, width + 2), x.dtype))
    kernel = functools.partial(
        _multisweep_kernel, bs=bs, n=n, steps=steps, alpha=alpha, halo=halo,
        width=width, emit_residual=emit_residual, chebyshev=coef is not None,
        ghosted=ghosts is not None,
        # the interpreter runs programs one at a time: no block to synchronise
        barrier=(lambda: None) if interpret else plgpu.debug_barrier,
    )
    # traced with 32-bit defaults: the package enables x64, and 64-bit index
    # scalars beside the 32-bit program id do not lower
    with jax.enable_x64(False):
        res = pl.pallas_call(
            kernel,
            out_shape=out_shape,
            grid=(grid,),
            backend="triton",
            # no loop in the kernel, so nothing for software pipelining
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
            interpret=interpret,
            name="chebyshev_multisweep" if coef is not None else "jacobi_multisweep",
        )(*args)
    return (res[0], res[1]) if emit_residual else res[0]


@functools.partial(jax.jit, static_argnames=("degree", "interpret", "emit_residual"))
def pallas_chebyshev_multisweep(
    a: BlockTridiag, s_inv: jax.Array, x: jax.Array, b: jax.Array, coef: jax.Array,
    degree: int = 3, interpret: bool = False, emit_residual: bool = False,
    ghosts=None, ml=None, mu=None,
):
    """All ``degree`` Chebyshev smoothing steps fused into one pass (optionally
    also emitting ``r = b - A x_new``).  ``coef`` from
    :func:`chebyshev_coefficients`; ``s_inv`` must be the exact inverse of
    ``a.diag`` (M-form); ``ml``/``mu`` are the precomputed M-form streams.
    ``ghosts = (gops, gvec)`` supplies neighbour-shard columns under
    ``shard_map`` (see :mod:`..parallel.sharded_kernels`)."""
    return _fused_pass(
        a, s_inv, x, b, steps=degree, alpha=None, coef=coef,
        emit_residual=emit_residual, ghosts=ghosts, ml=ml, mu=mu, interpret=interpret,
    )


@functools.partial(jax.jit, static_argnames=("alpha", "n_sweeps", "interpret", "emit_residual"))
def pallas_block_jacobi_multisweep(
    a: BlockTridiag, s_inv: jax.Array, x: jax.Array, b: jax.Array,
    n_sweeps: int = 3, alpha: float = 2.0 / 3.0, interpret: bool = False,
    emit_residual: bool = False, ghosts=None, ml=None, mu=None,
):
    """``n_sweeps`` fused damped block-Jacobi sweeps in one pass, optionally
    also returning ``r = b - A x_new`` from the same pass (the V-cycle's
    restrict-side matvec).  ``s_inv``, ``ml``/``mu`` and ``ghosts`` as in
    :func:`pallas_chebyshev_multisweep`."""
    return _fused_pass(
        a, s_inv, x, b, steps=n_sweeps, alpha=alpha, coef=None,
        emit_residual=emit_residual, ghosts=ghosts, ml=ml, mu=mu, interpret=interpret,
    )
