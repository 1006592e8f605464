"""Multigrid V-cycle and outer drivers (counterpart of ``src/solvers.jl``).

The V-cycle (``solvers.jl:19-50``) is a pure jittable function: the level count
and all shapes are static, so the cycle unrolls into one fused XLA program.  The
outer ``multigrid`` driver (``solvers.jl:116-139``) runs a ``lax.while_loop``
with a device-side convergence check and fixed-length masked residual / error
histories, preserving the reference's observability contract
``(x, iter, res, err)``.
"""

from __future__ import annotations

import functools

import numpy as np
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.block_penta import BlockPenta, bp5_matvec
from ..ops.block_coo import BlockCOO, bcoo_matvec
from ..ops.block_tridiag import BlockTridiag, bt_matvec
from ..ops.cg_operator import cg_matvec
from ..ops.coarse_solve import coarse_solve
from ..ops.transfer_ops import (
    BlockProlong,
    CgProlong,
    RaggedBlockProlong,
    SeamProlong,
    bp_prolong,
    bp_restrict,
    cgp_prolong,
    cgp_restrict,
    rbp_prolong,
    rbp_restrict,
    seam_prolong,
    seam_restrict,
)
from ..transfer.scattered_transfer import ScatteredProlong, sp_prolong, sp_restrict
from ..smoothers.smoother import apply_smoother
from .hierarchy import BlockLevel, CgLevel, Hierarchy


def _is_slim_bt(level) -> bool:
    """A "slim" fine level (XL stencil setup): the BlockTridiag carries only
    its diagonal; the off-diagonal action lives in the smoother's M-form
    streams (``A = D (I + ML_shift + MU_shift)`` since ``ML = D^-1 L``)."""
    return (
        isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and level.a.lower.size == 0
        and level.a.diag.size > 0
    )


def _mform_matvec(level, x):
    """``A x = D (x + ML x_- + MU x_+)`` from the M-form smoother streams.

    Exact up to one f32 rounding of the off-diagonal terms (ML/MU are
    rounded products) — used only where the solver needs an approximate
    residual magnitude (inner-cycle stall detection); the trustworthy defect
    always comes from the float-float stencil operator (``ops.df64``)."""
    from ..smoothers.smoother import ChebyshevSmoother

    from ..ops.shifts import shift

    s = level.smoother
    base = s.base if isinstance(s, ChebyshevSmoother) else s
    xm, xp = shift(x, -1), shift(x, +1)
    t = x + jnp.einsum("ijn,jn->in", base.ml, xm) + jnp.einsum("ijn,jn->in", base.mu, xp)
    return jnp.einsum("ijn,jn->in", level.a.diag, t)


def level_matvec(level, x):
    if isinstance(level, CgLevel):
        return cg_matvec(level.a, x)
    if isinstance(level.a, BlockPenta):
        return bp5_matvec(level.a, x)
    if isinstance(level.a, BlockCOO):
        return bcoo_matvec(level.a, x)
    if _is_slim_bt(level):
        return _mform_matvec(level, x)
    return bt_matvec(level.a, x)


def transfer_prolong(l, xc):
    if isinstance(l, CgProlong):
        return cgp_prolong(l, xc)
    if isinstance(l, BlockProlong):
        return bp_prolong(l, xc)
    if isinstance(l, RaggedBlockProlong):
        return rbp_prolong(l, xc)
    if isinstance(l, SeamProlong):
        return seam_prolong(l, xc)
    if isinstance(l, ScatteredProlong):
        return sp_prolong(l, xc)
    raise TypeError(type(l))


def transfer_restrict(l, rf):
    if isinstance(l, CgProlong):
        return cgp_restrict(l, rf)
    if isinstance(l, BlockProlong):
        return bp_restrict(l, rf)
    if isinstance(l, RaggedBlockProlong):
        return rbp_restrict(l, rf)
    if isinstance(l, SeamProlong):
        return seam_restrict(l, rf)
    if isinstance(l, ScatteredProlong):
        return sp_restrict(l, rf)
    raise TypeError(type(l))


def _flatten_level_vec(x):
    """Level vector -> flat DoF vector (block levels: dof = k * bs + i)."""
    if x.ndim == 1:
        return x
    return x.T.reshape(-1)


def _crop_cg(level, x):
    """Strip the inert ghost padding of an element-sharded CG level's vector
    before it crosses a level boundary (transfers expect real node counts)."""
    if isinstance(level, CgLevel) and x.shape[0] != level.a.n_nodes:
        return x[: level.a.n_nodes]
    return x


def _pad_cg(level, x):
    """Re-apply the level's ghost padding (zeros) after a transfer."""
    if isinstance(level, CgLevel):
        n_pad = level.a.n_nodes_padded
        if x.shape[0] != n_pad:
            return jnp.pad(x, (0, n_pad - x.shape[0]))
    return x


def _unflatten_level_vec(flat, like):
    if like.ndim == 1:
        return flat
    bs, n = like.shape
    return flat.reshape(n, bs).T


# Levels with fewer blocks than this take the XLA einsum path even when
# ``use_pallas=True``.  Prefer passing an INT as ``use_pallas`` (below) over
# mutating this module global: the global is read at trace time, so
# already-compiled jit programs (keyed on shapes + statics only) silently keep
# their old on/off decision after a mutation.
PALLAS_MIN_BLOCKS = 0


def _pallas_threshold(use_pallas) -> int:
    """``use_pallas`` may be an int ``k >= 1``: Pallas kernels only on levels
    with at least ``k`` blocks.  Being a static jit argument everywhere, an
    int threshold is part of every cache key — unlike ``PALLAS_MIN_BLOCKS``,
    which callers would have to pair with a jax-cache clear when changed."""
    if isinstance(use_pallas, bool):
        return PALLAS_MIN_BLOCKS
    return int(use_pallas)


def _shard_use_pallas(u, use_pallas) -> bool:
    """The bool the shard_map kernels receive: an int ``use_pallas`` gates on
    the level's (global) block count like the single-device path."""
    if isinstance(use_pallas, bool):
        return use_pallas
    return u.shape[-1] >= _pallas_threshold(use_pallas)


def _fused_smooth_ok(level, u, use_pallas, smoother_base):
    """Whether this level's smoothing takes the fused multisweep kernel: the
    caller asked for it, the level is a block-Jacobi block-tridiagonal level,
    and :func:`..ops.pallas.use_multisweep_kernel` accepts its shape."""
    from ..ops.pallas import use_multisweep_kernel
    from ..smoothers.smoother import BlockJacobiSmoother

    return bool(
        use_pallas
        and isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and isinstance(smoother_base, BlockJacobiSmoother)
        and use_multisweep_kernel(
            u.shape[0], u.shape[-1], u.dtype, _pallas_threshold(use_pallas)
        )
    )


def _pallas_smooth_ok(level, u, use_pallas):
    return _fused_smooth_ok(level, u, use_pallas, level.smoother)


def _cheb_pallas_ok(level, u, use_pallas):
    return _fused_smooth_ok(level, u, use_pallas, level.smoother.base)


def _cheb_ok_safe(level, u, use_pallas):
    """:func:`_cheb_pallas_ok` guarded on the smoother actually being a
    ChebyshevSmoother (it dereferences ``smoother.base``)."""
    from ..smoothers.smoother import ChebyshevSmoother

    return isinstance(
        getattr(level, "smoother", None), ChebyshevSmoother
    ) and _cheb_pallas_ok(level, u, use_pallas)


def _smooth_cheb(level, u, rhs, degree, use_pallas, emit_residual=False, shard=None):
    """Degree-``degree`` Chebyshev smoothing (see ChebyshevSmoother): the
    classic three-term recurrence on the preconditioned residual, one matvec +
    one base-smoother application per degree — identical per-step cost to a
    damped sweep, far stronger damping on [lam_lo, lam_hi].

    On f32 block levels all degrees (and optionally the restrict-side
    residual) fuse into ONE temporally-blocked kernel pass; with
    ``shard = (mesh, axis)`` that pass runs per shard inside ``shard_map``
    with ppermute halo exchange (``parallel.sharded_kernels``)."""
    from ..smoothers.smoother import BlockJacobiSmoother

    s = level.smoother
    if (
        shard is not None
        and isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and isinstance(s.base, BlockJacobiSmoother)
    ):
        from ..ops.pallas import chebyshev_coefficients
        from ..parallel.sharded_kernels import sharded_chebyshev_multisweep

        coef = chebyshev_coefficients(s.lam_lo, s.lam_hi, degree)
        return sharded_chebyshev_multisweep(
            shard[0], shard[1], level.a, s.base.inv, u, rhs, coef,
            degree=degree, emit_residual=emit_residual,
            use_pallas=_shard_use_pallas(u, use_pallas),
            ml=s.base.ml, mu=s.base.mu,
        )
    if _cheb_pallas_ok(level, u, use_pallas):
        from ..ops.pallas import chebyshev_coefficients, pallas_chebyshev_multisweep
        from ..ops.pallas.block_kernels import on_gpu

        coef = chebyshev_coefficients(s.lam_lo, s.lam_hi, degree)
        return on_gpu(
            lambda u, rhs: pallas_chebyshev_multisweep(
                level.a, s.base.inv, u, rhs, coef, degree, emit_residual=emit_residual,
                ml=s.base.ml, mu=s.base.mu,
            ),
            lambda u, rhs: _cheb_xla(level, u, rhs, degree, emit_residual),
            u, rhs,
        )
    return _cheb_xla(level, u, rhs, degree, emit_residual)


def _cheb_xla(level, u, rhs, degree, emit_residual):
    """The plain XLA Chebyshev recurrence of :func:`_smooth_cheb`."""
    s = level.smoother
    theta = 0.5 * (s.lam_hi + s.lam_lo)
    delta = 0.5 * (s.lam_hi - s.lam_lo)
    sigma = theta / delta
    rho = 1.0 / sigma

    z = apply_smoother(s.base, rhs - level_matvec(level, u))
    d = z / theta
    u = u + d
    for _ in range(1, degree):
        z = apply_smoother(s.base, rhs - level_matvec(level, u))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        u = u + d
        rho = rho_new
    if emit_residual:
        return u, rhs - level_matvec(level, u)
    return u


def _smooth_n(level, u, rhs, n_sweeps, alpha, use_pallas, shard=None):
    """``n_sweeps`` damped smoother applications ``u += alpha S (rhs - A u)``.

    On block levels the kernel route accepts (see :func:`_fused_smooth_ok`),
    all sweeps fuse into ONE temporally-blocked pass over device memory.  A
    ChebyshevSmoother level instead runs the degree-``n_sweeps`` Chebyshev recurrence (``alpha`` is
    ignored — damping is built into the polynomial).  ``shard = (mesh, axis)``
    routes an element-sharded block level through the shard_map kernels."""
    from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother

    if isinstance(level.smoother, ChebyshevSmoother):
        return _smooth_cheb(level, u, rhs, n_sweeps, use_pallas, shard=shard)
    if (
        shard is not None
        and isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and isinstance(level.smoother, BlockJacobiSmoother)
    ):
        from ..parallel.sharded_kernels import sharded_multisweep

        return sharded_multisweep(
            shard[0], shard[1], level.a, level.smoother.inv, u, rhs,
            n_sweeps=n_sweeps, alpha=alpha,
            use_pallas=_shard_use_pallas(u, use_pallas),
            ml=level.smoother.ml, mu=level.smoother.mu,
        )
    if _pallas_smooth_ok(level, u, use_pallas):
        from ..ops.pallas import pallas_block_jacobi_multisweep
        from ..ops.pallas.block_kernels import on_gpu

        return on_gpu(
            lambda u, rhs: pallas_block_jacobi_multisweep(
                level.a, level.smoother.inv, u, rhs, n_sweeps=n_sweeps, alpha=alpha,
                ml=level.smoother.ml, mu=level.smoother.mu,
            ),
            lambda u, rhs: _sweeps_xla(level, u, rhs, n_sweeps, alpha),
            u, rhs,
        )
    return _sweeps_xla(level, u, rhs, n_sweeps, alpha)


def _sweeps_xla(level, u, rhs, n_sweeps, alpha):
    for _ in range(n_sweeps):
        u = u + apply_smoother(level.smoother, rhs - level_matvec(level, u), alpha=alpha)
    return u


def _smooth_n_residual(level, u, rhs, n_sweeps, alpha, use_pallas, shard=None):
    """``_smooth_n`` fused with the post-smoothing residual ``rhs - A u``
    (one pass on the kernel path — the restrict-side matvec is free)."""
    from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother

    if isinstance(level.smoother, ChebyshevSmoother):
        return _smooth_cheb(
            level, u, rhs, n_sweeps, use_pallas, emit_residual=True, shard=shard
        )
    if (
        shard is not None
        and isinstance(level, BlockLevel)
        and isinstance(level.a, BlockTridiag)
        and isinstance(level.smoother, BlockJacobiSmoother)
    ):
        from ..parallel.sharded_kernels import sharded_multisweep

        return sharded_multisweep(
            shard[0], shard[1], level.a, level.smoother.inv, u, rhs,
            n_sweeps=n_sweeps, alpha=alpha, emit_residual=True,
            use_pallas=_shard_use_pallas(u, use_pallas),
            ml=level.smoother.ml, mu=level.smoother.mu,
        )
    if _pallas_smooth_ok(level, u, use_pallas):
        from ..ops.pallas import pallas_block_jacobi_multisweep
        from ..ops.pallas.block_kernels import on_gpu

        def xla(u, rhs):
            u = _sweeps_xla(level, u, rhs, n_sweeps, alpha)
            return u, rhs - level_matvec(level, u)

        return on_gpu(
            lambda u, rhs: pallas_block_jacobi_multisweep(
                level.a, level.smoother.inv, u, rhs, n_sweeps=n_sweeps, alpha=alpha,
                emit_residual=True, ml=level.smoother.ml, mu=level.smoother.mu,
            ),
            xla, u, rhs,
        )
    u = _smooth_n(level, u, rhs, n_sweeps, alpha, use_pallas)
    return u, rhs - level_matvec(level, u)


def v_cycle(
    h: Hierarchy,
    x0: jax.Array,
    b: jax.Array,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    use_pallas: bool = False,
    shard=None,
) -> jax.Array:
    """One multigrid V-cycle (cf. ``solvers.jl:19-50``).

    ``shard = (mesh, axis_name, per_level_sharded_flags)`` (static) routes the
    flagged block levels' smoothing through the shard_map fused kernels with
    ppermute halo exchange; everything else (transfers, CG levels, coarse
    solve) stays on XLA's automatic SPMD partitioning.
    """
    n = h.n_levels
    u = [None] * n
    rhs = [None] * n
    u[0], rhs[0] = x0, b

    def _lvl_shard(k):
        return (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None

    for k in range(n - 1):
        level = h.levels[k]
        if k > 0:
            u[k] = jnp.zeros_like(rhs[k])
        u[k], r_k = _smooth_n_residual(
            level, u[k], rhs[k], n_pre, alpha, use_pallas, shard=_lvl_shard(k)
        )
        rhs[k + 1] = _pad_cg(
            h.levels[k + 1], transfer_restrict(h.transfers[k], _crop_cg(level, r_k))
        )

    # coarsest level: replicated dense direct solve (cf. solvers.jl:39)
    flat = _flatten_level_vec(rhs[n - 1])
    u[n - 1] = _unflatten_level_vec(coarse_solve(h.coarse, flat), rhs[n - 1])

    for k in range(n - 2, -1, -1):
        level = h.levels[k]
        corr = transfer_prolong(h.transfers[k], _crop_cg(h.levels[k + 1], u[k + 1]))
        u[k] = u[k] + _pad_cg(level, corr)
        u[k] = _smooth_n(level, u[k], rhs[k], n_post, alpha, use_pallas, shard=_lvl_shard(k))
    return u[0]


def mg_preconditioner(h: Hierarchy, b: jax.Array, **kw) -> jax.Array:
    """One V-cycle from a zero initial guess (the reference's ``ldiv!`` interface,
    ``solvers.jl:63-92``)."""
    return v_cycle(h, jnp.zeros_like(b), b, **kw)


class MultigridResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array  # scalar int
    res_history: jax.Array  # (maxiter,), NaN beyond `iterations`
    err_history: jax.Array  # (maxiter,), NaN beyond `iterations` (or all-NaN)
    inner_cycles: jax.Array | None = None  # mixed solver: total f32 V-cycles run


def _dense_fine_solve(h: Hierarchy, b: jax.Array) -> jax.Array:
    """Host-side banded direct solve of the finest operator (the reference's
    ``u_exact = A \\ b``, ``solvers.jl:120``, which pays a *sparse* LU).  Every
    fine operator here is scalar-banded, so this is O(n p^2) LAPACK dgbsv on
    the host — observability-only, never the hot path."""
    import numpy as np

    from ..ops.banded_solve import fine_direct_solve

    fine = h.levels[0]
    sol = fine_direct_solve(fine, np.asarray(_flatten_level_vec(_crop_cg(fine, b))))
    return _pad_cg(fine, jnp.asarray(sol))


def multigrid(
    h: Hierarchy,
    x0: jax.Array,
    b: jax.Array,
    maxiter: int = 100,
    tol: float = 1e-10,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    compute_error: bool = True,
    use_pallas: bool = False,
    shard=None,
) -> MultigridResult:
    """Outer V-cycle iteration until ``||Ax - b|| < tol * ||b||`` (``solvers.jl:116-139``).

    ``err_history`` tracks ``||x - A^-1 b||`` against a dense direct solve of the
    finest operator, like the reference; disable via ``compute_error`` for large
    problems (the reference has no such guard — it always pays the sparse solve).
    ``shard`` as in :func:`v_cycle` (``parallel.distributed.fused_shard_spec``).
    """
    u_exact = _dense_fine_solve(h, b) if compute_error else None
    return _multigrid_loop(
        h, x0, b, u_exact, maxiter=maxiter, tol=tol, n_pre=n_pre, n_post=n_post,
        alpha=alpha, use_pallas=use_pallas, shard=shard,
    )


@functools.partial(
    jax.jit, static_argnames=("maxiter", "n_pre", "n_post", "alpha", "use_pallas", "shard")
)
def _multigrid_loop(
    h: Hierarchy,
    x0: jax.Array,
    b: jax.Array,
    u_exact,
    *,
    maxiter: int,
    tol,
    n_pre: int,
    n_post: int,
    alpha: float,
    use_pallas: bool = False,
    shard=None,
) -> MultigridResult:
    fine = h.levels[0]
    norm_b = jnp.linalg.norm(_flatten_level_vec(b))
    nan = jnp.full((maxiter,), jnp.nan, dtype=norm_b.dtype)

    def body(state):
        x, i, res_h, err_h, _ = state
        x = v_cycle(
            h, x, b, n_pre=n_pre, n_post=n_post, alpha=alpha,
            use_pallas=use_pallas, shard=shard,
        )
        res = jnp.linalg.norm(_flatten_level_vec(level_matvec(fine, x) - b))
        res_h = res_h.at[i].set(res)
        if u_exact is not None:
            err_h = err_h.at[i].set(jnp.linalg.norm(_flatten_level_vec(x) - u_exact))
        converged = res < tol * norm_b
        return x, i + 1, res_h, err_h, converged

    def cond(state):
        _, i, _, _, converged = state
        return jnp.logical_and(i < maxiter, jnp.logical_not(converged))

    x, it, res_h, err_h, _ = jax.lax.while_loop(
        cond, body, (x0, jnp.array(0), nan, nan, jnp.array(False))
    )
    return MultigridResult(x=x, iterations=it, res_history=res_h, err_history=err_h)


def iterative_smoother_solve(
    level,
    x0: jax.Array,
    b: jax.Array,
    *,
    maxiter: int = 1000,
    tol: float = 1e-6,
    alpha: float = 1.0,
) -> MultigridResult:
    """Pure Richardson-with-smoother iteration (``solvers.jl:189-213``)."""
    import numpy as np

    from ..ops.banded_solve import fine_direct_solve

    u_exact = jnp.asarray(fine_direct_solve(level, np.asarray(_flatten_level_vec(b))))
    norm_b = jnp.linalg.norm(_flatten_level_vec(b))
    nan = jnp.full((maxiter,), jnp.nan, dtype=norm_b.dtype)

    def body(state):
        x, i, res_h, err_h, _ = state
        x = x + apply_smoother(level.smoother, b - level_matvec(level, x), alpha=alpha)
        res = jnp.linalg.norm(_flatten_level_vec(level_matvec(level, x) - b))
        res_h = res_h.at[i].set(res)
        err_h = err_h.at[i].set(jnp.linalg.norm(_flatten_level_vec(x) - u_exact))
        return x, i + 1, res_h, err_h, res < tol * norm_b

    def cond(state):
        _, i, _, _, converged = state
        return jnp.logical_and(i < maxiter, jnp.logical_not(converged))

    x, it, res_h, err_h, _ = jax.lax.while_loop(
        cond, body, (x0, jnp.array(0), nan, nan, jnp.array(False))
    )
    return MultigridResult(x=x, iterations=it, res_history=res_h, err_history=err_h)


# ---------------------------------------------------------------------------
# Mixed precision: f32 fast-path V-cycle inside an f64 defect-correction loop
# ---------------------------------------------------------------------------


def _ff_split_level(lv):
    """Level operator -> float-float representation (CG band / tridiag / penta)."""
    from ..ops.df64 import bp5_split, bt_split, cg_band_split

    if isinstance(lv, CgLevel):
        return cg_band_split(lv.a.band)
    if isinstance(lv.a, BlockPenta):
        return bp5_split(lv.a)
    return bt_split(lv.a)


def make_low_precision_hierarchy(h: Hierarchy, dtype=jnp.float32) -> Hierarchy:
    """Cast a hierarchy for use as the inner preconditioner of
    :func:`multigrid_mixed` (see ``utils.precision``), and populate the cached
    M-form smoother streams the fused smoother kernels read
    (:func:`..models.hierarchy.prepare_fast_smoothers`)."""
    from ..utils.precision import hierarchy_astype
    from .hierarchy import prepare_fast_smoothers

    hl = hierarchy_astype(h, dtype)
    if dtype == jnp.float32:
        hl = prepare_fast_smoothers(hl)
    return hl


@jax.jit
def _mixed_defect(fine, x, b):
    r = b - level_matvec(fine, x)
    return r, jnp.linalg.norm(_flatten_level_vec(r))


@jax.jit
def _ff_defect(a_ff, x_ff, b_ff):
    """Float-float defect + f64 norm (one f32-speed fused pass; see ops.df64)."""
    from ..ops.df64 import ff_bt_defect, ff_norm

    r_ff = ff_bt_defect(a_ff, x_ff, b_ff)
    return r_ff, ff_norm(r_ff)


@jax.jit
def _ff_update(x_ff, e):
    from ..ops.df64 import FF, ff_add

    return ff_add(x_ff, FF(e, jnp.zeros_like(e)))


@functools.partial(
    jax.jit,
    static_argnames=(
        "maxiter", "max_inner", "n_pre", "n_post", "alpha", "use_pallas", "shard"
    ),
)
def _mixed_loop_ff(
    h_low,
    a_ff,
    x_ff,
    b_ff,
    inv_norm_b,
    *,
    maxiter,
    tol,
    inner_tol,
    max_inner,
    n_pre,
    n_post,
    alpha,
    use_pallas,
    shard=None,
):
    """The whole mixed-precision refinement as ONE on-device program.

    Everything is f32 (the f64-accuracy defect runs in float-float arithmetic),
    so the loop compiles quickly and runs with zero host round trips per
    iteration.

    The outer loop is *guarded* refinement: each proposed correction is
    evaluated against the trustworthy float-float defect, and corrections that
    grow the residual are rolled back (the f32 V-cycle is not a contraction for
    severely ill-conditioned fine operators, and at cond(A) >~ 1/eps_f32 the
    inner f32 residual measurements are pure noise — only the outer ff defect
    can arbitrate).  Rejected steps retry from the best iterate with a halved
    correction and a single inner cycle; three consecutive rejections end the
    iteration at the best iterate found.

    Returns ``(x_ff, outer, cycles, res_history_scaled)`` where the history
    holds the best ``||r|| / ||b||`` (f32) per outer step.
    """
    from ..ops.df64 import FF, ff_add, ff_defect

    kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard)
    nan32 = jnp.full((maxiter,), jnp.nan, dtype=jnp.float32)
    tol32 = jnp.asarray(tol, jnp.float32)
    it32 = jnp.asarray(inner_tol, jnp.float32)
    big32 = jnp.asarray(jnp.finfo(jnp.float32).max, jnp.float32)

    def rel_defect(x_ff):
        r_ff = ff_defect(a_ff, x_ff, b_ff)
        # relative norm from the hi part only: the check needs ~3 digits, lo
        # is 1e-7 relative; pre-scaling keeps squares in f32 range
        rs = jnp.linalg.norm(_flatten_level_vec(r_ff.hi) * inv_norm_b)
        return r_ff, rs

    def tree_where(c, new, old):
        return jax.tree_util.tree_map(lambda a, b: jnp.where(c, a, b), new, old)

    def body(state):
        x_cur, x_best, r_best, rel_best, i, cycles, limit, streak, res_h, _ = state

        # evaluate the previous proposal against the f64-accurate defect
        r_ff, rel = rel_defect(x_cur)
        improved = rel < rel_best
        x_best = tree_where(improved, x_cur, x_best)
        r_best = tree_where(improved, r_ff, r_best)
        rel_best = jnp.minimum(rel, rel_best)
        streak = jnp.where(improved, 0, streak + 1)
        res_h = jax.lax.cond(
            i > 0, lambda h: h.at[i - 1].set(rel_best), lambda h: h, res_h
        )
        done = (rel_best < tol32) | (streak >= 3) | (cycles >= maxiter)

        # next proposal, from the best iterate; rejected steps retry with a
        # single inner cycle and a damped correction
        probe = jnp.where(jnp.equal(jnp.remainder(i, 4), 0) & improved, 1, 0)
        cap = jnp.minimum(jnp.where(improved, limit, 1) + probe, max_inner)
        e, n_cyc, i_best = _mixed_inner_solve(h_low, r_best.hi, it32, cap, **kw)
        scale = jnp.where(streak > 0, 0.5**streak, 1.0).astype(e.dtype)
        x_new = ff_add(x_best, FF(scale * e, jnp.zeros_like(e)))

        # freeze once done (the loop still executes this body iteration)
        x_cur = tree_where(done, x_cur, x_new)
        cycles = jnp.where(done, cycles, cycles + n_cyc)
        limit = jnp.where(done | ~improved, jnp.maximum(limit, 1), jnp.maximum(1, i_best))
        i = jnp.where(done, i, i + 1)
        return x_cur, x_best, r_best, rel_best, i, cycles, limit, streak, res_h, done

    def cond(state):
        i, done = state[4], state[-1]
        return jnp.logical_and(i < maxiter, jnp.logical_not(done))

    zeros_r = jax.tree_util.tree_map(jnp.zeros_like, x_ff)
    state = (
        x_ff, x_ff, zeros_r, big32,
        jnp.array(0), jnp.array(0), jnp.array(max_inner), jnp.array(0),
        nan32, jnp.array(False),
    )
    x_cur, x_best, _, rel_best, outer, cycles, _, _, res_h, _ = jax.lax.while_loop(
        cond, body, state
    )
    # the final proposal may beat the recorded best; keep whichever is better
    _, rel_last = rel_defect(x_cur)
    final_better = rel_last < rel_best
    x_out = tree_where(final_better, x_cur, x_best)
    rel_out = jnp.minimum(rel_last, rel_best)
    res_h = jax.lax.cond(
        outer > 0, lambda h: h.at[outer - 1].set(rel_out), lambda h: h, res_h
    )
    return x_out, outer, cycles, res_h


@functools.partial(
    jax.jit, static_argnames=("n_pre", "n_post", "alpha", "use_pallas", "shard")
)
def _mixed_inner_solve(
    h_low, r, inner_tol, max_cycles, *, n_pre, n_post, alpha, use_pallas, shard=None
):
    """Solve the correction equation ``A e = r`` in low precision: V-cycles until
    the inner residual drops below ``inner_tol * ||r||`` (~f32 accuracy), stops
    contracting, or hits ``max_cycles``.  Returns ``(e_best, n_cycles)``.

    For well-conditioned levels this converges the correction to f32 accuracy so
    each outer f64 defect gains several digits.  For severely ill-conditioned
    operators (penalty terms ~ CDir n make cond(A) >~ 1/eps_f32) the f32
    iteration is *unstable* — rounding noise injected per cycle is amplified —
    so the loop detects growth immediately and returns the best iterate seen,
    degenerating gracefully to classic one-V-cycle-per-defect correction.

    One f32 matvec per cycle for the device-side check; the whole loop is a
    single f32-only module."""
    fine = h_low.levels[0]
    norm_r = jnp.linalg.norm(_flatten_level_vec(r))

    def body(state):
        e, best_e, best_res, best_i, i, res, _ = state
        e = v_cycle(
            h_low, e, r, n_pre=n_pre, n_post=n_post, alpha=alpha,
            use_pallas=use_pallas, shard=shard,
        )
        new = jnp.linalg.norm(_flatten_level_vec(r - level_matvec(fine, e)))
        better = new < best_res
        best_e = jnp.where(better, e, best_e)
        best_res = jnp.where(better, new, best_res)
        best_i = jnp.where(better, i + 1, best_i)
        return e, best_e, best_res, best_i, i + 1, new, res

    def cond(state):
        _, _, _, _, i, res, prev = state
        converged = res < inner_tol * norm_r
        # f32 noise floor / instability: once a cycle stops contracting the
        # (f32-measured) residual, further low-precision cycles are wasted —
        # return to the outer loop for a fresh f64 defect instead.
        stalled = res > 0.7 * prev
        return jnp.logical_and(i < max_cycles, ~jnp.logical_or(converged, stalled))

    big = jnp.array(jnp.finfo(norm_r.dtype).max, norm_r.dtype)
    z = jnp.zeros_like(r)
    _, e_best, _, i_best, n_cycles, _, _ = jax.lax.while_loop(
        cond, body, (z, z, big, jnp.array(0), jnp.array(0), norm_r, big)
    )
    return e_best, n_cycles, i_best


@jax.jit
def _mixed_update(x, e):
    return x + e.astype(x.dtype)


@functools.partial(
    jax.jit, static_argnames=("n_pre", "n_post", "alpha", "use_pallas", "shard")
)
def _inner_cycle_step(
    h_low, e, r, *, n_pre, n_post, alpha, use_pallas, shard=None
):
    """One f32 V-cycle on the correction equation plus the residual norm —
    the per-cycle unit of :func:`_mixed_inner_solve_eager` (no ``while_loop``
    in the module; see that function's rationale)."""
    fine = h_low.levels[0]
    e = v_cycle(
        h_low, e, r, n_pre=n_pre, n_post=n_post, alpha=alpha,
        use_pallas=use_pallas, shard=shard,
    )
    res = jnp.linalg.norm(_flatten_level_vec(r - level_matvec(fine, e)))
    return e, res


# --- split V-cycle: per-level programs around a fused coarse tail ----------
#
# The split form keeps each compiled unit small at the 1e8-DoF north-star
# size, where the whole-V-cycle module is one very large compile.  The V-cycle
# decomposes naturally: the fine level holds ~97% of the work but is only 3
# program stages (pre-smooth+restrict, coarse correction, prolong+post-smooth),
# and the rest of the hierarchy is a V-cycle on a problem ``agg_factor``x
# smaller.  ``eager_cut = c`` compiles levels ``0..c-1`` as per-level pre/post
# programs and the tail (levels ``c..end``) as ONE fused module.  Identical
# arithmetic to the fused cycle (the level boundary only forces
# materialization XLA would not have fused across anyway).  Whether XLA:GPU
# needs the split at all is open (ROADMAP, split-program V-cycle).


@functools.partial(
    jax.jit, static_argnames=("k", "zero_init", "n_pre", "alpha", "use_pallas", "shard")
)
def _level_pre_program(h, u, rhs, *, k, zero_init, n_pre, alpha, use_pallas, shard=None):
    """Level ``k`` pre-smooth + restrict: returns ``(u_k, rhs_{k+1})``."""
    lv = h.levels[k]
    if zero_init:
        u = jnp.zeros_like(rhs)
    lvl_shard = (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None
    u, r_k = _smooth_n_residual(lv, u, rhs, n_pre, alpha, use_pallas, shard=lvl_shard)
    rhs_next = _pad_cg(
        h.levels[k + 1], transfer_restrict(h.transfers[k], _crop_cg(lv, r_k))
    )
    return u, rhs_next


@functools.partial(
    jax.jit,
    static_argnames=("k", "emit_norm", "n_post", "alpha", "use_pallas", "shard"),
)
def _level_post_program(
    h, u, u_c, rhs, *, k, emit_norm, n_post, alpha, use_pallas, shard=None
):
    """Level ``k`` prolong + post-smooth; with ``emit_norm`` (fine level only)
    the post-smooth fuses the residual matvec into the same pass and the
    program also returns ``||rhs - A u||``."""
    lv = h.levels[k]
    corr = transfer_prolong(h.transfers[k], _crop_cg(h.levels[k + 1], u_c))
    u = u + _pad_cg(lv, corr)
    lvl_shard = (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None
    if emit_norm:
        u, r = _smooth_n_residual(lv, u, rhs, n_post, alpha, use_pallas, shard=lvl_shard)
        return u, jnp.linalg.norm(_flatten_level_vec(r))
    return _smooth_n(lv, u, rhs, n_post, alpha, use_pallas, shard=lvl_shard)


@functools.partial(jax.jit, static_argnames=("k", "use_pallas"))
def _level_correct_program(h, u, u_c, *, k, use_pallas=False):
    """Prolong + add as its own program.

    Split off from the post-smooth so that every operand of the fused
    smoother kernel is a program parameter, never a tensor produced in the
    same program.  (``use_pallas`` is accepted for interface symmetry; the
    prolong itself is the transpose+reshape XLA form — see
    ``ops.transfer_ops.bp_prolong``.)"""
    del use_pallas
    lv = h.levels[k]
    corr = transfer_prolong(h.transfers[k], _crop_cg(h.levels[k + 1], u_c))
    return u + _pad_cg(lv, corr)


@functools.partial(
    jax.jit,
    static_argnames=("k", "emit_norm", "n_post", "alpha", "use_pallas", "shard"),
)
def _level_postsmooth_program(
    h, u, rhs, *, k, emit_norm, n_post, alpha, use_pallas, shard=None
):
    """Post-smooth of an already-corrected iterate (kernel operands are all
    parameters — see :func:`_level_correct_program`)."""
    lv = h.levels[k]
    lvl_shard = (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None
    if emit_norm:
        u, r = _smooth_n_residual(lv, u, rhs, n_post, alpha, use_pallas, shard=lvl_shard)
        return u, jnp.linalg.norm(_flatten_level_vec(r))
    return _smooth_n(lv, u, rhs, n_post, alpha, use_pallas, shard=lvl_shard)


@functools.partial(
    jax.jit, static_argnames=("n_pre", "n_post", "alpha", "use_pallas", "shard")
)
def _tail_cycle_program(h_tail, rhs, *, n_pre, n_post, alpha, use_pallas, shard=None):
    """One V-cycle from zero on the coarse tail (its own fused module)."""
    return v_cycle(
        h_tail, jnp.zeros_like(rhs), rhs, n_pre=n_pre, n_post=n_post, alpha=alpha,
        use_pallas=use_pallas, shard=shard,
    )


def _tail_hierarchy(h_low: Hierarchy, cut: int) -> Hierarchy:
    return Hierarchy(
        levels=h_low.levels[cut:], transfers=h_low.transfers[cut:], coarse=h_low.coarse
    )


def _tail_shard(shard, cut: int):
    if shard is None:
        return None
    return (shard[0], shard[1], shard[2][cut:])


def _inner_cycle_step_split(
    h_low, h_tail, e, r, *, cut, n_pre, n_post, alpha, use_pallas, shard=None
):
    """:func:`_inner_cycle_step` composed from the split programs (see the
    section comment above): same math, ``2 * cut + 2`` small compiled units
    instead of one whole-hierarchy module."""
    us, rhss = [], [r]
    u = e
    for k in range(cut):
        u, rhs_next = _level_pre_program(
            h_low, u if k == 0 else rhss[k], rhss[k], k=k, zero_init=(k > 0),
            n_pre=n_pre, alpha=alpha, use_pallas=use_pallas, shard=shard,
        )
        us.append(u)
        rhss.append(rhs_next)
    u_c = _tail_cycle_program(
        h_tail, rhss[cut], n_pre=n_pre, n_post=n_post, alpha=alpha,
        use_pallas=use_pallas, shard=_tail_shard(shard, cut),
    )
    for k in range(cut - 1, -1, -1):
        emit_norm = k == 0
        if _pallas_smooth_ok(h_low.levels[k], rhss[k], use_pallas) or _cheb_ok_safe(
            h_low.levels[k], rhss[k], use_pallas
        ):
            # keep the kernel's operands pure parameters (see
            # _level_correct_program): correct, then smooth, as two programs
            u_k = _level_correct_program(h_low, us[k], u_c, k=k, use_pallas=use_pallas)
            u_c = _level_postsmooth_program(
                h_low, u_k, rhss[k], k=k, emit_norm=emit_norm,
                n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard,
            )
        else:
            u_c = _level_post_program(
                h_low, us[k], u_c, rhss[k], k=k, emit_norm=emit_norm,
                n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard,
            )
    return u_c


@jax.jit
def _vec_norm(r):
    """``||r||`` in the level vector's flat-DoF order, as a jitted program:
    called eagerly, ``_flatten_level_vec``'s transpose would materialize a
    full transposed copy of the vector; inside jit it fuses into the
    reduction and no buffer exists."""
    return jnp.linalg.norm(_flatten_level_vec(r))


# --- split-program progressive-precision cycle (the XL-scale counterpart of
# v_cycle_ff: same per-level math, compiled as the same program shapes as
# _inner_cycle_step_split — per-level pre/correct/post programs around one
# fused float-float tail) -------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("k", "zero_init", "n_pre", "alpha", "use_pallas", "shard")
)
def _ff_level_pre_program(
    h_low, a_ff_k, u_ff, rhs_ff, *, k, zero_init, n_pre, alpha, use_pallas, shard=None
):
    """Level ``k`` progressive pre-smooth + ff defect + restrict."""
    from ..ops.df64 import FF, ff_defect

    lv = h_low.levels[k]
    if zero_init:
        u_ff = _ff_zeros_like(rhs_ff)
    lvl_shard = (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None
    u_ff = _smooth_ff(lv, a_ff_k, u_ff, rhs_ff, n_pre, alpha, use_pallas, shard=lvl_shard)
    r_ff = ff_defect(a_ff_k, u_ff, rhs_ff)
    t = h_low.transfers[k]
    lvl_c = h_low.levels[k + 1]
    rhs_next = FF(
        _pad_cg(lvl_c, transfer_restrict(t, _crop_cg(lv, r_ff.hi))),
        _pad_cg(lvl_c, transfer_restrict(t, _crop_cg(lv, r_ff.lo))),
    )
    return u_ff, rhs_next


@functools.partial(jax.jit, static_argnames=("k",))
def _ff_level_correct_program(h_low, u_ff, u_c_ff, *, k):
    """Progressive prolong + add (both ff components; own program for the
    same produced-operand reason as :func:`_level_correct_program`)."""
    from ..ops.df64 import FF, ff_add

    lv = h_low.levels[k]
    t = h_low.transfers[k]
    lvl_c = h_low.levels[k + 1]
    corr = FF(
        _pad_cg(lv, transfer_prolong(t, _crop_cg(lvl_c, u_c_ff.hi))),
        _pad_cg(lv, transfer_prolong(t, _crop_cg(lvl_c, u_c_ff.lo))),
    )
    return ff_add(u_ff, corr)


@functools.partial(
    jax.jit, static_argnames=("k", "n_post", "alpha", "use_pallas", "shard")
)
def _ff_level_postsmooth_program(
    h_low, a_ff_k, u_ff, rhs_ff, *, k, n_post, alpha, use_pallas, shard=None
):
    lv = h_low.levels[k]
    lvl_shard = (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None
    return _smooth_ff(lv, a_ff_k, u_ff, rhs_ff, n_post, alpha, use_pallas, shard=lvl_shard)


@functools.partial(
    jax.jit, static_argnames=("n_pre", "n_post", "alpha", "use_pallas", "shard")
)
def _ff_tail_cycle_program(
    h_tail, a_ffs_tail, rhs_ff, coarse64=None, *, n_pre, n_post, alpha, use_pallas,
    shard=None
):
    """One progressive V-cycle from zero on the coarse tail (one fused
    module)."""
    return v_cycle_ff(
        h_tail, a_ffs_tail, _ff_zeros_like(rhs_ff), rhs_ff, coarse64,
        n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard,
    )


def _progressive_cycle_split(
    h_low, a_ffs, rhs_ff, coarse64=None, *, cut, n_pre, n_post, alpha, use_pallas,
    shard=None
):
    """One progressive-precision V-cycle from zero, as split programs
    (same math as :func:`v_cycle_ff`; same program decomposition as
    :func:`_inner_cycle_step_split`)."""
    us, rhss = [], [rhs_ff]
    for k in range(cut):
        u_k, rhs_next = _ff_level_pre_program(
            h_low, a_ffs[k], rhss[k], rhss[k], k=k, zero_init=True,
            n_pre=n_pre, alpha=alpha, use_pallas=use_pallas, shard=shard,
        )
        us.append(u_k)
        rhss.append(rhs_next)
    u_c = _ff_tail_cycle_program(
        _tail_hierarchy(h_low, cut), a_ffs[cut:], rhss[cut], coarse64,
        n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas,
        shard=_tail_shard(shard, cut),
    )
    for k in range(cut - 1, -1, -1):
        u_c = _ff_level_correct_program(h_low, us[k], u_c, k=k)
        u_c = _ff_level_postsmooth_program(
            h_low, a_ffs[k], u_c, rhss[k], k=k,
            n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard,
        )
    return u_c


@jax.jit
def _ff_add_program(x_ff, e_ff):
    from ..ops.df64 import ff_add

    return ff_add(x_ff, e_ff)


# --- TRUE-precision progressive cycle -------------------------------------
#
# Once ``eps_f32 * kappa_elem(A) > 1`` (the CDir = 1000 n penalty crosses
# that around 3e7 DoF; the 1e8 north star sits at ~6) every f32-VALUED
# operator application in the correction cycle — smoothing matvec, transfer,
# defect — injects error that the cycle AMPLIFIES (measured ~eps32 * kappa
# per cycle in the r5 conditioning bisects, independent of the arithmetic
# precision it is computed in).  The remedy is value accuracy: smoothing
# residuals from the float-float operators, transfers applied as
# ``T_hi r_hi + (T_hi r_lo + T_lo r_hi)``, defects float-float, and the
# coarse solve from the f64 factorization.  The preconditioner (block-Jacobi
# inverse) stays f32 — a perturbed S is a different-but-valid smoother.
# With that, the cycle contracts like f64 multigrid (verified against the
# all-f64 reference at matched conditioning) at ~4x the f32 cycle cost.


def _smooth_true(level, a_ff_k, u_ff, rhs_ff, n_sweeps, alpha):
    """Value-accurate smoothing: each sweep's residual is the float-float
    defect; the f32 preconditioner is applied to its hi part (the defect is
    r-scaled, so hi carries it to f32 relative accuracy)."""
    from ..ops.df64 import FF, ff_add, ff_defect
    from ..smoothers.smoother import ChebyshevSmoother

    s = level.smoother
    if isinstance(s, ChebyshevSmoother):
        theta = 0.5 * (s.lam_hi + s.lam_lo)
        delta = 0.5 * (s.lam_hi - s.lam_lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = ff_defect(a_ff_k, u_ff, rhs_ff)
        d = apply_smoother(s.base, r.hi) / theta
        u_ff = ff_add(u_ff, FF(d, jnp.zeros_like(d)))
        for _ in range(1, n_sweeps):
            r = ff_defect(a_ff_k, u_ff, rhs_ff)
            z = apply_smoother(s.base, r.hi)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            u_ff = ff_add(u_ff, FF(d, jnp.zeros_like(d)))
            rho = rho_new
        return u_ff
    for _ in range(n_sweeps):
        r = ff_defect(a_ff_k, u_ff, rhs_ff)
        du = alpha * apply_smoother(s, r.hi)
        u_ff = ff_add(u_ff, FF(du, jnp.zeros_like(du)))
    return u_ff


def _restrict_true(t32, t_lo, lv_f, lv_c, r_ff):
    from ..ops.df64 import FF, ff_add

    def tr(t, v):
        return _pad_cg(lv_c, transfer_restrict(t, _crop_cg(lv_f, v)))

    hi = tr(t32, r_ff.hi)
    cross = tr(t32, r_ff.lo)
    if t_lo is not None:
        cross = cross + tr(t_lo, r_ff.hi)
    return ff_add(FF(hi, jnp.zeros_like(hi)), FF(cross, jnp.zeros_like(cross)))


def _prolong_true(t32, t_lo, lv_f, lv_c, u_c_ff):
    from ..ops.df64 import FF, ff_add

    def pr(t, v):
        return _pad_cg(lv_f, transfer_prolong(t, _crop_cg(lv_c, v)))

    hi = pr(t32, u_c_ff.hi)
    cross = pr(t32, u_c_ff.lo)
    if t_lo is not None:
        cross = cross + pr(t_lo, u_c_ff.hi)
    return ff_add(FF(hi, jnp.zeros_like(hi)), FF(cross, jnp.zeros_like(cross)))


def _true_coarse_solve(coarse64, rhs_ff):
    from ..ops.df64 import FF, ff_split

    flat = (
        _flatten_level_vec(rhs_ff.hi).astype(jnp.float64)
        + _flatten_level_vec(rhs_ff.lo).astype(jnp.float64)
    )
    e64 = coarse_solve(coarse64, flat)
    sp = ff_split(e64)
    like = rhs_ff.hi
    return FF(_unflatten_level_vec(sp.hi, like), _unflatten_level_vec(sp.lo, like))


def v_cycle_true(h_low, ffops, rhs_ff, k=0, *, n_pre=3, n_post=3, alpha=2.0 / 3.0):
    """One TRUE-precision V-cycle from zero on levels ``k..end`` (see the
    section comment above; ``ffops`` is ``stencil_setup.FFOps``)."""
    from ..ops.df64 import ff_add, ff_defect

    if k == h_low.n_levels - 1:
        return _true_coarse_solve(ffops.coarse64, rhs_ff)
    lv = h_low.levels[k]
    lv_c = h_low.levels[k + 1]
    t32 = h_low.transfers[k]
    t_lo = ffops.t_los[k]
    u = _smooth_true(lv, ffops.a_ffs[k], _ff_zeros_like(rhs_ff), rhs_ff, n_pre, alpha)
    r = ff_defect(ffops.a_ffs[k], u, rhs_ff)
    e_c = v_cycle_true(
        h_low, ffops, _restrict_true(t32, t_lo, lv, lv_c, r), k + 1,
        n_pre=n_pre, n_post=n_post, alpha=alpha,
    )
    u = ff_add(u, _prolong_true(t32, t_lo, lv, lv_c, e_c))
    return _smooth_true(lv, ffops.a_ffs[k], u, rhs_ff, n_post, alpha)


@functools.partial(jax.jit, static_argnames=("k", "n_pre", "alpha"))
def _true_level_pre_program(h_low, ffops, rhs_ff, *, k, n_pre, alpha):
    from ..ops.df64 import ff_defect

    lv = h_low.levels[k]
    u = _smooth_true(lv, ffops.a_ffs[k], _ff_zeros_like(rhs_ff), rhs_ff, n_pre, alpha)
    r = ff_defect(ffops.a_ffs[k], u, rhs_ff)
    rhs_next = _restrict_true(
        h_low.transfers[k], ffops.t_los[k], lv, h_low.levels[k + 1], r
    )
    return u, rhs_next


@functools.partial(jax.jit, static_argnames=("cut", "n_pre", "n_post", "alpha"))
def _true_tail_cycle_program(h_low, ffops, rhs_ff, *, cut, n_pre, n_post, alpha):
    return v_cycle_true(h_low, ffops, rhs_ff, cut, n_pre=n_pre, n_post=n_post, alpha=alpha)


@functools.partial(jax.jit, static_argnames=("k",))
def _true_level_correct_program(h_low, ffops, u_ff, u_c_ff, *, k):
    from ..ops.df64 import ff_add

    return ff_add(
        u_ff,
        _prolong_true(
            h_low.transfers[k], ffops.t_los[k], h_low.levels[k],
            h_low.levels[k + 1], u_c_ff,
        ),
    )


@functools.partial(jax.jit, static_argnames=("k", "n_post", "alpha"))
def _true_level_postsmooth_program(h_low, ffops, u_ff, rhs_ff, *, k, n_post, alpha):
    return _smooth_true(h_low.levels[k], ffops.a_ffs[k], u_ff, rhs_ff, n_post, alpha)


def _true_cycle_split(h_low, ffops, rhs_ff, *, cut, n_pre, n_post, alpha):
    """One TRUE-precision cycle as split programs (per-level pre/correct/post
    for levels ``0..cut-1`` around one fused tail — the compile-unit shape
    proven at 1e8 DoF by the f32 split cycle).

    Each stage is synchronized before the next enqueues: queueing the whole
    cycle ahead makes the runtime allocate every stage's output buffers up
    front, which raises the 1e8-DoF working set's peak.  The syncs were sized
    for a 16 GB device; whether an 80 GB card needs them is open (ROADMAP)."""
    us, rhss = [], [rhs_ff]
    for k in range(cut):
        u_k, rhs_next = _true_level_pre_program(
            h_low, ffops, rhss[k], k=k, n_pre=n_pre, alpha=alpha
        )
        jax.block_until_ready(u_k.hi)
        us.append(u_k)
        rhss.append(rhs_next)
    u_c = _true_tail_cycle_program(
        h_low, ffops, rhss[cut], cut=cut, n_pre=n_pre, n_post=n_post, alpha=alpha
    )
    jax.block_until_ready(u_c.hi)
    for k in range(cut - 1, -1, -1):
        u_c = _true_level_correct_program(h_low, ffops, us[k], u_c, k=k)
        jax.block_until_ready(u_c.hi)
        u_c = _true_level_postsmooth_program(
            h_low, ffops, u_c, rhss[k], k=k, n_post=n_post, alpha=alpha
        )
        jax.block_until_ready(u_c.hi)
    return u_c


def _progressive_true_eager(
    h_low, ffops, x_ff, b_ff, inv_norm_b,
    *, maxiter, tol, cut, n_pre=3, n_post=3, alpha=2.0 / 3.0,
):
    """TRUE-precision progressive solve: split-program value-accurate cycles
    driven by an f64 outer defect (block-stencil fine operators) or the ff
    defect otherwise.  The north-star (1e8-DoF) solver: converges like f64
    multigrid at ~4x the f32 cycle cost where both the guarded mixed
    refinement and the plain progressive cycles floor around
    ``eps * kappa_elem`` (see the section comment)."""
    from ..ops.df64 import BTFFStencil

    use64 = isinstance(ffops.a_ffs[0], BTFFStencil)

    def defect(x):
        if use64:
            return _f64_rel_defect(ffops.a_ffs[0], x, b_ff, inv_norm_b)
        return _ff_rel_defect(ffops.a_ffs[0], x, b_ff, inv_norm_b)

    res_h = np.full((maxiter,), np.nan, dtype=np.float64)
    it = 0
    while it < maxiter:
        r_ff, rel = defect(x_ff)
        rel = float(rel)
        if it > 0:
            res_h[it - 1] = rel
        if rel < float(tol):
            break
        e_ff = _true_cycle_split(
            h_low, ffops, r_ff, cut=cut, n_pre=n_pre, n_post=n_post, alpha=alpha
        )
        del r_ff
        x_ff = _ff_add_program(x_ff, e_ff)
        del e_ff
        it += 1
    if it > 0:
        _, rel = defect(x_ff)
        res_h[it - 1] = float(rel)
    return x_ff, it, res_h


@jax.jit
def _f64_rel_defect(a_st, x_ff, b_ff, inv_norm_b):
    """TRUE-f64 outer defect from the stencil operator, returned split to ff
    for the f32-speed correction cycle.  The float-float defect floors around
    ``2^-48 * || |A| |x| || / ||b||`` relative (~4e-7 at the 1e8-DoF
    CDir = 1000 n north star — seen as a 5e-8..4e-6 bounce band); the f64
    defect floors ~2^-53 of the same, comfortably below 1e-8.  One per outer
    cycle (``ops.df64.f64_bt_defect_stencil``)."""
    from ..ops.df64 import f64_bt_defect_stencil

    r_ff = f64_bt_defect_stencil(a_st, x_ff, b_ff)
    # norm from the split pair, reduced 2-D (order-irrelevant, and no
    # transposed f64 copy of the vector)
    v = r_ff.hi.astype(jnp.float64) + r_ff.lo.astype(jnp.float64)
    rel = jnp.sqrt(jnp.sum(v * v)) * inv_norm_b.astype(jnp.float64)
    return r_ff, rel


def _progressive_eager(
    h_low, a_ffs, x_ff, b_ff, inv_norm_b, coarse64=None,
    *, maxiter, tol, cut, n_pre, n_post, alpha, use_pallas, shard=None,
):
    """Host-loop progressive-precision iteration over split-program cycles —
    the XL-scale counterpart of :func:`_progressive_loop` (same per-cycle
    math and stopping rule; returns the same ``(x_ff, it, res_history)``).

    NOTE: at ``eps_f32 * kappa_elem(A) > 1`` these ff cycles amplify instead
    of contracting (f32-valued operator applications inside the cycle) — use
    :func:`_progressive_true_eager` there."""
    kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard)
    tolc = np.float32(tol)
    res_h = np.full((maxiter,), np.nan, dtype=np.float32)
    it = 0
    while it < maxiter:
        r_ff, rel = _ff_rel_defect(a_ffs[0], x_ff, b_ff, inv_norm_b)
        rel = np.float32(rel)
        if it > 0:
            res_h[it - 1] = rel
        if rel < tolc:
            break
        e_ff = _progressive_cycle_split(h_low, a_ffs, r_ff, coarse64, cut=cut, **kw)
        del r_ff
        x_ff = _ff_add_program(x_ff, e_ff)
        del e_ff  # 2 vector buffers; keeping it across the next defect counts
        it += 1
    if it > 0:  # record the defect of the final iterate (cf. _progressive_loop)
        _, rel = _ff_rel_defect(a_ffs[0], x_ff, b_ff, inv_norm_b)
        res_h[it - 1] = np.float32(rel)
    return x_ff, it, res_h


def _mixed_inner_solve_eager(
    h_low, r, inner_tol, max_cycles, *, n_pre, n_post, alpha, use_pallas, shard=None,
    eager_cut: int = 0,
):
    """:func:`_mixed_inner_solve` with the cycle loop on the host: identical
    stopping rule and returns, but the compiled unit is ONE V-cycle + residual
    norm instead of a ``while_loop`` over them — and with ``eager_cut > 0``
    the V-cycle itself splits into per-level programs around a fused coarse
    tail (the structural rescue at the 1e8-DoF compile ceiling; see
    :func:`_inner_cycle_step_split`).  Costs one ~25 ms scalar sync per cycle.

    Stopping comparisons run in np.float32 to match the fused
    ``_mixed_inner_solve``'s on-device f32 arithmetic bit-for-bit."""
    kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard)
    norm_r = np.float32(_vec_norm(r))
    tol_abs = np.float32(inner_tol) * norm_r
    h_tail = _tail_hierarchy(h_low, eager_cut) if eager_cut > 0 else None

    e = best_e = jnp.zeros_like(r)
    best_res = np.float32(np.finfo(np.float32).max)
    best_i = 0
    i, res, prev = 0, norm_r, np.float32(np.finfo(np.float32).max)
    while i < int(max_cycles) and not (res < tol_abs or res > np.float32(0.7) * prev):
        if eager_cut > 0:
            e, new = _inner_cycle_step_split(h_low, h_tail, e, r, cut=eager_cut, **kw)
        else:
            e, new = _inner_cycle_step(h_low, e, r, **kw)
        new = np.float32(new)
        if new < best_res:
            best_e, best_res, best_i = e, new, i + 1
        prev, res = res, new
        i += 1
    return best_e, jnp.asarray(i), jnp.asarray(best_i)


@jax.jit
def _ff_rel_defect(a_ff, x_ff, b_ff, inv_norm_b):
    """``(r_ff, ||r||_hi * inv_norm_b)`` — the outer-loop defect as its own
    program (see :func:`_mixed_eager_outer`)."""
    from ..ops.df64 import ff_defect

    r_ff = ff_defect(a_ff, x_ff, b_ff)
    return r_ff, jnp.linalg.norm(_flatten_level_vec(r_ff.hi) * inv_norm_b)


@jax.jit
def _ff_apply_correction(x_best, e, scale):
    from ..ops.df64 import FF, ff_add

    return ff_add(x_best, FF(scale.astype(e.dtype) * e, jnp.zeros_like(e)))


def _mixed_eager_outer(
    h_low, a_ff, x_ff, b_ff, inv_norm_b,
    *, maxiter, tol, inner_tol, max_inner, n_pre, n_post, alpha, use_pallas,
    shard=None, eager_inner=False, eager_cut: int = 0, ffops=None,
):
    """:func:`_mixed_loop_ff` with the OUTER loop on the host.

    Identical guarded-refinement semantics and results, but the work splits
    into three jit units (ff defect + norm, the f32 inner solve, the ff
    correction update) instead of one module spanning the whole refinement.
    ``eager_inner=True`` additionally puts the inner cycle loop on the host
    (one V-cycle per program), and ``eager_cut=c > 0`` splits each V-cycle
    itself into per-level programs for levels ``0..c-1`` around one fused
    coarse-tail module (:func:`_inner_cycle_step_split`) — pick ``c`` = the
    number of levels running the fused smoother kernel.  The split forms keep
    each compiled unit small at very large n; each program boundary costs one
    scalar sync.

    Exact-match parity with the fused loop (including ``eager_cut`` 1 and 2)
    is pinned by ``tests/test_stencil_setup.py::test_eager_outer_matches_fused``.
    """
    kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard)
    it32 = jnp.asarray(inner_tol, jnp.float32)

    x_cur = x_best = x_ff
    # only the hi part feeds the f32 inner solve — don't hold the lo tail
    # (0.4 GB at the 1e8-DoF scale)
    r_best_hi = jnp.zeros_like(x_ff.hi)
    rel_best = float(np.finfo(np.float32).max)
    i = cycles = streak = 0
    limit = max_inner
    res_h = np.full((maxiter,), np.nan, dtype=np.float32)

    while i < maxiter:
        r_ff, rel = _ff_rel_defect(a_ff, x_cur, b_ff, inv_norm_b)
        rel = float(rel)
        improved = rel < rel_best
        if improved:
            x_best, r_best_hi = x_cur, r_ff.hi
            rel_best, streak = rel, 0
        else:
            streak += 1
        del r_ff
        if i > 0:
            res_h[i - 1] = rel_best
        if rel_best < tol or streak >= 3 or cycles >= maxiter:
            break
        if ffops is not None and i >= 4 and rel_best > 0.1 * res_h[i - 4]:
            # guarded refinement is only trickling (less than one decade over
            # the last three outers) and progressive-precision cycles are
            # available (~3 digits each at any conditioning): hand over
            # instead of burning the cycle budget on diminishing f32 returns
            break

        probe = 1 if (i % 4 == 0 and improved) else 0
        cap = min((limit if improved else 1) + probe, max_inner)
        if eager_inner:
            e, n_cyc, i_best = _mixed_inner_solve_eager(
                h_low, r_best_hi, it32, jnp.asarray(cap), eager_cut=eager_cut, **kw
            )
        else:
            e, n_cyc, i_best = _mixed_inner_solve(
                h_low, r_best_hi, it32, jnp.asarray(cap), **kw
            )
        scale = jnp.asarray(0.5**streak if streak > 0 else 1.0, jnp.float32)
        x_cur = _ff_apply_correction(x_best, e, scale)
        cycles += int(n_cyc)
        limit = max(limit, 1) if not improved else max(1, int(i_best))
        i += 1

    _, rel_last = _ff_rel_defect(a_ff, x_cur, b_ff, inv_norm_b)
    rel_last = float(rel_last)
    x_out = x_cur if rel_last < rel_best else x_best
    rel_out = min(rel_last, rel_best)
    if i > 0:
        res_h[i - 1] = rel_out

    if rel_out > tol and ffops is not None:
        # the f32 inner V-cycle stopped contracting above tol (eps_f32 *
        # kappa_elem > 1 at this scale): continue with TRUE-precision
        # progressive cycles, which converge like f64 multigrid (see
        # _progressive_true_eager and the section comment above it)
        remaining = maxiter - max(cycles, i)
        if remaining > 0:
            # drop the guarded phase's working set first (x pair + best pair +
            # residual + last correction ≈ 2.5 GB at 1e8 DoF — enough to OOM
            # the value-accurate cycles, whose footprint is ~2x the f32 cycle's)
            x_cur = x_best = r_best_hi = e = None  # noqa: F841
            x_out, it2, res2 = _progressive_true_eager(
                h_low, ffops, x_out, b_ff, inv_norm_b,
                maxiter=remaining, tol=tol, cut=eager_cut,
                n_pre=n_pre, n_post=n_post, alpha=alpha,
            )
            res_h[i : i + it2] = res2[:it2]
            i += it2
            cycles += it2
    return x_out, jnp.asarray(i), jnp.asarray(cycles), jnp.asarray(res_h)


# ---------------------------------------------------------------------------
# Progressive precision: float-float V-cycle with f32 smoothers
# ---------------------------------------------------------------------------


def _ff_zeros_like(x):
    from ..ops.df64 import FF

    return FF(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))


def _smooth_ff(level, a_ff, u_ff, rhs_ff, n_sweeps, alpha, use_pallas, shard=None):
    """Low-precision smoothing as a float-float-accumulated correction.

    The sweeps themselves run entirely in f32 on the hi parts (fused-kernel
    path) — a rounding-level perturbation of the smoother only nudges the
    contraction factor — but the result is folded into the ff iterate so the
    smooth-mode information of ``u`` is never truncated to f32."""
    from ..ops.df64 import FF, ff_add

    u32 = _smooth_n(level, u_ff.hi, rhs_ff.hi, n_sweeps, alpha, use_pallas, shard=shard)
    delta = u32 - u_ff.hi
    return ff_add(u_ff, FF(delta, jnp.zeros_like(delta)))


def v_cycle_ff(
    h_low: Hierarchy,
    a_ffs,
    u_ff,
    rhs_ff,
    coarse64=None,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    use_pallas: bool = False,
    shard=None,
):
    """One *progressive-precision* V-cycle.

    Identical control flow to :func:`v_cycle`, but every residual, transfer,
    and iterate update runs in float-float (~2^-48) arithmetic while the
    smoother sweeps and the coarse solve run in f32.  This is what makes
    multigrid work in low precision on severely ill-conditioned operators
    (cond(A) >> 1/eps_f32, e.g. high-order CG stiffness at 10^5+ DoF): a pure
    f32 V-cycle loses the smooth-mode content of residuals at restriction and
    its error operator stops being a contraction, whereas here the correction
    hierarchy sees f64-class defects throughout (progressive-precision
    multigrid).

    ``a_ffs`` is a tuple of per-level float-float operators split from the f64
    hierarchy; smoothers/transfers/coarse come from the f32 ``h_low``.
    """
    from ..ops.df64 import FF, ff_add, ff_defect

    n = h_low.n_levels
    u = [None] * n
    rhs = [None] * n
    u[0], rhs[0] = u_ff, rhs_ff

    def _lvl_shard(k):
        return (shard[0], shard[1]) if (shard is not None and shard[2][k]) else None

    for k in range(n - 1):
        level = h_low.levels[k]
        if k > 0:
            u[k] = _ff_zeros_like(rhs[k])
        u[k] = _smooth_ff(
            level, a_ffs[k], u[k], rhs[k], n_pre, alpha, use_pallas, shard=_lvl_shard(k)
        )
        r_ff = ff_defect(a_ffs[k], u[k], rhs[k])
        t = h_low.transfers[k]
        lvl_c = h_low.levels[k + 1]
        rhs[k + 1] = FF(
            _pad_cg(lvl_c, transfer_restrict(t, _crop_cg(level, r_ff.hi))),
            _pad_cg(lvl_c, transfer_restrict(t, _crop_cg(level, r_ff.lo))),
        )

    # coarsest solve
    r = rhs[n - 1]
    like = r.hi
    if coarse64 is not None:
        # f64 factorization (the level is tiny, so this costs little): the
        # f32-solve-plus-one-refinement scheme below stops
        # contracting once cond(A_coarse) >~ 1/eps_f32, which the CDir=1000n
        # penalty reaches at the 1e8-DoF north star (measured: progressive
        # cycles bounce in the 1e-6..1e-8 band instead of converging)
        from ..ops.df64 import ff_split

        flat64 = (
            _flatten_level_vec(r.hi).astype(jnp.float64)
            + _flatten_level_vec(r.lo).astype(jnp.float64)
        )
        e64 = coarse_solve(coarse64, flat64)
        sp = ff_split(e64)
        u[n - 1] = FF(
            _unflatten_level_vec(sp.hi, like), _unflatten_level_vec(sp.lo, like)
        )
    else:
        # f32 dense solve + one ff-defect refinement step (sufficient while
        # the coarse operator is mildly conditioned)
        e1 = _unflatten_level_vec(
            coarse_solve(h_low.coarse, _flatten_level_vec(r.hi)), like
        )
        e_ff = FF(e1, jnp.zeros_like(e1))
        d = ff_defect(a_ffs[n - 1], e_ff, r)
        e2 = _unflatten_level_vec(
            coarse_solve(h_low.coarse, _flatten_level_vec(d.hi)), like
        )
        u[n - 1] = ff_add(e_ff, FF(e2, jnp.zeros_like(e2)))

    for k in range(n - 2, -1, -1):
        level = h_low.levels[k]
        t = h_low.transfers[k]
        lvl_c = h_low.levels[k + 1]
        corr = FF(
            _pad_cg(level, transfer_prolong(t, _crop_cg(lvl_c, u[k + 1].hi))),
            _pad_cg(level, transfer_prolong(t, _crop_cg(lvl_c, u[k + 1].lo))),
        )
        u[k] = ff_add(u[k], corr)
        u[k] = _smooth_ff(
            level, a_ffs[k], u[k], rhs[k], n_post, alpha, use_pallas, shard=_lvl_shard(k)
        )
    return u[0]


@functools.partial(
    jax.jit,
    static_argnames=("maxiter", "n_pre", "n_post", "alpha", "use_pallas", "shard"),
)
def _progressive_loop(
    h_low, a_ffs, x_ff, b_ff, inv_norm_b, coarse64=None,
    *, maxiter, tol, n_pre, n_post, alpha, use_pallas, shard=None,
):
    from ..ops.df64 import ff_add, ff_defect

    nan32 = jnp.full((maxiter,), jnp.nan, dtype=jnp.float32)
    tol32 = jnp.asarray(tol, jnp.float32)

    def body(state):
        x_ff, i, res_h, _ = state
        # Each cycle solves the CORRECTION equation A e = r from zero: with a
        # well-scaled rhs every in-cycle f32 cancellation is relative to the
        # current residual, so the per-cycle contraction holds all the way to
        # the ff defect's ~2^-48 floor.  (Cycling on x directly stalls at
        # ~1e-6: the fine-level smoother's internal f32 defect b - A x is
        # noise once x has converged past f32.)
        r_ff = ff_defect(a_ffs[0], x_ff, b_ff)
        rel = jnp.linalg.norm(_flatten_level_vec(r_ff.hi) * inv_norm_b)
        res_h = jax.lax.cond(i > 0, lambda h: h.at[i - 1].set(rel), lambda h: h, res_h)
        done = rel < tol32
        e_ff = v_cycle_ff(
            h_low, a_ffs, _ff_zeros_like(r_ff), r_ff, coarse64,
            n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard,
        )
        x_new = ff_add(x_ff, e_ff)
        x_ff = jax.tree_util.tree_map(
            lambda new, old: jnp.where(done, old, new), x_new, x_ff
        )
        i = jnp.where(done, i, i + 1)
        return x_ff, i, res_h, done

    def cond(state):
        _, i, _, done = state
        return jnp.logical_and(i < maxiter, jnp.logical_not(done))

    x_ff, it, res_h, _ = jax.lax.while_loop(
        cond, body, (x_ff, jnp.array(0), nan32, jnp.array(False))
    )
    r_ff = ff_defect(a_ffs[0], x_ff, b_ff)
    rel = jnp.linalg.norm(_flatten_level_vec(r_ff.hi) * inv_norm_b)
    res_h = jax.lax.cond(it > 0, lambda h: h.at[it - 1].set(rel), lambda h: h, res_h)
    return x_ff, it, res_h


def multigrid_progressive(
    h: Hierarchy,
    h_low: Hierarchy,
    x0: jax.Array,
    b: jax.Array,
    maxiter: int = 100,
    tol: float = 1e-10,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    use_pallas: bool = True,
    shard=None,
) -> MultigridResult:
    """Multigrid with progressive-precision V-cycles: f32 smoother sweeps and
    coarse solves, float-float everything else.  Converges like the all-f64
    iteration (same per-cycle contraction, same 1e-10 tolerances) at close to
    f32 speed, on operators where :func:`multigrid_mixed`'s f32 inner V-cycle
    is not a contraction at all.  ``iterations`` counts V-cycles, matching the
    reference's observability contract (``src/solvers.jl:116-139``)."""
    import numpy as np

    from ..ops.df64 import ff_join, ff_split

    a_ffs = tuple(_ff_split_level(lv) for lv in h.levels)
    norm_b = float(_vec_norm(b))  # jitted: no eager transposed copy
    x_ff, it, res_scaled = _progressive_loop(
        h_low, a_ffs, ff_split(x0.astype(jnp.float64)), ff_split(b),
        jnp.asarray(1.0 / norm_b, jnp.float32),
        maxiter=maxiter, tol=tol, n_pre=n_pre, n_post=n_post, alpha=alpha,
        use_pallas=use_pallas, shard=shard,
    )
    err_h = np.full((maxiter,), np.nan)
    return MultigridResult(
        x=ff_join(x_ff),
        iterations=it,
        res_history=jnp.asarray(np.asarray(res_scaled, dtype=np.float64) * norm_b),
        err_history=jnp.asarray(err_h),
        inner_cycles=it,
    )


def multigrid_mixed(
    h: Hierarchy,
    h_low: Hierarchy,
    x0: jax.Array,
    b: jax.Array,
    maxiter: int = 100,
    tol: float = 1e-10,
    *,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    use_pallas: bool = True,
    inner_tol: float = 3.0e-5,
    max_inner: int = 20,
    shard=None,
) -> MultigridResult:
    """Mixed-precision iterative refinement: the correction equation
    ``A e = r`` is *solved* (not just preconditioned) in f32 with fused-kernel
    V-cycles down to ``inner_tol``-relative inner residual, and only the defect
    ``r = b - A x`` and the update ``x += e`` run at f64 accuracy.  Each outer
    step therefore gains ~``-log10(inner_tol)`` digits, so 1e-10 relative
    residuals cost ~3 f64-accurate defects total instead of one per V-cycle
    (SURVEY §7 hard part 1: the reference relies on double precision).

    On block-structured fine levels the f64-accurate defect is evaluated in
    float-float (two-f32) arithmetic — ~2^-48-accurate (see ``ops.df64``);
    the iterate itself is carried as an f32 pair.  Whether this beats plain
    f64 multigrid on a card with native f64 is open (ROADMAP, precision
    path).  The inner cycle limit adapts per outer step: once the inner loop
    is observed to stall after ``k`` cycles, subsequent steps run exactly ``k``
    (re-probing ``k + 1`` every 4th step), so ill-conditioned problems pay no
    repeated stall-discovery cycles.

    Returns the reference's observability contract: ``iterations`` counts outer
    refinement steps (``res_history[:iterations]`` is the per-step true-f64
    defect history, ending with the converged value); ``inner_cycles`` is the
    total number of f32 V-cycles executed.

    ``shard = (mesh, axis, flags)`` (see :func:`v_cycle` /
    ``parallel.distributed.fused_shard_spec``) routes the flagged block levels'
    inner-cycle smoothing through the shard_map fused kernels; the float-float
    defects stay on global arrays, where XLA's SPMD partitioner turns their
    pad+slice shifts into the same one-column collective-permutes.
    """
    import numpy as np

    from ..ops.df64 import ff_join, ff_split

    low_dtype = jax.tree_util.tree_leaves(h_low.levels[0].a)[0].dtype
    fine = h.levels[0]
    norm_b = float(_vec_norm(b))  # jitted: no eager transposed copy
    err_h = np.full((maxiter,), np.nan)
    kw = dict(n_pre=n_pre, n_post=n_post, alpha=alpha, use_pallas=use_pallas, shard=shard)

    if isinstance(fine, (BlockLevel, CgLevel)) and low_dtype == jnp.float32:
        # float-float fast path: the entire refinement is one on-device program
        a_ff = _ff_split_level(fine)
        b_ff = ff_split(b)
        x_ff = ff_split(x0.astype(jnp.float64))
        inv_nb = jnp.asarray(1.0 / norm_b, jnp.float32)
        x_ff, outer, cycles, res_scaled = _mixed_loop_ff(
            h_low, a_ff, x_ff, b_ff, inv_nb,
            maxiter=maxiter, tol=tol, inner_tol=inner_tol, max_inner=max_inner, **kw,
        )
        outer_i, cycles_i = int(outer), int(cycles)
        res_h = np.asarray(res_scaled, dtype=np.float64) * norm_b
        rel_out = res_h[outer_i - 1] / norm_b if outer_i > 0 else np.inf
        remaining = maxiter - max(cycles_i, outer_i)
        if rel_out > tol and remaining > 0:
            # the f32 inner V-cycle is not a contraction for this operator
            # (cond(A) >~ 1/eps_f32): continue with progressive-precision
            # cycles, which converge like f64 at ~f32 cost (see v_cycle_ff)
            a_ffs = tuple(_ff_split_level(lv) for lv in h.levels)
            x_ff, it2, res2 = _progressive_loop(
                h_low, a_ffs, x_ff, b_ff, inv_nb,
                maxiter=remaining, tol=tol, **kw,
            )
            it2_i = int(it2)
            res_h[outer_i : outer_i + it2_i] = (
                np.asarray(res2, dtype=np.float64)[:it2_i] * norm_b
            )
            outer_i += it2_i
            cycles_i += it2_i
        return MultigridResult(
            x=ff_join(x_ff),
            iterations=jnp.array(outer_i),
            res_history=jnp.asarray(res_h),
            err_history=jnp.asarray(err_h),
            inner_cycles=jnp.array(cycles_i),
        )

    # generic path (non-f32 inner dtypes): host outer loop over per-precision
    # programs, one f64 defect per outer step
    x = x0
    res_h = np.full((maxiter,), np.nan)
    cycles = 0
    outer = 0
    limit = max_inner
    for i in range(maxiter):
        r, res = _mixed_defect(fine, x, b)
        if i > 0:
            res_h[i - 1] = float(res)  # residual after outer step i
        if float(res) < tol * norm_b or cycles >= maxiter:
            break
        probe = 1 if (i % 4 == 0) else 0
        e, n_cyc, i_best = _mixed_inner_solve(
            h_low,
            r.astype(low_dtype),
            jnp.asarray(inner_tol, low_dtype),
            jnp.asarray(min(limit + probe, max_inner)),
            **kw,
        )
        x = _mixed_update(x, e)
        cycles += int(n_cyc)
        limit = max(1, int(i_best))
        outer = i + 1
    return MultigridResult(
        x=x,
        iterations=jnp.array(outer),
        res_history=jnp.asarray(res_h),
        err_history=jnp.asarray(err_h),
        inner_cycles=jnp.array(cycles),
    )


def multigrid_true(
    h_low: Hierarchy,
    ffops,
    b_ff,
    norm_b: float,
    maxiter: int = 40,
    tol: float = 1e-8,
    *,
    x0_ff=None,
    n_pre: int = 3,
    n_post: int = 3,
    alpha: float = 2.0 / 3.0,
    pallas_min_blocks: int = 1 << 22,
) -> MultigridResult:
    """TRUE-precision progressive multigrid (public wrapper around
    :func:`_progressive_true_eager`) with the reference's observability
    contract (``src/solvers.jl:116-139``): ``iterations`` counts V-cycles and
    ``res_history[:iterations]`` is the per-cycle relative-residual-times-
    ``norm_b`` history from the f64-accurate outer defect.

    The north-star solver: converges like all-f64 multigrid on operators
    where ``eps_f32 * kappa_elem(A) > 1`` (see the section comment above
    :func:`_smooth_true`) at ~4x the f32 cycle cost.  Inputs come from
    ``stencil_setup.build_xl_problem(..., ff_levels=True)``:

        h_low, ffops, b_ff, norm_b = build_xl_problem(spec, n, ff_levels=True)
        res = multigrid_true(h_low, ffops, b_ff, norm_b)

    ``pallas_min_blocks`` sets the split-program cut: every level with at
    least that many blocks runs as its own per-level programs (see the
    split V-cycle section above).
    """
    from ..ops.df64 import FF, ff_join

    if x0_ff is None:
        zero = jnp.zeros_like(b_ff.hi)
        x0_ff = FF(zero, zero)
    cut = sum(
        1 for lv in h_low.levels[:-1]
        if isinstance(lv, BlockLevel) and lv.a.n_blocks >= pallas_min_blocks
    )
    x_ff, it, res_h = _progressive_true_eager(
        h_low, ffops, x0_ff, b_ff, jnp.asarray(1.0 / norm_b, jnp.float32),
        maxiter=maxiter, tol=tol, cut=cut, n_pre=n_pre, n_post=n_post, alpha=alpha,
    )
    return MultigridResult(
        x=ff_join(x_ff),
        iterations=jnp.array(it),
        res_history=jnp.asarray(res_h * norm_b),
        err_history=jnp.asarray(np.full((maxiter,), np.nan)),
        inner_cycles=jnp.array(it),
    )
