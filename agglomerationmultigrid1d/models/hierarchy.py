"""Multigrid hierarchy construction (counterpart of ``src/mesh_heirarchy.jl``).

Two constructors mirroring the reference:

* :func:`build_hierarchy` — CG-topped (``mesh_heirarchy.jl:30-138``): a chain of
  CG p-coarsening levels (Galerkin stiffness, pointwise Jacobi), an optional DG
  seam + DG p-coarsening chain, then agglomerated h-coarsening levels.  DG/agg
  levels Galerkin-project G, D, C *separately* and recombine with the coarse
  level's own mass, ``A = C - D M^-1 G`` (``:79-84`` — NOT a direct triple
  product of A).
* :func:`build_dg_hierarchy` — DG-topped (``mesh_heirarchy.jl:140-181``).

The result is a JAX pytree; the V-cycle in ``.solvers`` traces over it with a
static level structure.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import functools as _functools

import jax
import jax.numpy as jnp

from ..assembly.agg_assembly import agg_flux_operators
from ..assembly.dg_assembly import dg_flux_operators
from ..mesh.agg_mesh import AggMesh
from ..mesh.cg_mesh import CgMesh
from ..mesh.dg_mesh import DgMesh
from ..mesh.scattered_agg import ScatteredAggMesh
from ..mesh.topology import BoundaryCondition
from ..ops.block_diag import BlockDiag
from ..ops.block_tridiag import (
    BlockTridiag,
    bd_mul_bt,
    block_mul,
    bt_mul_bt,
    bt_sub,
    bt_to_dense,
)
from ..ops.cg_operator import CgOperator, cg_to_dense
from ..ops.coarse_solve import CoarseSolver, make_coarse_solver
from ..ops.transfer_ops import (
    BlockProlong,
    CgProlong,
    RaggedBlockProlong,
    SeamProlong,
    bp_galerkin,
    cgp_galerkin,
    rbp_galerkin,
)
from ..smoothers.smoother import Smoother, cg_smoother, dg_smoother
from ..transfer.interpolation import (
    aggdg_aggdg_interpolation,
    aggdg_cg_interpolation,
    aggdg_dg_interpolation,
    cg_cg_interpolation,
    dg_cg_interpolation,
    dg_dg_interpolation,
)

Transfer = Union[CgProlong, BlockProlong, RaggedBlockProlong, SeamProlong]


def _block_galerkin(l, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` dispatch for block-aligned transfers (uniform or ragged)."""
    return rbp_galerkin(l, x) if isinstance(l, RaggedBlockProlong) else bp_galerkin(l, x)


class CgLevel(NamedTuple):
    a: CgOperator
    smoother: Smoother


class BlockLevel(NamedTuple):
    a: BlockTridiag
    g: BlockTridiag
    d: BlockTridiag
    c: BlockTridiag
    mass_inv: jax.Array  # (bs, bs, n) of the level's own mass
    smoother: Smoother


Level = Union[CgLevel, BlockLevel]


class Hierarchy(NamedTuple):
    levels: tuple  # of Level, fine -> coarse
    transfers: tuple  # of Transfer, len = n_levels - 1
    coarse: CoarseSolver  # host-factorized dense solver for the coarsest level

    @property
    def n_levels(self) -> int:
        return len(self.levels)


@jax.jit
def _schur_stiffness(
    g: BlockTridiag, d: BlockTridiag, c: BlockTridiag, mass_inv: BlockDiag
) -> BlockTridiag:
    """``A = C - D (M^-1 G)`` — the load-bearing factorization of the scheme
    (``mesh_heirarchy.jl:71-72``, ``tests/dg_convergence_test.jl:33``)."""
    return bt_sub(c, bt_mul_bt(d, bd_mul_bt(mass_inv, g)))


@jax.jit
def _schur_stiffness_penta(
    g: BlockTridiag, d: BlockTridiag, c: BlockTridiag, mass_inv: BlockDiag
):
    """Pentadiagonal ``A = C - D (M^-1 G)`` for *mixed-switch* DG levels, where
    the product's distance-2 blocks are nonzero (the reference's generic CSC A,
    ``dg_mesh.jl:114-138``, absorbs them silently; ``bt_mul_bt`` would drop
    them — see ``ops.block_penta``)."""
    from ..ops.block_penta import bp5_sub, bt_as_penta, bt_mul_bt_full

    return bp5_sub(bt_as_penta(c), bt_mul_bt_full(d, bd_mul_bt(mass_inv, g)))


def schur_stiffness(
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    mass_inv: BlockDiag,
    *,
    mixed_switch: bool = False,
):
    """Public ``A = C - D M^-1 G``.  Pass ``mixed_switch=True`` (or build from
    a ``DgMesh`` with a non-default switch) to get the exact block-pentadiagonal
    operator instead of the tridiagonal fast path."""
    if mixed_switch:
        return _schur_stiffness_penta(g, d, c, mass_inv)
    return _schur_stiffness(g, d, c, mass_inv)


def _block_level(
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    mass_inv: BlockDiag,
    penta: bool = False,
) -> BlockLevel:
    a = schur_stiffness(g, d, c, mass_inv, mixed_switch=penta)
    return BlockLevel(
        a=a, g=g, d=d, c=c, mass_inv=mass_inv.blocks, smoother=dg_smoother(a, "blockJac")
    )


MAX_COARSE_DOF = 16384  # dense-solve cap for CG coarsest levels only
DENSE_COARSE_MAX = 2048  # block levels beyond this use cyclic reduction


def _coarse_lu(level: Level) -> CoarseSolver:
    from ..ops.block_penta import BlockPenta, bp5_to_dense

    if isinstance(level, CgLevel):
        if level.a.n_nodes > MAX_COARSE_DOF:
            raise ValueError(
                f"coarsest CG level has {level.a.n_nodes} DoF (> {MAX_COARSE_DOF}); "
                "the dense coarse solve would not fit — add more coarsening levels "
                "(e.g. agglomeration levels for large element counts)"
            )
        return make_coarse_solver(cg_to_dense(level.a))
    if isinstance(level.a, BlockPenta):
        if level.a.n_dof > DENSE_COARSE_MAX:
            from ..ops.coarse_solve import make_penta_coarse_solver

            return make_penta_coarse_solver(level.a)
        return make_coarse_solver(bp5_to_dense(level.a))
    from ..ops.block_coo import BlockCOO, bcoo_to_dense

    if isinstance(level.a, BlockCOO):
        if level.a.n_dof > MAX_COARSE_DOF:
            raise ValueError(
                f"coarsest scattered level has {level.a.n_dof} DoF "
                f"(> {MAX_COARSE_DOF}); its general sparsity has no banded "
                "elimination — add more (scattered) coarsening levels"
            )
        return make_coarse_solver(bcoo_to_dense(level.a))
    if level.a.n_dof > DENSE_COARSE_MAX:
        # block cyclic reduction: O(n bs^2) memory, no size cliff (the
        # stand-in for the reference's any-size UMFPACK coarse
        # solve, solvers.jl:39)
        from ..ops.coarse_solve import make_bt_coarse_solver

        return make_bt_coarse_solver(level.a)
    return make_coarse_solver(bt_to_dense(level.a))


def build_hierarchy(
    meshes: list,
    bc: BoundaryCondition,
    a_fine: CgOperator,
    *,
    c_dir: float = 1.0,
    cg_smoother_kind: str = "jac",
) -> Hierarchy:
    """CG-topped hierarchy from a fine->coarse list of CgMesh / DgMesh / AggMesh.

    Level counts (nCG / nDG / nAgg in the reference) are inferred from the mesh
    types; the list must be CG+ [DG*] [Agg*] in that order.
    """
    n_levels = len(meshes)
    if not isinstance(meshes[0], CgMesh):
        raise ValueError("at least one CG mesh required at the top")

    levels: list[Level] = [CgLevel(a=a_fine, smoother=cg_smoother(a_fine, cg_smoother_kind))]
    transfers: list[Transfer] = []
    # once a mixed-switch DG level enters the chain, every block level below it
    # recombines into the exact pentadiagonal Schur stiffness (the Galerkin
    # projections of G, D, C preserve the flipped-vertex coupling pattern)
    mixed = False

    for i in range(1, n_levels):
        fine_mesh, mesh = meshes[i - 1], meshes[i]
        prev = levels[-1]

        if isinstance(mesh, CgMesh):
            if not isinstance(fine_mesh, CgMesh):
                raise ValueError("CG level below a non-CG level")
            l = cg_cg_interpolation(mesh, fine_mesh)
            a = cgp_galerkin(l, prev.a)
            levels.append(CgLevel(a=a, smoother=cg_smoother(a, cg_smoother_kind)))
            transfers.append(l)

        elif isinstance(mesh, DgMesh):
            if isinstance(fine_mesh, CgMesh):
                # CG -> DG seam: lumped-mass transfer + direct flux assembly
                l = dg_cg_interpolation(mesh, fine_mesh, 1)
                g, d, c = dg_flux_operators(mesh, bc, c_dir)
                mixed = mesh.u_hat_left is not None
            elif isinstance(fine_mesh, DgMesh):
                l = dg_dg_interpolation(mesh, fine_mesh)
                g = _block_galerkin(l, prev.g)
                d = _block_galerkin(l, prev.d)
                c = _block_galerkin(l, prev.c)
            else:
                raise ValueError("DG level below an agglomerated level")
            levels.append(_block_level(g, d, c, mesh.mass_inv, penta=mixed))
            transfers.append(l)

        elif isinstance(mesh, AggMesh):
            if isinstance(fine_mesh, CgMesh):
                # CG -> agg seam (nDG == 0 path, mesh_heirarchy.jl:108-117)
                l = aggdg_cg_interpolation(mesh, fine_mesh, 1)
                g, d, c = agg_flux_operators(mesh, bc, c_dir)
                mixed = mesh.u_hat_left is not None
            elif isinstance(fine_mesh, DgMesh):
                l = aggdg_dg_interpolation(mesh, fine_mesh)
                g = _block_galerkin(l, prev.g)
                d = _block_galerkin(l, prev.d)
                c = _block_galerkin(l, prev.c)
            else:
                l = aggdg_aggdg_interpolation(mesh, fine_mesh)
                g = _block_galerkin(l, prev.g)
                d = _block_galerkin(l, prev.d)
                c = _block_galerkin(l, prev.c)
            levels.append(_block_level(g, d, c, mesh.mass_inv, penta=mixed))
            transfers.append(l)
        else:
            raise TypeError(f"unknown mesh type {type(mesh)}")

    return Hierarchy(
        levels=tuple(levels), transfers=tuple(transfers), coarse=_coarse_lu(levels[-1])
    )


def build_dg_hierarchy(
    meshes: list,
    a: BlockTridiag,
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
) -> Hierarchy:
    """DG-topped hierarchy (``mesh_heirarchy.jl:140-181``): finest operators given.

    A finest mesh with a *mixed* switch must supply a block-pentadiagonal ``a``
    (``schur_stiffness(..., mixed_switch=True)``); a tridiagonal ``a`` would be
    a silent truncation of the true operator and is rejected.
    """
    from ..ops.block_penta import BlockPenta

    if not isinstance(meshes[0], DgMesh):
        raise ValueError("at least one DG mesh required at the top")
    penta = isinstance(a, BlockPenta)
    if meshes[0].u_hat_left is not None and not penta:
        raise ValueError(
            "the finest mesh has a mixed switch, which makes A = C - D M^-1 G "
            "block-PENTAdiagonal; the given block-tridiagonal `a` drops its "
            "distance-2 blocks — build it with "
            "schur_stiffness(g, d, c, mass_inv, mixed_switch=True)"
        )
    levels: list[Level] = [
        BlockLevel(
            a=a, g=g, d=d, c=c, mass_inv=meshes[0].mass_inv.blocks,
            smoother=dg_smoother(a, "blockJac"),
        )
    ]
    transfers: list[Transfer] = []
    for i in range(1, len(meshes)):
        fine_mesh, mesh = meshes[i - 1], meshes[i]
        prev = levels[-1]
        if isinstance(mesh, ScatteredAggMesh):
            from ..assembly.scattered_assembly import scattered_schur
            from ..transfer.scattered_transfer import (
                scattered_dg_interpolation,
                scattered_galerkin,
                scattered_scattered_interpolation,
            )

            if isinstance(fine_mesh, DgMesh):
                l = scattered_dg_interpolation(mesh, fine_mesh)
            elif isinstance(fine_mesh, (ScatteredAggMesh, AggMesh)):
                l = scattered_scattered_interpolation(mesh, fine_mesh)
            else:
                raise TypeError(
                    "a scattered agglomeration level must follow a DG or "
                    "agglomerated level"
                )
            gc = scattered_galerkin(l, prev.g)
            dc = scattered_galerkin(l, prev.d)
            cc = scattered_galerkin(l, prev.c)
            ac = scattered_schur(gc, dc, cc, mesh.mass_inv)
            levels.append(
                BlockLevel(
                    a=ac, g=gc, d=dc, c=cc, mass_inv=mesh.mass_inv.blocks,
                    smoother=dg_smoother(ac, "blockJac"),
                )
            )
            transfers.append(l)
            continue
        from ..ops.block_coo import BlockCOO as _BCOO

        if isinstance(prev.g, _BCOO):
            raise TypeError(
                "a contiguous level cannot follow a scattered level (its "
                "operators are general block-COO); keep the remaining levels "
                "scattered (coarsen_scattered_agg_mesh)"
            )
        if isinstance(mesh, DgMesh):
            l = dg_dg_interpolation(mesh, fine_mesh)
        elif isinstance(mesh, AggMesh):
            if isinstance(fine_mesh, DgMesh):
                l = aggdg_dg_interpolation(mesh, fine_mesh)
            else:
                l = aggdg_aggdg_interpolation(mesh, fine_mesh)
        else:
            raise TypeError("DG-topped hierarchies take DG/Agg/Scattered meshes only")
        gc = _block_galerkin(l, prev.g)
        dc = _block_galerkin(l, prev.d)
        cc = _block_galerkin(l, prev.c)
        levels.append(_block_level(gc, dc, cc, mesh.mass_inv, penta=penta))
        transfers.append(l)

    return Hierarchy(
        levels=tuple(levels), transfers=tuple(transfers), coarse=_coarse_lu(levels[-1])
    )


def strip_hierarchy(h: Hierarchy) -> Hierarchy:
    """Drop construction-only operator storage (G, D, C, level masses) from
    every block level, keeping just what the solve path reads: ``a``, the
    smoother, transfers and the coarse factorization.

    The reference keeps all per-level operators alive for the lifetime of the
    ``MeshHierarchy`` (``mesh_heirarchy.jl:17-28``); at 10^8 DoF they are ~3x
    the solve-path footprint, so for large problems strip before shipping to
    the accelerator."""
    def _strip(lv):
        if isinstance(lv, BlockLevel):
            from ..ops.block_coo import BlockCOO

            a_dtype = (
                lv.a.blocks.dtype if isinstance(lv.a, BlockCOO) else lv.a.diag.dtype
            )
            e = jnp.zeros((0, 0, 0), dtype=a_dtype)
            empty = BlockTridiag(e, e, e)
            return lv._replace(g=empty, d=empty, c=empty, mass_inv=e)
        return lv

    return Hierarchy(
        levels=tuple(_strip(lv) for lv in h.levels),
        transfers=h.transfers,
        coarse=h.coarse,
    )


def prepare_fast_smoothers(h: Hierarchy) -> Hierarchy:
    """Populate the M-form streams (``ml = S^-1 A_lower``, ``mu = S^-1 A_upper``)
    on every f32 block-tridiagonal level's block-Jacobi smoother.

    The fused Pallas multisweep kernels run in M-form (see
    ``ops.pallas.block_kernels``); without these cached streams they recompute
    the two batched einsums on every call.  ``dg_smoother`` fills them for
    levels built directly in f32; this pass covers hierarchies built in f64
    parity precision and then cast (``make_low_precision_hierarchy`` calls it
    automatically)."""
    from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother

    def fix(lv):
        if not isinstance(lv, BlockLevel) or not isinstance(lv.a, BlockTridiag):
            return lv
        if lv.a.diag.dtype != jnp.float32:
            return lv
        s = lv.smoother
        base = s.base if isinstance(s, ChebyshevSmoother) else s
        if not isinstance(base, BlockJacobiSmoother) or base.ml is not None:
            return lv
        ml = block_mul(base.inv, lv.a.lower)
        mu = block_mul(base.inv, lv.a.upper)
        nb = base._replace(ml=ml, mu=mu)
        ns = s._replace(base=nb) if isinstance(s, ChebyshevSmoother) else nb
        return lv._replace(smoother=ns)

    return h._replace(levels=tuple(fix(lv) for lv in h.levels))


def chebyshev_hierarchy(
    h: Hierarchy,
    *,
    ratio: float = 4.0,
    power_iters: int = 20,
    safety: float = 1.05,
) -> Hierarchy:
    """Wrap every level's smoother in Chebyshev acceleration (an
    extension beyond the reference's fixed-damping sweeps).

    ``lambda_max(S A)`` per level comes from ``power_iters`` power iterations
    with a deterministic start vector (setup-time, eager); the smoothed
    interval is ``[lam_hi / ratio, lam_hi * safety]``.  Use with the same
    ``n_pre``/``n_post`` as before — each "sweep" becomes one degree of the
    Chebyshev recurrence at identical cost — and expect ~2x fewer V-cycles.
    """
    import numpy as np

    from ..smoothers.smoother import ChebyshevSmoother

    new_levels = []
    for k, level in enumerate(h.levels):
        if k == len(h.levels) - 1:
            new_levels.append(level)  # coarsest level never smooths
            continue
        shape = (
            (level.a.n_nodes,)
            if isinstance(level, CgLevel)
            else (level.a.block_size, level.a.n_blocks)
        )
        from ..ops.block_coo import BlockCOO

        if isinstance(level, CgLevel):
            dtype = level.a.band.dtype
        elif isinstance(level.a, BlockCOO):
            dtype = level.a.blocks.dtype
        else:
            dtype = level.a.diag.dtype
        x0 = jnp.cos(1.7 * jnp.arange(np.prod(shape), dtype=dtype)).reshape(shape) + 0.5
        lam = _power_lam(level, x0, power_iters)
        s = ChebyshevSmoother(
            base=level.smoother,
            lam_lo=(lam * safety / ratio).astype(dtype),
            lam_hi=(lam * safety).astype(dtype),
        )
        new_levels.append(level._replace(smoother=s))
    return Hierarchy(levels=tuple(new_levels), transfers=h.transfers, coarse=h.coarse)


@_functools.partial(jax.jit, static_argnames=("iters",))
def _power_lam(level, x0, iters: int):
    """lambda_max(S A) by power iteration — one fused program per level (an
    eager loop would pay ~2000 dispatches)."""
    from ..smoothers.smoother import apply_smoother
    from .solvers import level_matvec

    def body(_, carry):
        x, _ = carry
        y = apply_smoother(level.smoother, level_matvec(level, x))
        lam = jnp.linalg.norm(y.reshape(-1))
        return y / lam, lam

    x0 = x0 / jnp.linalg.norm(x0.reshape(-1))
    _, lam = jax.lax.fori_loop(0, iters, body, (x0, jnp.asarray(1.0, x0.dtype)))
    return lam
