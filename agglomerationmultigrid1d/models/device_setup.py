"""Accelerator-side hierarchy construction for large DG-topped problems.

The reference builds its whole ``MeshHierarchy`` in serial host Julia
(``mesh_heirarchy.jl:140-181``); the host-f64 counterpart here
(:func:`~.hierarchy.build_dg_hierarchy`) does the same for parity.  At 10^7+
elements that host chain — Galerkin triple products, Schur recombination,
block inverses — is bandwidth-bound on a weak host CPU (minutes), while the
same arithmetic is a few passes over device memory on the accelerator.

:func:`build_dg_hierarchy_device` therefore splits setup:

* **host, f64** (cheap, closed-form): mesh geometry, the finest-level
  operators G/D/C/M^-1, and the per-level *transfer blocks* — these involve
  coordinate differences like ``x - x_center`` that MUST be formed in f64
  (at 10^7 elements neighboring centers are an f32 ulp apart) and are O(n)
  elementwise work in fused CPU jits;
* **device, f32**: everything downstream of the f32 cast — the whole coarse
  chain of Galerkin products, Schur stiffnesses, block-Jacobi inverses,
  M-form smoother streams and Chebyshev spectral bounds — traced into ONE
  jit program (one compile, persistently cached) so setup costs a single
  dispatch instead of ~50 small programs.

The result is the same pytree a strip+cast of the host-built hierarchy would
give (``strip_hierarchy`` + ``hierarchy_astype`` + ``prepare_fast_smoothers``
+ ``chebyshev_hierarchy``), up to f32 rounding of the coarse chain: the host
path rounds the exact f64 operators, this path computes in f32 — both carry
O(eps_f32) relative error and solve identically (asserted in
``tests/test_device_setup.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.dg_mesh import DgMesh
from ..ops.block_tridiag import BlockTridiag, block_mul
from ..ops.transfer_ops import BlockProlong, bp_galerkin
from ..smoothers.smoother import (
    BlockJacobiSmoother,
    ChebyshevSmoother,
    _inv_windows_2x2,
)
from ..transfer.interpolation import (
    aggdg_aggdg_interpolation,
    aggdg_dg_interpolation,
    dg_dg_interpolation,
)
from .hierarchy import BlockLevel, Hierarchy, _coarse_lu, _schur_stiffness


def _bt_inv_diag(a: BlockTridiag) -> jax.Array:
    bs = a.block_size
    if bs == 1:
        return 1.0 / a.diag
    if bs == 2:
        return _inv_windows_2x2.__wrapped__(a.diag)
    raise ValueError("device hierarchy build supports block sizes 1 and 2")


def _power_lam_bt(a: BlockTridiag, inv: jax.Array, iters: int) -> jax.Array:
    """lambda_max(S A) for the block-Jacobi smoother, fused into the chain."""
    from ..ops.block_diag import BlockDiag, bd_matvec
    from ..ops.block_tridiag import bt_matvec

    bs, n = a.block_size, a.n_blocks
    x0 = jnp.cos(1.7 * jnp.arange(bs * n, dtype=a.diag.dtype)).reshape(bs, n) + 0.5
    x0 = x0 / jnp.linalg.norm(x0.reshape(-1))

    def body(_, carry):
        x, _ = carry
        y = bd_matvec(BlockDiag(inv), bt_matvec(a, x))
        lam = jnp.linalg.norm(y.reshape(-1))
        return y / lam, lam

    _, lam = jax.lax.fori_loop(0, iters, body, (x0, jnp.asarray(1.0, a.diag.dtype)))
    return lam


@functools.partial(jax.jit, static_argnames=("chebyshev", "power_iters"))
def _device_chain(
    a_fine: BlockTridiag,
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    transfers: tuple,  # of BlockProlong (f32, on device)
    mass_invs: tuple,  # of (bs, bs, m) per coarse level
    chebyshev: bool = True,
    power_iters: int = 20,
):
    """The whole coarse chain as one program: per level, Galerkin-project
    G/D/C, recombine ``A = C - D M^-1 G`` (``mesh_heirarchy.jl:160-170``),
    invert the diagonal blocks, form the M-form streams, and bound the
    smoothed spectrum.  Returns per-level ``(a, inv, ml, mu, lam)``; the
    coarsest entry carries the operator only (it never smooths)."""
    from ..ops.block_diag import BlockDiag

    out = []
    ops = (g, d, c)
    a = a_fine
    for k in range(len(transfers)):
        inv = _bt_inv_diag(a)
        ml = block_mul(inv, a.lower)
        mu = block_mul(inv, a.upper)
        lam = _power_lam_bt(a, inv, power_iters) if chebyshev else None
        out.append((a, inv, ml, mu, lam))
        l = transfers[k]
        ops = tuple(bp_galerkin(l, x) for x in ops)
        a = _schur_stiffness.__wrapped__(ops[0], ops[1], ops[2], BlockDiag(mass_invs[k]))
    # coarsest level: operator only (never smooths; factorized host-side)
    out.append((a, None, None, None, None))
    return out


def _cast_bp(l: BlockProlong, dtype) -> BlockProlong:
    return BlockProlong(l.blocks.astype(dtype))


def build_dg_hierarchy_device(
    meshes: list,
    a_fine,
    g: BlockTridiag,
    d: BlockTridiag,
    c: BlockTridiag,
    *,
    dtype=jnp.float32,
    chebyshev: bool = True,
    power_iters: int = 20,
    device=None,
) -> Hierarchy:
    """DG-topped f32 hierarchy with the coarse chain computed on-device.

    ``meshes`` is the fine ``DgMesh`` + ``AggMesh`` chain (uniform partitions —
    the large-problem path); ``a_fine``/``g``/``d``/``c`` the host-f64 finest
    operators (``a_fine`` may already be the f32 ``hi`` of a float-float pair,
    in which case it is shipped as-is so the pair can share it).  The result
    is stripped (no G/D/C storage) and Chebyshev-wrapped, ready for
    ``multigrid_mixed`` / ``_mixed_loop_ff``.
    """
    if device is None:
        device = jax.devices()[0]
    if not isinstance(meshes[0], DgMesh):
        raise ValueError("device hierarchy build is for DG-topped chains")
    if meshes[0].u_hat_left is not None:
        raise ValueError("device hierarchy build supports the default switch only")

    # host f64: transfer blocks (fused CPU jits), then f32 casts
    transfers = []
    for i in range(1, len(meshes)):
        fine_mesh, mesh = meshes[i - 1], meshes[i]
        if isinstance(mesh, DgMesh):
            l = dg_dg_interpolation(mesh, fine_mesh)
        elif isinstance(fine_mesh, DgMesh):
            l = aggdg_dg_interpolation(mesh, fine_mesh)
        else:
            l = aggdg_aggdg_interpolation(mesh, fine_mesh)
        if not isinstance(l, BlockProlong):
            raise ValueError("device hierarchy build requires uniform partitions")
        transfers.append(_cast_bp(l, dtype))
    # one mass per coarse mesh (DgMesh and AggMesh both carry mass_inv)
    mass_invs = tuple(m.mass_inv.blocks.astype(dtype) for m in meshes[1:])

    cast_bt = lambda x: BlockTridiag(  # noqa: E731
        x.lower.astype(dtype), x.diag.astype(dtype), x.upper.astype(dtype)
    )
    put = lambda t: jax.device_put(t, device)  # noqa: E731
    a32 = put(a_fine if a_fine.diag.dtype == dtype else cast_bt(a_fine))
    g32, d32, c32 = put(cast_bt(g)), put(cast_bt(d)), put(cast_bt(c))
    transfers = put(tuple(transfers))
    mass_invs = put(mass_invs)

    chain = _device_chain(
        a32, g32, d32, c32, transfers, mass_invs,
        chebyshev=chebyshev, power_iters=power_iters,
    )

    e = jnp.zeros((0, 0, 0), dtype=dtype)
    empty = BlockTridiag(e, e, e)
    levels = []
    for a, inv, ml, mu, lam in chain[:-1]:
        base = BlockJacobiSmoother(inv=inv, ml=ml, mu=mu)
        s = base
        if chebyshev:
            ratio, safety = 4.0, 1.05
            s = ChebyshevSmoother(
                base=base,
                lam_lo=(lam * safety / ratio).astype(dtype),
                lam_hi=(lam * safety).astype(dtype),
            )
        levels.append(
            BlockLevel(a=a, g=empty, d=empty, c=empty, mass_inv=e, smoother=s)
        )
    a_coarse = chain[-1][0]
    coarse_level = BlockLevel(
        a=a_coarse, g=empty, d=empty, c=empty, mass_inv=e,
        smoother=BlockJacobiSmoother(inv=_bt_inv_diag(a_coarse)),
    )
    levels.append(coarse_level)
    return Hierarchy(
        levels=tuple(levels),
        transfers=transfers,
        coarse=_coarse_lu(coarse_level),
    )
