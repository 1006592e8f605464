"""Multi-chip multigrid: element-axis domain decomposition via ``jax.sharding``.

Strategy (the "How to Scale Your Model" recipe, applied to a banded solver):

1. pick a 1D device mesh over axis ``"x"``;
2. annotate every fine-level operator/vector with a ``NamedSharding`` that
   splits the trailing element/node axis; levels below a size threshold stay
   fully replicated (the multigrid coarse-grid analogue of data-parallel
   replication);
3. jit the *same* ``models.solvers`` V-cycle — XLA's SPMD partitioner turns the
   pad+slice neighbor shifts of the block-tridiagonal matvecs into one-column
   ``collective-permute``s and the norm reductions into ``psum``s.

No hand-written communication on this path; the hand-scheduled
``shard_map`` variant lives in ``parallel.halo`` and
``parallel.sharded_kernels`` for when the compiler's choices need overriding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.hierarchy import BlockLevel, CgLevel, Hierarchy
from ..models.solvers import MultigridResult, multigrid, v_cycle
from ..ops.transfer_ops import BlockProlong, CgProlong, SeamProlong

AXIS = "x"


def make_solver_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (AXIS,))


def _put(x, mesh: Mesh, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))


def _shard_last(x, mesh):
    """Shard the trailing axis when it divides the device count, else replicate.

    ``device_put`` requires even division, so CG solve-path arrays (odd node
    count ``n_el * p + 1``) are ghost-padded to a device multiple first — see
    :func:`_pad_cg_level` — and only setup-only leftovers (element windows for
    odd element counts) fall back to replication.
    """
    n_dev = mesh.devices.size
    if x.ndim == 0 or x.shape[-1] % n_dev != 0:
        return _put(x, mesh, P())
    spec = P(*([None] * (x.ndim - 1) + [AXIS]))
    return _put(x, mesh, spec)


def _pad_len(n: int, n_dev: int) -> int:
    return ((n + n_dev - 1) // n_dev) * n_dev


def _pad_tail(x, target: int, fill: float = 0.0):
    if x.shape[-1] == target:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])]
    return jnp.pad(x, pad, constant_values=fill)


def _pad_cg_smoother(s, n_pad: int):
    from ..smoothers.smoother import (
        ChebyshevSmoother,
        JacobiSmoother,
        SchwarzSmoother,
    )

    if isinstance(s, JacobiSmoother):
        # padding rows of the band are identity; 1/1 keeps the inverse exact
        return JacobiSmoother(inv_diag=_pad_tail(s.inv_diag, n_pad, fill=1.0))
    if isinstance(s, SchwarzSmoother) and s.mult_inv is not None:
        return s._replace(mult_inv=_pad_tail(s.mult_inv, n_pad, fill=1.0))
    if isinstance(s, ChebyshevSmoother):
        return s._replace(base=_pad_cg_smoother(s.base, n_pad))
    return s


def _pad_cg_level(level: CgLevel, n_dev: int) -> CgLevel:
    """Ghost-pad a CG level's solve-path arrays to a device multiple.

    The padded tail of the band is the identity (diagonal 1, off-diagonals 0),
    so with zero-padded vectors the padding region is exactly inert: residuals,
    smoother updates and norms there are identically zero.  ``windows`` (and the
    derived ``n_nodes``) keep the real node count; the V-cycle crops/pads at
    level boundaries (``models.solvers._crop_cg`` / ``_pad_cg``).
    """
    from ..ops.cg_operator import CgOperator

    a = level.a
    n_pad = _pad_len(a.band.shape[1], n_dev)
    if n_pad == a.band.shape[1]:
        return level
    p = a.p
    band = _pad_tail(a.band, n_pad)
    band = band.at[p, a.band.shape[1] :].set(1.0)
    return CgLevel(
        a=CgOperator(windows=a.windows, band=band),
        smoother=_pad_cg_smoother(level.smoother, n_pad),
    )


def _replicate(tree, mesh):
    return jax.tree_util.tree_map(lambda x: _put(x, mesh, P()), tree)


def shard_hierarchy(
    h: Hierarchy, mesh: Mesh, *, min_blocks_per_device: int = 8
) -> Hierarchy:
    """Distribute a hierarchy: fine levels element-sharded, small levels replicated.

    A level is sharded when its element count gives every device at least
    ``min_blocks_per_device`` blocks; a transfer is sharded iff its coarse side
    is.  The coarsest dense LU is always replicated.
    """
    n_dev = mesh.devices.size

    def level_size(level):
        if isinstance(level, CgLevel):
            return level.a.n_el
        return level.a.n_blocks

    sharded = [level_size(lv) >= n_dev * min_blocks_per_device for lv in h.levels]
    sharded[-1] = False  # coarsest level always replicates (dense direct solve)

    new_levels = []
    for lv, sh in zip(h.levels, sharded):
        if not sh:
            new_levels.append(_replicate(lv, mesh))
        else:
            if isinstance(lv, CgLevel):
                lv = _pad_cg_level(lv, n_dev)
            new_levels.append(jax.tree_util.tree_map(lambda x: _shard_last(x, mesh), lv))

    new_transfers = []
    for k, tr in enumerate(h.transfers):
        # transfer k maps level k+1 (coarse) -> level k (fine); CgProlong is one
        # constant (w_f, w_c) matrix and is always replicated
        if sharded[k + 1] and not isinstance(tr, CgProlong):
            new_transfers.append(jax.tree_util.tree_map(lambda x: _shard_last(x, mesh), tr))
        else:
            new_transfers.append(_replicate(tr, mesh))

    return Hierarchy(
        levels=tuple(new_levels),
        transfers=tuple(new_transfers),
        coarse=_replicate(h.coarse, mesh),
    )


def shard_vector(x: jax.Array, mesh: Mesh, h: Hierarchy | None = None) -> jax.Array:
    """Shard a fine-level vector; pass the (sharded) hierarchy ``h`` so CG node
    vectors are ghost-padded to match its padded fine level."""
    if h is not None and isinstance(h.levels[0], CgLevel) and x.ndim == 1:
        x = _pad_tail(x, h.levels[0].a.band.shape[1])
    return _shard_last(x, mesh)


def unshard_vector(x: jax.Array, h: Hierarchy) -> jax.Array:
    """Crop a (possibly ghost-padded) fine-level solution back to real DoFs."""
    if isinstance(h.levels[0], CgLevel) and x.ndim == 1:
        return x[: h.levels[0].a.n_nodes]
    return x


def fused_shard_spec(h: Hierarchy, mesh: Mesh) -> tuple:
    """Build the ``shard=(mesh, axis, flags)`` argument for the fused-kernel
    V-cycle path from an already-sharded hierarchy.

    A level is flagged when its operator arrays actually carry the element-axis
    sharding (inspected, not re-derived — so the flags can never disagree with
    what :func:`shard_hierarchy` did).  Flagged block levels run their smoother
    sweeps as the temporally-blocked Pallas multisweep *inside* ``shard_map``
    with ppermute halo exchange (``parallel.sharded_kernels``); CG levels and
    replicated levels stay on XLA's automatic SPMD partitioning.
    """
    from ..ops.block_tridiag import BlockTridiag

    flags = []
    for lv in h.levels:
        ok = isinstance(lv, BlockLevel) and isinstance(lv.a, BlockTridiag)
        if ok:
            spec = getattr(lv.a.diag.sharding, "spec", P())
            ok = spec == P(None, None, AXIS)
        flags.append(bool(ok))
    return (mesh, AXIS, tuple(flags))


def distributed_v_cycle(h: Hierarchy, x0, b, mesh: Mesh | None = None, fused=False, **kw):
    """Jitted V-cycle on a sharded hierarchy (XLA inserts the collectives).

    ``fused=True`` (requires ``mesh``) routes sharded block levels through the
    shard_map fused smoother kernels — the north-star scaling path."""
    if fused and mesh is None:
        raise ValueError("fused=True requires mesh= (the jax.sharding.Mesh)")
    shard = fused_shard_spec(h, mesh) if fused else None
    return jax.jit(lambda hh, x, bb: v_cycle(hh, x, bb, shard=shard, **kw))(h, x0, b)


def distributed_multigrid(
    h: Hierarchy, x0, b, maxiter=100, tol=1e-10, *, mesh: Mesh | None = None,
    fused=False, **kw
) -> MultigridResult:
    if fused:
        if mesh is None:
            raise ValueError("fused=True requires mesh= (the jax.sharding.Mesh)")
        kw["shard"] = fused_shard_spec(h, mesh)
    return multigrid(h, x0, b, maxiter, tol, **kw)
