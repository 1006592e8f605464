"""Multi-host (multi-process) solves: per-process LOCAL-shard construction.

The single-controller path (``parallel.distributed.shard_hierarchy``)
materializes every level globally on one host before ``device_put`` — fine for
one process driving N chips, but at the 10^8-DoF north star the global fine
level is itself the host-memory wall, and in a multi-host cluster each host can
only address its own devices anyway.  This module is the multi-host skeleton:

* :func:`initialize` wires ``jax.distributed.initialize`` (with gloo CPU
  collectives for the multi-process CPU test rig; on GPUs XLA uses NCCL);
* :func:`build_sharded_xl_problem` constructs the stencil-inflated hierarchy
  (``models.stencil_setup``) shard by shard: every process materializes ONLY
  the slices owned by its addressable devices (via
  ``jax.make_array_from_single_device_arrays``), plus the O(n/z) stencil
  problem that every process rebuilds redundantly (cheaper than communicating
  it).  No host ever holds a global fine-level array — including the rhs,
  whose volume load is evaluated per-shard.

Levels below ``min_blocks_per_device`` blocks per device replicate, exactly
like the single-controller policy; the coarse factorization always replicates.
The result solves with the same ``models.solvers`` entry points — XLA's SPMD
partitioner emits collective-permutes between hosts — or the fused
``shard=`` kernel path (``parallel.sharded_kernels``).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mesh.topology import BoundaryCondition
from ..models.hierarchy import BlockLevel, Hierarchy
from ..ops.block_tridiag import BlockTridiag
from ..ops.df64 import FF, BlockTridiagFF
from ..ops.transfer_ops import BlockProlong
from ..utils.config import HierarchySpec
from ..utils.host import on_host
from .distributed import AXIS


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    cpu_collectives: str | None = None,
    **kw,
) -> None:
    """``jax.distributed.initialize`` wrapper.

    Pass the coordinator address, process count and process id
    explicitly; for the multi-process CPU rig also and set ``cpu_collectives="gloo"`` BEFORE any backend is
    instantiated.  No-op if the distributed runtime is already up.
    """
    try:
        from jax._src import distributed as _dist

        if _dist.global_state.client is not None:  # already initialized
            return
    except Exception:  # pragma: no cover — private API moved; initialize will raise
        pass
    if cpu_collectives is not None:
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)
    jax.distributed.initialize(coordinator_address, num_processes, process_id, **kw)


def multihost_mesh(devices=None) -> Mesh:
    """1D solver mesh over ALL processes' devices (call after initialize)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (AXIS,))


# ---------------------------------------------------------------------------
# Local-shard materialization of stencil-inflated arrays
# ---------------------------------------------------------------------------


def _slice_of_inflated(st, n_big: int, lo: int, hi: int) -> np.ndarray:
    """Columns [lo, hi) of ``concat(left, mid*(n-bwl-bwr), right)`` without
    forming the global array (host NumPy; one shard's worth of memory)."""
    left, mid, right = np.asarray(st.left), np.asarray(st.mid), np.asarray(st.right)
    bwl, bwr = left.shape[-1], right.shape[-1]
    mid_end = n_big - bwr
    segs = []
    if lo < bwl:
        segs.append(left[..., lo : min(hi, bwl)])
    m0, m1 = max(lo, bwl), min(hi, mid_end)
    if m1 > m0:
        segs.append(np.broadcast_to(mid, mid.shape[:-1] + (m1 - m0,)))
    if hi > mid_end:
        r0 = max(lo, mid_end) - mid_end
        segs.append(right[..., r0 : hi - mid_end])
    return segs[0] if len(segs) == 1 else np.concatenate(segs, axis=-1)


def _slice_of_inflated_nodes(
    st, p: int, n_nodes: int, lo: int, hi: int, n_pad: int, pad_fill
) -> np.ndarray:
    """Columns [lo, hi) of the node-axis inflation (period-``p`` interior,
    see ``stencil_setup._inflate_nodes``), ghost-padded to ``n_pad`` total
    columns with ``pad_fill`` (a scalar, or one value per leading row — the
    identity tail of a padded CG band: 1 on the main diagonal, 0 off it)."""
    left, mid, right = np.asarray(st.left), np.asarray(st.mid), np.asarray(st.right)
    bwl, bwr = left.shape[-1], right.shape[-1]  # bw*p + 1 and bw*p
    mid_end = n_nodes - bwr
    segs = []
    if lo < bwl:
        segs.append(left[..., lo : min(hi, bwl)])
    m0, m1 = max(lo, bwl), min(hi, mid_end)
    if m1 > m0:
        segs.append(mid[..., (np.arange(m0, m1) - bwl) % p])
    r0, r1 = max(lo, mid_end), min(hi, n_nodes)
    if r1 > r0:
        segs.append(right[..., r0 - mid_end : r1 - mid_end])
    if hi > n_nodes:  # ghost tail (inert identity/zero region)
        n_fill = hi - max(lo, n_nodes)
        fill_col = np.broadcast_to(
            np.asarray(pad_fill, dtype=left.dtype), left.shape[:-1]
        )
        segs.append(np.repeat(fill_col[..., None], n_fill, axis=-1))
    out = segs[0] if len(segs) == 1 else np.concatenate(segs, axis=-1)
    return np.ascontiguousarray(out)


def _sharded_from_stencil(st, n_big: int, mesh: Mesh, extra_shape: tuple) -> jax.Array:
    """Assemble a globally-sharded array from a stencil: each addressable
    device gets exactly its slice, built locally."""
    shape = extra_shape + (n_big,)
    spec = P(*([None] * len(extra_shape) + [AXIS]))
    s = NamedSharding(mesh, spec)
    idx_map = s.addressable_devices_indices_map(shape)
    arrays = []
    for d, idx in idx_map.items():
        sl = idx[-1]
        lo = 0 if sl.start is None else sl.start
        hi = n_big if sl.stop is None else sl.stop
        arrays.append(jax.device_put(_slice_of_inflated(st, n_big, lo, hi), d))
    return jax.make_array_from_single_device_arrays(shape, s, arrays)


def _replicated(x, mesh: Mesh) -> jax.Array:
    """Replicate a (small) host array onto every device without collectives."""
    x = np.asarray(x)
    s = NamedSharding(mesh, P())
    arrays = [jax.device_put(x, d) for d in s.addressable_devices]
    return jax.make_array_from_single_device_arrays(x.shape, s, arrays)


def _replicate_tree(tree, mesh: Mesh):
    return jax.tree_util.tree_map(lambda x: _replicated(x, mesh), tree)


def _sharded_from_node_stencil(
    st, p: int, n_nodes: int, n_pad: int, pad_fill, mesh: Mesh, extra_shape: tuple
) -> jax.Array:
    """Assemble a globally-sharded node-axis array (ghost-padded to ``n_pad``)
    from a period-``p`` stencil, each device slice built locally."""
    shape = extra_shape + (n_pad,)
    spec = P(*([None] * len(extra_shape) + [AXIS]))
    s = NamedSharding(mesh, spec)
    idx_map = s.addressable_devices_indices_map(shape)
    arrays = []
    for d, idx in idx_map.items():
        sl = idx[-1]
        lo = 0 if sl.start is None else sl.start
        hi = n_pad if sl.stop is None else sl.stop
        arrays.append(
            jax.device_put(
                _slice_of_inflated_nodes(st, p, n_nodes, lo, hi, n_pad, pad_fill), d
            )
        )
    return jax.make_array_from_single_device_arrays(shape, s, arrays)


class _ShardPlan:
    """Like ``stencil_setup._Plan`` but each registered leaf is either sharded
    (stencil -> per-device slices) or replicated (small level)."""

    def __init__(self, z: int, bw: int, mesh: Mesh):
        self.z = z
        self.bw = bw
        self.mesh = mesh

    def el(self, arr, what: str, sharded: bool, rtol="auto"):
        from ..models.stencil_setup import _extract_el

        st = _extract_el(arr, self.bw, what, rtol)
        n_big = np.asarray(arr).shape[-1] * self.z
        if not sharded:
            # small level: inflate on the host (it IS small) and replicate
            return _replicated(_slice_of_inflated(st, n_big, 0, n_big), self.mesh)
        return _sharded_from_stencil(st, n_big, self.mesh, np.asarray(arr).shape[:-1])

    def node(self, arr, p: int, what: str, sharded: bool, n_pad: int | None = None,
             pad_fill=0.0, rtol="auto"):
        """Node-axis leaf (period ``p`` interior), ghost-padded to ``n_pad``
        columns filled with ``pad_fill`` (scalar or one value per leading
        row) so it divides evenly across devices.  ``rtol=None`` skips the
        translation-invariance check (float-float lo tails legitimately
        jitter by one ULP of hi — see stencil_setup._check_constant)."""
        from ..models.stencil_setup import _extract_nodes

        st = _extract_nodes(np.asarray(arr), p, self.bw, what, rtol)
        n_el_big = ((np.asarray(arr).shape[-1] - 1) // p) * self.z
        n_nodes = n_el_big * p + 1
        if n_pad is None:
            n_pad = n_nodes
        if not sharded:
            return _replicated(
                _slice_of_inflated_nodes(st, p, n_nodes, 0, n_pad, n_pad, pad_fill),
                self.mesh,
            )
        return _sharded_from_node_stencil(
            st, p, n_nodes, n_pad, pad_fill, self.mesh, np.asarray(arr).shape[:-1]
        )


def _shard_cg_smoother(plan: "_ShardPlan", s, p: int, what: str, sh: bool, n_pad: int):
    """Shard-local CG smoother arrays: node-axis leaves ghost-padded with the
    inert 1.0 (the padded band tail is the identity)."""
    from ..smoothers.smoother import (
        ChebyshevSmoother,
        JacobiSmoother,
        SchwarzSmoother,
    )

    if isinstance(s, ChebyshevSmoother):
        return s._replace(
            base=_shard_cg_smoother(plan, s.base, p, what + ".base", sh, n_pad)
        )
    if isinstance(s, JacobiSmoother):
        return JacobiSmoother(
            inv_diag=plan.node(
                s.inv_diag, p, what + ".inv_diag", sh, n_pad=n_pad, pad_fill=1.0
            )
        )
    if isinstance(s, SchwarzSmoother):
        w = s.inv_windows.shape[0] - 1
        return SchwarzSmoother(
            inv_windows=plan.el(s.inv_windows, what + ".inv_windows", sh),
            mult_inv=None if s.mult_inv is None else plan.node(
                s.mult_inv, w, what + ".mult_inv", sh, n_pad=n_pad, pad_fill=1.0
            ),
        )
    raise TypeError(f"shard-local build: unsupported CG smoother {type(s)}")


def build_sharded_xl_problem(
    spec: HierarchySpec,
    n: int,
    func: Callable | None = None,
    bc: BoundaryCondition | None = None,
    *,
    mesh: Mesh | None = None,
    z: int | None = None,
    bw: int = 4,
    chebyshev: bool = True,
    slim_fine: bool = False,
    ff_levels: bool = False,
    min_blocks_per_device: int = 128,
):
    """Stencil-inflated problem, constructed shard-locally — DG-topped chains
    (the north-star configuration) AND CG-topped chains (the flagship,
    ``mesh_heirarchy.jl:30-138`` ctor 1 at BASELINE config-5 scale).

    Every process runs this with identical arguments (SPMD setup); the
    returned ``(h_low, a_ff, b_ff, norm_b)`` match
    :func:`~..models.stencil_setup.build_xl_problem` +
    ``distributed.shard_hierarchy`` value-for-value, but no process ever
    materializes more than ``1/n_processes`` of any sharded level (asserted in
    ``tests/test_multihost.py``).  Sharded CG levels are ghost-padded to a
    device multiple exactly like ``distributed._pad_cg_level`` (identity band
    tail, inert); the seam transfer's ``inv_lump`` stays replicated (it is
    read at real node counts by the transfer kernels).

    ``slim_fine=True`` (DG-topped only, like the single-controller builder)
    drops the fine level's materialized off-diagonals and swaps the ff pair
    for the broadcast-stencil defect operator — the exact configuration
    ``bench.py`` runs at 10^8 DoF.  The stencils are position-independent, so
    the resulting :class:`~..ops.df64.BTFFStencil` is replicated by
    construction (O(bw) data); only x, b, r move during its defect.
    """
    from ..mesh.cg_mesh import CgMesh
    from ..models.problems import build_problem, default_model_problem
    from ..models.solvers import _ff_split_level
    from ..models.stencil_setup import (
        _share_fine_hi,
        _stencil_ff_fine,
        _stencil_mesh,
        default_stencil_factor,
    )
    from ..models.hierarchy import (
        CgLevel,
        _coarse_lu,
        chebyshev_hierarchy,
        prepare_fast_smoothers,
        strip_hierarchy,
    )
    from ..models.stencil_setup import _inflate_bt_host
    from ..ops.cg_operator import CgOperator
    from ..ops.df64 import CgBandFF
    from ..ops.transfer_ops import CgProlong, SeamProlong
    from ..smoothers.smoother import BlockJacobiSmoother, ChebyshevSmoother
    from ..utils.precision import hierarchy_astype, tree_astype

    if mesh is None:
        mesh = multihost_mesh()
    if z is None:
        z = default_stencil_factor(spec, n, bw)
    n0 = n // z
    h = 1.0 / n

    func_, u_ex, ux_ex = default_model_problem()
    func = func or func_
    if bc is None:
        bc = BoundaryCondition(("neu", ux_ex(0.0)), ("dir", u_ex(1.0)))

    # identical tiny stencil build on every process (cheaper than comms)
    with on_host():
        prob0 = build_problem(spec, n0, func, bc, mesh=_stencil_mesh(n0, h), to_device=False)
        h64 = strip_hierarchy(prob0.hierarchy)
        a_ff_small = _ff_split_level(h64.levels[0])
        h_low0 = hierarchy_astype(h64, jnp.float32)
        h_low0 = _share_fine_hi(h_low0, a_ff_small)
        h_low0 = prepare_fast_smoothers(h_low0)
        if chebyshev:
            h_low0 = chebyshev_hierarchy(h_low0, power_iters=50, safety=1.1)
        if slim_fine:
            if not isinstance(h_low0.levels[0], BlockLevel):
                raise ValueError("slim_fine requires a DG-topped chain")
            lv0 = h_low0.levels[0]
            e = jnp.zeros((0, 0, 0), dtype=jnp.float32)
            lv0 = lv0._replace(a=BlockTridiag(lower=e, diag=lv0.a.diag, upper=e))
            h_low0 = Hierarchy(
                levels=(lv0,) + h_low0.levels[1:],
                transfers=h_low0.transfers, coarse=h_low0.coarse,
            )

    n_dev = mesh.devices.size
    plan = _ShardPlan(z, bw, mesh)

    def _bt(a: BlockTridiag, what: str, sharded: bool) -> BlockTridiag:
        def one(arr, name):
            if arr is not None and hasattr(arr, "size") and arr.size == 0:
                return arr  # slim fine level: empty off-diagonals pass through
            return plan.el(arr, what + "." + name, sharded)

        return BlockTridiag(
            lower=one(a.lower, "lower"), diag=one(a.diag, "diag"),
            upper=one(a.upper, "upper"),
        )

    def _pad_nodes(n_nodes: int, sh: bool) -> int:
        if not sh:
            return n_nodes
        return ((n_nodes + n_dev - 1) // n_dev) * n_dev

    levels = []
    shard_flags = []
    cg_pads = {}  # level index -> padded node count
    for k, lv in enumerate(h_low0.levels):
        last = k == len(h_low0.levels) - 1  # coarsest always replicates
        if isinstance(lv, CgLevel):
            p = lv.a.p
            n_el_big = lv.a.n_el * z
            sh = (not last) and n_el_big >= n_dev * min_blocks_per_device \
                and n_el_big % n_dev == 0
            shard_flags.append(sh)
            n_nodes = n_el_big * p + 1
            n_pad = _pad_nodes(n_nodes, sh)
            cg_pads[k] = n_pad
            band_fill = np.zeros((2 * p + 1,))
            band_fill[p] = 1.0  # identity ghost tail (cf. _pad_cg_level)
            band = plan.node(
                lv.a.band, p, f"L{k}.band", sh, n_pad=n_pad, pad_fill=band_fill
            )
            windows = plan.el(lv.a.windows, f"L{k}.windows", sh)
            new_s = _shard_cg_smoother(plan, lv.smoother, p, f"L{k}.smoother", sh, n_pad)
            levels.append(CgLevel(a=CgOperator(windows=windows, band=band), smoother=new_s))
            continue
        assert isinstance(lv, BlockLevel)
        n_big_k = lv.a.n_blocks * z
        sh = (not last) and n_big_k >= n_dev * min_blocks_per_device \
            and n_big_k % n_dev == 0
        shard_flags.append(sh)
        s = lv.smoother
        base = s.base if isinstance(s, ChebyshevSmoother) else s
        assert isinstance(base, BlockJacobiSmoother)
        new_base = BlockJacobiSmoother(
            inv=plan.el(base.inv, f"L{k}.inv", sh),
            ml=None if base.ml is None else plan.el(base.ml, f"L{k}.ml", sh),
            mu=None if base.mu is None else plan.el(base.mu, f"L{k}.mu", sh),
        )
        new_s = s._replace(base=new_base) if isinstance(s, ChebyshevSmoother) else new_base
        levels.append(
            BlockLevel(
                a=_bt(lv.a, f"L{k}.a", sh),
                g=_replicate_tree(lv.g, mesh), d=_replicate_tree(lv.d, mesh),
                c=_replicate_tree(lv.c, mesh),
                mass_inv=_replicate_tree(lv.mass_inv, mesh),
                smoother=new_s,
            )
        )

    transfers = []
    for k, t in enumerate(h_low0.transfers):
        # transfer k maps level k+1 (coarse) -> k (fine): sharded iff coarse is
        if isinstance(t, CgProlong):
            transfers.append(_replicate_tree(t, mesh))
        elif isinstance(t, SeamProlong):
            if t.offsets is not None:
                raise ValueError("shard-local build requires uniform seam partitions")
            transfers.append(SeamProlong(
                n_win=plan.el(t.n_win, f"T{k}.n_win", shard_flags[k + 1]),
                # read at real node counts by seam_prolong/restrict — replicated
                inv_lump=plan.node(t.inv_lump, t.w_cg - 1, f"T{k}.inv_lump", False),
                offsets=None,
            ))
        else:
            assert isinstance(t, BlockProlong)
            transfers.append(BlockProlong(
                blocks=plan.el(t.blocks, f"T{k}.blocks", shard_flags[k + 1])
            ))

    # full-size coarse factorization from f64 stencils, replicated (tiny)
    coarse_lv = h64.levels[-1]
    if not (isinstance(coarse_lv, BlockLevel) and isinstance(coarse_lv.a, BlockTridiag)):
        raise TypeError(
            "shard-local build needs a block-tridiagonal coarsest level (add "
            "agglomeration levels below the CG chain)"
        )
    with on_host():
        a_coarse = _inflate_bt_host(coarse_lv.a, z, bw, "coarse.a")
        coarse = tree_astype(
            _coarse_lu(BlockLevel(a=a_coarse, g=None, d=None, c=None,
                                  mass_inv=None, smoother=None)),
            jnp.float32,
        )
    coarse = _replicate_tree(coarse, mesh)

    h_low = Hierarchy(levels=tuple(levels), transfers=tuple(transfers), coarse=coarse)

    # float-float fine operator + rhs
    fine0 = h_low0.levels[0]
    if isinstance(fine0, CgLevel):
        p = fine0.a.p
        n_pad = cg_pads[0]
        a_ff = CgBandFF(
            hi=h_low.levels[0].a.band,  # shares the sharded fine band buffers
            lo=plan.node(
                np.asarray(a_ff_small.lo), p, "a_ff.lo", shard_flags[0],
                n_pad=n_pad, pad_fill=0.0, rtol=None,  # hi pad identity, lo pad 0
            ),
        )
        b_ff, norm_b = _sharded_cg_b(
            prob0, n, h, func, bc, mesh, shard_flags[0], n_pad
        )
    elif slim_fine:
        # position-independent stencils: replicated O(bw) data by construction
        a_ff = _stencil_ff_fine(a_ff_small, n, bw, None)
        a_ff = _replicate_tree(a_ff, mesh)
        b_ff, norm_b = _sharded_dg_b(prob0, spec, n, h, func, bw, mesh, shard_flags[0])
    else:
        # hi shares the fine level's buffers, lo inflates shard-locally
        lo_bt = BlockTridiag(
            lower=plan.el(np.asarray(a_ff_small.lo.lower), "a_ff.lo.lower",
                          shard_flags[0], rtol=None),
            diag=plan.el(np.asarray(a_ff_small.lo.diag), "a_ff.lo.diag",
                         shard_flags[0], rtol=None),
            upper=plan.el(np.asarray(a_ff_small.lo.upper), "a_ff.lo.upper",
                          shard_flags[0], rtol=None),
        )
        a_ff = BlockTridiagFF(hi=h_low.levels[0].a, lo=lo_bt)
        b_ff, norm_b = _sharded_dg_b(prob0, spec, n, h, func, bw, mesh, shard_flags[0])

    if ff_levels:
        # per-level float-float operators for progressive-precision cycles
        # (cf. stencil_setup._inflate_ff_tail), built shard-locally: hi
        # shares each level's f32 buffers, lo tails slice from stencils
        from ..ops.df64 import bt_split, cg_band_split

        tail = []
        for k in range(1, len(h64.levels)):
            lv64, lv = h64.levels[k], h_low.levels[k]
            if isinstance(lv64, CgLevel):
                sp = cg_band_split(lv64.a.band)
                tail.append(CgBandFF(
                    hi=lv.a.band,
                    lo=plan.node(
                        np.asarray(sp.lo), lv64.a.p, f"a_ffs[{k}].lo",
                        shard_flags[k], n_pad=cg_pads[k], pad_fill=0.0, rtol=None,
                    ),
                ))
            else:
                sp = bt_split(lv64.a)
                tail.append(BlockTridiagFF(
                    hi=lv.a,
                    lo=BlockTridiag(
                        lower=plan.el(np.asarray(sp.lo.lower),
                                      f"a_ffs[{k}].lo.lower", shard_flags[k], rtol=None),
                        diag=plan.el(np.asarray(sp.lo.diag),
                                     f"a_ffs[{k}].lo.diag", shard_flags[k], rtol=None),
                        upper=plan.el(np.asarray(sp.lo.upper),
                                      f"a_ffs[{k}].lo.upper", shard_flags[k], rtol=None),
                    ),
                ))
        a_ff = (a_ff,) + tuple(tail)
    return h_low, a_ff, b_ff, norm_b


def _sharded_dg_b(prob0, spec, n, h, func, bw, mesh, sharded):
    """Shard-local rhs: each device's slice of the volume load is evaluated on
    its owning host (cf. ``stencil_setup._uniform_dg_b`` — every BC term is an
    additive, f-independent patch on the outermost ``bw`` elements), split to
    float-float, assembled with ``make_array_from_single_device_arrays``, and
    the global ||b|| reduced on-device (a psum across processes)."""
    from ..assembly.dg_assembly import dg_load_vector

    dg0 = prob0.meshes[0]
    ref = dg0.ref
    qw = np.asarray(ref.quad_weights)
    basis = np.asarray(ref.basis_at_quad)  # (n_q, bs)
    qx = np.asarray(ref.quad_nodes)
    with on_host():
        delta = np.asarray(prob0.b) - np.asarray(dg_load_vector(dg0, func))
    bs = delta.shape[0]
    k_patch = min(bw, delta.shape[1] // 2)

    def local_b(lo, hi):
        centers = (np.arange(lo, hi, dtype=np.float64) + 0.5) * h
        xq = centers[None, :] + (h / 2.0) * qx[:, None]  # (n_q, m)
        fv = np.asarray(func(jnp.asarray(xq))) * (h / 2.0)
        loc = np.einsum("l,li,lk->ik", qw, basis, fv)
        # left patch: global elements [0, k_patch) -> delta columns [0, k_patch)
        pl0, pl1 = max(lo, 0), min(hi, k_patch)
        if pl1 > pl0:
            loc[:, pl0 - lo : pl1 - lo] += delta[:, pl0:pl1]
        # right patch: global element n - j maps to delta column n0 - j
        pr0, pr1 = max(lo, n - k_patch), hi
        if pr1 > pr0:
            d0 = delta.shape[1] - (n - pr0)
            loc[:, pr0 - lo : pr1 - lo] += delta[:, d0 : d0 + (pr1 - pr0)]
        return loc

    shape = (bs, n)
    s = NamedSharding(mesh, P(None, AXIS) if sharded else P())
    idx_map = s.addressable_devices_indices_map(shape)
    his, los = [], []
    for d, idx in idx_map.items():
        sl = idx[-1]
        lo = 0 if sl.start is None else sl.start
        hi = n if sl.stop is None else sl.stop
        b_loc = local_b(lo, hi)
        hi32 = b_loc.astype(np.float32)
        lo32 = (b_loc - hi32.astype(np.float64)).astype(np.float32)
        his.append(jax.device_put(hi32, d))
        los.append(jax.device_put(lo32, d))
    b_hi = jax.make_array_from_single_device_arrays(shape, s, his)
    b_lo = jax.make_array_from_single_device_arrays(shape, s, los)
    return FF(b_hi, b_lo), float(np.sqrt(_global_sq_norm(b_hi, b_lo, mesh)))


def _sharded_cg_b(prob0, n, h, func, bc, mesh, sharded, n_pad):
    """Shard-local CG rhs (cf. ``stencil_setup._uniform_cg_b``): each device's
    node slice accumulates the volume load of the elements overlapping it plus
    the Neumann terms and the Dirichlet lift/overwrite on the boundary
    windows (taken from the stencil problem's raw windows — O(w) data every
    process already has).  The ghost tail [n_nodes, n_pad) is zero (inert
    against the identity-padded band)."""
    from ..assembly.cg_assembly import _raw_stiffness_windows

    cg0 = prob0.meshes[0]
    ref = cg0.ref
    p = cg0.p
    w = p + 1
    n_nodes = n * p + 1
    basis_pos = np.asarray(ref.basis_at_quad[:, ref.pos_to_slot])  # (n_q, w)
    qw = np.asarray(ref.quad_weights)
    qx = np.asarray(ref.quad_nodes)
    with on_host():
        raw0 = np.asarray(_raw_stiffness_windows(cg0))  # (w, w, n0_el)

    def local_f(lo, hi):
        hi_r = min(hi, n_nodes)
        buf = np.zeros((hi - lo,), dtype=np.float64)
        if hi_r <= lo:
            return buf
        # elements whose node window [kp, kp+p] intersects [lo, hi_r)
        k0 = max(0, -(-(lo - p) // p))
        k1 = min(n - 1, (hi_r - 1) // p)
        if k1 >= k0:
            ks = np.arange(k0, k1 + 1)
            centers = (ks + 0.5) * h
            xq = centers[:, None] + (h / 2.0) * qx[None, :]  # (m, n_q)
            fv = np.asarray(func(jnp.asarray(xq)))
            fe = (h / 2.0) * np.einsum("l,la,ml->am", qw, basis_pos, fv)  # (w, m)
            idx = p * ks[None, :] + np.arange(w)[:, None] - lo  # (w, m)
            mask = (idx >= 0) & (idx < hi_r - lo)
            np.add.at(buf, idx[mask], fe[mask])
        if bc.neu_left and lo == 0:
            buf[0] -= bc.left[1]
        if bc.neu_right and lo <= n_nodes - 1 < hi_r:
            buf[n_nodes - 1 - lo] += bc.right[1]
        if bc.dir_left:
            g = bc.left[1]
            j0, j1 = max(lo, 0), min(hi_r, w)
            if j1 > j0:
                buf[j0 - lo : j1 - lo] -= raw0[j0:j1, 0, 0] * g
            if lo == 0:
                buf[0] = g
        if bc.dir_right:
            g = bc.right[1]
            j0, j1 = max(lo, n_nodes - w), hi_r
            if j1 > j0:
                a0 = j0 - (n_nodes - w)
                buf[j0 - lo : j1 - lo] -= raw0[a0 : a0 + (j1 - j0), w - 1, -1] * g
            if lo <= n_nodes - 1 < hi_r:
                buf[n_nodes - 1 - lo] = g
        return buf

    shape = (n_pad,)
    s = NamedSharding(mesh, P(AXIS) if sharded else P())
    idx_map = s.addressable_devices_indices_map(shape)
    his, los = [], []
    for d, idx in idx_map.items():
        sl = idx[0]
        lo = 0 if sl.start is None else sl.start
        hi = n_pad if sl.stop is None else sl.stop
        b_loc = local_f(lo, hi)
        hi32 = b_loc.astype(np.float32)
        lo32 = (b_loc - hi32.astype(np.float64)).astype(np.float32)
        his.append(jax.device_put(hi32, d))
        los.append(jax.device_put(lo32, d))
    b_hi = jax.make_array_from_single_device_arrays(shape, s, his)
    b_lo = jax.make_array_from_single_device_arrays(shape, s, los)
    return FF(b_hi, b_lo), float(np.sqrt(_global_sq_norm(b_hi, b_lo, mesh)))


def _global_sq_norm(b_hi, b_lo, mesh) -> float:
    """sum((hi + lo)^2) over the global array, computed on-device so it works
    identically single- and multi-process (the reduction becomes a psum)."""
    acc_dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    f = jax.jit(
        lambda h, l: jnp.sum((h.astype(acc_dtype) + l.astype(acc_dtype)) ** 2),
        out_shardings=NamedSharding(mesh, P()),
    )
    out = f(b_hi, b_lo)
    return float(jax.device_get(out.addressable_shards[0].data))
