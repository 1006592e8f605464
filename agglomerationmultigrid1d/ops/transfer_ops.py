"""Structured prolongation operators (coarse -> fine) and their transposes.

The reference stores every inter-level transfer as a general sparse matrix
(``src/interpolation.jl``); here each of the three structural families gets a
dense batched representation with closed-form restriction (L^T v) and — where
the hierarchy needs it — a Galerkin triple product L^T X L that stays inside the
operator formats of this package:

* :class:`BlockProlong` — block-aligned transfers between (block-)element levels:
  DG->DG p-coarsening (r = 1), DG/CG-base -> agglomerated (r = 2 or 4), and
  agg -> agg (r = 2).  Fine block ``r*c + j`` receives coarse block ``c`` through
  ``blocks[j][:, :, c]``.
* :class:`CgProlong` — CG -> CG p-coarsening.  One constant matrix ``E`` (coarse
  nodal basis evaluated at fine nodes, grid order) applied per element with
  overlap-consistent assignment semantics, exactly reproducing the reference's
  two-pass duplicate-avoiding build (``src/interpolation.jl:14-52``).
* :class:`SeamProlong` — the CG <-> DG/agg seam (lumped-mass L2 projection,
  ``interpolation.jl:210-217``): ``L = diag(lump)^-1 N`` with ``N`` kept in
  unassembled per-base-element windows.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .block_tridiag import BlockTridiag
from .cg_operator import CgOperator, cg_from_windows
from .shifts import shift


# ---------------------------------------------------------------------------
# BlockProlong
# ---------------------------------------------------------------------------


class BlockProlong(NamedTuple):
    blocks: jax.Array  # (r, bs_f, bs_c, n_c)

    @property
    def r(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_fine(self) -> int:
        return self.blocks.shape[1]

    @property
    def bs_coarse(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.blocks.shape[3]


def block_prolong_constant(e: jax.Array, n: int) -> BlockProlong:
    """r = 1 prolongation with the same ``(bs_f, bs_c)`` matrix on every element."""
    return BlockProlong(jnp.broadcast_to(jnp.asarray(e)[None, :, :, None], (1, *e.shape, n)))


# Above this many coarse columns the prolongation runs in serialized chunks
# of at most this size (see bp_prolong).
_PROLONG_CHUNK = 1 << 20


def _bp_prolong_pads(blocks: jax.Array, xc: jax.Array) -> jax.Array:
    """Per-offset contractions interleaved onto the fine axis with native
    interior padding (``lax.pad``) — NOT an ``(bs_f, n_c, r)`` einsum +
    reshape: that intermediate puts the tiny ``r`` (2 or 4) on the minor
    axis, which a tiled layout pads many-fold."""
    r = blocks.shape[0]
    zero = jnp.zeros((), xc.dtype)
    out = None
    for j in range(r):
        oj = jnp.einsum("ibn,bn->in", blocks[j], xc)  # (bs_f, n_c)
        pj = jax.lax.pad(oj, zero, [(0, 0, 0), (j, r - 1 - j, r - 1)])
        out = pj if out is None else out + pj
    return out


def bp_prolong(l: BlockProlong, xc: jax.Array) -> jax.Array:
    """``(bs_c, n_c) -> (bs_f, r * n_c)``.

    Small transfers take the interior-pad interleave in one shot.  Above
    ``_PROLONG_CHUNK`` coarse columns the SAME formulation runs over
    serialized chunks (``fori_loop`` + dynamic_update_slice), which bounds
    the compile of interior-dilated pads at large sizes and adds no
    materialized temporaries.  Whether XLA:GPU needs the chunks is open
    (ROADMAP, serialized chunking).  Values are bit-identical between
    the two paths (each fine column is written by exactly one offset)."""
    r = l.r
    bs_f = l.blocks.shape[1]
    n_c = xc.shape[-1]
    if n_c <= _PROLONG_CHUNK:
        return _bp_prolong_pads(l.blocks, xc)

    chunks = 2
    while n_c % chunks == 0 and n_c // chunks > _PROLONG_CHUNK:
        chunks *= 2
    if n_c % chunks:  # awkward n_c: fall back to transpose+reshape interleave
        t = jnp.einsum("jibn,bn->jin", l.blocks, xc)  # (r, bs_f, n_c)
        return t.transpose(1, 2, 0).reshape(bs_f, r * n_c)
    m = n_c // chunks

    def body(c, out):
        bl = jax.lax.dynamic_slice_in_dim(l.blocks, c * m, m, axis=3)
        xcc = jax.lax.dynamic_slice_in_dim(xc, c * m, m, axis=1)
        return jax.lax.dynamic_update_slice_in_dim(
            out, _bp_prolong_pads(bl, xcc), c * (r * m), axis=1
        )

    return jax.lax.fori_loop(
        0, chunks, body, jnp.zeros((bs_f, r * n_c), xc.dtype)
    )


def _bp_restrict_strided(blocks: jax.Array, rf: jax.Array) -> jax.Array:
    out = None
    for j in range(blocks.shape[0]):
        rj = rf[:, j :: blocks.shape[0]]  # (bs_f, n_c)
        oj = jnp.einsum("ibn,in->bn", blocks[j], rj)
        out = oj if out is None else out + oj
    return out


def bp_restrict(l: BlockProlong, rf: jax.Array) -> jax.Array:
    """``L^T rf``: ``(bs_f, r * n_c) -> (bs_c, n_c)`` (strided lane slices per
    offset — the adjoint of :func:`bp_prolong`'s interior padding; same
    no-(…, n_c, r)-intermediate rationale).

    Above ``_PROLONG_CHUNK`` coarse columns the strided extraction runs over
    serialized chunks, each started from a contiguous ``dynamic_slice`` copy:
    fusing the strided slices directly with a large producer (e.g. the
    float-float defect) can make XLA emit a slow gather kernel.  Values are
    bit-identical (chunk boundaries are multiples of ``r``)."""
    r = l.r
    bs_c = l.blocks.shape[2]
    n_c = rf.shape[-1] // r
    if n_c <= _PROLONG_CHUNK:
        return _bp_restrict_strided(l.blocks, rf)
    chunks = 2
    while n_c % chunks == 0 and n_c // chunks > _PROLONG_CHUNK:
        chunks *= 2
    if n_c % chunks:
        return _bp_restrict_strided(l.blocks, rf)
    m = n_c // chunks

    def body(c, out):
        rfc = jax.lax.dynamic_slice(rf, (0, c * (r * m)), (rf.shape[0], r * m))
        blc = jax.lax.dynamic_slice(
            l.blocks, (0, 0, 0, c * m), (r, l.blocks.shape[1], bs_c, m)
        )
        return jax.lax.dynamic_update_slice(
            out, _bp_restrict_strided(blc, rfc), (0, c * m)
        )

    return jax.lax.fori_loop(
        0, chunks, body, jnp.zeros((bs_c, n_c), rf.dtype)
    )


def _sandwich(ba: jax.Array, m: jax.Array, bb: jax.Array) -> jax.Array:
    """``Ba^T M Bb`` per element: (bs_f,bs_c,n),(bs_f,bs_f,n),(bs_f,bs_c,n)->(bs_c,bs_c,n).

    Unrolled broadcast-sum, NOT einsum, for the same reason as
    :func:`~.block_tridiag.block_mul`: a dot_general with a tiny contraction
    batched over n can force a batch-major relayout; the unrolled form
    keeps n contiguous (this runs on-device in the accelerator-side
    hierarchy build)."""
    bsf, bsc = ba.shape[0], ba.shape[1]
    mb = [
        [sum(m[f, g] * bb[g, b] for g in range(bsf)) for b in range(bsc)]
        for f in range(bsf)
    ]
    out = [
        [sum(ba[f, a] * mb[f][b] for f in range(bsf)) for b in range(bsc)]
        for a in range(bsc)
    ]
    return jnp.stack([jnp.stack(row) for row in out])


@jax.jit
def bp_galerkin(l: BlockProlong, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` for block-tridiagonal fine X; result is coarse block-tridiagonal.

    Fine blocks ``r*c + j`` map to coarse block ``c``; since ``r >= 1`` and X only
    couples +-1 fine neighbors, the coarse result couples only +-1 coarse
    neighbors (through the boundary fine blocks of each group).
    """
    r, nc = l.r, l.n_coarse
    bs = x.block_size
    dg = x.diag.reshape(bs, bs, nc, r)
    lg = x.lower.reshape(bs, bs, nc, r)
    ug = x.upper.reshape(bs, bs, nc, r)
    b = l.blocks

    diag = _sandwich(b[0], dg[..., 0], b[0])
    for j in range(1, r):
        diag = diag + _sandwich(b[j], dg[..., j], b[j])
    for j in range(r - 1):
        diag = diag + _sandwich(b[j + 1], lg[..., j + 1], b[j])
        diag = diag + _sandwich(b[j], ug[..., j], b[j + 1])

    upper = _sandwich(b[r - 1], ug[..., r - 1], shift(b[0], +1))
    lower = _sandwich(b[0], lg[..., 0], shift(b[r - 1], -1))
    return BlockTridiag(lower=lower, diag=diag, upper=upper)


# ---------------------------------------------------------------------------
# RaggedBlockProlong — variable-size agglomerates
# ---------------------------------------------------------------------------


import dataclasses as _dataclasses
import functools as _functools


@_functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("blocks", "sizes", "offsets"),
    meta_fields=("n_fine",),
)
@_dataclasses.dataclass(frozen=True)
class RaggedBlockProlong:
    """Block-aligned prolongation with *variable* group sizes: coarse block ``c``
    owns the contiguous fine blocks ``offsets[c] .. offsets[c] + sizes[c] - 1``.

    Mirrors the reference's arbitrary-partition agglomeration API
    (``AgglomeratedDgMesh1(p, agg::Vector{Vector{Int64}}, ...)``,
    ``src/agglomerated_dg_mesh.jl:400-495``) in array form: tables padded to the
    max group size ``r_max`` with ZERO blocks, so clamped-index gathers/scatters
    need no masks (zero contributions are exact).  :class:`BlockProlong` remains
    the uniform fast path (pure reshapes on the solve path).
    """

    blocks: jax.Array  # (r_max, bs_f, bs_c, n_c); rows j >= sizes[c] are zero
    sizes: jax.Array  # (n_c,) int32
    offsets: jax.Array  # (n_c,) int32 — running sum of sizes, offsets[0] = 0
    n_fine: int  # static total fine block count (= sizes.sum())

    @property
    def r_max(self) -> int:
        return self.blocks.shape[0]

    @property
    def bs_fine(self) -> int:
        return self.blocks.shape[1]

    @property
    def bs_coarse(self) -> int:
        return self.blocks.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.blocks.shape[3]


def _rbp_fine_idx(l: RaggedBlockProlong) -> jax.Array:
    """(r_max, n_c) fine block index of slot (j, c), clamped into range (the
    padded slots carry zero blocks, so clamping is harmless)."""
    idx = l.offsets[None, :] + jnp.arange(l.r_max, dtype=l.offsets.dtype)[:, None]
    return jnp.minimum(idx, l.n_fine - 1)


def rbp_prolong(l: RaggedBlockProlong, xc: jax.Array) -> jax.Array:
    """``(bs_c, n_c) -> (bs_f, n_fine)``."""
    contrib = jnp.einsum("jibc,bc->ijc", l.blocks, xc)  # (bs_f, r_max, n_c)
    out = jnp.zeros((l.bs_fine, l.n_fine), dtype=xc.dtype)
    return out.at[:, _rbp_fine_idx(l)].add(contrib)


def rbp_restrict(l: RaggedBlockProlong, rf: jax.Array) -> jax.Array:
    """``L^T rf``: ``(bs_f, n_fine) -> (bs_c, n_c)``."""
    rg = rf[:, _rbp_fine_idx(l)]  # (bs_f, r_max, n_c)
    return jnp.einsum("jibc,ijc->bc", l.blocks, rg)


def _rbp_edge_blocks(l: RaggedBlockProlong):
    """(first, last): the first and last nonzero block of every group,
    each ``(bs_f, bs_c, n_c)``."""
    first = l.blocks[0]
    j_last = (l.sizes - 1)[None, None, None, :]
    last = jnp.take_along_axis(
        l.blocks, jnp.broadcast_to(j_last, (1, *l.blocks.shape[1:])), axis=0
    )[0]
    return first, last


@jax.jit
def rbp_galerkin(l: RaggedBlockProlong, x: BlockTridiag) -> BlockTridiag:
    """``L^T X L`` with ragged groups; coarse result stays block-tridiagonal
    because groups are contiguous and X couples only +-1 fine neighbors."""
    idx = _rbp_fine_idx(l)  # (r_max, n_c)
    dg = x.diag[:, :, idx]  # (bs, bs, r_max, n_c)
    lg = x.lower[:, :, idx]
    ug = x.upper[:, :, idx]
    b = l.blocks  # (r_max, bs, bs_c, n_c)

    # within-group: diag_c = sum_j B_j^T D_j B_j + B_j^T L_j B_{j-1} + B_{j-1}^T U_{j-1} B_j
    diag = jnp.einsum("jfbc,fgjc,jgdc->bdc", b, dg, b)
    if l.r_max > 1:
        diag = diag + jnp.einsum("jfbc,fgjc,jgdc->bdc", b[1:], lg[:, :, 1:], b[:-1])
        diag = diag + jnp.einsum("jfbc,fgjc,jgdc->bdc", b[:-1], ug[:, :, :-1], b[1:])

    # cross-group: through the first block of group c and the last of c +- 1
    first, last = _rbp_edge_blocks(l)
    l_first = x.lower[:, :, jnp.minimum(l.offsets, l.n_fine - 1)]  # L at fine row offsets[c]
    last_row = jnp.minimum(l.offsets + l.sizes - 1, l.n_fine - 1)
    u_last = x.upper[:, :, last_row]  # U at each group's last fine row
    lower = jnp.einsum("fbc,fgc,gdc->bdc", first, l_first, shift(last, -1))
    upper = jnp.einsum("fbc,fgc,gdc->bdc", last, u_last, shift(first, +1))
    return BlockTridiag(lower=lower, diag=diag, upper=upper)


def ragged_sizes_to_arrays(sizes) -> tuple[jax.Array, jax.Array, int]:
    """(sizes_i32, offsets_i32, n_fine) from any int sequence."""
    import numpy as np

    s = np.asarray(sizes, dtype=np.int32)
    off = np.concatenate([[0], np.cumsum(s)[:-1]]).astype(np.int32)
    return jnp.asarray(s), jnp.asarray(off), int(s.sum())


# ---------------------------------------------------------------------------
# CgProlong
# ---------------------------------------------------------------------------


class CgProlong(NamedTuple):
    e: jax.Array  # (w_f, w_c) coarse nodal basis at fine nodes, grid order

    @property
    def p_fine(self) -> int:
        return self.e.shape[0] - 1

    @property
    def p_coarse(self) -> int:
        return self.e.shape[1] - 1


def _gather_windows(x: jax.Array, p: int, n_el: int) -> jax.Array:
    """``out[a, k] = x[k * p + a]`` for a in 0..p."""
    idx = p * jnp.arange(n_el)[None, :] + jnp.arange(p + 1)[:, None]
    return x[idx]


def cgp_prolong(l: CgProlong, xc: jax.Array) -> jax.Array:
    n_el = (xc.shape[0] - 1) // l.p_coarse
    xc_win = _gather_windows(xc, l.p_coarse, n_el)  # (w_c, n_el)
    out_win = l.e @ xc_win  # (w_f, n_el)
    # deterministic overlap-consistent assembly: node 0, then positions 1..p_f of
    # every element left to right (shared vertices agree between neighbors).
    return jnp.concatenate([out_win[0, :1], out_win[1:, :].T.reshape(-1)])


def cgp_restrict(l: CgProlong, rf: jax.Array) -> jax.Array:
    """``L^T rf`` — each fine row of L appears in exactly one element window once
    row 0 is masked (the right endpoint row of window k carries vertex k+1)."""
    p_f, p_c = l.p_fine, l.p_coarse
    n_el = (rf.shape[0] - 1) // p_f
    rf_win = _gather_windows(rf, p_f, n_el)
    rf_win = rf_win.at[0, :].set(0.0)
    rc_win = l.e.T @ rf_win  # (w_c, n_el)
    rc = jnp.zeros((n_el * p_c + 1,), dtype=rf.dtype)
    idx = p_c * jnp.arange(n_el)[None, :] + jnp.arange(p_c + 1)[:, None]
    rc = rc.at[idx].add(rc_win)
    return rc.at[0].add(rf[0])


@jax.jit
def cgp_galerkin(l: CgProlong, a: CgOperator) -> CgOperator:
    """Window-level Galerkin ``L^T A L``; exact because the fine-row restriction of
    L to element k equals ``E`` on coarse window k (see ``ops.cg_operator``)."""
    coarse_windows = jnp.einsum("ac,abn,bd->cdn", l.e, a.windows, l.e)
    return cg_from_windows(coarse_windows)


# ---------------------------------------------------------------------------
# SeamProlong (CG fine level <-> DG/agg coarse level)
# ---------------------------------------------------------------------------


class SeamProlong(NamedTuple):
    n_win: jax.Array  # (w_cg, bs, r, n_c): cross-mass windows, base el e = c*r + j
    inv_lump: jax.Array  # (n_cg_nodes,) inverse lumped CG mass
    # ragged agglomerates (optional): base el e = offsets[c] + j, zero windows
    # past sizes[c] (clamped indices are then harmless)
    offsets: jax.Array | None = None  # (n_c,) int32

    @property
    def w_cg(self) -> int:
        return self.n_win.shape[0]

    @property
    def bs_coarse(self) -> int:
        return self.n_win.shape[1]

    @property
    def r(self) -> int:
        return self.n_win.shape[2]

    @property
    def n_coarse(self) -> int:
        return self.n_win.shape[3]


def _seam_indices(l: SeamProlong) -> jax.Array:
    p_cg = l.w_cg - 1
    j = jnp.arange(l.r)[None, :, None]
    a = jnp.arange(l.w_cg)[:, None, None]
    if l.offsets is None:
        c = jnp.arange(l.n_coarse)[None, None, :]
        el = c * l.r + j
    else:
        n_el = (l.inv_lump.shape[0] - 1) // p_cg
        el = jnp.minimum(l.offsets[None, None, :] + j, n_el - 1)
    return el * p_cg + a  # (w_cg, r, n_c)


def seam_prolong(l: SeamProlong, xc: jax.Array) -> jax.Array:
    """``(bs, n_c) -> (n_cg_nodes,)`` : ``diag(lump)^-1 N xc``."""
    contrib = jnp.einsum("amjc,mc->ajc", l.n_win, xc)  # (w_cg, r, n_c)
    out = jnp.zeros_like(l.inv_lump)
    out = out.at[_seam_indices(l)].add(contrib)
    return l.inv_lump * out


def seam_restrict(l: SeamProlong, rf: jax.Array) -> jax.Array:
    """``L^T rf = N^T diag(lump)^-1 rf`` : ``(n_cg_nodes,) -> (bs, n_c)``."""
    z = l.inv_lump * rf
    z_win = z[_seam_indices(l)]  # (w_cg, r, n_c)
    return jnp.einsum("amjc,ajc->mc", l.n_win, z_win)
