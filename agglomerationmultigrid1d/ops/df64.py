"""Float-float ("double-f32") arithmetic for f64-accurate defects from f32 data.

The mixed, progressive and true-precision solvers keep their iterates and
operators in f32 and need the defect ``r = b - A x`` to f64 accuracy (the
reference runs everything in f64, ``src/solvers.jl:33``).  This module
represents every f64 quantity as an unevaluated pair of f32s ``hi + lo`` with
``|lo| <= ulp(hi)/2`` (~2^-48 ≈ 7e-15 relative precision — far beyond the
1e-10 relative-residual targets) and evaluates the defect with error-free
transformations:

* ``two_sum``  — Knuth's branch-free exact addition (6 f32 ops),
* ``two_prod`` — Dekker's exact product via 12-bit operand splitting (17 f32
  ops; it needs every mul and add individually rounded — see
  :data:`FENCE_EFT`).

Whether this beats native f64 on a card that has it is open (ROADMAP, precision
path).

All public entry points force ``float32`` dtypes; inputs may be f64 (split
exactly) or f32 pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .block_penta import BlockPenta
from .block_tridiag import BlockTridiag
from .shifts import shift

_SPLITTER = 4097.0  # 2^12 + 1 for f32's 24-bit mantissa


class FF(NamedTuple):
    """A float-float number/array: value = hi + lo (both f32)."""

    hi: jax.Array
    lo: jax.Array


class BlockTridiagFF(NamedTuple):
    """A block-tridiagonal operator with float-float entries."""

    hi: BlockTridiag  # f32
    lo: BlockTridiag  # f32


def ff_split(x: jax.Array) -> FF:
    """Exactly split an f64 array into an f32 pair (hi = round(x), lo = round(x - hi)).

    The barrier keeps XLA from folding ``f64(f32(x))`` back to ``x``: XLA:GPU
    drops such round trips as allowed excess precision, which zeroes ``lo``
    (seen on an H100 as 3e-7 relative errors of the in-jit f64 defect)."""
    hi = jax.lax.optimization_barrier(x.astype(jnp.float32))
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return FF(hi, lo)


def ff_join(x: FF) -> jax.Array:
    """Recombine to f64 (one f64 add per element)."""
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


def bt_split(a: BlockTridiag) -> BlockTridiagFF:
    lo_parts = []
    hi_parts = []
    for d in a:
        p = ff_split(d)
        hi_parts.append(p.hi)
        lo_parts.append(p.lo)
    return BlockTridiagFF(BlockTridiag(*hi_parts), BlockTridiag(*lo_parts))


class BlockPentaFF(NamedTuple):
    """A block-pentadiagonal operator with float-float entries (mixed-switch
    DG levels, see ``ops.block_penta``)."""

    hi: BlockPenta  # f32
    lo: BlockPenta  # f32


def bp5_split(a: BlockPenta) -> BlockPentaFF:
    parts = [ff_split(d) for d in a]
    return BlockPentaFF(
        BlockPenta(*(p.hi for p in parts)), BlockPenta(*(p.lo for p in parts))
    )


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Exact a + b assuming |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = jnp.float32(_SPLITTER) * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ff_add(x: FF, y: FF) -> FF:
    """Float-float addition (QD-style 'sloppy' add: sufficient here because the
    accumulation chains are short and renormalized every step)."""
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return FF(*_quick_two_sum(s, e))


def ff_neg(x: FF) -> FF:
    return FF(-x.hi, -x.lo)


def ff_mul(x: FF, y: FF) -> FF:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return FF(*_quick_two_sum(p, e))


def ff_from_f32(x: jax.Array) -> FF:
    return FF(x, jnp.zeros_like(x))


# Whether every product and renormalized accumulator of the EFT chains is
# pinned with an ``optimization_barrier``.  Unfenced, XLA fuses the whole
# chain into one loop, and an optimizer that reassociated the accumulation or
# contracted ``a * b - c`` into an FMA would break the error-free transforms.
# Measured on an H100 (``chip_smoke.py`` phase 3, f64 reference on the card):
# the unfenced dense, stencil and CG-band defects are as exact as the fenced
# ones (~1e-13 relative), and the fences cost 7-57% of the defect time.  On
# the CPU backend, phase 3 at 2^20 dense and 2^22 stencil blocks gives equal
# fenced and unfenced errors as well (1.2e-13, 1.0e-13, 3.6e-14).  So the
# chains run unfenced; phase 3 re-measures both settings on every smoke run.
# Read at trace time.
FENCE_EFT = False


def _fence(t: FF) -> FF:
    if FENCE_EFT:
        return FF(*jax.lax.optimization_barrier((t.hi, t.lo)))
    return t


def _contract_ff(m: BlockTridiagFF, sel, x: FF, acc: FF, sign: float) -> FF:
    """acc += sign * (sel(m)[i, j, :] @ x[j, :]) over the block rows.

    Two details here guard against XLA's optimizer:

    * with :data:`FENCE_EFT`, each product and each renormalized accumulator
      pair is pinned with an ``optimization_barrier`` so the fused
      accumulation loop cannot be reassociated across the error-free
      transforms;
    * the sign is applied to the *product* (after its barrier), never to the
      multiplicand — ``(-a) * x`` invites a sign-distribution rewrite through
      Dekker's splitting that costs ~12 bits."""
    mh, ml = sel(m.hi), sel(m.lo)
    bs = mh.shape[0]
    for j in range(bs):
        a = FF(mh[:, j, :], ml[:, j, :])
        t = ff_mul(a, FF(x.hi[j : j + 1, :], x.lo[j : j + 1, :]))
        t = _fence(t)
        if sign < 0:
            t = ff_neg(t)
        acc = ff_add(acc, t)
        acc = _fence(acc)
    return acc


def ff_bt_matvec(a: BlockTridiagFF, x: FF) -> FF:
    """Block-tridiagonal matvec in float-float (cf. :func:`bt_matvec`)."""
    xm = FF(shift(x.hi, -1), shift(x.lo, -1))
    xp = FF(shift(x.hi, +1), shift(x.lo, +1))
    z = jnp.zeros_like(x.hi)
    acc = FF(z, z)
    acc = _contract_ff(a, lambda t: t.diag, x, acc, +1.0)
    acc = _contract_ff(a, lambda t: t.lower, xm, acc, +1.0)
    acc = _contract_ff(a, lambda t: t.upper, xp, acc, +1.0)
    return acc


def ff_bt_defect(a: BlockTridiagFF, x: FF, b: FF) -> FF:
    """``r = b - A x`` in float-float: one f32-speed pass, ~2^-48-accurate."""
    xm = FF(shift(x.hi, -1), shift(x.lo, -1))
    xp = FF(shift(x.hi, +1), shift(x.lo, +1))
    acc = b
    acc = _contract_ff(a, lambda t: t.diag, x, acc, -1.0)
    acc = _contract_ff(a, lambda t: t.lower, xm, acc, -1.0)
    acc = _contract_ff(a, lambda t: t.upper, xp, acc, -1.0)
    return acc


def ff_bp5_defect(a: BlockPentaFF, x: FF, b: FF) -> FF:
    """Pentadiagonal ``r = b - A x`` in float-float (mixed-switch levels):
    :func:`ff_bt_defect` plus the two distance-2 contractions."""
    acc = b
    acc = _contract_ff(a, lambda t: t.diag, x, acc, -1.0)
    for d, sel in ((-1, lambda t: t.lower), (+1, lambda t: t.upper),
                   (-2, lambda t: t.lower2), (+2, lambda t: t.upper2)):
        xs = FF(shift(x.hi, d), shift(x.lo, d))
        acc = _contract_ff(a, sel, xs, acc, -1.0)
    return acc


import dataclasses as _dataclasses
import functools as _functools


@_functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=("hi_left", "hi_mid", "hi_right", "lo_left", "lo_mid", "lo_right"),
    meta_fields=("n",),
)
@_dataclasses.dataclass(frozen=True)
class BTFFStencil:
    """A float-float block-tridiagonal operator on a UNIFORM mesh, stored as
    translation-invariant stencils instead of (bs, bs, n) streams.

    Away from the first/last ``bw`` block columns every block of the operator
    is identical (see ``models.stencil_setup``), so the defect can contract
    with ONE (bs, bs) block broadcast over the whole element axis — the
    operator contributes zero device-memory traffic and zero residency; only
    x, b and r move.  At the 10^8-DoF north star this removes ~4 GB of fine-level
    arrays.

    ``left``/``right`` hold the ``bw`` boundary columns, ``mid`` one interior
    column, each as an (hi, lo) pair of BlockTridiags; ``n`` is the full
    element count (static).  Values equal the materialized split bit-for-bit,
    so :func:`ff_defect` on this type matches :func:`ff_bt_defect` on the
    materialized pair except the boundary seam columns, which are recomputed
    with the exact boundary blocks (asserted in ``tests/test_stencil_setup``).
    """

    hi_left: BlockTridiag  # (bs, bs, bw)
    hi_mid: BlockTridiag  # (bs, bs, 1)
    hi_right: BlockTridiag  # (bs, bs, bw)
    lo_left: BlockTridiag
    lo_mid: BlockTridiag
    lo_right: BlockTridiag
    n: int


def _bt_broadcast(t: BlockTridiag, n: int) -> BlockTridiag:
    b = lambda x: jnp.broadcast_to(x, x.shape[:-1] + (n,))  # noqa: E731
    return BlockTridiag(lower=b(t.lower), diag=b(t.diag), upper=b(t.upper))


def _bt_concat(parts: list[BlockTridiag]) -> BlockTridiag:
    cat = lambda sel: jnp.concatenate([sel(p) for p in parts], axis=-1)  # noqa: E731
    return BlockTridiag(
        lower=cat(lambda t: t.lower), diag=cat(lambda t: t.diag),
        upper=cat(lambda t: t.upper),
    )


# Above this many columns the interior EFT pass runs in serialized chunks:
# the fenced full-length chain otherwise holds ~12 vector-sized temporaries
# live at once (~4.8 GB at 1e8 DoF).  Whether an 80 GB card needs the chunks
# is open (ROADMAP, serialized chunking).
_FF_DEFECT_CHUNK = 1 << 21


def _ff_mid_defect(a: BTFFStencil, x: FF, b: FF, n: int) -> FF:
    """Interior defect with the broadcast mid blocks (full-length pass)."""
    mid_ff = BlockTridiagFF(_bt_broadcast(a.hi_mid, n), _bt_broadcast(a.lo_mid, n))
    return ff_bt_defect(mid_ff, x, b)


def _ff_mid_defect_chunked(a: BTFFStencil, x: FF, b: FF, n: int, chunks: int) -> FF:
    """The same interior defect over ``chunks`` serialized segments
    (``fori_loop``): per-chunk EFT temporaries instead of vector-sized ones.
    Bit-identical to the one-shot pass — x is zero-padded by one column per
    side so every chunk sees exactly the global shift semantics."""
    m = n // chunks
    bs = x.hi.shape[0]
    xp_hi = jnp.pad(x.hi, ((0, 0), (1, 1)))
    xp_lo = jnp.pad(x.lo, ((0, 0), (1, 1)))
    mid_w = BlockTridiagFF(_bt_broadcast(a.hi_mid, m), _bt_broadcast(a.lo_mid, m))

    def body(c, out):
        o_hi, o_lo = out
        # padded coords: chunk columns [c*m + 1, c*m + m + 1), halo +-1
        xw = FF(
            jax.lax.dynamic_slice(xp_hi, (0, c * m), (bs, m + 2)),
            jax.lax.dynamic_slice(xp_lo, (0, c * m), (bs, m + 2)),
        )
        bw_ = FF(
            jax.lax.dynamic_slice(b.hi, (0, c * m), (bs, m)),
            jax.lax.dynamic_slice(b.lo, (0, c * m), (bs, m)),
        )
        # contract the interior columns directly: shifts come from the halo
        xm = FF(xw.hi[:, :m], xw.lo[:, :m])
        xc = FF(xw.hi[:, 1 : m + 1], xw.lo[:, 1 : m + 1])
        xr = FF(xw.hi[:, 2 :], xw.lo[:, 2 :])
        acc = bw_
        acc = _contract_ff(mid_w, lambda t: t.diag, xc, acc, -1.0)
        acc = _contract_ff(mid_w, lambda t: t.lower, xm, acc, -1.0)
        acc = _contract_ff(mid_w, lambda t: t.upper, xr, acc, -1.0)
        o_hi = jax.lax.dynamic_update_slice(o_hi, acc.hi, (0, c * m))
        o_lo = jax.lax.dynamic_update_slice(o_lo, acc.lo, (0, c * m))
        return o_hi, o_lo

    o_hi, o_lo = jax.lax.fori_loop(
        0, chunks, body, (jnp.empty_like(x.hi), jnp.empty_like(x.lo))
    )
    return FF(o_hi, o_lo)


def ff_bt_defect_stencil(a: BTFFStencil, x: FF, b: FF) -> FF:
    """``r = b - A x`` where A lives as stencils (see :class:`BTFFStencil`).

    One EFT pass with the broadcast mid blocks (XLA fuses the broadcasts into
    the contraction — no operator materialization), chunked above
    ``_FF_DEFECT_CHUNK`` columns (see :func:`_ff_mid_defect_chunked`), then
    the first/last ``bw`` columns are recomputed on small windows with the
    exact boundary blocks and spliced in."""
    bw = a.hi_left.diag.shape[-1]
    n = a.n
    chunks = 1
    while n % (2 * chunks) == 0 and n // chunks > 2 * _FF_DEFECT_CHUNK:
        chunks *= 2
    if chunks > 1:
        r = _ff_mid_defect_chunked(a, x, b, n, chunks)
    else:
        r = _ff_mid_defect(a, x, b, n)

    # boundary windows of width bw + 2: the defect needs the +-1 neighbor, so
    # columns [0, bw] of the window are exact (col bw + 1 reads a zero-padded
    # shift and is discarded)
    w = bw + 2
    hi_l = _bt_concat([a.hi_left, _bt_broadcast(a.hi_mid, w - bw)])
    lo_l = _bt_concat([a.lo_left, _bt_broadcast(a.lo_mid, w - bw)])
    xw = FF(x.hi[:, :w], x.lo[:, :w])
    bww = FF(b.hi[:, :w], b.lo[:, :w])
    r_l = ff_bt_defect(BlockTridiagFF(hi_l, lo_l), xw, bww)

    hi_r = _bt_concat([_bt_broadcast(a.hi_mid, w - bw), a.hi_right])
    lo_r = _bt_concat([_bt_broadcast(a.lo_mid, w - bw), a.lo_right])
    xw = FF(x.hi[:, n - w :], x.lo[:, n - w :])
    bww = FF(b.hi[:, n - w :], b.lo[:, n - w :])
    r_r = ff_bt_defect(BlockTridiagFF(hi_r, lo_r), xw, bww)

    def splice(full, left, right):
        full = jax.lax.dynamic_update_slice(full, left[:, :bw], (0, 0))
        return jax.lax.dynamic_update_slice(full, right[:, -bw:], (0, n - bw))

    return FF(splice(r.hi, r_l.hi, r_r.hi), splice(r.lo, r_l.lo, r_r.lo))


def f64_bt_defect_stencil(a: BTFFStencil, x_ff: FF, b_ff: FF) -> FF:
    """``r = b - A x`` in TRUE f64 from the stencil operator, consumed and
    produced as float-float PAIRS.

    The float-float defect's accuracy is ``2^-48 * || |A| |x| || / ||b||``
    relative — ~4e-7 at the 1e8-DoF north star's CDir = 1000 n conditioning,
    which floors the progressive iteration above the 1e-8 target (measured:
    cycles bounce in the 5e-8..4e-6 band once the true residual is below the
    defect noise).  Exact f64 block values cost nothing here: ``hi + lo`` IS
    the f64 operator, and the stencil carries only O(bw) blocks.

    Memory: the join to f64 happens PER CHUNK inside the serialized loop and
    the result is split back to (hi, lo) per chunk — no full-length f64
    buffer ever exists (each would be 0.8 GB at 1e8 DoF)."""
    n = a.n
    bs = x_ff.hi.shape[0]

    def blocks64(bt_hi: BlockTridiag, bt_lo: BlockTridiag) -> BlockTridiag:
        up = lambda h, l: h.astype(jnp.float64) + l.astype(jnp.float64)  # noqa: E731
        return BlockTridiag(
            lower=up(bt_hi.lower, bt_lo.lower),
            diag=up(bt_hi.diag, bt_lo.diag),
            upper=up(bt_hi.upper, bt_lo.upper),
        )

    mid = blocks64(a.hi_mid, a.lo_mid)
    left = blocks64(a.hi_left, a.lo_left)
    right = blocks64(a.hi_right, a.lo_right)
    bw = left.diag.shape[-1]

    def defect_win(bt: BlockTridiag, xw, bww, m):
        # xw: (bs, m + 2) with +-1 halo; bt diagonals broadcastable over m
        def c(mat, vec):
            acc = mat[:, 0, :] * vec[0:1, :]
            for j in range(1, bs):
                acc = acc + mat[:, j, :] * vec[j : j + 1, :]
            return acc

        return (
            bww
            - c(bt.diag, xw[:, 1 : m + 1])
            - c(bt.lower, xw[:, :m])
            - c(bt.upper, xw[:, 2:])
        )

    chunks = 1
    while n % (2 * chunks) == 0 and n // chunks > 2 * _FF_DEFECT_CHUNK:
        chunks *= 2
    m = n // chunks
    xp_hi = jnp.pad(x_ff.hi, ((0, 0), (1, 1)))
    xp_lo = jnp.pad(x_ff.lo, ((0, 0), (1, 1)))

    def join(hi, lo):
        return hi.astype(jnp.float64) + lo.astype(jnp.float64)

    def body(c, out):
        o_hi, o_lo = out
        xw = join(
            jax.lax.dynamic_slice(xp_hi, (0, c * m), (bs, m + 2)),
            jax.lax.dynamic_slice(xp_lo, (0, c * m), (bs, m + 2)),
        )
        bww = join(
            jax.lax.dynamic_slice(b_ff.hi, (0, c * m), (bs, m)),
            jax.lax.dynamic_slice(b_ff.lo, (0, c * m), (bs, m)),
        )
        r_hi, r_lo = ff_split(defect_win(mid, xw, bww, m))
        o_hi = jax.lax.dynamic_update_slice(o_hi, r_hi, (0, c * m))
        o_lo = jax.lax.dynamic_update_slice(o_lo, r_lo, (0, c * m))
        return o_hi, o_lo

    o_hi, o_lo = jax.lax.fori_loop(
        0, chunks, body, (jnp.empty_like(x_ff.hi), jnp.empty_like(x_ff.lo))
    )

    # boundary windows with the exact blocks (cf. ff_bt_defect_stencil)
    w = bw + 2
    mk = lambda sel_a, sel_b: BlockTridiag(  # noqa: E731
        lower=jnp.concatenate([sel_a.lower, sel_b.lower], axis=-1),
        diag=jnp.concatenate([sel_a.diag, sel_b.diag], axis=-1),
        upper=jnp.concatenate([sel_a.upper, sel_b.upper], axis=-1),
    )
    bcast = lambda t, k: BlockTridiag(  # noqa: E731
        lower=jnp.broadcast_to(t.lower, t.lower.shape[:-1] + (k,)),
        diag=jnp.broadcast_to(t.diag, t.diag.shape[:-1] + (k,)),
        upper=jnp.broadcast_to(t.upper, t.upper.shape[:-1] + (k,)),
    )
    zcol = jnp.zeros((bs, 1), jnp.float64)
    bl = mk(left, bcast(mid, w - bw))
    xw = jnp.concatenate(
        [zcol, join(x_ff.hi[:, : w + 1], x_ff.lo[:, : w + 1])], axis=1
    )  # halo: 0 | x[0..w]
    r_l_hi, r_l_lo = ff_split(
        defect_win(bl, xw, join(b_ff.hi[:, :w], b_ff.lo[:, :w]), w)
    )
    br = mk(bcast(mid, w - bw), right)
    xw = jnp.concatenate(
        [join(x_ff.hi[:, n - w - 1 :], x_ff.lo[:, n - w - 1 :]), zcol], axis=1
    )  # x[n-w-1..] | 0
    r_r_hi, r_r_lo = ff_split(
        defect_win(br, xw, join(b_ff.hi[:, n - w :], b_ff.lo[:, n - w :]), w)
    )

    def splice(full, left_v, right_v):
        full = jax.lax.dynamic_update_slice(full, left_v[:, :bw], (0, 0))
        return jax.lax.dynamic_update_slice(full, right_v[:, -bw:], (0, n - bw))

    return FF(splice(o_hi, r_l_hi, r_r_hi), splice(o_lo, r_l_lo, r_r_lo))


class CgBandFF(NamedTuple):
    """An assembled CG DIA band (see ops.cg_operator) with float-float entries."""

    hi: jax.Array  # (2p+1, n_nodes) f32
    lo: jax.Array  # (2p+1, n_nodes) f32


def cg_band_split(band: jax.Array) -> CgBandFF:
    p = ff_split(band)
    return CgBandFF(p.hi, p.lo)


def ff_cg_defect(a: CgBandFF, x: FF, b: FF) -> FF:
    """``r = b - A x`` for a scalar-banded CG operator in float-float.

    Mirrors :func:`ops.cg_operator.cg_matvec`: 2p+1 shifted MACs, fenced
    like :func:`_contract_ff` when :data:`FENCE_EFT` is set."""
    p = a.hi.shape[0] // 2
    acc = b
    for off in range(-p, p + 1):
        band = FF(a.hi[off + p], a.lo[off + p])
        xs = FF(shift(x.hi, off), shift(x.lo, off))
        t = _fence(ff_mul(band, xs))
        acc = _fence(ff_add(acc, ff_neg(t)))
    return acc


def ff_defect(a, x: FF, b: FF) -> FF:
    """Dispatch ``r = b - A x`` on the float-float operator type."""
    if isinstance(a, BlockTridiagFF):
        return ff_bt_defect(a, x, b)
    if isinstance(a, BTFFStencil):
        return ff_bt_defect_stencil(a, x, b)
    if isinstance(a, BlockPentaFF):
        return ff_bp5_defect(a, x, b)
    if isinstance(a, CgBandFF):
        return ff_cg_defect(a, x, b)
    raise TypeError(type(a))


def ff_norm(x: FF) -> jax.Array:
    """2-norm of a float-float vector, returned as f64.

    One f64 pass over the vector (join + square + sum); a negligible
    fraction of the defect cost, and the norm must be exact to f64 because the
    solver's convergence test compares it against ``tol * ||b||``."""
    v = ff_join(x).reshape(-1)
    return jnp.linalg.norm(v)
