"""Explicit one-column halo exchange for shard_map-style SPMD code.

``halo_shift`` is the distributed twin of ``ops.shifts.shift`` for code that
runs *inside* ``jax.shard_map`` over an element-axis mesh dimension: the local
zero-padded shift is corrected by pulling the neighbor's edge column
with ``lax.ppermute`` (devices without a source keep the zero fill — exactly
the global boundary condition).

The default distributed path (``parallel.distributed``) instead relies on XLA's
SPMD partitioner to insert the equivalent collective-permutes automatically for
the pad+slice shifts; this module is the hand-scheduled variant used by ring
kernels and kept for shard_map experiments.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.shifts import shift


def halo_shift(x: jax.Array, d: int, axis_name: str) -> jax.Array:
    """``out[..., k] = x_global[..., k + d]`` on the local shard of a sharded axis."""
    if d == 0:
        return x
    if abs(d) != 1:
        # compose unit shifts (p <= 8 for CG bands; still one ppermute per step)
        out = x
        step = 1 if d > 0 else -1
        for _ in range(abs(d)):
            out = halo_shift(out, step, axis_name)
        return out

    n_dev = lax.axis_size(axis_name)
    local = shift(x, d)
    if d > 0:
        # pull the right neighbor's first column into our last slot:
        # each device i sends its first column to device i - 1
        perm = [(i, i - 1) for i in range(1, n_dev)]
        edge = lax.ppermute(x[..., :1], axis_name, perm)
        return local.at[..., -1:].set(edge)
    perm = [(i, i + 1) for i in range(n_dev - 1)]
    edge = lax.ppermute(x[..., -1:], axis_name, perm)
    return local.at[..., :1].set(edge)
