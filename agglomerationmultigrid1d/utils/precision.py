"""Precision policies: f64 parity mode vs f32 fast path with defect correction.

The reference is Float64 throughout with tolerances down to 1e-10 relative
residual (``tests/full_heirarchy_test.jl:95``).  The fast path runs the
V-cycle in f32 (where the fused smoother kernels live) inside an f64 defect-correction outer loop — the approximate inner solve is a
preconditioner, so the outer iteration still converges to full f64 accuracy
(SURVEY §7 "hard parts" #1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tree_astype(tree, dtype):
    """Cast every floating leaf of an operator pytree to ``dtype``."""

    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x

    return jax.tree_util.tree_map(cast, tree)


def hierarchy_astype(h, dtype):
    """A dtype-cast copy of a Hierarchy (shares no precision with the original)."""
    return tree_astype(h, dtype)
