"""The north-star solve: 10^8 DoF on one GPU, to 1e-8 relative residual.

Demonstrates the full XL pipeline (cf. the reference's
``full_heirarchy_test.jl`` solve loop, scaled to BASELINE config-5 size):

1. **Stencil-inflated setup** (``models/stencil_setup.build_xl_problem``):
   O(n/z) host work; the hierarchy materializes on the accelerator as
   broadcasts.  ``slim_fine=True`` keeps only the fine diagonal (M-form
   smoother streams carry the off-diagonals) and ``ff_levels=True`` adds the
   value-accurate operator bundle (``FFOps``).
2. **TRUE-precision progressive solve** (``solvers._progressive_true_eager``):
   at this scale ``eps_f32 * kappa_elem(A) ~ 6`` and any f32-valued operator
   application inside the cycle amplifies error, so every application runs
   from the float-float operator values, the coarse solve from an f64
   factorization, and the outer defect in true f64.

Defaults to a laptop-friendly size; pass the element count for the real
thing (on one H100 it peaks near 16 GB of device memory):

    python examples/xl_north_star.py 50331648    # 1.007e8 DoF
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from agglomerationmultigrid1d.models import multigrid_true
from agglomerationmultigrid1d.models.stencil_setup import build_xl_problem
from agglomerationmultigrid1d.utils.config import HierarchySpec


def main() -> None:
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 16
    tol = 1e-8
    n_agg = max(int(np.ceil(np.log2(max(n_el / 12288, 4)) / 2)), 1)
    spec = HierarchySpec(
        cg_orders=(), dg_orders=(1,), n_agg_levels=n_agg, p_agg=1,
        agg_factor=4, c_dir=1000.0 * n_el,
    )

    t0 = time.time()
    h32, ffops, b_ff, norm_b = build_xl_problem(
        spec, n_el, slim_fine=True, ff_levels=True
    )
    jax.block_until_ready(h32.levels[0].a)
    print(f"setup: {time.time() - t0:.1f}s for {2 * n_el:.3g} DoF, "
          f"{h32.n_levels} levels")

    t0 = time.time()
    res = multigrid_true(h32, ffops, b_ff, norm_b, maxiter=40, tol=tol)
    it = int(res.iterations)
    hist = np.asarray(res.res_history)[:it] / norm_b
    print(f"solve: {time.time() - t0:.1f}s (includes compiles on first run), "
          f"{it} true-precision cycles")
    print("relative residual history:", " ".join(f"{v:.1e}" for v in hist))
    assert hist[-1] < tol


if __name__ == "__main__":
    main()
