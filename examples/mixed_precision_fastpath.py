"""Mixed-precision fast path: f32 V-cycles inside an f64-accurate defect loop.

Solves a DG + agglomeration hierarchy to 1e-10 relative residual.  On a GPU,
levels the kernel route accepts (``ops.pallas.use_multisweep_kernel``) smooth
with the fused multisweep kernel; the rest use XLA.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root


import time

import numpy as np
import jax.numpy as jnp

from agglomerationmultigrid1d.models import (
    make_low_precision_hierarchy,
    multigrid_mixed,
    poisson_dg_hierarchy,
)


def main():
    prob = poisson_dg_hierarchy(n=1 << 13, max_p=4, n_dg=3, n_agg=6)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    t0 = time.time()
    res = multigrid_mixed(prob.hierarchy, h32, jnp.zeros_like(b), b, 80, 1e-10)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(b.T.reshape(-1)))
    rel = float(np.asarray(res.res_history)[it - 1]) / nb
    print(f"{b.size} DoF: {int(res.inner_cycles)} f32 V-cycles in {it} f64 refinement "
          f"steps, rel res {rel:.1e}, {time.time() - t0:.2f}s wall (incl. compile)")


if __name__ == "__main__":
    main()
