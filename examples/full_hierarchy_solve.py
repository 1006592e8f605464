"""The flagship multilevel solve (mirrors tests/full_heirarchy_test.jl).

4 CG levels (p = 8, 4, 2, 1) + log2(n) - 1 agglomerated levels over a mesh-size
sweep; prints the V-cycle iteration count per n — the h-independence study.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root


import numpy as np
import jax.numpy as jnp

from agglomerationmultigrid1d.models import multigrid, poisson_full_hierarchy


def main():
    for n in 2 ** np.arange(3, 10):
        prob = poisson_full_hierarchy(n=int(n))
        res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 100, 1e-10)
        it = int(res.iterations)
        print(f"n={int(n):4d}: {it} V-cycles "
              f"(final res {float(np.asarray(res.res_history)[it-1]):.2e})")


if __name__ == "__main__":
    main()
