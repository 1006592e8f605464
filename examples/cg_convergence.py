"""CG discretization convergence study (mirrors tests/cg_convergence_test.jl).

Solves -u'' = cos on [0,1] with Neumann/Dirichlet ends at p = 3 over a mesh
sweep and prints the observed L2 convergence slope (expected ~ p + 1).
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root


import numpy as np
import jax.numpy as jnp

from agglomerationmultigrid1d.assembly import cg_stiffness_and_rhs
from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
from agglomerationmultigrid1d.numerics import evaluate_nodal_basis, gauss_quad
from agglomerationmultigrid1d.ops import cg_to_dense
from agglomerationmultigrid1d.utils import on_host

P = 3
NS = [4, 8, 16, 32, 64]


def l2_error(cg, u, u_exact):
    qx, qw = gauss_quad(4 * P)
    basis = evaluate_nodal_basis(cg.ref.basis_coeff, qx)[:, cg.ref.pos_to_slot]
    jac = cg.mesh.jacobians
    err2 = 0.0
    for k in range(cg.n_elements):
        uh = basis @ u[k * P : k * P + P + 1]
        xq = cg.mesh.centers[k] + jac[k] * qx
        err2 += jac[k] * np.sum(qw * (u_exact(xq) - uh) ** 2)
    return np.sqrt(err2)


def main():
    bc = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))
    errs = []
    with on_host():
        for n in NS:
            cg = make_cg_mesh(create_uniform_mesh(n, 0.0, 1.0), P)
            a, f = cg_stiffness_and_rhs(cg, jnp.cos, bc)
            u = np.linalg.solve(np.asarray(cg_to_dense(a)), np.asarray(f))
            errs.append(l2_error(cg, u, np.cos))
            print(f"n={n:4d}  L2 error = {errs[-1]:.3e}")
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / NS[-1]) - np.log10(1 / NS[0]))
    print(f"observed convergence order: {slope:.2f} (expected ~ {P + 1})")


if __name__ == "__main__":
    main()
