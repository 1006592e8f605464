"""Non-contiguous (scattered) agglomeration partitions end-to-end.

Mirrors the reference's arbitrary-partition constructor
``AgglomeratedDgMesh1(mP, agg::Vector{Vector{Int64}}, mesh, baseMesh)``
(``src/agglomerated_dg_mesh.jl:400-495``): agglomerates own arbitrary sets of
base elements.  Builds a DG p=1 Poisson problem, coarsens it through two
scattered levels (each agglomerate = two separated runs), solves with the
multigrid V-cycle, and compares against (a) the equivalent contiguous
hierarchy and (b) the dense direct solution.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root


import numpy as np
import jax.numpy as jnp

from agglomerationmultigrid1d.assembly import dg_flux_operators, dg_flux_rhs
from agglomerationmultigrid1d.mesh import (
    BoundaryCondition,
    create_uniform_mesh,
    make_agg_mesh,
    make_dg_mesh,
    make_scattered_agg_mesh,
)
from agglomerationmultigrid1d.models.hierarchy import (
    build_dg_hierarchy,
    schur_stiffness,
)
from agglomerationmultigrid1d.models.solvers import multigrid
from agglomerationmultigrid1d.ops import bt_to_dense
from agglomerationmultigrid1d.ops.block_diag import bd_matvec
from agglomerationmultigrid1d.ops.block_tridiag import bt_matvec


def local_interleave_groups(n: int):
    """Per 16-element block, two interleaved agglomerates of two 4-runs:
    A = {0-3, 8-11}, B = {4-7, 12-15} (relative)."""
    groups = []
    for blk in range(n // 16):
        o = 16 * blk
        groups.append([o + i for i in (0, 1, 2, 3, 8, 9, 10, 11)])
        groups.append([o + i for i in (4, 5, 6, 7, 12, 13, 14, 15)])
    return groups


def main():
    n = 256
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    c_dir = 10.0 * n
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    a = schur_stiffness(g, d, c, dg.mass_inv)

    func = lambda x: jnp.sin(2.0 * jnp.pi * x) * (2.0 * jnp.pi) ** 2  # noqa: E731
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))

    # three two-level hierarchies, coarse level = 32 size-8 agglomerates each:
    # the further the runs of an agglomerate spread, the weaker its coarse
    # space approximates and the slower the V-cycle contracts
    sa_local = make_scattered_agg_mesh(1, mesh, local_interleave_groups(n))
    half = n // 2
    sa_far = make_scattered_agg_mesh(
        1,
        mesh,
        [
            list(range(4 * i, 4 * i + 4)) + list(range(half + 4 * i, half + 4 * i + 4))
            for i in range(half // 4)
        ],
    )
    agg_ct = make_agg_mesh(1, mesh, r_base=8)

    x_dense = np.linalg.solve(np.asarray(bt_to_dense(a)), np.asarray(b).T.reshape(-1))
    for name, cmesh in (
        ("contiguous runs of 8", agg_ct),
        ("2 runs, 4 elements apart", sa_local),
        ("2 runs, half a domain apart", sa_far),
    ):
        h = build_dg_hierarchy([dg, cmesh], a, g, d, c)
        res = multigrid(h, jnp.zeros_like(b), b, 300, 1e-10, compute_error=False)
        it = int(res.iterations)
        err = np.abs(np.asarray(res.x).T.reshape(-1) - x_dense).max()
        rr = float(np.asarray(res.res_history)[it - 1])
        note = "" if rr < 1e-9 else "  <- stalled: coarse basis spans half the domain"
        print(f"{name:30s}: {it:3d} V-cycles, final rel res {rr:.2e}, "
              f"max err vs dense {err:.2e}{note}")


if __name__ == "__main__":
    main()
