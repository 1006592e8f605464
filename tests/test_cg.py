"""CG discretization tests: assembly invariants + L2 convergence order p+1
(cf. reference ``tests/cg_convergence_test.jl``)."""

import numpy as np
import pytest

from agglomerationmultigrid1d.assembly import cg_rhs, cg_stiffness, cg_stiffness_and_rhs
from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
from agglomerationmultigrid1d.numerics import evaluate_nodal_basis, gauss_quad
from agglomerationmultigrid1d.ops import cg_to_dense


def solve_cg(n, p, func, bc):
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    cg = make_cg_mesh(mesh, p)
    a, f = cg_stiffness_and_rhs(cg, func, bc)
    u = np.linalg.solve(np.asarray(cg_to_dense(a)), np.asarray(f))
    return cg, u


def cg_l2_error(cg, u, u_exact):
    """Gauss-quadrature L2 error vs the exact solution (cf. cg_convergence_test.jl:56-66)."""
    p = cg.p
    qx, qw = gauss_quad(4 * p)
    basis = evaluate_nodal_basis(cg.ref.basis_coeff, qx)[:, cg.ref.pos_to_slot]  # (n_q, w)
    jac = cg.mesh.jacobians
    err2 = 0.0
    for k in range(cg.n_elements):
        uh = basis @ u[k * p : k * p + p + 1]
        xq = cg.mesh.centers[k] + jac[k] * qx
        err2 += jac[k] * np.sum(qw * (u_exact(xq) - uh) ** 2)
    return np.sqrt(err2)


def test_cg_mass_matrix_total():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 3)
    dense = np.asarray(cg_to_dense(cg.mass))
    np.testing.assert_allclose(dense, dense.T, atol=1e-14)
    np.testing.assert_allclose(dense.sum(), 1.0, atol=1e-12)  # measure of [0,1]
    np.testing.assert_allclose(np.asarray(cg.lumped_mass), dense.sum(1), atol=1e-14)


def test_cg_stiffness_dirichlet_surgery():
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    mesh = create_uniform_mesh(4, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    a = np.asarray(cg_to_dense(cg_stiffness(cg, bc)))
    nn = cg.n_nodes
    np.testing.assert_allclose(a, a.T, atol=1e-12)
    # Dirichlet row/col is identity at the last grid node
    np.testing.assert_allclose(a[-1], np.eye(nn)[-1], atol=0)
    np.testing.assert_allclose(a[:, -1], np.eye(nn)[:, -1], atol=0)
    # folded surgery == post-assembly surgery on the raw (pure-Neumann) matrix
    raw = np.array(
        cg_to_dense(cg_stiffness(cg, BoundaryCondition(("neu", 0.0), ("neu", 0.0))))
    )
    raw[-1, :] = 0.0
    raw[:, -1] = 0.0
    raw[-1, -1] = 1.0
    np.testing.assert_allclose(a, raw, atol=0)
    # the raw operator annihilates constants (pure Neumann Laplacian)
    raw_nn = np.asarray(
        cg_to_dense(cg_stiffness(cg, BoundaryCondition(("neu", 0.0), ("neu", 0.0))))
    )
    np.testing.assert_allclose(raw_nn @ np.ones(nn), 0.0, atol=1e-10)


def test_cg_rhs_matches_combined():
    bc = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 3)
    import jax.numpy as jnp

    _, f1 = cg_stiffness_and_rhs(cg, jnp.cos, bc)
    f2 = cg_rhs(cg, jnp.cos, bc)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=0)


@pytest.mark.parametrize("p,expected", [(1, 2.0), (3, 4.0)])
def test_cg_convergence_order(p, expected):
    """-u'' = cos on [0,1], u = cos, Neumann left / Dirichlet right
    (the reference's model problem, cg_convergence_test.jl:11-23)."""
    import jax.numpy as jnp

    bc = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))
    ns = [4, 8, 16, 32]
    errs = []
    for n in ns:
        cg, u = solve_cg(n, p, jnp.cos, bc)
        errs.append(cg_l2_error(cg, u, np.cos))
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / ns[-1]) - np.log10(1 / ns[0]))
    assert abs(slope - expected) < 0.25, (slope, errs)


def test_cg_exactness_for_polynomials():
    """With f = 0 and linear Dirichlet data the FEM solution is exact."""
    import jax.numpy as jnp

    bc = BoundaryCondition(("dir", 1.0), ("dir", 3.0))
    cg, u = solve_cg(8, 2, lambda x: jnp.zeros_like(x), bc)
    x = cg.node_x()
    np.testing.assert_allclose(u, 1.0 + 2.0 * x, atol=1e-10)
