"""DG discretization tests: flux-operator structure + L2 convergence order p+1
(cf. reference ``tests/dg_convergence_test.jl``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.assembly import dg_flux_operators, dg_flux_rhs
from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_dg_mesh
from agglomerationmultigrid1d.numerics import evaluate_nodal_basis, gauss_quad
from agglomerationmultigrid1d.ops import (
    BlockDiag,
    bd_mul_bt,
    bt_matvec,
    bt_mul_bt,
    bt_sub,
    bt_to_dense,
)


def dg_solve(n, p, func, bc, c_dir):
    """A = C - D M^-1 G,  b = f - D M^-1 r  (dg_convergence_test.jl:29-35)."""
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, p)
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    minv = dg.mass_inv
    a = bt_sub(c, bt_mul_bt(d, bd_mul_bt(minv, g)))
    from agglomerationmultigrid1d.ops import bd_matvec

    b = f - bt_matvec(d, bd_matvec(minv, r))
    a_dense = np.asarray(bt_to_dense(a))
    u_flat = np.linalg.solve(a_dense, np.asarray(b).T.reshape(-1))
    u = u_flat.reshape(dg.n_elements, p + 1).T  # back to (bs, n)
    return dg, u


def dg_l2_error(dg, u, u_exact):
    p = dg.p
    qx, qw = gauss_quad(4 * max(p, 1))
    basis = evaluate_nodal_basis(dg.ref.basis_coeff, qx)  # (n_q, w) slot order
    jac = dg.mesh.jacobians
    err2 = 0.0
    for k in range(dg.n_elements):
        uh = basis @ np.asarray(u)[:, k]
        xq = dg.mesh.centers[k] + jac[k] * qx
        err2 += jac[k] * np.sum(qw * (u_exact(xq) - uh) ** 2)
    return np.sqrt(err2)


def test_dg_operator_structure():
    """G couples only left, D only right, C only boundary diagonals."""
    bc = BoundaryCondition(("dir", 1.0), ("neu", 0.0))
    mesh = create_uniform_mesh(6, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 2)
    g, d, c = dg_flux_operators(dg, bc, 6.0)
    assert float(jnp.max(jnp.abs(g.upper))) == 0.0
    assert float(jnp.max(jnp.abs(d.lower))) == 0.0
    assert float(jnp.max(jnp.abs(c.lower))) == 0.0 and float(jnp.max(jnp.abs(c.upper))) == 0.0
    # C only at the Dirichlet (left) end
    c_dense = np.asarray(bt_to_dense(c))
    assert c_dense[0, 0] == 6.0
    assert np.count_nonzero(c_dense) == 1


def test_dg_gradient_is_weak_derivative():
    """M^-1 G u should reproduce u' for polynomial u up to degree p (interior)."""
    bc = BoundaryCondition(("neu", 1.0), ("neu", 1.0))  # u = x: u' = 1 at both ends
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    p = 3
    dg = make_dg_mesh(mesh, p)
    g, _, _ = dg_flux_operators(dg, bc, 0.0)
    x_nodes = jnp.asarray(dg.node_x())  # (bs, n)
    u = x_nodes  # u = x
    from agglomerationmultigrid1d.ops import bd_matvec

    q = bd_matvec(dg.mass_inv, bt_matvec(g, u))
    # G is the weak gradient in the sign convention of the first-order system for
    # -u'': M q = -int(phi u') for continuous u, so q = -u' = -1 for u = x
    np.testing.assert_allclose(np.asarray(q), -1.0, atol=1e-9)


@pytest.mark.parametrize("p,expected,tol", [(1, 2.0, 0.35), (3, 4.0, 0.3)])
def test_dg_convergence_order(p, expected, tol):
    """u = cos on [0,1], Dirichlet left / Neumann right, CDir = 1.0 * n
    (dg_convergence_test.jl:21-27)."""
    bc = BoundaryCondition(("dir", np.cos(0.0)), ("neu", -np.sin(1.0)))
    ns = [4, 8, 16, 32, 64]
    errs = []
    for n in ns:
        dg, u = dg_solve(n, p, jnp.cos, bc, 1.0 * n)
        errs.append(dg_l2_error(dg, u, np.cos))
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / ns[-1]) - np.log10(1 / ns[0]))
    assert abs(slope - expected) < tol, (slope, errs)


def test_dg_p0_solves():
    """p = 0 branch (finite-volume-like); first-order convergence."""
    bc = BoundaryCondition(("dir", np.cos(0.0)), ("neu", -np.sin(1.0)))
    errs = []
    ns = [8, 16, 32, 64]
    for n in ns:
        dg, u = dg_solve(n, 0, jnp.cos, bc, 1.0 * n)
        errs.append(dg_l2_error(dg, u, np.cos))
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / ns[-1]) - np.log10(1 / ns[0]))
    assert abs(slope - 1.0) < 0.35, (slope, errs)


def test_dg_schur_stiffness_spd_like():
    """The Schur stiffness must be nonsingular and block-tridiagonal-exact."""
    bc = BoundaryCondition(("dir", 1.0), ("neu", 0.0))
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 2)
    g, d, c = dg_flux_operators(dg, bc, 8.0)
    from agglomerationmultigrid1d.ops import bt_distance2_residual

    mg = bd_mul_bt(dg.mass_inv, g)
    assert float(bt_distance2_residual(d, mg)) == 0.0
    a = bt_sub(c, bt_mul_bt(d, mg))
    a_dense = np.asarray(bt_to_dense(a))
    assert np.linalg.matrix_rank(a_dense) == a_dense.shape[0]
