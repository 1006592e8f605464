"""Agglomerated-DG tests: mesh tables, flux solve, L2 convergence
(cf. reference ``tests/aggdg_convergence_test.jl``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.assembly import agg_flux_operators, agg_flux_rhs
from agglomerationmultigrid1d.mesh import (
    BoundaryCondition,
    coarsen_agg_mesh,
    create_uniform_mesh,
    make_agg_mesh,
)
from agglomerationmultigrid1d.numerics import gauss_quad, modal_basis_vals
from agglomerationmultigrid1d.ops import (
    bd_matvec,
    bd_mul_bt,
    bd_to_dense,
    bt_matvec,
    bt_mul_bt,
    bt_sub,
    bt_to_dense,
)


def agg_solve(n, p_agg, r, func, bc, c_dir):
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    agg = make_agg_mesh(p_agg, mesh, r)
    g, d, c = agg_flux_operators(agg, bc, c_dir)
    f, rr = agg_flux_rhs(agg, func, bc, c_dir)
    a = bt_sub(c, bt_mul_bt(d, bd_mul_bt(agg.mass_inv, g)))
    b = f - bt_matvec(d, bd_matvec(agg.mass_inv, rr))
    u_flat = np.linalg.solve(np.asarray(bt_to_dense(a)), np.asarray(b).T.reshape(-1))
    u = u_flat.reshape(agg.n_agg, p_agg + 1).T
    return agg, u


def agg_l2_error(agg, u, u_exact):
    """Per base element quadrature of the modal solution (aggdg_convergence_test.jl:78-93)."""
    qx, qw = gauss_quad(4)
    jacs = agg.base_jacobians()
    centers = agg.mesh.centers.reshape(agg.n_agg, agg.r_base)
    err2 = 0.0
    for c in range(agg.n_agg):
        for s in range(agg.r_base):
            xq = centers[c, s] + jacs[c, s] * qx
            basis = modal_basis_vals(agg.p, agg.boxes[c], xq)
            uh = basis @ np.asarray(u)[:, c]
            err2 += jacs[c, s] * np.sum(qw * (u_exact(xq) - uh) ** 2)
    return np.sqrt(err2)


def test_agg_mesh_tables():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    agg = make_agg_mesh(1, mesh, 4)
    assert agg.n_agg == 2
    np.testing.assert_allclose(agg.boxes, [[0.0, 0.5], [0.5, 1.0]])
    # boundary traces of the modal basis: [1, -1] left, [1, +1] right
    np.testing.assert_allclose(agg.bd_left, [[1.0, -1.0]] * 2)
    np.testing.assert_allclose(agg.bd_right, [[1.0, 1.0]] * 2)
    np.testing.assert_allclose(agg.deriv_vals, [[0.0, 4.0]] * 2)
    # mass = diag(h, h/3) for the [1, 2(x-xc)/h] basis on a box of width h
    mass = np.asarray(bd_to_dense(agg.mass))
    np.testing.assert_allclose(mass[:2, :2], np.diag([0.5, 0.5 / 3]), atol=1e-12)


def test_agg_mesh_p0():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    agg = make_agg_mesh(0, mesh, 2)
    assert agg.block_size == 1
    np.testing.assert_allclose(np.asarray(bd_to_dense(agg.mass)), np.eye(4) * 0.25, atol=1e-14)


def test_coarsen_agg_mesh():
    mesh = create_uniform_mesh(16, 0.0, 1.0)
    a1 = make_agg_mesh(1, mesh, 4)
    a2 = coarsen_agg_mesh(a1)
    assert a2.n_agg == 2 and a2.r_base == 8 and a2.r_sub == 2
    np.testing.assert_allclose(a2.boxes, [[0.0, 0.5], [0.5, 1.0]])


@pytest.mark.parametrize("p_agg,expected,tol", [(0, 1.0, 0.3), (1, 2.0, 0.3)])
def test_agg_convergence_order(p_agg, expected, tol):
    """u = cos, Dirichlet left / Neumann right, CDir = 1.0*n, 2:1 agglomerates
    (aggdg_convergence_test.jl:8-45)."""
    bc = BoundaryCondition(("dir", np.cos(0.0)), ("neu", -np.sin(1.0)))
    ns = [8, 16, 32, 64, 128]
    errs = []
    for n in ns:
        agg, u = agg_solve(n, p_agg, 2, jnp.cos, bc, 1.0 * n)
        errs.append(agg_l2_error(agg, u, np.cos))
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (np.log10(1 / ns[-1]) - np.log10(1 / ns[0]))
    assert abs(slope - expected) < tol, (slope, errs)


def test_agg_flux_equals_dg_when_trivial():
    """A 1:1 'agglomeration' with p = 1 modal basis must reproduce the same
    solution as solving on the agglomerated space directly (sanity check that
    boundary traces and volume terms are consistent)."""
    bc = BoundaryCondition(("dir", 1.0), ("neu", 0.5))
    n = 16
    agg, u = agg_solve(n, 1, 1, lambda x: jnp.zeros_like(x), bc, 1.0 * n)
    # exact solution of -u'' = 0, u(0) = 1, u'(1) = 0.5 is u = 1 + 0.5 x
    # (modal p=1 space contains it; penalty formulation reproduces it up to CDir effects)
    err = agg_l2_error(agg, u, lambda x: 1.0 + 0.5 * x)
    assert err < 1e-8, err
