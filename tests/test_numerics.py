"""Unit tests for host-side numerics tables (L0/L1 of SURVEY's layer map)."""

import numpy as np
import pytest

from agglomerationmultigrid1d.numerics import (
    evaluate_nodal_basis,
    evaluate_nodal_basis_and_deriv,
    gauss_quad,
    legendre_vals,
    legendre_vals_and_derivs,
    make_reference_element,
    modal_basis_derivs,
    modal_basis_vals,
)


def test_legendre_against_numpy():
    x = np.linspace(-1, 1, 17)
    vals = legendre_vals(x, 6)
    for m in range(7):
        coef = np.zeros(m + 1)
        coef[m] = 1.0
        np.testing.assert_allclose(vals[:, m], np.polynomial.legendre.legval(x, coef), atol=1e-13)


def test_legendre_derivs():
    x = np.linspace(-0.9, 0.9, 11)
    _, der = legendre_vals_and_derivs(x, 5)
    eps = 1e-6
    up = legendre_vals(x + eps, 5)
    dn = legendre_vals(x - eps, 5)
    np.testing.assert_allclose(der, (up - dn) / (2 * eps), atol=1e-6)


@pytest.mark.parametrize("p", [0, 1, 2, 3, 5, 8, 16])
def test_gauss_quad_matches_leggauss(p):
    x, w = gauss_quad(p)
    n = x.shape[0]
    assert n == max(int(np.ceil((p + 1) / 2)), 1)
    if n >= 1:
        xr, wr = np.polynomial.legendre.leggauss(n)
        np.testing.assert_allclose(np.sort(x), xr, atol=1e-12)
        np.testing.assert_allclose(w[np.argsort(x)], wr, atol=1e-12)
    # exactness up to degree p
    for deg in range(p + 1):
        exact = (1 - (-1) ** (deg + 1)) / (deg + 1)
        np.testing.assert_allclose(np.sum(w * x**deg), exact, atol=1e-12)


def test_gauss_quad_p0_midpoint():
    x, w = gauss_quad(0)
    np.testing.assert_allclose(x, [0.0])
    np.testing.assert_allclose(w, [2.0])


@pytest.mark.parametrize("p", [1, 2, 3, 4, 8])
def test_reference_element_nodes_and_basis(p):
    ref = make_reference_element(p)
    # node layout: endpoints first, then interior Chebyshev descending
    assert ref.nodes_x[0] == -1.0 and ref.nodes_x[1] == 1.0
    if p > 1:
        np.testing.assert_allclose(ref.nodes_x[2:], np.cos(np.pi * np.arange(1, p) / p))
    # nodal property: basis_i(node_j) = delta_ij
    vals = evaluate_nodal_basis(ref.basis_coeff, ref.nodes_x)
    np.testing.assert_allclose(vals, np.eye(p + 1), atol=1e-12)
    # partition of unity
    x = np.linspace(-1, 1, 7)
    np.testing.assert_allclose(evaluate_nodal_basis(ref.basis_coeff, x).sum(1), 1.0, atol=1e-12)
    # derivative sums to zero
    _, der = evaluate_nodal_basis_and_deriv(ref.basis_coeff, x)
    np.testing.assert_allclose(der.sum(1), 0.0, atol=1e-11)


def test_reference_mass_p1_exact():
    ref = make_reference_element(1)
    # hat functions on [-1,1]: mass = [[2/3, 1/3], [1/3, 2/3]]
    np.testing.assert_allclose(ref.mass, [[2 / 3, 1 / 3], [1 / 3, 2 / 3]], atol=1e-14)


def test_reference_mass_spd():
    for p in (2, 3, 8):
        ref = make_reference_element(p)
        np.testing.assert_allclose(ref.mass, ref.mass.T)
        assert np.all(np.linalg.eigvalsh(ref.mass) > 0)
        # total mass = measure of [-1, 1]
        np.testing.assert_allclose(ref.mass.sum(), 2.0, atol=1e-12)


def test_slot_pos_permutation():
    for p in (1, 2, 3, 8):
        ref = make_reference_element(p)
        x_pos = ref.nodes_x[ref.pos_to_slot]
        assert np.all(np.diff(x_pos) > 0)
        np.testing.assert_array_equal(ref.slot_to_pos[ref.pos_to_slot], np.arange(p + 1))


def test_modal_basis():
    box = np.array([0.25, 0.75])
    x = np.linspace(0.25, 0.75, 5)
    v0 = modal_basis_vals(0, box, x)
    np.testing.assert_allclose(v0, 1.0)
    v1 = modal_basis_vals(1, box, x)
    np.testing.assert_allclose(v1[:, 0], 1.0)
    np.testing.assert_allclose(v1[0, 1], -1.0)
    np.testing.assert_allclose(v1[-1, 1], 1.0)
    np.testing.assert_allclose(modal_basis_derivs(1, box), [0.0, 4.0])
    with pytest.raises(ValueError):
        modal_basis_vals(2, box, x)
