"""Transfer-operator tests: the reference's workhorse invariant is
*rediscretization equals Galerkin projection* — for every transfer pair the
coarse-assembled operator must match L^T X_fine L to machine precision
(cf. ``tests/dg_interpolation_test.jl:40-44``, ``aggdg_interpolation_test.jl:53-63``,
``cg_interpolation_test.jl:40-44``) — plus exact prolongation of functions that
lie in the coarse space."""

import jax.numpy as jnp
import numpy as np

from helpers import bp_dense, cgp_dense, seam_dense

from agglomerationmultigrid1d.assembly import (
    agg_flux_operators,
    cg_stiffness,
    dg_flux_operators,
)
from agglomerationmultigrid1d.mesh import (
    BoundaryCondition,
    coarsen_agg_mesh,
    create_uniform_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d.ops import (
    bd_to_dense,
    bp_galerkin,
    bp_prolong,
    bt_to_dense,
    cg_to_dense,
    cgp_galerkin,
    cgp_prolong,
    seam_prolong,
)
from agglomerationmultigrid1d.transfer import (
    aggdg_aggdg_interpolation,
    aggdg_cg_interpolation,
    aggdg_dg_interpolation,
    cg_cg_interpolation,
    dg_cg_interpolation,
    dg_dg_interpolation,
)

BC = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))


# ---------------------------------------------------------------------------
# Galerkin consistency
# ---------------------------------------------------------------------------


def test_cg_cg_galerkin_consistency():
    """Coarse-assembled CG stiffness == L^T A_f L (cg_interpolation_test.jl:40-44).

    The reference *prints* this difference; it is exactly zero in the absence of
    Dirichlet surgery (nested spaces), while with surgery both codes produce the
    same structured boundary deviation — so we assert (a) exact equality for the
    pure-Neumann operator and (b) structured Galerkin == dense L^T A L always.
    """
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    fine, coarse = make_cg_mesh(mesh, 4), make_cg_mesh(mesh, 2)
    l = cg_cg_interpolation(coarse, fine)

    bc_nn = BoundaryCondition(("neu", 0.0), ("neu", 0.0))
    a_f = cg_stiffness(fine, bc_nn)
    np.testing.assert_allclose(
        np.asarray(cg_to_dense(cgp_galerkin(l, a_f))),
        np.asarray(cg_to_dense(cg_stiffness(coarse, bc_nn))),
        atol=1e-11,
    )
    # with Dirichlet surgery: structured galerkin == dense L^T A L
    a_f_dir = cg_stiffness(fine, BC)
    ld = cgp_dense(l, 8)
    np.testing.assert_allclose(
        np.asarray(cg_to_dense(cgp_galerkin(l, a_f_dir))),
        ld.T @ np.asarray(cg_to_dense(a_f_dir)) @ ld,
        atol=1e-11,
    )
    # mass too
    m_gal = cgp_galerkin(l, fine.mass)
    np.testing.assert_allclose(
        np.asarray(cg_to_dense(m_gal)), np.asarray(cg_to_dense(coarse.mass)), atol=1e-12
    )


def test_dg_dg_galerkin_consistency():
    """G, D, C, M rediscretized == Galerkin (dg_interpolation_test.jl:40-44)."""
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    c_dir = 100.0
    fine, coarse = make_dg_mesh(mesh, 4), make_dg_mesh(mesh, 2)
    l = dg_dg_interpolation(coarse, fine)
    gf, df, cf = dg_flux_operators(fine, BC, c_dir)
    gc, dc, cc = dg_flux_operators(coarse, BC, c_dir)
    for x_f, x_c in [(gf, gc), (df, dc), (cf, cc)]:
        np.testing.assert_allclose(
            np.asarray(bt_to_dense(bp_galerkin(l, x_f))),
            np.asarray(bt_to_dense(x_c)),
            atol=1e-11,
        )
    ld = bp_dense(l)
    mf = np.asarray(bd_to_dense(fine.mass))
    np.testing.assert_allclose(ld.T @ mf @ ld, np.asarray(bd_to_dense(coarse.mass)), atol=1e-12)


def test_aggdg_dg_galerkin_consistency():
    """Agg flux ops == L^T (DG flux ops) L (aggdg_dg_interpolation_test.jl:40-50)."""
    n, c_dir = 16, 100.0
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    agg = make_agg_mesh(1, mesh, 2)
    l = aggdg_dg_interpolation(agg, dg)
    gf, df, cf = dg_flux_operators(dg, BC, c_dir)
    ga, da, ca = agg_flux_operators(agg, BC, c_dir)
    for x_f, x_a in [(gf, ga), (df, da), (cf, ca)]:
        np.testing.assert_allclose(
            np.asarray(bt_to_dense(bp_galerkin(l, x_f))),
            np.asarray(bt_to_dense(x_a)),
            atol=1e-11,
        )
    ld = bp_dense(l)
    np.testing.assert_allclose(
        ld.T @ np.asarray(bd_to_dense(dg.mass)) @ ld,
        np.asarray(bd_to_dense(agg.mass)),
        atol=1e-12,
    )


def test_aggdg_aggdg_galerkin_consistency():
    """Coarser-agglomerate rediscretization == Galerkin through the L2 transfer
    (aggdg_interpolation_test.jl:53-63)."""
    n, c_dir = 32, 100.0
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    a1 = make_agg_mesh(1, mesh, 4)
    a2 = coarsen_agg_mesh(a1)
    l = aggdg_aggdg_interpolation(a2, a1)
    g1, d1, c1 = agg_flux_operators(a1, BC, c_dir)
    g2, d2, c2 = agg_flux_operators(a2, BC, c_dir)
    for x_f, x_c in [(g1, g2), (d1, d2), (c1, c2)]:
        np.testing.assert_allclose(
            np.asarray(bt_to_dense(bp_galerkin(l, x_f))),
            np.asarray(bt_to_dense(x_c)),
            atol=1e-10,
        )
    ld = bp_dense(l)
    np.testing.assert_allclose(
        ld.T @ np.asarray(bd_to_dense(a1.mass)) @ ld,
        np.asarray(bd_to_dense(a2.mass)),
        atol=1e-12,
    )


def test_agg_4to1_equals_two_2to1(rng):
    """A direct 4:1 agglomeration equals the composition of two 2:1 steps
    (aggdg_interpolation_test.jl:45-63)."""
    mesh = create_uniform_mesh(32, 0.0, 1.0)
    a2 = make_agg_mesh(1, mesh, 2)
    a4_direct = make_agg_mesh(1, mesh, 4)
    a4_two = coarsen_agg_mesh(a2, 2)
    l_direct = aggdg_dg_dummy = None  # noqa: F841
    # composition of prolongations: dg <- a2 <- a4  vs  dg <- a4
    dg = make_dg_mesh(mesh, 1)
    l1 = aggdg_dg_interpolation(a2, dg)
    l2 = aggdg_aggdg_interpolation(a4_two, a2)
    l_comp = bp_dense(l1) @ bp_dense(l2)
    l_dir = bp_dense(aggdg_dg_interpolation(a4_direct, dg))
    np.testing.assert_allclose(l_comp, l_dir, atol=1e-11)


# ---------------------------------------------------------------------------
# prolongation exactness on functions in the coarse space
# ---------------------------------------------------------------------------


def test_cg_cg_prolongation_exact_for_coarse_polys():
    mesh = create_uniform_mesh(4, 0.0, 1.0)
    fine, coarse = make_cg_mesh(mesh, 4), make_cg_mesh(mesh, 2)
    l = cg_cg_interpolation(coarse, fine)
    xc = coarse.node_x()
    xf = fine.node_x()
    for poly in (lambda x: x, lambda x: x**2 - 0.3 * x + 1):
        uf = np.asarray(cgp_prolong(l, jnp.asarray(poly(xc))))
        np.testing.assert_allclose(uf, poly(xf), atol=1e-12)


def test_dg_dg_prolongation_exact():
    mesh = create_uniform_mesh(4, 0.0, 1.0)
    fine, coarse = make_dg_mesh(mesh, 3), make_dg_mesh(mesh, 1)
    l = dg_dg_interpolation(coarse, fine)
    xc, xf = coarse.node_x(), fine.node_x()
    uf = np.asarray(bp_prolong(l, jnp.asarray(2 * xc - 1)))
    np.testing.assert_allclose(uf, 2 * xf - 1, atol=1e-12)


def test_aggdg_dg_prolongation_exact():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 2)
    agg = make_agg_mesh(1, mesh, 2)
    l = aggdg_dg_interpolation(agg, dg)
    # modal coefficients of u = 3 + 2(x - xc)/h per agglomerate
    u_agg = jnp.asarray(np.stack([3 * np.ones(agg.n_agg), 2 * np.ones(agg.n_agg)]))
    uf = np.asarray(bp_prolong(l, u_agg))
    xf = dg.node_x()
    expected = np.empty_like(xf)
    for c in range(agg.n_agg):
        x0, x1 = agg.boxes[c]
        for s in range(agg.r_base):
            e = c * agg.r_base + s
            expected[:, e] = 3 + 2 * (2 * (xf[:, e] - (x0 + x1) / 2) / (x1 - x0))
    np.testing.assert_allclose(uf, expected, atol=1e-12)


def test_seam_transfers_reproduce_constants():
    """Lumped-mass projection maps the constant-1 DG/agg function to constant-1
    CG nodal values (row sums of L equal 1: partition of unity + lumping)."""
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    dg = make_dg_mesh(mesh, 1)
    l = dg_cg_interpolation(dg, cg, 1)
    ones_dg = jnp.ones((dg.p + 1, dg.n_elements))
    np.testing.assert_allclose(np.asarray(seam_prolong(l, ones_dg)), 1.0, atol=1e-12)

    agg = make_agg_mesh(1, mesh, 2)
    l2 = aggdg_cg_interpolation(agg, cg, 1)
    u_agg = jnp.asarray(np.stack([np.ones(agg.n_agg), np.zeros(agg.n_agg)]))
    np.testing.assert_allclose(np.asarray(seam_prolong(l2, u_agg)), 1.0, atol=1e-12)


def test_seam_dense_matches_structured(rng):
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    dg = make_dg_mesh(mesh, 1)
    for flag in (1, 2):
        l = dg_cg_interpolation(dg, cg, flag)
        ld = seam_dense(l)
        xc = jnp.asarray(rng.standard_normal((dg.p + 1, dg.n_elements)))
        np.testing.assert_allclose(
            np.asarray(seam_prolong(l, xc)), ld @ np.asarray(xc).T.reshape(-1), atol=1e-12
        )
        from agglomerationmultigrid1d.ops import seam_restrict

        rf = jnp.asarray(rng.standard_normal((cg.n_nodes,)))
        np.testing.assert_allclose(
            np.asarray(seam_restrict(l, rf)).T.reshape(-1), ld.T @ np.asarray(rf), atol=1e-12
        )
