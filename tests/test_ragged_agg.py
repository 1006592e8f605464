"""Arbitrary (ragged) agglomeration partitions — the reference's
``AgglomeratedDgMesh1(p, agg::Vector{Vector{Int64}}, ...)`` API
(``src/agglomerated_dg_mesh.jl:400-495``) and recursive ``AgglomeratedDgMeshN``
from sub-agglomerate lists (``:501-559``), here with variable-size contiguous
groups.  The workhorse invariants are the same as for the uniform case:
rediscretization equals Galerkin projection, prolongations are exact on the
coarse space, and a full hierarchy on a non-power-of-two element count solves
to tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest

from helpers import rbp_dense, seam_dense

from agglomerationmultigrid1d.assembly import agg_flux_operators, agg_flux_rhs
from agglomerationmultigrid1d.mesh import (
    BoundaryCondition,
    coarsen_agg_mesh,
    create_uniform_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d.assembly import dg_flux_operators
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
from agglomerationmultigrid1d.ops.transfer_ops import (
    RaggedBlockProlong,
    rbp_galerkin,
    rbp_prolong,
    rbp_restrict,
)
from agglomerationmultigrid1d.transfer import (
    aggdg_aggdg_interpolation,
    aggdg_cg_interpolation,
    aggdg_dg_interpolation,
)
from agglomerationmultigrid1d.ops import seam_prolong, seam_restrict

BC = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))


def test_partition_api_matches_reference_form():
    """Explicit element-id lists (the reference's ``agg`` argument) == sizes."""
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    a_ids = make_agg_mesh(1, mesh, partition=[[0, 1, 2], [3, 4, 5, 6], [7, 8, 9, 10, 11]])
    a_sizes = make_agg_mesh(1, mesh, partition=[3, 4, 5])
    np.testing.assert_allclose(a_ids.boxes, a_sizes.boxes)
    np.testing.assert_allclose(
        np.asarray(bd_to_dense(a_ids.mass)), np.asarray(bd_to_dense(a_sizes.mass))
    )
    with pytest.raises(ValueError):
        make_agg_mesh(1, mesh, partition=[[0, 2, 1], [3, 4, 5, 6], [7, 8, 9, 10, 11]])
    with pytest.raises(ValueError):
        make_agg_mesh(1, mesh, partition=[3, 4, 4])


def test_ragged_matches_uniform_when_sizes_equal():
    mesh = create_uniform_mesh(16, 0.0, 1.0)
    a_u = make_agg_mesh(1, mesh, 4)
    a_r = make_agg_mesh(1, mesh, partition=[4, 4, 4, 4])
    g_u, d_u, c_u = agg_flux_operators(a_u, BC, 100.0)
    g_r, d_r, c_r = agg_flux_operators(a_r, BC, 100.0)
    for xu, xr in [(g_u, g_r), (d_u, d_r), (c_u, c_r)]:
        np.testing.assert_allclose(np.asarray(bt_to_dense(xu)), np.asarray(bt_to_dense(xr)))


@pytest.mark.parametrize("p_agg", [0, 1])
def test_ragged_aggdg_dg_galerkin_consistency(p_agg):
    """Direct ragged assembly == L^T (DG flux ops) L, sizes 3/4/5."""
    c_dir = 100.0
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    agg = make_agg_mesh(p_agg, mesh, partition=[3, 4, 5])
    l = aggdg_dg_interpolation(agg, dg)
    assert isinstance(l, RaggedBlockProlong)
    gf, df, cf = dg_flux_operators(dg, BC, c_dir)
    ga, da, ca = agg_flux_operators(agg, BC, c_dir)
    for x_f, x_a in [(gf, ga), (df, da), (cf, ca)]:
        np.testing.assert_allclose(
            np.asarray(bt_to_dense(rbp_galerkin(l, x_f))),
            np.asarray(bt_to_dense(x_a)),
            atol=1e-11,
        )
    ld = rbp_dense(l)
    np.testing.assert_allclose(
        ld.T @ np.asarray(bd_to_dense(dg.mass)) @ ld,
        np.asarray(bd_to_dense(agg.mass)),
        atol=1e-12,
    )


def test_ragged_galerkin_matches_dense_triple_product(rng):
    """rbp_galerkin == dense L^T X L for a random block-tridiagonal X."""
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    agg = make_agg_mesh(1, mesh, partition=[3, 4, 5])
    l = aggdg_dg_interpolation(agg, dg)
    from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag

    bs, n = 2, 12
    lo = rng.standard_normal((bs, bs, n))
    di = rng.standard_normal((bs, bs, n))
    up = rng.standard_normal((bs, bs, n))
    lo[:, :, 0] = up[:, :, -1] = 0.0
    x = BlockTridiag(*(jnp.asarray(m) for m in (lo, di, up)))
    ld = rbp_dense(l)
    np.testing.assert_allclose(
        np.asarray(bt_to_dense(rbp_galerkin(l, x))),
        ld.T @ np.asarray(bt_to_dense(x)) @ ld,
        atol=1e-12,
    )


def test_ragged_prolong_restrict_match_dense(rng):
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    agg = make_agg_mesh(1, mesh, partition=[3, 4, 5])
    l = aggdg_dg_interpolation(agg, dg)
    ld = rbp_dense(l)
    xc = jnp.asarray(rng.standard_normal((2, 3)))
    uf = np.asarray(rbp_prolong(l, xc))
    np.testing.assert_allclose(uf.T.reshape(-1), ld @ np.asarray(xc).T.reshape(-1), atol=1e-13)
    rf = jnp.asarray(rng.standard_normal((2, 12)))
    rc = np.asarray(rbp_restrict(l, rf))
    np.testing.assert_allclose(rc.T.reshape(-1), ld.T @ np.asarray(rf).T.reshape(-1), atol=1e-13)


def test_ragged_recursive_agglomeration_galerkin():
    """Ragged first level + ragged recursive grouping: rediscretization ==
    Galerkin through the L2 transfer (aggdg_interpolation_test.jl:53-63)."""
    c_dir = 100.0
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    a1 = make_agg_mesh(1, mesh, partition=[1, 2, 1, 2, 2, 1, 2, 1])
    a2 = coarsen_agg_mesh(a1, partition=[3, 2, 3])
    np.testing.assert_array_equal(a2.sizes, [4, 4, 4])
    l = aggdg_aggdg_interpolation(a2, a1)
    assert isinstance(l, RaggedBlockProlong)
    g1, d1, c1 = agg_flux_operators(a1, BC, c_dir)
    g2, d2, c2 = agg_flux_operators(a2, BC, c_dir)
    for x_f, x_c in [(g1, g2), (d1, d2), (c1, c2)]:
        np.testing.assert_allclose(
            np.asarray(bt_to_dense(rbp_galerkin(l, x_f))),
            np.asarray(bt_to_dense(x_c)),
            atol=1e-10,
        )
    ld = rbp_dense(l)
    np.testing.assert_allclose(
        ld.T @ np.asarray(bd_to_dense(a1.mass)) @ ld,
        np.asarray(bd_to_dense(a2.mass)),
        atol=1e-12,
    )


def test_ragged_seam_reproduces_constants_and_dense(rng):
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    agg = make_agg_mesh(1, mesh, partition=[3, 4, 5])
    l = aggdg_cg_interpolation(agg, cg, 1)
    assert l.offsets is not None
    u_agg = jnp.asarray(np.stack([np.ones(3), np.zeros(3)]))
    np.testing.assert_allclose(np.asarray(seam_prolong(l, u_agg)), 1.0, atol=1e-12)
    for flag in (1, 2):
        lf = aggdg_cg_interpolation(agg, cg, flag)
        ld = seam_dense(lf)
        xc = jnp.asarray(rng.standard_normal((2, 3)))
        np.testing.assert_allclose(
            np.asarray(seam_prolong(lf, xc)), ld @ np.asarray(xc).T.reshape(-1), atol=1e-12
        )
        rf = jnp.asarray(rng.standard_normal((cg.n_nodes,)))
        np.testing.assert_allclose(
            np.asarray(seam_restrict(lf, rf)).T.reshape(-1), ld.T @ np.asarray(rf), atol=1e-12
        )


def _agg_l2_error(agg, u, u_exact):
    qx, qw = gauss_quad(4)
    err2 = 0.0
    for c in range(agg.n_agg):
        for s in range(int(agg.sizes[c])):
            e = int(agg.offsets[c]) + s
            xq = agg.mesh.centers[e] + agg.mesh.jacobians[e] * qx
            basis = modal_basis_vals(agg.p, agg.boxes[c], xq)
            uh = basis @ np.asarray(u)[:, c]
            err2 += agg.mesh.jacobians[e] * np.sum(qw * (u_exact(xq) - uh) ** 2)
    return np.sqrt(err2)


def test_ragged_convergence_order():
    """Direct flux solve on alternating 3/5 agglomerates: O(h^2) for p_agg=1
    (same order as the uniform test; aggdg_convergence_test.jl)."""
    bc = BoundaryCondition(("dir", np.cos(0.0)), ("neu", -np.sin(1.0)))
    errs = []
    ns = [16, 32, 64]
    for n in ns:
        mesh = create_uniform_mesh(n, 0.0, 1.0)
        part = [3, 5] * (n // 8)
        agg = make_agg_mesh(1, mesh, partition=part)
        g, d, c = agg_flux_operators(agg, bc, 1.0 * n)
        f, rr = agg_flux_rhs(agg, jnp.cos, bc, 1.0 * n)
        a = bt_sub(c, bt_mul_bt(d, bd_mul_bt(agg.mass_inv, g)))
        b = f - bt_matvec(d, bd_matvec(agg.mass_inv, rr))
        u_flat = np.linalg.solve(np.asarray(bt_to_dense(a)), np.asarray(b).T.reshape(-1))
        u = u_flat.reshape(agg.n_agg, 2).T
        errs.append(_agg_l2_error(agg, u, np.cos))
    slope = (np.log10(errs[-1]) - np.log10(errs[0])) / (
        np.log10(1 / ns[-1]) - np.log10(1 / ns[0])
    )
    assert abs(slope - 2.0) < 0.35, (slope, errs)


def test_non_power_of_two_full_hierarchy():
    """A full CG+agg hierarchy on n = 96 (not a power of two) builds via
    near-uniform ragged partitions and converges h-independently."""
    from agglomerationmultigrid1d.models.problems import poisson_full_hierarchy
    from agglomerationmultigrid1d.models.solvers import multigrid

    prob = poisson_full_hierarchy(n=96, n_agg=5)
    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 50, 1e-10)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(prob.b))
    assert it <= 14, it
    assert float(res.res_history[it - 1]) < 1e-10 * nb * 1.01


def test_non_power_of_two_dg_agg_hierarchy():
    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy
    from agglomerationmultigrid1d.models.solvers import multigrid

    prob = poisson_dg_hierarchy(n=96, max_p=4, n_dg=3, n_agg=4)
    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 80, 1e-10)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(prob.b.T.reshape(-1)))
    assert it <= 40, it
    assert float(res.res_history[it - 1]) < 1e-10 * nb * 1.01
