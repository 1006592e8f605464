"""Scattered (non-contiguous) agglomeration: the reference's arbitrary
``agg::Vector{Vector{Int64}}`` partitions (``src/agglomerated_dg_mesh.jl:400-495``).

Validation strategy:

* BlockCOO algebra against dense (unit level);
* a contiguous partition fed through the scattered path must REPRODUCE the
  contiguous AggMesh/BlockTridiag path exactly (same math, different
  structures);
* for genuinely non-contiguous partitions, rediscretization must equal
  Galerkin projection of the fine DG operators through the scattered
  prolongation — the same identity the reference's interpolation test pins for
  contiguous agglomerates (``dg_interpolation_test.jl:40-44``), validated here
  by two fully independent code paths (interface-list assembly vs entry
  re-keying of the DG operators);
* end-to-end multigrid on an interleaved partition converges to the dense
  solution.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from agglomerationmultigrid1d.assembly import (
    agg_flux_operators,
    agg_flux_rhs,
    dg_flux_operators,
    scattered_flux_operators,
    scattered_flux_rhs,
    scattered_schur,
)
from agglomerationmultigrid1d.mesh import (
    BoundaryCondition,
    create_uniform_mesh,
    make_agg_mesh,
    make_dg_mesh,
    make_scattered_agg_mesh,
    coarsen_scattered_agg_mesh,
)
from agglomerationmultigrid1d.models.hierarchy import (
    build_dg_hierarchy,
    schur_stiffness,
)
from agglomerationmultigrid1d.models.solvers import multigrid
from agglomerationmultigrid1d.ops import (
    bcoo_add,
    bcoo_diag_blocks,
    bcoo_from_bt,
    bcoo_matvec,
    bcoo_matvec_t,
    bcoo_scale_cols,
    bcoo_spgemm,
    bcoo_to_dense,
    bt_to_dense,
)
from agglomerationmultigrid1d.ops.block_diag import BlockDiag
from agglomerationmultigrid1d.transfer import (
    aggdg_dg_interpolation,
    scattered_dg_interpolation,
    scattered_galerkin,
    scattered_scattered_interpolation,
    sp_prolong,
    sp_restrict,
)
from helpers import bp_dense

BC = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
C_DIR = 100.0


def _rand_bcoo(rng, n, bs, density=0.3):
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, True)
    rows, cols = np.nonzero(mask)
    blocks = rng.standard_normal((bs, bs, rows.size))
    from agglomerationmultigrid1d.ops import bcoo_coalesce

    return bcoo_coalesce(rows, cols, blocks, n, n)


from helpers import sp_dense  # noqa: E402 — shared with test_parity


# ---------------------------------------------------------------------------
# BlockCOO algebra
# ---------------------------------------------------------------------------


def test_bcoo_algebra_vs_dense(rng):
    n, bs = 7, 2
    a = _rand_bcoo(rng, n, bs)
    b = _rand_bcoo(rng, n, bs, density=0.4)
    ad = np.asarray(bcoo_to_dense(a))
    bd = np.asarray(bcoo_to_dense(b))

    x = rng.standard_normal((bs, n))
    xf = x.T.reshape(-1)
    np.testing.assert_allclose(
        np.asarray(bcoo_matvec(a, jnp.asarray(x))).T.reshape(-1), ad @ xf, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(bcoo_matvec_t(a, jnp.asarray(x))).T.reshape(-1), ad.T @ xf, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(bcoo_to_dense(bcoo_spgemm(a, b))), ad @ bd, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(bcoo_to_dense(bcoo_add(a, b, beta=-2.0))), ad - 2.0 * bd, atol=1e-12
    )
    # diag extraction
    d = np.asarray(bcoo_diag_blocks(a))
    for k in range(n):
        np.testing.assert_allclose(
            d[:, :, k], ad[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs], atol=1e-14
        )
    # column scaling by a block diagonal
    m = rng.standard_normal((bs, bs, n))
    md = np.zeros((n * bs, n * bs))
    for k in range(n):
        md[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = m[:, :, k]
    np.testing.assert_allclose(
        np.asarray(bcoo_to_dense(bcoo_scale_cols(a, BlockDiag(jnp.asarray(m))))),
        ad @ md,
        atol=1e-12,
    )


def test_bcoo_from_bt_roundtrip():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 2)
    g, d, c = dg_flux_operators(dg, BC, C_DIR)
    np.testing.assert_allclose(
        np.asarray(bcoo_to_dense(bcoo_from_bt(g))), np.asarray(bt_to_dense(g)), atol=0
    )


# ---------------------------------------------------------------------------
# Contiguous partitions: scattered path == AggMesh path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_agg", [0, 1])
def test_contiguous_scattered_matches_agg(p_agg):
    n = 12
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    groups = [[0, 1, 2], [3, 4], [5, 6, 7, 8], [9, 10, 11]]
    agg = make_agg_mesh(p_agg, mesh, partition=[3, 2, 4, 3])
    sa = make_scattered_agg_mesh(p_agg, mesh, groups)

    np.testing.assert_allclose(sa.boxes, agg.boxes, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(sa.mass.blocks), np.asarray(agg.mass.blocks), atol=1e-13
    )

    bc = BoundaryCondition(("neu", 1.0), ("dir", 2.0))
    ga, da, ca = agg_flux_operators(agg, bc, C_DIR)
    gs, ds, cs = scattered_flux_operators(sa, bc, C_DIR)
    for s, t in ((gs, ga), (ds, da), (cs, ca)):
        np.testing.assert_allclose(
            np.asarray(bcoo_to_dense(s)), np.asarray(bt_to_dense(t)), atol=1e-13
        )

    func = lambda x: jnp.sin(3.0 * x)  # noqa: E731
    fa, ra = agg_flux_rhs(agg, func, bc, C_DIR)
    fs, rs = scattered_flux_rhs(sa, func, bc, C_DIR)
    np.testing.assert_allclose(np.asarray(fs), np.asarray(fa), atol=1e-13)
    np.testing.assert_allclose(np.asarray(rs), np.asarray(ra), atol=1e-13)

    a_s = scattered_schur(gs, ds, cs, sa.mass_inv)
    a_t = schur_stiffness(ga, da, ca, agg.mass_inv)
    np.testing.assert_allclose(
        np.asarray(bcoo_to_dense(a_s)), np.asarray(bt_to_dense(a_t)), atol=1e-11
    )


def test_contiguous_scattered_prolong_matches_agg():
    n = 12
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 3)
    agg = make_agg_mesh(1, mesh, r_base=3)
    sa = make_scattered_agg_mesh(1, mesh, [list(range(3 * c, 3 * c + 3)) for c in range(4)])
    l_agg = aggdg_dg_interpolation(agg, dg)
    l_sc = scattered_dg_interpolation(sa, dg)
    np.testing.assert_allclose(sp_dense(l_sc), bp_dense(l_agg), atol=1e-13)


# ---------------------------------------------------------------------------
# Non-contiguous partitions
# ---------------------------------------------------------------------------

# interleaved pairs over 12 elements: agglomerate 0 = {0,1, 6,7}, etc. — every
# agglomerate is two runs, exercising hole interfaces
INTERLEAVED = [[0, 1, 6, 7], [2, 3, 8, 9], [4, 5, 10, 11]]


def test_scattered_mesh_structure():
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    sa = make_scattered_agg_mesh(1, mesh, INTERLEAVED)
    assert sa.n_agg == 3
    assert not sa.is_contiguous
    # bounding boxes span the holes
    np.testing.assert_allclose(sa.boxes[0], [0.0, 8.0 / 12.0], atol=1e-14)
    # member integrals exclude the holes: mass[0,0,c] = total member width
    np.testing.assert_allclose(np.asarray(sa.mass.blocks)[0, 0], 4.0 / 12.0, atol=1e-14)
    # interfaces: owner changes at vertices 2,4,6,8,10 -> 5 interfaces
    assert sa.n_interfaces == 5
    np.testing.assert_array_equal(sa.iface_left, [0, 1, 2, 0, 1])
    np.testing.assert_array_equal(sa.iface_right, [1, 2, 0, 1, 2])


def test_groups_validation():
    mesh = create_uniform_mesh(6, 0.0, 1.0)
    with pytest.raises(ValueError, match="more than one"):
        make_scattered_agg_mesh(1, mesh, [[0, 1, 2], [2, 3, 4, 5]])
    with pytest.raises(ValueError, match="not in any"):
        make_scattered_agg_mesh(1, mesh, [[0, 1, 2], [4, 5]])
    with pytest.raises(ValueError, match="empty"):
        make_scattered_agg_mesh(1, mesh, [[0, 1, 2, 3, 4, 5], []])


@pytest.mark.parametrize("p_agg", [0, 1])
@pytest.mark.parametrize(
    "bc",
    [BC, BoundaryCondition(("neu", 1.0), ("dir", 2.0))],
    ids=["dir-dir", "neu-dir"],
)
def test_noncontiguous_rediscretization_equals_galerkin(p_agg, bc):
    """Direct interface-list assembly == P^T (DG operator) P for every one of
    G, D, C — two independent code paths (cf. ``dg_interpolation_test.jl:40-44``
    for the contiguous version of this identity)."""
    n = 12
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, p_agg)  # same p so the spaces nest exactly
    sa = make_scattered_agg_mesh(p_agg, mesh, INTERLEAVED)
    l = scattered_dg_interpolation(sa, dg)

    gf, df, cf = dg_flux_operators(dg, bc, C_DIR)
    gs, ds, cs = scattered_flux_operators(sa, bc, C_DIR)
    for direct, fine in ((gs, gf), (ds, df), (cs, cf)):
        proj = scattered_galerkin(l, fine)
        np.testing.assert_allclose(
            np.asarray(bcoo_to_dense(direct)),
            np.asarray(bcoo_to_dense(proj)),
            atol=1e-11,
        )
    # mass Galerkin-projects too (block-diagonal fine mass)
    m_proj = scattered_galerkin(l, bcoo_from_bt_mass(dg))
    np.testing.assert_allclose(
        np.asarray(bcoo_to_dense(m_proj)),
        _bd_dense(np.asarray(sa.mass.blocks)),
        atol=1e-12,
    )


def bcoo_from_bt_mass(dg):
    from agglomerationmultigrid1d.ops import BlockTridiag, bcoo_from_bt

    bs, n = dg.mass.blocks.shape[0], dg.mass.blocks.shape[2]
    z = jnp.zeros((bs, bs, n), dtype=dg.mass.blocks.dtype)
    return bcoo_from_bt(BlockTridiag(lower=z, diag=dg.mass.blocks, upper=z))


def _bd_dense(blocks):
    bs, _, n = blocks.shape
    out = np.zeros((n * bs, n * bs))
    for k in range(n):
        out[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = blocks[:, :, k]
    return out


def test_scattered_switch_flip_matches_mirror():
    """Flipping EVERY interface must equal the mirror-image default problem
    (the same argument the contiguous explicit-switch tests use)."""
    n = 8
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    groups = [[0, 1, 4, 5], [2, 3, 6, 7]]
    sa_def = make_scattered_agg_mesh(1, mesh, groups)
    sw = np.zeros(sa_def.n_interfaces, dtype=bool)
    sa_flip = make_scattered_agg_mesh(1, mesh, groups, switch=sw)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    g0, d0, c0 = scattered_flux_operators(sa_def, bc, C_DIR)
    g1, d1, c1 = scattered_flux_operators(sa_flip, bc, C_DIR)
    a0 = np.asarray(bcoo_to_dense(scattered_schur(g0, d0, c0, sa_def.mass_inv)))
    a1 = np.asarray(bcoo_to_dense(scattered_schur(g1, d1, c1, sa_flip.mass_inv)))
    # the all-flipped operator is the default operator of the x -> -x mirrored
    # problem; with a symmetric partition layout the spectra coincide
    ev0 = np.sort_complex(np.linalg.eigvals(a0))
    ev1 = np.sort_complex(np.linalg.eigvals(a1))
    np.testing.assert_allclose(ev0, ev1, rtol=1e-8, atol=1e-8)


def test_scattered_prolong_restrict_adjoint(rng):
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 2)
    sa = make_scattered_agg_mesh(1, mesh, INTERLEAVED)
    l = scattered_dg_interpolation(sa, dg)
    pd = sp_dense(l)
    xc = rng.standard_normal((2, 3))
    rf = rng.standard_normal((3, 12))
    np.testing.assert_allclose(
        np.asarray(sp_prolong(l, jnp.asarray(xc))).T.reshape(-1),
        pd @ xc.T.reshape(-1),
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(sp_restrict(l, jnp.asarray(rf))).T.reshape(-1),
        pd.T @ rf.T.reshape(-1),
        atol=1e-13,
    )


def test_recursive_scattered_coarsening():
    mesh = create_uniform_mesh(12, 0.0, 1.0)
    sa1 = make_scattered_agg_mesh(1, mesh, [[2 * c, 2 * c + 1] for c in range(6)])
    # merge fine agglomerates 0,3 / 1,4 / 2,5 — non-contiguous at level 2
    sa2 = coarsen_scattered_agg_mesh(sa1, [[0, 3], [1, 4], [2, 5]])
    assert sa2.n_agg == 3
    # base membership composes: coarse 0 owns base elements of fine 0 and 3
    np.testing.assert_array_equal(np.nonzero(sa2.assign == 0)[0], [0, 1, 6, 7])
    # the fine->coarse re-expansion is exact on the nested linear spaces
    l = scattered_scattered_interpolation(sa2, sa1)
    pd = sp_dense(l)
    # the coarse linear basis function of each agglomerate re-expands exactly
    for c in range(3):
        h = sa2.boxes[c, 1] - sa2.boxes[c, 0]
        xcen = 0.5 * (sa2.boxes[c, 0] + sa2.boxes[c, 1])
        coef = np.zeros((3, 2))
        coef[c] = [0.0, 1.0]  # coarse phi1 of agglomerate c
        fine_coef = (pd @ coef.reshape(-1)).reshape(6, 2)
        for f in range(6):
            if sa2.sub_assign[f] != c:
                continue
            hf = sa1.boxes[f, 1] - sa1.boxes[f, 0]
            cf = 0.5 * (sa1.boxes[f, 0] + sa1.boxes[f, 1])
            x_test = cf + 0.3 * hf
            want = 2.0 * (x_test - xcen) / h
            got = fine_coef[f, 0] + fine_coef[f, 1] * 2.0 * (x_test - cf) / hf
            np.testing.assert_allclose(got, want, atol=1e-13)


# ---------------------------------------------------------------------------
# End-to-end multigrid
# ---------------------------------------------------------------------------


def _interleaved_groups(n, run, m):
    """m agglomerates, each taking runs of `run` elements round-robin."""
    groups = [[] for _ in range(m)]
    for start in range(0, n, run):
        groups[(start // run) % m].extend(range(start, min(start + run, n)))
    return groups


def _dg_problem(n=32):
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    c_dir = 10.0 * n
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    a = schur_stiffness(g, d, c, dg.mass_inv)

    from agglomerationmultigrid1d.assembly import dg_flux_rhs
    from agglomerationmultigrid1d.ops.block_diag import bd_matvec
    from agglomerationmultigrid1d.ops.block_tridiag import bt_matvec

    func = lambda x: jnp.sin(2.0 * jnp.pi * x) * (2.0 * jnp.pi) ** 2  # noqa: E731
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    return mesh, dg, (a, g, d, c), b


def test_contiguous_scattered_multigrid_iteration_parity():
    """The SAME contiguous partition driven through the scattered machinery
    must reproduce the AggMesh path's iteration count exactly (identical
    operators => identical V-cycles)."""
    n = 32
    mesh, dg, (a, g, d, c), b = _dg_problem(n)
    agg = make_agg_mesh(1, mesh, r_base=4)
    h_ref = build_dg_hierarchy([dg, agg], a, g, d, c)
    sa = make_scattered_agg_mesh(1, mesh, [list(range(4 * i, 4 * i + 4)) for i in range(8)])
    h_sc = build_dg_hierarchy([dg, sa], a, g, d, c)

    r_ref = multigrid(h_ref, jnp.zeros_like(b), b, 100, 1e-10)
    r_sc = multigrid(h_sc, jnp.zeros_like(b), b, 100, 1e-10)
    assert int(r_sc.iterations) == int(r_ref.iterations)
    np.testing.assert_allclose(
        np.asarray(r_sc.x), np.asarray(r_ref.x), rtol=1e-9, atol=1e-11
    )


def test_scattered_hierarchy_multigrid_converges():
    n = 32
    mesh, dg, (a, g, d, c), b = _dg_problem(n)
    sa1 = make_scattered_agg_mesh(1, mesh, _interleaved_groups(n, 2, 8))
    # level-2 merge in fine-agglomerate-id space; base membership stays
    # non-contiguous ([0 x 8, 1 x 8, 0 x 8, 1 x 8])
    sa2 = coarsen_scattered_agg_mesh(sa1, [[0, 1, 2, 3], [4, 5, 6, 7]])
    assert not sa2.is_contiguous
    h = build_dg_hierarchy([dg, sa1, sa2], a, g, d, c)

    # an interleaved coarse space approximates less well than a contiguous one
    # (its basis functions span holes), so the contraction is slower — but the
    # cycle must still converge to the dense solution
    res = multigrid(h, jnp.zeros_like(b), b, 150, 1e-10)
    it = int(res.iterations)
    assert it < 150, f"no convergence ({it} iterations)"
    x_dense = np.linalg.solve(np.asarray(bt_to_dense(a)), np.asarray(b).T.reshape(-1))
    np.testing.assert_allclose(
        np.asarray(res.x).T.reshape(-1), x_dense, rtol=1e-6, atol=1e-8
    )


def test_contiguous_below_scattered_rejected():
    n = 16
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 1)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    g, d, c = dg_flux_operators(dg, bc, C_DIR)
    a = schur_stiffness(g, d, c, dg.mass_inv)
    sa1 = make_scattered_agg_mesh(1, mesh, _interleaved_groups(n, 2, 4))
    agg2 = make_agg_mesh(1, mesh, r_base=8)
    with pytest.raises(TypeError, match="cannot follow a scattered"):
        build_dg_hierarchy([dg, sa1, agg2], a, g, d, c)


def test_poisson_scattered_hierarchy_factory():
    """One-call constructor: default locally-interleaved partition solves the
    model problem to 1e-10 and matches the dense direct solution."""
    from agglomerationmultigrid1d.models import (
        multigrid as mg,
        poisson_scattered_hierarchy,
    )

    prob = poisson_scattered_hierarchy(n=64)
    assert len(prob.meshes) == 2 and not prob.meshes[1].is_contiguous
    res = mg(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 200, 1e-10)
    it = int(res.iterations)
    assert it < 200
    a_dense = np.asarray(bt_to_dense(prob.hierarchy.levels[0].a))
    x_dense = np.linalg.solve(a_dense, np.asarray(prob.b).T.reshape(-1))
    np.testing.assert_allclose(
        np.asarray(res.x).T.reshape(-1), x_dense, rtol=1e-6, atol=1e-9
    )
