"""Mixed-switch DG solves: block-pentadiagonal Schur stiffness.

The reference's explicit-switch DG constructor (``dg_mesh.jl:114-138``) feeds
generic CSC matrices, so ``A = C - D M^-1 G`` with a *mixed* per-vertex switch
(block-pentadiagonal) solves there without ceremony.  Here the pentadiagonal
structure is explicit (``ops/block_penta.py``): these tests pin the product /
matvec / pair-merge against dense, and a full mixed-switch hierarchy against a
dense direct solve — closing the former silent-truncation trap in
``bt_mul_bt``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from agglomerationmultigrid1d.assembly.dg_assembly import dg_flux_operators, dg_flux_rhs
from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_dg_mesh
from agglomerationmultigrid1d.models.hierarchy import build_dg_hierarchy, schur_stiffness
from agglomerationmultigrid1d.models.solvers import multigrid
from agglomerationmultigrid1d.ops import (
    BlockTridiag,
    bd_matvec,
    bp5_matvec,
    bp5_pair_merge,
    bp5_to_dense,
    bt_mul_bt_full,
    bt_to_dense,
    coarse_solve,
    make_penta_coarse_solver,
)


def _random_bt(bs: int, n: int, seed: int) -> BlockTridiag:
    rng = np.random.default_rng(seed)
    lower = rng.standard_normal((bs, bs, n))
    diag = rng.standard_normal((bs, bs, n)) + 3.0 * bs * np.eye(bs)[:, :, None]
    upper = rng.standard_normal((bs, bs, n))
    lower[:, :, 0] = 0.0
    upper[:, :, -1] = 0.0
    return BlockTridiag(jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper))


@pytest.mark.parametrize("bs,n", [(1, 5), (2, 8), (4, 13)])
def test_bt_mul_bt_full_matches_dense(bs, n):
    a, b = _random_bt(bs, n, 1), _random_bt(bs, n, 2)
    p = bt_mul_bt_full(a, b)
    dense = np.asarray(bt_to_dense(a)) @ np.asarray(bt_to_dense(b))
    np.testing.assert_allclose(np.asarray(bp5_to_dense(p)), dense, atol=1e-12)


@pytest.mark.parametrize("bs,n", [(2, 9), (4, 12)])
def test_bp5_matvec_matches_dense(bs, n):
    p = bt_mul_bt_full(_random_bt(bs, n, 3), _random_bt(bs, n, 4))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((bs, n))
    y = np.asarray(bp5_matvec(p, jnp.asarray(x)))
    y_ref = (np.asarray(bp5_to_dense(p)) @ x.T.reshape(-1)).reshape(n, bs).T
    np.testing.assert_allclose(y, y_ref, atol=1e-12)


@pytest.mark.parametrize("n", [8, 13])  # even and odd block counts
def test_bp5_pair_merge_matches_dense(n):
    bs = 2
    p = bt_mul_bt_full(_random_bt(bs, n, 6), _random_bt(bs, n, 7))
    merged = bp5_pair_merge(p)
    dense = np.asarray(bt_to_dense(merged))
    nd = n * bs
    np.testing.assert_allclose(dense[:nd, :nd], np.asarray(bp5_to_dense(p)), atol=1e-12)
    if dense.shape[0] > nd:  # odd n: inert identity padding
        np.testing.assert_allclose(dense[nd:, nd:], np.eye(dense.shape[0] - nd), atol=0)
        np.testing.assert_allclose(dense[nd:, :nd], 0.0, atol=0)
        np.testing.assert_allclose(dense[:nd, nd:], 0.0, atol=0)


@pytest.mark.parametrize("n", [64, 65])
def test_penta_coarse_solver(n):
    p = bt_mul_bt_full(_random_bt(2, n, 8), _random_bt(2, n, 9))
    s = make_penta_coarse_solver(p)
    rng = np.random.default_rng(10)
    b = rng.standard_normal(2 * n)
    x = np.asarray(coarse_solve(s, jnp.asarray(b)))
    x_ref = np.linalg.solve(np.asarray(bp5_to_dense(p)), b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-8, atol=1e-8)


def _mixed_problem(n=32, p=3):
    """Mixed switch with no (True, False) adjacent pair: a True-vertex followed
    by a False-vertex leaves the element between them with its u-trace unused
    by ANY flux (u-"trapped"), which makes the exact A genuinely singular —
    a property of the scheme itself (the reference's generic sparse A would be
    singular there too), not of the pentadiagonal representation.  The
    False-run -> True-run pattern below is genuinely mixed (nonzero distance-2
    blocks) and provably nonsingular."""
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    switch = np.array([False] * (n // 2) + [True] * (n - 1 - n // 2), dtype=bool)
    dg = make_dg_mesh(mesh, p, switch=switch)
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    c_dir = 1000.0 * n
    g, d, c = dg_flux_operators(dg, bc, c_dir)
    return mesh, dg, bc, c_dir, g, d, c


def test_trapping_switch_rejected():
    """A (True, False) vertex pair u-traps the element between them and makes
    the exact operator singular; make_dg_mesh rejects it loudly (the
    reference's generic sparse A is equally singular there, silently)."""
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    switch = np.array([True, True, True, False, True, True, True])
    with pytest.raises(ValueError, match="u-traps element"):
        make_dg_mesh(mesh, 2, switch=switch)
    dg = make_dg_mesh(mesh, 2, switch=switch, allow_trapped=True)  # analysis path
    assert dg.u_hat_left is not None


def test_trapped_switch_schur_matches_dense_and_is_singular():
    """For a trapping switch, the pentadiagonal A equals the dense
    C - D M^-1 G including the distance-2 blocks (which the tridiagonal
    product silently drops) — and that exact operator is genuinely singular,
    which is precisely why trapping switches are rejected by default."""
    from agglomerationmultigrid1d.ops import bd_to_dense

    n, p = 16, 3
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    switch = np.array([True] * 7 + [False] + [True] * 7)
    dg = make_dg_mesh(mesh, p, switch=switch, allow_trapped=True)
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    g, d, c = dg_flux_operators(dg, bc, 1000.0 * n)
    a = schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
    dense_ref = np.asarray(bt_to_dense(c)) - np.asarray(bt_to_dense(d)) @ (
        np.asarray(bd_to_dense(dg.mass_inv)) @ np.asarray(bt_to_dense(g))
    )
    a_dense = np.asarray(bp5_to_dense(a))
    scale = np.abs(dense_ref).max()
    np.testing.assert_allclose(a_dense, dense_ref, atol=1e-12 * scale)
    # the distance-2 content is real exactly at the trapping pair
    assert float(jnp.abs(a.lower2).max() + jnp.abs(a.upper2).max()) > 1e-6 * scale
    # and the exact operator is singular (one null mode per trapped element)
    ev = np.linalg.eigvalsh(0.5 * (a_dense + a_dense.T))
    assert abs(ev).min() < 1e-10 * scale


def test_mixed_switch_hierarchy_rejects_truncated_a():
    from agglomerationmultigrid1d.ops import bd_mul_bt, bt_mul_bt, bt_sub

    mesh, dg, bc, c_dir, g, d, c = _mixed_problem()
    a_truncated = bt_sub(c, bt_mul_bt(d, bd_mul_bt(dg.mass_inv, g)))
    meshes = [dg, make_dg_mesh(mesh, 1, switch=dg.u_hat_left)]
    with pytest.raises(ValueError, match="PENTA"):
        build_dg_hierarchy(meshes, a_truncated, g, d, c)


def test_agg_explicit_switch_entrywise():
    """The agglomerated level's explicit switch (``agglomerated_dg_mesh.jl:
    459-487``) mirrors the flux couplings exactly like the DG level: the mixed
    operators equal the default stencil at True vertices and the uniformly
    flipped level's stencil at False vertices (rank-1 outer products of the
    boundary basis values)."""
    from agglomerationmultigrid1d.assembly.agg_assembly import agg_flux_operators
    from agglomerationmultigrid1d.mesh import make_agg_mesh

    n, m = 16, 8
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    sw = np.array([False] * 4 + [True] * 3)
    agg_def = make_agg_mesh(1, mesh, 2)
    agg_mix = make_agg_mesh(1, mesh, 2, switch=sw)
    assert agg_mix.u_hat_left is not None
    # all-True normalizes back to the default fast path
    assert make_agg_mesh(1, mesh, 2, switch=np.ones(m - 1, bool)).u_hat_left is None
    with pytest.raises(ValueError, match="u-traps"):
        make_agg_mesh(1, mesh, 2, switch=np.array([True] * 3 + [False] * 4))

    g0, d0, _ = agg_flux_operators(agg_def, bc, 100.0)
    gm, dm, _ = agg_flux_operators(agg_mix, bc, 100.0)
    bl, br = agg_def.bd_left, agg_def.bd_right
    for v in range(m - 1):
        if sw[v]:  # default couplings at this vertex
            np.testing.assert_allclose(
                np.asarray(gm.lower)[:, :, v + 1], np.asarray(g0.lower)[:, :, v + 1]
            )
            np.testing.assert_allclose(
                np.asarray(dm.upper)[:, :, v], np.asarray(d0.upper)[:, :, v]
            )
            assert np.all(np.asarray(gm.upper)[:, :, v] == 0.0)
        else:  # mirrored: u-hat from the right agglomerate, q-hat from the left
            np.testing.assert_allclose(
                np.asarray(gm.upper)[:, :, v], -np.outer(br[v], bl[v + 1])
            )
            np.testing.assert_allclose(
                np.asarray(dm.lower)[:, :, v + 1], np.outer(bl[v + 1], br[v])
            )
            assert np.all(np.asarray(gm.lower)[:, :, v + 1] == 0.0)
            assert np.all(np.asarray(dm.upper)[:, :, v] == 0.0)


def test_agg_mixed_switch_solves_to_direct():
    """A CG -> agg hierarchy whose agg seam has a (non-trapping) mixed switch
    solves to the dense direct solution of its own exact operator."""
    from agglomerationmultigrid1d.assembly.cg_assembly import cg_stiffness_and_rhs
    from agglomerationmultigrid1d.mesh import make_agg_mesh, make_cg_mesh
    from agglomerationmultigrid1d.models.hierarchy import build_hierarchy
    from agglomerationmultigrid1d.models.problems import default_model_problem

    n = 32
    mesh = create_uniform_mesh(n, 0.0, 1.0)
    bc = BoundaryCondition(("neu", 0.0), ("dir", 1.0))
    func, _, _ = default_model_problem()
    cg = make_cg_mesh(mesh, 1)
    m = n // 4
    sw = np.array([False] * (m // 2) + [True] * (m - 1 - m // 2))
    agg = make_agg_mesh(1, mesh, 4, switch=sw, tables=False)
    a, b = cg_stiffness_and_rhs(cg, func, bc)
    h = build_hierarchy([cg, agg], bc, a, c_dir=1000.0 * n)
    from agglomerationmultigrid1d.ops import BlockPenta

    assert isinstance(h.levels[1].a, BlockPenta)
    res = multigrid(h, jnp.zeros_like(b), b, 100, 1e-10, compute_error=False)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(b))
    assert float(res.res_history[it - 1]) < 1e-10 * nb


def test_penta_ff_defect_matches_f64():
    """Float-float pentadiagonal defect (ops/df64.py::ff_bp5_defect) is
    ~2^-48-accurate against the f64 reference."""
    from agglomerationmultigrid1d.ops import df64 as ff

    p = bt_mul_bt_full(_random_bt(4, 300, 11), _random_bt(4, 300, 12))
    rng = np.random.default_rng(13)
    x = jnp.asarray(rng.standard_normal((4, 300)))
    b = jnp.asarray(rng.standard_normal((4, 300)))
    r64 = np.asarray(b - bp5_matvec(p, x))
    a_ff = ff.bp5_split(p)
    import jax

    d = jax.jit(lambda A, X, B: ff.ff_defect(A, X, B))
    r_ff = np.asarray(ff.ff_join(d(a_ff, ff.ff_split(x), ff.ff_split(b))))
    scale = np.abs(r64).max() + np.abs(np.asarray(b)).max()
    assert np.abs(r_ff - r64).max() < 1e-12 * scale


def test_mixed_switch_progressive_and_mixed_solvers():
    """The float-float mixed and progressive solvers handle a pentadiagonal
    (mixed-switch) fine level end-to-end."""
    from agglomerationmultigrid1d.models.problems import default_model_problem
    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid_mixed,
        multigrid_progressive,
    )
    from agglomerationmultigrid1d.ops import bt_matvec

    mesh, dg, bc, c_dir, g, d, c = _mixed_problem()
    a = schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
    meshes = [dg, make_dg_mesh(mesh, 1, switch=dg.u_hat_left)]
    h = build_dg_hierarchy(meshes, a, g, d, c)
    h32 = make_low_precision_hierarchy(h)
    func, _, _ = default_model_problem()
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    nb = float(jnp.linalg.norm(b.T.reshape(-1)))

    for solver in (multigrid_mixed, multigrid_progressive):
        res = solver(h, h32, jnp.zeros_like(b), b, 80, 1e-10, use_pallas=False)
        it = int(res.iterations)
        assert float(res.res_history[it - 1]) < 1e-10 * nb, solver.__name__


def test_mixed_switch_hierarchy_solves_to_direct():
    """A mixed-switch DG-topped hierarchy (p 3 -> 1) converges to 1e-10 and its
    solution matches the dense direct solve of the exact pentadiagonal A."""
    mesh, dg, bc, c_dir, g, d, c = _mixed_problem()
    a = schur_stiffness(g, d, c, dg.mass_inv, mixed_switch=True)
    meshes = [dg, make_dg_mesh(mesh, 1, switch=dg.u_hat_left)]
    h = build_dg_hierarchy(meshes, a, g, d, c)

    from agglomerationmultigrid1d.models.problems import default_model_problem

    func, _, _ = default_model_problem()
    f, r = dg_flux_rhs(dg, func, bc, c_dir)
    from agglomerationmultigrid1d.ops import bt_matvec

    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))

    res = multigrid(h, jnp.zeros_like(b), b, 100, 1e-10)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(b.T.reshape(-1)))
    assert float(res.res_history[it - 1]) < 1e-10 * nb

    x_direct = np.linalg.solve(np.asarray(bp5_to_dense(a)), np.asarray(b).T.reshape(-1))
    x = np.asarray(res.x).T.reshape(-1)
    np.testing.assert_allclose(x, x_direct, atol=1e-8 * np.abs(x_direct).max())
    # the error history (banded penta direct solve) is finite and decreasing
    err = np.asarray(res.err_history)[:it]
    assert np.all(np.isfinite(err)) and err[-1] <= err[0]
