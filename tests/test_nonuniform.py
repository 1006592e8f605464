"""Non-uniform (graded) meshes through every discretization / transfer /
hierarchy path, and the explicit DG switch constructor (``dg_mesh.jl:114-138``).

The reference's mesh type carries arbitrary vertex positions
(``src/meshes.jl:11-17``); these tests prove the capability end to end."""

import jax.numpy as jnp
import numpy as np
import pytest

from helpers import bp_dense

from agglomerationmultigrid1d.assembly import (
    agg_flux_operators,
    agg_flux_rhs,
    cg_stiffness_and_rhs,
    dg_flux_operators,
    dg_flux_rhs,
)
from agglomerationmultigrid1d.mesh import (
    BoundaryCondition,
    create_graded_mesh,
    make_agg_mesh,
    make_cg_mesh,
    make_dg_mesh,
)
from agglomerationmultigrid1d.ops import (
    bd_matvec,
    bd_mul_bt,
    bd_to_dense,
    bp_galerkin,
    bt_matvec,
    bt_mul_bt,
    bt_sub,
    bt_to_dense,
    cg_to_dense,
)
from agglomerationmultigrid1d.transfer import aggdg_dg_interpolation

BC = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))


def _cg_solve_l2_error(mesh, p):
    cg = make_cg_mesh(mesh, p)
    a, b = cg_stiffness_and_rhs(cg, jnp.cos, BC)
    u = np.linalg.solve(np.asarray(cg_to_dense(a)), np.asarray(b))
    # L2 error by quadrature per element
    from agglomerationmultigrid1d.numerics import evaluate_nodal_basis, gauss_quad

    qx, qw = gauss_quad(2 * p + 2)
    ref = cg.ref
    basis = np.asarray(evaluate_nodal_basis(ref.basis_coeff, qx))[:, ref.pos_to_slot]
    err2 = 0.0
    for k in range(mesh.n_elements):
        xq = mesh.centers[k] + mesh.jacobians[k] * qx
        nodes = u[k * p : k * p + p + 1]
        uh = basis @ nodes
        err2 += mesh.jacobians[k] * np.sum(qw * (np.cos(xq) - uh) ** 2)
    return np.sqrt(err2)


def _dg_solve(dg, c_dir):
    g, d, c = dg_flux_operators(dg, BC, c_dir)
    f, r = dg_flux_rhs(dg, jnp.cos, BC, c_dir)
    a = bt_sub(c, bt_mul_bt(d, bd_mul_bt(dg.mass_inv, g)))
    b = f - bt_matvec(d, bd_matvec(dg.mass_inv, r))
    u = np.linalg.solve(np.asarray(bt_to_dense(a)), np.asarray(b).T.reshape(-1))
    return u.reshape(dg.n_elements, dg.p + 1).T


def _dg_l2_error(dg, u):
    from agglomerationmultigrid1d.numerics import evaluate_nodal_basis, gauss_quad

    qx, qw = gauss_quad(2 * dg.p + 2)
    ref = dg.ref
    basis = np.asarray(evaluate_nodal_basis(ref.basis_coeff, qx))  # (n_q, w) slot order
    mesh = dg.mesh
    err2 = 0.0
    for k in range(mesh.n_elements):
        xq = mesh.centers[k] + mesh.jacobians[k] * qx
        uh = basis @ np.asarray(u)[:, k]
        err2 += mesh.jacobians[k] * np.sum(qw * (np.cos(xq) - uh) ** 2)
    return np.sqrt(err2)


def test_cg_convergence_on_graded_mesh():
    """Order p+1 holds on geometrically stretched meshes (p = 3 -> ~4)."""
    errs, ns = [], [8, 16, 32, 64]
    for n in ns:
        errs.append(_cg_solve_l2_error(create_graded_mesh(n, 0.0, 1.0, ratio=4.0), 3))
    slope = (np.log(errs[-1]) - np.log(errs[0])) / (np.log(1 / ns[-1]) - np.log(1 / ns[0]))
    assert abs(slope - 4.0) < 0.4, (slope, errs)


def test_dg_convergence_on_graded_mesh():
    errs, ns = [], [8, 16, 32, 64]
    for n in ns:
        dg = make_dg_mesh(create_graded_mesh(n, 0.0, 1.0, ratio=4.0), 3)
        errs.append(_dg_l2_error(dg, _dg_solve(dg, 1.0 * n)))
    slope = (np.log(errs[-1]) - np.log(errs[0])) / (np.log(1 / ns[-1]) - np.log(1 / ns[0]))
    assert abs(slope - 4.0) < 0.4, (slope, errs)


def test_agg_galerkin_consistency_on_graded_mesh():
    """Rediscretization == Galerkin for the agg<->DG pair on a graded mesh
    (exercises the bounding-box modal tables with non-uniform jacobians)."""
    mesh = create_graded_mesh(16, 0.0, 1.0, ratio=3.0)
    dg = make_dg_mesh(mesh, 1)
    agg = make_agg_mesh(1, mesh, 2)
    l = aggdg_dg_interpolation(agg, dg)
    gf, df, cf = dg_flux_operators(dg, BC, 100.0)
    ga, da, ca = agg_flux_operators(agg, BC, 100.0)
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


def test_full_hierarchy_on_graded_mesh():
    """The flagship CG+agg hierarchy solves to 1e-10 on a graded mesh."""
    from agglomerationmultigrid1d.models.problems import poisson_full_hierarchy
    from agglomerationmultigrid1d.models.solvers import multigrid

    mesh = create_graded_mesh(64, 0.0, 1.0, ratio=4.0)
    prob = poisson_full_hierarchy(n=64, mesh=mesh) if False else None
    # build_problem takes the mesh directly
    from agglomerationmultigrid1d.models.problems import build_problem
    from agglomerationmultigrid1d.utils.config import HierarchySpec

    spec = HierarchySpec(
        cg_orders=(8, 4, 2, 1), n_agg_levels=5, p_agg=1, c_dir=1000.0 * 64
    )
    prob = build_problem(spec, 64, mesh=mesh)
    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 60, 1e-10)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(prob.b))
    assert it <= 20, it
    assert float(res.res_history[it - 1]) < 1e-10 * nb * 1.01


def test_dg_hierarchy_on_graded_mesh():
    from agglomerationmultigrid1d.models.problems import build_problem
    from agglomerationmultigrid1d.models.solvers import multigrid
    from agglomerationmultigrid1d.utils.config import HierarchySpec

    mesh = create_graded_mesh(64, 0.0, 1.0, ratio=4.0)
    spec = HierarchySpec(cg_orders=(), dg_orders=(4, 2, 1), c_dir=1000.0 * 64)
    prob = build_problem(spec, 64, mesh=mesh)
    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 80, 1e-10)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(prob.b.T.reshape(-1)))
    assert it <= 40, it
    assert float(res.res_history[it - 1]) < 1e-10 * nb * 1.01


# ---------------------------------------------------------------------------
# explicit switch (dg_mesh.jl:114-138)
# ---------------------------------------------------------------------------


def test_switch_all_default_matches_plain():
    mesh = create_graded_mesh(8, 0.0, 1.0, ratio=2.0)
    d0 = make_dg_mesh(mesh, 2)
    d1 = make_dg_mesh(mesh, 2, switch=np.ones(7, dtype=bool))
    assert d1.u_hat_left is None  # normalized to the fast path
    for x0, x1 in zip(dg_flux_operators(d0, BC, 8.0), dg_flux_operators(d1, BC, 8.0)):
        np.testing.assert_allclose(np.asarray(bt_to_dense(x0)), np.asarray(bt_to_dense(x1)))


def test_switch_flip_swaps_g_and_d_interior():
    """Flipping u-hat/q-hat sides at every vertex swaps the interior vertex
    couplings of G and D (the flux pair trades roles); volume terms are shared
    and boundary terms depend only on the BC."""
    mesh = create_graded_mesh(8, 0.0, 1.0, ratio=2.0)
    bc_nn = BoundaryCondition(("neu", 0.0), ("neu", 0.0))
    p = 2
    d0 = make_dg_mesh(mesh, p)
    d1 = make_dg_mesh(mesh, p, switch=np.zeros(7, dtype=bool))
    g0, dd0, _ = dg_flux_operators(d0, bc_nn, 0.0)
    g1, dd1, _ = dg_flux_operators(d1, bc_nn, 0.0)
    # interior-only parts: subtract the shared volume + Neumann boundary terms
    from agglomerationmultigrid1d.assembly.dg_assembly import _volume_ref

    vol = np.zeros((p + 1, p + 1, 8))
    vol += np.asarray(_volume_ref(d0))[:, :, None]
    gb = vol.copy()
    gb[0, 0, 0] += 1.0  # neumann left touches G
    gb[1, 1, -1] += -1.0
    g0_int = np.asarray(bt_to_dense(g0)) - _dense_from_diag(gb)
    g1_int = np.asarray(bt_to_dense(g1)) - _dense_from_diag(gb)
    d0_int = np.asarray(bt_to_dense(dd0)) - _dense_from_diag(vol)
    d1_int = np.asarray(bt_to_dense(dd1)) - _dense_from_diag(vol)
    np.testing.assert_allclose(g1_int, d0_int, atol=1e-14)
    np.testing.assert_allclose(d1_int, g0_int, atol=1e-14)


def _dense_from_diag(diag_blocks: np.ndarray) -> np.ndarray:
    bs = diag_blocks.shape[0]
    n = diag_blocks.shape[2]
    out = np.zeros((n * bs, n * bs))
    for k in range(n):
        out[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = diag_blocks[:, :, k]
    return out


def test_switch_flipped_solution_converges():
    """The uniformly flipped switch (u-hat from the right / q-hat from the
    left everywhere) is the mirror LDG scheme — same convergence order."""
    errs, ns = [], [8, 16, 32]
    for n in ns:
        mesh = create_graded_mesh(n, 0.0, 1.0, ratio=2.0)
        dg = make_dg_mesh(mesh, 2, switch=np.zeros(n - 1, dtype=bool))
        c_dir = 1.0 * n
        g, d, c = dg_flux_operators(dg, BC, c_dir)
        f, r = dg_flux_rhs(dg, jnp.cos, BC, c_dir)
        gd = np.asarray(bt_to_dense(g))
        dd = np.asarray(bt_to_dense(d))
        cd = np.asarray(bt_to_dense(c))
        md = np.asarray(bd_to_dense(dg.mass))
        a = cd - dd @ np.linalg.solve(md, gd)
        b = np.asarray(f).T.reshape(-1) - dd @ np.linalg.solve(
            md, np.asarray(r).T.reshape(-1)
        )
        u = np.linalg.solve(a, b).reshape(n, 3).T
        errs.append(_dg_l2_error(dg, u))
    slope = (np.log(errs[-1]) - np.log(errs[0])) / (np.log(1 / ns[-1]) - np.log(1 / ns[0]))
    assert abs(slope - 3.0) < 0.5, (slope, errs)


def test_switch_mixed_entrywise():
    """Exact entrywise check: every interior-vertex coupling of the mixed
    operators equals the default (True) or flipped (False) scalar stencil."""
    n, p = 8, 1
    mesh = create_graded_mesh(n, 0.0, 1.0, ratio=2.0)
    bc_nn = BoundaryCondition(("neu", 0.0), ("neu", 0.0))
    sw = (np.arange(n - 1) % 2).astype(bool)
    # the alternating pattern u-traps elements (singular scheme) — fine here,
    # only the assembled entries are inspected, nothing is solved
    g, d, _ = dg_flux_operators(
        make_dg_mesh(mesh, p, switch=sw, allow_trapped=True), bc_nn, 0.0
    )
    s1 = 1
    gl = np.asarray(g.lower)
    gdg = np.asarray(g.diag)
    gu = np.asarray(g.upper)
    dl = np.asarray(d.lower)
    ddg = np.asarray(d.diag)
    du = np.asarray(d.upper)
    vol = np.asarray(
        __import__(
            "agglomerationmultigrid1d.assembly.dg_assembly", fromlist=["_volume_ref"]
        )._volume_ref(make_dg_mesh(mesh, p))
    )
    for v in range(n - 1):
        if sw[v]:  # default: u-hat left, q-hat right
            assert gl[0, s1, v + 1] == 1.0
            assert gdg[s1, s1, v] - vol[s1, s1] == -1.0
            assert ddg[0, 0, v + 1] - vol[0, 0] == 1.0
            assert du[s1, 0, v] == -1.0
            assert gu[s1, 0, v] == 0.0 and dl[0, s1, v + 1] == 0.0
        else:  # flipped: u-hat right, q-hat left
            assert gdg[0, 0, v + 1] - vol[0, 0] == 1.0
            assert gu[s1, 0, v] == -1.0
            assert ddg[s1, s1, v] - vol[s1, s1] == -1.0
            assert dl[0, s1, v + 1] == 1.0
            assert gl[0, s1, v + 1] == 0.0 and du[s1, 0, v] == 0.0
