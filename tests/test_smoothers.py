"""Smoother tests (cf. ``tests/cg_smoother_test.jl``, ``dg_smoother_test.jl``):
(a) Richardson-with-smoother converges, (b) damped smoothers contract the
high-frequency error (spectral radius of I - alpha S A on the upper spectrum),
(c) apply_smoother matches the dense definition."""

import jax.numpy as jnp
import numpy as np

from agglomerationmultigrid1d.assembly import cg_stiffness_and_rhs, dg_flux_operators
from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh, make_dg_mesh
from agglomerationmultigrid1d.models.hierarchy import CgLevel, BlockLevel, _schur_stiffness
from agglomerationmultigrid1d.models.solvers import iterative_smoother_solve
from agglomerationmultigrid1d.ops import bt_to_dense, cg_to_dense, cg_node_multiplicity
from agglomerationmultigrid1d.smoothers import apply_smoother, cg_smoother, dg_smoother

BC = BoundaryCondition(("neu", -np.sin(0.0)), ("dir", np.cos(1.0)))


def _dense_smoother_matrix(s, n, shape):
    """Materialize S by applying it to the identity (flat dof = k * bs + i)."""
    cols = []
    for i in range(n):
        e = np.zeros(n)
        e[i] = 1.0
        if len(shape) == 2:
            vec = jnp.asarray(e.reshape(shape).T)  # (bs, n_el)
            out = np.asarray(apply_smoother(s, vec)).T.reshape(-1)
        else:
            out = np.asarray(apply_smoother(s, jnp.asarray(e)))
        cols.append(out)
    return np.stack(cols, axis=1)


def test_cg_jacobi_matches_dense():
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    a, _ = cg_stiffness_and_rhs(cg, jnp.cos, BC)
    s = cg_smoother(a, "jac")
    ad = np.asarray(cg_to_dense(a))
    sd = _dense_smoother_matrix(s, cg.n_nodes, (cg.n_nodes,))
    np.testing.assert_allclose(sd, np.diag(1.0 / np.diag(ad)), atol=1e-12)


def test_cg_schwarz_matches_dense():
    mesh = create_uniform_mesh(6, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    a, _ = cg_stiffness_and_rhs(cg, jnp.cos, BC)
    ad = np.asarray(cg_to_dense(a))
    p, n_el, nn = cg.p, cg.n_elements, cg.n_nodes
    # dense additive Schwarz: sum of P_k^T (A_k)^-1 P_k
    s_add = np.zeros((nn, nn))
    for k in range(n_el):
        sl = slice(k * p, k * p + p + 1)
        blk = np.zeros((nn, nn))
        blk[sl, sl] = np.linalg.inv(ad[sl, sl])
        s_add += blk
    sd = _dense_smoother_matrix(cg_smoother(a, "addSchwarz"), nn, (nn,))
    np.testing.assert_allclose(sd, s_add, atol=1e-11)
    # hybrid = divided by multiplicity
    mult = np.asarray(cg_node_multiplicity(p, n_el))
    sd_h = _dense_smoother_matrix(cg_smoother(a, "hybridSchwarz"), nn, (nn,))
    np.testing.assert_allclose(sd_h, s_add / mult[:, None], atol=1e-11)


def test_dg_block_jacobi_matches_dense():
    mesh = create_uniform_mesh(6, 0.0, 1.0)
    dg = make_dg_mesh(mesh, 2)
    g, d, c = dg_flux_operators(dg, BC, 100.0)
    a = _schur_stiffness(g, d, c, dg.mass_inv)
    ad = np.asarray(bt_to_dense(a))
    bs, n = dg.p + 1, dg.n_elements
    s_ref = np.zeros_like(ad)
    for k in range(n):
        sl = slice(k * bs, (k + 1) * bs)
        s_ref[sl, sl] = np.linalg.inv(ad[sl, sl])
    sd = _dense_smoother_matrix(dg_smoother(a, "blockJac"), bs * n, (n, bs))
    # note: _dense_smoother_matrix reshapes flat -> (n, bs) then transposes to (bs, n)
    np.testing.assert_allclose(sd, s_ref, atol=1e-11)


def test_cg_smoother_richardson_converges():
    """Richardson with each smoother solves -u'' = 1 (cg_smoother_test.jl:44-49)."""
    mesh = create_uniform_mesh(8, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 2)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    a, f = cg_stiffness_and_rhs(cg, lambda x: jnp.ones_like(x), bc)
    for kind, alpha in [("jac", 2.0 / 3.0), ("addSchwarz", 1.0 / 3.0), ("hybridSchwarz", 2.0 / 3.0)]:
        level = CgLevel(a=a, smoother=cg_smoother(a, kind))
        res = iterative_smoother_solve(
            level, jnp.zeros_like(f), f, maxiter=5000, tol=1e-6, alpha=alpha
        )
        it = int(res.iterations)
        assert it < 5000, kind
        r = np.asarray(res.res_history)[:it]
        assert r[-1] < 1e-6 * np.linalg.norm(np.asarray(f)), (kind, r[-1])
        # error history decreases monotonically once past the first few sweeps
        e = np.asarray(res.err_history)[:it]
        assert np.all(np.diff(e[5:]) <= 1e-12), kind


def test_smoother_damps_high_frequencies():
    """eig(I - alpha S A): upper half of the spectrum strongly damped
    (cg_smoother_test.jl:111-126)."""
    mesh = create_uniform_mesh(32, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 1)
    bc = BoundaryCondition(("dir", 0.0), ("dir", 0.0))
    a, _ = cg_stiffness_and_rhs(cg, lambda x: jnp.ones_like(x), bc)
    ad = np.asarray(cg_to_dense(a))
    sd = _dense_smoother_matrix(cg_smoother(a, "jac"), cg.n_nodes, (cg.n_nodes,))
    iteration = np.eye(cg.n_nodes) - (2.0 / 3.0) * sd @ ad
    evals = np.sort(np.abs(np.linalg.eigvals(iteration)))
    assert evals[-1] <= 1.0 + 1e-12  # stable
    # smoothing property: eigenvectors of A with large eigenvalues are damped to <= 1/3
    w, v = np.linalg.eigh(0.5 * (ad + ad.T))
    hi = v[:, w > 0.5 * w.max()]
    damped = iteration @ hi
    assert np.linalg.norm(damped, axis=0).max() <= 1.0 / 3.0 + 0.05


def test_chebyshev_smoothing_cuts_cycle_count():
    """Chebyshev-accelerated smoothing (an extension) must converge in
    fewer V-cycles than the reference's damped sweeps at identical per-sweep
    cost, on both hierarchy families."""
    import jax.numpy as jnp

    from agglomerationmultigrid1d.models.hierarchy import chebyshev_hierarchy
    from agglomerationmultigrid1d.models.problems import (
        poisson_dg_hierarchy,
        poisson_full_hierarchy,
    )
    from agglomerationmultigrid1d.models.solvers import multigrid

    for prob in (
        poisson_dg_hierarchy(n=256, max_p=3, n_dg=2, n_agg=4),
        poisson_full_hierarchy(n=256),
    ):
        b = prob.b
        r0 = multigrid(prob.hierarchy, jnp.zeros_like(b), b, 100, 1e-10, compute_error=False)
        rc = multigrid(
            chebyshev_hierarchy(prob.hierarchy), jnp.zeros_like(b), b, 100, 1e-10,
            compute_error=False,
        )
        nb = float(jnp.linalg.norm(b.T.reshape(-1) if b.ndim > 1 else b))
        it = int(rc.iterations)
        assert np.asarray(rc.res_history)[it - 1] < 1e-10 * nb
        assert it < int(r0.iterations), (it, int(r0.iterations))
