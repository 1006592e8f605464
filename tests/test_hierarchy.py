"""Multigrid integration tests: the four reference hierarchy configurations
(cg / dg / dg_cg / full, cf. ``tests/*_heirarchy_test.jl``) must converge to
``res < 1e-10 ||b||`` in few V-cycles, with h-independent counts for the full
configuration (full_heirarchy_test.jl:96-102)."""

import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.models.problems import (
    poisson_cg_hierarchy,
    poisson_dg_cg_hierarchy,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d.models.solvers import (
    mg_preconditioner,
    multigrid,
    v_cycle,
)


def _solve(prob, maxiter=100, tol=1e-10):
    return multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, maxiter, tol)


def test_cg_hierarchy_converges():
    """4 CG levels p = 8, 4, 2, 1 at n = 128 (cg_heirarchy_test.jl)."""
    prob = poisson_cg_hierarchy(n=128)
    res = _solve(prob)
    it = int(res.iterations)
    assert it <= 10, it
    r = np.asarray(res.res_history)[:it]
    assert r[-1] < 1e-10 * float(jnp.linalg.norm(prob.b))
    # roughly geometric convergence
    assert np.all(r[1:] / r[:-1] < 0.25)
    # final error vs direct solve is small
    e = np.asarray(res.err_history)[:it]
    assert e[-1] < 1e-8


def test_dg_hierarchy_converges():
    """DG-topped, 4 levels p = 8, 4, 2, 1, CDir = 1000 n (dg_heirarchy_test.jl)."""
    prob = poisson_dg_hierarchy(n=128)
    res = _solve(prob, maxiter=200)
    it = int(res.iterations)
    assert it <= 20, it
    r = np.asarray(res.res_history)[:it]
    assert r[-1] < 1e-10 * float(jnp.linalg.norm(prob.b.T.reshape(-1)))


def test_dg_cg_hierarchy_converges():
    """4 CG + 1 DG level (p reaching 0), CDir = 1000 n (dg_cg_heirarchy_test.jl)."""
    prob = poisson_dg_cg_hierarchy(n=128)
    res = _solve(prob)
    it = int(res.iterations)
    assert it <= 20, it
    r = np.asarray(res.res_history)[:it]
    assert r[-1] < 1e-10 * float(jnp.linalg.norm(prob.b))


@pytest.mark.parametrize("n", [32, 64, 128])
def test_full_hierarchy_converges(n):
    """4 CG + (log2 n - 1) agg levels (full_heirarchy_test.jl)."""
    prob = poisson_full_hierarchy(n=n)
    res = _solve(prob)
    it = int(res.iterations)
    assert it <= 16, (n, it)


def test_full_hierarchy_h_independence():
    """Iteration counts must not grow with n — the headline multigrid property
    (full_heirarchy_test.jl:96-102)."""
    counts = []
    for n in (32, 64, 128):
        prob = poisson_full_hierarchy(n=n)
        counts.append(int(_solve(prob).iterations))
    assert max(counts) - min(counts) <= 2, counts


def test_solution_accuracy_vs_exact():
    """The converged MG solution equals the direct solve to ~1e-10 and the
    discretization reproduces cos to the expected order."""
    prob = poisson_cg_hierarchy(n=64)
    res = _solve(prob)
    it = int(res.iterations)
    e = np.asarray(res.err_history)[:it]
    assert e[-1] < 1e-8
    # nodal error vs cos at grid nodes (p=8 fine level: machine-accurate)
    x = prob.meshes[0].node_x()
    np.testing.assert_allclose(np.asarray(res.x), np.cos(x), atol=1e-9)


def test_v_cycle_and_preconditioner_interface():
    prob = poisson_cg_hierarchy(n=32)
    x1 = v_cycle(prob.hierarchy, jnp.zeros_like(prob.b), prob.b)
    x2 = mg_preconditioner(prob.hierarchy, prob.b)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=0)


def test_multigrid_respects_maxiter():
    prob = poisson_cg_hierarchy(n=32)
    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 2, 1e-16)
    assert int(res.iterations) == 2
    assert np.isfinite(np.asarray(res.res_history)[:2]).all()
    assert np.isnan(np.asarray(res.res_history)[2:]).all()
