"""Block-cyclic-reduction coarse solver (ops/coarse_solve.py).

The reference's coarsest-level solve is UMFPACK ``A \\ b`` at any size
(``/root/reference/src/solvers.jl:39``); the equivalents here are a dense
inverse for small levels and block cyclic reduction beyond
``DENSE_COARSE_MAX`` — these tests pin both to the direct solution.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from agglomerationmultigrid1d.models.hierarchy import DENSE_COARSE_MAX
from agglomerationmultigrid1d.ops import (
    BlockTridiag,
    bt_to_dense,
    coarse_solve,
    make_bt_coarse_solver,
)


def _random_dd_bt(bs: int, n: int, seed: int = 0) -> BlockTridiag:
    """Random block-diagonally-dominant operator (stable without pivoting)."""
    rng = np.random.default_rng(seed)
    lower = rng.standard_normal((bs, bs, n))
    diag = rng.standard_normal((bs, bs, n))
    upper = rng.standard_normal((bs, bs, n))
    lower[:, :, 0] = 0.0
    upper[:, :, -1] = 0.0
    diag += (3.0 * bs) * np.eye(bs)[:, :, None]
    return BlockTridiag(jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper))


@pytest.mark.parametrize("bs,n", [(1, 1), (1, 7), (2, 2), (2, 31), (2, 64), (4, 100)])
def test_bcr_matches_dense(bs, n):
    a = _random_dd_bt(bs, n, seed=bs * 100 + n)
    s = make_bt_coarse_solver(a)
    rng = np.random.default_rng(n)
    b = rng.standard_normal(n * bs)
    x = np.asarray(coarse_solve(s, jnp.asarray(b)))
    x_ref = np.linalg.solve(np.asarray(bt_to_dense(a)), b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-9)


def test_bcr_garbage_band_entries_ignored():
    """The unused lower[.,.,0] / upper[.,.,-1] slots must not affect the solve."""
    a = _random_dd_bt(2, 17, seed=3)
    dirty = BlockTridiag(
        a.lower.at[:, :, 0].set(99.0), a.diag, a.upper.at[:, :, -1].set(-99.0)
    )
    b = jnp.asarray(np.random.default_rng(5).standard_normal(34))
    x_clean = coarse_solve(make_bt_coarse_solver(a), b)
    x_dirty = coarse_solve(make_bt_coarse_solver(dirty), b)
    np.testing.assert_allclose(np.asarray(x_clean), np.asarray(x_dirty), rtol=1e-12)


def test_large_coarse_dg_hierarchy_solves():
    """A DG-topped hierarchy whose coarsest level exceeds DENSE_COARSE_MAX
    (the old MAX_COARSE_DOF hard error) now builds and converges."""
    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy
    from agglomerationmultigrid1d.models.solvers import multigrid
    from agglomerationmultigrid1d.ops.coarse_solve import BTCoarseSolver

    n = 8192  # coarsest = one 4:1 agg level -> 2048 agglomerates = 4096 DoF
    prob = poisson_dg_hierarchy(n=n, max_p=1, n_dg=1, n_agg=1, p_agg=1)
    coarsest = prob.hierarchy.levels[-1]
    assert coarsest.a.n_dof > DENSE_COARSE_MAX
    assert isinstance(prob.hierarchy.coarse, BTCoarseSolver)
    res = multigrid(
        prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 60, 1e-10, compute_error=False
    )
    it = int(res.iterations)
    norm_b = float(jnp.linalg.norm(prob.b.T.reshape(-1)))
    assert float(res.res_history[it - 1]) < 1e-10 * norm_b
