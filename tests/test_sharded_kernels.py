"""Fused smoother kernels inside shard_map must reproduce the single-device
results: the ppermute ghost exchange + temporally-blocked multisweep
(interpret mode on CPU) and the halo-aware XLA path are both checked against
the global unsharded formulation.

The reference is a serial solver (SURVEY §2: no distributed code); these tests
pin the multi-device scaling path instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy
from agglomerationmultigrid1d.models.solvers import multigrid, v_cycle
from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag, bt_matvec
from agglomerationmultigrid1d.ops.pallas import chebyshev_coefficients, use_multisweep_kernel
from agglomerationmultigrid1d.parallel import (
    fused_shard_spec,
    make_solver_mesh,
    shard_hierarchy,
    sharded_chebyshev_multisweep,
    sharded_multisweep,
)
from agglomerationmultigrid1d.parallel.distributed import shard_vector
from agglomerationmultigrid1d.smoothers.smoother import (
    BlockJacobiSmoother,
    apply_smoother,
)


def _random_system(rng, bs, n, dtype):
    """Diagonally dominant block-tridiagonal system + block-Jacobi inverse."""
    diag = rng.normal(size=(bs, bs, n)) + 6.0 * np.eye(bs)[:, :, None]
    lower = 0.3 * rng.normal(size=(bs, bs, n))
    upper = 0.3 * rng.normal(size=(bs, bs, n))
    lower[:, :, 0] = 0.0
    upper[:, :, -1] = 0.0
    a = BlockTridiag(*(jnp.asarray(m, dtype) for m in (lower, diag, upper)))
    inv = jnp.asarray(
        np.linalg.inv(np.moveaxis(diag, -1, 0)).transpose(1, 2, 0), dtype
    )
    x = jnp.asarray(rng.normal(size=(bs, n)), dtype)
    b = jnp.asarray(rng.normal(size=(bs, n)), dtype)
    return a, inv, x, b


def _reference_sweeps(a, inv, x, b, n_sweeps, alpha):
    sm = BlockJacobiSmoother(inv=inv)
    for _ in range(n_sweeps):
        x = x + apply_smoother(sm, b - bt_matvec(a, x), alpha=alpha)
    return x


def _reference_cheb(a, inv, x, b, coef, degree):
    d = jnp.zeros_like(x)
    cf = coef.astype(x.dtype)
    for s in range(degree):
        z = jnp.einsum("ijn,jn->in", inv, b - bt_matvec(a, x))
        d = cf[s, 0] * d + cf[s, 1] * z
        x = x + d
    return x


@pytest.mark.parametrize("emit_residual", [False, True])
def test_sharded_multisweep_xla_fallback_matches(rng, emit_residual):
    """f64 (parity dtype) takes the halo-aware XLA path per shard."""
    bs, n = 3, 256
    a, inv, x, b = _random_system(rng, bs, n, jnp.float64)
    mesh = make_solver_mesh(8)
    out = sharded_multisweep(
        mesh, "x", a, inv, x, b, n_sweeps=3, alpha=2.0 / 3.0,
        emit_residual=emit_residual, use_pallas=False,
    )
    ref = _reference_sweeps(a, inv, x, b, 3, 2.0 / 3.0)
    if emit_residual:
        np.testing.assert_allclose(np.asarray(out[0]), np.asarray(ref), rtol=1e-13)
        np.testing.assert_allclose(
            np.asarray(out[1]), np.asarray(b - bt_matvec(a, ref)), atol=1e-12
        )
    else:
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-13)


# 8 shards of 1200 columns: several kernel windows per shard, so ghosts, shard
# edges and window edges all meet


@pytest.mark.parametrize("bs", [2, 4])
@pytest.mark.parametrize("emit_residual", [False, True])
def test_sharded_multisweep_pallas_ghosts_match(rng, bs, emit_residual):
    """f32 shards the kernel accepts run the ghosted multisweep (interpret
    mode on CPU) — the shard ghosts must make the result equal the global
    unsharded sweeps."""
    n = 8 * 1200
    assert use_multisweep_kernel(bs, n // 8, jnp.float32)
    a, inv, x, b = _random_system(rng, bs, n, jnp.float32)
    mesh = make_solver_mesh(8)
    out = sharded_multisweep(
        mesh, "x", a, inv, x, b, n_sweeps=3, alpha=2.0 / 3.0,
        emit_residual=emit_residual, use_pallas=True, interpret=True,
    )
    ref = _reference_sweeps(a, inv, x, b, 3, 2.0 / 3.0)
    x_new = out[0] if emit_residual else out
    np.testing.assert_allclose(np.asarray(x_new), np.asarray(ref), rtol=2e-5, atol=2e-5)
    if emit_residual:
        np.testing.assert_allclose(
            np.asarray(out[1]), np.asarray(b - bt_matvec(a, ref)), atol=5e-4
        )


@pytest.mark.parametrize("bs", [2, 4])
@pytest.mark.parametrize("emit_residual", [False, True])
def test_sharded_cheb_pallas_ghosts_match(rng, bs, emit_residual):
    n = 8 * 1200
    degree = 3
    a, inv, x, b = _random_system(rng, bs, n, jnp.float32)
    coef = chebyshev_coefficients(0.2, 2.0, degree)
    mesh = make_solver_mesh(8)
    out = sharded_chebyshev_multisweep(
        mesh, "x", a, inv, x, b, coef, degree=degree,
        emit_residual=emit_residual, use_pallas=True, interpret=True,
    )
    ref = _reference_cheb(a, inv, x, b, coef, degree)
    x_new = out[0] if emit_residual else out
    np.testing.assert_allclose(np.asarray(x_new), np.asarray(ref), rtol=2e-4, atol=2e-4)
    if emit_residual:
        np.testing.assert_allclose(
            np.asarray(out[1]), np.asarray(b - bt_matvec(a, ref)), atol=5e-3
        )


@pytest.mark.parametrize("width", [1, 4])
def test_edge_ghosts_are_neighbor_columns(width):
    """Each shard's ghosts are its neighbours' edge columns; the ring ends get
    zeros (the global zero-Dirichlet boundary)."""
    from jax.sharding import PartitionSpec as P

    from agglomerationmultigrid1d.parallel.sharded_kernels import _edge_ghosts

    n_dev, m = 8, 16
    x = jnp.arange(2 * n_dev * m, dtype=jnp.float32).reshape(2, n_dev * m)
    mesh = make_solver_mesh(n_dev)
    g = jax.shard_map(
        lambda v: _edge_ghosts(v, "x", width), mesh=mesh,
        in_specs=P(None, "x"), out_specs=P(None, "x"),
    )(x)
    g = np.asarray(g).reshape(2, n_dev, 2 * width)
    xs = np.asarray(x).reshape(2, n_dev, m)
    for d in range(n_dev):
        left = xs[:, d - 1, m - width:] if d > 0 else 0.0
        right = xs[:, d + 1, :width] if d < n_dev - 1 else 0.0
        np.testing.assert_array_equal(g[:, d, :width], np.broadcast_to(left, (2, width)))
        np.testing.assert_array_equal(g[:, d, width:], np.broadcast_to(right, (2, width)))


def test_sharded_cheb_xla_fallback_matches(rng):
    bs, n = 3, 256
    a, inv, x, b = _random_system(rng, bs, n, jnp.float64)
    coef = chebyshev_coefficients(0.2, 2.0, 4)
    mesh = make_solver_mesh(8)
    out = sharded_chebyshev_multisweep(
        mesh, "x", a, inv, x, b, coef, degree=4, use_pallas=False
    )
    ref = _reference_cheb(a, inv, x, b, coef, 4)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12)


def test_fused_v_cycle_matches_auto_spmd():
    """The fused shard_map smoother path must give the same V-cycle as XLA's
    automatic partitioning (here the small shapes take the halo-aware XLA local
    function — the code path under test is the shard_map routing itself)."""
    prob = poisson_dg_hierarchy(n=128, max_p=4, n_dg=3)
    ref = v_cycle(prob.hierarchy, jnp.zeros_like(prob.b), prob.b)

    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=4)
    shard = fused_shard_spec(h, mesh)
    assert any(shard[2]), "expected at least one sharded block level"
    b = shard_vector(prob.b, mesh)
    out = jax.jit(
        lambda hh, bb: v_cycle(hh, jnp.zeros_like(bb), bb, shard=shard)
    )(h, b)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12, atol=1e-13)


def test_fused_multigrid_matches_single():
    """Full multigrid driver with fused shard_map smoothers: iteration parity +
    identical residual histories vs the single-device solve."""
    prob = poisson_dg_hierarchy(n=128, max_p=4, n_dg=3)
    res_ref = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 50, 1e-10)

    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=4)
    shard = fused_shard_spec(h, mesh)
    b = shard_vector(prob.b, mesh)
    res = multigrid(h, jnp.zeros_like(b), b, 50, 1e-10, shard=shard)

    assert int(res.iterations) == int(res_ref.iterations)
    it = int(res.iterations)
    np.testing.assert_allclose(
        np.asarray(res.res_history)[:it], np.asarray(res_ref.res_history)[:it], rtol=1e-9
    )
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_ref.x), atol=1e-9)
