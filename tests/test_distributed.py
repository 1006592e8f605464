"""Distributed solver tests on an 8-virtual-CPU-device mesh: sharded execution
must reproduce single-device results; the halo_shift primitive must equal the
global shift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.models.problems import (
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d.models.solvers import multigrid, v_cycle
from agglomerationmultigrid1d.ops.shifts import shift
from agglomerationmultigrid1d.parallel import (
    halo_shift,
    make_solver_mesh,
    shard_hierarchy,
)
from agglomerationmultigrid1d.parallel.distributed import (
    shard_vector,
    unshard_vector,
)


@pytest.mark.parametrize("d", [1, -1, 2])
def test_halo_shift_matches_global(d):
    from jax.sharding import PartitionSpec as P

    mesh = make_solver_mesh(8)
    x = jnp.arange(64, dtype=jnp.float64).reshape(2, 32)

    def f(xl):
        return halo_shift(xl, d, "x")

    out = jax.shard_map(f, mesh=mesh, in_specs=P(None, "x"), out_specs=P(None, "x"))(x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(shift(x, d)), atol=0)


def test_sharded_dg_multigrid_matches_single():
    prob = poisson_dg_hierarchy(n=128, max_p=4, n_dg=3)
    res_ref = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 50, 1e-10)

    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=4)
    b = shard_vector(prob.b, mesh)
    res = multigrid(h, jnp.zeros_like(b), b, 50, 1e-10)

    assert int(res.iterations) == int(res_ref.iterations)
    it = int(res.iterations)
    np.testing.assert_allclose(
        np.asarray(res.res_history)[:it], np.asarray(res_ref.res_history)[:it], rtol=1e-10
    )
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res_ref.x), atol=1e-9)


def test_sharded_full_hierarchy_matches_single():
    """The flagship CG + agglomerated hierarchy, sharded (CG node arrays shard
    unevenly — XLA pads)."""
    prob = poisson_full_hierarchy(n=64)
    res_ref = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 50, 1e-10)

    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=2)
    b = shard_vector(prob.b, mesh, h)
    res = multigrid(h, jnp.zeros_like(b), b, 50, 1e-10)

    assert int(res.iterations) == int(res_ref.iterations)
    x = unshard_vector(res.x, h)
    np.testing.assert_allclose(np.asarray(x), np.asarray(res_ref.x), atol=1e-9)
    it = int(res.iterations)
    # reduction order differs across shards: tiny (~eps-accumulated) drift is
    # expected near convergence, iteration parity + solution agreement are exact
    np.testing.assert_allclose(
        np.asarray(res.res_history)[:it], np.asarray(res_ref.res_history)[:it], rtol=1e-5
    )


def test_sharded_cg_levels_are_actually_sharded():
    """Fine CG levels must shard on the element/node axis (ghost-padded to a
    device multiple), not silently replicate."""
    from jax.sharding import PartitionSpec as P

    prob = poisson_full_hierarchy(n=64)
    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=2)
    fine = h.levels[0]
    assert fine.a.n_nodes_padded % 8 == 0
    assert fine.a.n_nodes == 64 * 8 + 1
    assert fine.a.band.sharding.spec == P(None, "x")
    assert fine.a.windows.sharding.spec == P(None, None, "x")
    assert fine.smoother.inv_diag.sharding.spec == P("x")
    b = shard_vector(prob.b, mesh, h)
    assert b.sharding.spec == P("x")
    # and a sharded V-cycle runs, stays distributed, and the padding is inert
    out = jax.jit(lambda hh, bb: v_cycle(hh, jnp.zeros_like(bb), bb))(h, b)
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out)[fine.a.n_nodes :], 0.0, atol=0)


def test_sharded_mixed_and_progressive_match_single():
    """The float-float mixed and progressive-precision solvers accept
    ``shard=`` (fused shard_map smoothing on the flagged block levels, auto-SPMD
    float-float defects) and reproduce the single-device solve — the north-star
    configuration of fused sharded sweeps *plus* ff defect correction in one
    solve."""
    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid_mixed,
        multigrid_progressive,
    )
    from agglomerationmultigrid1d.parallel import fused_shard_spec

    prob = poisson_dg_hierarchy(n=128, max_p=4, n_dg=3)
    h32_ref = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    nb = float(jnp.linalg.norm(b.T.reshape(-1)))

    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=4)
    h32 = shard_hierarchy(h32_ref, mesh, min_blocks_per_device=4)
    bs = shard_vector(b, mesh)
    shard = fused_shard_spec(h32, mesh)
    assert any(shard[2]), "expected sharded block levels for the fused path"

    for solver in (multigrid_mixed, multigrid_progressive):
        res_ref = solver(
            prob.hierarchy, h32_ref, jnp.zeros_like(b), b, 60, 1e-10, use_pallas=False
        )
        res = solver(h, h32, jnp.zeros_like(bs), bs, 60, 1e-10,
                     use_pallas=False, shard=shard)
        it_ref, it = int(res_ref.iterations), int(res.iterations)
        assert np.asarray(res.res_history)[it - 1] < 1e-10 * nb
        # f32 reduction order differs across shards; allow one extra outer step
        assert abs(it - it_ref) <= 1, (solver.__name__, it, it_ref)
        np.testing.assert_allclose(
            np.asarray(res.x), np.asarray(res_ref.x), atol=1e-9 * nb
        )


def test_sharded_v_cycle_is_actually_sharded():
    """The fine-level arrays must carry a non-trivial sharding after device_put."""
    prob = poisson_dg_hierarchy(n=128, max_p=4, n_dg=2)
    mesh = make_solver_mesh(8)
    h = shard_hierarchy(prob.hierarchy, mesh, min_blocks_per_device=4)
    fine_diag = h.levels[0].a.diag
    assert len(fine_diag.sharding.device_set) == 8
    b = shard_vector(prob.b, mesh)
    out = jax.jit(lambda hh, bb: v_cycle(hh, jnp.zeros_like(bb), bb))(h, b)
    # output stays distributed
    assert len(out.sharding.device_set) == 8
