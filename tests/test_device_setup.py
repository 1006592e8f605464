"""Accelerator-side hierarchy construction vs the host-f64 build.

The device chain computes the coarse Galerkin/Schur chain in f32 where the
host path computes it in f64 and casts; both carry O(eps_f32) error, so the
operators must agree to f32 rounding and the mixed solver must behave
identically (same fixture as the reference's dg_heirarchy_test.jl scale,
shrunk)."""

import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.models.device_setup import build_dg_hierarchy_device
from agglomerationmultigrid1d.models.hierarchy import (
    chebyshev_hierarchy,
    prepare_fast_smoothers,
    strip_hierarchy,
)
from agglomerationmultigrid1d.models.problems import build_problem
from agglomerationmultigrid1d.models.solvers import multigrid_mixed
from agglomerationmultigrid1d.smoothers.smoother import ChebyshevSmoother
from agglomerationmultigrid1d.utils.config import HierarchySpec
from agglomerationmultigrid1d.utils.precision import hierarchy_astype


@pytest.fixture(scope="module")
def problems():
    n_el = 512
    spec = HierarchySpec(
        cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n_el
    )
    prob = build_problem(spec, n_el, to_device=False)
    return prob


def _host_h32(prob):
    h32 = hierarchy_astype(strip_hierarchy(prob.hierarchy), jnp.float32)
    h32 = chebyshev_hierarchy(h32)
    return prepare_fast_smoothers(h32)


def _device_h32(prob):
    lv0 = prob.hierarchy.levels[0]
    return build_dg_hierarchy_device(prob.meshes, lv0.a, lv0.g, lv0.d, lv0.c)


def test_device_chain_matches_host_cast(problems):
    prob = problems
    h_host = _host_h32(prob)
    h_dev = _device_h32(prob)
    assert h_dev.n_levels == h_host.n_levels
    for k, (lh, ld) in enumerate(zip(h_host.levels, h_dev.levels)):
        for name in ("lower", "diag", "upper"):
            ah, ad = getattr(lh.a, name), getattr(ld.a, name)
            scale = np.max(np.abs(np.asarray(ah))) or 1.0
            np.testing.assert_allclose(
                np.asarray(ad), np.asarray(ah), atol=2e-5 * scale,
                err_msg=f"level {k} {name}",
            )
        sh, sd = lh.smoother, ld.smoother
        if isinstance(sh, ChebyshevSmoother):
            assert isinstance(sd, ChebyshevSmoother)
            # spectral bound from the same power iteration, f32 vs f64 chain
            np.testing.assert_allclose(
                float(sd.lam_hi), float(sh.lam_hi), rtol=1e-3, err_msg=f"level {k}"
            )


def test_device_hierarchy_solves_like_host(problems):
    prob = problems
    from agglomerationmultigrid1d.models.hierarchy import chebyshev_hierarchy as ch

    h64 = ch(prob.hierarchy)
    b = prob.b
    res_host = multigrid_mixed(h64, _host_h32(prob), jnp.zeros_like(b), b, 40, 1e-10)
    res_dev = multigrid_mixed(h64, _device_h32(prob), jnp.zeros_like(b), b, 40, 1e-10)
    it_h, it_d = int(res_host.iterations), int(res_dev.iterations)
    assert it_d <= it_h + 1
    nb = float(jnp.linalg.norm(b))
    rel = float(np.asarray(res_dev.res_history)[it_d - 1]) / nb
    assert rel < 1e-10
