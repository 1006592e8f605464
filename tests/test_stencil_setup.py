"""Stencil-inflated setup (models/stencil_setup.py) must reproduce the direct
host build exactly: on a uniform mesh every level/transfer/smoother array is
translation invariant away from the boundary, so inflating stencils extracted
from an n/z-size build must give the same full-size hierarchy the reference's
full-size assembly chain (``src/mesh_heirarchy.jl:30-181``) produces."""

import os as _os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))

from agglomerationmultigrid1d.models.hierarchy import (
    CgLevel,
    chebyshev_hierarchy,
    prepare_fast_smoothers,
    strip_hierarchy,
)
from agglomerationmultigrid1d.models.problems import build_problem
from agglomerationmultigrid1d.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d.models.stencil_setup import (
    build_xl_problem,
    default_stencil_factor,
    inflate_hierarchy,
)
from agglomerationmultigrid1d.ops.coarse_solve import coarse_solve
from agglomerationmultigrid1d.ops.df64 import FF, bt_split, cg_band_split, ff_split
from agglomerationmultigrid1d.utils.config import HierarchySpec
from agglomerationmultigrid1d.utils.precision import hierarchy_astype


def _dg_spec(n):
    return HierarchySpec(
        cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n
    )


def _flagship_spec(n, smoother="jac"):
    return HierarchySpec(
        cg_orders=(8, 4, 2, 1), n_agg_levels=3, p_agg=1, c_dir=1000.0 * n,
        cg_smoother=smoother,
    )


def _assert_tree_close(tree_a, tree_b, rtol):
    la, ta = jax.tree_util.tree_flatten(tree_a)
    lb, tb = jax.tree_util.tree_flatten(tree_b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        if x.size == 0:
            continue
        scale = max(float(np.abs(y).max()), 1e-30)
        np.testing.assert_allclose(x, y, atol=rtol * scale, rtol=0)


def _reference_lowprec(spec, n):
    prob = build_problem(spec, n, to_device=False)
    h64 = strip_hierarchy(prob.hierarchy)
    fine = h64.levels[0]
    a_ff = cg_band_split(fine.a.band) if isinstance(fine, CgLevel) else bt_split(fine.a)
    h_ref = prepare_fast_smoothers(hierarchy_astype(h64, jnp.float32))
    return prob, h_ref, a_ff


@pytest.mark.parametrize("n", [4096, 3 * 1024])
def test_inflated_dg_matches_direct_build(n):
    """Every inflated array (levels, smoothers incl. M-form streams, transfers,
    the float-float fine pair, b) equals the direct full-size host build —
    bitwise for dyadic h, to one-f32-ULP jitter otherwise."""
    spec = _dg_spec(n)
    z = default_stencil_factor(spec, n)
    assert z >= 8
    h_low, a_ff, b_ff, norm_b = build_xl_problem(spec, n, z=z, chebyshev=False)
    prob, h_ref, a_ff_ref = _reference_lowprec(spec, n)

    _assert_tree_close(h_low.levels, h_ref.levels, rtol=3e-7)
    _assert_tree_close(h_low.transfers, h_ref.transfers, rtol=3e-7)
    _assert_tree_close(a_ff.hi, a_ff_ref.hi, rtol=3e-7)
    # hi + lo must reproduce the f64 operator (the pair, not lo alone, is the
    # invariant: lo legitimately jumps by an f32 ulp of hi at rounding edges)
    ff_sum = jax.tree_util.tree_map(
        lambda h, l: h.astype(np.float64) + l.astype(np.float64), a_ff.hi, a_ff.lo
    )
    ff_sum_ref = jax.tree_util.tree_map(
        lambda h, l: h.astype(np.float64) + l.astype(np.float64),
        a_ff_ref.hi, a_ff_ref.lo,
    )
    _assert_tree_close(ff_sum, ff_sum_ref, rtol=1e-11)

    b_ref = ff_split(jnp.asarray(prob.b))
    _assert_tree_close(b_ff.hi, b_ref.hi, rtol=3e-7)
    np.testing.assert_allclose(
        norm_b, float(jnp.linalg.norm(jnp.asarray(prob.b).T.reshape(-1))), rtol=1e-12
    )

    rng = np.random.default_rng(0)
    nc = h_ref.levels[-1].a.n_dof
    v = jnp.asarray(rng.standard_normal(nc), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(coarse_solve(h_low.coarse, v)),
        np.asarray(coarse_solve(h_ref.coarse, v)),
        rtol=1e-4,
    )


@pytest.mark.parametrize("smoother", ["jac", "hybridSchwarz"])
def test_inflated_flagship_matches_direct_build(smoother):
    """The CG-topped flagship chain (4 CG levels p=8..1, seam, agg levels)
    inflates exactly too: windows, bands, Schwarz inverses + multiplicities,
    the seam transfer, and the CG-band float-float pair."""
    n = 2048
    spec = _flagship_spec(n, smoother)
    h_low, a_ff, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=False)
    prob, h_ref, a_ff_ref = _reference_lowprec(spec, n)

    _assert_tree_close(h_low.levels, h_ref.levels, rtol=3e-7)
    _assert_tree_close(h_low.transfers, h_ref.transfers, rtol=3e-7)
    _assert_tree_close(a_ff.hi, a_ff_ref.hi, rtol=3e-7)
    b_ref = ff_split(jnp.asarray(prob.b))
    _assert_tree_close(b_ff.hi, b_ref.hi, rtol=3e-7)


def test_inflated_chebyshev_bounds_close_to_full_size():
    """The Chebyshev lambda_max is reused from the stencil-size hierarchy (a
    converged 50-iteration power estimate with an inflated 1.1 safety).  Only
    *under*-estimation is dangerous (the polynomial amplifies modes above
    lam_hi): the reused bound must cover the raw full-size power estimate and
    stay within ~25% above it."""
    n = 4096
    spec = _dg_spec(n)
    h_low, _, _, _ = build_xl_problem(spec, n, z=8, chebyshev=True)
    _, h_ref, _ = _reference_lowprec(spec, n)
    h_ref = chebyshev_hierarchy(h_ref, power_iters=50, safety=1.0)  # raw lambda
    for lv, lr in zip(h_low.levels[:-1], h_ref.levels[:-1]):
        lam_s, lam_f = float(lv.smoother.lam_hi), float(lr.smoother.lam_hi)
        assert lam_s >= lam_f, (lam_s, lam_f)
        assert lam_s <= 1.25 * lam_f, (lam_s, lam_f)


def test_inflated_solve_converges():
    """End-to-end: the guarded float-float refinement on the inflated flagship
    hierarchy reaches 1e-10 relative residual with the usual cycle counts."""
    n = 2048
    spec = _flagship_spec(n)
    h_low, a_ff, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=True)
    x_ff = FF(jnp.zeros_like(b_ff.hi), jnp.zeros_like(b_ff.hi))
    res = _mixed_loop_ff(
        h_low, a_ff, x_ff, b_ff, jnp.asarray(1.0 / norm_b, jnp.float32),
        maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20,
        n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
    )
    it, cycles = int(res[1]), int(res[2])
    rel = float(np.asarray(res[3])[it - 1])
    assert rel < 1e-10
    assert cycles <= 40


def test_slim_fine_defect_and_solve():
    """slim_fine mode: the stencil float-float defect must match the
    materialized-pair defect exactly away from the boundary seams (and to
    f64-jitter at them), the slim fine level's M-form matvec must approximate
    A x to f32 rounding, and the guarded solve must converge identically."""
    from agglomerationmultigrid1d.models.solvers import level_matvec
    from agglomerationmultigrid1d.ops.df64 import ff_defect

    n = 4096
    spec = _dg_spec(n)
    h_s, a_s, b_s, norm_s = build_xl_problem(spec, n, z=8, chebyshev=True,
                                             slim_fine=True)
    h_f, a_f, b_f, norm_f = build_xl_problem(spec, n, z=8, chebyshev=True)

    # slim level carries no off-diagonals; the full one does
    assert h_s.levels[0].a.lower.size == 0
    assert h_f.levels[0].a.lower.size > 0

    rng = np.random.default_rng(3)
    xh = jnp.asarray(rng.standard_normal((2, n)), jnp.float32)
    x = FF(xh, jnp.zeros_like(xh))
    r_s = ff_defect(a_s, x, b_s)
    r_f = ff_defect(a_f, x, b_f)
    val_s = np.asarray(r_s.hi, np.float64) + np.asarray(r_s.lo, np.float64)
    val_f = np.asarray(r_f.hi, np.float64) + np.asarray(r_f.lo, np.float64)
    np.testing.assert_allclose(
        val_s, val_f, rtol=0, atol=1e-12 * float(np.abs(val_f).max())
    )

    # M-form matvec of the slim level ~ true A x to f32 rounding
    y_s = np.asarray(level_matvec(h_s.levels[0], xh))
    from agglomerationmultigrid1d.ops.block_tridiag import bt_matvec

    y_f = np.asarray(bt_matvec(h_f.levels[0].a, xh))
    np.testing.assert_allclose(y_s, y_f, rtol=0, atol=3e-6 * float(np.abs(y_f).max()))

    def run(h, a_ff, b_ff, norm_b):
        x_ff = FF(jnp.zeros_like(b_ff.hi), jnp.zeros_like(b_ff.hi))
        res = _mixed_loop_ff(
            h, a_ff, x_ff, b_ff, jnp.asarray(1.0 / norm_b, jnp.float32),
            maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20,
            n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
        )
        it = int(res[1])
        return int(res[2]), float(np.asarray(res[3])[it - 1])

    cyc_s, rel_s = run(h_s, a_s, b_s, norm_s)
    cyc_f, rel_f = run(h_f, a_f, b_f, norm_f)
    assert rel_s < 1e-10 and rel_f < 1e-10
    assert abs(cyc_s - cyc_f) <= 3, (cyc_s, cyc_f)


def test_inflate_f64_identity_roundtrip():
    """Inflating an f64 hierarchy by its own z against a direct f64 build of
    the same size is exact (the generic inflation entry point)."""
    n, z = 2048, 4
    spec = _dg_spec(n)
    prob_small = build_problem(
        spec, n // z, to_device=False,
        mesh=__import__(
            "agglomerationmultigrid1d.models.stencil_setup", fromlist=["x"]
        )._stencil_mesh(n // z, 1.0 / n),
    )
    h_small = strip_hierarchy(prob_small.hierarchy)
    h_big = inflate_hierarchy(h_small, h_small, z)
    prob = build_problem(spec, n, to_device=False)
    h_ref = strip_hierarchy(prob.hierarchy)
    _assert_tree_close(h_big.levels, h_ref.levels, rtol=1e-11)
    _assert_tree_close(h_big.transfers, h_ref.transfers, rtol=1e-11)


def test_inflation_rejects_nonuniform():
    """A graded mesh is not translation invariant; the constancy check must
    catch it instead of silently inflating a wrong operator."""
    from agglomerationmultigrid1d.mesh.topology import create_graded_mesh

    n, z = 2048, 8
    spec = _dg_spec(n)
    prob_small = build_problem(
        spec, n // z, to_device=False, mesh=create_graded_mesh(n // z, 0.0, 1.0)
    )
    h_small = strip_hierarchy(prob_small.hierarchy)
    with pytest.raises(ValueError, match="translation invariant"):
        inflate_hierarchy(h_small, h_small, z)


_EAGER_PARITY_SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from agglomerationmultigrid1d.models.solvers import (
    _mixed_eager_outer,
    _mixed_loop_ff,
    _progressive_eager,
    _progressive_loop,
)
from agglomerationmultigrid1d.models.stencil_setup import build_xl_problem
from agglomerationmultigrid1d.ops.df64 import FF
from agglomerationmultigrid1d.utils.config import HierarchySpec

n = 4096
spec = HierarchySpec(
    cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n
)
h32, ffops, b_ff, norm_b = build_xl_problem(
    spec, n, z=8, slim_fine=True, ff_levels=True
)
a_ffs, coarse64 = ffops.a_ffs, ffops.coarse64
a_ff = a_ffs[0]
x0 = FF(jnp.zeros_like(b_ff.hi), jnp.zeros_like(b_ff.hi))
inv_nb = jnp.asarray(1.0 / norm_b, jnp.float32)

# split-program progressive cycles == the fused _progressive_loop, bit-exact
# (both with the f32+refinement coarse and the f64 coarse factorization)
pkw = dict(n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False)
for c64 in (None, coarse64):
    xf_p, itf_p, hf_p = _progressive_loop(
        h32, a_ffs, x0, b_ff, inv_nb, c64, maxiter=6, tol=1e-30, **pkw
    )
    for cut in (1, 2):
        xe_p, ite_p, he_p = _progressive_eager(
            h32, a_ffs, x0, b_ff, inv_nb, c64, maxiter=6, tol=1e-30, cut=cut, **pkw
        )
        assert int(ite_p) == int(itf_p), (cut, int(ite_p), int(itf_p))
        np.testing.assert_array_equal(np.asarray(xe_p.hi), np.asarray(xf_p.hi))
        np.testing.assert_array_equal(np.asarray(xe_p.lo), np.asarray(xf_p.lo))
        hfn, hen = np.asarray(hf_p), np.asarray(he_p)
        mask = ~np.isnan(hfn)
        np.testing.assert_array_equal(mask, ~np.isnan(hen))
        np.testing.assert_allclose(hen[mask], hfn[mask], rtol=0, atol=0)
# the TRUE-precision cycle (value-accurate operators + f64 outer defect)
# converges BELOW the float-float accuracy floor
# (~2^-48 * |||A||x||/||b|| — about 3e-11 at this n, ~4e-7 at the 1e8 north star)
from agglomerationmultigrid1d.models.solvers import _progressive_true_eager
xt, itt, ht = _progressive_true_eager(
    h32, ffops, x0, b_ff, inv_nb, maxiter=35, tol=1e-11, cut=1,
    n_pre=3, n_post=3, alpha=2.0 / 3.0,
)
assert ht[itt - 1] < 1e-11, (itt, ht[itt - 1])
print("PROGRESSIVE_PARITY_OK")

# THE conditioning regression: with c_dir inflated to match the 1e8-DoF north
# star's eps32*kappa_elem ~ 6, plain ff cycles AMPLIFY (~3.4x/cycle) while the
# TRUE-precision cycle must converge like f64 multigrid
n2 = 16384
spec2 = HierarchySpec(
    cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, agg_factor=4,
    c_dir=1000.0 * float(3 << 24) ** 2 / n2,
)
h2, ff2, b2, nb2 = build_xl_problem(spec2, n2, slim_fine=True, ff_levels=True)
z2 = FF(jnp.zeros_like(b2.hi), jnp.zeros_like(b2.hi))
xk, itk, hk = _progressive_true_eager(
    h2, ff2, z2, b2, jnp.asarray(1.0 / nb2, jnp.float32),
    maxiter=25, tol=1e-10, cut=1, n_pre=3, n_post=3, alpha=2.0 / 3.0,
)
assert hk[itk - 1] < 1e-10, (itk, hk[itk - 1])
print("TRUE_KAPPA_OK")

# and the guarded mixed loop HANDS OVER to the true cycles when its f32
# refinement stalls (the trickle-detection rule), converging end to end
xm, om, cm, hm = _mixed_eager_outer(
    h2, ff2.a_ffs[0], z2, b2, jnp.asarray(1.0 / nb2, jnp.float32),
    maxiter=60, tol=1e-9, inner_tol=3.0e-5, max_inner=20,
    n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
    eager_inner=True, eager_cut=1, ffops=ff2,
)
assert np.asarray(hm)[int(om) - 1] < 1e-9, np.asarray(hm)[: int(om)]
print("MIXED_HANDOVER_OK")
kw = dict(
    maxiter=40, tol=1e-8, inner_tol=3.0e-5, max_inner=20,
    n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
)
xf, of, cf, hf = _mixed_loop_ff(h32, a_ff, x0, b_ff, inv_nb, **kw)
for variant_kw in (
    {},
    {"eager_inner": True},
    {"eager_inner": True, "eager_cut": 1},  # fine level as split programs
    {"eager_inner": True, "eager_cut": 2},  # two split levels + fused tail
):
    xe, oe, ce, he = _mixed_eager_outer(h32, a_ff, x0, b_ff, inv_nb, **kw, **variant_kw)
    assert int(oe) == int(of), (variant_kw, int(oe), int(of))
    assert int(ce) == int(cf), (variant_kw, int(ce), int(cf))
    np.testing.assert_array_equal(np.asarray(xe.hi), np.asarray(xf.hi))
    np.testing.assert_array_equal(np.asarray(xe.lo), np.asarray(xf.lo))
    hfn, hen = np.asarray(hf), np.asarray(he)
    mask = ~np.isnan(hfn)
    np.testing.assert_array_equal(mask, ~np.isnan(hen))
    np.testing.assert_allclose(hen[mask], hfn[mask], rtol=0, atol=0)
print("EAGER_PARITY_OK")
"""


def test_eager_outer_matches_fused():
    """The host-outer-loop mixed solver (used above the fused module's
    compile-size ceiling) reproduces the fused loop exactly: same outer count,
    cycle count, residual history, and iterate.

    Runs in a fresh subprocess: in a long pytest session this image's XLA:CPU
    backend intermittently SIGABRTs/segfaults while compiling the large fused
    module (also seen loading cross-machine cached CPU executables —
    `cpu_aot_loader` machine-feature mismatch); a clean process compiles it
    reliably and keeps the flake out of the suite."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _EAGER_PARITY_SCRIPT],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "PROGRESSIVE_PARITY_OK" in proc.stdout
    assert "TRUE_KAPPA_OK" in proc.stdout
    assert "MIXED_HANDOVER_OK" in proc.stdout
    assert "EAGER_PARITY_OK" in proc.stdout


def test_multigrid_true_public_wrapper():
    """`models.multigrid_true` (the public north-star entry) converges below
    the float-float floor on a conditioning-matched problem and preserves the
    reference observability contract."""
    from agglomerationmultigrid1d.models import multigrid_true

    n = 16384
    spec = HierarchySpec(
        cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, agg_factor=4,
        c_dir=1000.0 * float(3 << 24) ** 2 / n,  # eps32 * kappa_elem ~ 6
    )
    h32, ffops, b_ff, norm_b = build_xl_problem(
        spec, n, slim_fine=True, ff_levels=True
    )
    res = multigrid_true(
        h32, ffops, b_ff, norm_b, maxiter=25, tol=1e-10, pallas_min_blocks=8192
    )
    it = int(res.iterations)
    hist = np.asarray(res.res_history)
    assert hist[it - 1] < 1e-10 * norm_b
    assert np.isnan(hist[it:]).all()
    assert res.x.dtype == jnp.float64
