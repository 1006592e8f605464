"""Fused smoother kernels (Triton route, interpreter mode on CPU), the
kernel-choice function, the XLA matvec and float-float defect that replaced
the old kernels, and mixed-precision multigrid convergence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.ops import BlockTridiag, bt_matvec
from agglomerationmultigrid1d.ops.block_tridiag import block_mul
from agglomerationmultigrid1d.ops.pallas import (
    chebyshev_coefficients,
    kernel_halo,
    pallas_block_jacobi_multisweep,
    pallas_chebyshev_multisweep,
    use_multisweep_kernel,
)
from agglomerationmultigrid1d.ops.pallas import block_kernels
from agglomerationmultigrid1d.smoothers.smoother import (
    BlockJacobiSmoother,
    apply_smoother,
)


def _random_bt(rng, bs, n, dtype=jnp.float64):
    l = rng.standard_normal((bs, bs, n))
    l[:, :, 0] = 0
    u = rng.standard_normal((bs, bs, n))
    u[:, :, -1] = 0
    d = rng.standard_normal((bs, bs, n)) + 5 * np.eye(bs)[:, :, None]
    return BlockTridiag(*[jnp.asarray(m, dtype) for m in (l, d, u)])


def _exact_inverse(a):
    """The block-Jacobi inverse the M-form kernels require (S^-1 A_D = I)."""
    return jnp.asarray(
        np.linalg.inv(np.moveaxis(np.asarray(a.diag, np.float64), -1, 0)).transpose(1, 2, 0),
        jnp.float32,
    )


def _reference(a, sinv, x, b, steps, coef=None, alpha=2.0 / 3.0):
    """Plain XLA sweeps (damped block Jacobi, or the Chebyshev recurrence)."""
    if coef is None:
        for _ in range(steps):
            x = x + apply_smoother(BlockJacobiSmoother(inv=sinv), b - bt_matvec(a, x), alpha)
    else:
        d = jnp.zeros_like(x)
        for s in range(steps):
            z = jnp.einsum("ijn,jn->in", sinv, b - bt_matvec(a, x))
            d = coef[s, 0] * d + coef[s, 1] * z
            x = x + d
    return x, b - bt_matvec(a, x)


# n = 1200 spans several kernel windows (tile = WINDOW - 2 * halo), so program
# edges, the domain ends and the masked tail of the last window are all hit
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("emit_residual", [False, True])
@pytest.mark.parametrize("bs", [2, 4])
def test_fused_multisweep_interpret_matches_xla(rng, bs, emit_residual, kind):
    n, steps = 1200, 3
    a = _random_bt(rng, bs, n, jnp.float32)
    sinv = _exact_inverse(a)
    x0 = jnp.asarray(rng.standard_normal((bs, n)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((bs, n)), jnp.float32)
    coef = chebyshev_coefficients(jnp.float32(0.3), jnp.float32(1.2), steps)
    ml, mu = block_mul(sinv, a.lower), block_mul(sinv, a.upper)
    kw = dict(interpret=True, emit_residual=emit_residual, ml=ml, mu=mu)
    if kind == "jacobi":
        out = pallas_block_jacobi_multisweep(a, sinv, x0, b, n_sweeps=steps, **kw)
        ref_x, ref_r = _reference(a, sinv, x0, b, steps)
    else:
        out = pallas_chebyshev_multisweep(a, sinv, x0, b, coef, steps, **kw)
        ref_x, ref_r = _reference(a, sinv, x0, b, steps, coef=coef)
    x = out[0] if emit_residual else out
    scale = float(jnp.abs(ref_x).max())
    np.testing.assert_allclose(np.asarray(x), np.asarray(ref_x), atol=2e-5 * scale)
    if emit_residual:
        np.testing.assert_allclose(
            np.asarray(out[1]), np.asarray(ref_r), atol=2e-4 * float(jnp.abs(b).max())
        )


def test_fused_multisweep_computes_mform_streams(rng):
    """Without the setup-time ml/mu the kernel derives them itself."""
    bs, n = 2, 700
    a = _random_bt(rng, bs, n, jnp.float32)
    sinv = _exact_inverse(a)
    x0 = jnp.asarray(rng.standard_normal((bs, n)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((bs, n)), jnp.float32)
    out = pallas_block_jacobi_multisweep(a, sinv, x0, b, n_sweeps=2, interpret=True)
    ref_x, _ = _reference(a, sinv, x0, b, 2)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(ref_x), atol=2e-5 * float(jnp.abs(ref_x).max())
    )


@pytest.mark.parametrize("dtype,bs", [(jnp.float64, 2), (jnp.float32, 3)])
def test_fused_multisweep_rejects_unsupported_inputs(rng, dtype, bs):
    """f64 and non-power-of-two blocks are never sent to the kernel; calling it
    directly with them is an error, not a silent fallback."""
    a = _random_bt(rng, bs, 64, dtype)
    x = jnp.zeros((bs, 64), dtype)
    with pytest.raises(ValueError, match="use_multisweep_kernel"):
        pallas_block_jacobi_multisweep(a, a.diag, x, x, interpret=True)


@pytest.mark.parametrize(
    "bs,n,dtype,min_blocks,expected",
    [
        (2, 1 << 20, jnp.float32, 0, True),
        (4, 2, jnp.float32, 0, True),
        (4, 4096, jnp.float32, 4096, True),
        (4, 4095, jnp.float32, 4096, False),
        (2, 1 << 20, jnp.float64, 0, False),
        (3, 1 << 20, jnp.float32, 0, False),
        (9, 1 << 20, jnp.float32, 0, False),
    ],
)
def test_kernel_choice(bs, n, dtype, min_blocks, expected):
    assert use_multisweep_kernel(bs, n, dtype, min_blocks) is expected


def test_on_gpu_lowers_only_the_xla_branch_here():
    """Off the GPU the program holds the XLA branch alone (the Triton kernel
    has no lowering here), and gives its result; ``interpret=True`` takes the
    kernel branch on any platform."""
    x = jnp.arange(6.0, dtype=jnp.float32)
    f = jax.jit(lambda x: block_kernels.on_gpu(lambda x: x * 0.0 - 1.0, lambda x: x + 1.0, x))
    np.testing.assert_array_equal(np.asarray(f(x)), np.asarray(x + 1.0))
    assert "custom_call" not in f.lower(x).as_text()
    g = jax.jit(lambda x: block_kernels.on_gpu(
        lambda x: x * 0.0 - 1.0, lambda x: x + 1.0, x, interpret=True))
    np.testing.assert_array_equal(np.asarray(g(x)), -np.ones(6, np.float32))


@pytest.mark.parametrize("steps,emit_residual,halo", [(3, False, 3), (3, True, 4), (1, True, 2)])
def test_kernel_halo(steps, emit_residual, halo):
    assert kernel_halo(steps, emit_residual) == halo


def test_solver_routes_levels_through_kernel_choice(monkeypatch):
    """The solver takes the fused kernel exactly where the choice function
    says so (and never for f64 or ``use_pallas=False``)."""
    from agglomerationmultigrid1d.models import solvers
    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy
    from agglomerationmultigrid1d.models.solvers import (
        _pallas_smooth_ok,
        make_low_precision_hierarchy,
    )

    prob = poisson_dg_hierarchy(n=64, max_p=3, n_dg=2)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    fine32, fine64 = h32.levels[0], prob.hierarchy.levels[0]
    u32 = jnp.zeros((4, 64), jnp.float32)
    assert _pallas_smooth_ok(fine32, u32, True)
    assert _pallas_smooth_ok(fine32, u32, 64)  # int threshold at n
    assert not _pallas_smooth_ok(fine32, u32, False)
    assert not _pallas_smooth_ok(fine32, u32, 128)  # int threshold above n
    monkeypatch.setattr(solvers, "PALLAS_MIN_BLOCKS", 128)
    assert not _pallas_smooth_ok(fine32, u32, True)
    assert not _pallas_smooth_ok(fine64, jnp.zeros((4, 64)), True)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-12), (jnp.float32, 1e-5)])
def test_level_matvec_matches_oracle(dtype, tol):
    """The XLA block matvec that replaced the matvec kernel, on every block
    level of a DG chain (f64 and the f32 inner hierarchy), against the dense
    oracle's operators."""
    from oracle import build_oracle_hierarchy
    from test_parity import _oracle_spec

    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy
    from agglomerationmultigrid1d.models.solvers import (
        _flatten_level_vec,
        level_matvec,
        make_low_precision_hierarchy,
    )

    prob = poisson_dg_hierarchy(n=32, max_p=3, n_dg=2)
    h = prob.hierarchy
    oracle_levels, _ = build_oracle_hierarchy(_oracle_spec(h))
    hl = h if dtype == jnp.float64 else make_low_precision_hierarchy(h, dtype)
    rng = np.random.default_rng(1)
    for lv, ol in zip(hl.levels, oracle_levels):
        bs, n = lv.a.diag.shape[0], lv.a.diag.shape[-1]
        x = rng.standard_normal((bs, n))
        got = np.asarray(_flatten_level_vec(level_matvec(lv, jnp.asarray(x, dtype))))
        want = ol.a @ x.T.reshape(-1)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_mixed_precision_multigrid_converges_to_f64_tol():
    """f32 inner V-cycle + f64 defect correction reaches 1e-10 relative residual
    and matches the all-f64 solve."""
    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy
    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
    )

    prob = poisson_dg_hierarchy(n=256, max_p=4, n_dg=3)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    res = multigrid_mixed(prob.hierarchy, h32, jnp.zeros_like(b), b, 80, 1e-10, use_pallas=False)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(b.T.reshape(-1)))
    r = np.asarray(res.res_history)[:it]
    assert r[-1] < 1e-10 * nb, (it, r[-1] / nb)

    res64 = multigrid(prob.hierarchy, jnp.zeros_like(b), b, 80, 1e-10, compute_error=False)
    # Both runs stop on the same relative-residual criterion; for this
    # penalty-conditioned A (CDir = 1000 n) two residual-stopped solutions may
    # legitimately differ by ~cond(A) * tol * ||x||.  Check both are equally
    # good solutions of the system rather than bitwise-near each other.
    from agglomerationmultigrid1d.models.solvers import _flatten_level_vec, level_matvec

    def true_rel_defect(x):
        return float(
            jnp.linalg.norm(_flatten_level_vec(level_matvec(prob.hierarchy.levels[0], x) - b))
        ) / nb

    assert true_rel_defect(res.x) < 1e-10
    assert true_rel_defect(res64.x) < 1e-10
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(res64.x), atol=1e-4)
    # the mixed refinement should need far fewer f64 defects than f64 V-cycles,
    # and not dramatically more total cycles
    assert it <= int(res64.iterations), (it, int(res64.iterations))
    assert int(res.inner_cycles) <= 4 * int(res64.iterations), (
        int(res.inner_cycles), int(res64.iterations),
    )


def test_mixed_solve_with_kernel_route_interpret_equivalent(monkeypatch):
    """The mixed solver with the kernel route enabled converges like the XLA
    route (CPU: the route is forced on, the kernel runs through the solver's
    own dispatch, and the choice function sends this level to it)."""
    from agglomerationmultigrid1d.models import solvers
    from agglomerationmultigrid1d.models.problems import poisson_dg_hierarchy

    prob = poisson_dg_hierarchy(n=256, max_p=3, n_dg=2)
    h = prob.hierarchy
    h32 = solvers.make_low_precision_hierarchy(h)
    b = prob.b
    ref = solvers.multigrid_mixed(h, h32, jnp.zeros_like(b), b, 60, 1e-10, use_pallas=False)

    calls = []
    real = block_kernels._fused_pass

    def interpreted(*args, **kw):
        calls.append(kw["steps"])
        kw["interpret"] = True
        return real(*args, **kw)

    # the kernel branch here too (it is dropped off the GPU), and only on the
    # 256-block fine level (the int threshold), to keep interpret mode short
    monkeypatch.setattr(block_kernels, "on_gpu", lambda kernel, xla, *a, **k: kernel(*a))
    monkeypatch.setattr(block_kernels, "_fused_pass", interpreted)
    jax.clear_caches()
    try:
        res = solvers.multigrid_mixed(h, h32, jnp.zeros_like(b), b, 60, 1e-10, use_pallas=256)
    finally:
        jax.clear_caches()
    assert calls, "the kernel route was never taken"
    nb = float(jnp.linalg.norm(b.T.reshape(-1)))
    it = int(res.iterations)
    assert float(np.asarray(res.res_history)[it - 1]) < 1e-10 * nb
    assert abs(it - int(ref.iterations)) <= 1


@pytest.mark.parametrize("fenced", [True, False])
@pytest.mark.parametrize("kind", ["dense", "stencil"])
def test_xla_ff_defect_matches_f64(monkeypatch, fenced, kind):
    """The XLA float-float defect that replaced the fused float-float kernel,
    with and without the ``FENCE_EFT`` barriers, against the true f64 defect
    (forced chunking on the stencil path, as at the north-star size)."""
    from agglomerationmultigrid1d.ops import df64

    monkeypatch.setattr(df64, "FENCE_EFT", fenced)
    monkeypatch.setattr(df64, "_FF_DEFECT_CHUNK", 256)
    rng = np.random.default_rng(5)
    bs, n = 2, 3 * 1024
    x64 = rng.standard_normal((bs, n))
    b64 = rng.standard_normal((bs, n))

    def blocks(w):
        d = rng.standard_normal((bs, bs, w)) + 8.0 * np.eye(bs)[:, :, None]
        return BlockTridiag(*(jnp.asarray(m) for m in (
            rng.standard_normal((bs, bs, w)), d, rng.standard_normal((bs, bs, w)))))

    if kind == "dense":
        a64 = blocks(n)
        a64 = a64._replace(lower=a64.lower.at[:, :, 0].set(0.0),
                           upper=a64.upper.at[:, :, -1].set(0.0))
        op = df64.bt_split(a64)
        fn = df64.ff_bt_defect
    else:
        bw = 4
        mid, left, right = blocks(1), blocks(bw), blocks(bw)
        sp = [df64.bt_split(t) for t in (left, mid, right)]
        op = df64.BTFFStencil(
            hi_left=sp[0].hi, hi_mid=sp[1].hi, hi_right=sp[2].hi,
            lo_left=sp[0].lo, lo_mid=sp[1].lo, lo_right=sp[2].lo, n=n,
        )
        full = lambda sel: jnp.concatenate([  # noqa: E731
            sel(left), jnp.broadcast_to(sel(mid), (bs, bs, n - 2 * bw)), sel(right)], axis=-1)
        a64 = BlockTridiag(lower=full(lambda t: t.lower).at[:, :, 0].set(0.0),
                           diag=full(lambda t: t.diag),
                           upper=full(lambda t: t.upper).at[:, :, -1].set(0.0))
        fn = df64.ff_bt_defect_stencil
    r64 = np.asarray(jnp.asarray(b64) - bt_matvec(a64, jnp.asarray(x64)))
    r_ff = jax.jit(lambda a, x, b: fn(a, x, b))(op, df64.ff_split(jnp.asarray(x64)),
                                                df64.ff_split(jnp.asarray(b64)))
    got = np.asarray(r_ff.hi, np.float64) + np.asarray(r_ff.lo, np.float64)
    np.testing.assert_allclose(got, r64, rtol=0, atol=1e-12 * np.abs(b64).max())
