"""Float-float (double-f32) arithmetic: accuracy invariants for the f64-speed
defect path (ops/df64.py).  The reference runs all-native-f64 on CPU
(src/solvers.jl:33); the mixed solver's defect must reach f64-class
accuracy from f32 operations — these tests pin the ~2^-48 error bound."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from agglomerationmultigrid1d.ops import df64 as ff
from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag, bt_matvec


def _rand_bt(rng, bs, n, spread=8.0):
    mk = lambda: jnp.asarray(  # noqa: E731
        rng.standard_normal((bs, bs, n)) * np.exp(rng.uniform(-3.0, spread, (bs, bs, n)))
    )
    return BlockTridiag(mk(), mk(), mk())


def test_ff_split_join_roundtrip(rng):
    x = jnp.asarray(rng.standard_normal(1000) * 10.0 ** rng.uniform(-20, 20, 1000))
    p = ff.ff_split(x)
    # hi is exact f32 rounding; lo carries the remainder rounded once more, so
    # the pair reproduces x to ~2^-49 relative
    np.testing.assert_allclose(np.asarray(ff.ff_join(p)), np.asarray(x), rtol=2e-14)
    # |lo| <= ulp(hi)/2
    assert np.all(np.abs(np.asarray(p.lo)) <= np.spacing(np.abs(np.asarray(p.hi))) / 2 + 1e-300)


def test_ff_add_mul_accuracy(rng):
    a64 = jnp.asarray(rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096))
    b64 = jnp.asarray(rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096))
    a, b = ff.ff_split(a64), ff.ff_split(b64)
    s = np.asarray(ff.ff_join(ff.ff_add(a, b)))
    p = np.asarray(ff.ff_join(ff.ff_mul(a, b)))
    np.testing.assert_allclose(s, np.asarray(a64 + b64), rtol=1e-13)
    np.testing.assert_allclose(p, np.asarray(a64 * b64), rtol=1e-13)


@pytest.mark.parametrize("bs", [2, 4, 5])
def test_ff_bt_matvec_matches_f64(rng, bs):
    n = 257
    a = _rand_bt(rng, bs, n)
    x = jnp.asarray(rng.standard_normal((bs, n)))
    y64 = np.asarray(bt_matvec(a, x))
    y_ff = np.asarray(ff.ff_join(ff.ff_bt_matvec(ff.bt_split(a), ff.ff_split(x))))
    scale = np.abs(y64).max()
    np.testing.assert_allclose(y_ff, y64, atol=2e-14 * scale)


def test_ff_defect_survives_catastrophic_cancellation(rng):
    """The real workload: r = b - A x with ||r|| ~ 1e-9 ||b|| — a plain f32
    evaluation would be 100% noise; ff must keep ~5 significant digits."""
    bs, n = 4, 1024
    a = _rand_bt(rng, bs, n)
    x = jnp.asarray(rng.standard_normal((bs, n)))
    b = jnp.asarray(bt_matvec(a, x) * (1.0 + 1e-9))
    r64 = np.asarray(b - bt_matvec(a, x))

    d = jax.jit(lambda aff, xff, bff: ff.ff_bt_defect(aff, xff, bff))
    r_ff = np.asarray(ff.ff_join(d(ff.bt_split(a), ff.ff_split(x), ff.ff_split(b))))
    scale = float(np.abs(np.asarray(b)).max())
    assert np.abs(r_ff - r64).max() < 3e-14 * scale
    # and the norm (the convergence quantity) is accurate
    assert abs(np.linalg.norm(r_ff.T.ravel()) - np.linalg.norm(r64.T.ravel())) < 1e-5 * np.linalg.norm(r64)


def test_ff_norm_matches_f64(rng):
    x = jnp.asarray(rng.standard_normal((4, 512)))
    p = ff.ff_split(x)
    np.testing.assert_allclose(
        float(ff.ff_norm(p)), float(jnp.linalg.norm(x.reshape(-1))), rtol=1e-12
    )


def test_ff_cg_defect_matches_f64(rng):
    """Scalar-banded (CG) float-float defect against the f64 reference."""
    from agglomerationmultigrid1d.assembly import cg_stiffness
    from agglomerationmultigrid1d.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
    from agglomerationmultigrid1d.ops.cg_operator import cg_matvec

    mesh = create_uniform_mesh(64, 0.0, 1.0)
    cg = make_cg_mesh(mesh, 4)
    a = cg_stiffness(cg, BoundaryCondition(("neu", 0.0), ("dir", 1.0)))
    x = jnp.asarray(rng.standard_normal(a.n_nodes))
    b = jnp.asarray(cg_matvec(a, x) * (1.0 + 1e-9))
    r64 = np.asarray(b - cg_matvec(a, x))

    a_ff = ff.cg_band_split(a.band)
    d = jax.jit(lambda A, X, B: ff.ff_cg_defect(A, X, B))
    r_ff = np.asarray(ff.ff_join(d(a_ff, ff.ff_split(x), ff.ff_split(b))))
    scale = float(np.abs(np.asarray(b)).max())
    assert np.abs(r_ff - r64).max() < 1e-13 * scale


def test_mixed_solver_cg_topped_uses_ff_path():
    """The flagship CG-topped hierarchy converges through the fused ff loop."""
    from agglomerationmultigrid1d.models.problems import poisson_full_hierarchy
    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid_mixed,
    )

    prob = poisson_full_hierarchy(n=64)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    b = prob.b
    res = multigrid_mixed(prob.hierarchy, h32, jnp.zeros_like(b), b, 60, 1e-10, use_pallas=False)
    it = int(res.iterations)
    nb = float(jnp.linalg.norm(b))
    assert np.asarray(res.res_history)[it - 1] < 1e-10 * nb
    assert int(res.inner_cycles) >= it


def test_progressive_precision_matches_f64_iterations():
    """Progressive-precision V-cycles (f32 smoothers, float-float residuals/
    transfers) must converge with the same cycle count as all-f64 multigrid,
    including on the ill-conditioned CG-topped flagship configuration."""
    from agglomerationmultigrid1d.models.problems import (
        poisson_dg_hierarchy,
        poisson_full_hierarchy,
    )
    from agglomerationmultigrid1d.models.solvers import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_progressive,
    )

    for prob in (
        poisson_full_hierarchy(n=256),
        poisson_dg_hierarchy(n=256, max_p=4, n_dg=3),
    ):
        h32 = make_low_precision_hierarchy(prob.hierarchy)
        b = prob.b
        res = multigrid_progressive(
            prob.hierarchy, h32, jnp.zeros_like(b), b, 60, 1e-10, use_pallas=False
        )
        r64 = multigrid(prob.hierarchy, jnp.zeros_like(b), b, 60, 1e-10, compute_error=False)
        it = int(res.iterations)
        nb = float(jnp.linalg.norm(b.T.reshape(-1) if b.ndim > 1 else b))
        assert np.asarray(res.res_history)[it - 1] < 1e-10 * nb
        assert it <= int(r64.iterations) + 2, (it, int(r64.iterations))


def test_ff_stencil_defect_chunked_matches_oneshot(rng):
    """The chunked interior EFT pass (used above _FF_DEFECT_CHUNK columns to
    bound fused-temporary memory) is bit-identical to the one-shot pass."""
    from agglomerationmultigrid1d.ops import df64
    from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag
    from agglomerationmultigrid1d.ops.df64 import FF, BTFFStencil

    bs, bw, n = 2, 4, 1024

    def bt(m):
        return BlockTridiag(
            lower=jnp.asarray(rng.standard_normal((bs, bs, m)), jnp.float32),
            diag=jnp.asarray(rng.standard_normal((bs, bs, m)), jnp.float32),
            upper=jnp.asarray(rng.standard_normal((bs, bs, m)), jnp.float32),
        )

    st = BTFFStencil(
        hi_left=bt(bw), hi_mid=bt(1), hi_right=bt(bw),
        lo_left=jax.tree_util.tree_map(lambda x: 1e-7 * x, bt(bw)),
        lo_mid=jax.tree_util.tree_map(lambda x: 1e-7 * x, bt(1)),
        lo_right=jax.tree_util.tree_map(lambda x: 1e-7 * x, bt(bw)),
        n=n,
    )
    x = FF(
        jnp.asarray(rng.standard_normal((bs, n)), jnp.float32),
        jnp.asarray(1e-7 * rng.standard_normal((bs, n)), jnp.float32),
    )
    b = FF(
        jnp.asarray(rng.standard_normal((bs, n)), jnp.float32),
        jnp.asarray(1e-7 * rng.standard_normal((bs, n)), jnp.float32),
    )
    r_one = df64.ff_bt_defect_stencil(st, x, b)
    old = df64._FF_DEFECT_CHUNK
    try:
        df64._FF_DEFECT_CHUNK = 64  # force 8 chunks at n = 1024
        r_chunk = df64.ff_bt_defect_stencil(st, x, b)
    finally:
        df64._FF_DEFECT_CHUNK = old
    # hi is bit-identical; lo may differ by XLA:CPU reassociation inside the
    # EFT tail (~1e-13 abs) — the meaningful invariant is the hi+lo value
    np.testing.assert_array_equal(np.asarray(r_chunk.hi), np.asarray(r_one.hi))
    v_chunk = np.asarray(r_chunk.hi, np.float64) + np.asarray(r_chunk.lo, np.float64)
    v_one = np.asarray(r_one.hi, np.float64) + np.asarray(r_one.lo, np.float64)
    np.testing.assert_allclose(
        v_chunk, v_one, rtol=0, atol=1e-11 * float(np.abs(v_one).max())
    )


def test_f64_stencil_defect_matches_numpy(rng):
    """The true-f64 stencil defect (progressive outer loop above the ff
    accuracy floor) equals a dense NumPy f64 defect to f64 roundoff."""
    from agglomerationmultigrid1d.ops import df64
    from agglomerationmultigrid1d.ops.block_tridiag import BlockTridiag
    from agglomerationmultigrid1d.ops.df64 import BTFFStencil, f64_bt_defect_stencil

    bs, bw, n = 2, 4, 512

    def bt(m):
        return BlockTridiag(
            lower=jnp.asarray(rng.standard_normal((bs, bs, m)), jnp.float32),
            diag=jnp.asarray(rng.standard_normal((bs, bs, m)), jnp.float32),
            upper=jnp.asarray(rng.standard_normal((bs, bs, m)), jnp.float32),
        )

    st = BTFFStencil(
        hi_left=bt(bw), hi_mid=bt(1), hi_right=bt(bw),
        lo_left=jax.tree_util.tree_map(lambda x: 1e-7 * x, bt(bw)),
        lo_mid=jax.tree_util.tree_map(lambda x: 1e-7 * x, bt(1)),
        lo_right=jax.tree_util.tree_map(lambda x: 1e-7 * x, bt(bw)),
        n=n,
    )
    x64 = jnp.asarray(rng.standard_normal((bs, n)))
    b64 = jnp.asarray(rng.standard_normal((bs, n)))
    from agglomerationmultigrid1d.ops.df64 import ff_join, ff_split

    r_pair = f64_bt_defect_stencil(st, ff_split(x64), ff_split(b64))
    r = np.asarray(ff_join(r_pair))

    # dense NumPy reference: materialize the f64 diagonals from the stencils
    def full(sel):
        parts = []
        for name, reps in (("left", None), ("mid", n - 2 * bw), ("right", None)):
            h = np.asarray(getattr(getattr(st, f"hi_{name}"), sel), np.float64)
            l = np.asarray(getattr(getattr(st, f"lo_{name}"), sel), np.float64)
            v = h + l
            if reps is not None:
                v = np.broadcast_to(v, v.shape[:-1] + (reps,))
            parts.append(v)
        return np.concatenate(parts, axis=-1)

    lo_, di_, up_ = full("lower"), full("diag"), full("upper")
    xn = np.asarray(x64)
    xm = np.concatenate([np.zeros((bs, 1)), xn[:, :-1]], axis=1)
    xp = np.concatenate([xn[:, 1:], np.zeros((bs, 1))], axis=1)
    ref = (
        np.asarray(b64)
        - np.einsum("ijn,jn->in", di_, xn)
        - np.einsum("ijn,jn->in", lo_, xm)
        - np.einsum("ijn,jn->in", up_, xp)
    )
    np.testing.assert_allclose(r, ref, rtol=0, atol=1e-13 * float(np.abs(ref).max()))
