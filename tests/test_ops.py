"""Operator-format tests: every structured op must match its dense materialization."""

import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.ops import (
    BlockDiag,
    BlockProlong,
    BlockTridiag,
    CgProlong,
    SeamProlong,
    bd_inverse,
    bd_matvec,
    bd_mul_bt,
    bd_to_dense,
    bp_galerkin,
    bp_prolong,
    bp_restrict,
    bt_distance2_residual,
    bt_from_dense,
    bt_matvec,
    bt_mul_bt,
    bt_sub,
    bt_to_dense,
    cg_assembled_windows,
    cg_from_windows,
    cg_matvec,
    cg_node_multiplicity,
    cg_to_dense,
    cgp_galerkin,
    cgp_prolong,
    cgp_restrict,
    shift,
)


def rand_bt(rng, bs, n):
    lower = rng.standard_normal((bs, bs, n))
    diag = rng.standard_normal((bs, bs, n)) + 3 * np.eye(bs)[:, :, None]
    upper = rng.standard_normal((bs, bs, n))
    lower[:, :, 0] = 0
    upper[:, :, -1] = 0
    return BlockTridiag(jnp.asarray(lower), jnp.asarray(diag), jnp.asarray(upper))


def test_shift(rng):
    x = jnp.asarray(rng.standard_normal((3, 5)))
    np.testing.assert_allclose(shift(x, 1)[:, :-1], x[:, 1:])
    np.testing.assert_allclose(shift(x, 1)[:, -1], 0)
    np.testing.assert_allclose(shift(x, -2)[:, 2:], x[:, :-2])
    np.testing.assert_allclose(shift(x, -2)[:, :2], 0)


def test_block_diag_roundtrip(rng):
    bs, n = 3, 7
    blocks = rng.standard_normal((bs, bs, n)) + 4 * np.eye(bs)[:, :, None]
    bd = BlockDiag(jnp.asarray(blocks))
    x = jnp.asarray(rng.standard_normal((bs, n)))
    dense = np.asarray(bd_to_dense(bd))
    flat = np.asarray(x).T.reshape(-1)
    np.testing.assert_allclose(
        np.asarray(bd_matvec(bd, x)).T.reshape(-1), dense @ flat, atol=1e-12
    )
    inv = bd_inverse(bd)
    np.testing.assert_allclose(
        np.asarray(bd_matvec(inv, bd_matvec(bd, x))), np.asarray(x), atol=1e-10
    )


def test_bt_matvec_vs_dense(rng):
    bs, n = 4, 9
    a = rand_bt(rng, bs, n)
    x = jnp.asarray(rng.standard_normal((bs, n)))
    dense = np.asarray(bt_to_dense(a))
    flat = np.asarray(x).T.reshape(-1)
    np.testing.assert_allclose(
        np.asarray(bt_matvec(a, x)).T.reshape(-1), dense @ flat, atol=1e-12
    )
    # round trip
    rt = bt_from_dense(bt_to_dense(a), bs)
    for f1, f2 in zip(a, rt):
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=0)


def test_bt_mul_bt_structured(rng):
    """D (diag+upper) times M^-1 G (diag+lower) stays tridiagonal and matches dense."""
    bs, n = 3, 8
    zero = jnp.zeros((bs, bs, n))
    d_op = BlockTridiag(zero, *(rand_bt(rng, bs, n)[1:]))  # diag + upper only
    g_op = BlockTridiag(*(rand_bt(rng, bs, n)[:2]), zero)  # lower + diag only
    assert float(bt_distance2_residual(d_op, g_op)) == 0.0
    prod = bt_mul_bt(d_op, g_op)
    dense = np.asarray(bt_to_dense(d_op)) @ np.asarray(bt_to_dense(g_op))
    np.testing.assert_allclose(np.asarray(bt_to_dense(prod)), dense, atol=1e-12)


def test_bd_mul_bt_vs_dense(rng):
    bs, n = 3, 6
    blocks = rng.standard_normal((bs, bs, n)) + 4 * np.eye(bs)[:, :, None]
    m = BlockDiag(jnp.asarray(blocks))
    a = rand_bt(rng, bs, n)
    prod = bd_mul_bt(m, a)
    dense = np.asarray(bd_to_dense(m)) @ np.asarray(bt_to_dense(a))
    np.testing.assert_allclose(np.asarray(bt_to_dense(prod)), dense, atol=1e-12)


def test_cg_operator_assembly_and_matvec(rng):
    p, n_el = 3, 5
    w = p + 1
    windows = jnp.asarray(rng.standard_normal((w, w, n_el)))
    a = cg_from_windows(windows)
    n_nodes = n_el * p + 1
    # dense reference assembly
    dense = np.zeros((n_nodes, n_nodes))
    for k in range(n_el):
        sl = slice(k * p, k * p + w)
        dense[sl, sl] += np.asarray(windows[:, :, k])
    np.testing.assert_allclose(np.asarray(cg_to_dense(a)), dense, atol=1e-12)
    x = jnp.asarray(rng.standard_normal((n_nodes,)))
    np.testing.assert_allclose(np.asarray(cg_matvec(a, x)), dense @ np.asarray(x), atol=1e-12)
    # assembled windows == dense element sub-blocks
    aw = np.asarray(cg_assembled_windows(a))
    for k in range(n_el):
        sl = slice(k * p, k * p + w)
        np.testing.assert_allclose(aw[:, :, k], dense[sl, sl], atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(cg_node_multiplicity(p, n_el)),
        [1] * p + ([2] + [1] * (p - 1)) * (n_el - 1) + [1],
    )


def _bp_dense(l: BlockProlong) -> np.ndarray:
    r, bs_f, bs_c, nc = l.blocks.shape
    out = np.zeros((r * nc * bs_f, nc * bs_c))
    for c in range(nc):
        for j in range(r):
            f = c * r + j
            out[f * bs_f : (f + 1) * bs_f, c * bs_c : (c + 1) * bs_c] = np.asarray(
                l.blocks[j, :, :, c]
            )
    return out


@pytest.mark.parametrize("r", [1, 2, 4])
def test_block_prolong_vs_dense(rng, r):
    bs_f, bs_c, nc = 3, 2, 4
    l = BlockProlong(jnp.asarray(rng.standard_normal((r, bs_f, bs_c, nc))))
    ld = _bp_dense(l)
    xc = jnp.asarray(rng.standard_normal((bs_c, nc)))
    np.testing.assert_allclose(
        np.asarray(bp_prolong(l, xc)).T.reshape(-1), ld @ np.asarray(xc).T.reshape(-1), atol=1e-12
    )
    rf = jnp.asarray(rng.standard_normal((bs_f, r * nc)))
    np.testing.assert_allclose(
        np.asarray(bp_restrict(l, rf)).T.reshape(-1),
        ld.T @ np.asarray(rf).T.reshape(-1),
        atol=1e-12,
    )
    x = rand_bt(rng, bs_f, r * nc)
    coarse = bp_galerkin(l, x)
    dense = ld.T @ np.asarray(bt_to_dense(x)) @ ld
    np.testing.assert_allclose(np.asarray(bt_to_dense(coarse)), dense, atol=1e-12)


def _cgp_dense(l: CgProlong, n_el: int) -> np.ndarray:
    p_f, p_c = l.p_fine, l.p_coarse
    nf, nc = n_el * p_f + 1, n_el * p_c + 1
    out = np.zeros((nf, nc))
    e = np.asarray(l.e)
    for k in range(n_el):
        out[k * p_f : k * p_f + p_f + 1, k * p_c : k * p_c + p_c + 1] = e  # assignment
    return out


def test_cg_prolong_vs_dense(rng):
    # a nodal-interpolation-like E: endpoint rows are unit vectors
    p_f, p_c, n_el = 4, 2, 5
    e = rng.standard_normal((p_f + 1, p_c + 1))
    e[0] = 0.0
    e[0, 0] = 1.0
    e[-1] = 0.0
    e[-1, -1] = 1.0
    l = CgProlong(jnp.asarray(e))
    ld = _cgp_dense(l, n_el)
    xc = jnp.asarray(rng.standard_normal((n_el * p_c + 1,)))
    np.testing.assert_allclose(np.asarray(cgp_prolong(l, xc)), ld @ np.asarray(xc), atol=1e-12)
    rf = jnp.asarray(rng.standard_normal((n_el * p_f + 1,)))
    np.testing.assert_allclose(np.asarray(cgp_restrict(l, rf)), ld.T @ np.asarray(rf), atol=1e-12)
    # Galerkin on a random window operator
    w = p_f + 1
    a = cg_from_windows(jnp.asarray(rng.standard_normal((w, w, n_el))))
    coarse = cgp_galerkin(l, a)
    dense = ld.T @ np.asarray(cg_to_dense(a)) @ ld
    np.testing.assert_allclose(np.asarray(cg_to_dense(coarse)), dense, atol=1e-12)
