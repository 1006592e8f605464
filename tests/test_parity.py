"""Pinned numerical parity with the reference solver via the dense NumPy
oracle (tests/oracle.py — the executable stand-in for the Julia reference,
which is not installable in this image).

For each of the reference's four hierarchy configurations
(``cg_heirarchy_test.jl``, ``dg_heirarchy_test.jl``, ``dg_cg_heirarchy_test.jl``,
``full_heirarchy_test.jl``) the framework's f64 multigrid must reproduce the
oracle's iteration count EXACTLY and its residual/error histories to f64
reduction-order noise.  The oracle receives only discretization data (fine
operator + rhs, dense transfers, directly-assembled seam G/D/C, level masses)
and independently redoes every solver-side computation: Galerkin coarsening,
the separate-G/D/C projection + ``A = C - D M^-1 G`` recombination, smoother
construction, the V-cycle, and the convergence loop."""

import jax.numpy as jnp
import numpy as np
import pytest

from helpers import bp_dense, cgp_dense, rbp_dense, seam_dense
from oracle import build_oracle_hierarchy, oracle_multigrid

from agglomerationmultigrid1d.models.hierarchy import BlockLevel, CgLevel
from agglomerationmultigrid1d.models.problems import (
    poisson_cg_hierarchy,
    poisson_dg_cg_hierarchy,
    poisson_dg_hierarchy,
    poisson_full_hierarchy,
)
from agglomerationmultigrid1d.models.solvers import multigrid
from agglomerationmultigrid1d.ops import bt_to_dense, cg_to_dense
from agglomerationmultigrid1d.ops.transfer_ops import (
    BlockProlong,
    CgProlong,
    RaggedBlockProlong,
    SeamProlong,
)


def _mass_dense(mass_inv) -> np.ndarray:
    """Dense level mass from the stored (bs, bs, n) inverse blocks."""
    inv = np.moveaxis(np.asarray(mass_inv), -1, 0)  # (n, bs, bs)
    blocks = np.linalg.inv(inv)
    bs, n = inv.shape[1], inv.shape[0]
    m = np.zeros((n * bs, n * bs))
    for k in range(n):
        m[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = blocks[k]
    return m


def _transfer_dense(tr, fine_level) -> np.ndarray:
    from agglomerationmultigrid1d.transfer.scattered_transfer import (
        ScatteredProlong,
    )

    from helpers import sp_dense

    if isinstance(tr, CgProlong):
        n_el = (fine_level.a.n_nodes - 1) // tr.p_fine
        return cgp_dense(tr, n_el)
    if isinstance(tr, BlockProlong):
        return bp_dense(tr)
    if isinstance(tr, RaggedBlockProlong):
        return rbp_dense(tr)
    if isinstance(tr, SeamProlong):
        return seam_dense(tr)
    if isinstance(tr, ScatteredProlong):
        return sp_dense(tr)
    raise TypeError(type(tr))


def _oracle_spec(h) -> tuple[list, list]:
    """Walk a framework hierarchy, emitting the oracle's level spec with only
    discretization inputs (assembled seam G/D/C; deeper block levels get no
    operators — the oracle Galerkin-projects them itself)."""
    from agglomerationmultigrid1d.smoothers.smoother import SchwarzSmoother

    def _cg_kind(lv):
        if isinstance(lv.smoother, SchwarzSmoother):
            return "hybridSchwarz" if lv.smoother.mult_inv is not None else "addSchwarz"
        return "jac"

    spec = []
    for k, lv in enumerate(h.levels):
        if isinstance(lv, CgLevel):
            entry = {"type": "cg", "smoother": _cg_kind(lv), "p": lv.a.p}
            if k == 0:
                entry["a"] = np.asarray(cg_to_dense(lv.a))
            else:
                entry["l"] = _transfer_dense(h.transfers[k - 1], h.levels[k - 1])
            spec.append(entry)
        else:
            assert isinstance(lv, BlockLevel)
            first_block = k == 0 or isinstance(h.levels[k - 1], CgLevel)
            entry = {
                "type": "block",
                "bs": lv.a.block_size,
                "mass": _mass_dense(lv.mass_inv),
                "gdc": (
                    tuple(np.asarray(bt_to_dense(x)) for x in (lv.g, lv.d, lv.c))
                    if first_block
                    else None
                ),
            }
            if k > 0:
                entry["l"] = _transfer_dense(h.transfers[k - 1], h.levels[k - 1])
            spec.append(entry)
    return spec


def _run_parity(prob, maxiter=200, tol=1e-10):
    b = np.asarray(prob.b, dtype=np.float64)
    b_flat = b if b.ndim == 1 else b.T.reshape(-1)

    levels, transfers = build_oracle_hierarchy(_oracle_spec(prob.hierarchy))
    x_o, it_o, res_o, err_o = oracle_multigrid(
        levels, transfers, np.zeros_like(b_flat), b_flat, maxiter=maxiter, tol=tol
    )

    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, maxiter, tol)
    it_f = int(res.iterations)

    assert it_f == it_o, (it_f, it_o)
    # histories match to f64 reduction-order noise: once the residual is near
    # eps * ||b||-level cancellation in b - A x, different summation orders
    # differ by ~1e-13 absolute — tie atol to ||b||, keep rtol tight above it
    noise = 1e-11 * np.linalg.norm(b_flat)
    np.testing.assert_allclose(
        np.asarray(res.res_history)[:it_f], res_o, rtol=1e-5, atol=noise,
        err_msg="residual history diverged from the reference oracle",
    )
    np.testing.assert_allclose(
        np.asarray(res.err_history)[:it_f], err_o, rtol=1e-5, atol=noise,
        err_msg="error history diverged from the reference oracle",
    )
    x_f = np.asarray(res.x, dtype=np.float64)
    x_f = x_f if x_f.ndim == 1 else x_f.T.reshape(-1)
    np.testing.assert_allclose(x_f, x_o, rtol=1e-6, atol=noise)
    return it_f


def test_parity_cg_hierarchy():
    """cf. cg_heirarchy_test.jl (4 CG levels p = 8, 4, 2, 1)."""
    # golden count pinned EXACTLY: any drift in framework or oracle (even a
    # shared one that still agrees between them) fails loudly
    assert _run_parity(poisson_cg_hierarchy(n=32)) == 6


@pytest.mark.parametrize("kind,golden", [("addSchwarz", 7), ("hybridSchwarz", 4)])
def test_parity_cg_schwarz_hierarchy(kind, golden):
    """Schwarz-smoothed CG hierarchy (BASELINE parity config 2: the reference's
    ``cg_smoother(..., :addSchwarz/:hybridSchwarz)``, ``smoother.jl:1-46,
    :88-139``) — exact iteration-count parity against the dense oracle."""
    assert _run_parity(poisson_cg_hierarchy(n=32, cg_smoother=kind)) == golden


def test_parity_dg_hierarchy():
    """cf. dg_heirarchy_test.jl (4 DG levels, CDir = 1000 n)."""
    assert _run_parity(poisson_dg_hierarchy(n=32, max_p=8, n_dg=4)) == 9


def test_parity_dg_cg_hierarchy():
    """cf. dg_cg_heirarchy_test.jl (4 CG levels + 1 DG p=0 seam)."""
    assert _run_parity(poisson_dg_cg_hierarchy(n=32)) == 11


def test_parity_scattered_hierarchy():
    """Genuinely NON-CONTIGUOUS partitions (interleaved 4-element runs, then an
    interleaved partition of the agglomerates themselves) — exact-count parity
    against the dense oracle, which receives only the dense scattered transfer
    and redoes the Galerkin chain itself (cf. the reference's explicit
    element-list constructor, ``agglomerated_dg_mesh.jl:400-495``)."""
    from agglomerationmultigrid1d.models.problems import (
        poisson_scattered_hierarchy,
    )

    prob = poisson_scattered_hierarchy(
        n=32,
        groups_per_level=[
            # base: two interleaved 8-element agglomerates per 16-element block
            [[o + i for i in (0, 1, 2, 3, 8, 9, 10, 11)] for o in (0, 16)]
            + [[o + i for i in (4, 5, 6, 7, 12, 13, 14, 15)] for o in (0, 16)],
            # recursive: interleave the four level-1 agglomerates
            [[0, 2], [1, 3]],
        ],
    )
    # 116 cycles is the real (oracle-confirmed) cost of an interleaved
    # partition: scattering an agglomerate across the domain breaks the
    # smoother/coarse-correction locality that gives contiguous partitions
    # their ~10-cycle counts (same physics in the reference; see PARITY.md)
    assert _run_parity(prob) == 116


# stored golden residual history of the flagship n=32 full-hierarchy run
# (the reference's printed `resVec` semantics, full_heirarchy_test.jl:96-102):
# ||b - A x_k||_2 after V-cycle k, f64, nPre=nPost=3, alpha=2/3, CDir=1000n.
FULL_N32_RES_HISTORY = np.array([
    9.1257776062898299e-01, 7.8437318174045700e-02, 1.4892271154039027e-02,
    3.1954752448787580e-03, 7.2896991082313262e-04, 1.7241273153882682e-04,
    4.2096918779178286e-05, 1.0608170251476927e-05, 2.7535621457507922e-06,
    7.3305446084402545e-07, 1.9905801461158008e-07, 5.4843103474666954e-08,
])


def test_parity_full_hierarchy():
    """cf. full_heirarchy_test.jl (4 CG + agglomerated levels, CDir = 1000 n)."""
    prob = poisson_full_hierarchy(n=32)
    assert _run_parity(prob) == len(FULL_N32_RES_HISTORY) == 12
    # pin the flagship residual history against the stored fixture (loose
    # enough for cross-XLA-version reduction-order noise, tight enough that
    # any algorithmic change — smoother, transfer, coarse solve — trips it)
    from agglomerationmultigrid1d.models.solvers import multigrid

    res = multigrid(prob.hierarchy, jnp.zeros_like(prob.b), prob.b, 200, 1e-10)
    it = int(res.iterations)
    # rtol catches algorithmic drift; the atol floor absorbs f64 reduction-
    # order noise (different-but-equivalent transfer formulations perturb the
    # late history by ~1e-13 * ||b||)
    np.testing.assert_allclose(
        np.asarray(res.res_history)[:it], FULL_N32_RES_HISTORY, rtol=1e-6,
        atol=1e-13 * np.linalg.norm(np.asarray(prob.b)),
        err_msg="flagship residual history drifted from the stored golden fixture",
    )


def test_parity_full_hierarchy_ragged():
    """The ragged-partition path must satisfy the same solver parity (the
    oracle Galerkin-projects through the dense ragged transfer matrices)."""
    assert _run_parity(poisson_full_hierarchy(n=24, n_agg=3)) == 14
