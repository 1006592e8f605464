"""Multi-host local-shard construction (parallel/multihost.py).

The single-controller ``shard_hierarchy`` materializes globals on one host;
the multihost builder must produce the SAME hierarchy while no process (and no
host buffer) ever holds a global fine-level array.  Verified two ways: in-
process against the unsharded stencil build on the 8-virtual-device mesh, and
with a genuine 2-process ``jax.distributed`` CPU cluster (gloo collectives)
run in subprocesses.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agglomerationmultigrid1d.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d.models.stencil_setup import build_xl_problem
from agglomerationmultigrid1d.ops.df64 import FF
from agglomerationmultigrid1d.parallel.multihost import (
    build_sharded_xl_problem,
    multihost_mesh,
)
from agglomerationmultigrid1d.utils.config import HierarchySpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dg_spec(n):
    return HierarchySpec(
        cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1, c_dir=1000.0 * n
    )


def test_local_shard_build_matches_unsharded():
    """Shard-locally constructed hierarchy == the unsharded stencil build,
    and every fine-level shard holds exactly 1/n_devices of the data."""
    n = 4096
    spec = _dg_spec(n)
    mesh = multihost_mesh()
    h_sh, a_ff_sh, b_ff_sh, norm_sh = build_sharded_xl_problem(
        spec, n, mesh=mesh, z=8, chebyshev=False
    )
    h_ref, a_ff_ref, b_ff_ref, norm_ref = build_xl_problem(
        spec, n, z=8, chebyshev=False
    )

    # fine level is genuinely sharded: 8 shards of n/8 blocks each
    fine_diag = h_sh.levels[0].a.diag
    assert len(fine_diag.sharding.device_set) == 8
    for shard in fine_diag.addressable_shards:
        assert shard.data.shape[-1] == n // 8

    def close(tree_a, tree_b, rtol=0.0):
        la = jax.tree_util.tree_leaves(tree_a)
        lb = jax.tree_util.tree_leaves(tree_b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            x, y = np.asarray(x), np.asarray(y)
            if x.size == 0:
                continue
            scale = max(float(np.abs(y).max()), 1e-30)
            np.testing.assert_allclose(x, y, atol=rtol * scale, rtol=0)

    close(h_sh.levels, h_ref.levels)
    close(h_sh.transfers, h_ref.transfers)
    close(a_ff_sh.hi, a_ff_ref.hi)
    close(b_ff_sh.hi, b_ff_ref.hi)
    np.testing.assert_allclose(norm_sh, norm_ref, rtol=1e-10)

    # and it solves: guarded ff refinement over the sharded arrays (XLA SPMD)
    x_ff = FF(jnp.zeros_like(b_ff_sh.hi), jnp.zeros_like(b_ff_sh.hi))
    res = _mixed_loop_ff(
        h_sh, a_ff_sh, x_ff, b_ff_sh, jnp.asarray(1.0 / norm_sh, jnp.float32),
        maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20,
        n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
    )
    it = int(res[1])
    rel = float(np.asarray(res[3])[it - 1])
    assert rel < 1e-10


def _close_cropped(tree_a, tree_b):
    """Leafwise equality with node-axis ghost padding cropped (the sharded CG
    build pads bands/smoother vectors to a device multiple)."""
    la = jax.tree_util.tree_leaves(tree_a)
    lb = jax.tree_util.tree_leaves(tree_b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.size == 0 and y.size == 0:
            continue
        if x.ndim == 0:  # Chebyshev lam_lo/lam_hi scalars
            np.testing.assert_array_equal(x, y)
            continue
        m = min(x.shape[-1], y.shape[-1])
        np.testing.assert_array_equal(x[..., :m], y[..., :m])


def test_local_shard_build_flagship_cg():
    """The CG-topped flagship chain (4 CG levels p=8..1, seam, agg levels)
    builds shard-locally: identical values to the unsharded stencil build up
    to the inert identity ghost tail, genuinely sharded fine CG level, and
    the guarded ff solve converges on the sharded arrays."""
    n = 2048
    spec = HierarchySpec(
        cg_orders=(8, 4, 2, 1), n_agg_levels=3, p_agg=1, c_dir=1000.0 * n
    )
    mesh = multihost_mesh()
    h_sh, a_sh, b_sh, norm_sh = build_sharded_xl_problem(
        spec, n, mesh=mesh, chebyshev=False, min_blocks_per_device=8
    )
    h_ref, a_ref, b_ref, norm_ref = build_xl_problem(spec, n, chebyshev=False)

    # fine CG level is sharded, band ghost-padded to a device multiple with
    # an identity tail (cf. distributed._pad_cg_level)
    band = h_sh.levels[0].a.band
    assert len(band.sharding.device_set) == 8
    p = h_ref.levels[0].a.p
    n_nodes = h_ref.levels[0].a.n_nodes
    n_pad = band.shape[1]
    assert n_pad % 8 == 0 and n_pad >= n_nodes
    bandv = np.asarray(band)
    np.testing.assert_array_equal(bandv[:, :n_nodes], np.asarray(h_ref.levels[0].a.band))
    tail = bandv[:, n_nodes:]
    assert (tail[p] == 1.0).all()
    off = np.delete(tail, p, axis=0)
    assert (off == 0.0).all()

    _close_cropped(h_sh.levels, h_ref.levels)
    _close_cropped(h_sh.transfers, h_ref.transfers)
    _close_cropped(a_sh, a_ref)
    _close_cropped(b_sh.hi, b_ref.hi)
    np.testing.assert_allclose(norm_sh, norm_ref, rtol=1e-10)

    x_ff = FF(jnp.zeros_like(b_sh.hi), jnp.zeros_like(b_sh.hi))
    res = _mixed_loop_ff(
        h_sh, a_sh, x_ff, b_sh, jnp.asarray(1.0 / norm_sh, jnp.float32),
        maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20,
        n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
    )
    it = int(res[1])
    rel = float(np.asarray(res[3])[it - 1])
    assert rel < 1e-10, rel


def test_local_shard_build_slim_fine():
    """slim_fine (the exact mode bench.py runs at 10^8 DoF: diag-only fine
    level + broadcast-stencil ff defect) under the shard-local builder:
    identical arrays to the single-controller slim build and identical solve
    behavior on the 8-virtual-device mesh."""
    from agglomerationmultigrid1d.ops.df64 import BTFFStencil

    n = 4096
    spec = _dg_spec(n)
    mesh = multihost_mesh()
    h_sh, a_sh, b_sh, norm_sh = build_sharded_xl_problem(
        spec, n, mesh=mesh, z=8, chebyshev=True, slim_fine=True,
        min_blocks_per_device=8,
    )
    h_ref, a_ref, b_ref, norm_ref = build_xl_problem(
        spec, n, z=8, chebyshev=True, slim_fine=True
    )
    assert h_sh.levels[0].a.lower.size == 0  # slim: diag-only fine level
    assert isinstance(a_sh, BTFFStencil)
    assert len(h_sh.levels[0].a.diag.sharding.device_set) == 8

    _close_cropped(h_sh.levels, h_ref.levels)
    _close_cropped(h_sh.transfers, h_ref.transfers)
    _close_cropped(a_sh, a_ref)
    _close_cropped(b_sh.hi, b_ref.hi)
    np.testing.assert_allclose(norm_sh, norm_ref, rtol=1e-10)

    def run(h, a_ff, b_ff, norm_b):
        x_ff = FF(jnp.zeros_like(b_ff.hi), jnp.zeros_like(b_ff.hi))
        res = _mixed_loop_ff(
            h, a_ff, x_ff, b_ff, jnp.asarray(1.0 / norm_b, jnp.float32),
            maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20,
            n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
        )
        it = int(res[1])
        return int(res[2]), float(np.asarray(res[3])[it - 1])

    cyc_sh, rel_sh = run(h_sh, a_sh, b_sh, norm_sh)
    cyc_ref, rel_ref = run(h_ref, a_ref, b_ref, norm_ref)
    assert rel_sh < 1e-10 and rel_ref < 1e-10
    assert cyc_sh == cyc_ref, (cyc_sh, cyc_ref)


_WORKER = r"""
import sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from agglomerationmultigrid1d.parallel.multihost import (
    build_sharded_xl_problem, initialize, multihost_mesh)
initialize(f"localhost:{port}", nproc, pid, cpu_collectives="gloo")
assert jax.process_count() == nproc, jax.process_count()

import jax.numpy as jnp, numpy as np
from agglomerationmultigrid1d.models.solvers import _mixed_loop_ff
from agglomerationmultigrid1d.ops.df64 import FF
from agglomerationmultigrid1d.utils.config import HierarchySpec

n = 4096
spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=4, p_agg=1,
                     c_dir=1000.0 * n)
mesh = multihost_mesh()
assert mesh.devices.size == 4  # 2 processes x 2 virtual devices
h, a_ff, b_ff, norm_b = build_sharded_xl_problem(spec, n, mesh=mesh, z=8,
                                                 chebyshev=False)
# no global fine array on this process: only local shards are addressable
fine = h.levels[0].a.diag
local = sum(s.data.shape[-1] for s in fine.addressable_shards)
assert local == n // nproc, (local, n)

x_ff = FF(jnp.zeros_like(b_ff.hi), jnp.zeros_like(b_ff.hi))
res = _mixed_loop_ff(
    h, a_ff, x_ff, b_ff, jnp.asarray(1.0 / norm_b, jnp.float32),
    maxiter=100, tol=1e-10, inner_tol=3.0e-5, max_inner=20,
    n_pre=3, n_post=3, alpha=2.0 / 3.0, use_pallas=False,
)
it = int(res[1])
rel = float(np.asarray(res[3])[it - 1])
assert rel < 1e-10, rel
print(f"MULTIHOST_OK pid={pid} rel={rel:.2e}", flush=True)
"""


def test_two_process_cpu_cluster(tmp_path):
    """A real 2-process jax.distributed CPU cluster (gloo): each process
    builds only its local shards and the cross-process SPMD solve converges."""
    script = tmp_path / "mh_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    port = "12973"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", port],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
        assert "MULTIHOST_OK" in out, out
