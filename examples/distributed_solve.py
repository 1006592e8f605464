"""Element-axis-sharded multigrid over all local devices.

Run with XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU to see the
multi-device path without accelerator hardware.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root


import jax
import jax.numpy as jnp

from agglomerationmultigrid1d.models import multigrid, poisson_dg_hierarchy
from agglomerationmultigrid1d.parallel import make_solver_mesh, shard_hierarchy
from agglomerationmultigrid1d.parallel.distributed import shard_vector


def main():
    prob = poisson_dg_hierarchy(n=512, max_p=4, n_dg=3)
    mesh = make_solver_mesh()
    print(f"devices: {mesh.devices.ravel().tolist()}")
    h = shard_hierarchy(prob.hierarchy, mesh)
    b = shard_vector(prob.b, mesh)
    res = multigrid(h, jnp.zeros_like(b), b, 50, 1e-10, compute_error=False)
    print(f"iterations: {int(res.iterations)}; x sharding: {res.x.sharding}")


if __name__ == "__main__":
    main()
