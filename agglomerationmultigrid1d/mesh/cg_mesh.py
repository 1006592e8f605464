"""Continuous-Galerkin discretization mesh (order-p nodal Lagrange).

Counterpart of ``src/cg_mesh.jl:12-80``.  Differences by design:

* **Node numbering is spatial ("grid order")**: element k owns global nodes
  ``k*p .. k*p + p`` left to right, sharing endpoints with neighbors.  The
  reference instead numbers all mesh vertices first and appends interior nodes
  per element (``cg_mesh.jl:35-45``); the two differ by a permutation only, and
  every residual norm / iteration count / L2 error is permutation-invariant.
* The global sparse mass matrix + UMFPACK LU (``cg_mesh.jl:75-77``) are replaced
  by the banded :class:`~..ops.cg_operator.CgOperator` plus the *lumped* mass
  vector (the hierarchy's seam transfers only ever need row sums and the full
  mass action; a full mass solve, needed only by the unused ``interpFlag = 0``
  projection variant, is done densely on demand).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..numerics import make_reference_element
from ..ops.cg_operator import CgOperator, cg_from_windows
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class CgMesh:
    p: int
    mesh: Mesh1D
    ref: "object"  # ReferenceElement
    mass: CgOperator  # assembled mass, grid order
    lumped_mass: jnp.ndarray  # (n_nodes,) row sums of the assembled mass
    mass_pos: np.ndarray  # (w, w) reference mass in position order (host)

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements

    @property
    def n_nodes(self) -> int:
        return self.n_elements * self.p + 1

    def node_x(self) -> np.ndarray:
        """Grid-order coordinates of all global nodes."""
        p = self.p
        ref_pos = self.ref.nodes_x[self.ref.pos_to_slot]  # ascending in [-1, 1]
        xs = self.mesh.ref_map(np.arange(self.n_elements)[:, None], ref_pos[None, :])
        return np.concatenate([xs[:, :p].reshape(-1), xs[-1:, p]])


def make_cg_mesh(mesh: Mesh1D, p: int) -> CgMesh:
    ref = make_reference_element(p)
    pos = ref.pos_to_slot
    mass_pos = ref.mass[np.ix_(pos, pos)]  # reference mass in grid order

    jac = jnp.asarray(mesh.jacobians)
    windows = jnp.asarray(mass_pos)[:, :, None] * jac[None, None, :]
    mass = cg_from_windows(windows)
    lumped = jnp.sum(mass.band, axis=0)  # row sums: sum over offsets == sum over cols
    return CgMesh(p=p, mesh=mesh, ref=ref, mass=mass, lumped_mass=lumped, mass_pos=mass_pos)
