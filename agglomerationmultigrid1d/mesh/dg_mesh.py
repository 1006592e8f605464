"""Discontinuous-Galerkin discretization mesh (order-p nodal, element-contiguous).

Counterpart of ``src/dg_mesh.jl:16-138``.  DoFs keep the reference's
*slot* ordering inside each element (slot 0 = left endpoint, slot 1 = right
endpoint, slots 2..p = interior Chebyshev nodes in descending x,
``dg_mesh.jl:41-46``), and element k owns the contiguous block ``k*(p+1) ..``;
vectors are stored as ``(p+1, n)`` with the element axis last (contiguous).

The per-vertex "switch function" (``dg_mesh.jl:81-109``) resolves — due to both
branches of the interior case reading ``vert.mFaces[1]`` — to the deterministic
rule "u-hat from the LEFT element, q-hat from the RIGHT element" at every
interior vertex; we implement that rule directly (SURVEY §7 quirk (a)).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..numerics import make_reference_element
from ..ops.block_diag import BlockDiag, bd_inverse
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class DgMesh:
    p: int
    mesh: Mesh1D
    ref: "object"  # ReferenceElement
    mass: BlockDiag  # (p+1, p+1, n): J_k * reference mass per element
    mass_inv: BlockDiag
    # per-interior-vertex switch (n_el - 1,): True = u-hat from the LEFT
    # element / q-hat from the right (the reference's resolved default rule);
    # False flips the sides at that vertex.  None = all-default (fast path).
    # Mirrors the explicit-switch constructor ``dg_mesh.jl:114-138``.
    u_hat_left: np.ndarray | None = None

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements

    @property
    def block_size(self) -> int:
        return self.p + 1

    @property
    def n_nodes(self) -> int:
        return self.n_elements * (self.p + 1)

    def node_x(self) -> np.ndarray:
        """Coordinates per (slot, element), shape ``(p+1, n)``."""
        return self.mesh.ref_map(
            np.arange(self.n_elements)[None, :], self.ref.nodes_x[:, None]
        )


def normalize_switch(
    switch: np.ndarray | None, n_elements: int, allow_trapped: bool
) -> np.ndarray | None:
    """Validate a per-interior-vertex switch (DG or agglomerated level):
    reject u-trapping (True, False) adjacent pairs unless ``allow_trapped``,
    and normalize all-True (= the default rule) to ``None``."""
    if switch is None:
        return None
    switch = np.asarray(switch, dtype=bool)
    if switch.shape != (n_elements - 1,):
        raise ValueError("switch must have one entry per interior vertex")
    trapped = switch[:-1] & ~switch[1:]
    if trapped.any() and not allow_trapped:
        els = (np.nonzero(trapped)[0] + 1).tolist()
        raise ValueError(
            f"switch u-traps element(s) {els}: a True vertex followed by a "
            "False vertex means neither neighbor flux reads that element's "
            "trace, making the operator singular. Pass allow_trapped=True to "
            "build the (singular, block-pentadiagonal) operator anyway for "
            "analysis."
        )
    return None if switch.all() else switch


def make_dg_mesh(
    mesh: Mesh1D, p: int, switch: np.ndarray | None = None, allow_trapped: bool = False
) -> DgMesh:
    """``switch`` (optional, (n_el - 1,) bool): per interior vertex, True takes
    u-hat from the left element and q-hat from the right (the reference's
    resolved default); False flips the sides — the explicit-switch constructor
    ``dg_mesh.jl:114-138``.

    A switch with an adjacent (True, False) pair at vertices (j, j+1) leaves
    element ``j + 1`` *u-trapped*: its trace enters no flux term, the scheme
    loses control of one mode per such pair, and the exact Schur stiffness
    ``A = C - D M^-1 G`` is **singular** (the reference's generic sparse A is
    equally singular there — its tests never exercise a mixed switch).  Those
    are also exactly the configurations whose A is block-PENTAdiagonal; every
    non-trapping switch yields a block-tridiagonal A.  Trapping switches are
    rejected here unless ``allow_trapped=True`` (analysis use: the
    pentadiagonal operator path, ``ops.block_penta``, represents the singular
    A exactly)."""
    ref = make_reference_element(p)
    jac = jnp.asarray(mesh.jacobians)
    blocks = jnp.asarray(ref.mass)[:, :, None] * jac[None, None, :]
    mass = BlockDiag(blocks)
    # every block is J_k * M_ref, so the inverse is M_ref^-1 / J_k — one tiny
    # host inverse + an elementwise scale instead of n batched LU inverses
    # (the batched path dominated XL setup at 10^7+ elements)
    inv_ref = np.linalg.inv(np.asarray(ref.mass))
    mass_inv = BlockDiag(jnp.asarray(inv_ref)[:, :, None] / jac[None, None, :])
    switch = normalize_switch(switch, mesh.n_elements, allow_trapped)
    return DgMesh(
        p=p, mesh=mesh, ref=ref, mass=mass, mass_inv=mass_inv,
        u_hat_left=switch,
    )
