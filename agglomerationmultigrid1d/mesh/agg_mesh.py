"""Agglomerated-DG mesh levels (local modal basis on merged base elements).

Counterpart of ``src/agglomerated_dg_mesh.jl``.  One class covers
both the reference's ``AgglomeratedDgMesh1`` (first agglomeration level, built
from base CG/DG elements, ``:31-47``) and ``AgglomeratedDgMeshN`` (recursive
levels, ``:62-72``).  Agglomerate ``c`` owns the *contiguous* run of base
elements ``offsets[c] .. offsets[c] + sizes[c] - 1``; sizes may vary per
agglomerate (the reference's arbitrary ``agg::Vector{Vector{Int64}}`` partition,
``:400-495``, restricted to contiguous runs — the only partitions that keep 1D
operators block-tridiagonal, and the only ones its tests exercise).  Every table
batches into dense arrays padded to the max run length ``r_max`` with ZERO
jacobians, which makes the padding exactly inert in all quadrature sums:

* ``boxes``       (m, 2)            bounding boxes [x_left, x_right]
* ``basis_q``     (m, r_max, n_q, p+1)  modal basis at base-element-mapped
                                     Gauss points (``mBasisGQFunVal``, ``:103-128``)
* ``deriv_vals``  (m, p+1)          constant modal derivatives ([0, 2/h], ``:131``)
* ``bd_left/right`` (m, p+1)         boundary basis values at the agglomerate
                                     endpoints (``mBdBasisGQFunVal``, ``:158-173``)
* ``mass``        BlockDiag         per-agglomerate mass integrated base element
                                     by base element (``:437-456``)

The interior-vertex switch resolves to "u-hat from the LEFT agglomerate, q-hat
from the RIGHT agglomerate" exactly as at the DG level (quirk ``:474-475``).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..numerics import gauss_quad, modal_basis_vals_batched
from ..ops.block_diag import BlockDiag, bd_inverse
from .dg_mesh import normalize_switch
from .topology import Mesh1D


@dataclasses.dataclass(frozen=True)
class AggMesh:
    p: int  # modal order, 0 or 1
    mesh: Mesh1D  # the BASE topological mesh (geometry provider)
    sizes: np.ndarray  # (m,) base elements per agglomerate
    offsets: np.ndarray  # (m,) first base element of each agglomerate
    sub_sizes: np.ndarray  # (m,) sub-(agg-)elements per agglomerate (== sizes on level 1)
    sub_offsets: np.ndarray  # (m,) first sub-element of each agglomerate
    n_agg: int
    quad_nodes: np.ndarray  # (n_q,)
    quad_weights: np.ndarray  # (n_q,)
    boxes: np.ndarray  # (m, 2)
    basis_q: np.ndarray  # (m, r_max, n_q, p+1); rows past sizes[c] are padding
    x_quad: np.ndarray  # (m, r_max, n_q) mapped quadrature points
    jacs: np.ndarray  # (m, r_max) base jacobians, ZERO in the padding
    deriv_vals: np.ndarray  # (m, p+1)
    bd_left: np.ndarray  # (m, p+1)
    bd_right: np.ndarray  # (m, p+1)
    mass: BlockDiag
    mass_inv: BlockDiag
    # per-interior-vertex switch, as on DgMesh (the reference stores mSwitch on
    # AgglomeratedDgMesh1 too, ``agglomerated_dg_mesh.jl:38,:459-487``); None =
    # all-default "u-hat from the left agglomerate".  Only meaningful on level
    # 1 — recursive levels never assemble flux operators (like the reference's
    # AgglomeratedDgMeshN, which has no switch).
    u_hat_left: np.ndarray | None = None

    @property
    def n_elements(self) -> int:
        return self.n_agg

    @property
    def block_size(self) -> int:
        return self.p + 1

    @property
    def n_nodes(self) -> int:
        return self.n_agg * (self.p + 1)

    @property
    def r_max(self) -> int:
        return int(self.sizes.max())

    @property
    def has_tables(self) -> bool:
        """Whether the per-base-element quadrature tables were built (see
        ``make_agg_mesh(tables=...)``); load vectors and quadrature-based
        integrals require them."""
        return self.basis_q is not None

    @property
    def uniform_r(self) -> int | None:
        """Group size if uniform (enables the reshape fast paths), else None."""
        s = int(self.sizes[0])
        return s if bool((self.sizes == s).all()) else None

    @property
    def sub_uniform_r(self) -> int | None:
        s = int(self.sub_sizes[0])
        return s if bool((self.sub_sizes == s).all()) else None

    # kept names from the uniform-only first version (bench/tests use them)
    @property
    def r_base(self) -> int:
        r = self.uniform_r
        if r is None:
            raise ValueError("ragged agglomeration has no single r_base; use sizes")
        return r

    @property
    def r_sub(self) -> int:
        r = self.sub_uniform_r
        if r is None:
            raise ValueError("ragged agglomeration has no single r_sub; use sub_sizes")
        return r

    def base_jacobians(self) -> np.ndarray:
        """(m, r_max) jacobians of the base elements of each agglomerate,
        zero-padded past ``sizes[c]``."""
        if self.jacs is None:
            raise ValueError(
                "this AggMesh was built with tables=False (hierarchy lite mode); "
                "rebuild with tables=True for quadrature-table access"
            )
        return self.jacs


def _normalize_partition(n_base: int, partition) -> np.ndarray:
    """Partition spec -> (m,) sizes.  Accepts a sequence of group sizes or the
    reference's explicit element-id lists (``agg::Vector{Vector{Int64}}``,
    0-based here), which must be contiguous runs covering 0..n_base-1 in order."""
    part = list(partition)
    if part and hasattr(part[0], "__len__"):
        sizes = []
        expect = 0
        for group in part:
            ids = np.asarray(group)
            if ids.size == 0 or not np.array_equal(ids, np.arange(expect, expect + ids.size)):
                raise ValueError(
                    "agglomerates must be contiguous, in-order runs of base element "
                    f"ids (group starting at {expect} got {ids.tolist()}); "
                    "non-contiguous agglomerates break the 1D block-tridiagonal "
                    "operator structure — use make_scattered_agg_mesh (block-COO "
                    "operators) for arbitrary partitions"
                )
            sizes.append(ids.size)
            expect += ids.size
        sizes = np.asarray(sizes, dtype=np.int64)
    else:
        sizes = np.asarray(part, dtype=np.int64)
    if sizes.min() < 1 or sizes.sum() != n_base:
        raise ValueError(
            f"partition sizes {sizes.tolist()} must be >= 1 and sum to n_base={n_base}"
        )
    return sizes


def make_agg_mesh(
    p: int,
    mesh: Mesh1D,
    r_base: int | None = None,
    *,
    partition=None,
    r_sub: int | None = None,
    sub_sizes: np.ndarray | None = None,
    tables: bool = True,
    switch: np.ndarray | None = None,
    allow_trapped: bool = False,
) -> AggMesh:
    """Build an agglomeration level directly from the base mesh geometry.

    Either ``r_base`` (uniform: every agglomerate takes ``r_base`` consecutive
    base elements) or ``partition`` (arbitrary contiguous partition: a sequence
    of group sizes, or the reference's explicit element-id lists,
    ``agglomerated_dg_mesh.jl:400-495``).  ``sub_sizes`` records how many
    *previous-level* elements each agglomerate merges (defaults to the base
    sizes, i.e. a first agglomeration level); the recursive constructor
    :func:`coarsen_agg_mesh` fills it.

    The reference hierarchy re-uses whichever CG/DG mesh for geometry — all its
    CG meshes share element geometry, so taking the topological mesh directly
    resolves SURVEY §7 quirk (d) explicitly.

    ``tables=False`` builds a *lite* mesh: the O(n_base * n_q) per-base-element
    tables (``basis_q``, ``x_quad``, ``jacs``) are skipped and the mass is taken
    in closed form — exact, because the modal basis {1, 2(x-xc)/h} on an
    interval integrates analytically (mass = diag(h, h/3), and the base
    elements tile the agglomerate exactly).  Hierarchy construction uses lite
    meshes (every derived quantity is closed-form, see ``assembly.agg_assembly``
    and ``transfer.interpolation``); keep the default for direct discretization
    use (load vectors / quadrature-based L2 errors need the tables).

    ``switch`` (optional, (m - 1,) bool over interior agg vertices): the
    explicit per-vertex switch, exactly as on :func:`make_dg_mesh` (the
    reference stores ``mSwitch`` on ``AgglomeratedDgMesh1``,
    ``agglomerated_dg_mesh.jl:459-487``); u-trapping patterns are rejected
    unless ``allow_trapped``.
    """
    n_base = mesh.n_elements
    if (r_base is None) == (partition is None):
        raise ValueError("give exactly one of r_base or partition")
    if partition is not None:
        sizes = _normalize_partition(n_base, partition)
    else:
        if n_base % r_base:
            raise ValueError(
                "number of base elements must divide into uniform agglomerates; "
                "pass an explicit partition for ragged sizes"
            )
        sizes = np.full(n_base // r_base, r_base, dtype=np.int64)
    m = sizes.shape[0]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    r_max = int(sizes.max())

    if sub_sizes is None:
        sub_sizes = sizes.copy() if r_sub is None else np.full(m, r_sub, dtype=np.int64)
    sub_offsets = np.concatenate([[0], np.cumsum(sub_sizes)[:-1]])

    qx, qw = gauss_quad(2 * p)

    vx = mesh.vertex_x
    boxes = np.stack([vx[offsets], vx[offsets + sizes]], axis=1)
    h_agg = boxes[:, 1] - boxes[:, 0]

    if tables:
        # padded (m, r_max) gather of the base elements; zero jacobian in the
        # padding makes every quadrature contribution of the pad rows zero
        j_idx = offsets[:, None] + np.arange(r_max)[None, :]
        valid = np.arange(r_max)[None, :] < sizes[:, None]
        j_idx = np.minimum(j_idx, n_base - 1)
        centers = np.where(
            valid, mesh.centers[j_idx], boxes[:, :1] * 0.5 + boxes[:, 1:] * 0.5
        )
        jacs = np.where(valid, mesh.jacobians[j_idx], 0.0)
        x_quad = centers[:, :, None] + jacs[:, :, None] * qx[None, None, :]
        basis_q = modal_basis_vals_batched(p, boxes, x_quad)
        # mass blocks: sum over base elements of J_b * sum_l w_l phi_i phi_j
        mass_nij = np.einsum("cs,l,csli,cslj->cij", jacs, qw, basis_q, basis_q)
    else:
        jacs = x_quad = basis_q = None
        # closed form on the interval: {1, xi} with xi = 2(x - xc)/h is
        # mass-orthogonal, diag(h, h/3); identical to the quadrature sums
        mass_nij = np.zeros((m, p + 1, p + 1))
        mass_nij[:, 0, 0] = h_agg
        if p == 1:
            mass_nij[:, 1, 1] = h_agg / 3.0

    # boundary traces / derivatives of {1, xi}: constants in the box frame
    bd_left = np.ones((m, p + 1))
    bd_right = np.ones((m, p + 1))
    if p == 0:
        deriv_vals = np.zeros((m, 1))
    else:
        bd_left[:, 1] = -1.0
        bd_right[:, 1] = 1.0
        deriv_vals = np.stack([np.zeros(m), 2.0 / h_agg], axis=1)
    mass = BlockDiag(jnp.moveaxis(jnp.asarray(mass_nij), 0, -1))
    if tables:
        mass_inv = bd_inverse(mass)
    else:
        # lite mass is exactly diag(h, h/3): invert in closed form (the batched
        # LU path dominated hierarchy setup at 10^7+ base elements)
        inv_nij = np.zeros_like(mass_nij)
        inv_nij[:, 0, 0] = 1.0 / h_agg
        if p == 1:
            inv_nij[:, 1, 1] = 3.0 / h_agg
        mass_inv = BlockDiag(jnp.moveaxis(jnp.asarray(inv_nij), 0, -1))

    return AggMesh(
        p=p,
        mesh=mesh,
        sizes=sizes,
        offsets=offsets,
        sub_sizes=np.asarray(sub_sizes, dtype=np.int64),
        sub_offsets=sub_offsets,
        n_agg=m,
        quad_nodes=qx,
        quad_weights=qw,
        boxes=boxes,
        basis_q=basis_q,
        x_quad=x_quad,
        jacs=jacs,
        deriv_vals=deriv_vals,
        bd_left=bd_left,
        bd_right=bd_right,
        mass=mass,
        mass_inv=mass_inv,
        u_hat_left=normalize_switch(switch, m, allow_trapped),
    )


def coarsen_agg_mesh(
    fine: AggMesh, r_sub: int = 2, *, partition=None, tables: bool | None = None
) -> AggMesh:
    """Next agglomeration level merging finer agglomerates (the reference's
    recursive ``AgglomeratedDgMeshN`` from sub-agglomerate lists,
    ``agglomerated_dg_mesh.jl:501-559``).

    ``r_sub`` merges a uniform count of consecutive fine agglomerates;
    ``partition`` gives explicit group sizes (in units of fine agglomerates).
    ``tables`` defaults to the fine level's choice (hierarchy levels >= 2 never
    need the per-base-element tables — everything about them is closed-form).
    """
    if partition is not None:
        sub = _normalize_partition(fine.n_agg, partition)
    else:
        if fine.n_agg % r_sub:
            raise ValueError(
                "fine agglomerate count must divide by r_sub; pass an explicit "
                "partition for ragged grouping"
            )
        sub = np.full(fine.n_agg // r_sub, r_sub, dtype=np.int64)
    # base-element sizes of each coarse agglomerate = sum of its fine sizes
    ends = np.cumsum(sub)
    starts = ends - sub
    cum = np.concatenate([[0], np.cumsum(fine.sizes)])
    base_sizes = cum[ends] - cum[starts]
    if tables is None:
        tables = fine.has_tables
    return make_agg_mesh(
        fine.p, fine.mesh, partition=base_sizes, sub_sizes=sub, tables=tables
    )
