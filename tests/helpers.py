"""Shared dense-materialization helpers for structured transfer operators."""

import numpy as np

from agglomerationmultigrid1d.ops import BlockProlong, CgProlong, SeamProlong
from agglomerationmultigrid1d.transfer.interpolation import _seam_to_dense_n


def bp_dense(l: BlockProlong) -> np.ndarray:
    r, bs_f, bs_c, nc = l.blocks.shape
    out = np.zeros((r * nc * bs_f, nc * bs_c))
    for c in range(nc):
        for j in range(r):
            f = c * r + j
            out[f * bs_f : (f + 1) * bs_f, c * bs_c : (c + 1) * bs_c] = np.asarray(
                l.blocks[j, :, :, c]
            )
    return out


def cgp_dense(l: CgProlong, n_el: int) -> np.ndarray:
    p_f, p_c = l.p_fine, l.p_coarse
    nf, nc = n_el * p_f + 1, n_el * p_c + 1
    out = np.zeros((nf, nc))
    e = np.asarray(l.e)
    for k in range(n_el):
        out[k * p_f : k * p_f + p_f + 1, k * p_c : k * p_c + p_c + 1] = e
    return out


def seam_dense(l: SeamProlong) -> np.ndarray:
    """Full dense L = diag(inv_lump) N."""
    n = np.asarray(_seam_to_dense_n(l))
    return np.asarray(l.inv_lump)[:, None] * n


def rbp_dense(l) -> np.ndarray:
    """Dense materialization of a RaggedBlockProlong."""
    r_max, bs_f, bs_c, nc = l.blocks.shape
    sizes = np.asarray(l.sizes)
    offsets = np.asarray(l.offsets)
    out = np.zeros((l.n_fine * bs_f, nc * bs_c))
    for c in range(nc):
        for j in range(int(sizes[c])):
            f = int(offsets[c]) + j
            out[f * bs_f : (f + 1) * bs_f, c * bs_c : (c + 1) * bs_c] = np.asarray(
                l.blocks[j, :, :, c]
            )
    return out


def sp_dense(l) -> np.ndarray:
    """Dense materialization of a ScatteredProlong."""
    bs_f, bs_c, nf = np.asarray(l.blocks).shape
    out = np.zeros((nf * bs_f, l.n_coarse * bs_c))
    cols = np.asarray(l.cols)
    for e in range(nf):
        c = int(cols[e])
        out[e * bs_f : (e + 1) * bs_f, c * bs_c : (c + 1) * bs_c] = np.asarray(
            l.blocks[:, :, e]
        )
    return out
