"""Dense local-operator apply on the uniform grid.

Port of ``tpufem/ops/dense_local.py``: on a uniform Cartesian mesh with a
constant coefficient every cell has the same local matrix
A = sum_a scale_a K_a (nn x nn, nn = (p+1)^dim), so the apply is blocked
gather -> one (ncells, nn) @ (nn, nn) matmul -> overlap-add.  K_a is built
with the same quadrature algebra as the assembled oracle
(``assemble.cell_basis_gradients``), so parity with it is exact to
rounding.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpufem_torch.fem.assemble import cell_basis_gradients
from tpufem_torch.fem.quadrature import Quadrature
from tpufem_torch.ops.structured import block_all, unblock_all_add


@lru_cache(maxsize=None)
def reference_stiffness_axes(p: int, dim: int, nq1: int) -> tuple:
    """K_a[i,j] = sum_q G[q,i,a] w_q G[q,j,a] on the reference cell,
    one (nn, nn) f64 matrix per axis (unscaled)."""
    quad = Quadrature.gauss(nq1)
    G = cell_basis_gradients(p, dim, quad)  # (nq, nn, d)
    w = quad.tensor_weights(dim)
    return tuple(np.einsum("qi,q,qj->ij", G[:, :, a], w, G[:, :, a])
                 for a in range(dim))


def _blocked_to_cells(t: torch.Tensor, dim: int):
    """(nz,pz,ny,py,nx,px) -> (ncells, nn) with cells (cz,cy,cx) x-fastest
    and locals lexicographic x-fastest."""
    perm = tuple(2 * k for k in range(dim)) + tuple(2 * k + 1
                                                    for k in range(dim))
    t = t.permute(perm)
    nc = int(np.prod(t.shape[:dim]))
    return t.reshape(nc, -1), t.shape


def _cells_to_blocked(y: torch.Tensor, shape, dim: int) -> torch.Tensor:
    perm = [0] * 2 * dim  # inverse of _blocked_to_cells' permutation
    for k in range(dim):
        perm[2 * k] = k
        perm[2 * k + 1] = dim + k
    return y.reshape(shape).permute(perm)


def laplace_apply_dense(u, dim: int, ns, p: int, A_local, mask_cells=None):
    """Blocked gather -> one matmul -> overlap-add.

    A_local: (nn, nn) tensor = sum_a scale_a K_a, identical for all cells.
    mask_cells: optional (ncells,) 0/1 in (cz, cy, cx) x-fastest order;
    inactive cells contribute zero (the JAX package's
    ``laplace_apply_dense_masked``).
    """
    if isinstance(ns, int):
        ns = (ns,) * dim
    cells, shape = _blocked_to_cells(block_all(u, dim, ns, p), dim)
    y = cells @ A_local.T
    if mask_cells is not None:
        y = y * mask_cells[:, None]
    return unblock_all_add(_cells_to_blocked(y, shape, dim), dim, ns, p)


def build_dense_local_matrix(p, dim, nq1, scale) -> np.ndarray:
    """A = sum_a scale[a] * K_a, f64 numpy."""
    Ks = reference_stiffness_axes(p, dim, nq1)
    return sum(float(scale[a]) * Ks[a] for a in range(dim))
