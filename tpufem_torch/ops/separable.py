"""Separable global-operator apply on a uniform Cartesian grid.

Port of ``tpufem/ops/separable.py`` (``global_1d_matrices``,
``build_separable_operators``, ``laplace_apply_separable``).  On a uniform
Cartesian grid with constant coefficient the assembled Laplace operator
factors exactly into assembled 1D stiffness/mass matrices:

  A = K_z (x) M_y (x) M_x + M_z (x) K_y (x) M_x + M_z (x) M_y (x) K_x

``laplace_apply_separable`` applies it as dense 1D contractions along each
grid axis, in the JAX package's order.  It is the plain PyTorch version of
both CUDA kernels in ``tpufem_torch.ops.kernel_separable``.

The host builders are numpy copies of the JAX module's (pinned equal to
them by tests/test_torch_separable.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from tpufem.fem.quadrature import Quadrature
from tpufem.fem.shapes import ShapeInfo


@lru_cache(maxsize=None)
def global_1d_matrices(p: int, n: int, nq1: int) -> tuple[np.ndarray, np.ndarray]:
    """Assembled 1D reference matrices on n cells of the unit interval,
    f64 and UNSCALED: the caller multiplies K1 by 1/h and M1 by h per axis."""
    si = ShapeInfo(p, Quadrature.gauss(nq1))
    w = si.quad.weights_1d
    k1 = np.einsum("qi,q,qj->ij", si.D, w, si.D)  # reference-cell stiffness
    m1 = np.einsum("qi,q,qj->ij", si.S, w, si.S)
    npts = n * p + 1
    K1 = np.zeros((npts, npts))
    M1 = np.zeros((npts, npts))
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        K1[sl, sl] += k1
        M1[sl, sl] += m1
    return K1, M1


def build_separable_operators(p, dim, nq1, n, h, dtype):
    """Per-axis scaled (K1_a, M1_a) as numpy arrays of ``dtype``.

    h: (dim,) physical cell widths; K scales by 1/h, M by h.
    """
    K1u, M1u = global_1d_matrices(p, n, nq1)
    Ks, Ms = [], []
    for a in range(dim):
        Ks.append(np.asarray(K1u / h[a], dtype))
        Ms.append(np.asarray(M1u * h[a], dtype))
    return Ks, Ms


def _contract_grid(t: torch.Tensor, M: torch.Tensor, axis: int,
                   dim: int) -> torch.Tensor:
    """Contract the grid dimension holding spatial axis ``axis`` (0 = x,
    the last grid dimension) with M: out[..., o, ...] = sum_i M[o, i] t[..., i, ...]."""
    pos = dim - 1 - axis
    out = torch.matmul(t.movedim(pos, -1), M.T)
    return out.movedim(-1, pos)


def laplace_apply_separable(u: torch.Tensor, dim: int, npts: int, Ks,
                            Ms) -> torch.Tensor:
    """y = A u via the separable factorisation (8 contractions in 3D, 4 in
    2D, with shared partials).  u is flat (npts**dim,); Ks/Ms are per-axis
    (npts, npts) tensors on u's device, x first."""
    t = u.reshape((npts,) * dim)
    if dim == 2:
        r = _contract_grid(_contract_grid(t, Ms[0], 0, dim), Ks[1], 1, dim)
        r = r + _contract_grid(_contract_grid(t, Ks[0], 0, dim), Ms[1], 1, dim)
        return r.reshape(-1)
    a = _contract_grid(t, Ms[0], 0, dim)  # Mx u
    b = _contract_grid(a, Ms[1], 1, dim)  # My Mx u
    r = _contract_grid(b, Ks[2], 2, dim)  # Kz My Mx u
    c = _contract_grid(a, Ks[1], 1, dim)  # Ky Mx u
    r = r + _contract_grid(c, Ms[2], 2, dim)
    e = _contract_grid(t, Ks[0], 0, dim)  # Kx u
    f = _contract_grid(e, Ms[1], 1, dim)
    r = r + _contract_grid(f, Ms[2], 2, dim)
    return r.reshape(-1)
