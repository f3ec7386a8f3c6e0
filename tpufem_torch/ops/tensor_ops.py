"""Batched sum-factorized tensor contractions over a batch of cells.

Port of ``tpufem/ops/tensor_ops.py`` (the reference's ``tensor_ops.cuh``,
``TensorOpsShmem<dim,n,Number>``): each 1D contraction over a batch of
cells is one matmul ``(ncells * n^(dim-1), n) @ (n, nq)``, the cell batch
its M dimension.

Two evaluation schemes:
- *basis*: d contractions per gradient component (supports nq1 != n1);
- *collocation*: transform to values at quadrature points (d contractions
  with S), then differentiate in quadrature space with D_col = D S^{-1}
  (d contractions), 2d in all; requires nq1 == n1.

Data layout: local vectors are (ncells, n1^dim) with lexicographic local
ordering, x fastest; reshaped to (ncells, n_z, n_y, n_x) so the LAST tensor
axis is x.  Axis a in {0=x, 1=y, 2=z} lives at tensor dim (dim - a).
The 1D matrices are tensors in the data's dtype and on its device.
"""

from __future__ import annotations

import torch


def contract_axis(u: torch.Tensor, M: torch.Tensor, axis: int, dim: int,
                  transpose: bool = False) -> torch.Tensor:
    """Apply the 1D matrix M (nq, n1) along spatial axis ``axis``.

    u: (nc, m_{d-1}, ..., m_0) where the last dim is x (axis 0).
    transpose=False: out_size along that axis becomes nq (dof -> quad);
    transpose=True:  applies M^T (quad -> dof).
    """
    tdim = u.dim() - 1 - axis  # tensor dim holding spatial axis `axis`
    Mx = M.T if transpose else M
    out = torch.movedim(u, tdim, -1) @ Mx.T
    return torch.movedim(out, -1, tdim)


def eval_gradients_basis(u, S, D, dim: int):
    """Reference-space gradients at quadrature points, basis scheme.

    u: (nc, n1^dim) -> g: (nc, dim, nq1^dim)
    """
    nc = u.shape[0]
    nq1, n1 = S.shape
    ut = u.reshape((nc,) + (n1,) * dim)
    outs = []
    for a in range(dim):
        t = ut
        for b in range(dim):
            t = contract_axis(t, D if b == a else S, b, dim)
        outs.append(t.reshape(nc, nq1**dim))
    return torch.stack(outs, dim=1)


def integrate_gradients_basis(g, S, D, dim: int):
    """Transpose of eval_gradients_basis:
    g (nc, dim, nq^dim) -> (nc, n1^dim)."""
    nc = g.shape[0]
    nq1, n1 = S.shape
    acc = None
    for a in range(dim):
        t = g[:, a].reshape((nc,) + (nq1,) * dim)
        for b in range(dim):
            t = contract_axis(t, D if b == a else S, b, dim, transpose=True)
        acc = t if acc is None else acc + t
    return acc.reshape(nc, n1**dim)


def eval_values(u, S, dim: int):
    """Values at quadrature points: (nc, n1^dim) -> (nc, nq1^dim)."""
    nc = u.shape[0]
    n1 = S.shape[1]
    ut = u.reshape((nc,) + (n1,) * dim)
    for b in range(dim):
        ut = contract_axis(ut, S, b, dim)
    return ut.reshape(nc, -1)


def integrate_values(v, S, dim: int):
    """Transpose of eval_values: (nc, nq^dim) -> (nc, n1^dim)."""
    nc = v.shape[0]
    nq1 = S.shape[0]
    vt = v.reshape((nc,) + (nq1,) * dim)
    for b in range(dim):
        vt = contract_axis(vt, S, b, dim, transpose=True)
    return vt.reshape(nc, -1)


def eval_gradients_collocation(u, S, D_col, dim: int):
    """Collocation scheme: also returns values for free.

    u: (nc, n1^dim) -> (values (nc, nq), grads (nc, dim, nq)); nq1 == n1.
    """
    nc = u.shape[0]
    n1 = S.shape[1]
    vals = u.reshape((nc,) + (n1,) * dim)
    for b in range(dim):
        vals = contract_axis(vals, S, b, dim)
    grads = [contract_axis(vals, D_col, a, dim).reshape(nc, -1)
             for a in range(dim)]
    return vals.reshape(nc, -1), torch.stack(grads, dim=1)


def integrate_collocation(v, g, S, D_col, dim: int):
    """Transpose of eval_gradients_collocation.

    v: (nc, nq) or None (submitted values), g: (nc, dim, nq) or None
    -> (nc, n1^dim)
    """
    nc = (v if v is not None else g).shape[0]
    nq1 = S.shape[0]
    acc = None
    if g is not None:
        for a in range(dim):
            t = contract_axis(g[:, a].reshape((nc,) + (nq1,) * dim), D_col,
                              a, dim, transpose=True)
            acc = t if acc is None else acc + t
    if v is not None:
        t = v.reshape((nc,) + (nq1,) * dim)
        acc = t if acc is None else acc + t
    for b in range(dim):
        acc = contract_axis(acc, S, b, dim, transpose=True)
    return acc.reshape(nc, -1)
