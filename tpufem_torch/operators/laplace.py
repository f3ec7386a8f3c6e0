"""Matrix-free Laplace operator: vmult and diagonal.

Port of ``tpufem/operators/laplace.py`` (the reference's
``LaplaceOperatorGpu``): ``vmult_raw`` dispatches on the MatrixFree's
scheme — separable (the Laplace factorisation or the
sum-of-tensor-products terms, through their kernels under
``use_pallas``), structured, dense, or the general cell loop (gather ->
``laplace_cell_apply`` -> scatter).  The reference's constraint
save/zero/restore around ``cell_loop`` is mask algebra with the
hanging-node resolution C: ``y = m·C^T A C(m·x) + (1-m)·x``, identity on
constrained DoFs, keeping the operator symmetric.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.assemble import cell_basis_gradients
from tpufem_torch.ops import tensor_ops as tops
from tpufem_torch.ops.dense_local import laplace_apply_dense
from tpufem_torch.ops.diagonal import diagonal_device_hanging
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.ops.separable import (
    laplace_apply_separable,
    laplace_apply_separable_terms,
)
from tpufem_torch.ops.structured import (
    laplace_apply_global_general,
    laplace_apply_structured,
)


def _apply_metric_to_gradients(mf: MatrixFree, g: torch.Tensor):
    """g (nc, d, nq) reference gradients -> submitted reference gradients
    t[b] = sum_a invJ[b,a] * jxw * coef * (sum_b' invJ[b',a] g[b'])."""
    if mf.metric_kind == "cartesian":
        # J diagonal: t[a] = inv_h[a]^2 * det * w_q * coef * g[a]
        scale = mf.inv_h**2 * mf.det[:, None]  # (nc, d)
        t = g * scale[:, :, None] * mf.w_q[None, None, :]
        if mf.coef_dev is not None:
            t = t * mf.coef_dev[:, None, :]
        return t
    gp = torch.einsum("cqba,cbq->caq", mf.inv_jac, g)
    w = mf.jxw if mf.coef_dev is None else mf.jxw * mf.coef_dev
    gp = gp * w[:, None, :]
    return torch.einsum("cqba,caq->cbq", mf.inv_jac, gp)


def laplace_cell_apply(mf: MatrixFree, u_loc: torch.Tensor) -> torch.Tensor:
    """The per-cell-batch pipeline: evaluate -> quadrature op -> integrate
    (the FEEvaluation evaluate / submit_gradient / integrate sequence over
    the whole cell batch).  u_loc: (nc, nn) -> (nc, nn)."""
    mf.cell_data()
    dim = mf.config.dim
    if mf.D_col is not None:
        _, g = tops.eval_gradients_collocation(u_loc, mf.S, mf.D_col, dim)
        t = _apply_metric_to_gradients(mf, g)
        return tops.integrate_collocation(None, t, mf.S, mf.D_col, dim)
    g = tops.eval_gradients_basis(u_loc, mf.S, mf.D, dim)
    t = _apply_metric_to_gradients(mf, g)
    return tops.integrate_gradients_basis(t, mf.S, mf.D, dim)


class LaplaceOperator:
    """vmult-able Laplace operator with constrained-DoF identity semantics."""

    def __init__(self, mf: MatrixFree):
        self.mf = mf
        self.n_dofs = mf.n_dofs

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x without constraint handling (JAX ``laplace.py:201-248``):
        separable — a terms operator through its K4/K3 wrapper when
        attached (``use_pallas``), else the plain terms apply; the Laplace
        factorisation through K2 when attached, else the plain separable
        apply; dense and structured (curved: the global quadrature-grid
        form) gather-free; incidence and colored the general cell loop."""
        mf = self.mf
        d, p = mf.config.dim, mf.config.degree
        if mf.scheme == "separable":
            if mf.terms is not None:
                if mf.resident is not None:
                    return mf.resident(x)
                return laplace_apply_separable_terms(x, d, mf.npts, mf.terms)
            if mf.kernel is not None:
                return mf.kernel(x)
            return laplace_apply_separable(x, d, mf.npts, mf.Ks, mf.Ms)
        if mf.scheme == "dense":
            return laplace_apply_dense(x, d, mf.uniform_n, p, mf.dense_A)
        if mf.scheme == "structured":
            if mf.struct_gsym is not None:  # curved/general metric
                E_list, G_list = mf.global_EG
                return laplace_apply_global_general(
                    x, d, mf.uniform_n, p, E_list, G_list, mf.struct_gsym)
            return laplace_apply_structured(x, d, mf.uniform_n, p, mf.S,
                                            mf.D_col, mf.struct_scale,
                                            mf.struct_w)
        return mf.scatter(laplace_cell_apply(mf, mf.gather(x)))

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """y = m·C^T A C(m·x) + (1-m)·x: identity rows/cols on constrained
        DoFs; C fills hanging DoFs from their masters on read, C^T
        accumulates their results into the masters on write."""
        mf = self.mf
        m = mf.interior_mask
        y = self.vmult_raw(mf.distribute(m * x))
        return m * mf.distribute_transpose(y) + (1.0 - m) * x

    def diagonal(self) -> torch.Tensor:
        """Diagonal of the constrained operator, for Jacobi: with hanging
        nodes diag(C^T A C) on the device (``diagonal_device_hanging``);
        else the host closed form of the reference's unit-basis trick
        (``tpufem/operators/laplace.py::diagonal``), in its Cartesian
        branch (with the coefficient at the quadrature points, if any)
        and its general-metric branch (curved meshes); constrained DoFs
        get 1.  A MatrixFree built from given arrays (bridge.py) returns
        its given diagonal."""
        mf = self.mf
        if mf.jacobi_diag is not None:
            return mf.jacobi_diag
        if mf.has_hanging:
            m = mf.interior_mask
            return diagonal_device_hanging(mf) * m + (1.0 - m)
        p, d = mf.config.degree, mf.config.dim
        metric, coef = mf.host_metric, mf.coef_q
        G = cell_basis_gradients(p, d, mf.quad)  # (nq, nn, d) f64
        if metric.kind == "cartesian":
            # sum_q G[q,j,a]^2 w_q (times coef[c,q]) pre-contracted
            G2 = G**2
            if coef is None:
                B = np.einsum("qja,q->ja", G2, metric.w_q)  # (nn, d)
                diag_e = np.einsum("ja,ca,c->cj", B, metric.inv_h**2,
                                   metric.det)
            else:
                B = np.einsum("qja,cq->cja", G2, metric.w_q[None] * coef)
                diag_e = np.einsum("cja,ca,c->cj", B, metric.inv_h**2,
                                   metric.det)
        else:
            # sum_q w sum_a (sum_b G[q,j,b] invJ[b,a])^2
            #   = sum_{q,b,e} (w invJ invJ^T)[c,q,b,e] G[q,j,b] G[q,j,e]:
            # one matmul over (q, b, e) per chunk of cells (the reference's
            # per-cell einsum chain, reordered; equal to rounding)
            w = metric.jxw if coef is None else metric.jxw * coef
            nc = mf.mesh.n_cells
            nq, nn = G.shape[:2]
            GG = np.einsum("qjb,qje->qbej", G, G).reshape(nq * d * d, nn)
            diag_e = np.empty((nc, nn))
            step = max(1, int(2e7 // (nq * d * d)))  # bounds the memory
            for c0 in range(0, nc, step):
                c1 = min(nc, c0 + step)
                J = metric.inv_jac[c0:c1]
                JJ = np.matmul(J, np.swapaxes(J, -1, -2)) \
                    * w[c0:c1, :, None, None]
                diag_e[c0:c1] = JJ.reshape(c1 - c0, -1) @ GG
        diag = np.zeros(mf.n_dofs)
        np.add.at(diag, mf.dofs.cell_dofs.ravel(), diag_e.ravel())
        mask = mf.interior_mask.cpu().to(torch.float64).numpy()
        diag = diag * mask + (1.0 - mask)
        return torch.as_tensor(diag, dtype=mf.interior_mask.dtype,
                               device=mf.device)
