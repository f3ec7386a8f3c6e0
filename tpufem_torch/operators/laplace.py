"""Matrix-free Laplace operator: vmult and diagonal.

Port of ``tpufem/operators/laplace.py`` for the separable scheme (the
Laplace factorisation and the sum-of-tensor-products terms).  The
reference's constraint save/zero/restore around ``cell_loop`` is mask
algebra, ``y = m·A(m·x) + (1-m)·x``: identity on constrained DoFs,
keeping the operator symmetric.  The slice has no hanging nodes, so the
JAX package's ``distribute``/``distribute_transpose`` are identities and
do not appear.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.fem.assemble import cell_basis_gradients
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.ops.separable import (
    laplace_apply_separable,
    laplace_apply_separable_terms,
)


class LaplaceOperator:
    """vmult-able Laplace operator with constrained-DoF identity semantics."""

    def __init__(self, mf: MatrixFree):
        self.mf = mf
        self.n_dofs = mf.n_dofs

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x without constraint handling (JAX ``laplace.py:201-216``):
        a terms operator goes through its K4/K3 wrapper when attached
        (``use_pallas``), else the plain terms apply; the Laplace
        factorisation through K2 when attached, else the plain separable
        apply."""
        mf = self.mf
        if mf.terms is not None:
            if mf.resident is not None:
                return mf.resident(x)
            return laplace_apply_separable_terms(x, mf.config.dim, mf.npts,
                                                 mf.terms)
        if mf.kernel is not None:
            return mf.kernel(x)
        return laplace_apply_separable(x, mf.config.dim, mf.npts, mf.Ks,
                                       mf.Ms)

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """y = m·A(m·x) + (1-m)·x: identity rows/cols on constrained DoFs."""
        m = self.mf.interior_mask
        y = self.vmult_raw(m * x)
        return m * y + (1.0 - m) * x

    def diagonal(self) -> torch.Tensor:
        """Diagonal of the constrained operator, for Jacobi: the host
        closed form of the reference's unit-basis trick
        (``tpufem/operators/laplace.py::diagonal``), in its Cartesian
        branch (with the coefficient at the quadrature points, if any)
        and its general-metric branch (curved meshes); constrained DoFs
        get 1.  A MatrixFree built from given arrays (bridge.py) returns
        its given diagonal."""
        mf = self.mf
        if mf.jacobi_diag is not None:
            return mf.jacobi_diag
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
        mask = mf.interior_mask.cpu().numpy().astype(np.float64)
        diag = diag * mask + (1.0 - mask)
        return torch.as_tensor(diag, dtype=mf.interior_mask.dtype,
                               device=mf.device)
