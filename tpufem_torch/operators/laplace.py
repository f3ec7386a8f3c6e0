"""Matrix-free Laplace operator: vmult and diagonal.

Port of ``tpufem/operators/laplace.py`` for the separable slice.  The
reference's constraint save/zero/restore around ``cell_loop`` is mask
algebra, ``y = m·A(m·x) + (1-m)·x``: identity on constrained DoFs,
keeping the operator symmetric.  The slice has no hanging nodes, so the
JAX package's ``distribute``/``distribute_transpose`` are identities and
do not appear.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem.fem.assemble import cell_basis_gradients
from tpufem_torch.ops.matrix_free import MatrixFree
from tpufem_torch.ops.separable import laplace_apply_separable


class LaplaceOperator:
    """vmult-able Laplace operator with constrained-DoF identity semantics."""

    def __init__(self, mf: MatrixFree):
        self.mf = mf
        self.n_dofs = mf.n_dofs

    def vmult_raw(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x without constraint handling: the K2 kernel when
        attached (``use_pallas``), else the plain separable apply."""
        mf = self.mf
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
        closed form of the reference's unit-basis trick (Cartesian
        branch of ``tpufem/operators/laplace.py::diagonal``); constrained
        DoFs get 1.  A MatrixFree built from given arrays (bridge.py)
        returns its given diagonal."""
        mf = self.mf
        if mf.jacobi_diag is not None:
            return mf.jacobi_diag
        p, d = mf.config.degree, mf.config.dim
        metric = mf.host_metric
        G = cell_basis_gradients(p, d, mf.quad)  # (nq, nn, d) f64
        B = np.einsum("qja,q->ja", G**2, metric.w_q)  # (nn, d)
        diag_e = np.einsum("ja,ca,c->cj", B, metric.inv_h**2, metric.det)
        diag = np.zeros(mf.n_dofs)
        np.add.at(diag, mf.dofs.cell_dofs.ravel(), diag_e.ravel())
        mask = mf.interior_mask.cpu().numpy().astype(np.float64)
        diag = diag * mask + (1.0 - mask)
        return torch.as_tensor(diag, dtype=mf.interior_mask.dtype,
                               device=mf.device)
