"""Assembled sparse-matrix SpMV baseline (device).

Port of ``tpufem/ops/sparse.py`` (the reference's ``cuda_sparse_matrix.h``:
the assembled operator used as the ``bmspmv`` baseline and as an
independent oracle for the matrix-free path, SURVEY.md §2, §4.3).

The layout is the reference's padded ELL: (n_rows, K) column indices and
values, each row padded with index 0 and value 0 to the widest row.  The
apply is plain PyTorch, a gather and a row sum: the JAX package's
``ell_matvec`` is an XLA gather and reduction, not a Pallas kernel.  The
gather is ``index_select`` on the flattened int32 indices (``x[indices]``
would copy them to int64 first), and the row sum is a reduction in a fixed
order: no ``index_add_``, no atomics, the same y from run to run.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from tpufem_torch.ops.matrix_free import resolve_device
from tpufem_torch.utils.precision import torch_dtype


def ell_matvec(indices: torch.Tensor, values: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A x in ELL form: ``(values * x[indices]).sum(1)``."""
    n, K = indices.shape
    g = torch.index_select(x, 0, indices.reshape(-1)).view(n, K)
    return (values * g).sum(1)


class EllMatrix:
    """Padded-ELL sparse matrix for the SpMV baseline."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 n_cols: int):
        self.indices = indices  # (n_rows, K) int32, padded with column 0
        self.values = values  # (n_rows, K) dtype, padded with 0
        self.n_cols = n_cols

    @classmethod
    def from_csr(cls, A: sp.csr_matrix, dtype=torch.float64,
                 device: torch.device | str = "cuda") -> "EllMatrix":
        """The reference's per-row fill in one numpy pass: each stored
        entry goes to its row, at slot (its position - the row's start)."""
        device = resolve_device(device)
        A = A.tocsr()
        n = A.shape[0]
        counts = np.diff(A.indptr)
        K = int(counts.max())
        nnz = int(A.indptr[-1])
        row = np.repeat(np.arange(n), counts)
        slot = np.arange(nnz) - A.indptr[row]
        idx = np.zeros((n, K), dtype=np.int32)
        val = np.zeros((n, K), dtype=np.float64)
        idx[row, slot] = A.indices[:nnz]
        val[row, slot] = A.data[:nnz]
        return cls(torch.as_tensor(idx, device=device),
                   torch.as_tensor(val, dtype=torch_dtype(dtype),
                                   device=device), A.shape[1])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x."""
        return ell_matvec(self.indices, self.values, x)

    @property
    def nnz_padded(self) -> int:
        return int(np.prod(self.values.shape))
