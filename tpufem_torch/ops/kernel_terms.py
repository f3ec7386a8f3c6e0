"""The sum-of-tensor-products apply as a hand-written CUDA kernel.

Port of the Pallas kernels K4 (``_kernel_resident_terms`` /
``ResidentTerms``, 3D) and K3 (``_kernel_resident_2d`` /
``ResidentTerms2D``, 2D) of ``tpufem/ops/pallas_separable.py``.  They
apply ``A = sum_a (x)_b X_{a,b}`` for T terms of banded 1D matrices: the
exact factorisation of a curved orthogonal shell, of a separable or
CP-expanded coefficient, and (K3) of the 2D uniform Laplace.  One CUDA
routine serves both (``tpufem_torch/csrc/terms_apply.cuh``, whose header
note gives the schedule and what bounds it); each 1D matrix enters as an
exact per-row band table, as for K1/K2 (``kernel_separable.band_tables``).

The TPU kernels' halo'd, 128-lane-padded layouts, tile clamps,
``interleave``, ``x_mode`` (dense vs block-tridiagonal x stage) and the
``TPUFEM_TERMS_BX_MAX`` knob answered VMEM limits and have no
counterpart: the resident layout is the plain ``(npts,)*dim`` grid, so
``pad``, ``pad_any`` and ``unpad`` are reshapes.  The mask algebra stays
outside the kernel (``dirichlet`` is False), as in the JAX package.

On a CUDA tensor a wrapper launches the kernel (or raises); on a CPU
tensor it runs its plain PyTorch version (``plain``), built on
``tpufem_torch.ops.separable.laplace_apply_separable_terms``.  Each class
counts its kernel launches in the class attribute ``launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.kernel_separable import (
    band_tables,
    check_grid,
    check_instance,
    choose_tile,
)
from tpufem_torch.ops.separable import laplace_apply_separable_terms
from tpufem_torch.utils.precision import torch_dtype


class _ResidentTermsBase:
    """Tables, tile, launch and resident-layout contract of one
    sum-of-tensor-products operator on a ``(npts,)*dim`` grid.

    terms: T lists of ``dim`` banded (npts, npts) matrices of bandwidth
    p, ``terms[a][b]`` acting on axis b (0 = x, the fastest).

    Modes (``dtype`` is the compute dtype):
    - "f32": vectors stored and computed in ``dtype`` (f32 or f64);
    - "bf16": on the TPU a bf16x3 split of the x matmul (~3e-6 rel); this
      kernel has no matmul to split, so it runs the f32 instance, which
      meets that accuracy class;
    - "bf16s": vectors stored bf16, arithmetic in f32 (dtype float32);
      ~4e-3 rel, the class of the TPU kernel.

    A CUDA instance's output tile (TZ, TY, TX) is the first of the tile
    chooser's list whose block fits (``kernel_separable.choose_tile``).
    """

    dim = 0  # set by the subclasses, each with its own ``launches``

    def __init__(self, npts, p, terms, dtype, mode="f32", device="cuda"):
        if mode not in ("f32", "bf16", "bf16s"):
            raise ValueError(f"mode must be 'f32', 'bf16' or 'bf16s', got "
                             f"{mode!r}")
        cdt = torch_dtype(dtype)
        if mode == "bf16s" and cdt != torch.float32:
            raise ValueError("mode 'bf16s' computes in float32")
        dim = self.dim
        mats = [np.asarray(X, np.float64) for term in terms for X in term]
        if not terms or any(len(term) != dim for term in terms):
            raise ValueError(f"terms must be a non-empty list of {dim} "
                             f"matrices each")
        if any(X.shape != (npts, npts) for X in mats):
            raise ValueError(f"every 1D matrix must be ({npts}, {npts})")
        self.npts, self.p, self.mode = npts, p, mode
        self.n_terms = len(terms)
        self.compute_dt = cdt
        self.dt = torch.bfloat16 if mode == "bf16s" else cdt  # storage
        self.dirichlet = False  # the mask algebra stays outside the kernel
        self.code, self.device, self.lib = check_instance(
            dim, p, self.dt, cdt, device, "terms_apply")
        self.tile = None
        if self.lib is not None:
            itemsize = torch.empty((), dtype=cdt).element_size()
            smem = self.lib.lib.tpufem_terms_smem_elems
            T = self.n_terms
            self.tile = choose_tile(
                dim, p, itemsize,
                lambda d, pp, tz, ty, tx: smem(d, pp, T, tz, ty, tx))
        self.tables = torch.as_tensor(
            band_tables(mats, p).reshape(self.n_terms, dim, npts, 2 * p + 2),
            dtype=cdt, device=self.device)
        self.terms = [[torch.tensor(X, dtype=cdt, device=self.device)
                       for X in mats[a * dim:(a + 1) * dim]]
                      for a in range(self.n_terms)]

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident grid in the storage dtype."""
        return u.to(self.dt).reshape((self.npts,) * self.dim)

    def pad_any(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident grid, dtype preserved."""
        return u.reshape((self.npts,) * self.dim)

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        return gp.reshape(-1)

    def plain(self, gp: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of ``raw`` (compute dtype inside,
        storage dtype out)."""
        y = laplace_apply_separable_terms(gp.to(self.compute_dt).reshape(-1),
                                          self.dim, self.npts, self.terms)
        return y.to(self.dt).reshape(gp.shape)

    def raw(self, gp: torch.Tensor) -> torch.Tensor:
        """y = A u on a resident grid (storage dtype in and out)."""
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp)
        check_grid(gp, self.device, self.dt, self.npts, self.dim)
        y = torch.empty_like(gp)
        tz, ty, tx = self.tile
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.lib.lib.tpufem_terms_apply(
                self.code, self.dim, self.p, self.n_terms, self.npts, tz, ty,
                tx, gp.data_ptr(), y.data_ptr(), self.tables.data_ptr(),
                stream)
        self.lib.check(rc, "tpufem_terms_apply launch")
        type(self).launches += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.unpad(self.raw(self.pad(u)))


class ResidentTerms(_ResidentTermsBase):
    """K4: 3D ``A = sum_a X_{a,2} (x) X_{a,1} (x) X_{a,0}`` (z, y, x).

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident_terms``
    behind ``ResidentTerms``."""

    dim = 3
    launches = 0  # kernel launches by all instances (plain calls excluded)


class ResidentTerms2D(_ResidentTermsBase):
    """K3: 2D ``A = sum_a X_{a,1} (x) X_{a,0}`` (y, x); the uniform grid
    passes the 2-term Laplace factorisation, a 2D shell its weighted
    terms.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident_2d``
    behind ``ResidentTerms2D``."""

    dim = 2
    launches = 0  # kernel launches by all instances (plain calls excluded)
