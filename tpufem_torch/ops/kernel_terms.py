"""The sum-of-tensor-products apply as hand-written CUDA kernels.

Port of the Pallas kernels K4 (``_kernel_resident_terms`` /
``ResidentTerms``, 3D) and K3 (``_kernel_resident_2d`` /
``ResidentTerms2D``, 2D) of ``tpufem/ops/pallas_separable.py``.  They
apply ``A = sum_a (x)_b X_{a,b}`` for T terms of banded 1D matrices: the
exact factorisation of a curved orthogonal shell, of a separable or
CP-expanded coefficient, and (K3) of the 2D uniform Laplace.  Each 1D
matrix enters as an exact per-row band table, as for K1/K2
(``kernel_separable.band_tables``).

K4 runs the TMA ring of ``tpufem_torch/csrc/resident_ring.cuh`` (its term
plan; K1 runs its Laplace plan) on the ring's resident layout ``(npts,
npts, X)`` (``kernel_separable.RingApply``), and with ``dirichlet`` fuses
the mask algebra y = m·A(m·x) + (1-m)·x of the full-box boundary as K1
does: the masked 1D tables inside, a boundary point's input at the store.
K3 runs the tile routine of ``csrc/terms_apply.cuh`` on the plain
``(npts, npts)`` grid (``pad``, ``pad_any`` and ``unpad`` are reshapes),
its mask algebra outside the kernel.  The TPU kernels' halo'd,
128-lane-padded layouts, tile clamps, ``interleave``, ``x_mode`` and the
``TPUFEM_TERMS_BX_MAX`` knob answered VMEM limits and have no counterpart.

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU
tensor it runs its plain PyTorch version (``plain``, the same layout in
and out), built on ``tpufem_torch.ops.separable.laplace_apply_separable_
terms``.  Each class counts its kernel launches in the class attribute
``launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.kernel_separable import (
    RING_ABLATIONS,
    RingApply,
    ablation_terms,
    band_tables,
    check_grid,
    check_instance,
    choose_tile,
    separable_interior_mask,
)
from tpufem_torch.ops.separable import laplace_apply_separable_terms
from tpufem_torch.utils.precision import torch_dtype

_MODES = ("f32", "bf16", "bf16s")


def _check(npts, terms, dim, mode, dtype):
    """The compute dtype and the f64 1D matrices (term by term, x first)
    of a terms operator; raises on what no kernel instance takes.

    Modes (``dtype`` is the compute dtype):
    - "f32": vectors stored and computed in ``dtype`` (f32 or f64);
    - "bf16": on the TPU a bf16x3 split of the x matmul (~3e-6 rel); these
      kernels have no matmul to split, so they run the f32 instance, which
      meets that accuracy class;
    - "bf16s": vectors stored bf16, arithmetic in f32 (dtype float32);
      ~4e-3 rel, the class of the TPU kernel."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'f32', 'bf16' or 'bf16s', got "
                         f"{mode!r}")
    cdt = torch_dtype(dtype)
    if mode == "bf16s" and cdt != torch.float32:
        raise ValueError("mode 'bf16s' computes in float32")
    mats = [np.asarray(X, np.float64) for term in terms for X in term]
    if not terms or any(len(term) != dim for term in terms):
        raise ValueError(f"terms must be a non-empty list of {dim} "
                         f"matrices each")
    if any(X.shape != (npts, npts) for X in mats):
        raise ValueError(f"every 1D matrix must be ({npts}, {npts})")
    return cdt, mats


class ResidentTerms:
    """K4: 3D ``A = sum_a X_{a,2} (x) X_{a,1} (x) X_{a,0}`` (z, y, x) on
    the ring's resident layout, optionally with the fused Dirichlet mask of
    the full-box boundary (``dirichlet``).

    terms: T lists of 3 banded (npts, npts) matrices of bandwidth p,
    ``terms[a][b]`` acting on axis b (0 = x, the fastest); modes as
    ``_check`` says.  A CUDA instance's sub-tile (TZ, TY) and term group
    (the terms whose windows are resident; T beyond it takes further passes
    over x) come from ``kernel_separable.choose_ring_tile``; ``tile``
    overrides the sub-tile.

    ``raw`` is the resident apply, layout to layout, masked with
    ``dirichlet``; ``__call__`` applies the unmasked A to flat vectors (the
    operator's ``vmult_raw``, whose Dirichlet lift needs A itself), through
    the same kernel with the unmasked tables.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident_terms``
    behind ``ResidentTerms``.  The ring's timing ablations at K4's shared
    memory (float32, no mask) split its time: ``mode="copy"``, y = u
    through its loads and stores; ``mode="bands"``, its z and y stages
    alone, y = sum_a q_a at each x, no x band.
    """

    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, npts, p, terms, dtype, mode="f32", dirichlet=False,
                 device="cuda", tile=None):
        ablation = mode in RING_ABLATIONS
        if ablation and dirichlet:
            raise ValueError(f"mode {mode!r} has no Dirichlet mask")
        cdt, mats = _check(npts, terms, 3, "f32" if ablation else mode,
                           dtype)
        if ablation and cdt != torch.float32:
            raise ValueError(f"mode {mode!r} computes in float32")
        self.npts, self.p, self.mode = npts, p, mode
        self.n_terms = len(terms)
        self.compute_dt = cdt
        self.dt = torch.bfloat16 if mode == "bf16s" else cdt  # storage
        self.dirichlet = bool(dirichlet)
        self._ring = RingApply(1, npts, p, mats, self.dt, cdt,
                               self.dirichlet, device, tile)
        self._unmasked = (RingApply(1, npts, p, mats, self.dt, cdt, False,
                                    device, tile)
                          if self.dirichlet else self._ring)
        self.device, self.tile = self._ring.device, self._ring.tile
        self.group, self.X = self._ring.group, self._ring.X
        self.smem = self._ring.smem
        self.tables = self._ring.tables
        self.terms = [[torch.tensor(X, dtype=cdt, device=self.device)
                       for X in mats[a * 3:(a + 1) * 3]]
                      for a in range(self.n_terms)]

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident layout in the storage dtype."""
        return self._ring.pad_any(u.to(self.dt))

    def pad_any(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident layout, dtype preserved."""
        return self._ring.pad_any(u)

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        return self._ring.unpad(gp)

    def plain(self, gp: torch.Tensor, masked: bool | None = None
              ) -> torch.Tensor:
        """The plain PyTorch version of ``raw`` (compute dtype inside,
        storage dtype out, the same layout); ``masked=False``: of the
        unmasked A."""
        if self.mode == "copy":
            return gp.clone()
        x = self.unpad(gp).to(self.compute_dt)
        terms = self.terms if self.mode != "bands" else ablation_terms(
            self.terms, self.npts, self.compute_dt, self.device)
        A = lambda v: laplace_apply_separable_terms(v, 3, self.npts, terms)
        if self.dirichlet if masked is None else masked:
            m = separable_interior_mask(self.npts, self.compute_dt,
                                        self.device)
            y = m * A(m * x) + (1.0 - m) * x
        else:
            y = A(x)
        return self._ring.pad_any(y.to(self.dt))

    def raw(self, gp: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
        """y = A u (with ``dirichlet``: m·A(m·u) + (1-m)·u) on a resident
        layout (storage dtype in and out); on the card into ``out`` if
        given."""
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp)
        y = self._ring.launch(gp, self.mode, out=out)
        ResidentTerms.launches += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """y = A u, unmasked, on flat vectors."""
        gp = self.pad(u)
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.unpad(self.plain(gp, masked=False))
        y = self._unmasked.launch(gp, self.mode)
        ResidentTerms.launches += 1
        return self.unpad(y)


class ResidentTerms2D:
    """K3: 2D ``A = sum_a X_{a,1} (x) X_{a,0}`` (y, x); the uniform grid
    passes the 2-term Laplace factorisation, a 2D shell its weighted
    terms.  The resident layout is the plain ``(npts, npts)`` grid; the
    mask algebra stays outside the kernel (``dirichlet`` is False).  A
    CUDA instance's output tile (1, TY, TX) is the first of the tile
    chooser's list whose block fits (``kernel_separable.choose_tile``).

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident_2d``
    behind ``ResidentTerms2D``."""

    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, npts, p, terms, dtype, mode="f32", device="cuda"):
        cdt, mats = _check(npts, terms, 2, mode, dtype)
        self.npts, self.p, self.mode = npts, p, mode
        self.n_terms = len(terms)
        self.compute_dt = cdt
        self.dt = torch.bfloat16 if mode == "bf16s" else cdt  # storage
        self.dirichlet = False  # the mask algebra stays outside the kernel
        self.code, self.device, self.lib = check_instance(
            2, p, self.dt, cdt, device, "terms_apply")
        self.tile = None
        if self.lib is not None:
            itemsize = torch.empty((), dtype=cdt).element_size()
            smem = self.lib.lib.tpufem_terms_smem_elems
            T = self.n_terms
            self.tile = choose_tile(
                2, p, itemsize,
                lambda d, pp, tz, ty, tx: smem(pp, T, ty, tx))
        self.tables = torch.as_tensor(
            band_tables(mats, p).reshape(self.n_terms, 2, npts, 2 * p + 2),
            dtype=cdt, device=self.device)
        self.terms = [[torch.tensor(X, dtype=cdt, device=self.device)
                       for X in mats[a * 2:(a + 1) * 2]]
                      for a in range(self.n_terms)]

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident grid in the storage dtype."""
        return u.to(self.dt).reshape(self.npts, self.npts)

    def pad_any(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident grid, dtype preserved."""
        return u.reshape(self.npts, self.npts)

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        return gp.reshape(-1)

    def plain(self, gp: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of ``raw`` (compute dtype inside,
        storage dtype out)."""
        y = laplace_apply_separable_terms(gp.to(self.compute_dt).reshape(-1),
                                          2, self.npts, self.terms)
        return y.to(self.dt).reshape(gp.shape)

    def raw(self, gp: torch.Tensor) -> torch.Tensor:
        """y = A u on a resident grid (storage dtype in and out)."""
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp)
        check_grid(gp, self.device, self.dt, self.npts, 2)
        y = torch.empty_like(gp)
        _, ty, tx = self.tile
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.lib.lib.tpufem_terms_apply(
                self.code, self.p, self.n_terms, self.npts, ty, tx,
                gp.data_ptr(), y.data_ptr(), self.tables.data_ptr(), stream)
        self.lib.check(rc, "tpufem_terms_apply launch")
        ResidentTerms2D.launches += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.unpad(self.raw(self.pad(u)))
