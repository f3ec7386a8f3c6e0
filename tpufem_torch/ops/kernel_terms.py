"""The sum-of-tensor-products apply as hand-written CUDA kernels.

Port of the Pallas kernels K4 (``_kernel_resident_terms`` /
``ResidentTerms``, 3D) and K3 (``_kernel_resident_2d`` /
``ResidentTerms2D``, 2D) of ``tpufem/ops/pallas_separable.py``.  They
apply ``A = sum_a (x)_b X_{a,b}`` for T terms of banded 1D matrices: the
exact factorisation of a curved orthogonal shell, of a separable or
CP-expanded coefficient, and (K3) of the 2D uniform Laplace.  Each 1D
matrix enters as an exact per-row band table, as for K1/K2
(``kernel_separable.band_tables``).

Both run the terms plan of the band ring, ``tpufem_torch/csrc/
resident_ring.cuh`` (K1 runs its Laplace plan), on the ring's
resident layout (``kernel_separable.RingApply``): ``(npts, npts, X)`` in
3D, ``(npts, X)`` in 2D, x zero-padded to a multiple of the ring's chunk
(``kernel_separable.ring_xc``).
With ``dirichlet`` they fuse the mask algebra y = m·A(m·x) + (1-m)·x of
the full-box boundary as K1 does: the masked 1D tables inside, a boundary
point's input at the store.  The TPU kernels' halo'd, 128-lane-padded
layouts, tile clamps, ``interleave``, ``x_mode`` and the
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
    overrides the sub-tile.  x is cut into ``segments`` (K4: one; K3:
    ``kernel_separable.choose_segments``'s).

    ``raw`` is the resident apply, layout to layout, masked with
    ``dirichlet``; ``__call__`` applies the unmasked A to flat vectors (the
    operator's ``vmult_raw``, whose Dirichlet lift needs A itself), through
    the same kernel with the unmasked tables.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident_terms``
    behind ``ResidentTerms``.  The ring's timing ablations at the plan's
    shared memory (float32, no mask) split its time: ``mode="copy"``, y =
    u through its loads and stores; ``mode="bands"``, its z and y stages
    alone, y = sum_a q_a at each x, no x band.
    """

    dim = 3
    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, npts, p, terms, dtype, mode="f32", dirichlet=False,
                 device="cuda", tile=None):
        dim = self.dim
        ablation = mode in RING_ABLATIONS
        if ablation and dirichlet:
            raise ValueError(f"mode {mode!r} has no Dirichlet mask")
        cdt, mats = _check(npts, terms, dim, "f32" if ablation else mode,
                           dtype)
        if ablation and cdt != torch.float32:
            raise ValueError(f"mode {mode!r} computes in float32")
        self.npts, self.p, self.mode = npts, p, mode
        self.n_terms = len(terms)
        self.compute_dt = cdt
        self.dt = torch.bfloat16 if mode == "bf16s" else cdt  # storage
        self.dirichlet = bool(dirichlet)
        ring = lambda masked: RingApply(1, npts, p, mats, self.dt, cdt,
                                        masked, device, tile, dim=dim)
        self._ring = ring(self.dirichlet)
        self._unmasked = ring(False) if self.dirichlet else self._ring
        self.device, self.tile = self._ring.device, self._ring.tile
        self.group, self.X = self._ring.group, self._ring.X
        self.smem, self.segments = self._ring.smem, self._ring.nseg
        self.tables = self._ring.tables
        self.terms = [[torch.tensor(X, dtype=cdt, device=self.device)
                       for X in mats[a * dim:(a + 1) * dim]]
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
        A = lambda v: laplace_apply_separable_terms(v, self.dim, self.npts,
                                                    terms)
        if self.dirichlet if masked is None else masked:
            m = separable_interior_mask(self.npts, self.compute_dt,
                                        self.device, self.dim)
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
        type(self).launches += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """y = A u, unmasked, on flat vectors."""
        gp = self.pad(u)
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.unpad(self.plain(gp, masked=False))
        y = self._unmasked.launch(gp, self.mode)
        type(self).launches += 1
        return self.unpad(y)


class ResidentTerms2D(ResidentTerms):
    """K3: 2D ``A = sum_a X_{a,1} (x) X_{a,0}`` (y, x); the uniform grid
    passes the 2-term Laplace factorisation, a 2D shell its weighted
    terms.  K4's wrapper in 2D: the ring's terms plan on the resident
    layout ``(npts, X)``, sub-tile (1, TY), x cut into segments that fill
    the card (``kernel_separable.choose_segments``), the mask of the
    full-box boundary fused with ``dirichlet``.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident_2d``
    behind ``ResidentTerms2D`` (whose mask algebra stays outside)."""

    dim = 2
    launches = 0  # kernel launches by all instances (plain calls excluded)
