"""The fused separable Laplace apply as a hand-written CUDA kernel.

Port of the Pallas kernels K2 (``_kernel`` / ``PallasSeparable``) and K1
(``_kernel_resident`` / ``ResidentSeparable``) of
``tpufem/ops/pallas_separable.py``.  One CUDA routine serves both
(``tpufem_torch/csrc/separable_apply.cuh``, whose header note gives the
schedule and what bounds it): each 1D operator enters as an EXACT per-row
band table ``W[g, o] = M[g, g+o-p]`` of shape ``(npts, 2p+1)``, so the
TPU's periodic tables, deficit corrections, 128-lane padding and sublane
halos have no counterpart here.

Each wrapper dispatches on the device of the tensor it is given: on a
CUDA tensor it launches the kernel (and raises if it cannot), on a CPU
tensor it runs its plain PyTorch version (``plain``), built on
``tpufem_torch.ops.separable.laplace_apply_separable``.  Each wrapper
class counts its kernel launches in the class attribute ``launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.separable import laplace_apply_separable
from tpufem_torch.utils.build import load_kernels
from tpufem_torch.utils.precision import torch_dtype

# Shared memory a block may use; larger tiles cut the halo re-reads but
# leave fewer blocks per SM (228 KB of shared memory per H100 SM).
SMEM_BUDGET = 100 * 1024
MAX_DEGREE = 8  # the CUDA routine is instantiated for p = 1..8
# Output tiles (TZ, TY, TX) tried in order; TX = 32 keeps warp rows
# contiguous.  2D tiles have TZ = 1.
_TILES = {
    3: ((8, 8, 32), (4, 8, 32), (4, 4, 32), (2, 4, 32), (2, 2, 32),
        (2, 2, 16), (1, 2, 16), (1, 1, 16)),
    2: ((1, 32, 32), (1, 16, 32), (1, 8, 32), (1, 4, 32), (1, 2, 32),
        (1, 1, 32)),
}
# (storage, compute) dtype pairs the CUDA routine is instantiated for,
# with the code its C entry takes
_DTYPE_CODES = {
    (torch.float64, torch.float64): 0,
    (torch.float32, torch.float32): 1,
    (torch.bfloat16, torch.float32): 2,
}


def exact_bands(M1: np.ndarray, p: int, b: int, nt: int) -> np.ndarray:
    """(nt, 2p+1, b) EXACT per-row tap weights of a banded 1D operator:
    W[t, o, i] = M1[g, g+o-p] for global row g = t*b + i; zero where g or
    g+o-p lies outside [0, npts).  Copy of
    ``tpufem/ops/pallas_separable.py::_exact_bands``."""
    npts = M1.shape[0]
    g = (np.arange(nt)[:, None, None] * b
         + np.arange(b)[None, None, :])  # (nt, 1, b)
    j = g + np.arange(2 * p + 1)[None, :, None] - p  # (nt, 2p+1, b)
    ok = (g < npts) & (j >= 0) & (j < npts)
    W = np.zeros((nt, 2 * p + 1, b))
    W[ok] = M1[np.broadcast_to(g, j.shape)[ok], j[ok]]
    return W


def band_tables(mats, p: int) -> np.ndarray:
    """(len(mats), npts, 2p+2) f64 kernel tables, one per 1D operator:
    ``exact_bands`` with a single tile spanning the axis (rows by global
    index, 2p+1 taps), then the row's tap sum, which the kernel's
    difference form takes (separable_apply.cuh, ``band``)."""
    npts = mats[0].shape[0]
    tabs = []
    for M in mats:
        W = exact_bands(np.asarray(M, np.float64), p, npts, 1)[0].T
        tabs.append(np.concatenate([W, W.sum(axis=1, keepdims=True)], 1))
    return np.ascontiguousarray(np.stack(tabs))  # row-major, as the kernel reads


def choose_tile(dim: int, p: int, itemsize: int, smem_elems):
    """The first tile of ``_TILES[dim]`` whose block fits SMEM_BUDGET.

    ``smem_elems(dim, p, tz, ty, tx)`` is the kernel library's own count
    of a block's shared-memory elements (``tpufem_smem_elems``)."""
    for tile in _TILES[dim]:
        if smem_elems(dim, p, *tile) * itemsize <= SMEM_BUDGET:
            return tile
    raise ValueError(f"no tile fits {SMEM_BUDGET} bytes of shared memory "
                     f"at dim={dim}, p={p}, itemsize={itemsize}")


class _BandApply:
    """Tables, tile and launch of the CUDA routine for one operator.

    Ks/Ms: per-axis (npts, npts) 1D operators (x first), any banded
    matrices of bandwidth p.  ``storage`` is the dtype of the vectors the
    kernel reads and writes, ``compute`` that of its arithmetic.  ``tile``
    is the output tile (TZ, TY, TX) of a CUDA instance (``None``: the
    first of ``_TILES`` that fits); a CPU instance has none.
    """

    def __init__(self, dim, npts, p, Ks, Ms, storage, compute, dirichlet,
                 device, tile=None):
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        if not 1 <= p <= MAX_DEGREE:
            raise ValueError(f"the CUDA routine is instantiated for p = "
                             f"1..{MAX_DEGREE}, got p = {p}")
        if (storage, compute) not in _DTYPE_CODES:
            raise ValueError(f"no kernel instance stores {storage} and "
                             f"computes in {compute}")
        self.dim, self.npts, self.p = dim, npts, p
        self.storage, self.compute = storage, compute
        self.code = _DTYPE_CODES[(storage, compute)]
        self.dirichlet = bool(dirichlet)
        self.device = torch.device(device)
        self.lib = self.tile = None
        if self.device.type == "cuda":
            # the library is built when the first CUDA instance is made, so
            # a kernel that cannot be built raises at construction
            self.lib = load_kernels()
            if self.device.index is None:
                # "cuda" means the current card; tensors report "cuda:<i>"
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            itemsize = torch.empty((), dtype=compute).element_size()
            self.tile = tuple(tile) if tile is not None else choose_tile(
                dim, p, itemsize, self.lib.lib.tpufem_smem_elems)
        mats = []
        for a in range(dim):
            mats += [Ks[a], Ms[a]]
        self.tables = torch.as_tensor(band_tables(mats, p), dtype=compute,
                                      device=self.device)

    def launch(self, u: torch.Tensor) -> torch.Tensor:
        """y = A u (with the fused mask if ``dirichlet``) on the card."""
        if u.device != self.device or not u.is_cuda:
            raise ValueError(f"kernel on {self.device} got a tensor on "
                             f"{u.device}")
        if u.dtype != self.storage:
            raise ValueError(f"kernel stores {self.storage}, got {u.dtype}")
        if u.numel() != self.npts**self.dim or not u.is_contiguous():
            raise ValueError(f"kernel takes a contiguous grid of "
                             f"{self.npts}**{self.dim} points, got shape "
                             f"{tuple(u.shape)}")
        y = torch.empty_like(u)
        tz, ty, tx = self.tile
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.lib.lib.tpufem_separable_apply(
                self.code, self.dim, self.p, self.npts, int(self.dirichlet),
                tz, ty, tx, u.data_ptr(), y.data_ptr(),
                self.tables.data_ptr(), stream)
        self.lib.check(rc, "tpufem_separable_apply launch")
        return y


def _on(device, mats, dtype):
    return [torch.tensor(np.asarray(M, np.float64), dtype=dtype,
                         device=device) for M in mats]


class KernelSeparable:
    """K2: fused separable apply on flat ``(npts**dim,)`` vectors, 2D/3D.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel`` behind
    ``PallasSeparable``.  dtype float32 or float64 (Hopper runs f64
    natively; the TPU kernel compiled f32 only).
    """

    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, dim, npts, p, Ks, Ms, dtype, device):
        dt = torch_dtype(dtype)
        self.dim, self.npts = dim, npts
        self._band = _BandApply(dim, npts, p, Ks, Ms, dt, dt, False, device)
        self.device, self.tile = self._band.device, self._band.tile
        self.Ks = _on(self.device, Ks, dt)
        self.Ms = _on(self.device, Ms, dt)

    def plain(self, u: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version (dense 1D contractions)."""
        return laplace_apply_separable(u, self.dim, self.npts, self.Ks,
                                       self.Ms)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        if u.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(u)
        y = self._band.launch(u)
        KernelSeparable.launches += 1
        return y


class ResidentSeparable:
    """K1: solver-resident fused 3D apply, optionally with the fused
    Dirichlet mask y = m·A(m·x) + (1-m)·x of the uniform hyper_cube.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident``
    behind ``ResidentSeparable``.  The TPU kernel needed a halo'd, lane-
    padded resident layout; this kernel bounds-checks its own halo, so the
    resident layout is the plain ``(npts, npts, npts)`` grid and ``pad``,
    ``pad_any`` and ``unpad`` are reshapes (``pad`` also casts to the
    storage dtype).  ``raw`` applies the kernel to a resident grid.

    Modes (``dtype`` is the compute dtype):
    - "f32": vectors stored and computed in ``dtype`` (f32 or f64).
    - "bf16": on the TPU a bf16x3 split of the x matmul (~3e-6 rel); this
      kernel has no matmul to split, so it runs the f32 instance, which
      meets that accuracy class.
    - "bf16s": vectors stored bf16, arithmetic in f32 (dtype float32);
      ~4e-3 rel, the class of the TPU kernel (input/output quantisation).

    ``tile`` overrides the kernel's output tile (the tile sweep of
    ``tpufem_torch.apps.resident_probe``).
    """

    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, npts, p, Ks, Ms, dtype, mode="f32", dirichlet=False,
                 device="cpu", tile=None):
        if mode not in ("f32", "bf16", "bf16s"):
            raise ValueError(f"mode must be 'f32', 'bf16' or 'bf16s', got "
                             f"{mode!r}")
        cdt = torch_dtype(dtype)
        if mode == "bf16s" and cdt != torch.float32:
            raise ValueError("mode 'bf16s' computes in float32")
        self.npts, self.p, self.mode = npts, p, mode
        self.compute_dt = cdt
        self.dt = torch.bfloat16 if mode == "bf16s" else cdt  # storage
        self.dirichlet = bool(dirichlet)
        self._band = _BandApply(3, npts, p, Ks, Ms, self.dt, cdt,
                                self.dirichlet, device, tile)
        self.device, self.tile = self._band.device, self._band.tile
        self.Ks = _on(self.device, Ks, cdt)
        self.Ms = _on(self.device, Ms, cdt)

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident grid in the storage dtype."""
        return u.to(self.dt).reshape((self.npts,) * 3)

    def pad_any(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident grid, dtype preserved."""
        return u.reshape((self.npts,) * 3)

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        return gp.reshape(-1)

    def interior_mask(self) -> torch.Tensor:
        """(npts**3,) separable interior mask of the hyper_cube, compute
        dtype: 0 on the six boundary planes, 1 elsewhere."""
        m1 = torch.ones(self.npts, dtype=self.compute_dt, device=self.device)
        m1[0] = m1[-1] = 0.0
        return (m1[:, None, None] * m1[None, :, None]
                * m1[None, None, :]).reshape(-1)

    def plain(self, gp: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of ``raw`` (compute dtype inside,
        storage dtype out)."""
        x = gp.to(self.compute_dt).reshape(-1)
        A = lambda v: laplace_apply_separable(v, 3, self.npts, self.Ks,
                                              self.Ms)
        if self.dirichlet:
            m = self.interior_mask()
            y = m * A(m * x) + (1.0 - m) * x
        else:
            y = A(x)
        return y.to(self.dt).reshape(gp.shape)

    def raw(self, gp: torch.Tensor) -> torch.Tensor:
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp)
        y = self._band.launch(gp)
        ResidentSeparable.launches += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.unpad(self.raw(self.pad(u)))
