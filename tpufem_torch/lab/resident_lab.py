"""The K1 kernel lab: host side and wrappers of the L1 kernels v17-v20.

Port of ``scripts/kernel_lab.py::V17Kernel`` and its Pallas kernels
``_kernel_v17`` (:581), ``_kernel_v18`` (:1090), ``_kernel_v19`` (:922)
and ``_kernel_v20`` (:747): K1's 3D Laplace operator on a solver-resident
halo'd layout, z and y axes by band stages, the x axis by one
tensor-core product ``[q1 | q2+q3] @ [Kx^T; Mx^T]`` (the CUDA routine and
its design note: ``tpufem_torch/csrc/lab_resident.cuh``).

The layout is ``(npts + 2p, npts + 2p, X)``: data at ``[p:p+npts,
p:p+npts, :npts]``, zeros elsewhere, ``X`` = npts rounded up to the MMA
tile (16).  The halo is p rows in z and y (the TPU's 8-row sublane halo
``H`` has no Hopper counterpart).  The z/y band tables are K1's exact
per-row tables in difference form (``kernel_separable.band_tables``), so
the TPU's periodic tables and deficit corrections (``_periodic_band``,
``corr_z``/``corr_y``) are not ported.

``V17Kernel.raw`` on a CUDA tensor launches the kernel (or raises); on a
CPU tensor it runs ``plain``, the dense separable contraction of
``tpufem_torch.ops.separable.laplace_apply_separable`` on the unpadded
grid, re-padded.  Launches are counted per kernel in the class attribute
``launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.ops.kernel_separable import band_tables
from tpufem_torch.ops.separable import laplace_apply_separable
from tpufem_torch.utils.build import load_kernels
from tpufem_torch.utils.timer import roofline_ms

KERNELS = ("v17", "v18", "v19", "v20")
MODES = {"f32": 0, "bf16": 0, "copy": 1, "bands": 2, "mm": 3}
# x-stage precision codes of the CUDA routine (LabXPrec): 3xTF32, 1xTF32,
# bf16x3, f64 (DMMA)
X3TF32, X1TF32, XBF16X3, XF64 = 0, 1, 2, 3
# MMA tile (M, N, K) of each x-stage precision
MMA = {X3TF32: (16, 16, 8), X1TF32: (16, 16, 8), XBF16X3: (16, 16, 16),
       XF64: (8, 8, 4)}
X_ALIGN = 16  # x padding: a multiple of every MMA N and K
SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may use on an H100
MAX_DEGREE = 8
# (TZ, TY) output tiles tried in order; M = TZ*TY must be a multiple of
# the MMA tile's M
TILES = ((2, 16), (4, 8), (2, 8), (1, 16), (1, 8))


def x_operator(Kx: np.ndarray, Mx: np.ndarray, X: int) -> np.ndarray:
    """(2X, X) f64 ``[Kx^T; Mx^T]``, zero-padded: out = [q1 | q23] @ it
    (``kernel_lab.py:1312-1315``)."""
    npts = Kx.shape[0]
    xkm = np.zeros((2 * X, X))
    xkm[:npts, :npts] = Kx.T
    xkm[X:X + npts, :npts] = Mx.T
    return xkm


def x_windows(X: int, p: int, n: int, k: int) -> np.ndarray:
    """(X // n, 2) int32 row windows of v20: column block j = [j n, (j+1) n)
    of a bandwidth-p operator's transpose needs rows [j n - p, (j+1) n + p)
    of each half of ``[Kx^T; Mx^T]``, rounded out to the MMA depth k and
    clipped to [0, X), so no window reads past row 2X."""
    lo = np.maximum(np.arange(0, X, n) - p, 0) // k * k
    hi = np.minimum(-(-(np.arange(0, X, n) + n + p) // k) * k, X)
    return np.ascontiguousarray(np.stack([lo, hi], 1).astype(np.int32))


def choose_tile(p: int, xp: int, nbuf: int, X: int, smem_bytes):
    """The first of ``TILES`` whose M fits the MMA tile and whose block fits
    SMEM_BUDGET by the routine's own count ``smem_bytes(p, xp, nbuf, tz,
    ty, X)`` (``tpufem_lab_smem_bytes``)."""
    for tz, ty in TILES:
        if (tz * ty) % MMA[xp][0] == 0 and \
                smem_bytes(p, xp, nbuf, tz, ty, X) <= SMEM_BUDGET:
            return tz, ty
    raise ValueError(f"no lab tile fits {SMEM_BUDGET} bytes of shared "
                     f"memory at p={p}, X={X}")


def operator_bound(npts: int, p: int, bands: int,
                   dtype=torch.float32) -> tuple[float, str]:
    """(ms, "bytes" or "operations") on an H100 for a 3D band operator on
    npts**3 DoFs stored in dtype: each DoF read and written once, and
    ``bands`` bands of 2p+1 multiply-adds per DoF on CUDA cores."""
    item = torch.empty((), dtype=dtype).element_size()
    return roofline_ms(2 * item * npts**3, {
        "fp64" if dtype == torch.float64 else "fp32":
        bands * 2 * (2 * p + 1) * npts**3})


def _ablation_operators(Ks, Ms, mode):
    """Per-axis (Ks, Ms) whose ``laplace_apply_separable`` is what mode
    computes: the operator, its band stages alone (x operators identity:
    q1 + q2 + q3) or its x product alone (Kx + Mx along x)."""
    n = Ks[0].shape[0]
    eye, zero = np.eye(n), np.zeros((n, n))
    if mode == "bands":
        return [eye, Ks[1], Ks[2]], [eye, Ms[1], Ms[2]]
    if mode == "mm":
        return [Ks[0] + Ms[0], zero, zero], [eye, eye, eye]
    return Ks, Ms


class V17Kernel:
    """An L1 kernel (``kern_name`` v17, v18, v19 or v20) on the resident
    layout: ``pad``/``unpad`` between flat vectors and the layout, ``raw``
    on the layout, ``__call__`` = unpad(raw(pad(u))).

    K1, M1: (npts, npts) unscaled 1D matrices (``global_1d_matrices``); h:
    the cell size per axis (x first), so the axis operators are K1/h[a]
    and M1*h[a].  Modes and precisions (the x stage's arithmetic):
    - "f32", prec "highest": 3xTF32 (float32) or DMMA (``dtype`` float64);
    - "f32", prec "high": one TF32 product (float32 only);
    - "bf16": bf16x3, hi/lo split of both operands, lo*lo dropped;
    - "copy", "bands", "mm": the timing ablations of the JAX lab (the
      layout alone, the band stages alone, the x product alone); each
      still computes a defined function, which ``plain`` gives.
    """

    launches = {name: 0 for name in KERNELS}  # per kernel; plain excluded

    def __init__(self, npts, p, K1, M1, h, mode="f32", prec="highest",
                 kern_name="v17", dtype=torch.float32, device="cuda",
                 tile=None):
        if kern_name not in KERNELS:
            raise ValueError(f"kern_name must be one of {KERNELS}, got "
                             f"{kern_name!r}")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {tuple(MODES)}, got "
                             f"{mode!r}")
        if prec not in ("highest", "high"):
            raise ValueError(f"prec must be 'highest' or 'high', got {prec!r}")
        if not 1 <= p <= MAX_DEGREE:
            raise ValueError(f"the CUDA routine is instantiated for p = "
                             f"1..{MAX_DEGREE}, got p = {p}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if dtype == torch.float64 and (mode == "bf16" or prec == "high"):
            raise ValueError("float64 runs the exact x stage only (mode "
                             "'f32' or an ablation, prec 'highest')")
        if prec == "high" and mode != "f32":
            raise ValueError("prec 'high' (1xTF32) applies to mode 'f32'")
        self.npts, self.p, self.mode, self.prec = npts, p, mode, prec
        self.kern_name, self.dt = kern_name, dtype
        self.xp = (XF64 if dtype == torch.float64 else XBF16X3
                   if mode == "bf16" else X1TF32 if prec == "high"
                   else X3TF32)
        self.X = X_ALIGN * -(-npts // X_ALIGN)
        self.sz = self.sy = npts + 2 * p
        h = np.broadcast_to(np.asarray(h, np.float64), (3,))
        K1 = np.asarray(K1, np.float64)
        M1 = np.asarray(M1, np.float64)
        self.Ks = [K1 / h[a] for a in range(3)]
        self.Ms = [M1 * h[a] for a in range(3)]

        device = torch.device(device)
        self.lib = None
        if device.type == "cuda":
            self.lib = load_kernels()["lab_resident"]
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.nbuf = 2 if kern_name == "v19" else 1
        self.tile = self.grid = self.smem = None
        if self.lib is not None:
            self.tile = tuple(tile) if tile is not None else choose_tile(
                p, self.xp, self.nbuf, self.X,
                self.lib.lib.tpufem_lab_smem_bytes)
            self.smem = self.lib.lib.tpufem_lab_smem_bytes(
                p, self.xp, self.nbuf, *self.tile, self.X)
            if not 0 < self.smem <= 227 * 1024 or \
                    (self.tile[0] * self.tile[1]) % MMA[self.xp][0]:
                raise ValueError(f"lab tile {self.tile} does not fit")
            ntiles = (-(-npts // self.tile[0])) * (-(-npts // self.tile[1]))
            # v19's persistent blocks: as many as fit on the card at once
            props = torch.cuda.get_device_properties(device)
            per_sm = max(1, (228 * 1024) // (self.smem + 1024))
            self.grid = min(ntiles, props.multi_processor_count * per_sm)
        self.tables = torch.as_tensor(
            band_tables([self.Ks[1], self.Ms[1], self.Ks[2], self.Ms[2]], p),
            dtype=dtype, device=device)
        xkm = torch.as_tensor(x_operator(self.Ks[0], self.Ms[0], self.X),
                              dtype=dtype, device=device)
        if self.xp == XBF16X3:
            hi = xkm.to(torch.bfloat16)
            self.xk, self.xk_lo = hi, (xkm - hi.to(dtype)).to(torch.bfloat16)
        else:
            self.xk, self.xk_lo = xkm, None
        n_mma, k_mma = MMA[self.xp][1], MMA[self.xp][2]
        self.windows = torch.as_tensor(x_windows(self.X, p, n_mma, k_mma),
                                       device=device)
        pk, pm = _ablation_operators(self.Ks, self.Ms, mode)
        self._plain_K = [torch.tensor(K, dtype=dtype, device=device)
                         for K in pk]
        self._plain_M = [torch.tensor(M, dtype=dtype, device=device)
                         for M in pm]

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat (npts**3,) vector -> resident layout in the storage dtype."""
        n, p = self.npts, self.p
        gp = torch.zeros((self.sz, self.sy, self.X), dtype=self.dt,
                         device=u.device)
        gp[p:p + n, p:p + n, :n] = u.reshape(n, n, n)
        return gp

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        n, p = self.npts, self.p
        return gp[p:p + n, p:p + n, :n].reshape(-1)

    def plain(self, gp: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of ``raw`` for this mode: the dense
        separable contraction on the unpadded grid, re-padded (copy: the
        data itself)."""
        u = self.unpad(gp).to(self.dt)
        if self.mode != "copy":
            u = laplace_apply_separable(u, 3, self.npts, self._plain_K,
                                        self._plain_M)
        return self.pad(u)

    def raw(self, gp: torch.Tensor) -> torch.Tensor:
        """y = A u on the resident layout (halo and padding zeros out)."""
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp)
        if gp.device != self.device or not gp.is_cuda:
            raise ValueError(f"kernel on {self.device} got a tensor on "
                             f"{gp.device}")
        if gp.dtype != self.dt or not gp.is_contiguous() or \
                tuple(gp.shape) != (self.sz, self.sy, self.X):
            raise ValueError(f"kernel takes a contiguous {self.dt} layout "
                             f"{(self.sz, self.sy, self.X)}, got "
                             f"{gp.dtype} {tuple(gp.shape)}")
        y = torch.empty_like(gp)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.lib.lib.tpufem_lab_apply(
                int(self.kern_name[1:]), self.xp, self.p, MODES[self.mode],
                self.npts, self.sz, self.sy, self.X, *self.tile, self.grid,
                gp.data_ptr(), y.data_ptr(), self.tables.data_ptr(),
                self.xk.data_ptr(),
                None if self.xk_lo is None else self.xk_lo.data_ptr(),
                self.windows.data_ptr(), stream)
        self.lib.check(rc, f"tpufem_lab_apply {self.kern_name} launch")
        V17Kernel.launches[self.kern_name] += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.unpad(self.raw(self.pad(u)))

    def emulate(self, gp: torch.Tensor) -> torch.Tensor:
        """``raw`` in the kernel's arithmetic, in plain PyTorch (f32
        storage, mode "f32" or "bf16"): the z/y band stages as the kernel
        runs them (``band_fma``: its f32 tables, its taps in its order, one
        f32 rounding per multiply-add), so ``qq`` is the kernel's; both
        operands of the x stage split as the kernel splits them (3xTF32:
        big + small; 1xTF32: one rounding; bf16x3: hi + lo, lo*lo dropped);
        each product an f32 matmul of the split parts, which are exact in
        f32, summed in f32.  It differs from the kernel only in the order
        of the x stage's f32 sums."""
        if self.dt != torch.float32 or self.mode not in ("f32", "bf16"):
            raise ValueError("emulate: f32 storage, mode 'f32' or 'bf16'")
        n, X = self.npts, self.X
        wky, wmy, wkz, wmz = self.tables.to(gp.device)  # Ky, My, Kz, Mz
        u = self.unpad(gp).to(torch.float32).reshape(n, n, n)  # (z, y, x)
        s, t = band_fma(wmz, u, 0), band_fma(wkz, u, 0)
        q1 = band_fma(wmy, s, 1)
        q23 = band_fma(wky, s, 1) + band_fma(wmy, t, 1)
        qq = torch.zeros((n * n, 2 * X), dtype=torch.float32,
                         device=gp.device)
        qq[:, :n] = q1.reshape(n * n, n)
        qq[:, X:X + n] = q23.reshape(n * n, n)
        if self.xp == XBF16X3:
            bf = lambda a: a.to(torch.bfloat16).to(torch.float32)
            ah = bf(qq)
            al = bf(qq - ah)
            bh, bl = (self.xk.to(torch.float32).to(gp.device),
                      self.xk_lo.to(torch.float32).to(gp.device))
            out = al @ bh + ah @ bl + ah @ bh
        else:
            b = self.xk.to(gp.device)
            a, b_b = tf32(qq), tf32(b)
            a_s, b_s = tf32(qq - a), tf32(b - b_b)
            out = (a @ b_b if self.xp == X1TF32
                   else a_s @ b_b + a @ b_s + a @ b_b)
        return self.pad(out[:, :n].reshape(-1))

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time an H100 could take
        for the function ``raw`` computes, whatever its design: each DoF
        read and written once, and the band operations the function needs
        (2p+1 multiply-adds per band output: 7 bands per DoF for the
        operator, as K1; 4 for the bands ablation, 1 for mm, 0 for copy)
        (``utils.timer.roofline_ms``)."""
        bands = {"f32": 7, "bf16": 7, "bands": 4, "mm": 1, "copy": 0}
        return operator_bound(self.npts, self.p, bands[self.mode], self.dt)

    def design_bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time an H100 could take
        for what this design does: the padded layout read and written and
        the tables and x operator read once; 5 band stages on CUDA cores;
        the x product on tensor cores, every pass of its split over the
        data rows (dense: K = 2X; v20: its windows)."""
        n, X, p = self.npts, self.X, self.p
        item = torch.empty((), dtype=self.dt).element_size()
        nbytes = (2 * self.sz * self.sy * X * item
                  + self.tables.numel() * item + self.xk.numel()
                  * self.xk.element_size() * (2 if self.xk_lo is not None
                                              else 1))
        bands = 0 if self.mode in ("copy", "mm") else 10 * (2 * p + 1) * n**3
        if self.mode in ("copy", "bands"):
            k_rows = 0
        elif self.kern_name == "v20":
            w = self.windows.cpu().numpy()
            k_rows = 2 * int((w[:, 1] - w[:, 0]).sum()) * MMA[self.xp][1] / X
        else:
            k_rows = 2 * X
        passes = {X3TF32: 3, X1TF32: 1, XBF16X3: 3, XF64: 1}[self.xp]
        mma = {X3TF32: "tf32", X1TF32: "tf32", XBF16X3: "bf16",
               XF64: "fp64_tensor"}[self.xp]
        return roofline_ms(nbytes, {
            "fp64" if self.xp == XF64 else "fp32": bands,
            mma: passes * 2.0 * n * n * k_rows * X})


def band_fma(tab: torch.Tensor, v: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernels' band stage (``band`` in csrc/common.cuh) along tensor
    dim ``dim`` of the f32 tensor v, in their arithmetic: output g is
    sum_o W[g,o] (v[g+o-p] - v[g]) + R[g] v[g] with the f32 table row
    ``tab[g] = (W[g, 0..2p], R[g])``, v zero outside the axis, the taps
    taken in order o = 0..2p from a zero accumulator, each difference an
    f32 subtraction and each multiply-add rounded once to f32, as the FMA
    the kernel compiles to (computed in f64, where the product of two f32
    values is exact, then rounded)."""
    n = v.shape[dim]
    p = (tab.shape[1] - 2) // 2
    v = v.movedim(dim, -1)
    vp = torch.nn.functional.pad(v, (p, p))
    W = tab.to(torch.float64)
    vc = v.to(torch.float64)
    acc = torch.zeros_like(v)
    for o in range(2 * p + 1):
        d = (vp[..., o:o + n] - v).to(torch.float64)
        acc = (acc.to(torch.float64) + W[:, o] * d).to(torch.float32)
    out = (acc.to(torch.float64) + W[:, 2 * p + 1] * vc).to(torch.float32)
    return out.movedim(-1, dim)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10-bit mantissa, ties away from zero),
    as ``wmma::__float_to_tf32``."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)
