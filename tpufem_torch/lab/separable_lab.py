"""The K2 kernel lab (L2): host side and wrappers of its fourteen kernels.

Port of ``scripts/kernel_lab.py::LabKernel`` (:1461), K2's 3D Laplace
operator (the ablations: their own functions) on the lab's padded layout,
in two CUDA routines:

- the x-first half (L2a), ``_kernel_v2`` (:47), ``_kernel_v3`` (:78),
  ``_kernel_v6`` (:106), ``_kernel_v8`` (:132), ``_kernel_vx`` (:164),
  ``_kernel_vxy`` (:177), ``_kernel_v9`` (:212) and ``_kernel_v12`` (:237):
  x first, then y, then z; each axis stage dense (a tensor-core product) or
  band (CUDA cores).  ``tpufem_torch/csrc/lab_separable.cuh``.
- the z/y-first half (L2b), ``_kernel_v13`` (:302), ``_kernel_v14`` (:359),
  ``_kernel_v15`` (:431), ``_kernel_vcopy`` (:500), ``_kernel_vband`` (:525)
  and ``_kernel_v16`` (:1347): band z, band y on the halo'd tile, then the x
  axis last, as two tensor-core products (v13; v14 with the next load in
  flight), one K-stacked product (v15) or a band (v16); vcopy and vband are
  the all-band schedule's loads and stores, and its band stages, alone.  A
  block owns a (TZ, TY) sub-tile of the output rows (``tile``; b sets the
  layouts only).  ``tpufem_torch/csrc/lab_zyfirst.cuh``: v13-v15 keep qq =
  [q1 | q23] over all of x in shared memory for the tensor-core product;
  v16, vcopy and vband run one routine (a mode argument) that moves its
  halo'd boxes by TMA through an ``mbarrier`` ring and keeps only a window
  of q1 and q23, so its sub-tile is (8, 8) where v15's is (2, 8).

Layout in: ``(size, size, X)``, ``size = nt b + 2p``, data at ``[p:p+npts,
p:p+npts, :npts]``, zeros elsewhere, ``X`` = npts rounded up to 16 (the
MMA tile; the TPU's 128-lane padding and v3's 128-lane halo are Mosaic
machinery and are not ported).  Layout out: ``(nt b, nt b, X)``, data at
``[:npts, :npts, :npts]``; ``__call__`` = unpad(raw(pad(u))).  The band
stages take K2's exact per-row tables in difference form
(``kernel_separable.band_tables``), so the periodic tables and deficit
corrections of v12-v16 (``_periodic_band``, ``corr_y``/``corr_z``) are not
ported and those variants take any b.

``LabKernel.raw`` on a CUDA tensor launches the kernel (or raises); on a
CPU tensor it runs ``plain``.  Launches are counted per variant in the
class attribute ``launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufem_torch.lab.resident_lab import (
    MMA,
    X_ALIGN,
    band_fma,
    operator_bound,
    tf32,
    x_operator,
)
from tpufem_torch.ops.kernel_separable import band_tables
from tpufem_torch.ops.separable import laplace_apply_separable
from tpufem_torch.utils.build import load_kernels
from tpufem_torch.utils.timer import roofline_ms

XFIRST = ("v2", "v3", "v6", "v8", "v9", "v12", "vx", "vxy")  # L2a
ZYFIRST = ("v13", "v14", "v15", "v16", "vcopy", "vband")  # L2b
VARIANTS = XFIRST + ZYFIRST
# stage flags of the CUDA routine (L2Flags; cut << 3); XJOBS: the dense x
# stage of the first version (per-warp jobs, B from device memory), kept as
# an ablation beside the ring (``LabKernel(..., x_jobs=True)``)
XBAND, YZBAND, TRANS, XJOBS = 1, 2, 4, 32
XC = 16  # x columns of a block's output box (kL2XC)
MAX_LP = 32  # halo'd rows b + 2p, rounded up to 16, the x ring takes (kL2MaxLP)
FLAGS = {"v2": 0, "v6": 0, "v9": 0, "v3": XBAND, "v12": YZBAND, "v8": TRANS,
         "vx": 1 << 3, "vxy": 2 << 3}
# the L2b routine's arguments per variant: (mode, two, nu): mode full (0),
# copy (1), bands (2) or x by bands (4, kZyXBand); two: the x stage as two
# products into one accumulator; nu: u slots (2: the next chunk's load in
# flight)
ZY_ARGS = {"v13": (0, 1, 1), "v14": (0, 1, 2), "v15": (0, 0, 2),
           "vcopy": (1, 0, 2), "vband": (2, 0, 2), "v16": (4, 0, 2)}
NO_MMA = ("v16", "vcopy", "vband")  # no tensor-core stage: prec is moot
# dense-stage precision codes (LabXPrec): 3xTF32, 1xTF32, bf16x3, f64
# (DMMA), one bf16 product
X3TF32, X1TF32, XBF16X3, XF64, XBF16 = 0, 1, 2, 3, 4
PRECS = {"highest": X3TF32, "high": X1TF32, "bf16x3": XBF16X3,
         "default": XBF16}
# each precision's class against the f64 plain version (max |error| /
# max |y| on a random input): the emulation of its arithmetic stays inside
# it on the CPU (tests/test_torch_lab_separable.py::test_emulated_classes:
# worst 2.9e-7, 1.1e-3, 1.5e-5, 7.4e-3), and a kernel stays within EMU_TOL
# of the emulation on its own input: the tensor cores' f32 sums and the
# emulation's f64 ones differ by up to ~1.0e-6 of max |y| in 3xTF32 and
# ~1.0e-5 in bf16x3 (an H100, p = 1..8 and 17M DoFs), so 3xTF32 is held to
# its class, bf16x3 to 2e-5, 1xTF32 and one bf16 product to their classes
TOL = {XF64: 1e-12, X3TF32: 2e-6, X1TF32: 4e-3, XBF16X3: 5e-5, XBF16: 3e-2}
EMU_TOL = {X3TF32: 2e-6, X1TF32: 4e-3, XBF16X3: 2e-5, XBF16: 3e-2}
ZC = 8  # halo'd z rows per x/y pass (kL2ZC)
TILES = (24, 16, 8)  # tile sizes b tried in order; 24 is the JAX lab's
SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may use on an H100
# L2b's (TZ, TY) sub-tiles, tried in order: first under the budget of two
# blocks an SM (L1's sweeps: occupancy decides before halo traffic), then
# under SMEM_BUDGET.  v13-v15 (qq over all of x): M = TZ*TY must be a
# multiple of the MMA tile's M.  v16, vcopy, vband (a window of qq): eight
# warps share the sub-tile in pieces of an even number of rows
# (``zy_ring_takes``); (8, 8) re-reads its halo 4x at p = 4, (4, 16) 4.5x,
# (4, 8) 6x, (2, 8) 10x
ZY_TILES = ((2, 8), (1, 16), (1, 8))
ZY_RING_TILES = ((8, 8), (4, 16), (4, 8), (2, 8), (1, 16))
ZY_TWO_BLOCKS = 113 * 1024  # (228 KB - 2 x 1 KB reserved) / 2
MAX_DEGREE = 8


def tile_slices(M1: np.ndarray, b: int, n_tiles: int, p: int) -> np.ndarray:
    """(n_tiles b, b + 2p) rows of M1 seen from each tile's halo'd window:
    ``out[t b + i, j] = M1[t b + i, t b + j - p]`` (0 outside).  Copy of
    ``scripts/kernel_lab.py::_tile_slices``."""
    npts = M1.shape[0]
    size = n_tiles * b + 2 * p
    Mp = np.zeros((size, size))
    Mp[p:p + npts, p:p + npts] = M1
    out = np.empty((n_tiles * b, b + 2 * p))
    for t in range(n_tiles):
        out[t * b:(t + 1) * b] = Mp[
            t * b + p:(t + 1) * b + p, t * b:(t + 1) * b + 2 * p]
    return out


def round16(v: int) -> int:
    return -(-v // 16) * 16


def dense_slices(mats, b: int, nt: int, p: int, trans: bool) -> np.ndarray:
    """(len(mats), nt, MB, LP) f64 tile slices, rows zero-padded to MB = b
    and columns to LP = b + 2p rounded up to 16 (trans: (.., LP, MB), each
    slice transposed), as the CUDA routine reads them."""
    MB, LP = round16(b), round16(b + 2 * p)
    out = np.zeros((len(mats), nt, MB, LP))
    for a, M in enumerate(mats):
        out[a, :, :b, :b + 2 * p] = tile_slices(M, b, nt, p).reshape(
            nt, b, b + 2 * p)
    return np.ascontiguousarray(out.transpose(0, 1, 3, 2) if trans else out)


def x_blocks(Mx: np.ndarray, Kx: np.ndarray, X: int) -> np.ndarray:
    """(X / XC, 2 XC, X) f64: per block of XC x columns the rows of Mx, then
    of Kx, zero-padded to X: the dense x stage's B operand, K-major (a row
    of the matrix is a column of the product's B)."""
    n = Mx.shape[0]
    out = np.zeros((2, X, X))
    out[0, :n, :n], out[1, :n, :n] = Mx, Kx
    return np.ascontiguousarray(
        out.reshape(2, X // XC, XC, X).transpose(1, 0, 2, 3)).reshape(
            X // XC, 2 * XC, X)


def choose_b(p: int, xp: int, smem_bytes=None, flags: int = 0) -> int:
    """The first of ``TILES`` whose block fits SMEM_BUDGET by the routine's
    own count ``smem_bytes(p, xp, b, flags)`` (``tpufem_l2_smem_bytes``)
    and, for a variant on the dense x stage's ring, whose halo'd rows fit
    its accumulators (``MAX_LP``); without a count (a CPU instance, which
    runs the plain version) the second condition alone."""
    ring = not flags & (XBAND | XJOBS)
    for b in TILES:
        if ring and round16(b + 2 * p) > MAX_LP:
            continue
        if smem_bytes is None or smem_bytes(p, xp, b, flags) <= SMEM_BUDGET:
            return b
    raise ValueError(f"no lab tile fits {SMEM_BUDGET} bytes of shared memory "
                     f"at p={p}")


def choose_zy_tile(p: int, xp: int, nu: int, X: int, smem_bytes, mode=0):
    """The first sub-tile whose block fits ZY_TWO_BLOCKS, else SMEM_BUDGET,
    by the routine's own count ``smem_bytes(mode, p, xp, nu, tz, ty, X)``
    (``tpufem_zy_smem_bytes``): of ``ZY_TILES`` (M a multiple of the MMA
    tile's) for mode 0 (v13-v15), of ``ZY_RING_TILES`` for the all-band
    modes (vcopy, vband, v16)."""
    m_mma = MMA[XBF16X3 if xp == XBF16 else xp][0] if mode == 0 else 1
    for budget in (ZY_TWO_BLOCKS, SMEM_BUDGET):
        for tz, ty in (ZY_TILES if mode == 0 else ZY_RING_TILES):
            if (tz * ty) % m_mma == 0 and \
                    smem_bytes(mode, p, xp, nu, tz, ty, X) <= budget:
                return tz, ty
    raise ValueError(f"no L2b sub-tile fits {SMEM_BUDGET} bytes of shared "
                     f"memory at p={p}, X={X}")


def _split_bf16(a: torch.Tensor):
    """f32 -> (hi, lo) bf16 parts, hi + lo ~ a to 2^-16, as lab_put."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(a.dtype)).to(torch.bfloat16)


def _parts(a: torch.Tensor, xp: int):
    """The parts of an f32 operand a split-product multiplies, in f64: the
    TF32 big/small split (3xTF32), one TF32 rounding (1xTF32), bf16 hi/lo
    (bf16x3) or hi alone (bf16)."""
    f64 = lambda t: t.to(torch.float64)
    if xp in (XBF16X3, XBF16):
        hi, lo = _split_bf16(a)
        return (f64(hi), f64(lo)) if xp == XBF16X3 else (f64(hi),)
    big = tf32(a)
    return (f64(big), f64(tf32(a - big))) if xp == X3TF32 else (f64(big),)


def _split_product(a: torch.Tensor, b: torch.Tensor, xp: int, expr: str):
    """einsum(expr, a, b) in the kernel's arithmetic: both f32 operands
    split as the kernel splits them, the part products that it sums
    (3xTF32: small*big + big*small + big*big; bf16x3: lo*hi + hi*lo +
    hi*hi; one pass otherwise) each in f64."""
    pa, pb = _parts(a, xp), _parts(b, xp)
    out = torch.einsum(expr, pa[0], pb[0])
    if len(pa) == 2:
        out = out + torch.einsum(expr, pa[1], pb[0]) \
            + torch.einsum(expr, pa[0], pb[1])
    return out


class LabKernel:
    """An L2 kernel (``variant`` one of VARIANTS) on the lab's padded
    layout: ``pad``/``unpad`` between flat vectors and the layouts, ``raw``
    on the layout, ``__call__`` = unpad(raw(pad(u))).

    K1, M1: (npts, npts) unscaled 1D matrices (``global_1d_matrices``); h:
    the cell size per axis (x first), so the axis operators are K1/h[a]
    and M1*h[a].  ``prec`` (the JAX lab's names) sets every dense stage's
    arithmetic: "highest" 3xTF32 (float32) or DMMA (float64), "high" one
    TF32 product, "default" one bf16 product (the hi*hi term of bf16x3);
    "bf16x3" names v9's arithmetic, which v9 takes whatever ``prec``
    says, as in JAX.  v6 runs v2's kernel (the two differ only in Mosaic's
    layout of the same contractions); v8 stages the y/z intermediates
    transposed.  b: the tile (None: the first of TILES that fits; for an
    L2b variant TILES[0], as b only sets its layouts).  tile: an L2b
    variant's (TZ, TY) sub-tile (None: ``choose_zy_tile``).  v16, vcopy and
    vband have no tensor-core stage and take "highest" whatever ``prec``
    says.  x_jobs: run the dense x stage of an L2a variant as the first
    version did (an ablation, timed beside the ring).
    """

    launches = {v: 0 for v in VARIANTS}  # per variant; plain excluded

    def __init__(self, variant, npts, p, K1, M1, h, b=None, prec="highest",
                 dtype=torch.float32, device="cuda", tile=None,
                 x_jobs=False):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, got "
                             f"{variant!r}")
        if prec not in PRECS:
            raise ValueError(f"prec must be one of {tuple(PRECS)}, got "
                             f"{prec!r}")
        if not 1 <= p <= MAX_DEGREE:
            raise ValueError(f"the CUDA routine is instantiated for p = "
                             f"1..{MAX_DEGREE}, got p = {p}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if variant == "v9":
            prec = "bf16x3"
        if variant in NO_MMA:
            prec = "highest"
        if dtype == torch.float64 and prec != "highest":
            raise ValueError("float64 runs the exact dense stages only (prec "
                             "'highest', not v9)")
        self.variant, self.npts, self.p, self.prec, self.dt = (
            variant, npts, p, prec, dtype)
        self.xp = XF64 if dtype == torch.float64 else PRECS[prec]
        self.zy = variant in ZYFIRST
        self.flags = None if self.zy else FLAGS[variant] | (
            XJOBS if x_jobs and not FLAGS[variant] & XBAND else 0)
        h = np.broadcast_to(np.asarray(h, np.float64), (3,))
        K1, M1 = np.asarray(K1, np.float64), np.asarray(M1, np.float64)
        self.Ks = [K1 / h[a] for a in range(3)]
        self.Ms = [M1 * h[a] for a in range(3)]

        device = torch.device(device)
        self.lib = None
        if device.type == "cuda":
            self.lib = load_kernels()["lab_zyfirst" if self.zy
                                      else "lab_separable"]
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.smem = self.tile = None
        self.X = X_ALIGN * -(-npts // X_ALIGN)
        if b is None:
            b = TILES[0] if self.zy else choose_b(
                p, self.xp, self.lib and self.lib.lib.tpufem_l2_smem_bytes,
                self.flags)
        if self.zy:
            self.tile = None if tile is None else tuple(tile)
            if self.lib is not None:
                count = self.lib.lib.tpufem_zy_smem_bytes
                mode, _, nu = ZY_ARGS[variant]
                if self.tile is None:
                    self.tile = choose_zy_tile(p, self.xp, nu, self.X, count,
                                               mode)
                if mode and not self.lib.lib.tpufem_zy_ring_takes(
                        p, *self.tile):
                    raise ValueError(f"{variant} takes no sub-tile "
                                     f"{self.tile} at p={p}: its eight warps "
                                     f"share it in pieces of an even number "
                                     f"of rows")
                self.smem = count(mode, p, self.xp, nu, *self.tile, self.X)
        elif self.lib is not None:
            if not self.flags & (XBAND | XJOBS) and \
                    round16(b + 2 * p) > MAX_LP:
                raise ValueError(f"the dense x stage takes b + 2p <= "
                                 f"{MAX_LP}, got b={b}, p={p}")
            self.smem = self.lib.lib.tpufem_l2_smem_bytes(p, self.xp, b,
                                                          self.flags)
        if self.smem is not None and not 0 < self.smem <= 227 * 1024:
            raise ValueError(f"lab tile b={b}, sub-tile {self.tile} needs "
                             f"{self.smem} bytes of shared memory")
        self.b, self.nt = b, -(-npts // b)
        self.size, self.L = self.nt * b + 2 * p, b + 2 * p

        def put(a):  # kernel operand: C, or bf16 hi then lo (lo offset)
            t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)
            if self.xp not in (XBF16X3, XBF16):
                return t, 0
            hi, lo = _split_bf16(t)
            return torch.stack([hi, lo]).contiguous(), t.numel()

        if self.zy:  # [Kx^T; Mx^T] (2X, X); tables Ky, My, Kz, Mz, Kx, Mx
            self.xk, self.xk_lo = put(x_operator(self.Ks[0], self.Ms[0],
                                                 self.X))
            order = [self.Ks[1], self.Ms[1], self.Ks[2], self.Ms[2],
                     self.Ks[0], self.Ms[0]]
        else:
            xk = np.zeros((self.X, 2 * self.X))
            xk[:npts, :npts] = self.Ms[0].T
            xk[:npts, self.X:self.X + npts] = self.Ks[0].T
            self.xk, self.xk_lo = put(xk)
            # the ring's B operand, split here with the kernel's roundings
            xb = torch.as_tensor(x_blocks(self.Ms[0], self.Ks[0], self.X),
                                 dtype=dtype, device=device)
            if self.xp in (XBF16X3, XBF16):
                xb = torch.stack(_split_bf16(xb))
            elif self.xp == X3TF32:
                xb = torch.stack([tf32(xb), tf32(xb - tf32(xb))])
            elif self.xp == X1TF32:
                xb = tf32(xb)
            self.xb = xb.contiguous()
            self.xb_part = xb[0].numel() if xb.dim() == 4 else 0
            self.slices, self.sl_lo = put(dense_slices(
                [self.Ms[1], self.Ks[1], self.Ms[2], self.Ks[2]], b, self.nt,
                p, bool(self.flags & TRANS)))
            order = [self.Ms[0], self.Ks[0], self.Ms[1], self.Ks[1],
                     self.Ms[2], self.Ks[2]]
        self.tables = torch.as_tensor(band_tables(order, p), dtype=dtype,
                                      device=device)
        pk, pm = self._operators()
        self._plain_K = [torch.tensor(K, device=device) for K in pk]  # f64
        self._plain_M = [torch.tensor(M, device=device) for M in pm]

    def _operators(self):
        """Per-axis (Ks, Ms) whose ``laplace_apply_separable`` is this
        variant's function before its shift: the operator; vx (Mx + Kx)
        along x; vxy (My + Ky)(x)Mx + My(x)Kx; vcopy the identity; vband
        the band stages alone, q1 + q2 + q3 = Mz(x)My + Mz(x)Ky + Kz(x)My
        per x column (the x operators the identity)."""
        n = self.npts
        eye, zero = np.eye(n), np.zeros((n, n))
        Ks, Ms = self.Ks, self.Ms
        if self.variant == "vx":
            return [Ks[0] + Ms[0], zero, zero], [eye, eye, eye]
        if self.variant == "vxy":
            return [Ks[0], Ks[1], eye], [Ms[0], Ms[1], eye]
        if self.variant == "vcopy":
            return [eye, zero, zero], [eye, eye, eye]
        if self.variant == "vband":
            return [eye, Ks[1], Ks[2]], [eye, Ms[1], Ms[2]]
        return Ks, Ms

    def _place(self, f: torch.Tensor) -> torch.Tensor:
        """(npts,)*3 grid -> the output layout: vx shifted by p rows in z
        and y, vxy by p in z, as the ablations crop the halo'd tile's first
        b rows; rows past nt b are dropped."""
        n, p, NT = self.npts, self.p, self.nt * self.b
        sz = p if self.variant in ("vx", "vxy") else 0
        sy = p if self.variant == "vx" else 0
        y = torch.zeros((NT, NT, self.X), dtype=f.dtype, device=f.device)
        y[sz:sz + n, sy:sy + n, :n] = f[:NT - sz, :NT - sy]
        return y

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat (npts**3,) vector -> the input layout in the storage dtype."""
        n, p = self.npts, self.p
        gp = torch.zeros((self.size, self.size, self.X), dtype=self.dt,
                         device=u.device)
        gp[p:p + n, p:p + n, :n] = u.reshape(n, n, n)
        return gp

    def unpad(self, y: torch.Tensor) -> torch.Tensor:
        """The output layout -> flat (npts**3,): ``y[:npts, :npts, :npts]``
        (``kernel_lab.py:1607``)."""
        n = self.npts
        return y[:n, :n, :n].reshape(-1)

    def plain(self, gp: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of ``raw``: the variant's function by
        the dense separable contraction on the unpadded grid, placed in the
        output layout; in the storage dtype, or in float64 when given a
        float64 layout (the reference the kernels are held to)."""
        n, p = self.npts, self.p
        dt = torch.float64 if gp.dtype == torch.float64 else self.dt
        u = gp[p:p + n, p:p + n, :n].reshape(-1).to(dt)
        f = laplace_apply_separable(u, 3, n,
                                    [K.to(dt) for K in self._plain_K],
                                    [M.to(dt) for M in self._plain_M])
        return self._place(f.reshape(n, n, n))

    def raw(self, gp: torch.Tensor, out=None) -> torch.Tensor:
        """The variant's function on the layouts (input -> output); out: a
        contiguous output layout to write into (a check fills it with NaN
        first: every point is written)."""
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp) if out is None else out.copy_(
                self.plain(gp))
        if gp.device != self.device or not gp.is_cuda:
            raise ValueError(f"kernel on {self.device} got a tensor on "
                             f"{gp.device}")
        if gp.dtype != self.dt or not gp.is_contiguous() or \
                tuple(gp.shape) != (self.size, self.size, self.X):
            raise ValueError(f"kernel takes a contiguous {self.dt} layout "
                             f"{(self.size, self.size, self.X)}, got "
                             f"{gp.dtype} {tuple(gp.shape)}")
        NT = self.nt * self.b
        y = out
        if y is None:
            y = torch.empty((NT, NT, self.X), dtype=self.dt,
                            device=self.device)
        elif y.device != self.device or y.dtype != self.dt or \
                not y.is_contiguous() or tuple(y.shape) != (NT, NT, self.X):
            raise ValueError(f"out must be a contiguous {self.dt} layout "
                             f"{(NT, NT, self.X)} on {self.device}")
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            if self.zy:
                lo = self.xk.data_ptr() + self.xk_lo * self.xk.element_size()
                rc = self.lib.lib.tpufem_zy_apply(
                    *ZY_ARGS[self.variant], self.xp, self.p, self.npts,
                    self.size, self.X, *self.tile, gp.data_ptr(),
                    y.data_ptr(), self.tables.data_ptr(), self.xk.data_ptr(),
                    lo, stream)
            else:
                rc = self.lib.lib.tpufem_l2_apply(
                    self.flags, self.xp, self.p, self.npts, self.b, self.nt,
                    self.size, self.X, gp.data_ptr(), y.data_ptr(),
                    self.xk.data_ptr(), self.xk_lo, self.xb.data_ptr(),
                    self.xb_part, self.slices.data_ptr(),
                    self.sl_lo, self.tables.data_ptr(), stream)
        self.lib.check(rc, f"{self.variant} launch")
        LabKernel.launches[self.variant] += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.unpad(self.raw(self.pad(u)))

    def emulate(self, gp: torch.Tensor) -> torch.Tensor:
        """``raw`` in the kernel's arithmetic, in plain PyTorch (f32
        storage): each dense stage a split product of f32 operands, the
        part products in f64 (``_split_product``), rounded to f32 at the
        stage's end as the kernel's shared-memory intermediates; each band
        stage as the kernel runs it (``band_fma``: its f32 tables, its taps
        in its order, one f32 rounding per multiply-add).  It differs from
        the kernel in the order and precision of the dense stages' sums."""
        if self.dt != torch.float32 or self.variant in NO_MMA:
            raise ValueError("emulate: f32 storage, a variant with a "
                             "tensor-core stage")
        n, p, dev = self.npts, self.p, gp.device
        f32 = lambda t: t.to(torch.float32)
        f64 = lambda M: torch.as_tensor(M, dtype=torch.float64, device=dev)
        m32 = lambda M: f32(f64(M))  # the f32 operand the kernel reads
        tab = self.tables.to(dev)
        u = gp[p:p + n, p:p + n, :n].to(torch.float32)  # (z, y, x)
        Mx, Kx, My, Ky, Mz, Kz = (self.Ms[0], self.Ks[0], self.Ms[1],
                                  self.Ks[1], self.Ms[2], self.Ks[2])
        if self.zy:  # bands z, y; then the x products
            wky, wmy, wkz, wmz = tab[:4]
            s, t = band_fma(wmz, u, 0), band_fma(wkz, u, 0)
            q1 = band_fma(wmy, s, 1)
            q23 = band_fma(wky, s, 1) + band_fma(wmy, t, 1)
            return self._place(f32(
                _split_product(q1, m32(Kx), self.xp, "zyx,ox->zyo")
                + _split_product(q23, m32(Mx), self.xp, "zyx,ox->zyo")))
        wmx, wkx, wmy, wky, wmz, wkz = tab
        if self.flags & XBAND:
            ax, gx = band_fma(wmx, u, 2), band_fma(wkx, u, 2)
        else:
            ax = f32(_split_product(u, m32(Mx), self.xp, "zyx,ox->zyo"))
            gx = f32(_split_product(u, m32(Kx), self.xp, "zyx,ox->zyo"))
        if self.variant == "vx":
            return self._place(ax + gx)
        if self.flags & YZBAND:
            t1 = band_fma(wmy, ax, 1)
            t2 = band_fma(wky, ax, 1) + band_fma(wmy, gx, 1)
        else:
            sp = lambda M, t: _split_product(m32(M), t, self.xp,
                                             "by,zyx->zbx")
            t1, t2 = f32(sp(My, ax)), f32(sp(Ky, ax) + sp(My, gx))
        if self.variant == "vxy":
            return self._place(t1 + t2)
        if self.flags & YZBAND:
            return self._place(band_fma(wkz, t1, 0) + band_fma(wmz, t2, 0))
        sp = lambda M, t: _split_product(m32(M), t, self.xp, "az,zyx->ayx")
        return self._place(f32(sp(Kz, t1) + sp(Mz, t2)))

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time an H100 could take
        for the function ``raw`` computes, whatever its design: each DoF
        read and written once, 2p+1 multiply-adds per band output: 7 band
        outputs per DoF for the operator (K2's), 1 for vx ((Mx + Kx) u), 4
        for vxy (Mx u, Kx u, (My + Ky) Mx u, My Kx u), 4 for vband (Mz u,
        Kz u, (My + Ky) Mz u, My Kz u), none for vcopy (bytes only)."""
        bands = {"vx": 1, "vxy": 4, "vband": 4, "vcopy": 0}.get(
            self.variant, 7)
        return operator_bound(self.npts, self.p, bands, self.dt)

    def l2_bytes(self) -> int:
        """Bytes one apply of a redesigned routine moves from L2 into shared
        memory, from its tile: the all-band routine's halo'd boxes ((TZ +
        2p)(TY + 2p) rows over X columns per sub-tile); the dense x stage's
        ring (per block and pass of ZC z rows: the tile's L halo'd rows over
        X columns and, for each of the block's x blocks of XC columns (vx:
        two; else one), the B operand's 2 XC rows over X, every part)."""
        item = torch.empty((), dtype=self.dt).element_size()
        p, X, NT = self.p, self.X, self.nt * self.b
        if self.zy:
            if self.variant not in NO_MMA or self.tile is None:
                raise ValueError("l2_bytes: vcopy, vband, v16 with a sub-tile")
            tz, ty = self.tile
            return (-(-NT // tz) * -(-NT // ty) * (tz + 2 * p) * (ty + 2 * p)
                    * X * item)
        if self.flags & (XBAND | XJOBS):
            raise ValueError("l2_bytes: a variant on the x stage's ring")
        zend = self.b if self.flags >> 3 & 3 else self.L
        nxb = 2 if self.flags >> 3 & 3 == 1 else 1
        parts = 2 if self.xp in (X3TF32, XBF16X3) else 1
        e = 2 if self.xp in (XBF16X3, XBF16) else item
        per_pass = ZC * self.L * X * item + nxb * parts * 2 * XC * X * e
        return (-(-(X // XC) // nxb) * self.nt**2 * -(-zend // ZC)
                * per_pass)

    def design_bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the least time an H100 could take
        for what this design does: the input layout read and the output
        layout written once; every dense stage's products over its padded
        rows (LP, MB), every pass of its split, on tensor cores; band stages
        on CUDA cores."""
        nt, b, X, p = self.nt, self.b, self.X, self.p
        L, LP, MB = self.L, round16(self.L), round16(b)
        item = torch.empty((), dtype=self.dt).element_size()
        nbytes = (self.size**2 + (nt * b)**2) * X * item
        passes = 3 if self.xp in (X3TF32, XBF16X3) else 1
        mma = {X3TF32: "tf32", X1TF32: "tf32", XBF16X3: "bf16",
               XBF16: "bf16", XF64: "fp64_tensor"}[self.xp]
        cuda_cores = "fp64" if self.xp == XF64 else "fp32"
        if self.zy:
            # 5 z/y band stages (v16: 2 x bands more) and the x product over
            # the (nt b)^2 rows of the output layout, K = 2X
            rows = (nt * b)**2
            mode = ZY_ARGS[self.variant][0]
            nbands = {0: 5, 1: 0, 2: 5, 4: 7}[mode]
            return roofline_ms(nbytes, {
                cuda_cores: nbands * 2 * (2 * p + 1) * rows * X,
                mma: passes * 2.0 * rows * 2 * X * X if mode == 0 else 0.0})
        zrows = L if self.variant not in ("vx", "vxy") else \
            min(L, -(-b // ZC) * ZC)
        tiles = nt * nt
        dense = band = 0.0
        nb = 2 * (2 * p + 1)  # flops of one band output
        if self.flags & XBAND:
            band += 2 * tiles * zrows * LP * X * nb
        else:
            dense += 2 * tiles * zrows * LP * X * X * 2
        if self.variant != "vx":
            if self.flags & YZBAND:
                band += 3 * tiles * zrows * b * X * nb
            else:
                dense += 3 * tiles * zrows * MB * LP * X * 2
        if self.variant not in ("vx", "vxy"):
            if self.flags & YZBAND:
                band += 2 * tiles * b * b * X * nb
            else:
                dense += 2 * tiles * MB * LP * MB * X * 2
        return roofline_ms(nbytes, {cuda_cores: band, mma: passes * dense})
