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

v17-v20 run the ring routines (``csrc/lab_resident_ring.cuh``: the z/y
bands fed by a TMA ring; v17 and v19 the x stage on wgmma over x chunks,
v19 warp-specialised and persistent; v20 v19's roles with the x stage
windowed, each 32-column block's products over the 48 rows a half of
``[Kx^T; Mx^T]`` its band needs, from a window of qq stages).  v18 is v17
with fused band stages; the ring's bands run ``band2`` (the fused
stages' two tables on one read of the input, ``band``'s arithmetic tap by
tap) on every chunk, so on the ring v18 is v17's launch
(``lab_ring_kernel``) and bit for bit its output.  The tile routine
(``lab_tile_kernel``, ``lab_pipe_kernel``) stays as their earlier
schedule, taken with ``routine="tile"`` (v18's with ``fused=1``).

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
# bf16x3, f64 (DMMA); one bf16 product (L2's "default", on the ring for v15)
X3TF32, X1TF32, XBF16X3, XF64, XBF16 = 0, 1, 2, 3, 4
# MMA tile (M, N, K) of each x-stage precision
MMA = {X3TF32: (16, 16, 8), X1TF32: (16, 16, 8), XBF16X3: (16, 16, 16),
       XF64: (8, 8, 4)}
X_ALIGN = 16  # x padding: a multiple of every MMA N and K
SMEM_BUDGET = 220 * 1024  # of the 227 KB a block may use on an H100
MAX_DEGREE = 8
# (TZ, TY) output tiles tried in order; M = TZ*TY must be a multiple of
# the MMA tile's M
TILES = ((2, 16), (4, 8), (2, 8), (1, 16), (1, 8))
# the ring routines (v17 and v18, v19; v20 windowed): sub-tiles of one
# wgmma M (64 rows), the least halo first; ring depths (u slots, B stages)
# tried in order, deepest first
RING_KERNELS = ("v17", "v18", "v19", "v20")
# the ring routine's variant number each kernel launches: v18 runs v17's
RING_VARIANT = {"v17": 17, "v18": 17, "v19": 19, "v20": 20}
RING_M = 64
RING_TILES = ((8, 8), (4, 16), (16, 4))
RING_DEPTHS = ((3, 2), (2, 2), (3, 1), (2, 1))
RING_BUDGET = 227 * 1024  # a block's shared memory on an H100
# per precision: x columns of a chunk, B parts, B element bytes, columns a
# block multiplies at most (lr_xc, lr_parts, lr_belem, lr_max_cols)
RING_XC = {X3TF32: 16, X1TF32: 16, XBF16X3: 16, XF64: 8, XBF16: 16}
RING_PARTS = {X3TF32: 2, X1TF32: 1, XBF16X3: 2, XF64: 1, XBF16: 1}
RING_MAX_COLS = {X3TF32: 320, X1TF32: 320, XBF16X3: 320, XF64: 160,
                 XBF16: 320}
NO_XSTAGE = ("copy", "bands")  # the ablations that run no x product
# v20's windowed x stage (lab_window_kernel): a 32-column block's window of
# 48 rows a half, [32 j - 8, 32 j + 40) (kLwLead, kLwRows: P <= 8), two B
# stages (kLwB), and (u slots, qq stages) tried in order, deepest first
WIN_N, WIN_LEAD, WIN_ROWS, WIN_B = 32, 8, 48, 2
WINDOW_DEPTHS = ((3, 8), (2, 8), (2, 7), (2, 6), (1, 6))


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


def ring_columns(xp: int, X: int, mode: str = "f32") -> tuple[int, int]:
    """(ncols, nsplit): the columns of the x operator a ring block
    multiplies (32-column blocks, as even as the splits allow) and the
    splits of X that the block's registers force.  The copy and bands
    ablations have no x stage: one split (the block's shared memory still
    the full mode's)."""
    nb32 = -(-X // 32)
    nsplit = -(-nb32 // (RING_MAX_COLS[xp] // 32))
    return 32 * -(-nb32 // nsplit), (1 if mode in NO_XSTAGE else nsplit)


def choose_ring(p: int, xp: int, X: int, nq: int, smem_bytes,
                tiles=RING_TILES, mode: str = "f32"):
    """(tile, nu, nb, ncols, nsplit) of the ring routine in ``mode``: the
    first of ``tiles`` and the deepest rings (``RING_DEPTHS``) whose block
    fits RING_BUDGET by the routine's own count ``smem_bytes(p, xp, tz, ty,
    nu, nb, nq, ncols)`` (``tpufem_lab_ring_smem_bytes``); nq: qq stages
    (v17 1, v19 2)."""
    ncols, nsplit = ring_columns(xp, X, mode)
    for tz, ty in tiles:
        if tz * ty != RING_M or max(tz, ty) + 2 * p > 256:
            continue
        for nu, nb in RING_DEPTHS:
            if smem_bytes(p, xp, tz, ty, nu, nb, nq, ncols) <= RING_BUDGET:
                return (tz, ty), nu, nb, ncols, nsplit
    raise ValueError(f"no ring block fits {RING_BUDGET} bytes of shared "
                     f"memory at p={p}, X={X}")


def choose_window(p: int, xp: int, smem_bytes, tiles=RING_TILES):
    """(tile, nu, nq) of v20's windowed routine: the first of ``tiles``
    and the deepest (u slots, qq stages) of ``WINDOW_DEPTHS`` whose block
    fits RING_BUDGET by the routine's own count ``smem_bytes(p, xp, tz, ty,
    nu, nq)`` (``tpufem_lab_window_smem_bytes``).  Its shared memory does
    not grow with X: every block holds one column block's window."""
    for tz, ty in tiles:
        if tz * ty != RING_M or max(tz, ty) + 2 * p > 256:
            continue
        for nu, nq in WINDOW_DEPTHS:
            if smem_bytes(p, xp, tz, ty, nu, nq) <= RING_BUDGET:
                return (tz, ty), nu, nq
    raise ValueError(f"no windowed ring block fits {RING_BUDGET} bytes of "
                     f"shared memory at p={p}")


def _operand_parts(xkm: torch.Tensor, xp: int) -> list:
    """The x operator split with the kernel's rounding: 3xTF32 big and
    small (``tf32``), 1xTF32 one rounding, bf16x3 hi and lo, one bf16
    product hi, f64 itself."""
    if xp in (XBF16X3, XBF16):
        hi = xkm.to(torch.bfloat16)
        return [hi] if xp == XBF16 else \
            [hi, (xkm - hi.to(xkm.dtype)).to(torch.bfloat16)]
    if xp == X3TF32:
        big = tf32(xkm)
        return [big, tf32(xkm - big)]
    return [tf32(xkm)] if xp == X1TF32 else [xkm]


def _b_layout(b: torch.Tensor, xp: int) -> torch.Tensor:
    """(..., n, K) B operands -> the kernel's layout, flat per operand:
    wgmma's K-major B (``hopper.cuh::hop_b_offset``: core matrices of 8
    columns by 16 bytes of k), f64 as WMMA's column-major B (each column's K
    values in turn)."""
    if xp != XF64:  # (n / 8, 8, k / E, E) -> (n / 8, k / E, 8, E)
        n, K = b.shape[-2:]
        e = 16 // b.element_size()
        b = b.reshape(*b.shape[:-2], n // 8, 8, K // e, e).transpose(-3, -2)
    return b.reshape(*b.shape[:-2] if xp == XF64 else b.shape[:-4], -1)


def window_operand(xkm: torch.Tensor, xp: int, X: int,
                   p: int) -> torch.Tensor:
    """The x operator ``[Kx^T; Mx^T]`` (2X, X) as v20's B stages, flat:
    (X / 32 column blocks, parts, stage) where block j's stage holds the 48
    rows x in [32 j - 8, 32 j + 40) of the Kx^T half, then of the Mx^T half
    (K = 96), for its 32 columns: the operator's rows inside the block's
    window ``x_windows(X, p, 32, 8)`` (clipped to [0, X)), zeros elsewhere
    and beyond X; split and laid out as ``ring_operand``'s."""
    nbl = -(-X // WIN_N)
    win = torch.as_tensor(x_windows(X, p, WIN_N, 8), dtype=torch.int64)
    kk = torch.arange(2 * WIN_ROWS)
    x = (torch.arange(nbl)[:, None] * WIN_N - WIN_LEAD
         + kk[None, :] % WIN_ROWS)  # (nbl, K)
    inside = (x >= win[:, :1]) & (x < win[:, 1:])
    rows = (x.clamp(0, X - 1) + kk[None, :] // WIN_ROWS * X).to(xkm.device)
    cols = torch.arange(nbl)[:, None] * WIN_N + torch.arange(WIN_N)[None, :]
    keep = (inside[:, :, None] & (cols < X)[:, None, :]).to(xkm.device)
    cols = cols.clamp(max=X - 1).to(xkm.device)
    out = []
    for part in _operand_parts(xkm, xp):
        b = part[rows[:, :, None], cols[:, None, :]]  # (nbl, K, n)
        b = torch.where(keep, b, torch.zeros((), dtype=b.dtype,
                                             device=b.device))
        out.append(_b_layout(b.transpose(1, 2).contiguous(), xp)[:, None])
    return torch.cat(out, 1).contiguous().reshape(-1)


def ring_operand(xkm: torch.Tensor, xp: int, X: int, ncols: int,
                 nsplit: int) -> torch.Tensor:
    """The x operator ``[Kx^T; Mx^T]`` (2X, X) as the ring routine's B
    stages, flat: (nsplit, X / XC chunks, parts, stage) where chunk c's
    stage holds rows [c XC, (c+1) XC) of the Kx^T half, then the same rows
    of the Mx^T half (K = 2 XC), for the split's ncols columns (zeros
    beyond X), split by ``_operand_parts`` and laid out by
    ``_b_layout``."""
    xc = RING_XC[xp]
    K, nchunk = 2 * xc, X // xc
    rows = (torch.arange(nchunk)[:, None] * xc + torch.arange(xc)[None, :])
    rows = torch.cat([rows, rows + X], 1).to(xkm.device)  # (nchunk, K)
    out = []
    for part in _operand_parts(xkm, xp):
        b = torch.zeros((2 * X, ncols * nsplit), dtype=part.dtype,
                        device=part.device)
        b[:, :X] = part
        b = b[rows].reshape(nchunk, K, nsplit, ncols).permute(2, 0, 3, 1)
        out.append(_b_layout(b.contiguous(), xp)[:, :, None])
    return torch.cat(out, 2).contiguous().reshape(-1)


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

    routine: "ring" (the default: ``lab_resident_ring.cuh``; v18 runs
    v17's ``lab_ring_kernel``, v20's is windowed, ``lab_window_kernel``) or
    "tile" (the first version, their earlier schedule).  tile: the output
    tile (the ring's: a sub-tile of 64 rows); the chooser's by default
    (``choose_ring``, ``choose_window``, ``choose_tile``).
    """

    launches = {name: 0 for name in KERNELS}  # per kernel; plain excluded

    def __init__(self, npts, p, K1, M1, h, mode="f32", prec="highest",
                 kern_name="v17", dtype=torch.float32, device="cuda",
                 tile=None, routine=None):
        if kern_name not in KERNELS:
            raise ValueError(f"kern_name must be one of {KERNELS}, got "
                             f"{kern_name!r}")
        if routine is None:
            routine = "ring" if kern_name in RING_KERNELS else "tile"
        if routine not in ("ring", "tile") or (
                routine == "ring" and kern_name not in RING_KERNELS):
            raise ValueError(f"routine must be 'tile', or 'ring' for "
                             f"{RING_KERNELS}; got {routine!r} for "
                             f"{kern_name}")
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
        self.kern_name, self.dt, self.routine = kern_name, dtype, routine
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
        self.tile = self.grid = self.smem = self.ring = None
        tiles = (tuple(tile),) if tile is not None else RING_TILES
        if self.lib is not None and routine == "ring" and kern_name == "v20":
            lib = self.lib.lib
            self.tile, nu, nq = choose_window(
                p, self.xp, lib.tpufem_lab_window_smem_bytes, tiles)
            self.ring = (nu, WIN_B, nq, WIN_N, 1)
            self.smem = lib.tpufem_lab_window_smem_bytes(p, self.xp,
                                                         *self.tile, nu, nq)
            bps = lib.tpufem_lab_ring_blocks_per_sm(
                20, self.xp, p, *self.tile, *self.ring[:4])
            if bps < 1:
                raise ValueError(f"the windowed ring's v20 block does not "
                                 f"fit an SM at p={p}")
            units = (-(-npts // self.tile[0])) * (-(-npts // self.tile[1]))
            props = torch.cuda.get_device_properties(device)
            self.grid = min(units, props.multi_processor_count * bps)
        elif self.lib is not None and routine == "ring":
            lib = self.lib.lib
            (self.tile, nu, nb, ncols, nsplit) = choose_ring(
                p, self.xp, self.X, self.nbuf, lib.tpufem_lab_ring_smem_bytes,
                tiles, mode)
            self.ring = (nu, nb, self.nbuf, ncols, nsplit)
            self.smem = lib.tpufem_lab_ring_smem_bytes(
                p, self.xp, *self.tile, *self.ring[:4])
            units = nsplit * (-(-npts // self.tile[0])) * \
                (-(-npts // self.tile[1]))
            self.grid = units
            if kern_name == "v19":  # persistent: the blocks the card holds
                bps = lib.tpufem_lab_ring_blocks_per_sm(
                    19, self.xp, p, *self.tile, *self.ring[:4])
                if bps < 1:
                    raise ValueError(f"the ring routine's v19 block does not "
                                     f"fit an SM at p={p}, X={self.X}")
                props = torch.cuda.get_device_properties(device)
                self.grid = min(units, props.multi_processor_count * bps)
        elif self.lib is not None:
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
        self.xb = None
        if self.ring is not None and mode not in NO_XSTAGE:
            self.xb = (window_operand(xkm, self.xp, self.X, p)
                       if kern_name == "v20" else
                       ring_operand(xkm, self.xp, self.X, *self.ring[3:]))
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
        if self.routine == "ring":
            # v19 and v20's ticket counter, the launcher sets it to 0 on the
            # stream
            tickets = torch.empty(1, dtype=torch.int64, device=self.device)
            with torch.cuda.device(self.device):
                rc = self.lib.lib.tpufem_lab_ring_apply(
                    RING_VARIANT[self.kern_name], self.xp, self.p,
                    MODES[self.mode], self.npts, self.sz, self.sy, self.X,
                    *self.tile, *self.ring, self.grid, gp.data_ptr(),
                    y.data_ptr(), self.tables.data_ptr(),
                    None if self.xb is None else self.xb.data_ptr(),
                    tickets.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            self.lib.check(rc, f"tpufem_lab_ring_apply {self.kern_name} "
                           "launch")
            V17Kernel.launches[self.kern_name] += 1
            return y
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
        if self.routine == "ring":
            return self._ring_design_bound(item)
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


    def _ring_plan(self):
        """(tile, nsplit, kn) of the ring routine: the instance's sub-tile,
        or on the CPU (no chooser) the first; its column splits; the K x N
        of the x product a sub-tile and split multiplies, over all its
        column blocks (dense: 2X by the split's columns; v20: 96 by 32 a
        32-column block)."""
        tile = self.tile or RING_TILES[0]
        if self.kern_name == "v20":
            return tile, 1, 2 * WIN_ROWS * WIN_N * -(-self.X // WIN_N)
        ncols, nsplit = ring_columns(self.xp, self.X, self.mode)
        return tile, nsplit, 2 * self.X * ncols

    def _ring_design_bound(self, item) -> tuple[float, str]:
        """The ring routine's design bound (``ring_design_bound``) on the
        resident layout (copy and bands read no x operator)."""
        (tz, ty), nsplit, kn = self._ring_plan()
        units = nsplit * (-(-self.npts // tz)) * (-(-self.npts // ty))
        return ring_design_bound(
            2 * self.sz * self.sy * self.X * item + self.tables.numel() * item,
            units, (tz, ty), self.p, self.X, kn, nsplit, self.xp, item,
            bands=self.mode not in ("copy", "mm"),
            xstage=self.mode not in NO_XSTAGE)

    def l2_bytes(self) -> int:
        """Bytes the ring routine moves from L2 into shared memory an apply
        (``ring_l2_bytes``): v20's B is every column block's window."""
        (tz, ty), nsplit, kn = self._ring_plan()
        units = nsplit * (-(-self.npts // tz)) * (-(-self.npts // ty))
        return ring_l2_bytes(units, (tz, ty), self.p, self.X, kn, self.xp,
                             self.dt, self.mode not in NO_XSTAGE)


def _b_elem(xp: int, item: int) -> int:
    """Bytes of an element of the split x operator: bf16 parts, or the
    storage's."""
    return 2 if xp in (XBF16X3, XBF16) else item


def ring_design_bound(nbytes, units, tile, p, X, kn, nsplit, xp, item,
                      bands=True, xstage=True) -> tuple[float, str]:
    """(ms, "bytes" or "operations") of a ring routine's design on an
    H100: ``nbytes`` (its layouts and tables) and the split x operator (kn:
    K x N of a unit's column blocks, over nsplit splits) read once from
    device memory; 5 band stages over every unit's halo'd box (units: sub-tiles
    times splits), on CUDA cores; the x product over every unit's 64 rows
    (overhang rows too) by its K x N (dense: K = 2X by the split's padded
    columns; v20: 96 rows by 32 a column block), each pass of its split.
    B's traffic from L2 (``ring_l2_bytes``) is not in it: the card's L2
    rate is not in the bound's table."""
    tz, ty = tile
    if xstage:
        nbytes += kn * nsplit * RING_PARTS[xp] * _b_elem(xp, item)
    band = (2 * units * (2 * tz * (ty + 2 * p) + 3 * tz * ty) * X
            * (2 * p + 1) if bands else 0)
    passes = {X3TF32: 3, X1TF32: 1, XBF16X3: 3, XF64: 1, XBF16: 1}[xp]
    mma = {X3TF32: "tf32", X1TF32: "tf32", XBF16X3: "bf16", XBF16: "bf16",
           XF64: "fp64_tensor"}[xp]
    return roofline_ms(nbytes, {
        "fp64" if xp == XF64 else "fp32": band,
        mma: passes * 2.0 * RING_M * units * kn if xstage else 0.0})


def ring_l2_bytes(units, tile, p, X, kn, xp, dtype, xstage=True) -> int:
    """Bytes a ring routine moves from L2 into shared memory an apply: every
    unit's halo'd u boxes over X and, with an x stage, its B stages (kn
    elements of K x N a unit, every part)."""
    tz, ty = tile
    item = torch.empty((), dtype=dtype).element_size()
    u = (tz + 2 * p) * (ty + 2 * p) * X * item
    b = kn * RING_PARTS[xp] * _b_elem(xp, item) if xstage else 0
    return units * (u + b)


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
