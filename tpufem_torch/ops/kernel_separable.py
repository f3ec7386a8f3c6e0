"""The fused separable Laplace apply as hand-written CUDA kernels.

Port of the Pallas kernels K2 (``_kernel`` / ``PallasSeparable``) and K1
(``_kernel_resident`` / ``ResidentSeparable``) of
``tpufem/ops/pallas_separable.py``.  K1 runs the band ring of
``tpufem_torch/csrc/resident_ring.cuh`` (shared with K3 and K4,
``kernel_terms``), its 3D Laplace plan on the resident layout ``(npts,
npts, X)``, X the smallest multiple of the ring's chunk (64 bytes of a
row) that is >= npts, columns npts .. X zero, boxes moved by TMA.  K2
runs the z-march of ``csrc/separable_apply.cuh`` on the flat grid (its
tile routine, the earlier schedule of the same arithmetic, stays beside it
for the comparisons, ``KernelSeparable.with_routine``, and runs the 2D
levels of ``TILE_NPTS``, where it is faster).
Each header note gives the schedule and what bounds it.  Each 1D operator
enters as an EXACT per-row band table ``W[g, o] = M[g, g+o-p]`` of shape
``(npts, 2p+1)`` plus its f64 row sum, so the TPU's periodic tables,
deficit corrections, 128-lane padding and sublane halos have no
counterpart here.

Each wrapper dispatches on the device of the tensor it is given: on a
CUDA tensor it launches the kernel (and raises if it cannot), on a CPU
tensor it runs its plain PyTorch version (``plain``), built on
``tpufem_torch.ops.separable.laplace_apply_separable``, which takes and
returns the same layout.  Each wrapper class counts its kernel launches in
the class attribute ``launches``.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from tpufem_torch.ops.separable import (
    laplace_apply_separable,
    laplace_apply_separable_terms,
)
from tpufem_torch.utils.build import load_kernels
from tpufem_torch.utils.precision import torch_dtype

# Shared memory a block may use; larger tiles cut the halo re-reads but
# leave fewer blocks per SM (228 KB of shared memory per H100 SM).
SMEM_BUDGET = 100 * 1024
MAX_DEGREE = 8  # the CUDA routines are instantiated for p = 1..8
# K2's z-march (choose_march): the cost of a band output from registers
# (the z stage) and of a warm-up plane's load, a halo'd column, each against
# a band output from shared memory (the y and x stages)
MARCH_REG_BAND = 0.5
MARCH_LOAD = 0.25
# and a step's fixed cost (its barriers and the latency they expose), in
# band outputs; the march axis's rows a step (csrc: march_rows)
MARCH_STEP = 1000.0
MARCH_ROWS = {2: 8, 3: 1}
# npts at which K2 runs the tile routine instead of the z-march, by dim: the
# 2D V-cycle levels where the tile routine's one-shot blocks beat the
# march's (one wave of blocks either way; a march block pays its 2P warm-up
# rows and a barrier a step).  Device time a launch, f32 Q4, NVIDIA H100
# 80GB HBM3 at 700 W (``python -m tpufem_torch.lab.march_sweep``, in
# turns): npts 257 tile 0.0068 against the march's 0.0075 (its best
# schedule 0.0070), 513 0.0100 against 0.0106; the march wins at every
# other level (2D 9-129, 3D 9-257)
TILE_NPTS = {2: (257, 513), 3: ()}
# the tile routine's output tiles (TZ, TY, TX) tried in order; TX = 32 keeps
# warp rows contiguous.  2D tiles have TZ = 1.
_TILES = {
    3: ((8, 8, 32), (4, 8, 32), (4, 4, 32), (2, 4, 32), (2, 2, 32),
        (2, 2, 16), (1, 2, 16), (1, 1, 16)),
    2: ((1, 32, 32), (1, 16, 32), (1, 8, 32), (1, 4, 32), (1, 2, 32),
        (1, 1, 32)),
}
# The ring's 3D (TZ, TY) sub-tiles (K1, K4), tried in order: first under
# the budget of two blocks an SM, then under RING_BUDGET.  (8, 8) re-reads
# its halo 4x at p = 4, (4, 16) 4.5x, (4, 8) 6x, (8, 16) 3x at one block an
# SM
RING_TILES = ((8, 8), (4, 16), (4, 8), (8, 16), (2, 8), (1, 16))
# its 2D sub-tiles (1, TY) (K3): TY + 2P rows a slot, (TY + 2P) / TY the
# halo re-read (1.13x at TY = 64, p = 4; resident_probe --dim 2 sweeps them)
RING_TILES_2D = ((1, 64), (1, 128), (1, 32), (1, 16))
RING_TWO_BLOCKS = 113 * 1024  # (228 KB - 2 x 1 KB reserved) / 2
RING_BUDGET = 220 * 1024  # of the 227 KB a block may use on an H100
# the ring's timing ablations (resident_ring.cuh's ResMode), run at the
# plan's shared memory, in float32, without the mask: "copy" y = u through
# the loads and stores; "bands" the z and y stages too, y = the windows at x
RING_ABLATIONS = {"copy": 1, "bands": 2}
# (storage, compute) dtype pairs the CUDA routines are instantiated for,
# with the code their C entries take (K2: the first two)
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
    difference form takes (``band`` in csrc/common.cuh)."""
    npts = mats[0].shape[0]
    tabs = []
    for M in mats:
        W = exact_bands(np.asarray(M, np.float64), p, npts, 1)[0].T
        tabs.append(np.concatenate([W, W.sum(axis=1, keepdims=True)], 1))
    return np.ascontiguousarray(np.stack(tabs))  # row-major, as the kernel reads


def ring_tables(mats, p: int) -> np.ndarray:
    """``band_tables`` for the ring routine: each row padded with zeros to
    a multiple of four values (``res_nwp`` in csrc/resident_ring.cuh), so
    the kernel loads a row as 16-byte vectors."""
    t = band_tables(mats, p)
    return np.pad(t, ((0, 0), (0, 0), (0, (2 * p + 5) // 4 * 4 - 2 * p - 2)))


def masked(M: np.ndarray) -> np.ndarray:
    """D M D with D = diag(0, 1, ..., 1, 0): the 1D factor of m·A·m for the
    separable interior mask m = D (x) D (x) D of the hyper_cube."""
    M = np.array(M, np.float64)
    M[[0, -1], :] = 0.0
    M[:, [0, -1]] = 0.0
    return M


def ring_xc(storage: torch.dtype, dim: int = 3) -> int:
    """Columns of the ring's chunk (csrc/band_ring.cuh, ring_xc): 64 bytes
    of a row in 3D; 128 bytes, at most 32 columns, in 2D."""
    elem = torch.empty((), dtype=storage).element_size()
    return min(128 // elem, 32) if dim == 2 else 64 // elem


def resident_x(npts: int, storage: torch.dtype, dim: int = 3) -> int:
    """X of the ring's resident layouts: the smallest multiple of one chunk
    (``ring_xc``) that is >= npts, the layout's row length."""
    xc = ring_xc(storage, dim)
    return xc * -(-npts // xc)


def choose_ring_tile(p: int, code: int, n_terms, smem_bytes, takes,
                     tiles=RING_TILES):
    """(sub-tile, windows) of the ring routine: the first of ``tiles`` the
    routine takes (``takes(p, tz, ty)``, ``tpufem_ring_takes``) whose
    block fits RING_TWO_BLOCKS, else RING_BUDGET, by its own count
    ``smem_bytes(p, code, nwin, tz, ty)`` (``tpufem_ring_smem_bytes``).
    The Laplace plan (``n_terms`` None) keeps its two windows, the terms
    plan the windows of all T terms; where no sub-tile holds T windows, it
    keeps as many as fit at the first sub-tile that holds one, and takes
    passes over x."""
    need = 2 if n_terms is None else n_terms
    budgets = (RING_TWO_BLOCKS, RING_BUDGET)
    for budget in budgets:
        for tz, ty in tiles:
            if takes(p, tz, ty) and \
                    smem_bytes(p, code, need, tz, ty) <= budget:
                return (tz, ty), need
    for budget in budgets if n_terms is not None else ():
        for tz, ty in tiles:
            if takes(p, tz, ty) and smem_bytes(p, code, 1, tz, ty) <= budget:
                group = 1
                while smem_bytes(p, code, group + 1, tz, ty) <= budget:
                    group += 1
                return (tz, ty), group
    raise ValueError(f"no ring sub-tile fits {RING_BUDGET} bytes of shared "
                     f"memory at p={p} (tried {tiles})")


def choose_segments(rows: int, nchunk: int, slots: int) -> int:
    """The count s of segments x is cut into, for a launch of ``rows``
    sub-tiles over ``nchunk`` chunks of x on a card that holds ``slots``
    blocks at once (its SMs times the blocks an SM takes): the s in
    1..nchunk that minimises

        rounds(s) x (ceil(nchunk / s) + halo(s)),

    rounds(s) = ceil(rows s / slots) the waves of blocks, ceil(nchunk / s)
    the chunks of the longest segment and halo(s) = min(s - 1, 2) the
    chunks it loads beyond them for its x band (one on each side inside
    x); the fewest segments among equals.  One segment walks all of x and
    loads nothing twice, so a grid that fills the card keeps it."""
    best = None
    for s in range(1, nchunk + 1):
        cost = -(-rows * s // slots) * (-(-nchunk // s) + min(s - 1, 2))
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


def choose_march(dim: int, npts: int, p: int, cols: int, smem_bytes,
                 blocks_per_sm, n_sm: int):
    """(tile, nseg) of K2's z-march: the output tile (TY, TX) (2D: (1,
    TX)) and the count of segments the march axis (z; 2D: y) is cut into.

    TX, TY and the segments are even splits of their axis, ceil(npts / n)
    whose last piece holds at least half of one (129 = 3 x 43, not 32 x 4
    + 1); the halo'd tile must fit the ``cols`` columns a block holds
    (``tpufem_march_cols``: its register ring) and ``smem_bytes(ty, tx)``
    SMEM_BUDGET.  Of those, the (tile, nseg) that minimises

        rounds x (steps x (R x plane + MARCH_STEP) + warm),

    rounds = ceil(blocks / slots) the waves of blocks on a card of ``n_sm``
    SMs holding ``blocks_per_sm(ty, tx)`` each (the library's occupancy
    query), steps = ceil(seg / R) the steps of R = ``MARCH_ROWS`` planes
    (2D: rows) of a segment of seg = ceil(npts / nseg) planes, plane a
    plane's band outputs (``MARCH_REG_BAND`` per register band: 2
    (TY+2P)(TX+2P); one per shared-memory band: 3 TY (TX+2P) + 2 TY TX; 2D:
    2 (TX+2P) and 2 TX) and warm the 2P warm-up planes' loads
    (``MARCH_LOAD`` a column); the widest tile and the fewest segments
    among equals."""
    splits = sorted({t for t in (-(-npts // n) for n in range(1, npts + 1))
                     if 2 * (npts % t or t) >= t}, reverse=True)
    best = None
    for tx in splits:
        lx = tx + 2 * p
        for ty in (splits if dim == 3 else (1,)):
            ly = ty + 2 * p if dim == 3 else 1
            if ly * lx > cols or smem_bytes(ty, tx) > SMEM_BUDGET:
                continue
            bps = blocks_per_sm(ty, tx)
            if bps < 1:
                continue
            tiles = -(-npts // tx) * (-(-npts // ty) if dim == 3 else 1)
            if dim == 3:
                plane = (2 * MARCH_REG_BAND * ly * lx + 3 * ty * lx
                         + 2 * ty * tx)
            else:
                plane = 2 * MARCH_REG_BAND * lx + 2 * tx
            warm = 2 * p * MARCH_LOAD * ly * lx
            for seg in splits:
                nseg = -(-npts // seg)
                steps = -(-seg // MARCH_ROWS[dim])
                cost = (-(-tiles * nseg // (n_sm * bps))
                        * (steps * (MARCH_ROWS[dim] * plane + MARCH_STEP)
                           + warm))
                key = (cost, -tx * ty, nseg)
                if best is None or key < best[0]:
                    best = (key, (ty, tx), nseg)
    if best is None:
        raise ValueError(f"no z-march tile of npts={npts} fits {cols} "
                         f"columns and {SMEM_BUDGET} bytes at dim={dim}, "
                         f"p={p}")
    return best[1], best[2]


def choose_tile(dim: int, p: int, itemsize: int, smem_elems):
    """The tile routine's tile: the first of ``_TILES[dim]`` whose block
    fits SMEM_BUDGET.

    ``smem_elems(dim, p, tz, ty, tx)`` is the kernel library's own count
    of a block's shared-memory elements (``tpufem_smem_elems``)."""
    for tile in _TILES[dim]:
        if smem_elems(dim, p, *tile) * itemsize <= SMEM_BUDGET:
            return tile
    raise ValueError(f"no tile fits {SMEM_BUDGET} bytes of shared memory "
                     f"at dim={dim}, p={p}, itemsize={itemsize}")


def check_instance(dim, p, storage, compute, device, library: str):
    """Validate a kernel instance's dim, degree and dtype pair; return its
    dtype code, its device ("cuda" resolved to the current card, as the
    tensors it will get report it) and, on a CUDA device, the loaded
    kernel library ``library`` (None on the CPU).  The library is built
    when the first CUDA instance is made, so a kernel that cannot be
    built raises here."""
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if not 1 <= p <= MAX_DEGREE:
        raise ValueError(f"the CUDA routine is instantiated for p = "
                         f"1..{MAX_DEGREE}, got p = {p}")
    if (storage, compute) not in _DTYPE_CODES:
        raise ValueError(f"no kernel instance stores {storage} and "
                         f"computes in {compute}")
    device, lib = torch.device(device), None
    if device.type == "cuda":
        lib = load_kernels()[library]
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return _DTYPE_CODES[(storage, compute)], device, lib


def check_grid(u: torch.Tensor, device, storage, npts: int, dim: int):
    """Raise unless u is what a kernel on ``device`` takes: a contiguous
    CUDA grid of npts**dim points in the storage dtype."""
    if u.device != device or not u.is_cuda:
        raise ValueError(f"kernel on {device} got a tensor on {u.device}")
    if u.dtype != storage:
        raise ValueError(f"kernel stores {storage}, got {u.dtype}")
    if u.numel() != npts**dim or not u.is_contiguous():
        raise ValueError(f"kernel takes a contiguous grid of {npts}**{dim} "
                         f"points, got shape {tuple(u.shape)}")


class _BandApply:
    """Tables, schedule and launch of K2 for one operator.

    Ks/Ms: per-axis (npts, npts) 1D operators (x first), any banded
    matrices of bandwidth p; ``dtype`` is the vectors' and the
    arithmetic's.  ``routine``: "march" (the z-march) or "tile" (the tile
    routine), the main path's (``schedule``): the march except at the npts
    of ``TILE_NPTS``.  A CUDA instance's ``tile`` is the march's (TY, TX)
    (2D: (1, TX)) with ``nseg`` segments of the march axis
    (``choose_march``), or the tile routine's (TZ, TY, TX) (the first of
    ``_TILES`` that fits); a CPU instance has neither.
    """

    def __init__(self, dim, npts, p, Ks, Ms, dtype, device):
        self.code, self.device, self.lib = check_instance(
            dim, p, dtype, dtype, device, "separable_apply")
        self.dim, self.npts, self.p, self.dtype = dim, npts, p, dtype
        mats = []
        for a in range(dim):
            mats += [Ks[a], Ms[a]]
        self.tables = torch.as_tensor(band_tables(mats, p), dtype=dtype,
                                      device=self.device)
        self.schedule()

    def schedule(self, routine=None, tile=None, nseg=None):
        """Take ``routine`` (None: the main path's) and its tile; ``tile``
        and ``nseg`` stand in for the march's chooser (its sweep,
        ``tpufem_torch.lab.march_sweep``)."""
        if routine is None:
            routine = "tile" if self.npts in TILE_NPTS[self.dim] else "march"
        if routine not in ("march", "tile"):
            raise ValueError(f"routine must be 'march' or 'tile', got "
                             f"{routine!r}")
        self.routine, self.tile, self.nseg = routine, None, None
        if self.lib is None:
            return
        lib, dim, p, code = self.lib.lib, self.dim, self.p, self.code
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        if routine == "tile":
            self.tile = choose_tile(dim, p, itemsize, lib.tpufem_smem_elems)
            return
        if tile is not None:
            self.tile, self.nseg = tuple(tile), nseg
            return
        n_sm = torch.cuda.get_device_properties(
            self.device).multi_processor_count
        self.tile, self.nseg = choose_march(
            dim, self.npts, p, lib.tpufem_march_cols(code, dim, p),
            lambda ty, tx: lib.tpufem_march_smem_elems(dim, p, ty, tx)
            * itemsize,
            lambda ty, tx: lib.tpufem_march_blocks_per_sm(code, dim, p, ty,
                                                          tx), n_sm)

    def launch(self, u: torch.Tensor, out: torch.Tensor | None = None
               ) -> torch.Tensor:
        """y = A u on the card, into ``out`` if given."""
        check_grid(u, self.device, self.dtype, self.npts, self.dim)
        y = torch.empty_like(u) if out is None else out
        check_grid(y, self.device, self.dtype, self.npts, self.dim)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            if self.routine == "march":
                ty, tx = self.tile
                rc = self.lib.lib.tpufem_separable_march(
                    self.code, self.dim, self.p, self.npts, ty, tx,
                    self.nseg, u.data_ptr(), y.data_ptr(),
                    self.tables.data_ptr(), stream)
            else:
                tz, ty, tx = self.tile
                rc = self.lib.lib.tpufem_separable_apply(
                    self.code, self.dim, self.p, self.npts, tz, ty, tx,
                    u.data_ptr(), y.data_ptr(), self.tables.data_ptr(),
                    stream)
        self.lib.check(rc, f"tpufem_separable_{self.routine} launch")
        return y


class RingApply:
    """Tables, sub-tile, segments and launch of the ring routine for one
    operator on its resident layout, and the layout's contract (``pad``,
    ``pad_any``, ``unpad``).

    plan 0, the Laplace plan (3D: K1): ``mats`` [Kx, Mx, Ky, My, Kz, Mz];
    plan 1, the terms plan (K4 in 3D, K3 in 2D): ``mats`` term by term, x
    first, the windows of ``group`` terms resident (fewer than T:
    ``npass`` passes over x, whose partial sums a bf16s launch keeps in a
    float32 buffer of its own).  Table rows are ``ring_tables``'s, padded
    to a multiple of four values.  The layout is ``(npts, npts, X)`` (2D:
    ``(npts, X)``), moved by TMA.  With ``dirichlet`` the tables are those
    of the masked 1D matrices (``masked``) and the kernel stores a boundary
    point's input.  ``tile`` overrides the sub-tile (TZ, TY) (2D: (1, TY)).
    x is cut into ``nseg`` segments: ``choose_segments``'s count in 2D, one
    for K1 and K4.  ``smem`` is a block's shared-memory bytes,
    ``blocks_per_sm`` the blocks an SM holds.  A CPU instance has neither
    tile, group, segments nor smem.
    """

    def __init__(self, plan, npts, p, mats, storage, compute, dirichlet,
                 device, tile=None, dim=3):
        self.code, self.device, self.lib = check_instance(
            dim, p, storage, compute, device, "resident_ring")
        self.plan, self.npts, self.p, self.dim = plan, npts, p, dim
        self.storage, self.compute = storage, compute
        self.dirichlet = bool(dirichlet)
        self.X = resident_x(npts, storage, dim)
        self.n_terms = len(mats) // dim if plan == 1 else None
        self.tile = self.group = self.smem = self.nseg = None
        self.blocks_per_sm = None
        self.npass = 1
        if self.lib is not None:
            lib = self.lib.lib
            smem = lambda pp, code, nwin, tz, ty: lib.tpufem_ring_smem_bytes(
                pp, dim, code, nwin, tz, ty)
            takes = lambda pp, tz, ty: lib.tpufem_ring_takes(pp, dim, tz, ty)
            tiles = RING_TILES_2D if dim == 2 else RING_TILES
            self.tile, self.group = choose_ring_tile(
                p, self.code, self.n_terms, smem, takes,
                tiles if tile is None else (tuple(tile),))
            self.smem = smem(p, self.code, self.group, *self.tile)
            if plan == 1:
                self.npass = -(-self.n_terms // self.group)
            self.blocks_per_sm = lib.tpufem_ring_blocks_per_sm(
                plan, dim, self.code, p, self.group, *self.tile)
            if self.blocks_per_sm < 1:
                raise RuntimeError(f"the ring routine holds no block of "
                                   f"sub-tile {self.tile} on an SM")
            self.nseg = 1
            if dim == 2:
                n_sm = torch.cuda.get_device_properties(
                    self.device).multi_processor_count
                self.nseg = choose_segments(
                    -(-npts // self.tile[1]), self.X // ring_xc(storage, dim),
                    n_sm * self.blocks_per_sm)
        if self.dirichlet:
            mats = [masked(M) for M in mats]
        tab = ring_tables(mats, p)
        if plan == 1:
            tab = tab.reshape(self.n_terms, dim, npts, tab.shape[-1])
        self.tables = torch.as_tensor(tab, dtype=compute, device=self.device)

    @property
    def shape(self) -> tuple:
        """The layout's shape."""
        return (self.npts,) * (self.dim - 1) + (self.X,)

    def pad_any(self, u: torch.Tensor) -> torch.Tensor:
        """Flat (npts**dim,) vector -> the layout, dtype kept, pad zero."""
        n = self.npts
        gp = u.new_zeros(self.shape)
        gp[..., :n] = u.reshape((n,) * self.dim)
        return gp

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        return gp[..., :self.npts].reshape(-1)

    def launch(self, u: torch.Tensor, mode: str = "apply",
               out: torch.Tensor | None = None) -> torch.Tensor:
        """The plan's operator of u on the card (or one of
        RING_ABLATIONS), into ``out`` if given (a tensor like u)."""
        if u.device != self.device or not u.is_cuda:
            raise ValueError(f"kernel on {self.device} got a tensor on "
                             f"{u.device}")
        if u.dtype != self.storage:
            raise ValueError(f"kernel stores {self.storage}, got {u.dtype}")
        if u.shape != self.shape or not u.is_contiguous():
            raise ValueError(f"kernel takes a contiguous layout "
                             f"{self.shape}, got {tuple(u.shape)}")
        y = torch.empty_like(u) if out is None else out
        if (y.shape, y.dtype, y.device) != (u.shape, u.dtype, u.device) \
                or not y.is_contiguous() or y.data_ptr() == u.data_ptr():
            raise ValueError("out must be a contiguous tensor like u, apart "
                             "from it")
        part = None  # the passes' partial sums, in the compute dtype
        if self.npass > 1 and mode != "copy":
            part = y if self.storage == self.compute else torch.empty_like(
                y, dtype=self.compute)
        tz, ty = self.tile
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.lib.lib.tpufem_ring_apply(
                self.plan, self.dim, self.code, self.p, self.npts, self.X,
                self.n_terms or 0, self.group, tz, ty, self.nseg,
                RING_ABLATIONS.get(mode, 0), int(self.dirichlet),
                u.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(),
                self.tables.data_ptr(), stream)
        self.lib.check(rc, "tpufem_ring_apply launch")
        return y


def ablation_terms(terms, npts: int, dtype, device):
    """The operator of the "bands" ablation of a terms operator (K1: its
    three Laplace terms): each term with the identity along x."""
    eye = torch.eye(npts, dtype=dtype, device=device)
    return [[eye, *t[1:]] for t in terms]


def separable_interior_mask(npts: int, dtype, device, dim: int = 3
                            ) -> torch.Tensor:
    """(npts**dim,) separable interior mask of the hyper_cube: 0 on the
    boundary planes (2D: lines), 1 elsewhere."""
    m1 = torch.ones(npts, dtype=dtype, device=device)
    m1[0] = m1[-1] = 0.0
    m = m1
    for _ in range(dim - 1):
        m = torch.outer(m, m1).reshape(-1)
    return m


def _on(device, mats, dtype):
    return [torch.tensor(np.asarray(M, np.float64), dtype=dtype,
                         device=device) for M in mats]


class KernelSeparable:
    """K2: fused separable apply on flat ``(npts**dim,)`` vectors, 2D/3D.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel`` behind
    ``PallasSeparable``.  dtype float32 or float64 (Hopper runs f64
    natively; the TPU kernel compiled f32 only).  On the card it launches
    the z-march, or at the npts of ``TILE_NPTS`` the tile routine
    (``_BandApply``; ``routine``, ``tile`` and ``nseg`` its schedule).
    """

    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, dim, npts, p, Ks, Ms, dtype, device):
        dt = torch_dtype(dtype)
        self.dim, self.npts = dim, npts
        self._band = _BandApply(dim, npts, p, Ks, Ms, dt, device)
        self.device, self.tile = self._band.device, self._band.tile
        self.nseg, self.routine = self._band.nseg, self._band.routine
        self.Ks = _on(self.device, Ks, dt)
        self.Ms = _on(self.device, Ms, dt)

    def plain(self, u: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version (dense 1D contractions)."""
        return laplace_apply_separable(u, self.dim, self.npts, self.Ks,
                                       self.Ms)

    def with_routine(self, routine: str) -> _BandApply:
        """K2's "march" or "tile" routine on this operator's tables (its
        ``launch``, on the card only, uncounted), whichever the main path
        takes here: the two equal each other bit for bit, for the
        comparisons and timings in turns."""
        band = copy.copy(self._band)
        band.schedule(routine)
        return band

    def __call__(self, u: torch.Tensor, out: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """y = A u; on the card into ``out`` if given (a tensor like u)."""
        if u.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(u)
        y = self._band.launch(u, out=out)
        KernelSeparable.launches += 1
        return y


class ResidentSeparable:
    """K1: solver-resident fused 3D apply, optionally with the fused
    Dirichlet mask y = m·A(m·x) + (1-m)·x of the uniform hyper_cube.

    Pallas twin: ``tpufem/ops/pallas_separable.py::_kernel_resident``
    behind ``ResidentSeparable``.  The resident layout is the ring's
    ``(npts, npts, X)`` (``RingApply``): ``pad`` casts a flat vector to
    the storage dtype and zero-pads x to X, ``pad_any`` pads keeping the
    dtype, ``unpad`` takes the first npts columns.  ``raw`` applies the
    kernel (or, on the CPU, the plain version) layout to layout; the pad
    stays zero.  With ``dirichlet`` the kernel applies the masked 1D
    tables (D M D) and stores a boundary point's input.

    Modes (``dtype`` is the compute dtype):
    - "f32": vectors stored and computed in ``dtype`` (f32 or f64).
    - "bf16": on the TPU a bf16x3 split of the x matmul (~3e-6 rel); this
      kernel has no matmul to split, so it runs the f32 instance, which
      meets that accuracy class.
    - "bf16s": vectors stored bf16, arithmetic in f32 (dtype float32);
      ~4e-3 rel, the class of the TPU kernel (input/output quantisation).
    - "copy": the ring's copy ablation (the kernel lab's ``v5-copy``),
      y = u through the ring's loads and stores at K1's shared memory, no
      band stage (float32, no mask);
    - "bands": the ring's z and y stages alone, y = q1 + q23 at each x, no
      x band (float32, no mask).  With "copy" it splits K1's time.

    ``tile`` overrides the ring's sub-tile (TZ, TY) (the sweep of
    ``tpufem_torch.apps.resident_probe``).
    """

    launches = 0  # kernel launches by all instances (plain calls excluded)

    def __init__(self, npts, p, Ks, Ms, dtype, mode="f32", dirichlet=False,
                 device="cuda", tile=None):
        if mode not in ("f32", "bf16", "bf16s", *RING_ABLATIONS):
            raise ValueError(f"mode must be 'f32', 'bf16', 'bf16s', 'copy' "
                             f"or 'bands', got {mode!r}")
        cdt = torch_dtype(dtype)
        if mode in ("bf16s", *RING_ABLATIONS) and cdt != torch.float32:
            raise ValueError(f"mode {mode!r} computes in float32")
        if mode in RING_ABLATIONS and dirichlet:
            raise ValueError(f"mode {mode!r} has no Dirichlet mask")
        self.npts, self.p, self.mode = npts, p, mode
        self.compute_dt = cdt
        self.dt = torch.bfloat16 if mode == "bf16s" else cdt  # storage
        self.dirichlet = bool(dirichlet)
        mats = []
        for a in range(3):
            mats += [Ks[a], Ms[a]]
        self._ring = RingApply(0, npts, p, mats, self.dt, cdt,
                               self.dirichlet, device, tile)
        self.device, self.tile = self._ring.device, self._ring.tile
        self.X = self._ring.X
        self.Ks = _on(self.device, Ks, cdt)
        self.Ms = _on(self.device, Ms, cdt)

    def pad(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident layout in the storage dtype."""
        return self._ring.pad_any(u.to(self.dt))

    def pad_any(self, u: torch.Tensor) -> torch.Tensor:
        """Flat vector -> resident layout, dtype preserved."""
        return self._ring.pad_any(u)

    def unpad(self, gp: torch.Tensor) -> torch.Tensor:
        return self._ring.unpad(gp)

    def interior_mask(self) -> torch.Tensor:
        """(npts**3,) separable interior mask of the hyper_cube, compute
        dtype: 0 on the six boundary planes, 1 elsewhere."""
        return separable_interior_mask(self.npts, self.compute_dt,
                                       self.device)

    def plain(self, gp: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version of ``raw`` (compute dtype inside,
        storage dtype out, the same layout)."""
        if self.mode == "copy":
            return gp.clone()
        x = self.unpad(gp).to(self.compute_dt)
        A = lambda v: laplace_apply_separable(v, 3, self.npts, self.Ks,
                                              self.Ms)
        if self.mode == "bands":
            K, M = self.Ks, self.Ms
            terms = ablation_terms([[M[0], M[1], K[2]], [M[0], K[1], M[2]],
                                    [K[0], M[1], M[2]]], self.npts,
                                   self.compute_dt, self.device)
            y = laplace_apply_separable_terms(x, 3, self.npts, terms)
        elif self.dirichlet:
            m = self.interior_mask()
            y = m * A(m * x) + (1.0 - m) * x
        else:
            y = A(x)
        return self._ring.pad_any(y.to(self.dt))

    def raw(self, gp: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
        """The apply on a resident layout (storage dtype in and out); on the
        card into ``out`` if given."""
        if gp.device.type == "cpu" and self.device.type == "cpu":
            return self.plain(gp)
        y = self._ring.launch(gp, self.mode, out=out)
        ResidentSeparable.launches += 1
        return y

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self.unpad(self.raw(self.pad(u)))
