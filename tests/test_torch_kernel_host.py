"""The CUDA routines of K1-K4 compiled for the CPU with g++ and held
against the plain PyTorch versions: the band ring (tpufem_torch/csrc/
resident_ring.cuh on band_ring.cuh) under K1 and K4 (3D) and K3 (2D;
tests/test_torch_ring2d.py covers the 2D plan case by case), on their
resident layouts, and K2's tile routine (separable_apply.cuh) on the flat
grid.

Every stage of the tile routine is a loop ``for (i = threadIdx.x; i < n;
i += blockDim.x)`` between ``__syncthreads()``, so one thread running each
block in turn computes exactly what a block of 256 threads computes on the
card.  The stub header below defines the CUDA built-ins (qualifiers,
``threadIdx``/``blockIdx``/``blockDim``, a no-op ``__syncthreads``,
round-to-nearest-even bf16 conversions).  The ring runs through
csrc/hopper.cuh's host forms: a TMA box load is a loop copy with zero fill
(negative coordinates included), a box store one with clipping, the
mbarrier calls do nothing, and one host thread runs the producer's step, then each warp's piece, lane by
lane.  This holds the kernels' indexing, halo, segments, band tables, term
loop and passes, fused mask, layouts and storage conversions to the plain
version on every run of the CPU tests; the card itself (launch
configuration, shared-memory limits, TMA) is covered by
``chip_smoke.py``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpufem.fem.mesh import Mesh
from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops.separable import (
    build_separable_metric_terms,
    global_1d_matrices,
    laplace_apply_separable,
    laplace_apply_separable_terms,
)
from tpufem_torch.utils import build
from tpufem_torch.utils.build import CSRC

STUBS = r"""
#include <cstdint>
#include <cstring>
struct Dim3 { int x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__
static inline void __syncthreads() {}
struct __nv_bfloat16 { uint16_t bits; };
static inline float __bfloat162float(__nv_bfloat16 v) {
  uint32_t u = (uint32_t)v.bits << 16; float f; std::memcpy(&f, &u, 4);
  return f;
}
static inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  u += 0x7FFF + ((u >> 16) & 1);  // round to nearest even (finite inputs)
  __nv_bfloat16 b; b.bits = (uint16_t)(u >> 16); return b;
}
namespace tpufem { unsigned char smem_raw[1 << 22]; }
"""

HOST_SHIM = STUBS + r"""
#include "separable_apply.cuh"

template <int P, int DIM, typename C>
static int run(int npts, int tz, int ty, int tx, const void* u, void* y,
               const void* tables) {
  const long long bytes = tpufem::smem_elems(DIM, P, tz, ty, tx) * sizeof(C);
  const int gx = (npts + tx - 1) / tx, gy = (npts + ty - 1) / ty;
  const int gz = DIM == 3 ? (npts + tz - 1) / tz : 1;
  for (int bz = 0; bz < gz; ++bz)
    for (int by = 0; by < gy; ++by)
      for (int bx = 0; bx < gx; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, sizeof(tpufem::smem_raw));
        blockIdx = Dim3{bx, by, bz};
        tpufem::separable_apply_kernel<P, DIM, C>(
            (const C*)u, (C*)y, (const C*)tables, npts, tz, ty, tx);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

template <int DIM, typename C>
static int by_p(int p, int npts, int tz, int ty, int tx, const void* u,
                void* y, const void* t) {
  switch (p) {
    case 1: return run<1, DIM, C>(npts, tz, ty, tx, u, y, t);
    case 2: return run<2, DIM, C>(npts, tz, ty, tx, u, y, t);
    case 3: return run<3, DIM, C>(npts, tz, ty, tx, u, y, t);
    case 4: return run<4, DIM, C>(npts, tz, ty, tx, u, y, t);
    case 7: return run<7, DIM, C>(npts, tz, ty, tx, u, y, t);
    case 8: return run<8, DIM, C>(npts, tz, ty, tx, u, y, t);
  }
  return 2;
}

template <int DIM>
static int by_dtype(int code, int p, int npts, int tz, int ty, int tx,
                    const void* u, void* y, const void* t) {
  if (code == 0) return by_p<DIM, double>(p, npts, tz, ty, tx, u, y, t);
  return by_p<DIM, float>(p, npts, tz, ty, tx, u, y, t);
}

extern "C" int host_apply(int code, int dim, int p, int npts, int tz, int ty,
                          int tx, const void* u, void* y, const void* t) {
  return dim == 3 ? by_dtype<3>(code, p, npts, tz, ty, tx, u, y, t)
                  : by_dtype<2>(code, p, npts, 1, ty, tx, u, y, t);
}

extern "C" long long host_smem_elems(int dim, int p, int tz, int ty, int tx) {
  return tpufem::smem_elems(dim, p, tz, ty, tx);
}
"""

CODES = {"f64": (0, torch.float64, torch.float64),
         "f32": (1, torch.float32, torch.float32),
         "bf16s": (2, torch.bfloat16, torch.float32)}
TOL = {"f64": 1e-13, "f32": 1e-6, "bf16s": 4e-3}

# The ring routine (resident_ring.cuh) for one host thread a block, each
# block's shared memory NaN-filled first (a read of a point no stage wrote
# shows in the output) and checked for writes beyond it.  SETS: the
# instances a build carries, "3d" (K1, K4) and "2d" (K3).
RING_SHIM = STUBS + r"""
#define __syncwarp()
#define __grid_constant__
#include "resident_ring.cuh"

template <int P, typename S, typename C, int PLAN, int DIM>
static int run(int mode, tpufem::ResGeo g, const void* u, void* y, void* part,
               const void* tab) {
  if (!tpufem::res_takes(P, g.tz, g.ty, DIM)) return 3;
  const int xc = tpufem::ring_xc(sizeof(S), DIM);
  const tpufem::RingPieces pc = tpufem::ring_pieces(g.tz, g.ty);
  tpufem::HopMap in_map{}, out_map{};  // the launcher's two maps
  const long long dim[3] = {g.X, g.npts, DIM == 3 ? g.npts : 1};
  const int in_box[3] = {xc, g.ty + 2 * P, DIM == 3 ? g.tz + 2 * P : 1};
  const int out_box[3] = {xc, pc.by, pc.bz};
  tpufem::hop_map_3d(&in_map, (void*)u, sizeof(S), dim, in_box);
  tpufem::hop_map_3d(&out_map, y, sizeof(S), dim, out_box);
  const int nwin = PLAN == tpufem::kPlanTerms ? g.group : 2;
  const long long bytes = tpufem::res_smem(P, sizeof(S), sizeof(C), nwin,
                                           g.tz, g.ty, DIM).total;
  const int nz = DIM == 3 ? (g.npts + g.tz - 1) / g.tz : 1;
  for (int sg = 0; sg < g.nseg; ++sg)
    for (int bz = 0; bz < nz; ++bz)
      for (int by = 0; by < (g.npts + g.ty - 1) / g.ty; ++by) {
        std::memset(tpufem::smem_raw, 0xFF, bytes);
        std::memset(tpufem::smem_raw + bytes, 0xAB, 4096);
        blockIdx = Dim3{by, bz, sg};
        tpufem::resident_ring_kernel<P, S, C, PLAN, DIM>(
            in_map, out_map, (const S*)u, (C*)part, (const C*)tab, g, mode);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

template <typename S, typename C, int PLAN, int DIM>
static int by_p(int p, int mode, tpufem::ResGeo g, const void* u, void* y,
                void* q, const void* t) {
  switch (p) {
    case 1: return run<1, S, C, PLAN, DIM>(mode, g, u, y, q, t);
    case 2: return run<2, S, C, PLAN, DIM>(mode, g, u, y, q, t);
    case 3: return run<3, S, C, PLAN, DIM>(mode, g, u, y, q, t);
    case 4: return run<4, S, C, PLAN, DIM>(mode, g, u, y, q, t);
    case 7: return run<7, S, C, PLAN, DIM>(mode, g, u, y, q, t);
    case 8: return run<8, S, C, PLAN, DIM>(mode, g, u, y, q, t);
  }
  return 2;
}

template <int PLAN, int DIM>
static int by_dtype(int code, int p, int mode, tpufem::ResGeo g,
                    const void* u, void* y, void* q, const void* t) {
  if (code == 0)
    return by_p<double, double, PLAN, DIM>(p, mode, g, u, y, q, t);
  if (code == 1)
    return by_p<float, float, PLAN, DIM>(p, mode, g, u, y, q, t);
  return by_p<__nv_bfloat16, float, PLAN, DIM>(p, mode, g, u, y, q, t);
}

// 4: refused by the launcher's argument check; 5: not in this build
extern "C" int host_ring_apply(int plan, int dim, int code, int p, int npts,
                               int X, int nt, int group, int tz, int ty,
                               int nseg, int mode, int dirichlet,
                               const void* u, void* y, void* part,
                               const void* t) {
  if (!tpufem::ring_args_ok(plan, dim, code, p, npts, X, nt, group, tz, ty,
                            nseg, mode, dirichlet, u, y, part))
    return 4;
  const tpufem::ResGeo g{npts, X, tz, ty, nt, group, dirichlet, nseg};
#ifdef SET3D
  if (plan == 0 && dim == 3)
    return by_dtype<0, 3>(code, p, mode, g, u, y, part, t);
  if (plan == 1 && dim == 3)
    return by_dtype<1, 3>(code, p, mode, g, u, y, part, t);
#endif
#ifdef SET2D
  if (plan == 1 && dim == 2)
    return by_dtype<1, 2>(code, p, mode, g, u, y, part, t);
#endif
  return 5;
}

extern "C" long long host_ring_smem_bytes(int p, int dim, int code, int nwin,
                                          int tz, int ty) {
  return tpufem::res_smem(p, tpufem::ring_storage_bytes(code),
                          code == 0 ? 8 : 4, nwin, tz, ty, dim)
      .total;
}

extern "C" int host_ring_takes(int p, int dim, int tz, int ty) {
  return tpufem::res_takes(p, tz, ty, dim) ? 1 : 0;
}
"""


def _build(tmp_path_factory, name, source, defines=(), opt=("-O1",)):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA routine "
                    "needs a C++17 compiler")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.cpp").write_text(source)
    lib_path = d / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++17", *opt, "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}",
                    *(f"-D{m}" for m in defines),
                    "-o", str(lib_path), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


def build_ring(tmp_path_factory, name, sets):
    """The host build of the ring routine with the instance sets ``sets``
    ("3d", "2d"), its entries typed."""
    lib = _build(tmp_path_factory, name, RING_SHIM,
                 [f"SET{x.upper()}" for x in sets])
    lib.host_ring_apply.argtypes = [ctypes.c_int] * 13 + [ctypes.c_void_p] * 4
    lib.host_ring_apply.restype = ctypes.c_int
    lib.host_ring_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.host_ring_smem_bytes.restype = ctypes.c_longlong
    lib.host_ring_takes.argtypes = [ctypes.c_int] * 4
    lib.host_ring_takes.restype = ctypes.c_int
    return lib


def ring_counts(lib, dim=3):
    """The chooser's two callables for a host build: ``smem(p, code, nwin,
    tz, ty)`` and ``takes(p, tz, ty)``, at dim."""
    return (lambda p, code, nwin, tz, ty: lib.host_ring_smem_bytes(
                p, dim, code, nwin, tz, ty),
            lambda p, tz, ty: lib.host_ring_takes(p, dim, tz, ty))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "kernel_host", HOST_SHIM)
    lib.host_apply.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    lib.host_apply.restype = ctypes.c_int
    lib.host_smem_elems.argtypes = [ctypes.c_int] * 5
    lib.host_smem_elems.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def ring2d_lib(tmp_path_factory):
    """K3's instances of the ring (the 2D resident layout)."""
    return build_ring(tmp_path_factory, "ring2d_host", ("2d",))


def _nonsym(rng, npts, p):
    i, j = np.indices((npts, npts))
    return np.where(np.abs(i - j) <= p, rng.standard_normal((npts, npts)), 0.0)


def _mask(npts, dim):
    g = torch.arange(npts)
    m1 = ((g != 0) & (g != npts - 1)).double()
    m = m1
    for _ in range(dim - 1):
        m = torch.outer(m1, m.reshape(-1))
    return m.reshape(-1)


def _plain(dim, npts, Ks, Ms, u64, dirichlet):
    K = [torch.as_tensor(k) for k in Ks]
    M = [torch.as_tensor(m) for m in Ms]
    A = lambda v: laplace_apply_separable(v, dim, npts, K, M)
    if not dirichlet:
        return A(u64)
    m = _mask(npts, dim)
    return m * A(m * u64) + (1.0 - m) * u64


@pytest.mark.parametrize("dim,p,npts,mode,dirichlet,tile", [
    (3, 1, 9, "f64", False, None),
    (3, 2, 13, "f64", True, None),
    (3, 4, 17, "f64", True, (2, 8)),  # K1: a ring sub-tile, ragged here
    (3, 7, 15, "f64", False, None),
    (3, 8, 17, "f64", True, None),
    (3, 3, 10, "f32", False, (2, 3, 4)),  # ragged tiles on every axis
    (3, 4, 33, "f32", True, None),
    (3, 4, 21, "bf16s", True, None),
    (2, 1, 9, "f64", False, None),
    (2, 3, 25, "f64", True, None),
    (2, 8, 33, "f64", False, (1, 5, 7)),
    (2, 4, 41, "f32", False, None),
    (2, 2, 70, "bf16s", True, None),
    # beyond the cases above (their ids name their place in the list)
    (3, 4, 21, "f32", False, (4, 4, 32)),
    (2, 2, 70, "f32", False, (1, 8, 32)),
])
def test_kernel_host_build_matches_plain(host_lib, ring_lib, ring2d_lib, dim,
                                         p, npts, mode, dirichlet, tile):
    """The Laplace apply on random non-symmetric banded matrices, distinct
    per axis: an axis swap, a transposed band or a boundary-row error
    shows.  Unmasked: K2's tile routine on the flat grid.  With the
    Dirichlet mask, the resident
    kernel that carries it, fused, on the ring: in 3D K1, in 2D K3 on the
    two-term factorisation."""
    code, storage, compute = CODES[mode]
    rng = np.random.default_rng(npts * 10 + p)
    Ks = [_nonsym(rng, npts, p) for _ in range(dim)]
    Ms = [_nonsym(rng, npts, p) for _ in range(dim)]
    mats = []
    for a in range(dim):
        mats += [Ks[a], Ms[a]]
    u64 = torch.as_tensor(rng.standard_normal(npts**dim))
    if dirichlet and dim == 3:
        y, x, _ = _ring_apply(ring_lib, 0, mats, p, mode, u64, True, tile)
    elif dirichlet:
        y, x, _ = _ring_apply(ring2d_lib, 1, [Ks[0], Ms[1], Ms[0], Ks[1]], p,
                              mode, u64, True, tile, dim=2)
    else:
        tables = torch.as_tensor(tks.band_tables(mats, p), dtype=compute)
        if tile is None:
            tile = tks.choose_tile(dim, p, tables.element_size(),
                                   host_lib.host_smem_elems)
        u = u64.to(storage)
        y = torch.empty_like(u)
        rc = host_lib.host_apply(code, dim, p, npts, *tile, u.data_ptr(),
                                 y.data_ptr(), tables.data_ptr())
        assert rc == 0, "kernel wrote beyond its shared memory"
        y, x = y.to(torch.float64), u.to(torch.float64)
    ref = _plain(dim, npts, Ks, Ms, x, dirichlet)
    err = (y - ref).abs().max() / ref.abs().max()
    assert err <= TOL[mode], err


def test_kernel_host_build_f32_keeps_zero_row_sums(host_lib):
    """A stiffness matrix annihilates constants (every row sums to zero).
    f32-rounded taps alone break that by ~eps·|K| per row, a systematic
    perturbation that shifts the f32 solve's solution; the kernel's
    difference form takes the row sum from the f64 matrix, so A·1 = 0
    holds to f64 rounding in the f32 kernel (a plain f32 tap sum leaves
    ~1e-8 of the scale here)."""
    p, n = 4, 8
    npts = n * p + 1
    K1u, M1u = global_1d_matrices(p, n, p + 1)
    Ks, Ms = [K1u * n] * 3, [M1u / n] * 3
    mats = []
    for a in range(3):
        mats += [Ks[a], Ms[a]]
    tables = torch.as_tensor(tks.band_tables(mats, p), dtype=torch.float32)
    u = torch.ones(npts**3, dtype=torch.float32)
    y = torch.empty_like(u)
    tile = tks.choose_tile(3, p, 4, host_lib.host_smem_elems)
    assert host_lib.host_apply(1, 3, p, npts, *tile, u.data_ptr(),
                               y.data_ptr(), tables.data_ptr()) == 0
    scale = _plain(3, npts, [abs(K) for K in Ks], [abs(M) for M in Ms],
                   u.to(torch.float64), False).max()
    assert y.abs().max() <= 1e-12 * scale


@pytest.mark.parametrize("dim", [2, 3])
def test_tiles_fit_for_every_degree(host_lib, dim):
    """K2's tile chooser, sized by the routine's own shared-memory count,
    finds a block within budget at every degree and compute dtype."""
    for p in range(1, tks.MAX_DEGREE + 1):
        for itemsize in (4, 8):
            tile = tks.choose_tile(dim, p, itemsize, host_lib.host_smem_elems)
            assert (host_lib.host_smem_elems(dim, p, *tile) * itemsize
                    <= tks.SMEM_BUDGET)
            assert dim == 3 or tile[0] == 1


# ---------------------------------------------------------------------
# K1 and K4 on the ring (resident_ring.cuh)
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def ring_lib(tmp_path_factory):
    """K1's and K4's instances of the ring (the 3D resident layout)."""
    return build_ring(tmp_path_factory, "ring_host", ("3d",))


def _ring_apply(lib, plan, mats, p, mode, u64, dirichlet=False, tile=None,
                group=None, ablation=0, *, dim=3, segments=1):
    """Run the host build of the ring routine on the flat f64 ``u64``:
    tables as the wrappers make them (``RingApply``), the layout padded
    with zeros, the output filled with NaN first.  ``tile``: the sub-tile
    (tz, ty), or (tz, ty, segments).  Return (y flat in f64, the
    storage-rounded input flat in f64, the output layout)."""
    code, storage, compute = CODES[mode]
    npts = mats[0].shape[0]
    nt = len(mats) // dim if plan == 1 else 0
    if dirichlet:
        mats = [tks.masked(M) for M in mats]
    tab = tks.ring_tables(mats, p)
    if plan == 1:
        tab = tab.reshape(nt, dim, npts, tab.shape[-1])
    tables = torch.as_tensor(tab, dtype=compute)
    if tile is not None and len(tile) == 3:
        tile, segments = tile[:2], tile[2]
    tiles = ((tks.RING_TILES if dim == 3 else tks.RING_TILES_2D)
             if tile is None else (tile,))
    (tz, ty), g = tks.choose_ring_tile(p, code, nt or None,
                                       *ring_counts(lib, dim), tiles)
    X = tks.resident_x(npts, storage, dim)
    u = torch.zeros((npts,) * (dim - 1) + (X,), dtype=storage)
    u[..., :npts] = u64.reshape((npts,) * dim).to(storage)
    y = torch.full_like(u, float("nan"))  # every point written
    group = group or g
    part = None  # the passes' partial sums, as RingApply.launch makes them
    if nt and group < nt and ablation != tks.RING_ABLATIONS["copy"]:
        part = y if storage == compute else torch.full_like(
            y, float("nan"), dtype=compute)
    rc = lib.host_ring_apply(plan, dim, code, p, npts, X, nt, group, tz, ty,
                             segments, ablation,
                             int(dirichlet), u.data_ptr(), y.data_ptr(),
                             None if part is None else part.data_ptr(),
                             tables.data_ptr())
    assert rc == 0, f"host build returned {rc} (1: wrote beyond its smem)"
    assert torch.isfinite(y).all()
    assert not y[..., npts:].any(), "the pad columns are not zero"
    return (y[..., :npts].reshape(-1).to(torch.float64),
            u[..., :npts].reshape(-1).to(torch.float64), y)


def _terms_plain(terms, x, dirichlet):
    dim, npts = len(terms[0]), terms[0][0].shape[0]
    A = lambda v: laplace_apply_separable_terms(
        v, dim, npts, [[torch.as_tensor(X) for X in t] for t in terms])
    if not dirichlet:
        return A(x)
    m = _mask(npts, dim)
    return m * A(m * x) + (1.0 - m) * x


K1_CASES = ([(p, mode, d) for p in (1, 2, 4, 7, 8) for mode in TOL
             for d in (False, True)])


@pytest.mark.parametrize("p,mode,dirichlet", K1_CASES)
def test_ring_host_k1_matches_plain(ring_lib, p, mode, dirichlet):
    """K1 (the ring's Laplace plan) with and without the fused mask, in
    each storage, on random non-symmetric banded matrices distinct per axis
    and a grid whose rows no chosen sub-tile divides: against the plain
    version in f64 on the same storage-rounded input."""
    npts = 2 * p + 9
    rng = np.random.default_rng(npts * 10 + p)
    Ks = [_nonsym(rng, npts, p) for _ in range(3)]
    Ms = [_nonsym(rng, npts, p) for _ in range(3)]
    mats = []
    for a in range(3):
        mats += [Ks[a], Ms[a]]
    y, x, _ = _ring_apply(ring_lib, 0, mats, p, mode,
                          torch.as_tensor(rng.standard_normal(npts**3)),
                          dirichlet)
    ref = _plain(3, npts, Ks, Ms, x, dirichlet)
    err = (y - ref).abs().max() / ref.abs().max()
    assert err <= TOL[mode], err
    if dirichlet:  # boundary points store their input, bit for bit
        bnd = _mask(npts, 3) == 0
        assert torch.equal(y[bnd], x[bnd])


K4_CASES = ([(T, p, "f64", d) for T in (1, 3, 4, 7) for p in (1, 2, 4, 8)
             for d in (False, True) if (T + p) % 2 or d]
            + [(3, 4, "f32", False), (3, 4, "f32", True), (4, 2, "f32", True),
               (3, 4, "bf16s", False), (3, 4, "bf16s", True),
               (7, 2, "bf16s", True), (9, 1, "f32", False)])


@pytest.mark.parametrize("T,p,mode,dirichlet", K4_CASES)
def test_ring_host_k4_matches_plain(ring_lib, T, p, mode, dirichlet):
    """K4 (the ring's term plan) at T = 1, 3, 4 and CP-sized T: against
    the plain terms apply in f64, with and without the fused mask.  Where T
    exceeds the term group the chooser keeps resident, the block makes
    further passes over x and adds into its own output."""
    npts = 2 * p + 9
    rng = np.random.default_rng(npts * 10 + p + T)
    terms = [[_nonsym(rng, npts, p) for _ in range(3)] for _ in range(T)]
    y, x, _ = _ring_apply(ring_lib, 1, [X for t in terms for X in t], p,
                          mode, torch.as_tensor(rng.standard_normal(npts**3)),
                          dirichlet)
    ref = _terms_plain(terms, x, dirichlet)
    err = (y - ref).abs().max() / ref.abs().max()
    assert err <= TOL[mode], err


@pytest.mark.parametrize("group,mode", [(1, "f64"), (2, "f64"), (3, "f64"),
                                        (3, "f32"), (2, "bf16s")])
def test_ring_host_k4_passes_sum_in_term_order(ring_lib, group, mode):
    """T = 5 terms in groups of 1, 2 or 3 (5, 3 or 2 passes over x), with
    the fused mask: against the plain version in f64, within the storage's
    class (f64 1e-13; bf16s keeps its partial sums in an f32 buffer, so the
    passes add no bf16 rounding)."""
    p, npts, T = 2, 15, 5
    rng = np.random.default_rng(3)
    terms = [[_nonsym(rng, npts, p) for _ in range(3)] for _ in range(T)]
    u = torch.as_tensor(rng.standard_normal(npts**3))
    y, x, _ = _ring_apply(ring_lib, 1, [X for t in terms for X in t], p,
                          mode, u, True, group=group)
    ref = _terms_plain(terms, x, True)
    tol = 1e-13 if mode == "f64" else TOL[mode]
    assert (y - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("mode", ["f64", "f32", "bf16s"])
def test_ring_host_k4_chooser_takes_passes_at_many_terms(ring_lib, mode):
    """At p = 8, 22 terms (chip_smoke.py's PASS_T) hold more windows than
    any sub-tile: the chooser itself takes passes over x, and the result
    with the fused mask stays within the storage's class."""
    p, npts, T = 8, 17, 22
    code = CODES[mode][0]
    (tz, ty), g = tks.choose_ring_tile(p, code, T, *ring_counts(ring_lib))
    assert g < T
    rng = np.random.default_rng(8)
    terms = [[_nonsym(rng, npts, p) for _ in range(3)] for _ in range(T)]
    u = torch.as_tensor(rng.standard_normal(npts**3))
    y, x, _ = _ring_apply(ring_lib, 1, [X for t in terms for X in t], p,
                          mode, u, True)
    ref = _terms_plain(terms, x, True)
    tol = 1e-13 if mode == "f64" else TOL[mode]
    assert (y - ref).abs().max() <= tol * ref.abs().max()


def _takes(lib, p, code):
    """Every (tz, ty) of 1..16 the ring routine takes whose block with
    three windows fits a block's shared memory."""
    smem, takes = ring_counts(lib)
    return [(tz, ty) for tz in range(1, 17) for ty in range(1, 17)
            if takes(p, tz, ty) and smem(p, code, 3, tz, ty)
            <= tks.RING_BUDGET]


@pytest.mark.parametrize("mode", ["f32", "bf16s"])
def test_ring_host_every_subtile_on_a_ragged_grid(ring_lib, mode):
    """K1 with the mask and K4 (3 terms) at every sub-tile the routine
    takes, on a grid of 19 rows that most of them do not divide: every
    output point written (NaN first), pad columns zero, within the class."""
    p, npts = 2, 19
    code = CODES[mode][0]
    rng = np.random.default_rng(5)
    mats = [_nonsym(rng, npts, p) for _ in range(6)]
    terms = [[_nonsym(rng, npts, p) for _ in range(3)] for _ in range(3)]
    u = torch.as_tensor(rng.standard_normal(npts**3))
    tiles = _takes(ring_lib, p, code)
    assert (8, 8) in tiles and (4, 8) in tiles and (1, 8) not in tiles
    for tile in tiles:
        y, x, _ = _ring_apply(ring_lib, 0, mats, p, mode, u, True, tile)
        ref = _plain(3, npts, mats[0::2], mats[1::2], x, True)
        assert (y - ref).abs().max() <= TOL[mode] * ref.abs().max(), tile
        y, x, _ = _ring_apply(ring_lib, 1, [X for t in terms for X in t], p,
                              mode, u, False, tile)
        ref = _terms_plain(terms, x, False)
        assert (y - ref).abs().max() <= TOL[mode] * ref.abs().max(), tile


@pytest.mark.parametrize("p,npts,tile,plan", [
    pytest.param(1, 9, None, 0, id="1-9-None"),
    pytest.param(4, 17, (2, 8), 0, id="4-17-tile1"),  # ragged
    pytest.param(8, 33, None, 0, id="8-33-None"),
    pytest.param(1, 9, None, 1, id="K4-1-9-None"),
    pytest.param(4, 17, (2, 8), 1, id="K4-4-17-tile1"),
    pytest.param(8, 33, None, 1, id="K4-8-33-None")])
def test_kernel_host_copy_ablation_returns_its_input(ring_lib, p, npts, tile,
                                                     plan):
    """The ring's copy ablation (K1's is the kernel lab's ``v5-copy``; K4's
    splits K4's time) stores each point it loaded: y = u bit for bit, pad
    columns included, every point written."""
    rng = np.random.default_rng(p)
    mats = [_nonsym(rng, npts, p) for _ in range(6)]
    u = torch.as_tensor(rng.standard_normal(npts**3))
    _, _, y = _ring_apply(ring_lib, plan, mats, p, "f32", u, tile=tile,
                          ablation=tks.RING_ABLATIONS["copy"])
    assert torch.equal(y[..., :npts].reshape(-1), u.to(torch.float32))


@pytest.mark.parametrize("p,T", [(1, None), (4, None), (2, 1), (4, 3),
                                 (2, 5)])
def test_ring_host_bands_ablation_matches_its_plain_version(ring_lib, p, T):
    """The ring's "bands" ablation (z and y stages, the windows summed at
    x, no x band) against the wrappers' plain version of its function:
    K1 (T None) and K4, 5 terms in passes too."""
    from tpufem_torch.ops.kernel_terms import ResidentTerms

    npts = 2 * p + 9
    rng = np.random.default_rng(p + 7)
    mats = [_nonsym(rng, npts, p) for _ in range(6 if T is None else 3 * T)]
    u = torch.as_tensor(rng.standard_normal(npts**3))
    y, x, _ = _ring_apply(ring_lib, 0 if T is None else 1, mats, p, "f64",
                          u, ablation=tks.RING_ABLATIONS["bands"],
                          group=None if T is None else min(T, 2))
    M = [torch.as_tensor(X) for X in mats]
    terms = ([[M[1], M[3], M[4]], [M[1], M[2], M[5]], [M[0], M[3], M[5]]]
             if T is None else [M[3 * a:3 * a + 3] for a in range(T)])
    ref = laplace_apply_separable_terms(
        x, 3, npts, tks.ablation_terms(terms, npts, torch.float64, "cpu"))
    if T is None:  # the wrapper's plain version of the ablation, in f32
        k = tks.ResidentSeparable(npts, p, mats[0::2], mats[1::2],
                                  torch.float32, mode="bands", device="cpu")
    else:
        k = ResidentTerms(npts, p, [mats[3 * a:3 * a + 3] for a in range(T)],
                          torch.float32, mode="bands", device="cpu")
    yk = k.unpad(k.plain(k.pad(x))).to(torch.float64)
    assert (yk - ref).abs().max() <= 1e-6 * ref.abs().max()
    assert (y - ref).abs().max() <= 1e-13 * ref.abs().max()


def test_ring_host_f32_keeps_zero_row_sums(ring_lib):
    """K1 on the ring keeps A·1 = 0 to f64 rounding in f32 (the row sums
    from the f64 matrices), as K2 does."""
    p, n = 4, 8
    npts = n * p + 1
    K1u, M1u = global_1d_matrices(p, n, p + 1)
    mats = [K1u * n, M1u / n] * 3
    y, _, _ = _ring_apply(ring_lib, 0, mats, p, "f32",
                          torch.ones(npts**3, dtype=torch.float64))
    scale = _plain(3, npts, [abs(K1u * n)] * 3, [abs(M1u / n)] * 3,
                   torch.ones(npts**3, dtype=torch.float64), False).max()
    assert y.abs().max() <= 1e-12 * scale


def test_ring_subtiles_fit_up_to_cp_terms(ring_lib):
    """The ring's chooser finds a sub-tile within budget at every degree
    and storage, for K1 and for K4 up to the 18 terms of a rank-6 CP
    coefficient; at T = 3 and p = 4 in f32 it keeps all three windows at
    (8, 8) with two blocks an SM."""
    smem, takes = ring_counts(ring_lib)
    for p in range(1, tks.MAX_DEGREE + 1):
        for code in (0, 1, 2):
            for nt in (None, 1, 3, 18):
                (tz, ty), g = tks.choose_ring_tile(p, code, nt, smem, takes)
                assert smem(p, code, g, tz, ty) <= tks.RING_BUDGET
                assert g == 2 if nt is None else 1 <= g <= nt
    assert tks.choose_ring_tile(4, 1, 3, smem, takes) == ((8, 8), 3)
    assert smem(4, 1, 3, 8, 8) <= tks.RING_TWO_BLOCKS
    assert tks.choose_ring_tile(4, 1, None, smem, takes)[0] == (8, 8)


@pytest.mark.parametrize("dim,p,npts,n_terms,mode,tile", [
    (3, 1, 9, 1, "f64", None),
    (3, 2, 13, 3, "f64", (2, 8)),  # ragged sub-tiles on both axes
    (3, 4, 17, 3, "f64", None),
    (3, 8, 17, 1, "f64", None),
    (3, 3, 10, 3, "f32", (4, 8)),
    (3, 4, 21, 3, "bf16s", None),
    (2, 1, 9, 1, "f64", None),
    (2, 3, 25, 3, "f64", (1, 16, 2)),  # ragged rows, two segments
    (2, 8, 33, 3, "f64", None),
    (2, 4, 41, 1, "f32", None),
    (2, 2, 70, 3, "bf16s", None),
])
def test_terms_host_build_matches_plain(ring_lib, ring2d_lib, dim, p, npts,
                                        n_terms, mode, tile):
    """K3 (2D) and K4 (3D), both on the ring's terms plan: random
    non-symmetric banded matrices, distinct per term and axis, so a swapped
    axis or term, a transposed band or a boundary-row error shows."""
    rng = np.random.default_rng(npts * 10 + p + n_terms)
    terms = [[_nonsym(rng, npts, p) for _ in range(dim)]
             for _ in range(n_terms)]
    u64 = torch.as_tensor(rng.standard_normal(npts**dim))
    y, x, _ = _ring_apply(ring_lib if dim == 3 else ring2d_lib, 1,
                          [X for t in terms for X in t], p, mode, u64,
                          tile=tile, dim=dim)
    ref = laplace_apply_separable_terms(
        x, dim, npts, [[torch.as_tensor(X) for X in t] for t in terms])
    err = (y - ref).abs().max() / ref.abs().max()
    assert err <= TOL[mode], err


@pytest.mark.parametrize("dim", [2, 3])
def test_terms_host_build_f32_keeps_zero_row_sums(ring_lib, ring2d_lib, dim):
    """The shell's operator annihilates constants (each term has one
    weighted stiffness factor, whose rows sum to zero).  With the row sums
    taken in f64, the f32 kernels (K3 in 2D, K4 in 3D) keep A·1 = 0 to f64
    rounding, as K1 does for the uniform Laplace."""
    p, n = 4, 4
    npts = n * p + 1
    mesh = Mesh.hyper_shell_3d(2) if dim == 3 else Mesh.hyper_shell_2d(2)
    terms = build_separable_metric_terms(p, dim, p + 1, n,
                                         mesh.separable_metric, np.float64)
    ones = torch.ones(npts**dim, dtype=torch.float64)
    y, _, _ = _ring_apply(ring_lib if dim == 3 else ring2d_lib, 1,
                          [X for t in terms for X in t], p, "f32", ones,
                          dim=dim)
    scale = laplace_apply_separable_terms(
        ones, dim, npts,
        [[torch.as_tensor(abs(X)) for X in t] for t in terms]).max()
    assert y.abs().max() <= 1e-12 * scale


def test_terms_tiles_fit_up_to_cp_terms(ring_lib, ring2d_lib):
    """The ring's chooser finds a sub-tile and term group within budget
    for every degree and storage, up to the 18 terms of a rank-6 CP
    coefficient: K3's (1, TY) in 2D, K4's (TZ, TY) in 3D."""
    for p in range(1, tks.MAX_DEGREE + 1):
        for code in (1, 0, 2):
            for nt in (1, 3, 18):
                for dim, lib in ((2, ring2d_lib), (3, ring_lib)):
                    smem, takes = ring_counts(lib, dim)
                    (tz, ty), g = tks.choose_ring_tile(
                        p, code, nt, smem, takes,
                        tks.RING_TILES if dim == 3 else tks.RING_TILES_2D)
                    assert smem(p, code, g, tz, ty) <= tks.RING_BUDGET \
                        and 1 <= g <= nt and (dim == 3 or tz == 1)


@pytest.mark.parametrize("name", sorted(build.SOURCES))
def test_build_hash_covers_the_included_headers(name):
    """Each library's hash lists exactly the csrc/ headers its source
    includes (transitively), so an edited header rebuilds the libraries
    that include it, and only those."""
    import re

    source, headers = build.SOURCES[name]
    seen, todo = set(), [source]
    while todo:
        text = (CSRC / todo.pop()).read_text()
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            if inc not in seen:
                seen.add(inc)
                todo.append(inc)
    assert seen == set(headers)
