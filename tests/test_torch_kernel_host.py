"""The CUDA routines of K2 (tpufem_torch/csrc/separable_apply.cuh), K3
(terms_apply.cuh) and K1/K4 (the TMA ring, resident_ring.cuh), compiled
for the CPU with g++ and held against the plain PyTorch versions.

Every stage of the K2/K3 kernels is a loop ``for (i = threadIdx.x; i < n;
i += blockDim.x)`` between ``__syncthreads()``, so one thread running each
block in turn computes exactly what a block of 256 threads computes on
the card.  The stub header below defines the CUDA built-ins for that
(qualifiers, ``threadIdx``/``blockIdx``/``blockDim``, a no-op
``__syncthreads``, round-to-nearest-even bf16 conversions).  The ring
routine runs through csrc/hopper.cuh's host forms: a TMA box load is a
loop copy with zero fill (negative coordinates included), a box store one
with clipping, the mbarrier calls do nothing, and one host thread runs
the producer's step, then each warp's piece, lane by lane.  This holds the
kernels' indexing, halo, band tables, term loop and passes, fused mask,
resident layout and storage conversions to the plain version on every run
of the CPU tests; the card itself (launch configuration, shared-memory
limits, TMA) is covered by ``chip_smoke.py``.
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


TERMS_SHIM = STUBS + r"""
#include "terms_apply.cuh"

template <int P, typename S, typename C>
static int run(int nt, int npts, int ty, int tx, const void* u, void* y,
               const void* tables) {
  const long long bytes = tpufem::terms_smem_elems(P, nt, ty, tx) * sizeof(C);
  const int gx = (npts + tx - 1) / tx, gy = (npts + ty - 1) / ty;
  for (int by = 0; by < gy; ++by)
    for (int bx = 0; bx < gx; ++bx) {
      std::memset(tpufem::smem_raw, 0xAB, sizeof(tpufem::smem_raw));
      blockIdx = Dim3{bx, by, 0};
      tpufem::terms_apply_kernel<P, S, C>((const S*)u, (S*)y, (const C*)tables,
                                          nt, npts, ty, tx);
      for (long long i = bytes; i < bytes + 4096; ++i)
        if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
    }
  return 0;
}

template <typename S, typename C>
static int by_p(int p, int nt, int npts, int ty, int tx, const void* u,
                void* y, const void* t) {
  switch (p) {
    case 1: return run<1, S, C>(nt, npts, ty, tx, u, y, t);
    case 2: return run<2, S, C>(nt, npts, ty, tx, u, y, t);
    case 3: return run<3, S, C>(nt, npts, ty, tx, u, y, t);
    case 4: return run<4, S, C>(nt, npts, ty, tx, u, y, t);
    case 8: return run<8, S, C>(nt, npts, ty, tx, u, y, t);
  }
  return 2;
}

extern "C" int host_terms_apply(int code, int p, int nt, int npts, int ty,
                                int tx, const void* u, void* y,
                                const void* t) {
  if (code == 0) return by_p<double, double>(p, nt, npts, ty, tx, u, y, t);
  if (code == 1) return by_p<float, float>(p, nt, npts, ty, tx, u, y, t);
  return by_p<__nv_bfloat16, float>(p, nt, npts, ty, tx, u, y, t);
}

extern "C" long long host_terms_smem_elems(int p, int nt, int ty, int tx) {
  return tpufem::terms_smem_elems(p, nt, ty, tx);
}
"""

RING_SHIM = STUBS + r"""
#define __syncwarp()
#define __grid_constant__
#include "resident_ring.cuh"

template <int P, typename S, typename C, int PLAN>
static int run(int mode, tpufem::ResGeo g, const void* u, void* y, void* part,
               const void* tab) {
  if (!tpufem::res_takes(P, g.tz, g.ty)) return 3;
  const int xc = tpufem::ring_xc(sizeof(S));
  const tpufem::RingPieces pc = tpufem::ring_pieces(g.tz, g.ty);
  tpufem::HopMap in_map, out_map;  // the launcher's two maps
  const long long dim[3] = {g.X, g.npts, g.npts};
  const int in_box[3] = {xc, g.ty + 2 * P, g.tz + 2 * P};
  const int out_box[3] = {xc, pc.by, pc.bz};
  tpufem::hop_map_3d(&in_map, (void*)u, sizeof(S), dim, in_box);
  tpufem::hop_map_3d(&out_map, y, sizeof(S), dim, out_box);
  const int nwin = PLAN == tpufem::kPlanTerms ? g.group : 2;
  const long long bytes =
      tpufem::res_smem(P, sizeof(S), sizeof(C), nwin, g.tz, g.ty).total;
  for (int bz = 0; bz < (g.npts + g.tz - 1) / g.tz; ++bz)
    for (int by = 0; by < (g.npts + g.ty - 1) / g.ty; ++by) {
      // NaN in the block's own shared memory: a read of a point no stage
      // wrote shows in the output
      std::memset(tpufem::smem_raw, 0xFF, bytes);
      std::memset(tpufem::smem_raw + bytes, 0xAB, 4096);
      blockIdx = Dim3{by, bz, 0};
      tpufem::resident_ring_kernel<P, S, C, PLAN>(
          in_map, out_map, (const S*)u, (C*)part, (const C*)tab, g, mode);
      for (long long i = bytes; i < bytes + 4096; ++i)
        if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
    }
  return 0;
}

template <typename S, typename C, int PLAN>
static int by_p(int p, int mode, tpufem::ResGeo g, const void* u, void* y,
                void* q, const void* t) {
  switch (p) {
    case 1: return run<1, S, C, PLAN>(mode, g, u, y, q, t);
    case 2: return run<2, S, C, PLAN>(mode, g, u, y, q, t);
    case 3: return run<3, S, C, PLAN>(mode, g, u, y, q, t);
    case 4: return run<4, S, C, PLAN>(mode, g, u, y, q, t);
    case 7: return run<7, S, C, PLAN>(mode, g, u, y, q, t);
    case 8: return run<8, S, C, PLAN>(mode, g, u, y, q, t);
  }
  return 2;
}

template <int PLAN>
static int by_dtype(int code, int p, int mode, tpufem::ResGeo g,
                    const void* u, void* y, void* q, const void* t) {
  if (code == 0) return by_p<double, double, PLAN>(p, mode, g, u, y, q, t);
  if (code == 1) return by_p<float, float, PLAN>(p, mode, g, u, y, q, t);
  return by_p<__nv_bfloat16, float, PLAN>(p, mode, g, u, y, q, t);
}

extern "C" int host_ring_apply(int plan, int code, int p, int npts, int X,
                               int nt, int group, int tz, int ty, int mode,
                               int dirichlet, const void* u, void* y,
                               void* part, const void* t) {
  const tpufem::ResGeo g{npts, X, tz, ty, nt, group, dirichlet};
  return plan == 0 ? by_dtype<0>(code, p, mode, g, u, y, part, t)
                   : by_dtype<1>(code, p, mode, g, u, y, part, t);
}

static int bytes_of(int code) { return code == 0 ? 8 : code == 1 ? 4 : 2; }

extern "C" long long host_ring_smem_bytes(int p, int code, int nwin, int tz,
                                          int ty) {
  return tpufem::res_smem(p, bytes_of(code), code == 0 ? 8 : 4, nwin, tz, ty)
      .total;
}

extern "C" int host_ring_takes(int p, int tz, int ty) {
  return tpufem::res_takes(p, tz, ty) ? 1 : 0;
}
"""


def _build(tmp_path_factory, name, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA routine "
                    "needs a C++17 compiler")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.cpp").write_text(source)
    lib_path = d / f"lib{name}.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}",
                    "-o", str(lib_path), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib_path))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "kernel_host", HOST_SHIM)
    lib.host_apply.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    lib.host_apply.restype = ctypes.c_int
    lib.host_smem_elems.argtypes = [ctypes.c_int] * 5
    lib.host_smem_elems.restype = ctypes.c_longlong
    return lib


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
def test_kernel_host_build_matches_plain(host_lib, ring_lib, terms_lib, dim,
                                         p, npts, mode, dirichlet, tile):
    """The Laplace apply on random non-symmetric banded matrices, distinct
    per axis: an axis swap, a transposed band or a boundary-row error
    shows.  Unmasked: K2 on the flat grid.  With the Dirichlet mask, the
    resident kernel that carries it: in 3D K1 on the ring, the mask fused;
    in 2D K3 on the two-term factorisation, the mask algebra around it."""
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
        m = _mask(npts, 2)
        x = u64.to(storage).to(torch.float64)
        ym, _ = _terms_host_apply(terms_lib, [[Ks[0], Ms[1]], [Ms[0], Ks[1]]],
                                  p, mode, m * x, tile)
        y = m * ym + (1.0 - m) * x
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
    lib = _build(tmp_path_factory, "ring_host", RING_SHIM)
    lib.host_ring_apply.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 4
    lib.host_ring_apply.restype = ctypes.c_int
    lib.host_ring_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.host_ring_smem_bytes.restype = ctypes.c_longlong
    lib.host_ring_takes.argtypes = [ctypes.c_int] * 3
    lib.host_ring_takes.restype = ctypes.c_int
    return lib


def _ring_apply(lib, plan, mats, p, mode, u64, dirichlet=False, tile=None,
                group=None, ablation=0):
    """Run the host build of the ring routine on the flat f64 ``u64``:
    tables as the wrappers make them (``RingApply``), the resident layout
    padded with zeros, the output filled with NaN first.  Return (y flat in
    f64, the storage-rounded input flat in f64, the output layout)."""
    code, storage, compute = CODES[mode]
    npts = mats[0].shape[0]
    nt = len(mats) // 3 if plan == 1 else 0
    if dirichlet:
        mats = [tks.masked(M) for M in mats]
    tab = tks.ring_tables(mats, p)
    if plan == 1:
        tab = tab.reshape(nt, 3, npts, tab.shape[-1])
    tables = torch.as_tensor(tab, dtype=compute)
    tiles = tks.RING_TILES if tile is None else (tile,)
    (tz, ty), g = tks.choose_ring_tile(p, code, nt or None,
                                       lib.host_ring_smem_bytes,
                                       lib.host_ring_takes, tiles)
    X = tks.resident_x(npts, storage)
    u = torch.zeros((npts, npts, X), dtype=storage)
    u[..., :npts] = u64.reshape((npts,) * 3).to(storage)
    y = torch.full_like(u, float("nan"))  # every point written
    group = group or g
    part = None  # the passes' partial sums, as RingApply.launch makes them
    if nt and group < nt and ablation != tks.RING_ABLATIONS["copy"]:
        part = y if storage == compute else torch.full_like(
            y, float("nan"), dtype=compute)
    rc = lib.host_ring_apply(plan, code, p, npts, X, nt, group, tz, ty,
                             ablation, int(dirichlet), u.data_ptr(),
                             y.data_ptr(),
                             None if part is None else part.data_ptr(),
                             tables.data_ptr())
    assert rc == 0, "kernel wrote beyond its shared memory"
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
    (tz, ty), g = tks.choose_ring_tile(p, code, T,
                                       ring_lib.host_ring_smem_bytes,
                                       ring_lib.host_ring_takes)
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
    return [(tz, ty) for tz in range(1, 17) for ty in range(1, 17)
            if lib.host_ring_takes(p, tz, ty)
            and lib.host_ring_smem_bytes(p, code, 3, tz, ty)
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
    for p in range(1, tks.MAX_DEGREE + 1):
        for code in (0, 1, 2):
            for nt in (None, 1, 3, 18):
                (tz, ty), g = tks.choose_ring_tile(
                    p, code, nt, ring_lib.host_ring_smem_bytes,
                    ring_lib.host_ring_takes)
                assert ring_lib.host_ring_smem_bytes(p, code, g, tz, ty) \
                    <= tks.RING_BUDGET
                assert g == 2 if nt is None else 1 <= g <= nt
    assert tks.choose_ring_tile(4, 1, 3, ring_lib.host_ring_smem_bytes,
                                ring_lib.host_ring_takes) == ((8, 8), 3)
    assert ring_lib.host_ring_smem_bytes(4, 1, 3, 8, 8) <= tks.RING_TWO_BLOCKS
    assert tks.choose_ring_tile(4, 1, None, ring_lib.host_ring_smem_bytes,
                                ring_lib.host_ring_takes)[0] == (8, 8)


@pytest.fixture(scope="module")
def terms_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "terms_host", TERMS_SHIM)
    lib.host_terms_apply.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    lib.host_terms_apply.restype = ctypes.c_int
    lib.host_terms_smem_elems.argtypes = [ctypes.c_int] * 4
    lib.host_terms_smem_elems.restype = ctypes.c_longlong
    return lib


def _terms_host_apply(lib, terms, p, mode, u64, tile=None):
    """Run the host build of the K3 routine (2D) on f64 ``u64``; return
    (y in f64, the storage-rounded input in f64)."""
    code, storage, compute = CODES[mode]
    npts, nt = terms[0][0].shape[0], len(terms)
    tables = torch.as_tensor(
        tks.band_tables([X for t in terms for X in t], p).reshape(
            nt, 2, npts, 2 * p + 2), dtype=compute)
    if tile is None:
        tile = tks.choose_tile(
            2, p, tables.element_size(),
            lambda d, pp, tz, ty, tx: lib.host_terms_smem_elems(pp, nt, ty,
                                                                tx))
    u = u64.to(storage)
    y = torch.empty_like(u)
    rc = lib.host_terms_apply(code, p, nt, npts, tile[1], tile[2],
                              u.data_ptr(), y.data_ptr(), tables.data_ptr())
    assert rc == 0, "kernel wrote beyond its shared memory"
    return y.to(torch.float64), u.to(torch.float64)


@pytest.mark.parametrize("dim,p,npts,n_terms,mode,tile", [
    (3, 1, 9, 1, "f64", None),
    (3, 2, 13, 3, "f64", (2, 8)),  # ragged sub-tiles on both axes
    (3, 4, 17, 3, "f64", None),
    (3, 8, 17, 1, "f64", None),
    (3, 3, 10, 3, "f32", (4, 8)),
    (3, 4, 21, 3, "bf16s", None),
    (2, 1, 9, 1, "f64", None),
    (2, 3, 25, 3, "f64", (1, 5, 7)),
    (2, 8, 33, 3, "f64", None),
    (2, 4, 41, 1, "f32", None),
    (2, 2, 70, 3, "bf16s", None),
])
def test_terms_host_build_matches_plain(terms_lib, ring_lib, dim, p, npts,
                                        n_terms, mode, tile):
    """K3 (2D, terms_apply.cuh) and K4 (3D, the ring): random non-symmetric
    banded matrices, distinct per term and axis, so a swapped axis or
    term, a transposed band or a boundary-row error shows."""
    rng = np.random.default_rng(npts * 10 + p + n_terms)
    terms = [[_nonsym(rng, npts, p) for _ in range(dim)]
             for _ in range(n_terms)]
    u64 = torch.as_tensor(rng.standard_normal(npts**dim))
    if dim == 3:
        y, x, _ = _ring_apply(ring_lib, 1, [X for t in terms for X in t], p,
                              mode, u64, tile=tile)
    else:
        y, x = _terms_host_apply(terms_lib, terms, p, mode, u64, tile)
    ref = laplace_apply_separable_terms(
        x, dim, npts, [[torch.as_tensor(X) for X in t] for t in terms])
    err = (y - ref).abs().max() / ref.abs().max()
    assert err <= TOL[mode], err


@pytest.mark.parametrize("dim", [2, 3])
def test_terms_host_build_f32_keeps_zero_row_sums(terms_lib, ring_lib, dim):
    """The shell's operator annihilates constants (each term has one
    weighted stiffness factor, whose rows sum to zero).  With the row sums
    taken in f64, the f32 kernels (K3 in 2D, K4 on the ring in 3D) keep
    A·1 = 0 to f64 rounding, as K1 does for the uniform Laplace."""
    p, n = 4, 4
    npts = n * p + 1
    mesh = Mesh.hyper_shell_3d(2) if dim == 3 else Mesh.hyper_shell_2d(2)
    terms = build_separable_metric_terms(p, dim, p + 1, n,
                                         mesh.separable_metric, np.float64)
    ones = torch.ones(npts**dim, dtype=torch.float64)
    if dim == 3:
        y, _, _ = _ring_apply(ring_lib, 1, [X for t in terms for X in t], p,
                              "f32", ones)
    else:
        y, _ = _terms_host_apply(terms_lib, terms, p, "f32", ones)
    scale = laplace_apply_separable_terms(
        ones, dim, npts,
        [[torch.as_tensor(abs(X)) for X in t] for t in terms]).max()
    assert y.abs().max() <= 1e-12 * scale


def test_terms_tiles_fit_up_to_cp_terms(terms_lib, ring_lib):
    """The tile choosers find a block within budget for every degree and
    compute dtype, up to the 18 terms of a rank-6 CP coefficient: K3's
    tile chooser in 2D, the ring's sub-tile and term group in 3D."""
    for p in range(1, tks.MAX_DEGREE + 1):
        for itemsize, code in ((4, 1), (8, 0), (4, 2)):
            for nt in (1, 3, 18):
                count = (lambda d, pp, tz, ty, tx, nt=nt:
                         terms_lib.host_terms_smem_elems(pp, nt, ty, tx))
                tile = tks.choose_tile(2, p, itemsize, count)
                assert count(2, p, *tile) * itemsize <= tks.SMEM_BUDGET
                (tz, ty), g = tks.choose_ring_tile(
                    p, code, nt, ring_lib.host_ring_smem_bytes,
                    ring_lib.host_ring_takes)
                assert ring_lib.host_ring_smem_bytes(p, code, g, tz, ty) \
                    <= tks.RING_BUDGET and 1 <= g <= nt


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
