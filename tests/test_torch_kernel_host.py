"""The CUDA routine of K1/K2 (tpufem_torch/csrc/separable_apply.cuh),
compiled for the CPU with g++ and held against the plain PyTorch version.

Every stage of the kernel is a loop ``for (i = threadIdx.x; i < n; i +=
blockDim.x)`` between ``__syncthreads()``, so one thread running each
block in turn computes exactly what a block of 256 threads computes on
the card.  The stub header below defines the CUDA built-ins for that
(qualifiers, ``threadIdx``/``blockIdx``/``blockDim``, a no-op
``__syncthreads``, round-to-nearest-even bf16 conversions).  This holds
the kernel's indexing, halo, band tables, fused mask and storage
conversions to the plain version on every run of the CPU tests; the
card itself (launch configuration, shared-memory limits) is covered by
``chip_smoke.py``.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpufem_torch.ops import kernel_separable as tks
from tpufem_torch.ops.separable import global_1d_matrices, laplace_apply_separable
from tpufem_torch.utils.build import CSRC

HOST_SHIM = r"""
#include <cstdint>
#include <cstring>
struct Dim3 { int x, y, z; };
static Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(n)
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
#include "separable_apply.cuh"

template <int P, int DIM, typename S, typename C>
static int run(int npts, int dirichlet, int tz, int ty, int tx,
               const void* u, void* y, const void* tables) {
  const long long bytes = tpufem::smem_elems(DIM, P, tz, ty, tx) * sizeof(C);
  const int gx = (npts + tx - 1) / tx, gy = (npts + ty - 1) / ty;
  const int gz = DIM == 3 ? (npts + tz - 1) / tz : 1;
  for (int bz = 0; bz < gz; ++bz)
    for (int by = 0; by < gy; ++by)
      for (int bx = 0; bx < gx; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, sizeof(tpufem::smem_raw));
        blockIdx = Dim3{bx, by, bz};
        tpufem::separable_apply_kernel<P, DIM, S, C>(
            (const S*)u, (S*)y, (const C*)tables, npts, dirichlet, tz, ty, tx);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

template <int DIM, typename S, typename C>
static int by_p(int p, int npts, int d, int tz, int ty, int tx,
                const void* u, void* y, const void* t) {
  switch (p) {
    case 1: return run<1, DIM, S, C>(npts, d, tz, ty, tx, u, y, t);
    case 2: return run<2, DIM, S, C>(npts, d, tz, ty, tx, u, y, t);
    case 3: return run<3, DIM, S, C>(npts, d, tz, ty, tx, u, y, t);
    case 4: return run<4, DIM, S, C>(npts, d, tz, ty, tx, u, y, t);
    case 7: return run<7, DIM, S, C>(npts, d, tz, ty, tx, u, y, t);
    case 8: return run<8, DIM, S, C>(npts, d, tz, ty, tx, u, y, t);
  }
  return 2;
}

template <int DIM>
static int by_dtype(int code, int p, int npts, int d, int tz, int ty, int tx,
                    const void* u, void* y, const void* t) {
  if (code == 0) return by_p<DIM, double, double>(p, npts, d, tz, ty, tx, u, y, t);
  if (code == 1) return by_p<DIM, float, float>(p, npts, d, tz, ty, tx, u, y, t);
  return by_p<DIM, __nv_bfloat16, float>(p, npts, d, tz, ty, tx, u, y, t);
}

extern "C" int host_apply(int code, int dim, int p, int npts, int d, int tz,
                          int ty, int tx, const void* u, void* y,
                          const void* t) {
  return dim == 3 ? by_dtype<3>(code, p, npts, d, tz, ty, tx, u, y, t)
                  : by_dtype<2>(code, p, npts, d, 1, ty, tx, u, y, t);
}

extern "C" long long host_smem_elems(int dim, int p, int tz, int ty, int tx) {
  return tpufem::smem_elems(dim, p, tz, ty, tx);
}
"""

CODES = {"f64": (0, torch.float64, torch.float64),
         "f32": (1, torch.float32, torch.float32),
         "bf16s": (2, torch.bfloat16, torch.float32)}
TOL = {"f64": 1e-13, "f32": 1e-6, "bf16s": 4e-3}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host build of the CUDA routine "
                    "needs a C++17 compiler")
    d = tmp_path_factory.mktemp("kernel_host")
    (d / "shim.cpp").write_text(HOST_SHIM)
    lib_path = d / "libkernel_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}",
                    "-o", str(lib_path), str(d / "shim.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.host_apply.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
    lib.host_apply.restype = ctypes.c_int
    lib.host_smem_elems.argtypes = [ctypes.c_int] * 5
    lib.host_smem_elems.restype = ctypes.c_longlong
    return lib


def _nonsym(rng, npts, p):
    i, j = np.indices((npts, npts))
    return np.where(np.abs(i - j) <= p, rng.standard_normal((npts, npts)), 0.0)


def _plain(dim, npts, Ks, Ms, u64, dirichlet):
    K = [torch.as_tensor(k) for k in Ks]
    M = [torch.as_tensor(m) for m in Ms]
    A = lambda v: laplace_apply_separable(v, dim, npts, K, M)
    if not dirichlet:
        return A(u64)
    g = torch.arange(npts)
    m1 = ((g != 0) & (g != npts - 1)).double()
    m = m1
    for _ in range(dim - 1):
        m = torch.outer(m1, m.reshape(-1))
    m = m.reshape(-1)
    return m * A(m * u64) + (1.0 - m) * u64


@pytest.mark.parametrize("dim,p,npts,mode,dirichlet,tile", [
    (3, 1, 9, "f64", False, None),
    (3, 2, 13, "f64", True, None),
    (3, 4, 17, "f64", True, (3, 5, 7)),  # ragged tiles on every axis
    (3, 7, 15, "f64", False, None),
    (3, 8, 17, "f64", True, None),
    (3, 3, 10, "f32", False, (2, 3, 4)),
    (3, 4, 33, "f32", True, None),
    (3, 4, 21, "bf16s", True, None),
    (2, 1, 9, "f64", False, None),
    (2, 3, 25, "f64", True, None),
    (2, 8, 33, "f64", False, (1, 5, 7)),
    (2, 4, 41, "f32", False, None),
    (2, 2, 70, "bf16s", True, None),
])
def test_kernel_host_build_matches_plain(host_lib, dim, p, npts, mode,
                                         dirichlet, tile):
    """Random non-symmetric banded matrices, distinct per axis: an axis
    swap, a transposed band or a boundary-row error shows."""
    code, storage, compute = CODES[mode]
    rng = np.random.default_rng(npts * 10 + p)
    Ks = [_nonsym(rng, npts, p) for _ in range(dim)]
    Ms = [_nonsym(rng, npts, p) for _ in range(dim)]
    mats = []
    for a in range(dim):
        mats += [Ks[a], Ms[a]]
    tables = torch.as_tensor(tks.band_tables(mats, p), dtype=compute)
    if tile is None:
        tile = tks.choose_tile(dim, p, tables.element_size(),
                               host_lib.host_smem_elems)
    u = torch.as_tensor(rng.standard_normal(npts**dim)).to(storage)
    y = torch.empty_like(u)
    rc = host_lib.host_apply(code, dim, p, npts, int(dirichlet), *tile,
                             u.data_ptr(), y.data_ptr(), tables.data_ptr())
    assert rc == 0, "kernel wrote beyond its shared memory"
    ref = _plain(dim, npts, Ks, Ms, u.to(torch.float64), dirichlet)
    err = (y.to(torch.float64) - ref).abs().max() / ref.abs().max()
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
    assert host_lib.host_apply(1, 3, p, npts, 0, *tile, u.data_ptr(),
                               y.data_ptr(), tables.data_ptr()) == 0
    scale = _plain(3, npts, [abs(K) for K in Ks], [abs(M) for M in Ms],
                   u.to(torch.float64), False).max()
    assert y.abs().max() <= 1e-12 * scale


@pytest.mark.parametrize("dim", [2, 3])
def test_tiles_fit_for_every_degree(host_lib, dim):
    """The tile chooser, sized by the routine's own shared-memory count,
    finds a block within budget at every degree and compute dtype."""
    for p in range(1, tks.MAX_DEGREE + 1):
        for itemsize in (4, 8):
            tile = tks.choose_tile(dim, p, itemsize, host_lib.host_smem_elems)
            assert (host_lib.host_smem_elems(dim, p, *tile) * itemsize
                    <= tks.SMEM_BUDGET)
            assert dim == 3 or tile[0] == 1
