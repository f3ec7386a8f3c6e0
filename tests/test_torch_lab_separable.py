"""The K2 kernel lab's x-first half (L2a: v2, v3, v6, v8, v9, v12, vx, vxy)
on the CPU: the port's plain version against the Pallas kernels of
``scripts/kernel_lab.py`` in interpret mode, the copied tile slices, the
entry point's refusal without a card, the routines' shared-memory counts,
and g++ builds of the CUDA routines (tpufem_torch/csrc/lab_separable.cuh;
the rings of v3, vxy, v2 (v6, v8, v9) and v12, lab_separable_ring.cuh,
through hopper.cuh's host forms: a TMA box a loop copy with zero fill, a
bulk copy a memcpy, an mbarrier call nothing, a wgmma operand or
accumulator its whole tile, one thread each pass's load, x stage and both
warpgroups' products in turn, then every column's bands) against the plain
version; v2's and v12's rings bit for bit across their z segments, and v6,
v8 and v9 bit for bit v2 there.

``scripts/kernel_lab.py`` is imported by path and its module's
``pl.pallas_call`` replaced by ``partial(pl.pallas_call, interpret=True)``;
nothing in ``scripts/`` changes.  The host build runs one thread per block
with the WMMA stub of test_torch_lab.py (one host thread stands for a
warp).
"""

import ctypes
import functools
import importlib.util
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_host import STUBS, _build
from test_torch_lab import WMMA_STUBS

from tpufem_torch.lab import kernel_lab, separable_lab
from tpufem_torch.lab.separable_lab import LabKernel
from tpufem_torch.ops.separable import global_1d_matrices
from torch_threads import one_torch_thread  # noqa: F401

L2_SHIM = STUBS + WMMA_STUBS + r"""
#define __grid_constant__
#include "lab_separable.cuh"
#include "lab_separable_ring.cuh"

template <int P, int XP>
static int run(int flags, tpufem::L2Geo g, const void* u, void* y,
               const void* xk, long long xk_lo, const void* xb,
               long long xb_part, const void* sl, long long sl_lo,
               const void* tab) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  const long long bytes = tpufem::l2_smem(P, XP, g.b, flags).total;
  const int nxb = tpufem::l2_nxb(flags);  // 2: vx on the ring
  const bool vx = ((flags >> 3) & 3) == 1 && !(flags & tpufem::kL2XBand);
  for (int bz = 0; bz < g.nt; ++bz)
    for (int by = 0; by < g.nt; ++by)
      for (int bx = 0; bx < (g.X / tpufem::kL2XC + nxb - 1) / nxb; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
        blockIdx = Dim3{bx, by, bz};
        if (vx)  // its own kernel, as the launcher
          tpufem::l2_x_kernel<XP>((const C*)u, (C*)y, (const E*)xk, xk_lo,
                                  (const E*)xb, xb_part, g, flags);
        else
          tpufem::l2_kernel<P, XP>((const C*)u, (C*)y, (const E*)xk, xk_lo,
                                   (const E*)xb, xb_part, (const E*)sl, sl_lo,
                                   (const C*)tab, g, flags);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

template <int XP>
static int by_p(int p, int flags, tpufem::L2Geo g, const void* u, void* y,
                const void* xk, long long xl, const void* xb, long long xbp,
                const void* sl, long long sll, const void* t) {
  switch (p) {
    case 1: return run<1, XP>(flags, g, u, y, xk, xl, xb, xbp, sl, sll,
                              t);
    case 2: return run<2, XP>(flags, g, u, y, xk, xl, xb, xbp, sl, sll,
                              t);
    case 4: return run<4, XP>(flags, g, u, y, xk, xl, xb, xbp, sl, sll,
                              t);
    case 7: return run<7, XP>(flags, g, u, y, xk, xl, xb, xbp, sl, sll,
                              t);
  }
  return 2;
}

extern "C" int host_l2_apply(int flags, int xp, int p, int npts, int b,
                             int nt, int size, int X, const void* u, void* y,
                             const void* xk, long long xk_lo, const void* xb,
                             long long xb_part, const void* sl,
                             long long sl_lo, const void* t) {
  const int L = b + 2 * p;
  const tpufem::L2Geo g{npts, b, nt, size, X, L, tpufem::l2_round16(L),
                        tpufem::l2_round16(b)};
  if (!(flags & (tpufem::kL2XBand | tpufem::kL2XJobs)) &&
      g.LP > tpufem::kL2MaxLP)
    return 4;  // as the launcher: the ring's accumulators cover kL2MaxLP rows
  switch (xp) {
    case 0: return by_p<0>(p, flags, g, u, y, xk, xk_lo, xb, xb_part, sl,
                            sl_lo, t);
    case 1: return by_p<1>(p, flags, g, u, y, xk, xk_lo, xb, xb_part, sl,
                            sl_lo, t);
    case 2: return by_p<2>(p, flags, g, u, y, xk, xk_lo, xb, xb_part, sl,
                            sl_lo, t);
    case 3: return by_p<3>(p, flags, g, u, y, xk, xk_lo, xb, xb_part, sl,
                            sl_lo, t);
    case 4: return by_p<4>(p, flags, g, u, y, xk, xk_lo, xb, xb_part, sl,
                            sl_lo, t);
  }
  return 2;
}

extern "C" long long host_l2_smem_bytes(int p, int xp, int b, int flags) {
  return tpufem::l2_smem(p, xp, b, flags).total;
}

// v3's ring routine, one host thread a block, as its launcher: the input
// layout's tensor map in the pass's boxes, grid (ceil(X / XC), nt, nt)
template <int P, int XP>
static int ring(tpufem::BxGeo g, int nu, const void* u, void* y,
                const void* tab, const void* bop) {
  using C = typename tpufem::LabMma<XP>::C;
  constexpr int XC = tpufem::bx_xc(XP);
  const long long bytes = tpufem::bx_smem(P, XP, nu).total;
  tpufem::HopMap in_map;
  const long long dim[3] = {g.X, g.size, g.size};
  const int box[3] = {XC + 2 * tpufem::bx_ph(P, XP), tpufem::bx_lp(P, XP),
                      tpufem::kBxZC};
  tpufem::hop_map_3d(&in_map, (void*)u, sizeof(C), dim, box);
  for (int bz = 0; bz < g.nt; ++bz)
    for (int by = 0; by < g.nt; ++by)
      for (int bx = 0; bx < (g.X + XC - 1) / XC; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
        blockIdx = Dim3{bx, by, bz};
        tpufem::l2_bx_kernel<P, XP>(in_map, (C*)y, (const C*)tab,
                                    (const unsigned char*)bop, g, nu);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

// the instances the cases use: f64 at p = 1, 2, 4, 7, 8; the split and
// single products at p = 4 (3xTF32 also at 2 and 7)
extern "C" int host_l2_ring_apply(int xp, int p, int npts, int b, int nt,
                                  int size, int X, int nu, const void* u,
                                  void* y, const void* t, const void* bop) {
  const tpufem::BxGeo g{npts, b, nt, size, X};
  if (xp == 3) {
    switch (p) {
      case 1: return ring<1, 3>(g, nu, u, y, t, bop);
      case 2: return ring<2, 3>(g, nu, u, y, t, bop);
      case 4: return ring<4, 3>(g, nu, u, y, t, bop);
      case 7: return ring<7, 3>(g, nu, u, y, t, bop);
      case 8: return ring<8, 3>(g, nu, u, y, t, bop);
    }
  } else if (xp == 0) {
    switch (p) {
      case 2: return ring<2, 0>(g, nu, u, y, t, bop);
      case 4: return ring<4, 0>(g, nu, u, y, t, bop);
      case 7: return ring<7, 0>(g, nu, u, y, t, bop);
    }
  } else if (p == 4) {
    switch (xp) {
      case 1: return ring<4, 1>(g, nu, u, y, t, bop);
      case 2: return ring<4, 2>(g, nu, u, y, t, bop);
      case 4: return ring<4, 4>(g, nu, u, y, t, bop);
    }
  }
  return 2;
}

extern "C" long long host_l2_ring_smem_bytes(int p, int xp, int nu) {
  return tpufem::bx_smem(p, xp, nu).total;
}
extern "C" int host_l2_ring_k(int p, int xp) { return tpufem::bx_lp(p, xp); }

// vxy's ring routine, one host thread a block, as its launcher: grid
// (ceil(X / XC), nt, nt)
template <int P, int XP>
static int ring_xy(tpufem::BxGeo g, const void* u, void* y, const void* xb,
                   long long xb_part, const void* bop) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  constexpr int XC = tpufem::bx_xc(XP);
  const long long bytes = tpufem::bxy_smem(P, XP).total;
  for (int bz = 0; bz < g.nt; ++bz)
    for (int by = 0; by < g.nt; ++by)
      for (int bx = 0; bx < (g.X + XC - 1) / XC; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
        blockIdx = Dim3{bx, by, bz};
        tpufem::l2_bxy_kernel<P, XP>((const C*)u, (C*)y, (const E*)xb,
                                     xb_part, (const unsigned char*)bop, g);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

// the instances the cases use: f64 at p = 1, 2, 4, 7, 8; 3xTF32 at p = 1,
// 2, 4, 7; 1xTF32 and bf16x3 at p = 4; one bf16 product at p = 1 and 4
extern "C" int host_l2_ring_xy_apply(int xp, int p, int npts, int b, int nt,
                                     int size, int X, const void* u, void* y,
                                     const void* xb, long long xb_part,
                                     const void* bop) {
  const tpufem::BxGeo g{npts, b, nt, size, X};
#define TPUFEM_XY(XP, PP)                                          \
  if (xp == XP && p == PP)                                         \
    return ring_xy<PP, XP>(g, u, y, xb, xb_part, bop);
  TPUFEM_XY(3, 1) TPUFEM_XY(3, 2) TPUFEM_XY(3, 4) TPUFEM_XY(3, 7)
  TPUFEM_XY(3, 8) TPUFEM_XY(0, 1) TPUFEM_XY(0, 2) TPUFEM_XY(0, 4)
  TPUFEM_XY(0, 7) TPUFEM_XY(1, 4) TPUFEM_XY(2, 4) TPUFEM_XY(4, 1)
  TPUFEM_XY(4, 4)
#undef TPUFEM_XY
  return 2;
}

extern "C" long long host_l2_ring_xy_smem_bytes(int p, int xp) {
  return tpufem::bxy_smem(p, xp).total;
}
extern "C" long long host_l2_ring_side_bytes(int p, int xp, int z) {
  return tpufem::bx_side_bytes(p, xp, z);
}

// v2's ring routine (v6's, v8's), one host thread a block, as its
// launcher: grid (ceil(X / XC), nt, ceil(nt / seg))
template <int P, int XP>
static int ring_xyz(tpufem::BxGeo g, int seg, const void* u, void* y,
                    const void* xb, long long xb_part, const void* bop) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  constexpr int XC = tpufem::bx_xc(XP);
  const long long bytes = tpufem::bxy_smem(P, XP, true).total;
  for (int bz = 0; bz < (g.nt + seg - 1) / seg; ++bz)
    for (int by = 0; by < g.nt; ++by)
      for (int bx = 0; bx < (g.X + XC - 1) / XC; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
        blockIdx = Dim3{bx, by, bz};
        tpufem::l2_bxyz_kernel<P, XP>((const C*)u, (C*)y, (const E*)xb,
                                      xb_part, (const unsigned char*)bop, g,
                                      seg);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

// the instances the cases use: f64 at p = 1, 2, 4, 7, 8; 3xTF32 at p = 2,
// 4, 7; 1xTF32 and one bf16 product at p = 2 and 4; bf16x3 at p = 2 and 4
extern "C" int host_l2_ring_xyz_apply(int xp, int p, int npts, int b, int nt,
                                      int size, int X, int seg, const void* u,
                                      void* y, const void* xb,
                                      long long xb_part, const void* bop) {
  const tpufem::BxGeo g{npts, b, nt, size, X};
#define TPUFEM_XYZ(XP, PP)                                          \
  if (xp == XP && p == PP)                                          \
    return ring_xyz<PP, XP>(g, seg, u, y, xb, xb_part, bop);
  TPUFEM_XYZ(3, 1) TPUFEM_XYZ(3, 2) TPUFEM_XYZ(3, 4) TPUFEM_XYZ(3, 7)
  TPUFEM_XYZ(3, 8) TPUFEM_XYZ(0, 2) TPUFEM_XYZ(0, 4) TPUFEM_XYZ(0, 7)
  TPUFEM_XYZ(1, 2) TPUFEM_XYZ(1, 4) TPUFEM_XYZ(2, 2) TPUFEM_XYZ(2, 4)
  TPUFEM_XYZ(4, 2) TPUFEM_XYZ(4, 4)
#undef TPUFEM_XYZ
  return 2;
}

extern "C" long long host_l2_ring_xyz_smem_bytes(int p, int xp) {
  return tpufem::bxy_smem(p, xp, tpufem::kBxyV2).total;
}

// v12's ring routine, one host thread a block, as its launcher: grid
// (ceil(X / XC), nt, ceil(nt / seg))
template <int P, int XP>
static int ring_xyzb(tpufem::BxGeo g, int seg, const void* u, void* y,
                     const void* xb, long long xb_part, const void* tab) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  constexpr int XC = tpufem::bx_xc(XP);
  const long long bytes = tpufem::bxy_smem(P, XP, tpufem::kBxyV12).total;
  for (int bz = 0; bz < (g.nt + seg - 1) / seg; ++bz)
    for (int by = 0; by < g.nt; ++by)
      for (int bx = 0; bx < (g.X + XC - 1) / XC; ++bx) {
        std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
        blockIdx = Dim3{bx, by, bz};
        tpufem::l2_bxyzb_kernel<P, XP>((const C*)u, (C*)y, (const E*)xb,
                                       xb_part, (const C*)tab, g, seg);
        for (long long i = bytes; i < bytes + 4096; ++i)
          if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
      }
  return 0;
}

// the instances the cases use: f64 and 3xTF32 at p = 1, 2, 4, 7, 8 (the
// window in shared memory, and in 3xTF32 at p <= 6 in registers); 1xTF32
// and one bf16 product at p = 2 and 4; bf16x3 at p = 2, 4 and 7
extern "C" int host_l2_ring_xyzb_apply(int xp, int p, int npts, int b,
                                       int nt, int size, int X, int seg,
                                       const void* u, void* y, const void* xb,
                                       long long xb_part, const void* tab) {
  const tpufem::BxGeo g{npts, b, nt, size, X};
#define TPUFEM_XYZB(XP, PP)                                          \
  if (xp == XP && p == PP)                                           \
    return ring_xyzb<PP, XP>(g, seg, u, y, xb, xb_part, tab);
  TPUFEM_XYZB(3, 1) TPUFEM_XYZB(3, 2) TPUFEM_XYZB(3, 4) TPUFEM_XYZB(3, 7)
  TPUFEM_XYZB(3, 8) TPUFEM_XYZB(0, 1) TPUFEM_XYZB(0, 2) TPUFEM_XYZB(0, 4)
  TPUFEM_XYZB(0, 7) TPUFEM_XYZB(0, 8) TPUFEM_XYZB(1, 2) TPUFEM_XYZB(1, 4)
  TPUFEM_XYZB(2, 2) TPUFEM_XYZB(2, 4) TPUFEM_XYZB(2, 7) TPUFEM_XYZB(4, 2)
  TPUFEM_XYZB(4, 4)
#undef TPUFEM_XYZB
  return 2;
}

extern "C" long long host_l2_ring_xyzb_smem_bytes(int p, int xp) {
  return tpufem::bxy_smem(p, xp, tpufem::kBxyV12).total;
}
extern "C" int host_l2_ring_xyzb_k(int p) { return tpufem::bzb_lp(p); }
extern "C" int host_l2_ring_xyzb_window_regs(int p, int xp) {
  return tpufem::bzb_regs(p, xp);
}
"""

# storage dtype and precision of each mode; the classes are
# separable_lab.TOL and EMU_TOL, by precision code
MODES = {"f64": (torch.float64, "highest"), "f32": (torch.float32, "highest"),
         "f32h": (torch.float32, "high"), "bf16": (torch.float32, "bf16x3"),
         "bf16d": (torch.float32, "default")}
TOL, EMU_TOL = separable_lab.TOL, separable_lab.EMU_TOL
# the variants of each mode: v9 is v2 in bf16x3
MODE_VARIANTS = {m: [v for v in separable_lab.XFIRST
                     if m == "bf16" or v != "v9"] for m in MODES}


def _kernel(v, p, n, mode, b=None, h=(1.0, 1.3, 0.7), routine=None,
            seg=None):
    K1, M1 = global_1d_matrices(p, n, p + 1)
    dtype, prec = MODES[mode]
    return LabKernel(v, n * p + 1, p, K1, M1, [x / n for x in h], b=b,
                     prec=prec, dtype=dtype, device="cpu", routine=routine,
                     seg=seg)


@pytest.fixture(scope="module")
def klab():
    """``scripts/kernel_lab.py`` with its ``pallas_call`` in interpret mode;
    the process's JAX cache setting and environment are put back after."""
    env = dict(os.environ)
    cache = jax.config.jax_compilation_cache_dir
    min_s = jax.config.jax_persistent_cache_min_compile_time_secs
    path = Path(__file__).resolve().parents[1] / "scripts" / "kernel_lab.py"
    spec = importlib.util.spec_from_file_location("_pallas_kernel_lab", path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
        os.environ.clear()
        os.environ.update(env)
    # the script's own view of pallas, so the process's pl.pallas_call stays
    mod.pl = types.SimpleNamespace(**vars(mod.pl))
    mod.pl.pallas_call = functools.partial(mod.pl.pallas_call, interpret=True)
    return mod


@pytest.mark.parametrize("b", [4, 8])
@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("v", separable_lab.XFIRST)
def test_plain_matches_pallas(klab, v, p, b):
    """The port's plain version of each variant against the Pallas
    LabKernel in interpret mode (f32, n = 8), same numpy-seeded input:
    1e-6 relative, v9 the bf16x3 class (its arithmetic on the TPU side)."""
    n = 8
    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = np.array([1.0 / n, 1.3 / n, 0.7 / n])
    u = np.random.default_rng(10 * p + b).standard_normal(npts**3).astype(
        np.float32)
    y_j = np.asarray(klab.LabKernel(v, npts, p, K1, M1, h, b=b)(
        jnp.asarray(u)), np.float64)
    k = LabKernel(v, npts, p, K1, M1, h, b=b, device="cpu")
    y_t = k(torch.as_tensor(u)).numpy().astype(np.float64)
    assert np.linalg.norm(y_j) > 0
    tol = 2e-5 if v == "v9" else 1e-6
    assert np.linalg.norm(y_t - y_j) <= tol * np.linalg.norm(y_j)


def test_tile_slices_pinned(klab):
    rng = np.random.default_rng(4)
    for npts, b, p in ((17, 4, 2), (33, 8, 4), (9, 24, 1), (29, 8, 7)):
        M = rng.standard_normal((npts, npts))
        nt = -(-npts // b)
        assert np.array_equal(separable_lab.tile_slices(M, b, nt, p),
                              klab._tile_slices(M, b, nt, p))


def test_layout_and_shifts():
    """pad/unpad round trip; vx and vxy place their functions shifted."""
    p, n = 2, 3
    npts = n * p + 1
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(npts**3))
    k = _kernel("v2", p, n, "f64", b=4)
    gp = k.pad(u)
    assert gp.shape == (k.nt * 4 + 2 * p,) * 2 + (16,)
    assert torch.equal(gp[p:p + npts, p:p + npts, :npts].reshape(-1), u)
    y = k.plain(gp)
    assert y.shape == (k.nt * 4, k.nt * 4, 16)
    assert not y[npts:].any() and not y[:, npts:].any() \
        and not y[..., npts:].any()
    for v, (sz, sy) in (("vx", (p, p)), ("vxy", (p, 0))):
        kv = _kernel(v, p, n, "f64", b=4)
        yv = kv.plain(gp)
        f = yv[sz:sz + npts, sy:sy + npts, :npts]
        assert yv.abs().sum() == f.abs().sum() > 0


def test_lab_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K1, M1 = global_1d_matrices(2, 4, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        LabKernel("v2", 9, 2, K1, M1, [0.25] * 3)  # the card is the default
    with pytest.raises(RuntimeError, match="CUDA"):
        LabKernel("v12", 9, 2, K1, M1, [0.25] * 3, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_lab.main(["--refine", "1", "--p", "1", "--variants",
                         "v2-highest"])
    with pytest.raises(ValueError, match="exact dense stages"):
        LabKernel("v2", 9, 2, K1, M1, [0.25] * 3, prec="high",
                  dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        LabKernel("v21", 9, 2, K1, M1, [0.25] * 3, device="cpu")


@pytest.fixture(scope="module")
def l2_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "l2_host", L2_SHIM)
    lib.host_l2_apply.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
                                  + [ctypes.c_longlong, ctypes.c_void_p] * 3)
    lib.host_l2_apply.restype = ctypes.c_int
    lib.host_l2_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.host_l2_smem_bytes.restype = ctypes.c_longlong
    lib.host_l2_ring_apply.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 4
    lib.host_l2_ring_apply.restype = ctypes.c_int
    lib.host_l2_ring_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.host_l2_ring_smem_bytes.restype = ctypes.c_longlong
    lib.host_l2_ring_k.argtypes = [ctypes.c_int] * 2
    lib.host_l2_ring_k.restype = ctypes.c_int
    lib.host_l2_ring_side_bytes.argtypes = [ctypes.c_int] * 3
    lib.host_l2_ring_side_bytes.restype = ctypes.c_longlong
    lib.host_l2_ring_xy_apply.argtypes = ([ctypes.c_int] * 7
                                          + [ctypes.c_void_p] * 3
                                          + [ctypes.c_longlong,
                                             ctypes.c_void_p])
    lib.host_l2_ring_xy_apply.restype = ctypes.c_int
    lib.host_l2_ring_xy_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.host_l2_ring_xy_smem_bytes.restype = ctypes.c_longlong
    lib.host_l2_ring_xyz_apply.argtypes = ([ctypes.c_int] * 8
                                           + [ctypes.c_void_p] * 3
                                           + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    lib.host_l2_ring_xyz_apply.restype = ctypes.c_int
    lib.host_l2_ring_xyz_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.host_l2_ring_xyz_smem_bytes.restype = ctypes.c_longlong
    lib.host_l2_ring_xyzb_apply.argtypes = ([ctypes.c_int] * 8
                                            + [ctypes.c_void_p] * 3
                                            + [ctypes.c_longlong,
                                               ctypes.c_void_p])
    lib.host_l2_ring_xyzb_apply.restype = ctypes.c_int
    lib.host_l2_ring_xyzb_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.host_l2_ring_xyzb_smem_bytes.restype = ctypes.c_longlong
    lib.host_l2_ring_xyzb_k.argtypes = [ctypes.c_int]
    lib.host_l2_ring_xyzb_k.restype = ctypes.c_int
    lib.host_l2_ring_xyzb_window_regs.argtypes = [ctypes.c_int] * 2
    lib.host_l2_ring_xyzb_window_regs.restype = ctypes.c_int
    return lib


def _host(lib, k, gp):
    """The routine k runs (v3, vxy, v2 (v6, v8, v9) and v12: their rings
    by default, or l2_kernel), its host build on the layout gp; v3's u
    slots by its chooser on the build's own count, v2's and v12's segment
    k.seg."""
    NT = k.nt * k.b
    y = torch.full((NT, NT, k.X), float("nan"), dtype=k.dt)  # all written
    if k.band:
        rc = lib.host_l2_ring_xyzb_apply(k.xp, k.p, k.npts, k.b, k.nt,
                                         k.size, k.X, k.seg, gp.data_ptr(),
                                         y.data_ptr(), k.xb.data_ptr(),
                                         k.xb_part, k.tables.data_ptr())
        assert rc != 2, "no host instance of v12's ring at this p and xp"
    elif k.xyz:
        rc = lib.host_l2_ring_xyz_apply(k.xp, k.p, k.npts, k.b, k.nt, k.size,
                                        k.X, k.seg, gp.data_ptr(),
                                        y.data_ptr(), k.xb.data_ptr(),
                                        k.xb_part, k.bop.data_ptr())
        assert rc != 2, "no host instance of v2's ring at this p and xp"
    elif k.bx and k.variant == "vxy":
        rc = lib.host_l2_ring_xy_apply(k.xp, k.p, k.npts, k.b, k.nt, k.size,
                                       k.X, gp.data_ptr(), y.data_ptr(),
                                       k.xb.data_ptr(), k.xb_part,
                                       k.bop.data_ptr())
        assert rc != 2, "no host instance of vxy's ring at this p and xp"
    elif k.bx:
        nu = separable_lab.choose_ring_u(k.p, k.xp,
                                         lib.host_l2_ring_smem_bytes)
        rc = lib.host_l2_ring_apply(k.xp, k.p, k.npts, k.b, k.nt, k.size,
                                    k.X, nu, gp.data_ptr(), y.data_ptr(),
                                    k.tables.data_ptr(), k.bop.data_ptr())
    else:
        rc = lib.host_l2_apply(k.flags, k.xp, k.p, k.npts, k.b, k.nt,
                               k.size, k.X, gp.data_ptr(), y.data_ptr(),
                               k.xk.data_ptr(), k.xk_lo, k.xb.data_ptr(),
                               k.xb_part, k.slices.data_ptr(), k.sl_lo,
                               k.tables.data_ptr())
    assert rc == 0, "kernel wrote beyond its shared memory"
    return y


def _max_rel(y, ref):
    return float((y.to(torch.float64) - ref).abs().max() / ref.abs().max())


HOST_CASES = (
    [(v, p, "f64", None) for v in separable_lab.XFIRST if v != "v9"
     for p in (1, 2, 4, 7)]
    + [(v, 4, m, None) for m in ("f32", "f32h", "bf16", "bf16d")
       for v in MODE_VARIANTS[m]]
    # several tiles, ragged, b not a multiple of the MMA tile
    + [(v, 2, m, 4) for v in ("v2", "v8", "v12", "vxy") for m in ("f64",
                                                                  "f32")]
    + [("v3", 1, "f64", 5), ("v2", 7, "f64", 8), ("vx", 2, "f32", 6)])


@pytest.mark.parametrize("v,p,mode,b", HOST_CASES)
def test_host_build_matches_plain(l2_lib, v, p, mode, b, routine=None, n=None):
    """Each L2a kernel in each precision (v3: its ring) against the plain
    version in f64 on the same (storage-rounded) input, every output point
    written; the split precisions also against ``emulate``."""
    n = n or (2 if p > 2 else 9 // p)
    k = _kernel(v, p, n, mode, b, routine=routine)
    assert k.routine == (routine or ("ring" if v in separable_lab.RING_L2A
                                     else None))
    u = torch.as_tensor(np.random.default_rng(n * p + 3).standard_normal(
        (n * p + 1)**3))
    gp = k.pad(u)
    y = _host(l2_lib, k, gp)
    assert torch.isfinite(y).all()
    ref = k.plain(gp.to(torch.float64))
    err = _max_rel(y, ref)
    assert err <= TOL[k.xp], err
    if mode != "f64":
        ye = k.emulate(gp).to(torch.float64)
        emu, apart = _max_rel(ye, ref), float(
            (y.to(torch.float64) - ye).abs().max() / ref.abs().max())
        print(f"{v} {mode} p={p} b={k.b}: host stub {err:.3e}, emulation "
              f"{emu:.3e}, apart {apart:.3e}")
        assert apart <= EMU_TOL[k.xp], (apart, err, emu)


# v3's two routines beyond HOST_CASES (whose v3 cases run the ring): the
# ring at p = 8, in 3xTF32 at p = 2 and 7, on X = 48 (two blocks of 32
# columns, the second ragged) and at a tile of 5; its earlier schedule,
# l2_kernel, at each degree and precision HOST_CASES held it to before
V3_CASES = (
    [("ring", 8, "f64", None, None), ("ring", 7, "f32", None, None),
     ("ring", 2, "f32", 5, None), ("ring", 4, "f32", None, 9),
     ("ring", 4, "f64", None, 9)]
    + [("tile", p, "f64", None, None) for p in (1, 2, 4, 7)]
    + [("tile", 4, m, None, None) for m in ("f32", "f32h", "bf16", "bf16d")]
    + [("tile", 1, "f64", 5, None)])


@pytest.mark.parametrize("routine,p,mode,b,n", V3_CASES)
def test_v3_host_build_by_routine(l2_lib, routine, p, mode, b, n):
    """v3's ring and its earlier schedule (``routine="tile"``), each as
    ``test_host_build_matches_plain`` holds a kernel: against the f64
    plain version (f64 1e-12) with a NaN-filled output, and a split
    precision against ``emulate`` within EMU_TOL."""
    test_host_build_matches_plain(l2_lib, "v3", p, mode, b, routine, n)


# vxy's two routines beyond HOST_CASES (whose vxy cases run the ring): the
# ring at p = 8 in f64 and p = 7 in 3xTF32, on layouts whose tile b does not
# divide npts (a ragged last tile) and on X = 48 (two blocks of 32 columns,
# the second ragged); its earlier schedule, l2_kernel, at each degree and
# precision HOST_CASES held it to before
VXY_CASES = (
    [("ring", 8, "f64", None, None), ("ring", 7, "f32", None, None),
     ("ring", 2, "f32", 6, None), ("ring", 1, "f64", 5, None),
     ("ring", 4, "f32", None, 9), ("ring", 4, "f64", None, 9)]
    + [("tile", p, "f64", None, None) for p in (1, 2, 4, 7)]
    + [("tile", 4, m, None, None) for m in ("f32", "f32h", "bf16", "bf16d")]
    + [("tile", 2, m, 4, None) for m in ("f64", "f32")])


@pytest.mark.parametrize("routine,p,mode,b,n", VXY_CASES)
def test_vxy_host_build_by_routine(l2_lib, routine, p, mode, b, n):
    """vxy's ring and its earlier schedule (``routine="tile"``), each as
    ``test_host_build_matches_plain`` holds a kernel: against the f64
    plain version (f64 1e-12) with a NaN-filled output, and a split
    precision against ``emulate`` within EMU_TOL."""
    test_host_build_matches_plain(l2_lib, "vxy", p, mode, b, routine, n)


# v2's two routines beyond HOST_CASES (whose v2, v6 and v8 cases run the
# ring): the ring at p = 8 in f64 and p = 7 in 3xTF32, on layouts whose tile
# b does not divide npts (a ragged last tile) and on X = 48 (two blocks of
# 32 columns, the second ragged); its earlier schedule, l2_kernel, at each
# degree and precision HOST_CASES held it to before
V2_CASES = (
    [("ring", 8, "f64", None, None), ("ring", 7, "f32", None, None),
     ("ring", 2, "f32", 6, None), ("ring", 1, "f64", 5, None),
     ("ring", 4, "f32", None, 9), ("ring", 4, "f64", None, 9)]
    + [("tile", p, "f64", None, None) for p in (1, 2, 4, 7)]
    + [("tile", 4, m, None, None) for m in ("f32", "f32h", "bf16", "bf16d")])


@pytest.mark.parametrize("routine,p,mode,b,n", V2_CASES)
def test_v2_host_build_by_routine(l2_lib, routine, p, mode, b, n):
    """v2's ring and its earlier schedule (``routine="tile"``), each as
    ``test_host_build_matches_plain`` holds a kernel: against the f64
    plain version (f64 1e-12) with a NaN-filled output, and a split
    precision against ``emulate`` within EMU_TOL."""
    test_host_build_matches_plain(l2_lib, "v2", p, mode, b, routine, n)


@pytest.mark.parametrize("mode", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("p,b,n", [(2, 16, 16), (4, 16, 8), (4, 8, 9)])
def test_v2_march_is_bitwise(l2_lib, p, b, n, mode):
    """v2's ring down z segments of 1, 2, 3 and all nt tiles (a ragged last
    segment where seg does not divide nt) gives the same output, bit for
    bit: a shared pass's x and y stages read the same rows and slices in
    any segment, and each tile's z sums keep their order.  The per-tile
    output is held to the f64 plain version in its class."""
    ks = {s: _kernel("v2", p, n, mode, b, seg=s) for s in (1, 2, 3, None)}
    k1 = ks[1]
    nt = k1.nt
    assert nt >= 3 and separable_lab.march_shares(b, p)
    ks[nt] = _kernel("v2", p, n, mode, b, seg=nt)
    assert ks[None].seg == min(separable_lab.RING_SEG, nt)
    u = torch.as_tensor(np.random.default_rng(p + b).standard_normal(
        (n * p + 1)**3))
    gp = k1.pad(u)
    y1 = _host(l2_lib, k1, gp)
    assert _max_rel(y1, k1.plain(gp.to(torch.float64))) <= TOL[k1.xp]
    for s, k in ks.items():
        assert torch.equal(_host(l2_lib, k, gp), y1), s
    with pytest.raises(ValueError, match="segment"):
        _kernel("v2", p, n, mode, b, seg=nt + 1)
    with pytest.raises(ValueError, match="segment"):
        _kernel("v2", 7, 2, mode, 8, seg=2)  # 2p > 8: no shared pass


@pytest.mark.parametrize("mode", list(MODES))
def test_v8_v6_are_v2_on_the_ring(l2_lib, mode):
    """v8 and v6 on the ring run v2's instruction stream (v8's transposes
    are the operand layouts the ring's y and z products read already), and
    so does v9 in bf16x3: their outputs equal v2's bit for bit, in every
    mode (v9: bf16x3), at a ragged tile and at the march's segments."""
    for p, n, b in ((2, 5, None), (4, 8, 16), (2, 5, 6)):
        ks = [_kernel(v, p, n, mode, b) for v in MODE_VARIANTS[mode]
              if v in separable_lab.RING_XYZ]
        assert [k.variant for k in ks][:3] == ["v2", "v6", "v8"]
        assert all(k.xyz and k.seg == ks[0].seg for k in ks)
        gp = ks[0].pad(torch.as_tensor(np.random.default_rng(n).standard_normal(
            (n * p + 1)**3)))
        y2 = _host(l2_lib, ks[0], gp)
        assert torch.isfinite(y2).all()
        for k in ks[1:]:
            assert torch.equal(_host(l2_lib, k, gp), y2), (k.variant, p)


@pytest.mark.parametrize("p,n,b,seg", [(2, 5, None, None), (4, 8, 16, None),
                                       (2, 5, 6, None), (4, 8, 16, 1),
                                       (4, 3, 5, None)])
def test_v9_is_v2_on_the_ring(l2_lib, p, n, b, seg):
    """v9 (v2's function in bf16x3) on v2's ring: its plan is v2's in
    bf16x3 (segment, layouts, operands), its output v2's bit for bit at
    each degree, on a ragged tile and at one tile a block, every point
    written, in the bf16x3 class of the f64 plain version; its routine
    "tile" is still l2_kernel, and its launches count under v9."""
    k9 = _kernel("v9", p, n, "f32", b, seg=seg)  # v9 takes bf16x3 anyway
    k2 = _kernel("v2", p, n, "bf16", b, seg=seg)
    assert (k9.routine, k9.xyz, k9.xp, k9.seg, k9.b) == \
        ("ring", True, separable_lab.XBF16X3, k2.seg, k2.b)
    assert torch.equal(k9.xb, k2.xb) and torch.equal(k9.bop, k2.bop)
    gp = k2.pad(torch.as_tensor(np.random.default_rng(p + n).standard_normal(
        (n * p + 1)**3)))
    y9 = _host(l2_lib, k9, gp)
    assert torch.isfinite(y9).all()
    assert torch.equal(y9, _host(l2_lib, k2, gp))
    assert _max_rel(y9, k9.plain(gp.to(torch.float64))) <= \
        TOL[separable_lab.XBF16X3]
    kt = _kernel("v9", p, n, "bf16", b, routine="tile")
    assert not kt.bx and kt.flags == separable_lab.FLAGS["v9"]
    before = dict(LabKernel.launches)
    k9.raw(gp)  # a CPU tensor: the plain version, not a launch
    assert LabKernel.launches == before


# v12's two routines: the ring (l2_bxyzb_kernel) at p = 1, 2, 4, 7, 8 in
# f64 and 3xTF32 (the z window in shared memory in f64 and at p = 7, 8, in
# registers in f32 at p <= 6), 1xTF32, bf16x3 (p = 2, 4, 7) and one bf16
# product, on layouts whose tile b does not divide npts (ragged last tiles
# of 5 and 6) and on X = 48 (two blocks of 32 columns, the second ragged);
# its earlier schedule, l2_kernel, at each degree and precision HOST_CASES
# held it to before
V12_CASES = (
    [("ring", p, m, None, None) for p in (1, 2, 4, 7, 8)
     for m in ("f64", "f32")]
    + [("ring", 2, m, None, None) for m in ("f32h", "bf16", "bf16d")]
    + [("ring", 7, "bf16", None, None)]
    + [("ring", 2, "f32", 5, None), ("ring", 1, "f64", 5, None),
       ("ring", 2, "f64", 6, None), ("ring", 7, "f32", 6, None),
       ("ring", 4, "f32", None, 9), ("ring", 4, "f64", None, 9),
       ("ring", 4, "bf16", 5, 9)]
    + [("tile", p, "f64", None, None) for p in (1, 2, 4, 7)]
    + [("tile", 4, m, None, None) for m in ("f32", "f32h", "bf16", "bf16d")]
    + [("tile", 2, m, 4, None) for m in ("f64", "f32")])


@pytest.mark.parametrize("routine,p,mode,b,n", V12_CASES)
def test_v12_host_build_by_routine(l2_lib, routine, p, mode, b, n):
    """v12's ring and its earlier schedule (``routine="tile"``), each as
    ``test_host_build_matches_plain`` holds a kernel: against the f64
    plain version (f64 1e-12) with a NaN-filled output, and a split
    precision against ``emulate`` within EMU_TOL."""
    k = _kernel("v12", p, n or (2 if p > 2 else 9 // p), mode, b,
                routine=routine)
    assert k.band == (routine == "ring")
    if n == 9:
        assert k.X == 48  # two x blocks of 32 columns, the second ragged
    test_host_build_matches_plain(l2_lib, "v12", p, mode, b, routine, n)


@pytest.mark.parametrize("mode", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("p,b,n", [(2, 16, 24), (4, 8, 9), (2, 5, 9),
                                   (7, 8, 4)])
def test_v12_march_is_bitwise(l2_lib, p, b, n, mode):
    """v12's ring down z segments of 1, 2, 3 and all nt tiles (a ragged
    last segment where seg does not divide nt) gives the same output, bit
    for bit, for any b and p (a tile of 5, and p = 7, where v2's ring
    cannot march): its z window carries across tile edges, and each output
    keeps its x products' rows and its taps' order in any segment.  The
    per-tile output is held to the f64 plain version in its class; a
    segment outside 1 .. nt is refused."""
    ks = {s: _kernel("v12", p, n, mode, b, seg=s) for s in (1, 2, 3, None)}
    k1 = ks[1]
    nt = k1.nt
    assert nt >= 4 and k1.band
    ks[nt] = _kernel("v12", p, n, mode, b, seg=nt)
    assert ks[None].seg == min(separable_lab.BAND_SEG, nt)
    u = torch.as_tensor(np.random.default_rng(p + b).standard_normal(
        (n * p + 1)**3))
    gp = k1.pad(u)
    y1 = _host(l2_lib, k1, gp)
    assert _max_rel(y1, k1.plain(gp.to(torch.float64))) <= TOL[k1.xp]
    for s, k in ks.items():
        assert torch.equal(_host(l2_lib, k, gp), y1), s
    for bad in (0, nt + 1):
        with pytest.raises(ValueError, match="segment"):
            _kernel("v12", p, n, mode, b, seg=bad)
    with pytest.raises(ValueError, match="segment"):
        _kernel("v12", p, n, mode, b, seg=2, routine="tile")


def test_v12_plan_with_host_counts(l2_lib):
    """v12's ring: the host's K and window are the routine's own
    (``band_k`` against ``bzb_lp``; registers in f32 storage at p <= 6,
    else a shared ring), its block fits 227 KB at every degree and
    precision (at p = 4 in 3xTF32: the band tables' rows, 2,304 bytes,
    then four stages of an (8, 24, 16) f32 chunk of u and two x blocks'
    split B, with ax and gx, (192, 40) f32 each, over them; no slices, no
    T1/T2); no B sides are made for it.  The card's plan at the flagship, the host build's counts
    standing in for the library's: a block per segment of 3 z tiles (6 of
    the 17) and 32 x columns (f64: 8); a segment's passes its halo'd rows
    over 8 (7 for 3 tiles of 16 at p = 4, 40 a column); bf16's x product
    over 24 halo'd y rows, not v2's 32."""
    count = l2_lib.host_l2_ring_xyzb_smem_bytes
    for p in range(1, separable_lab.MAX_DEGREE + 1):
        assert l2_lib.host_l2_ring_xyzb_k(p) == separable_lab.band_k(p)
        for xp in separable_lab.TOL:
            regs = bool(l2_lib.host_l2_ring_xyzb_window_regs(p, xp))
            assert regs == (xp != separable_lab.XF64 and p <= 6)
            assert 0 < count(p, xp) <= 227 * 1024
            if not regs:
                c = 8 if xp == separable_lab.XF64 else 4
                assert count(p, xp) >= 2 * (2 * p + 1) * 16 * (
                    8 if xp == separable_lab.XF64 else 32) * c
    stage = 8 * 24 * 16 * 4 + 2 * 2 * 32 * 16 * 4
    assert 4 * stage >= 2 * 8 * 24 * 40 * 4
    assert count(4, separable_lab.X3TF32) == 2304 + 4 * stage == 84224
    assert separable_lab.band_k(4) == 24 < separable_lab.ring_k(
        4, separable_lab.XBF16X3) == 32
    assert separable_lab.band_passes(16, 4, 17, 3) == [7] * 5 + [5]
    assert separable_lab.band_passes(16, 4, 17, 1) == [3] * 17
    assert separable_lab.band_passes(5, 7, 4, 3) == [4, 3]
    assert separable_lab.band_segment(17) == 3
    assert separable_lab.band_segment(2) == 2
    K1, M1 = global_1d_matrices(4, 64, 5)
    fake = types.SimpleNamespace(lib=types.SimpleNamespace(
        tpufem_l2_ring_xyzb_k=l2_lib.host_l2_ring_xyzb_k,
        tpufem_l2_ring_xyzb_smem_bytes=count,
        tpufem_l2_ring_xyzb_window_regs=l2_lib.host_l2_ring_xyzb_window_regs))
    for mode in MODES:
        dtype, prec = MODES[mode]
        k = LabKernel("v12", 257, 4, K1, M1, [1 / 64] * 3, prec=prec,
                      dtype=dtype, device="cpu")
        assert (k.routine, k.b, k.band, k.xyz, k.seg) == \
            ("ring", 16, True, False, 3)
        assert not hasattr(k, "bop")
        assert k.xb.shape[-3:] == (272 // 16, 32, 272)
        k.lib = fake
        k._plan_bx()
        nxc = 34 if mode == "f64" else 9
        assert (k.ring, k.grid) == ((), nxc * 17 * 6)
        assert k.smem == count(4, k.xp)
        assert k.window == ("shared" if mode == "f64" else "registers")
        assert k._bx_plan() == (nxc * 17 * 6, nxc * 17 * 40, 24,
                                32 if mode != "f64" else 8, 0)
    with pytest.raises(ValueError, match="b <= 16"):
        _kernel("v12", 2, 4, "f32", b=24)
    with pytest.raises(ValueError, match="by jobs"):
        LabKernel("v12", 9, 2, *global_1d_matrices(2, 4, 3), [0.25] * 3,
                  device="cpu", routine="ring", x_jobs=True)
    assert _kernel("v12", 2, 4, "f32", b=24, routine="tile").b == 24


@pytest.mark.parametrize("v,p,mode,b", [
    ("vx", 4, "f32", None), ("vx", 2, "f64", 6), ("vx", 4, "bf16", None),
    ("v2", 4, "f32", None), ("v12", 2, "f32h", 4), ("vxy", 1, "bf16d", 5)])
def test_host_build_x_stage_by_jobs(l2_lib, v, p, mode, b):
    """The dense x stage of the first version (flag XJOBS: per-warp jobs, B
    from device memory), kept as an ablation of the ring: in its class
    against the f64 plain version, and within 2x that class of the ring's
    output on the same input (same products, other order of the sums)."""
    n = 2 if p > 2 else 9 // p
    K1, M1 = global_1d_matrices(p, n, p + 1)
    dtype, prec = MODES[mode]
    mk = lambda jobs: LabKernel(v, n * p + 1, p, K1, M1, [1.0 / n, 1.3 / n,
                                                          0.7 / n], b=b,
                                prec=prec, dtype=dtype, device="cpu",
                                x_jobs=jobs)
    kj, kr = mk(True), mk(False)
    assert kj.flags == kr.flags | separable_lab.XJOBS
    assert kj.routine in (None, "tile")  # the jobs run on l2_kernel only
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (n * p + 1)**3))
    gp = kj.pad(u)
    yj = _host(l2_lib, kj, gp)
    yr = kr.unpad(_host(l2_lib, kr, kr.pad(u)))  # its own layout (ring: b)
    ref = kj.plain(gp.to(torch.float64))
    assert _max_rel(yj, ref) <= TOL[kj.xp]
    assert _max_rel(kj.unpad(yj), yr.to(torch.float64)) <= 2 * TOL[kj.xp]
    # band x (v3) has no dense x stage: the flag is not set
    assert LabKernel("v3", n * p + 1, p, K1, M1, [1.0 / n] * 3, device="cpu",
                     x_jobs=True).flags == separable_lab.XBAND


def test_host_split_b_operand():
    """The dense x stage's B operand, made on the host: per block of 16 x
    columns the rows of Mx, then of Kx (the columns x0 .. x0 + 15 of [Mx^T |
    Kx^T]), K-major.  3xTF32: a big and a small part, each a TF32 value (13
    low mantissa bits zero) made with the kernel's rounding (to nearest, ties
    away: ``(bits + 0x1000) & ~0x1fff``), big + small = B to 2^-21 relative
    (two 11-bit significands); 1xTF32 the big part alone; bf16: hi and lo,
    hi + lo = B to 2^-16; f64 exact."""
    p, n = 4, 5
    npts = n * p + 1
    k = {m: _kernel("vx", p, n, m) for m in MODES}
    X = k["f32"].X
    B = separable_lab.x_blocks(k["f32"].Ms[0], k["f32"].Ks[0], X)
    assert B.shape == (X // 16, 32, X)
    xk = k["f64"].xk.numpy()  # (X, 2X) [Mx^T | Kx^T], the jobs ablation's
    for j in range(X // 16):
        assert np.array_equal(B[j, :16].T, xk[:, 16 * j:16 * j + 16])
        assert np.array_equal(B[j, 16:].T, xk[:, X + 16 * j:X + 16 * j + 16])
    assert not B[:, :, npts:].any() and np.abs(B).sum() > 0
    assert torch.equal(k["f64"].xb, torch.as_tensor(B)) and \
        k["f64"].xb_part == 0
    B32 = torch.as_tensor(B, dtype=torch.float32)
    big, small = k["f32"].xb
    assert k["f32"].xb_part == B32.numel()
    for part in (big, small):
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(big.view(torch.int32),
                       (B32.view(torch.int32) + 0x1000) & -0x2000)
    err = (big.double() + small.double() - B32.double()).abs()
    assert bool((err <= 2.0**-21 * B32.double().abs()).all())
    assert bool((small.abs() <= 2.0**-11 * big.abs()).all())
    assert torch.equal(k["f32h"].xb, big) and k["f32h"].xb_part == 0
    for m in ("bf16", "bf16d"):
        hi, lo = k[m].xb
        assert hi.dtype == torch.bfloat16 and k[m].xb_part == B32.numel()
        assert torch.equal(hi, B32.to(torch.bfloat16))
        err = (hi.double() + lo.double() - B32.double()).abs()
        assert bool((err <= 2.0**-16 * B32.double().abs()).all())


@pytest.mark.parametrize("v", separable_lab.XFIRST)
def test_host_build_matches_pallas(klab, l2_lib, v):
    """The g++ build of each kernel in f32 (v9: bf16x3) directly against
    the Pallas kernel in interpret mode on the same input (p = 2, n = 8,
    b = 8)."""
    p, n, b = 2, 8, 8
    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = np.array([1.0 / n, 1.3 / n, 0.7 / n])
    u = np.random.default_rng(7).standard_normal(npts**3).astype(np.float32)
    y_j = np.asarray(klab.LabKernel(v, npts, p, K1, M1, h, b=b)(
        jnp.asarray(u)), np.float64)
    k = LabKernel(v, npts, p, K1, M1, h, b=b, device="cpu")
    y_h = k.unpad(_host(l2_lib, k, k.pad(torch.as_tensor(u)))).numpy()
    tol = 5e-5 if v == "v9" else 2e-6
    assert np.linalg.norm(y_h - y_j) <= tol * np.linalg.norm(y_j)


def test_ring_counts_agree(l2_lib):
    """v3's ring: the host's K and B side bytes are the routine's own
    (``ring_k``, ``bx_side_bytes`` against ``bx_lp``, ``bx_side_bytes`` of
    the header), its chooser's u slots fit a block at every degree and
    precision (3 at the flagship, 213,632 bytes in 3xTF32), the B operand
    holds nt y sides then nt z sides, and a tile above RING_B is
    refused.  vxy's ring takes the same K and B operand (its y sides read)
    and the dense x stage's split B, and its plan is one block a tile and
    32 x columns (f64: 8), within two blocks an SM's shared memory."""
    count = l2_lib.host_l2_ring_smem_bytes
    for p in range(1, separable_lab.MAX_DEGREE + 1):
        for xp in separable_lab.TOL:
            assert l2_lib.host_l2_ring_k(p, xp) == separable_lab.ring_k(p, xp)
            for z in (0, 1):
                assert l2_lib.host_l2_ring_side_bytes(p, xp, z) == \
                    separable_lab.bx_side_bytes(p, xp, z)
            nu = separable_lab.choose_ring_u(p, xp, count)
            assert count(p, xp, nu) <= separable_lab.RING_BUDGET
    assert separable_lab.choose_ring_u(4, separable_lab.X3TF32, count) == 3
    assert count(4, separable_lab.X3TF32, 3) == 213632
    for mode in MODES:
        k = _kernel("v3", 2, 4, mode)
        xp = k.xp
        assert k.bop.numel() == k.nt * sum(
            separable_lab.bx_side_bytes(2, xp, z) for z in (0, 1))
    with pytest.raises(ValueError, match="b <= 16"):
        _kernel("v3", 2, 4, "f32", b=24)
    assert _kernel("v3", 2, 4, "f32", b=24, routine="tile").b == 24
    # the card's plan at the flagship, the host build's counts standing in
    # for the library's: 9 blocks of 32 x columns (f64: 34 of 8) on each of
    # the 17^2 tiles
    K1, M1 = global_1d_matrices(4, 64, 5)
    fake = types.SimpleNamespace(lib=types.SimpleNamespace(
        tpufem_l2_ring_k=l2_lib.host_l2_ring_k,
        tpufem_l2_ring_smem_bytes=count))
    for dtype, nu, grid in ((torch.float32, 3, 9 * 17**2),
                            (torch.float64, 3, 34 * 17**2)):
        k = LabKernel("v3", 257, 4, K1, M1, [1 / 64] * 3, dtype=dtype,
                      device="cpu")
        k.lib = fake
        k._plan_bx()
        assert (k.ring, k.grid, k.smem) == ((nu,), grid, count(4, k.xp, nu))
    fake.lib.tpufem_l2_ring_xy_smem_bytes = l2_lib.host_l2_ring_xy_smem_bytes
    for mode in MODES:
        dtype, prec = MODES[mode]
        k = LabKernel("vxy", 257, 4, K1, M1, [1 / 64] * 3, prec=prec,
                      dtype=dtype, device="cpu")
        assert (k.routine, k.b, k.bx) == ("ring", 16, True)
        assert k.bop.numel() == k.nt * sum(
            separable_lab.bx_side_bytes(4, k.xp, z) for z in (0, 1))
        assert k.xb.shape[-3:] == (272 // 16, 32, 272) and \
            k.xb_part == (k.xb[0].numel() if k.xb.dim() == 4 else 0)
        k.lib = fake
        k._plan_bx()
        assert (k.ring, k.grid) == ((), (34 if mode == "f64" else 9) * 17**2)
        assert k.smem == l2_lib.host_l2_ring_xy_smem_bytes(4, k.xp) <= \
            separable_lab.ZY_TWO_BLOCKS
    with pytest.raises(ValueError, match="b <= 16"):
        _kernel("vxy", 2, 4, "f32", b=24)
    with pytest.raises(ValueError, match="by jobs"):
        LabKernel("vxy", 9, 2, *global_1d_matrices(2, 4, 3), [0.25] * 3,
                  device="cpu", routine="ring", x_jobs=True)
    # v2's ring (v6's, v8's, v9's): vxy's operands with the z sides read, a
    # block per segment of 3 z tiles (6 segments of the 17), one block an
    # SM; v9 has no f64 form
    fake.lib.tpufem_l2_ring_xyz_smem_bytes = \
        l2_lib.host_l2_ring_xyz_smem_bytes
    for v in separable_lab.RING_XYZ:
        for mode in (m for m in MODES if m != "f64" or v != "v9"):
            dtype, prec = MODES[mode]
            k = LabKernel(v, 257, 4, K1, M1, [1 / 64] * 3, prec=prec,
                          dtype=dtype, device="cpu")
            assert (k.routine, k.b, k.xyz, k.seg) == ("ring", 16, True, 3)
            assert k.bop.numel() == k.nt * sum(
                separable_lab.bx_side_bytes(4, k.xp, z) for z in (0, 1))
            k.lib = fake
            k._plan_bx()
            assert (k.ring, k.grid) == ((), (34 if mode == "f64" else 9)
                                        * 17 * 6)
            assert k.smem == l2_lib.host_l2_ring_xyz_smem_bytes(4, k.xp)
        with pytest.raises(ValueError, match="b <= 16"):
            _kernel(v, 2, 4, "f32", b=24)
        with pytest.raises(ValueError, match="by jobs"):
            LabKernel(v, 9, 2, *global_1d_matrices(2, 4, 3), [0.25] * 3,
                      device="cpu", routine="ring", x_jobs=True)
        assert _kernel(v, 2, 4, "f32", b=24, routine="tile").b == 24
    assert separable_lab.march_segment(16, 4, 17) == 3
    assert separable_lab.march_segment(16, 4, 2) == 2
    assert separable_lab.march_segment(16, 5, 17) == 1  # 2p > 8
    assert separable_lab.march_segment(12, 2, 17) == 1  # b % 8
    assert separable_lab.march_passes(16, 4, 17, 4) == [9, 9, 9, 9, 3]
    assert separable_lab.march_passes(16, 4, 17, 3) == [7] * 5 + [5]
    assert separable_lab.march_passes(16, 4, 17, 1) == [3] * 17


def test_smem_fits(l2_lib):
    """The default tile of every degree and precision fits a block's
    shared memory by the routine's own count, whatever the variant's
    flags; vxy's ring, at every degree and precision, fits two blocks an
    SM (at p = 4 in 3xTF32: the y side, 6,144 bytes, then four stages of
    an (8, 24, 16) f32 chunk of u and two x blocks' split B, 32 columns by
    16 each, with ax and gx, (256, 28) f32 each, over them)."""
    xy = l2_lib.host_l2_ring_xy_smem_bytes
    for p in range(1, separable_lab.MAX_DEGREE + 1):
        for xp in separable_lab.TOL:
            assert 0 < xy(p, xp) <= separable_lab.ZY_TWO_BLOCKS
            assert xy(p, xp) >= separable_lab.bx_side_bytes(p, xp, 0) + \
                2 * 8 * (8 if xp == separable_lab.XF64 else 32) * (
                    separable_lab.ring_k(p, xp) + 4) * (
                    8 if xp == separable_lab.XF64 else 4)
    stage = 8 * 24 * 16 * 4 + 2 * 2 * 32 * 16 * 4
    assert 4 * stage >= 2 * 256 * 28 * 4
    assert xy(4, separable_lab.X3TF32) == 6144 + 4 * stage == 88064
    # v2's ring adds two slots of a tile's z side and t1, t2 ((512, 12) f32
    # each): one block an SM, within 227 KB at every degree and precision
    xyz = l2_lib.host_l2_ring_xyz_smem_bytes
    for p in range(1, separable_lab.MAX_DEGREE + 1):
        for xp in separable_lab.TOL:
            assert xy(p, xp) < xyz(p, xp) <= 227 * 1024
            assert xyz(p, xp) >= xy(p, xp) + 2 * \
                separable_lab.bx_side_bytes(p, xp, 1) + 2 * 16 * (
                    8 if xp == separable_lab.XF64 else 32) * 12 * (
                    8 if xp == separable_lab.XF64 else 4)
    assert xyz(4, separable_lab.X3TF32) == 88064 + 2 * 6144 + 2 * 512 * 12 * 4 \
        == 149504 > separable_lab.ZY_TWO_BLOCKS
    count = l2_lib.host_l2_smem_bytes
    for p in range(1, separable_lab.MAX_DEGREE + 1):
        for xp in separable_lab.TOL:
            for flags in set(separable_lab.FLAGS.values()):
                b = separable_lab.choose_b(p, xp, count, flags)
                assert count(p, xp, b, flags) <= \
                    separable_lab.SMEM_BUDGET < 227 * 1024
                if p <= 4 and xp != separable_lab.XF64:
                    assert b == 24  # the JAX lab's tile


def test_smem_sized_by_the_flags(l2_lib):
    """At the flagship (p = 4, b = 24, f32, 3xTF32) shared memory is sized
    by what the variant runs.  The full variants hold the ring (4 stages of
    16 KB of u rows and 2 x 2 KB of B, lying over ax and gx), t (131,072
    bytes of (LP, MB, 16) f32 pairs) and the WMMA scratch: one block an SM.
    vx holds no t and owns two x blocks (a stage: 16 KB + 2 x 2 x 2 KB), so
    two of its blocks share an SM.  Band x (v3) has no ring; the x stage by
    per-warp jobs (the first version, an ablation) holds its per-warp
    staging instead: vx then needs 49,152 bytes where it held 184,320."""
    count = l2_lib.host_l2_smem_bytes
    X3, F = separable_lab.X3TF32, separable_lab.FLAGS
    a, bp = 8 * 32 * 16 * 4, 32 * 16 * 4
    ring, ring_vx = 4 * (a + 2 * bp), 4 * (a + 2 * 2 * bp)
    t, scr, ax = 2 * 32 * 32 * 16 * 4, 8 * 256 * 4, 2 * 8 * 32 * 16 * 4
    assert (ring, ring_vx, t) == (81920, 98304, 131072)
    assert count(4, X3, 24, F["vx"]) == ring_vx >= 2 * ax
    assert 2 * (count(4, X3, 24, F["vx"]) + 1024) <= 228 * 1024
    assert count(4, X3, 24, F["v2"]) == ring + t + scr
    assert count(4, X3, 24, F["vxy"]) == ring + t + scr
    assert count(4, X3, 24, F["v3"]) == ax + t + scr  # band x: no ring
    jobs = separable_lab.XJOBS
    assert count(4, X3, 24, F["vx"] | jobs) == ax + 2 * scr == 49152
    assert count(4, X3, 24, F["v2"] | jobs) == ax + t + 2 * scr == 180224


def test_l2_bytes_from_the_tile():
    """The bytes a redesigned routine moves from L2 into shared memory an
    apply, at the flagship: vcopy's halo'd boxes at (8, 8) are 4x the input
    rows it needs (0.30 GB; 10x at (2, 8)); vx on the ring reads its
    tile's rows once per pair of x blocks, 9 times over in place of 17."""
    K1, M1 = global_1d_matrices(4, 64, 5)
    kc = LabKernel("vcopy", 257, 4, K1, M1, [1 / 64] * 3, device="cpu")
    kc.tile = (8, 8)
    assert kc.l2_bytes() == 33 * 33 * 16 * 16 * 272 * 4
    kc.tile = (2, 8)
    assert kc.l2_bytes() == 132 * 33 * 10 * 16 * 272 * 4
    kx = LabKernel("vx", 257, 4, K1, M1, [1 / 64] * 3, device="cpu")
    per_pass = 8 * 32 * 272 * 4 + 2 * 2 * 32 * 272 * 4
    assert kx.l2_bytes() == 9 * 11 * 11 * 3 * per_pass
    assert abs(kx.l2_bytes() / 1e9 - 1.365) < 1e-3
    # v2's earlier schedule (l2_kernel, b = 24): 4 passes of 8 z rows of its
    # 32 halo'd rows a tile and block of 16 x columns
    k2 = LabKernel("v2", 257, 4, K1, M1, [1 / 64] * 3, device="cpu",
                   routine="tile")
    assert k2.l2_bytes() == 17 * 11 * 11 * 4 * (8 * 32 * 272 * 4
                                                + 2 * 32 * 272 * 4)
    # v2's ring (b = 16, 17 tiles a side, 9 blocks of 32 x columns): a block
    # per segment of seg z tiles reads, each pass, 8 z rows of its tiles'
    # halo'd rows by 24 y rows over X and its two x blocks' [Mx | Kx] rows
    # over X, two parts; once, the y side and each tile's z side.  seg = 1:
    # 3 passes a tile; seg = 4: 9 passes for 4 tiles (their 72 halo'd z
    # rows), the last segment 1 tile
    bx = 2 * 64 * 272 * 4
    side = 2 * 2 * 16 * 24 * 4
    rows = 24 * 272 * 4
    tile1 = 24 * rows + 3 * bx + 2 * side
    for seg, per_column in ((1, 17 * tile1),
                            (4, 4 * (72 * rows + 9 * bx + 5 * side) + tile1)):
        kv2 = LabKernel("v2", 257, 4, K1, M1, [1 / 64] * 3, device="cpu",
                        seg=seg)
        assert (kv2.routine, kv2.b, kv2.seg) == ("ring", 16, seg)
        assert kv2.l2_bytes() == 9 * 17 * per_column
    assert abs(kv2.l2_bytes() / 1e9 - 2.098) < 1e-3
    # v3's ring (b = 16, 17 tiles a side, 9 blocks of 32 x columns): each
    # of its 3 passes a box of 8 z rows, K = 24 y rows, 32 + 2 x 4 columns;
    # the tile's y and z B sides, two slices of two parts of 16 x 24 f32
    # each (3xTF32)
    k3 = LabKernel("v3", 257, 4, K1, M1, [1 / 64] * 3, device="cpu")
    assert (k3.routine, k3.b) == ("ring", 16)
    assert k3.l2_bytes() == 9 * 17 * 17 * (3 * 8 * 24 * 40 * 4
                                           + 2 * 2 * 2 * 16 * 24 * 4)
    # its earlier schedule (b = 24, blocks of 16 x columns, no ring): the
    # tile's (32, 32) halo'd rows over 16 + 8 columns and four (32, 32)
    # slices, each once a block
    kt = LabKernel("v3", 257, 4, K1, M1, [1 / 64] * 3, device="cpu",
                   routine="tile")
    assert kt.b == 24
    assert kt.l2_bytes() == 17 * 11 * 11 * (32 * 32 * 24 * 4
                                            + 4 * 32 * 32 * 4)
    # vxy's ring (b = 16, 17 tiles a side, 9 blocks of 32 x columns): each
    # of its 2 passes 8 z rows of the tile's 24 halo'd y rows over X = 272
    # and its two x blocks' [Mx | Kx] rows (64) over X, two parts; the
    # tile's y side
    kxy = LabKernel("vxy", 257, 4, K1, M1, [1 / 64] * 3, device="cpu")
    assert (kxy.routine, kxy.b) == ("ring", 16)
    assert kxy.l2_bytes() == 9 * 17 * 17 * (
        2 * 8 * 24 * 272 * 4 + 2 * 2 * 64 * 272 * 4 + 2 * 2 * 16 * 24 * 4)
    assert abs(kxy.l2_bytes() / 1e9 - 1.827) < 1e-3


def test_ring_sweep_edits_apply(monkeypatch):
    """``python -m tpufem_torch.lab.ring_sweep`` builds copies of the four
    L2 lab libraries with one constant changed each: every edit's text
    occurs once in today's sources, the copies keep p = 4 only, the
    committed copy is the sources themselves, and the entry point raises
    without a card."""
    from tpufem_torch.lab import ring_sweep
    from tpufem_torch.utils.build import CSRC

    cus = tuple(ring_sweep.LIBRARIES.values())
    assert cus == ("lab_zyfirst.cu", "lab_separable.cu",
                   "lab_separable_ring.cu", "lab_separable_band.cu")
    for name, (lib, edits, _) in ring_sweep.VARIANTS.items():
        src = ring_sweep.edited_sources(name)
        for cu in cus:
            assert "    TPUFEM_CASE(4)\n" in src[cu]
            assert "    TPUFEM_CASE(5)\n" not in src[cu]
            assert "#define TPUFEM_CASE(PP)" in src[cu]
        for fname, text in src.items():
            same = text == (CSRC / fname).read_text()
            assert same == (fname not in edits and fname not in cus)
        assert (lib is None) == (name == "committed")
    with pytest.raises(RuntimeError, match="once"):
        monkeypatch.setitem(ring_sweep.VARIANTS, "gone", (
            "lab_zyfirst", {"lab_zyfirst.cuh": [("no such text", "")]}, False))
        ring_sweep.edited_sources("gone")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_sweep.main(["--only", "committed"])


def test_emulated_classes():
    """Each split precision's arithmetic, emulated in plain PyTorch on the
    grids of chip_smoke's phase 5 (p = 1, 2, 4, 7, 8; npts ~ 25), stays in
    its class for every variant; ``-s`` prints the worst per mode."""
    worst = {}
    rng = np.random.default_rng(5)
    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        u = torch.as_tensor(rng.standard_normal((n * p + 1)**3),
                            dtype=torch.float32)
        for mode in ("f32", "f32h", "bf16", "bf16d"):
            for v in MODE_VARIANTS[mode]:
                k = _kernel(v, p, n, mode)
                gp = k.pad(u)
                err = _max_rel(k.emulate(gp), k.plain(gp.to(torch.float64)))
                worst[k.xp] = max(worst.get(k.xp, 0.0), err)
    print("emulated L2a worst max rel err by precision code: "
          + ", ".join(f"{m} {e:.3e}" for m, e in worst.items()))
    assert all(worst[m] <= TOL[m] for m in worst), worst


def test_bounds():
    """K2's function bound for the operator variants (0.0405 ms, bytes, at
    the flagship in f32); the design bound is never below it."""
    from tpufem_torch.lab.resident_lab import operator_bound

    ms, by = operator_bound(257, 4, 7)
    assert by == "bytes" and abs(ms - 2 * 4 * 257**3 / 3.35e9) < 1e-12
    for v in separable_lab.XFIRST:
        k = _kernel(v, 2, 3, "f32", b=4)
        bands = {"vx": 1, "vxy": 4}.get(v, 7)
        assert k.bound() == operator_bound(7, 2, bands)
        assert k.design_bound()[0] >= k.bound()[0]
    # v3's two routines at the flagship in 3xTF32: the ring's design
    # (products over its passes' rows, band x over its boxes, its layouts
    # and B sides) and the earlier schedule's are each at least the
    # function's bound; the ring's products are 19.9 GFLOP
    K1, M1 = global_1d_matrices(4, 64, 5)
    for routine in ("ring", "tile"):
        k = LabKernel("v3", 257, 4, K1, M1, [1 / 64] * 3, device="cpu",
                      routine=routine)
        assert k.design_bound()[0] >= k.bound()[0] == ms
    nblk, npass, K, xc, ph = k3 = LabKernel(
        "v3", 257, 4, K1, M1, [1 / 64] * 3, device="cpu")._bx_plan()
    assert k3 == (9 * 17 * 17, 3, 24, 32, 4)
    flops = 3 * nblk * npass * 2 * 16 * xc * (3 * 8 * K + 2 * 16 * 8)
    assert abs(flops / 1e9 - 19.94) < 0.01
    # vxy's ring: its x products (2 passes of 3 tiles of 64 rows by [Mx |
    # Kx] of 32 columns, K = 272) are 104.3 GFLOP in 3xTF32, its y products
    # (256 rows by N = 48, K = 24) 9.2, both at 495 TFLOP/s
    kxy = LabKernel("vxy", 257, 4, K1, M1, [1 / 64] * 3, device="cpu")
    assert kxy._bx_plan() == (9 * 17 * 17, 2, 24, 32, 0)
    xf = 3 * 9 * 17 * 17 * 2 * 2 * 192 * 64 * 272
    yf = 3 * 9 * 17 * 17 * 2 * 2 * 256 * 48 * 24
    assert abs(xf / 1e9 - 104.3) < 0.05 and abs(yf / 1e9 - 9.2) < 0.05
    ms, by = kxy.design_bound()
    assert by == "operations" and abs(ms - (xf + yf) / 495e12 * 1e3) < 1e-12
    assert kxy.design_bound()[0] >= kxy.bound()[0]
    # v2's ring: vxy's x and y products over its passes (seg = 1: 3 a tile,
    # x 156.5 GFLOP, y 13.8; seg = 4: 39 for a column's 17 tiles) and v3's z
    # products, 3 k steps a tile (6.1 GFLOP): 0.36 and 0.28 ms
    zf = 3 * 9 * 17 * 17 * 3 * 2 * 512 * 32 * 8
    for seg, passes, ms_ in ((1, 51, 0.3565), (4, 39, 0.2754)):
        kv = LabKernel("v2", 257, 4, K1, M1, [1 / 64] * 3, device="cpu",
                       seg=seg)
        assert kv._bx_plan()[1] == 9 * 17 * passes
        xf = 3 * 9 * 17 * passes * 2 * 192 * 64 * 272
        yf = 3 * 9 * 17 * passes * 2 * 256 * 48 * 24
        assert seg > 1 or (abs(xf / 1e9 - 156.5) < 0.05
                           and abs(yf / 1e9 - 13.8) < 0.05)
        assert abs(zf / 1e9 - 6.14) < 0.01
        ms, by = kv.design_bound()
        assert by == "operations" and abs(
            ms - (xf + yf + zf) / 495e12 * 1e3) < 1e-12
        assert abs(ms - ms_) < 1e-4 and ms >= kv.bound()[0]
