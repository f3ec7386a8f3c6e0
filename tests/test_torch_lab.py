"""The K1 kernel lab (L1: v17-v20) on the CPU: its plain version against
tpufem's separable apply, its layout and tables, its entry point's refusal
without a card, and g++ builds of the CUDA routines against the plain
version: the tile routine's (tpufem_torch/csrc/lab_resident.cuh; the
earlier schedule of v17-v20) and the ring routines of v17, v19 and v20
(lab_resident_ring.cuh; v20's x stage windowed), with v18 on the ring bit
for bit v17's launch.

The host builds run one thread per block, as in test_torch_kernel_host.py,
with a stub of the WMMA calls the routines use: a fragment holds its whole
tile row-major, ``mma_sync`` is a loop, ``__float_to_tf32`` rounds to a
10-bit mantissa (to nearest, ties away).  Warp-wide code takes one thread
for the whole warp, and v19's two warp groups take turns in each step.
The ring routine runs through hopper.cuh's host forms: a TMA box is a loop
copy with zero fill, a bulk copy a memcpy, an mbarrier call does nothing,
and the one thread runs each chunk's load, bands and both warpgroups'
products (a wgmma operand or accumulator holds its whole tile) in turn.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_host import STUBS, _build

from tpufem.ops import separable as jsep
from tpufem_torch.lab import kernel_lab, resident_lab
from tpufem_torch.lab.resident_lab import V17Kernel
from tpufem_torch.ops.separable import global_1d_matrices
from torch_threads import one_torch_thread  # noqa: F401

WMMA_STUBS = r"""
#include <type_traits>
static Dim3 gridDim{1, 1, 1};
#define __syncwarp()
namespace nvcuda { namespace wmma {
struct matrix_a {}; struct matrix_b {}; struct accumulator {};
struct row_major {}; struct col_major {};
namespace precision { struct tf32 {}; }
enum layout_t { mem_row_major, mem_col_major };
template <typename T> struct storage { using type = T; };
template <> struct storage<precision::tf32> { using type = float; };
template <typename U, int M, int N, int K> struct shape;
template <int M, int N, int K> struct shape<matrix_a, M, N, K> {
  enum { R = M, C = K }; };
template <int M, int N, int K> struct shape<matrix_b, M, N, K> {
  enum { R = K, C = N }; };
template <int M, int N, int K> struct shape<accumulator, M, N, K> {
  enum { R = M, C = N }; };
template <typename U, int M, int N, int K, typename T, typename L = void>
struct fragment {
  enum { rows = shape<U, M, N, K>::R, cols = shape<U, M, N, K>::C,
         num_elements = rows * cols };
  using layout = L;
  typename storage<T>::type x[num_elements];
};
inline float __float_to_tf32(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  u = (u + 0x1000u) & 0xFFFFE000u;  // to nearest, ties away from zero
  std::memcpy(&f, &u, 4); return f;
}
inline double val(double v) { return v; }
inline float val(float v) { return v; }
inline float val(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename F, typename V> void fill_fragment(F& f, V v) {
  for (int i = 0; i < F::num_elements; ++i) f.x[i] = v;
}
template <typename F, typename P>
void load_matrix_sync(F& f, const P* p, unsigned ld) {
  for (int r = 0; r < F::rows; ++r)
    for (int c = 0; c < F::cols; ++c)
      f.x[r * F::cols + c] =
          std::is_same<typename F::layout, col_major>::value
              ? p[(long long)c * ld + r] : p[(long long)r * ld + c];
}
template <typename P, typename F>
void store_matrix_sync(P* p, const F& f, unsigned ld, layout_t) {
  for (int r = 0; r < F::rows; ++r)
    for (int c = 0; c < F::cols; ++c)
      p[(long long)r * ld + c] = f.x[r * F::cols + c];
}
template <typename D, typename A, typename B>
void mma_sync(D& d, const A& a, const B& b, const D& c) {
  D r;
  for (int i = 0; i < D::rows; ++i)
    for (int j = 0; j < D::cols; ++j) {
      auto acc = c.x[i * D::cols + j];
      for (int k = 0; k < A::cols; ++k)
        acc += val(a.x[i * A::cols + k]) * val(b.x[k * D::cols + j]);
      r.x[i * D::cols + j] = acc;
    }
  d = r;
}
} }
"""

LAB_SHIM = STUBS + WMMA_STUBS + r"""
#include "lab_resident.cuh"

template <int P, int XP>
static int run(int variant, int mode, tpufem::LabGeo g, int grid,
               const void* u, void* y, const void* tab, const void* xk,
               const void* xkl, const void* win) {
  using C = typename tpufem::LabMma<XP>::C;
  const int nbuf = variant == 19 ? 2 : 1;
  const long long bytes = tpufem::lab_smem(P, XP, nbuf, g.tz, g.ty, g.X).total;
  const int nblk = variant == 19 ? grid : g.ntz * g.nty;
  gridDim = Dim3{grid, 1, 1};
  for (int b = 0; b < nblk; ++b) {
    std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
    if (variant == 19) {
      blockIdx = Dim3{b, 0, 0};
      tpufem::lab_pipe_kernel<P, XP>((const C*)u, (C*)y, (const C*)tab, xk,
                                     xkl, g, mode);
    } else {
      blockIdx = Dim3{b % g.nty, b / g.nty, 0};
      tpufem::lab_tile_kernel<P, XP>((const C*)u, (C*)y, (const C*)tab, xk,
                                     xkl, variant == 20 ? (const int*)win
                                                        : nullptr,
                                     g, variant == 18, mode);
    }
    for (long long i = bytes; i < bytes + 4096; ++i)
      if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
  }
  return 0;
}

template <int XP>
static int by_p(int p, int v, int mode, tpufem::LabGeo g, int grid,
                const void* u, void* y, const void* t, const void* xk,
                const void* xkl, const void* win) {
  switch (p) {
    case 1: return run<1, XP>(v, mode, g, grid, u, y, t, xk, xkl, win);
    case 2: return run<2, XP>(v, mode, g, grid, u, y, t, xk, xkl, win);
    case 4: return run<4, XP>(v, mode, g, grid, u, y, t, xk, xkl, win);
    case 7: return run<7, XP>(v, mode, g, grid, u, y, t, xk, xkl, win);
  }
  return 2;
}

extern "C" int host_lab_apply(int variant, int xp, int p, int mode, int npts,
                              int sz, int sy, int X, int tz, int ty, int grid,
                              const void* u, void* y, const void* t,
                              const void* xk, const void* xkl,
                              const void* win) {
  const tpufem::LabGeo g{npts, sz, sy, X, tz, ty, (npts + tz - 1) / tz,
                         (npts + ty - 1) / ty};
  switch (xp) {
    case 0: return by_p<0>(p, variant, mode, g, grid, u, y, t, xk, xkl, win);
    case 1: return by_p<1>(p, variant, mode, g, grid, u, y, t, xk, xkl, win);
    case 2: return by_p<2>(p, variant, mode, g, grid, u, y, t, xk, xkl, win);
    case 3: return by_p<3>(p, variant, mode, g, grid, u, y, t, xk, xkl, win);
  }
  return 2;
}

extern "C" long long host_lab_smem_bytes(int p, int xp, int nbuf, int tz,
                                         int ty, int X) {
  return tpufem::lab_smem(p, xp, nbuf, tz, ty, X).total;
}
"""

RING_SHIM = STUBS + WMMA_STUBS + r"""
#define __grid_constant__
#include "lab_resident_ring.cuh"

static unsigned long long* ticket_ctr;  // v19's, at 0 for each launch

template <int P, int XP>
static int run(int variant, int mode, tpufem::LrGeo q, int grid,
               const void* u, void* y, const void* tab, const void* xb) {
  using C = typename tpufem::LabMma<XP>::C;
  const tpufem::LabGeo& g = q.g;
  const long long bytes =
      variant == 20
          ? tpufem::lw_smem(P, XP, g.tz, g.ty, q.nu, q.nq).total
          : tpufem::lr_smem(P, XP, g.tz, g.ty, q.nu, q.nb, q.nq, q.ncols)
                .total;
  tpufem::HopMap in_map;  // the launcher's map of the input layout
  const long long dim[3] = {g.X, g.sy, g.sz};
  const int box[3] = {tpufem::lr_xc(XP), g.ty + 2 * P, g.tz + 2 * P};
  tpufem::hop_map_3d(&in_map, (void*)u, sizeof(C), dim, box);
  const int nblk = variant != 17 ? grid : g.ntz * g.nty * q.nsplit;
  gridDim = Dim3{grid, 1, 1};
  for (int b = 0; b < nblk; ++b) {
    std::memset(tpufem::smem_raw, 0xAB, bytes + 4096);
    if (variant == 19) {
      blockIdx = Dim3{b, 0, 0};
      tpufem::lab_ring_pipe_kernel<P, XP>(in_map, (C*)y, (const C*)tab,
                                          (const unsigned char*)xb, q, mode,
                                          ticket_ctr);
    } else if (variant == 20) {
      blockIdx = Dim3{b, 0, 0};
      tpufem::lab_window_kernel<P, XP>(in_map, (C*)y, (const C*)tab,
                                       (const unsigned char*)xb, q, mode,
                                       ticket_ctr);
    } else {
      blockIdx = Dim3{b % g.nty, b / g.nty % g.ntz, b / (g.nty * g.ntz)};
      tpufem::lab_ring_kernel<P, XP>(in_map, (C*)y, (const C*)tab,
                                     (const unsigned char*)xb, q, mode);
    }
    for (long long i = bytes; i < bytes + 4096; ++i)
      if (tpufem::smem_raw[i] != 0xAB) return 1;  // beyond its smem
  }
  return 0;
}

// the instances the cases use: f64 at p = 1, 2, 4, 7, 8; 3xTF32 at 2, 4, 7
// (the ablations at 2); 1xTF32 and bf16x3 at 4 and 7
template <int XP>
static int by_p(int p, int v, int mode, tpufem::LrGeo q, int grid,
                const void* u, void* y, const void* t, const void* xb) {
  constexpr bool f64 = XP == tpufem::kXF64, tf = XP == tpufem::kX3TF32;
  switch (p) {
    case 1: if constexpr (f64) return run<1, XP>(v, mode, q, grid, u, y, t, xb);
            break;
    case 2: if constexpr (f64 || tf)
              return run<2, XP>(v, mode, q, grid, u, y, t, xb);
            break;
    case 4: return run<4, XP>(v, mode, q, grid, u, y, t, xb);
    case 7: return run<7, XP>(v, mode, q, grid, u, y, t, xb);
    case 8: if constexpr (f64) return run<8, XP>(v, mode, q, grid, u, y, t, xb);
            break;
  }
  return 2;
}

extern "C" int host_lab_ring_apply(int variant, int xp, int p, int mode,
                                   int npts, int sz, int sy, int X, int tz,
                                   int ty, int nu, int nb, int nq, int ncols,
                                   int nsplit, int grid, const void* u,
                                   void* y, const void* t, const void* xb,
                                   void* tickets) {
  const tpufem::LabGeo g{npts, sz, sy, X, tz, ty, (npts + tz - 1) / tz,
                         (npts + ty - 1) / ty};
  const tpufem::LrGeo q{g, nu, nb, nq, ncols, nsplit,
                        tpufem::lab_resident_out(g, p)};
  ticket_ctr = (unsigned long long*)tickets;
  switch (xp) {
    case 0: return by_p<0>(p, variant, mode, q, grid, u, y, t, xb);
    case 1: return by_p<1>(p, variant, mode, q, grid, u, y, t, xb);
    case 2: return by_p<2>(p, variant, mode, q, grid, u, y, t, xb);
    case 3: return by_p<3>(p, variant, mode, q, grid, u, y, t, xb);
  }
  return 2;
}

// The x stage alone: the products of nchunk (64, K) qq stages (the A
// operand's layout) by their B stages (xb, as the kernel's), out (64,
// ncols) row-major: every column block on both warpgroups.
template <int XP>
static void xstage(int nchunk, int ncols, const void* qq, const void* xb,
                   void* out) {
  using C = typename tpufem::LabMma<XP>::C;
  const tpufem::LrSmem pl = tpufem::lr_smem(1, XP, 8, 8, 1, 1, 1, ncols);
  tpufem::LrX<XP> x;
  x.zero();
  for (int ch = 0; ch < nchunk; ++ch) {
    x.retire();
    tpufem::lr_x_issue<XP>(
        x, (const unsigned char*)qq + ch * pl.qq_bytes,
        (const unsigned char*)xb + ch * pl.b_bytes, pl, ncols / 32, 0, [] {});
  }
  x.retire();
  auto st = [&](int m, int n, C v) { ((C*)out)[m * ncols + n] = v; };
  if constexpr (XP == tpufem::kXF64)
    x.store(ncols / 32, (double*)tpufem::smem_raw, 0, 0, 1, st);
  else
    x.store(ncols / 32, 0, 0, 0, st);
}

extern "C" int host_lab_ring_xstage(int xp, int nchunk, int ncols,
                                    const void* qq, const void* xb,
                                    void* out) {
  switch (xp) {
    case 0: xstage<0>(nchunk, ncols, qq, xb, out); return 0;
    case 1: xstage<1>(nchunk, ncols, qq, xb, out); return 0;
    case 2: xstage<2>(nchunk, ncols, qq, xb, out); return 0;
    case 3: xstage<3>(nchunk, ncols, qq, xb, out); return 0;
  }
  return 2;
}

extern "C" long long host_lab_ring_smem_bytes(int p, int xp, int tz, int ty,
                                              int nu, int nb, int nq,
                                              int ncols) {
  return tpufem::lr_smem(p, xp, tz, ty, nu, nb, nq, ncols).total;
}

extern "C" long long host_lab_window_smem_bytes(int p, int xp, int tz, int ty,
                                                int nu, int nq) {
  return tpufem::lw_smem(p, xp, tz, ty, nu, nq).total;
}

// how many column blocks read chunk c (lw_readers), for X
extern "C" int host_lab_window_readers(int xp, int c, int X) {
  const int nbl = (X + 31) / 32;
  return xp == tpufem::kXF64 ? tpufem::lw_readers<8>(c, nbl, X / 8)
                             : tpufem::lw_readers<16>(c, nbl, X / 16);
}
"""

# x-stage class against the f64 plain version (max abs error / max |y|),
# as chip_smoke.LAB_TOL: bf16x3's own arithmetic passes 1e-5
# (test_emulated_x_stage_classes)
TOL = {"f64": 1e-12, "f32": 1e-6, "f32h": 4e-3, "bf16": 2e-5,
       "copy": 0.0, "bands": 1e-6, "mm": 1e-6}
# a kernel against the emulation of its x stage's arithmetic on the same
# layout (chip_smoke.EMU_TOL)
EMU_TOL = {"f32": 1e-6, "bf16": 1e-5}


def _kernel(npts, p, mode, kern, n, dtype=None):
    """A CPU instance; mode is a TOL key (f64: mode f32 in float64)."""
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = [1.0 / n, 1.3 / n, 0.7 / n]  # distinct per axis
    if dtype is None:
        dtype = torch.float64 if mode == "f64" else torch.float32
    return V17Kernel(npts, p, K1, M1, h,
                     mode={"f64": "f32", "f32h": "f32"}.get(mode, mode),
                     prec="high" if mode == "f32h" else "highest",
                     kern_name=kern, dtype=dtype, device="cpu")


def _halo_mask(k):
    m = torch.ones((k.sz, k.sy, k.X), dtype=torch.bool)
    n, p = k.npts, k.p
    m[p:p + n, p:p + n, :n] = False
    return m


@pytest.mark.parametrize("p,n", [(1, 6), (2, 3), (4, 2), (7, 2)])
def test_plain_matches_tpufem(p, n):
    """The lab's plain version on the halo'd layout against tpufem's
    laplace_apply_separable (JAX on the CPU, x64) on the same input."""
    npts = n * p + 1
    k = _kernel(npts, p, "f64", "v17", n)
    u = np.random.default_rng(p).standard_normal(npts**3)
    y = k.plain(k.pad(torch.as_tensor(u)))
    y_j = np.asarray(jsep.laplace_apply_separable(
        jnp.asarray(u), 3, npts, [jnp.asarray(K) for K in k.Ks],
        [jnp.asarray(M) for M in k.Ms]))
    y_t = k.unpad(y).numpy()
    assert np.linalg.norm(y_t - y_j) <= 1e-12 * np.linalg.norm(y_j)
    assert not y[_halo_mask(k)].any()


def test_layout_round_trip_and_raw_keeps_zeros():
    p, n = 2, 3
    npts = n * p + 1
    k = _kernel(npts, p, "f32", "v20", n)
    assert (k.sz, k.sy, k.X) == (npts + 2 * p, npts + 2 * p, 16)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(npts**3),
                        dtype=torch.float32)
    gp = k.pad(u)
    assert torch.equal(k.unpad(gp), u) and not gp[_halo_mask(k)].any()
    before = dict(V17Kernel.launches)
    y2 = k.raw(k.raw(gp))  # plain on the CPU: chains on the layout
    assert V17Kernel.launches == before
    assert not y2[_halo_mask(k)].any()
    ref = k.plain(k.pad(k(u)))
    assert torch.allclose(y2, ref, rtol=0, atol=0)


@pytest.mark.parametrize("xp", sorted(resident_lab.MMA))
@pytest.mark.parametrize("p,npts", [(1, 37), (4, 257), (8, 33)])
def test_x_windows_equal_dense_product(xp, p, npts):
    """v20's windowed product equals the dense [Kx^T; Mx^T] product, and
    no window leaves its half of the stacked operator."""
    K1, M1 = global_1d_matrices(p, (npts - 1) // p, p + 1)
    X = resident_lab.X_ALIGN * -(-npts // resident_lab.X_ALIGN)
    xkm = resident_lab.x_operator(K1, M1, X)
    _, n_mma, k_mma = resident_lab.MMA[xp]
    win = resident_lab.x_windows(X, p, n_mma, k_mma)
    assert win.shape == (X // n_mma, 2)
    assert (win[:, 0] >= 0).all() and (win[:, 1] <= X).all()
    assert (win % k_mma == 0).all()
    qq = np.random.default_rng(1).standard_normal((5, 2 * X))
    out = np.zeros((5, X))
    for j, (lo, hi) in enumerate(win):
        cols = slice(j * n_mma, (j + 1) * n_mma)
        for half in (0, X):
            out[:, cols] += qq[:, half + lo:half + hi] @ \
                xkm[half + lo:half + hi, cols]
    assert np.array_equal(out, qq @ xkm) or \
        np.abs(out - qq @ xkm).max() <= 1e-12 * np.abs(qq @ xkm).max()


def test_lab_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_lab.main(["--refine", "1", "--p", "1"])
    K1, M1 = global_1d_matrices(2, 2, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        V17Kernel(5, 2, K1, M1, [0.5] * 3)  # the card is the default
    with pytest.raises(ValueError, match="exact x stage"):
        V17Kernel(5, 2, K1, M1, [0.5] * 3, mode="bf16", dtype=torch.float64,
                  device="cpu")


def test_plain_banded_version_matches_plain():
    p, n = 2, 3
    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    h = np.array([1.0 / n] * 3)
    k = V17Kernel(npts, p, K1, M1, h, dtype=torch.float64, device="cpu")
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(npts**3))
    yb = kernel_lab.make_banded_apply(npts, p, K1, M1, h, torch.float64,
                                      "cpu")(u)
    assert torch.allclose(yb, k(u), rtol=0, atol=1e-12 * k(u).abs().max())


@pytest.fixture(scope="module")
def lab_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "lab_host", LAB_SHIM)
    lib.host_lab_apply.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6
    lib.host_lab_apply.restype = ctypes.c_int
    lib.host_lab_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.host_lab_smem_bytes.restype = ctypes.c_longlong
    return lib


CASES = (
    [(kern, p, "f64", None, None) for kern in resident_lab.KERNELS
     for p in (1, 2, 4, 7)]
    + [(kern, 4, mode, None, None) for kern in resident_lab.KERNELS
       for mode in ("f32", "f32h", "bf16")]
    + [(kern, 2, mode, None, None) for kern in ("v17", "v19")
       for mode in ("copy", "bands", "mm")]
    # several y tiles, ragged; v19 with fewer blocks than tiles, and with
    # more (blocks with no tile)
    + [("v17", 2, "f64", (2, 8), None), ("v18", 2, "f32", (1, 16), None),
       ("v20", 2, "f64", (1, 8), None), ("v19", 2, "f64", (2, 8), 3),
       ("v19", 1, "f32", (4, 8), 40)])


@pytest.mark.parametrize("kern,p,mode,tile,grid", CASES)
def test_lab_host_build_matches_plain(lab_lib, kern, p, mode, tile, grid):
    """Each L1 kernel in each x-stage class against the plain version in
    f64 on the same (storage-rounded) input, with the halo and padding
    zeros written, and two chained applies."""
    n = 2 if p > 2 else 5 // p + 1
    npts = n * p + 1
    k = _kernel(npts, p, mode, kern, n)
    tile = tile or resident_lab.choose_tile(p, k.xp, k.nbuf, k.X,
                                            lab_lib.host_lab_smem_bytes)
    ntiles = (-(-npts // tile[0])) * (-(-npts // tile[1]))
    grid = grid or ntiles
    # the function of this mode (the operator, or an ablation's) in f64
    ref_k = _kernel(npts, p, "f64" if mode in ("f32h", "bf16") else mode,
                    kern, n, torch.float64)

    def host(gp):
        y = torch.full_like(gp, float("nan"))  # every point must be written
        rc = lab_lib.host_lab_apply(
            int(kern[1:]), k.xp, p, resident_lab.MODES[k.mode], npts, k.sz,
            k.sy, k.X, *tile, grid, gp.data_ptr(), y.data_ptr(),
            k.tables.data_ptr(), k.xk.data_ptr(),
            None if k.xk_lo is None else k.xk_lo.data_ptr(),
            k.windows.data_ptr())
        assert rc == 0, "kernel wrote beyond its shared memory"
        return y

    u = torch.as_tensor(np.random.default_rng(npts + p).standard_normal(
        npts**3))
    gp = k.pad(u)
    y = host(gp)
    ref = ref_k.plain(gp.to(torch.float64))
    assert not y[_halo_mask(k)].any() and torch.isfinite(y).all()
    err = float((y.to(torch.float64) - ref).abs().max() / ref.abs().max())
    assert err <= TOL[mode], err
    if mode in ("f32", "f32h", "bf16"):
        ye = k.emulate(gp).to(torch.float64)
        emu = float((ye - ref).abs().max() / ref.abs().max())
        diff = float((y.to(torch.float64) - ye).abs().max()
                     / ref.abs().max())
        print(f"{kern} {mode} p={p} npts={npts}: host stub {err:.3e}, "
              f"emulation {emu:.3e}, apart {diff:.3e}")
        assert diff <= EMU_TOL.get(mode, TOL[mode]), (diff, err, emu)
    if mode in ("f64", "f32"):
        y2 = host(y)
        ref2 = ref_k.plain(y.to(torch.float64))
        assert float((y2.to(torch.float64) - ref2).abs().max()
                     / ref2.abs().max()) <= TOL[mode]


def _cpu_has_fma() -> bool:
    try:
        with open("/proc/cpuinfo") as f:
            return " fma" in f.read()
    except OSError:
        return False


@pytest.fixture(scope="module")
def lab_lib_fma(tmp_path_factory):
    """The p = 7 host build with each multiply-add contracted into one FMA
    (-O2 -mfma), as nvcc compiles the band stages for the card."""
    if not _cpu_has_fma():
        pytest.skip("the CPU has no FMA instruction")
    lib = _build(tmp_path_factory, "lab_host_fma", LAB_SHIM,
                 opt=("-O2", "-mfma"))
    lib.host_lab_apply.argtypes = [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6
    lib.host_lab_apply.restype = ctypes.c_int
    lib.host_lab_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.host_lab_smem_bytes.restype = ctypes.c_longlong
    return lib


# kernel vs emulation at p = 7 in bf16x3: the emulation's band stages give
# the kernel's qq to the bit, so only the x stage's f32 sum order parts
# them; an emulation with the bands in f64 turns a bf16 split at some
# point on these seeds and lands above this level
EMU_APART_FMA = 1e-6


@pytest.mark.parametrize("seed", range(8))
def test_emulation_follows_the_host_build_at_p7(lab_lib_fma, seed):
    """v20 (and v17) at p = 7 in bf16 on the FMA host build against
    ``V17Kernel.emulate``: apart by at most EMU_APART_FMA of max |y|."""
    p, n = 7, 3
    npts = n * p + 1
    for kern in ("v17", "v20"):
        k = _kernel(npts, p, "bf16", kern, n)
        tile = resident_lab.choose_tile(p, k.xp, k.nbuf, k.X,
                                        lab_lib_fma.host_lab_smem_bytes)
        ntiles = (-(-npts // tile[0])) * (-(-npts // tile[1]))
        gp = k.pad(torch.as_tensor(np.random.default_rng(100 + seed)
                                   .standard_normal(npts**3),
                                   dtype=torch.float32))
        y = torch.full_like(gp, float("nan"))
        rc = lab_lib_fma.host_lab_apply(
            int(kern[1:]), k.xp, p, resident_lab.MODES[k.mode], npts, k.sz,
            k.sy, k.X, *tile, ntiles, gp.data_ptr(), y.data_ptr(),
            k.tables.data_ptr(), k.xk.data_ptr(), k.xk_lo.data_ptr(),
            k.windows.data_ptr())
        assert rc == 0
        ye = k.emulate(gp).to(torch.float64)
        apart = float((y.to(torch.float64) - ye).abs().max()
                      / ye.abs().max())
        print(f"{kern} bf16 p=7 seed {seed}: apart {apart:.3e}")
        assert apart <= EMU_APART_FMA, (kern, seed, apart)


def test_emulated_x_stage_classes():
    """The x stage's arithmetic alone, emulated in plain PyTorch on the
    grids of chip_smoke's phase 5 (p = 1, 2, 4, 7, 8; npts ~ 25; four
    random inputs each), stays in each mode's class.  bf16x3 (hi + lo
    keep ~16 bits of each operand) lands near 1e-5, past it on some
    inputs, so its class is 2e-5; ``-s`` prints the worst per p."""
    worst = {}
    rng = np.random.default_rng(5)
    for p in (1, 2, 4, 7, 8):
        n = max(2, 24 // p)
        npts = n * p + 1
        ref_k = _kernel(npts, p, "f64", "v17", n)
        ks = {mode: _kernel(npts, p, mode, "v17", n)
              for mode in ("f32", "f32h", "bf16")}
        at_p = {}
        for _ in range(4):
            gp = ks["f32"].pad(torch.as_tensor(rng.standard_normal(npts**3),
                                               dtype=torch.float32))
            ref = ref_k.plain(gp.to(torch.float64))
            for mode, k in ks.items():
                err = float((k.emulate(gp).to(torch.float64) - ref).abs()
                            .max() / ref.abs().max())
                at_p[mode] = max(at_p.get(mode, 0.0), err)
                worst[mode] = max(worst.get(mode, 0.0), err)
        print(f"emulated x stage p={p} npts={npts}, worst max rel err: "
              + ", ".join(f"{m} {e:.3e}" for m, e in at_p.items()))
    assert all(worst[m] <= TOL[m] for m in worst), worst
    assert worst["bf16"] > 5e-6 and worst["f32h"] > 1e-4, worst


def test_bounds():
    """Each L1 kernel's bound is its function's, K1's at the flagship
    (0.0405 ms, bytes); the roofline takes the slowest unit, not a sum."""
    from tpufem_torch.utils.timer import roofline_ms

    ms, by = resident_lab.operator_bound(257, 4, 7)
    assert by == "bytes" and abs(ms - 2 * 4 * 257**3 / 3.35e9) < 1e-12
    assert roofline_ms(0, {"tf32": 495e9, "fp32": 67e9}) == (1.0, "operations")
    assert roofline_ms(0, {"tf32": 495e9, "bf16": 989e9})[0] == 2.0
    p, n = 2, 3
    for kern in resident_lab.KERNELS:
        for mode in ("f32", "bf16", "copy", "bands", "mm"):
            k = _kernel(n * p + 1, p, mode, kern, n)
            bands = {"f32": 7, "bf16": 7, "bands": 4, "mm": 1, "copy": 0}
            assert k.bound() == resident_lab.operator_bound(
                n * p + 1, p, bands[mode])
            assert k.design_bound()[0] >= k.bound()[0]


def test_k1_copy_ablation_on_the_cpu(monkeypatch):
    """K1's copy mode (the lab's ``v5-copy``): its plain version returns
    its input; it refuses a mask and f64, before touching a device."""
    from tpufem_torch.ops.kernel_separable import ResidentSeparable

    p, n = 2, 3
    npts = n * p + 1
    K1, M1 = global_1d_matrices(p, n, p + 1)
    k = ResidentSeparable(npts, p, [K1] * 3, [M1] * 3, "float32",
                          mode="copy", device="cpu")
    gp = k.pad(torch.as_tensor(np.random.default_rng(0).standard_normal(
        npts**3)))
    before = ResidentSeparable.launches
    y = k.raw(gp)
    assert torch.equal(y, gp) and y.data_ptr() != gp.data_ptr()
    assert ResidentSeparable.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="Dirichlet"):
        ResidentSeparable(npts, p, [K1] * 3, [M1] * 3, "float32",
                          mode="copy", dirichlet=True)
    with pytest.raises(ValueError, match="float32"):
        ResidentSeparable(npts, p, [K1] * 3, [M1] * 3, "float64",
                          mode="copy")
    with pytest.raises(RuntimeError, match="CUDA"):
        ResidentSeparable(npts, p, [K1] * 3, [M1] * 3, "float32",
                          mode="copy")  # the card is the default


def test_lab_tiles_fit(lab_lib):
    """The lab's tile chooser finds a block within budget for every degree
    and x-stage precision at the flagship's X."""
    for p in range(1, resident_lab.MAX_DEGREE + 1):
        for xp in resident_lab.MMA:
            for nbuf in (1, 2):
                tz, ty = resident_lab.choose_tile(
                    p, xp, nbuf, 272, lab_lib.host_lab_smem_bytes)
                assert (tz * ty) % resident_lab.MMA[xp][0] == 0
                assert lab_lib.host_lab_smem_bytes(p, xp, nbuf, tz, ty, 272) \
                    <= resident_lab.SMEM_BUDGET


@pytest.fixture(scope="module")
def ring_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "lab_ring_host", RING_SHIM)
    lib.host_lab_ring_apply.argtypes = ([ctypes.c_int] * 16
                                        + [ctypes.c_void_p] * 5)
    lib.host_lab_ring_apply.restype = ctypes.c_int
    lib.host_lab_ring_xstage.argtypes = ([ctypes.c_int] * 3
                                         + [ctypes.c_void_p] * 3)
    lib.host_lab_ring_xstage.restype = ctypes.c_int
    lib.host_lab_ring_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.host_lab_ring_smem_bytes.restype = ctypes.c_longlong
    lib.host_lab_window_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.host_lab_window_smem_bytes.restype = ctypes.c_longlong
    lib.host_lab_window_readers.argtypes = [ctypes.c_int] * 3
    lib.host_lab_window_readers.restype = ctypes.c_int
    return lib


def _ring_host(lib, k, tile=None, grid=None, ncols=None):
    """The ring routine's host build as a function of the layout, for the
    CPU instance k: the chooser's plan (its sub-tile and rings, by the
    build's own shared-memory count), or the sub-tile, v19 and v20 grid and
    block columns (v17, v19) given."""
    tiles = (tile,) if tile else resident_lab.RING_TILES
    xkm = torch.as_tensor(resident_lab.x_operator(k.Ks[0], k.Ms[0], k.X),
                          dtype=k.dt)
    xstage = k.mode not in resident_lab.NO_XSTAGE
    if k.kern_name == "v20":
        (tz, ty), nu, nq = resident_lab.choose_window(
            k.p, k.xp, lib.host_lab_window_smem_bytes, tiles)
        nb, nc, nsplit = resident_lab.WIN_B, resident_lab.WIN_N, 1
        xb = resident_lab.window_operand(xkm, k.xp, k.X, k.p) \
            if xstage else None
    else:
        nq = 2 if k.kern_name == "v19" else 1
        (tz, ty), nu, nb, nc, nsplit = resident_lab.choose_ring(
            k.p, k.xp, k.X, nq, lib.host_lab_ring_smem_bytes, tiles, k.mode)
        if ncols:
            nc = ncols
            nsplit = -(-k.X // ncols) if xstage else 1
        xb = resident_lab.ring_operand(xkm, k.xp, k.X, nc, nsplit) \
            if xstage else None
    units = nsplit * (-(-k.npts // tz)) * (-(-k.npts // ty))
    variant = resident_lab.RING_VARIANT[k.kern_name]

    def host(gp):
        y = torch.full_like(gp, float("nan"))  # every point must be written
        tickets = torch.zeros(1, dtype=torch.int64)
        rc = lib.host_lab_ring_apply(
            variant, k.xp, k.p, resident_lab.MODES[k.mode],
            k.npts, k.sz, k.sy, k.X, tz, ty, nu, nb, nq, nc, nsplit,
            grid or units, gp.data_ptr(), y.data_ptr(), k.tables.data_ptr(),
            None if xb is None else xb.data_ptr(), tickets.data_ptr())
        assert rc == 0, "kernel wrote beyond its shared memory"
        if variant != 17:  # each block took one ticket past the end
            assert int(tickets) == units + (grid or units)
        return y

    return host


# the three ring routines (v18 runs v17's: test_v18_ring_is_v17_bitwise)
RING_ROUTINES = ("v17", "v19", "v20")
RING_CASES = (
    [(kern, p, "f64", None, None, None) for kern in RING_ROUTINES
     for p in (1, 2, 4, 7, 8)]
    + [(kern, p, mode, None, None, None)
       for kern in RING_ROUTINES for p in (4, 7)
       for mode in ("f32", "f32h", "bf16")]
    + [(kern, 2, mode, None, None, None)
       for kern in RING_ROUTINES
       for mode in ("copy", "bands", "mm")]
    # ragged sub-tiles in z and in y; v19 with fewer persistent blocks than
    # units and with more (blocks with none); X = 48 in two column splits,
    # and the copy and bands ablations there in one split of fewer columns
    + [("v17", 2, "f64", (4, 16), None, None),
       ("v17", 4, "f32", (16, 4), None, None),
       ("v19", 2, "f64", (16, 4), 3, None),
       ("v19", 4, "f32", (4, 16), 40, None),
       ("v17", 4, "f64", None, None, 33), ("v19", 4, "bf16", None, 7, 33),
       ("v17", 4, "copy", None, None, 33), ("v19", 4, "bands", None, 7, 33)]
    # v20: ragged sub-tiles, fewer persistent blocks than units and more;
    # X = 48 (npts 33: a last block of 16 columns, windows clipped at row 0
    # and at row X) and X = 80 (three blocks, five chunks) in each
    # arithmetic
    + [("v20", 2, "f64", (4, 16), 3, None),
       ("v20", 4, "f32", (16, 4), 40, None),
       ("v20", 4, "f64", None, 5, 33), ("v20", 4, "f32", None, 7, 33),
       ("v20", 4, "f32h", None, None, 33), ("v20", 4, "bf16", None, 3, 33),
       ("v20", 2, "f64", None, 4, 41), ("v20", 4, "f32", None, 6, 77)])


@pytest.mark.parametrize("kern,p,mode,tile,grid,npts", RING_CASES)
def test_ring_host_build_matches_plain(ring_lib, kern, p, mode, tile, grid,
                                       npts):
    """The ring routines of v17, v19 and v20 in each x-stage class against
    the plain version in f64 on the same (storage-rounded) input and
    against ``emulate`` (f32, f32h, bf16), with the halo and padding zeros
    written and two chained applies.  X = 16 (npts <= 17) and 48 fill a
    32-column block of the x operator half with zeros; at npts 33 v17 and
    v19's block columns are 32, in two splits."""
    n = (npts - 1) // p if npts else 2 if p > 2 else 5 // p + 1
    npts = n * p + 1
    k = _kernel(npts, p, mode, kern, n)
    host = _ring_host(ring_lib, k, tile, grid, 32 if n * p + 1 > 17 else None)
    ref_k = _kernel(npts, p, "f64" if mode in ("f32h", "bf16") else mode,
                    kern, n, torch.float64)
    u = torch.as_tensor(np.random.default_rng(npts + p + 1).standard_normal(
        npts**3))
    gp = k.pad(u)
    y = host(gp)
    ref = ref_k.plain(gp.to(torch.float64))
    assert not y[_halo_mask(k)].any() and torch.isfinite(y).all()
    err = float((y.to(torch.float64) - ref).abs().max() / ref.abs().max())
    assert err <= TOL[mode], err
    if mode in ("f32", "f32h", "bf16"):
        ye = k.emulate(gp).to(torch.float64)
        diff = float((y.to(torch.float64) - ye).abs().max()
                     / ref.abs().max())
        print(f"ring {kern} {mode} p={p} npts={npts}: host {err:.3e}, "
              f"apart from the emulation {diff:.3e}")
        assert diff <= EMU_TOL.get(mode, TOL[mode]), (diff, err)
    if mode in ("f64", "f32"):
        y2 = host(y)
        ref2 = ref_k.plain(y.to(torch.float64))
        assert float((y2.to(torch.float64) - ref2).abs().max()
                     / ref2.abs().max()) <= TOL[mode]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["copy", "bands"])
@pytest.mark.parametrize("kern", resident_lab.RING_KERNELS)
def test_ring_ablations_equal_the_tile_routine_bitwise(lab_lib, ring_lib,
                                                        kern, mode, dtype):
    """The ring routine's copy and bands ablations are the tile routine's bit
    for bit: the same band tables, taps and order (band2 runs band's
    operations), on a ragged layout (npts 9 against sub-tiles of 8)."""
    p, n = 4, 2
    npts = n * p + 1
    k = _kernel(npts, p, mode, kern, n, dtype)
    gp = k.pad(torch.as_tensor(np.random.default_rng(7).standard_normal(
        npts**3), dtype=dtype))
    y = _ring_host(ring_lib, k)(gp)
    tile = resident_lab.choose_tile(p, k.xp, k.nbuf, k.X,
                                    lab_lib.host_lab_smem_bytes)
    ntiles = (-(-npts // tile[0])) * (-(-npts // tile[1]))
    y_tile = torch.full_like(gp, float("nan"))
    assert lab_lib.host_lab_apply(
        int(kern[1:]), k.xp, p, resident_lab.MODES[mode], npts, k.sz, k.sy,
        k.X, *tile, ntiles, gp.data_ptr(), y_tile.data_ptr(),
        k.tables.data_ptr(), k.xk.data_ptr(), None,
        k.windows.data_ptr()) == 0
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(y.view(bits), y_tile.view(bits))
    assert mode == "copy" or not torch.equal(y, gp)


def _a_layout(a: np.ndarray, xp: int) -> np.ndarray:
    """A (64, K) qq stage in the ring's A operand layout (``lr_at``)."""
    m, k = np.meshgrid(np.arange(64), np.arange(a.shape[1]), indexing="ij")
    if xp == resident_lab.XF64:
        at = m * 16 + k
    else:
        at = m * 32 + (k ^ ((m & 7) << 2))
    out = np.zeros(a.size, a.dtype)
    out[at.ravel()] = a.ravel()
    return out


@pytest.mark.parametrize("xp", sorted(resident_lab.MMA))
def test_ring_x_stage_over_all_column_blocks(ring_lib, xp):
    """The ring's x stage alone on the flagship's X = 272 (nine 32-column
    blocks: five on one warpgroup, four on the other, the fifth's one past
    the last not stored; f64: 160-column splits) over two chunks, against
    the products of the split operands the kernel multiplies, summed in
    f64."""
    X, nchunk = 272, 2
    xc = resident_lab.RING_XC[xp]
    K = 2 * xc
    ncols, nsplit = resident_lab.ring_columns(xp, X)
    rng = np.random.default_rng(xp)
    f64 = xp == resident_lab.XF64
    dt = torch.float64 if f64 else torch.float32
    xkm = torch.as_tensor(rng.standard_normal((2 * X, X)), dtype=dt)
    xb = resident_lab.ring_operand(xkm, xp, X, ncols, nsplit)
    a = torch.as_tensor(rng.standard_normal((nchunk, 64, K)), dtype=dt)
    qq = torch.as_tensor(np.concatenate([_a_layout(a[c].numpy(), xp)
                                         for c in range(nchunk)]))
    out = torch.zeros((64, ncols), dtype=dt)
    assert ring_lib.host_lab_ring_xstage(xp, nchunk, ncols, qq.data_ptr(),
                                         xb.data_ptr(), out.data_ptr()) == 0
    ref = torch.zeros((64, X), dtype=torch.float64)
    for c in range(nchunk):
        rows = torch.cat([torch.arange(c * xc, (c + 1) * xc),
                          X + torch.arange(c * xc, (c + 1) * xc)])
        b, ac = xkm[rows], a[c]
        if xp == resident_lab.XBF16X3:
            bf = lambda v: v.to(torch.bfloat16).to(dt)
            pa = [(bf(ac - bf(ac)), bf(b)), (bf(ac), bf(b - bf(b))),
                  (bf(ac), bf(b))]
        elif xp == resident_lab.X3TF32:
            t = resident_lab.tf32
            pa = [(t(ac - t(ac)), t(b)), (t(ac), t(b - t(b))), (t(ac), t(b))]
        elif xp == resident_lab.X1TF32:
            pa = [(resident_lab.tf32(ac), resident_lab.tf32(b))]
        else:
            pa = [(ac, b)]
        for pa_, pb in pa:
            ref += pa_.to(torch.float64) @ pb.to(torch.float64)
    got = out[:, :X].to(torch.float64) if nsplit == 1 else None
    if nsplit > 1:  # the stage multiplies one split: the first ncols columns
        ref = ref[:, :ncols]
        got = out.to(torch.float64)
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= (1e-12 if f64 else 1e-6), err


def test_ring_blocks_fit(ring_lib):
    """The ring chooser finds a block within 227 KB by the routine's own
    count at every degree, x-stage precision and variant, at the flagship's
    X = 272 and at X = 528 (p = 8, refine 6: two column splits on wgmma)."""
    for X in (272, 528):
        for p in range(1, resident_lab.MAX_DEGREE + 1):
            for xp in resident_lab.MMA:
                for nq in (1, 2):
                    (tz, ty), nu, nb, nc, ns = resident_lab.choose_ring(
                        p, xp, X, nq, ring_lib.host_lab_ring_smem_bytes)
                    assert tz * ty == resident_lab.RING_M
                    assert nc * ns >= X and nc % 32 == 0
                    assert nc <= resident_lab.RING_MAX_COLS[xp]
                    assert ring_lib.host_lab_ring_smem_bytes(
                        p, xp, tz, ty, nu, nb, nq, nc) \
                        <= resident_lab.RING_BUDGET
    # the flagship's rings in 3xTF32: three u slots and two B stages, beside
    # v19's two qq stages too (230,784 bytes)
    for nq in (1, 2):
        assert resident_lab.choose_ring(
            4, resident_lab.X3TF32, 272, nq,
            ring_lib.host_lab_ring_smem_bytes)[1:3] == (3, 2)
    # v20's windowed ring: its count does not grow with X; at every degree
    # and precision a block of the deepest rings that fit, at least six qq
    # stages (f64's window of six chunks)
    count = ring_lib.host_lab_window_smem_bytes
    for p in range(1, resident_lab.MAX_DEGREE + 1):
        for xp in resident_lab.MMA:
            (tz, ty), nu, nq = resident_lab.choose_window(p, xp, count)
            assert tz * ty == resident_lab.RING_M and nq >= 6
            assert count(p, xp, tz, ty, nu, nq) <= resident_lab.RING_BUDGET
    # the flagship in 3xTF32: (8, 8); barriers, unit slots and zero bytes
    # (256), tables, three u slots of 16 KB, s and t, eight qq stages of 8 KB
    # and two B stages of a block's window (24 KB)
    assert resident_lab.choose_window(4, resident_lab.X3TF32, count) == (
        (8, 8), 3, 8)
    assert count(4, resident_lab.X3TF32, 8, 8, 3, 8) == (
        256 + 1280 + 3 * 16384 + 16384 + 8 * 8192 + 2 * 24576) == 181760


def test_ring_columns_by_mode():
    """The column splits that the x stage's registers force (f64 at X =
    272: two of 160 columns; on wgmma one of 288), and one split for the
    copy and bands ablations, which have no x stage and so band each
    sub-tile once."""
    XF64, X3TF32 = resident_lab.XF64, resident_lab.X3TF32
    for mode in ("f32", "mm"):
        assert resident_lab.ring_columns(XF64, 272, mode) == (160, 2)
        assert resident_lab.ring_columns(X3TF32, 528, mode) == (288, 2)
    for mode in resident_lab.NO_XSTAGE:
        assert resident_lab.ring_columns(XF64, 272, mode) == (160, 1)
        assert resident_lab.ring_columns(X3TF32, 528, mode) == (288, 1)
    assert resident_lab.ring_columns(X3TF32, 272) == (288, 1)


def test_ring_routine_selection():
    """Every L1 kernel runs a ring routine unless the tile routine is asked
    for (v18 v17's launch, its fused bands being the ring's own); another
    routine name is refused."""
    K1, M1 = global_1d_matrices(2, 2, 3)
    assert resident_lab.RING_KERNELS == resident_lab.KERNELS
    assert resident_lab.RING_VARIANT == {"v17": 17, "v18": 17, "v19": 19,
                                         "v20": 20}
    for kern in resident_lab.KERNELS:
        k = V17Kernel(5, 2, K1, M1, [0.5] * 3, kern_name=kern, device="cpu")
        assert k.routine == "ring"
        assert V17Kernel(5, 2, K1, M1, [0.5] * 3, kern_name=kern,
                         device="cpu", routine="tile").routine == "tile"
    with pytest.raises(ValueError, match="routine"):
        V17Kernel(5, 2, K1, M1, [0.5] * 3, kern_name="v18", device="cpu",
                  routine="pipe")


@pytest.mark.parametrize("mode,p", [("f64", 2), ("f32", 4), ("f32h", 4),
                                    ("bf16", 4), ("f64", 7)])
def test_v18_ring_is_v17_bitwise(ring_lib, mode, p):
    """v18 on the ring (its default) is v17 on the ring bit for bit, in each
    x-stage arithmetic, on the same input: the same launch with the same
    plan, on a ragged layout (npts 9 and 15 against sub-tiles of 8)."""
    n = 2
    npts = n * p + 1
    ks = {kern: _kernel(npts, p, mode, kern, n) for kern in ("v17", "v18")}
    assert ks["v18"].routine == ks["v17"].routine == "ring"
    gp = ks["v17"].pad(torch.as_tensor(np.random.default_rng(9 + p)
                                       .standard_normal(npts**3)))
    y = {kern: _ring_host(ring_lib, k)(gp) for kern, k in ks.items()}
    bits = torch.int32 if gp.dtype == torch.float32 else torch.int64
    assert torch.equal(y["v18"].view(bits), y["v17"].view(bits))
    assert torch.isfinite(y["v18"]).all() and y["v18"].abs().max() > 0


@pytest.mark.parametrize("xp", [resident_lab.X3TF32, resident_lab.XF64])
def test_window_chunks_and_readers(ring_lib, xp):
    """v20's windows over the chunks (16 columns; f64: 8) at every X from 16
    to 544: each block's window holds the rows ``x_windows(X, p, 32, 8)``
    gives it at every p, every chunk has one or two reader blocks (the
    routine's release counts), and the windows cover every chunk."""
    xc = resident_lab.RING_XC[xp]
    for X in range(16, 545, 16):
        nbl, nchunk = -(-X // 32), X // xc
        readers = [ring_lib.host_lab_window_readers(xp, c, X)
                   for c in range(nchunk)]
        assert set(readers) <= {1, 2}, (X, readers)
        for p in range(1, resident_lab.MAX_DEGREE + 1):
            win = resident_lab.x_windows(X, p, 32, 8)
            assert win.shape == (nbl, 2)
            for j, (lo, hi) in enumerate(win):
                assert 32 * j - 8 <= lo and hi <= 32 * j + 40, (X, p, j)


@pytest.mark.parametrize("mode,p", [("f32", 4), ("f32", 7), ("bf16", 4),
                                    ("f32h", 7)])
def test_window_agrees_with_the_dense_ring(ring_lib, mode, p):
    """v20's windowed x stage against v17's dense one, the same ring and
    band stages (so the same qq) on the same input: the windowed product
    leaves out exact zeros only, so the two differ in the order of the
    x stage's f32 sums; held to EMU_TOL (f32h: its class), ``-s`` prints
    the largest difference."""
    n = 9 if p == 4 else 5  # X = 48: two column blocks, three chunks
    npts = n * p + 1
    u = torch.as_tensor(np.random.default_rng(31 + p).standard_normal(
        npts**3))
    y = {}
    for kern in ("v17", "v20"):
        k = _kernel(npts, p, mode, kern, n)
        y[kern] = _ring_host(ring_lib, k)(k.pad(u)).to(torch.float64)
    ref = _kernel(npts, p, "f64", "v17", n, torch.float64).plain(
        k.pad(u).to(torch.float64))
    apart = float((y["v20"] - y["v17"]).abs().max() / ref.abs().max())
    print(f"v20 against v17's ring, {mode} p={p} npts={npts}: largest "
          f"difference {apart:.3e} of max |y|")
    assert apart <= EMU_TOL.get(mode, TOL[mode]), apart
