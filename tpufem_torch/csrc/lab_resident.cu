// Host launcher of the K1 kernel lab (device code and the design notes in
// lab_resident.cuh, the tile routine, and lab_resident_ring.cuh, the ring
// routines of v17, v19 and v20), with a plain C interface for ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -ldl -o <lib>.so lab_resident.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_resident_ring.cuh"

namespace {

template <int P, int XP>
cudaError_t launch(int variant, int mode, const tpufem::LabGeo& g, int grid,
                   const void* u, void* y, const void* tables, const void* xk,
                   const void* xk_lo, const void* win, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  const C* uc = static_cast<const C*>(u);
  C* yc = static_cast<C*>(y);
  const C* tc = static_cast<const C*>(tables);
  if (variant == 19) {
    const int smem =
        (int)tpufem::lab_smem(P, XP, 2, g.tz, g.ty, g.X).total;
    auto kern = tpufem::lab_pipe_kernel<P, XP>;
    static std::atomic<int> granted[tpufem::kLabMaxDevices];
    cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
    if (e != cudaSuccess) return e;
    kern<<<grid, tpufem::kLabThreads, smem, stream>>>(uc, yc, tc, xk, xk_lo,
                                                      g, mode);
    return cudaGetLastError();
  }
  const int smem = (int)tpufem::lab_smem(P, XP, 1, g.tz, g.ty, g.X).total;
  auto kern = tpufem::lab_tile_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.nty, g.ntz), tpufem::kLabThreads, smem, stream>>>(
      uc, yc, tc, xk, xk_lo, variant == 20 ? static_cast<const int*>(win)
                                           : nullptr,
      g, variant == 18, mode);
  return cudaGetLastError();
}

template <int XP>
cudaError_t dispatch_p(int p, int variant, int mode, const tpufem::LabGeo& g,
                       int grid, const void* u, void* y, const void* tables,
                       const void* xk, const void* xk_lo, const void* win,
                       cudaStream_t stream) {
#define TPUFEM_CASE(PP)                                                   \
  case PP:                                                                \
    return launch<PP, XP>(variant, mode, g, grid, u, y, tables, xk, xk_lo, \
                          win, stream);
  switch (p) {
    TPUFEM_CASE(1)
    TPUFEM_CASE(2)
    TPUFEM_CASE(3)
    TPUFEM_CASE(4)
    TPUFEM_CASE(5)
    TPUFEM_CASE(6)
    TPUFEM_CASE(7)
    TPUFEM_CASE(8)
  }
#undef TPUFEM_CASE
  return cudaErrorInvalidValue;
}

// The ring routines (v17: lab_ring_kernel, v19: lab_ring_pipe_kernel, v20:
// lab_window_kernel) by variant, degree and precision.
template <int XP>
cudaError_t ring_by_p(int p, int variant, int mode, const tpufem::LrGeo& q,
                      const tpufem::LrLaunch& a) {
#define TPUFEM_CASE(PP)                                                   \
  case PP:                                                                \
    return variant == 17   ? tpufem::lr_launch<PP, XP, 17>(mode, q, a)    \
           : variant == 19 ? tpufem::lr_launch<PP, XP, 19>(mode, q, a)    \
                           : tpufem::lr_launch<PP, XP, 20>(mode, q, a);
  switch (p) {
    TPUFEM_CASE(1)
    TPUFEM_CASE(2)
    TPUFEM_CASE(3)
    TPUFEM_CASE(4)
    TPUFEM_CASE(5)
    TPUFEM_CASE(6)
    TPUFEM_CASE(7)
    TPUFEM_CASE(8)
  }
#undef TPUFEM_CASE
  return cudaErrorInvalidValue;
}

cudaError_t ring_dispatch(int xp, int p, int variant, int mode,
                          const tpufem::LrGeo& q, const tpufem::LrLaunch& a) {
  switch (xp) {
    case tpufem::kX3TF32:
      return ring_by_p<tpufem::kX3TF32>(p, variant, mode, q, a);
    case tpufem::kX1TF32:
      return ring_by_p<tpufem::kX1TF32>(p, variant, mode, q, a);
    case tpufem::kXBF16x3:
      return ring_by_p<tpufem::kXBF16x3>(p, variant, mode, q, a);
    case tpufem::kXF64:
      return ring_by_p<tpufem::kXF64>(p, variant, mode, q, a);
  }
  return cudaErrorInvalidValue;
}

// The ring routines take: v17, v19 or v20, a sub-tile of 64 rows whose
// halo'd box is a TMA box, rings of 1..3 u slots; v17 and v19: 1..2 B stages
// and qq stages (v17: 1), column splits of a multiple of 32 columns within
// the block's registers that cover X (copy and bands, which have no x stage:
// one split); v20: kLwB B stages, 6..kLwMaxQ qq stages (a window of f64's
// six chunks fits), one split; X a multiple of the chunk.
bool ring_args_ok(int variant, int xp, int p, int mode, int X, int tz, int ty,
                  int nu, int nb, int nq, int ncols, int nsplit) {
  if ((variant != 17 && variant != 19 && variant != 20) ||
      xp < tpufem::kX3TF32 || xp > tpufem::kXF64 || p < 1 || p > 8)
    return false;
  if (tz < 1 || ty < 1 || tz * ty != tpufem::kLrM || tz + 2 * p > 256 ||
      ty + 2 * p > 256 || nu < 1 || nu > tpufem::kLrMaxU ||
      X <= 0 || X % tpufem::lr_xc(xp))
    return false;
  if (variant == 20)
    return nb == tpufem::kLwB && nq >= 6 && nq <= tpufem::kLwMaxQ &&
           nsplit == 1;
  if (nb < 1 || nb > tpufem::kLrMaxB || nq < 1 || nq > tpufem::kLrMaxQ ||
      (variant == 17 && nq != 1))
    return false;
  const bool xstage = mode == tpufem::kFull || mode == tpufem::kMM;
  return ncols > 0 && ncols % tpufem::kHopN == 0 &&
         ncols <= tpufem::lr_max_cols(xp) &&
         (xstage ? nsplit >= 1 && (long long)ncols * nsplit >= X
                 : nsplit == 1);
}

}  // namespace

extern "C" {

// y = A u on the resident layout (sz, sy, X) by the ring routine of v17, v19
// or v20 (lab_resident_ring.cuh) with x-stage precision xp in mode; sub-tile
// (tz, ty) of 64 rows; rings nu, nb, nq; ncols columns a block in nsplit
// splits (v20: one split, its blocks' windows); grid: the persistent blocks
// of v19 and v20 (v17 ignores it).  tables: (4, npts, 2p+2) [Ky, My, Kz,
// Mz]; xb: the B stages as the host lays them out (resident_lab.ring_operand;
// v20: window_operand).  v19, v20: tickets, 8 bytes of device memory for the
// counter their blocks take units from, set to 0 on the stream before the
// launch (v17 ignores it).  Returns the cudaError_t of the launch.
int tpufem_lab_ring_apply(int variant, int xp, int p, int mode, int npts,
                          int sz, int sy, int X, int tz, int ty, int nu,
                          int nb, int nq, int ncols, int nsplit, int grid,
                          const void* u, void* y, const void* tables,
                          const void* xb, void* tickets, void* stream) {
  if (!ring_args_ok(variant, xp, p, mode, X, tz, ty, nu, nb, nq, ncols,
                    nsplit) ||
      grid < 1 || (variant != 17 && !tickets))
    return (int)cudaErrorInvalidValue;
  const tpufem::LabGeo g{npts, sz, sy, X, tz, ty, (npts + tz - 1) / tz,
                         (npts + ty - 1) / ty};
  const tpufem::LrGeo q{g, nu, nb, nq, ncols, nsplit,
                        tpufem::lab_resident_out(g, p)};
  const tpufem::LrLaunch a{grid, u, y, tables, xb,
                           static_cast<unsigned long long*>(tickets),
                           static_cast<cudaStream_t>(stream), nullptr};
  return (int)ring_dispatch(xp, p, variant, mode, q, a);
}

// Blocks of a ring launch an SM holds at once (v19 and v20's grid is that
// times the SMs); -1 where refused.
int tpufem_lab_ring_blocks_per_sm(int variant, int xp, int p, int tz, int ty,
                                  int nu, int nb, int nq, int ncols) {
  if (!ring_args_ok(variant, xp, p, tpufem::kFull, ncols, tz, ty, nu, nb,
                    nq, ncols, 1))
    return -1;
  int n = -1;
  const tpufem::LrGeo q{{0, 0, 0, 0, tz, ty, 0, 0}, nu, nb, nq, ncols, 1,
                        {0, 0, 0}};
  const tpufem::LrLaunch a{1,       nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, &n};
  if (ring_dispatch(xp, p, variant, 0, q, a) != cudaSuccess) return -1;
  return n;
}

// Shared-memory bytes of one block of v17 or v19's ring routine; the chooser
// in tpufem_torch/lab/resident_lab.py sizes its rings with it.
long long tpufem_lab_ring_smem_bytes(int p, int xp, int tz, int ty, int nu,
                                     int nb, int nq, int ncols) {
  return tpufem::lr_smem(p, xp, tz, ty, nu, nb, nq, ncols).total;
}

// The same for v20's (lab_window_kernel: kLwB B stages of a column block's
// window, nq qq stages of one chunk).
long long tpufem_lab_window_smem_bytes(int p, int xp, int tz, int ty, int nu,
                                       int nq) {
  return tpufem::lw_smem(p, xp, tz, ty, nu, nq).total;
}

// y = A u on the resident layout (sz, sy, X) by lab kernel `variant` (17,
// 18, 19 or 20) with x-stage precision xp (LabXPrec) in mode (LabMode).
// Tile (tz, ty); grid: the persistent blocks of v19 (others ignore it).
// tables: (4, npts, 2p+2) band tables [Ky, My, Kz, Mz]; xk: (2X, X)
// [Kx^T; Mx^T] (bf16x3: its hi part, xk_lo its lo part); win: (X/N, 2)
// int32 row windows of v20.  Returns the cudaError_t of the launch.
int tpufem_lab_apply(int variant, int xp, int p, int mode, int npts, int sz,
                     int sy, int X, int tz, int ty, int grid, const void* u,
                     void* y, const void* tables, const void* xk,
                     const void* xk_lo, const void* win, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant < 17 || variant > 20 || tz < 1 || ty < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const tpufem::LabGeo g{npts, sz, sy, X, tz, ty, (npts + tz - 1) / tz,
                         (npts + ty - 1) / ty};
  switch (xp) {
    case tpufem::kX3TF32:
      return (int)dispatch_p<tpufem::kX3TF32>(p, variant, mode, g, grid, u, y,
                                              tables, xk, xk_lo, win, s);
    case tpufem::kX1TF32:
      return (int)dispatch_p<tpufem::kX1TF32>(p, variant, mode, g, grid, u, y,
                                              tables, xk, xk_lo, win, s);
    case tpufem::kXBF16x3:
      return (int)dispatch_p<tpufem::kXBF16x3>(p, variant, mode, g, grid, u,
                                               y, tables, xk, xk_lo, win, s);
    case tpufem::kXF64:
      return (int)dispatch_p<tpufem::kXF64>(p, variant, mode, g, grid, u, y,
                                            tables, xk, xk_lo, win, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block (nbuf qq buffers: 2 for v19); the tile
// chooser in tpufem_torch/lab/resident_lab.py sizes its blocks with it.
long long tpufem_lab_smem_bytes(int p, int xp, int nbuf, int tz, int ty,
                                int X) {
  return tpufem::lab_smem(p, xp, nbuf, tz, ty, X).total;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
