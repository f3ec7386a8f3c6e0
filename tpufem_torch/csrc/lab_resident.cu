// Host launcher of the K1 kernel lab (device code and the design note in
// lab_resident.cuh), with a plain C interface for ctypes.  Built by
// tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so lab_resident.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_resident.cuh"

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

}  // namespace

extern "C" {

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
