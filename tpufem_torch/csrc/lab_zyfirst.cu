// Host launcher of the K2 kernel lab's z/y-first half (device code and the
// design note in lab_zyfirst.cuh), with a plain C interface for ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so lab_zyfirst.cu
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_zyfirst.cuh"

namespace {

template <int P, int XP>
cudaError_t launch(int mode, int two, int nu, const tpufem::LabGeo& g,
                   const void* u, void* y, const void* tables, const void* xk,
                   const void* xk_lo, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  const int smem = (int)tpufem::zy_smem(P, XP, nu, g.tz, g.ty, g.X).total;
  auto kern = tpufem::zy_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.nty, g.ntz), tpufem::kLabThreads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y),
      static_cast<const C*>(tables), xk, xk_lo, g, mode, two, nu);
  return cudaGetLastError();
}

template <int XP>
cudaError_t dispatch_p(int p, int mode, int two, int nu,
                       const tpufem::LabGeo& g, const void* u, void* y,
                       const void* tables, const void* xk, const void* xk_lo,
                       cudaStream_t stream) {
#define TPUFEM_CASE(PP)                                                     \
  case PP:                                                                  \
    return launch<PP, XP>(mode, two, nu, g, u, y, tables, xk, xk_lo, stream);
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

// out = the variant's function of u, layout in (size, size, X), out (NT, NT,
// X) with NT = size - 2p, by the L2b routine: mode (LabMode kFull, kCopy,
// kBands, or kZyXBand: x by bands), two (the x stage as two products), nu (1
// or 2 u slots: 2 keeps the next chunk's load in flight), x-stage precision
// xp (LabXPrec), sub-tile (tz, ty).  tables: (6, npts, 2p+2) band tables
// [Ky, My, Kz, Mz, Kx, Mx]; xk: (2X, X) [Kx^T; Mx^T] (bf16: its hi part,
// xk_lo its lo part).  Returns the cudaError_t of the launch.
int tpufem_zy_apply(int mode, int two, int nu, int xp, int p, int npts,
                    int size, int X, int tz, int ty, const void* u, void* y,
                    const void* tables, const void* xk, const void* xk_lo,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NT = size - 2 * p;
  const bool bf16 = xp == tpufem::kXBF16x3 || xp == tpufem::kXBF16;
  if (mode < 0 || mode > tpufem::kZyXBand || mode == tpufem::kMM ||
      (mode == tpufem::kZyXBand && bf16) || nu < 1 || nu > 2 || tz < 1 ||
      ty < 1 || (tz * ty) % (xp == tpufem::kXF64 ? 8 : 16) || NT < npts ||
      X % 16 || X < npts || reinterpret_cast<uintptr_t>(u) % 16)
    return (int)cudaErrorInvalidValue;
  const tpufem::LabGeo g{npts, size, size, X, tz, ty, (NT + tz - 1) / tz,
                         (NT + ty - 1) / ty};
  switch (xp) {
#define TPUFEM_XP(XP) \
  case XP:            \
    return (int)dispatch_p<XP>(p, mode, two, nu, g, u, y, tables, xk, xk_lo, s);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXF64)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block with nu u slots; the tile chooser in
// tpufem_torch/lab/separable_lab.py sizes its sub-tiles with it.
long long tpufem_zy_smem_bytes(int p, int xp, int nu, int tz, int ty, int X) {
  return tpufem::zy_smem(p, xp, nu, tz, ty, X).total;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
