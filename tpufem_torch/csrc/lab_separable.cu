// Host launcher of the K2 kernel lab's x-first half (device code and the
// design note in lab_separable.cuh), with a plain C interface for ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so lab_separable.cu
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_separable.cuh"

namespace {

template <int P, int XP>
cudaError_t launch(int flags, const tpufem::L2Geo& g, const void* u, void* y,
                   const void* xk, long long xk_lo, const void* xb,
                   long long xb_part, const void* sl,
                   long long sl_lo, const void* tab, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  const int smem = (int)tpufem::l2_smem(P, XP, g.b, flags).total;
  auto kern = tpufem::l2_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.X / tpufem::kL2XC, g.nt, g.nt), tpufem::kL2Threads, smem,
         stream>>>(static_cast<const C*>(u), static_cast<C*>(y),
                   static_cast<const E*>(xk), xk_lo,
                   static_cast<const E*>(xb), xb_part,
                   static_cast<const E*>(sl), sl_lo,
                   static_cast<const C*>(tab), g, flags);
  return cudaGetLastError();
}

// vx (a dense x stage cut after x): its own kernel; on the ring two x blocks
// a block
template <int XP>
cudaError_t launch_x(int flags, const tpufem::L2Geo& g, const void* u, void* y,
                     const void* xk, long long xk_lo, const void* xb,
                     long long xb_part, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  const int smem =
      (int)tpufem::l2_smem((g.L - g.b) / 2, XP, g.b, flags).total;
  auto kern = tpufem::l2_x_kernel<XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  const int nxb = tpufem::l2_nxb(flags);
  kern<<<dim3((g.X / tpufem::kL2XC + nxb - 1) / nxb, g.nt, g.nt),
         tpufem::kL2Threads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y), static_cast<const E*>(xk),
      xk_lo, static_cast<const E*>(xb), xb_part, g, flags);
  return cudaGetLastError();
}

template <int XP>
cudaError_t dispatch_p(int p, int flags, const tpufem::L2Geo& g,
                       const void* u, void* y, const void* xk, long long xk_lo,
                       const void* xb, long long xb_part, const void* sl,
                       long long sl_lo, const void* tab, cudaStream_t stream) {
#define TPUFEM_CASE(PP)                                                    \
  case PP:                                                                 \
    return launch<PP, XP>(flags, g, u, y, xk, xk_lo, xb, xb_part, sl, sl_lo, \
                          tab, stream);
  if (((flags >> 3) & 3) == 1 && !(flags & tpufem::kL2XBand) && p >= 1 &&
      p <= 8)
    return launch_x<XP>(flags, g, u, y, xk, xk_lo, xb, xb_part, stream);
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

// out = the variant's function of u, layout in (size, size, X), out (nt b,
// nt b, X), by the L2a routine with dense-stage precision xp (LabXPrec) and
// stage flags (L2Flags | cut << 3).  xb: the dense x stage's B operand, (parts,
// X / 16, 32, X): per block of 16 x columns the rows of Mx, then of Kx,
// K-major; parts: 3xTF32 big then small (TF32 values), bf16x3 and bf16 hi then
// lo, else one; part q xb_part elements on.  xk: (X, 2X) [Mx^T | Kx^T], read
// by the kL2XJobs ablation only.  sl: (4, nt, MB, LP) tile slices of My, Ky,
// Mz, Kz (kL2Trans: (4, nt, LP, MB)); in the bf16 precisions xk and sl are
// each a hi array with its lo array xk_lo (sl_lo) elements on.  tab: (6,
// npts, 2p+2) band tables of Mx, Kx, My, Ky, Mz, Kz.  Returns the
// cudaError_t of the launch.
int tpufem_l2_apply(int flags, int xp, int p, int npts, int b, int nt,
                    int size, int X, const void* u, void* y, const void* xk,
                    long long xk_lo, const void* xb, long long xb_part,
                    const void* sl, long long sl_lo, const void* tab,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int L = b + 2 * p;
  const bool ring = !(flags & (tpufem::kL2XBand | tpufem::kL2XJobs));
  if (b < 1 || nt < 1 || X % tpufem::kL2XC || (long long)nt * b < npts ||
      size != nt * b + 2 * p || ((flags >> 3) & 3) > 2 || (flags >> 6) ||
      (ring && (tpufem::l2_round16(L) > tpufem::kL2MaxLP ||
                reinterpret_cast<uintptr_t>(u) % 16 ||
                reinterpret_cast<uintptr_t>(xb) % 16)))
    return (int)cudaErrorInvalidValue;
  const tpufem::L2Geo g{npts, b, nt, size, X, L, tpufem::l2_round16(L),
                        tpufem::l2_round16(b)};
  switch (xp) {
#define TPUFEM_XP(XP)                                                       \
  case XP:                                                                  \
    return (int)dispatch_p<XP>(p, flags, g, u, y, xk, xk_lo, xb, xb_part, sl, \
                               sl_lo, tab, s);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXF64)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block; the tile chooser in
// tpufem_torch/lab/separable_lab.py sizes b with it.
long long tpufem_l2_smem_bytes(int p, int xp, int b, int flags) {
  return tpufem::l2_smem(p, xp, b, flags).total;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
