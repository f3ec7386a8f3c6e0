// Host launcher of the K2 kernel lab's v12 on the ring (l2_bxyzb_kernel:
// v2's dense x stage feeding band y and z stages; device code and the
// design notes in lab_separable_ring.cuh), with a plain C interface for
// ctypes.  A library of its own, built beside lab_separable_ring's by
// tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -ldl -o <lib>.so lab_separable_band.cu
#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_separable_ring.cuh"

namespace {

// The shared-memory opt-in and the launch, grid (ceil(X / XC), nt,
// ceil(nt / seg)).
template <int P, int XP>
cudaError_t launch(const tpufem::BxGeo& g, int seg, const void* u, void* y,
                   const void* xb, long long xb_part, const void* tab,
                   cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  const int smem = (int)tpufem::bxy_smem(P, XP, tpufem::kBxyV12).total;
  auto kern = tpufem::l2_bxyzb_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  constexpr int XC = tpufem::bx_xc(XP);
  kern<<<dim3((g.X + XC - 1) / XC, g.nt, (g.nt + seg - 1) / seg),
         tpufem::kBxyThreads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y),
      static_cast<const E*>(xb), xb_part, static_cast<const C*>(tab), g,
      seg);
  return cudaGetLastError();
}

// f(precision, degree), each an integral_constant, for the instance of (xp,
// p)
template <int XP, typename F>
cudaError_t by_p(int p, F f) {
#define TPUFEM_CASE(PP)                       \
  case PP:                                    \
    return f(std::integral_constant<int, XP>{}, \
             std::integral_constant<int, PP>{});
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

template <typename F>
cudaError_t dispatch(int xp, int p, F f) {
  switch (xp) {
#define TPUFEM_XP(XP) \
  case XP:            \
    return by_p<XP>(p, f);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXF64)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out = v12's function of u (K2's operator, x dense, y and z by bands) on
// the layouts of tpufem_l2_ring_xyz_apply (u (size, size, X), out (nt b,
// nt b, X)) by its ring routine with product precision xp (LabXPrec), a
// tile of b <= 16 rows a side and a segment of 1 <= seg <= nt consecutive
// z tiles a block.  xb: the dense x stage's B operand as
// separable_lab.x_blocks lays it out, part q xb_part elements on; tab: (6,
// npts, 2p+2) band tables of Mx, Kx, My, Ky, Mz, Kz (My to Kz are read).
// u and xb 16-byte aligned.  Every seg computes the same output.  Returns
// the cudaError_t of the launch.
int tpufem_l2_ring_xyzb_apply(int xp, int p, int npts, int b, int nt,
                              int size, int X, int seg, const void* u,
                              void* y, const void* xb, long long xb_part,
                              const void* tab, void* stream) {
  if (b < 1 || b > tpufem::kBxN || nt < 1 || (long long)nt * b < npts ||
      size != nt * b + 2 * p || X < npts || X % 16 || seg < 1 || seg > nt ||
      reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(xb) % 16)
    return (int)cudaErrorInvalidValue;
  const tpufem::BxGeo g{npts, b, nt, size, X};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(xp, p, [&](auto x, auto pp) {
    return launch<decltype(pp)::value, decltype(x)::value>(
        g, seg, u, y, xb, xb_part, tab, s);
  });
}

// Shared-memory bytes of one block of v12's ring.
long long tpufem_l2_ring_xyzb_smem_bytes(int p, int xp) {
  return tpufem::bxy_smem(p, xp, tpufem::kBxyV12).total;
}

// The halo'd y rows of v12's x product: 16 + 2p rounded up to 8.
int tpufem_l2_ring_xyzb_k(int p) { return tpufem::bzb_lp(p); }

// Whether v12's z window lies in registers (1) or in shared memory (0).
int tpufem_l2_ring_xyzb_window_regs(int p, int xp) {
  return tpufem::bzb_regs(p, xp);
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
