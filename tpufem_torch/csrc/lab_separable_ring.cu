// Host launchers of the K2 kernel lab's v3, vxy and v2 on the ring (device code
// and the design notes in lab_separable_ring.cuh), with a plain C interface
// for ctypes.  Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -ldl -o <lib>.so lab_separable_ring.cu
#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_separable_ring.cuh"

namespace {

// The shared-memory opt-in, the tensor map of the input layout (X, size,
// size) in the pass's boxes and the launch, grid (ceil(X / XC), nt, nt).
template <int P, int XP>
cudaError_t launch(const tpufem::BxGeo& g, int nu, const void* u, void* y,
                   const void* tab, const void* bop, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  const int smem = (int)tpufem::bx_smem(P, XP, nu).total;
  auto kern = tpufem::l2_bx_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  constexpr int XC = tpufem::bx_xc(XP);
  tpufem::HopMap in_map;
  const long long dim[3] = {g.X, g.size, g.size};
  const int box[3] = {XC + 2 * tpufem::bx_ph(P, XP), tpufem::bx_lp(P, XP),
                      tpufem::kBxZC};
  if (tpufem::hop_map_3d(&in_map, const_cast<void*>(u), sizeof(C), dim, box))
    return cudaErrorInvalidValue;
  kern<<<dim3((g.X + XC - 1) / XC, g.nt, g.nt), tpufem::kBxThreads, smem,
         stream>>>(in_map, static_cast<C*>(y), static_cast<const C*>(tab),
                   static_cast<const unsigned char*>(bop), g, nu);
  return cudaGetLastError();
}

// vxy's: the shared-memory opt-in and the launch, grid (ceil(X / XC), nt,
// nt)
template <int P, int XP>
cudaError_t launch_xy(const tpufem::BxGeo& g, const void* u, void* y,
                      const void* xb, long long xb_part, const void* bop,
                      cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  const int smem = (int)tpufem::bxy_smem(P, XP).total;
  auto kern = tpufem::l2_bxy_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  constexpr int XC = tpufem::bx_xc(XP);
  kern<<<dim3((g.X + XC - 1) / XC, g.nt, g.nt), tpufem::kBxyThreads, smem,
         stream>>>(static_cast<const C*>(u), static_cast<C*>(y),
                   static_cast<const E*>(xb), xb_part,
                   static_cast<const unsigned char*>(bop), g);
  return cudaGetLastError();
}

// v2's: the shared-memory opt-in and the launch, grid (ceil(X / XC), nt,
// ceil(nt / seg))
template <int P, int XP>
cudaError_t launch_xyz(const tpufem::BxGeo& g, int seg, const void* u,
                       void* y, const void* xb, long long xb_part,
                       const void* bop, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  using E = typename tpufem::LabMma<XP>::E;
  const int smem = (int)tpufem::bxy_smem(P, XP, tpufem::kBxyV2).total;
  auto kern = tpufem::l2_bxyz_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  constexpr int XC = tpufem::bx_xc(XP);
  kern<<<dim3((g.X + XC - 1) / XC, g.nt, (g.nt + seg - 1) / seg),
         tpufem::kBxyThreads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y),
      static_cast<const E*>(xb), xb_part,
      static_cast<const unsigned char*>(bop), g, seg);
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

// out = v3's function of u (layout (size, size, X), out (nt b, nt b, X)) by
// the ring routine with product precision xp (LabXPrec), a tile of b <= 16
// rows a side and a ring of nu u slots.  tab: (6, npts, 2p+2) band tables
// of Mx, Kx, My, Ky, Mz, Kz (Mx and Kx are read); bop: the B operand as
// separable_lab.ring_slices lays it out (nt y sides, then nt z sides, of
// bx_side_bytes each), 16-byte aligned.  Returns the
// cudaError_t of the launch.
int tpufem_l2_ring_apply(int xp, int p, int npts, int b, int nt, int size,
                         int X, int nu, const void* u, void* y,
                         const void* tab, const void* bop, void* stream) {
  if (b < 1 || b > tpufem::kBxN || nt < 1 || (long long)nt * b < npts ||
      size != nt * b + 2 * p || X < npts || X % 16 || nu < 1 ||
      nu > tpufem::kBxMaxU || reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(bop) % 16)
    return (int)cudaErrorInvalidValue;
  const tpufem::BxGeo g{npts, b, nt, size, X};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(xp, p, [&](auto x, auto pp) {
    return launch<decltype(pp)::value, decltype(x)::value>(g, nu, u, y, tab,
                                                           bop, s);
  });
}

// out = vxy's function of u (layout (size, size, X), out (nt b, nt b, X))
// by its ring routine with product precision xp (LabXPrec), a tile of b <=
// 16 rows a side.  xb: the dense x stage's B operand, (parts, X / 16, 32, X)
// as separable_lab.x_blocks lays it out (3xTF32 big then small, bf16x3 and
// bf16 hi then lo, else one part), part q xb_part elements on; bop: the y
// sides of the nt tiles as separable_lab.ring_slices lays them out (bx_side_
// bytes(p, xp, 0) each, then the z sides, which are not read).  u, xb and
// bop 16-byte aligned.  Returns the cudaError_t of the launch.
int tpufem_l2_ring_xy_apply(int xp, int p, int npts, int b, int nt, int size,
                            int X, const void* u, void* y, const void* xb,
                            long long xb_part, const void* bop,
                            void* stream) {
  if (b < 1 || b > tpufem::kBxN || nt < 1 || (long long)nt * b < npts ||
      size != nt * b + 2 * p || X < npts || X % 16 ||
      reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(xb) % 16 ||
      reinterpret_cast<uintptr_t>(bop) % 16)
    return (int)cudaErrorInvalidValue;
  const tpufem::BxGeo g{npts, b, nt, size, X};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(xp, p, [&](auto x, auto pp) {
    return launch_xy<decltype(pp)::value, decltype(x)::value>(
        g, u, y, xb, xb_part, bop, s);
  });
}

// out = v2's function of u (K2's operator; v6's, v8's and v9's too) on the
// same layouts and operands as tpufem_l2_ring_xy_apply (bop's z sides read
// too) by its ring routine, a segment of seg consecutive z tiles a block: seg > 1
// only where a pass ends one tile and starts the next (b % 8 == 0 and 2p <=
// 8), else 1.  Every seg computes the same output.  Returns the cudaError_t
// of the launch.
int tpufem_l2_ring_xyz_apply(int xp, int p, int npts, int b, int nt,
                             int size, int X, int seg, const void* u,
                             void* y, const void* xb, long long xb_part,
                             const void* bop, void* stream) {
  if (b < 1 || b > tpufem::kBxN || nt < 1 || (long long)nt * b < npts ||
      size != nt * b + 2 * p || X < npts || X % 16 || seg < 1 ||
      seg > nt || (seg > 1 && (b % tpufem::kBxZC || 2 * p > tpufem::kBxZC)) ||
      reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(xb) % 16 ||
      reinterpret_cast<uintptr_t>(bop) % 16)
    return (int)cudaErrorInvalidValue;
  const tpufem::BxGeo g{npts, b, nt, size, X};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dispatch(xp, p, [&](auto x, auto pp) {
    return launch_xyz<decltype(pp)::value, decltype(x)::value>(
        g, seg, u, y, xb, xb_part, bop, s);
  });
}

// Shared-memory bytes of one block of v2's ring.
long long tpufem_l2_ring_xyz_smem_bytes(int p, int xp) {
  return tpufem::bxy_smem(p, xp, tpufem::kBxyV2).total;
}

// Shared-memory bytes of one block of vxy's ring.
long long tpufem_l2_ring_xy_smem_bytes(int p, int xp) {
  return tpufem::bxy_smem(p, xp).total;
}

// Shared-memory bytes of one block; the chooser in
// tpufem_torch/lab/separable_lab.py sizes the ring with it.
long long tpufem_l2_ring_smem_bytes(int p, int xp, int nu) {
  return tpufem::bx_smem(p, xp, nu).total;
}

// The products' K: rows L = 16 + 2p rounded up to the k step
// (separable_lab.ring_k lays the B operand out for it).
int tpufem_l2_ring_k(int p, int xp) { return tpufem::bx_lp(p, xp); }

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
