// Tensor-core pieces shared by the kernel-lab routines (lab_resident.cuh:
// L1, the K1 lab; lab_separable.cuh: L2a, the K2 lab's x-first half;
// lab_zyfirst.cuh: L2b, its z/y-first half) and the toolchain probes
// (toolchain_probe.cuh): the precision codes, their WMMA fragment shapes,
// the TF32 and bf16 splits of an operand, one MMA k step in each precision,
// the shared-memory helpers that store a value in a dense stage's operand
// format, a named barrier and the cp.async copies.
//
// Precisions (XP) of a tensor-core product, all with an f32 (f64) sum:
//   kX3TF32   a = big + small in TF32, three products (small*big, big*small,
//             big*big), ~f32
//   kX1TF32   one TF32 product (~1e-3 relative)
//   kXBF16x3  a = hi + lo in bf16, three products (lo*hi, hi*lo, hi*hi)
//   kXF64     f64 storage, DMMA m8n8k4
//   kXBF16    one bf16 product (hi*hi): the hi part of bf16x3
#pragma once

#include <cstring>
#include <type_traits>

#ifdef __CUDACC__
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#endif

namespace tpufem {

namespace wmma = nvcuda::wmma;

enum LabXPrec {
  kX3TF32 = 0,
  kX1TF32 = 1,
  kXBF16x3 = 2,
  kXF64 = 3,
  kXBF16 = 4
};

// Fragment shapes and types of each precision: C the storage, band and
// accumulator type, AT the fragment's input type, E the element type of an
// operand in memory (bf16: a hi array, its lo array further on).
template <int XP>
struct LabMma {  // kX3TF32, kX1TF32
  static constexpr int M = 16, N = 16, K = 8;
  using C = float;
  using AT = wmma::precision::tf32;
  using E = float;
  static constexpr bool kBF16 = false;
};
template <>
struct LabMma<kXBF16x3> {
  static constexpr int M = 16, N = 16, K = 16;
  using C = float;
  using AT = __nv_bfloat16;
  using E = __nv_bfloat16;
  static constexpr bool kBF16 = true;
};
template <>
struct LabMma<kXBF16> : LabMma<kXBF16x3> {};
template <>
struct LabMma<kXF64> {
  static constexpr int M = 8, N = 8, K = 4;
  using C = double;
  using AT = double;
  using E = double;
  static constexpr bool kBF16 = false;
};

template <int XP>
struct LabFrag {
  using T = LabMma<XP>;
  using FA = wmma::fragment<wmma::matrix_a, T::M, T::N, T::K, typename T::AT,
                            wmma::row_major>;
  using FB = wmma::fragment<wmma::matrix_b, T::M, T::N, T::K, typename T::AT,
                            wmma::row_major>;
  using FC = wmma::fragment<wmma::accumulator, T::M, T::N, T::K,
                            typename T::C>;
};

__host__ __device__ inline long long lab_align(long long b) {
  return (b + 127) / 128 * 128;
}

// A barrier of `count` threads: 0 is the whole block.
__device__ __forceinline__ void lab_sync(int id, int count) {
#ifdef __CUDA_ARCH__
  if (id == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
#else
  __syncthreads();
#endif
}

// cp.async: 16 bytes from device memory to shared memory without passing
// through registers (both 16-byte aligned); a thread's copies so far form a
// group at lab_cp_commit, and lab_cp_wait returns once all its groups have
// landed.  Other threads see them after the next barrier.  A host build
// copies at once.
__device__ __forceinline__ void lab_cp16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem)
               : "memory");
#else
  std::memcpy(smem, gmem, 16);
#endif
}
__device__ __forceinline__ void lab_cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}
__device__ __forceinline__ void lab_cp_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;" ::: "memory");
#endif
}

// ... once all but its N newest groups have landed (a ring of N + 1 stages)
template <int N>
__device__ __forceinline__ void lab_cp_wait_but() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
#endif
}

// f32 fragment -> big + small TF32 parts (3xTF32)
template <typename F>
__device__ __forceinline__ void lab_tf32_split(F& big, F& small) {
  for (int e = 0; e < big.num_elements; ++e) {
    const float v = big.x[e];
    const float b = wmma::__float_to_tf32(v);
    small.x[e] = wmma::__float_to_tf32(v - b);
    big.x[e] = b;
  }
}
template <typename F>
__device__ __forceinline__ void lab_tf32_round(F& f) {
  for (int e = 0; e < f.num_elements; ++e)
    f.x[e] = wmma::__float_to_tf32(f.x[e]);
}

// Store v at element i of a buffer: as C (split < 0), or in bf16 operand
// format, hi at i and lo at split + i (v = hi + lo to ~2^-16 relative).
template <typename C>
__device__ __forceinline__ void lab_put(unsigned char* qq, long long split,
                                        long long i, C v) {
  reinterpret_cast<C*>(qq)[i] = v;
}
template <>
__device__ __forceinline__ void lab_put<float>(unsigned char* qq,
                                               long long split, long long i,
                                               float v) {
  if (split < 0) {
    reinterpret_cast<float*>(qq)[i] = v;
    return;
  }
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(qq);
  const __nv_bfloat16 hi = __float2bfloat16(v);
  h[i] = hi;
  h[split + i] = __float2bfloat16(v - __bfloat162float(hi));
}

template <typename C>
__device__ __forceinline__ C lab_get(const unsigned char* qq, long long split,
                                     long long i) {
  return reinterpret_cast<const C*>(qq)[i];
}
template <>
__device__ __forceinline__ float lab_get<float>(const unsigned char* qq,
                                                long long split, long long i) {
  if (split < 0) return reinterpret_cast<const float*>(qq)[i];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(qq);
  return __bfloat162float(h[i]) + __bfloat162float(h[split + i]);
}

// One MMA k step: acc += A (M x K at a, leading dimension lda) @ B (K x N
// at b, ldb) in precision XP.  In the bf16 precisions an operand's lo part
// sits a_lo (b_lo) elements after its hi part; bf16x1 reads hi only.
template <int XP>
__device__ __forceinline__ void lab_mma(
    typename LabFrag<XP>::FC& acc, const typename LabMma<XP>::E* a,
    long long a_lo, int lda, const typename LabMma<XP>::E* b, long long b_lo,
    int ldb) {
  typename LabFrag<XP>::FA fa;
  typename LabFrag<XP>::FB fb;
  wmma::load_matrix_sync(fa, a, lda);
  wmma::load_matrix_sync(fb, b, ldb);
  if constexpr (XP == kXBF16x3) {
    typename LabFrag<XP>::FA fal;
    typename LabFrag<XP>::FB fbl;
    wmma::load_matrix_sync(fal, a + a_lo, lda);
    wmma::load_matrix_sync(fbl, b + b_lo, ldb);
    wmma::mma_sync(acc, fal, fb, acc);
    wmma::mma_sync(acc, fa, fbl, acc);
  }
  if constexpr (XP == kX3TF32) {
    typename LabFrag<XP>::FA fas;
    typename LabFrag<XP>::FB fbs;
    lab_tf32_split(fa, fas);
    lab_tf32_split(fb, fbs);
    wmma::mma_sync(acc, fas, fb, acc);
    wmma::mma_sync(acc, fa, fbs, acc);
  }
  if constexpr (XP == kX1TF32) {
    lab_tf32_round(fa);
    lab_tf32_round(fb);
  }
  wmma::mma_sync(acc, fa, fb, acc);
}

#ifdef __CUDACC__
constexpr int kLabMaxDevices = 64;

// Opt a kernel into `smem` bytes of dynamic shared memory on the current
// device, once per kernel and device (again only for a larger block).
template <typename Kern>
cudaError_t lab_opt_in(Kern kern, int smem, std::atomic<int>* granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kLabMaxDevices) return cudaErrorInvalidDevice;
  if (smem > granted[dev].load()) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    granted[dev].store(smem);
  }
  return cudaSuccess;
}
#endif

}  // namespace tpufem
