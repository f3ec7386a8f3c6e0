// Host launcher of the two toolchain probes (device code and the design
// note in toolchain_probe.cuh), with a plain C interface for ctypes.  Built
// by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so toolchain_probe.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "toolchain_probe.cuh"

namespace {

template <int XP>
cudaError_t matmul(int n, const void* a, const void* b, void* c,
                   cudaStream_t stream) {
  const int tiles = (n / tpufem::kPT) * (n / tpufem::kPT);
  tpufem::probe_matmul_kernel<XP>
      <<<(tiles + tpufem::kP1Warps - 1) / tpufem::kP1Warps,
         tpufem::kP1Threads, 0, stream>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(b),
                                          static_cast<float*>(c), n);
  return cudaGetLastError();
}

template <int XP, int MODE>
cudaError_t chain(int m, int n_iter, int fpp, float c1, float c2,
                  const void* a, const void* w, long long w_lo, const void* v,
                  void* o, void* vo, cudaStream_t stream) {
  using E = typename tpufem::LabMma<XP>::E;
  const int smem = (int)tpufem::probe_chain_smem(m);
  auto kern = tpufem::probe_chain_kernel<XP, MODE>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<m / tpufem::kP2Rows, tpufem::kP2Threads, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const E*>(w), w_lo,
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(vo), m, n_iter, fpp, c1, c2);
  return cudaGetLastError();
}

template <int XP>
cudaError_t chain_mode(int mode, int m, int n_iter, int fpp, float c1,
                       float c2, const void* a, const void* w, long long w_lo,
                       const void* v, void* o, void* vo, cudaStream_t s) {
  switch (mode) {
    case tpufem::kProbeMma:
      return chain<XP, tpufem::kProbeMma>(m, n_iter, fpp, c1, c2, a, w, w_lo,
                                          v, o, vo, s);
    case tpufem::kProbeFma:
      return chain<XP, tpufem::kProbeFma>(m, n_iter, fpp, c1, c2, a, w, w_lo,
                                          v, o, vo, s);
    case tpufem::kProbeBoth:
      return chain<XP, tpufem::kProbeBoth>(m, n_iter, fpp, c1, c2, a, w, w_lo,
                                           v, o, vo, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1: c = a b, (n, n) f32 row-major, n a multiple of 16, in arithmetic xp
// (LabXPrec: 3xTF32, 1xTF32, bf16x3 or one bf16 product).  Returns the
// cudaError_t of the launch.
int tpufem_probe_matmul(int xp, int n, const void* a, const void* b, void* c,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 16 || n % 16) return (int)cudaErrorInvalidValue;
  switch (xp) {
    case tpufem::kX3TF32:
      return (int)matmul<tpufem::kX3TF32>(n, a, b, c, s);
    case tpufem::kX1TF32:
      return (int)matmul<tpufem::kX1TF32>(n, a, b, c, s);
    case tpufem::kXBF16x3:
      return (int)matmul<tpufem::kXBF16x3>(n, a, b, c, s);
    case tpufem::kXBF16:
      return (int)matmul<tpufem::kXBF16>(n, a, b, c, s);
  }
  return (int)cudaErrorInvalidValue;
}

// P2: mode (ProbeMode) mma: o = a w^n_iter, vo = v; fma: vo = v after fpp
// n_iter steps v <- v c1 + c2, o = a; both: both chains.  a, v, o, vo: (m,
// m) f32; w: (m, m) f32, or in the bf16 arithmetics its bf16 hi part with
// the lo part w_lo elements on; m a multiple of 16, n_iter >= 1.  Returns
// the cudaError_t of the launch.
int tpufem_probe_chain(int mode, int xp, int m, int n_iter, int fpp, float c1,
                       float c2, const void* a, const void* w, long long w_lo,
                       const void* v, void* o, void* vo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 16 || m % 16 || n_iter < 1 || fpp < 0 ||
      tpufem::probe_chain_smem(m) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  switch (xp) {
#define TPUFEM_XP(XP)                                                        \
  case XP:                                                                   \
    return (int)chain_mode<XP>(mode, m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, \
                               vo, s);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return (int)cudaErrorInvalidValue;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
