// Host launcher of the 2D sum-of-tensor-products apply, K3 (device code and
// the design note in terms_apply.cuh), with a plain C interface for ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so terms_apply.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "terms_apply.cuh"

namespace {

constexpr int kMaxDevices = 64;

template <int P, typename S, typename C>
cudaError_t launch(int n_terms, int npts, int ty, int tx, const void* u,
                   void* y, const void* tables, cudaStream_t stream) {
  const int smem = (int)(tpufem::terms_smem_elems(P, n_terms, ty, tx) *
                         (long long)sizeof(C));
  auto kern = tpufem::terms_apply_kernel<P, S, C>;
  // above 48 KB dynamic shared memory must be opted into per kernel and
  // device; the opt-in is made once per instantiation and device (and again
  // only for a larger block).  A refused launch shows only in
  // cudaGetLastError, never at a synchronize.
  static std::atomic<int> granted[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > granted[dev].load()) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    granted[dev].store(smem);
  }
  const dim3 grid((npts + tx - 1) / tx, (npts + ty - 1) / ty);
  kern<<<grid, tpufem::kThreads, smem, stream>>>(
      static_cast<const S*>(u), static_cast<S*>(y),
      static_cast<const C*>(tables), n_terms, npts, ty, tx);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t dispatch_p(int p, int n_terms, int npts, int ty, int tx,
                       const void* u, void* y, const void* tables,
                       cudaStream_t stream) {
#define TPUFEM_CASE(PP) \
  case PP:              \
    return launch<PP, S, C>(n_terms, npts, ty, tx, u, y, tables, stream);
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

// y = sum_a X_{a,1} (x) X_{a,0} u on a (npts, npts) grid.  tables:
// (n_terms, 2, npts, 2p+2) band tables in the compute type, axis b = 0 is
// x.  dtype_code 0: f64, 1: f32, 2: bf16 storage with f32 arithmetic.
// Returns the cudaError_t of the launch (0 = launched).
int tpufem_terms_apply(int dtype_code, int p, int n_terms, int npts, int ty,
                       int tx, const void* u, void* y, const void* tables,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_terms < 1) return (int)cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0:
      return (int)dispatch_p<double, double>(p, n_terms, npts, ty, tx, u, y,
                                             tables, s);
    case 1:
      return (int)dispatch_p<float, float>(p, n_terms, npts, ty, tx, u, y,
                                           tables, s);
    case 2:
      return (int)dispatch_p<__nv_bfloat16, float>(p, n_terms, npts, ty, tx,
                                                   u, y, tables, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory elements (of the compute type) of one block at this tile
// and term count; the tile chooser in kernel_terms.py sizes its blocks
// with it.
long long tpufem_terms_smem_elems(int p, int n_terms, int ty, int tx) {
  return tpufem::terms_smem_elems(p, n_terms, ty, tx);
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
