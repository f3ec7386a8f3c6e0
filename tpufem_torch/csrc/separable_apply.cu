// Host launcher of the fused separable Laplace apply, K2 (device code and
// the design note in separable_apply.cuh), with a plain C interface for ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so separable_apply.cu
#include <cuda_runtime.h>

#include <atomic>

#include "separable_apply.cuh"

namespace {

constexpr int kMaxDevices = 64;

template <int P, int DIM, typename C>
cudaError_t launch(int npts, int tz, int ty, int tx, const void* u, void* y,
                   const void* tables, cudaStream_t stream) {
  const int smem =
      (int)(tpufem::smem_elems(DIM, P, tz, ty, tx) * (long long)sizeof(C));
  auto kern = tpufem::separable_apply_kernel<P, DIM, C>;
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
  const dim3 grid((npts + tx - 1) / tx, (npts + ty - 1) / ty,
                  DIM == 3 ? (npts + tz - 1) / tz : 1);
  kern<<<grid, tpufem::kThreads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y),
      static_cast<const C*>(tables), npts, tz, ty, tx);
  return cudaGetLastError();
}

template <int DIM, typename C>
cudaError_t dispatch_p(int p, int npts, int tz, int ty, int tx, const void* u,
                       void* y, const void* tables, cudaStream_t stream) {
#define TPUFEM_CASE(PP) \
  case PP:              \
    return launch<PP, DIM, C>(npts, tz, ty, tx, u, y, tables, stream);
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

template <int DIM>
cudaError_t dispatch_dtype(int dtype_code, int p, int npts, int tz, int ty,
                           int tx, const void* u, void* y, const void* tables,
                           cudaStream_t stream) {
  switch (dtype_code) {
    case 0:  // f64
      return dispatch_p<DIM, double>(p, npts, tz, ty, tx, u, y, tables,
                                     stream);
    case 1:  // f32
      return dispatch_p<DIM, float>(p, npts, tz, ty, tx, u, y, tables, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y = A u on a (npts,)^dim grid.  tables: (2*dim, npts, 2p+2) band tables
// [Kx, Mx, Ky, My(, Kz, Mz)] in the vectors' type.  Returns the cudaError_t
// of the launch (0 = launched).
int tpufem_separable_apply(int dtype_code, int dim, int p, int npts, int tz,
                           int ty, int tx, const void* u, void* y,
                           const void* tables, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3)
    return (int)dispatch_dtype<3>(dtype_code, p, npts, tz, ty, tx, u, y,
                                  tables, s);
  if (dim == 2)
    return (int)dispatch_dtype<2>(dtype_code, p, npts, 1, ty, tx, u, y,
                                  tables, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory elements (of the compute type) of one block at this tile;
// the tile chooser in kernel_separable.py sizes its blocks with it.
long long tpufem_smem_elems(int dim, int p, int tz, int ty, int tx) {
  return tpufem::smem_elems(dim, p, tz, ty, tx);
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
