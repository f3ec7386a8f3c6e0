// Host launchers of the fused separable Laplace apply, K2 (device code and
// the design note in separable_apply.cuh): the z-march, which K2 launches,
// and the tile routine, its earlier schedule, with a plain C interface for
// ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so separable_apply.cu
#include <cuda_runtime.h>

#include <atomic>

#include "separable_apply.cuh"

namespace {

constexpr int kMaxDevices = 64;

// above 48 KB dynamic shared memory must be opted into per kernel and
// device; the opt-in is made once per instantiation and device (and again
// only for a larger block).  A refused launch shows only in
// cudaGetLastError, never at a synchronize.
template <typename K>
cudaError_t opt_in(K kern, int smem, std::atomic<int>* granted) {
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
  return cudaSuccess;
}

// The z-march's launch, or (blocks_per_sm not null) the query of how many of
// its blocks an SM holds at once.  nseg: segments of the march axis.
template <int P, int DIM, typename C>
cudaError_t launch_march(int npts, int ty, int tx, int nseg, const void* u,
                         void* y, const void* tables, cudaStream_t stream,
                         int* blocks_per_sm) {
  constexpr int CPT = tpufem::march_cpt(DIM, P, sizeof(C));
  if (DIM == 2) ty = 1;
  if (npts < 1 || ty < 1 || tx < 1 || nseg < 1 ||
      (long long)(DIM == 3 ? ty + 2 * P : 1) * (tx + 2 * P) >
          (long long)CPT * tpufem::kThreads)
    return cudaErrorInvalidValue;
  const int smem =
      (int)(tpufem::march_smem_elems(DIM, P, ty, tx) * (long long)sizeof(C));
  auto kern = tpufem::separable_apply_march<P, DIM, C, CPT>;
  static std::atomic<int> granted[kMaxDevices];
  cudaError_t e = opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kern, tpufem::kThreads, smem);
  const int seg = (npts + nseg - 1) / nseg;
  const int nm = (npts + seg - 1) / seg;  // no empty segment
  const int nx = (npts + tx - 1) / tx;
  const dim3 grid(nx, DIM == 3 ? (npts + ty - 1) / ty : nm,
                  DIM == 3 ? nm : 1);
  kern<<<grid, tpufem::kThreads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y),
      static_cast<const C*>(tables), npts, ty, tx, seg);
  return cudaGetLastError();
}

template <int P, int DIM, typename C>
cudaError_t launch(int npts, int tz, int ty, int tx, const void* u, void* y,
                   const void* tables, cudaStream_t stream) {
  const int smem =
      (int)(tpufem::smem_elems(DIM, P, tz, ty, tx) * (long long)sizeof(C));
  auto kern = tpufem::separable_apply_kernel<P, DIM, C>;
  static std::atomic<int> granted[kMaxDevices];
  cudaError_t e = opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
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

template <int DIM, typename C>
cudaError_t dispatch_march_p(int p, int npts, int ty, int tx, int nseg,
                             const void* u, void* y, const void* tables,
                             cudaStream_t stream, int* bps) {
#define TPUFEM_CASE(PP)                                                  \
  case PP:                                                               \
    return launch_march<PP, DIM, C>(npts, ty, tx, nseg, u, y, tables,    \
                                    stream, bps);
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

cudaError_t dispatch_march(int dtype_code, int dim, int p, int npts, int ty,
                           int tx, int nseg, const void* u, void* y,
                           const void* tables, cudaStream_t s, int* bps) {
  if (dim == 3 && dtype_code == 0)
    return dispatch_march_p<3, double>(p, npts, ty, tx, nseg, u, y, tables, s,
                                       bps);
  if (dim == 3 && dtype_code == 1)
    return dispatch_march_p<3, float>(p, npts, ty, tx, nseg, u, y, tables, s,
                                      bps);
  if (dim == 2 && dtype_code == 0)
    return dispatch_march_p<2, double>(p, npts, ty, tx, nseg, u, y, tables, s,
                                       bps);
  if (dim == 2 && dtype_code == 1)
    return dispatch_march_p<2, float>(p, npts, ty, tx, nseg, u, y, tables, s,
                                      bps);
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

// y = A u on a (npts,)^dim grid by the z-march (K2): output tiles (ty, tx)
// (2D: tx; ty ignored) over nseg segments of the march axis (z; 2D: y).
// tables as tpufem_separable_apply's.  Returns the cudaError_t of the launch
// (0 = launched; cudaErrorInvalidValue where the tile exceeds the halo'd
// columns a block holds, tpufem_march_cols).
int tpufem_separable_march(int dtype_code, int dim, int p, int npts, int ty,
                           int tx, int nseg, const void* u, void* y,
                           const void* tables, void* stream) {
  return (int)dispatch_march(dtype_code, dim, p, npts, ty, tx, nseg, u, y,
                             tables, static_cast<cudaStream_t>(stream),
                             nullptr);
}

// Blocks of the z-march at tile (ty, tx) an SM holds at once (its registers
// and shared memory, by the CUDA occupancy query); -1 where the tile is not
// taken.
int tpufem_march_blocks_per_sm(int dtype_code, int dim, int p, int ty,
                               int tx) {
  int n = -1;
  if (dispatch_march(dtype_code, dim, p, 1, ty, tx, 1, nullptr, nullptr,
                     nullptr, nullptr, &n) != cudaSuccess)
    return -1;
  return n;
}

// Halo'd columns ((ty+2p)(tx+2p); 2D: tx+2p) a block of the z-march holds.
int tpufem_march_cols(int dtype_code, int dim, int p) {
  return tpufem::march_cols(dim, p, dtype_code == 0 ? 8 : 4);
}

// Shared-memory elements (of the compute type) of one z-march block.
long long tpufem_march_smem_elems(int dim, int p, int ty, int tx) {
  return tpufem::march_smem_elems(dim, p, ty, tx);
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
