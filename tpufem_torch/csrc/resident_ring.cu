// Host launcher of the solver-resident 3D band operators K1 and K4 (device
// code and the design note in resident_ring.cuh), with a plain C interface
// for ctypes.  Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so resident_ring.cu
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "resident_ring.cuh"

namespace {

// the tensor maps of the two resident layouts, then the launch
template <int P, typename S, typename C, int PLAN>
cudaError_t launch(int mode, const tpufem::ResGeo& g, const void* u, void* y,
                   void* part, const void* tables, cudaStream_t stream) {
  const int xc = tpufem::ring_xc(sizeof(S));
  const tpufem::RingPieces pc = tpufem::ring_pieces(g.tz, g.ty);
  tpufem::HopMap in_map, out_map;
  const long long dim[3] = {g.X, g.npts, g.npts};
  const int in_box[3] = {xc, g.ty + 2 * P, g.tz + 2 * P};
  const int out_box[3] = {xc, pc.by, pc.bz};
  if (tpufem::hop_map_3d(&in_map, const_cast<void*>(u), sizeof(S), dim,
                         in_box) ||
      tpufem::hop_map_3d(&out_map, y, sizeof(S), dim, out_box))
    return cudaErrorInvalidValue;
  const int nwin = PLAN == tpufem::kPlanTerms ? g.group : 2;
  const int smem =
      (int)tpufem::res_smem(P, sizeof(S), sizeof(C), nwin, g.tz, g.ty).total;
  auto kern = tpufem::resident_ring_kernel<P, S, C, PLAN>;
  static std::atomic<int> granted[tpufem::kRingMaxDevices];
  cudaError_t e = tpufem::ring_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.npts + g.ty - 1) / g.ty, (g.npts + g.tz - 1) / g.tz);
  kern<<<grid, tpufem::kRingThreads, smem, stream>>>(
      in_map, out_map, static_cast<const S*>(u), static_cast<C*>(part),
      static_cast<const C*>(tables), g, mode);
  return cudaGetLastError();
}

template <typename S, typename C, int PLAN>
cudaError_t dispatch_p(int p, int mode, const tpufem::ResGeo& g,
                       const void* u, void* y, void* part, const void* tables,
                       cudaStream_t stream) {
#define TPUFEM_CASE(PP) \
  case PP:              \
    return launch<PP, S, C, PLAN>(mode, g, u, y, part, tables, stream);
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

template <int PLAN>
cudaError_t dispatch_dtype(int dtype_code, int p, int mode,
                           const tpufem::ResGeo& g, const void* u, void* y,
                           void* part, const void* tables,
                           cudaStream_t stream) {
  switch (dtype_code) {
    case 0:  // f64 storage, f64 compute
      return dispatch_p<double, double, PLAN>(p, mode, g, u, y, part, tables,
                                              stream);
    case 1:  // f32 storage, f32 compute
      return dispatch_p<float, float, PLAN>(p, mode, g, u, y, part, tables,
                                            stream);
    case 2:  // bf16 storage, f32 compute ("bf16s")
      return dispatch_p<__nv_bfloat16, float, PLAN>(p, mode, g, u, y, part,
                                                    tables, stream);
  }
  return cudaErrorInvalidValue;
}

int storage_bytes(int dtype_code) {
  return dtype_code == 0 ? 8 : dtype_code == 1 ? 4 : 2;
}

}  // namespace

extern "C" {

// y = the plan's operator of u on the resident layout (npts, npts, X), both
// 16-byte aligned and apart.  Table rows are res_nwp(p) values apart, 16-byte
// aligned.  plan 0 (K1): tables (6, npts, .) [Kx, Mx, Ky, My, Kz, Mz]; plan 1
// (K4): tables (n_terms, 3, npts, .), axis 0 = x,
// the windows of `group` terms resident (1 <= group <= n_terms; a smaller
// group takes passes over x, which keep their partial sums in `part`: y
// itself in f32 and f64, a (npts, npts, X) f32 buffer in bf16s).  With
// dirichlet the tables are those of the masked 1D matrices and boundary
// points store their input.  mode 0 applies; mode 1 copies (y = u through
// the ring), mode 2 runs the z and y stages only (y = the sum of the windows
// at x), both without the mask.  Sub-tile (tz, ty): tpufem_resident_takes.
// Returns the cudaError_t of the launch (a refused argument or a tensor map
// that cannot be encoded: cudaErrorInvalidValue).
int tpufem_resident_apply(int plan, int dtype_code, int p, int npts, int X,
                          int n_terms, int group, int tz, int ty, int mode,
                          int dirichlet, const void* u, void* y, void* part,
                          const void* tables, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code < 0 || dtype_code > 2 || p < 1 || p > 8 || npts < 2)
    return (int)cudaErrorInvalidValue;
  const int xc = tpufem::ring_xc(storage_bytes(dtype_code));
  if (X % xc || X < npts || X - npts >= xc || mode < 0 || mode > 2 ||
      (mode != 0 && dirichlet) || u == y ||
      reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 ||
      !tpufem::res_takes(p, tz, ty))
    return (int)cudaErrorInvalidValue;
  if (plan == tpufem::kPlanTerms &&
      (n_terms < 1 || group < 1 || group > n_terms ||
       (group < n_terms && mode != 1 && part == nullptr)))
    return (int)cudaErrorInvalidValue;
  const tpufem::ResGeo g{npts, X, tz, ty, n_terms, group, dirichlet};
  if (plan == tpufem::kPlanLaplace)
    return (int)dispatch_dtype<tpufem::kPlanLaplace>(dtype_code, p, mode, g, u,
                                                     y, part, tables, s);
  if (plan == tpufem::kPlanTerms)
    return (int)dispatch_dtype<tpufem::kPlanTerms>(dtype_code, p, mode, g, u,
                                                   y, part, tables, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block: nwin windows (K1: 2; K4: its group) at
// sub-tile (tz, ty); the sub-tile chooser in kernel_separable.py sizes its
// blocks and K4's group with it.
long long tpufem_resident_smem_bytes(int p, int dtype_code, int nwin, int tz,
                                     int ty) {
  return tpufem::res_smem(p, storage_bytes(dtype_code),
                          dtype_code == 0 ? 8 : 4, nwin, tz, ty)
      .total;
}

// 1 where the routine takes the sub-tile.
int tpufem_resident_takes(int p, int tz, int ty) {
  return tpufem::res_takes(p, tz, ty) ? 1 : 0;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
