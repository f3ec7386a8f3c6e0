// Host entries of the band operators on the resident layouts, K1, K3 and K4
// (device code and the design note in resident_ring.cuh): the launcher, with
// a plain C interface for ctypes.  Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so resident_ring.cu
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "resident_ring.cuh"

namespace {

using namespace tpufem;

// One launch: its arguments, or (blocks_per_sm not null) the query of how
// many blocks of it an SM holds at once.
struct RingArgs {
  ResGeo g;
  int mode;
  const void* u;
  void* y;
  void* part;
  const void* tables;
  cudaStream_t stream;
  int* blocks_per_sm;
};

// the shared-memory opt-in, the occupancy query or the tensor maps of the
// resident layouts and the launch
template <int P, typename S, typename C, int PLAN, int DIM>
cudaError_t ring_launch(const RingArgs& a) {
  const ResGeo& g = a.g;
  const int nwin = PLAN == kPlanTerms ? g.group : 2;
  const int smem =
      (int)res_smem(P, sizeof(S), sizeof(C), nwin, g.tz, g.ty, DIM).total;
  auto kern = resident_ring_kernel<P, S, C, PLAN, DIM>;
  static std::atomic<int> granted[kRingMaxDevices];
  cudaError_t e = ring_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  if (a.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, kern, kRingThreads, smem);
  HopMap in_map, out_map;
  const int xc = ring_xc(sizeof(S), DIM);
  const RingPieces pc = ring_pieces(g.tz, g.ty);
  const long long dim[3] = {g.X, g.npts, DIM == 3 ? g.npts : 1};
  const int in_box[3] = {xc, g.ty + 2 * P, DIM == 3 ? g.tz + 2 * P : 1};
  const int out_box[3] = {xc, pc.by, pc.bz};
  if (hop_map_3d(&in_map, const_cast<void*>(a.u), sizeof(S), dim, in_box) ||
      hop_map_3d(&out_map, a.y, sizeof(S), dim, out_box))
    return cudaErrorInvalidValue;
  const dim3 grid((g.npts + g.ty - 1) / g.ty,
                  DIM == 3 ? (g.npts + g.tz - 1) / g.tz : 1, g.nseg);
  kern<<<grid, kRingThreads, smem, a.stream>>>(
      in_map, out_map, static_cast<const S*>(a.u), static_cast<C*>(a.part),
      static_cast<const C*>(a.tables), g, a.mode);
  return cudaGetLastError();
}

// ring_launch at degree p = 1..8
template <typename S, typename C, int PLAN, int DIM>
cudaError_t ring_by_p(int p, const RingArgs& a) {
#define TPUFEM_CASE(PP) \
  case PP:              \
    return ring_launch<PP, S, C, PLAN, DIM>(a);
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

template <int PLAN, int DIM>
cudaError_t by_dtype(int dtype_code, int p, const RingArgs& a) {
  switch (dtype_code) {
    case 0:  // f64 storage, f64 compute
      return ring_by_p<double, double, PLAN, DIM>(p, a);
    case 1:  // f32 storage, f32 compute
      return ring_by_p<float, float, PLAN, DIM>(p, a);
    case 2:  // bf16 storage, f32 compute ("bf16s")
      return ring_by_p<__nv_bfloat16, float, PLAN, DIM>(p, a);
  }
  return cudaErrorInvalidValue;
}

// K1 (the Laplace plan, 3D), K4 (the terms plan, 3D), K3 (the terms plan, 2D)
cudaError_t dispatch(int plan, int dim, int dtype_code, int p,
                     const RingArgs& a) {
  if (plan == kPlanLaplace && dim == 3)
    return by_dtype<kPlanLaplace, 3>(dtype_code, p, a);
  if (plan == kPlanTerms && dim == 3)
    return by_dtype<kPlanTerms, 3>(dtype_code, p, a);
  if (plan == kPlanTerms && dim == 2)
    return by_dtype<kPlanTerms, 2>(dtype_code, p, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y = the plan's operator of u on the resident layout ((npts, npts, X) in
// 3D, (npts, X) in 2D), both 16-byte aligned and apart.  Table rows are
// res_nwp(p) values apart, 16-byte aligned.  plan 0 (K1, 3D): tables (6,
// npts, .) [Kx, Mx, Ky, My, Kz, Mz]; plan 1 (K4 in 3D, K3 in 2D): tables
// (n_terms, dim, npts, .), axis 0 = x, the windows of `group` terms resident
// (1 <= group <= n_terms; a smaller group takes passes over x, which keep
// their partial sums in `part`: y itself in f32 and f64, an f32 buffer of
// y's layout in bf16s).  With dirichlet the tables are those of the masked
// 1D matrices and boundary points store their input.  nseg: segments of x
// (1 .. X / chunk; K1 and K4 take 1).  mode 0 applies; mode 1 copies (y = u
// through the ring), mode 2 runs the z and y stages only (y = the sum of the
// windows at x), both without the mask.  Sub-tile (tz, ty) (2D: tz = 1):
// tpufem_ring_takes.  Returns the cudaError_t of the launch (a refused
// argument or a tensor map that cannot be encoded: cudaErrorInvalidValue).
int tpufem_ring_apply(int plan, int dim, int dtype_code, int p, int npts,
                      int X, int n_terms, int group, int tz, int ty, int nseg,
                      int mode, int dirichlet, const void* u, void* y,
                      void* part, const void* tables, void* stream) {
  if (!tpufem::ring_args_ok(plan, dim, dtype_code, p, npts, X, n_terms, group,
                            tz, ty, nseg, mode, dirichlet, u, y, part))
    return (int)cudaErrorInvalidValue;
  const RingArgs a{{npts, X, tz, ty, n_terms, group, dirichlet, nseg},
                   mode, u, y, part, tables,
                   static_cast<cudaStream_t>(stream), nullptr};
  return (int)dispatch(plan, dim, dtype_code, p, a);
}

// Blocks of one launch an SM holds at once (the segment chooser in
// kernel_separable.py sizes its grid with it); -1 where refused.
int tpufem_ring_blocks_per_sm(int plan, int dim, int dtype_code, int p,
                              int group, int tz, int ty) {
  int n = -1;
  const RingArgs a{{0, 0, tz, ty, group, group, 0, 1},
                   0, nullptr, nullptr, nullptr, nullptr, nullptr, &n};
  if (!tpufem::res_takes(p, tz, ty, dim) || group < 1 ||
      dispatch(plan, dim, dtype_code, p, a) != cudaSuccess)
    return -1;
  return n;
}

// Shared-memory bytes of one block: nwin windows (the Laplace plan: 2; the
// terms plan: its group) at sub-tile (tz, ty); the sub-tile chooser in
// kernel_separable.py sizes its blocks and the term group with it.
long long tpufem_ring_smem_bytes(int p, int dim, int dtype_code, int nwin,
                                 int tz, int ty) {
  return tpufem::res_smem(p, tpufem::ring_storage_bytes(dtype_code),
                          dtype_code == 0 ? 8 : 4, nwin, tz, ty, dim)
      .total;
}

// 1 where the routine takes the sub-tile.
int tpufem_ring_takes(int p, int dim, int tz, int ty) {
  return tpufem::res_takes(p, tz, ty, dim) ? 1 : 0;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
