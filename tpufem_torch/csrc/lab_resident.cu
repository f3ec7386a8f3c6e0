// Host launcher of the K1 kernel lab (device code and the design notes in
// lab_resident.cuh, the tile routine, and lab_resident_ring.cuh, the ring
// routine of v17 and v19), with a plain C interface for ctypes.  Built by
// tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -ldl -o <lib>.so lab_resident.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_resident_ring.cuh"

namespace {

template <int P, int XP>
cudaError_t launch(int variant, int mode, const tpufem::LabGeo& g, int grid,
                   const void* u, void* y, const void* tables, const void* xk,
                   const void* xk_lo, const void* win, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  const C* uc = static_cast<const C*>(u);
  C* yc = static_cast<C*>(y);
  const C* tc = static_cast<const C*>(tables);
  if (variant == 19) {
    const int smem =
        (int)tpufem::lab_smem(P, XP, 2, g.tz, g.ty, g.X).total;
    auto kern = tpufem::lab_pipe_kernel<P, XP>;
    static std::atomic<int> granted[tpufem::kLabMaxDevices];
    cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
    if (e != cudaSuccess) return e;
    kern<<<grid, tpufem::kLabThreads, smem, stream>>>(uc, yc, tc, xk, xk_lo,
                                                      g, mode);
    return cudaGetLastError();
  }
  const int smem = (int)tpufem::lab_smem(P, XP, 1, g.tz, g.ty, g.X).total;
  auto kern = tpufem::lab_tile_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.nty, g.ntz), tpufem::kLabThreads, smem, stream>>>(
      uc, yc, tc, xk, xk_lo, variant == 20 ? static_cast<const int*>(win)
                                           : nullptr,
      g, variant == 18, mode);
  return cudaGetLastError();
}

template <int XP>
cudaError_t dispatch_p(int p, int variant, int mode, const tpufem::LabGeo& g,
                       int grid, const void* u, void* y, const void* tables,
                       const void* xk, const void* xk_lo, const void* win,
                       cudaStream_t stream) {
#define TPUFEM_CASE(PP)                                                   \
  case PP:                                                                \
    return launch<PP, XP>(variant, mode, g, grid, u, y, tables, xk, xk_lo, \
                          win, stream);
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

// The ring routine (v17: lab_ring_kernel, v19: lab_ring_pipe_kernel): its
// shared-memory opt-in, then the occupancy query (blocks_per_sm not null) or
// the tensor map of the input layout and the launch.
struct RingLaunch {
  int grid;
  const void* u;
  void* y;
  const void* tables;
  const void* xb;
  unsigned long long* tickets;
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <int P, int XP>
cudaError_t launch_ring(int variant, int mode, const tpufem::LrGeo& q,
                        const RingLaunch& a) {
  using C = typename tpufem::LabMma<XP>::C;
  const tpufem::LabGeo& g = q.g;
  const int smem = (int)tpufem::lr_smem(P, XP, g.tz, g.ty, q.nu, q.nb, q.nq,
                                        q.ncols)
                       .total;
  const bool pipe = variant == 19;
  const int threads = pipe ? tpufem::kLrPipeThreads : tpufem::kLrThreads;
  auto v17 = tpufem::lab_ring_kernel<P, XP>;
  auto v19 = tpufem::lab_ring_pipe_kernel<P, XP>;
  static std::atomic<int> granted[2][tpufem::kLabMaxDevices];
  cudaError_t e = pipe ? tpufem::lab_opt_in(v19, smem, granted[1])
                       : tpufem::lab_opt_in(v17, smem, granted[0]);
  if (e != cudaSuccess) return e;
  if (a.blocks_per_sm)
    return pipe ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      a.blocks_per_sm, v19, threads, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      a.blocks_per_sm, v17, threads, smem);
  tpufem::HopMap in_map;
  const long long dim[3] = {g.X, g.sy, g.sz};
  const int box[3] = {tpufem::lr_xc(XP), g.ty + 2 * P, g.tz + 2 * P};
  if (tpufem::hop_map_3d(&in_map, const_cast<void*>(a.u), sizeof(C), dim,
                         box))
    return cudaErrorInvalidValue;
  if (pipe) {
    // the counter starts at 0 on the launch's stream, whatever ran before
    e = cudaMemsetAsync(a.tickets, 0, sizeof(*a.tickets), a.stream);
    if (e != cudaSuccess) return e;
    v19<<<a.grid, threads, smem, a.stream>>>(
        in_map, static_cast<C*>(a.y), static_cast<const C*>(a.tables),
        static_cast<const unsigned char*>(a.xb), q, mode, a.tickets);
  } else {
    v17<<<dim3(g.nty, g.ntz, q.nsplit), threads, smem, a.stream>>>(
        in_map, static_cast<C*>(a.y), static_cast<const C*>(a.tables),
        static_cast<const unsigned char*>(a.xb), q, mode);
  }
  return cudaGetLastError();
}

template <int XP>
cudaError_t ring_by_p(int p, int variant, int mode, const tpufem::LrGeo& q,
                      const RingLaunch& a) {
#define TPUFEM_CASE(PP) \
  case PP:              \
    return launch_ring<PP, XP>(variant, mode, q, a);
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

cudaError_t ring_dispatch(int xp, int p, int variant, int mode,
                          const tpufem::LrGeo& q, const RingLaunch& a) {
  switch (xp) {
    case tpufem::kX3TF32:
      return ring_by_p<tpufem::kX3TF32>(p, variant, mode, q, a);
    case tpufem::kX1TF32:
      return ring_by_p<tpufem::kX1TF32>(p, variant, mode, q, a);
    case tpufem::kXBF16x3:
      return ring_by_p<tpufem::kXBF16x3>(p, variant, mode, q, a);
    case tpufem::kXF64:
      return ring_by_p<tpufem::kXF64>(p, variant, mode, q, a);
  }
  return cudaErrorInvalidValue;
}

// The ring routine takes: v17 or v19, a sub-tile of 64 rows whose halo'd box
// is a TMA box, rings of 1..3 u slots, 1..2 B stages and qq stages (v17: 1),
// column splits of a multiple of 32 columns within the block's registers
// that cover X (copy and bands, which have no x stage: one split), X a
// multiple of the chunk.
bool ring_args_ok(int variant, int xp, int p, int mode, int X, int tz, int ty,
                  int nu, int nb, int nq, int ncols, int nsplit) {
  if ((variant != 17 && variant != 19) || xp < tpufem::kX3TF32 ||
      xp > tpufem::kXF64 || p < 1 || p > 8)
    return false;
  if (tz < 1 || ty < 1 || tz * ty != tpufem::kLrM || tz + 2 * p > 256 ||
      ty + 2 * p > 256)
    return false;
  if (nu < 1 || nu > tpufem::kLrMaxU || nb < 1 || nb > tpufem::kLrMaxB ||
      nq < 1 || nq > tpufem::kLrMaxQ || (variant == 17 && nq != 1))
    return false;
  const bool xstage = mode == tpufem::kFull || mode == tpufem::kMM;
  return ncols > 0 && ncols % tpufem::kHopN == 0 &&
         ncols <= tpufem::lr_max_cols(xp) &&
         (xstage ? nsplit >= 1 && (long long)ncols * nsplit >= X
                 : nsplit == 1) &&
         X > 0 && X % tpufem::lr_xc(xp) == 0;
}

}  // namespace

extern "C" {

// y = A u on the resident layout (sz, sy, X) by the ring routine of v17 or
// v19 (lab_resident_ring.cuh) with x-stage precision xp in mode; sub-tile
// (tz, ty) of 64 rows; rings nu, nb, nq; ncols columns a block in nsplit
// splits; grid: v19's persistent blocks (v17 ignores it).  tables: (4, npts,
// 2p+2) [Ky, My, Kz, Mz]; xb: the B stages as the host lays them out
// (resident_lab.ring_operand).  v19: tickets, 8 bytes of device memory for
// the counter its blocks take units from, set to 0 on the stream before the
// launch (v17 ignores it).  Returns the cudaError_t of the launch.
int tpufem_lab_ring_apply(int variant, int xp, int p, int mode, int npts,
                          int sz, int sy, int X, int tz, int ty, int nu,
                          int nb, int nq, int ncols, int nsplit, int grid,
                          const void* u, void* y, const void* tables,
                          const void* xb, void* tickets, void* stream) {
  if (!ring_args_ok(variant, xp, p, mode, X, tz, ty, nu, nb, nq, ncols,
                    nsplit) ||
      grid < 1 || (variant == 19 && !tickets))
    return (int)cudaErrorInvalidValue;
  const tpufem::LrGeo q{{npts, sz, sy, X, tz, ty, (npts + tz - 1) / tz,
                         (npts + ty - 1) / ty},
                        nu, nb, nq, ncols, nsplit};
  const RingLaunch a{grid, u, y, tables, xb,
                     static_cast<unsigned long long*>(tickets),
                     static_cast<cudaStream_t>(stream), nullptr};
  return (int)ring_dispatch(xp, p, variant, mode, q, a);
}

// Blocks of a ring launch an SM holds at once (v19's grid is that times the
// SMs); -1 where refused.
int tpufem_lab_ring_blocks_per_sm(int variant, int xp, int p, int tz, int ty,
                                  int nu, int nb, int nq, int ncols) {
  if (!ring_args_ok(variant, xp, p, tpufem::kFull, ncols, tz, ty, nu, nb,
                    nq, ncols, 1))
    return -1;
  int n = -1;
  const tpufem::LrGeo q{{0, 0, 0, 0, tz, ty, 0, 0}, nu, nb, nq, ncols, 1};
  const RingLaunch a{1,       nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, &n};
  if (ring_dispatch(xp, p, variant, 0, q, a) != cudaSuccess) return -1;
  return n;
}

// Shared-memory bytes of one block of the ring routine; the chooser in
// tpufem_torch/lab/resident_lab.py sizes its rings with it.
long long tpufem_lab_ring_smem_bytes(int p, int xp, int tz, int ty, int nu,
                                     int nb, int nq, int ncols) {
  return tpufem::lr_smem(p, xp, tz, ty, nu, nb, nq, ncols).total;
}

// y = A u on the resident layout (sz, sy, X) by lab kernel `variant` (17,
// 18, 19 or 20) with x-stage precision xp (LabXPrec) in mode (LabMode).
// Tile (tz, ty); grid: the persistent blocks of v19 (others ignore it).
// tables: (4, npts, 2p+2) band tables [Ky, My, Kz, Mz]; xk: (2X, X)
// [Kx^T; Mx^T] (bf16x3: its hi part, xk_lo its lo part); win: (X/N, 2)
// int32 row windows of v20.  Returns the cudaError_t of the launch.
int tpufem_lab_apply(int variant, int xp, int p, int mode, int npts, int sz,
                     int sy, int X, int tz, int ty, int grid, const void* u,
                     void* y, const void* tables, const void* xk,
                     const void* xk_lo, const void* win, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant < 17 || variant > 20 || tz < 1 || ty < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const tpufem::LabGeo g{npts, sz, sy, X, tz, ty, (npts + tz - 1) / tz,
                         (npts + ty - 1) / ty};
  switch (xp) {
    case tpufem::kX3TF32:
      return (int)dispatch_p<tpufem::kX3TF32>(p, variant, mode, g, grid, u, y,
                                              tables, xk, xk_lo, win, s);
    case tpufem::kX1TF32:
      return (int)dispatch_p<tpufem::kX1TF32>(p, variant, mode, g, grid, u, y,
                                              tables, xk, xk_lo, win, s);
    case tpufem::kXBF16x3:
      return (int)dispatch_p<tpufem::kXBF16x3>(p, variant, mode, g, grid, u,
                                               y, tables, xk, xk_lo, win, s);
    case tpufem::kXF64:
      return (int)dispatch_p<tpufem::kXF64>(p, variant, mode, g, grid, u, y,
                                            tables, xk, xk_lo, win, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block (nbuf qq buffers: 2 for v19); the tile
// chooser in tpufem_torch/lab/resident_lab.py sizes its blocks with it.
long long tpufem_lab_smem_bytes(int p, int xp, int nbuf, int tz, int ty,
                                int X) {
  return tpufem::lab_smem(p, xp, nbuf, tz, ty, X).total;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
