// Host launcher of the K2 kernel lab's z/y-first half (device code and the
// design note in lab_zyfirst.cuh), with a plain C interface for ctypes.
// Built by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o <lib>.so lab_zyfirst.cu
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lab_resident_ring.cuh"
#include "lab_zyfirst.cuh"

namespace {

// v13-v15
template <int P, int XP>
cudaError_t launch(int two, int nu, const tpufem::LabGeo& g, const void* u,
                   void* y, const void* tables, const void* xk,
                   const void* xk_lo, cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
  const int smem = (int)tpufem::zy_smem(P, XP, nu, g.tz, g.ty, g.X).total;
  auto kern = tpufem::zy_kernel<P, XP>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.nty, g.ntz), tpufem::kLabThreads, smem, stream>>>(
      static_cast<const C*>(u), static_cast<C*>(y),
      static_cast<const C*>(tables), xk, xk_lo, g, two, nu);
  return cudaGetLastError();
}

// vcopy, vband, v16: the tensor maps of the two layouts, then the launch
template <int P, typename C>
cudaError_t launch_ring(int mode, const tpufem::LabGeo& g, const void* u,
                        void* y, const void* tables, cudaStream_t stream) {
  const int xc = tpufem::ring_xc(sizeof(C)), NT = g.sz - 2 * P;
  const tpufem::RingPieces pc = tpufem::ring_pieces(g.tz, g.ty);
  tpufem::HopMap in_map, out_map;
  const long long in_dim[3] = {g.X, g.sy, g.sz}, out_dim[3] = {g.X, NT, NT};
  const int in_box[3] = {xc, g.ty + 2 * P, g.tz + 2 * P};
  const int out_box[3] = {xc, pc.by, pc.bz};
  if (tpufem::hop_map_3d(&in_map, const_cast<void*>(u), sizeof(C), in_dim,
                         in_box) ||
      tpufem::hop_map_3d(&out_map, y, sizeof(C), out_dim, out_box))
    return cudaErrorInvalidValue;
  const int smem = (int)tpufem::zy_ring_smem(P, sizeof(C), g.tz, g.ty).total;
  auto kern = tpufem::zy_ring_kernel<P, C>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.nty, g.ntz), tpufem::kRingThreads, smem, stream>>>(
      in_map, out_map, static_cast<const C*>(tables), g, mode);
  return cudaGetLastError();
}

template <int XP>
cudaError_t dispatch_p(int p, int mode, int two, int nu,
                       const tpufem::LabGeo& g, const void* u, void* y,
                       const void* tables, const void* xk, const void* xk_lo,
                       cudaStream_t stream) {
  using C = typename tpufem::LabMma<XP>::C;
#define TPUFEM_CASE(PP)                                                      \
  case PP:                                                                   \
    if constexpr (XP == tpufem::kX3TF32 || XP == tpufem::kXF64)              \
      if (mode != tpufem::kFull)                                             \
        return launch_ring<PP, C>(mode, g, u, y, tables, stream);            \
    return launch<PP, XP>(two, nu, g, u, y, tables, xk, xk_lo, stream);
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

// v15 on L1's ring routines (lab_resident_ring.cuh): pipe, the persistent
// lab_ring_pipe_kernel (v19's), or lab_ring_kernel (v17's)
template <int XP>
cudaError_t lr_by_p(int p, int pipe, const tpufem::LrGeo& q,
                    const tpufem::LrLaunch& a) {
#define TPUFEM_CASE(PP)                                                    \
  case PP:                                                                 \
    return pipe ? tpufem::lr_launch<PP, XP, 19>(tpufem::kFull, q, a)       \
                : tpufem::lr_launch<PP, XP, 17>(tpufem::kFull, q, a);
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

cudaError_t lr_dispatch(int xp, int p, int pipe, const tpufem::LrGeo& q,
                        const tpufem::LrLaunch& a) {
  switch (xp) {
#define TPUFEM_XP(XP) \
  case XP:            \
    return lr_by_p<XP>(p, pipe, q, a);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXF64)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return cudaErrorInvalidValue;
}

// What v15's ring takes: a sub-tile of 64 rows whose halo'd box is a TMA box,
// rings of 1..3 u slots, 1..2 B stages, 1..2 qq stages (lab_ring_kernel: 1),
// column splits of a multiple of 32 columns within the block's registers
// that cover X, X a multiple of the chunk.
bool lr_args_ok(int pipe, int xp, int p, int X, int tz, int ty, int nu, int nb,
                int nq, int ncols, int nsplit) {
  return xp >= tpufem::kX3TF32 && xp <= tpufem::kXBF16 && p >= 1 && p <= 8 &&
         tz >= 1 && ty >= 1 && tz * ty == tpufem::kLrM &&
         tz + 2 * p <= 256 && ty + 2 * p <= 256 && nu >= 1 &&
         nu <= tpufem::kLrMaxU && nb >= 1 && nb <= tpufem::kLrMaxB &&
         nq >= 1 && nq <= (pipe ? tpufem::kLrMaxQ : 1) && ncols > 0 &&
         ncols % tpufem::kHopN == 0 && ncols <= tpufem::lr_max_cols(xp) &&
         nsplit >= 1 && (long long)ncols * nsplit >= X && X > 0 &&
         X % tpufem::lr_xc(xp) == 0;
}

}  // namespace

extern "C" {

// out = the variant's function of u, layout in (size, size, X), out (NT, NT,
// X) with NT = size - 2p, sub-tile (tz, ty).  mode kFull (v13-v15, zy_kernel):
// two (the x stage as two products), nu (1 or 2 u slots: 2 keeps the next
// chunk's load in flight), x-stage precision xp (LabXPrec); xk: (2X, X)
// [Kx^T; Mx^T] (bf16: its hi part, xk_lo its lo part).  mode kCopy, kBands
// or kZyXBand (vcopy, vband, v16, zy_ring_kernel): xp kX3TF32 (f32 storage)
// or kXF64; two, nu, xk and xk_lo are not read.  tables: (6, npts, 2p+2) band
// tables [Ky, My, Kz, Mz, Kx, Mx].  Returns the cudaError_t of the launch (a
// tensor map that cannot be encoded: cudaErrorInvalidValue).
int tpufem_zy_apply(int mode, int two, int nu, int xp, int p, int npts,
                    int size, int X, int tz, int ty, const void* u, void* y,
                    const void* tables, const void* xk, const void* xk_lo,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NT = size - 2 * p;
  const bool ring = mode == tpufem::kCopy || mode == tpufem::kBands ||
                    mode == tpufem::kZyXBand;
  if ((!ring && mode != tpufem::kFull) || tz < 1 || ty < 1 || NT < npts ||
      X % 16 || X < npts || reinterpret_cast<uintptr_t>(u) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  if (ring ? (xp != tpufem::kX3TF32 && xp != tpufem::kXF64) ||
                 !tpufem::zy_ring_takes(p, tz, ty)
           : nu < 1 || nu > 2 ||
                 (tz * ty) % (xp == tpufem::kXF64 ? 8 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  const tpufem::LabGeo g{npts, size, size, X, tz, ty, (NT + tz - 1) / tz,
                         (NT + ty - 1) / ty};
  switch (xp) {
#define TPUFEM_XP(XP) \
  case XP:            \
    return (int)dispatch_p<XP>(p, mode, two, nu, g, u, y, tables, xk, xk_lo, s);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXF64)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return (int)cudaErrorInvalidValue;
}

// v15: out = [q1 | q23] @ [Kx^T; Mx^T] from the input layout (size, size,
// X) into the output layout (NT, NT, X), NT = size - 2p, every point written
// (rows and columns past npts as zeros), on L1's ring routine: pipe (the
// persistent lab_ring_pipe_kernel, `grid` blocks; tickets: 8 bytes of device
// memory the launcher sets to 0 on the stream) or lab_ring_kernel (one block
// per sub-tile and split).  Sub-tile (tz, ty) of 64 rows over the (NT, NT)
// output rows; rings nu, nb, nq; ncols columns a block in nsplit splits; xp
// as tpufem_zy_apply's (one bf16 product too).  tables: (6, npts, 2p+2)
// [Ky, My, Kz, Mz, Kx, Mx] (the first four read); xb: the B stages as
// resident_lab.ring_operand lays them out.  Returns the cudaError_t.
int tpufem_zy_lr_apply(int pipe, int xp, int p, int npts, int size, int X,
                       int tz, int ty, int nu, int nb, int nq, int ncols,
                       int nsplit, int grid, const void* u, void* y,
                       const void* tables, const void* xb, void* tickets,
                       void* stream) {
  const int NT = size - 2 * p;
  if (!lr_args_ok(pipe, xp, p, X, tz, ty, nu, nb, nq, ncols, nsplit) ||
      grid < 1 || NT < npts || X < npts || (pipe && !tickets))
    return (int)cudaErrorInvalidValue;
  const tpufem::LabGeo g{npts, size, size, X, tz, ty, (NT + tz - 1) / tz,
                         (NT + ty - 1) / ty};
  const tpufem::LrGeo q{g, nu, nb, nq, ncols, nsplit, {0, NT, NT}};
  const tpufem::LrLaunch a{grid, u, y, tables, xb,
                           static_cast<unsigned long long*>(tickets),
                           static_cast<cudaStream_t>(stream), nullptr};
  return (int)lr_dispatch(xp, p, pipe, q, a);
}

// Blocks of v15's ring launch an SM holds at once (the persistent grid is
// that times the SMs); -1 where refused.
int tpufem_zy_lr_blocks_per_sm(int pipe, int xp, int p, int tz, int ty,
                               int nu, int nb, int nq, int ncols) {
  if (!lr_args_ok(pipe, xp, p, ncols, tz, ty, nu, nb, nq, ncols, 1)) return -1;
  int n = -1;
  const tpufem::LrGeo q{{0, 0, 0, 0, tz, ty, 0, 0}, nu, nb, nq, ncols, 1,
                        {0, 0, 0}};
  const tpufem::LrLaunch a{1,       nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, &n};
  if (lr_dispatch(xp, p, pipe, q, a) != cudaSuccess) return -1;
  return n;
}

// Shared-memory bytes of one block of v15's ring (lr_smem); the chooser in
// tpufem_torch/lab/separable_lab.py sizes its rings with it.
long long tpufem_zy_lr_smem_bytes(int p, int xp, int tz, int ty, int nu,
                                  int nb, int nq, int ncols) {
  return tpufem::lr_smem(p, xp, tz, ty, nu, nb, nq, ncols).total;
}

// Shared-memory bytes of one block (mode kFull: with nu u slots, over X
// columns; the other modes: the ring's, whatever nu and X); the tile chooser
// in tpufem_torch/lab/separable_lab.py sizes its sub-tiles with it.
long long tpufem_zy_smem_bytes(int mode, int p, int xp, int nu, int tz, int ty,
                               int X) {
  return tpufem::zy_smem_bytes(mode, p, xp, nu, tz, ty, X);
}

// 1 where the all-band routine (vcopy, vband, v16) takes the sub-tile.
int tpufem_zy_ring_takes(int p, int tz, int ty) {
  return tpufem::zy_ring_takes(p, tz, ty) ? 1 : 0;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
