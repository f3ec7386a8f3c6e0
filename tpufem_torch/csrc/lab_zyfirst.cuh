// The K2 kernel lab's z/y-first half (L2b) on Hopper: one routine for the
// schedules that run band z, then band y on the halo'd tile and the x axis
// last.  Device code; the host launcher with its plain C interface is
// lab_zyfirst.cu.
//
// Replaces the Pallas lab kernels of scripts/kernel_lab.py (LabKernel,
// call at :1592):
//   v13    _kernel_v13 (:302)    band z, band y, then two x products
//                                q1 @ Kx^T + q23 @ Mx^T; one load, then compute
//   v14    _kernel_v14 (:359)    v13 with the next load in flight during
//                                compute (two scratch slots, two semaphores)
//   v15    _kernel_v15 (:431)    v14 with the two products K-stacked into one,
//                                [q1 | q23] @ [Kx^T; Mx^T]
//   vcopy  _kernel_vcopy (:500)  v15's loads and stores alone: out = the
//                                tile's centre
//   vband  _kernel_vband (:525)  v15's band stages alone: out = q1 + q23
//   v16    _kernel_v16 (:1347)   all three axes as bands, no matrix unit
// with s = Bz(u; Mz), t = Bz(u; Kz), q1 = By(s; My), q23 = By(s; Ky) +
// By(t; My), so v13-v16 compute K2's operator A = Kz(x)My(x)Mx +
// Mz(x)Ky(x)Mx + Mz(x)My(x)Kx.
//
// Layouts are the lab's (lab_separable.cuh): in (size, size, X), size = nt b
// + 2P, data at [P:P+npts, P:P+npts, 0:npts], zeros elsewhere, X = npts
// rounded up to 16; out (nt b, nt b, X), data at [0:npts, 0:npts, 0:npts],
// every point written.  b sets the layouts only: the TPU kernel held a
// tile's whole halo'd slab (b+2P)^2 X in VMEM and its (b, b, 2X) qq (1.25 MB
// at b = 24, X = 272); a block has 227 KB, so a block owns a (TZ, TY)
// sub-tile of the (nt b)^2 output rows over all of x, masked at a ragged
// edge, and streams x in chunks.  That is L1's schedule (lab_resident.cuh,
// whose device functions this routine calls) on L2's layouts:
//   z, y   lab_bands: per chunk of XC x columns, the halo'd u chunk (TZ+2P,
//          TY+2P, XC) into shared memory, band z, band y in K2's difference
//          form from the exact per-row tables, into qq = [q1 | q23] (M, 2X),
//          M = TZ TY, in shared memory.  The exact tables take the place of
//          the TPU kernels' periodic tables and deficit corrections, so any
//          b is taken.
//   load   v13: each chunk is loaded, then computed (one u slot, plain
//          loads).  v14 on: two u slots; chunk c + 1 travels by cp.async (16
//          bytes a copy, no registers) while chunk c is in its bands, and a
//          wait_group with the block's barrier stands for the TPU's DMA
//          semaphore.  The prefetch is across the chunks of one block's
//          tile, not across tiles: blocks are not persistent, and the SM's
//          other resident blocks cover a block's first load.
//   x      v13, v14: lab_xstage with `two`, a k step of q1 @ Kx^T then one of
//          q23 @ Mx^T into the same accumulator fragments; v15: one product
//          over K = 2X.  WMMA from shared memory, B from device memory
//          (L2-resident), any of lab_mma.cuh's five arithmetics.  v16
//          (zy_xband): band x on CUDA cores from the exact tables of Kx and
//          Mx in difference form, qq read from shared memory; no
//          tensor-core instruction.
//   store  vcopy, vband: qq's first half (lab_store_rows); else per warp
//          from the accumulators.  Rows of the output layout beyond the
//          data come out as zeros (their table rows are zero).
// The stage kinds are run-time arguments (mode, two, nu), so the library has
// one kernel per (P, arithmetic).
//
// What bounds it on an H100: v13-v16 compute K2's function, each DoF read
// and written once, 0.0405 ms at 16,974,593 DoFs in f32 (bytes); vcopy the
// same bytes; vband's function needs 4 band outputs a DoF and is bytes-bound
// too.  The design adds: the layouts' bytes (0.0468 ms), a (TZ+2P)(TY+2P) /
// (TZ TY) halo re-read from L2 (7.5x at (2, 8), P = 4), 5 band stages, and
// the x product over (nt b)^2 rows, 2 * 69,696 * 2X * X = 20.6 GFLOP a pass
// at the flagship: 0.125 ms in 3xTF32.  L1's sweeps found occupancy to
// decide before halo traffic, so the tile chooser starts from (2, 8): 91 KB
// a block with both u slots at P = 4, two blocks an SM.
#pragma once

#include "lab_resident.cuh"

namespace tpufem {

// one more mode beside LabMode's: x by bands (v16)
constexpr int kZyXBand = 4;

// x columns per band-stage chunk: half L1's in f64, so that two u slots of
// the P = 8 halo fit a block
__host__ __device__ constexpr int zy_xc(int xp) {
  return xp == kXF64 ? kXC / 2 : kXC;
}

__host__ __device__ inline LabSmem zy_smem(int p, int xp, int nu, int tz,
                                           int ty, int X) {
  return lab_smem(p, xp, 1, tz, ty, X, nu, zy_xc(xp));
}

// Row m of the sub-tile at (z0, y0) in the output layout (NT, NT, X); -1
// beyond a ragged edge.
struct ZyRows {
  int z0, y0, ty, NT, X;
  __device__ __forceinline__ long long operator()(int m) const {
    const int gz = z0 + m / ty, gy = y0 + m % ty;
    if (gz >= NT || gy >= NT) return -1;
    return ((long long)gz * NT + gy) * X;
  }
};

// v16's x stage: out[row, x] = Bx(q1; Kx)[x] + Bx(q23; Mx)[x] from qq (M,
// 2X) in shared memory, K2's difference form; tkx, tmx: (npts, 2P+2) band
// tables (columns beyond npts come out as zeros).
template <int P, typename C>
__device__ void zy_xband(const C* __restrict__ qq, const C* __restrict__ tkx,
                         const C* __restrict__ tmx, const LabGeo& g,
                         const ZyRows& rows, C* __restrict__ out, int tid,
                         int nthr) {
  constexpr int NW = 2 * P + 2;
  const int X = g.X, M = g.tz * g.ty;
  for (long long i = tid; i < (long long)M * X; i += nthr) {
    const int m = (int)(i / X), x = (int)(i % X);
    const long long o = rows(m);
    if (o < 0) continue;
    C y = C(0);
    if (x < g.npts) {
      const C* row = qq + (long long)m * 2 * X;
      C v1[2 * P + 1], v23[2 * P + 1];
#pragma unroll
      for (int k = 0; k <= 2 * P; ++k) {
        const int xi = x + k - P;
        const bool in = xi >= 0 && xi < X;
        v1[k] = in ? row[xi] : C(0);
        v23[k] = in ? row[X + xi] : C(0);
      }
      y = band<P>(tkx + (long long)x * NW, v1, 1) +
          band<P>(tmx + (long long)x * NW, v23, 1);
    }
    out[o + x] = y;
  }
}

// One block per (TZ, TY) sub-tile of the output rows, grid (nty, ntz); g.sz
// = g.sy = size, the input layout's.  tables: (6, npts, 2P+2) [Ky, My, Kz,
// Mz, Kx, Mx]; xk: (2X, X) [Kx^T; Mx^T] (bf16: its hi part, xk_lo its lo
// part).  mode: LabMode or kZyXBand; two: v13's x stage; nu: u slots.
template <int P, int XP>
__global__ void __launch_bounds__(kLabThreads)
zy_kernel(const typename LabMma<XP>::C* __restrict__ u,
          typename LabMma<XP>::C* __restrict__ out,
          const typename LabMma<XP>::C* __restrict__ tables, const void* xk,
          const void* xk_lo, LabGeo g, int mode, int two, int nu) {
  using C = typename LabMma<XP>::C;
  constexpr int NW = 2 * P + 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const LabSmem pl = zy_smem(P, XP, nu, g.tz, g.ty, g.X);
  const int z0 = blockIdx.y * g.tz, y0 = blockIdx.x * g.ty;
  unsigned char* qq = smem_raw + pl.qq;
  lab_bands<P, XP, zy_xc(XP)>(u, tables, g, z0, y0, 0,
                              mode == kZyXBand ? (int)kFull : mode, smem_raw,
                              pl, qq, tid, nthr, 0, nu);
  const ZyRows rows{z0, y0, g.ty, g.sz - 2 * P, g.X};
  if (mode == kCopy || mode == kBands) {
    lab_store_rows<XP>(qq, g, rows, out, tid, nthr);
  } else if (mode == kZyXBand) {
    if constexpr (!LabMma<XP>::kBF16)
      zy_xband<P, C>(reinterpret_cast<const C*>(qq),
                     tables + 4LL * g.npts * NW, tables + 5LL * g.npts * NW, g,
                     rows, out, tid, nthr);
  } else {
    lab_xstage<XP>(qq, xk, xk_lo, nullptr, two != 0, g, rows,
                   reinterpret_cast<C*>(smem_raw + pl.scr), out, tid / 32,
                   (nthr + 31) / 32, tid % 32, nthr < 32 ? nthr : 32);
  }
}

}  // namespace tpufem
