// The K2 kernel lab's z/y-first half (L2b) on Hopper: two routines for the
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
//   vcopy  _kernel_vcopy (:500)  the schedule's loads and stores alone: out =
//                                the tile's centre
//   vband  _kernel_vband (:525)  its band stages alone: out = q1 + q23
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
// sub-tile of the (nt b)^2 output rows over all of x, ragged at the layout's
// edge, and streams x in chunks.  The exact per-row band tables in K2's
// difference form (common.cuh) take the place of the TPU kernels' periodic
// tables and deficit corrections, so any b is taken.
//
// The routines of v13-v15: v14 runs zy_kernel (below); v15 and v13 run L1's
// ring routines of lab_resident_ring.cuh, built into this library by
// lab_zyfirst.cu: lab_ring_pipe_kernel (v19's schedule: a producer warp,
// seven band warps, two x-stage warpgroups, persistent blocks on a ticket
// counter; v15's default in f32 storage) or lab_ring_kernel (v17's; v15's
// default in f64, where the persistent x stage's DMMA tiles spill at its
// 160 registers: 4.62 ms against 3.39, and v13's in every storage: its
// Pallas schedule loads a tile, then computes it, with no load of the next
// in flight).  v13's two products, a k step of q1 @ Kx^T then one of q23 @
// Mx^T into one accumulator, are on the ring a chunk's Kx^T rows then its
// Mx^T rows of each B stage, multiplied into the one accumulator chunk by
// chunk: v15's product taken in turns at a chunk's granularity, so v13 and
// v15 on lab_ring_kernel are one instruction stream, bit for bit (the g++
// build holds it).  Their function is L1's on other layouts: the input layout's data row g sits at row g + P as in
// L1's, so the TMA boxes are L1's; the sub-tiles of 64 rows cover the
// (nt b)^2 output rows, and the store's row map (LabOut) is {org 0, stride
// nt b, rows nt b}: rows past npts come out of the bands as exact zeros
// (their table rows are zero), columns past npts out of the x product (B's
// columns are zero there).  zy_kernel stays as v13's and v15's earlier
// schedule (routine "tile").  On
// an H100 80GB HBM3 at 700 W at the flagship in 3xTF32, in turns by
// chip_smoke.py phase 6: zy_kernel 2.19 ms, lab_ring_pipe_kernel 0.62,
// lab_ring_kernel 0.69; the design bound 0.132 ms (65.5 GFLOP of 3xTF32
// products over the 288 padded columns) and B streamed from L2 into every
// sub-tile (1.67 GB an apply with the u boxes) hold it at ~5x.
//
// zy_kernel (v14, and v13's and v15's earlier schedule): the tensor-core x
// product needs qq = [q1 | q23] (M, 2X), M = TZ TY, over all of x in shared
// memory, which keeps the sub-tile small ((2, 8): a 10x halo re-read at P =
// 4).  It is
// L1's tile routine (lab_resident.cuh, whose device functions it calls) on
// L2's layouts:
//   z, y   lab_bands: per chunk of XC x columns, the halo'd u chunk (TZ+2P,
//          TY+2P, XC) into shared memory, band z, band y into qq.
//   load   v13: each chunk is loaded, then computed (one u slot, plain
//          loads).  v14 on: two u slots; chunk c + 1 travels by cp.async (16
//          bytes a copy, no registers) while chunk c is in its bands, and a
//          wait_group with the block's barrier stands for the TPU's DMA
//          semaphore.
//   x      v13, v14: lab_xstage with `two`, a k step of q1 @ Kx^T then one of
//          q23 @ Mx^T into the same accumulator fragments; v15: one product
//          over K = 2X.  WMMA from shared memory, B from device memory
//          (L2-resident), any of lab_mma.cuh's five arithmetics; every warp
//          re-reads and re-splits its B fragment at every k step, which
//          with the 10x halo and the plain loads held v15 at 2.19 ms.
//
// zy_ring_kernel (vcopy, vband, v16: no tensor-core stage): the all-band
// schedule's tile mover, one routine with a mode argument.  What bounded the
// first version (vcopy 0.328 ms against 0.064 ms of one strided copy): a 10x
// halo re-read through L2, because qq over all of x (M 2X values) left room
// for a (2, 8) sub-tile only; an index computation, three bounds tests and a
// 16-byte copy or zero store per thread and vector, then the centre moved
// twice more by plain loads and stores; two block barriers a chunk with one
// chunk in flight.  What this design does about each:
//   window  x by bands (v16) reads only x +- P, so q1 and q23 are kept for a
//          window of kZyWin columns, carried from chunk to chunk in a
//          circular buffer (recomputing them on XC + 2P columns would load
//          and band 1.5x the columns at P = 4): once chunk c has its q1 and
//          q23, the x band writes the columns of chunk c - 1, which need P
//          columns of either neighbour (one more step after the last chunk
//          writes the last one), so every stored box starts on a chunk.
//          Shared memory no longer grows with X, and the sub-tile grows to
//          (8, 8): a (TZ+2P)(TY+2P)/(TZ TY) = 4x re-read at P = 4, two
//          blocks an SM.
//   TMA    one thread of a producer warp asks for each halo'd box (TZ+2P,
//          TY+2P, XC) of the input layout; what lies beyond the layout
//          arrives as zeros.  Each consumer warp owns a (TZ/nwz, TY/nwy)
//          piece of the sub-tile's rows and stores its piece of every chunk
//          as one box of the output layout, clipped at a ragged edge.  No
//          thread computes an address of device memory or tests a bound.
//   ring   kRingStages u slots, a `full` mbarrier each (armed with the box's
//          bytes) and an `empty` one (a warp arrives once it has read the
//          slot); two output slots a warp, reused once the store of two
//          chunks ago has been read (bulk wait_group).  Copy mode has no
//          block-wide barrier at all; the band modes keep two a chunk around
//          s and t, which the y stage reads across warps.
// vcopy is that schedule with no arithmetic: out = the box's centre.
//
// What bounds it on an H100: v13-v16 compute K2's function, each DoF read
// and written once, 0.0405 ms at 16,974,593 DoFs in f32 (bytes); vcopy the
// same bytes; vband's function needs 4 band outputs a DoF and is bytes-bound
// too.  The design adds: the layouts' bytes (0.0468 ms), the halo re-read
// from L2 (4x at (8, 8): 0.32 GB an apply; 10x at (2, 8): 0.80 GB), 5 band
// stages (v16: 7), and for v13-v15 the x product over (nt b)^2 rows, 2 *
// 69,696 * 2X * X = 20.6 GFLOP a pass at the flagship: 0.125 ms in 3xTF32
// (v15 on the ring: 288 padded columns, 21.8 GFLOP a pass, 0.132 ms).
#pragma once

#include "band_ring.cuh"
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

// v13-v15: one block per (TZ, TY) sub-tile of the output rows, grid (nty,
// ntz); g.sz = g.sy = size, the input layout's.  tables: (6, npts, 2P+2) [Ky,
// My, Kz, Mz, Kx, Mx]; xk: (2X, X) [Kx^T; Mx^T] (bf16: its hi part, xk_lo its
// lo part).  two: v13's x stage; nu: u slots.
template <int P, int XP>
__global__ void __launch_bounds__(kLabThreads)
zy_kernel(const typename LabMma<XP>::C* __restrict__ u,
          typename LabMma<XP>::C* __restrict__ out,
          const typename LabMma<XP>::C* __restrict__ tables, const void* xk,
          const void* xk_lo, LabGeo g, int two, int nu) {
  using C = typename LabMma<XP>::C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const LabSmem pl = zy_smem(P, XP, nu, g.tz, g.ty, g.X);
  const int z0 = blockIdx.y * g.tz, y0 = blockIdx.x * g.ty;
  unsigned char* qq = smem_raw + pl.qq;
  lab_bands<P, XP, zy_xc(XP)>(u, tables, g, z0, y0, 0, kFull, smem_raw, pl,
                              qq, tid, nthr, 0, nu);
  const int NT = g.sz - 2 * P;
  const LabRows rows{LabOut{0, NT, NT}, g.X, z0, y0, g.ty};
  lab_xstage<XP>(qq, xk, xk_lo, nullptr, two != 0, g, rows,
                 reinterpret_cast<C*>(smem_raw + pl.scr), out, tid / 32,
                 (nthr + 31) / 32, tid % 32, nthr < 32 ? nthr : 32);
}

// ---- the all-band schedule: vcopy, vband, v16 ------------------------------
// on the ring of band_ring.cuh, which K1 and K4 (resident_ring.cuh) share

constexpr int kZyWin = 48;  // columns of the q1/q23 window (>= 2 XC + P)
// The sub-tiles the routine takes: the ring's pieces, and a window that holds
// two chunks (of at most 16 columns) and P columns behind them.
__host__ __device__ inline bool zy_ring_takes(int p, int tz, int ty) {
  return ring_pieces_take(p, tz, ty) && 2 * 16 + p <= kZyWin;
}

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   bar  the ring's mbarriers, full then empty
//   tab  z/y table rows of the sub-tile [Ky, My (TY rows), Kz, Mz (TZ rows)]
//   u    kRingStages slots of the halo'd u chunk (TZ+2P, TY+2P, XC)
//   st   s and t (2, TZ, TY+2P, XC)
//   q    the windows of q1 and q23 (2, M, kZyWin)
//   o    two output slots (M, XC), piece by piece
// The same for the three modes: vcopy is v16's schedule, not a lighter one.
struct ZyRingSmem {
  long long bar, tab, u, u_bytes, st, q, o, o_bytes, total;
};
__host__ __device__ inline ZyRingSmem zy_ring_smem(int p, int elem, int tz,
                                                   int ty) {
  const long long c = elem, nw = 2 * p + 2, ly = ty + 2 * p, lz = tz + 2 * p;
  const long long xc = ring_xc(elem), M = (long long)tz * ty;
  ZyRingSmem s;
  s.bar = 0;
  s.tab = lab_align(2 * kRingStages * 8);
  s.u = s.tab + lab_align(2 * (tz + ty) * nw * c);
  s.u_bytes = lab_align(lz * ly * xc * c);
  s.st = s.u + kRingStages * s.u_bytes;
  s.q = s.st + lab_align(2 * tz * ly * xc * c);
  s.o = s.q + lab_align(2 * M * kZyWin * c);
  s.o_bytes = lab_align(M * xc * c);
  s.total = s.o + 2 * s.o_bytes;
  return s;
}

// Shared-memory bytes of a block of either routine: mode kFull is zy_kernel
// (v13-v15), the others zy_ring_kernel.
__host__ __device__ inline long long zy_smem_bytes(int mode, int p, int xp,
                                                   int nu, int tz, int ty,
                                                   int X) {
  return mode == kFull ? zy_smem(p, xp, nu, tz, ty, X).total
                       : zy_ring_smem(p, xp == kXF64 ? 8 : 4, tz, ty).total;
}

// One block per (TZ, TY) sub-tile of the output rows, grid (nty, ntz), of
// kRingThreads threads: kRingWarps consumer warps and a producer warp.  in_map:
// the input layout (size, size, X) in boxes (TZ+2P, TY+2P, XC); out_map: the
// output layout (NT, NT, X) in boxes (bz, by, XC), a warp's piece.  tables:
// (6, npts, 2P+2) [Ky, My, Kz, Mz, Kx, Mx].  mode: kCopy, kBands or kZyXBand.
// One host thread (blockDim 1) runs the producer's step, then each warp's,
// in turn.
template <int P, typename C>
__global__ void __launch_bounds__(kRingThreads)
zy_ring_kernel(const __grid_constant__ HopMap in_map,
               const __grid_constant__ HopMap out_map,
               const C* __restrict__ tables, LabGeo g, int mode) {
  constexpr int NW = 2 * P + 2, XC = ring_xc(sizeof(C));
  constexpr int WX = kZyWin;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const bool solo = blockDim.x < 64;
  const int warp = tid / 32, lane = tid % 32, nlanes = solo ? 1 : 32;
  const int cn = solo ? 1 : 32 * kRingWarps;  // consumer threads
  const int tz = g.tz, ty = g.ty, lz = tz + 2 * P, ly = ty + 2 * P;
  const int X = g.X, npts = g.npts, NT = g.sz - 2 * P;
  const ZyRingSmem pl = zy_ring_smem(P, sizeof(C), tz, ty);
  const RingPieces pc = ring_pieces(tz, ty);
  const int nsub = pc.bz * pc.by * XC;  // elements of a piece's box
  const Ring ring{reinterpret_cast<uint64_t*>(smem_raw + pl.bar),
                  smem_raw + pl.u, pl.u_bytes,
                  (unsigned)(lz * ly * XC * sizeof(C))};
  const int z0 = blockIdx.y * tz, y0 = blockIdx.x * ty;
  const int nchunk = X / XC;
  const long long tsz = (long long)npts * NW;

  ring.init(tid);
  __syncthreads();

  if (!solo && warp == kRingWarps) {  // the producer warp
    if (lane == 0)
      for (int ch = 0; ch < nchunk; ++ch) {
        ring.reusable(ch);
        ring.load(ch, &in_map, ch * XC, y0, z0);
      }
    return;
  }

  C* wky = reinterpret_cast<C*>(smem_raw + pl.tab);
  C* wmy = wky + ty * NW;
  C* wkz = wmy + ty * NW;
  C* wmz = wkz + tz * NW;
  C* s = reinterpret_cast<C*>(smem_raw + pl.st);
  C* t = s + (long long)tz * ly * XC;
  C* Q1 = reinterpret_cast<C*>(smem_raw + pl.q);
  C* Q23 = Q1 + (long long)tz * ty * WX;
  const C* tkx = tables + 4 * tsz;
  const C* tmx = tables + 5 * tsz;
  if (mode != kCopy) {
    for (int i = tid; i < 2 * ty * NW; i += cn) {
      const int k = i / (ty * NW), j = i - k * ty * NW, r = j / NW;
      const int gg = y0 + r;
      wky[i] = gg < npts ? tables[k * tsz + (long long)gg * NW + (j - r * NW)]
                         : C(0);
    }
    for (int i = tid; i < 2 * tz * NW; i += cn) {
      const int k = i / (tz * NW), j = i - k * tz * NW, r = j / NW;
      const int gg = z0 + r;
      wkz[i] = gg < npts
                   ? tables[(2 + k) * tsz + (long long)gg * NW + (j - r * NW)]
                   : C(0);
    }
    ring_sync(cn);
  }

  const long long zs = (long long)ly * XC;
  // v16 writes chunk c - 1 in step c: one more step after the last chunk
  const int nsteps = mode == kZyXBand ? nchunk + 1 : nchunk;
  for (int ch = 0; ch < nsteps; ++ch) {
    const int cx0 = ch * XC;
    const bool loaded = ch < nchunk;
    const C* U = reinterpret_cast<const C*>(ring.slot(ch));
    if (loaded) {
      if (solo) ring.load(ch, &in_map, cx0, y0, z0);
      ring.wait(ch);
    }
    if (mode != kCopy && loaded) {
      // z stage, the whole block: (LZ, LY, XC) -> s, t (TZ, LY, XC)
      for (int i = tid; i < tz * ly * XC; i += cn)
        band2<P>(wmz + i / (ly * XC) * NW, wkz + i / (ly * XC) * NW, U + i, zs,
                 s[i], t[i]);
      __syncwarp();
      if (lane == 0 && !solo) ring.release(ch);
      ring_sync(cn);
    }
    // each warp its piece of the rows: y stage (v16: then x), into its box
    for (int w = solo ? 0 : warp; w < kRingWarps; w += solo ? 1 : kRingWarps) {
      const int wz = w / pc.nwy * pc.bz, wy = w % pc.nwy * pc.by;
      C* O = reinterpret_cast<C*>(smem_raw + pl.o + (ch & 1) * pl.o_bytes) +
             (long long)w * nsub;
      ring_out_acquire(lane);  // the store of chunk ch - 2
      if (loaded)
        for (int e = lane; e < nsub; e += nlanes) {
          const int ix = e % XC, r = e / XC;
          const int iy = wy + r % pc.by, iz = wz + r / pc.by;
          if (mode == kCopy) {
            O[e] = U[((long long)(iz + P) * ly + iy + P) * XC + ix];
            continue;
          }
          const long long base = ((long long)iz * ly + iy) * XC + ix;
          C q1, q2;
          band2<P>(wmy + iy * NW, wky + iy * NW, s + base, XC, q1, q2);
          const C q23 = q2 + band<P>(wmy + iy * NW, t + base, XC);
          if (mode == kBands) {
            O[e] = q1 + q23;
          } else {
            const long long qi =
                (long long)(iz * ty + iy) * WX + (cx0 + ix) % WX;
            Q1[qi] = q1;
            Q23[qi] = q23;
          }
        }
      if (mode == kZyXBand && ch > 0) {
        // x stage of the chunk before, columns [cx0 - XC, cx0), from the
        // windows (columns beyond X are zeros): out = Bx(q1; Kx) + Bx(q23;
        // Mx) in K2's difference form
        __syncwarp();
        // a warp's lanes keep their column from element to element (XC
        // divides the warp), so its two table rows are read once a chunk
        const bool own = nlanes % XC == 0;
        C wk[NW], wm[NW];
        auto rows_of = [&](int x) {
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            wk[k] = x < npts ? tkx[(long long)x * NW + k] : C(0);
            wm[k] = x < npts ? tmx[(long long)x * NW + k] : C(0);
          }
        };
        if (own) rows_of(cx0 - XC + lane % XC);
        for (int e = lane; e < nsub; e += nlanes) {
          const int ix = e % XC, r = e / XC, x = cx0 - XC + ix;
          const int iy = wy + r % pc.by, iz = wz + r / pc.by;
          if (!own) rows_of(x);
          C y = C(0);
          if (x < npts) {
            C v1[2 * P + 1], v23[2 * P + 1];
            ring_taps<P, WX>(Q1 + (long long)(iz * ty + iy) * WX, x, X, v1);
            ring_taps<P, WX>(Q23 + (long long)(iz * ty + iy) * WX, x, X, v23);
            y = band<P>(wk, v1, 1) + band<P>(wm, v23, 1);
          }
          O[e] = y;
        }
      }
      ring_out_store(lane, &out_map, O,
                     z0 + wz < NT && y0 + wy < NT &&
                         (mode != kZyXBand || ch > 0),
                     mode == kZyXBand ? cx0 - XC : cx0, y0 + wy, z0 + wz,
                     &ring, mode == kCopy && loaded && !solo ? ch : -1);
    }
    // the next z stage overwrites s and t
    if (mode != kCopy && ch + 1 < nchunk) ring_sync(cn);
  }
  if (lane == 0) hop_store_wait<0>();
}

}  // namespace tpufem
