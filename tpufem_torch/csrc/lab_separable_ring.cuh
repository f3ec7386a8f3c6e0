// The K2 kernel lab's v3 (band x, dense y and z) on Hopper's asynchronous
// machinery: a TMA ring feeds the band x stage, and the y and z stages are
// wgmma products.  Its vxy (dense x, dense y) and v2 (dense x, y and z; v6,
// v8 and v9 run it) at the end of the file, on the same y and z products,
// and v12 (dense x, band y and z) on v2's x stage.  Device code; the host
// launchers with their plain C interface are in lab_separable_ring.cu and
// (v12's) lab_separable_band.cu.  The first routine of them all
// (l2_kernel, lab_separable.cuh) stays as their earlier schedule.
//
// Replaces the Pallas kernel _kernel_v3 (scripts/kernel_lab.py:78): on the
// lab's layouts, input (size, size, X), size = nt b + 2P, data at [P:P+npts,
// P:P+npts, 0:npts], zeros elsewhere, and output (nt b, nt b, X), every point
// written, it computes K2's operator with the x axis by bands and y, z by the
// tile's dense slices (the same host tables as l2_kernel: the per-row x band
// tables in difference form, the (b, L) slices of My, Ky, Mz, Kz, L = b + 2P):
//   x   ax, gx = Bx(u; Mx), Bx(u; Kx) over the tile's halo'd (L, L) rows
//   y   t1 = My ax, t2 = Ky ax + My gx    (the tile's y slices, K = L rows)
//   z   out = Kz t1 + Mz t2               (its z slices, K = L rows)
//
// What held the first routine back (1.405 ms at the flagship in 3xTF32 on an
// H100, PERF.md) and what this design does about it:
//   loads  every thread read its 2P+1 x taps from device memory by scalar
//          loads, nothing in flight.  Here a producer warp asks for each
//          pass's halo'd u box, (kBxZC z rows, LP y rows, XC + 2 PH x
//          columns), by TMA into a ring of nu slots (an mbarrier pair a slot),
//          zero-filled beyond the layout, so no thread computes an address or
//          tests a bound on the way in, and the next pass's box is in flight
//          while this one is computed.  The tile's y and z slices reach
//          shared memory once a block, by two bulk copies.
//   x      a block owned 16 x columns and read (16 + 2P) / 16 of them.  Here
//          XC = 32 (f64: 8; 128 and 64 bytes of a row), the halo rounded to
//          16 bytes a side (PH): 1.25x at P <= 4.  The band runs on CUDA
//          cores from the slot, K2's difference form with l2_kernel's tables
//          and tap order (band2: band's operations for Mx and Kx on one read
//          of the taps), and writes ax and gx straight into the y product's
//          A layout: rows (z, x), K = y, rows padded to AS words so a
//          fragment's loads fall in distinct banks.
//   y, z   per-warp WMMA jobs from shared memory, each stored through a
//          scratch tile.  Here the two warpgroups run wgmma with A from
//          registers (hop_load_a splits it: 3xTF32 big/small, bf16x3 hi/lo)
//          and B, the slices, from shared memory, K-major as the host lays
//          them out (hop_b_offset) and split there with the kernel's own
//          rounding.  y: rows (zr, x) of the pass in 64-row tiles, N = 16 (b
//          <= 16 output rows), K = LP; [t1 | ax Ky^T] = ax [My | Ky]^T one
//          n32 product, gx My^T an n16 one added to ax Ky^T for t2 as it is
//          stored (a wgmma a k step fewer than three n16 products; no faster
//          on an H100); they land in shared memory as the z
//          product's A, rows (y, x), K = the pass's z rows.  z: rows (y, x)
//          of the tile, N = 16, accumulated in registers over the passes (a
//          split K over z: pass j is k step j; bf16's k step of 16 holds the
//          pass's 8 rows and 8 zero rows of B), out += t1 Kz^T + t2 Mz^T into
//          one accumulator, issued asynchronously so they run while the next
//          pass's band x does.  The three 3xTF32 (bf16x3) products keep
//          lab_mma.cuh's order: small*big, big*small, big*big.  f64 has no
//          wgmma: DMMA m8n8k4 (WMMA) from the same buffers, each warp its
//          8-row tiles.
//   store  each output point once, from the z accumulators to device memory
//          (rows beyond the tile's b and columns beyond X masked): a warp's
//          store writes whole 32-byte sectors.
// The tile is b <= 16 rows a side, so the products' N is 16 with no padding
// at b = 16 (the chooser's: at b = 24, N would be 24 and the products' work
// a point 1.6x); their K is L = b + 2P rounded up to the k step (LP, for b
// = 16 at compile time; a smaller b leaves zero columns).
//
// What bounds it on an H100: the function is K2's, 0.0405 ms at 16,974,593
// DoFs in f32 (bytes).  The design adds the products over the tiles' halo'd
// rows (3xTF32 at the flagship, b = 16, nt = 17, X = 272 in 9 blocks of 32
// columns, 3 passes of 8 z rows, K = 24: y 3 x 2 x 17^2 9 x 3 x 256 x 24 x
// 16 = 4.60 GFLOP, z 2 x 2 x 17^2 9 x 3 x 512 x 8 x 16 = 2.05 GFLOP, 19.9
// GFLOP with the three passes of the split, 0.040 ms at 495 TFLOP/s) and
// the band x over each pass's (8, 24, 32) box rows, two tables (1.73 GFLOP
// on CUDA cores, 0.026 ms at 67 TFLOP/s): LabKernel.design_bound.  It runs
// 0.43 ms there, 8.7x that (PERF.md): the copy without the band takes
// 0.35, its products at ~11% of the TF32 peak (N = 16 and 32, A from
// registers, one wait a y tile, two block barriers a pass); neither the
// ring's depth nor both y tiles of a warpgroup in flight moved it.
//
// One host thread (blockDim 1, the g++ build of the tests) runs a block: the
// mbarrier calls do nothing, the thread loads each pass's box itself before
// it waits, then runs both warpgroups' (f64: the eight warps') products in
// turn; a wgmma operand or accumulator holds its whole tile (hopper.cuh).
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "lab_mma.cuh"

namespace tpufem {

constexpr int kBxWarps = 8;  // two warpgroups; one more warp produces
constexpr int kBxThreads = 32 * (kBxWarps + 1);
constexpr int kBxN = 16;    // a tile's output rows at most: the products' N
constexpr int kBxZC = 8;    // halo'd z rows a pass (an item of the ring)
constexpr int kBxZS = 12;   // words a row of t (kBxZC, padded)
constexpr int kBxMaxU = 3;  // the deepest u ring

__host__ __device__ constexpr bool bx_bf(int xp) {
  return xp == kXBF16x3 || xp == kXBF16;
}
// x columns a block owns: 128 bytes of a row (f64: 64)
__host__ __device__ constexpr int bx_xc(int xp) {
  return xp == kXF64 ? 8 : 32;
}
// parts of the B operand (split products) and the bytes of its elements
__host__ __device__ constexpr int bx_parts(int xp) {
  return xp == kX3TF32 || xp == kXBF16x3 ? 2 : 1;
}
__host__ __device__ constexpr int bx_belem(int xp) {
  return xp == kXF64 ? 8 : bx_bf(xp) ? 2 : 4;
}
// the x halo each side: P rounded up to 16 bytes
__host__ __device__ constexpr int bx_ph(int p, int xp) {
  return xp == kXF64 ? (p + 1) / 2 * 2 : (p + 3) / 4 * 4;
}
// the products' K: L = kBxN + 2P rounded up to the k step (16 bf16 values,
// else 8)
__host__ __device__ constexpr int bx_lp(int p, int xp) {
  return bx_bf(xp) ? (kBxN + 2 * p + 15) / 16 * 16
                   : (kBxN + 2 * p + 7) / 8 * 8;
}
// words a row of ax and gx: LP padded so a fragment's rows fall in
// distinct banks
__host__ __device__ constexpr int bx_as(int p, int xp) {
  return bx_lp(p, xp) + (bx_bf(xp) ? 8 : 4);
}
// bytes of k a column of the y and the z products' B (bf16's z: each pass's
// 8 rows, then 8 zero rows, a k step of 16)
__host__ __device__ constexpr int bx_ykb(int p, int xp) {
  return bx_lp(p, xp) * bx_belem(xp);
}
__host__ __device__ constexpr int bx_zkb(int p, int xp) {
  return bx_lp(p, xp) * (xp == kXF64 ? 8 : 4);
}
// bytes of a tile's y (z) side of the host's B operand: [M, K] slices, each
// its parts, each kBxN columns of K-major k (f64: WMMA's column-major B)
__host__ __device__ constexpr long long bx_side_bytes(int p, int xp, int z) {
  return 2LL * bx_parts(xp) * kBxN * (z ? bx_zkb(p, xp) : bx_ykb(p, xp));
}

struct BxGeo {
  int npts, b, nt, size, X;
};

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   bar  the u ring's full and empty mbarriers (kBxMaxU each), B's
//   tab  the Mx, Kx table rows of the block's XC columns
//   b    the tile's y side, then its z side (bx_side_bytes)
//   u    nu slots of the pass's halo'd box (kBxZC, LP, XC + 2 PH)
//   ax   ax, then gx: (kBxZC XC rows, AS words)
//   t    t1, then t2: (kBxN XC rows, kBxZS words)
//   scr  f64: one 8 x 8 accumulator tile a warp
struct BxSmem {
  long long bar, tab, b, u, u_bytes, ax, t, scr, total;
};
__host__ __device__ inline BxSmem bx_smem(int p, int xp, int nu) {
  const long long c = xp == kXF64 ? 8 : 4, xc = bx_xc(xp);
  BxSmem s;
  s.bar = 0;
  s.tab = lab_align((2 * kBxMaxU + 1) * 8);
  s.b = s.tab + lab_align(2 * xc * (2 * p + 2) * c);
  s.u = s.b + lab_align(bx_side_bytes(p, xp, 0) + bx_side_bytes(p, xp, 1));
  s.u_bytes =
      lab_align(kBxZC * bx_lp(p, xp) * (xc + 2 * bx_ph(p, xp)) * c);
  s.ax = s.u + nu * s.u_bytes;
  s.t = s.ax + lab_align(2 * kBxZC * xc * bx_as(p, xp) * c);
  s.scr = s.t + lab_align(2LL * kBxN * xc * kBxZS * c);
  s.total = s.scr + (xp == kXF64 ? lab_align(kBxWarps * 64 * 8) : 0);
  return s;
}

// The y and z products on wgmma (3xTF32, 1xTF32, bf16x3, one bf16 product).
// Warpgroup wg multiplies the y tiles wg, wg + 2, ... of a pass, and holds
// the z accumulators of the tile's rows [wg ZT 64, (wg + 1) ZT 64).  One
// host thread stands for both warpgroups.
template <int P, int XP>
struct BxWgmma {
  static constexpr bool BF = bx_bf(XP);
  static constexpr bool kSplit = bx_parts(XP) == 2;
  static constexpr int XC = bx_xc(XP), AS = bx_as(P, XP);
  static constexpr int YKB = bx_ykb(P, XP), ZKB = bx_zkb(P, XP);
  static constexpr int KSY = YKB / 32;  // k steps of a y product
  static constexpr int YT = kBxZC * XC / kHopM;  // y tiles a pass
  static constexpr int ZT = kBxN * XC / kHopM / 2;  // z tiles a warpgroup
  static constexpr int NG = kHopHost ? 2 : 1;
  // Each accumulator's first product overwrites it (hop_wgmma's acc_in
  // false): no instruction defines an accumulator register while a wgmma
  // group is in flight, which would make ptxas serialise the wgmmas.
  using Acc = HopAccN<kBxN>;
  Acc z[NG * ZT];
  HopA zbig[ZT][2], zsmall[ZT][2];  // the z k step's A of t1, t2
  static constexpr int kFirst = kSplit ? 0 : 2;  // the first part's index
  // B of slice s (0: M, 1: K) part q of a side: a part's two slices side
  // by side, so the y side's [My | Ky] is one n32 B operand
  static __device__ __forceinline__ const unsigned char* bpart(
      const unsigned char* side, int s, int q, int kb) {
    return side + (long long)(q * 2 + s) * kBxN * kb;
  }
  // the y products of a pass, tile by tile: warpgroup wg's y tiles mt (rows
  // (zr, x) of the pass), ax [My | Ky]^T, one n32 product, into a1 = [t1 |
  // Ky ax], gx My^T into a2; st(mt, a1, a2) once the tile's products are
  // done (a thread holds a2's (r, c) beside a1's (r, c + 16))
  template <typename St>
  static __device__ __forceinline__ void y_products(
      const float* AX, const float* GX, const unsigned char* By, int wg,
      int w, int lane, St st) {
    auto at = [](int r, int k) { return r * AS + k; };
    for (int mt = wg; mt < YT; mt += 2) {
      HopAccN<2 * kBxN> a1;
      Acc a2;
      HopA ab[KSY], as[KSY], gb[KSY], gs[KSY];
#pragma unroll
      for (int ks = 0; ks < KSY; ++ks) {
        hop_load_a<BF>(ab[ks], as[ks], kSplit, AX + mt * kHopM * AS, at, ks,
                       w, lane);
        hop_load_a<BF>(gb[ks], gs[ks], kSplit, GX + mt * kHopM * AS, at, ks,
                       w, lane);
      }
      hop_wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSY; ++ks)
#pragma unroll
        for (int part = kFirst; part < 3; ++part) {
          const int q = part == 1;
          const bool acc_in = ks > 0 || part > kFirst;
          const HopA& a = part == 0 ? as[ks] : ab[ks];
          const HopA& g = part == 0 ? gs[ks] : gb[ks];
          hop_wgmma<BF>(a1, a, bpart(By, 0, q, YKB), ks, YKB, acc_in);
          hop_wgmma<BF>(a2, g, bpart(By, 0, q, YKB), ks, YKB, acc_in);
        }
      hop_wgmma_commit();
      hop_wgmma_wait<0>();
#pragma unroll
      for (int ks = 0; ks < KSY; ++ks) {
        hop_keep(ab[ks]);
        hop_keep(gb[ks]);
        if constexpr (kSplit) {
          hop_keep(as[ks]);
          hop_keep(gs[ks]);
        }
      }
      st(mt, a1, a2);
    }
  }
  // v3: t1, t2 into T1, T2 (row y XC + x, column zr), Ky ax added to gx My^T
  // as it is stored
  __device__ __forceinline__ void y(const float* AX, const float* GX,
                                    const unsigned char* By, float* T1,
                                    float* T2, int wg, int w, int lane) {
    y_products(AX, GX, By, wg, w, lane,
               [&](int mt, const HopAccN<2 * kBxN>& a1, const Acc& a2) {
                 auto at_t = [&](int r, int c) {
                   const int m = mt * kHopM + r;
                   return (c % kBxN * XC + m % XC) * kBxZS + m / XC;
                 };
                 hop_acc_each(a1, w, lane, [&](int r, int c, float v) {
                   (c < kBxN ? T1 : T2)[at_t(r, c)] = v;
                 });
                 hop_acc_each(a2, w, lane, [&](int r, int c, float v) {
                   T2[at_t(r, c)] += v;
                 });
               });
  }
  // the z products of pass j (its k step), asynchronous on the card: A from
  // T1, T2 (bf16: the k step's second 8 values repeat the first, against
  // B's zero rows)
  __device__ __forceinline__ void z_issue(const float* T1, const float* T2,
                                          const unsigned char* Bz, int j,
                                          int wg, int w, int lane) {
    auto at = [](int r, int k) { return r * kBxZS + (BF ? (k & 7) : k); };
    Acc* d = z + (kHopHost ? wg * ZT : 0);
#pragma unroll
    for (int i = 0; i < ZT; ++i) {
      const int mt = wg * ZT + i;
      hop_load_a<BF>(zbig[i][0], zsmall[i][0], kSplit,
                     T1 + mt * kHopM * kBxZS, at, 0, w, lane);
      hop_load_a<BF>(zbig[i][1], zsmall[i][1], kSplit,
                     T2 + mt * kHopM * kBxZS, at, 0, w, lane);
    }
    hop_wgmma_fence();
#pragma unroll
    for (int part = kFirst; part < 3; ++part)
#pragma unroll
      for (int i = 0; i < ZT; ++i) {
        const int q = part == 1;
        hop_wgmma<BF>(d[i], part == 0 ? zsmall[i][0] : zbig[i][0],
                      bpart(Bz, 1, q, ZKB), j, ZKB, j > 0 || part > kFirst);
        hop_wgmma<BF>(d[i], part == 0 ? zsmall[i][1] : zbig[i][1],
                      bpart(Bz, 0, q, ZKB), j, ZKB);
      }
    hop_wgmma_commit();
  }
  // the z products issued so far are done: their operands are free
  __device__ __forceinline__ void retire() {
    hop_wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < ZT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hop_keep(zbig[i][h]);
        if constexpr (kSplit) hop_keep(zsmall[i][h]);
      }
  }
  // st(by, x, bz, v) for each output of warpgroup wg's rows
  template <typename St>
  __device__ __forceinline__ void store(int wg, int w, int lane, St st) {
    const Acc* d = z + (kHopHost ? wg * ZT : 0);
#pragma unroll
    for (int i = 0; i < ZT; ++i) {
      const int mt = wg * ZT + i;
      hop_acc_each(d[i], w, lane, [&](int r, int c, float v) {
        const int m = mt * kHopM + r;
        st(m / XC, m % XC, c, v);
      });
    }
  }
};

// The same in f64: DMMA m8n8k4 (WMMA), A row-major from ax/gx and t, B
// column-major from the slices.  A pass's y rows are 64 (8 x columns): warp
// w multiplies the 8-row tile w; the tile's z rows are 128: warp w holds
// the tiles w and w + 8.  One host thread stands for the eight warps.
template <int P>
struct BxDmma {
  using T = LabMma<kXF64>;
  using FA = typename LabFrag<kXF64>::FA;
  using FC = typename LabFrag<kXF64>::FC;
  using FB = wmma::fragment<wmma::matrix_b, T::M, T::N, T::K, double,
                            wmma::col_major>;
  static constexpr int XC = bx_xc(kXF64), LP = bx_lp(P, kXF64);
  static constexpr int AS = bx_as(P, kXF64);
  static constexpr int NB = kBxN / T::N;  // 8-column tiles of N
  static constexpr int ZT = kBxN * XC / T::M / kBxWarps;  // z tiles a warp
  static constexpr int NG = kHopHost ? kBxWarps : 1;
  FC z[NG * ZT * NB];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < NG * ZT * NB; ++i) wmma::fill_fragment(z[i], 0.0);
  }
  // the accumulator tile through the warp's scratch: f(row, column, v)
  template <typename F>
  static __device__ __forceinline__ void each(const FC& acc, double* sw,
                                              int lane, int nlanes, F f) {
    wmma::store_matrix_sync(sw, acc, T::N, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < T::M * T::N; e += nlanes)
      f(e / T::N, e % T::N, sw[e]);
    __syncwarp();
  }
  // the y products of a pass, warp by warp: warp w's 8-row tile (rows (zr,
  // x) of the pass) by the NB column tiles, a1 = ax My^T, a2 = ax Ky^T +
  // gx My^T; st(w, a1, a2) once they are done
  template <typename St>
  static __device__ __forceinline__ void y_products(const double* AX,
                                                    const double* GX,
                                                    const double* By,
                                                    int warp, St st) {
    const double* My = By;
    const double* Ky = By + kBxN * LP;
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? kBxWarps : warp + 1);
         ++w) {
      FC a1[NB], a2[NB];
#pragma unroll
      for (int jn = 0; jn < NB; ++jn) {
        wmma::fill_fragment(a1[jn], 0.0);
        wmma::fill_fragment(a2[jn], 0.0);
      }
#pragma unroll
      for (int kk = 0; kk < LP; kk += T::K) {
        FA fa, fg;
        wmma::load_matrix_sync(fa, AX + w * T::M * AS + kk, AS);
        wmma::load_matrix_sync(fg, GX + w * T::M * AS + kk, AS);
#pragma unroll
        for (int jn = 0; jn < NB; ++jn) {
          FB fm, fk;
          wmma::load_matrix_sync(fm, My + jn * T::N * LP + kk, LP);
          wmma::load_matrix_sync(fk, Ky + jn * T::N * LP + kk, LP);
          wmma::mma_sync(a1[jn], fa, fm, a1[jn]);
          wmma::mma_sync(a2[jn], fa, fk, a2[jn]);
          wmma::mma_sync(a2[jn], fg, fm, a2[jn]);
        }
      }
      st(w, a1, a2);
    }
  }
  // v3: t1, t2 into T1, T2 through the warp's scratch tile
  __device__ __forceinline__ void y(const double* AX, const double* GX,
                                    const double* By, double* T1, double* T2,
                                    double* scr, int warp, int lane,
                                    int nlanes) {
    y_products(AX, GX, By, warp, [&](int w, const FC* a1, const FC* a2) {
      double* sw = scr + (kHopHost ? 0 : w * T::M * T::N);
#pragma unroll
      for (int jn = 0; jn < NB; ++jn)
        for (int h = 0; h < 2; ++h)
          each(h ? a2[jn] : a1[jn], sw, lane, nlanes,
               [&](int r, int c, double v) {
                 const int m = w * T::M + r;
                 (h ? T2 : T1)[((jn * T::N + c) * XC + m % XC) * kBxZS +
                               m / XC] = v;
               });
    });
  }
  __device__ __forceinline__ void z_issue(const double* T1, const double* T2,
                                          const double* Bz, int j, int warp) {
    const double* Mz = Bz;
    const double* Kz = Bz + kBxN * LP;
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? kBxWarps : warp + 1);
         ++w) {
      FC* d = z + (kHopHost ? w * ZT * NB : 0);
#pragma unroll
      for (int i = 0; i < ZT; ++i) {
        const int m0 = (w + i * kBxWarps) * T::M;
#pragma unroll
        for (int kk = 0; kk < kBxZC; kk += T::K) {
          FA f1, f2;
          wmma::load_matrix_sync(f1, T1 + m0 * kBxZS + kk, kBxZS);
          wmma::load_matrix_sync(f2, T2 + m0 * kBxZS + kk, kBxZS);
#pragma unroll
          for (int jn = 0; jn < NB; ++jn) {
            FB fk, fm;
            const long long o = jn * T::N * LP + j * kBxZC + kk;
            wmma::load_matrix_sync(fk, Kz + o, LP);
            wmma::load_matrix_sync(fm, Mz + o, LP);
            wmma::mma_sync(d[i * NB + jn], f1, fk, d[i * NB + jn]);
            wmma::mma_sync(d[i * NB + jn], f2, fm, d[i * NB + jn]);
          }
        }
      }
    }
  }
  __device__ __forceinline__ void retire() {}
  template <typename St>
  __device__ __forceinline__ void store(double* scr, int warp, int lane,
                                        int nlanes, St st) {
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? kBxWarps : warp + 1);
         ++w) {
      const FC* d = z + (kHopHost ? w * ZT * NB : 0);
      double* sw = scr + (kHopHost ? 0 : w * T::M * T::N);
#pragma unroll
      for (int i = 0; i < ZT; ++i)
#pragma unroll
        for (int jn = 0; jn < NB; ++jn)
          each(d[i * NB + jn], sw, lane, nlanes,
               [&](int r, int c, double v) {
                 const int m = (w + i * kBxWarps) * T::M + r;
                 st(m / XC, m % XC, jn * T::N + c, v);
               });
    }
  }
};

// v3 on the ring: one block per tile (iz, iy) and x block of XC columns,
// grid (ceil(X / XC), nt, nt), kBxThreads threads: eight warps run each
// pass's band x, y products and z products; a producer warp loads the
// tile's B sides once and each pass's u box into the ring of nu slots.
// in_map: the input layout (X, size, size) in boxes (XC + 2 PH, LP, kBxZC);
// bop: the host's B operand, the y sides of the nt tiles, then their z
// sides.
template <int P, int XP>
__global__ void __launch_bounds__(kBxThreads, 1)
l2_bx_kernel(const __grid_constant__ HopMap in_map,
             typename LabMma<XP>::C* __restrict__ out,
             const typename LabMma<XP>::C* __restrict__ tables,
             const unsigned char* __restrict__ bop, BxGeo g, int nu) {
  using C = typename LabMma<XP>::C;
  constexpr bool F64 = XP == kXF64;
  constexpr int XC = bx_xc(XP), PH = bx_ph(P, XP), NW = 2 * P + 2;
  constexpr int LP = bx_lp(P, XP), BXW = XC + 2 * PH, AS = bx_as(P, XP);
  constexpr int ZC = kBxZC;
  // the x band's table rows in registers, not read from shared memory for
  // each output: 3xTF32 0.478 -> 0.422 ms, 1xTF32 0.411 -> 0.364 at the
  // flagship on an H100; bf16x3, whose split operands leave no registers
  // for them, spills with them there: 0.520 in shared memory, 0.582 in
  // registers (ring_sweep, bx_rows_other)
  constexpr bool kRowsInRegs = XP != kXBF16x3;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool solo = blockDim.x < 64;
  const int cn = solo ? 1 : 32 * kBxWarps;
  const BxSmem pl = bx_smem(P, XP, nu);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + pl.bar);
  uint64_t* empty = full + kBxMaxU;
  uint64_t* bfull = full + 2 * kBxMaxU;
  const int iy = blockIdx.y, iz = blockIdx.z, x0 = blockIdx.x * XC;
  const int b = g.b, npass = (b + 2 * P + ZC - 1) / ZC;
  const long long ybytes = bx_side_bytes(P, XP, 0);
  const long long zbytes = bx_side_bytes(P, XP, 1);
  unsigned char* B = smem_raw + pl.b;
  auto produce_b = [&] {
    hop_mbar_expect(bfull, (unsigned)(ybytes + zbytes));
    hop_bulk_load(B, bop + iy * ybytes, (unsigned)ybytes, bfull);
    hop_bulk_load(B + ybytes, bop + g.nt * ybytes + iz * zbytes,
                  (unsigned)zbytes, bfull);
  };
  auto produce = [&](int j) {  // pass j's box into slot j % nu
    const int s = j % nu;
    if (j >= nu) hop_mbar_wait(empty + s, (unsigned)((j / nu - 1) & 1));
    hop_mbar_expect(full + s, (unsigned)(ZC * LP * BXW * sizeof(C)));
    hop_tma_load(smem_raw + pl.u + s * pl.u_bytes, &in_map, full + s,
                 x0 - PH, iy * b, iz * b + j * ZC);
  };

  if (tid == 0) {
    for (int s = 0; s < kBxMaxU; ++s) {
      hop_mbar_init(full + s, 1);
      hop_mbar_init(empty + s, 1);
    }
    hop_mbar_init(bfull, 1);
    hop_mbar_init_fence();
  }
  __syncthreads();
  if (!solo && warp == kBxWarps) {  // the producer warp
    if (lane == 0) {
      produce_b();
      for (int j = 0; j < npass; ++j) produce(j);
    }
    return;
  }
  if (solo) produce_b();
  // the Mx and Kx rows of the block's columns (zeros beyond npts)
  C* tab = reinterpret_cast<C*>(smem_raw + pl.tab);
  for (int i = tid; i < 2 * XC * NW; i += cn) {
    const int k = i / (XC * NW), r = i / NW % XC, xg = x0 + r;
    tab[i] = xg < g.npts
                 ? tables[((long long)k * g.npts + xg) * NW + i % NW]
                 : C(0);
  }
  C* AX = reinterpret_cast<C*>(smem_raw + pl.ax);
  C* GX = AX + ZC * XC * AS;
  C* T1 = reinterpret_cast<C*>(smem_raw + pl.t);
  C* T2 = T1 + kBxN * XC * kBxZS;
  // the x band's split of the threads: column pairs (xo, yl mod 4), then
  // rows (zr, yl / 4); one host thread takes them all
  constexpr int kCols = XC * 4;
  const bool split = cn >= kCols;
  const int c0 = split ? tid % kCols : tid, cstep = split ? kCols : cn;
  const int r0 = split ? tid / kCols : 0, rstep = split ? cn / kCols : 1;
  lab_sync(1, cn);
  hop_mbar_wait(bfull, 0);
  std::conditional_t<F64, BxDmma<P>, BxWgmma<P, XP>> x;
  if constexpr (F64) x.zero();
  // f(wg) for this thread's warpgroup (the host thread: both), its index
  // warp-uniform as ptxas can see (a wgmma on a path it cannot prove so is
  // serialised)
  auto each_wg = [&](auto f) {
    if constexpr (kHopHost) {
      for (int wg = 0; wg < 2; ++wg) f(wg);
    } else {
      f(hop_uniform(tid / 128));
    }
  };
  for (int j = 0; j < npass; ++j) {
    if (solo) produce(j);
    const int s = j % nu;
    hop_mbar_wait(full + s, (unsigned)((j / nu) & 1));
    // x band: output (zr, yl, xo) of the pass.  A thread keeps one column
    // pair (xo, yl mod 4) over the pass's rows, and its Mx, Kx table rows
    // in registers where kRowsInRegs; a warp's lanes take eight x columns
    // by four y rows (distinct banks on both sides)
    const C* U = reinterpret_cast<const C*>(smem_raw + pl.u + s * pl.u_bytes);
    for (int c = c0; c < kCols; c += cstep) {
      const int xo = (c & 7) + (c >> 5) * 8, ylo = (c >> 3) & 3;
      C wm[NW], wk[NW];
      if constexpr (kRowsInRegs) {
#pragma unroll
        for (int o = 0; o < NW; ++o) {
          wm[o] = tab[xo * NW + o];
          wk[o] = tab[(XC + xo) * NW + o];
        }
      }
      const C* wa = kRowsInRegs ? wm : tab + xo * NW;
      const C* wb = kRowsInRegs ? wk : tab + (XC + xo) * NW;
      for (int r = r0; r < ZC * (LP / 4); r += rstep) {
        const int zr = r / (LP / 4), yl = r % (LP / 4) * 4 + ylo;
        C am, ak;
        band2<P>(wa, wb, U + (zr * LP + yl) * BXW + xo + PH - P, 1, am, ak);
        AX[(zr * XC + xo) * AS + yl] = am;
        GX[(zr * XC + xo) * AS + yl] = ak;
      }
    }
    lab_sync(1, cn);  // ax, gx whole; the slot read
    if (tid == 0) hop_mbar_arrive(empty + s);
    x.retire();  // pass j - 1's z products: their registers are free
    if constexpr (F64) {
      x.y(AX, GX, reinterpret_cast<const double*>(B), T1, T2,
          reinterpret_cast<double*>(smem_raw + pl.scr), warp, lane,
          solo ? 1 : 32);
    } else {
      each_wg([&](int wg) { x.y(AX, GX, B, T1, T2, wg, warp % 4, lane); });
    }
    lab_sync(1, cn);  // t1, t2 whole
    if constexpr (F64) {
      x.z_issue(T1, T2, reinterpret_cast<const double*>(B + ybytes), j, warp);
    } else {
      each_wg([&](int wg) {
        x.z_issue(T1, T2, B + ybytes, j, wg, warp % 4, lane);
      });
    }
  }
  x.retire();
  const long long NT = (long long)g.nt * b;
  auto st = [&](int by, int xo, int bz, C v) {
    if (by < b && bz < b && x0 + xo < g.X)
      out[(((long long)iz * b + bz) * NT + (long long)iy * b + by) * g.X +
          x0 + xo] = v;
  };
  if constexpr (F64) {
    x.store(reinterpret_cast<double*>(smem_raw + pl.scr), warp, lane,
            solo ? 1 : 32, st);
  } else {
    each_wg([&](int wg) { x.store(wg, warp % 4, lane, st); });
  }
}

// ---- vxy and v2 on the ring ------------------------------------------------
// The K2 lab's vxy (_kernel_vxy, scripts/kernel_lab.py:177: the x stage, then
// the y products, the output the halo'd tile's first b z rows, so its
// function is ((My + Ky)(x)Mx + My(x)Kx) u shifted by P rows in z) on the
// same layouts and tile as v3's ring: one block per tile (iz, iy) and x
// block of XC columns (32, f64 8), b <= 16, a pass per 8 halo'd z rows of
// the first b.
//   x   ax, gx = u Mx^T, u Kx^T over the pass's (8, LP) halo'd rows, K = all
//       X columns, dense on wgmma as vx's x stage (l2_xring) runs it: a ring
//       of kBxyStages stages, each a chunk of KC columns of the pass's u rows
//       (the A operand, its 16-byte pieces permuted by the row so a
//       fragment's loads fall in distinct banks) and of the host's split B
//       (the rows of Mx, then of Kx, of the block's two x blocks of 16
//       columns, K-major: separable_lab.x_blocks), cp.async 16 bytes a
//       thread, the loads of two chunks in flight while one is multiplied;
//       warpgroup wg multiplies the 64-row tiles wg, wg + 2 (a pass has 3 at
//       LP = 24, 4 at 32; at 24 each warpgroup runs code of its own, its
//       tile count known at compile time, so no wgmma waits on a run-time
//       condition and none multiplies a tile twice, where a copy of the
//       third tile, not stored, cost vxy and v2 5-9% at the flagship in
//       1xTF32 and 3xTF32: ring_sweep bxy_tile_repeat, PERF.md), one n32
//       product an x block, 3xTF32 and bf16x3 in lab_mma.cuh's order (small*big,
//       big*small, big*big).  The accumulators, rows (zr, yl), are stored
//       transposed straight into the y product's A layout (rows (zr, x), K =
//       yl, AS words a row: bx_as), which lies over the ring once the pass's
//       last chunk is multiplied.  Its own copy of l2_xring's loop, with
//       the rows a pass at compile time and each accumulator's first product
//       overwriting it: vxy calling l2_xring itself ran 1.11 ms at the
//       flagship in 3xTF32 against this copy's 0.98 (PERF.md, vxy).
//   y   BxWgmma::y_products, v3's: [t1 | Ky ax] = ax [My | Ky]^T one n32
//       product, gx My^T one n16, A from registers, B the tile's y side as v3
//       lays it out (bulk-free: cp.async with the first chunk).  A thread
//       holds a2's (r, c) beside a1's (r, c) and (r, c + 16), so t1 + t2 is
//       summed in registers and stored from there to device memory, masked
//       to the tile's b rows and to X: no T1/T2, no scratch tile, no second
//       trip through shared memory.
//   f64 DMMA m8n8k4 (WMMA) for both, 8 x columns a block: the x stage's
//       jobs are 8-row tiles by the 8 columns of Mx, then of Kx; an
//       accumulator's elements are found by a fragment of their indices
//       (WMMA leaves the mapping unspecified), loaded once from a 64-entry
//       table.
// What bounds it on an H100: the function is 4 band outputs a DoF, bytes:
// 0.0405 ms at 16,974,593 DoFs in f32.  The design is the dense x stage's:
// at the flagship (b = 16, nt = 17, X = 272, 9 blocks of 32 columns, 2
// passes, 3 tiles of 64 rows a pass, N = 32 a part, K = 272) 2 x 17^2 9 x 2
// x 192 x 64 x 272 x 3 = 104.3 GFLOP in 3xTF32, 0.21 ms at 495 TFLOP/s; the
// y products 9.2 (N = 48 a k step, K = 24): LabKernel.design_bound.
// The shared memory (the y side, the ring with ax and gx over it: 88 KB at
// p = 4 in 3xTF32, 106 KB at p = 8) lets two blocks share an SM, so one
// block's y products and stores run beside the other's x stage.
//
// v2 (_kernel_v2, scripts/kernel_lab.py:47: K2's operator, x, y and z dense;
// _kernel_v6 :106 and _kernel_v8 :132 compute the same function, their
// differences Mosaic's layouts of the same contractions, and _kernel_v9
// :212 is v2 in bf16x3: they run this routine, bit for bit v2's) is vxy's x
// stage and v3's y and z stages on the same tile, l2_bxyz_kernel:
//   x   vxy's loop over every pass of the tile's L halo'd z rows (ceil(L /
//       8) passes, not only its first b); rows past the block's last tile
//       load as zeros, rows past a tile's L within the block as real data:
//       the z slices' zero columns multiply both.
//   y   BxWgmma::y, v3's products, t1 and t2 into T1/T2 in the z product's
//       A layout (rows (y, x), K = the pass's z rows).
//   z   BxWgmma::z_issue after each pass, pass j of a tile its k step j,
//       accumulated in registers, and the output stored from the
//       accumulators (masked to the tile's b rows and to X; no scratch tile,
//       no staging).  f64: BxDmma's products, the accumulators' elements
//       found by vxy's index fragment for T1/T2 and for the store.
//   march  a block owns a segment of `seg` consecutive z tiles of one y
//       tile and x block and walks its passes in order.  Where b is a
//       multiple of 8 and 2P <= 8 (the flagship's b = 16, P = 4), the pass
//       that ends tile t is the first of tile t + 1: its x and y stages run
//       once, tile t's last k step is issued from T1/T2, retired and
//       stored, and tile t + 1's accumulators start from the same T1/T2 as
//       its k step 0, with the tile's z side, loaded into the other of two
//       slots while tile t ran.  Segments of 3 at the flagship (the
//       chooser's, separable_lab.RING_SEG) run 40 passes for a column's 17
//       tiles where one tile a block runs 51.  A pass's x and y stages read
//       the same rows and slices in any segment and each tile's z sums keep
//       their order, so every seg computes the same bits; seg = 1 is the
//       per-tile routine (the host sends seg > 1 only where a pass is
//       shared).
// What bounds it: K2's operator, 0.0405 ms at the flagship in f32 (bytes).
// The design: 3 passes a tile at seg = 1 (x 156.5 GFLOP, y 13.8, z 6.1 in
// 3xTF32: 0.36 ms at 495 TFLOP/s), 40 for 17 tiles at seg = 3, the
// chooser's (0.28 ms): LabKernel.design_bound.  Shared memory: vxy's, two
// z side slots and T1/T2 (146 KB at p = 4 in 3xTF32): one block an SM, 255
// registers a thread (two blocks an SM at 128 ran 1.92 against 1.19 ms,
// ring_sweep bxyz_two_blocks).
//
// v12 (_kernel_v12, scripts/kernel_lab.py:237: K2's operator, x dense, y and
// z by bands; the port's exact per-row band tables, l2_kernel's, in place of
// the periodic ones and their corrections) is v2's x stage feeding band y
// and z stages on CUDA cores, l2_bxyzb_kernel (the body's third mode):
//   x   v2's, over every pass of the segment's halo'd z rows, 8 a pass, rows
//       past the segment's last tile's halo'd end zeros; its rows a pass 8
//       LP, LP = 16 + 2P rounded up to 8 in every precision (no y product
//       asks for bf16's k step of 16: bzb_lp).  The accumulators are stored
//       in rows (zr, yl) with x contiguous, as the band reads them, XS words
//       a row (bzb_xs; f32 XC + 8, so a fragment's two-value stores fall in
//       distinct banks).
//   y   t1 = My ax, t2 = Ky ax + My gx in K2's difference form (band2: My
//       and Ky on one read of ax's taps; l2_kernel's operations, tap by tap),
//       each thread for its columns (by, x) of the tile: two consecutive y
//       rows at one x (f64: one column, on the first 128 threads), whose
//       2P + 2 taps it reads once, a warp's lanes consecutive x; the My and
//       Ky rows of its columns in registers for the pass, loaded 16 bytes
//       at a time from shared memory (a first version, which read every
//       table value and tap of each output from shared memory a word at a
//       time, spent a third of its time in the bands).
//   z   as K2's z-march (separable_apply.cuh): a thread keeps t1 and t2 of
//       the last 2P + 1 halo'd z rows of its columns in a window (registers,
//       shifted a row at a time with compile-time indices, or a ring of 2P
//       + 1 rows in shared memory: bzb_regs), and once halo'd row g + 2P has
//       arrived emits output row g, Kz t1 + Mz t2 (l2_kernel's order) with
//       the Kz and Mz rows of g from shared memory (loaded with each pass;
//       16 bytes a load, the same for every thread), straight to device
//       memory, masked to the tile's b rows, to X and to the segment; zeros
//       where g >= npts.
//   after  each pass's bands run after its x stage, a row at a time, the My,
//       Ky rows of a thread's columns in registers for the pass; the Mz, Kz
//       rows of a pass reach shared memory by cp.async with its first
//       chunk.  Bands of pass j - 1 run inside pass j's x stage, a row or
//       more after each chunk's products were issued (the CUDA cores
//       banding while the tensor cores multiply, ax and gx beside the
//       ring), ran slower in an exploratory build, and were not kept.
//   march  the window carries across tile edges, so a segment of seg z
//       tiles runs ceil((seg b + 2P) / 8) passes whatever b and P (v2 shares
//       one pass between two tiles only where b % 8 == 0 and 2P <= 8).  An
//       output's sums keep one order in any segment (its x products' rows,
//       its taps), so every seg computes the same bits; seg = 1 is the
//       per-tile routine.
// No y or z slices, no T1/T2, no z accumulators: the shared memory is the x
// stage's ring with ax and gx over it, the band tables' rows and, where the
// window is not in registers, the window (82 KB at p = 4 in 3xTF32).  One
// block an SM, by its registers, as v2: at two, 128 registers a thread,
// ptxas serialises every wgmma and the ring ran slower (ring_sweep
// bzb_two_blocks).  What bounds it: K2's operator, 0.0405 ms at the
// flagship in f32 (bytes); the design, v2's x products over its passes and
// the bands on CUDA cores: LabKernel.design_bound.

constexpr int kBxyThreads = 256;  // two warpgroups (f64: eight warps)
constexpr int kBxyStages = 4;     // stages of the x stage's ring
constexpr int kBxyzStages = 4;    // v2's and v12's: 5 or 6 gained nothing
                                  // for v2 (ring_sweep)
constexpr int kBxyzBlocks = 1;    // v2's blocks an SM at launch (registers)
constexpr int kBxyzbBlocks = 1;   // v12's
// the body's stage modes: vxy (x, y products), v2 (x, y and z products),
// v12 (x, band y and z)
enum BxyMode { kBxyVxy = 0, kBxyV2 = 1, kBxyV12 = 2 };
// K columns of the x stage a chunk: 64 bytes of a u row
__host__ __device__ constexpr int bxy_kc(int xp) {
  return xp == kXF64 ? 8 : 16;
}
// v12's halo'd y rows of the x product: kBxN + 2P rounded up to 8
__host__ __device__ constexpr int bzb_lp(int p) {
  return (kBxN + 2 * p + 7) / 8 * 8;
}
// v12's words a row of ax and gx, x contiguous
__host__ __device__ constexpr int bzb_xs(int xp) {
  return xp == kXF64 ? bx_xc(xp) : bx_xc(xp) + 8;
}
// values a band table row of v12's takes in shared memory: 2P + 2 padded
// to 16 bytes, so a row reaches registers by 16-byte loads
__host__ __device__ constexpr int bzb_nwp(int p, int xp) {
  return xp == kXF64 ? (2 * p + 3) / 2 * 2 : (2 * p + 5) / 4 * 4;
}
// the row of a band table at src (16-byte aligned) into dst: 16 bytes a
// load on the card
template <int N, typename C>
__device__ __forceinline__ void bzb_row(C (&dst)[N], const C* src) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(C) == 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 v = reinterpret_cast<const double2*>(src)[i];
      dst[2 * i] = v.x;
      dst[2 * i + 1] = v.y;
    }
  }
#else
  for (int i = 0; i < N; ++i) dst[i] = src[i];
#endif
}
// cp.async of one table value (4 or 8 bytes, aligned so) into shared
// memory, landing with the thread's next cp.async group; a host build copies
// at once
template <typename C>
__device__ __forceinline__ void bzb_cp(C* smem, const C* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
               "l"(gmem), "n"((int)sizeof(C))
               : "memory");
#else
  *smem = *gmem;
#endif
}
// whether v12's z window lies in registers (else a ring in shared memory):
// not in f64, and not at p = 7, 8, where the register window spills and
// the shared ring ran faster (ring_sweep bzb_window_shared: the shared ring
// at p = 4)
__host__ __device__ constexpr bool bzb_regs(int p, int xp) {
  return xp != kXF64 && p <= 6;
}

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   idx   f64: the 64 indices the accumulators' elements are found by
//   b     the tile's y side of the B operand (bx_side_bytes)
//   bz    v2 (z): two slots of a tile's z side, bz_slot bytes each
//   b     v12: the band tables' rows instead: My, then Ky, of the tile's
//         kBxN rows, then Mz, then Kz, of a pass's 8 output rows ((2 (kBxN
//         + 8), bzb_nwp) values)
//   bz    v2 (z): two slots of a tile's z side, bz_slot bytes each
//   ring  kBxyStages (v2, v12: kBxyzStages) stages of `stage` bytes: the
//         chunk's A operand (8 LP rows of KC values), then for each x
//         block each part of B (its [Mx | Kx] columns by KC); ax, then gx
//         ((8 XC rows, AS words); v12: (8 LP rows, bzb_xs words)) lie over
//         it
//   t     v2: t1, then t2 ((kBxN XC rows, kBxZS words)), v3's layout; v12,
//         its window outside registers: t1, then t2, of 2P + 1 rows of the
//         tile's kBxN XC columns
struct BxySmem {
  long long idx, b, bz, bz_slot, ring, a, b_part, stage, ax, t, total;
};
__host__ __device__ inline BxySmem bxy_smem(int p, int xp,
                                            int mode = kBxyVxy) {
  const bool f64 = xp == kXF64, z = mode == kBxyV2, zb = mode == kBxyV12;
  const long long c = f64 ? 8 : 4, xc = bx_xc(xp), kc = bxy_kc(xp);
  const long long nxb = f64 ? 1 : 2, ncol = f64 ? 2 * xc : kHopN;
  const long long lp = zb ? bzb_lp(p) : bx_lp(p, xp);
  BxySmem s;
  s.idx = 0;
  s.b = f64 ? lab_align(64 * 8) : 0;
  s.bz = s.b + lab_align(zb ? 2LL * (kBxN + kBxZC) * bzb_nwp(p, xp) * c
                            : bx_side_bytes(p, xp, 0));
  s.bz_slot = z ? lab_align(bx_side_bytes(p, xp, 1)) : 0;
  s.ring = s.bz + 2 * s.bz_slot;
  s.a = lab_align(kBxZC * lp * kc * c);
  s.b_part = lab_align(ncol * kc * bx_belem(xp));
  s.stage = s.a + nxb * bx_parts(xp) * s.b_part;
  const long long ax = lab_align(
      2LL * kBxZC * (zb ? lp * bzb_xs(xp) : xc * bx_as(p, xp)) * c);
  const long long ring = (mode == kBxyVxy ? kBxyStages : kBxyzStages) *
                         s.stage;
  s.ax = s.ring;
  s.t = s.ring + (ring > ax ? ring : ax);
  s.total = s.t + (z ? lab_align(2LL * kBxN * xc * kBxZS * c)
                   : zb && !bzb_regs(p, xp)
                       ? lab_align(2LL * (2 * p + 1) * kBxN * xc * c)
                       : 0);
  return s;
}

// The 64-row tiles of a pass of NMT that warpgroup W (of NWG) multiplies:
// W an integral_constant, its own count; a run-time int, NMT / NWG (NMT a
// multiple of NWG)
template <int NMT, int NWG, typename W>
__host__ __device__ constexpr int bxy_tiles() {
  if constexpr (std::is_integral_v<W>) {
    static_assert(NMT % NWG == 0, "a run-time warpgroup: equal shares");
    return NMT / NWG;
  } else {
    return (NMT - W::value + NWG - 1) / NWG;
  }
}
// the warpgroup's index, a run-time int or an integral_constant's value
template <typename W>
__host__ __device__ constexpr int bxy_wg(W wg) {
  if constexpr (std::is_integral_v<W>) {
    return wg;
  } else {
    return W::value;
  }
}

// f(r, c, t1 + t2) for each element (r, c < N) of a y tile this thread holds:
// a1 = [t1 | Ky ax] (n 2N), a2 = gx My^T (n N), t2 = Ky ax + gx My^T
template <int N, typename F>
__device__ __forceinline__ void bxy_sum_each(const HopAccN<2 * N>& a1,
                                             const HopAccN<N>& a2, int w,
                                             int lane, F f) {
#ifdef __CUDA_ARCH__
  const int r = 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(r + 8 * (e >> 1), 8 * j + c + (e & 1),
        a1.d[4 * j + e] + (a1.d[4 * (j + N / 8) + e] + a2.d[4 * j + e]));
#else
  for (int r = 0; r < kHopM; ++r)
    for (int c = 0; c < N; ++c)
      f(r, c,
        a1.d[r * 2 * N + c] + (a1.d[r * 2 * N + N + c] + a2.d[r * N + c]));
#endif
}

// two values to d, d[0] and d[1] (d 8-byte aligned): one store on the card
__device__ __forceinline__ void bzb_put2(float* d, float a, float b) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
#else
  d[0] = a;
  d[1] = b;
#endif
}

// The block of vxy (M kBxyVxy: one tile, blockIdx.z), of v2 (kBxyV2) or of
// v12 (kBxyV12; v2 and v12: the tiles [blockIdx.z seg, + seg) of the
// column), grid (ceil(X / XC), nt, nt or ceil(nt / seg)), kBxyThreads
// threads.  u: the input layout (size, size, X); xb: the dense x stage's B
// operand, (parts, X / 16, 32, X) (separable_lab.x_blocks, split), part q
// xb_part elements on; bop: the y sides of the nt tiles, then their z sides
// (separable_lab.ring_slices; vxy reads no z side, v12 none);
// tables: v12's (6, npts, 2P + 2) band tables of Mx, Kx, My, Ky, Mz, Kz
// (My to Kz read).  One host thread (blockDim 1) runs a block: each chunk's
// loads at once, both warpgroups' (f64: the eight warps') products in turn,
// every column's bands.
template <int P, int XP, int M>
__device__ __forceinline__ void l2_bxy_body(
    const typename LabMma<XP>::C* __restrict__ u,
    typename LabMma<XP>::C* __restrict__ out,
    const typename LabMma<XP>::E* __restrict__ xb, long long xb_part,
    const unsigned char* __restrict__ bop,
    const typename LabMma<XP>::C* __restrict__ tables, const BxGeo& g,
    int seg) {
  using T = LabMma<XP>;
  using C = typename T::C;
  using E = typename T::E;
  constexpr bool F64 = XP == kXF64, BF = bx_bf(XP);
  constexpr bool Z = M == kBxyV2, ZB = M == kBxyV12;
  constexpr bool kSplit = bx_parts(XP) == 2;
  constexpr int XC = bx_xc(XP), AS = bx_as(P, XP);
  constexpr int LP = ZB ? bzb_lp(P) : bx_lp(P, XP);
  constexpr int ZC = kBxZC, KC = bxy_kc(XP);
  constexpr int S = M == kBxyVxy ? kBxyStages : kBxyzStages;
  constexpr int NP = bx_parts(XP), NXB = F64 ? 1 : 2;
  constexpr int NCOL = F64 ? 2 * XC : kHopN;  // B columns of an x block
  constexpr int CV = 16 / (int)sizeof(C), EV = 16 / (int)sizeof(E);
  constexpr int ACH = KC / CV, BCH = KC / EV;  // 16-byte pieces of a row
  constexpr int kbytes = KC * (int)sizeof(E);
  constexpr int ROWS = ZC * LP;  // the x product's rows a pass: (zr, yl)
  static_assert(ROWS % kHopM == 0 && ROWS <= 4 * kHopM, "LP <= 32");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const bool solo = nthr < 64;
  const BxySmem pl = bxy_smem(P, XP, M);
  const int iy = blockIdx.y, x0 = blockIdx.x * XC;
  const int b = g.b, L = b + 2 * P, nkc = g.X / KC, nxblk = g.X / 16;
  // the block's z tiles [t0, tn)
  const int t0 = blockIdx.z * seg;
  const int tn = t0 + seg < g.nt ? t0 + seg : g.nt;
  // u rows at or past zlim load as zeros: vxy's tile's first b z rows; v2's
  // and v12's tiles' halo'd rows
  const int zlim = M != kBxyVxy ? (tn - 1) * b + L : t0 * b + b;
  const long long NT = (long long)g.nt * b;
  const long long ybytes = bx_side_bytes(P, XP, 0);
  const long long zbytes = bx_side_bytes(P, XP, 1);
  unsigned char* B = smem_raw + pl.b;
  unsigned char* ring = smem_raw + pl.ring;
  constexpr int XS = bzb_xs(XP);  // v12: words a row of ax and gx
  C* AX = reinterpret_cast<C*>(smem_raw + pl.ax);
  C* GX = AX + (ZB ? ZC * LP * XS : ZC * XC * AS);
  C* T1 = reinterpret_cast<C*>(smem_raw + pl.t);
  C* T2 = T1 + kBxN * XC * kBxZS;
  // word offset of column k of row `row` of a chunk's A operand: f32 rows of
  // 64 bytes with their 16-byte pieces permuted by the row (l2_xring's)
  auto a_at = [](int row, int k) -> int {
    if constexpr (F64) return row * KC + k;
    else return row * KC + ((((k >> 2) ^ (row >> 1)) & 3) << 2) + (k & 3);
  };
  // chunk kc of the pass whose first halo'd z row is z0 into its stage: u
  // rows beyond the tile's L halo'd y rows or at or past zlim are zeros
  auto load = [&](int z0, int kc) {
    if (kc < nkc) {
      unsigned char* st = ring + (kc % S) * pl.stage;
      C* A = reinterpret_cast<C*>(st);
      const C* src = u + (long long)iy * b * g.X + kc * KC;
      for (int i = tid; i < ROWS * ACH; i += nthr) {
        const int row = i / ACH, ch = i % ACH;
        const int z = z0 + row / LP, yl = row % LP;
        C* dst = A + a_at(row, ch * CV);
        if (yl < L && z < zlim) {
          lab_cp16(dst, src + ((long long)z * g.size + yl) * g.X + ch * CV);
        } else {
#pragma unroll
          for (int e = 0; e < CV; ++e) dst[e] = C(0);
        }
      }
      for (int i = tid; i < NXB * NP * NCOL * BCH; i += nthr) {
        const int ch = i % BCH, n = i / BCH % NCOL, jq = i / (BCH * NCOL);
        const int q = jq % NP, j = jq / NP;
        long long row;  // of xb's part: Mx row x, or Kx row x
        if constexpr (F64) {
          row = (long long)(x0 / 16) * kHopN + (n < XC ? 0 : 16) + x0 % 16 +
                n % XC;
        } else {
          const int xblk = blockIdx.x * NXB + j < nxblk
                               ? blockIdx.x * NXB + j : nxblk - 1;
          row = (long long)xblk * kHopN + n;
        }
        const int off = F64 ? (n * KC + ch * EV) * (int)sizeof(E)
                            : hop_b_offset(n, ch * 16, kbytes);
        lab_cp16(st + pl.a + jq * pl.b_part + off,
                 xb + q * xb_part + row * g.X + kc * KC + ch * EV);
      }
    }
    lab_cp_commit();  // an empty group past the end keeps the count
  };
  // bytes of device memory into shared memory, cp.async: they land with
  // the next chunk's group
  auto load_side = [&](unsigned char* dst, const unsigned char* src,
                       long long bytes) {
    for (int i = tid; i < (int)(bytes / 16); i += nthr)
      lab_cp16(dst + 16 * i, src + 16 * i);
  };
  // the tile's y side, with the first pass's first chunk
  if constexpr (!ZB) load_side(B, bop + iy * ybytes, ybytes);
  // v2: tile t's z side into its slot
  auto z_side = [&](int t) {
    return smem_raw + pl.bz + ((t - t0) & 1) * pl.bz_slot;
  };
  auto load_z = [&](int t) {
    load_side(z_side(t), bop + g.nt * ybytes + t * zbytes, zbytes);
  };
  // v2: before the tile's first pass that runs its x stage, the z sides
  // the tile needs next (the first tile's own too); the slot is the one
  // tile t - 1 read, which every warp has retired once the block is past
  // a barrier
  auto next_z = [&](int t) {
    if (t > t0) __syncthreads();
    if (t == t0) load_z(t);
    if (t + 1 < tn) load_z(t + 1);
  };
  const int npass = Z ? (L + ZC - 1) / ZC : (b + ZC - 1) / ZC;
  // v2: the output of tile t, by (by, x, bz)
  auto out_at = [&](int t, int bz, int by, int x) {
    return (((long long)t * b + bz) * NT + (long long)iy * b + by) * g.X +
           x0 + x;
  };
  // ---- v12's band stages ----
  // the segment's first halo'd z row, the end of its output rows
  const int zs = t0 * b, zend = tn * b;
  constexpr int NW = 2 * P + 2, NR = 2 * P + 1;  // a table row; the window
  constexpr int NWP = bzb_nwp(P, XP);  // a table row in shared memory
  // a group: CPT consecutive y rows by0 .. by0 + CPT - 1 at one x, whose
  // y taps are read once; a thread's groups (the host thread: all of them)
  constexpr int CPT = F64 ? 1 : 2, NG = kBxN * XC / CPT;
  constexpr int GPT = kHopHost ? NG : (NG + kBxyThreads - 1) / kBxyThreads;
  constexpr int NTAP = CPT + 2 * P;
  constexpr bool WREG = ZB && bzb_regs(P, XP);
  // My, Ky rows of the tile's rows; Mz, Kz rows of a pass's output rows
  C* ytab = reinterpret_cast<C*>(smem_raw + pl.b);
  C* ztab = ytab + 2 * kBxN * NWP;
  // the window: in registers, t1 and t2 of the last NR halo'd rows of
  // each of this thread's columns, oldest first; else in shared memory,
  // (2, NR, kBxN XC), row r in slot r % NR, column (by, x) at by XC + x
  C win[WREG ? GPT : 1][WREG ? CPT : 1][2][WREG ? NR : 1];
  C* wsh = reinterpret_cast<C*>(smem_raw + pl.t);
  if constexpr (ZB) {
    for (int i = tid; i < 2 * kBxN * NWP; i += nthr) {
      const int by = i / NWP % kBxN, gy = iy * b + by, o = i % NWP;
      ytab[i] = by < b && gy < g.npts && o < NW
                    ? tables[((2LL + i / (kBxN * NWP)) * g.npts + gy) * NW +
                             o]
                    : C(0);
    }
    if constexpr (WREG) {
#pragma unroll
      for (int i = 0; i < GPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int o = 0; o < NR; ++o) win[i][c][0][o] = win[i][c][1][o] = 0;
    }
  }
  // the Mz, Kz rows of pass j's output rows, zs + 8 j - 2P .. + 7 (zeros
  // outside [0, npts)), by cp.async: they land with the pass's first chunk,
  // and no thread waits on their loads before the pass's own; read after
  // the pass's x stage
  auto load_ztab = [&](int j) {
    for (int i = tid; i < 2 * ZC * NWP; i += nthr) {
      const int gz = zs + j * ZC + i / NWP % ZC - 2 * P, o = i % NWP;
      if (gz >= 0 && gz < g.npts && o < NW) {
        bzb_cp(ztab + i,
               tables + ((4LL + i / (ZC * NWP)) * g.npts + gz) * NW + o);
      } else {
        ztab[i] = C(0);
      }
    }
  };
  // the My, Ky rows of each of this thread's columns into registers, 16
  // bytes a load
  using YRows = C[GPT][CPT][NWP];
  auto load_yrows = [&](YRows& wmy, YRows& wky) {
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int by0 = (tid + i * nthr) / XC * CPT;
      if (NG % kBxyThreads != 0 && by0 >= kBxN) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        bzb_row<NWP>(wmy[i][c], ytab + (by0 + c) * NWP);
        bzb_row<NWP>(wky[i][c], ytab + (kBxN + by0 + c) * NWP);
      }
    }
  };
  // the band y (from AX, GX) and band z of halo'd row r = 8 j + zr of the
  // segment, pass j's: r goes into each column's window, and output row zs
  // + r - 2P, once it lies in the segment, is emitted from it; the row's Mz
  // and Kz rows (one for the whole block) reach registers 16 bytes a load
  auto band_row = [&](int j, int zr, const YRows& wmy, const YRows& wky) {
    const int r = j * ZC + zr, gz = zs + r - 2 * P;
    const bool emit = r >= 2 * P && gz < zend;
    C wkz[NWP], wmz[NWP];
    bzb_row<NWP>(wkz, ztab + (ZC + zr) * NWP);
    bzb_row<NWP>(wmz, ztab + zr * NWP);
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int gi = tid + i * nthr, x = gi % XC, by0 = gi / XC * CPT;
      if (NG % kBxyThreads != 0 && by0 >= kBxN) continue;
      // the taps of the group's rows: halo'd y rows by0 .. by0 + CPT - 1 +
      // 2P of ax and gx at x
      C ta[NTAP], tg[NTAP];
#pragma unroll
      for (int o = 0; o < NTAP; ++o) {
        ta[o] = AX[(zr * LP + by0 + o) * XS + x];
        tg[o] = GX[(zr * LP + by0 + o) * XS + x];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int by = by0 + c, col = by * XC + x;
        C t1, t2;
        band2<P>(wmy[i][c], wky[i][c], ta + c, 1, t1, t2);
        t2 += band<P>(wmy[i][c], tg + c, 1);
        if constexpr (WREG) {
#pragma unroll
          for (int o = 0; o + 1 < NR; ++o) {
            win[i][c][0][o] = win[i][c][0][o + 1];
            win[i][c][1][o] = win[i][c][1][o + 1];
          }
          win[i][c][0][NR - 1] = t1;
          win[i][c][1][NR - 1] = t2;
        } else {
          wsh[(r % NR) * kBxN * XC + col] = t1;
          wsh[(NR + r % NR) * kBxN * XC + col] = t2;
        }
        if (emit && by < b && x0 + x < g.X) {
          C v = C(0);
          if (gz < g.npts) {
            if constexpr (WREG) {
              v = band<P>(wkz, win[i][c][0], 1) +
                  band<P>(wmz, win[i][c][1], 1);
            } else {
              C w1[NR], w2[NR];  // rows r - 2P .. r: slots (r + 1 + o) % NR
#pragma unroll
              for (int o = 0; o < NR; ++o) {
                const int sl = (r + 1 + o) % NR;
                w1[o] = wsh[sl * kBxN * XC + col];
                w2[o] = wsh[(NR + sl) * kBxN * XC + col];
              }
              v = band<P>(wkz, w1, 1) + band<P>(wmz, w2, 1);
            }
          }
          out[((long long)gz * NT + (long long)iy * b + by) * g.X + x0 + x] =
              v;
        }
      }
    }
  };
  // v12's passes: the segment's halo'd rows, 8 a pass, each pass's bands
  // after its x stage (x_stage(z0): the pass whose first halo'd z row is
  // z0), before the next pass's loads land on ax, gx
  auto band_passes = [&](auto x_stage) {
    for (int j = 0; j * ZC < zend - zs + 2 * P; ++j) {
      load_ztab(j);
      x_stage(zs + j * ZC);
      YRows wmy, wky;
      load_yrows(wmy, wky);
      // a row at a time: the eight rows' code unrolled beside the x stage's
      // pressed it into spills (ring_sweep bzb_rows_unrolled)
#pragma unroll 1
      for (int zr = 0; zr < ZC; ++zr) band_row(j, zr, wmy, wky);
      __syncthreads();  // ax, gx and the z rows read: the next pass's loads
                        // may land
    }
  };
  if constexpr (F64) {
    using FA = typename LabFrag<XP>::FA;
    using FC = typename LabFrag<XP>::FC;
    using FB = wmma::fragment<wmma::matrix_b, T::M, T::N, T::K, double,
                              wmma::col_major>;
    constexpr int NJOB = ROWS / T::M * 2;  // 8-row tiles by [Mx | Kx]
    constexpr int NJ = kHopHost ? NJOB : (NJOB + kBxWarps - 1) / kBxWarps;
    const int nwarps = solo ? 1 : nthr / 32;
    double* tab = reinterpret_cast<double*>(smem_raw + pl.idx);
    for (int i = tid; i < T::M * T::N; i += nthr) tab[i] = i;
    __syncthreads();
    FC idx;  // each element's index r 8 + c
#ifdef __CUDA_ARCH__
    wmma::load_matrix_sync(idx, tab, T::N, wmma::mem_row_major);
#else
    for (int e = 0; e < idx.num_elements; ++e) idx.x[e] = e;
#endif
    auto each = [&](const FC& acc, auto f) {
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e) {
        const int rc = (int)idx.x[e];
        f(rc / T::N, rc % T::N, e);
      }
    };
    // the x stage of the pass whose first halo'd z row is z0: ax and gx
    // whole in AX, GX
    auto x_stage = [&](int z0) {
      FC acc[NJ];
      for (int kc = 0; kc < S - 1; ++kc) load(z0, kc);
      for (int kc = 0; kc < nkc; ++kc) {
        lab_cp_wait_but<S - 2>();
        __syncthreads();
        load(z0, kc + S - 1);  // the slot chunk kc - 1 was multiplied from
        const unsigned char* st = ring + (kc % S) * pl.stage;
        const double* A = reinterpret_cast<const double*>(st);
        const double* Bx = reinterpret_cast<const double*>(st + pl.a);
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
          const int job = warp + i * nwarps, mt = job / 2, nt = job % 2;
          if (job >= NJOB) continue;
          if (kc == 0) wmma::fill_fragment(acc[i], 0.0);
#pragma unroll
          for (int kk = 0; kk < KC; kk += T::K) {
            FA fa;
            FB fb;
            wmma::load_matrix_sync(fa, A + mt * T::M * KC + kk, KC);
            wmma::load_matrix_sync(fb, Bx + nt * T::N * KC + kk, KC);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
      __syncthreads();  // the ring is free: ax, gx lie over it
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int job = warp + i * nwarps, mt = job / 2, nt = job % 2;
        if (job >= NJOB) continue;
        each(acc[i], [&](int r, int c, int e) {
          const int m = mt * T::M + r;
          (nt ? GX : AX)[ZB ? m * XS + c : (m / LP * XC + c) * AS + m % LP] =
              acc[i].x[e];
        });
      }
      __syncthreads();  // ax, gx whole
    };
    const double* By = reinterpret_cast<const double*>(B);
    if constexpr (ZB) {
      band_passes(x_stage);
    } else if constexpr (!Z) {
      for (int j = 0; j < npass; ++j) {
        const int zc = j * ZC;
        x_stage(t0 * b + zc);
        BxDmma<P>::y_products(
            AX, GX, By, warp, [&](int w, const FC* a1, const FC* a2) {
#pragma unroll
              for (int jn = 0; jn < BxDmma<P>::NB; ++jn)
                each(a1[jn], [&](int r, int c, int e) {
                  const int m = w * T::M + r, zl = zc + m / XC, x = m % XC;
                  const int by = jn * T::N + c;
                  if (zl < b && by < b && x0 + x < g.X)
                    out[out_at(t0, zl, by, x)] = a1[jn].x[e] + a2[jn].x[e];
                });
            });
        __syncthreads();  // ax, gx read: the ring's next loads may land
      }
    } else {
      using D = BxDmma<P>;
      D zd;
      for (int t = t0; t < tn; ++t) {
        const double* Bz = reinterpret_cast<const double*>(z_side(t));
        for (int j = 0; j < npass; ++j) {
          if (t == t0 || j > 0) {  // else T1/T2 hold it: tile t - 1's last
            if (j == (t > t0)) next_z(t);
            x_stage(t * b + j * ZC);
            D::y_products(AX, GX, By, warp,
                          [&](int w, const FC* a1, const FC* a2) {
#pragma unroll
                            for (int jn = 0; jn < D::NB; ++jn)
                              for (int h = 0; h < 2; ++h)
                                each(h ? a2[jn] : a1[jn],
                                     [&](int r, int c, int e) {
                                       const int m = w * T::M + r;
                                       (h ? T2 : T1)[((jn * T::N + c) * XC +
                                                      m % XC) * kBxZS +
                                                     m / XC] =
                                           (h ? a2[jn] : a1[jn]).x[e];
                                     });
                          });
            __syncthreads();  // t1, t2 whole; ax, gx read
          }
          if (j == 0) zd.zero();
          zd.z_issue(T1, T2, Bz, j, warp);
          if (j == npass - 1) {
            for (int w = kHopHost ? 0 : warp;
                 w < (kHopHost ? kBxWarps : warp + 1); ++w) {
              const FC* d = zd.z + (kHopHost ? w * D::ZT * D::NB : 0);
#pragma unroll
              for (int i = 0; i < D::ZT; ++i)
#pragma unroll
                for (int jn = 0; jn < D::NB; ++jn)
                  each(d[i * D::NB + jn], [&](int r, int c, int e) {
                    const int m = (w + i * kBxWarps) * T::M + r;
                    const int by = m / XC, x = m % XC, bz = jn * T::N + c;
                    if (by < b && bz < b && x0 + x < g.X)
                      out[out_at(t, bz, by, x)] = d[i * D::NB + jn].x[e];
                  });
            }
          }
        }
      }
    }
  } else {
    constexpr int NMT = ROWS / kHopM, MAXT = 2, NWG = 2;
    constexpr int KS = KC / (BF ? 16 : 8);  // k steps a chunk
    constexpr int kFirst = kSplit ? 0 : 2;  // the first part's index
    constexpr int NA = NXB * MAXT;          // accumulators of a warpgroup
    static_assert(NMT <= NWG * MAXT, "two tiles a warpgroup");
    const int w = warp % 4;
    HopAcc acc[kHopHost ? NWG * NA : NA];
    HopA big[MAXT][KS], small[MAXT][KS];
    // chunk `st`'s products of warpgroup wg (the first chunk's overwrite
    // the accumulators): its 64-row tiles of the pass, wg, wg + 2, ..., a
    // count known at compile time (bxy_tiles), so no wgmma waits on a
    // run-time condition
    auto mma = [&](auto wg, const unsigned char* st, HopAcc* d,
                   bool first) {
      constexpr int NTW = bxy_tiles<NMT, NWG, decltype(wg)>();
      const float* A = reinterpret_cast<const float*>(st);
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          hop_load_a<BF>(big[i][ks], small[i][ks], kSplit,
                         A + (bxy_wg(wg) + i * NWG) * kHopM * KC, a_at, ks,
                         w, lane);
      hop_wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int part = kFirst; part < 3; ++part)
#pragma unroll
          for (int jx = 0; jx < NXB; ++jx)
#pragma unroll
            for (int i = 0; i < NTW; ++i)
              hop_wgmma<BF>(d[jx * MAXT + i],
                            part == 0 ? small[i][ks] : big[i][ks],
                            st + pl.a + (jx * NP + (part == 1)) * pl.b_part,
                            ks, kbytes, !first || ks > 0 || part > kFirst);
      hop_wgmma_commit();
    };
    // warpgroup wg's operand registers stay the compiler's until here
    auto keep = [&](auto wg) {
      constexpr int NTW = bxy_tiles<NMT, NWG, decltype(wg)>();
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          hop_keep(big[i][ks]);
          if constexpr (kSplit) hop_keep(small[i][ks]);
        }
    };
    // f(wg) for this thread's warpgroup (the host thread: both), its index
    // warp-uniform as ptxas can see
    auto each_wg = [&](auto f) {
      if constexpr (kHopHost) {
        for (int wg = 0; wg < NWG; ++wg) f(wg);
      } else {
        f(hop_uniform(tid / 128));
      }
    };
    // the x stage's: where the warpgroups' tile counts differ (a pass of
    // 3 tiles, LP = 24) the index an integral_constant, each warpgroup its
    // own code (at LP = 32 one code for both, as two copies spill in
    // bf16x3)
    auto each_wgx = [&](auto f) {
      using W0 = std::integral_constant<int, 0>;
      using W1 = std::integral_constant<int, 1>;
      if constexpr (NMT % NWG == 0) {
        each_wg(f);
      } else if constexpr (kHopHost) {
        f(W0{});
        f(W1{});
      } else if (hop_uniform(tid / 128) == 0) {
        f(W0{});
      } else {
        f(W1{});
      }
    };
    // the x stage of the pass whose first halo'd z row is z0: ax and gx
    // whole in AX, GX
    auto x_stage = [&](int z0) {
      for (int kc = 0; kc < S - 2; ++kc) load(z0, kc);
      for (int kc = 0; kc < nkc; ++kc) {
        lab_cp_wait_but<S - 3>();
        hop_fence_async();  // the copies are read by wgmma's async proxy
        __syncthreads();
        load(z0, kc + S - 2);  // the slot chunk kc - 2 was multiplied from
        hop_wgmma_wait<0>();   // chunk kc - 1: its operand registers free
        if constexpr (NMT % NWG == 0) keep(0);
        const unsigned char* st = ring + (kc % S) * pl.stage;
        each_wgx([&](auto wg) {
          if constexpr (NMT % NWG != 0) keep(wg);
          mma(wg, st, acc + (kHopHost ? bxy_wg(wg) * NA : 0), kc == 0);
        });
      }
      hop_wgmma_wait<0>();
      each_wgx([&](auto wg) { keep(wg); });
      __syncthreads();  // the ring is free: ax, gx lie over it
      each_wg([&](int wg) {
#pragma unroll
        for (int ji = 0; ji < NA; ++ji) {
          const int jx = ji / MAXT, mt = wg + ji % MAXT * NWG;
          if (mt >= NMT) continue;
          if constexpr (ZB) {
            hop_acc_pairs(acc[(kHopHost ? wg * NA : 0) + ji], w, lane,
                          [&](int r, int c, float v0, float v1) {
                            bzb_put2((c < 16 ? AX : GX) +
                                         (mt * kHopM + r) * XS + jx * 16 +
                                         c % 16,
                                     v0, v1);
                          });
          } else {
            hop_acc_each(acc[(kHopHost ? wg * NA : 0) + ji], w, lane,
                         [&](int r, int c, float v) {
                           const int m = mt * kHopM + r;
                           const int x = jx * 16 + c % 16;
                           (c < 16 ? AX : GX)[(m / LP * XC + x) * AS +
                                              m % LP] = v;
                         });
          }
        }
      });
      __syncthreads();  // ax, gx whole
    };
    if constexpr (ZB) {
      band_passes(x_stage);
    } else if constexpr (!Z) {
      for (int j = 0; j < npass; ++j) {
        const int zc = j * ZC;
        x_stage(t0 * b + zc);
        each_wg([&](int wg) {
          BxWgmma<P, XP>::y_products(
              AX, GX, B, wg, w, lane,
              [&](int mt, const HopAccN<2 * kBxN>& a1,
                  const HopAccN<kBxN>& a2) {
                bxy_sum_each<kBxN>(a1, a2, w, lane, [&](int r, int c,
                                                        float v) {
                  const int m = mt * kHopM + r, zl = zc + m / XC, x = m % XC;
                  if (zl < b && c < b && x0 + x < g.X)
                    out[out_at(t0, zl, c, x)] = v;
                });
              });
        });
        __syncthreads();  // ax, gx read: the ring's next loads may land
      }
    } else {
      BxWgmma<P, XP> zw;
      for (int t = t0; t < tn; ++t) {
        const unsigned char* Bz = z_side(t);
        for (int j = 0; j < npass; ++j) {
          if (t == t0 || j > 0) {  // else T1/T2 hold it: tile t - 1's last
            if (j == (t > t0)) next_z(t);
            zw.retire();  // the last pass's z products: T1/T2 may be written
            x_stage(t * b + j * ZC);
            each_wg([&](int wg) { zw.y(AX, GX, B, T1, T2, wg, w, lane); });
            __syncthreads();  // t1, t2 whole; ax, gx read
          }
          each_wg([&](int wg) { zw.z_issue(T1, T2, Bz, j, wg, w, lane); });
          if (j == npass - 1) {
            zw.retire();
            each_wg([&](int wg) {
              zw.store(wg, w, lane, [&](int by, int x, int bz, float v) {
                if (by < b && bz < b && x0 + x < g.X)
                  out[out_at(t, bz, by, x)] = v;
              });
            });
          }
        }
      }
    }
  }
}

// vxy on the ring: grid (ceil(X / XC), nt, nt), two blocks an SM.
template <int P, int XP>
__global__ void __launch_bounds__(kBxyThreads, 2)
l2_bxy_kernel(const typename LabMma<XP>::C* __restrict__ u,
              typename LabMma<XP>::C* __restrict__ out,
              const typename LabMma<XP>::E* __restrict__ xb, long long xb_part,
              const unsigned char* __restrict__ bop, BxGeo g) {
  l2_bxy_body<P, XP, kBxyVxy>(u, out, xb, xb_part, bop, nullptr, g, 1);
}

// v2 on the ring: grid (ceil(X / XC), nt, ceil(nt / seg)), a segment of seg
// z tiles a block (seg > 1 only where b % 8 == 0 and 2P <= 8).
template <int P, int XP>
__global__ void __launch_bounds__(kBxyThreads, kBxyzBlocks)
l2_bxyz_kernel(const typename LabMma<XP>::C* __restrict__ u,
               typename LabMma<XP>::C* __restrict__ out,
               const typename LabMma<XP>::E* __restrict__ xb,
               long long xb_part, const unsigned char* __restrict__ bop,
               BxGeo g, int seg) {
  l2_bxy_body<P, XP, kBxyV2>(u, out, xb, xb_part, bop, nullptr, g, seg);
}

// v12 on the ring: grid (ceil(X / XC), nt, ceil(nt / seg)), a segment of
// seg z tiles a block (any seg).
template <int P, int XP>
__global__ void __launch_bounds__(kBxyThreads, kBxyzbBlocks)
l2_bxyzb_kernel(const typename LabMma<XP>::C* __restrict__ u,
                typename LabMma<XP>::C* __restrict__ out,
                const typename LabMma<XP>::E* __restrict__ xb,
                long long xb_part,
                const typename LabMma<XP>::C* __restrict__ tables, BxGeo g,
                int seg) {
  l2_bxy_body<P, XP, kBxyV12>(u, out, xb, xb_part, nullptr, tables, g, seg);
}

}  // namespace tpufem
