// The K2 kernel lab's x-first half (L2a) on Hopper: one routine for the
// schedules that contract x first, then y, then z.  Device code; the host
// launcher with its plain C interface is lab_separable.cu.
//
// Replaces the Pallas lab kernels of scripts/kernel_lab.py (LabKernel,
// call at :1592):
//   v2, v6  _kernel_v2 (:47), _kernel_v6 (:106)   dense x, y, z
//   v8      _kernel_v8 (:132)   the same with the y/z intermediates staged
//                               transposed (the slice is the B operand)
//   v9      _kernel_v9 (:212)   v2 with every product in bf16x3
//   v3      _kernel_v3 (:78)    band x, dense y and z
//   v12     _kernel_v12 (:237)  dense x, band y and z
//   vx      _kernel_vx (:164)   the x stage alone (cut after x)
//   vxy     _kernel_vxy (:177)  x and y (cut after y)
// v6 computes v2's function with v2's stages; on the TPU the two differ
// only in how Mosaic lays the contractions onto (8, 128) tiles, which has
// no counterpart here, so v6 runs v2's kernel.
//
// The operator is K2's, A = Kz(x)My(x)Mx + Mz(x)Ky(x)Mx + Mz(x)My(x)Kx.
// Layout in: (size, size, X), size = nt b + 2P, data at [P:P+npts,
// P:P+npts, 0:npts], zeros elsewhere; X = npts rounded up to 16.  Layout
// out: (nt b, nt b, X), data at [0:npts, 0:npts, 0:npts]; each block
// writes its whole (b, b, kL2XC) box, the zeros around the data included.
// vx writes ((Mx+Kx)_x u) shifted by P rows in z and y, vxy ((My+Ky)(x)Mx
// + My(x)Kx) u shifted by P rows in z: what the Pallas ablations compute.
//
// One block per output box (b, b, kL2XC) of tile (iz, iy) and x chunk:
//   x   ax, gx = u Mx^T, u Kx^T over the tile's halo'd (L, L) rows, L = b +
//       2P, in passes of kL2ZC z rows (l2_xring, below).  Band (v3): K2's
//       difference form on CUDA cores.
//   y   t1 = My ax, t2 = Ky ax + My gx per z row.  Dense: the tile's slice
//       (b, L) of My/Ky (a host table, rows and columns zero-padded to MB =
//       b rounded up to 16 and LP = L rounded up to 16) times ax, WMMA from
//       shared memory.  Band (v12): K2's difference form.
//   z   out = Kz t1 + Mz t2 over all L rows of t, after the last pass.
// The TPU kernel kept the whole halo'd slab (L, L, X), 1.1 MB at b = 24, P
// = 4, in VMEM; a block has 227 KB, so a block owns kL2XC x columns of its
// tile's output and reads the tile's L^2 rows over all of X for them: a
// read amplification of X / kL2XC over the slab, from L2.
//
// The dense x stage (vx; the x stage of v2, v6, v8, v9, v12, vxy).  What
// bounded the first version (vx 6.08 ms against 0.34 ms of one torch.matmul
// of its shape): every warp job re-read its B fragments from L2 at every k
// step and split them again, staged its own 16 x 16 piece of u by scalar
// loads with two warp barriers a step and nothing in flight, and the block
// held 131 KB of t it never touched, so one 8-warp block ran on an SM.  What
// l2_xring does about each:
//   smem   l2_smem counts what the variant's flags run: no t for vx, no
//          per-warp staging.  vx has its own kernel (l2_x_kernel: no band
//          table, so no P; 128 registers), two blocks an SM, and with no t
//          to hold it owns two x blocks: a u row it loads serves 64 columns
//          of [Mx | Kx], which halves the re-read of u (17x to 9x).
//   ring   a pass's A operand (its kL2ZC LP halo'd rows of u, K columns k0 ..
//          k0 + KC) and the block's B operand (rows x0 .. x0 + 15 of Mx and
//          of Kx, the same K columns: K-major as the matrices are stored, no
//          transposition) travel together through a ring of kL2Stages
//          stages, cp.async 16 bytes a thread, block-wide, one block barrier
//          a chunk: B is read from shared memory in the k loop, once per
//          block and pass, and the loads of two chunks are in flight while
//          one is multiplied and the one before it finishes.  Rows beyond L
//          are zeros.
//   split  B is split on the host (3xTF32: big and small made with the
//          kernel's own rounding; bf16: hi and lo), A in registers, once, for
//          both the Mx and the Kx half: the 32 columns of [Mx | Kx] are one N.
//   wgmma  each of the block's two warpgroups multiplies 64-row tiles of the
//          pass, m64n32k8 in TF32 and m64n32k16 in bf16, A from registers, B
//          through a descriptor (hopper.cuh); the three 3xTF32 products keep
//          their order (small*big, big*small, big*big).  f64 has no wgmma:
//          DMMA m8n8k4 (WMMA) on the same ring.
// The ring shares its shared memory with ax and gx, which are written once
// the pass's last chunk has been multiplied.  The first version's x stage
// stays as an ablation (flag kL2XJobs: per-warp jobs, B from L2) so the share
// of the gain that shared memory sized by the flags alone brings can be
// measured beside the ring.
//
// Precision (lab_mma.cuh): every dense stage in XP (3xTF32, 1xTF32, bf16x3,
// f64 DMMA, or one bf16 product), f32 (f64) sums; band stages in C.  A
// dense stage has no row-sum slot, so it cannot take the difference form
// of the band stages (common.cuh): on a smooth input its error exceeds K2's.
//
// What bounds it on an H100: the function is K2's, each DoF read and
// written once, 0.0405 ms at 16,974,593 DoFs in f32.  The design adds the
// dense products over padded rows: at the flagship (b = 24, nt = 11, X =
// 272, L = LP = 32, MB = 32) the x stage is 2 nt^2 L LP X X 2 = 36.7 GFLOP
// a pass, y 3 nt^2 L MB LP X 2 = 6.4, z 2 nt^2 MB LP MB X 2 = 4.3 (with the
// padding), so 3xTF32 needs at least 0.29 ms of tensor-core time: 7x the
// function's bound before any traffic; and u is read X / kL2XC = 17 times
// through L2 (1.7 GB an apply for vx, 2.3 GB for v2), B once per pass (a
// quarter of that again).
#pragma once

#include "common.cuh"
#include "hopper.cuh"
#include "lab_mma.cuh"

namespace tpufem {

constexpr int kL2Threads = 256;
constexpr int kL2XC = 16;  // x columns of a block's output box
constexpr int kL2ZC = 8;   // halo'd z rows per x/y pass
constexpr int kL2Job = 16;  // rows of one warp job; its u staging is 16 x 16

constexpr int kL2Stages = 4;  // stages of the x stage's ring
constexpr int kL2MaxLP = 32;  // the ring's accumulators cover LP / 16 <= 2 tiles

// flags: the stage kinds of a variant; (flags >> 3) & 3 cuts the schedule
// after x (1: vx) or after y (2: vxy); kL2XJobs: the dense x stage by
// per-warp jobs with B from device memory (the first version, an ablation)
enum L2Flags { kL2XBand = 1, kL2YZBand = 2, kL2Trans = 4, kL2XJobs = 32 };

struct L2Geo {
  int npts, b, nt, size, X, L, LP, MB;
};

__host__ __device__ inline int l2_round16(int v) { return (v + 15) / 16 * 16; }

// The ring of the dense x stage: K columns a stage (64 bytes of a u row),
// the parts of the B operand (big and small, or hi and lo, where the
// product is split), and a stage's bytes: the A operand (kL2ZC LP rows),
// then, for each of the block's x blocks, each part of B (2 kL2XC columns).
__host__ __device__ constexpr int l2_kc(int xp) { return xp == kXF64 ? 8 : 16; }
__host__ __device__ constexpr int l2_parts(int xp) {
  return xp == kX3TF32 || xp == kXBF16x3 ? 2 : 1;
}
struct L2Ring {
  long long a, b_part, stage;
};
// x blocks of kL2XC columns a block of the variant owns: vx, which holds no
// t, takes two, so each u row it loads serves 64 columns of [Mx | Kx]
__host__ __device__ constexpr int l2_nxb(int flags) {
  return ((flags >> 3) & 3) == 1 && !(flags & (kL2XBand | kL2XJobs)) ? 2 : 1;
}
__host__ __device__ inline L2Ring l2_ring(int xp, int LP, int nxb) {
  const long long c = xp == kXF64 ? 8 : 4;
  const long long e = xp == kXBF16x3 || xp == kXBF16 ? 2 : c;
  L2Ring r;
  r.a = lab_align(kL2ZC * LP * l2_kc(xp) * c);
  r.b_part = lab_align(2 * kL2XC * l2_kc(xp) * e);
  r.stage = r.a + nxb * l2_parts(xp) * r.b_part;
  return r;
}

// Byte offsets of a block's shared-memory regions, each 128-byte aligned,
// sized by what the variant's flags run:
//   ax     ax then gx, (kL2ZC, LP, kL2XC) each (v8: (kL2ZC, kL2XC, LP)), for
//          each of the block's x blocks; the dense x stage's ring lies over it
//   t      t1 then t2, (LP, MB, kL2XC) each (v8: (kL2XC, MB, LP)); none for
//          vx
//   stage  kL2XJobs: one 16 x 16 u tile per warp, in the operand format
//   scr    one WMMA accumulator tile per warp (none for vx on wgmma)
struct L2Smem {
  long long ax, t, stage, scr, total;
};

__host__ __device__ inline L2Smem l2_smem(int p, int xp, int b, int flags) {
  const long long c = xp == kXF64 ? 8 : 4;  // bytes per value, any format
  const long long mn = xp == kXF64 ? 8 * 8 : 16 * 16;  // accumulator tile
  const long long LP = l2_round16(b + 2 * p), MB = l2_round16(b);
  const long long nw = kL2Threads / 32;
  const int cut = (flags >> 3) & 3;
  const bool jobs = !(flags & kL2XBand) && (flags & kL2XJobs);
  const bool ring = !(flags & kL2XBand) && !jobs;
  const int nxb = l2_nxb(flags);
  long long first = nxb * 2 * kL2ZC * LP * kL2XC * c;
  if (ring && kL2Stages * l2_ring(xp, (int)LP, nxb).stage > first)
    first = kL2Stages * l2_ring(xp, (int)LP, nxb).stage;
  L2Smem s;
  s.ax = 0;
  s.t = lab_align(first);
  s.stage = s.t + (cut == 1 ? 0 : lab_align(2 * LP * MB * kL2XC * c));
  s.scr = s.stage + (jobs ? lab_align(nw * kL2Job * kL2Job * c) : 0);
  s.total = s.scr + (ring && cut == 1 && xp != kXF64 ? 0
                                                     : lab_align(nw * mn * c));
  return s;
}

// Store a warp's accumulator tile through its scratch: map(r, c, v) for
// each element (warp-wide; one host thread, nlanes 1, stands for the warp).
template <typename FC, typename C, typename Map>
__device__ __forceinline__ void l2_store(const FC& acc, C* sw, int ldn,
                                         int lane, int nlanes, int rows,
                                         Map map) {
  wmma::store_matrix_sync(sw, acc, ldn, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < rows * ldn; e += nlanes) map(e / ldn, e % ldn, sw[e]);
  __syncwarp();
}

// The dense x stage of one pass: ax, gx of the halo'd z rows [zc, zc + kL2ZC)
// of tile (iz, iy) for the block's NXB x blocks bx NXB, ... (kL2XC columns
// each; one past the last is the last again, and not stored), by the whole
// block (256 threads: two warpgroups).  xb: the B operand, (parts, X / kL2XC,
// 2 kL2XC, X): for each x block the rows x0 .. x0 + 15 of Mx, then of Kx, over
// all K (K-major), part q (big, small / hi, lo) xb_part elements on.  ring:
// kL2Stages stages of l2_ring.  put(j, half, zr, yl, xo, v) takes the results
// of x block bx NXB + j (half 0: ax, 1: gx) after the last chunk, when the
// ring is free.  One host thread stands for both warpgroups (f64: for the
// eight warps).
template <int XP, int NXB, typename Put>
__device__ void l2_xring(const typename LabMma<XP>::C* __restrict__ u,
                         const typename LabMma<XP>::E* __restrict__ xb,
                         long long xb_part, const L2Geo& g, int iz, int iy,
                         int bx, int zc, int zend, unsigned char* ring,
                         typename LabMma<XP>::C* sw, Put put, int tid,
                         int nthr) {
  using T = LabMma<XP>;
  using C = typename T::C;
  using E = typename T::E;
  static_assert(2 * kL2XC == kHopN, "the block's [Mx | Kx] columns are one N");
  constexpr int KC = l2_kc(XP), NP = l2_parts(XP), S = kL2Stages;
  constexpr int CV = 16 / (int)sizeof(C), EV = 16 / (int)sizeof(E);
  constexpr int ACH = KC / CV, BCH = KC / EV;  // 16-byte pieces of a row
  constexpr int kbytes = KC * (int)sizeof(E);
  const int LP = g.LP, rows = kL2ZC * LP, nkc = g.X / KC;
  const L2Ring rg = l2_ring(XP, LP, NXB);
  const int nxblk = g.X / kL2XC;
  const bool solo = nthr < 64;
  const int warp = tid / 32, lane = tid % 32, nlanes = solo ? 1 : 32;
  // word offset of column k of row `row` of a stage's A operand: f32 rows of
  // 64 bytes with their 16-byte pieces permuted by the row, so the lanes of a
  // fragment load (8 rows x 4 columns) fall in 32 banks
  auto a_at = [](int row, int k) -> int {
    if constexpr (XP == kXF64) return row * KC + k;
    else return row * KC + ((((k >> 2) ^ (row >> 1)) & 3) << 2) + (k & 3);
  };
  auto load = [&](int kc) {
    if (kc < nkc) {
      unsigned char* st = ring + (kc % S) * rg.stage;
      C* A = reinterpret_cast<C*>(st);
      const C* src = u + ((long long)iz * g.b * g.size + (long long)iy * g.b) *
                             g.X + kc * KC;
      for (int zr = 0; zr < kL2ZC; ++zr)  // a z row: LP rows of ACH pieces
        for (int i = tid; i < LP * ACH; i += nthr) {
          const int yl = i / ACH, ch = i % ACH, zl = zc + zr;
          C* dst = A + a_at(zr * LP + yl, ch * CV);
          if (yl < g.L && zl < zend) {
            lab_cp16(dst, src + ((long long)zl * g.size + yl) * g.X + ch * CV);
          } else {
#pragma unroll
            for (int e = 0; e < CV; ++e) dst[e] = C(0);
          }
        }
      for (int i = tid; i < NXB * NP * kHopN * BCH; i += nthr) {
        const int ch = i % BCH, n = i / BCH % kHopN;
        const int jq = i / (BCH * kHopN), q = jq % NP;
        const int xblk = bx * NXB + jq / NP < nxblk ? bx * NXB + jq / NP
                                                    : nxblk - 1;
        const int off = XP == kXF64 ? (n * KC + ch * EV) * (int)sizeof(E)
                                    : hop_b_offset(n, ch * 16, kbytes);
        lab_cp16(st + rg.a + jq * rg.b_part + off,
                 xb + q * xb_part + ((long long)xblk * kHopN + n) * g.X +
                     kc * KC + ch * EV);
      }
    }
    lab_cp_commit();  // an empty group past the end keeps the count
  };
  if constexpr (XP == kXF64) {
    // DMMA: a warp job is one 8-row tile by one 8-column tile of [ax | gx]
    using FA = typename LabFrag<XP>::FA;
    using FC = typename LabFrag<XP>::FC;
    using FB = wmma::fragment<wmma::matrix_b, T::M, T::N, T::K, double,
                              wmma::col_major>;
    constexpr int NJ =
        NXB * (kHopHost ? kL2ZC * kL2MaxLP / 2 : kL2ZC * kL2MaxLP / 16);
    constexpr int NB = kHopN / T::N;  // column tiles of an x block
    const int nwarps = (nthr + 31) / 32, nn = NXB * NB;
    const int njobs = rows / T::M * nn;
    FC acc[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) wmma::fill_fragment(acc[i], C(0));
    for (int kc = 0; kc < S - 1; ++kc) load(kc);
    for (int kc = 0; kc < nkc; ++kc) {
      lab_cp_wait_but<S - 2>();
      __syncthreads();
      load(kc + S - 1);
      const unsigned char* st = ring + (kc % S) * rg.stage;
      const C* A = reinterpret_cast<const C*>(st);
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int job = warp + i * nwarps, mt = job / nn, jn = job % nn;
        if (job >= njobs || zc + mt * T::M / LP >= zend) continue;
#pragma unroll
        for (int kk = 0; kk < KC; kk += T::K) {
          FA fa;
          FB fb;
          wmma::load_matrix_sync(fa, A + mt * T::M * KC + kk, KC);
          wmma::load_matrix_sync(
              fb,
              reinterpret_cast<const C*>(st + rg.a + jn / NB * rg.b_part) +
                  jn % NB * T::N * KC + kk,
              KC);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
    __syncthreads();  // the ring is free: ax, gx lie over it
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int job = warp + i * nwarps, mt = job / nn, jn = job % nn;
      if (job >= njobs || zc + mt * T::M / LP >= zend) continue;
      l2_store(acc[i], sw, T::N, lane, nlanes, T::M, [&](int r, int c, C v) {
        const int m = mt * T::M + r, n = jn % NB * T::N + c;
        put(jn / NB, n / kL2XC, m / LP, m % LP, n % kL2XC, v);
      });
    }
  } else {
    // wgmma: warpgroup wg multiplies the 64-row tiles wg, wg + 2, ... of the
    // pass.  Nothing in the k loop depends on a run-time condition, so the
    // compiler keeps the wgmmas asynchronous: a tile the pass does not have
    // multiplies the last one again and is not stored.  The products of
    // chunk kc run while the block waits for chunk kc + 1 and starts the
    // loads of chunk kc + S - 2, into the slot of chunk kc - 2, whose
    // products every warp waited for before it came to the barrier.
    static_assert(S >= 4, "a slot is loaded two chunks after it is read");
    constexpr bool BF = T::kBF16;
    constexpr bool split = NP == 2;
    constexpr int KS = KC / (BF ? 16 : 8);  // k steps a chunk
    constexpr int MAXT = kL2MaxLP / 16, NWG = kL2Threads / 128;
    const int w = warp % 4, nmt = rows / kHopM;
    constexpr int NA = NXB * MAXT;  // accumulators of a warpgroup
    HopAcc acc[kHopHost ? NWG * NA : NA];
#pragma unroll
    for (int i = 0; i < (kHopHost ? NWG * NA : NA); ++i) hop_acc_zero(acc[i]);
    HopA big[MAXT][KS], small[MAXT][KS];
    auto mma = [&](int wg, const unsigned char* st, HopAcc* d) {
      const float* A = reinterpret_cast<const float*>(st);
      const unsigned char* B = st + rg.a;
#pragma unroll
      for (int i = 0; i < MAXT; ++i) {
        const int mt = wg + i * NWG < nmt ? wg + i * NWG : nmt - 1;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          hop_load_a<BF>(big[i][ks], small[i][ks], split, A + mt * kHopM * KC,
                         a_at, ks, w, lane);
      }
      hop_wgmma_fence();
      // the tiles' and x blocks' products in turn (small*big, big*small,
      // big*big each), so that a wgmma follows one it does not depend on
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int part = split ? 0 : 2; part < 3; ++part)
#pragma unroll
          for (int j = 0; j < NXB; ++j)
#pragma unroll
            for (int i = 0; i < MAXT; ++i)
              hop_wgmma<BF>(d[j * MAXT + i],
                            part == 0 ? small[i][ks] : big[i][ks],
                            B + (j * NP + (part == 1)) * rg.b_part, ks,
                            kbytes);
      hop_wgmma_commit();
    };
    for (int kc = 0; kc < S - 2; ++kc) load(kc);
    for (int kc = 0; kc < nkc; ++kc) {
      lab_cp_wait_but<S - 3>();
      hop_fence_async();  // the copies are read by wgmma's asynchronous proxy
      __syncthreads();
      load(kc + S - 2);     // the slot chunk kc - 2 was multiplied from
      hop_wgmma_wait<0>();  // chunk kc - 1: its operand registers are free
#pragma unroll
      for (int i = 0; i < MAXT; ++i)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          hop_keep(big[i][ks]);
          if constexpr (split) hop_keep(small[i][ks]);
        }
      const unsigned char* st = ring + (kc % S) * rg.stage;
      if constexpr (kHopHost) {
        for (int wg = 0; wg < NWG; ++wg) mma(wg, st, acc + wg * NA);
      } else {
        mma(tid / 128, st, acc);
      }
    }
    hop_wgmma_wait<0>();
    __syncthreads();  // the ring is free: ax, gx lie over it
    for (int wg = kHopHost ? 0 : tid / 128; wg < NWG;
         wg += kHopHost ? 1 : NWG)
#pragma unroll
      for (int ji = 0; ji < NA; ++ji) {
        const int mt = wg + ji % MAXT * NWG;
        if (mt >= nmt || zc + mt * kHopM / LP >= zend) continue;
        hop_acc_each(acc[kHopHost ? wg * NA + ji : ji], w, lane,
                     [&](int r, int c, float v) {
                       const int m = mt * kHopM + r;
                       put(ji / MAXT, c / kL2XC, m / LP, m % LP, c % kL2XC, v);
                     });
      }
  }
}

// The dense x stage of one pass as the first version ran it, an ablation of
// l2_xring: a warp job is 16 (z, y) rows by one MMA N of the block's columns
// [x0, x0 + kL2XC); it stages u 16 x 16 at a time from device memory into
// its `stage` (operand format: bf16 hi/lo) and reads [Mx^T | Kx^T] (xk, (X,
// 2X); bf16: lo part xk_lo elements on) from device memory at every k step.
// put(half, zr, yl, xo, v) takes the results; sw: the warp's scratch tile.
template <int XP, typename Put>
__device__ void l2_xjobs(const typename LabMma<XP>::C* __restrict__ u,
                         const typename LabMma<XP>::E* __restrict__ xk,
                         long long xk_lo, const L2Geo& g, int iz, int iy,
                         int x0, int zc, int zend, unsigned char* stage,
                         typename LabMma<XP>::C* sw, Put put, int warp,
                         int nwarps, int lane, int nlanes) {
  using T = LabMma<XP>;
  using C = typename T::C;
  using E = typename T::E;
  using FC = typename LabFrag<XP>::FC;
  constexpr int MT = kL2Job / T::M;  // MMA row tiles per warp job
  const int X = g.X, LP = g.LP;
  const long long st_split = T::kBF16 ? kL2Job * kL2Job : -1;
  const int nyj = LP / kL2Job, nn = kL2XC / T::N;
  for (int job = warp; job < kL2ZC * nyj * nn; job += nwarps) {
    const int jn = job % nn, yj = (job / nn) % nyj, zr = job / (nn * nyj);
    const int zl = zc + zr, yl0 = yj * kL2Job;
    if (zl >= zend) continue;
    FC acc[2][MT];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) wmma::fill_fragment(acc[h][mi], C(0));
    const C* rows = u + (((long long)iz * g.b + zl) * g.size +
                         (long long)iy * g.b + yl0) * X;
    for (int k0 = 0; k0 < X; k0 += kL2Job) {
      for (int e = lane; e < kL2Job * kL2Job; e += nlanes) {
        const int r = e / kL2Job, c = e % kL2Job;
        lab_put<C>(stage, st_split, e,
                   yl0 + r < g.L ? rows[(long long)r * X + k0 + c] : C(0));
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < kL2Job; kk += T::K)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const E* a =
              reinterpret_cast<const E*>(stage) + mi * T::M * kL2Job + kk;
          const E* bm = xk + (long long)(k0 + kk) * 2 * X + x0 + jn * T::N;
          lab_mma<XP>(acc[0][mi], a, st_split, kL2Job, bm, xk_lo, 2 * X);
          lab_mma<XP>(acc[1][mi], a, st_split, kL2Job, bm + X, xk_lo, 2 * X);
        }
      __syncwarp();
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        l2_store(acc[h][mi], sw, T::N, lane, nlanes, T::M,
                 [&](int r, int c, C v) {
                   put(h, zr, yl0 + mi * T::M + r, jn * T::N + c, v);
                 });
  }
}

// vx: the x stage alone, ax + gx of the tile's first b halo'd z and y rows.
// No t and no band table, so the kernel does not depend on P, and two of its
// blocks share an SM (128 registers a thread; f64's DMMA fragments need
// more).  On the ring a block owns two x blocks (grid ((X / kL2XC + 1) / 2,
// nt, nt)); with kL2XJobs, the first version's x stage, one (grid (X /
// kL2XC, nt, nt)).
template <int XP>
__global__ void __launch_bounds__(kL2Threads, XP == kXF64 ? 1 : 2)
l2_x_kernel(const typename LabMma<XP>::C* __restrict__ u,
            typename LabMma<XP>::C* __restrict__ out,
            const typename LabMma<XP>::E* __restrict__ xk, long long xk_lo,
            const typename LabMma<XP>::E* __restrict__ xb, long long xb_part,
            L2Geo g, int flags) {
  using C = typename LabMma<XP>::C;
  constexpr int XC = kL2XC, ZC = kL2ZC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, nwarps = (nthr + 31) / 32, lane = tid % 32;
  const int iy = blockIdx.y, iz = blockIdx.z, b = g.b, LP = g.LP;
  const int nxb = l2_nxb(flags);
  const long long NT = (long long)g.nt * b;
  const L2Smem sm = l2_smem((g.L - b) / 2, XP, b, flags);
  const long long nax = (long long)ZC * LP * XC;
  C* AX = reinterpret_cast<C*>(smem_raw + sm.ax);  // (nxb, 2, ZC, LP, XC)
  C* sw = reinterpret_cast<C*>(smem_raw + sm.scr) +
          warp * LabMma<XP>::M * LabMma<XP>::N;
  auto put = [&](int j, int h, int zr, int yl, int xo, C v) {
    AX[(j * 2 + h) * nax + ((long long)zr * LP + yl) * XC + xo] = v;
  };
  for (int zc = 0; zc < b; zc += ZC) {
    if (flags & kL2XJobs) {
      l2_xjobs<XP>(u, xk, xk_lo, g, iz, iy, blockIdx.x * XC, zc, b,
                   smem_raw + sm.stage +
                       warp * kL2Job * kL2Job * (long long)sizeof(C),
                   sw,
                   [&](int h, int zr, int yl, int xo, C v) {
                     put(0, h, zr, yl, xo, v);
                   },
                   warp, nwarps, lane, nthr < 32 ? nthr : 32);
    } else {
      l2_xring<XP, l2_nxb(1 << 3)>(u, xb, xb_part, g, iz, iy, blockIdx.x, zc,
                                   b, smem_raw, sw, put, tid, nthr);
    }
    __syncthreads();
    for (long long i = tid; i < (long long)nxb * ZC * b * XC; i += nthr) {
      const int xo = (int)(i % XC), r = (int)(i / XC), yl = r % b;
      const int zr = r / b % ZC, j = r / (b * ZC), zl = zc + zr;
      const int x0 = (blockIdx.x * nxb + j) * XC;
      if (zl >= b || x0 >= g.X) continue;
      const long long a = j * 2 * nax + ((long long)zr * LP + yl) * XC + xo;
      out[(((long long)iz * b + zl) * NT + (long long)iy * b + yl) * g.X + x0 +
          xo] = AX[a] + AX[a + nax];
    }
    __syncthreads();
  }
}

template <int P, int XP>
__global__ void __launch_bounds__(kL2Threads)
l2_kernel(const typename LabMma<XP>::C* __restrict__ u,
          typename LabMma<XP>::C* __restrict__ out,
          const typename LabMma<XP>::E* __restrict__ xk, long long xk_lo,
          const typename LabMma<XP>::E* __restrict__ xb, long long xb_part,
          const typename LabMma<XP>::E* __restrict__ sl, long long sl_lo,
          const typename LabMma<XP>::C* __restrict__ tab, L2Geo g, int flags) {
  using T = LabMma<XP>;
  using C = typename T::C;
  using E = typename T::E;
  using FC = typename LabFrag<XP>::FC;
  constexpr int NW = 2 * P + 2;  // a band table row: 2P+1 taps, row sum
  constexpr int MT = kL2Job / T::M;  // MMA row tiles per warp job
  constexpr int XC = kL2XC, ZC = kL2ZC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, nwarps = (nthr + 31) / 32, lane = tid % 32;
  const int nlanes = nthr < 32 ? nthr : 32;
  const int x0 = blockIdx.x * XC, iy = blockIdx.y, iz = blockIdx.z;
  const int b = g.b, L = g.L, LP = g.LP, MB = g.MB, X = g.X, nt = g.nt;
  const int npts = g.npts;
  const long long NT = (long long)nt * b;
  const bool xband = flags & kL2XBand, yzband = flags & kL2YZBand;
  const bool trans = flags & kL2Trans;
  const int cut = (flags >> 3) & 3;
  const L2Smem sm = l2_smem(P, XP, b, flags);
  // operand format (bf16 hi/lo) where a dense stage reads the buffer
  const long long nax = (long long)ZC * LP * XC, ntt = (long long)LP * MB * XC;
  const long long ax_split = T::kBF16 && !yzband && cut != 1 ? nax : -1;
  const long long t_split = T::kBF16 && !yzband && cut == 0 ? ntt : -1;
  const long long cb = sizeof(C);
  unsigned char* AX = smem_raw + sm.ax;
  unsigned char* GX = AX + nax * cb;
  unsigned char* T1 = smem_raw + sm.t;
  unsigned char* T2 = T1 + ntt * cb;
  unsigned char* stage = smem_raw + sm.stage + warp * kL2Job * kL2Job * cb;
  C* sw = reinterpret_cast<C*>(smem_raw + sm.scr) + warp * T::M * T::N;
  const C* tMx = tab;
  const C* tKx = tab + (long long)npts * NW;
  const C* tMy = tab + 2LL * npts * NW;
  const C* tKy = tab + 3LL * npts * NW;
  const C* tMz = tab + 4LL * npts * NW;
  const C* tKz = tab + 5LL * npts * NW;
  // dense slices (My, Ky, Mz, Kz) of tile t: (MB, LP), v8: (LP, MB)
  const long long sls = (long long)MB * LP;
  const E* sMy = sl + iy * sls;
  const E* sKy = sl + (nt + iy) * sls;
  const E* sMz = sl + (2LL * nt + iz) * sls;
  const E* sKz = sl + (3LL * nt + iz) * sls;
  auto ax_at = [&](int zr, int yl, int xo) -> long long {
    return trans ? ((long long)zr * XC + xo) * LP + yl
                 : ((long long)zr * LP + yl) * XC + xo;
  };
  auto t_at = [&](int zl, int by, int xo) -> long long {
    return trans ? ((long long)xo * MB + by) * LP + zl
                 : ((long long)zl * MB + by) * XC + xo;
  };
  auto out_at = [&](int bz, int by, int xo) -> long long {
    return (((long long)iz * b + bz) * NT + (long long)iy * b + by) * X + x0 +
           xo;
  };

  // rows L..LP-1 of t (read by a dense z stage) hold zeros
  if (!yzband && cut == 0)
    for (long long i = tid; i < (long long)(LP - L) * MB * XC; i += nthr) {
      const int xo = (int)(i % XC), r = (int)(i / XC), by = r % MB;
      const int zl = L + r / MB;
      lab_put<C>(T1, t_split, t_at(zl, by, xo), C(0));
      lab_put<C>(T2, t_split, t_at(zl, by, xo), C(0));
    }
  const int zend = cut ? b : L;  // the halo'd z rows the schedule needs
  for (int zc = 0; zc < zend; zc += ZC) {
    // ---- x stage: ax, gx of z rows [zc, zc + ZC) -----------------------
    if (xband) {
      for (long long i = tid; i < nax; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), yl = r % LP;
        const int zr = r / LP, zl = zc + zr, xg = x0 + xo;
        if (zl >= zend) continue;
        C am = C(0), ak = C(0);
        if (yl < L && xg < npts) {
          const C* row = u + (((long long)iz * b + zl) * g.size +
                              (long long)iy * b + yl) * X;
          C v[2 * P + 1];
#pragma unroll
          for (int o = 0; o <= 2 * P; ++o) {
            const int xi = xg + o - P;
            v[o] = xi >= 0 && xi < X ? row[xi] : C(0);
          }
          am = band<P>(tMx + (long long)xg * NW, v, 1);
          ak = band<P>(tKx + (long long)xg * NW, v, 1);
        }
        lab_put<C>(AX, ax_split, ax_at(zr, yl, xo), am);
        lab_put<C>(GX, ax_split, ax_at(zr, yl, xo), ak);
      }
    } else if (!(flags & kL2XJobs)) {
      l2_xring<XP, 1>(u, xb, xb_part, g, iz, iy, blockIdx.x, zc, zend, AX, sw,
                      [&](int, int h, int zr, int yl, int xo, C v) {
                        lab_put<C>(h ? GX : AX, ax_split, ax_at(zr, yl, xo), v);
                      },
                      tid, nthr);
    } else {  // the first version: per-warp jobs, B from device memory
      l2_xjobs<XP>(u, xk, xk_lo, g, iz, iy, x0, zc, zend, stage, sw,
                   [&](int h, int zr, int yl, int xo, C v) {
                     lab_put<C>(h ? GX : AX, ax_split, ax_at(zr, yl, xo), v);
                   },
                   warp, nwarps, lane, nlanes);
    }
    __syncthreads();
    if (cut == 1) {  // vx: (ax + gx) of the tile's first b halo'd rows
      for (long long i = tid; i < (long long)ZC * b * XC; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), yl = r % b;
        const int zr = r / b, zl = zc + zr;
        if (zl >= b) continue;
        out[out_at(zl, yl, xo)] = lab_get<C>(AX, ax_split, ax_at(zr, yl, xo)) +
                                  lab_get<C>(GX, ax_split, ax_at(zr, yl, xo));
      }
      __syncthreads();
      continue;
    }
    // ---- y stage: t1 = My ax, t2 = Ky ax + My gx, z rows [zc, zc + ZC) --
    if (yzband) {
      for (long long i = tid; i < (long long)ZC * b * XC; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), by = r % b;
        const int zr = r / b, zl = zc + zr, gy = iy * b + by;
        if (zl >= zend) continue;
        C t1 = C(0), t2 = C(0);
        if (gy < npts) {
          const C* a = reinterpret_cast<const C*>(AX) + ax_at(zr, by, xo);
          const C* gg = reinterpret_cast<const C*>(GX) + ax_at(zr, by, xo);
          t1 = band<P>(tMy + (long long)gy * NW, a, XC);
          t2 = band<P>(tKy + (long long)gy * NW, a, XC) +
               band<P>(tMy + (long long)gy * NW, gg, XC);
        }
        lab_put<C>(T1, t_split, t_at(zl, by, xo), t1);
        lab_put<C>(T2, t_split, t_at(zl, by, xo), t2);
      }
    } else {
      // v2: rows by (the slice's), columns xo; v8: rows xo, columns by
      const int nrj = (trans ? XC : MB) / kL2Job;
      const int nn = (trans ? MB : XC) / T::N;
      for (int job = warp; job < ZC * nrj * nn; job += nwarps) {
        const int jn = job % nn, rj = (job / nn) % nrj, zr = job / (nn * nrj);
        const int zl = zc + zr, r0 = rj * kL2Job, n0 = jn * T::N;
        if (zl >= zend) continue;
        FC acc[2][MT];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) wmma::fill_fragment(acc[h][mi], C(0));
        const E* eax = reinterpret_cast<const E*>(AX);
        const E* egx = reinterpret_cast<const E*>(GX);
        for (int kk = 0; kk < LP; kk += T::K)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const int m0 = r0 + mi * T::M;
            if (trans) {  // (xo, yl) @ (yl, by)
              const long long ao = ((long long)zr * XC + m0) * LP + kk;
              const long long bo = (long long)kk * MB + n0;
              lab_mma<XP>(acc[0][mi], eax + ao, ax_split, LP, sMy + bo, sl_lo,
                          MB);
              lab_mma<XP>(acc[1][mi], eax + ao, ax_split, LP, sKy + bo, sl_lo,
                          MB);
              lab_mma<XP>(acc[1][mi], egx + ao, ax_split, LP, sMy + bo, sl_lo,
                          MB);
            } else {  // (by, yl) @ (yl, xo)
              const long long ao = (long long)m0 * LP + kk;
              const long long bo = ((long long)zr * LP + kk) * XC + n0;
              lab_mma<XP>(acc[0][mi], sMy + ao, sl_lo, LP, eax + bo, ax_split,
                          XC);
              lab_mma<XP>(acc[1][mi], sKy + ao, sl_lo, LP, eax + bo, ax_split,
                          XC);
              lab_mma<XP>(acc[1][mi], sMy + ao, sl_lo, LP, egx + bo, ax_split,
                          XC);
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            l2_store(acc[h][mi], sw, T::N, lane, nlanes, T::M,
                     [&](int r, int c, C v) {
                       const int m = r0 + mi * T::M + r, n = n0 + c;
                       lab_put<C>(h ? T2 : T1, t_split,
                                  trans ? t_at(zl, n, m) : t_at(zl, m, n), v);
                     });
      }
    }
    __syncthreads();
    if (cut == 2) {  // vxy: t1 + t2 of the tile's first b halo'd rows
      for (long long i = tid; i < (long long)ZC * b * XC; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), by = r % b;
        const int zl = zc + r / b;
        if (zl >= b) continue;
        out[out_at(zl, by, xo)] = lab_get<C>(T1, t_split, t_at(zl, by, xo)) +
                                  lab_get<C>(T2, t_split, t_at(zl, by, xo));
      }
    }
  }
  if (cut) return;
  // ---- z stage: out = Kz t1 + Mz t2 over all L rows of t -----------------
  if (yzband) {
    for (long long i = tid; i < (long long)b * b * XC; i += nthr) {
      const int xo = (int)(i % XC), r = (int)(i / XC), by = r % b;
      const int bz = r / b, gz = iz * b + bz;
      C v = C(0);
      if (gz < npts) {
        const long long o = t_at(bz, by, xo), s = (long long)MB * XC;
        v = band<P>(tKz + (long long)gz * NW,
                    reinterpret_cast<const C*>(T1) + o, s) +
            band<P>(tMz + (long long)gz * NW,
                    reinterpret_cast<const C*>(T2) + o, s);
      }
      out[out_at(bz, by, xo)] = v;
    }
    return;
  }
  // v2: rows bz, columns (by, xo); v8: rows (xo, by), columns bz
  const int nrj = (trans ? XC * MB : MB) / kL2Job;
  const int nn = (trans ? MB : MB * XC) / T::N;
  const E* et1 = reinterpret_cast<const E*>(T1);
  const E* et2 = reinterpret_cast<const E*>(T2);
  for (int job = warp; job < nrj * nn; job += nwarps) {
    const int jn = job % nn, r0 = (job / nn) * kL2Job, n0 = jn * T::N;
    FC acc[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) wmma::fill_fragment(acc[mi], C(0));
    for (int kk = 0; kk < LP; kk += T::K)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int m0 = r0 + mi * T::M;
        if (trans) {  // (xo by, zl) @ (zl, bz)
          const long long ao = (long long)m0 * LP + kk;
          const long long bo = (long long)kk * MB + n0;
          lab_mma<XP>(acc[mi], et1 + ao, t_split, LP, sKz + bo, sl_lo, MB);
          lab_mma<XP>(acc[mi], et2 + ao, t_split, LP, sMz + bo, sl_lo, MB);
        } else {  // (bz, zl) @ (zl, by xo)
          const long long ao = (long long)m0 * LP + kk;
          const long long bo = (long long)kk * MB * XC + n0;
          lab_mma<XP>(acc[mi], sKz + ao, sl_lo, LP, et1 + bo, t_split,
                      MB * XC);
          lab_mma<XP>(acc[mi], sMz + ao, sl_lo, LP, et2 + bo, t_split,
                      MB * XC);
        }
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      l2_store(acc[mi], sw, T::N, lane, nlanes, T::M, [&](int r, int c, C v) {
        const int m = r0 + mi * T::M + r, n = n0 + c;
        const int bz = trans ? n : m;
        const int by = trans ? m % MB : n / XC, xo = trans ? m / MB : n % XC;
        if (bz < b && by < b) out[out_at(bz, by, xo)] = v;
      });
  }
}

}  // namespace tpufem
