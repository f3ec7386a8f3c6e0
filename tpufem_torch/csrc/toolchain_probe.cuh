// The two toolchain probes on Hopper.  Device code; the host launcher with
// its plain C interface is toolchain_probe.cu.
//
// Replaces the Pallas kernels of scripts/toolchain_probe.py:
//   P1  probe_high_precision -> kernel (:36, call at :44)   one (n, n) f32
//       product pinned to Precision.HIGH: does the three-pass bf16 product
//       exist inside a kernel?
//   P2  probe_co_scheduling -> k_mxu, k_vpu, k_both (:73, :81, :88, call at
//       :105)   a chain of n_iter products acc <- acc @ w on (m, m) f32, a
//       chain of fpp n_iter multiply-adds v <- v c1 + c2 on an independent
//       (m, m), and both in one kernel: do the matrix unit and the vector
//       unit run at the same time?
//
// P1 on wgmma (probe_wgmma_kernel<XP, NB>, the default): C = A B in any of
// lab_mma.cuh's f32 arithmetics, bf16x3 (the counterpart of Precision.HIGH:
// hi/lo bf16 split of both operands, lo*lo dropped), 3xTF32, 1xTF32 or one
// bf16 product.  At n = 256 it is 33.6 MFLOP and 0.8 MB (bound 0.23 us,
// bytes); what bounds the design is one block's chain of dependent wgmmas
// (bf16x3 at 16 columns: 16 k steps x 3 passes of m64n16k16, 0.21 us at one
// SM's share of the bf16 peak) behind the latency of its first TMA chunk.
// A block of one warpgroup owns a 64-row tile by NB = kP1wColumns (16)
// columns, 64 blocks at n = 256 (lab/probe_sweep.py times copies at 32 and
// 64 columns, 32 and 16 blocks, in turns with it):
//   ring    chunks of 64 k, A's (64, 64) by two TMA boxes of 32 k landing in
//           the 128-byte swizzle (eight rows at one k in eight bank groups:
//           conflict-free A loads) and B's raw (64, NB) by one, each chunk
//           on its stage's `full` mbarrier; every chunk's copy is issued at
//           the start where the stages fit 227 KB (to n = 512 in every
//           arithmetic), else a stage takes chunk j + stages once chunk j's
//           products are done
//   split   B by the block's threads into wgmma's K-major operand
//           (hop_b_offset; 16 bytes of k of one column a thread, a warp's
//           threads on adjacent columns), fenced for the async proxy, while the
//           previous chunk's wgmmas run; A in registers as it loads
//           (hop_load_a), one register set, reloaded once the previous
//           chunk's wgmmas are waited for, so no register a wgmma reads is
//           written while it runs
//   passes  each k step in lab_mma.cuh's order, small*big and big*small into
//           a second accumulator, big*big into the first; each chunk's
//           accumulators are added into totals by CUDA-core adds once its
//           wgmmas are waited for, and the totals summed at the end.  The
//           tensor cores' f32 accumulation truncates, so each chain of
//           wgmmas into one accumulator drifts from the rounded sum with its
//           length: one accumulator over all of k (the earlier routine's
//           way; probe_sweep's `one_accumulator` copy) or two over all of k
//           (its `no_promotion` copy) put 3xTF32 outside EMU_TOL of the
//           plain version as n grows, a chain of one chunk does not
//           (PERF.md, section 7)
//   store   the totals straight to C (hop_acc_pairs), clipped at n; TMA's
//           zero fill past n makes partial tiles and the last chunk of k
//           need no bounds test in any load
//
// P1's earlier routine (probe_matmul_kernel, routine "earlier"): a warp owns
// a 16 x 16 output tile and stages its A and B tiles 16 x 16 at a time in
// shared memory in the operand format by scalar loads, one to three WMMA
// passes a step, 16 serial steps at n = 256 on 64 blocks of 4 warps: each
// step pays an L2 round trip (34 us on an H100).
//
// P2 on a cluster chain (probe_cluster_kernel<XP, MODE, NT>, the default):
// the chain's 64-row stripes are independent, so a thread-block cluster of C
// blocks owns one stripe for the whole chain and needs no grid-wide barrier:
// m / 64 clusters (8 at m = 512), C blocks each (8 in one bf16 pass, 64 SMs;
// 16 in 1xTF32 and bf16x3, 128 SMs, of which an H100 80GB HBM3 holds 7
// clusters at once: two waves).  Block r of a cluster owns columns
// [r m/C, (r+1) m/C) of w and of every product (NT n32 column tiles):
//   w       its column slice, split on the host with the kernel's rounding
//           and laid out as wgmma's K-major B operand (hop_b_offset, K = m),
//           arrives once by one bulk copy and stays in shared memory, so a
//           product reads nothing from L2
//   stripe  the (64, m) stripe in the operand format (bf16 hi and, in bf16x3,
//           lo; f32 in the TF32 arithmetics, split as A is loaded), blocked
//           by owner (C, parts, 64, m/C) so that a block's slice is one piece,
//           16-byte chunks XOR-swizzled by the row (conflict-free A loads and
//           accumulator stores)
//   product one warpgroup loads A by k step into registers (hop_load_a
//           splits it where the arithmetic does) and issues the block's
//           wgmmas (one n32 or n64 a k step and part: the block's m/C
//           columns) over K = m, one owner's slice a batch, two register sets
//           in turn so that one batch's A loads while the other's products
//           run; then writes its (64, m/C) slice in the operand format into
//           its own slot of the next stripe buffer and sends it to every
//           peer by bulk copies between shared memories (cp.async.bulk.
//           shared::cluster), each completing its bytes on the peer's
//           `full` mbarrier of that buffer, which the peer armed with the
//           C - 1 slices' bytes as soon as it had waited for the buffer's
//           last fill (so an expect always comes before the copies it
//           counts).  With two stripe buffers that is the only wait (a peer
//           sends product i only after it received product i - 1 from every
//           block, sent after each had read the buffer i reuses); with one
//           buffer an `empty` mbarrier, arrived on remotely by every block
//           once it has read the stripe, comes before a block writes its
//           slot (then every peer has also received the copy whose source
//           that slot was).  The last product stores its f32 accumulators
//           straight to o
//   FMAs    a second warpgroup runs the multiply-add chain on the block's own
//           (64, m/C) share of v, 16 NT values a thread held in registers for
//           the whole chain; in `both` the two warpgroups share nothing but
//           the SM
// mma: the multiply-add warpgroup copies v through; fma: the product
// warpgroup copies a through.  The launcher takes the smallest C (and two
// stripe buffers where they fit) whose block fits 227 KB by pc_smem: one bf16
// pass at m = 512 C = 8 (w 64 KB, two stripes 128 KB); 1xTF32 and bf16x3 C =
// 16 (w 64 KB, one stripe 128 KB); 3xTF32 does not fit at m = 512 (w 128 KB
// and the stripe 128 KB) and runs the earlier routine there, as does an m
// that is not a multiple of 64 and of 32 C (toolchain_probe.py's table).
// Bound at (n_iter, m) = (256, 512): 68.7 GFLOP of products, 0.069 ms in one
// bf16 pass on the whole card (operations), 0.143 ms on the 64 SMs of the
// grid at C = 8 and 0.072 on 128; the 255 dependent exchanges between
// products are the design's latency floor.  On an H100 80GB HBM3 at 700 W
// the products and the exchange add (0.37 + 0.45 ms of a 0.83 ms chain at
// C = 8; 1.4 + 4.4 of 5.9 at C = 16: tpufem_torch/lab/probe_sweep.py).
//
// P2's earlier routine (probe_chain_kernel<XP, MODE>, routine "earlier"): a
// block owns a 16-row stripe, m / 16 blocks (32 of 132 SMs at m = 512);
// warps 0-7 the products by WMMA (the stripe in shared memory in the operand
// format, ping-pong between two buffers, one named barrier of those 8 warps
// per product, every fragment of w read from device memory, L2-resident, at
// every k step), warps 8-11 the multiply-adds (16 values a thread in
// registers).  The multiply-add constants are kernel arguments so the chain
// cannot be folded.
//
// One host thread (blockDim 1, the g++ build of the tests) plays a block's
// warps in turn; a cluster's blocks run in one host thread, each product's
// multiplications for every rank before its sends (hopper.cuh's host forms).
#pragma once

#include <cmath>

#include "hopper.cuh"
#include "lab_mma.cuh"

namespace tpufem {

constexpr int kP1Warps = 4, kP1Threads = 32 * kP1Warps;
constexpr int kPT = 16;  // a warp's output tile and its staging tiles

constexpr int kP2MmaWarps = 8, kP2FmaWarps = 4;
constexpr int kP2Threads = 32 * (kP2MmaWarps + kP2FmaWarps);
constexpr int kP2Rows = 16;  // rows of a block's stripe
constexpr int kP2Regs = 16;  // values a thread holds in a pass of the FMAs

enum ProbeMode { kProbeMma = 0, kProbeFma = 1, kProbeBoth = 2 };

// Shared-memory bytes of a chain block: two stripes in the operand format
// (4 bytes a value in every arithmetic), one accumulator tile per warp.
__host__ __device__ inline long long probe_chain_smem(int m) {
  return 2 * lab_align((long long)kP2Rows * m * 4) +
         lab_align((long long)kP2MmaWarps * kPT * kPT * 4);
}

__device__ __forceinline__ float probe_fma(float v, float c1, float c2) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(v, c1, c2);
#else
  return std::fmaf(v, c1, c2);
#endif
}

// C = A B, (n, n) f32 row-major, n a multiple of 16; grid n^2 / 256 tiles
// over kP1Warps-warp blocks.
template <int XP>
__global__ void __launch_bounds__(kP1Threads)
probe_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    float* __restrict__ Cout, int n) {
  using T = LabMma<XP>;
  using E = typename T::E;
  using FC = typename LabFrag<XP>::FC;
  __shared__ __align__(128) unsigned char stage[kP1Warps][2][kPT * kPT * 4];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, nwarps = (nthr + 31) / 32, lane = tid % 32;
  const int nlanes = nthr < 32 ? nthr : 32;
  const long long split = T::kBF16 ? kPT * kPT : -1;
  const int nt = n / kPT;
  for (int job = warp; job < kP1Warps; job += nwarps) {
    const int tile = blockIdx.x * kP1Warps + job;
    if (tile >= nt * nt) continue;
    const int r0 = tile / nt * kPT, c0 = tile % nt * kPT;
    unsigned char* sa = stage[job][0];
    unsigned char* sb = stage[job][1];
    FC acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < n; k0 += kPT) {
      for (int e = lane; e < kPT * kPT; e += nlanes) {
        const int r = e / kPT, c = e % kPT;
        lab_put<float>(sa, split, e, A[(long long)(r0 + r) * n + k0 + c]);
        lab_put<float>(sb, split, e, B[(long long)(k0 + r) * n + c0 + c]);
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < kPT; kk += T::K)
        lab_mma<XP>(acc, reinterpret_cast<const E*>(sa) + kk, split, kPT,
                    reinterpret_cast<const E*>(sb) + kk * kPT, split, kPT);
      __syncwarp();
    }
    wmma::store_matrix_sync(Cout + (long long)r0 * n + c0, acc, n,
                            wmma::mem_row_major);
  }
}

// The chains of one 16-row stripe.  a, v, o, vo: (m, m) f32; w: (m, m) in
// the operand format (f32, or bf16 hi with its lo part w_lo elements on); m
// a multiple of 16; n_iter >= 1.  One host thread (blockDim 1) plays both
// teams in turn.
template <int XP, int MODE>
__global__ void __launch_bounds__(kP2Threads)
probe_chain_kernel(const float* __restrict__ a,
                   const typename LabMma<XP>::E* __restrict__ w,
                   long long w_lo, const float* __restrict__ v,
                   float* __restrict__ o, float* __restrict__ vo, int m,
                   int n_iter, int fpp, float c1, float c2) {
  using T = LabMma<XP>;
  using E = typename T::E;
  using FC = typename LabFrag<XP>::FC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool solo = nthr < 64;
  const int nmma = solo ? nthr : 32 * kP2MmaWarps;
  const int nfma = solo ? nthr : nthr - nmma;
  const long long r0 = (long long)blockIdx.x * kP2Rows;
  const int n_el = kP2Rows * m;  // the stripe, contiguous in a, v, o, vo
  const float* a_s = a + r0 * m;
  const float* v_s = v + r0 * m;
  float* o_s = o + r0 * m;
  float* vo_s = vo + r0 * m;

  if (solo || tid < nmma) {  // ---- the product team --------------------
    const int mtid = tid, warp = mtid / 32, nwarps = (nmma + 31) / 32;
    const int lane = mtid % 32, nlanes = nmma < 32 ? nmma : 32;
    const int bar = solo ? 0 : 1;
    if (MODE == kProbeFma) {
      for (int i = mtid; i < n_el; i += nmma) o_s[i] = a_s[i];
    } else {
      const long long split = T::kBF16 ? n_el : -1;
      const long long buf_bytes = lab_align((long long)n_el * 4);
      float* scr = reinterpret_cast<float*>(smem_raw + 2 * buf_bytes) +
                   warp * kPT * kPT;
      for (int i = mtid; i < n_el; i += nmma)
        lab_put<float>(smem_raw, split, i, a_s[i]);
      lab_sync(bar, nmma);
      for (int it = 0; it < n_iter; ++it) {
        const unsigned char* src = smem_raw + (it & 1) * buf_bytes;
        unsigned char* dst = smem_raw + ((it + 1) & 1) * buf_bytes;
        const bool last = it == n_iter - 1;
        for (int job = warp; job < m / kPT; job += nwarps) {
          const int c0 = job * kPT;
          FC acc;
          wmma::fill_fragment(acc, 0.0f);
          for (int k0 = 0; k0 < m; k0 += T::K)
            lab_mma<XP>(acc, reinterpret_cast<const E*>(src) + k0, split, m,
                        w + (long long)k0 * m + c0, w_lo, m);
          if (last) {  // the f32 sums themselves
            wmma::store_matrix_sync(o_s + c0, acc, m, wmma::mem_row_major);
          } else {
            wmma::store_matrix_sync(scr, acc, kPT, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < kPT * kPT; e += nlanes)
              lab_put<float>(dst, split, (long long)(e / kPT) * m + c0 +
                                             e % kPT, scr[e]);
            __syncwarp();
          }
        }
        lab_sync(bar, nmma);
      }
    }
  }
  if (solo || tid >= nmma) {  // ---- the multiply-add team ---------------
    const int ftid = solo ? tid : tid - nmma;
    if (MODE == kProbeMma) {
      for (int i = ftid; i < n_el; i += nfma) vo_s[i] = v_s[i];
    } else {
      const int steps = n_iter * fpp;
      for (int base = 0; base < n_el; base += nfma * kP2Regs) {
        float r[kP2Regs];
#pragma unroll
        for (int j = 0; j < kP2Regs; ++j) {
          const int i = base + j * nfma + ftid;
          r[j] = i < n_el ? v_s[i] : 0.0f;
        }
        for (int s = 0; s < steps; ++s)
#pragma unroll
          for (int j = 0; j < kP2Regs; ++j) r[j] = probe_fma(r[j], c1, c2);
#pragma unroll
        for (int j = 0; j < kP2Regs; ++j) {
          const int i = base + j * nfma + ftid;
          if (i < n_el) vo_s[i] = r[j];
        }
      }
    }
  }
}

// ---- P2 on a cluster chain -----------------------------------------------

constexpr int kPcRows = kHopM;     // rows of a cluster's stripe: one wgmma M
constexpr int kPcTeam = 128;       // threads of a warpgroup
constexpr int kPcThreads = 2 * kPcTeam;  // products, then multiply-adds
constexpr int kPcMaxCluster = 16;  // blocks of a cluster (16: non-portable)
constexpr int kPcMaxTiles = 2;     // n32 column tiles of a block (NT)
constexpr long long kPcSmemMax = 227 * 1024;

// bytes of a stored stripe element (bf16 in the bf16 arithmetics, else f32);
// parts of the stored stripe (bf16x3: hi and lo; the TF32 arithmetics split
// A as they load it); parts of w (the three-product arithmetics: two)
__host__ __device__ constexpr bool pc_bf16(int xp) {
  return xp == kXBF16x3 || xp == kXBF16;
}
__host__ __device__ constexpr int pc_elem(int xp) { return pc_bf16(xp) ? 2 : 4; }
__host__ __device__ constexpr int pc_a_parts(int xp) {
  return xp == kXBF16x3 ? 2 : 1;
}
__host__ __device__ constexpr int pc_b_parts(int xp) {
  return xp == kXBF16x3 || xp == kX3TF32 ? 2 : 1;
}

// Byte offsets of a block's shared memory, each 128-byte aligned:
//   bar     four mbarriers: w's bulk copy, empty (one buffer: every block
//           has read the stripe), full[2] (a stripe buffer's slices from
//           the peers have arrived)
//   w       the block's w slice, its parts one after the other (w_part
//           bytes each: exactly the host's, so one bulk copy fills it)
//   stripe  nbuf stripe buffers of stripe_bytes, C owners' slices of slice
//           bytes each
struct PcSmem {
  long long bar, w, w_part, stripe, slice, stripe_bytes, total;
};
__host__ __device__ inline PcSmem pc_smem(int xp, int m, int C, int nbuf) {
  const long long ncb = m / C, e = pc_elem(xp);
  PcSmem s;
  s.bar = 0;
  s.w = 128;
  s.w_part = ncb * m * e;
  s.stripe = s.w + lab_align(pc_b_parts(xp) * s.w_part);
  s.slice = pc_a_parts(xp) * kPcRows * ncb * e;
  s.stripe_bytes = lab_align(C * s.slice);
  s.total = s.stripe + nbuf * s.stripe_bytes;
  return s;
}
// The cluster geometries the routine is built for (its shared memory aside):
// C a power of two from 2 to 16, m a multiple of the stripe and of 32 C, at
// most kPcMaxTiles n32 tiles a block, one or two stripe buffers.
__host__ __device__ inline bool pc_geometry(int xp, int m, int C, int nbuf) {
  return xp != kXF64 && xp >= kX3TF32 && xp <= kXBF16 && C >= 2 &&
         C <= kPcMaxCluster && (C & (C - 1)) == 0 && m >= kPcRows &&
         m % kPcRows == 0 && m % (32 * C) == 0 &&
         m / (32 * C) <= kPcMaxTiles && (nbuf == 1 || nbuf == 2);
}
__host__ __device__ inline bool pc_takes(int xp, int m, int C, int nbuf) {
  return pc_geometry(xp, m, C, nbuf) &&
         pc_smem(xp, m, C, nbuf).total <= kPcSmemMax;
}

// A block's place: the stripe of `cluster`, the columns of `rank`.
struct PcGeo {
  int m, C, nbuf, cluster, rank;
};

// Element offset of (row, k) in a stripe buffer (of its hi part: the lo part
// of an owner's slice is kPcRows * ncb elements on): the owner's slice,
// then the row, then the column with its 16-byte chunk XOR-swizzled by the
// row, so the eight rows of an A load or an accumulator store fall in eight
// bank groups.
template <int XP, int NT>
struct PcAt {
  static constexpr int ncb = 32 * NT, epc = 16 / pc_elem(XP);
  static constexpr int nch = ncb / epc;  // chunks of a row: 4, 8 or 16
  static constexpr int slice = pc_a_parts(XP) * kPcRows * ncb;
  __host__ __device__ static int col(int row, int c) {
    const int f = nch >= 8 ? (row & 7) : ((row / (8 / nch)) & (nch - 1));
    return ((c / epc) ^ f) * epc + c % epc;
  }
  __host__ __device__ int operator()(int row, int k) const {
    return k / ncb * slice + row * ncb + col(row, k % ncb);
  }
};

// Store the pair (v0, v1) at element e (and e + 1) of a stripe in the
// operand format: bf16 hi (and lo, lo_el on), or f32.
template <int XP>
__device__ __forceinline__ void pc_put2(unsigned char* buf, long long lo_el,
                                        int e, float v0, float v1) {
  if constexpr (pc_bf16(XP)) {
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(buf);
#ifdef __CUDA_ARCH__
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(h + e) = hi;
    if constexpr (pc_a_parts(XP) == 2)
      *reinterpret_cast<__nv_bfloat162*>(h + lo_el + e) =
          __floats2bfloat162_rn(v0 - __bfloat162float(hi.x),
                                v1 - __bfloat162float(hi.y));
#else
    const float v[2] = {v0, v1};
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16 hi = __float2bfloat16(v[i]);
      h[e + i] = hi;
      if constexpr (pc_a_parts(XP) == 2)
        h[lo_el + e + i] = __float2bfloat16(v[i] - __bfloat162float(hi));
    }
#endif
  } else {
    float* f = reinterpret_cast<float*>(buf);
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float2*>(f + e) = make_float2(v0, v1);
#else
    f[e] = v0;
    f[e + 1] = v1;
#endif
  }
}

// The product warpgroup of a block: its accumulator (64 x 32 NT: one n32 or
// n64 wgmma a k step and part) and two register sets of A, each a batch of
// one owner's slice (KS k steps).  One host thread stands for the
// warpgroup.
template <int XP, int NT>
struct PcMma {
  static constexpr bool BF = pc_bf16(XP);
  static constexpr bool kSplit = pc_b_parts(XP) == 2;  // three products
  static constexpr int ncb = 32 * NT;
  static constexpr int KS = ncb / (BF ? 16 : 8);
  HopAccN<ncb> acc;
  HopA big[2][KS], small[2][KS];

  // A of the batch whose first k step is k0 into set S, then its wgmmas
  // against the block's w (kbytes of k a column; part 1, the small or lo
  // part, w_part bytes on); the 3xTF32 and bf16x3 products in l2_xring's
  // order (small*big, big*small, big*big)
  template <int S>
  __device__ __forceinline__ void batch(const unsigned char* stripe,
                                        const unsigned char* wsm,
                                        long long w_part, int kbytes, int k0,
                                        int w, int lane) {
    const PcAt<XP, NT> at;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (BF)
        hop_load_a_bf16(big[S][ks], small[S][ks], kSplit,
                        reinterpret_cast<const __nv_bfloat16*>(stripe),
                        (long long)kPcRows * ncb, at, k0 + ks, w, lane);
      else
        hop_load_a<false>(big[S][ks], small[S][ks], kSplit,
                          reinterpret_cast<const float*>(stripe), at, k0 + ks,
                          w, lane);
    }
    hop_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int part = kSplit ? 0 : 2; part < 3; ++part)
        hop_wgmma<BF>(acc, part == 0 ? small[S][ks] : big[S][ks],
                      wsm + (part == 1 ? w_part : 0), k0 + ks, kbytes);
    hop_wgmma_commit();
  }
  template <int S>
  __device__ __forceinline__ void keep() {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      hop_keep(big[S][ks]);
      if constexpr (kSplit) hop_keep(small[S][ks]);
    }
  }
  // acc = stripe @ w over K = m: the owners' slices in pairs of batches,
  // each set reloaded only once its products are done (C batches, an even
  // count)
  __device__ __forceinline__ void multiply(const unsigned char* stripe,
                                           const unsigned char* wsm,
                                           long long w_part, int m, int w,
                                           int lane) {
    const int kbytes = m * (BF ? 2 : 4);
    hop_acc_zero(acc);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) big[1][ks] = small[1][ks] = HopA{};
    for (int b = 0; b < m / ncb; b += 2) {
      batch<0>(stripe, wsm, w_part, kbytes, b * KS, w, lane);
      hop_wgmma_wait<1>();
      keep<1>();
      batch<1>(stripe, wsm, w_part, kbytes, (b + 1) * KS, w, lane);
      hop_wgmma_wait<1>();
      keep<0>();
    }
    hop_wgmma_wait<0>();
    keep<1>();
  }
};

// The block's mbarriers.
struct PcBars {
  uint64_t* b;
  __device__ __forceinline__ uint64_t* wb() const { return b; }
  __device__ __forceinline__ uint64_t* empty() const { return b + 1; }
  __device__ __forceinline__ uint64_t* full(int buf) const {
    return b + 2 + buf;
  }
};

// The product warpgroup's start (thread t of nthr): thread 0 initialises the
// barriers, arms each stripe buffer's `full` for its first fill and asks for
// the block's w slice (`w`: every block's slices, one after the other); all
// load the cluster's stripe of a into stripe buffer 0.  A cluster barrier
// follows before any peer uses the barriers.
template <int XP, int NT>
__device__ void pc_start(unsigned char* smem, const PcGeo& g,
                         const float* __restrict__ a,
                         const unsigned char* __restrict__ w, int t,
                         int nthr) {
  const PcSmem s = pc_smem(XP, g.m, g.C, g.nbuf);
  const PcBars br{reinterpret_cast<uint64_t*>(smem + s.bar)};
  if (t == 0) {
    hop_mbar_init(br.wb(), 1);
    hop_mbar_init(br.empty(), g.C);
    hop_mbar_init(br.full(0), 1);
    hop_mbar_init(br.full(1), 1);
    hop_mbar_init_fence();
    // this block's arrival with the peers' bytes, for each fill before the
    // copies it counts (pc_multiply arms the next fill as soon as a buffer
    // has been waited for)
    for (int b = 0; b < g.nbuf; ++b)
      hop_mbar_expect(br.full(b), (unsigned)((g.C - 1) * s.slice));
    const long long wbytes = pc_b_parts(XP) * s.w_part;
    hop_mbar_expect(br.wb(), (unsigned)wbytes);
    hop_bulk_load(smem + s.w, w + g.rank * wbytes, (unsigned)wbytes, br.wb());
  }
  const PcAt<XP, NT> at;
  const float* a_s = a + (long long)g.cluster * kPcRows * g.m;
  const long long lo = (long long)kPcRows * at.ncb;
  for (int i = t; i < kPcRows * g.m; i += nthr) {
    const int row = i / g.m, k = i % g.m;
    const float v = a_s[i];
    if constexpr (pc_bf16(XP)) {
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(smem + s.stripe);
      const __nv_bfloat16 hi = __float2bfloat16(v);
      h[at(row, k)] = hi;
      if constexpr (pc_a_parts(XP) == 2)
        h[lo + at(row, k)] = __float2bfloat16(v - __bfloat162float(hi));
    } else {
      reinterpret_cast<float*>(smem + s.stripe)[at(row, k)] = v;
    }
  }
}

// Product it: its input waited for (w at it = 0, where the stripe of a is
// the block's own; else every peer's slice of product it - 1, its buffer's
// next fill then armed by thread 0), then its multiplications.
template <int XP, int NT>
__device__ __forceinline__ void pc_multiply(PcMma<XP, NT>& mm,
                                            unsigned char* smem,
                                            const PcSmem& s, const PcGeo& g,
                                            int it, int t, int w, int lane) {
  const PcBars br{reinterpret_cast<uint64_t*>(smem + s.bar)};
  const int buf = it % g.nbuf;
  if (it == 0) {
    hop_mbar_wait(br.wb(), 0);
  } else {
    hop_mbar_wait(br.full(buf), (unsigned)(((it - 1) / g.nbuf) & 1));
    if (t == 0)
      hop_mbar_expect(br.full(buf), (unsigned)((g.C - 1) * s.slice));
  }
  mm.multiply(smem + s.stripe + buf * s.stripe_bytes, smem + s.w, s.w_part,
              g.m, w, lane);
}

// Product it's slice (not the last product) into the next stripe buffer,
// the block's own slot and every peer's (thread t of the warpgroup).
template <int XP, int NT>
__device__ void pc_send(PcMma<XP, NT>& mm, unsigned char* smem,
                        const PcSmem& s, const PcGeo& g, int it, int t,
                        int w, int lane) {
  const PcBars br{reinterpret_cast<uint64_t*>(smem + s.bar)};
  const int nb = (it + 1) % g.nbuf;
  unsigned char* own = smem + s.stripe + nb * s.stripe_bytes +
                       (long long)g.rank * s.slice;
  if (g.nbuf == 1) {
    // this block's warps have read the stripe: say so to every block, and
    // wait until every block has read it, and with it the slice this block
    // sent last (the source of that copy is the slot written next)
    lab_sync(1, kPcTeam);
    if (t == 0)
      for (int r = 0; r < g.C; ++r)
        hop_mbar_arrive_remote(hop_mapa(br.empty(), r));
    hop_mbar_wait_cluster(br.empty(), (unsigned)(it & 1));
  }
  using At = PcAt<XP, NT>;
  hop_acc_pairs(mm.acc, w, lane, [&](int r, int c, float v0, float v1) {
    pc_put2<XP>(own, (long long)kPcRows * At::ncb,
                r * At::ncb + At::col(r, c), v0, v1);
  });
  hop_fence_async();
  lab_sync(1, kPcTeam);
  if (t == 0)
    for (int r = 0; r < g.C; ++r)
      if (r != g.rank)
        hop_bulk_s2s(hop_mapa(own, r), own, (unsigned)s.slice,
                     hop_mapa(br.full(nb), r));
}

// The last product's f32 sums to o.
template <int XP, int NT>
__device__ void pc_store(const PcMma<XP, NT>& mm, const PcGeo& g,
                         float* __restrict__ o, int w, int lane) {
  float* o_s = o + (long long)g.cluster * kPcRows * g.m +
               (long long)g.rank * (32 * NT);
  hop_acc_pairs(mm.acc, w, lane, [&](int r, int c, float v0, float v1) {
    float* d = o_s + (long long)r * g.m + c;
#ifdef __CUDA_ARCH__
    *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
#else
    d[0] = v0;
    d[1] = v1;
#endif
  });
}

// A block's own (64, 32 NT) share of an (m, m) array: element i (row-major in
// the share) at its place in the array.
template <int NT>
__device__ __forceinline__ long long pc_share(const PcGeo& g, int i) {
  return ((long long)g.cluster * kPcRows + i / (32 * NT)) * g.m +
         (long long)g.rank * (32 * NT) + i % (32 * NT);
}

// The multiply-add warpgroup (thread t of nthr): steps v <- v c1 + c2 on the
// block's share of v (16 NT values a thread of 128, in registers), or (mma)
// v copied through; the product warpgroup's copy of a (fma) likewise.
template <int NT, bool RUN>
__device__ void pc_fma(const float* __restrict__ v, float* __restrict__ vo,
                       const PcGeo& g, int steps, float c1, float c2, int t,
                       int nthr) {
  constexpr int R = 16 * NT, n_el = kPcRows * 32 * NT;
  for (int base = 0; base < n_el; base += nthr * R) {
    float r[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = base + j * nthr + t;
      r[j] = i < n_el ? v[pc_share<NT>(g, i)] : 0.0f;
    }
    if (RUN)
      for (int s = 0; s < steps; ++s)
#pragma unroll
        for (int j = 0; j < R; ++j) r[j] = probe_fma(r[j], c1, c2);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = base + j * nthr + t;
      if (i < n_el) vo[pc_share<NT>(g, i)] = r[j];
    }
  }
}

// The chains of one (64, m) stripe on a cluster of C blocks (grid m / 64 *
// C, kPcThreads threads, cluster dimension C).  a, v, o, vo: (m, m) f32;
// w_op: the blocks' slices of w as toolchain_probe.w_operand lays them out;
// (m, C, nbuf) a plan pc_takes takes; n_iter >= 1.
template <int XP, int MODE, int NT>
__global__ void __launch_bounds__(kPcThreads, 1)
probe_cluster_kernel(const float* __restrict__ a,
                     const unsigned char* __restrict__ w_op,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ vo, int m, int C, int nbuf,
                     int n_iter, int fpp, float c1, float c2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const PcGeo g{m, C, nbuf, (int)blockIdx.x / C, (int)blockIdx.x % C};
  const PcSmem s = pc_smem(XP, m, C, nbuf);
  const int tid = threadIdx.x, role = hop_uniform(tid / kPcTeam);
  const int t = tid % kPcTeam, w = t / 32, lane = tid % 32;
  if (role == 0 && MODE != kProbeFma)
    pc_start<XP, NT>(smem_raw, g, a, w_op, t, kPcTeam);
  hop_cluster_sync();
  if (role == 0) {
    if constexpr (MODE == kProbeFma) {
      pc_fma<NT, false>(a, o, g, 0, c1, c2, t, kPcTeam);
    } else {
      PcMma<XP, NT> mm;
      for (int it = 0; it < n_iter; ++it) {
        pc_multiply(mm, smem_raw, s, g, it, t, w, lane);
        if (it == n_iter - 1)
          pc_store(mm, g, o, w, lane);
        else
          pc_send(mm, smem_raw, s, g, it, t, w, lane);
      }
    }
  } else {
    pc_fma<NT, MODE != kProbeMma>(v, vo, g, n_iter * fpp, c1, c2, t,
                                  kPcTeam);
  }
  hop_cluster_sync();
}

// ---- P1 on wgmma ------------------------------------------------------------

constexpr int kP1wKC = 64;        // k of a ring stage
constexpr int kP1wBox = 32;       // k of an A box: 128 bytes, the swizzle's row
constexpr int kP1wThreads = 128;  // one warpgroup
constexpr int kP1wMaxStages = 16;
// a block's columns, NB, in the library (lab/probe_sweep.py builds copies at
// 32 and 64 and times them in turns with it)
constexpr int kP1wColumns = 16;

// Byte offsets of a block's shared memory (from its 1024-byte aligned base;
// `total` counts the alignment's slack):
//   stage j  A's (64, 64) chunk as two swizzled (64, 32) f32 boxes, B's raw
//            (64, NB) f32 chunk, then B's chunk in wgmma's K-major operand,
//            its parts (hi, lo; big, small) op_part bytes apart
//   bar      one `full` mbarrier a stage
struct P1wSmem {
  long long braw, op, op_part, stage_bytes, bar, total;
};
__host__ __device__ inline P1wSmem p1w_smem(int xp, int nb, int stages) {
  P1wSmem s;
  s.braw = (long long)kHopM * kP1wKC * 4;
  s.op = s.braw + (long long)kP1wKC * nb * 4;
  s.op_part = (long long)nb * kP1wKC * pc_elem(xp);
  s.stage_bytes = s.op + pc_b_parts(xp) * s.op_part;
  s.bar = stages * s.stage_bytes;
  s.total = 1024 + s.bar + 8 * kP1wMaxStages;
  return s;
}
// The ring's stages at n: every chunk of k (all of a block's operands in
// flight at once) where they fit kPcSmemMax, else as many as fit.
__host__ __device__ inline int p1w_stages(int xp, int nb, int n) {
  const long long fit = (kPcSmemMax - p1w_smem(xp, nb, 0).total) /
                        p1w_smem(xp, nb, 1).stage_bytes;
  const long long nch = (n + kP1wKC - 1) / kP1wKC;
  const long long s = fit < nch ? fit : nch;
  return (int)(s < kP1wMaxStages ? s : kP1wMaxStages);
}

// The two tensor maps of an (n, n) f32 product: A in (64, 32) boxes landing
// in the 128-byte swizzle, B in (64 k, nb) boxes.
inline int p1w_maps(HopMap* am, HopMap* bm, const void* a, const void* b,
                    int n, int nb) {
  const long long dim[3] = {n, n, 1};
  const int abox[3] = {kP1wBox, kHopM, 1}, bbox[3] = {nb, kP1wKC, 1};
  return hop_map_3d(am, const_cast<void*>(a), 4, dim, abox, true) ||
         hop_map_3d(bm, const_cast<void*>(b), 4, dim, bbox);
}

// Word offset of A's (row, k) in a stage: the box of k, its 128-byte row,
// the 16-byte chunk swizzled by the row.
struct P1wAt {
  __host__ __device__ int operator()(int row, int k) const {
    return k / kP1wBox * (kHopM * kP1wBox) + row * kP1wBox +
           ((((k % kP1wBox) >> 2) ^ (row & 7)) << 2) + (k & 3);
  }
};

// Sixteen bytes of B's operand from the values v (8 in bf16, 4 in TF32):
// hi (big) at `hi`, where the arithmetic splits lo (small) at `lo`, with the
// kernel's rounding (bf16 to nearest even; TF32 cvt.rna).
template <int XP>
__device__ __forceinline__ void p1w_put16(unsigned char* hi, unsigned char* lo,
                                          const float* v) {
  constexpr bool kSplit = pc_b_parts(XP) == 2;
#ifdef __CUDA_ARCH__
  uint4 h, l;
  uint32_t* hw = &h.x;
  uint32_t* lw = &l.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (pc_bf16(XP)) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      hw[j] = *reinterpret_cast<const uint32_t*>(&b);
      if constexpr (kSplit) {
        const __nv_bfloat162 s = __floats2bfloat162_rn(
            v[2 * j] - __bfloat162float(b.x),
            v[2 * j + 1] - __bfloat162float(b.y));
        lw[j] = *reinterpret_cast<const uint32_t*>(&s);
      }
    } else {
      const float b = hop_tf32(v[j]);
      hw[j] = __float_as_uint(b);
      if constexpr (kSplit) lw[j] = __float_as_uint(hop_tf32(v[j] - b));
    }
  }
  *reinterpret_cast<uint4*>(hi) = h;
  if constexpr (kSplit) *reinterpret_cast<uint4*>(lo) = l;
#else
  if constexpr (pc_bf16(XP)) {
    for (int i = 0; i < 8; ++i) {
      const __nv_bfloat16 b = __float2bfloat16(v[i]);
      std::memcpy(hi + 2 * i, &b, 2);
      if constexpr (kSplit) {
        const __nv_bfloat16 s = __float2bfloat16(v[i] - __bfloat162float(b));
        std::memcpy(lo + 2 * i, &s, 2);
      }
    }
  } else {
    for (int i = 0; i < 4; ++i) {
      const float b = hop_tf32(v[i]), s = hop_tf32(v[i] - b);
      std::memcpy(hi + 4 * i, &b, 4);
      if constexpr (kSplit) std::memcpy(lo + 4 * i, &s, 4);
    }
  }
#endif
}

// B's raw (64 k, NB) chunk into the operand (thread t of nthr): a thread
// takes 16 bytes of k of one column at a time, so a warp reads 32 adjacent
// columns of a row and writes whole 128-byte core matrices.
template <int XP, int NB>
__device__ __forceinline__ void p1w_split_b(const float* raw,
                                            unsigned char* op,
                                            long long op_part, int t,
                                            int nthr) {
  constexpr int V = pc_bf16(XP) ? 8 : 4, E = pc_elem(XP);
  for (int u = t; u < NB * kP1wKC / V; u += nthr) {
    const int col = u % NB, k0 = u / NB * V;
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = raw[(k0 + i) * NB + col];
    const int off = hop_b_offset(col, k0 * E, kP1wKC * E);
    p1w_put16<XP>(op + off, op + op_part + off, v);
  }
}

// The warpgroup's accumulators (64 x NB: the big*big pass, and in the
// three-product arithmetics the two small passes apart from it) for one
// chunk of k, their sums over the chunks done (`tot`, `tot_lo`), and one
// register set of A, a stage's KS k steps.  One host thread stands for the
// warpgroup.
template <int XP, int NB>
struct P1wMma {
  static constexpr bool BF = pc_bf16(XP);
  static constexpr bool kSplit = pc_b_parts(XP) == 2;  // three products
  static constexpr int KS = kP1wKC / (BF ? 16 : 8);
  HopAccN<NB> acc, acc_lo, tot, tot_lo;
  HopA big[KS], small[KS];

  // A of a stage (split as it loads), then its wgmmas against the stage's B
  // operand, each k step in lab_mma.cuh's order (small*big, big*small into
  // acc_lo; big*big into acc), the chunk's first step overwriting each
  __device__ __forceinline__ void batch(const float* a,
                                        const unsigned char* op,
                                        long long op_part, int w, int lane) {
    constexpr int kbytes = kP1wKC * pc_elem(XP);
    const P1wAt at;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      hop_load_a<BF>(big[ks], small[ks], kSplit, a, at, ks, w, lane);
    hop_wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (kSplit) {
        hop_wgmma<BF>(acc_lo, small[ks], op, ks, kbytes, ks > 0);
        hop_wgmma<BF>(acc_lo, big[ks], op + op_part, ks, kbytes);
      }
      hop_wgmma<BF>(acc, big[ks], op, ks, kbytes, ks > 0);
    }
    hop_wgmma_commit();
  }
  // The chunk's sums into the totals by CUDA-core adds, once its wgmmas are
  // waited for: the tensor cores' f32 accumulation truncates, so a chain of
  // wgmmas over all of k drifts from the rounded sum as k grows; here a
  // chain is one chunk's KS steps
  __device__ __forceinline__ void promote() {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc.d) / sizeof(float)); ++i) {
      tot.d[i] += acc.d[i];
      if constexpr (kSplit) tot_lo.d[i] += acc_lo.d[i];
    }
  }
  // A's registers the compiler's until here, after the wait for the wgmmas
  // that read them, and the accumulators' accesses held on this side of it
  __device__ __forceinline__ void keep() {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      hop_keep(big[ks]);
      if constexpr (kSplit) hop_keep(small[ks]);
    }
    hop_acc_fence(acc);
    if constexpr (kSplit) hop_acc_fence(acc_lo);
  }
};

// C = A B, (n, n) f32 row-major, n a multiple of 16: a block owns the 64-row
// tile blockIdx.y by NB columns blockIdx.x (grid (ceil(n / NB), ceil(n /
// 64)), kP1wThreads threads, p1w_smem's bytes).  a_map, b_map: p1w_maps;
// `stages` p1w_stages'.
template <int XP, int NB>
__global__ void __launch_bounds__(kP1wThreads, 1)
probe_wgmma_kernel(const __grid_constant__ HopMap a_map,
                   const __grid_constant__ HopMap b_map,
                   float* __restrict__ c, int n, int stages) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
#ifdef __CUDA_ARCH__
  unsigned char* sm =
      smem_raw + ((1024u - (hop_smem(smem_raw) & 1023u)) & 1023u);
#else
  unsigned char* sm = smem_raw;
#endif
  const P1wSmem s = p1w_smem(XP, NB, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + s.bar);
  const int tid = threadIdx.x, nthr = blockDim.x, w = tid / 32,
            lane = tid % 32;
  const int r0 = blockIdx.y * kHopM, c0 = blockIdx.x * NB;
  const int nch = (n + kP1wKC - 1) / kP1wKC;
  // chunk j's A boxes and B box into stage j % stages (zeros past n)
  auto produce = [&](int j) {
    unsigned char* st = sm + j % stages * s.stage_bytes;
    uint64_t* bar = full + j % stages;
    hop_mbar_expect(bar, (unsigned)s.op);
    for (int h = 0; h < kP1wKC / kP1wBox; ++h)
      hop_tma_load(st + h * kHopM * kP1wBox * 4, &a_map, bar,
                   j * kP1wKC + h * kP1wBox, r0, 0);
    hop_tma_load(st + s.braw, &b_map, bar, c0, j * kP1wKC, 0);
  };
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) hop_mbar_init(full + i, 1);
    hop_mbar_init_fence();
    for (int j = 0; j < stages; ++j) produce(j);
  }
  __syncthreads();
  P1wMma<XP, NB> mm;
  hop_acc_zero(mm.acc);
  hop_acc_zero(mm.acc_lo);
  hop_acc_zero(mm.tot);
  hop_acc_zero(mm.tot_lo);
#pragma unroll
  for (int ks = 0; ks < mm.KS; ++ks) mm.big[ks] = mm.small[ks] = HopA{};
  mm.keep();
  // chunk j: B's operand written and fenced while chunk j - 1's wgmmas run;
  // once those are done (and every thread has passed this chunk's barrier)
  // their sums go into the totals, chunk j - 1's stage takes chunk j - 1 +
  // stages and A's registers take chunk j
  for (int j = 0; j < nch; ++j) {
    unsigned char* st = sm + j % stages * s.stage_bytes;
    hop_mbar_wait(full + j % stages, (unsigned)((j / stages) & 1));
    p1w_split_b<XP, NB>(reinterpret_cast<const float*>(st + s.braw),
                        st + s.op, s.op_part, tid, nthr);
    hop_fence_async();
    __syncthreads();
    hop_wgmma_wait<0>();
    mm.keep();
    mm.promote();
    if (tid == 0 && j >= 1 && j - 1 + stages < nch) produce(j - 1 + stages);
    mm.batch(reinterpret_cast<const float*>(st), st + s.op, s.op_part, w,
             lane);
  }
  hop_wgmma_wait<0>();
  mm.keep();
  mm.promote();
  if constexpr (P1wMma<XP, NB>::kSplit) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(mm.tot.d) / sizeof(float)); ++i)
      mm.tot.d[i] += mm.tot_lo.d[i];
  }
  hop_acc_pairs(mm.tot, w, lane, [&](int r, int cc, float v0, float v1) {
    const int row = r0 + r, col = c0 + cc;
    if (row < n && col < n) {
      float* d = c + (long long)row * n + col;
#ifdef __CUDA_ARCH__
      *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
#else
      d[0] = v0;
      d[1] = v1;
#endif
    }
  });
}

}  // namespace tpufem
