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
// P1 (probe_matmul_kernel): C = A B by WMMA in any of lab_mma.cuh's f32
// arithmetics, bf16x3 (the counterpart of Precision.HIGH: hi/lo bf16 split
// of both operands, lo*lo dropped), 3xTF32, 1xTF32 or one bf16 product.  A
// warp owns a 16 x 16 output tile and stages its A and B tiles 16 x 16 at a
// time in shared memory in the operand format.  It answers whether the
// arithmetic builds and is right; at n = 256 it is 33.6 MFLOP and 0.8 MB,
// far below anything the card can be timed on (bound 0.23 us, bytes).
//
// P2 (probe_chain_kernel<XP, MODE>): row stripes of acc @ w are independent,
// so a block owns a 16-row stripe of acc and of v for the whole chain and no
// grid-wide barrier is needed; m / 16 blocks (32 at m = 512) fill that many
// of the 132 SMs, so it is a per-SM co-scheduling probe, not a card-wide one.
// Separate warps of one block run the two streams: warps 0-7 the products
// (the stripe in shared memory in the operand format, ping-pong between two
// buffers, one named barrier of those 8 warps per product, w read from
// device memory, L2-resident), warps 8-11 the multiply-adds (16 values a
// thread in registers, fpp n_iter dependent FMAs each).  A warp scheduler
// dispatches one instruction a cycle from any ready warp, so two streams in
// separate warps overlap whenever one stalls (the product warps wait on
// their operand loads and the tensor pipe); interleaved in the same warps
// they would share each warp's dispatch slots and one stream's barrier.  mma:
// the FMA warps copy v through; fma: the product warps copy a through; both:
// each team runs its stream.  The multiply-add constants are kernel
// arguments so the chain cannot be folded.  Bound at (n_iter, m) = (256,
// 512): 68.7 GFLOP of products, 0.069 ms in one bf16 pass on the whole card
// (operations), 0.29 ms on the 32 SMs it runs on; 0.54 GFLOP of FMAs.
#pragma once

#include <cmath>

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

}  // namespace tpufem
