// Hopper's asynchronous machinery for the kernel-lab routines, beside the
// cp.async helpers of lab_mma.cuh: mbarriers, the Tensor Memory Accelerator
// (TMA), thread-block clusters and the warpgroup matrix multiply (wgmma).
//
// Used by band_ring.cuh (the all-band ring under K1, K3 and K4 in
// resident_ring.cuh and under the lab's vcopy, vband, v16 of
// scripts/kernel_lab.py, _kernel_vcopy :500, _kernel_vband :525, _kernel_v16
// :1347, in lab_zyfirst.cuh), lab_separable.cuh (the dense x stage of
// _kernel_vx :164 and the x-first kernels around it),
// lab_separable_ring.cuh (_kernel_v3 :78: band x, y and z on wgmma),
// lab_resident_ring.cuh (the ring routines of the K1 lab's v17, v19 and v20,
// and of the K2 lab's v13 and v15) and toolchain_probe.cuh (P2's cluster
// chain; P1's wgmma tile, whose A boxes arrive in the 128-byte swizzle).
// What each piece is for:
//   mbarrier  a barrier in shared memory that counts thread arrivals and the
//             bytes of asynchronous copies; a ring of `full`/`empty` pairs
//             takes the place of the TPU kernels' DMA semaphores, and of a
//             block-wide __syncthreads per chunk
//   TMA       one thread asks for a whole 3-D box of a tensor (a halo'd tile)
//             to be copied to or from shared memory; the hardware computes
//             the addresses, fills what lies beyond the tensor with zeros on
//             a load and clips a store at the tensor's extent, so a ragged
//             tile needs no index arithmetic, bounds test or zero store in
//             any thread.  The tensor is described by a tensor map the host
//             encodes (hop_map_3d) and passes as a __grid_constant__ kernel
//             argument.
//   cluster   blocks on neighbouring SMs that reach each other's shared
//             memory (hop_mapa, bulk copies between shared memories, remote
//             mbarrier arrivals), started and ended by a cluster barrier
//   wgmma     four warps multiply a 64-row tile, A from registers (so a
//             3xTF32 or bf16x3 split of A stays in registers), B from shared
//             memory through a descriptor, the sum in registers; the only
//             way to the tensor cores' full rate on this card.
// Every device function has a host form (taken where __CUDA_ARCH__ is not
// defined) so the routines can be compiled by a plain C++ compiler and run by
// one host thread per block: a TMA box is a loop copy with zero fill or
// clipping, an mbarrier call does nothing (the one thread runs the producer,
// then the consumers, in turn), and a wgmma operand or accumulator holds its
// whole tile.
#pragma once

#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#endif

namespace tpufem {

// ---- tensor maps -----------------------------------------------------------

#ifdef __CUDACC__
using HopMap = CUtensorMap;
#else
// what a tiled 3-D map of a dense tensor says (innermost dimension first)
struct HopMap {
  void* base;
  long long dim[3];
  int box[3];
  int elem;    // bytes per element
  bool sw128;  // boxes in shared memory in the 128-byte swizzle
};
#endif

// Encode the map of a dense (dim[2], dim[1], dim[0]) tensor of `elem`-byte
// floating-point elements (8: f64, 4: f32, 2: bf16) at `base` (16-byte
// aligned, dim[0] * elem a multiple of 16), copied in boxes of box[2] x
// box[1] x box[0] elements (each at most 256, box[0] * elem a multiple of
// 16).  Returns 0, or a non-zero code when libcuda's encoder is missing or
// refuses.  With sw128 a loaded box lands in shared memory in the 128-byte
// swizzle (box[0] * elem exactly 128, the box 1024-byte aligned): the
// 16-byte chunk c of a 128-byte row r sits at chunk c ^ (r % 8), so that
// eight rows read at one column fall in eight bank groups (the host form of
// hop_tma_store knows no swizzle).
inline int hop_map_3d(HopMap* m, void* base, int elem, const long long* dim,
                      const int* box, bool sw128 = false) {
#ifdef __CUDACC__
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  if (!encode) return -1;
  const cuuint64_t gdim[3] = {(cuuint64_t)dim[0], (cuuint64_t)dim[1],
                              (cuuint64_t)dim[2]};
  const cuuint64_t gstride[2] = {(cuuint64_t)dim[0] * elem,
                                 (cuuint64_t)dim[0] * dim[1] * elem};
  const cuuint32_t gbox[3] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                              (cuuint32_t)box[2]};
  const cuuint32_t estride[3] = {1, 1, 1};
  return (int)encode(m,
                     elem == 8   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                     : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     3, base, gdim, gstride, gbox, estride,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     sw128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
#else
  m->base = base;
  m->elem = elem;
  m->sw128 = sw128;
  for (int a = 0; a < 3; ++a) {
    m->dim[a] = dim[a];
    m->box[a] = box[a];
  }
  return 0;
#endif
}

#ifdef __CUDA_ARCH__
__device__ __forceinline__ unsigned hop_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
#endif

// ---- mbarriers -------------------------------------------------------------

// `count` arrivals complete a phase; call from one thread, then
// hop_mbar_init_fence and a block barrier before anyone uses the barrier.
__device__ __forceinline__ void hop_mbar_init(uint64_t* bar, int count) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(hop_smem(bar)),
               "r"(count)
               : "memory");
#endif
}
__device__ __forceinline__ void hop_mbar_init_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#endif
}
__device__ __forceinline__ void hop_mbar_arrive(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(hop_smem(bar))
               : "memory");
#endif
}
// One arrival that also tells the barrier to expect `bytes` of TMA loads.
__device__ __forceinline__ void hop_mbar_expect(uint64_t* bar, unsigned bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   hop_smem(bar)),
               "r"(bytes)
               : "memory");
#endif
}
// Wait until the phase of parity `parity` (0 for the first) has completed.
__device__ __forceinline__ void hop_mbar_wait(uint64_t* bar, unsigned parity) {
#ifdef __CUDA_ARCH__
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(hop_smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
#endif
}

// ---- TMA -------------------------------------------------------------------

// Load the box at element coordinates (c0 innermost, c1, c2) of `map` into
// `dst` (128-byte aligned, dense box[2] x box[1] x box[0]); elements beyond
// the tensor arrive as zeros; the box's bytes, all of them, complete on `bar`.
__device__ __forceinline__ void hop_tma_load(void* dst, const HopMap* map,
                                             uint64_t* bar, int c0, int c1,
                                             int c2) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(hop_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(hop_smem(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
#elif !defined(__CUDACC__)
  const unsigned char* s = static_cast<const unsigned char*>(map->base);
  long long o = 0;  // the element's byte offset in the dense box
  for (int k = 0; k < map->box[2]; ++k)
    for (int j = 0; j < map->box[1]; ++j)
      for (int i = 0; i < map->box[0]; ++i, o += map->elem) {
        unsigned char* d = static_cast<unsigned char*>(dst) +
                           (map->sw128 ? o ^ (((o >> 7) & 7) << 4) : o);
        const long long x = c0 + i, y = c1 + j, z = c2 + k;
        if (x >= 0 && x < map->dim[0] && y >= 0 && y < map->dim[1] && z >= 0 &&
            z < map->dim[2])
          std::memcpy(
              d, s + ((z * map->dim[1] + y) * map->dim[0] + x) * map->elem,
              map->elem);
        else
          std::memset(d, 0, map->elem);
      }
#endif
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) of device
// memory at `src` to `dst` in one bulk copy, completing on `bar` as a TMA
// box does: a tensor laid out on the host as shared memory wants it.
__device__ __forceinline__ void hop_bulk_load(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(hop_smem(dst)),
      "l"(src), "r"(bytes), "r"(hop_smem(bar))
      : "memory");
#elif !defined(__CUDACC__)
  std::memcpy(dst, src, bytes);
#endif
}

// Store the dense box at `src` to element coordinates (c0, c1, c2) of `map`,
// clipped at the tensor's extent.  The writers of `src` call hop_fence_async
// and synchronise before the one thread that stores; that thread then
// commits (hop_store_commit) and, before `src` is written again, waits
// (hop_store_wait<N>: all but its N newest groups have been read).
__device__ __forceinline__ void hop_tma_store(const HopMap* map,
                                              const void* src, int c0, int c1,
                                              int c2) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(hop_smem(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
#elif !defined(__CUDACC__)
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(map->base);
  for (int k = 0; k < map->box[2]; ++k)
    for (int j = 0; j < map->box[1]; ++j)
      for (int i = 0; i < map->box[0]; ++i, s += map->elem) {
        const long long x = c0 + i, y = c1 + j, z = c2 + k;
        if (x >= 0 && x < map->dim[0] && y >= 0 && y < map->dim[1] && z >= 0 &&
            z < map->dim[2])
          std::memcpy(
              d + ((z * map->dim[1] + y) * map->dim[0] + x) * map->elem, s,
              map->elem);
      }
#endif
}
__device__ __forceinline__ void hop_store_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void hop_store_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
#endif
}
// Order this thread's earlier writes to device memory before the
// asynchronous proxy's later accesses (a TMA store to the same addresses).
__device__ __forceinline__ void hop_fence_async_global() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.global;" ::: "memory");
#endif
}
// Make this thread's shared-memory writes visible to the asynchronous proxy
// (TMA stores, wgmma operand reads).
__device__ __forceinline__ void hop_fence_async() {
#ifdef __CUDA_ARCH__
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
}

// ---- thread-block clusters ---------------------------------------------------
// A launch with a cluster dimension C (cudaLaunchKernelEx) puts C blocks on C
// SMs of one GPC at the same time; each can reach the others' shared memory
// (distributed shared memory) through addresses hop_mapa makes, by bulk
// copies and remote mbarrier arrivals.  A block's mbarriers are initialised
// and fenced (hop_mbar_init_fence: release at cluster scope) before a cluster
// barrier (hop_cluster_sync) lets any peer use them, and a block leaves only
// after a last cluster barrier, when no peer can still write into it.  The
// host form runs a whole cluster in one host thread: the calling code sets
// hop_host_cluster[r] to rank r's shared-memory array and hop_host_rank to
// the rank whose code runs, a remote address is the same offset in the
// peer's array, a bulk copy to it a memcpy, and the barriers do nothing.

#ifdef __CUDA_ARCH__
using HopDsmem = unsigned;  // a shared::cluster address
#else
using HopDsmem = unsigned char*;
#endif
#ifndef __CUDACC__
inline unsigned char* hop_host_cluster[16];
inline int hop_host_rank = 0;
#endif

// The address of `p` (in this block's shared memory) in block `rank` of the
// cluster.
__device__ __forceinline__ HopDsmem hop_mapa(const void* p, int rank) {
#ifdef __CUDA_ARCH__
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(hop_smem(p)), "r"(rank));
  return r;
#elif !defined(__CUDACC__)
  return hop_host_cluster[rank] +
         (static_cast<const unsigned char*>(p) - hop_host_cluster[hop_host_rank]);
#else
  return nullptr;
#endif
}
// Every thread of every block of the cluster arrives (release) and waits
// (acquire) for all the others.
__device__ __forceinline__ void hop_cluster_sync() {
#ifdef __CUDA_ARCH__
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
#endif
}
// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) of this
// block's shared memory at `src` to `dst` in a peer's (hop_mapa), completing
// its bytes on the peer's mbarrier `bar` (hop_mapa of the peer's barrier).
// The writers of `src` call hop_fence_async and synchronise first.
__device__ __forceinline__ void hop_bulk_s2s(HopDsmem dst, const void* src,
                                             unsigned bytes, HopDsmem bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(hop_smem(src)), "r"(bytes), "r"(bar)
      : "memory");
#elif !defined(__CUDACC__)
  std::memcpy(dst, src, bytes);
#endif
}
// One arrival (release at cluster scope) on a peer's mbarrier (hop_mapa).
__device__ __forceinline__ void hop_mbar_arrive_remote(HopDsmem bar) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::
                   "r"(bar)
               : "memory");
#endif
}
// hop_mbar_wait with acquire at cluster scope: the peers' arrivals order
// their earlier accesses before this thread's later ones.
__device__ __forceinline__ void hop_mbar_wait_cluster(uint64_t* bar,
                                                      unsigned parity) {
#ifdef __CUDA_ARCH__
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(hop_smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
#endif
}

// ---- warp roles --------------------------------------------------------------

// The next ticket of a counter in device memory that the blocks of a launch
// share (a dynamic scheduler of persistent blocks).
__device__ __forceinline__ unsigned long long hop_ticket(
    unsigned long long* ctr) {
#ifdef __CUDA_ARCH__
  return atomicAdd(ctr, 1ULL);
#else
  return (*ctr)++;
#endif
}

// v, the same in every lane of the warp, as the compiler can see it (a role
// index the warp branches on: ptxas serialises wgmma on a path it cannot
// prove warp-uniform)
__device__ __forceinline__ int hop_uniform(int v) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(0xffffffffu, v, 0);
#else
  return v;
#endif
}
// Raise (lower) the registers of each thread of this warpgroup to N (a
// multiple of 8); every warp of the warpgroup calls it.
template <int N>
__device__ __forceinline__ void hop_reg_alloc() {
#ifdef __CUDA_ARCH__
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
#endif
}
template <int N>
__device__ __forceinline__ void hop_reg_dealloc() {
#ifdef __CUDA_ARCH__
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
#endif
}

// ---- wgmma -----------------------------------------------------------------
// acc (64 x N, f32) += A (64 x K, registers) @ B (K x N, shared memory), N =
// 32 (or 16, 64), K = 8 TF32 values or 16 bf16 values (32 bytes).  B is K-major:
// for each of the N columns n its K values are contiguous, in the layout
// without swizzle:
// core matrices of 8 columns n by 16 bytes of k, 128 bytes each, those of one
// 8-column group side by side along k (hop_b_offset).  The four warps of a
// warpgroup call every function below together.

constexpr int kHopM = 64, kHopN = 32;

// Byte offset of element (n, byte kb of its K values) in a B operand of
// `kbytes` bytes of k a column (a multiple of 16).
__host__ __device__ inline int hop_b_offset(int n, int kb, int kbytes) {
  return ((n >> 3) * (kbytes >> 4) + (kb >> 4)) * 128 + (n & 7) * 16 +
         (kb & 15);
}

#ifdef __CUDA_ARCH__
constexpr bool kHopHost = false;
#else
constexpr bool kHopHost = true;
#endif

// One k step of an A operand: on the card this thread's four 32-bit
// registers of the m64 fragment (TF32: a value each; bf16: two), on the host
// the whole 64 x 16 tile as floats already rounded to the operand's type.
struct HopA {
#ifdef __CUDA_ARCH__
  uint32_t r[4];
#else
  float v[kHopM * 16];
#endif
};
// The 64 x N accumulator: this thread's N / 2 values, or the whole tile.
template <int N>
struct HopAccN {
#ifdef __CUDA_ARCH__
  float d[N / 2];
#else
  float d[kHopM * N];
#endif
};
using HopAcc = HopAccN<kHopN>;

template <int N>
__device__ __forceinline__ void hop_acc_zero(HopAccN<N>& acc) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(acc.d) / sizeof(float)); ++i) acc.d[i] = 0.f;
}

// f(row, column, value) for each accumulator element this thread holds
// (warp w of the warpgroup, lane): rows 16w + lane/4 and 8 below, columns
// 8j + 2(lane%4) and the next.
template <int N, typename F>
__device__ __forceinline__ void hop_acc_each(const HopAccN<N>& acc, int w,
                                             int lane, F f) {
#ifdef __CUDA_ARCH__
  const int r = 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    f(r, 8 * j + c, acc.d[4 * j]);
    f(r, 8 * j + c + 1, acc.d[4 * j + 1]);
    f(r + 8, 8 * j + c, acc.d[4 * j + 2]);
    f(r + 8, 8 * j + c + 1, acc.d[4 * j + 3]);
  }
#else
  for (int i = 0; i < kHopM * N; ++i) f(i / N, i % N, acc.d[i]);
#endif
}

// to the nearest TF32 value, ties away from zero (cvt.rna)
__device__ __forceinline__ float hop_tf32(float v) {
#ifdef __CUDA_ARCH__
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
#else
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u = (u + 0x1000u) & 0xFFFFE000u;
  std::memcpy(&v, &u, 4);
  return v;
#endif
}

// The A operands of k step `ks` (8 columns in TF32, 16 in bf16) of the
// 64-row tile whose f32 rows start at `tile`, `at(row, k)` giving the word
// offset of column k of row `row`: big = the operand's rounding of a, small
// that of a - big (written when `split`).
template <bool BF16, typename At>
__device__ __forceinline__ void hop_load_a(HopA& big, HopA& small, bool split,
                                           const float* tile, At at, int ks,
                                           int w, int lane) {
#ifdef __CUDA_ARCH__
  const int r0 = 16 * w + (lane >> 2), t = lane & 3;
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8, k = 16 * ks + 2 * t + (i >> 1) * 8;
      const float2 v = *reinterpret_cast<const float2*>(tile + at(row, k));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.x, v.y);
      big.r[i] = *reinterpret_cast<const uint32_t*>(&hi);
      if (split) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            v.x - __bfloat162float(hi.x), v.y - __bfloat162float(hi.y));
        small.r[i] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8, k = 8 * ks + t + (i >> 1) * 4;
      const float v = tile[at(row, k)];
      const float b = hop_tf32(v);
      big.r[i] = __float_as_uint(b);
      if (split) small.r[i] = __float_as_uint(hop_tf32(v - b));
    }
  }
#else
  constexpr int K = BF16 ? 16 : 8;
  for (int row = 0; row < kHopM; ++row)
    for (int k = 0; k < K; ++k) {
      const float v = tile[at(row, K * ks + k)];
      float b;
      if constexpr (BF16) b = __bfloat162float(__float2bfloat16(v));
      else b = hop_tf32(v);
      big.v[row * 16 + k] = b;
      if (split) {
        if constexpr (BF16)
          small.v[row * 16 + k] = __bfloat162float(__float2bfloat16(v - b));
        else
          small.v[row * 16 + k] = hop_tf32(v - b);
      }
    }
#endif
}

// hop_load_a for an A operand already stored as bf16: element (row, k) of
// its hi part at hi[at(row, k)] (k even: the pair k, k + 1 adjacent), of its
// lo part `lo` elements further on (read when `split`).
template <typename At>
__device__ __forceinline__ void hop_load_a_bf16(HopA& big, HopA& small,
                                                bool split,
                                                const __nv_bfloat16* hi,
                                                long long lo, At at, int ks,
                                                int w, int lane) {
#ifdef __CUDA_ARCH__
  const int r0 = 16 * w + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = at(r0 + (i & 1) * 8, 16 * ks + 2 * t + (i >> 1) * 8);
    big.r[i] = *reinterpret_cast<const uint32_t*>(hi + e);
    if (split) small.r[i] = *reinterpret_cast<const uint32_t*>(hi + lo + e);
  }
#else
  for (int row = 0; row < kHopM; ++row)
    for (int k = 0; k < 16; ++k) {
      const int e = at(row, 16 * ks + k);
      big.v[row * 16 + k] = __bfloat162float(hi[e]);
      if (split) small.v[row * 16 + k] = __bfloat162float(hi[lo + e]);
    }
#endif
}

// f(row, column, value, next value) for each pair of adjacent accumulator
// columns (column even) this thread holds, as hop_acc_each.
template <int N, typename F>
__device__ __forceinline__ void hop_acc_pairs(const HopAccN<N>& acc, int w,
                                              int lane, F f) {
#ifdef __CUDA_ARCH__
  const int r = 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    f(r, 8 * j + c, acc.d[4 * j], acc.d[4 * j + 1]);
    f(r + 8, 8 * j + c, acc.d[4 * j + 2], acc.d[4 * j + 3]);
  }
#else
  for (int i = 0; i < kHopM * N; i += 2) f(i / N, i % N, acc.d[i], acc.d[i + 1]);
#endif
}

// Keep an operand's registers the compiler's until here: a wgmma reads them
// until it has been waited for, long after the statement that launched it.
__device__ __forceinline__ void hop_keep(HopA& a) {
#ifdef __CUDA_ARCH__
  asm volatile("" : "+r"(a.r[0]), "+r"(a.r[1]), "+r"(a.r[2]), "+r"(a.r[3])::"memory");
#endif
}

// Keep the compiler from moving any access to the accumulator's registers
// across this point (the wgmma wait's asm names no register): before the
// first wgmma of a pipeline and after each wait, so that no instruction
// that defines them lands between a wgmma and its wait, where ptxas would
// serialise every wgmma of the kernel (C7515).
template <int N>
__device__ __forceinline__ void hop_acc_fence(HopAccN<N>& acc) {
#ifdef __CUDA_ARCH__
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc.d[i])::"memory");
#endif
}

// Order this thread's register and shared-memory accesses before the
// wgmmas that follow; close a group of wgmmas; wait for groups.
__device__ __forceinline__ void hop_wgmma_fence() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#endif
}
__device__ __forceinline__ void hop_wgmma_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#endif
}
template <int N>  // all but the N newest groups
__device__ __forceinline__ void hop_wgmma_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
#endif
}

// acc += a @ B for k step `ks` of the B operand at `b` (hop_b_offset layout,
// `kbytes` bytes of k a column); acc = a @ B where acc_in is false (the
// accumulator's first product: no instruction of the thread need define its
// registers first).  Asynchronous on the card: a and acc are not to be
// touched until hop_wgmma_wait has waited for its group.
template <bool BF16, int N>
__device__ __forceinline__ void hop_wgmma(HopAccN<N>& acc, const HopA& a,
                                          const void* b, int ks, int kbytes,
                                          bool acc_in = true) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma n16, n32 or n64");
#ifdef __CUDA_ARCH__
  // descriptor: address, leading (k) and stride (n) byte offsets of the core
  // matrices, all in units of 16 bytes; no swizzle
  const uint64_t desc =
      (uint64_t)(((hop_smem(b) + ks * 256) & 0x3FFFF) >> 4) |
      ((uint64_t)(128 >> 4) << 16) | ((uint64_t)((kbytes >> 4) * 128 >> 4) << 32);
  float* d = acc.d;
  if constexpr (N == 64) {
#define TPUFEM_HOP_D64                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define TPUFEM_HOP_DREGS64                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1"
    if constexpr (BF16)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
          TPUFEM_HOP_DREGS64 ", 0;\n}"
          : TPUFEM_HOP_D64
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
            "r"((int)acc_in));
    else
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
          TPUFEM_HOP_DREGS64 ";\n}"
          : TPUFEM_HOP_D64
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
            "r"((int)acc_in));
#undef TPUFEM_HOP_DREGS64
#undef TPUFEM_HOP_D64
  } else if constexpr (N == 16) {
    if constexpr (BF16)
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
          "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
          "1, 0;\n}"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
            "r"((int)acc_in));
    else
      asm volatile(
          "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
          " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
          "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
          "1;\n}"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
            "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
          : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
            "r"((int)acc_in));
  } else if constexpr (BF16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
          "r"((int)acc_in));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "l"(desc),
          "r"((int)acc_in));
  }
#else
  constexpr int K = BF16 ? 16 : 8, E = BF16 ? 2 : 4;
  if (!acc_in) hop_acc_zero(acc);
  const unsigned char* bb = static_cast<const unsigned char*>(b);
  for (int n = 0; n < N; ++n)
    for (int k = 0; k < K; ++k) {
      const unsigned char* p = bb + hop_b_offset(n, (K * ks + k) * E, kbytes);
      float bv;
      if constexpr (BF16) {
        __nv_bfloat16 h;
        std::memcpy(&h, p, 2);
        bv = __bfloat162float(h);
      } else {
        std::memcpy(&bv, p, 4);
      }
      for (int m = 0; m < kHopM; ++m) acc.d[m * N + n] += a.v[m * 16 + k] * bv;
    }
#endif
}

}  // namespace tpufem
