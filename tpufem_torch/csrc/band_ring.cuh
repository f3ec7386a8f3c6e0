// The all-band ring: the block skeleton shared by the routines that band
// every axis of a 2D or 3D grid on Hopper's TMA (resident_ring.cuh: K1, K3,
// K4; the kernel lab's vcopy, vband and v16 in lab_zyfirst.cuh).
//
// A block owns a (TZ, TY) sub-tile of the output rows (2D: (1, TY)) over
// chunks [c0, c1) of x (a segment; K1, K4 and the lab: all of x) and walks
// them in chunks of XC columns (ring_xc: 64 bytes of a row in 3D; 128 bytes,
// at most 32 columns, in 2D, whose boxes are TZ + 2P times thinner).  Its
// threads are kRingWarps consumer warps and one producer warp:
//   producer  one thread asks for each halo'd u box (TZ+2P, TY+2P, XC) (2D:
//             (TY+2P, XC)) by TMA, into one of kRingStages slots; what lies
//             beyond the tensor arrives as zeros, so no thread computes an
//             address or tests a bound on the way in
//   full      a slot's mbarrier, armed with the box's bytes: the consumers
//             wait on it
//   empty     a slot's other mbarrier: each consumer warp arrives once it has
//             read the slot, and the producer waits for all of them before
//             it reuses the slot
//   window    x bands read x +- P only, so the y stage's outputs are kept for
//             a window of columns (circular, a few chunks wide): once chunk c
//             has its y outputs, the x band writes chunk c - 1, and every
//             stored box starts on a chunk
//   segment   the x band of chunk c0 reads chunk c0 - 1's last P columns and
//             that of c1 - 1 chunk c1's first P, so a block loads chunk
//             c0 - 1 and chunk c1 too, where they exist, and stores [c0, c1)
//             (ring_segment; the host picks the count, choose_segments in
//             ops/kernel_separable.py)
//   out       each consumer warp owns a (TZ/nwz, TY/nwy) piece of the rows
//             (ring_pieces) and stores its piece of every chunk as one TMA
//             box from one of two output slots, reused once the store of two
//             chunks ago has been read (bulk wait_group); a box is clipped at
//             the tensor's ragged edge
// The routines keep their own stages between those pieces: which bands run
// on the slot, how many windows, what the store adds.
//
// One host thread (blockDim 1, the g++ builds of the tests) runs a block: the
// mbarrier calls do nothing, the thread loads each box itself before it
// waits (ring_solo), then runs each warp's piece, lane by lane where a
// routine needs its lanes apart.
#pragma once

#include "hopper.cuh"

#ifdef __CUDACC__
#include <atomic>
#endif

namespace tpufem {

constexpr int kRingWarps = 8;  // consumer warps of a block; one more produces
constexpr int kRingThreads = 32 * (kRingWarps + 1);
constexpr int kRingStages = 3;  // u slots of the ring

__host__ __device__ inline long long ring_align(long long b) {
  return (b + 127) / 128 * 128;
}

// x columns per chunk: 64 bytes of a row in 3D; in 2D 128 bytes, at most 32
// columns (a lane keeps its column: XC divides the warp)
__host__ __device__ constexpr int ring_xc(int elem, int dim = 3) {
  return dim == 2 ? (128 / elem < 32 ? 128 / elem : 32) : 64 / elem;
}

// How the consumer warps share a (tz, ty) sub-tile: nwz x nwy pieces of
// (bz, by) rows, piece w at (w / nwy, w % nwy).
struct RingPieces {
  int nwz, nwy, bz, by;
};
__host__ __device__ inline RingPieces ring_pieces(int tz, int ty) {
  RingPieces q;
  q.nwz = tz < kRingWarps ? tz : kRingWarps;
  q.nwy = kRingWarps / q.nwz;
  q.bz = tz / q.nwz;
  q.by = ty / q.nwy;
  return q;
}
// The pieces tile (tz, ty), each piece's box of a chunk is a multiple of 128
// bytes (chunk rows are 64 bytes) and the halo'd box fits a TMA box.
__host__ __device__ inline bool ring_pieces_take(int p, int tz, int ty) {
  if (tz < 1 || ty < 1) return false;
  const RingPieces q = ring_pieces(tz, ty);
  return kRingWarps % q.nwz == 0 && q.nwz * q.bz == tz &&
         q.nwy * q.by == ty && q.bz * q.by % 2 == 0 && tz + 2 * p <= 256 &&
         ty + 2 * p <= 256;
}

// A barrier of the consumer threads (the producer warp has left): named
// barrier 1.
__device__ __forceinline__ void ring_sync(int count) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
#endif
}

// The ring of u slots and their barriers in shared memory.
struct Ring {
  uint64_t* full;  // kRingStages, then kRingStages `empty`
  unsigned char* slots;
  long long slot_bytes;
  unsigned box_bytes;

  __device__ __forceinline__ uint64_t* empty() const {
    return full + kRingStages;
  }
  // tid 0 of the block; then a block barrier before anyone uses the ring
  __device__ __forceinline__ void init(int tid) const {
    if (tid != 0) return;
    for (int s = 0; s < kRingStages; ++s) {
      hop_mbar_init(full + s, 1);
      hop_mbar_init(empty() + s, kRingWarps);
    }
    hop_mbar_init_fence();
  }
  __device__ __forceinline__ unsigned char* slot(int k) const {
    return slots + (k % kRingStages) * slot_bytes;
  }
  // box k (the k-th the block loads) at element coordinates (c0, c1, c2)
  __device__ __forceinline__ void load(int k, const HopMap* map, int c0,
                                       int c1, int c2) const {
    hop_mbar_expect(full + k % kRingStages, box_bytes);
    hop_tma_load(slot(k), map, full + k % kRingStages, c0, c1, c2);
  }
  // the producer, before box k: its slot's readers of box k - kRingStages
  // are done
  __device__ __forceinline__ void reusable(int k) const {
    if (k >= kRingStages)
      hop_mbar_wait(empty() + k % kRingStages, (k / kRingStages - 1) & 1);
  }
  __device__ __forceinline__ void wait(int k) const {
    hop_mbar_wait(full + k % kRingStages, (k / kRingStages) & 1);
  }
  __device__ __forceinline__ void release(int k) const {
    hop_mbar_arrive(empty() + k % kRingStages);
  }
};

// Chunks [c0, c1) of segment s of nseg over nchunk chunks: sizes differ by
// one at most, none empty while nseg <= nchunk.
__host__ __device__ inline void ring_segment(int s, int nseg, int nchunk,
                                             int& c0, int& c1) {
  c0 = (int)((long long)s * nchunk / nseg);
  c1 = (int)((long long)(s + 1) * nchunk / nseg);
}

// A consumer warp's output slot, before it is written: the store of two
// chunks ago has been read.
__device__ __forceinline__ void ring_out_acquire(int lane) {
  if (lane == 0) hop_store_wait<1>();
  __syncwarp();
}
// After it is written: the writes made visible to TMA, then lane 0 releases
// `slot_read` (the u slot this warp read, unless null), stores the box when
// `store` and commits.
__device__ __forceinline__ void ring_out_store(int lane, const HopMap* map,
                                               const void* box, bool store,
                                               int c0, int c1, int c2,
                                               const Ring* ring = nullptr,
                                               int slot_read = -1) {
  hop_fence_async();
  __syncwarp();
  if (lane == 0) {
    if (ring && slot_read >= 0) ring->release(slot_read);
    if (store) hop_tma_store(map, box, c0, c1, c2);
    hop_store_commit();
  }
}

// The 2P+1 window values of columns x - P .. x + P (columns beyond [0, X)
// are zeros) of one row of a circular window of WX columns, column c in slot
// c % WX.
template <int P, int WX, typename C>
__device__ __forceinline__ void ring_taps(const C* row, int x, int X,
                                          C (&v)[2 * P + 1]) {
  int wi = (x + WX - P) % WX;  // the slot of column x - P
#pragma unroll
  for (int k = 0; k <= 2 * P; ++k) {
    const int xi = x + k - P;
    v[k] = xi >= 0 && xi < X ? row[wi] : C(0);
    wi = wi + 1 == WX ? 0 : wi + 1;
  }
}

#ifdef __CUDACC__
// Opt a kernel into `smem` bytes of dynamic shared memory on the current
// device, once per kernel and device (again only for a larger block).
constexpr int kRingMaxDevices = 64;
template <typename Kern>
cudaError_t ring_opt_in(Kern kern, int smem, std::atomic<int>* granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kRingMaxDevices) return cudaErrorInvalidDevice;
  if (smem > granted[dev].load()) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    granted[dev].store(smem);
  }
  return cudaSuccess;
}
#endif

}  // namespace tpufem
