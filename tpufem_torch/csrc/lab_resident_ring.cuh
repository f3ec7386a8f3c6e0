// The K1 kernel lab's v17 and v19 on Hopper's asynchronous machinery: the z/y
// bands of a sub-tile fed by a TMA ring, the x stage on wgmma over x chunks.
// Device code; the host launcher is lab_resident.cu, the design note of the
// lab and of the tile routine (lab_tile_kernel, lab_pipe_kernel: the earlier
// schedule of v17 and v19, still built) is lab_resident.cuh's.
//
// Both compute what _kernel_v17 (scripts/kernel_lab.py:581) computes, on the
// same resident layout (sz, sy, X), from the same host tables: out rows =
// [q1 | q23] @ [Kx^T; Mx^T] over all 2X rows (the dense x stage), every layout
// point written, halo and padding zeros included.
//
// One sub-tile (TZ, TY) of M = 64 data rows (one wgmma M; (8, 8) unless asked)
// over x chunks of XC columns (64 bytes of a row: 16 in f32, 8 in f64):
//   load   a producer warp asks for the chunk's halo'd u box (TZ+2P, TY+2P, XC)
//          by TMA into a ring of nu slots (zero fill beyond the layout), and
//          for the chunk's rows of the x operator by one bulk copy into a ring
//          of nb B stages; `full` mbarriers count the bytes, `empty` ones the
//          readers
//   bands  z, then y, as the tile routine's lab_bands: the same band tables, the same
//          difference-form taps in the same order (band2 runs band's
//          operations for two tables on one read of the input), so qq, and
//          the copy and bands ablations, are the tile routine's bit for bit; qq = [q1 |
//          q23] of the chunk, (M, 2 XC), lands in a qq stage in the A
//          operand's layout (lr_at)
//   x      B, the chunk's 2 XC rows of [Kx^T; Mx^T] (rows c0.. of the Kx^T half
//          and X + c0.. of the Mx^T half) for the block's columns, is split on
//          the host with the kernel's own rounding (3xTF32: big and small;
//          1xTF32: one rounding; bf16x3: hi and lo) and laid out as wgmma's
//          K-major B operand (hop_b_offset), so it reaches shared memory in one
//          copy and is never split again; each of two warpgroups multiplies
//          the qq stage (A from registers: hop_load_a splits it) by its half of
//          the column blocks, n32 wgmmas (kLrNBW a warpgroup), the output (64,
//          X) accumulated in registers over all chunks (a split-K over x); the
//          three 3xTF32 products keep l2_xring's order (small*big, big*small,
//          big*big).  f64 has no wgmma: DMMA m8n8k4 (WMMA) from the same
//          stages, each warp an 8-row tile by up to kLrF64Tiles 8-column tiles
//   store  after the last chunk, the accumulators straight to the data rows
//          (rows beyond npts and columns beyond X masked); boundary sub-tiles
//          write the halo zeros of the rows they own
// The products sit in registers only after the last chunk, so the columns a
// block multiplies are bounded (lr_max_cols: 320 on wgmma, 160 in f64); a
// wider X is cut into column splits, each block running the bands again.
//
// v17 (lab_ring_kernel): one block per sub-tile and split; eight warps run
// the bands of chunk c, then issue its products and go on to the bands of
// chunk c + 1 while the tensor cores run them (wgmma is asynchronous): the
// product of a chunk overlaps the next chunk's bands, one block an SM.
// The band stages are bound by their instructions and latency, not by
// shared memory: they run at the chooser's sub-tile as a compile-time
// instance (lr_bands_any), whose index arithmetic folds into shifts.
// v19 (lab_ring_pipe_kernel): persistent blocks take the sub-tiles from a
// ticket counter, so a block that is ahead takes more (on an H100 a static
// walk b, b + G, ... ran 0.97 ms an apply at the flagship where one
// sub-tile a block ran 0.76 and the counter 0.73, at any grid); a band team
// (seven warps) fills a ring of nq qq stages,
// the two x-stage warpgroups (setmaxnreg gives them the band warps' spare
// registers) drain it (full/empty mbarriers in place of the block-wide
// barrier of the tile routine's v19), and the producer runs on into the next sub-tile,
// so the store of one sub-tile and the loads of the next overlap the bands.
//
// What bounds it on an H100: the function is K1's, 0.0405 ms at 16,974,593
// DoFs in f32.  The design adds: the padded layout (0.046 ms), 5 band stages
// on CUDA cores, the dense x product over the sub-tiles' rows and the padded
// columns (3xTF32 at the flagship: 3 x 2 x 69,696 x 544 x 288 = 65.5 GFLOP,
// 0.132 ms at 495 TFLOP/s), and B streamed from L2 into every block (1.25 MB
// a sub-tile in 3xTF32, 1.36 GB an apply): shared memory holds one chunk's
// B, not all of it.  PERF.md has the measured split.
//
// One host thread (blockDim 1, the g++ build of the tests) runs a block: the
// mbarrier calls do nothing, the thread loads each chunk itself before it
// waits, runs the bands, then both warpgroups' products in turn (a wgmma
// operand or accumulator holds its whole tile, hopper.cuh).
#pragma once

#include "hopper.cuh"
#include "lab_resident.cuh"

namespace tpufem {

constexpr int kLrM = kHopM;  // rows of a sub-tile, TZ TY: one wgmma M
constexpr int kLrWarps = 8;  // x-stage warps, two warpgroups (v17: bands too)
constexpr int kLrBandWarps = 7;  // v19's band warps
constexpr int kLrThreads = 32 * (kLrWarps + 1);  // v17: and a producer warp
constexpr int kLrPipeThreads = 32 * (kLrWarps + kLrBandWarps + 1);  // v19
// v19's registers a thread: the x-stage warpgroups take what the band and
// producer warps give up (2 x 128 x (160 + 96) = the SM's 65,536)
constexpr int kLrXRegs = 160, kLrBandRegs = 96;
constexpr int kLrNBW = 5;  // n32 column blocks of a warpgroup
constexpr int kLrF64Tiles = 20;  // f64: 8-column tiles of a warp
constexpr int kLrMaxU = 3, kLrMaxB = 2, kLrMaxQ = 2;  // deepest rings
// v19's slots of the units in flight in a block (the producer runs at most
// kLrMaxU + kLrMaxQ + 1 units ahead of the x stage)
constexpr int kLrUnits = 8;

// x columns of a chunk (64 bytes of a row); the qq stage's K is twice that
__host__ __device__ constexpr int lr_xc(int xp) {
  return xp == kXF64 ? 8 : 16;
}
// parts of the B operand (split products) and the bytes of its elements
__host__ __device__ constexpr int lr_parts(int xp) {
  return xp == kX3TF32 || xp == kXBF16x3 ? 2 : 1;
}
__host__ __device__ constexpr int lr_belem(int xp) {
  return xp == kXF64 ? 8 : xp == kXBF16x3 ? 2 : 4;
}
// columns of the x operator a block multiplies at most
__host__ __device__ constexpr int lr_max_cols(int xp) {
  return xp == kXF64 ? 8 * kLrF64Tiles : 2 * kLrNBW * kHopN;
}

// One launch: the layout, the ring depths (u slots, B stages, qq stages), the
// columns of a block (a multiple of 32) and the column splits of X.
struct LrGeo {
  LabGeo g;
  int nu, nb, nq, ncols, nsplit;
};

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   bar  the rings' mbarriers (lr_bars), then v19's unit slots (kLrUnits)
//   tab  z/y table rows of the sub-tile [Ky, My (TY rows), Kz, Mz (TZ rows)]
//   u    nu slots of the halo'd u box (TZ+2P, TY+2P, XC)
//   st   s and t (2, TZ, TY+2P, XC)
//   qq   nq stages of [q1 | q23] (M, 2 XC)
//   b    nb stages of B, its parts one after the other (b_part bytes each:
//        exactly the host's, so one bulk copy fills a stage)
//   scr  f64: one 8 x 8 accumulator tile a warp
struct LrSmem {
  long long bar, units, tab, u, u_bytes, st, qq, qq_bytes, b, b_part,
      b_bytes, scr, total;
};
__host__ __device__ inline LrSmem lr_smem(int p, int xp, int tz, int ty,
                                          int nu, int nb, int nq, int ncols) {
  const long long c = xp == kXF64 ? 8 : 4, nw = 2 * p + 2;
  const long long lz = tz + 2 * p, ly = ty + 2 * p, xc = lr_xc(xp);
  LrSmem s;
  s.bar = 0;
  s.units = 2 * (kLrMaxU + kLrMaxB + kLrMaxQ) * 8;
  s.tab = lab_align(s.units + kLrUnits * 4);
  s.u = s.tab + lab_align(2LL * (tz + ty) * nw * c);
  s.u_bytes = lab_align(lz * ly * xc * c);
  s.st = s.u + nu * s.u_bytes;
  s.qq = s.st + lab_align(2 * tz * ly * xc * c);
  s.qq_bytes = lab_align((long long)tz * ty * 2 * xc * c);
  s.b = s.qq + nq * s.qq_bytes;
  s.b_part = (long long)ncols * 2 * xc * lr_belem(xp);  // 128-byte multiple
  s.b_bytes = lr_parts(xp) * s.b_part;
  s.scr = s.b + nb * s.b_bytes;
  s.total = s.scr + (xp == kXF64 ? lab_align(kLrWarps * 64 * 8) : 0);
  return s;
}

// The rings' mbarriers: u, B and qq, a full and an empty one a slot.
struct LrBars {
  uint64_t* b;
  __device__ __forceinline__ uint64_t* uf(int s) const { return b + s; }
  __device__ __forceinline__ uint64_t* ue(int s) const {
    return b + kLrMaxU + s;
  }
  __device__ __forceinline__ uint64_t* bf(int s) const {
    return b + 2 * kLrMaxU + s;
  }
  __device__ __forceinline__ uint64_t* be(int s) const {
    return b + 2 * kLrMaxU + kLrMaxB + s;
  }
  __device__ __forceinline__ uint64_t* qf(int s) const {
    return b + 2 * (kLrMaxU + kLrMaxB) + s;
  }
  __device__ __forceinline__ uint64_t* qe(int s) const {
    return b + 2 * (kLrMaxU + kLrMaxB) + kLrMaxQ + s;
  }
  // tid 0 of the block; then a block barrier.  A u slot is released by one
  // band thread, a B stage by each x-stage warp, a qq stage (v19) by each
  // x-stage warp once it holds its operand.
  __device__ __forceinline__ void init(int tid) const {
    if (tid != 0) return;
    for (int s = 0; s < kLrMaxU; ++s) {
      hop_mbar_init(uf(s), 1);
      hop_mbar_init(ue(s), 1);
    }
    for (int s = 0; s < kLrMaxB; ++s) {
      hop_mbar_init(bf(s), 1);
      hop_mbar_init(be(s), kLrWarps);
    }
    for (int s = 0; s < kLrMaxQ; ++s) {
      hop_mbar_init(qf(s), 1);
      hop_mbar_init(qe(s), kLrWarps);
    }
    hop_mbar_init_fence();
  }
};

// Wait for the phase of item k of an n-slot ring (parity k / n), or, before
// the slot is filled again, for the readers of item k - n.
__device__ __forceinline__ void lr_wait_full(uint64_t* bar, long long k,
                                             int n) {
  hop_mbar_wait(bar, (unsigned)((k / n) & 1));
}
__device__ __forceinline__ void lr_wait_empty(uint64_t* bar, long long k,
                                              int n) {
  if (k >= n) hop_mbar_wait(bar, (unsigned)((k / n - 1) & 1));
}

// Word offset of element (m, k) of a qq stage, the A operand of 64 rows by K
// (2 XC) columns: f32 rows of 128 bytes with their 16-byte pieces permuted by
// the row (a TF32 fragment's 8 rows x 4 columns fall in 32 banks, a bf16
// fragment's pairs stay together); f64 rows as they are (WMMA's row-major A).
template <int XP>
__host__ __device__ __forceinline__ int lr_at(int m, int k) {
  if constexpr (XP == kXF64) return m * 16 + k;
  else return m * 32 + (k ^ ((m & 7) << 2));
}

// The producer's item k: the u box of chunk cx0 of the sub-tile at (z0, y0)
// into u slot k % nu, and, with_b, the chunk's B stage (b_bytes at bsrc) into
// B stage k % nb.
template <typename C>
__device__ __forceinline__ void lr_produce(const LrBars& br,
                                           unsigned char* smem,
                                           const LrSmem& pl, const LrGeo& q,
                                           long long k, const HopMap* map,
                                           int cx0, int y0, int z0,
                                           unsigned ubytes,
                                           const unsigned char* bsrc,
                                           bool with_b) {
  const int su = (int)(k % q.nu);
  lr_wait_empty(br.ue(su), k, q.nu);
  hop_mbar_expect(br.uf(su), ubytes);
  hop_tma_load(smem + pl.u + su * pl.u_bytes, map, br.uf(su), cx0, y0, z0);
  if (!with_b) return;
  const int sb = (int)(k % q.nb);
  lr_wait_empty(br.be(sb), k, q.nb);
  hop_mbar_expect(br.bf(sb), (unsigned)pl.b_bytes);
  hop_bulk_load(smem + pl.b + sb * pl.b_bytes, bsrc, (unsigned)pl.b_bytes,
                br.bf(sb));
}

// The sub-tile's table rows [Ky, My (TY rows), Kz, Mz (TZ rows)] into `tab`
// (zeros beyond npts), as lab_bands loads them.
template <int P, typename C>
__device__ void lr_tables(const C* __restrict__ tables, const LabGeo& g,
                          int z0, int y0, C* tab, int tid, int nthr) {
  constexpr int NW = 2 * P + 2;
  const int tz = g.tz, ty = g.ty, npts = g.npts;
  const long long tsz = (long long)npts * NW;
  C* wkz = tab + 2 * ty * NW;
  for (int i = tid; i < 2 * ty * NW; i += nthr) {
    const int k = i / (ty * NW), j = i - k * ty * NW, r = j / NW;
    const int gg = y0 + r;
    tab[i] = gg < npts ? tables[k * tsz + (long long)gg * NW + (j - r * NW)]
                       : C(0);
  }
  for (int i = tid; i < 2 * tz * NW; i += nthr) {
    const int k = i / (tz * NW), j = i - k * tz * NW, r = j / NW;
    const int gg = z0 + r;
    wkz[i] = gg < npts
                 ? tables[(2 + k) * tsz + (long long)gg * NW + (j - r * NW)]
                 : C(0);
  }
}

// The band stages of one chunk (x columns [cx0, cx0 + XC)) of the sub-tile at
// (z0, y0), from the u box U, by a team of `nthr` threads (tid within it,
// named barrier `bar`):
//   kFull   qq = [q1 | q23]         kMM     qq = [u | u]
//   kBands  out rows = q1 + q23     kCopy   out rows = u
// the last two straight to the layout, masked to the data rows.  free_u()
// runs on one thread once U has been read; the team's barrier ends the
// stage (qq complete; s and t free).  TZ, TY: the sub-tile as compile-time
// constants (the chooser's (8, 8): the index arithmetic of every output
// folds into shifts), or 0 for g's.
template <int P, int XP, int TZ, int TY, typename Free>
__device__ void lr_bands(const typename LabMma<XP>::C* U,
                         const typename LabMma<XP>::C* tab,
                         typename LabMma<XP>::C* s, typename LabMma<XP>::C* t,
                         typename LabMma<XP>::C* qq, const LabGeo& g, int z0,
                         int y0, int cx0, int mode,
                         typename LabMma<XP>::C* __restrict__ out, int tid,
                         int nthr, int bar, Free free_u) {
  using C = typename LabMma<XP>::C;
  constexpr int NW = 2 * P + 2, XC = lr_xc(XP);
  const int tz = TZ ? TZ : g.tz, ty = TY ? TY : g.ty, ly = ty + 2 * P;
  const C* wky = tab;
  const C* wmy = wky + ty * NW;
  const C* wkz = wmy + ty * NW;
  const C* wmz = wkz + tz * NW;
  const LabRows rows{g, z0, y0, P};
  if (mode == kCopy || mode == kMM) {
    for (int i = tid; i < tz * ty * XC; i += nthr) {
      const int ix = i % XC, m = i / XC, iy = m % ty, iz = m / ty;
      const C v = U[((long long)(iz + P) * ly + iy + P) * XC + ix];
      if (mode == kCopy) {
        const long long o = rows(m);
        if (o >= 0) out[o + cx0 + ix] = v;
      } else {
        qq[lr_at<XP>(m, ix)] = v;
        qq[lr_at<XP>(m, XC + ix)] = v;
      }
    }
    lab_sync(bar, nthr);
    if (tid == 0) free_u();
    return;
  }
  // z stage: (LZ, LY, XC) -> s = Bz(u; Mz), t = Bz(u; Kz) (TZ, LY, XC)
  const long long zs = (long long)ly * XC;
  for (int i = tid; i < tz * ly * XC; i += nthr) {
    const int iz = i / (ly * XC);
    band2<P>(wmz + iz * NW, wkz + iz * NW, U + i, zs, s[i], t[i]);
  }
  lab_sync(bar, nthr);
  if (tid == 0) free_u();
  // y stage: q1 = By(s; My), q23 = By(s; Ky) + By(t; My) (TZ, TY, XC)
  for (int i = tid; i < tz * ty * XC; i += nthr) {
    const int ix = i % XC, m = i / XC, iy = m % ty, iz = m / ty;
    const long long base = ((long long)iz * ly + iy) * XC + ix;
    C q1, q2;
    band2<P>(wmy + iy * NW, wky + iy * NW, s + base, XC, q1, q2);
    const C q23 = q2 + band<P>(wmy + iy * NW, t + base, XC);
    if (mode == kBands) {
      const long long o = rows(m);
      if (o >= 0) out[o + cx0 + ix] = q1 + q23;
    } else {
      qq[lr_at<XP>(m, ix)] = q1;
      qq[lr_at<XP>(m, XC + ix)] = q23;
    }
  }
  lab_sync(bar, nthr);
}

// lr_bands at the sub-tile's compile-time instance where it has one.
template <int P, int XP, typename Free>
__device__ __forceinline__ void lr_bands_any(
    const typename LabMma<XP>::C* U, const typename LabMma<XP>::C* tab,
    typename LabMma<XP>::C* s, typename LabMma<XP>::C* t,
    typename LabMma<XP>::C* qq, const LabGeo& g, int z0, int y0, int cx0,
    int mode, typename LabMma<XP>::C* __restrict__ out, int tid, int nthr,
    int bar, Free free_u) {
  if (g.tz == 8 && g.ty == 8)
    lr_bands<P, XP, 8, 8>(U, tab, s, t, qq, g, z0, y0, cx0, mode, out, tid,
                          nthr, bar, free_u);
  else
    lr_bands<P, XP, 0, 0>(U, tab, s, t, qq, g, z0, y0, cx0, mode, out, tid,
                          nthr, bar, free_u);
}

// The x stage on wgmma (3xTF32, 1xTF32, bf16x3): warpgroup wg holds the
// products of the column blocks wg kLrNBW .. + kLrNBW - 1 of the block's nbl;
// one past the last multiplies the last again and is not stored, so no wgmma
// depends on a run-time condition.  One host thread stands for both
// warpgroups (acc holds both, issue and store run them in turn).
template <int XP>
struct LrWgmma {
  static constexpr bool BF = XP == kXBF16x3;
  static constexpr bool kSplit = lr_parts(XP) == 2;
  static constexpr int KS = BF ? 2 : 4;  // k steps of a chunk (K = 32)
  static constexpr int kbytes = 32 * (BF ? 2 : 4);  // B bytes of k a column
  static constexpr int NG = kHopHost ? 2 : 1;
  HopAcc acc[NG * kLrNBW];
  HopA big[KS], small[KS];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NG * kLrNBW; ++j) hop_acc_zero(acc[j]);
  }
  // A from the qq stage, the chunk's products against the B stage
  // (asynchronous on the card), then held_a(): the qq stage may be reused.
  template <typename Held>
  __device__ __forceinline__ void issue(const float* qq,
                                        const unsigned char* B,
                                        long long b_part, int nbl, int wg,
                                        int w, int lane, Held held_a) {
    auto one = [&](int g, HopAcc* d) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        hop_load_a<BF>(big[ks], small[ks], kSplit, qq,
                       [](int r, int k) { return lr_at<XP>(r, k); }, ks, w,
                       lane);
      hop_wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int part = kSplit ? 0 : 2; part < 3; ++part)
#pragma unroll
          for (int j = 0; j < kLrNBW; ++j) {
            const int bj =
                g * kLrNBW + j < nbl ? g * kLrNBW + j : nbl - 1;
            hop_wgmma<BF>(d[j], part == 0 ? small[ks] : big[ks],
                          B + (part == 1 ? b_part : 0) +
                              (long long)bj * kHopN * kbytes,
                          ks, kbytes);
          }
      hop_wgmma_commit();
      if (!kHopHost || g == NG - 1) held_a();  // its A is in registers
    };
    if constexpr (kHopHost) {
      for (int g = 0; g < NG; ++g) one(g, acc + g * kLrNBW);
    } else {
      one(wg, acc);
    }
  }
  // the products issued so far are done: their operands are free
  __device__ __forceinline__ void retire() {
    hop_wgmma_wait<0>();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      hop_keep(big[ks]);
      if constexpr (kSplit) hop_keep(small[ks]);
    }
  }
  // st(m, n, v) for each product (n: the block's column), then zeros
  template <typename St>
  __device__ __forceinline__ void store(int nbl, int wg, int w, int lane,
                                        St st) {
    for (int g = kHopHost ? 0 : wg; g < (kHopHost ? NG : wg + 1); ++g) {
      HopAcc* d = acc + (kHopHost ? g * kLrNBW : 0);
#pragma unroll
      for (int j = 0; j < kLrNBW; ++j) {
        const int bj = g * kLrNBW + j;
        if (bj < nbl)
          hop_acc_each(d[j], w, lane, [&](int r, int c, float v) {
            st(r, bj * kHopN + c, v);
          });
        hop_acc_zero(d[j]);
      }
    }
  }
};

// The x stage in f64: DMMA m8n8k4 (WMMA) from the stages; warp w multiplies
// the 8-row tile w by the block's nbl * 4 8-column tiles.  One host thread
// stands for the eight warps.
struct LrDmma {
  using T = LabMma<kXF64>;
  using FA = typename LabFrag<kXF64>::FA;
  using FC = typename LabFrag<kXF64>::FC;
  using FB = wmma::fragment<wmma::matrix_b, T::M, T::N, T::K, double,
                            wmma::col_major>;
  static constexpr int NG = kHopHost ? kLrWarps : 1;
  static constexpr int K = 2 * lr_xc(kXF64);
  FC acc[NG * kLrF64Tiles];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NG * kLrF64Tiles; ++j)
      wmma::fill_fragment(acc[j], 0.0);
  }
  template <typename Held>
  __device__ __forceinline__ void issue(const double* qq, const double* B,
                                        int nbl, int warp, Held held) {
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? NG : warp + 1); ++w) {
      FC* d = acc + (kHopHost ? w * kLrF64Tiles : 0);
#pragma unroll
      for (int kk = 0; kk < K; kk += T::K) {
        FA fa;
        wmma::load_matrix_sync(fa, qq + w * T::M * K + kk, K);
#pragma unroll
        for (int jn = 0; jn < kLrF64Tiles; ++jn)
          if (jn < nbl * 4) {
            FB fb;
            wmma::load_matrix_sync(fb, B + (long long)jn * T::N * K + kk, K);
            wmma::mma_sync(d[jn], fa, fb, d[jn]);
          }
      }
    }
    held();
  }
  __device__ __forceinline__ void retire() {}
  template <typename St>
  __device__ __forceinline__ void store(int nbl, double* scr, int warp,
                                        int lane, int nlanes, St st) {
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? NG : warp + 1); ++w) {
      FC* d = acc + (kHopHost ? w * kLrF64Tiles : 0);
      double* sw = scr + (kHopHost ? 0 : w * T::M * T::N);
#pragma unroll
      for (int jn = 0; jn < kLrF64Tiles; ++jn) {
        if (jn < nbl * 4) {
          wmma::store_matrix_sync(sw, d[jn], T::N, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < T::M * T::N; e += nlanes)
            st(w * T::M + e / T::N, jn * T::N + e % T::N, sw[e]);
          __syncwarp();
        }
        wmma::fill_fragment(d[jn], 0.0);
      }
    }
  }
};

template <int XP>
using LrX = std::conditional_t<XP == kXF64, LrDmma, LrWgmma<XP>>;

// The x-stage team's step on item k (the chunk's qq stage at qq, its B stage
// at B): the products; held() once the qq stage may be reused.
template <int XP, typename Held>
__device__ __forceinline__ void lr_x_issue(LrX<XP>& x, const unsigned char* qq,
                                           const unsigned char* B,
                                           const LrSmem& pl, int nbl, int tid,
                                           Held held) {
  if constexpr (XP == kXF64) {
    x.issue(reinterpret_cast<const double*>(qq),
            reinterpret_cast<const double*>(B), nbl, tid / 32, held);
  } else {
    x.issue(reinterpret_cast<const float*>(qq), B, pl.b_part, nbl, tid / 128,
            tid / 32 % 4, tid % 32, held);
  }
}

// The x-stage team's store of a sub-tile's products: out rows (masked to the
// data rows, columns col0 + n below X).
template <int XP>
__device__ __forceinline__ void lr_x_store(LrX<XP>& x, const LrGeo& q,
                                           int z0, int y0, int col0,
                                           unsigned char* scr,
                                           typename LabMma<XP>::C* out,
                                           int tid, bool solo) {
  using C = typename LabMma<XP>::C;
  const int P = (q.g.sz - q.g.npts) / 2;
  const LabRows rows{q.g, z0, y0, P};
  const int X = q.g.X, nbl = q.ncols / kHopN;
  auto st = [&](int m, int n, C v) {
    const long long o = rows(m);
    if (o >= 0 && col0 + n < X) out[o + col0 + n] = v;
  };
  if constexpr (XP == kXF64) {
    x.store(nbl, reinterpret_cast<double*>(scr), tid / 32, tid % 32,
            solo ? 1 : 32, st);
  } else {
    x.store(nbl, tid / 128, tid / 32 % 4, tid % 32, st);
  }
}

// v17: one block per (TZ, TY) sub-tile and column split, grid (nty, ntz,
// nsplit), kLrThreads threads: eight warps run the bands of a chunk, then
// issue its products, which run on while they band the next chunk; a
// producer warp keeps the u and B rings full.  in_map: the input layout in
// boxes (TZ+2P, TY+2P, XC); xb: the B stages on the host's layout (nsplit,
// nchunk, parts, ncols x 2 XC).
template <int P, int XP>
__global__ void __launch_bounds__(kLrThreads, 1)
lab_ring_kernel(const __grid_constant__ HopMap in_map,
                typename LabMma<XP>::C* __restrict__ out,
                const typename LabMma<XP>::C* __restrict__ tables,
                const unsigned char* __restrict__ xb, LrGeo q, int mode) {
  using C = typename LabMma<XP>::C;
  constexpr int XC = lr_xc(XP);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const LabGeo& g = q.g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool solo = blockDim.x < 64;
  const int cn = solo ? 1 : 32 * kLrWarps;
  const LrSmem pl = lr_smem(P, XP, g.tz, g.ty, q.nu, q.nb, 1, q.ncols);
  const LrBars br{reinterpret_cast<uint64_t*>(smem_raw + pl.bar)};
  const int by = blockIdx.x, bz = blockIdx.y, split = blockIdx.z;
  const int z0 = bz * g.tz, y0 = by * g.ty, nchunk = g.X / XC;
  const bool mm = mode == kFull || mode == kMM;
  const unsigned ubytes =
      (unsigned)((g.tz + 2 * P) * (g.ty + 2 * P) * XC * sizeof(C));
  const unsigned char* bsrc = xb + (long long)split * nchunk * pl.b_bytes;
  auto produce = [&](int ch) {
    lr_produce<C>(br, smem_raw, pl, q, ch, &in_map, ch * XC, y0, z0, ubytes,
                  bsrc + (long long)ch * pl.b_bytes, mm);
  };

  br.init(tid);
  __syncthreads();
  if (!solo && warp == kLrWarps) {  // the producer warp
    if (lane == 0)
      for (int ch = 0; ch < nchunk; ++ch) produce(ch);
    return;
  }

  C* tab = reinterpret_cast<C*>(smem_raw + pl.tab);
  C* s = reinterpret_cast<C*>(smem_raw + pl.st);
  C* t = s + (long long)g.tz * (g.ty + 2 * P) * XC;
  C* qq = reinterpret_cast<C*>(smem_raw + pl.qq);
  lr_tables<P>(tables, g, z0, y0, tab, tid, cn);
  if (split == 0) lab_zero_halo(g, bz, by, P, out, tid, cn);
  lab_sync(1, cn);
  LrX<XP> x;
  x.zero();
  const int nbl = q.ncols / kHopN;
  for (int ch = 0; ch < nchunk; ++ch) {
    if (solo) produce(ch);
    const int su = ch % q.nu;
    lr_wait_full(br.uf(su), ch, q.nu);
    lr_bands_any<P, XP>(reinterpret_cast<const C*>(smem_raw + pl.u +
                                               su * pl.u_bytes),
                    tab, s, t, qq, g, z0, y0, ch * XC, mode, out, tid, cn, 1,
                    [&] { hop_mbar_arrive(br.ue(su)); });
    if (!mm) continue;
    x.retire();  // chunk ch - 1's products are done: its B stage is free
    __syncwarp();
    if (ch > 0 && lane == 0) hop_mbar_arrive(br.be((ch - 1) % q.nb));
    const int sb = ch % q.nb;
    lr_wait_full(br.bf(sb), ch, q.nb);
    lr_x_issue<XP>(x, reinterpret_cast<const unsigned char*>(qq),
                   smem_raw + pl.b + sb * pl.b_bytes, pl, nbl, tid, [] {});
  }
  if (!mm) return;
  x.retire();
  lr_x_store<XP>(x, q, z0, y0, split * q.ncols, smem_raw + pl.scr, out, tid,
                 solo);
}

// v19: persistent blocks (grid <= sub-tiles x splits), kLrPipeThreads
// threads: warps 0-7 the x stage (two warpgroups, kLrXRegs registers a
// thread), warps 8-14 the bands (named barrier 2), warp 15 the producer
// (kLrBandRegs).  The producer takes the block's units (sub-tile and split)
// one at a time from the launch's ticket counter (0 at the launch: 0 ..
// units - 1, then past the end: every block takes one ticket more than its
// units, so a launch takes units + grid), and publishes each in a unit slot
// before its first load.  Items k (a unit's chunks, in turn) flow through the
// u ring (producer -> bands), the qq ring (bands -> x stage) and the B ring
// (producer -> x stage), each role learning a unit from its slot once the
// unit's first item has reached it; a unit of -1 ends each role.  The
// producer and the band warps run on into the next unit while the x stage
// finishes and stores the last.  One host thread (blockDim 1) runs each
// item through the three in turn.
template <int P, int XP>
__global__ void __launch_bounds__(kLrPipeThreads, 1)
lab_ring_pipe_kernel(const __grid_constant__ HopMap in_map,
                     typename LabMma<XP>::C* __restrict__ out,
                     const typename LabMma<XP>::C* __restrict__ tables,
                     const unsigned char* __restrict__ xb, LrGeo q, int mode,
                     unsigned long long* tickets) {
  using C = typename LabMma<XP>::C;
  constexpr int XC = lr_xc(XP);
  constexpr int kBandTid = 32 * kLrWarps, kBandN = 32 * kLrBandWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const LabGeo& g = q.g;
  const int tid = threadIdx.x, warp = hop_uniform(tid / 32), lane = tid % 32;
  const int wg = hop_uniform(tid / 128);
  const bool solo = kHopHost && blockDim.x < 64;  // the host build's thread
  const LrSmem pl = lr_smem(P, XP, g.tz, g.ty, q.nu, q.nb, q.nq, q.ncols);
  const LrBars br{reinterpret_cast<uint64_t*>(smem_raw + pl.bar)};
  volatile int* slots = reinterpret_cast<int*>(smem_raw + pl.units);
  const int ntile = g.ntz * g.nty, nunit = ntile * q.nsplit;
  const int nchunk = g.X / XC, nbl = q.ncols / kHopN;
  const bool mm = mode == kFull || mode == kMM;
  const unsigned ubytes =
      (unsigned)((g.tz + 2 * P) * (g.ty + 2 * P) * XC * sizeof(C));
  struct Unit {
    int bz, by, split, z0, y0;
  };
  auto unit_of = [&](int u) {
    const int tile = u % ntile;
    Unit r;
    r.split = u / ntile;
    r.bz = tile / g.nty;
    r.by = tile % g.nty;
    r.z0 = r.bz * g.tz;
    r.y0 = r.by * g.ty;
    return r;
  };
  // the producer's unit i: its ticket, published in slot i (-1: none left)
  auto take = [&](int i) {
    const unsigned long long t = hop_ticket(tickets);
    const int u = t < (unsigned long long)nunit ? (int)t : -1;
    slots[i % kLrUnits] = u;
    return u;
  };
  auto produce = [&](const Unit& un, long long k, int ch) {
    lr_produce<C>(br, smem_raw, pl, q, k, &in_map, ch * XC, un.y0, un.z0,
                  ubytes,
                  xb + ((long long)un.split * nchunk + ch) * pl.b_bytes, mm);
  };
  C* tab = reinterpret_cast<C*>(smem_raw + pl.tab);
  C* s = reinterpret_cast<C*>(smem_raw + pl.st);
  C* t = s + (long long)g.tz * (g.ty + 2 * P) * XC;
  auto qq_of = [&](long long k) {
    return smem_raw + pl.qq + (k % q.nq) * pl.qq_bytes;
  };
  // the band warps' start of a unit: its tables and halo zeros
  auto band_unit = [&](const Unit& un, int btid, int bn) {
    lr_tables<P>(tables, g, un.z0, un.y0, tab, btid, bn);
    if (un.split == 0) lab_zero_halo(g, un.bz, un.by, P, out, btid, bn);
    lab_sync(2, bn);
  };
  // the band warps' item: u slot -> qq stage (or, copy and bands, out)
  auto bands = [&](const Unit& un, long long k, int ch, int btid, int bn) {
    const int su = (int)(k % q.nu);
    lr_wait_full(br.uf(su), k, q.nu);
    if (mm) lr_wait_empty(br.qe((int)(k % q.nq)), k, q.nq);
    lr_bands_any<P, XP>(
        reinterpret_cast<const C*>(smem_raw + pl.u + su * pl.u_bytes), tab, s,
        t, reinterpret_cast<C*>(qq_of(k)), g, un.z0, un.y0, ch * XC, mode,
        out, btid, bn, 2, [&] { hop_mbar_arrive(br.ue(su)); });
    if (mm && btid == 0) hop_mbar_arrive(br.qf((int)(k % q.nq)));
  };
  LrX<XP> x;
  // the x stage's item: the products of chunk ch (k - 1's first retired)
  auto xstep = [&](long long k, int ch) {
    x.retire();
    __syncwarp();
    if (ch > 0 && lane == 0) hop_mbar_arrive(br.be((int)((k - 1) % q.nb)));
    const int sq = (int)(k % q.nq), sb = (int)(k % q.nb);
    lr_wait_full(br.qf(sq), k, q.nq);
    lr_wait_full(br.bf(sb), k, q.nb);
    lr_x_issue<XP>(x, qq_of(k), smem_raw + pl.b + sb * pl.b_bytes, pl, nbl,
                   tid, [&] {
                     __syncwarp();
                     if (lane == 0) hop_mbar_arrive(br.qe(sq));
                   });
  };
  // the x stage's end of a unit: the last products and their store
  auto xend = [&](const Unit& un, long long k_last, int xtid) {
    x.retire();
    __syncwarp();
    if (lane == 0) hop_mbar_arrive(br.be((int)(k_last % q.nb)));
    lr_x_store<XP>(x, q, un.z0, un.y0, un.split * q.ncols, smem_raw + pl.scr,
                   out, xtid, solo);
  };

  br.init(tid);
  __syncthreads();
  if (solo) {
    for (int i = 0;; ++i) {
      const int u = take(i);
      if (u < 0) break;
      const Unit un = unit_of(u);
      band_unit(un, 0, 1);
      x.zero();
      for (int ch = 0; ch < nchunk; ++ch) {
        const long long k = (long long)i * nchunk + ch;
        produce(un, k, ch);
        bands(un, k, ch, 0, 1);
        if (mm) xstep(k, ch);
      }
      if (mm) xend(un, (long long)(i + 1) * nchunk - 1, 0);
    }
    return;
  }
  // each role opens with its registers (setmaxnreg), on a path ptxas can
  // see is the same for the whole warpgroup
  if (wg >= kLrWarps / 4) {
    hop_reg_dealloc<kLrBandRegs>();
    if (warp == kLrWarps + kLrBandWarps) {  // the producer warp
      if (lane != 0) return;
      for (int i = 0;; ++i) {
        const long long k0 = (long long)i * nchunk;
        const int u = take(i);
        if (u < 0) {  // the end: an arrival with no bytes on the next u slot
          const int su = (int)(k0 % q.nu);
          lr_wait_empty(br.ue(su), k0, q.nu);
          hop_mbar_arrive(br.uf(su));
          return;
        }
        const Unit un = unit_of(u);
        for (int ch = 0; ch < nchunk; ++ch) produce(un, k0 + ch, ch);
      }
    }
    // the band warps
    const int btid = tid - kBandTid;
    for (int i = 0;; ++i) {
      const long long k0 = (long long)i * nchunk;
      lr_wait_full(br.uf((int)(k0 % q.nu)), k0, q.nu);
      const int u = slots[i % kLrUnits];
      if (u < 0) {  // the end: passed on to the x stage through its qq ring
        if (mm && btid == 0) {
          lr_wait_empty(br.qe((int)(k0 % q.nq)), k0, q.nq);
          hop_mbar_arrive(br.qf((int)(k0 % q.nq)));
        }
        return;
      }
      const Unit un = unit_of(u);
      band_unit(un, btid, kBandN);
      for (int ch = 0; ch < nchunk; ++ch)
        bands(un, k0 + ch, ch, btid, kBandN);
    }
  }
  // the x-stage warpgroups (copy and bands: nothing to do)
  hop_reg_alloc<kLrXRegs>();
  if (!mm) return;
  for (int i = 0;; ++i) {
    const long long k0 = (long long)i * nchunk;
    lr_wait_full(br.qf((int)(k0 % q.nq)), k0, q.nq);
    const int u = slots[i % kLrUnits];
    if (u < 0) return;
    const Unit un = unit_of(u);
    x.zero();
    for (int ch = 0; ch < nchunk; ++ch) xstep(k0 + ch, ch);
    xend(un, k0 + nchunk - 1, tid);
  }
}

}  // namespace tpufem
