// The K1 kernel lab's v17-v20 on Hopper's asynchronous machinery (v18, v17
// with fused band stages, is v17's launch: these bands are fused already):
// the z/y bands of a sub-tile fed by a TMA ring, the x stage on wgmma over x
// chunks (v20: over each column block's window).  Device code; the host
// launches are lr_launch (below), called by lab_resident.cu and, for the K2
// lab's v15 on L2's layouts, by lab_zyfirst.cu; the design note of the lab
// and of the tile routine (lab_tile_kernel, lab_pipe_kernel: the earlier
// schedule of v17, v19 and v20, still built) is lab_resident.cuh's.
//
// All three compute what _kernel_v17 (scripts/kernel_lab.py:581) computes,
// on the same resident layout (sz, sy, X), from the same host tables: out
// rows = [q1 | q23] @ [Kx^T; Mx^T] over all 2X rows (v20: the rows of each
// column block's band, the rest being exact zeros), every layout point
// written, halo and padding zeros included.  Where the rows go is a run-time
// map (LrGeo::o, LabOut), so v15 runs v17's and v19's routines on L2's
// output layout.
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
// v20 (lab_window_kernel, at the end of this file): v19's roles and rings;
// each 32-column block multiplies its 48-row window of each half, gathered
// from a ring of qq stages that holds every chunk of the window, and is
// stored once its products retire, so its accumulator is one 64 x 32 tile
// (no column split in any precision).  The window's A (12 TF32 k steps,
// big and small: 96 registers) is why it keeps v19's 160-register x-stage
// warpgroups, one block an SM, rather than a 288-thread block at two.  Its
// products are 11.6 GFLOP in 3xTF32 (three passes) at the flagship, B 0.24
// GB from L2; the bands bound it.
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
  return xp == kXF64 ? 8 : xp == kXBF16x3 || xp == kXBF16 ? 2 : 4;
}
// columns of the x operator a block multiplies at most
__host__ __device__ constexpr int lr_max_cols(int xp) {
  return xp == kXF64 ? 8 * kLrF64Tiles : 2 * kLrNBW * kHopN;
}

// One launch: the input layout and the sub-tiles' grid (g), the ring depths
// (u slots, B stages, qq stages), the columns of a block (a multiple of 32),
// the column splits of X and where the rows go in the output layout (o; a
// layout with a halo, org > 0, gets its halo zeros from the boundary
// sub-tiles).
struct LrGeo {
  LabGeo g;
  int nu, nb, nq, ncols, nsplit;
  LabOut o;
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
// (zero: v20's 16 zero bytes, lw_smem; none here)
struct LrSmem {
  long long bar, units, zero, tab, u, u_bytes, st, qq, qq_bytes, b, b_part,
      b_bytes, scr, total;
};
__host__ __device__ inline LrSmem lr_smem(int p, int xp, int tz, int ty,
                                          int nu, int nb, int nq, int ncols) {
  const long long c = xp == kXF64 ? 8 : 4, nw = 2 * p + 2;
  const long long lz = tz + 2 * p, ly = ty + 2 * p, xc = lr_xc(xp);
  LrSmem s;
  s.bar = 0;
  s.units = 2 * (kLrMaxU + kLrMaxB + kLrMaxQ) * 8;
  s.zero = 0;
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

// The rings' mbarriers: u, B and qq, a full and an empty one a slot, for
// rings of at most MU, MB and MQ slots.
template <int MU, int MB, int MQ>
struct LrBarsOf {
  static constexpr int kCount = 2 * (MU + MB + MQ);
  uint64_t* b;
  __device__ __forceinline__ uint64_t* uf(int s) const { return b + s; }
  __device__ __forceinline__ uint64_t* ue(int s) const {
    return b + MU + s;
  }
  __device__ __forceinline__ uint64_t* bf(int s) const {
    return b + 2 * MU + s;
  }
  __device__ __forceinline__ uint64_t* be(int s) const {
    return b + 2 * MU + MB + s;
  }
  __device__ __forceinline__ uint64_t* qf(int s) const {
    return b + 2 * (MU + MB) + s;
  }
  __device__ __forceinline__ uint64_t* qe(int s) const {
    return b + 2 * (MU + MB) + MQ + s;
  }
  // tid 0 of the block; then a block barrier.  A u slot is released by one
  // band thread, a B stage by be_n x-stage warps (v17, v19: each of the
  // eight), a qq stage (v19) by qe_n arrivals of x-stage warps once they
  // hold its operand.
  __device__ __forceinline__ void init(int tid, int be_n = kLrWarps,
                                       int qe_n = kLrWarps) const {
    if (tid != 0) return;
    for (int s = 0; s < MU; ++s) {
      hop_mbar_init(uf(s), 1);
      hop_mbar_init(ue(s), 1);
    }
    for (int s = 0; s < MB; ++s) {
      hop_mbar_init(bf(s), 1);
      hop_mbar_init(be(s), be_n);
    }
    for (int s = 0; s < MQ; ++s) {
      hop_mbar_init(qf(s), 1);
      hop_mbar_init(qe(s), qe_n);
    }
    hop_mbar_init_fence();
  }
};
using LrBars = LrBarsOf<kLrMaxU, kLrMaxB, kLrMaxQ>;

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
template <typename C, typename Bars>
__device__ __forceinline__ void lr_produce(const Bars& br,
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
// stage (qq complete; s and t free).  o: where the rows go (copy and bands).
// TZ, TY: the sub-tile as compile-time
// constants (the chooser's (8, 8): the index arithmetic of every output
// folds into shifts), or 0 for g's.
template <int P, int XP, int TZ, int TY, typename Free>
__device__ void lr_bands(const typename LabMma<XP>::C* U,
                         const typename LabMma<XP>::C* tab,
                         typename LabMma<XP>::C* s, typename LabMma<XP>::C* t,
                         typename LabMma<XP>::C* qq, const LabGeo& g,
                         const LabOut& o, int z0, int y0, int cx0, int mode,
                         typename LabMma<XP>::C* __restrict__ out, int tid,
                         int nthr, int bar, Free free_u) {
  using C = typename LabMma<XP>::C;
  constexpr int NW = 2 * P + 2, XC = lr_xc(XP);
  const int tz = TZ ? TZ : g.tz, ty = TY ? TY : g.ty, ly = ty + 2 * P;
  const C* wky = tab;
  const C* wmy = wky + ty * NW;
  const C* wkz = wmy + ty * NW;
  const C* wmz = wkz + tz * NW;
  const LabRows rows{o, g.X, z0, y0, ty};
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
    typename LabMma<XP>::C* qq, const LabGeo& g, const LabOut& o, int z0,
    int y0, int cx0, int mode, typename LabMma<XP>::C* __restrict__ out,
    int tid, int nthr, int bar, Free free_u) {
  if (g.tz == 8 && g.ty == 8)
    lr_bands<P, XP, 8, 8>(U, tab, s, t, qq, g, o, z0, y0, cx0, mode, out,
                          tid, nthr, bar, free_u);
  else
    lr_bands<P, XP, 0, 0>(U, tab, s, t, qq, g, o, z0, y0, cx0, mode, out,
                          tid, nthr, bar, free_u);
}

// The x stage on wgmma (3xTF32, 1xTF32, bf16x3, one bf16 product): warpgroup
// wg holds the
// products of the column blocks wg kLrNBW .. + kLrNBW - 1 of the block's nbl;
// one past the last multiplies the last again and is not stored, so no wgmma
// depends on a run-time condition.  One host thread stands for both
// warpgroups (acc holds both, issue and store run them in turn).
template <int XP>
struct LrWgmma {
  static constexpr bool BF = XP == kXBF16x3 || XP == kXBF16;
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
  const LabRows rows{q.o, q.g.X, z0, y0, q.g.ty};
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
  if (q.o.org && split == 0) lab_zero_halo(g, bz, by, P, out, tid, cn);
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
                    tab, s, t, qq, g, q.o, z0, y0, ch * XC, mode, out, tid,
                    cn, 1,
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

// What the roles of a persistent ring kernel (v19: lab_ring_pipe_kernel,
// v20: lab_window_kernel) share.  The producer takes the block's units
// (sub-tile and split) one at a time from the launch's ticket counter (0 at
// the launch: 0 .. units - 1, then past the end: every block takes one
// ticket more than its units, so a launch takes units + grid), publishes
// each in a unit slot before its first load, and loads the unit's u boxes
// (items k, a unit's chunks in turn) into the u ring; the band warps learn a
// unit from its slot once its first item has reached them, write its
// tables and (split 0 of a layout with a halo) its halo zeros, and band each
// item from its u slot into qq stage k % nq (copy and bands: into out); a
// unit of -1 ends each role, passed on through the u ring, then the qq ring.
template <int P, int XP, typename Bars>
struct LrPipe {
  using C = typename LabMma<XP>::C;
  static constexpr int XC = lr_xc(XP);
  struct Unit {
    int bz, by, split, z0, y0;
  };
  const LrGeo& q;
  const LrSmem& pl;
  const Bars& br;
  unsigned char* smem;
  const HopMap* map;
  const C* tables;
  C* out;
  unsigned long long* tickets;
  int mode;

  __device__ __forceinline__ int nchunk() const { return q.g.X / XC; }
  __device__ __forceinline__ bool mm() const {
    return mode == kFull || mode == kMM;
  }
  __device__ __forceinline__ volatile int* slots() const {
    return reinterpret_cast<int*>(smem + pl.units);
  }
  __device__ __forceinline__ unsigned char* qq(long long k) const {
    return smem + pl.qq + (k % q.nq) * pl.qq_bytes;
  }
  __device__ __forceinline__ Unit unit_of(int u) const {
    const int ntile = q.g.ntz * q.g.nty, tile = u % ntile;
    Unit r;
    r.split = u / ntile;
    r.bz = tile / q.g.nty;
    r.by = tile % q.g.nty;
    r.z0 = r.bz * q.g.tz;
    r.y0 = r.by * q.g.ty;
    return r;
  }
  // the producer's unit i: its ticket, published in slot i (-1: none left)
  __device__ __forceinline__ int take(int i) const {
    const unsigned long long t = hop_ticket(tickets);
    const int nunit = q.g.ntz * q.g.nty * q.nsplit;
    const int u = t < (unsigned long long)nunit ? (int)t : -1;
    slots()[i % kLrUnits] = u;
    return u;
  }
  // item k, chunk ch of unit un: its u box, and with_b its B stage from bsrc
  __device__ __forceinline__ void produce(const Unit& un, long long k, int ch,
                                          const unsigned char* bsrc,
                                          bool with_b) const {
    const unsigned ubytes =
        (unsigned)((q.g.tz + 2 * P) * (q.g.ty + 2 * P) * XC * sizeof(C));
    lr_produce<C>(br, smem, pl, q, k, map, ch * XC, un.y0, un.z0, ubytes,
                  bsrc, with_b);
  }
  // the producer's end: an arrival with no bytes on the u slot of item k0
  __device__ __forceinline__ void end(long long k0) const {
    const int su = (int)(k0 % q.nu);
    lr_wait_empty(br.ue(su), k0, q.nu);
    hop_mbar_arrive(br.uf(su));
  }
  // the band warps' start of a unit: its tables and halo zeros
  __device__ __forceinline__ void band_unit(const Unit& un, int btid,
                                            int bn) const {
    C* tab = reinterpret_cast<C*>(smem + pl.tab);
    lr_tables<P>(tables, q.g, un.z0, un.y0, tab, btid, bn);
    if (q.o.org && un.split == 0)
      lab_zero_halo(q.g, un.bz, un.by, P, out, btid, bn);
    lab_sync(2, bn);
  }
  // the band warps' item: u slot -> qq stage (or, copy and bands, out)
  __device__ __forceinline__ void bands(const Unit& un, long long k, int ch,
                                        int btid, int bn) const {
    const int su = (int)(k % q.nu);
    lr_wait_full(br.uf(su), k, q.nu);
    if (mm()) lr_wait_empty(br.qe((int)(k % q.nq)), k, q.nq);
    C* s = reinterpret_cast<C*>(smem + pl.st);
    lr_bands_any<P, XP>(
        reinterpret_cast<const C*>(smem + pl.u + su * pl.u_bytes),
        reinterpret_cast<const C*>(smem + pl.tab), s,
        s + (long long)q.g.tz * (q.g.ty + 2 * P) * XC,
        reinterpret_cast<C*>(qq(k)), q.g, q.o, un.z0, un.y0, ch * XC, mode,
        out, btid, bn, 2, [&] { hop_mbar_arrive(br.ue(su)); });
    if (mm() && btid == 0) hop_mbar_arrive(br.qf((int)(k % q.nq)));
  }
  // the band warps' role (named barrier 2, bn threads)
  __device__ void band_role(int btid, int bn) const {
    for (int i = 0;; ++i) {
      const long long k0 = (long long)i * nchunk();
      lr_wait_full(br.uf((int)(k0 % q.nu)), k0, q.nu);
      const int u = slots()[i % kLrUnits];
      if (u < 0) {  // the end: passed on to the x stage through its qq ring
        if (mm() && btid == 0) {
          lr_wait_empty(br.qe((int)(k0 % q.nq)), k0, q.nq);
          hop_mbar_arrive(br.qf((int)(k0 % q.nq)));
        }
        return;
      }
      const Unit un = unit_of(u);
      band_unit(un, btid, bn);
      for (int ch = 0; ch < nchunk(); ++ch)
        bands(un, k0 + ch, ch, btid, bn);
    }
  }
  // the x stage's wait for unit i's first qq item: its unit, or -1 (the end)
  __device__ __forceinline__ int x_unit(int i) const {
    const long long k0 = (long long)i * nchunk();
    lr_wait_full(br.qf((int)(k0 % q.nq)), k0, q.nq);
    return slots()[i % kLrUnits];
  }
};

// v19: persistent blocks (grid <= sub-tiles x splits), kLrPipeThreads
// threads: warps 0-7 the x stage (two warpgroups, kLrXRegs registers a
// thread), warps 8-14 the bands, warp 15 the producer (kLrBandRegs), with
// the roles of LrPipe; the producer loads each item's B stage beside its u
// box, and items flow through the u ring (producer -> bands), the qq ring
// (bands -> x stage) and the B ring (producer -> x stage).  The producer and
// the band warps run on into the next unit while the x stage finishes and
// stores the last.  One host thread (blockDim 1) runs each item through the
// three in turn.
template <int P, int XP>
__global__ void __launch_bounds__(kLrPipeThreads, 1)
lab_ring_pipe_kernel(const __grid_constant__ HopMap in_map,
                     typename LabMma<XP>::C* __restrict__ out,
                     const typename LabMma<XP>::C* __restrict__ tables,
                     const unsigned char* __restrict__ xb, LrGeo q, int mode,
                     unsigned long long* tickets) {
  constexpr int kBandTid = 32 * kLrWarps, kBandN = 32 * kLrBandWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const LabGeo& g = q.g;
  const int tid = threadIdx.x, warp = hop_uniform(tid / 32), lane = tid % 32;
  const int wg = hop_uniform(tid / 128);
  const bool solo = kHopHost && blockDim.x < 64;  // the host build's thread
  const LrSmem pl = lr_smem(P, XP, g.tz, g.ty, q.nu, q.nb, q.nq, q.ncols);
  const LrBars br{reinterpret_cast<uint64_t*>(smem_raw + pl.bar)};
  const LrPipe<P, XP, LrBars> pp{q,      pl,  br,      smem_raw, &in_map,
                                 tables, out, tickets, mode};
  using Unit = typename LrPipe<P, XP, LrBars>::Unit;
  const int nchunk = pp.nchunk(), nbl = q.ncols / kHopN;
  const bool mm = pp.mm();
  auto produce = [&](const Unit& un, long long k, int ch) {
    pp.produce(un, k, ch,
               xb + ((long long)un.split * nchunk + ch) * pl.b_bytes, mm);
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
    lr_x_issue<XP>(x, pp.qq(k), smem_raw + pl.b + sb * pl.b_bytes, pl, nbl,
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
      const int u = pp.take(i);
      if (u < 0) break;
      const Unit un = pp.unit_of(u);
      pp.band_unit(un, 0, 1);
      x.zero();
      for (int ch = 0; ch < nchunk; ++ch) {
        const long long k = (long long)i * nchunk + ch;
        produce(un, k, ch);
        pp.bands(un, k, ch, 0, 1);
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
        const int u = pp.take(i);
        if (u < 0) return pp.end(k0);
        const Unit un = pp.unit_of(u);
        for (int ch = 0; ch < nchunk; ++ch) produce(un, k0 + ch, ch);
      }
    }
    return pp.band_role(tid - kBandTid, kBandN);
  }
  // the x-stage warpgroups (copy and bands: nothing to do)
  hop_reg_alloc<kLrXRegs>();
  if (!mm) return;
  for (int i = 0;; ++i) {
    const int u = pp.x_unit(i);
    if (u < 0) return;
    const Unit un = pp.unit_of(u);
    const long long k0 = (long long)i * nchunk;
    x.zero();
    for (int ch = 0; ch < nchunk; ++ch) xstep(k0 + ch, ch);
    xend(un, k0 + nchunk - 1, tid);
  }
}

// ---- v20: the block-banded x stage as a windowed wgmma stage --------------
// Column block j (kHopN = 32 columns of the output, [32 j, 32 j + 32)) needs
// rows [32 j - P, 32 j + 32 + P) of each half of [Kx^T; Mx^T].  At every P <=
// 8 those lie in its window, x in [32 j - 8, 32 j + 40): 48 rows a half,
// resident_lab.x_windows(X, p, 32, 8), whose rows beyond [0, X) the host
// lays out as zeros (the window is clipped at the table, not in the kernel).
// A block's product is (64, 96) x (96, 32): its qq window's columns, gathered
// from the qq stages of the chunks that hold them, times its B.
constexpr int kLwLead = 8;  // rows of a window before its block
constexpr int kLwRows = kHopN + 2 * kLwLead;  // 48 rows a half
constexpr int kLwK = 2 * kLwRows;             // K of a block's product
constexpr int kLwMaxQ = 8;                    // deepest qq window ring
// B stages: two.  Two warpgroups take the blocks in turn, so each waits on
// every other B item; with an even ring it has seen the fill before the one
// it waits for in the same stage, and a parity wait cannot pass a phase early
constexpr int kLwB = 2;
using LwBars = LrBarsOf<kLrMaxU, kLwB, kLwMaxQ>;

// B bytes of one part of a column block's operand (the host's layout: K-major
// for wgmma, hop_b_offset with kLwK values a column; f64 column-major)
__host__ __device__ constexpr long long lw_b_part(int xp) {
  return (long long)kHopN * kLwK * lr_belem(xp);
}

// Byte offsets of a block's shared-memory regions, as lr_smem's: the rings'
// mbarriers (LwBars), the unit slots, 16 zero bytes (the A operand beyond [0,
// X): B's rows there are zeros), tables, nu u slots, s and t, nq qq stages of
// one chunk each (the window ring), kLwB B stages of one column block each,
// f64's accumulator tiles.
__host__ __device__ inline LrSmem lw_smem(int p, int xp, int tz, int ty,
                                          int nu, int nq) {
  const long long c = xp == kXF64 ? 8 : 4, nw = 2 * p + 2;
  const long long lz = tz + 2 * p, ly = ty + 2 * p, xc = lr_xc(xp);
  LrSmem s;
  s.bar = 0;
  s.units = LwBars::kCount * 8;
  s.zero = s.units + kLrUnits * 4;
  s.tab = lab_align(s.zero + 16);
  s.u = s.tab + lab_align(2LL * (tz + ty) * nw * c);
  s.u_bytes = lab_align(lz * ly * xc * c);
  s.st = s.u + nu * s.u_bytes;
  s.qq = s.st + lab_align(2 * tz * ly * xc * c);
  s.qq_bytes = lab_align((long long)tz * ty * 2 * xc * c);
  s.b = s.qq + nq * s.qq_bytes;
  s.b_part = lw_b_part(xp);
  s.b_bytes = lr_parts(xp) * s.b_part;
  s.scr = s.b + kLwB * s.b_bytes;
  s.total = s.scr + (xp == kXF64 ? lab_align(kLrWarps * 64 * 8) : 0);
  return s;
}

// The chunks (x columns [c XC, (c + 1) XC)) block j's window reads, within
// the unit's nchunk; how many blocks read chunk c (one or two: a stage is
// free once each of its readers holds its operand, so a lone reader arrives
// twice).
template <int XC>
__host__ __device__ inline int lw_c0(int j) {
  const int x = kHopN * j - kLwLead;
  return x < 0 ? 0 : x / XC;
}
template <int XC>
__host__ __device__ inline int lw_c1(int j, int nchunk) {
  const int c = (kHopN * j + kHopN + kLwLead - 1) / XC;
  return c < nchunk ? c : nchunk - 1;
}
template <int XC>
__host__ __device__ inline int lw_readers(int c, int nbl, int nchunk) {
  const int j0 = c * XC / kHopN;
  int n = 0;
  for (int j = j0 - 2; j <= j0 + 2; ++j)
    if (j >= 0 && j < nbl && lw_c0<XC>(j) <= c && c <= lw_c1<XC>(j, nchunk))
      ++n;
  return n;
}

// A unit's place in the qq ring, from its first item k0: chunk c is item k0
// + c, in stage (k0 % nq + c) % nq, of phase k0 / nq + (k0 % nq + c) / nq
// (32-bit arithmetic once k0 is split).
struct LwUnit {
  long long k0, kq;  // k0 / nq
  int kr, nq;        // k0 % nq
  __device__ __forceinline__ int stage(int c) const { return (kr + c) % nq; }
  __device__ __forceinline__ void wait(const LwBars& br, int c) const {
    hop_mbar_wait(br.qf(stage(c)), (unsigned)((kq + (kr + c) / nq) & 1));
  }
};

// The qq stages of column block j's window: the element offset of each
// chunk it reads (W from floor((32 j - 8) / XC)), -1 for a chunk beyond the
// unit's nchunk (B's rows there are zeros).  Window column d (x = 32 j - 8 +
// d) lies in chunk slot (kMod + d) / XC at column (kMod + d) % XC: known at
// compile time for every k step.
template <int XC>
struct LwWindow {
  static constexpr int kMod = (XC - kLwLead % XC) % XC;  // (32 j - 8) mod XC
  static constexpr int W = (kMod + kLwRows + XC - 1) / XC;
  int off[W];
  __device__ __forceinline__ LwWindow(const LwUnit& un, int j, int nchunk,
                                      long long qq, long long qq_bytes,
                                      int esz) {
    const int cb = (kHopN * j - kLwLead - kMod) / XC;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int c = cb + i;
      off[i] = c < 0 || c >= nchunk
                   ? -1
                   : (int)((qq + un.stage(c) * qq_bytes) / esz);
    }
  }
};

// v20's x stage on wgmma (3xTF32, 1xTF32, bf16x3): a warpgroup multiplies
// one column block at a time, A from registers (its window's 96 columns, k
// steps of 8 TF32 or 16 bf16 columns: 12 or 6, hop_load_a splitting them),
// B from its stage; the three 3xTF32 products in l2_xring's order.  One host
// thread multiplies the whole 64-row tile.
template <int XP>
struct LwWgmma {
  static constexpr bool BF = XP == kXBF16x3 || XP == kXBF16;
  static constexpr bool kSplit = lr_parts(XP) == 2;
  static constexpr int XC = lr_xc(XP);
  static constexpr int SW = BF ? 16 : 8;   // x columns of a k step
  static constexpr int KH = kLwRows / SW;  // k steps a half
  static constexpr int KS = 2 * KH;
  static constexpr int kbytes = kLwK * (BF ? 2 : 4);
  HopAcc acc;
  HopA big[KS], small[KS];

  // the block's A from its window's stages (zero: the element offset of
  // the zero bytes)
  __device__ __forceinline__ void load(const float* smem,
                                       const LwWindow<XC>& win, int zero,
                                       int w, int lane) {
    constexpr int M = LwWindow<XC>::kMod;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // the step's pieces of 8 columns (bf16: two, across a chunk's edge)
      const int h = s / KH, d = SW * (s % KH);
      const int o0 = win.off[(M + d) / XC];
      const int o1 = win.off[(M + d + 8) / XC < LwWindow<XC>::W
                                 ? (M + d + 8) / XC
                                 : LwWindow<XC>::W - 1];
      const int c0 = h * XC + (M + d) % XC;
      const int c1 = h * XC + (M + d + 8) % XC;
      hop_load_a<BF>(
          big[s], small[s], kSplit, smem,
          [&](int r, int k) {
            const int o = k < 8 ? o0 : o1;
            return o < 0 ? zero
                         : o + lr_at<XP>(r, (k < 8 ? c0 : c1) + (k & 7));
          },
          0, w, lane);
    }
  }
  // its products against the B stage (asynchronous on the card)
  __device__ __forceinline__ void issue(const unsigned char* B,
                                        long long b_part) {
    hop_acc_zero(acc);
    hop_wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int part = kSplit ? 0 : 2; part < 3; ++part)
        hop_wgmma<BF>(acc, part == 0 ? small[s] : big[s],
                      B + (part == 1 ? b_part : 0), s, kbytes);
    hop_wgmma_commit();
  }
  __device__ __forceinline__ void retire() {
    hop_wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      hop_keep(big[s]);
      if constexpr (kSplit) hop_keep(small[s]);
    }
  }
  // st(m, n, v) for each product (n: the block's column)
  template <typename St>
  __device__ __forceinline__ void store(int w, int lane, St st) {
    hop_acc_each(acc, w, lane, st);
  }
};

// v20's x stage in f64: DMMA m8n8k4 (WMMA), warp w the 8-row tile w by the
// block's four 8-column tiles over its window's 24 k steps, A from the
// stages (zeros beyond [0, X)), B column-major (kLwK a column).  One host
// thread stands for the eight warps.
struct LwDmma {
  using T = LabMma<kXF64>;
  using FA = typename LabFrag<kXF64>::FA;
  using FC = typename LabFrag<kXF64>::FC;
  using FB = wmma::fragment<wmma::matrix_b, T::M, T::N, T::K, double,
                            wmma::col_major>;
  static constexpr int XC = lr_xc(kXF64);
  static constexpr int NT = kHopN / T::N;   // column tiles of a block
  static constexpr int KH = kLwRows / T::K;  // k steps a half
  static constexpr int NG = kHopHost ? kLrWarps : 1;
  FC acc[NG * NT];

  __device__ __forceinline__ void run(const double* smem,
                                      const LwWindow<XC>& win, const double* B,
                                      int warp) {
    constexpr int M = LwWindow<XC>::kMod;
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? NG : warp + 1); ++w) {
      FC* d = acc + (kHopHost ? w * NT : 0);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) wmma::fill_fragment(d[jn], 0.0);
#pragma unroll
      for (int s = 0; s < 2 * KH; ++s) {
        const int h = s / KH, x = M + T::K * (s % KH);
        const int o = win.off[x / XC];
        FA fa;
        if (o < 0)
          wmma::fill_fragment(fa, 0.0);
        else
          wmma::load_matrix_sync(
              fa, smem + o + w * T::M * 2 * XC + h * XC + x % XC, 2 * XC);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          FB fb;
          wmma::load_matrix_sync(fb, B + jn * T::N * kLwK + T::K * s, kLwK);
          wmma::mma_sync(d[jn], fa, fb, d[jn]);
        }
      }
    }
  }
  template <typename St>
  __device__ __forceinline__ void store(double* scr, int warp, int lane,
                                        int nlanes, St st) {
    for (int w = kHopHost ? 0 : warp; w < (kHopHost ? NG : warp + 1); ++w) {
      FC* d = acc + (kHopHost ? w * NT : 0);
      double* sw = scr + (kHopHost ? 0 : w * T::M * T::N);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        wmma::store_matrix_sync(sw, d[jn], T::N, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < T::M * T::N; e += nlanes)
          st(w * T::M + e / T::N, jn * T::N + e % T::N, sw[e]);
        __syncwarp();
      }
    }
  }
};

template <int XP>
using LwX = std::conditional_t<XP == kXF64, LwDmma, LwWgmma<XP>>;

// v20: lab_ring_pipe_kernel's roles and rings (LrPipe: persistent blocks
// taking sub-tiles from the ticket counter; a producer warp, seven band
// warps, two x-stage warpgroups; kLrPipeThreads threads, one split: the
// accumulator is one 64 x 32 tile a block), with the x stage windowed.  The
// bands write chunk c of a unit into qq stage (k0 + c) % nq of the window
// ring.  Once the chunks of block j's window are in (lw_c1), its B (one bulk
// copy of b_bytes, xb + j b_bytes, into stage kb % kLwB: the producer asks
// for it right after that chunk's u box) and its A are multiplied: on wgmma,
// block j by warpgroup j % 2, which releases the window's stages once it
// holds A, waits for its products and stores them; in f64, every block by
// the eight warps, each its 8 rows.  Every product is issued from a loop of
// fixed trips, never under a condition on j; the ragged last block's
// columns are masked at the store.  One host thread (blockDim 1) runs a
// unit's chunks (load, bands), each block's products as soon as its window
// is in.
template <int P, int XP>
__global__ void __launch_bounds__(kLrPipeThreads, 1)
lab_window_kernel(const __grid_constant__ HopMap in_map,
                  typename LabMma<XP>::C* __restrict__ out,
                  const typename LabMma<XP>::C* __restrict__ tables,
                  const unsigned char* __restrict__ xb, LrGeo q, int mode,
                  unsigned long long* tickets) {
  using C = typename LabMma<XP>::C;
  constexpr int XC = lr_xc(XP);
  constexpr bool F64 = XP == kXF64;
  constexpr int kBandTid = 32 * kLrWarps, kBandN = 32 * kLrBandWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const LabGeo& g = q.g;
  const int tid = threadIdx.x, warp = hop_uniform(tid / 32), lane = tid % 32;
  const int wg = hop_uniform(tid / 128);
  const bool solo = kHopHost && blockDim.x < 64;  // the host build's thread
  const LrSmem pl = lw_smem(P, XP, g.tz, g.ty, q.nu, q.nq);
  const LwBars br{reinterpret_cast<uint64_t*>(smem_raw + pl.bar)};
  const LrPipe<P, XP, LwBars> pp{q,      pl,  br,      smem_raw, &in_map,
                                 tables, out, tickets, mode};
  using Unit = typename LrPipe<P, XP, LwBars>::Unit;
  const int nchunk = pp.nchunk(), nbl = (g.X + kHopN - 1) / kHopN;
  const bool mm = pp.mm();
  // unit i's items: its chunks' u boxes, each column block's B right after
  // the u box of the last chunk of its window
  auto produce = [&](const Unit& un, int i, auto&& with_block) {
    const long long k0 = (long long)i * nchunk;
    for (int ch = 0, j = 0; ch < nchunk; ++ch) {
      pp.produce(un, k0 + ch, ch, nullptr, false);
      if (solo) pp.bands(un, k0 + ch, ch, 0, 1);
      for (; mm && j < nbl && lw_c1<XC>(j, nchunk) == ch; ++j) {
        const long long kb = (long long)i * nbl + j;
        const int sb = (int)(kb % kLwB);
        lr_wait_empty(br.be(sb), kb, kLwB);
        hop_mbar_expect(br.bf(sb), (unsigned)pl.b_bytes);
        hop_bulk_load(smem_raw + pl.b + sb * pl.b_bytes,
                      xb + (long long)j * pl.b_bytes, (unsigned)pl.b_bytes,
                      br.bf(sb));
        with_block(j);
      }
    }
  };
  // block j of the unit at k0 (its B item kb): wait for its window's chunks
  // and its B stage, multiply, release, store
  LwX<XP> x;
  auto xblock = [&](const Unit& un, const LwUnit& ku, long long kb, int j,
                    int xtid) {
    const int c0 = lw_c0<XC>(j), c1 = lw_c1<XC>(j, nchunk);
    for (int c = c0; c <= c1; ++c) ku.wait(br, c);
    const int sb = (int)(kb % kLwB);
    lr_wait_full(br.bf(sb), kb, kLwB);
    const LwWindow<XC> win(ku, j, nchunk, pl.qq, pl.qq_bytes, sizeof(C));
    const unsigned char* B = smem_raw + pl.b + sb * pl.b_bytes;
    auto release = [&] {
      __syncwarp();
      if (lane == 0)
        for (int c = c0; c <= c1; ++c) {
          uint64_t* e = br.qe(ku.stage(c));
          hop_mbar_arrive(e);
          if (lw_readers<XC>(c, nbl, nchunk) == 1) hop_mbar_arrive(e);
        }
    };
    if constexpr (F64) {
      x.run(reinterpret_cast<const double*>(smem_raw), win,
            reinterpret_cast<const double*>(B), xtid / 32);
    } else {
      x.load(reinterpret_cast<const float*>(smem_raw), win,
             (int)(pl.zero / sizeof(float)), xtid / 32 % 4, lane);
      release();
      x.issue(B, pl.b_part);
      x.retire();
    }
    __syncwarp();
    if (lane == 0) hop_mbar_arrive(br.be(sb));
    if constexpr (F64) release();
    const LabRows rows{q.o, g.X, un.z0, un.y0, g.ty};
    const int col0 = kHopN * j;
    auto st = [&](int r, int n, C v) {
      const long long o = rows(r);
      if (o >= 0 && col0 + n < g.X) out[o + col0 + n] = v;
    };
    if constexpr (F64)
      x.store(reinterpret_cast<double*>(smem_raw + pl.scr), xtid / 32, lane,
              solo ? 1 : 32, st);
    else
      x.store(xtid / 32 % 4, lane, st);
  };

  // a B stage's readers: one warpgroup (f64: the eight warps); a qq stage's:
  // those of two blocks
  constexpr int kReaders = F64 ? kLrWarps : kLrWarps / 2;
  if (tid == 0)
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float*>(smem_raw + pl.zero)[i] = 0.f;
  br.init(tid, kReaders, 2 * kReaders);
  __syncthreads();
  if (solo) {
    for (int i = 0;; ++i) {
      const int u = pp.take(i);
      if (u < 0) break;
      const Unit un = pp.unit_of(u);
      pp.band_unit(un, 0, 1);
      const long long k0 = (long long)i * nchunk;
      const LwUnit ku{k0, k0 / q.nq, (int)(k0 % q.nq), q.nq};
      produce(un, i, [&](int j) {
        xblock(un, ku, (long long)i * nbl + j, j, 0);
      });
    }
    return;
  }
  if (wg >= kLrWarps / 4) {
    hop_reg_dealloc<kLrBandRegs>();
    if (warp == kLrWarps + kLrBandWarps) {  // the producer warp
      if (lane != 0) return;
      for (int i = 0;; ++i) {
        const int u = pp.take(i);
        if (u < 0) return pp.end((long long)i * nchunk);
        produce(pp.unit_of(u), i, [](int) {});
      }
    }
    return pp.band_role(tid - kBandTid, kBandN);
  }
  // the x-stage warpgroups (copy and bands: nothing to do)
  hop_reg_alloc<kLrXRegs>();
  if (!mm) return;
  for (int i = 0;; ++i) {
    const int u = pp.x_unit(i);
    if (u < 0) return;
    const Unit un = pp.unit_of(u);
    const long long k0 = (long long)i * nchunk;
    const LwUnit ku{k0, k0 / q.nq, (int)(k0 % q.nq), q.nq};
    for (int j = F64 ? 0 : wg; j < nbl; j += F64 ? 1 : 2)
      xblock(un, ku, (long long)i * nbl + j, j, tid);
  }
}

#ifdef __CUDACC__
// ---- host side: one launch of a ring routine -------------------------------
// V: 17 (lab_ring_kernel), 19 (lab_ring_pipe_kernel) or 20
// (lab_window_kernel).  The shared-memory opt-in, then the occupancy query
// (blocks_per_sm not null) or the tensor map of the input layout (g.sz, g.sy,
// X) in halo'd boxes and the launch: grid (nty, ntz, nsplit) for 17, `grid`
// persistent blocks for 19 and 20, whose ticket counter is set to 0 on the
// stream first.  Shared by lab_resident.cu (L1) and lab_zyfirst.cu (L2's
// v15, which passes its output layout in q.o).  Internal linkage (static):
// the opt-in record of each instance must be its library's own, as each
// library registers its own kernels; a template's local static with
// external linkage is one object for every library loaded in the process,
// and the second library's kernel would never be opted in.
struct LrLaunch {
  int grid;
  const void* u;
  void* y;
  const void* tables;
  const void* xb;
  unsigned long long* tickets;
  cudaStream_t stream;
  int* blocks_per_sm;
};

template <int P, int XP, int V>
static constexpr auto lr_kernel() {
  if constexpr (V == 17) return lab_ring_kernel<P, XP>;
  else if constexpr (V == 19) return lab_ring_pipe_kernel<P, XP>;
  else return lab_window_kernel<P, XP>;
}

template <int P, int XP, int V>
static cudaError_t lr_launch(int mode, const LrGeo& q, const LrLaunch& a) {
  using C = typename LabMma<XP>::C;
  const LabGeo& g = q.g;
  const int smem =
      (int)(V == 20 ? lw_smem(P, XP, g.tz, g.ty, q.nu, q.nq)
                    : lr_smem(P, XP, g.tz, g.ty, q.nu, q.nb, q.nq, q.ncols))
          .total;
  constexpr int threads = V == 17 ? kLrThreads : kLrPipeThreads;
  auto kern = lr_kernel<P, XP, V>();
  static std::atomic<int> granted[kLabMaxDevices];
  cudaError_t e = lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  if (a.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_per_sm, kern,
                                                         threads, smem);
  HopMap in_map;
  const long long dim[3] = {g.X, g.sy, g.sz};
  const int box[3] = {lr_xc(XP), g.ty + 2 * P, g.tz + 2 * P};
  if (hop_map_3d(&in_map, const_cast<void*>(a.u), sizeof(C), dim, box))
    return cudaErrorInvalidValue;
  C* y = static_cast<C*>(a.y);
  const C* tab = static_cast<const C*>(a.tables);
  const unsigned char* xb = static_cast<const unsigned char*>(a.xb);
  if constexpr (V == 17) {
    kern<<<dim3(g.nty, g.ntz, q.nsplit), threads, smem, a.stream>>>(
        in_map, y, tab, xb, q, mode);
  } else {
    // the counter starts at 0 on the launch's stream, whatever ran before
    e = cudaMemsetAsync(a.tickets, 0, sizeof(*a.tickets), a.stream);
    if (e != cudaSuccess) return e;
    kern<<<a.grid, threads, smem, a.stream>>>(in_map, y, tab, xb, q, mode,
                                              a.tickets);
  }
  return cudaGetLastError();
}
#endif

}  // namespace tpufem
