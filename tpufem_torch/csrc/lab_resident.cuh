// The K1 kernel lab on Hopper: four schedules of the solver-resident 3D
// Laplace apply with a tensor-core x stage, on two kinds of routine.  Device
// code of the tile routine and of the pieces they share; the ring routines
// are lab_resident_ring.cuh, the host launcher with its plain C interface
// lab_resident.cu.
//
// Replaces the Pallas lab kernels of scripts/kernel_lab.py:
//   v17  _kernel_v17  (kernel_lab.py:581)   halo'd resident layout, z/y band
//                                            stages, dense K-stacked x matmul
//   v18  _kernel_v18  (kernel_lab.py:1090)  v17 with fused band stages
//   v19  _kernel_v19  (kernel_lab.py:922)   v17 pipelined across tiles
//   v20  _kernel_v20  (kernel_lab.py:747)   v17 with a block-banded x matmul
// All four compute K1's operator A = Kz(x)My(x)Mx + Mz(x)Ky(x)Mx + Mz(x)My(x)Kx
// on the resident layout (sz, sy, X) = (npts + 2P, npts + 2P, X): data at
// [P:P+npts, P:P+npts, 0:npts], zeros elsewhere, X = npts rounded up to 16
// (the MMA tile).  Hopper has no 8-row sublane rule, so the halo is P rows
// in z and y (the TPU's H is not needed).  Each kernel writes the whole
// layout, halo and padding zeros included, so raw(raw(u)) chains.
//
// The two kinds:
//   ring  v17-v20 (lab_resident_ring.cuh: lab_ring_kernel for v17 and v18,
//         lab_ring_pipe_kernel, lab_window_kernel): a producer warp feeds the
//         halo'd u boxes by TMA and the host-split rows of [Kx^T; Mx^T] by
//         bulk copies through mbarrier rings; the bands of a 64-row sub-tile
//         run chunk by chunk of x into qq stages that warpgroups multiply on
//         wgmma (A from registers).  v17 and v19: the dense product, the
//         output accumulated in registers over all of x; v17 overlaps a
//         chunk's products with the next chunk's bands, v19 gives bands and
//         products warps of their own and walks the sub-tiles with
//         persistent blocks.  Bounded by the bands on CUDA cores and by B's
//         stream from L2 into every block.  v20: v19's roles, the x stage
//         windowed: each 32-column block multiplies only the 48 rows a half
//         of [Kx^T; Mx^T] its band needs (B 0.24 GB from L2 an apply, not
//         1.36), gathered from a ring of qq stages, and is stored as soon
//         as it retires; its products are small beside its bands, which
//         bound it (PERF.md has the split).
//   tile  the first version (lab_tile_kernel, lab_pipe_kernel, below):
//         the earlier schedule of v17-v20 (v18's with fused=1).  One (TZ, TY)
//         output tile over all of x (M = TZ*TY rows):
//   z, y   s = Bz(u; Mz), t = Bz(u; Kz); q1 = By(s; My), q23 = By(s; Ky) +
//          By(t; My) on CUDA cores, x streamed in chunks of kXC columns (the
//          TPU's (b+2p)(b+2H)X slab, ~2 MB, does not fit a block's 227 KB);
//          the z/y tables are K1's exact per-row band tables in difference
//          form (common.cuh)
//   qq     [q1 | q23], (M, 2X), in shared memory
//   x      out = qq @ [Kx^T; Mx^T], (M, 2X) x (2X, X), on tensor cores (WMMA
//          from shared memory, [Kx^T; Mx^T] from device memory, L2-resident)
//   store  per warp, masked to the data rows; boundary tiles write the halo
//          zeros of the rows they own
// v18 fuses the band stages: each z-slice value feeds both the Mz and Kz
// accumulators, each s value both My and Ky (the z stage already covers
// exactly the TY + 2P rows the y stage reads, the TPU's trim).  The ring's
// bands do so on every chunk (band2), so there v18 is v17's launch.  v19 runs
// persistent blocks over the tiles: warps 0-3 run the bands of tile t into
// one qq buffer while warps 4-7 run the tensor-core product of tile t-1
// from the other; one __syncthreads per pipeline step, a named barrier
// inside the band warps.  v20 runs the x stage only over the rows
// [lo - P, hi + P) of each half of [Kx^T; Mx^T] that a column block
// [lo, hi) of width N needs, rounded out to the MMA depth (a host table).
//
// x-stage precision (XP):
//   kX3TF32   f32 storage, 3xTF32: a = big + small in TF32, three products
//             (small*big, big*small, big*big), f32 accumulate (~f32)
//   kX1TF32   f32 storage, one TF32 product (~1e-3 relative)
//   kXBF16x3  f32 storage, bf16x3: hi/lo bf16 split of qq (made in the band
//             stage) and of [Kx^T; Mx^T] (on the host), lo*lo dropped
//   kXF64     f64 storage, DMMA m8n8k4
// Modes (timing ablations of kernel_lab.py:649-708): kFull; kCopy (the
// layout and its traffic only: out = in); kBands (bands only: out = q1 +
// q23 per column); kMM (the x product only, qq = [u | u]).
//
// What bounds it on an H100 (3.35 TB/s, 495 TFLOP/s TF32, 989 bf16, 67
// FP64 tensor): the function is K1's, so its bound is K1's, each DoF read
// and written once, 0.0405 ms at 17M DoFs in f32.  The design adds work:
// the padded layout moves 2 x 4 bytes per layout point, 0.046 ms, and the
// dense x stage is 2 npts^2 (2X) X = 19.5 GFLOP a pass at npts 257 (X =
// 272): 0.118 ms in 3xTF32, 0.039 ms in 1xTF32, 0.059 ms in bf16x3, so
// v17-v19 cannot come within 3x of the function's bound, while v20 (~6x
// fewer rows per 32-column block) keeps the design's bound at its bytes.
// The tile routine approaches neither: WMMA (not wgmma) from shared memory
// with the B operand read from L2 by every block, no TMA, a (TZ+2P)(TY+2P)
// /(TZ TY) ~ 7x halo re-read in the band stage (in 3xTF32 at the flagship on
// an H100 80GB HBM3 at 700 W, timed in turns with the ring routines by
// chip_smoke.py phase 6: v17 3.31 ms, its ring routine 0.69; v20 1.46, its
// windowed ring routine 0.49).  PERF.md has the measured split.
#pragma once

#include "common.cuh"
#include "lab_mma.cuh"

namespace tpufem {

constexpr int kLabThreads = 256;
constexpr int kXC = 32;  // x columns per band-stage chunk

enum LabMode { kFull = 0, kCopy = 1, kBands = 2, kMM = 3 };

// Geometry of one launch.
struct LabGeo {
  int npts, sz, sy, X, tz, ty, ntz, nty;
};

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   tab  z/y table rows of the tile [Ky, My (TY rows), Kz, Mz (TZ rows)]
//   u    nu slots of the u chunk (TZ+2P, TY+2P, xc); st: s and t (2, TZ,
//        TY+2P, xc)
//   qq   nbuf buffers of (M, 2X) (bf16: a hi then a lo array)
//   scr  one (MMA M, MMA N) accumulator tile per warp
struct LabSmem {
  long long tab, u, u_bytes, st, qq, qq_bytes, scr, total;
};

// nu: u slots (2: the next chunk's load runs during this chunk's bands,
// L2b's prefetch); xc: x columns per band-stage chunk.
__host__ __device__ inline LabSmem lab_smem(int p, int xp, int nbuf, int tz,
                                            int ty, int X, int nu = 1,
                                            int xc = kXC) {
  const long long c = xp == kXF64 ? 8 : 4;  // band and storage element
  const long long q = xp == kXF64 ? 8 : 4;  // qq bytes per (row, column)
  const long long mm = xp == kXF64 ? 8 : 16;
  const long long nw = 2 * p + 2, ly = ty + 2 * p, lz = tz + 2 * p;
  LabSmem s;
  s.tab = 0;
  s.u = lab_align(2LL * (tz + ty) * nw * c);
  s.u_bytes = lab_align(lz * ly * xc * c);
  s.st = s.u + nu * s.u_bytes;
  s.qq = s.st + lab_align(2LL * tz * ly * xc * c);
  s.qq_bytes = lab_align((long long)tz * ty * 2 * X * q);
  s.scr = s.qq + nbuf * s.qq_bytes;
  s.total = s.scr + lab_align((kLabThreads / 32) * mm * mm * c);
  return s;
}

// The u chunk of x columns [cx0, cx0 + XC) for the tile at (z0, y0): layout
// rows z0.., y0.. (data row g sits at layout row g + P), zeros beyond the
// layout.  async: by cp.async, 16 bytes a copy, committed as one group (the
// layout's rows are 16-byte aligned: X is a multiple of 16).
template <typename C, int XC>
__device__ __forceinline__ void lab_load_chunk(const C* __restrict__ u,
                                               const LabGeo& g, int z0, int y0,
                                               int lz, int ly, int cx0, C* U,
                                               bool async, int tid, int nthr) {
  if (!async) {
    for (int i = tid; i < lz * ly * XC; i += nthr) {
      const int ix = i % XC, r = i / XC, iy = r % ly, iz = r / ly;
      const int lzz = z0 + iz, lyy = y0 + iy, x = cx0 + ix;
      U[i] = (lzz < g.sz && lyy < g.sy && x < g.X)
                 ? u[((long long)lzz * g.sy + lyy) * g.X + x]
                 : C(0);
    }
    return;
  }
  constexpr int V = 16 / (int)sizeof(C), NV = XC / V;
  for (int i = tid; i < lz * ly * NV; i += nthr) {
    const int iv = i % NV, r = i / NV, iy = r % ly, iz = r / ly;
    const int lzz = z0 + iz, lyy = y0 + iy, x = cx0 + iv * V;
    C* dst = U + (long long)r * XC + iv * V;
    if (lzz < g.sz && lyy < g.sy && x < g.X) {
      lab_cp16(dst, u + ((long long)lzz * g.sy + lyy) * g.X + x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dst[e] = C(0);
    }
  }
  lab_cp_commit();
}

// z and y band stages of the tile at (z0, y0) into qq, by `nthr` threads
// (tid within the team) synchronised by barrier `bar`.  qq column x holds
// q1 (bands: q1 + q23), column X + x q23; copy and mm write the centre u.
// nu = 2: two u slots, the load of chunk c + 1 (cp.async) in flight during
// the bands of chunk c.
template <int P, int XP, int XC = kXC>
__device__ void lab_bands(const typename LabMma<XP>::C* __restrict__ u,
                          const typename LabMma<XP>::C* __restrict__ tables,
                          const LabGeo& g, int z0, int y0, int fused,
                          int mode, unsigned char* smem, const LabSmem& pl,
                          unsigned char* qq, int tid, int nthr, int bar,
                          int nu = 1) {
  using C = typename LabMma<XP>::C;
  constexpr int NW = 2 * P + 2;
  const int tz = g.tz, ty = g.ty, lz = tz + 2 * P, ly = ty + 2 * P;
  const int X = g.X, npts = g.npts;
  const long long M2X = (long long)tz * ty * 2 * X;
  const long long split = LabMma<XP>::kBF16 ? M2X : -1;
  const long long tsz = (long long)npts * NW;
  C* wky = reinterpret_cast<C*>(smem + pl.tab);
  C* wmy = wky + ty * NW;
  C* wkz = wmy + ty * NW;
  C* wmz = wkz + tz * NW;
  C* s = reinterpret_cast<C*>(smem + pl.st);
  C* t = s + (long long)tz * ly * XC;
  auto slot = [&](int ch) {
    return reinterpret_cast<C*>(smem + pl.u + (nu == 2 ? (ch & 1) : 0) *
                                                  pl.u_bytes);
  };

  lab_sync(bar, nthr);  // the previous tile's readers of tab/U/st are done
  if (nu == 2)
    lab_load_chunk<C, XC>(u, g, z0, y0, lz, ly, 0, slot(0), true, tid, nthr);
  for (int i = tid; i < 2 * ty * NW; i += nthr) {
    const int k = i / (ty * NW), j = i - k * ty * NW, r = j / NW;
    const int gg = y0 + r;
    wky[i] = gg < npts ? tables[k * tsz + (long long)gg * NW + (j - r * NW)]
                       : C(0);
  }
  for (int i = tid; i < 2 * tz * NW; i += nthr) {
    const int k = i / (tz * NW), j = i - k * tz * NW, r = j / NW;
    const int gg = z0 + r;
    wkz[i] = gg < npts
                 ? tables[(2 + k) * tsz + (long long)gg * NW + (j - r * NW)]
                 : C(0);
  }
  const long long zs = (long long)ly * XC;
  const int nchunk = (X + XC - 1) / XC;
  for (int ch = 0; ch < nchunk; ++ch) {
    const int cx0 = ch * XC;
    C* U = slot(ch);
    if (nu == 2) {
      lab_cp_wait();        // this thread's copies of chunk ch
      lab_sync(bar, nthr);  // everyone's; readers of chunk ch - 1 are done
      if (ch + 1 < nchunk)
        lab_load_chunk<C, XC>(u, g, z0, y0, lz, ly, cx0 + XC, slot(ch + 1),
                              true, tid, nthr);
    } else {
      lab_sync(bar, nthr);  // readers of the previous chunk are done
      lab_load_chunk<C, XC>(u, g, z0, y0, lz, ly, cx0, U, false, tid, nthr);
      lab_sync(bar, nthr);
    }
    if (mode == kCopy || mode == kMM) {
      for (int i = tid; i < tz * ty * XC; i += nthr) {
        const int ix = i % XC, r = i / XC, iy = r % ty, iz = r / ty;
        const int x = cx0 + ix;
        if (x >= X) continue;
        const C v = U[((long long)(iz + P) * ly + iy + P) * XC + ix];
        const long long row = (long long)(iz * ty + iy) * 2 * X;
        lab_put<C>(qq, split, row + x, v);
        if (mode == kMM) lab_put<C>(qq, split, row + X + x, v);
      }
      continue;
    }
    // z stage: (LZ, LY, XC) -> s, t (TZ, LY, XC)
    for (int i = tid; i < tz * ly * XC; i += nthr) {
      const int iz = i / (ly * XC);
      if (fused) {
        band2<P>(wmz + iz * NW, wkz + iz * NW, U + i, zs, s[i], t[i]);
      } else {
        s[i] = band<P>(wmz + iz * NW, U + i, zs);
        t[i] = band<P>(wkz + iz * NW, U + i, zs);
      }
    }
    lab_sync(bar, nthr);
    // y stage: s, t -> q1, q23 (TZ, TY, XC) -> qq
    for (int i = tid; i < tz * ty * XC; i += nthr) {
      const int ix = i % XC, r = i / XC, iy = r % ty, iz = r / ty;
      const int x = cx0 + ix;
      if (x >= X) continue;
      const long long base = ((long long)iz * ly + iy) * XC + ix;
      C q1, q2;
      if (fused) {
        band2<P>(wmy + iy * NW, wky + iy * NW, s + base, XC, q1, q2);
      } else {
        q1 = band<P>(wmy + iy * NW, s + base, XC);
        q2 = band<P>(wky + iy * NW, s + base, XC);
      }
      const C q23 = q2 + band<P>(wmy + iy * NW, t + base, XC);
      const long long row = (long long)(iz * ty + iy) * 2 * X;
      if (mode == kBands) {
        lab_put<C>(qq, split, row + x, q1 + q23);
      } else {
        lab_put<C>(qq, split, row + x, q1);
        lab_put<C>(qq, split, row + X + x, q23);
      }
    }
  }
  lab_sync(bar, nthr);  // qq complete
}

// Zeros of the halo and overhang rows the tile (bz, by) owns: its rows,
// extended to the layout's edge on a boundary tile.  Data rows are the x
// stage's (their padding columns come out of it as exact zeros).
template <typename C>
__device__ void lab_zero_halo(const LabGeo& g, int bz, int by, int P,
                              C* __restrict__ out, int tid, int nthr) {
  if (bz != 0 && by != 0 && bz != g.ntz - 1 && by != g.nty - 1) return;
  const int z0 = bz * g.tz, y0 = by * g.ty;
  const int zlo = bz == 0 ? 0 : P + z0, zhi = bz == g.ntz - 1 ? g.sz : P + z0 + g.tz;
  const int ylo = by == 0 ? 0 : P + y0, yhi = by == g.nty - 1 ? g.sy : P + y0 + g.ty;
  const int nyr = yhi - ylo;
  const long long n = (long long)(zhi - zlo) * nyr * g.X;
  for (long long i = tid; i < n; i += nthr) {
    const long long r = i / g.X;
    const int lyy = ylo + (int)(r % nyr), lzz = zlo + (int)(r / nyr);
    const int gz = lzz - P, gy = lyy - P;
    if (gz < 0 || gz >= g.npts || gy < 0 || gy >= g.npts)
      out[((long long)lzz * g.sy + lyy) * g.X + i % g.X] = C(0);
  }
}

// Where the rows of a sub-tile go in an output layout (., stride, X): row
// (gz, gy) of the grid at layout row (org + gz, org + gy), for gz, gy <
// nrows; beyond, the row is not stored.  L1's resident layout: org P,
// stride sy, nrows npts (its halo rows are lab_zero_halo's).  L2's output
// layout: org 0, stride NT, nrows NT (rows past npts come out of the band
// stages, whose tables are zero there, as exact zeros).
struct LabOut {
  int org, stride, nrows;
};
__host__ __device__ inline LabOut lab_resident_out(const LabGeo& g, int P) {
  return LabOut{P, g.sy, g.npts};
}

// Where a tile's row m goes in the output: rows(m) is its offset, or -1 for
// a row the tile does not store; the tile at (z0, y0), ty rows in y.
struct LabRows {
  LabOut o;
  int X, z0, y0, ty;
  __device__ __forceinline__ long long operator()(int m) const {
    const int gz = z0 + m / ty, gy = y0 + m % ty;
    if (gz >= o.nrows || gy >= o.nrows) return -1;
    return ((long long)(gz + o.org) * o.stride + gy + o.org) * X;
  }
};

// copy / bands: qq's first half is the output
template <int XP, typename Rows>
__device__ void lab_store_rows(const unsigned char* qq, const LabGeo& g,
                               const Rows& rows,
                               typename LabMma<XP>::C* __restrict__ out,
                               int tid, int nthr) {
  using C = typename LabMma<XP>::C;
  const int X = g.X;
  const long long M2X = (long long)g.tz * g.ty * 2 * X;
  const long long split = LabMma<XP>::kBF16 ? M2X : -1;
  for (long long i = tid; i < (long long)g.tz * g.ty * X; i += nthr) {
    const int m = (int)(i / X), x = (int)(i % X);
    const long long o = rows(m);
    if (o >= 0) out[o + x] = lab_get<C>(qq, split, (long long)m * 2 * X + x);
  }
}

// One k step of the x product for up to two M-row tiles sharing the B
// fragment: TF32 (3x or 1x), bf16 (x3, or the hi parts alone) or f64.
template <int XP>
struct LabStep {
  using T = LabMma<XP>;
  using FA = typename LabFrag<XP>::FA;
  using FB = typename LabFrag<XP>::FB;
  using FC = typename LabFrag<XP>::FC;

  // A rows: qq (ld 2X), k0 a column of qq; B: xk (ld X) at row k0, column n0
  static __device__ __forceinline__ void run(FC* acc, int nm,
                                             const unsigned char* qq,
                                             long long M2X, int m0, int k0,
                                             int n0, const void* xk,
                                             const void* xk_lo, int X) {
    const int lda = 2 * X;
    if constexpr (T::kBF16) {
      const __nv_bfloat16* qh = reinterpret_cast<const __nv_bfloat16*>(qq);
      const __nv_bfloat16* bh_p =
          static_cast<const __nv_bfloat16*>(xk) + (long long)k0 * X + n0;
      FB bh, bl;
      wmma::load_matrix_sync(bh, bh_p, X);
      if constexpr (XP == kXBF16x3)
        wmma::load_matrix_sync(
            bl, static_cast<const __nv_bfloat16*>(xk_lo) + (long long)k0 * X +
                    n0,
            X);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi >= nm) break;
        const long long off = (long long)(m0 + mi * T::M) * lda + k0;
        FA ah;
        wmma::load_matrix_sync(ah, qh + off, lda);
        if constexpr (XP == kXBF16x3) {
          FA al;
          wmma::load_matrix_sync(al, qh + M2X + off, lda);
          wmma::mma_sync(acc[mi], al, bh, acc[mi]);
          wmma::mma_sync(acc[mi], ah, bl, acc[mi]);
        }
        wmma::mma_sync(acc[mi], ah, bh, acc[mi]);
      }
    } else {
      using E = typename T::C;
      const E* qa = reinterpret_cast<const E*>(qq);
      const E* b_p = static_cast<const E*>(xk) + (long long)k0 * X + n0;
      FB b, bs;
      wmma::load_matrix_sync(b, b_p, X);
      if constexpr (XP == kX3TF32) lab_tf32_split(b, bs);
      if constexpr (XP == kX1TF32) lab_tf32_round(b);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (mi >= nm) break;
        FA a;
        wmma::load_matrix_sync(a, qa + (long long)(m0 + mi * T::M) * lda + k0,
                               lda);
        if constexpr (XP == kX3TF32) {
          FA as;
          lab_tf32_split(a, as);
          wmma::mma_sync(acc[mi], as, b, acc[mi]);
          wmma::mma_sync(acc[mi], a, bs, acc[mi]);
        }
        if constexpr (XP == kX1TF32) lab_tf32_round(a);
        wmma::mma_sync(acc[mi], a, b, acc[mi]);
      }
    }
  }
};

// x stage of a tile: out rows = qq @ [Kx^T; Mx^T] over the whole K = 2X
// (win == nullptr) or, per column block j, over the rows [win[2j],
// win[2j+1]) of each half (v20).  two: as two products into the same
// accumulators, a k step of q1 @ Kx^T then one of q23 @ Mx^T in turn, the
// halves read as two (X, X) operands (L2b's v13, v14).  rows(m): where row
// m goes (LabRows).  Jobs (column block, pair of M-row tiles) go round the
// `nwarps` warps of the team; warp-wide code, where one host thread
// (nlanes 1) stands for the whole warp.
template <int XP, typename Rows>
__device__ void lab_xstage(const unsigned char* qq, const void* xk,
                           const void* xk_lo, const int* __restrict__ win,
                           bool two, const LabGeo& g, const Rows& rows,
                           typename LabMma<XP>::C* __restrict__ scr,
                           typename LabMma<XP>::C* __restrict__ out, int warp,
                           int nwarps, int lane, int nlanes) {
  using T = LabMma<XP>;
  using S = LabStep<XP>;
  const int X = g.X, M = g.tz * g.ty;
  const long long M2X = (long long)M * 2 * X;
  const int nmt = M / T::M, nnt = X / T::N, nmg = (nmt + 1) / 2;
  typename T::C* sw = scr + warp * T::M * T::N;
  for (int job = warp; job < nnt * nmg; job += nwarps) {
    const int jn = job % nnt, mg = job / nnt;
    const int n0 = jn * T::N, m0 = mg * 2 * T::M;
    const int nm = nmt - 2 * mg < 2 ? nmt - 2 * mg : 2;
    typename S::FC acc[2];
    wmma::fill_fragment(acc[0], typename T::C(0));
    wmma::fill_fragment(acc[1], typename T::C(0));
    const int lo = win ? win[2 * jn] : 0;
    const int hi = win ? win[2 * jn + 1] : two ? X : 2 * X;
    for (int k0 = lo; k0 < hi; k0 += T::K) {
      S::run(acc, nm, qq, M2X, m0, k0, n0, xk, xk_lo, X);
      if (two) S::run(acc, nm, qq, M2X, m0, X + k0, n0, xk, xk_lo, X);
    }
    if (win)  // the Mx^T half
      for (int k0 = X + lo; k0 < X + hi; k0 += T::K)
        S::run(acc, nm, qq, M2X, m0, k0, n0, xk, xk_lo, X);
    for (int mi = 0; mi < nm; ++mi) {
      wmma::store_matrix_sync(sw, acc[mi], T::N, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < T::M * T::N; e += nlanes) {
        const int r = e / T::N, c = e - r * T::N;
        const long long o = rows(m0 + mi * T::M + r);
        if (o >= 0) out[o + n0 + c] = sw[e];
      }
      __syncwarp();
    }
  }
}

// v17, v18 (fused) and v20 (win): one block per (TZ, TY) tile, grid
// (nty, ntz); the whole block runs the bands, then each warp its x jobs.
template <int P, int XP>
__global__ void __launch_bounds__(kLabThreads)
lab_tile_kernel(const typename LabMma<XP>::C* __restrict__ u,
                typename LabMma<XP>::C* __restrict__ out,
                const typename LabMma<XP>::C* __restrict__ tables,
                const void* xk, const void* xk_lo,
                const int* __restrict__ win, LabGeo g, int fused, int mode) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const LabSmem pl = lab_smem(P, XP, 1, g.tz, g.ty, g.X);
  const int bz = blockIdx.y, by = blockIdx.x;
  const int z0 = bz * g.tz, y0 = by * g.ty;
  unsigned char* qq = smem_raw + pl.qq;
  lab_bands<P, XP>(u, tables, g, z0, y0, fused, mode, smem_raw, pl, qq, tid,
                   nthr, 0);
  lab_zero_halo(g, bz, by, P, out, tid, nthr);
  const LabRows rows{lab_resident_out(g, P), g.X, z0, y0, g.ty};
  if (mode == kCopy || mode == kBands) {
    lab_store_rows<XP>(qq, g, rows, out, tid, nthr);
    return;
  }
  const int nlanes = nthr < 32 ? nthr : 32;
  lab_xstage<XP>(qq, xk, xk_lo, win, false, g, rows,
                 reinterpret_cast<typename LabMma<XP>::C*>(smem_raw + pl.scr),
                 out, tid / 32, (nthr + 31) / 32, tid % 32, nlanes);
}

// v19: persistent blocks (grid <= tiles) walk tiles b, b + G, ...; step s
// runs the bands of the block's tile s (warps 0-3, named barrier 1) beside
// the x stage of its tile s - 1 (warps 4-7), qq double-buffered.  Every
// thread runs every step, so a block with fewer tiles than the two stages
// (or none) still meets each __syncthreads.  One host thread (blockDim 1)
// runs both halves of each step in turn.
template <int P, int XP>
__global__ void __launch_bounds__(kLabThreads)
lab_pipe_kernel(const typename LabMma<XP>::C* __restrict__ u,
                typename LabMma<XP>::C* __restrict__ out,
                const typename LabMma<XP>::C* __restrict__ tables,
                const void* xk, const void* xk_lo, LabGeo g, int mode) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const LabSmem pl = lab_smem(P, XP, 2, g.tz, g.ty, g.X);
  const int ntiles = g.ntz * g.nty, G = gridDim.x, b = blockIdx.x;
  const int n_my = b < ntiles ? (ntiles - b + G - 1) / G : 0;
  const bool solo = nthr < 64;
  const int half = solo ? nthr : nthr / 2;
  const bool band_team = solo || tid < half;
  const bool mma_team = solo || tid >= half;
  const int mtid = solo ? tid : tid - half;
  for (int step = 0; step <= n_my; ++step) {
    if (band_team && step < n_my) {
      const int t = b + step * G, bz = t / g.nty, by = t % g.nty;
      lab_bands<P, XP>(u, tables, g, bz * g.tz, by * g.ty, 0, mode, smem_raw,
                       pl, smem_raw + pl.qq + (step & 1) * pl.qq_bytes, tid,
                       half, solo ? 0 : 1);
      lab_zero_halo(g, bz, by, P, out, tid, half);
    }
    if (mma_team && step >= 1) {
      const int t = b + (step - 1) * G, bz = t / g.nty, by = t % g.nty;
      const unsigned char* qq =
          smem_raw + pl.qq + ((step - 1) & 1) * pl.qq_bytes;
      const LabRows rows{lab_resident_out(g, P), g.X, bz * g.tz,
                         by * g.ty, g.ty};
      if (mode == kCopy || mode == kBands) {
        lab_store_rows<XP>(qq, g, rows, out, mtid, half);
      } else {
        lab_xstage<XP>(
            qq, xk, xk_lo, nullptr, false, g, rows,
            reinterpret_cast<typename LabMma<XP>::C*>(smem_raw + pl.scr), out,
            mtid / 32, (half + 31) / 32, mtid % 32, half < 32 ? half : 32);
      }
    }
    __syncthreads();
  }
}

}  // namespace tpufem
