// The solver-resident 3D band operators on Hopper's TMA ring: the device
// code of K1 and K4.  The host launcher with its plain C interface is
// resident_ring.cu.
//
// Replaces the Pallas kernels of tpufem/ops/pallas_separable.py:
//   K1  _kernel_resident        (ResidentSeparable: the 3D Laplace, with the
//                                optional fused Dirichlet mask)
//   K4  _kernel_resident_terms  (ResidentTerms: sum of T tensor products)
// One routine with two plans, chosen at compile time:
//   K1 (kPlanLaplace)  s = Bz(u; Mz), t = Bz(u; Kz), q1 = By(s; My),
//                      q23 = By(s; Ky) + By(t; My),
//                      out = Bx(q1; Kx) + Bx(q23; Mx)           (7 bands)
//   K4 (kPlanTerms)    per term a: t = Bz(u; X_{a,2}), q_a = By(t; X_{a,1}),
//                      out = sum_a Bx(q_a; X_{a,0})             (3T bands)
// Every band is an exact per-row table in K2's difference form (common.cuh:
// the row sum R in f64 from the host), sum_o W[g,o] (v[g+o-P] - v[g]) +
// R[g] v[g].  Each output is summed by the one thread that owns it, terms in
// a fixed order, so results are bitwise reproducible run to run.
//
// The resident layout is (npts, npts, X), x fastest, X the smallest multiple
// of a chunk (XC columns, 64 bytes of a row: 16 in f32, 32 in bf16, 8 in
// f64) that is >= npts; columns npts .. X are zeros.  One layout in and out:
// the kernel writes every point of its output, the pad columns as zeros.  It
// stores no z or y halo: the producer asks for the box at (z0 - P, y0 - P)
// and TMA fills what lies beyond the tensor with zeros.
//
// The fused Dirichlet mask (dirichlet): on the hyper_cube the interior mask
// is separable, m = D(x)D(x)D with D = diag(0, 1, ..., 1, 0), so
// m A m = sum_a (D X_{a,2} D)(x)(D X_{a,1} D)(x)(D X_{a,0} D) exactly, and
// the host passes the tables of the masked 1D matrices (their R summed in
// f64 from the masked rows).  The kernel adds the (1 - m) x term at the
// store only: a boundary point stores its input, read from device memory
// (2.3% of the points at npts = 257).  No band loop tests a bound.
//
// Schedule: the ring of band_ring.cuh, a (TZ, TY) sub-tile over all of x,
// u chunks by TMA through kRingStages slots, y outputs kept in circular
// windows of res_win(XC) columns, the x band of chunk c - 1 once chunk c has
// its y outputs, each warp's piece stored as one TMA box.  Storage type S
// (u slots, output boxes) and compute type C (the z outputs, the windows):
// one conversion at the z stage and one at the store (bf16s: bf16 storage,
// f32 arithmetic).  Per chunk, for both plans:
//   z  the whole block: a thread bands a run of kResRun rows of one (y, x)
//      column of the slot, the column's taps in registers, into K1's s and
//      t, or into each term's t (K4: every term of the group from one read
//      of the taps); then the slot is released and a block barrier
//   y  each warp its piece of the rows, a lane a run of rows of one column,
//      taps in registers, into the windows: K1's q1 and q23, K4's q_a
//   x  each warp, the chunk before: a lane keeps its column x (its table
//      rows in registers, loaded as 16-byte vectors: rows are res_nwp(P)
//      values apart) and sums the terms in order; then the store, and a
//      block barrier before the next z stage overwrites s and t
// K4 keeps the windows and t buffers of a group of G terms; the host picks
// the sub-tile that holds all T (G = T: the shell and the separable
// coefficient, T = 3, at (8, 8) in f32 with two blocks an SM) where one
// does.  A larger T takes ceil(T / G) passes over x, each reloading the u
// boxes: a pass before the last stores its sums in the compute type (plain
// stores, read back by the same lane), the last adds them and stores.
//   copy, bands  the timing ablations, at the plan's shared memory and
//      occupancy: the ring's loads and stores alone (out = the box's
//      centre), and the z and y stages too (out = the windows summed at x,
//      no x band).  They split a plan's time into the tile mover, its z/y
//      bands and its x band.
//
// What bounds it on an H100 80GB HBM3 (700 W): each point read and written
// once is 0.0405 ms at 16,974,593 DoFs in f32, 0.0429 ms on the padded
// layout (272 columns for 257); the bands, 2P+1 multiply-adds an output
// each (7 for K1, 9 for K4 at T = 3), are 4.8 and 6.2 GFLOP at P = 4, far
// below the f32 peak.  The design adds: the halo re-read from L2, (TZ+2P)
// (TY+2P) / (TZ TY) = 4x at (8, 8), P = 4; the band stages' shared-memory
// reads, (kResRun + 2P) / kResRun taps and a row's vectors an output in the
// z and y stages, 2P+1 taps in the x stage; two block barriers a chunk.
#pragma once

#include <type_traits>

#include "band_ring.cuh"
#include "common.cuh"

namespace tpufem {

enum ResPlan { kPlanLaplace = 0, kPlanTerms = 1 };
enum ResMode { kResApply = 0, kResCopy = 1, kResBands = 2 };

// columns of a window: two chunks and the P <= 8 columns behind them
__host__ __device__ constexpr int res_win(int xc) { return 2 * xc + 8; }
// a table row's stride: its 2P+2 values padded to a multiple of four, so a
// row loads as 16-byte vectors
__host__ __device__ constexpr int res_nwp(int p) { return (2 * p + 5) / 4 * 4; }
// output elements a lane sums at a time in the x stage
constexpr int kResRound = 4;
// rows a thread bands from one column of taps in registers (z, y stages)
constexpr int kResRun = 4;

// Geometry of one launch.  group: the terms whose windows are resident (K1:
// its q1 and q23, 2).
struct ResGeo {
  int npts, X, tz, ty, n_terms, group, dirichlet;
};

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   bar  the ring's mbarriers, full then empty
//   tab  z/y table rows of the sub-tile, res_nwp(P) apart: K1 [Ky, My (TY
//        rows), Kz, Mz (TZ rows)]; K4 per term of the group [X_{a,1} (TY
//        rows), X_{a,2} (TZ rows)]
//   u    kRingStages slots of the halo'd u chunk (TZ+2P, TY+2P, XC), S
//   st   (TZ, TY+2P, XC) buffers, C: K1's s and t; K4's t of each term
//   q    nwin windows (M, res_win(XC)), C: K1's q1 and q23; K4's q_a
//   o    two output slots (M, XC), S, piece by piece
// nwin: K1 2, K4 its group.  The ablations take their plan's: they run at
// the same occupancy.
struct ResSmem {
  long long bar, tab, u, u_bytes, st, st_bytes, q, q_bytes, o, o_bytes,
      total;
};
__host__ __device__ inline ResSmem res_smem(int p, int es, int ec, int nwin,
                                            int tz, int ty) {
  const long long ly = ty + 2 * p, lz = tz + 2 * p;
  const long long xc = ring_xc(es), M = (long long)tz * ty;
  ResSmem s;
  s.bar = 0;
  s.tab = ring_align(2 * kRingStages * 8);
  s.u = s.tab + ring_align((long long)nwin * (tz + ty) * res_nwp(p) * ec);
  s.u_bytes = ring_align(lz * ly * xc * es);
  s.st = s.u + kRingStages * s.u_bytes;
  s.st_bytes = ring_align(tz * ly * xc * ec);
  s.q = s.st + nwin * s.st_bytes;
  s.q_bytes = ring_align(M * res_win(xc) * ec);
  s.o = s.q + nwin * s.q_bytes;
  s.o_bytes = ring_align(M * xc * es);
  s.total = s.o + 2 * s.o_bytes;
  return s;
}

// The sub-tiles the routine takes: the ring's pieces (the window holds two
// chunks and the P <= 8 columns behind them).
__host__ __device__ inline bool res_takes(int p, int tz, int ty) {
  return p <= 8 && ring_pieces_take(p, tz, ty);
}

// A table row (2P+2 values, 16-byte aligned) into registers, by 16-byte
// vectors on the card.
template <int P, typename C>
__device__ __forceinline__ void res_row(const C* w, C (&r)[2 * P + 2]) {
  constexpr int NW = 2 * P + 2, K = 16 / sizeof(C);
#ifdef __CUDA_ARCH__
  using V = typename std::conditional<sizeof(C) == 4, float4, double2>::type;
#pragma unroll
  for (int k = 0; k < (NW + K - 1) / K; ++k) {
    const V q = reinterpret_cast<const V*>(w)[k];
    const C* c = reinterpret_cast<const C*>(&q);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (k * K + j < NW) r[k * K + j] = c[j];
  }
#else
  for (int k = 0; k < NW; ++k) r[k] = w[k];
#endif
}

// The difference form of common.cuh's band, split so that bands sharing
// their taps share the differences: res_diffs takes the 2P+1 taps v (stored
// in V, converted to C) to d[o] = v[o] - v[P] and returns the centre v[P];
// res_band then sums one row w (in registers) over them,
// sum_o w[o] d[o] + w[2P+1] v[P].
template <int P, typename C, typename V>
__device__ __forceinline__ C res_diffs(const V* v, C (&d)[2 * P + 1]) {
  const C vc = Conv<V, C>::load(v[P]);
#pragma unroll
  for (int o = 0; o < 2 * P + 1; ++o) d[o] = Conv<V, C>::load(v[o]) - vc;
  return vc;
}
template <int P, typename C>
__device__ __forceinline__ C res_band(const C (&w)[2 * P + 2],
                                      const C (&d)[2 * P + 1], C vc) {
  C acc = C(0);
#pragma unroll
  for (int o = 0; o < 2 * P + 1; ++o) acc += w[o] * d[o];
  return acc + w[2 * P + 1] * vc;
}

// One block per (TZ, TY) sub-tile of the grid's rows, grid (ceil(npts/TY),
// ceil(npts/TZ)), of kRingThreads threads: kRingWarps consumer warps and a
// producer warp.  in_map / out_map: the resident layouts of u and out
// (npts, npts, X), in boxes (TZ+2P, TY+2P, XC) and (bz, by, XC), a warp's
// piece; u is the input's as a plain pointer (the boundary's input); part
// holds the partial sums of the passes before the last (K4 beyond its term
// group: out itself when S is C, else a (npts, npts, X) C buffer).  tables,
// rows res_nwp(P) apart: K1 (6, npts, .) [Kx, Mx, Ky, My, Kz, Mz]; K4 (T,
// 3, npts, .), axis 0 = x (masked with dirichlet).  One host thread
// (blockDim 1) runs the producer's step, then each warp's piece, lane by
// lane.
template <int P, typename S, typename C, int PLAN>
__global__ void __launch_bounds__(kRingThreads, 2)
resident_ring_kernel(const __grid_constant__ HopMap in_map,
                     const __grid_constant__ HopMap out_map,
                     const S* __restrict__ u, C* part,
                     const C* __restrict__ tables, ResGeo g, int mode) {
  constexpr int NW = 2 * P + 2, NWP = res_nwp(P), NB = 2 * P + 1;
  constexpr int XC = ring_xc(sizeof(S)), WX = res_win(XC), R = kResRun;
  constexpr bool K4 = PLAN == kPlanTerms;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const bool solo = blockDim.x < 64;
  const int warp = tid / 32, lane = tid % 32;
  // lanes this thread runs: its own, or all 32 in turn on the host
  const int ln0 = solo ? 0 : lane, ln1 = solo ? 32 : lane + 1;
  const int cn = solo ? 1 : 32 * kRingWarps;  // consumer threads
  const int tz = g.tz, ty = g.ty, lz = tz + 2 * P, ly = ty + 2 * P;
  const int X = g.X, npts = g.npts, last = npts - 1;
  const int nwin = K4 ? g.group : 2;
  const ResSmem pl = res_smem(P, sizeof(S), sizeof(C), nwin, tz, ty);
  const RingPieces pc = ring_pieces(tz, ty);
  const int nsub = pc.bz * pc.by * XC;  // elements of a piece's box
  const int nper = (nsub + 31) / 32;    // of them, per lane
  // the y stage's runs: ry rows, the longest (up to R) that divides the
  // piece's rows and leaves a run for each lane
  int ry = R;
  while (ry > 1 && (pc.by % ry || pc.bz * pc.by / ry * XC < 32)) ry /= 2;
  const int nseg = pc.bz * pc.by / ry * XC;
  // the z stage's runs: R rows of a (y, x) column of the slot
  const int zs = ly * XC, nzrun = (tz + R - 1) / R;
  const Ring ring{reinterpret_cast<uint64_t*>(smem_raw + pl.bar),
                  smem_raw + pl.u, pl.u_bytes,
                  (unsigned)(lz * ly * XC * sizeof(S))};
  const int z0 = blockIdx.y * tz, y0 = blockIdx.x * ty;
  const int nchunk = X / XC;
  const bool copy = mode == kResCopy, bands = mode == kResBands;
  const int npass = K4 && !copy ? (g.n_terms + g.group - 1) / g.group : 1;
  const long long tsz = (long long)npts * NWP;

  ring.init(tid);
  __syncthreads();

  if (!solo && warp == kRingWarps) {  // the producer warp
    if (lane == 0)
      for (int k = 0; k < npass * nchunk; ++k) {
        ring.reusable(k);
        ring.load(k, &in_map, k % nchunk * XC, y0 - P, z0 - P);
      }
    return;
  }

  C* tab = reinterpret_cast<C*>(smem_raw + pl.tab);
  auto st = [&](int a) {  // K1: s (0) and t (1); K4: term a's t
    return reinterpret_cast<C*>(smem_raw + pl.st + a * pl.st_bytes);
  };
  auto win = [&](int a) {
    return reinterpret_cast<C*>(smem_raw + pl.q + a * pl.q_bytes);
  };
  // the rows of the sub-tile's z/y tables: K1 [Ky, My, Kz, Mz]; K4 term a's
  // y rows, then its z rows
  const C* wky = tab;
  const C* wmy = tab + ty * NWP;
  const C* wkz = tab + 2 * ty * NWP;
  const C* wmz = wkz + tz * NWP;
  auto wya = [&](int a) { return tab + (long long)a * (ty + tz) * NWP; };
  auto wza = [&](int a) { return wya(a) + ty * NWP; };

  for (int pass = 0; pass < npass; ++pass) {
    const int a0 = pass * g.group;
    const int ng = K4 ? (g.n_terms - a0 < g.group ? g.n_terms - a0 : g.group)
                      : 0;
    if (!copy) {
      // the sub-tile's z/y table rows (rows beyond the grid: zeros)
      if (pass > 0) ring_sync(cn);  // the last pass's readers are done
      const int nrow = K4 ? ng * (ty + tz) : 2 * (ty + tz);
      for (int i = tid; i < nrow * NWP; i += cn) {
        const int row = i / NWP, o = i - row * NWP;
        const int blk = row / (ty + tz), r = row - blk * (ty + tz);
        const bool isy = K4 ? r < ty : row < 2 * ty;
        const int rr = K4 ? (isy ? r : r - ty)
                          : (isy ? row % ty : (row - 2 * ty) % tz);
        const int gg = (isy ? y0 : z0) + rr;
        // the source table: K1 [Kx, Mx, Ky, My, Kz, Mz]; K4 term a0 + blk's
        // y (axis 1) or z (axis 2)
        const long long src =
            K4 ? ((long long)(a0 + blk) * 3 + (isy ? 1 : 2)) * tsz
               : (long long)(isy ? 2 + row / ty : 4 + (row - 2 * ty) / tz) *
                     tsz;
        tab[i] = gg < npts ? tables[src + (long long)gg * NWP + o] : C(0);
      }
      ring_sync(cn);
    }
    // the last pass's TMA stores may land where this lane's stores of the
    // partial sums did (part aliases out when S is C)
    if (pass > 0 && pass + 1 == npass) hop_fence_async_global();

    const int nsteps = copy ? nchunk : nchunk + 1;
    for (int ch = 0; ch < nsteps; ++ch) {
      const int k = pass * nchunk + ch;  // the box's number in the ring
      const int cx0 = ch * XC;
      const bool loaded = ch < nchunk;
      const S* U = reinterpret_cast<const S*>(ring.slot(k));
      if (loaded) {
        if (solo) ring.load(k, &in_map, cx0, y0 - P, z0 - P);
        ring.wait(k);
      }
      if (loaded && !copy) {
        // z stage, the whole block: a thread bands a run of R consecutive
        // rows of one (y, x) column of the slot, its R + 2P taps in
        // registers, into K1's s and t or each of the group's t
        for (int i = tid; i < zs * nzrun; i += cn) {
          const int c = i % zs, iz0 = i / zs * R;
          S v[R + 2 * P];
#pragma unroll
          for (int o = 0; o < R + 2 * P; ++o)
            v[o] = iz0 + o < lz ? U[(iz0 + o) * zs + c]
                                : Conv<S, C>::store(C(0));
#pragma unroll
          for (int o = 0; o < R; ++o) {
            const int iz = iz0 + o;
            if (iz >= tz) break;
            C w[NW], d[NB];
            const C vc = res_diffs<P>(v + o, d);
            for (int a = 0; a < (K4 ? ng : 2); ++a) {
              res_row<P>(K4 ? wza(a) + iz * NWP
                            : (a ? wkz : wmz) + iz * NWP, w);
              st(a)[iz * zs + c] = res_band<P>(w, d, vc);
            }
          }
        }
        __syncwarp();
        if (lane == 0 && !solo) ring.release(k);
        ring_sync(cn);
        // y stage, each warp its piece: a lane bands a run of ry
        // consecutive rows of one (z, x) column, its ry + 2P taps in
        // registers, into the windows at column chunk ch
        for (int w = solo ? 0 : warp; w < kRingWarps;
             w += solo ? 1 : kRingWarps) {
          const int wz = w / pc.nwy * pc.bz, wy = w % pc.nwy * pc.by;
          for (int ln = ln0; ln < ln1; ++ln)
            for (int sg = ln; sg < nseg; sg += 32) {
              const int ix = sg % XC, r = sg / XC;
              const int iy0 = wy + r % (pc.by / ry) * ry;
              const int iz = wz + r / (pc.by / ry);
              const int base = (iz * ly + iy0) * XC + ix;
              const long long qi =
                  (long long)(iz * ty + iy0) * WX + (cx0 + ix) % WX;
              for (int a = 0; a < (K4 ? ng : 1); ++a) {
                C v[R + 2 * P], v1[R + 2 * P];
#pragma unroll
                for (int o = 0; o < R + 2 * P; ++o) {
                  v[o] = o < ry + 2 * P ? st(a)[base + o * XC] : C(0);
                  if (!K4) v1[o] = o < ry + 2 * P ? st(1)[base + o * XC] : C(0);
                }
#pragma unroll
                for (int o = 0; o < R; ++o) {
                  if (o >= ry) break;
                  const long long q = qi + (long long)o * WX;
                  C wa[NW], wb[NW], d[NB];
                  const C vc = res_diffs<P>(v + o, d);
                  if constexpr (K4) {
                    res_row<P>(wya(a) + (iy0 + o) * NWP, wa);
                    win(a)[q] = res_band<P>(wa, d, vc);
                  } else {
                    // q1 = By(s; My), q23 = By(s; Ky) + By(t; My)
                    res_row<P>(wmy + (iy0 + o) * NWP, wa);
                    res_row<P>(wky + (iy0 + o) * NWP, wb);
                    win(0)[q] = res_band<P>(wa, d, vc);
                    const C q2 = res_band<P>(wb, d, vc);
                    const C tc = res_diffs<P>(v1 + o, d);
                    win(1)[q] = q2 + res_band<P>(wa, d, tc);
                  }
                }
              }
            }
        }
      }
      if (copy || ch > 0) {
        // each warp: the x band of chunk ch - 1 (copy: chunk ch's centre)
        // into its output slot, then its box
        const int ox0 = copy ? cx0 : cx0 - XC;
        for (int w = solo ? 0 : warp; w < kRingWarps;
             w += solo ? 1 : kRingWarps) {
          const int wz = w / pc.nwy * pc.bz, wy = w % pc.nwy * pc.by;
          S* O = reinterpret_cast<S*>(smem_raw + pl.o +
                                      (ch & 1) * pl.o_bytes) +
                 (long long)w * nsub;
          ring_out_acquire(lane);  // the store of two chunks ago
          for (int ln = ln0; ln < ln1; ++ln) {
            // a lane keeps its column from element to element (XC divides
            // the warp): x = ox0 + ln % XC
            const int x = ox0 + ln % XC;
            if (copy) {
              for (int e = ln; e < nsub; e += 32) {
                const int r = e / XC;
                const int iy = wy + r % pc.by, iz = wz + r / pc.by;
                O[e] = U[((iz + P) * ly + iy + P) * XC + e % XC];
              }
              continue;
            }
            // the lane's elements j = j0 .. j0 + kResRound - 1 at a time
            for (int j0 = 0; j0 < nper; j0 += kResRound) {
              C acc[kResRound];
              int row[kResRound];  // the element's window row, -1: none
#pragma unroll
              for (int jj = 0; jj < kResRound; ++jj) {
                const int e = ln + 32 * (j0 + jj), r = e / XC;
                acc[jj] = C(0);
                row[jj] = e < nsub ? (wz + r / pc.by) * ty + wy + r % pc.by
                                   : -1;
              }
              for (int a = 0; x < npts && a < (K4 ? ng : 1); ++a) {
                if (bands) {  // the windows at x, no x band
#pragma unroll
                  for (int jj = 0; jj < kResRound; ++jj) {
                    if (row[jj] < 0) break;
                    const long long qi = (long long)row[jj] * WX + x % WX;
                    acc[jj] += win(a)[qi];
                    if (!K4) acc[jj] += win(1)[qi];
                  }
                  continue;
                }
                // K1: Bx(q1; Kx) + Bx(q23; Mx); K4: Bx(q_a; X_{a,0})
                const C* ta = (K4 ? tables + (long long)(a0 + a) * 3 * tsz
                                  : tables) + (long long)x * NWP;
                C wa[NW], wb[NW], v[NB];
                res_row<P>(ta, wa);
                if (!K4) res_row<P>(ta + tsz, wb);
#pragma unroll
                for (int jj = 0; jj < kResRound; ++jj) {
                  if (row[jj] < 0) break;
                  ring_taps<P, WX>(win(a) + (long long)row[jj] * WX, x, X, v);
                  acc[jj] += band<P>(wa, v, 1);
                  if (!K4) {
                    ring_taps<P, WX>(win(1) + (long long)row[jj] * WX, x, X,
                                     v);
                    acc[jj] += band<P>(wb, v, 1);
                  }
                }
              }
              // the store: a pass before the last keeps its sums in `part`;
              // the last adds them, then pad columns 0, boundary points
              // (fused mask) their input
#pragma unroll
              for (int jj = 0; jj < kResRound; ++jj) {
                const int e = ln + 32 * (j0 + jj), r = e / XC;
                if (e >= nsub) break;
                const int gz = z0 + wz + r / pc.by, gy = y0 + wy + r % pc.by;
                const long long gi = ((long long)gz * npts + gy) * X + x;
                const bool in = x < npts && gz < npts && gy < npts;
                C sum = acc[jj];
                if (in && pass > 0) sum += part[gi];
                if (pass + 1 < npass) {
                  if (in) part[gi] = sum;
                  continue;
                }
                S val = Conv<S, C>::store(C(0));
                if (in)
                  val = g.dirichlet && (gz == 0 || gz == last || gy == 0 ||
                                        gy == last || x == 0 || x == last)
                            ? u[gi]
                            : Conv<S, C>::store(sum);
                O[e] = val;
              }
            }
          }
          ring_out_store(lane, &out_map, O,
                         pass + 1 == npass && z0 + wz < npts &&
                             y0 + wy < npts,
                         ox0, y0 + wy, z0 + wz, &ring,
                         copy && !solo ? k : -1);
        }
      }
      // the next z stage overwrites the st buffers
      if (!copy && ch + 1 < nchunk) ring_sync(cn);
    }
  }
  if (lane == 0) hop_store_wait<0>();
}

}  // namespace tpufem
