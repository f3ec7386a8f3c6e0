// Fused separable Laplace apply on a uniform tensor grid: the device code.
//
// Replaces the Pallas kernel K2 of tpufem/ops/pallas_separable.py,
// ``_kernel`` (PallasSeparable, flat 2D/3D vmult).  (K1, the resident 3D
// apply with the fused Dirichlet mask, runs on the TMA ring of
// resident_ring.cuh.)  It applies
//   2D:  A = Ky(x)Mx + My(x)Kx
//   3D:  A = Kz(x)My(x)Mx + Mz(x)Ky(x)Mx + Mz(x)My(x)Kx
// with each 1D operator given as an EXACT per-row band table
//   W[g, o] = M[g, g + o - P],  o = 0..2P   (zero outside [0, npts)),
// so boundary rows need no correction and any banded matrix (per-axis h,
// non-symmetric) is applied as given.  Flat index = (z*npts + y)*npts + x:
// x is the fastest axis and table 0/1 (Kx/Mx) acts on it.
//
// Two schedules of the same arithmetic live here.  Both evaluate
//   z      s = Bz(u; Mz), t = Bz(u; Kz)                  (3D only)
//   y      q1 = By(s; My), q23 = By(s; Ky) + By(t; My)   (2D: q2 = By(u; Ky))
//   x      out = Bx(q1; Kx) + Bx(q23; Mx)
// (the schedule of pallas_separable.py:33-34, with the x stage a band as
// well: the TPU's dense K-stacked MXU matmul has no reason to exist here)
// with every band output by ``band<P>`` of common.cuh, the same taps in the
// same order, so the two give the same bits in f32 and f64.
//
// The z-march (separable_apply_march, what K2 launches).  A block owns an
// output column of (TY, TX) points over a segment [z0, z1) of z (2D: TX
// points of x over a segment of y, 8 rows a step: march_rows) and its
// threads own the halo'd (TY+2P, TX+2P) columns (2D: the TX+2P columns of
// x), march_cpt of them a thread.  Each thread keeps the 2P+1 values of u
// along z of each of its columns in a register ring and marches:
//   load   the plane z+P+1 of its columns, a step ahead of its use, by plain
//          coalesced 4-/8-byte loads (a warp reads consecutive x of a row;
//          no alignment asked), zeros written where it lies off the grid
//   z      s, t of each column from the ring (registers, no shared memory)
//          -> two shared planes (TY+2P, TX+2P)
//   y, x   from shared memory as the tile routine does it; store the plane
//   ring   rotated by moves (compile-time indices only: a ring indexed at
//          run time goes to local memory)
// A segment starts with a 2P-plane warm-up; the z halo is loaded once per
// segment, every other u point (TY+2P)(TX+2P)/(TY TX) times.  Band outputs
// a point: 2(TY+2P)(TX+2P)/(TY TX) from registers, 3(TX+2P)/TX + 2 from
// shared memory (3D; at (13, 65), p = 4: 3.6 and 5.4, where the tile
// routine reads all 10.75 from shared memory).  The host picks (TY, TX) and
// the segment count (choose_march in ops/kernel_separable.py) from the
// columns a block holds (march_cols) and its shared memory
// (march_smem_elems); TX need not be a power of two, so npts = 2^k 4 + 1
// splits into even tiles.
//
// The tile routine (separable_apply_kernel, PR 1's K2, kept as the
// march's earlier schedule: the g++ host tests hold the march bitwise
// against it and chip_smoke.py times the two in turns; K2 launches it only
// at the 2D sizes where it measured faster, TILE_NPTS in
// ops/kernel_separable.py).  One thread block, one output tile (TZ, TY, TX):
//   load   u tile + P-wide halo -> smem (out-of-range = 0)
//   z, y, x as above, every stage over the halo'd block in shared memory
//   store
// Each output is written by one thread with a fixed summation order, so
// results are bitwise reproducible.
//
// What bounds K2 on an H100: at P = 4 the operator needs ~2 x 4 bytes of
// device memory traffic per DoF in f32, 0.0051 ms for 2.1M DoFs at 3.35
// TB/s, while the band stages cost ~20 shared-memory reads per band output
// (9 taps, 10 table values).  The tile routine spends 10.75 band outputs a
// point from shared memory, reloads each u point ~5 times and overlaps no
// load with its bands (0.1295 ms per 2.1M-DoF f32 apply on an H100 80GB
// HBM3 at 700 W; PERF.md); the march takes the z bands to registers, loads
// each point about once and keeps the next plane's loads in flight behind
// the bands (0.0575 ms there, 2.3x; its 128 registers a thread hold two
// blocks an SM, and its y and x stages' shared-memory bands are what is
// left: 17% of its own loads' bound).
#pragma once

#include "common.cuh"

namespace tpufem {

// Shared-memory elements (of the compute type) one block uses; exported to
// Python as tpufem_smem_elems (separable_apply.cu) for the tile chooser.
//   tables: 2 per axis, (T_axis rows, 2P+2)
//   bufA:   u tile (LZ, LY, LX), later q1/q23 (2, TZ, TY, LX)
//   bufB:   3D: s/t (2, TZ, LY, LX); 2D: q1/q2 (2, TY, LX)
__host__ __device__ inline long long smem_elems(int dim, int p, int tz,
                                                int ty, int tx) {
  const long long lx = tx + 2 * p, ly = ty + 2 * p, nw = 2 * p + 2;
  if (dim == 3) {
    const long long lz = tz + 2 * p;
    long long a = lz * ly * lx;
    const long long q = 2LL * tz * ty * lx;
    if (q > a) a = q;
    return 2LL * (tz + ty + tx) * nw + a + 2LL * tz * ly * lx;
  }
  return 2LL * (ty + tx) * nw + ly * lx + 2LL * ty * lx;
}

// C: the storage and compute type (f32 or f64).
template <int P, int DIM, typename C>
__global__ void __launch_bounds__(kThreads)
separable_apply_kernel(const C* __restrict__ u, C* __restrict__ y,
                       const C* __restrict__ tables, int npts, int tz, int ty,
                       int tx) {
  constexpr int NW = 2 * P + 2;  // table row: 2P+1 taps, then the row sum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lx = tx + 2 * P, ly = ty + 2 * P;
  const int lz = (DIM == 3) ? tz + 2 * P : 1;
  const int nz = (DIM == 3) ? tz : 1;  // output rows along z in the tile
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;
  const int z0 = (DIM == 3) ? blockIdx.z * tz : 0;
  const long long plane = (long long)npts * npts;

  // per-tile rows of the band tables [Kx, Mx, Ky, My, Kz, Mz]
  C* wkx = sm;
  C* wmx = wkx + tx * NW;
  C* wky = wmx + tx * NW;
  C* wmy = wky + ty * NW;
  C* wkz = wmy + ty * NW;
  C* wmz = wkz + ((DIM == 3) ? tz * NW : 0);
  C* bufA = wmz + ((DIM == 3) ? tz * NW : 0);
  long long a_elems = (long long)lz * ly * lx;
  if (DIM == 3 && 2LL * tz * ty * lx > a_elems) a_elems = 2LL * tz * ty * lx;
  C* bufB = bufA + a_elems;

  const long long tsz = (long long)npts * NW;
  const int ntab = 2 * DIM;
  const int trows[6] = {tx, tx, ty, ty, tz, tz};
  const int tg0[6] = {x0, x0, y0, y0, z0, z0};
  C* tdst[6] = {wkx, wmx, wky, wmy, wkz, wmz};
  for (int k = 0; k < ntab; ++k) {
    for (int i = tid; i < trows[k] * NW; i += nthr) {
      const int r = i / NW, o = i - r * NW, g = tg0[k] + r;
      tdst[k][i] = (g < npts) ? tables[k * tsz + (long long)g * NW + o] : C(0);
    }
  }

  // u tile with a P-wide halo; out-of-range points are 0
  for (int i = tid; i < lz * ly * lx; i += nthr) {
    const int ix = i % lx, r = i / lx, iy = r % ly, iz = r / ly;
    const int gx = x0 - P + ix, gy = y0 - P + iy;
    const int gz = (DIM == 3) ? z0 - P + iz : 0;
    C v = C(0);
    if (gx >= 0 && gx < npts && gy >= 0 && gy < npts && gz >= 0 &&
        gz < npts)
      v = u[gz * plane + (long long)gy * npts + gx];
    bufA[i] = v;
  }
  __syncthreads();

  C* q1;
  C* q2;
  if (DIM == 3) {
    // z stage: (LZ, LY, LX) -> s, t (TZ, LY, LX); input row iz+o of the
    // same (y, x) sits at bufA[i + o*LY*LX]
    C* s = bufB;
    C* t = bufB + (long long)tz * ly * lx;
    const long long zs = (long long)ly * lx;
    for (int i = tid; i < tz * ly * lx; i += nthr) {
      const int iz = i / (ly * lx);
      s[i] = band<P>(wmz + iz * NW, bufA + i, zs);
      t[i] = band<P>(wkz + iz * NW, bufA + i, zs);
    }
    __syncthreads();
    // y stage: s, t (TZ, LY, LX) -> q1, q23 (TZ, TY, LX) in bufA
    q1 = bufA;
    q2 = bufA + (long long)tz * ty * lx;
    for (int i = tid; i < tz * ty * lx; i += nthr) {
      const int ix = i % lx, r = i / lx, iy = r % ty, iz = r / ty;
      const long long base = ((long long)iz * ly + iy) * lx + ix;
      q1[i] = band<P>(wmy + iy * NW, s + base, lx);
      q2[i] = band<P>(wky + iy * NW, s + base, lx) +
              band<P>(wmy + iy * NW, t + base, lx);
    }
  } else {
    // y stage: u (LY, LX) -> q1 = By(u; My), q2 = By(u; Ky) (TY, LX) in bufB
    q1 = bufB;
    q2 = bufB + (long long)ty * lx;
    for (int i = tid; i < ty * lx; i += nthr) {
      const int iy = i / lx;
      q1[i] = band<P>(wmy + iy * NW, bufA + i, lx);
      q2[i] = band<P>(wky + iy * NW, bufA + i, lx);
    }
  }
  __syncthreads();

  // x stage and store: out = Bx(q1; Kx) + Bx(q2; Mx)
  for (int i = tid; i < nz * ty * tx; i += nthr) {
    const int ix = i % tx, r = i / tx, iy = r % ty, iz = r / ty;
    const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
    if (gx >= npts || gy >= npts || gz >= npts) continue;
    const long long row = ((long long)iz * ty + iy) * lx + ix;
    y[gz * plane + (long long)gy * npts + gx] =
        band<P>(wkx + ix * NW, q1 + row, 1) +
        band<P>(wmx + ix * NW, q2 + row, 1);
  }
}

// Rows of the march axis one step of the march takes: 3D one plane (its
// y and x stages have a whole (TY, TX) plane of outputs); 2D eight rows, so
// a step's x stage has 8 TX outputs behind one barrier and its eight loads
// a column are in flight together.
__host__ __device__ constexpr int march_rows(int dim) {
  return dim == 3 ? 1 : 8;
}

// Columns of the halo'd tile a thread of the march carries (its register
// ring is unrolled over them): about 64 registers of ring a thread (the
// 2P + R values of a column's ring and its R prefetched ones, R =
// march_rows), at least 3 columns in 3D, so a useful tile exists at p = 8
// in f64, and at least 1 in 2D.
__host__ __device__ constexpr int march_cpt(int dim, int p, int elem_bytes) {
  const int words = (2 * p + 2 * march_rows(dim)) * (elem_bytes / 4);
  const int lo = dim == 3 ? 3 : 1;
  return 64 / words < lo ? lo : (64 / words > 16 ? 16 : 64 / words);
}

// Halo'd columns a block of the march holds ((TY+2P)(TX+2P); 2D: TX+2P).
__host__ __device__ inline int march_cols(int dim, int p, int elem_bytes) {
  return kThreads * march_cpt(dim, p, elem_bytes);
}

// Shared-memory elements (of the compute type) a block of the march uses;
// exported as tpufem_march_smem_elems (separable_apply.cu) for the chooser.
//   tables: x rows (Kx, Mx) and, 3D, y rows (Ky, My) of the tile, (T, 2P+2)
//           (the march axis's rows are read from device memory, one row a
//           step, the same address in every thread)
//   3D:     s, t planes (TY+2P, TX+2P); q1, q23 planes (TY, TX+2P)
//   2D:     q1, q2 (R, TX+2P) each, two buffers
__host__ __device__ inline long long march_smem_elems(int dim, int p, int ty,
                                                      int tx) {
  const long long lx = tx + 2 * p, nw = 2 * p + 2;
  if (dim == 3) return 2LL * (ty + tx) * nw + 2LL * (ty + 2 * p) * lx +
                       2LL * ty * lx;
  return 2LL * tx * nw + 4LL * march_rows(2) * lx;
}

// The z-march (see the note at the top).  CPT: columns a thread carries;
// the launcher gives march_cpt(DIM, P, sizeof(C)) and a block of kThreads,
// the g++ host build one thread that carries every column.  seg: planes
// (2D: rows) of the march axis a block walks.
template <int P, int DIM, typename C, int CPT>
__global__ void __launch_bounds__(kThreads)
separable_apply_march(const C* __restrict__ u, C* __restrict__ y,
                      const C* __restrict__ tables, int npts, int ty, int tx,
                      int seg) {
  constexpr int NW = 2 * P + 2;
  constexpr int RS = march_rows(DIM);  // march rows a step
  constexpr int NR = 2 * P + RS;       // a column's ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lx = tx + 2 * P;
  const int ly = (DIM == 3) ? ty + 2 * P : 1;
  const int ty_ = (DIM == 3) ? ty : 0;
  const int x0 = blockIdx.x * tx;
  const int y0 = (DIM == 3) ? blockIdx.y * ty : 0;
  const int m0 = ((DIM == 3) ? blockIdx.z : blockIdx.y) * seg;
  const int m1 = (m0 + seg < npts) ? m0 + seg : npts;
  // stride of the march axis in u and y
  const long long mstride = (DIM == 3) ? (long long)npts * npts : npts;
  const long long tsz = (long long)npts * NW;
  // the march axis's tables: M (s; 2D q1) and K (t; 2D q2)
  const C* wm_march = tables + (DIM == 3 ? 5 : 3) * tsz;
  const C* wk_march = tables + (DIM == 3 ? 4 : 2) * tsz;

  C* wkx = sm;
  C* wmx = wkx + tx * NW;
  C* wky = wmx + tx * NW;
  C* wmy = wky + ty_ * NW;
  C* buf = wmy + ty_ * NW;

  const int ntab = (DIM == 3) ? 4 : 2;
  const int trows[4] = {tx, tx, ty_, ty_};
  const int tg0[4] = {x0, x0, y0, y0};
  C* tdst[4] = {wkx, wmx, wky, wmy};
  for (int k = 0; k < ntab; ++k) {
    for (int i = tid; i < trows[k] * NW; i += nthr) {
      const int r = i / NW, o = i - r * NW, g = tg0[k] + r;
      tdst[k][i] = (g < npts) ? tables[k * tsz + (long long)g * NW + o] : C(0);
    }
  }

  // the thread's columns c = tid + k*nthr of the halo'd (LY, LX) tile: their
  // offset in a plane (-1: off the grid or beyond the tile)
  const int ncols = ly * lx;
  int off[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * nthr;
    const int gx = x0 - P + c % lx;
    const int gy = (DIM == 3) ? y0 - P + c / lx : 0;
    off[k] = (c < ncols && gx >= 0 && gx < npts && gy >= 0 && gy < npts)
                 ? gy * ((DIM == 3) ? npts : 0) + gx
                 : -1;
  }
  auto at = [&](int k, int m) -> C {
    return (off[k] >= 0 && m >= 0 && m < npts) ? u[m * mstride + off[k]]
                                               : C(0);
  };

  // the ring: ring[k][o] = u at march index m - P + o of column k (the
  // rows m .. m + RS - 1 of a step and P on each side)
  C ring[CPT][NR];
  C nxt[CPT][RS];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
#pragma unroll
    for (int o = 0; o < NR; ++o) ring[k][o] = at(k, m0 - P + o);
  }
  __syncthreads();  // the table rows

  for (int m = m0, b = 0; m < m1; m += RS, b ^= 1) {
    // the next step's rows, in flight behind this step's bands
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
#pragma unroll
      for (int r = 0; r < RS; ++r)
        nxt[k][r] = at(k, m + RS < m1 ? m + RS + P + r : -1);
    }
    if constexpr (DIM == 3) {
      // z stage from the ring -> s, t (LY, LX)
      C* s = buf;
      C* t = s + (long long)ly * lx;
      C* q1 = t + (long long)ly * lx;
      C* q2 = q1 + (long long)ty * lx;
      const C* wm = wm_march + (long long)m * NW;
      const C* wk = wk_march + (long long)m * NW;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = tid + k * nthr;
        if (c < ncols) {
          s[c] = band<P>(wm, ring[k], 1);
          t[c] = band<P>(wk, ring[k], 1);
        }
      }
      __syncthreads();
      // y stage: s, t (LY, LX) -> q1, q23 (TY, LX)
      for (int i = tid; i < ty * lx; i += nthr) {
        const int iy = i / lx;
        q1[i] = band<P>(wmy + iy * NW, s + i, lx);
        q2[i] = band<P>(wky + iy * NW, s + i, lx) +
                band<P>(wmy + iy * NW, t + i, lx);
      }
      __syncthreads();
      // x stage and store: out = Bx(q1; Kx) + Bx(q23; Mx)
      for (int i = tid; i < ty * tx; i += nthr) {
        const int ix = i % tx, iy = i / tx;
        const int gx = x0 + ix, gy = y0 + iy;
        if (gx >= npts || gy >= npts) continue;
        const int row = iy * lx + ix;
        y[m * mstride + (long long)gy * npts + gx] =
            band<P>(wkx + ix * NW, q1 + row, 1) +
            band<P>(wmx + ix * NW, q2 + row, 1);
      }
    } else {
      // y stage from the ring -> q1 = By(u; My), q2 = By(u; Ky) (RS, LX),
      // in buffer b: its readers, two steps ago, finished before the last
      // step's barrier
      C* q1 = buf + b * 2 * RS * lx;
      C* q2 = q1 + RS * lx;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = tid + k * nthr;
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          if (c < ncols && m + r < m1) {
            q1[r * lx + c] = band<P>(wm_march + (m + r) * NW, ring[k] + r, 1);
            q2[r * lx + c] = band<P>(wk_march + (m + r) * NW, ring[k] + r, 1);
          }
        }
      }
      __syncthreads();
      // x stage and store: out = Bx(q1; Kx) + Bx(q2; Mx), RS rows
      for (int i = tid; i < RS * tx; i += nthr) {
        const int ix = i % tx, r = i / tx, gx = x0 + ix;
        if (gx >= npts || m + r >= m1) continue;
        y[(m + r) * mstride + gx] =
            band<P>(wkx + ix * NW, q1 + r * lx + ix, 1) +
            band<P>(wmx + ix * NW, q2 + r * lx + ix, 1);
      }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
#pragma unroll
      for (int o = 0; o < 2 * P; ++o) ring[k][o] = ring[k][o + RS];
#pragma unroll
      for (int r = 0; r < RS; ++r) ring[k][2 * P + r] = nxt[k][r];
    }
  }
}

}  // namespace tpufem
