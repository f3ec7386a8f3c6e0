// Sum-of-tensor-products apply on a (npts,)^DIM grid: the device code.
//
// Replaces the Pallas kernels of tpufem/ops/pallas_separable.py:
//   K4  _kernel_resident_terms  (ResidentTerms, 3D)
//   K3  _kernel_resident_2d     (ResidentTerms2D, 2D, with its _xblocks
//                                block-tridiagonal x stage)
// One routine serves both.  It applies
//   y = sum_a  X_{a,DIM-1} (x) ... (x) X_{a,0}  u,      a = 0..T-1
// with each 1D operator X_{a,b} (b = 0 is x, the fastest axis) given as an
// EXACT per-row band table W[g, o] = X[g, g + o - P] plus the f64 row sum
// in the last column (common.cuh, ``band``).  The table array is
// (T, DIM, npts, 2P+2), row-major.  T is a runtime argument: 3 terms for a
// curved shell or a separable coefficient, DIM*R for a CP-expanded one.
//
// Schedule of one thread block, one output tile (TZ, TY, TX):
//   load    the u tile with its P-wide halo (out-of-range = 0), once, and
//           term 0's table rows for the tile, into shared memory
//   term a  z   t = Bz(u; X_{a,2})           (TZ, LY, LX)   (3D only)
//           y   q = By(t; X_{a,1})           (TZ, TY, LX)   (2D: By(u))
//           x   acc += Bx(q; X_{a,0})        (TZ, TY, TX)
//               beside it, load term a+1's table rows (two table slots)
//   store   acc
// Terms run in a fixed order and each output is summed by one thread, so
// results are bitwise reproducible.  The accumulator sits in shared memory
// rather than registers: the tile is a runtime choice, and one-thread
// host builds (tests/test_torch_kernel_host.py) run the same code.
// Shared memory does not grow with T: the table rows of two terms are
// resident at a time.
//
// On the TPU the x stage was a K-stacked MXU matmul (K4) or, past
// npts ~ 600, a block-tridiagonal sweep of deduplicated 128-lane blocks
// (K3's _xblocks); both answered VMEM limits.  Here the x stage is a band
// like the others.
//
// What bounds it on an H100: per output and term, three band stages of
// 2P+1 shared-memory taps (3D), against ~2 x 4 bytes of device memory per
// DoF in f32 for the whole apply.  Like K1 it is bound by shared-memory
// traffic and the integer index arithmetic of the strided stage loops, far
// from the memory bound; a T-term apply costs about T/3 of a 3-term one
// beyond the fixed load and store.  Register blocking along z, TMA tiles
// and persistent blocks are the later work.
#pragma once

#include "common.cuh"

namespace tpufem {

// Shared-memory elements (of the compute type) one block uses; exported to
// Python as tpufem_terms_smem_elems (terms_apply.cu) for the tile chooser.
//   tables: min(T, 2) slots x (TX + TY [+ TZ]) rows x (2P+2)
//   u:      (LZ, LY, LX)
//   t:      (TZ, LY, LX)                  (3D only)
//   q:      (TZ, TY, LX)
//   acc:    (TZ, TY, TX)
__host__ __device__ inline long long terms_smem_elems(int dim, int p,
                                                      int n_terms, int tz,
                                                      int ty, int tx) {
  const long long lx = tx + 2 * p, ly = ty + 2 * p, nw = 2 * p + 2;
  const long long slots = n_terms < 2 ? n_terms : 2;
  if (dim == 3) {
    const long long lz = tz + 2 * p;
    return slots * (tz + ty + tx) * nw + lz * ly * lx +
           (long long)tz * ly * lx + (long long)tz * ty * lx +
           (long long)tz * ty * tx;
  }
  return slots * (ty + tx) * nw + ly * lx +
         (long long)ty * lx + (long long)ty * tx;
}

template <int P, int DIM, typename S, typename C>
__global__ void __launch_bounds__(kThreads)
terms_apply_kernel(const S* __restrict__ u, S* __restrict__ y,
                   const C* __restrict__ tables, int n_terms, int npts,
                   int tz, int ty, int tx) {
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

  // per term, the tile's table rows: x (TX), then y (TY), then z (TZ);
  // two slots, term a in slot a % 2
  const int trows = tx + ty + ((DIM == 3) ? tz : 0);
  const long long tslot = (long long)trows * NW;
  C* tab = sm;
  C* ubuf = tab + ((n_terms < 2) ? 1 : 2) * tslot;
  C* tbuf = ubuf + (long long)lz * ly * lx;
  C* qbuf = tbuf + ((DIM == 3) ? (long long)tz * ly * lx : 0);
  C* acc = qbuf + (long long)nz * ty * lx;

  // the tile's table rows of term a into slot a % 2
  auto load_tables = [&](int a) {
    C* dst = tab + (a & 1) * tslot;
    for (int i = tid; i < trows * NW; i += nthr) {
      const int k = i / NW, o = i - k * NW;
      int b, g;
      if (k < tx) {
        b = 0;
        g = x0 + k;
      } else if (k < tx + ty) {
        b = 1;
        g = y0 + (k - tx);
      } else {
        b = 2;
        g = z0 + (k - tx - ty);
      }
      dst[i] = (g < npts)
                   ? tables[(((long long)a * DIM + b) * npts + g) * NW + o]
                   : C(0);
    }
  };

  load_tables(0);
  // u tile with a P-wide halo; out-of-range points are 0
  for (int i = tid; i < lz * ly * lx; i += nthr) {
    const int ix = i % lx, r = i / lx, iy = r % ly, iz = r / ly;
    const int gx = x0 - P + ix, gy = y0 - P + iy;
    const int gz = (DIM == 3) ? z0 - P + iz : 0;
    C v = C(0);
    if (gx >= 0 && gx < npts && gy >= 0 && gy < npts && gz >= 0 &&
        gz < npts)
      v = Conv<S, C>::load(u[gz * plane + (long long)gy * npts + gx]);
    ubuf[i] = v;
  }
  __syncthreads();

  for (int a = 0; a < n_terms; ++a) {
    const C* wx = tab + (a & 1) * tslot;
    const C* wy = wx + tx * NW;
    const C* src = ubuf;  // (nz-or-LZ rows, LY, LX) input of the y stage
    if (DIM == 3) {
      // z stage: u (LZ, LY, LX) -> t (TZ, LY, LX); input row iz+o of the
      // same (y, x) sits at ubuf[i + o*LY*LX]
      const C* wz = wy + ty * NW;
      const long long zs = (long long)ly * lx;
      for (int i = tid; i < tz * ly * lx; i += nthr) {
        const int iz = i / (ly * lx);
        tbuf[i] = band<P>(wz + iz * NW, ubuf + i, zs);
      }
      __syncthreads();
      src = tbuf;
    }
    // y stage: src (., LY, LX) -> q (TZ, TY, LX)
    for (int i = tid; i < nz * ty * lx; i += nthr) {
      const int ix = i % lx, r = i / lx, iy = r % ty, iz = r / ty;
      qbuf[i] = band<P>(wy + iy * NW, src + ((long long)iz * ly + iy) * lx +
                                          ix, lx);
    }
    __syncthreads();
    // x stage: acc (+)= Bx(q); output i is always summed by the same
    // thread.  The other slot was last read by term a-1, so term a+1's
    // tables load beside it.
    for (int i = tid; i < nz * ty * tx; i += nthr) {
      const int ix = i % tx, r = i / tx;  // r = iz*TY + iy
      const C v = band<P>(wx + ix * NW, qbuf + (long long)r * lx + ix, 1);
      acc[i] = (a == 0) ? v : acc[i] + v;
    }
    if (a + 1 < n_terms) load_tables(a + 1);
    __syncthreads();
  }

  for (int i = tid; i < nz * ty * tx; i += nthr) {
    const int ix = i % tx, r = i / tx, iy = r % ty, iz = r / ty;
    const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
    if (gx >= npts || gy >= npts || gz >= npts) continue;
    y[gz * plane + (long long)gy * npts + gx] = Conv<S, C>::store(acc[i]);
  }
}

}  // namespace tpufem
