// Sum-of-tensor-products apply on a 2D (npts, npts) grid: the device code.
//
// Replaces the Pallas kernel K3 of tpufem/ops/pallas_separable.py,
// ``_kernel_resident_2d`` (ResidentTerms2D, with its _xblocks
// block-tridiagonal x stage).  (K4, the 3D terms apply, runs on the TMA ring
// of resident_ring.cuh.)  It applies
//   y = sum_a  X_{a,1} (x) X_{a,0}  u,      a = 0..T-1
// with each 1D operator X_{a,b} (b = 0 is x, the fastest axis) given as an
// EXACT per-row band table W[g, o] = X[g, g + o - P] plus the f64 row sum
// in the last column (common.cuh, ``band``).  The table array is
// (T, 2, npts, 2P+2), row-major.  T is a runtime argument: 2 terms for the
// uniform Laplace, weighted terms for a 2D shell, 2R for a CP-expanded
// coefficient.
//
// Schedule of one thread block, one output tile (TY, TX):
//   load    the u tile with its P-wide halo (out-of-range = 0), once, and
//           term 0's table rows for the tile, into shared memory
//   term a  y   q = By(u; X_{a,1})           (TY, LX)
//           x   acc += Bx(q; X_{a,0})        (TY, TX)
//               beside it, load term a+1's table rows (two table slots)
//   store   acc
// Terms run in a fixed order and each output is summed by one thread, so
// results are bitwise reproducible.  The accumulator sits in shared memory
// rather than registers: the tile is a runtime choice, and one-thread
// host builds (tests/test_torch_kernel_host.py) run the same code.
// Shared memory does not grow with T: the table rows of two terms are
// resident at a time.
//
// On the TPU the x stage was, past npts ~ 600, a block-tridiagonal sweep of
// deduplicated 128-lane blocks (_xblocks), an answer to VMEM limits.  Here
// the x stage is a band like the other.
//
// What bounds it on an H100: per output and term, two band stages of 2P+1
// shared-memory taps, against ~2 x 4 bytes of device memory per DoF in f32
// for the whole apply.  Like K2 it is bound by shared-memory traffic and the
// integer index arithmetic of the strided stage loops, far from the memory
// bound; K1 and K4 run the ring of band_ring.cuh, which K3 could take too
// (ROADMAP R4).
#pragma once

#include "common.cuh"

namespace tpufem {

// Shared-memory elements (of the compute type) one block uses; exported to
// Python as tpufem_terms_smem_elems (terms_apply.cu) for the tile chooser.
//   tables: min(T, 2) slots x (TX + TY) rows x (2P+2)
//   u:      (LY, LX)
//   q:      (TY, LX)
//   acc:    (TY, TX)
__host__ __device__ inline long long terms_smem_elems(int p, int n_terms,
                                                      int ty, int tx) {
  const long long lx = tx + 2 * p, ly = ty + 2 * p, nw = 2 * p + 2;
  const long long slots = n_terms < 2 ? n_terms : 2;
  return slots * (ty + tx) * nw + ly * lx + (long long)ty * lx +
         (long long)ty * tx;
}

template <int P, typename S, typename C>
__global__ void __launch_bounds__(kThreads)
terms_apply_kernel(const S* __restrict__ u, S* __restrict__ y,
                   const C* __restrict__ tables, int n_terms, int npts,
                   int ty, int tx) {
  constexpr int NW = 2 * P + 2;  // table row: 2P+1 taps, then the row sum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lx = tx + 2 * P, ly = ty + 2 * P;
  const int x0 = blockIdx.x * tx, y0 = blockIdx.y * ty;

  // per term, the tile's table rows: x (TX), then y (TY); two slots, term a
  // in slot a % 2
  const int trows = tx + ty;
  const long long tslot = (long long)trows * NW;
  C* tab = sm;
  C* ubuf = tab + ((n_terms < 2) ? 1 : 2) * tslot;
  C* qbuf = ubuf + (long long)ly * lx;
  C* acc = qbuf + (long long)ty * lx;

  // the tile's table rows of term a into slot a % 2
  auto load_tables = [&](int a) {
    C* dst = tab + (a & 1) * tslot;
    for (int i = tid; i < trows * NW; i += nthr) {
      const int k = i / NW, o = i - k * NW;
      const int b = k < tx ? 0 : 1, g = k < tx ? x0 + k : y0 + (k - tx);
      dst[i] = (g < npts)
                   ? tables[(((long long)a * 2 + b) * npts + g) * NW + o]
                   : C(0);
    }
  };

  load_tables(0);
  // u tile with a P-wide halo; out-of-range points are 0
  for (int i = tid; i < ly * lx; i += nthr) {
    const int ix = i % lx, iy = i / lx;
    const int gx = x0 - P + ix, gy = y0 - P + iy;
    C v = C(0);
    if (gx >= 0 && gx < npts && gy >= 0 && gy < npts)
      v = Conv<S, C>::load(u[(long long)gy * npts + gx]);
    ubuf[i] = v;
  }
  __syncthreads();

  for (int a = 0; a < n_terms; ++a) {
    const C* wx = tab + (a & 1) * tslot;
    const C* wy = wx + tx * NW;
    // y stage: u (LY, LX) -> q (TY, LX)
    for (int i = tid; i < ty * lx; i += nthr) {
      const int ix = i % lx, iy = i / lx;
      qbuf[i] = band<P>(wy + iy * NW, ubuf + (long long)iy * lx + ix, lx);
    }
    __syncthreads();
    // x stage: acc (+)= Bx(q); output i is always summed by the same
    // thread.  The other slot was last read by term a-1, so term a+1's
    // tables load beside it.
    for (int i = tid; i < ty * tx; i += nthr) {
      const int ix = i % tx, iy = i / tx;
      const C v = band<P>(wx + ix * NW, qbuf + (long long)iy * lx + ix, 1);
      acc[i] = (a == 0) ? v : acc[i] + v;
    }
    if (a + 1 < n_terms) load_tables(a + 1);
    __syncthreads();
  }

  for (int i = tid; i < ty * tx; i += nthr) {
    const int ix = i % tx, iy = i / tx;
    const int gx = x0 + ix, gy = y0 + iy;
    if (gx >= npts || gy >= npts) continue;
    y[(long long)gy * npts + gx] = Conv<S, C>::store(acc[i]);
  }
}

}  // namespace tpufem
