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
// Schedule of one thread block, one output tile (TZ, TY, TX):
//   load   u tile + P-wide halo -> smem (out-of-range = 0)
//   z      s = Bz(u; Mz), t = Bz(u; Kz)                  (3D only)
//   y      q1 = By(s; My), q23 = By(s; Ky) + By(t; My)   (2D: q2 = By(u; Ky))
//   x      out = Bx(q1; Kx) + Bx(q23; Mx)
//   store
// the schedule of pallas_separable.py:33-34, with the x stage a band as
// well (the TPU's dense K-stacked MXU matmul has no reason to exist here).
// Every intermediate stays in shared memory; each output is written by one
// thread with a fixed summation order, so results are bitwise reproducible.
//
// What bounds it on an H100: at P = 4 the operator needs ~2 x 4 bytes of
// device memory traffic per DoF in f32, 0.0051 ms for 2.1M DoFs at 3.35
// TB/s, while the three band stages cost ~60 shared-memory reads per
// output.  The tiling keeps the whole stencil chain on chip (one read of u
// plus halo, one write of y) and uses TX = 32 so a warp reads and writes
// contiguous rows.  This first version is far from the memory bound (0.1297
// ms per 2.1M-DoF f32 apply on an H100 80GB HBM3 at 700 W; PERF.md): the
// halo re-read (a (T+2P)/T factor per axis), the shared-memory traffic and
// the occupancy of 80 KB blocks are what a later design has to cut (K1
// runs the all-band ring of band_ring.cuh, which cuts all three).
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

}  // namespace tpufem
