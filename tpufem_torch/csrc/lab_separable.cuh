// The K2 kernel lab's x-first half (L2a) on Hopper: one routine for the
// schedules that contract x first, then y, then z.  Device code; the host
// launcher with its plain C interface is lab_separable.cu.
//
// Replaces the Pallas lab kernels of scripts/kernel_lab.py (LabKernel,
// call at :1592):
//   v2, v6  _kernel_v2 (:47), _kernel_v6 (:106)   dense x, y, z
//   v8      _kernel_v8 (:132)   the same with the y/z intermediates staged
//                               transposed (the slice is the B operand)
//   v9      _kernel_v9 (:212)   v2 with every product in bf16x3
//   v3      _kernel_v3 (:78)    band x, dense y and z
//   v12     _kernel_v12 (:237)  dense x, band y and z
//   vx      _kernel_vx (:164)   the x stage alone (cut after x)
//   vxy     _kernel_vxy (:177)  x and y (cut after y)
// v6 computes v2's function with v2's stages; on the TPU the two differ
// only in how Mosaic lays the contractions onto (8, 128) tiles, which has
// no counterpart here, so v6 runs v2's kernel.
//
// The operator is K2's, A = Kz(x)My(x)Mx + Mz(x)Ky(x)Mx + Mz(x)My(x)Kx.
// Layout in: (size, size, X), size = nt b + 2P, data at [P:P+npts,
// P:P+npts, 0:npts], zeros elsewhere; X = npts rounded up to 16.  Layout
// out: (nt b, nt b, X), data at [0:npts, 0:npts, 0:npts]; each block
// writes its whole (b, b, kL2XC) box, the zeros around the data included.
// vx writes ((Mx+Kx)_x u) shifted by P rows in z and y, vxy ((My+Ky)(x)Mx
// + My(x)Kx) u shifted by P rows in z: what the Pallas ablations compute.
//
// One block per output box (b, b, kL2XC) of tile (iz, iy) and x chunk:
//   x   ax, gx = u Mx^T, u Kx^T over the tile's halo'd (L, L) rows, L = b +
//       2P, in passes of kL2ZC z rows.  Dense: a warp job is 16 (z, y) rows
//       by one MMA N of columns; it stages u 16 x 16 at a time from device
//       memory into shared memory in the operand format (bf16: hi/lo) and
//       reads [Mx^T | Kx^T] from device memory (L2-resident).  Band (v3):
//       K2's difference form on CUDA cores.
//   y   t1 = My ax, t2 = Ky ax + My gx per z row.  Dense: the tile's slice
//       (b, L) of My/Ky (a host table, rows and columns zero-padded to MB =
//       b rounded up to 16 and LP = L rounded up to 16) times ax.  Band
//       (v12): K2's difference form.
//   z   out = Kz t1 + Mz t2 over all L rows of t, after the last pass.
// The TPU kernel kept the whole halo'd slab (L, L, X), 1.1 MB at b = 24, P
// = 4, in VMEM; a block has 227 KB, so a block owns kL2XC x columns of its
// tile's output and reads the tile's L^2 rows over all of X for them: a
// read amplification of X / kL2XC over the slab, from L2.  l2_smem is the
// one count of a block's shared memory (the tile chooser in
// tpufem_torch/lab/separable_lab.py calls it through the library).
//
// Precision (lab_mma.cuh): every dense stage in XP (3xTF32, 1xTF32, bf16x3,
// f64 DMMA, or one bf16 product), f32 (f64) sums; band stages in C.  A
// dense stage has no row-sum slot, so it cannot take the difference form
// of the band stages (common.cuh): on a smooth input its error exceeds K2's.
//
// What bounds it on an H100: the function is K2's, each DoF read and
// written once, 0.0405 ms at 16,974,593 DoFs in f32.  The design adds the
// dense products over padded rows: at the flagship (b = 24, nt = 11, X =
// 272, L = LP = 32, MB = 32) the x stage is 2 nt^2 L LP X X 2 = 36.7 GFLOP
// a pass, y 3 nt^2 L MB LP X 2 = 6.4, z 2 nt^2 MB LP MB X 2 = 4.3 (with the
// padding), so 3xTF32 needs at least 0.29 ms of tensor-core time: 7x the
// function's bound before any traffic.  This first version is WMMA (not
// wgmma) with every operand re-read from L2 or shared memory per job.
#pragma once

#include "common.cuh"
#include "lab_mma.cuh"

namespace tpufem {

constexpr int kL2Threads = 256;
constexpr int kL2XC = 16;  // x columns of a block's output box
constexpr int kL2ZC = 8;   // halo'd z rows per x/y pass
constexpr int kL2Job = 16;  // rows of one warp job; its u staging is 16 x 16

// flags: the stage kinds of a variant; (flags >> 3) & 3 cuts the schedule
// after x (1: vx) or after y (2: vxy)
enum L2Flags { kL2XBand = 1, kL2YZBand = 2, kL2Trans = 4 };

struct L2Geo {
  int npts, b, nt, size, X, L, LP, MB;
};

__host__ __device__ inline int l2_round16(int v) { return (v + 15) / 16 * 16; }

// Byte offsets of a block's shared-memory regions, each 128-byte aligned:
//   ax     ax then gx, (kL2ZC, LP, kL2XC) each (v8: (kL2ZC, kL2XC, LP))
//   t      t1 then t2, (LP, MB, kL2XC) each (v8: (kL2XC, MB, LP))
//   stage  one 16 x 16 u tile per warp, in the operand format
//   scr    one accumulator tile per warp
struct L2Smem {
  long long ax, t, stage, scr, total;
};

__host__ __device__ inline L2Smem l2_smem(int p, int xp, int b) {
  const long long c = xp == kXF64 ? 8 : 4;  // bytes per value, any format
  const long long mn = xp == kXF64 ? 8 * 8 : 16 * 16;  // accumulator tile
  const long long LP = l2_round16(b + 2 * p), MB = l2_round16(b);
  const long long nw = kL2Threads / 32;
  L2Smem s;
  s.ax = 0;
  s.t = lab_align(2 * kL2ZC * LP * kL2XC * c);
  s.stage = s.t + lab_align(2 * LP * MB * kL2XC * c);
  s.scr = s.stage + lab_align(nw * kL2Job * kL2Job * c);
  s.total = s.scr + lab_align(nw * mn * c);
  return s;
}

// Store a warp's accumulator tile through its scratch: map(r, c, v) for
// each element (warp-wide; one host thread, nlanes 1, stands for the warp).
template <typename FC, typename C, typename Map>
__device__ __forceinline__ void l2_store(const FC& acc, C* sw, int ldn,
                                         int lane, int nlanes, int rows,
                                         Map map) {
  wmma::store_matrix_sync(sw, acc, ldn, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < rows * ldn; e += nlanes) map(e / ldn, e % ldn, sw[e]);
  __syncwarp();
}

template <int P, int XP>
__global__ void __launch_bounds__(kL2Threads)
l2_kernel(const typename LabMma<XP>::C* __restrict__ u,
          typename LabMma<XP>::C* __restrict__ out,
          const typename LabMma<XP>::E* __restrict__ xk, long long xk_lo,
          const typename LabMma<XP>::E* __restrict__ sl, long long sl_lo,
          const typename LabMma<XP>::C* __restrict__ tab, L2Geo g, int flags) {
  using T = LabMma<XP>;
  using C = typename T::C;
  using E = typename T::E;
  using FC = typename LabFrag<XP>::FC;
  constexpr int NW = 2 * P + 2;  // a band table row: 2P+1 taps, row sum
  constexpr int MT = kL2Job / T::M;  // MMA row tiles per warp job
  constexpr int XC = kL2XC, ZC = kL2ZC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, nwarps = (nthr + 31) / 32, lane = tid % 32;
  const int nlanes = nthr < 32 ? nthr : 32;
  const int x0 = blockIdx.x * XC, iy = blockIdx.y, iz = blockIdx.z;
  const int b = g.b, L = g.L, LP = g.LP, MB = g.MB, X = g.X, nt = g.nt;
  const int npts = g.npts;
  const long long NT = (long long)nt * b;
  const bool xband = flags & kL2XBand, yzband = flags & kL2YZBand;
  const bool trans = flags & kL2Trans;
  const int cut = (flags >> 3) & 3;
  const L2Smem sm = l2_smem(P, XP, b);
  // operand format (bf16 hi/lo) where a dense stage reads the buffer
  const long long nax = (long long)ZC * LP * XC, ntt = (long long)LP * MB * XC;
  const long long ax_split = T::kBF16 && !yzband && cut != 1 ? nax : -1;
  const long long t_split = T::kBF16 && !yzband && cut == 0 ? ntt : -1;
  const long long cb = sizeof(C);
  unsigned char* AX = smem_raw + sm.ax;
  unsigned char* GX = AX + nax * cb;
  unsigned char* T1 = smem_raw + sm.t;
  unsigned char* T2 = T1 + ntt * cb;
  unsigned char* stage = smem_raw + sm.stage + warp * kL2Job * kL2Job * cb;
  C* sw = reinterpret_cast<C*>(smem_raw + sm.scr) + warp * T::M * T::N;
  const long long st_split = T::kBF16 ? kL2Job * kL2Job : -1;
  const C* tMx = tab;
  const C* tKx = tab + (long long)npts * NW;
  const C* tMy = tab + 2LL * npts * NW;
  const C* tKy = tab + 3LL * npts * NW;
  const C* tMz = tab + 4LL * npts * NW;
  const C* tKz = tab + 5LL * npts * NW;
  // dense slices (My, Ky, Mz, Kz) of tile t: (MB, LP), v8: (LP, MB)
  const long long sls = (long long)MB * LP;
  const E* sMy = sl + iy * sls;
  const E* sKy = sl + (nt + iy) * sls;
  const E* sMz = sl + (2LL * nt + iz) * sls;
  const E* sKz = sl + (3LL * nt + iz) * sls;
  auto ax_at = [&](int zr, int yl, int xo) -> long long {
    return trans ? ((long long)zr * XC + xo) * LP + yl
                 : ((long long)zr * LP + yl) * XC + xo;
  };
  auto t_at = [&](int zl, int by, int xo) -> long long {
    return trans ? ((long long)xo * MB + by) * LP + zl
                 : ((long long)zl * MB + by) * XC + xo;
  };
  auto out_at = [&](int bz, int by, int xo) -> long long {
    return (((long long)iz * b + bz) * NT + (long long)iy * b + by) * X + x0 +
           xo;
  };

  // rows L..LP-1 of t (read by a dense z stage) hold zeros
  if (!yzband && cut == 0)
    for (long long i = tid; i < (long long)(LP - L) * MB * XC; i += nthr) {
      const int xo = (int)(i % XC), r = (int)(i / XC), by = r % MB;
      const int zl = L + r / MB;
      lab_put<C>(T1, t_split, t_at(zl, by, xo), C(0));
      lab_put<C>(T2, t_split, t_at(zl, by, xo), C(0));
    }
  const int zend = cut ? b : L;  // the halo'd z rows the schedule needs
  for (int zc = 0; zc < zend; zc += ZC) {
    // ---- x stage: ax, gx of z rows [zc, zc + ZC) -----------------------
    if (xband) {
      for (long long i = tid; i < nax; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), yl = r % LP;
        const int zr = r / LP, zl = zc + zr, xg = x0 + xo;
        if (zl >= zend) continue;
        C am = C(0), ak = C(0);
        if (yl < L && xg < npts) {
          const C* row = u + (((long long)iz * b + zl) * g.size +
                              (long long)iy * b + yl) * X;
          C v[2 * P + 1];
#pragma unroll
          for (int o = 0; o <= 2 * P; ++o) {
            const int xi = xg + o - P;
            v[o] = xi >= 0 && xi < X ? row[xi] : C(0);
          }
          am = band<P>(tMx + (long long)xg * NW, v, 1);
          ak = band<P>(tKx + (long long)xg * NW, v, 1);
        }
        lab_put<C>(AX, ax_split, ax_at(zr, yl, xo), am);
        lab_put<C>(GX, ax_split, ax_at(zr, yl, xo), ak);
      }
    } else {
      const int nyj = LP / kL2Job, nn = XC / T::N;
      for (int job = warp; job < ZC * nyj * nn; job += nwarps) {
        const int jn = job % nn, yj = (job / nn) % nyj, zr = job / (nn * nyj);
        const int zl = zc + zr, yl0 = yj * kL2Job;
        if (zl >= zend) continue;
        FC acc[2][MT];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) wmma::fill_fragment(acc[h][mi], C(0));
        const C* rows = u + (((long long)iz * b + zl) * g.size +
                             (long long)iy * b + yl0) * X;
        for (int k0 = 0; k0 < X; k0 += kL2Job) {
          for (int e = lane; e < kL2Job * kL2Job; e += nlanes) {
            const int r = e / kL2Job, c = e % kL2Job;
            lab_put<C>(stage, st_split, e,
                       yl0 + r < L ? rows[(long long)r * X + k0 + c] : C(0));
          }
          __syncwarp();
#pragma unroll
          for (int kk = 0; kk < kL2Job; kk += T::K)
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              const E* a = reinterpret_cast<const E*>(stage) +
                           mi * T::M * kL2Job + kk;
              const E* bm = xk + (long long)(k0 + kk) * 2 * X + x0 + jn * T::N;
              lab_mma<XP>(acc[0][mi], a, st_split, kL2Job, bm, xk_lo, 2 * X);
              lab_mma<XP>(acc[1][mi], a, st_split, kL2Job, bm + X, xk_lo,
                          2 * X);
            }
          __syncwarp();
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            l2_store(acc[h][mi], sw, T::N, lane, nlanes, T::M,
                     [&](int r, int c, C v) {
                       lab_put<C>(h ? GX : AX, ax_split,
                                  ax_at(zr, yl0 + mi * T::M + r, jn * T::N + c),
                                  v);
                     });
      }
    }
    __syncthreads();
    if (cut == 1) {  // vx: (ax + gx) of the tile's first b halo'd rows
      for (long long i = tid; i < (long long)ZC * b * XC; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), yl = r % b;
        const int zr = r / b, zl = zc + zr;
        if (zl >= b) continue;
        out[out_at(zl, yl, xo)] = lab_get<C>(AX, ax_split, ax_at(zr, yl, xo)) +
                                  lab_get<C>(GX, ax_split, ax_at(zr, yl, xo));
      }
      __syncthreads();
      continue;
    }
    // ---- y stage: t1 = My ax, t2 = Ky ax + My gx, z rows [zc, zc + ZC) --
    if (yzband) {
      for (long long i = tid; i < (long long)ZC * b * XC; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), by = r % b;
        const int zr = r / b, zl = zc + zr, gy = iy * b + by;
        if (zl >= zend) continue;
        C t1 = C(0), t2 = C(0);
        if (gy < npts) {
          const C* a = reinterpret_cast<const C*>(AX) + ax_at(zr, by, xo);
          const C* gg = reinterpret_cast<const C*>(GX) + ax_at(zr, by, xo);
          t1 = band<P>(tMy + (long long)gy * NW, a, XC);
          t2 = band<P>(tKy + (long long)gy * NW, a, XC) +
               band<P>(tMy + (long long)gy * NW, gg, XC);
        }
        lab_put<C>(T1, t_split, t_at(zl, by, xo), t1);
        lab_put<C>(T2, t_split, t_at(zl, by, xo), t2);
      }
    } else {
      // v2: rows by (the slice's), columns xo; v8: rows xo, columns by
      const int nrj = (trans ? XC : MB) / kL2Job;
      const int nn = (trans ? MB : XC) / T::N;
      for (int job = warp; job < ZC * nrj * nn; job += nwarps) {
        const int jn = job % nn, rj = (job / nn) % nrj, zr = job / (nn * nrj);
        const int zl = zc + zr, r0 = rj * kL2Job, n0 = jn * T::N;
        if (zl >= zend) continue;
        FC acc[2][MT];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) wmma::fill_fragment(acc[h][mi], C(0));
        const E* eax = reinterpret_cast<const E*>(AX);
        const E* egx = reinterpret_cast<const E*>(GX);
        for (int kk = 0; kk < LP; kk += T::K)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            const int m0 = r0 + mi * T::M;
            if (trans) {  // (xo, yl) @ (yl, by)
              const long long ao = ((long long)zr * XC + m0) * LP + kk;
              const long long bo = (long long)kk * MB + n0;
              lab_mma<XP>(acc[0][mi], eax + ao, ax_split, LP, sMy + bo, sl_lo,
                          MB);
              lab_mma<XP>(acc[1][mi], eax + ao, ax_split, LP, sKy + bo, sl_lo,
                          MB);
              lab_mma<XP>(acc[1][mi], egx + ao, ax_split, LP, sMy + bo, sl_lo,
                          MB);
            } else {  // (by, yl) @ (yl, xo)
              const long long ao = (long long)m0 * LP + kk;
              const long long bo = ((long long)zr * LP + kk) * XC + n0;
              lab_mma<XP>(acc[0][mi], sMy + ao, sl_lo, LP, eax + bo, ax_split,
                          XC);
              lab_mma<XP>(acc[1][mi], sKy + ao, sl_lo, LP, eax + bo, ax_split,
                          XC);
              lab_mma<XP>(acc[1][mi], sMy + ao, sl_lo, LP, egx + bo, ax_split,
                          XC);
            }
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
            l2_store(acc[h][mi], sw, T::N, lane, nlanes, T::M,
                     [&](int r, int c, C v) {
                       const int m = r0 + mi * T::M + r, n = n0 + c;
                       lab_put<C>(h ? T2 : T1, t_split,
                                  trans ? t_at(zl, n, m) : t_at(zl, m, n), v);
                     });
      }
    }
    __syncthreads();
    if (cut == 2) {  // vxy: t1 + t2 of the tile's first b halo'd rows
      for (long long i = tid; i < (long long)ZC * b * XC; i += nthr) {
        const int xo = (int)(i % XC), r = (int)(i / XC), by = r % b;
        const int zl = zc + r / b;
        if (zl >= b) continue;
        out[out_at(zl, by, xo)] = lab_get<C>(T1, t_split, t_at(zl, by, xo)) +
                                  lab_get<C>(T2, t_split, t_at(zl, by, xo));
      }
    }
  }
  if (cut) return;
  // ---- z stage: out = Kz t1 + Mz t2 over all L rows of t -----------------
  if (yzband) {
    for (long long i = tid; i < (long long)b * b * XC; i += nthr) {
      const int xo = (int)(i % XC), r = (int)(i / XC), by = r % b;
      const int bz = r / b, gz = iz * b + bz;
      C v = C(0);
      if (gz < npts) {
        const long long o = t_at(bz, by, xo), s = (long long)MB * XC;
        v = band<P>(tKz + (long long)gz * NW,
                    reinterpret_cast<const C*>(T1) + o, s) +
            band<P>(tMz + (long long)gz * NW,
                    reinterpret_cast<const C*>(T2) + o, s);
      }
      out[out_at(bz, by, xo)] = v;
    }
    return;
  }
  // v2: rows bz, columns (by, xo); v8: rows (xo, by), columns bz
  const int nrj = (trans ? XC * MB : MB) / kL2Job;
  const int nn = (trans ? MB : MB * XC) / T::N;
  const E* et1 = reinterpret_cast<const E*>(T1);
  const E* et2 = reinterpret_cast<const E*>(T2);
  for (int job = warp; job < nrj * nn; job += nwarps) {
    const int jn = job % nn, r0 = (job / nn) * kL2Job, n0 = jn * T::N;
    FC acc[MT];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) wmma::fill_fragment(acc[mi], C(0));
    for (int kk = 0; kk < LP; kk += T::K)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int m0 = r0 + mi * T::M;
        if (trans) {  // (xo by, zl) @ (zl, bz)
          const long long ao = (long long)m0 * LP + kk;
          const long long bo = (long long)kk * MB + n0;
          lab_mma<XP>(acc[mi], et1 + ao, t_split, LP, sKz + bo, sl_lo, MB);
          lab_mma<XP>(acc[mi], et2 + ao, t_split, LP, sMz + bo, sl_lo, MB);
        } else {  // (bz, zl) @ (zl, by xo)
          const long long ao = (long long)m0 * LP + kk;
          const long long bo = (long long)kk * MB * XC + n0;
          lab_mma<XP>(acc[mi], sKz + ao, sl_lo, LP, et1 + bo, t_split,
                      MB * XC);
          lab_mma<XP>(acc[mi], sMz + ao, sl_lo, LP, et2 + bo, t_split,
                      MB * XC);
        }
      }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      l2_store(acc[mi], sw, T::N, lane, nlanes, T::M, [&](int r, int c, C v) {
        const int m = r0 + mi * T::M + r, n = n0 + c;
        const int bz = trans ? n : m;
        const int by = trans ? m % MB : n / XC, xo = trans ? m / MB : n % XC;
        if (bz < b && by < b) out[out_at(bz, by, xo)] = v;
      });
  }
}

}  // namespace tpufem
