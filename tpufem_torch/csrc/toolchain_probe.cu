// Host launcher of the two toolchain probes (device code and the design
// note in toolchain_probe.cuh), with a plain C interface for ctypes.  Built
// by tpufem_torch/utils/build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -ldl -o <lib>.so toolchain_probe.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "toolchain_probe.cuh"

namespace {

template <int XP>
cudaError_t matmul(int n, const void* a, const void* b, void* c,
                   cudaStream_t stream) {
  const int tiles = (n / tpufem::kPT) * (n / tpufem::kPT);
  tpufem::probe_matmul_kernel<XP>
      <<<(tiles + tpufem::kP1Warps - 1) / tpufem::kP1Warps,
         tpufem::kP1Threads, 0, stream>>>(static_cast<const float*>(a),
                                          static_cast<const float*>(b),
                                          static_cast<float*>(c), n);
  return cudaGetLastError();
}

// P1 on wgmma: the shared-memory opt-in, the two tensor maps and the
// launch, grid (ceil(n / NB), ceil(n / 64)), NB = kP1wColumns.
template <int XP>
cudaError_t matmul_wgmma(int n, const void* a, const void* b, void* c,
                         cudaStream_t stream) {
  constexpr int NB = tpufem::kP1wColumns;
  const int stages = tpufem::p1w_stages(XP, NB, n);
  const int smem = (int)tpufem::p1w_smem(XP, NB, stages).total;
  auto kern = tpufem::probe_wgmma_kernel<XP, NB>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  tpufem::HopMap am, bm;
  if (tpufem::p1w_maps(&am, &bm, a, b, n, NB)) return cudaErrorInvalidValue;
  kern<<<dim3((n + NB - 1) / NB, (n + tpufem::kHopM - 1) / tpufem::kHopM),
         tpufem::kP1wThreads, smem, stream>>>(am, bm, static_cast<float*>(c),
                                              n, stages);
  return cudaGetLastError();
}

template <int XP, int MODE>
cudaError_t chain(int m, int n_iter, int fpp, float c1, float c2,
                  const void* a, const void* w, long long w_lo, const void* v,
                  void* o, void* vo, cudaStream_t stream) {
  using E = typename tpufem::LabMma<XP>::E;
  const int smem = (int)tpufem::probe_chain_smem(m);
  auto kern = tpufem::probe_chain_kernel<XP, MODE>;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<m / tpufem::kP2Rows, tpufem::kP2Threads, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const E*>(w), w_lo,
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(vo), m, n_iter, fpp, c1, c2);
  return cudaGetLastError();
}

template <int XP>
cudaError_t chain_mode(int mode, int m, int n_iter, int fpp, float c1,
                       float c2, const void* a, const void* w, long long w_lo,
                       const void* v, void* o, void* vo, cudaStream_t s) {
  switch (mode) {
    case tpufem::kProbeMma:
      return chain<XP, tpufem::kProbeMma>(m, n_iter, fpp, c1, c2, a, w, w_lo,
                                          v, o, vo, s);
    case tpufem::kProbeFma:
      return chain<XP, tpufem::kProbeFma>(m, n_iter, fpp, c1, c2, a, w, w_lo,
                                          v, o, vo, s);
    case tpufem::kProbeBoth:
      return chain<XP, tpufem::kProbeBoth>(m, n_iter, fpp, c1, c2, a, w, w_lo,
                                           v, o, vo, s);
  }
  return cudaErrorInvalidValue;
}

// P2 on the cluster chain: one launch, or (active non-null) the clusters of
// that launch the card holds at once (cudaOccupancyMaxActiveClusters).
struct ClusterArgs {
  int m, C, nbuf, n_iter, fpp;
  float c1, c2;
  const float* a;
  const unsigned char* w;
  const float* v;
  float *o, *vo;
  cudaStream_t s;
};

template <int XP, int MODE, int NT>
cudaError_t cluster_chain(const ClusterArgs& c, int* active) {
  auto kern = tpufem::probe_cluster_kernel<XP, MODE, NT>;
  const int smem = (int)tpufem::pc_smem(XP, c.m, c.C, c.nbuf).total;
  static std::atomic<int> granted[tpufem::kLabMaxDevices];
  cudaError_t e = tpufem::lab_opt_in(kern, smem, granted);
  if (e != cudaSuccess) return e;
  if (c.C > 8) {  // 16 is beyond the portable cluster size
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.m / tpufem::kPcRows * c.C);
  cfg.blockDim = dim3(tpufem::kPcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active) return cudaOccupancyMaxActiveClusters(active, kern, &cfg);
  e = cudaLaunchKernelEx(&cfg, kern, c.a, c.w, c.v, c.o, c.vo, c.m, c.C,
                         c.nbuf, c.n_iter, c.fpp, c.c1, c.c2);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int XP, int MODE>
cudaError_t cluster_tiles(const ClusterArgs& c, int* active) {
  switch (c.m / (32 * c.C)) {
    case 1: return cluster_chain<XP, MODE, 1>(c, active);
    case 2: return cluster_chain<XP, MODE, 2>(c, active);
  }
  return cudaErrorInvalidValue;
}

template <int XP>
cudaError_t cluster_mode(int mode, const ClusterArgs& c, int* active) {
  switch (mode) {
    case tpufem::kProbeMma:
      return cluster_tiles<XP, tpufem::kProbeMma>(c, active);
    case tpufem::kProbeFma:
      return cluster_tiles<XP, tpufem::kProbeFma>(c, active);
    case tpufem::kProbeBoth:
      return cluster_tiles<XP, tpufem::kProbeBoth>(c, active);
  }
  return cudaErrorInvalidValue;
}

cudaError_t cluster_dispatch(int mode, int xp, const ClusterArgs& c,
                             int* active) {
  if (!tpufem::pc_takes(xp, c.m, c.C, c.nbuf) || c.n_iter < 1 || c.fpp < 0)
    return cudaErrorInvalidValue;
  switch (xp) {
    case tpufem::kX3TF32:
      return cluster_mode<tpufem::kX3TF32>(mode, c, active);
    case tpufem::kX1TF32:
      return cluster_mode<tpufem::kX1TF32>(mode, c, active);
    case tpufem::kXBF16x3:
      return cluster_mode<tpufem::kXBF16x3>(mode, c, active);
    case tpufem::kXBF16:
      return cluster_mode<tpufem::kXBF16>(mode, c, active);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1: c = a b, (n, n) f32 row-major, n a multiple of 16, in arithmetic xp
// (LabXPrec: 3xTF32, 1xTF32, bf16x3 or one bf16 product).  Returns the
// cudaError_t of the launch.
int tpufem_probe_matmul(int xp, int n, const void* a, const void* b, void* c,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 16 || n % 16) return (int)cudaErrorInvalidValue;
  switch (xp) {
    case tpufem::kX3TF32:
      return (int)matmul<tpufem::kX3TF32>(n, a, b, c, s);
    case tpufem::kX1TF32:
      return (int)matmul<tpufem::kX1TF32>(n, a, b, c, s);
    case tpufem::kXBF16x3:
      return (int)matmul<tpufem::kXBF16x3>(n, a, b, c, s);
    case tpufem::kXBF16:
      return (int)matmul<tpufem::kXBF16>(n, a, b, c, s);
  }
  return (int)cudaErrorInvalidValue;
}

// P1 on wgmma (probe_wgmma_kernel): c = a b as tpufem_probe_matmul does, a
// block a 64-row tile by kP1wColumns columns; a and b 16-byte aligned (the
// tensor maps' rule).  Returns the cudaError_t of the launch.
int tpufem_probe_matmul_wgmma(int xp, int n, const void* a, const void* b,
                              void* c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 16 || n % 16 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return (int)cudaErrorInvalidValue;
  switch (xp) {
    case tpufem::kX3TF32:
      return (int)matmul_wgmma<tpufem::kX3TF32>(n, a, b, c, s);
    case tpufem::kX1TF32:
      return (int)matmul_wgmma<tpufem::kX1TF32>(n, a, b, c, s);
    case tpufem::kXBF16x3:
      return (int)matmul_wgmma<tpufem::kXBF16x3>(n, a, b, c, s);
    case tpufem::kXBF16:
      return (int)matmul_wgmma<tpufem::kXBF16>(n, a, b, c, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The columns, ring stages and shared-memory bytes of a P1 wgmma block at n
// (kP1wColumns, p1w_stages, p1w_smem).
int tpufem_probe_wgmma_columns() { return tpufem::kP1wColumns; }
int tpufem_probe_wgmma_stages(int xp, int n) {
  return tpufem::p1w_stages(xp, tpufem::kP1wColumns, n);
}
long long tpufem_probe_wgmma_smem(int xp, int n) {
  return tpufem::p1w_smem(xp, tpufem::kP1wColumns,
                          tpufem::p1w_stages(xp, tpufem::kP1wColumns, n))
      .total;
}

// P2's earlier routine (probe_chain_kernel): mode (ProbeMode) mma: o = a
// w^n_iter, vo = v; fma: vo = v after fpp n_iter steps v <- v c1 + c2, o =
// a; both: both chains.  a, v, o, vo: (m,
// m) f32; w: (m, m) f32, or in the bf16 arithmetics its bf16 hi part with
// the lo part w_lo elements on; m a multiple of 16, n_iter >= 1.  Returns
// the cudaError_t of the launch.
int tpufem_probe_chain(int mode, int xp, int m, int n_iter, int fpp, float c1,
                       float c2, const void* a, const void* w, long long w_lo,
                       const void* v, void* o, void* vo, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 16 || m % 16 || n_iter < 1 || fpp < 0 ||
      tpufem::probe_chain_smem(m) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  switch (xp) {
#define TPUFEM_XP(XP)                                                        \
  case XP:                                                                   \
    return (int)chain_mode<XP>(mode, m, n_iter, fpp, c1, c2, a, w, w_lo, v, o, \
                               vo, s);
    TPUFEM_XP(tpufem::kX3TF32)
    TPUFEM_XP(tpufem::kX1TF32)
    TPUFEM_XP(tpufem::kXBF16x3)
    TPUFEM_XP(tpufem::kXBF16)
#undef TPUFEM_XP
  }
  return (int)cudaErrorInvalidValue;
}

// P2 on the cluster chain (probe_cluster_kernel): the chains of
// tpufem_probe_chain on m / 64 clusters of C blocks with nbuf stripe
// buffers, a plan tpufem_probe_cluster_smem counts within 227 KB; w: the
// blocks' column slices of w as toolchain_probe.w_operand(w, arithmetic, C)
// lays them out.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a plan the routine does not take).
int tpufem_probe_cluster_chain(int mode, int xp, int m, int C, int nbuf,
                               int n_iter, int fpp, float c1, float c2,
                               const void* a, const void* w, const void* v,
                               void* o, void* vo, void* stream) {
  const ClusterArgs c{m,
                      C,
                      nbuf,
                      n_iter,
                      fpp,
                      c1,
                      c2,
                      static_cast<const float*>(a),
                      static_cast<const unsigned char*>(w),
                      static_cast<const float*>(v),
                      static_cast<float*>(o),
                      static_cast<float*>(vo),
                      static_cast<cudaStream_t>(stream)};
  return (int)cluster_dispatch(mode, xp, c, nullptr);
}

// Shared-memory bytes of a block of the cluster chain (pc_smem), or -1 for a
// geometry it is not built for (whatever the bytes); the plan chooser in
// tpufem_torch/lab/toolchain_probe.py takes the first that fits 227 KB.
long long tpufem_probe_cluster_smem(int xp, int m, int C, int nbuf) {
  if (!tpufem::pc_geometry(xp, m, C, nbuf)) return -1;
  return tpufem::pc_smem(xp, m, C, nbuf).total;
}

// Clusters of a cluster-chain launch the current device holds at once, or
// -1 where the plan is refused or the query fails.
int tpufem_probe_cluster_active(int mode, int xp, int m, int C, int nbuf) {
  ClusterArgs c{};
  c.m = m;
  c.C = C;
  c.nbuf = nbuf;
  c.n_iter = 1;
  int n = -1;
  if (cluster_dispatch(mode, xp, c, &n) != cudaSuccess) return -1;
  return n;
}

const char* tpufem_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
