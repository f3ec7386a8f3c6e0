// Device pieces shared by the port's band-table kernels
// (separable_apply.cuh: K2; terms_apply.cuh: K3; resident_ring.cuh: K1, K4;
// the kernel labs).
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace tpufem {

// Storage type S <-> compute type C.
template <typename S, typename C>
struct Conv;

template <>
struct Conv<double, double> {
  static __device__ __forceinline__ double load(double v) { return v; }
  static __device__ __forceinline__ double store(double v) { return v; }
};

template <>
struct Conv<float, float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Conv<__nv_bfloat16, float> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};

constexpr int kThreads = 256;

// One output of a band stage in difference form:
//   B(v)[g] = sum_o W[g,o] (v[g+o-P] - v[g]) + R[g] v[g],  R[g] = sum_o W[g,o]
// w: the row's table (2P+1 taps, then R); v: tap 0 (row g-P), center at
// v[P*stride].  Equal to sum_o W[g,o] v[g+o-P] in exact arithmetic.  R is
// summed in f64 on the host, so a stiffness row (which annihilates
// constants, R = 0) keeps K*const = 0 in an f32 kernel, where f32-rounded
// taps alone would leave ~eps*|K| per row: a systematic perturbation of
// relative size ~eps/h^2 on the smooth modes that shifts the f32 solve's
// solution.  Measured on an H100 80GB HBM3 (700 W), f32 3D Q4 refine 5
// Jacobi-CG: L2 error 5.8e-6 in 99 iterations with the plain tap sum,
// 6.2e-8 in 19 with this form.
template <int P, typename C>
__device__ __forceinline__ C band(const C* __restrict__ w, const C* v,
                                  long long stride) {
  constexpr int NB = 2 * P + 1;
  const C vc = v[P * stride];
  C acc = C(0);
#pragma unroll
  for (int o = 0; o < NB; ++o) acc += w[o] * (v[o * stride] - vc);
  return acc + w[NB] * vc;
}

}  // namespace tpufem
