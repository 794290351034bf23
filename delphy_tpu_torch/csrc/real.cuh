// The kernels' float type.  Every kernel is a template on `real` (double or
// float): the float64 build is the C entry without a suffix, the float32
// build the same source instantiated with float, behind an entry with the
// suffix _f32.  The overloads below pick the full-precision library function
// of each type (log or logf, expm1 or expm1f, ...): no fast-math intrinsic.
// A floating literal in a kernel is written real(x), so that the float32
// build computes in float32 throughout, as the TPU kernels and their JAX
// twins do in the JAX package's production configuration.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace delphy_real {

__device__ __forceinline__ double r_log(double x) { return log(x); }
__device__ __forceinline__ float r_log(float x) { return logf(x); }
__device__ __forceinline__ double r_exp(double x) { return exp(x); }
__device__ __forceinline__ float r_exp(float x) { return expf(x); }
__device__ __forceinline__ double r_expm1(double x) { return expm1(x); }
__device__ __forceinline__ float r_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double r_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float r_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double r_floor(double x) { return floor(x); }
__device__ __forceinline__ float r_floor(float x) { return floorf(x); }
__device__ __forceinline__ double r_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float r_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double r_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float r_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double r_abs(double x) { return fabs(x); }
__device__ __forceinline__ float r_abs(float x) { return fabsf(x); }
__device__ __forceinline__ bool r_isfinite(double x) { return isfinite(x); }
__device__ __forceinline__ bool r_isfinite(float x) { return isfinite(x); }

// +infinity of the type
template <class real>
__host__ __device__ __forceinline__ constexpr real r_inf() {
  return (real)INFINITY;
}

}  // namespace delphy_real
