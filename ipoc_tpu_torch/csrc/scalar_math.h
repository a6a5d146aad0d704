// Scalar math for the generated stage programs (ops/codegen/scalarize.py).
//
// The same generated text compiles under nvcc (host and device) and under a
// plain host C++ compiler (the CPU tests compile it with g++ and call it
// through ctypes), so this header needs nothing from CUDA.  Each function
// has a float and a double overload; the semantics follow torch's CPU and
// CUDA kernels: remainder takes the sign of the divisor, and max/min
// propagate NaN (like torch.maximum and jnp.maximum).

#pragma once

#include <math.h>

#ifdef __CUDACC__
#define IPOC_HD __host__ __device__ __forceinline__
#else
#define IPOC_HD inline
#endif

#define IPOC_UNARY(name, f32, f64)                         \
  IPOC_HD float ipoc_##name(float a) { return f32(a); }    \
  IPOC_HD double ipoc_##name(double a) { return f64(a); }

IPOC_UNARY(abs, fabsf, fabs)
IPOC_UNARY(sin, sinf, sin)
IPOC_UNARY(cos, cosf, cos)
IPOC_UNARY(tan, tanf, tan)
IPOC_UNARY(exp, expf, exp)
IPOC_UNARY(log, logf, log)
IPOC_UNARY(sqrt, sqrtf, sqrt)
IPOC_UNARY(tanh, tanhf, tanh)
IPOC_UNARY(log1p, log1pf, log1p)
IPOC_UNARY(expm1, expm1f, expm1)
IPOC_UNARY(asin, asinf, asin)
IPOC_UNARY(acos, acosf, acos)
IPOC_UNARY(atan, atanf, atan)
IPOC_UNARY(sinh, sinhf, sinh)
IPOC_UNARY(cosh, coshf, cosh)

#undef IPOC_UNARY

template <typename T>
IPOC_HD T ipoc_rsqrt(T a) { return T(1) / ipoc_sqrt(a); }

template <typename T>
IPOC_HD T ipoc_reciprocal(T a) { return T(1) / a; }

template <typename T>
IPOC_HD T ipoc_sigmoid(T a) { return T(1) / (T(1) + ipoc_exp(-a)); }

IPOC_HD float ipoc_pow(float a, float b) { return powf(a, b); }
IPOC_HD double ipoc_pow(double a, double b) { return pow(a, b); }
IPOC_HD float ipoc_atan2(float a, float b) { return atan2f(a, b); }
IPOC_HD double ipoc_atan2(double a, double b) { return atan2(a, b); }
IPOC_HD float ipoc_fmod(float a, float b) { return fmodf(a, b); }
IPOC_HD double ipoc_fmod(double a, double b) { return fmod(a, b); }

// torch.remainder / jnp.remainder: the result takes the sign of the divisor.
template <typename T>
IPOC_HD T ipoc_rem(T a, T b) {
  T m = ipoc_fmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = m + b;
  return m;
}

// NaN-propagating maximum and minimum (a NaN operand wins).
template <typename T>
IPOC_HD T ipoc_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

template <typename T>
IPOC_HD T ipoc_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// isfinite without <cmath>'s overload sets, so one spelling serves nvcc's
// host and device passes and g++ (a - a is NaN for an inf or a NaN).
template <typename T>
IPOC_HD bool ipoc_isfinite(T a) {
  const T d = a - a;
  return d == d;
}
