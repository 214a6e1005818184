// Helpers shared by the port's kernels: precise sincos, and the TF32 planes of the float32
// kernels' products (hi and lo for 3×TF32, hi alone for one pass).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace neo {

constexpr int kThreads = 256;

// Precise (no fast-math) sincos: the feature phases U reach tens of radians, where the
// fast intrinsics lose digits.
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }

// v as a TF32 value rounded to nearest (ties away), low 13 bits zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Stores v in its PLANES TF32 planes, `plane` floats apart: hi = tf32(v) at out, and for
// two planes (the 3×TF32 products) lo = tf32(v − hi) at out + plane (v − hi is exact in
// f32). One-pass products read hi alone.
template <int PLANES>
__device__ __forceinline__ void store_split(float* out, int64_t plane, float v) {
  static_assert(PLANES == 1 || PLANES == 2, "hi, or hi and lo");
  const float h = tf32_rna(v);
  out[0] = h;
  if constexpr (PLANES == 2) out[plane] = tf32_rna(v - h);
}

}  // namespace neo

extern "C" const char* neo_error_string(int status);
