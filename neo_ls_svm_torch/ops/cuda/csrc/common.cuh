// Helpers shared by the port's kernels: precise sincos and 4-wide shared-memory loads for
// the float64 kernels, and the TF32 hi/lo split of the float32 kernels' 3×TF32 products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace neo {

constexpr int kThreads = 256;

// Precise (no fast-math) sincos: the feature phases U reach tens of radians, where the
// fast intrinsics lose digits.
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }

// Four consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// v as a TF32 value rounded to nearest (ties away), low 13 bits zero.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Stores v split as hi = tf32(v), lo = tf32(v − hi) (v − hi is exact in f32).
__device__ __forceinline__ void store_split(float* hi, float* lo, float v) {
  const float h = tf32_rna(v);
  *hi = h;
  *lo = tf32_rna(v - h);
}

}  // namespace neo

extern "C" const char* neo_error_string(int status);
