// Helpers shared by the port's kernels: precise sincos and 4-wide shared-memory loads,
// overloaded on float and double so each kernel is written once as a template.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace neo {

constexpr int kThreads = 256;

// Precise (no fast-math) sincos: the feature phases U reach tens of radians, where the
// fast intrinsics lose digits.
__device__ __forceinline__ void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }

// Four consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

}  // namespace neo

extern "C" const char* neo_error_string(int status);
