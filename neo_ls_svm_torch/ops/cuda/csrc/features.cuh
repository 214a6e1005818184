// The feature build of K1 and K2 (features.cu), written once per element into a device
// workspace: in f32 already split into TF32 planes (hi and lo for the 3×TF32 products, hi
// alone for K2's one-pass products), in f64 as one plane for the FP64 tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace neo {

enum class FeatureLayout {
  // K1: sYᵀ, feature-major, out[plane][f][r], f over [cos U | sin U | 1 | y]/√D (the 1 and
  // y unscaled), every row scaled by s = √s², so that G = (sY)ᵀ(sY).
  kGramT,
  // K2: W, row-major, out[plane][r][f], f over [cos U/√D, 1, sin U/√D, 0].
  kSweepW,
};

// Builds rows r0 .. r0+rows_pad-1 of the chunk (zero past n) at leading dimension ld, and
// every padding column up to F, into out (hi plane) and, for planes == 2, out + plane (lo
// plane). rows_pad is a multiple of 32.
cudaError_t launch_features(FeatureLayout layout, const float* X, const float* Mmap,
                            const float* bmap, const float* s2, const float* y, float* out,
                            int64_t plane, int planes, int ld, int64_t r0, int64_t n,
                            int rows_pad, int d, int D, int F, float inv_sqrt_d,
                            cudaStream_t stream);

// The same in f64, one plane: rows_pad is a multiple of 32.
cudaError_t launch_features(FeatureLayout layout, const double* X, const double* Mmap,
                            const double* bmap, const double* s2, const double* y, double* out,
                            int ld, int64_t r0, int64_t n, int rows_pad, int d, int D, int F,
                            double inv_sqrt_d, cudaStream_t stream);

// out[plane][c][r] = split(in[r][c]) for the rows × cols row-major matrix in, zero up to
// cols_pad × rows_pad (both multiples of 32), in `planes` TF32 planes: the B operand of a
// product against in.
cudaError_t launch_split_transpose(const float* in, int rows, int cols, float* out,
                                   int rows_pad, int cols_pad, int planes, cudaStream_t stream);

// out[c][r] = in[r][c] in f64, zero up to cols_pad × rows_pad (any sizes): the K-major B
// operand of an f64 product against in.
cudaError_t launch_transpose(const double* in, int rows, int cols, double* out, int rows_pad,
                             int cols_pad, cudaStream_t stream);

}  // namespace neo
