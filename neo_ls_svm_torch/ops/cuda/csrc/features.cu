// The feature build of K1 and K2's f32 paths, once per element, for Hopper (sm_90a).
//
// Part of the port of neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram and
// neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep. The Pallas kernels rebuild the
// random-Fourier features inside the product because the TPU's HBM budget demands it. On
// an H100, writing a row chunk's features once costs less than rebuilding them for each
// of the ten or so output tiles that read them, so they are built here once, into a
// workspace:
//
//     U = X·M + b (f32 FMAs), then precise sincosf (no fast math: U reaches tens of
//     radians), each value v stored as hi = tf32_rna(v) and, for the 3×TF32 products,
//     lo = tf32_rna(v − hi),
//
// in the layout its product reads, K-major with zero padding to whole tiles (see
// features.cuh). K2's one-pass path writes the hi plane only; U stays in f32 FMAs there
// too, where the Pallas kernel under precision=DEFAULT also rounds X·M to one MXU pass.
// What bounds it: the bytes it writes, 4 per feature and plane; the sincosf and the phase
// FMAs cost less. A block owns 32 rows × 32 phases:
// it stages X and M tiles in shared memory, computes the phases, and writes cos and sin
// through a shared tile so that either layout is written with neighbouring threads on
// neighbouring addresses. One extra block column writes the 1, y and zero columns.
//
// The same file holds the split of the resolvent operands (Qs and r_all) into their TF32
// planes, which K2 needs transposed to K-major: once per call, 1026² and 1026 × G values.

#include "common.cuh"
#include "features.cuh"

namespace neo {
namespace {

constexpr int kT = 32;  // rows and phases of a feature tile

template <FeatureLayout L, int PLANES>
__global__ void __launch_bounds__(kThreads)
    features_kernel(const float* __restrict__ X, const float* __restrict__ Mmap,
                    const float* __restrict__ bmap, const float* __restrict__ s2,
                    const float* __restrict__ y, float* __restrict__ out, int64_t plane, int ld,
                    int64_t r0, int64_t n, int d, int D, int F, float inv_sqrt_d) {
  __shared__ float xs[kT][kT + 1];
  __shared__ float ms[kT][kT + 1];
  __shared__ float cs[kT][kT + 1];
  __shared__ float sn[kT][kT + 1];
  __shared__ float scale[kT];  // K1: s of the row; K2: 1. Zero past n.
  __shared__ float ys[kT];

  const int tid = threadIdx.x;
  const int rt0 = blockIdx.y * kT;  // first row of the tile within the chunk
  const int64_t row0 = r0 + rt0;
  if (tid < kT) {
    const bool valid = row0 + tid < n;
    scale[tid] = valid ? (L == FeatureLayout::kGramT ? sqrtf(s2[row0 + tid]) : 1.0f) : 0.0f;
    ys[tid] = valid ? y[row0 + tid] : 0.0f;
  }

  if (blockIdx.x == gridDim.x - 1) {  // the columns that are not cos or sin
    __syncthreads();
    const int cols = F - 2 * D;
    for (int e = tid; e < cols * kT; e += kThreads) {
      if constexpr (L == FeatureLayout::kGramT) {  // f = 2D: s, 2D+1: s·y, then zeros
        const int f = 2 * D + e / kT, r = e % kT;
        const float v = f == 2 * D ? scale[r] : (f == 2 * D + 1 ? scale[r] * ys[r] : 0.0f);
        float* o = out + static_cast<int64_t>(f) * ld + rt0 + r;
        store_split<PLANES>(o, plane, v);
      } else {  // f = D: 1, f = 2D+1 .. F-1: zeros
        const int r = e / cols, c = e % cols;
        const int f = c == 0 ? D : 2 * D + c;
        float* o = out + static_cast<int64_t>(rt0 + r) * ld + f;
        store_split<PLANES>(o, plane, c == 0 ? scale[r] : 0.0f);
      }
    }
    return;
  }

  // Phases of rows i0 + 8t, t < 4, and phase column j of the tile.
  const int q0 = blockIdx.x * kT;
  const int j = tid % kT, i0 = tid / kT;
  float u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < d; k0 += kT) {
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int a = e / kT, b = e % kT;
      xs[a][b] = (row0 + a < n && k0 + b < d) ? X[(row0 + a) * d + k0 + b] : 0.0f;
      ms[a][b] = (k0 + a < d && q0 + b < D) ? Mmap[static_cast<int64_t>(k0 + a) * D + q0 + b] : 0.0f;
    }
    __syncthreads();
    const int kmax = min(kT, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float m = ms[kk][j];
#pragma unroll
      for (int t = 0; t < 4; ++t) u[t] = fmaf(xs[i0 + 8 * t][kk], m, u[t]);
    }
  }
  const float bq = q0 + j < D ? bmap[q0 + j] : 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float sv, cv;
    sincosf(u[t] + bq, &sv, &cv);
    cs[i0 + 8 * t][j] = cv * inv_sqrt_d;
    sn[i0 + 8 * t][j] = sv * inv_sqrt_d;
  }
  __syncthreads();

#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (L == FeatureLayout::kGramT) {  // neighbouring threads on neighbouring rows
      const int r = tid % kT, q = tid / kT + 8 * t;
      if (q0 + q < D) {
        float* oc = out + static_cast<int64_t>(q0 + q) * ld + rt0 + r;
        float* os = out + static_cast<int64_t>(D + q0 + q) * ld + rt0 + r;
        store_split<PLANES>(oc, plane, scale[r] * cs[r][q]);
        store_split<PLANES>(os, plane, scale[r] * sn[r][q]);
      }
    } else {  // neighbouring threads on neighbouring columns
      const int q = tid % kT, r = tid / kT + 8 * t;
      if (q0 + q < D) {
        float* oc = out + static_cast<int64_t>(rt0 + r) * ld + q0 + q;
        float* os = oc + D + 1;
        store_split<PLANES>(oc, plane, scale[r] * cs[r][q]);
        store_split<PLANES>(os, plane, scale[r] * sn[r][q]);
      }
    }
  }
}

template <int PLANES>
__global__ void __launch_bounds__(kThreads)
    split_transpose_kernel(const float* __restrict__ in, int rows, int cols,
                           float* __restrict__ out, int rows_pad, int cols_pad) {
  __shared__ float t[kT][kT + 1];
  const int c0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int a = e / kT, b = e % kT;
    t[a][b] = (r0 + a < rows && c0 + b < cols) ? in[static_cast<int64_t>(r0 + a) * cols + c0 + b] : 0.0f;
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(cols_pad) * rows_pad;
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int a = e / kT, b = e % kT;  // column c0 + a, row r0 + b
    float* o = out + static_cast<int64_t>(c0 + a) * rows_pad + r0 + b;
    store_split<PLANES>(o, plane, t[b][a]);
  }
}

}  // namespace

cudaError_t launch_features(FeatureLayout layout, const float* X, const float* Mmap,
                            const float* bmap, const float* s2, const float* y, float* out,
                            int64_t plane, int planes, int ld, int64_t r0, int64_t n,
                            int rows_pad, int d, int D, int F, float inv_sqrt_d,
                            cudaStream_t stream) {
  const dim3 grid((D + kT - 1) / kT + 1, rows_pad / kT);
  if (layout == FeatureLayout::kGramT) {  // K1 has the 3×TF32 path only
    if (planes != 2) return cudaErrorInvalidValue;
    features_kernel<FeatureLayout::kGramT, 2><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, plane, ld, r0, n, d, D, F, inv_sqrt_d);
  } else if (planes == 2) {
    features_kernel<FeatureLayout::kSweepW, 2><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, plane, ld, r0, n, d, D, F, inv_sqrt_d);
  } else {
    features_kernel<FeatureLayout::kSweepW, 1><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, plane, ld, r0, n, d, D, F, inv_sqrt_d);
  }
  return cudaGetLastError();
}

cudaError_t launch_split_transpose(const float* in, int rows, int cols, float* out,
                                   int rows_pad, int cols_pad, int planes, cudaStream_t stream) {
  const dim3 grid(cols_pad / kT, rows_pad / kT);
  if (planes == 2) {
    split_transpose_kernel<2><<<grid, kThreads, 0, stream>>>(in, rows, cols, out, rows_pad, cols_pad);
  } else {
    split_transpose_kernel<1><<<grid, kThreads, 0, stream>>>(in, rows, cols, out, rows_pad, cols_pad);
  }
  return cudaGetLastError();
}

}  // namespace neo
