// The feature build of K1 and K2, once per element, for Hopper (sm_90a): f32 (split into
// TF32 planes) and f64 (one plane).
//
// Part of the port of neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram and
// neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep. The Pallas kernels rebuild the
// random-Fourier features inside the product because the TPU's HBM budget demands it. On
// an H100, writing a row chunk's features once costs less than rebuilding them for each
// of the ten or so output tiles that read them, so they are built here once, into a
// workspace:
//
//     U = X·M + b (FMAs in the element type), then precise sincos (no fast math: U
//     reaches tens of radians). In f32 each value v is stored as hi = tf32_rna(v) and,
//     for the 3×TF32 products, lo = tf32_rna(v − hi); in f64 it is stored as it is, the
//     operand of the FP64 tensor cores (gemm_sm90_f64.cuh),
//
// in the layout its product reads, K-major with zero padding to whole tiles (see
// features.cuh). K2's one-pass path writes the hi plane only; U stays in f32 FMAs there
// too, where the Pallas kernel under precision=DEFAULT also rounds X·M to one MXU pass.
// What bounds it: the bytes it writes, 4 per feature and plane in f32, 8 in f64; the
// sincos and the phase FMAs cost less. A block owns 32 rows × 32 phases:
// it stages X and M tiles in shared memory, computes the phases, and writes cos and sin
// through a shared tile so that either layout is written with neighbouring threads on
// neighbouring addresses. One extra block column writes the 1, y and zero columns.
//
// The same file holds the transposes of the resolvent operands (Qs and r_all), which K2
// needs K-major (in f32 split into their TF32 planes): once per call, 1026² and 1026 × G
// values.

#include "common.cuh"
#include "features.cuh"

namespace neo {
namespace {

constexpr int kT = 32;  // rows and phases of a feature tile

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }

// v into its planes: the TF32 split of an f32 value (store_split), an f64 value as it is.
template <int PLANES>
__device__ __forceinline__ void store_value(float* out, int64_t plane, float v) {
  store_split<PLANES>(out, plane, v);
}
template <int PLANES>
__device__ __forceinline__ void store_value(double* out, int64_t, double v) {
  static_assert(PLANES == 1, "f64 is stored in one plane");
  out[0] = v;
}

template <typename T, FeatureLayout L, int PLANES>
__global__ void __launch_bounds__(kThreads)
    features_kernel(const T* __restrict__ X, const T* __restrict__ Mmap,
                    const T* __restrict__ bmap, const T* __restrict__ s2,
                    const T* __restrict__ y, T* __restrict__ out, int64_t plane, int ld,
                    int64_t r0, int64_t n, int d, int D, int F, T inv_sqrt_d) {
  __shared__ T xs[kT][kT + 1];
  __shared__ T ms[kT][kT + 1];
  __shared__ T cs[kT][kT + 1];
  __shared__ T sn[kT][kT + 1];
  __shared__ T scale[kT];  // K1: s of the row; K2: 1. Zero past n.
  __shared__ T ys[kT];

  const int tid = threadIdx.x;
  const int rt0 = blockIdx.y * kT;  // first row of the tile within the chunk
  const int64_t row0 = r0 + rt0;
  if (tid < kT) {
    const bool valid = row0 + tid < n;
    scale[tid] = valid ? (L == FeatureLayout::kGramT ? sqrt_t(s2[row0 + tid]) : T(1)) : T(0);
    ys[tid] = valid ? y[row0 + tid] : T(0);
  }

  if (blockIdx.x == gridDim.x - 1) {  // the columns that are not cos or sin
    __syncthreads();
    const int cols = F - 2 * D;
    for (int e = tid; e < cols * kT; e += kThreads) {
      if constexpr (L == FeatureLayout::kGramT) {  // f = 2D: s, 2D+1: s·y, then zeros
        const int f = 2 * D + e / kT, r = e % kT;
        const T v = f == 2 * D ? scale[r] : (f == 2 * D + 1 ? scale[r] * ys[r] : T(0));
        T* o = out + static_cast<int64_t>(f) * ld + rt0 + r;
        store_value<PLANES>(o, plane, v);
      } else {  // f = D: 1, f = 2D+1 .. F-1: zeros
        const int r = e / cols, c = e % cols;
        const int f = c == 0 ? D : 2 * D + c;
        T* o = out + static_cast<int64_t>(rt0 + r) * ld + f;
        store_value<PLANES>(o, plane, c == 0 ? scale[r] : T(0));
      }
    }
    return;
  }

  // Phases of rows i0 + 8t, t < 4, and phase column j of the tile.
  const int q0 = blockIdx.x * kT;
  const int j = tid % kT, i0 = tid / kT;
  T u[4] = {T(0), T(0), T(0), T(0)};
  for (int k0 = 0; k0 < d; k0 += kT) {
    __syncthreads();
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int a = e / kT, b = e % kT;
      xs[a][b] = (row0 + a < n && k0 + b < d) ? X[(row0 + a) * d + k0 + b] : T(0);
      ms[a][b] = (k0 + a < d && q0 + b < D) ? Mmap[static_cast<int64_t>(k0 + a) * D + q0 + b] : T(0);
    }
    __syncthreads();
    const int kmax = min(kT, d - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const T m = ms[kk][j];
#pragma unroll
      for (int t = 0; t < 4; ++t) u[t] = fma_t(xs[i0 + 8 * t][kk], m, u[t]);
    }
  }
  const T bq = q0 + j < D ? bmap[q0 + j] : T(0);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    T sv, cv;
    sincos_t(u[t] + bq, &sv, &cv);
    cs[i0 + 8 * t][j] = cv * inv_sqrt_d;
    sn[i0 + 8 * t][j] = sv * inv_sqrt_d;
  }
  __syncthreads();

#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (L == FeatureLayout::kGramT) {  // neighbouring threads on neighbouring rows
      const int r = tid % kT, q = tid / kT + 8 * t;
      if (q0 + q < D) {
        T* oc = out + static_cast<int64_t>(q0 + q) * ld + rt0 + r;
        T* os = out + static_cast<int64_t>(D + q0 + q) * ld + rt0 + r;
        store_value<PLANES>(oc, plane, scale[r] * cs[r][q]);
        store_value<PLANES>(os, plane, scale[r] * sn[r][q]);
      }
    } else {  // neighbouring threads on neighbouring columns
      const int q = tid % kT, r = tid / kT + 8 * t;
      if (q0 + q < D) {
        T* oc = out + static_cast<int64_t>(rt0 + r) * ld + q0 + q;
        T* os = oc + D + 1;
        store_value<PLANES>(oc, plane, scale[r] * cs[r][q]);
        store_value<PLANES>(os, plane, scale[r] * sn[r][q]);
      }
    }
  }
}

template <typename T, int PLANES>
__global__ void __launch_bounds__(kThreads)
    split_transpose_kernel(const T* __restrict__ in, int rows, int cols, T* __restrict__ out,
                           int rows_pad, int cols_pad) {
  __shared__ T t[kT][kT + 1];
  const int c0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int a = e / kT, b = e % kT;
    t[a][b] = (r0 + a < rows && c0 + b < cols) ? in[static_cast<int64_t>(r0 + a) * cols + c0 + b] : T(0);
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(cols_pad) * rows_pad;
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int a = e / kT, b = e % kT;  // column c0 + a, row r0 + b
    if (c0 + a < cols_pad && r0 + b < rows_pad) {
      T* o = out + static_cast<int64_t>(c0 + a) * rows_pad + r0 + b;
      store_value<PLANES>(o, plane, t[b][a]);
    }
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
    features_kernel<float, FeatureLayout::kGramT, 2><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, plane, ld, r0, n, d, D, F, inv_sqrt_d);
  } else if (planes == 2) {
    features_kernel<float, FeatureLayout::kSweepW, 2><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, plane, ld, r0, n, d, D, F, inv_sqrt_d);
  } else {
    features_kernel<float, FeatureLayout::kSweepW, 1><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, plane, ld, r0, n, d, D, F, inv_sqrt_d);
  }
  return cudaGetLastError();
}

cudaError_t launch_features(FeatureLayout layout, const double* X, const double* Mmap,
                            const double* bmap, const double* s2, const double* y, double* out,
                            int ld, int64_t r0, int64_t n, int rows_pad, int d, int D, int F,
                            double inv_sqrt_d, cudaStream_t stream) {
  const dim3 grid((D + kT - 1) / kT + 1, rows_pad / kT);
  if (layout == FeatureLayout::kGramT) {
    features_kernel<double, FeatureLayout::kGramT, 1><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, 0, ld, r0, n, d, D, F, inv_sqrt_d);
  } else {
    features_kernel<double, FeatureLayout::kSweepW, 1><<<grid, kThreads, 0, stream>>>(
        X, Mmap, bmap, s2, y, out, 0, ld, r0, n, d, D, F, inv_sqrt_d);
  }
  return cudaGetLastError();
}

cudaError_t launch_split_transpose(const float* in, int rows, int cols, float* out,
                                   int rows_pad, int cols_pad, int planes, cudaStream_t stream) {
  const dim3 grid(cols_pad / kT, rows_pad / kT);
  if (planes == 2) {
    split_transpose_kernel<float, 2><<<grid, kThreads, 0, stream>>>(in, rows, cols, out, rows_pad, cols_pad);
  } else {
    split_transpose_kernel<float, 1><<<grid, kThreads, 0, stream>>>(in, rows, cols, out, rows_pad, cols_pad);
  }
  return cudaGetLastError();
}

cudaError_t launch_transpose(const double* in, int rows, int cols, double* out, int rows_pad,
                             int cols_pad, cudaStream_t stream) {
  const dim3 grid((cols_pad + kT - 1) / kT, (rows_pad + kT - 1) / kT);
  split_transpose_kernel<double, 1><<<grid, kThreads, 0, stream>>>(in, rows, cols, out, rows_pad, cols_pad);
  return cudaGetLastError();
}

}  // namespace neo
