// K2 in float64: fused leave-one-out γ-sweep on the CUDA cores, for Hopper (sm_90a).
// (The float32 path is sweep.cu, on the tensor cores; this one exists to check parity
// with the plain version.)
//
// Replaces, in float64, the TPU kernel neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep
// (kernel body _sweep_kernel). For every row i and every γ_g of the grid it evaluates
//
//     W_i  = [cos U_i/√D, 1, sin U_i/√D, 0],   U_i = x_i·M + b,   Gu_i = W_i·Qs
//     num  = (1/c₀)·Σ_j Gu_ij·k_j·r_jg,        lev = (1/c₀)·s²_i·Σ_j Gu_ij²·r_jg
//     e_ig = (num − y_i)/(1 − lev), zeroed where a classifier is confidently right,
//
// and returns err_g = Σ_i s_i·|e_ig| and the objective: err_g, plus for a classifier
// Σ_i s_i·[|e_ig| ≥ 1] + Σ_i s_i·max(0, |e_ig| − 1).
//
// What bounds it on this card: operations, in IEEE FP64 FMAs on the CUDA cores. With
// 2M = 2D+2 basis columns and G values of γ it does 2·n·(2M)² FLOP for Gu and 4·n·2M·G
// for num and lev: 6.61 TFLOP at n = 1,048,576, 2M = 1026, G = 1024.
//
// What the design does about it:
//  * A block owns a group of R rows (8, fewer when 2M is too wide for shared memory)
//    and keeps the group's Gu∘k and Gu∘Gu in shared memory, 2·R·2M values
//    (131 KB at the slice's size): the eigenbasis projection is computed once per row and
//    never reaches device memory. The feature block W is built in the same buffer first.
//    The buffers are column-major ([column][row]), so the R rows of one column are
//    adjacent and a thread reads its rows of a column with 16-byte loads.
//  * Both products of the group (W·Qs, then [Gu∘k | Gu∘Gu]·r_all) are skinny products of
//    R rows by a wide matrix that stays in the 50 MB L2 (Qs and r_all are 8.4 MB each),
//    so the L2 traffic per row is (|Qs| + |r_all|)/R: R is as large as shared
//    memory allows. They are register-tiled: a thread holds all R rows × 4 columns of
//    each output, so one 16-byte load of the wide matrix (read once per block) and R/4
//    16-byte shared loads per operand (broadcast across the warp) feed 4·R FMAs per
//    operand. The wide matrix is read 4 steps ahead of its use, to cover L2 latency.
//    (Of the layouts timed on an H100 — rows split in 2 or 4 between threads, 2 or 4
//    columns a thread, 8 or 16 rows a block — this one was the fastest.)
//  * The residuals and their weighted sums are formed in registers right after the
//    sweep product; a thread adds its terms into the block's partial sums for its 4
//    values of γ. Each partial sum belongs to one thread, so there are no atomics.
//  * Persistent blocks stride over the row groups, so the partials are blocks × G; a
//    second kernel adds them in block order (the same result on every run, so the
//    argmin over a flat objective cannot flip).
//  * Rows past n, columns past 2M and γ past G are masked; Qs and r_all arrive padded to
//    a leading dimension that is a multiple of 4.

#include "common.cuh"

namespace {

using neo::kThreads;

constexpr int kCols = 4;                    // output columns per thread
constexpr int kPass = kThreads * kCols;     // output columns per pass of the block
constexpr int kAhead = 4;                   // steps the wide matrix is read ahead

template <typename T>
__host__ __device__ inline int64_t sweep_smem_bytes(int D, int rows) {
  return (2 * static_cast<int64_t>(rows) * (2 * D + 2) + 3 * rows) * sizeof(T);
}

// R consecutive values from shared memory (16-byte loads when R is a multiple of 4).
template <typename T, int R>
__device__ __forceinline__ void load_rows(const T* p, T v[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) neo::load4(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

__device__ __forceinline__ void load4_global(const double* p, double v[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// acc[a][r][j] += Σ_k A_a[k][r] · B[k][c0 + j] for NA column-major [K][R] shared
// operands A_a and the wide matrix B (leading dimension ldb).
template <typename T, int R, int NA>
__device__ __forceinline__ void skinny_product(const T* const (&A)[NA],
                                               const T* __restrict__ B, int ldb, int K,
                                               int c0, T (&acc)[NA][R][kCols]) {
  const T* b_ptr = B + c0;
  T b_next[kAhead][kCols];
#pragma unroll
  for (int s = 0; s < kAhead; ++s)
    if (s < K) load4_global(b_ptr + static_cast<int64_t>(s) * ldb, b_next[s]);
  for (int k0 = 0; k0 < K; k0 += kAhead) {
    T b_cur[kAhead][kCols];
#pragma unroll
    for (int s = 0; s < kAhead; ++s)
#pragma unroll
      for (int j = 0; j < kCols; ++j) b_cur[s][j] = b_next[s][j];
#pragma unroll
    for (int s = 0; s < kAhead; ++s)
      if (k0 + kAhead + s < K)
        load4_global(b_ptr + static_cast<int64_t>(k0 + kAhead + s) * ldb, b_next[s]);
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (k0 + s < K) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          T av[R];
          load_rows<T, R>(A[a] + (k0 + s) * R, av);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[a][r][j] = fma(av[r], b_cur[s][j], acc[a][r][j]);
        }
      }
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    sweep_partial_kernel(const T* __restrict__ X, const T* __restrict__ Mmap,
                         const T* __restrict__ bmap, const T* __restrict__ y,
                         const T* __restrict__ s, const T* __restrict__ s2,
                         const T* __restrict__ Qs, int ldq, const T* __restrict__ r_all,
                         int ldr, const T* __restrict__ k, T* __restrict__ part_err,
                         T* __restrict__ part_obj, int64_t n, int d, int D, int G,
                         int is_classifier, T inv_sqrt_d, T inv_c0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M2 = 2 * D + 2;
  T* bufA = reinterpret_cast<T*>(smem_raw);  // [M2][R]: Gu, then Gu∘k
  T* bufB = bufA + R * M2;                   // [M2][R]: W, then Gu∘Gu
  T* ys = bufB + R * M2;
  T* ss = ys + R;
  T* s2s = ss + R;

  const int tid = threadIdx.x;
  T* my_err = part_err + static_cast<int64_t>(blockIdx.x) * G;
  T* my_obj = part_obj + static_cast<int64_t>(blockIdx.x) * G;
  for (int g0 = kCols * tid; g0 < G; g0 += kPass)  // the same thread owns these γ below
    for (int j = 0; j < kCols && g0 + j < G; ++j) {
      my_err[g0 + j] = T(0);
      my_obj[g0 + j] = T(0);
    }

  const int64_t groups = (n + R - 1) / R;
  for (int64_t grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int64_t r0 = grp * R;
    const int rows = static_cast<int>(min(static_cast<int64_t>(R), n - r0));
    __syncthreads();  // the previous group's readers of the buffers are done
    if (tid < R) {
      ys[tid] = tid < rows ? y[r0 + tid] : T(0);
      ss[tid] = tid < rows ? s[r0 + tid] : T(0);
      s2s[tid] = tid < rows ? s2[r0 + tid] : T(0);
    }
    // Feature block W = [cos U/√D, 1, sin U/√D, 0] into bufB, zero in rows past n.
    for (int e = tid; e < R * D; e += kThreads) {
      const int r = e % R, q = e / R;
      T c = T(0), sn = T(0);
      if (r < rows) {
        const T* xr = X + (r0 + r) * d;
        T u = T(0);
        for (int kk = 0; kk < d; ++kk) u = fma(xr[kk], Mmap[static_cast<int64_t>(kk) * D + q], u);
        neo::sincos_t(u + bmap[q], &sn, &c);
        c *= inv_sqrt_d;
        sn *= inv_sqrt_d;
      }
      bufB[q * R + r] = c;
      bufB[(D + 1 + q) * R + r] = sn;
    }
    if (tid < R) {
      bufB[D * R + tid] = tid < rows ? T(1) : T(0);
      bufB[(2 * D + 1) * R + tid] = T(0);
    }
    __syncthreads();
    // Gu = W·Qs into bufA.
    {
      const T* A[1] = {bufB};
      for (int c0 = kCols * tid; c0 < M2; c0 += kPass) {
        T acc[1][R][kCols];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[0][r][j] = T(0);
        skinny_product<T, R, 1>(A, Qs, ldq, M2, c0, acc);
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (c0 + j < M2)
#pragma unroll
            for (int r = 0; r < R; ++r) bufA[(c0 + j) * R + r] = acc[0][r][j];
      }
    }
    __syncthreads();
    // Gu∘k into bufA and Gu∘Gu into bufB (W is no longer needed).
    for (int e = tid; e < R * M2; e += kThreads) {
      const T gu = bufA[e];
      bufA[e] = gu * k[e / R];
      bufB[e] = gu * gu;
    }
    __syncthreads();
    // The sweep: num and lev of the group's rows for 4 values of γ, then the sums.
    {
      const T* A[2] = {bufA, bufB};
      for (int g0 = kCols * tid; g0 < G; g0 += kPass) {
        T acc[2][R][kCols];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[a][r][j] = T(0);
        skinny_product<T, R, 2>(A, r_all, ldr, M2, g0, acc);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (g0 + j < G) {
            T err = T(0), extra = T(0);
#pragma unroll
            for (int row = 0; row < R; ++row) {
              if (row < rows) {
                const T num = inv_c0 * acc[0][row][j];
                const T lev = inv_c0 * s2s[row] * acc[1][row][j];
                T e = (num - ys[row]) / (T(1) - lev);
                if (is_classifier && ((ys[row] > T(0) && e > T(0)) || (ys[row] < T(0) && e < T(0))))
                  e = T(0);
                const T ae = fabs(e);
                err = fma(ss[row], ae, err);
                if (is_classifier) {
                  extra += ss[row] * (ae >= T(1) ? T(1) : T(0));
                  extra += ss[row] * fmax(T(0), ae - T(1));
                }
              }
            }
            my_err[g0 + j] += err;
            my_obj[g0 + j] += err + extra;
          }
        }
      }
    }
  }
}

// Adds the partials in block order: the result is the same on every run.
template <typename T>
__global__ void sweep_reduce_kernel(const T* __restrict__ part_err,
                                    const T* __restrict__ part_obj, T* __restrict__ err,
                                    T* __restrict__ obj, int G, int blocks) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  T e = T(0), o = T(0);
  for (int b = 0; b < blocks; ++b) {
    e += part_err[static_cast<int64_t>(b) * G + g];
    o += part_obj[static_cast<int64_t>(b) * G + g];
  }
  err[g] = e;
  obj[g] = o;
}

template <typename T, int R>
int launch_sweep_rows(const T* X, const T* Mmap, const T* bmap, const T* y, const T* s,
                      const T* s2, const T* Qs, int ldq, const T* r_all, int ldr, const T* k,
                      T* err, T* obj, T* partials, int64_t n, int d, int D, int G, int blocks,
                      int is_classifier, T inv_sqrt_d, T inv_c0, cudaStream_t stream) {
  const int64_t smem = sweep_smem_bytes<T>(D, R);
  cudaError_t status = cudaFuncSetAttribute(
      sweep_partial_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (status != cudaSuccess) return status;
  T* part_err = partials;
  T* part_obj = partials + static_cast<int64_t>(blocks) * G;
  sweep_partial_kernel<T, R><<<blocks, kThreads, smem, stream>>>(
      X, Mmap, bmap, y, s, s2, Qs, ldq, r_all, ldr, k, part_err, part_obj, n, d, D, G,
      is_classifier, inv_sqrt_d, inv_c0);
  status = cudaGetLastError();
  if (status != cudaSuccess) return status;
  sweep_reduce_kernel<T><<<(G + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_err, part_obj, err, obj, G, blocks);
  return cudaGetLastError();
}

template <typename T>
int launch_sweep(const T* X, const T* Mmap, const T* bmap, const T* y, const T* s,
                 const T* s2, const T* Qs, int ldq, const T* r_all, int ldr, const T* k, T* err,
                 T* obj, T* partials, int64_t n, int d, int D, int G, int rows, int blocks,
                 int is_classifier, T inv_sqrt_d, T inv_c0, cudaStream_t stream) {
#define NEO_SWEEP_CASE(R)                                                                 \
  case R:                                                                                 \
    return launch_sweep_rows<T, R>(X, Mmap, bmap, y, s, s2, Qs, ldq, r_all, ldr, k, err, \
                                   obj, partials, n, d, D, G, blocks, is_classifier,    \
                                   inv_sqrt_d, inv_c0, stream);
  switch (rows) {
    NEO_SWEEP_CASE(8)
    NEO_SWEEP_CASE(4)
    NEO_SWEEP_CASE(2)
    default:
      return cudaErrorInvalidValue;
  }
#undef NEO_SWEEP_CASE
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for `rows` rows per group.
int64_t neo_sweep_f64_smem_bytes(int D, int rows) { return sweep_smem_bytes<double>(D, rows); }

// Partial sums the kernel needs: 2 (err, obj) × blocks × G.
int64_t neo_sweep_f64_partials(int G, int blocks) { return 2 * static_cast<int64_t>(blocks) * G; }

int neo_sweep_f64(const void* X, const void* Mmap, const void* bmap, const void* y,
                  const void* s, const void* s2, const void* Qs, int ldq, const void* r_all,
                  int ldr, const void* k, void* err, void* obj, void* partials, int64_t n,
                  int d, int D, int G, int rows, int blocks, int is_classifier,
                  double inv_sqrt_d, double inv_c0, void* stream) {
  using T = double;
  return launch_sweep<T>(static_cast<const T*>(X), static_cast<const T*>(Mmap),
                         static_cast<const T*>(bmap), static_cast<const T*>(y),
                         static_cast<const T*>(s), static_cast<const T*>(s2),
                         static_cast<const T*>(Qs), ldq, static_cast<const T*>(r_all), ldr,
                         static_cast<const T*>(k), static_cast<T*>(err), static_cast<T*>(obj),
                         static_cast<T*>(partials), n, d, D, G, rows, blocks, is_classifier,
                         inv_sqrt_d, inv_c0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
