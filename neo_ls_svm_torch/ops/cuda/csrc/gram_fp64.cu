// K1 in float64: fused random-Fourier feature build + augmented Gram on the CUDA cores,
// for Hopper (sm_90a). (The float32 path is gram.cu, on the tensor cores.)
//
// Replaces, in float64, the TPU kernel neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram
// (kernel body _gram_kernel). It computes
//
//     G = Yᵀ·diag(s²)·Y,   Y = [cos U/√D | sin U/√D | 1 | y],   U = X·M + b,
//
// the (2D+2)×(2D+2) augmented Gram of the primal solver's streaming pass 1, and Y is
// never written to device memory. The float64 path exists to check parity with the
// plain version; the main path runs float32.
//
// What bounds it on this card: operations, in IEEE FP64 FMAs on the CUDA cores. At the
// 1M-row shape (n = 1,048,576, d = 32, D = 512, K = 2D+2 = 1026) the Gram's upper
// triangle is 1.10 TFLOP against about 290 MB read: far above the FP64 ridge.
//
// What the design does about it:
//  * The output is symmetric, so only the upper-triangle tiles of 128×128 are computed
//    (36 tiles at D = 512); the reduction kernel mirrors them into the lower triangle.
//  * Inside the kernel the trig columns are interleaved (internal column 2q = cos U_q,
//    2q+1 = sin U_q), so one length-d dot product and one sincos serve two columns of a
//    tile: per row, rebuilding a tile's two 128-column sides costs 128 dot products and
//    128 sincos against 128² FMAs of product. The reduction kernel writes the result in
//    the TPU kernel's [cos | sin | 1 | y] order.
//  * The 1 and y columns are not tiled: the diagonal tiles also accumulate Σ s²·Y_p and
//    Σ s²·y·Y_p for their columns, and tile (0,0) the 2×2 corner.
//  * The rows are split into ranges so that tiles × splits blocks fill the SMs. A block
//    walks its rows in chunks of 16: it stages the X chunk in shared memory, builds its
//    two 16×128 sides of Y there (one side scaled by s²), and accumulates the 128×128
//    outer products in registers, 8×8 per thread, in IEEE FMAs.
//  * Each block writes its partial tile; the second kernel adds the partials over the
//    splits in a fixed order. No float atomics, so the result is the same on every run.
//  * Rows past n, columns past 2D and the ragged last tile are masked to zero.

#include "common.cuh"

namespace {

using neo::kThreads;

constexpr int kTile = 128;         // output tile edge, in internal columns
constexpr int kPairs = kTile / 2;  // (cos, sin) pairs on each side of a tile
constexpr int kRows = 16;          // rows per staged chunk
constexpr int kXCols = 32;         // X columns staged per step

__host__ __device__ inline int num_col_tiles(int D) { return (2 * D + kTile - 1) / kTile; }

// Internal column of output column a: cos a → 2a, sin a → 2a+1, then 1 → 2D, y → 2D+1.
__device__ inline int internal_column(int a, int D) {
  if (a < D) return 2 * a;
  if (a < 2 * D) return 2 * (a - D) + 1;
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gram_partial_kernel(const T* __restrict__ X, const T* __restrict__ Mmap,
                        const T* __restrict__ bmap, const T* __restrict__ s2,
                        const T* __restrict__ y, T* __restrict__ part_tiles,
                        T* __restrict__ part_edges, T* __restrict__ part_corner, int64_t n,
                        int d, int D, int nt, int64_t rows_per_split, T inv_sqrt_d) {
  __shared__ __align__(16) T xs[kRows][kXCols];
  __shared__ __align__(16) T As[kRows][kTile];
  __shared__ __align__(16) T Bs[kRows][kTile];
  __shared__ T ys[kRows];
  __shared__ T s2s[kRows];

  const int tid = threadIdx.x;
  // This block's upper-triangle tile (ti <= tj), enumerated row by row.
  int t = blockIdx.x, ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;
  const int split = blockIdx.y;
  const int64_t row_begin = static_cast<int64_t>(split) * rows_per_split;
  const int64_t row_end = min(n, row_begin + rows_per_split);

  // Feature build: this thread owns pair `pr` of both sides, in rows rbase + 4i.
  const int pr = tid % kPairs;
  const int rbase = tid / kPairs;
  const int qA = ti * kPairs + pr;
  const int qB = tj * kPairs + pr;
  const bool vA = qA < D;
  const bool vB = qB < D;
  const T bA = vA ? bmap[qA] : T(0);
  const T bB = vB ? bmap[qB] : T(0);

  // Product: rows {4ty..4ty+3, 64+4ty..64+4ty+3} × the same pattern of columns in tx.
  const int ty = tid / 16;
  const int tx = tid % 16;
  T acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);
  T edge_one = T(0), edge_y = T(0);                 // diagonal tiles, tid < kTile
  T corner0 = T(0), corner1 = T(0), corner2 = T(0);  // tile (0,0), tid == kTile

  for (int64_t r0 = row_begin; r0 < row_end; r0 += kRows) {
    const int rows = static_cast<int>(min(static_cast<int64_t>(kRows), row_end - r0));
    T uA[4] = {T(0), T(0), T(0), T(0)};
    T uB[4] = {T(0), T(0), T(0), T(0)};
    for (int k0 = 0; k0 < d; k0 += kXCols) {
      __syncthreads();  // the previous readers of xs, As, Bs, ys and s2s are done
      for (int e = tid; e < kRows * kXCols; e += kThreads) {
        const int r = e / kXCols, kk = e % kXCols;
        xs[r][kk] = (r < rows && k0 + kk < d) ? X[(r0 + r) * d + k0 + kk] : T(0);
      }
      if (k0 == 0 && tid < kRows) {
        ys[tid] = tid < rows ? y[r0 + tid] : T(0);
        s2s[tid] = tid < rows ? s2[r0 + tid] : T(0);
      }
      __syncthreads();
      const int kmax = min(kXCols, d - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        const T mA = vA ? Mmap[static_cast<int64_t>(k0 + kk) * D + qA] : T(0);
        const T mB = vB ? Mmap[static_cast<int64_t>(k0 + kk) * D + qB] : T(0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T xv = xs[rbase + 4 * i][kk];
          uA[i] = fma(xv, mA, uA[i]);
          uB[i] = fma(xv, mB, uB[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rbase + 4 * i;
      T sa, ca, sb, cb;
      neo::sincos_t(uA[i] + bA, &sa, &ca);
      neo::sincos_t(uB[i] + bB, &sb, &cb);
      const T wa = vA ? inv_sqrt_d * s2s[r] : T(0);  // zero past n: s2s is zero there
      const T wb = (vB && r < rows) ? inv_sqrt_d : T(0);
      As[r][2 * pr] = ca * wa;
      As[r][2 * pr + 1] = sa * wa;
      Bs[r][2 * pr] = cb * wb;
      Bs[r][2 * pr + 1] = sb * wb;
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      T a[8], b[8];
      neo::load4(&As[r][4 * ty], a);
      neo::load4(&As[r][64 + 4 * ty], a + 4);
      neo::load4(&Bs[r][4 * tx], b);
      neo::load4(&Bs[r][64 + 4 * tx], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    if (diag && tid < kTile) {
      for (int r = 0; r < rows; ++r) {
        const T a = As[r][tid];
        edge_one += a;
        edge_y = fma(a, ys[r], edge_y);
      }
    }
    if (diag && ti == 0 && tid == kTile) {
      for (int r = 0; r < rows; ++r) {
        corner0 += s2s[r];
        corner1 = fma(s2s[r], ys[r], corner1);
        corner2 = fma(s2s[r] * ys[r], ys[r], corner2);
      }
    }
  }

  T* out = part_tiles + (static_cast<int64_t>(split) * gridDim.x + blockIdx.x) * kTile * kTile;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = (i < 4 ? 4 * ty : 64 + 4 * ty) + (i % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int q = (j < 4 ? 4 * tx : 64 + 4 * tx) + (j % 4);
      out[p * kTile + q] = acc[i][j];
    }
  }
  if (diag && tid < kTile) {
    T* edge = part_edges + (static_cast<int64_t>(split) * nt + ti) * kTile * 2;
    edge[2 * tid] = edge_one;
    edge[2 * tid + 1] = edge_y;
  }
  if (diag && ti == 0 && tid == kTile) {
    part_corner[3 * split] = corner0;
    part_corner[3 * split + 1] = corner1;
    part_corner[3 * split + 2] = corner2;
  }
}

// Adds the partials over the splits in a fixed order and writes G in [cos|sin|1|y]
// order, both triangles from the same upper-triangle sum (exactly symmetric).
template <typename T>
__global__ void gram_reduce_kernel(const T* __restrict__ part_tiles,
                                   const T* __restrict__ part_edges,
                                   const T* __restrict__ part_corner, T* __restrict__ G,
                                   int D, int nt, int splits) {
  const int K = 2 * D + 2;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(K) * K) return;
  const int ia = internal_column(static_cast<int>(idx / K), D);
  const int ic = internal_column(static_cast<int>(idx % K), D);
  const int p = min(ia, ic), q = max(ia, ic);
  const int ntiles = nt * (nt + 1) / 2;
  T sum = T(0);
  if (q < 2 * D) {
    const int ti = p / kTile, tj = q / kTile;
    const int tile = ti * nt - ti * (ti - 1) / 2 + (tj - ti);
    const int64_t off = static_cast<int64_t>(tile) * kTile * kTile + (p % kTile) * kTile + q % kTile;
    const int64_t stride = static_cast<int64_t>(ntiles) * kTile * kTile;
    for (int s = 0; s < splits; ++s) sum += part_tiles[s * stride + off];
  } else if (p < 2 * D) {
    const int64_t off = static_cast<int64_t>(p / kTile) * kTile * 2 + (p % kTile) * 2 + (q - 2 * D);
    const int64_t stride = static_cast<int64_t>(nt) * kTile * 2;
    for (int s = 0; s < splits; ++s) sum += part_edges[s * stride + off];
  } else {
    const int which = (p - 2 * D) + (q - 2 * D);  // (1,1) → 0, (1,y) → 1, (y,y) → 2
    for (int s = 0; s < splits; ++s) sum += part_corner[3 * s + which];
  }
  G[idx] = sum;
}

template <typename T>
int launch_gram(const T* X, const T* Mmap, const T* bmap, const T* s2, const T* y, T* G,
                T* workspace, int64_t n, int d, int D, int splits, int64_t rows_per_split,
                T inv_sqrt_d, cudaStream_t stream) {
  const int nt = num_col_tiles(D);
  const int ntiles = nt * (nt + 1) / 2;
  T* part_tiles = workspace;
  T* part_edges = part_tiles + static_cast<int64_t>(splits) * ntiles * kTile * kTile;
  T* part_corner = part_edges + static_cast<int64_t>(splits) * nt * kTile * 2;
  gram_partial_kernel<T><<<dim3(ntiles, splits), kThreads, 0, stream>>>(
      X, Mmap, bmap, s2, y, part_tiles, part_edges, part_corner, n, d, D, nt, rows_per_split,
      inv_sqrt_d);
  cudaError_t status = cudaGetLastError();
  if (status != cudaSuccess) return status;
  const int64_t K = 2 * static_cast<int64_t>(D) + 2;
  const int64_t blocks = (K * K + kThreads - 1) / kThreads;
  gram_reduce_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      part_tiles, part_edges, part_corner, G, D, nt, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of scratch the two kernels need for `splits` row ranges.
int64_t neo_gram_f64_workspace(int D, int splits) {
  const int64_t nt = num_col_tiles(D);
  return static_cast<int64_t>(splits) * (nt * (nt + 1) / 2 * kTile * kTile + nt * kTile * 2 + 3);
}

int neo_gram_f64(const void* X, const void* Mmap, const void* bmap, const void* s2,
                 const void* y, void* G, void* workspace, int64_t n, int d, int D, int splits,
                 int64_t rows_per_split, double inv_sqrt_d, void* stream) {
  return launch_gram<double>(static_cast<const double*>(X), static_cast<const double*>(Mmap),
                             static_cast<const double*>(bmap), static_cast<const double*>(s2),
                             static_cast<const double*>(y), static_cast<double*>(G),
                             static_cast<double*>(workspace), n, d, D, splits, rows_per_split,
                             inv_sqrt_d, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
