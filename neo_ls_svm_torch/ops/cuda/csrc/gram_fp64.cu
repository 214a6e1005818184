// K1 (float64): fused random-Fourier feature build + augmented Gram, on Hopper's FP64
// tensor cores (sm_90a). The float32 path is gram.cu.
//
// Replaces, in float64, the TPU kernel neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram
// (kernel body _gram_kernel). It computes
//
//     G = Yᵀ·diag(s²)·Y,   Y = [cos U/√D | sin U/√D | 1 | y],   U = X·M + b,
//
// the (2D+2)×(2D+2) augmented Gram of the primal solver's streaming pass 1. Every float64
// fit that streams (from 261,633 rows at D = 512: the working set 3·n·2(D+1)·8 passes
// 6 GiB) launches it once.
//
// What bounds it on this card: operations, on the FP64 tensor cores. At the 1M-row fit
// (n = 1,048,576, D = 512, K = 2D+2 = 1026) the upper triangle is 1.1 TFLOP against
// 67 TFLOP/s (17 ms), and the chunks' features are about 5 ms of bytes at 3.35 TB/s.
//
// What the design does about it (the structure of gram.cu, in f64):
//  * The rows are walked in chunks. For each, features.cu writes the chunk's sYᵀ once
//    (s = √s², so G = (sY)ᵀ(sY)), feature-major in one f64 plane, with the 1 and y columns
//    as two more feature rows: a row's 512 sincos and phases are computed once, not once
//    per output tile.
//  * The product loop of gemm_sm90_f64.cuh (TMA + DMMA m16n8k16) computes the upper
//    128×128 tiles of (sYᵀ)(sYᵀ)ᵀ with the chunk's rows as the contraction. The last tile
//    row and column hold the 1 and y features and padding: their fragments past K are
//    skipped, so a tile there costs a quarter of a full one or less. The rows of a chunk
//    are also split between blocks so that tiles × splits fill the 132 SMs.
//  * Each chunk's tile is added into its split's partial slot; the mirror kernel adds the
//    slots in a fixed order. No atomics, so the result is the same on every run.
//  * The mirror kernel writes both triangles from the same sum (exactly symmetric), in the
//    TPU kernel's [cos | sin | 1 | y] order.

#include "features.cuh"
#include "gemm_sm90_f64.cuh"

namespace {

using namespace neo::sm90_f64;

constexpr int kStages = 6;  // 32 KB each
constexpr int kBN = 128;

__global__ void __launch_bounds__(kThreads, 1)
    gram_tiles_f64_kernel(const __grid_constant__ CUtensorMap tmY, double* __restrict__ slots,
                          int nt, int K, int kb_per_split, int kblocks, int accumulate) {
  auto& p = pipe_setup<1, kBN, kStages>();
  const int ntiles = nt * (nt + 1) / 2;
  const int tile = blockIdx.x % ntiles;
  const int split = blockIdx.x / ntiles;
  int t = tile, ti = 0;  // the upper-triangle tile (ti <= tj), enumerated row by row
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int kb0 = split * kb_per_split;
  const int kbs = max(0, min(kb_per_split, kblocks - kb0));
  if (threadIdx.x >= kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers) produce<1, kBN, kStages>(p, &tmY, &tmY, ti * kBM, tj * kBN, kb0, kbs);
  } else {
    consumer_registers();
    Acc<1, kBN> acc;
    consume<1, kBN, kStages>(p, kbs, K - ti * kBM, K - tj * kBN, acc);
    double* out = slots + (static_cast<int64_t>(split) * ntiles + tile) * kBM * kBN;
    using T = Tiling<kBN>;
#pragma unroll
    for (int mf = 0; mf < T::kMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < T::kNF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          double2* o = reinterpret_cast<double2*>(out + acc_row<kBN>(mf, i) * kBN + acc_col<kBN>(nf, i));
          double2 v = make_double2(acc[0][mf][nf][i], acc[0][mf][nf][i + 1]);
          if (accumulate) {
            const double2 before = *o;
            v.x += before.x;
            v.y += before.y;
          }
          *o = v;
        }
  }
}

// G[a][c] = Σ over the splits, in order, of the upper-triangle entry (min, max).
__global__ void gram_mirror_f64_kernel(const double* __restrict__ slots, double* __restrict__ G,
                                       int K, int nt, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(K) * K) return;
  const int a = static_cast<int>(idx / K), c = static_cast<int>(idx % K);
  const int p = min(a, c), q = max(a, c);
  const int ti = p / kBM, tj = q / kBN;
  const int tile = ti * nt - ti * (ti - 1) / 2 + (tj - ti);
  const int64_t off = static_cast<int64_t>(tile) * kBM * kBN + (p % kBM) * kBN + q % kBN;
  const int64_t stride = static_cast<int64_t>(nt) * (nt + 1) / 2 * kBM * kBN;
  double sum = 0.0;
  for (int s = 0; s < splits; ++s) sum += slots[s * stride + off];
  G[idx] = sum;
}

}  // namespace

extern "C" {

// The workspace (doubles) is the chunk's sYᵀ (F·chunk, F = 2D+2 rounded up to 128), then
// splits × nt(nt+1)/2 partial tiles (nt = F/128); the wrapper's plan sizes it. chunk is a
// multiple of 32, and kb_per_split · splits covers chunk / 16 k-blocks.
int neo_gram_f64(const void* X, const void* Mmap, const void* bmap, const void* s2,
                 const void* y, void* G, void* workspace, int64_t n, int d, int D, int chunk,
                 int splits, int kb_per_split, double inv_sqrt_d, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int K = 2 * D + 2;
  const int F = (K + kBM - 1) / kBM * kBM;
  const int nt = F / kBM;
  const int ntiles = nt * (nt + 1) / 2;
  double* feat = static_cast<double*>(workspace);
  double* slots = feat + static_cast<int64_t>(F) * chunk;
  CUtensorMap tmY;
  cudaError_t status = make_tile_map(&tmY, feat, chunk, F, 1, kBM);
  if (status != cudaSuccess) return status;
  const int smem = pipe_smem_bytes<1, kBN, kStages>(0);
  status = cudaFuncSetAttribute(gram_tiles_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return status;
  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int rows_pad = (rows + 31) / 32 * 32;
    status = neo::launch_features(neo::FeatureLayout::kGramT, static_cast<const double*>(X),
                                  static_cast<const double*>(Mmap), static_cast<const double*>(bmap),
                                  static_cast<const double*>(s2), static_cast<const double*>(y), feat,
                                  chunk, r0, n, rows_pad, d, D, F, inv_sqrt_d, st);
    if (status != cudaSuccess) return status;
    gram_tiles_f64_kernel<<<splits * ntiles, kThreads, smem, st>>>(tmY, slots, nt, K, kb_per_split,
                                                                    rows_pad / kBK, r0 > 0);
    status = cudaGetLastError();
    if (status != cudaSuccess) return status;
  }
  const int64_t entries = static_cast<int64_t>(K) * K;
  gram_mirror_f64_kernel<<<static_cast<unsigned>((entries + 255) / 256), 256, 0, st>>>(
      slots, static_cast<double*>(G), K, nt, splits);
  return cudaGetLastError();
}

}  // extern "C"
