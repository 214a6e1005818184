// K1 (float32): fused random-Fourier feature build + augmented Gram, on Hopper's tensor
// cores in 3×TF32 (sm_90a). The float64 path is gram_fp64.cu.
//
// Replaces the TPU kernel neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram
// (kernel body _gram_kernel). It computes
//
//     G = Yᵀ·diag(s²)·Y,   Y = [cos U/√D | sin U/√D | 1 | y],   U = X·M + b,
//
// the (2D+2)×(2D+2) augmented Gram of the primal solver's streaming pass 1.
//
// What bounds it on this card: the tensor cores' TF32 operations. The Gram's upper
// triangle is a symmetric product over the rows; 3×TF32 issues it three times, so at
// the 1M-row fit (n = 1,048,576, D = 512, 1152 padded features, 45 of 81 tiles) it is
// about 4.6 TFLOP of TF32 against 495 TFLOP/s, far above the HBM ridge.
//
// What the design does about it:
//  * The rows are walked in chunks. For each, features.cu writes the chunk's sYᵀ once
//    (s = √s², so G = (sY)ᵀ(sY)), feature-major and split into TF32 hi and lo planes,
//    with the 1 and y columns as two more feature rows: no edge or corner code.
//  * The product loop of gemm_sm90.cuh (TMA + wgmma 3×TF32) computes the 45 upper
//    128×128 tiles of (sYᵀ)(sYᵀ)ᵀ with the chunk's rows as the contraction. The rows of a
//    chunk are also split between blocks so that tiles × splits fill the 132 SMs; the
//    blocks are ordered split-major, so the blocks in flight read a few splits' rows
//    (about the 50 MB L2) while all tiles read them.
//  * Accumulation runs are bounded: each k-block of 32 rows is one wgmma run, added into
//    a register sum in IEEE f32; each chunk's tile is then added into its split's partial
//    slot, and the mirror kernel adds the slots in a fixed order. No atomics, so the
//    result is the same on every run.
//  * The mirror kernel writes both triangles from the same sum (exactly symmetric), in the
//    TPU kernel's [cos | sin | 1 | y] order.

#include "features.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace neo::sm90;

constexpr int kStages = 3;

__global__ void __launch_bounds__(kThreads, 1)
    gram_tiles_kernel(const __grid_constant__ CUtensorMap tmY, float* __restrict__ slots,
                      int nt, int kb_per_split, int kblocks, int accumulate) {
  auto& p = pipe_setup<1, kStages>();
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
    if (threadIdx.x == kConsumers) produce<1, kStages>(p, &tmY, &tmY, ti * kBM, tj * kBN, kb0, kbs);
  } else {
    consumer_registers();
    float acc[1][kAcc];
    consume<1, kStages>(p, kbs, acc);
    float* out = slots + (static_cast<int64_t>(split) * ntiles + tile) * kBM * kBN;
#pragma unroll
    for (int i = 0; i < kAcc; i += 2) {
      float2* o = reinterpret_cast<float2*>(out + acc_row(i) * kBN + acc_col(i));
      float2 v = make_float2(acc[0][i], acc[0][i + 1]);
      if (accumulate) {
        const float2 before = *o;
        v.x += before.x;
        v.y += before.y;
      }
      *o = v;
    }
  }
}

// G[a][c] = Σ over the splits, in order, of the upper-triangle entry (min, max).
__global__ void gram_mirror_kernel(const float* __restrict__ slots, float* __restrict__ G,
                                   int K, int nt, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(K) * K) return;
  const int a = static_cast<int>(idx / K), c = static_cast<int>(idx % K);
  const int p = min(a, c), q = max(a, c);
  const int ti = p / kBM, tj = q / kBN;
  const int tile = ti * nt - ti * (ti - 1) / 2 + (tj - ti);
  const int64_t off = static_cast<int64_t>(tile) * kBM * kBN + (p % kBM) * kBN + q % kBN;
  const int64_t stride = static_cast<int64_t>(nt) * (nt + 1) / 2 * kBM * kBN;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += slots[s * stride + off];
  G[idx] = sum;
}

}  // namespace

extern "C" {

// The workspace (floats) is the chunk's sYᵀ, hi and lo (2·F·chunk, F = 2D+2 rounded up
// to 128), then splits × 45 (at F = 1152) partial tiles; the wrapper's plan sizes it.
// chunk is a multiple of 32, and kb_per_split · splits covers chunk / 32 k-blocks.
int neo_gram_f32(const void* X, const void* Mmap, const void* bmap, const void* s2,
                 const void* y, void* G, void* workspace, int64_t n, int d, int D, int chunk,
                 int splits, int kb_per_split, float inv_sqrt_d, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int K = 2 * D + 2;
  const int F = (K + kBM - 1) / kBM * kBM;
  const int nt = F / kBM;
  const int ntiles = nt * (nt + 1) / 2;
  float* feat = static_cast<float*>(workspace);
  float* slots = feat + 2 * static_cast<int64_t>(F) * chunk;
  CUtensorMap tmY;
  cudaError_t status = make_tile_map(&tmY, feat, chunk, F, 2);
  if (status != cudaSuccess) return status;
  const int smem = pipe_smem_bytes<1, kStages>(0);
  status = cudaFuncSetAttribute(gram_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return status;
  const auto* Xf = static_cast<const float*>(X);
  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int rows_pad = (rows + kBK - 1) / kBK * kBK;
    status = neo::launch_features(neo::FeatureLayout::kGramT, Xf, static_cast<const float*>(Mmap),
                                  static_cast<const float*>(bmap), static_cast<const float*>(s2),
                                  static_cast<const float*>(y), feat,
                                  static_cast<int64_t>(F) * chunk, 2, chunk, r0, n, rows_pad, d,
                                  D, F, inv_sqrt_d, st);
    if (status != cudaSuccess) return status;
    gram_tiles_kernel<<<splits * ntiles, kThreads, smem, st>>>(tmY, slots, nt, kb_per_split,
                                                                rows_pad / kBK, r0 > 0);
    status = cudaGetLastError();
    if (status != cudaSuccess) return status;
  }
  const int64_t entries = static_cast<int64_t>(K) * K;
  gram_mirror_kernel<<<static_cast<unsigned>((entries + 255) / 256), 256, 0, st>>>(
      slots, static_cast<float*>(G), K, nt, splits);
  return cudaGetLastError();
}

const char* neo_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
