// K3 (float32): the streaming solver's third pass, the per-row statistics at the chosen γ,
// on Hopper's tensor cores (sm_90a), in 3×TF32.
//
// Replaces no TPU kernel. The JAX package computes this pass with XLA operations
// (neo_ls_svm_tpu/models/primal.py, the third pass of primal_fit_streaming; only
// ops/pallas/gram.py and ops/pallas/sweep.py reach pl.pallas_call), and the port did the
// same in PyTorch: per row chunk the features, Gu = W·Qs in cuBLAS's IEEE float32 on the
// CUDA cores, Gu∘Gu and three matrix-vector products. It was added because that product was
// the largest single cost of a large streaming fit on an H100 (PERF.md §5), at a sixth of
// its tensor-core bound. For every row i, at the chosen γ's resolvent column r = 1/(γ + λ):
//
//     W_i   = [cos U_i/√D, 1, sin U_i/√D, 0],   U_i = x_i·M + b,   Gu_i = W_i·Qs
//     num_i = (1/c₀)·Σ_j Gu_ij·(k∘r)_j,          σ²_i = (1/c₀)·Σ_j Gu_ij²·r_j
//     res_i = W_i·β − y_i                         (β = sign∘β_emb, the embedded solution)
//
// What bounds it on this card: the tensor cores' TF32 operations, 2·n·(2M)² FLOP for Gu
// (22.1 TFLOP at n = 10.5M, 2M = 1026), each issued three times against 495 TFLOP/s. It
// writes three floats a row; W's planes pass through the workspace once a chunk.
//
// What the design does about it (per row chunk, the rows walked in chunks as K2 walks them):
//  (a) features.cu writes the chunk's W, row-major, in its TF32 hi and lo planes (K2's layout).
//  (b) The product loop of gemm_sm90.cuh computes Gu as 128×128 tiles against [Qs | β]ᵀ,
//      split once per call: β rides in column 2M of the B operand, which is padding for Qs,
//      so the residual costs no product of its own (k∘r and r are zero past 2M, so that
//      column enters the residual alone). Accumulation runs stay bounded at one k-block.
//  (c) No Gu leaves the registers. The epilogue reduces each row of its tile: a thread adds
//      its 32 columns of the row in order, the 4 lanes that hold the row add theirs by two
//      shuffles (xor 1, then 2), and one lane writes the tile's partial Σ Gu·(k∘r) and
//      Σ Gu²·r of the row; the thread that holds column 2M writes the residual.
//  (d) A second kernel adds a row's column-tile partials in order and scales them by 1/c₀.
//  There are no atomics: two calls on the same rows give the same bits. Padding is zero (k
//  to 32, rows and columns to 128), so the product needs no masks; rows past n are written
//  nowhere.

#include "features.cuh"
#include "gemm_sm90.cuh"

namespace {

using namespace neo::sm90;

// Stages of the product: each holds 4 tiles (W and [Qs | β]ᵀ, hi and lo), 16 KB each.
constexpr int kStages = 3;

// (b), (c): tile nt of the chunk's row tile blockIdx.x / n_tiles. part[2·nt][row] and
// part[2·nt + 1][row], leading dimension ldp, get the tile's Σ_j Gu·(k∘r) and Σ_j Gu²·r of
// each row of the chunk; res[r0 + row] the residual, from the tile that holds column M2.
__global__ void __launch_bounds__(kThreads, 1)
    pass3_gu_kernel(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmB,
                    const float* __restrict__ kr, const float* __restrict__ r,
                    const float* __restrict__ y, float* __restrict__ part, int ldp,
                    float* __restrict__ res, int64_t r0, int64_t n, int M2, int n_tiles, int kblocks) {
  auto& p = pipe_setup<1, kStages>();
  const int nt = blockIdx.x % n_tiles;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = nt * kBN;
  if (threadIdx.x >= kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers) produce<1, kStages>(p, &tmW, &tmB, m0, n0, 0, kblocks);
    return;
  }
  consumer_registers();
  float acc[1][kAcc];
  consume<1, kStages>(p, kblocks, acc);
  // This thread's two rows h = 0, 1 (acc_row(2h)), 32 columns of each.
  float num[2] = {0.0f, 0.0f}, sig[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int h = (i >> 1) & 1;
    const int c = n0 + acc_col(i);
    const float gu = acc[0][i];
    if (c < M2) {
      num[h] = fmaf(gu, kr[c], num[h]);
      sig[h] = fmaf(gu * gu, r[c], sig[h]);
    } else if (c == M2) {
      const int64_t g = r0 + m0 + acc_row(i);
      if (g < n) res[g] = gu - y[g];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {  // the 4 lanes of a row
      num[h] += __shfl_xor_sync(0xffffffffu, num[h], off);
      sig[h] += __shfl_xor_sync(0xffffffffu, sig[h], off);
    }
  }
  if (threadIdx.x % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + acc_row(2 * h);
      part[static_cast<int64_t>(2 * nt) * ldp + row] = num[h];
      part[static_cast<int64_t>(2 * nt + 1) * ldp + row] = sig[h];
    }
  }
}

// (d): rows r0 .. r0 + rows - 1.
__global__ void pass3_sum_kernel(const float* __restrict__ part, int ldp, int n_tiles, int64_t r0,
                                 int rows, float inv_c0, float* __restrict__ num,
                                 float* __restrict__ sig2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float a = 0.0f, b = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    a += part[static_cast<int64_t>(2 * t) * ldp + i];
    b += part[static_cast<int64_t>(2 * t + 1) * ldp + i];
  }
  num[r0 + i] = inv_c0 * a;
  sig2[r0 + i] = inv_c0 * b;
}

// The whole pass on one stream; see neo_pass3_f32.
cudaError_t run_pass3(const float* X, const float* Mmap, const float* bmap, const float* y,
                      const float* QB, const float* kr, const float* r, float* num, float* sig2,
                      float* res, float* workspace, int64_t n, int d, int D, int chunk,
                      float inv_sqrt_d, float inv_c0, cudaStream_t st) {
  constexpr int P = kPlanes;
  const int M2 = 2 * D + 2;
  const int Kp = (M2 + kBK - 1) / kBK * kBK;
  const int Np = (M2 + 1 + kBN - 1) / kBN * kBN;  // β's column too
  const int n_tiles = Np / kBN;
  const int64_t plane = static_cast<int64_t>(chunk) * Kp;
  float* W = workspace;
  float* Bt = W + P * plane;
  float* part = Bt + P * static_cast<int64_t>(Np) * Kp;

  cudaError_t status = neo::launch_split_transpose(QB, M2, M2 + 1, Bt, Kp, Np, P, st);
  if (status != cudaSuccess) return status;
  CUtensorMap tmW, tmB;
  if ((status = make_tile_map(&tmW, W, Kp, chunk, P)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmB, Bt, Kp, Np, P)) != cudaSuccess) return status;
  const int smem = pipe_smem_bytes<1, kStages>(0);
  status = cudaFuncSetAttribute(pass3_gu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return status;

  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int row_tiles = (rows + kBM - 1) / kBM;
    // The kSweepW layout reads no s2.
    status = neo::launch_features(neo::FeatureLayout::kSweepW, X, Mmap, bmap, nullptr, y, W, plane,
                                  P, Kp, r0, n, row_tiles * kBM, d, D, Kp, inv_sqrt_d, st);
    if (status != cudaSuccess) return status;
    pass3_gu_kernel<<<row_tiles * n_tiles, kThreads, smem, st>>>(tmW, tmB, kr, r, y, part, chunk, res,
                                                                 r0, n, M2, n_tiles, Kp / kBK);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
    pass3_sum_kernel<<<(rows + 255) / 256, 256, 0, st>>>(part, chunk, n_tiles, r0, rows, inv_c0, num, sig2);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K3 in float32: num, sig2 and res (n floats each) of the rows of X (n × d), for M (d × D),
// b (D), y (n), QB = [Qs | β] (2M × (2M + 1), row-major), kr = k∘r and r (2M each). The
// workspace (floats), for Kp = 2M rounded up to 32 and Np = 2M + 1 rounded up to 128: W
// (2·chunk·Kp), [Qs | β]ᵀ (2·Np·Kp), then the column tiles' partials (2·(Np/128)·chunk);
// chunk is a multiple of 128. The wrapper's plan sizes it.
int neo_pass3_f32(const void* X, const void* Mmap, const void* bmap, const void* y, const void* QB,
                  const void* kr, const void* r, void* num, void* sig2, void* res, void* workspace,
                  int64_t n, int d, int D, int chunk, float inv_sqrt_d, float inv_c0, void* stream) {
  if (chunk <= 0 || chunk % neo::sm90::kBM != 0) return cudaErrorInvalidValue;
  return run_pass3(static_cast<const float*>(X), static_cast<const float*>(Mmap),
                   static_cast<const float*>(bmap), static_cast<const float*>(y),
                   static_cast<const float*>(QB), static_cast<const float*>(kr),
                   static_cast<const float*>(r), static_cast<float*>(num), static_cast<float*>(sig2),
                   static_cast<float*>(res), static_cast<float*>(workspace), n, d, D, chunk,
                   inv_sqrt_d, inv_c0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
