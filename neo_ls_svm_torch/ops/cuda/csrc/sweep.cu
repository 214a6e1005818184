// K2 (float32): fused leave-one-out γ-sweep, on Hopper's tensor cores (sm_90a), in
// 3×TF32. The one-pass path (precision="fast") is sweep_1xtf32.cu, the float64 path
// sweep_fp64.cu; neo_sweep_f32 below is the entry point of both float32 paths.
//
// Replaces the TPU kernel neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep (kernel
// body _sweep_kernel) under mxu_precision=HIGHEST (multi-pass MXU dots). For every row i
// and every γ_g of the grid it evaluates
//
//     W_i  = [cos U_i/√D, 1, sin U_i/√D, 0],   U_i = x_i·M + b,   Gu_i = W_i·Qs
//     num  = (1/c₀)·Σ_j Gu_ij·k_j·r_jg,        lev = (1/c₀)·s²_i·Σ_j Gu_ij²·r_jg
//     e_ig = (num − y_i)/(1 − lev), zeroed where a classifier is confidently right,
//
// and returns err_g = Σ_i s_i·|e_ig| and the objective: err_g, plus for a classifier
// Σ_i s_i·[|e_ig| ≥ 1] + Σ_i s_i·max(0, |e_ig| − 1).
//
// What bounds it on this card: the tensor cores' TF32 operations. With 2M = 2D+2 basis
// columns and G values of γ it does 2·n·(2M)² FLOP for Gu and 4·n·2M·G for num and lev,
// 6.6 TFLOP of f32 products at n = 1,048,576, 2M = 1026, G = 1024; 3×TF32 issues each
// three times against 495 TFLOP/s.
//
// What the design does about it (per row chunk, the rows walked in chunks):
//  (a) features.cu writes the chunk's W, row-major, in its TF32 hi and lo planes. U = X·M + b
//      stays in f32 FMAs.
//  (b) The product loop of gemm_sm90.cuh computes Gu = W·Qs as 128×128 tiles against
//      Qsᵀ (split once per call). Its epilogue writes Gu∘k and Gu∘Gu in hi and lo planes,
//      row-major: the A operands of (c).
//  (c) The product loop computes num and lev as two accumulators that share each B tile
//      of r_allᵀ (split once per call), 6 wgmma per k-step. Its epilogue forms e, the
//      classifier clip and the weighted sums over the tile's 128 rows (warp shuffles, then
//      the 8 warps in order through shared memory), and adds them into the partials of
//      its (row tile, γ).
//  Every product's accumulation runs are bounded at one k-block (gemm_sm90.cuh). A last
//  kernel adds the row tiles' partials in a fixed order. The wide matrices are
//  read once per 128-row tile (not once per 16 rows, as the CUDA-core kernel did), and
//  there are no atomics: the argmin over a flat objective cannot flip between runs.
//  Padding is zero (k to 32, rows and γ to 128), so the products need no masks; rows
//  past n are left out of the sums and γ past G is never read.

#include "features.cuh"
#include "gemm_sm90.cuh"
#include "sweep_epilogue.cuh"

namespace neo {
// The one-pass sweep (sweep_1xtf32.cu), with neo_sweep_f32's arguments.
cudaError_t sweep_1xtf32(const float* X, const float* Mmap, const float* bmap, const float* y,
                         const float* s, const float* s2, const float* Qs, const float* r_all,
                         const float* k, float* err, float* obj, float* workspace, int64_t n,
                         int d, int D, int G, int chunk, int is_classifier, float inv_sqrt_d,
                         float inv_c0, cudaStream_t st);
}  // namespace neo

namespace {

using namespace neo::sm90;
using neo::store_split;
using neo::sweep_f32::loo_epilogue;
using neo::sweep_f32::sweep_sum_kernel;

constexpr int kReduceBytes = neo::sweep_f32::reduce_bytes<kBN>();

// Stages of each product: a Gu stage holds 4 tiles, a sweep stage 6 (the hi and lo planes
// of two A operands and of r_allᵀ), 16 KB each; as many as fit in shared memory with the
// epilogue's buffer.
constexpr int kStagesGu = 3;
constexpr int kStagesLoo = 2;

// (b): GG planes, leading dimension ldk: 0, 1 = Gu∘k (hi, lo) and 2, 3 = Gu∘Gu (hi, lo).
__global__ void __launch_bounds__(kThreads, 1)
    sweep_gu_kernel(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmQ,
                    float* __restrict__ GG, int64_t plane, int ldk, const float* __restrict__ k,
                    int M2, int n_tiles, int kblocks) {
  auto& p = pipe_setup<1, kStagesGu>();
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  if (threadIdx.x >= kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers) produce<1, kStagesGu>(p, &tmW, &tmQ, m0, n0, 0, kblocks);
  } else {
    consumer_registers();
    float acc[1][kAcc];
    consume<1, kStagesGu>(p, kblocks, acc);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int c = n0 + acc_col(i);
      if (c < ldk) {
        const float gu = acc[0][i];
        float* o = GG + static_cast<int64_t>(m0 + acc_row(i)) * ldk + c;
        store_split<2>(o, plane, gu * (c < M2 ? k[c] : 0.0f));
        store_split<2>(o + 2 * plane, plane, gu * gu);
      }
    }
  }
}

// (c): the residuals of 128 rows × 128 values of γ and their weighted sums over the rows.
__global__ void __launch_bounds__(kThreads, 1)
    sweep_loo_kernel(const __grid_constant__ CUtensorMap tmGG, const __grid_constant__ CUtensorMap tmR,
                     float* __restrict__ part_err, float* __restrict__ part_obj, int ldp,
                     const float* __restrict__ y, const float* __restrict__ s,
                     const float* __restrict__ s2, int64_t r0, int64_t n, int g_tiles,
                     int kblocks, int is_classifier, float inv_c0, int accumulate) {
  auto& p = pipe_setup<2, kStagesLoo>();
  float* red = reinterpret_cast<float*>(&p + 1);  // [warp][column][err, obj]
  const int mt = blockIdx.x / g_tiles;
  const int m0 = mt * kBM;
  const int n0 = (blockIdx.x % g_tiles) * kBN;
  if (threadIdx.x >= kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers) produce<2, kStagesLoo>(p, &tmGG, &tmR, m0, n0, 0, kblocks);
  } else {
    consumer_registers();
    float acc[2][kAcc];
    consume<2, kStagesLoo>(p, kblocks, acc);
    loo_epilogue<kBN>(acc, red, part_err, part_obj, ldp, y, s, s2, r0 + m0, n, mt, n0, is_classifier,
                      inv_c0, accumulate);
  }
}

// The whole 3×TF32 sweep on one stream; see neo_sweep_f32.
cudaError_t run_sweep(const float* X, const float* Mmap, const float* bmap, const float* y,
                      const float* s, const float* s2, const float* Qs, const float* r_all,
                      const float* k, float* err, float* obj, float* workspace, int64_t n, int d,
                      int D, int G, int chunk, int is_classifier, float inv_sqrt_d, float inv_c0,
                      cudaStream_t st) {
  constexpr int P = kPlanes;
  const int M2 = 2 * D + 2;
  const int Kp = (M2 + kBK - 1) / kBK * kBK;
  const int Np = (M2 + kBN - 1) / kBN * kBN;
  const int Gp = (G + kBN - 1) / kBN * kBN;
  const int64_t plane = static_cast<int64_t>(chunk) * Kp;
  float* W = workspace;
  float* GG = W + P * plane;
  float* Qt = GG + 2 * P * plane;
  float* Rt = Qt + P * static_cast<int64_t>(Np) * Kp;
  float* part_err = Rt + P * static_cast<int64_t>(Gp) * Kp;
  float* part_obj = part_err + static_cast<int64_t>(chunk / kBM) * Gp;

  cudaError_t status = neo::launch_split_transpose(Qs, M2, M2, Qt, Kp, Np, P, st);
  if (status != cudaSuccess) return status;
  status = neo::launch_split_transpose(r_all, M2, G, Rt, Kp, Gp, P, st);
  if (status != cudaSuccess) return status;
  CUtensorMap tmW, tmQ, tmGG, tmR;
  if ((status = make_tile_map(&tmW, W, Kp, chunk, P)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmQ, Qt, Kp, Np, P)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmGG, GG, Kp, chunk, 2 * P)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmR, Rt, Kp, Gp, P)) != cudaSuccess) return status;
  const int smem_gu = pipe_smem_bytes<1, kStagesGu>(0);
  const int smem_loo = pipe_smem_bytes<2, kStagesLoo>(kReduceBytes);
  status = cudaFuncSetAttribute(sweep_gu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_gu);
  if (status != cudaSuccess) return status;
  status = cudaFuncSetAttribute(sweep_loo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_loo);
  if (status != cudaSuccess) return status;

  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int row_tiles = (rows + kBM - 1) / kBM;
    status = neo::launch_features(neo::FeatureLayout::kSweepW, X, Mmap, bmap, s2, y, W, plane, P,
                                  Kp, r0, n, row_tiles * kBM, d, D, Kp, inv_sqrt_d, st);
    if (status != cudaSuccess) return status;
    sweep_gu_kernel<<<row_tiles * (Np / kBN), kThreads, smem_gu, st>>>(
        tmW, tmQ, GG, plane, Kp, k, M2, Np / kBN, Kp / kBK);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
    sweep_loo_kernel<<<row_tiles * (Gp / kBN), kThreads, smem_loo, st>>>(
        tmGG, tmR, part_err, part_obj, Gp, y, s, s2, r0, n, Gp / kBN, Kp / kBK, is_classifier,
        inv_c0, r0 > 0);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
  }
  sweep_sum_kernel<<<(G + 255) / 256, 256, 0, st>>>(part_err, part_obj, Gp, chunk / kBM, G, err, obj);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 in float32. passes = 3 runs the 3×TF32 sweep above; its workspace (floats), for
// Kp = 2M rounded up to 32, Np = 2M rounded up to 128 and Gp = G rounded up to 128: W
// (2·chunk·Kp), GG (4·chunk·Kp), Qsᵀ (2·Np·Kp), r_allᵀ (2·Gp·Kp), then the err and obj
// partials (2·(chunk/128)·Gp); chunk is a multiple of 128 and at most the first chunk's
// rows rounded up to 128. passes = 1 runs the one-pass sweep of sweep_1xtf32.cu, with the
// workspace and chunk that its neo::sweep_1xtf32 states. The wrapper's plan sizes both.
int neo_sweep_f32(const void* X, const void* Mmap, const void* bmap, const void* y,
                  const void* s, const void* s2, const void* Qs, const void* r_all,
                  const void* k, void* err, void* obj, void* workspace, int64_t n, int d, int D,
                  int G, int chunk, int is_classifier, int passes, float inv_sqrt_d, float inv_c0,
                  void* stream) {
  if (passes != 1 && passes != 3) return cudaErrorInvalidValue;
  const auto run = passes == 3 ? &run_sweep : &neo::sweep_1xtf32;
  return run(static_cast<const float*>(X), static_cast<const float*>(Mmap),
             static_cast<const float*>(bmap), static_cast<const float*>(y),
             static_cast<const float*>(s), static_cast<const float*>(s2),
             static_cast<const float*>(Qs), static_cast<const float*>(r_all),
             static_cast<const float*>(k), static_cast<float*>(err), static_cast<float*>(obj),
             static_cast<float*>(workspace), n, d, D, G, chunk, is_classifier, inv_sqrt_d, inv_c0,
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
