// K2 (float32) under precision="fast": the fused leave-one-out γ-sweep in one TF32 pass per
// product, on Hopper's tensor cores (sm_90a). The 3×TF32 path is sweep.cu, whose
// neo_sweep_f32 calls sweep_1xtf32 below for passes = 1.
//
// Replaces the TPU kernel neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep (kernel
// body _sweep_kernel) under mxu_precision=DEFAULT (one MXU pass per dot). It evaluates what
// sweep.cu does (U = X·M + b in f32 FMAs with precise sincos, W = [cos U/√D, 1, sin U/√D, 0],
// Gu = W·Qs, num = (1/c₀)(Gu∘k)·r_all, lev = (1/c₀)s²(Gu∘Gu)·r_all, the residual, the
// classifier clip and the weighted err/obj sums), with each of the three products in one
// TF32 pass: every operand is rounded once, tf32_rna(v).
//
// What bounds it on this card: the tensor cores' TF32 operations, 6.6 TFLOP of products at
// n = 1,048,576, 2M = 1026, G = 1024, about 13 ms at 495 TFLOP/s. One pass needs its tiles
// three times as fast per operation as 3×TF32, so the design is about what a k-block moves
// (gemm_sm90_1xtf32.cuh). Per row chunk (a multiple of 256 rows):
//  (a) features.cu writes the chunk's W, row-major, TF32 hi plane only.
//  (b) gu_1xtf32_kernel: Gu = W·Qs in persistent tiles of 256 rows × 176 columns against
//      Qsᵀ (transposed and rounded once per call), 6 column tiles at D = 512 with no
//      padding; its epilogue stores Gu in float32, one plane, two columns a store.
//  (c) loo_1xtf32_kernel: num and lev as two accumulators over one B tile of r_allᵀ, in
//      persistent tiles of 128 rows × 176 values of γ. A stage holds the Gu tile, the
//      r_allᵀ tile and the k-block's k (38 KB); each consumer thread forms its fragments of
//      tf32(Gu∘k) and tf32(Gu∘Gu) in registers, the A operands of a register-A wgmma, so
//      neither operand passes through device memory or shared memory. Its epilogue
//      (sweep_epilogue.cuh) forms e and the weighted sums over the tile's rows and adds them
//      into the partials of its (row tile, γ); a last kernel adds the row tiles' partials in
//      a fixed order. No atomics: the argmin over a flat objective cannot flip between runs.
// Padding is zero (k to 32, rows to 256, columns and γ to 176), so the products need no
// masks; rows past n are left out of the sums and γ past G is never read.

#include "features.cuh"
#include "gemm_sm90_1xtf32.cuh"
#include "sweep_epilogue.cuh"

namespace neo {
namespace {

// (Not `using namespace`: neo::kThreads, the 256 threads of the feature build, would clash
// with the 384 of these blocks, sm90::kThreads.)
using one_pass::consume;
using one_pass::consume_rs;
using one_pass::kAcc;
using one_pass::kBK;
using one_pass::kBN;
using one_pass::kConsumers;
using one_pass::make_box_map;
using one_pass::pipe_setup;
using one_pass::pipe_smem_bytes;
using one_pass::produce;
using one_pass::Ring;
using one_pass::Tiles;
using sm90::desc_b128;
using sm90::kThreads;
using neo::sweep_f32::loo_epilogue;
using neo::sweep_f32::sweep_sum_kernel;

// Stages of the two products' rings, 54 KB (Gu) and 38 KB (sweep) each. Gu's four are as
// many as fit; the sweep's four fit beside its epilogue buffer, and five were no faster.
constexpr int kStagesGu = 4;
constexpr int kStagesLoo = 4;
constexpr int kRowsGu = 256;   // rows of a Gu tile: two 64-row products a consumer warpgroup
constexpr int kRowsLoo = 128;  // rows of a sweep tile: one 64-row slab a consumer warpgroup
constexpr int kReduceBytes = neo::sweep_f32::reduce_bytes<kBN>();

// (b): Gu (float32, as the accumulators hold it) at leading dimension ldk; columns past ldk
// are not stored, columns past 2M hold zero.
__global__ void __launch_bounds__(kThreads, 1)
    gu_1xtf32_kernel(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmQ,
                     float* __restrict__ Gu, int ldk, Tiles tiles, int kblocks) {
  auto& p = pipe_setup<kRowsGu, kStagesGu, false>();
  if (threadIdx.x >= kConsumers) {
    sm90::producer_registers();
    if (threadIdx.x == kConsumers) produce<kRowsGu, kStagesGu, false>(p, &tmW, &tmQ, nullptr, tiles, kblocks);
    return;
  }
  sm90::consumer_registers();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // The warpgroup's two products: rows 128·wg and 128·wg + 64 of the stage's 256.
  const auto operands = [&p, wg](int stage, int, uint64_t& da0, uint64_t& da1) {
    da0 = desc_b128(p.a[stage] + 128 * wg * kBK);
    da1 = desc_b128(p.a[stage] + (128 * wg + 64) * kBK);
  };
  Ring<kStagesGu> ring;
  float acc[2][kAcc];
  for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
    consume<kRowsGu, kStagesGu>(p, ring, kblocks, acc, operands);
    // acc[j][4q + 2h + e]: row 128·wg + 64·j + 16·warp + lane/4 + 8h, column 8q + 2·(lane%4) + e.
    const int row = (t / tiles.col_tiles) * kRowsGu + 128 * wg + 16 * warp + lane / 4;
    const int c0 = (t % tiles.col_tiles) * kBN + 2 * (lane % 4);
#pragma unroll
    for (int q = 0; q < kAcc / 4; ++q) {
      const int c = c0 + 8 * q;
      if (c < ldk) {  // ldk is even: so is c + 1 < ldk
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* o = Gu + static_cast<int64_t>(row + 64 * j + 8 * h) * ldk + c;
            *reinterpret_cast<float2*>(o) = make_float2(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
          }
      }
    }
  }
}

// (c): the residuals of 128 rows × 176 values of γ and their weighted sums over the rows.
// A stage holds a Gu tile (the rows, TMA from the workspace), an r_allᵀ tile and the
// k-block's 32 values of k: 38 KB a k-block where Gu∘k and Gu∘Gu would take 54. Each
// consumer thread loads its A fragments of Gu from shared memory and forms tf32(Gu∘k) and
// tf32(Gu∘Gu) in registers, the A operands of wgmma; B comes from shared memory.
__global__ void __launch_bounds__(kThreads, 1)
    loo_1xtf32_kernel(const __grid_constant__ CUtensorMap tmGu, const __grid_constant__ CUtensorMap tmR,
                      const __grid_constant__ CUtensorMap tmK, float* __restrict__ part_err,
                      float* __restrict__ part_obj, int ldp, const float* __restrict__ y,
                      const float* __restrict__ s, const float* __restrict__ s2, int64_t r0,
                      int64_t n, Tiles tiles, int kblocks, int is_classifier, float inv_c0,
                      int accumulate) {
  auto& p = pipe_setup<kRowsLoo, kStagesLoo, true>();
  float* red = reinterpret_cast<float*>(&p + 1);  // [warp][column][err, obj]
  if (threadIdx.x >= kConsumers) {
    sm90::producer_registers();
    if (threadIdx.x == kConsumers) produce<kRowsLoo, kStagesLoo, true>(p, &tmGu, &tmR, &tmK, tiles, kblocks);
    return;
  }
  sm90::consumer_registers();
  // This thread's rows of the warpgroup's 64-row slab and its column within a k-step. In the
  // 128-byte swizzle, row r's 16-byte chunk j lies at chunk j ^ (r % 8); r % 8 = lane/4.
  const int lane = threadIdx.x % 32;
  const int row = 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const int swz = lane / 4, c = lane % 4;
  const auto fragments = [&p, row, swz, c](int stage, int kk, uint32_t (&fk)[4], uint32_t (&fg)[4]) {
    const float* g0 = p.a[stage] + row * kBK + c;  // row r; g0 + 8·kBK is row r + 8
    const float* g1 = g0 + 8 * kBK;
    const int lo = 4 * ((2 * kk) ^ swz), hi = 4 * ((2 * kk + 1) ^ swz);  // columns 8kk + c, + 4
    const float g[4] = {g0[lo], g1[lo], g0[hi], g1[hi]};
    const float k0 = p.side[stage][8 * kk + c], k1 = p.side[stage][8 * kk + c + 4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      fk[i] = __float_as_uint(tf32_rna(g[i] * (i < 2 ? k0 : k1)));
      fg[i] = __float_as_uint(tf32_rna(g[i] * g[i]));
    }
  };
  Ring<kStagesLoo> ring;
  float acc[2][kAcc];
  for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
    consume_rs<kRowsLoo, kStagesLoo>(p, ring, kblocks, acc, fragments);
    const int mt = t / tiles.col_tiles, n0 = (t % tiles.col_tiles) * kBN;
    sm90::consumers_sync();  // the last tile's epilogue has read `red`
    loo_epilogue<kBN>(acc, red, part_err, part_obj, ldp, y, s, s2, r0 + mt * kRowsLoo, n, mt, n0,
                      is_classifier, inv_c0, accumulate);
  }
}

}  // namespace

// The one-pass sweep on one stream. Its workspace (floats), for Kp = 2M rounded up to 32,
// Gq = ceil(G/176)·176, and Nq, Gr those of ceil(Kp/176)·176 and Gq rounded up to 32: W
// (chunk·Kp), Gu (chunk·Kp), Qsᵀ (Nq·Kp), r_allᵀ (Gr·Kp), k padded with zeros (Kp), then the
// err and obj partials (2·(chunk/128)·Gq). chunk is a multiple of 256 and at most the first chunk's
// rows rounded up to 256.
cudaError_t sweep_1xtf32(const float* X, const float* Mmap, const float* bmap, const float* y,
                         const float* s, const float* s2, const float* Qs, const float* r_all,
                         const float* k, float* err, float* obj, float* workspace, int64_t n,
                         int d, int D, int G, int chunk, int is_classifier, float inv_sqrt_d,
                         float inv_c0, cudaStream_t st) {
  if (chunk % kRowsGu != 0) return cudaErrorInvalidValue;
  const int M2 = 2 * D + 2;
  const int Kp = (M2 + kBK - 1) / kBK * kBK;
  const int col_tiles = (Kp + kBN - 1) / kBN;
  const int Nq = (col_tiles * kBN + kBK - 1) / kBK * kBK;
  const int g_tiles = (G + kBN - 1) / kBN;
  const int Gq = g_tiles * kBN;
  const int Gr = (Gq + kBK - 1) / kBK * kBK;
  const int64_t plane = static_cast<int64_t>(chunk) * Kp;
  float* W = workspace;
  float* Gu = W + plane;
  float* Qt = Gu + plane;
  float* Rt = Qt + static_cast<int64_t>(Nq) * Kp;
  float* kp = Rt + static_cast<int64_t>(Gr) * Kp;
  float* part_err = kp + Kp;
  float* part_obj = part_err + static_cast<int64_t>(chunk / kRowsLoo) * Gq;

  cudaError_t status = launch_split_transpose(Qs, M2, M2, Qt, Kp, Nq, 1, st);
  if (status != cudaSuccess) return status;
  status = launch_split_transpose(r_all, M2, G, Rt, Kp, Gr, 1, st);
  if (status != cudaSuccess) return status;
  if ((status = cudaMemsetAsync(kp, 0, Kp * sizeof(float), st)) != cudaSuccess) return status;
  status = cudaMemcpyAsync(kp, k, M2 * sizeof(float), cudaMemcpyDeviceToDevice, st);
  if (status != cudaSuccess) return status;
  CUtensorMap tmW, tmQ, tmGu, tmR, tmK;
  if ((status = make_box_map(&tmW, W, Kp, chunk, 1, kRowsGu)) != cudaSuccess) return status;
  if ((status = make_box_map(&tmQ, Qt, Kp, Nq, 1, kBN)) != cudaSuccess) return status;
  if ((status = make_box_map(&tmGu, Gu, Kp, chunk, 1, kRowsLoo)) != cudaSuccess) return status;
  if ((status = make_box_map(&tmR, Rt, Kp, Gr, 1, kBN)) != cudaSuccess) return status;
  if ((status = make_box_map(&tmK, kp, Kp, 1, 1, 1, CU_TENSOR_MAP_SWIZZLE_NONE)) != cudaSuccess) return status;
  const int smem_gu = pipe_smem_bytes<kRowsGu, kStagesGu, false>(0);
  const int smem_loo = pipe_smem_bytes<kRowsLoo, kStagesLoo, true>(kReduceBytes);
  status = cudaFuncSetAttribute(gu_1xtf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_gu);
  if (status != cudaSuccess) return status;
  status = cudaFuncSetAttribute(loo_1xtf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_loo);
  if (status != cudaSuccess) return status;
  // Persistent grids: a block an SM, at most one a tile.
  int dev = 0, sms = 0;
  if ((status = cudaGetDevice(&dev)) != cudaSuccess) return status;
  status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (status != cudaSuccess) return status;

  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int rows_pad = (rows + kRowsGu - 1) / kRowsGu * kRowsGu;
    status = launch_features(FeatureLayout::kSweepW, X, Mmap, bmap, s2, y, W, plane, 1, Kp, r0, n,
                             rows_pad, d, D, Kp, inv_sqrt_d, st);
    if (status != cudaSuccess) return status;
    const Tiles gu_tiles = {rows_pad / kRowsGu * col_tiles, col_tiles};
    gu_1xtf32_kernel<<<gu_tiles.count < sms ? gu_tiles.count : sms, sm90::kThreads, smem_gu, st>>>(
        tmW, tmQ, Gu, Kp, gu_tiles, Kp / kBK);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
    // Every row tile of the padded chunk, so that the first chunk writes every partial.
    const Tiles loo_tiles = {rows_pad / kRowsLoo * g_tiles, g_tiles};
    loo_1xtf32_kernel<<<loo_tiles.count < sms ? loo_tiles.count : sms, sm90::kThreads, smem_loo, st>>>(
        tmGu, tmR, tmK, part_err, part_obj, Gq, y, s, s2, r0, n, loo_tiles, Kp / kBK, is_classifier,
        inv_c0, r0 > 0);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
  }
  sweep_sum_kernel<<<(G + 255) / 256, 256, 0, st>>>(part_err, part_obj, Gq, chunk / kRowsLoo, G, err, obj);
  return cudaGetLastError();
}

}  // namespace neo
