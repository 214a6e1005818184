// K2 (float64): fused leave-one-out γ-sweep, on Hopper's FP64 tensor cores (sm_90a). The
// float32 path is sweep.cu.
//
// Replaces, in float64, the TPU kernel neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep
// (kernel body _sweep_kernel; float64 has no reduced-precision path, so both of its
// mxu_precision settings land here). For every row i and every γ_g of the grid it evaluates
//
//     W_i  = [cos U_i/√D, 1, sin U_i/√D, 0],   U_i = x_i·M + b,   Gu_i = W_i·Qs
//     num  = (1/c₀)·Σ_j Gu_ij·k_j·r_jg,        lev = (1/c₀)·s²_i·Σ_j Gu_ij²·r_jg
//     e_ig = (num − y_i)/(1 − lev), zeroed where a classifier is confidently right,
//
// and returns err_g = Σ_i s_i·|e_ig| and the objective: err_g, plus for a classifier
// Σ_i s_i·[|e_ig| ≥ 1] + Σ_i s_i·max(0, |e_ig| − 1). Every float64 fit that streams (from
// 261,633 rows at D = 512) launches it once.
//
// What bounds it on this card: operations, on the FP64 tensor cores. With 2M = 2D+2 basis
// columns and G values of γ it does 2·n·(2M)² FLOP for Gu and 4·n·2M·G for num and lev:
// 6.6 TFLOP at n = 1,048,576, 2M = 1026, G = 1024, about 99 ms at 67 TFLOP/s. The chunks'
// W, Gu∘k and Gu∘Gu, written once and read once, are about 16 ms of bytes at 3.35 TB/s.
//
// What the design does about it (the structure of sweep.cu, in f64; per row chunk):
//  (a) features.cu writes the chunk's W, row-major, in one f64 plane.
//  (b) The product loop of gemm_sm90_f64.cuh (TMA + DMMA) computes Gu = W·Qs as 128×128
//      tiles against Qsᵀ (transposed once per call). Its epilogue writes Gu∘k and Gu∘Gu,
//      row-major: the A operands of (c). They pass through a workspace in device memory
//      bounded by the chunk, not through shared memory, so any D fits.
//  (c) The product loop computes num and lev as two accumulators of 128 rows × 64 values
//      of γ that share each B tile of r_allᵀ (transposed once per call). Its epilogue forms
//      e, the classifier clip and the weighted sums over the tile's 128 rows (warp
//      shuffles, then the 4 row warps in order through shared memory), and adds them into
//      the partials of its (row tile, γ).
//  A last kernel adds the row tiles' partials in a fixed order. Qs and r_all are read once
//  per 128-row tile, and there are no atomics: the argmin over a flat objective cannot
//  flip between runs. Padding is zero (k to 16, rows to 128, basis columns to 128, γ to
//  64), so the products need no masks; rows past n are left out of the sums and γ past G
//  is never read.

#include "features.cuh"
#include "gemm_sm90_f64.cuh"

namespace {

using namespace neo::sm90_f64;

constexpr int kBNGu = 128;
constexpr int kBNLoo = 64;
constexpr int kStagesGu = 6;   // 32 KB each
constexpr int kStagesLoo = 5;  // 40 KB each
using LooTiling = Tiling<kBNLoo>;
constexpr int kReduceBytes = LooTiling::kWarpsM * kBNLoo * 2 * sizeof(double);

// (b): GG planes at leading dimension ldk: 0 = Gu∘k, 1 = Gu∘Gu.
__global__ void __launch_bounds__(kThreads, 1)
    sweep_gu_f64_kernel(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmQ,
                        double* __restrict__ GG, int64_t plane, int ldk, const double* __restrict__ k,
                        int M2, int n_tiles, int kblocks) {
  auto& p = pipe_setup<1, kBNGu, kStagesGu>();
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBNGu;
  if (threadIdx.x >= kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers) produce<1, kBNGu, kStagesGu>(p, &tmW, &tmQ, m0, n0, 0, kblocks);
  } else {
    consumer_registers();
    Acc<1, kBNGu> acc;
    consume<1, kBNGu, kStagesGu>(p, kblocks, kBM, M2 - n0, acc);
    using T = Tiling<kBNGu>;
#pragma unroll
    for (int mf = 0; mf < T::kMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < T::kNF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = n0 + acc_col<kBNGu>(nf, i);
          if (c < ldk) {
            const double gu = acc[0][mf][nf][i];
            double* o = GG + static_cast<int64_t>(m0 + acc_row<kBNGu>(mf, i)) * ldk + c;
            o[0] = gu * (c < M2 ? k[c] : 0.0);
            o[plane] = gu * gu;
          }
        }
  }
}

// (c): the residuals of 128 rows × 64 values of γ and their weighted sums over the rows:
// rows row0 + (0..127) of the chunk's row tile mt, γ columns n0 + (0..63).
__global__ void __launch_bounds__(kThreads, 1)
    sweep_loo_f64_kernel(const __grid_constant__ CUtensorMap tmGG, const __grid_constant__ CUtensorMap tmR,
                         double* __restrict__ part_err, double* __restrict__ part_obj, int ldp,
                         const double* __restrict__ y, const double* __restrict__ s,
                         const double* __restrict__ s2, int64_t r0, int64_t n, int g_tiles, int G,
                         int kblocks, int is_classifier, double inv_c0, int accumulate) {
  auto& p = pipe_setup<2, kBNLoo, kStagesLoo>();
  double* red = reinterpret_cast<double*>(&p + 1);  // [row warp][column][err, obj]
  const int mt = blockIdx.x / g_tiles;
  const int m0 = mt * kBM;
  const int n0 = (blockIdx.x % g_tiles) * kBNLoo;
  if (threadIdx.x >= kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers) produce<2, kBNLoo, kStagesLoo>(p, &tmGG, &tmR, m0, n0, 0, kblocks);
    return;
  }
  consumer_registers();
  Acc<2, kBNLoo> acc;
  consume<2, kBNLoo, kStagesLoo>(p, kblocks, kBM, G - n0, acc);
  using T = LooTiling;
  // This thread's four rows (mf, h: acc_row(mf, 2h)), masked past n.
  bool valid[T::kMF][2];
  double yv[T::kMF][2], sv[T::kMF][2], s2v[T::kMF][2];
#pragma unroll
  for (int mf = 0; mf < T::kMF; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + m0 + acc_row<kBNLoo>(mf, 2 * h);
      valid[mf][h] = row < n;
      yv[mf][h] = valid[mf][h] ? y[row] : 0.0;
      sv[mf][h] = valid[mf][h] ? s[row] : 0.0;
      s2v[mf][h] = valid[mf][h] ? s2[row] : 0.0;
    }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::kWarpsN;
#pragma unroll
  for (int nf = 0; nf < T::kNF; ++nf) {
    double err[2] = {0.0, 0.0}, obj[2] = {0.0, 0.0};  // columns acc_col(nf, c), c = 0, 1
#pragma unroll
    for (int mf = 0; mf < T::kMF; ++mf)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, c = i & 1;
        if (valid[mf][h]) {
          const double num = inv_c0 * acc[0][mf][nf][i];
          const double lev = inv_c0 * s2v[mf][h] * acc[1][mf][nf][i];
          double e = (num - yv[mf][h]) / (1.0 - lev);
          if (is_classifier && ((yv[mf][h] > 0.0 && e > 0.0) || (yv[mf][h] < 0.0 && e < 0.0))) e = 0.0;
          const double ae = fabs(e);
          const double t = sv[mf][h] * ae;
          err[c] += t;
          obj[c] += is_classifier ? t + sv[mf][h] * (ae >= 1.0 ? 1.0 : 0.0) + sv[mf][h] * fmax(0.0, ae - 1.0) : t;
        }
      }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {  // the 8 lanes of a column
        err[c] += __shfl_xor_sync(0xffffffffu, err[c], off);
        obj[c] += __shfl_xor_sync(0xffffffffu, obj[c], off);
      }
      if (lane < 4) {
        double* r = red + (wm * kBNLoo + acc_col<kBNLoo>(nf, c)) * 2;
        r[0] = err[c];
        r[1] = obj[c];
      }
    }
  }
  consumers_sync();
  if (threadIdx.x < kBNLoo) {
    double e = 0.0, o = 0.0;
    for (int w = 0; w < T::kWarpsM; ++w) {
      e += red[(w * kBNLoo + threadIdx.x) * 2];
      o += red[(w * kBNLoo + threadIdx.x) * 2 + 1];
    }
    const int64_t at = static_cast<int64_t>(mt) * ldp + n0 + threadIdx.x;
    if (accumulate) {
      e += part_err[at];
      o += part_obj[at];
    }
    part_err[at] = e;
    part_obj[at] = o;
  }
}

// err[g], obj[g] = Σ over the row tiles, in order.
__global__ void sweep_sum_f64_kernel(const double* __restrict__ part_err,
                                     const double* __restrict__ part_obj, int ldp, int row_tiles,
                                     int G, double* __restrict__ err, double* __restrict__ obj) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  double e = 0.0, o = 0.0;
  for (int t = 0; t < row_tiles; ++t) {
    e += part_err[static_cast<int64_t>(t) * ldp + g];
    o += part_obj[static_cast<int64_t>(t) * ldp + g];
  }
  err[g] = e;
  obj[g] = o;
}

}  // namespace

extern "C" {

// The workspace (doubles), for Kp = 2M rounded up to 16, Np = 2M rounded up to 128 and
// Gp = G rounded up to 64: W (chunk·Kp), Gu∘k and Gu∘Gu (2·chunk·Kp), Qsᵀ (Np·Kp), r_allᵀ
// (Gp·Kp), then the err and obj partials (2·(chunk/128)·Gp); the wrapper's plan sizes it.
// chunk is a multiple of 128 and at most the first chunk's rows rounded up to 128.
int neo_sweep_f64(const void* X, const void* Mmap, const void* bmap, const void* y,
                  const void* s, const void* s2, const void* Qs, const void* r_all,
                  const void* k, void* err, void* obj, void* workspace, int64_t n, int d, int D,
                  int G, int chunk, int is_classifier, double inv_sqrt_d, double inv_c0,
                  void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int M2 = 2 * D + 2;
  const int Kp = (M2 + kBK - 1) / kBK * kBK;
  const int Np = (M2 + kBNGu - 1) / kBNGu * kBNGu;
  const int Gp = (G + kBNLoo - 1) / kBNLoo * kBNLoo;
  const int64_t plane = static_cast<int64_t>(chunk) * Kp;
  double* W = static_cast<double*>(workspace);
  double* GG = W + plane;
  double* Qt = GG + 2 * plane;
  double* Rt = Qt + static_cast<int64_t>(Np) * Kp;
  double* part_err = Rt + static_cast<int64_t>(Gp) * Kp;
  double* part_obj = part_err + static_cast<int64_t>(chunk / kBM) * Gp;

  cudaError_t status = neo::launch_transpose(static_cast<const double*>(Qs), M2, M2, Qt, Kp, Np, st);
  if (status != cudaSuccess) return status;
  status = neo::launch_transpose(static_cast<const double*>(r_all), M2, G, Rt, Kp, Gp, st);
  if (status != cudaSuccess) return status;
  CUtensorMap tmW, tmQ, tmGG, tmR;
  if ((status = make_tile_map(&tmW, W, Kp, chunk, 1, kBM)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmQ, Qt, Kp, Np, 1, kBNGu)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmGG, GG, Kp, chunk, 2, kBM)) != cudaSuccess) return status;
  if ((status = make_tile_map(&tmR, Rt, Kp, Gp, 1, kBNLoo)) != cudaSuccess) return status;
  const int smem_gu = pipe_smem_bytes<1, kBNGu, kStagesGu>(0);
  const int smem_loo = pipe_smem_bytes<2, kBNLoo, kStagesLoo>(kReduceBytes);
  status = cudaFuncSetAttribute(sweep_gu_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_gu);
  if (status != cudaSuccess) return status;
  status = cudaFuncSetAttribute(sweep_loo_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_loo);
  if (status != cudaSuccess) return status;

  const auto* y_ = static_cast<const double*>(y);
  const auto* s_ = static_cast<const double*>(s);
  const auto* s2_ = static_cast<const double*>(s2);
  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(n - r0 < chunk ? n - r0 : chunk);
    const int row_tiles = (rows + kBM - 1) / kBM;
    status = neo::launch_features(neo::FeatureLayout::kSweepW, static_cast<const double*>(X),
                                  static_cast<const double*>(Mmap), static_cast<const double*>(bmap),
                                  s2_, y_, W, Kp, r0, n, row_tiles * kBM, d, D, Kp, inv_sqrt_d, st);
    if (status != cudaSuccess) return status;
    sweep_gu_f64_kernel<<<row_tiles * (Np / kBNGu), kThreads, smem_gu, st>>>(
        tmW, tmQ, GG, plane, Kp, static_cast<const double*>(k), M2, Np / kBNGu, Kp / kBK);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
    sweep_loo_f64_kernel<<<row_tiles * (Gp / kBNLoo), kThreads, smem_loo, st>>>(
        tmGG, tmR, part_err, part_obj, Gp, y_, s_, s2_, r0, n, Gp / kBNLoo, G, Kp / kBK,
        is_classifier, inv_c0, r0 > 0);
    if ((status = cudaGetLastError()) != cudaSuccess) return status;
  }
  sweep_sum_f64_kernel<<<(G + 255) / 256, 256, 0, st>>>(part_err, part_obj, Gp, chunk / kBM, G,
                                                        static_cast<double*>(err), static_cast<double*>(obj));
  return cudaGetLastError();
}

}  // extern "C"
