// The parts of K2's float32 sweep that follow its products, shared by the 3×TF32 path
// (sweep.cu, 128 values of γ a tile) and the one-pass path (sweep_1xtf32.cu, 176): the
// residual epilogue of a tile and the fixed-order sum of the row tiles' partials.
#pragma once

#include "gemm_sm90.cuh"

namespace neo {
namespace sweep_f32 {

using sm90::acc_row;
using sm90::kConsumers;

constexpr int kWarps = kConsumers / 32;

// Bytes of the epilogue's shared buffer for a tile of BN values of γ.
template <int BN>
constexpr int reduce_bytes() {
  return kWarps * BN * 2 * sizeof(float);
}

// The epilogue of a sweep tile, for the consumer threads: acc[0] = Σ_j (Gu∘k)_ij·r_jg and
// acc[1] = Σ_j (Gu∘Gu)_ij·r_jg for rows row0 + (0..127) of the chunk's row tile mt, γ columns
// n0 + (0..BN-1), in the m64nBNk8 accumulator layout of two consumer warpgroups. It forms
// e, the classifier clip and the weighted sums over the tile's 128 rows (warp shuffles,
// then the 8 warps in order through shared memory), and adds them into the partials of its
// (row tile, γ). The caller keeps `red` free: a persistent block synchronises its
// consumers before it reuses it.
template <int BN>
__device__ __forceinline__ void loo_epilogue(const float (&acc)[2][BN / 2], float* red,
                                             float* __restrict__ part_err,
                                             float* __restrict__ part_obj, int ldp,
                                             const float* __restrict__ y,
                                             const float* __restrict__ s,
                                             const float* __restrict__ s2, int64_t row0,
                                             int64_t n, int mt, int n0, int is_classifier,
                                             float inv_c0, int accumulate) {
  constexpr int kAcc = BN / 2;
  // This thread's two rows (h = 0, 1: acc_row(2h)), masked past n.
  bool valid[2];
  float yv[2], sv[2], s2v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t g = row0 + acc_row(2 * h);
    valid[h] = g < n;
    yv[h] = valid[h] ? y[g] : 0.0f;
    sv[h] = valid[h] ? s[g] : 0.0f;
    s2v[h] = valid[h] ? s2[g] : 0.0f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int jg = 0; jg < kAcc / 4; ++jg) {  // columns 8·jg + 2·(lane % 4) + {0, 1}
    float err[2] = {0.0f, 0.0f}, obj[2] = {0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * jg + q, h = q >> 1, c = q & 1;
      if (valid[h]) {
        const float num = inv_c0 * acc[0][i];
        const float lev = inv_c0 * s2v[h] * acc[1][i];
        float e = (num - yv[h]) / (1.0f - lev);
        if (is_classifier && ((yv[h] > 0.0f && e > 0.0f) || (yv[h] < 0.0f && e < 0.0f))) e = 0.0f;
        const float ae = fabsf(e);
        const float t = sv[h] * ae;
        err[c] += t;
        obj[c] += is_classifier ? t + sv[h] * (ae >= 1.0f ? 1.0f : 0.0f) + sv[h] * fmaxf(0.0f, ae - 1.0f) : t;
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
        float* r = red + (warp * BN + 8 * jg + 2 * lane + c) * 2;
        r[0] = err[c];
        r[1] = obj[c];
      }
    }
  }
  sm90::consumers_sync();
  if (threadIdx.x < BN) {
    float e = 0.0f, o = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      e += red[(w * BN + threadIdx.x) * 2];
      o += red[(w * BN + threadIdx.x) * 2 + 1];
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

// err[g], obj[g] = Σ over the row tiles, in order (one copy in each source that includes
// this header).
static __global__ void sweep_sum_kernel(const float* __restrict__ part_err,
                                        const float* __restrict__ part_obj, int ldp,
                                        int row_tiles, int G, float* __restrict__ err,
                                        float* __restrict__ obj) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  float e = 0.0f, o = 0.0f;
  for (int t = 0; t < row_tiles; ++t) {
    e += part_err[static_cast<int64_t>(t) * ldp + g];
    o += part_obj[static_cast<int64_t>(t) * ldp + g];
  }
  err[g] = e;
  obj[g] = o;
}

}  // namespace sweep_f32
}  // namespace neo
