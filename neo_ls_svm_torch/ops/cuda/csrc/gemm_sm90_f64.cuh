// The product loop under K1 and K2's f64 paths: a TMA + DMMA tile product on Hopper's
// FP64 tensor cores (sm_90a).
//
// Part of the port, in float64, of neo_ls_svm_tpu/ops/pallas/gram.py::fused_augmented_gram
// and neo_ls_svm_tpu/ops/pallas/sweep.py::fused_loo_sweep: it carries the dots of their
// kernel bodies (_gram_kernel, _sweep_kernel), which run in f64 under x64 off the TPU.
//
// It computes, for a 128 × BN output tile, C[m][n] = Σ_k A[m][k]·B[n][k] for NA operands A
// that share B, where A and B are float64 matrices stored K-major (k contiguous), in IEEE
// FP64: every product and sum of the FP64 tensor cores is a double-precision FMA, so the
// result is an f64 product in another order of summation, with no split and no bounded
// runs (gemm_sm90.cuh needs both for TF32).
//
// What bounds a product built from this loop: the FP64 tensor cores, 67 TFLOP/s dense on
// an H100 SXM, twice the 34 TFLOP/s of FP64 FMAs on the CUDA cores. wgmma has no f64 form;
// they are reached through the warp-level mma.sync.aligned.m16n8k16.row.col.f64 (PTX 7.8,
// sm_90), whose operands come from registers. So the loop is built to feed registers from
// shared memory fast enough:
//  * A ring of STAGES shared-memory stages. Each holds the NA A tiles (128 rows × 16
//    doubles) and the B tile (BN rows × 16 doubles), one 128-byte row per tile row, written
//    by TMA (CU_TENSOR_MAP_DATA_TYPE_FLOAT64, CU_TENSOR_MAP_SWIZZLE_128B). One producer
//    thread, in a warpgroup of its own that hands its registers to the consumers
//    (setmaxnreg 40 / 232), keeps the loads in flight: it waits for a stage's `empty`
//    mbarrier and arms its `full` one with the stage's byte count.
//  * Eight consumer warps tile the output: 2 × 4 warps of 64 × 32 for BN = 128, 4 × 2 warps
//    of 32 × 32 for BN = 64, so that a 128 × 64 tile holds two accumulators (K2's num and
//    lev) in the registers one 128 × 128 tile takes (64 doubles a thread). Per k-block a
//    warp loads 48 doubles a thread from shared memory for 16 DMMA (a 16 × 16 fragment of A
//    is 8 doubles a thread, a 16 × 8 one of B 4): about 0.4 bytes of shared memory a FMA,
//    a third of what the SM's shared memory can deliver at the DMMA rate.
//  * Bank conflicts: a fragment load reads, for one k index t + 4j of each of 4 lanes t,
//    8 rows g. The k indices of the product are a free permutation, as long as A and B
//    take the same one: lane t's index t + 4j is stored at column π = 2j + (t & 1) +
//    8(t >> 1) of the 16, which puts each half-warp's 16 doubles on 16 distinct bank pairs
//    under the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)).
//  * The consumer warps release a stage once their fragments are in registers; the output
//    order is fixed and there are no atomics: an epilogue reads each accumulator through
//    acc_row/acc_col and writes each element from one thread.
//  * A block may compute only part of its tile: the fragments whose first row is at or past
//    m_valid, or whose first column is at or past n_valid, are skipped and stay zero (K1's
//    last tile column holds the 1 and y features and zero padding, 2 of 128 columns).
//
// Padding is the callers' business: every operand is zero-padded to whole tiles (rows to
// the box, k to 16), so the loop has no masks.
#pragma once

#include <cuda.h>

#include "gemm_sm90.cuh"

namespace neo {
namespace sm90_f64 {

using sm90::consumer_registers;
using sm90::consumers_sync;
using sm90::encode_tiled;
using sm90::mbar_wait;
using sm90::producer_registers;
using sm90::smem_u32;

constexpr int kBM = 128;                    // output tile rows
constexpr int kBK = 16;                     // k-block: 16 f64 = one 128-byte swizzle row
constexpr int kConsumers = sm90::kConsumers;  // eight warps
constexpr int kThreads = sm90::kThreads;      // and a producer warpgroup (one thread works)
constexpr int kWarps = kConsumers / 32;

// The consumer warps' tiling of a 128 × BN output tile.
template <int BN>
struct Tiling {
  static_assert(BN == 128 || BN == 64, "a tile is 128 × 128 or 128 × 64");
  static constexpr int kWarpsN = BN == 128 ? 4 : 2;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;  // rows of a warp: 64 or 32
  static constexpr int kWN = BN / kWarpsN;   // columns of a warp: 32
  static constexpr int kMF = kWM / 16;       // m16 fragments of a warp
  static constexpr int kNF = kWN / 8;        // n8 fragments of a warp
};

template <int NA, int BN>
using Acc = double[NA][Tiling<BN>::kMF][Tiling<BN>::kNF][4];

template <int NA, int BN, int STAGES>
struct Pipe {
  double a[STAGES][NA][kBM * kBK];  // the NA operands' tiles
  double b[STAGES][BN * kBK];       // the shared B tile
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// Dynamic shared memory for a Pipe and `extra` bytes after it, with room to align.
template <int NA, int BN, int STAGES>
constexpr int pipe_smem_bytes(int extra) {
  return static_cast<int>(sizeof(Pipe<NA, BN, STAGES>)) + extra + 1024;
}

// The Pipe at the first 1024-byte boundary of dynamic shared memory (the swizzle atom's
// alignment), its barriers initialised. Every thread of the block calls it.
template <int NA, int BN, int STAGES>
__device__ __forceinline__ Pipe<NA, BN, STAGES>& pipe_setup() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  auto& p = *reinterpret_cast<Pipe<NA, BN, STAGES>*>(smem_raw + pad);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&p.full[s])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(&p.empty[s])), "n"(kWarps));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return p;
}

__device__ __forceinline__ void tma_load(double* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row), "r"(plane)
      : "memory");
}

// c += a·b for one 16 × 8 × 16 step on the FP64 tensor cores (fragments as in the PTX ISA:
// a_i at row g + 8(i & 1), k t + 4(i >> 1); b_i at k t + 4i, column g; c_i at row
// g + 8(i >> 1), column 2t + (i & 1), for lane 4g + t).
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Row and column, within the output tile, of this consumer thread's accumulator
// acc[.][mf][nf][i].
template <int BN>
__device__ __forceinline__ int acc_row(int mf, int i) {
  using T = Tiling<BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / T::kWarpsN) * T::kWM + 16 * mf + lane / 4 + 8 * (i >> 1);
}
template <int BN>
__device__ __forceinline__ int acc_col(int nf, int i) {
  using T = Tiling<BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % T::kWarpsN) * T::kWN + 8 * nf + 2 * (lane % 4) + (i & 1);
}

// The producer: k-blocks kb0 .. kb0+kblocks-1 of the A planes 0 .. NA-1 at row m0 and of
// B (plane 0) at row n0. One thread calls it.
template <int NA, int BN, int STAGES>
__device__ void produce(Pipe<NA, BN, STAGES>& p, const CUtensorMap* tmA, const CUtensorMap* tmB,
                        int m0, int n0, int kb0, int kblocks) {
  constexpr uint32_t kBytes = (NA * kBM + BN) * kBK * sizeof(double);
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&p.empty[stage], phase ^ 1);  // a fresh barrier passes the first round
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_u32(&p.full[stage])),
                 "r"(kBytes)
                 : "memory");
    const int k = (kb0 + kb) * kBK;
#pragma unroll
    for (int z = 0; z < NA; ++z) tma_load(p.a[stage][z], tmA, &p.full[stage], k, m0, z);
    tma_load(p.b[stage], tmB, &p.full[stage], k, n0, 0);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The consumers: acc[a] = Σ over the k-blocks of A_a·Bᵀ, skipping the fragments at or past
// m_valid rows and n_valid columns of the tile (they stay zero).
template <int NA, int BN, int STAGES>
__device__ void consume(Pipe<NA, BN, STAGES>& p, int kblocks, int m_valid, int n_valid,
                        Acc<NA, BN>& acc) {
  using T = Tiling<BN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int mf = 0; mf < T::kMF; ++mf)
#pragma unroll
      for (int nf = 0; nf < T::kNF; ++nf)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][mf][nf][i] = 0.0;
  // Offset, in a swizzled 128-byte row whose index is g modulo 8, of k index t + 4j: column
  // π = 2j + (t & 1) + 8(t >> 1), in 16-byte chunk π/2 = j + 4(t >> 1), stored at chunk
  // (π/2) ^ g. Every tile row a lane reads is g modulo 8.
  int col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col[j] = 2 * ((j + 4 * (t >> 1)) ^ g) + (t & 1);
  const int a_row = (wm * T::kWM + g) * kBK;
  const int b_row = (wn * T::kWN + g) * kBK;
  bool m_on[T::kMF], n_on[T::kNF];
#pragma unroll
  for (int mf = 0; mf < T::kMF; ++mf) m_on[mf] = wm * T::kWM + 16 * mf < m_valid;
#pragma unroll
  for (int nf = 0; nf < T::kNF; ++nf) n_on[nf] = wn * T::kWN + 8 * nf < n_valid;

  int stage = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&p.full[stage], phase);
    const double* B = p.b[stage] + b_row;
    double bf[T::kNF][4];
#pragma unroll
    for (int nf = 0; nf < T::kNF; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) bf[nf][i] = B[8 * nf * kBK + col[i]];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int mf = 0; mf < T::kMF; ++mf) {
        if (!m_on[mf]) continue;
        const double* A = p.a[stage][a] + a_row + 16 * mf * kBK;
        double af[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) af[i] = A[8 * (i & 1) * kBK + col[i >> 1]];
#pragma unroll
        for (int nf = 0; nf < T::kNF; ++nf)
          if (n_on[nf]) dmma(acc[a][mf][nf], af, bf[nf]);
      }
    }
    __syncwarp();
    if (lane == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(&p.empty[stage]))
                   : "memory");
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// ---- host side ----

// The TMA map of `planes` K-major f64 matrices of rows × ld doubles, back to back at base,
// read in box_rows-row × 16-double boxes with the 128-byte swizzle. ld is a multiple of 16
// and rows of box_rows (whole tiles), so no box reaches past the data.
inline cudaError_t make_tile_map(CUtensorMap* map, const double* base, int64_t ld, int64_t rows,
                                 int planes, int box_rows) {
  const sm90::EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * sizeof(double),
                                 static_cast<cuuint64_t>(ld * rows) * sizeof(double)};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<double*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90_f64
}  // namespace neo
