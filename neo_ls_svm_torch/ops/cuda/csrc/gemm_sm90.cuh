// The product loop under K1 and K2's 3×TF32 paths: a TMA + wgmma TF32 tile product for
// Hopper (sm_90a). K2's one-pass path has a loop of its own, gemm_sm90_1xtf32.cuh, which
// shares this file's TMA, descriptor and register helpers.
//
// It computes, for a 128×128 output tile, C[m][n] = Σ_k A[m][k]·B[n][k] where A and B
// are float32 matrices stored K-major (k contiguous), each already split into a TF32 high
// part and a TF32 low part, a = a_hi + a_lo (store_split in common.cuh). Every product is
//
//     a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
//
// three tensor-core passes accumulated in f32 ("3×TF32"): about 21-22 bits of each
// operand, the Hopper counterpart of the Pallas kernels' multi-pass precision=HIGHEST on
// the MXU.
//
// What bounds a product built from this loop: the tensor cores' TF32 rate, 495 TFLOP/s
// dense on an H100 SXM, so 165 TFLOP/s of f32-equivalent product. The loop feeds the
// tensor cores like this:
//  * A ring of STAGES shared-memory stages. Each stage holds the hi and lo planes of NA
//    operands A that share the B tile, and the B tile's planes, 128
//    rows × 32 floats each: one 128-byte swizzle row per tile row, written by TMA with
//    CU_TENSOR_MAP_SWIZZLE_128B, which is the layout wgmma's 128-byte-swizzled K-major
//    descriptors read.
//  * One producer thread (in a warpgroup of its own) keeps TMA loads in flight; it waits
//    for a stage to be released (the `empty` mbarrier) and arms the `full` mbarrier with
//    the stage's byte count (complete_tx). The producer warpgroup hands its registers to
//    the consumers (setmaxnreg): a consumer thread may hold 232, which two accumulators
//    and a run buffer (3·64) need. Without it each of 9 or 12 warps gets at most 168.
//  * Two consumer warpgroups, rows 0-63 and 64-127 of the tile, issue
//    wgmma.m64n128k8.f32.tf32.tf32 on the stage: four k-steps of 8, three products each,
//    for each of the NA accumulators.
//  * Accumulation runs are bounded. The tensor cores' f32 accumulation need not round to
//    nearest, so its error grows with the run's length: on an H100, one run over K2's
//    whole contraction (2M = 3602) left the sweep many times further from float64 than
//    the f32 plain version. So every k-block of 32 (12 products) starts a fresh wgmma
//    accumulator, which is then added into a register sum in IEEE f32.
//  * The output order is fixed and there are no atomics: a caller's epilogue reads the
//    accumulators through acc_row/acc_col and writes each element from one thread.
//
// Padding is the callers' business: every operand is zero-padded to whole tiles (rows to
// 128, k to 32), so the loop has no masks.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace neo {
namespace sm90 {

constexpr int kBM = 128;                 // output tile rows: two consumer warpgroups
constexpr int kBN = 128;                 // output tile columns
constexpr int kBK = 32;                  // k-block: 32 f32 = one 128-byte swizzle row
constexpr int kTileFloats = kBM * kBK;   // one operand tile, 16 KB (kBM == kBN)
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup (one thread works)
constexpr int kAcc = kBN / 2;            // accumulator registers per thread (m64n128)

constexpr int kPlanes = 2;               // TF32 planes of every operand: hi and lo

template <int NA, int STAGES>
struct Pipe {
  float a[STAGES][kPlanes * NA][kTileFloats];  // the planes of each of the NA operands
  float b[STAGES][kPlanes][kTileFloats];       // the planes of B
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// Dynamic shared memory for a Pipe and `extra` bytes after it, with room to align.
template <int NA, int STAGES>
constexpr int pipe_smem_bytes(int extra) {
  return static_cast<int>(sizeof(Pipe<NA, STAGES>)) + extra + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The Pipe at the first 1024-byte boundary of dynamic shared memory (the swizzle atom's
// alignment), its barriers initialised. Every thread of the block calls it.
template <int NA, int STAGES>
__device__ __forceinline__ Pipe<NA, STAGES>& pipe_setup() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  auto& p = *reinterpret_cast<Pipe<NA, STAGES>*>(smem_raw + pad);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&p.full[s])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;" ::"r"(smem_u32(&p.empty[s])));
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return p;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, uint64_t* bar,
                                         int k, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row), "r"(plane)
      : "memory");
}

// wgmma descriptor of a K-major tile in 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO), layout type 1 (B128). A k-step of 8 f32 (32 bytes) inside the
// swizzle row advances the start address by 2 (16-byte units).
__device__ __forceinline__ uint64_t desc_b128(const float* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// d (+)= A·Bᵀ for one 64×128×8 step; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators across a wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Row and column, within the 128×128 tile, of this consumer thread's accumulator i
// (the m64nNk8 f32 layout: warp w of the two warpgroups owns rows 16w..16w+15).
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1); }

// The producer: k-blocks kb0 .. kb0+kblocks-1 of the A planes 0 .. 2·NA-1 at row m0 and
// of the B planes 0, 1 at row n0. One thread calls it.
template <int NA, int STAGES>
__device__ void produce(Pipe<NA, STAGES>& p, const CUtensorMap* tmA, const CUtensorMap* tmB,
                        int m0, int n0, int kb0, int kblocks) {
  constexpr int P = kPlanes;
  constexpr uint32_t kBytes = (P * NA + P) * kTileFloats * sizeof(float);
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
    for (int z = 0; z < P * NA; ++z) tma_load(p.a[stage][z], tmA, &p.full[stage], k, m0, z);
#pragma unroll
    for (int z = 0; z < P; ++z) tma_load(p.b[stage][z], tmB, &p.full[stage], k, n0, z);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The consumers: acc[a] = Σ over the k-blocks of A_a·Bᵀ in 3×TF32, for this thread's
// accumulator registers. Each k-block of each operand is one wgmma run of 12 products into
// `run`, which is then added into acc in IEEE f32. The NA operands take turns on the one
// run buffer, so two accumulators cost 3·64 registers, not 4·64.
template <int NA, int STAGES>
__device__ void consume(Pipe<NA, STAGES>& p, int kblocks, float (&acc)[NA][kAcc]) {
  constexpr int P = kPlanes;
  const int wg_row = (threadIdx.x / 128) * 64 * kBK;  // this warpgroup's 64 rows of A
  float run[kAcc];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[a][i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&p.full[stage], phase);
    const uint64_t b_hi = desc_b128(p.b[stage][0]);
    const uint64_t b_lo = desc_b128(p.b[stage][1]);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      fence_acc(run);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint64_t a_hi = desc_b128(p.a[stage][P * a] + wg_row) + 2 * kk;
        const uint64_t a_lo = desc_b128(p.a[stage][P * a + 1] + wg_row) + 2 * kk;
        wgmma_tf32(run, a_lo, b_hi + 2 * kk, kk > 0);  // the small terms first; the run's
        wgmma_tf32(run, a_hi, b_lo + 2 * kk, 1);       // first product overwrites
        wgmma_tf32(run, a_hi, b_hi + 2 * kk, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_acc(run);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[a][i] += run[i];
    }
    if (threadIdx.x % 128 == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(&p.empty[stage]))
                   : "memory");
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Register budgets of the two roles (a warp of each warpgroup shares an SM sub-partition's
// 16,384 registers: 232 + 232 + 40 lanes' worth fit). Each warpgroup calls its own once,
// first thing in its branch of the kernel.
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
}

// Synchronises the two consumer warpgroups only (the producer warpgroup may be done).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, fetched through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The TMA map of `planes` K-major f32 matrices of rows × ld floats, back to back at base,
// read in 128-row × 32-float boxes with the 128-byte swizzle. ld is a multiple of 32 and
// rows of 128 (whole tiles), so no box reaches past the data.
inline cudaError_t make_tile_map(CUtensorMap* map, const float* base, int64_t ld, int64_t rows,
                                 int planes) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * sizeof(float),
                                 static_cast<cuuint64_t>(ld * rows) * sizeof(float)};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace neo
