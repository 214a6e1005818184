// The product loop under K2's one-pass TF32 path (precision="fast"): a persistent TMA +
// wgmma tile product for Hopper (sm_90a), built for one pass's arithmetic intensity.
// gemm_sm90.cuh is the 3×TF32 loop; this one shares its TMA, descriptor and register
// helpers and nothing of its schedule.
//
// It computes C[m][n] = Σ_k A[m][k]·B[n][k] for two products that share each B tile, where
// B is a K-major (k contiguous) float32 matrix that holds TF32 values (its caller stores
// tf32_rna(v), common.cuh), and A is either such a matrix too (consume) or formed from
// one in registers by the consumer threads (consume_rs: K2's Gu∘k and Gu∘Gu, made from Gu
// and rounded to TF32 there). Every product is one TF32 pass, the counterpart of one MXU
// pass under precision=DEFAULT.
//
// What bounds it: the tensor cores' TF32 rate, 495 TFLOP/s dense on an H100 SXM. One pass
// does a third of 3×TF32's tensor work on half its bytes, so its tiles must arrive three
// times as fast per operation; on the card (NVIDIA H100 80GB HBM3) the depth of the ring,
// the bytes that shared memory moves per k-block, and the instructions between one wgmma
// group and the next bound it before L2 does. The design:
//  * Wide tiles. A stage holds ROWS_A rows of A and 176 rows of B (one 128-byte swizzle row
//    each) for two 64 × 176 products a consumer warpgroup: 256 rows of W for Gu (54 KB for
//    2.9 MFLOP, 53 FLOP a byte where gemm_sm90.cuh's 128 × 128 tile has 32), or 128 rows
//    of Gu for the sweep (38 KB, with the 32 values of k for the k-block: 76 FLOP a byte).
//    176 = 1056/6 divides the padded width of K2's Gu at D = 512 (2M = 1026, k padded to
//    1056), so no column tile is mostly padding; m64n176k8 is a TF32 wgmma.
//  * One accumulation run per tile. The one-pass operands carry 11 significant bits, so the
//    rounding of the tensor cores' f32 accumulation (not to nearest, about 2^-23 a step)
//    is far below theirs: the whole contraction accumulates in the wgmma registers, with
//    no run buffer and no IEEE add per k-block. Two 64 × 176 accumulators a warpgroup are
//    176 of the 232 registers that setmaxnreg gives a consumer thread.
//  * wgmma groups in flight. The consumers commit a group (a k-block with A in shared
//    memory, a k-step with A in registers) and wait for the one before it (wait_group 1),
//    then release that group's stage: the tensor cores never drain inside a tile.
//  * Persistent blocks. A block per SM walks output tiles blockIdx.x, + gridDim.x, ...; the
//    producer runs ahead into the next tile's k-blocks while the consumers run the
//    epilogue of the last one.
//  * No clusters: with two blocks sharing A by TMA multicast the sweep product ran slower
//    on the card in every form tried (PERF.md §6): each stage then waits on both
//    blocks' consumers.
//  * The output order is fixed and there are no atomics: an epilogue reads each
//    accumulator through its row and column (the m64nNk8 layout: warp w of a warpgroup
//    holds rows 16w .. 16w + 15) and writes each element from one thread.
// Padding is the callers' business: operands are zero-padded to whole tiles (rows of A to
// ROWS_A, rows of B to 176, k to 32), so the loop has no masks.
#pragma once

#include "gemm_sm90.cuh"

namespace neo {
namespace one_pass {

using sm90::desc_b128;
using sm90::kBK;
using sm90::kConsumers;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::tma_load;

constexpr int kBN = 176;        // rows of B a stage holds: the output tile's columns
constexpr int kAcc = kBN / 2;   // accumulator registers of one m64n176 product a thread

// A stage holds ROWS_A rows of A and 176 of B, one 128-byte row each (ROWS_A = 256 for
// K2's Gu product, 128 for its sweep; both tiles are whole 1024-byte swizzle atoms), and
// with SIDE the k-block's 32 values of a vector (the sweep's k).
template <int ROWS_A, int STAGES, bool SIDE>
struct Pipe {
  static constexpr uint32_t kStageBytes = ((ROWS_A + kBN) * kBK + (SIDE ? kBK : 0)) * sizeof(float);
  float a[STAGES][ROWS_A * kBK];
  float b[STAGES][kBN * kBK];
  float side[STAGES][SIDE ? kBK : 1];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
};

// Dynamic shared memory for a Pipe and `extra` bytes after it, with room to align.
template <int ROWS_A, int STAGES, bool SIDE>
constexpr int pipe_smem_bytes(int extra) {
  return static_cast<int>(sizeof(Pipe<ROWS_A, STAGES, SIDE>)) + extra + 1024;
}

// A position in the ring. The producer and each consumer walk the same stages, across tiles.
template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The output tiles of a launch: tile t is row tile t / col_tiles and column tile
// t % col_tiles.
struct Tiles {
  int count;
  int col_tiles;
};

// The Pipe at the first 1024-byte boundary of dynamic shared memory (the swizzle atom's
// alignment), its barriers initialised. Every thread of the block calls it.
template <int ROWS_A, int STAGES, bool SIDE>
__device__ __forceinline__ Pipe<ROWS_A, STAGES, SIDE>& pipe_setup() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  auto& p = *reinterpret_cast<Pipe<ROWS_A, STAGES, SIDE>*>(smem_raw + pad);
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

// Keeps the compiler from moving reads or writes of the accumulators across a wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A·Bᵀ for one 64×176×8 step (TF32 operands, f32 accumulator).
__device__ __forceinline__ void wgmma_n176(float (&d)[kAcc], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87}, "
      "%88, %89, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "l"(da), "l"(db), "r"(1));
}

// d += A·Bᵀ for one 64×176×8 step with A from registers: this thread's four TF32 values of
// the warpgroup's 64 × 8 A tile, a[0] = (r, c), a[1] = (r + 8, c), a[2] = (r, c + 4),
// a[3] = (r + 8, c + 4) for r = 16·warp + lane/4, c = lane % 4. They must not change until
// the wgmma has retired.
__device__ __forceinline__ void wgmma_n176_rs(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87}, "
      "{%88, %89, %90, %91}, %92, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Keeps the compiler from reusing the registers of an A fragment before a wgmma has read it.
__device__ __forceinline__ void fence_fragment(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The producer, one thread: for each of the block's tiles, every k-block of A (ROWS_A rows
// at its row tile), of B (176 rows at its column tile) and with SIDE of the vector (tmSide,
// one row).
template <int ROWS_A, int STAGES, bool SIDE>
__device__ void produce(Pipe<ROWS_A, STAGES, SIDE>& p, const CUtensorMap* tmA, const CUtensorMap* tmB,
                        const CUtensorMap* tmSide, Tiles tiles, int kblocks) {
  Ring<STAGES> ring;
  for (int t = blockIdx.x; t < tiles.count; t += gridDim.x) {
    const int m0 = (t / tiles.col_tiles) * ROWS_A;
    const int n0 = (t % tiles.col_tiles) * kBN;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&p.empty[ring.stage], ring.phase ^ 1);  // a fresh barrier passes the first round
      uint64_t* full = &p.full[ring.stage];
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(full)),
                   "r"(Pipe<ROWS_A, STAGES, SIDE>::kStageBytes)
                   : "memory");
      const int k = kb * kBK;
      tma_load(p.a[ring.stage], tmA, full, k, m0, 0);
      tma_load(p.b[ring.stage], tmB, full, k, n0, 0);
      if constexpr (SIDE) tma_load(p.side[ring.stage], tmSide, full, k, 0, 0);
      ring.advance();
    }
  }
}

// Releases a stage to the producer: one thread a consumer warpgroup arrives.
template <int ROWS_A, int STAGES, bool SIDE>
__device__ __forceinline__ void release(Pipe<ROWS_A, STAGES, SIDE>& p, int stage) {
  if (threadIdx.x % 128 == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(&p.empty[stage]))
                 : "memory");
  }
}

// The consumers, for one tile: acc[j] = Σ over the k-blocks of A_j·Bᵀ for this thread's
// registers, where operands(stage, kb, da0, da1) gives the wgmma descriptors of the
// warpgroup's two 64-row A operands in the stage (and may first write them to shared
// memory). One wgmma group a k-block, one group left in flight: a stage is released once
// the group after it has been issued and its own has retired.
template <int ROWS_A, int STAGES, typename Operands>
__device__ void consume(Pipe<ROWS_A, STAGES, false>& p, Ring<STAGES>& ring, int kblocks,
                        float (&acc)[2][kAcc], Operands operands) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[j][i] = 0.0f;
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  int last = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&p.full[ring.stage], ring.phase);
    uint64_t da0, da1;
    operands(ring.stage, kb, da0, da1);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint64_t db = desc_b128(p.b[ring.stage]);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_n176(acc[0], da0 + 2 * kk, db + 2 * kk);
      wgmma_n176(acc[1], da1 + 2 * kk, db + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    if (kb > 0) release(p, last);
    last = ring.stage;
    ring.advance();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  release(p, last);
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// The consumers, for one tile, with A from registers: acc[j] = Σ over the k-blocks of
// A_j·Bᵀ, where fragments(stage, kk, a0, a1) writes this thread's TF32 values of the
// warpgroup's two 64 × 8 A operands for k-step kk of the stage (wgmma_n176_rs). One wgmma
// group a k-step, one group left in flight: the fragments alternate between two register
// sets, and a stage is released once the first group of the next k-block has been issued
// and the last group that reads it has retired. (Fetching the next k-step's values before
// the wait would keep a third set live: ptxas then serializes the wgmmas for registers.)
template <int ROWS_A, int STAGES, typename Fragments>
__device__ void consume_rs(Pipe<ROWS_A, STAGES, true>& p, Ring<STAGES>& ring, int kblocks,
                           float (&acc)[2][kAcc], Fragments fragments) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[j][i] = 0.0f;
  fence_acc(acc[0]);
  fence_acc(acc[1]);
  uint32_t f[2][2][4];  // [register set][operand][value]
  int last = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    mbar_wait(&p.full[ring.stage], ring.phase);
    const uint64_t db = desc_b128(p.b[ring.stage]);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      auto& set = f[kk & 1];
      fragments(ring.stage, kk, set[0], set[1]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_n176_rs(acc[0], set[0], db + 2 * kk);
      wgmma_n176_rs(acc[1], set[1], db + 2 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_fragment(f[(kk & 1) ^ 1][0]);  // the group before this one has retired
      fence_fragment(f[(kk & 1) ^ 1][1]);
      if (kk == 0 && kb > 0) release(p, last);
    }
    last = ring.stage;
    ring.advance();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_fragment(f[1][0]);
  fence_fragment(f[1][1]);
  release(p, last);
  fence_acc(acc[0]);
  fence_acc(acc[1]);
}

// ---- host side ----

// The TMA map of `planes` K-major f32 matrices of rows × ld floats, back to back at base,
// read in box_rows × 32-float boxes, with the 128-byte swizzle unless told otherwise. ld is
// a multiple of 32 and every box lies inside the rows (whole tiles).
inline cudaError_t make_box_map(CUtensorMap* map, const float* base, int64_t ld, int64_t rows,
                                int planes, int box_rows,
                                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * sizeof(float),
                                 static_cast<cuuint64_t>(ld * rows) * sizeof(float)};
  const cuuint32_t box[3] = {kBK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace one_pass
}  // namespace neo
