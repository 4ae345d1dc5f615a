// Exact-softmax attention on Hopper: TMA loads into a ring of swizzled
// shared-memory stages, wgmma, and warp-specialised blocks. Every attention
// of SD-1.5's head dims (40, 80, 160) with 256 keys or more runs here:
// the forward serves the KV-resident inference attention (kvres_sm90_kernel,
// gmdx_attention), the long-sequence inference forward (flash_bsc_kernel,
// gmdx_flash_bsc; both in attention.cu) and the training forward with its
// logsumexp (train_fwd_sm90_kernel, gmdx_flash_fwd in flash_attention.cu);
// the flash backward (flash_attention.cu) is built from the same pieces.
// Built on gemm_sm90.cuh's helpers (mbarriers, TMA, descriptors,
// setmaxnreg, tensor maps).
//
// Operands stay head-packed (B, S, H*D) bf16 in device memory. Each is read
// through a 4-D tensor map (D, H, S, B) in boxes 64 columns wide and SWIZZLE_
// 128B: a tile of R rows is NCH = ceil(D / 64) chunk tiles of R x 128 bytes.
// Columns past D arrive as TMA's out-of-bounds zeros, so D = 40 is padded to
// 64 in shared memory and never in device memory; rows past S arrive as
// zeros the same way. Products over D run their k16 loop to round_up(D, 16)
// (48, 80, 160); products whose N is D read a tile MN-major (the
// descriptor's transpose bit), with N = D.
//
// The forward: a block is persistent. It walks query tiles (64 queries for
// each of its NC consumer warpgroups, of one (batch, head); query tile
// fastest, so that neighbouring blocks share a head's K and V in L2)
// blockIdx.x, + gridDim.x, ..., beside one producer warpgroup:
//   * the producer gives back registers and keeps the ring full: per query
//     tile the Q tile, then its key tiles of BKV rows, K and V counted by
//     the stage's `full` mbarrier and released by its `empty` one. The ring
//     runs on across query tiles, and the next tile's Q is loaded as soon as
//     every consumer is past its last Q K^T of the current one (`q_empty`),
//     so that Q's load and the ring's fill run under the current tile's last
//     P V and epilogue.
//   * each consumer, per key tile: S = Q K^T on wgmma m64 x BKV x k16 (both
//     operands from shared memory), the online softmax on the accumulators
//     with the scale folded into exp2's FFMA, P = exp2(S c - m c) (c = scale
//     * log2 e; keys past Sk masked to -inf: a zero K row would still give
//     exp2(0 - m c) != 0), and O += P V on wgmma with A from registers: the
//     accumulator layout of m64nN is the A-fragment layout, so P is packed to
//     bf16 in place. It issues S of tile j with P V of tile j - 1, so that
//     P V runs under the softmax of tile j.
//   * The softmax of one consumer overlaps the products of the others by
//     the warp schedulers alone. Measured on the H100 (PERF.md): FA3-style
//     named-barrier ping-pong of two consumers lost 13 %, and a second S
//     accumulator (S of tile j + 1 under the softmax of tile j) lost 11 %;
//     a third consumer at D = 40 gained 22 %: the loop is bound by the
//     latency of each warpgroup's chain (S, softmax, P V), not by one unit.
//   * The epilogue divides by the row sum and stores bf16 with 16-byte
//     stores through a padded staging tile of its own where one fits beside
//     the ring (D = 40; 1.5-2 % faster there), else in pairs straight from
//     the accumulators (Q's space is the next tile's by then); rows past Sq
//     write neither the output nor the logsumexp.
// NC, BKV and the grid are the launch plan's (FwdPlan).
//
// Why not KV-resident in the TPU kernel's sense (all of one head's K and V
// in fast memory for a whole query block): it fits at none of the shapes
// that route here. At 4096 keys K and V of one head of 40 are 640 KB in
// 64-column boxes, past the 227 KB a block may use; even at 256 keys and
// D = 160, K and V padded to 192 columns take 196 KB, and Q's 48 KB more. So
// keys stream through the ring with an online softmax: the same exact
// function, reached another way.
//
// Bound on the H100: 4 B H Sq Sk D operations, but also one exp2 per score.
// The SFU gives 16 exp2 per SM per clock, about 3.9 T/s (FlashAttention-3,
// section 3.1), against 989 T / 160 = 6.2 T scores/s of tensor work at
// D = 40: at B 2, S 16384, H 8 the exp2 floor is 4.3 G exp2, 1.10 ms, above
// the 0.695 ms operations bound; hence the overlap. Each query tile reads
// its head's whole K and V once: Sq / BQ passes over 2 Sk D bytes a (batch,
// head), from L2.
#pragma once

#include "gemm_sm90.cuh"

namespace gmdx {
namespace attn90 {

using sm90::SMEM_BUDGET;

// The backward's blocks: a producer and two consumer warpgroups.
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int BOX_COLS = 64;  // bf16 columns of one 128-byte swizzled box
constexpr int MAX_STAGES = 4;
constexpr int PRODUCER_REGS = 40;  // the backward's setmaxnreg split
constexpr int CONSUMER_REGS = 232;
static_assert((2 * CONSUMER_REGS + PRODUCER_REGS) * 128 <= 65536, "setmaxnreg split");

__host__ __device__ constexpr int chunks(int d) { return (d + BOX_COLS - 1) / BOX_COLS; }
__host__ __device__ constexpr int ksteps(int d) { return (d + 15) / 16; }
__host__ __device__ constexpr int min_int(int a, int b) { return a < b ? a : b; }

// The forward's launch plan (kernels/flash_attention.py:attention_fwd_plan
// mirrors it): NC consumer warpgroups of 64 queries each, three at D = 40
// (160 registers a consumer thread) and two above, whose wider
// accumulators need 232; key tiles of BKV = 128 rows, 64 at D = 160, where
// a 128-key stage would leave room for one. Measured at 256-4096 keys
// (PERF.md), 128-query blocks at D = 40, a third consumer at D = 80 and
// 64-key tiles at D = 80 all lose at every shape. Shared memory is 1024 bytes of alignment
// slack, Q, the stages of K and V, and 256 bytes of mbarriers. The grid is
// persistent: one block an SM at most. Each plan names the rows a block
// owns and the rows of a streamed tile (OWNED, TILE), the box rows of the
// Q/dO and K/V maps (Q_ROWS, KV_ROWS) and the grid at (B, Sq, Sk, H);
// gmdx_attention_sm90_plan (attention.cu) reports them.
template <int D>
struct FwdPlan {
  static constexpr int NCH = chunks(D);
  static constexpr int NC = D == 40 ? 3 : 2;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = NC == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : 232;
  static_assert((NC * CONSUMER_REGS + PRODUCER_REGS) * 128 <= 65536, "setmaxnreg split");
  static constexpr int BQ = 64 * NC;
  static constexpr int BKV = D > 80 ? 64 : 128;
  static constexpr int OWNED = BQ, TILE = BKV, Q_ROWS = BQ, KV_ROWS = BKV;
  static int tiles(int B, int Sq, int H) { return (Sq + BQ - 1) / BQ * H * B; }
  static dim3 grid(int B, int Sq, int, int H) {
    const int t = tiles(B, Sq, H);
    return dim3(t < sm90::num_sms() ? t : sm90::num_sms());
  }
  static constexpr int Q_BYTES = NCH * BQ * 128;
  static constexpr int KV_TILE = NCH * BKV * 128;  // K or V of one stage
  static constexpr int STAGE_BYTES = 2 * KV_TILE;
  static constexpr int STAGES =
      min_int(MAX_STAGES, (SMEM_BUDGET - 1024 - Q_BYTES - 256) / STAGE_BYTES);
  // The epilogue's staging tiles (64 x (D + 8) bf16 a consumer), where they
  // fit beside the ring: at D = 40 only.
  static constexpr int STG_BYTES = NC * 64 * (D + 8) * 2;
  static constexpr bool STAGED =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + STG_BYTES + 256 <= SMEM_BUDGET;
  static constexpr int BYTES =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + (STAGED ? STG_BYTES : 0) + 256;
  static_assert(STAGES >= 2, "too few stages fit");
};

// The backward's plans (kernels/flash_attention.py:flash_bwd_plan mirrors
// them). dK/dV: a block owns BK = 128 keys, 64 for each consumer, holds its
// K and V, and streams (Q, dO) tiles of NQ queries with their lse and dd
// rows; NQ is 32 at D = 160, where the dK and dV accumulators alone take 160
// registers a thread. dQ: a block owns 128 queries and streams (K, V) tiles
// of NK keys.
template <int D>
struct DkvPlan {
  static constexpr int NCH = chunks(D);
  static constexpr int BK = 128;
  static constexpr int NQ = D > 80 ? 32 : 64;
  static constexpr int OWNED = BK, TILE = NQ, Q_ROWS = NQ, KV_ROWS = BK;
  static dim3 grid(int B, int, int Sk, int H) { return dim3((Sk + BK - 1) / BK, H, B); }
  static constexpr int KV_BYTES = 2 * NCH * BK * 128;     // K, then V
  static constexpr int STAGE_BYTES = 2 * NCH * NQ * 128;  // Q, then dO
  static constexpr int ROWS_BYTES = MAX_STAGES * NQ * 8;  // lse and dd of each stage
  static constexpr int STAGES = min_int(
      MAX_STAGES, (SMEM_BUDGET - 1024 - KV_BYTES - ROWS_BYTES - 256) / STAGE_BYTES);
  static constexpr int BYTES = 1024 + KV_BYTES + STAGES * STAGE_BYTES + ROWS_BYTES + 256;
  static_assert(STAGES >= 2, "too few stages fit");
};

template <int D>
struct DqPlan {
  static constexpr int NCH = chunks(D);
  static constexpr int BQ = 128;
  static constexpr int NK = D > 80 ? 64 : 128;
  static constexpr int OWNED = BQ, TILE = NK, Q_ROWS = BQ, KV_ROWS = NK;
  static dim3 grid(int B, int Sq, int, int H) { return dim3((Sq + BQ - 1) / BQ, H, B); }
  static constexpr int QD_BYTES = 2 * NCH * BQ * 128;     // Q, then dO
  static constexpr int STAGE_BYTES = 2 * NCH * NK * 128;  // K, then V
  static constexpr int STAGES =
      min_int(MAX_STAGES, (SMEM_BUDGET - 1024 - QD_BYTES - 256) / STAGE_BYTES);
  static constexpr int BYTES = 1024 + QD_BYTES + STAGES * STAGE_BYTES + 256;
  static_assert(STAGES >= 2, "too few stages fit");
};

// ---------------------------------------------------------------------------
// PTX helpers beyond gemm_sm90.cuh's
// ---------------------------------------------------------------------------

// wgmma descriptor of an MN-major SWIZZLE_128B tile: rows are the K index,
// 128 bytes (64 MN elements) each; 8-row groups 1024 bytes apart (SBO) and
// 64-column chunk tiles `chunk_bytes` apart (LBO). A k16 step is + 2048
// bytes, 128 in descriptor units.
__device__ __forceinline__ uint64_t make_desc_mn(const void* tile, uint32_t chunk_bytes) {
  const uint64_t addr = sm90::smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(chunk_bytes >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

// K-major descriptor of k16 step s of a tile cut in 64-column chunk tiles
// `chunk_bytes` apart, from row offset `row_bytes` in each.
__device__ __forceinline__ uint64_t kmajor_step(const uint8_t* tile, int chunk_bytes,
                                                int row_bytes, int s) {
  return sm90::make_desc(tile + (s >> 2) * chunk_bytes + row_bytes) + 2 * (s & 3);
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Named barrier 3 spans the consumer warpgroups (0 is __syncthreads;
// gemm_sm90.cuh's warpgroup_sync takes 1 and 2).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 3, %0;\n" ::"r"(threads) : "memory");
}

// Packs accumulator columns [16 c, 16 c + 16) of an m64nN tile into the A
// fragment of k16 step c.
template <int C>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* s) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[c][j] = pack2(s[8 * c + 2 * j], s[8 * c + 2 * j + 1]);
  }
}

// Stages the m64 x D accumulators `acc` times `mul` as bf16 into rows of
// `stg` (row stride D + 8).
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* stg, const float* acc, float mul0,
                                           float mul1) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = sm90::frag_row(i);
    const float m = (i >> 1) & 1 ? mul1 : mul0;
    *reinterpret_cast<uint32_t*>(stg + r * LDS + sm90::frag_col(i)) =
        pack2(acc[i] * m, acc[i + 1] * m);
  }
}

// ---------------------------------------------------------------------------
// wgmma instances beyond gemm_sm90.cuh's m64n128 and m64n160
// ---------------------------------------------------------------------------

// SS m64n32k16, A and B K-major from shared memory: 16 accumulators.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// SS m64n64k16, A and B K-major from shared memory: 32 accumulators.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// SS m64n80k16, A and B K-major from shared memory: 40 accumulators (the
// short-K cross-attention's 77 keys, rounded up to 80).
__device__ __forceinline__ void wgmma_ss_n80(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(accumulate));
}

// RS m64n40k16, A (four bf16x2 a thread) from registers, B MN-major from
// shared memory (transposed): 20 accumulators.
__device__ __forceinline__ void wgmma_rs_n40(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS m64n80k16, A (four bf16x2 a thread) from registers, B MN-major from
// shared memory (transposed): 40 accumulators.
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// RS m64n160k16, A (four bf16x2 a thread) from registers, B MN-major from
// shared memory (transposed): 80 accumulators.
__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S-shaped products (SS, N = the tile's rows) and D-wide products (RS, MN-major B).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 80 || N == 128, "wgmma SS instance");
  if constexpr (N == 32) {
    wgmma_ss_n32(d, da, db, accumulate);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, da, db, accumulate);
  } else if constexpr (N == 80) {
    wgmma_ss_n80(d, da, db, accumulate);
  } else {
    sm90::wgmma_m64n128(d, da, db, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 40 || N == 80 || N == 160, "wgmma RS instance");
  if constexpr (N == 40) {
    wgmma_rs_n40(d, a, db);
  } else if constexpr (N == 80) {
    wgmma_rs_n80(d, a, db);
  } else {
    wgmma_rs_n160(d, a, db);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The 4-D map (D, H, S, B) of a head-packed (B, S, H * D) bf16 tensor, read
// in boxes of 64 columns x `rows` rows of one (batch, head).
inline bool make_head_map(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                          int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2, (uint64_t)S * H * D * 2};
  const uint32_t box[4] = {(uint32_t)BOX_COLS, 1, (uint32_t)rows, 1};
  return sm90::make_map(map, base, 4, dims, strides, box);
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

// out (B, Sq, H*D) = softmax(scale Q K^T) V over the block's query tiles;
// with LSE, lse (B, H, Sq) fp32 gets the base-2 logsumexp of the scaled
// logits, m c + log2(l). `c` is scale * log2(e).
template <int D, bool LSE>
__device__ __forceinline__ void attention_sm90_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                                    const CUtensorMap* tv,
                                                    __nv_bfloat16* __restrict__ out,
                                                    float* __restrict__ lse, int B, int Sq, int Sk,
                                                    int H, float c) {
  using P = FwdPlan<D>;
  constexpr int NC = P::NC;
  constexpr int NCH = P::NCH;
  constexpr int BKV = P::BKV;
  constexpr int NS = BKV / 16;  // k16 steps of P V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  uint8_t* q_tile = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* stages = q_tile + P::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + P::STAGES * P::STAGE_BYTES +
                                               (P::STAGED ? P::STG_BYTES : 0));
  uint64_t* empty = full + P::STAGES;
  uint64_t* q_full = empty + P::STAGES;
  uint64_t* q_empty = q_full + 1;

  const int wg = threadIdx.x >> 7;
  const int q_tiles = (Sq + P::BQ - 1) / P::BQ;
  const int ntiles = q_tiles * H * B;
  const int nkv = (Sk + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * NC);
    }
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, 4 * NC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int producer = NC * 128;
  if (threadIdx.x == producer) {
    sm90::tma_prefetch_map(tq);
    sm90::tma_prefetch_map(tk);
    sm90::tma_prefetch_map(tv);
  }
  __syncthreads();

  if (wg == NC) {
    sm90::setmaxnreg_dec<P::PRODUCER_REGS>();
    if (threadIdx.x == producer) {
      sm90::Pipe<P::STAGES> pipe;
      int n = 0;  // this block's query tiles so far
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++n) {
        const int q0 = t % q_tiles * P::BQ;
        const int h = t / q_tiles % H;
        const int b = t / q_tiles / H;
        // Q's space is free once every consumer is past its last Q K^T of
        // the previous tile.
        if (n > 0) sm90::mbar_wait(q_empty, (n - 1) & 1);
        sm90::mbar_expect_tx(q_full, P::Q_BYTES);
        for (int ch = 0; ch < NCH; ++ch)
          sm90::tma_load_4d(q_tile + ch * P::BQ * 128, tq, q_full, ch * BOX_COLS, h, q0, b);
        for (int j = 0; j < nkv; ++j) {
          sm90::mbar_wait(&empty[pipe.stage], pipe.phase ^ 1);
          uint64_t* bar = &full[pipe.stage];
          sm90::mbar_expect_tx(bar, P::STAGE_BYTES);
          uint8_t* kt = stages + pipe.stage * P::STAGE_BYTES;
          for (int ch = 0; ch < NCH; ++ch) {
            sm90::tma_load_4d(kt + ch * BKV * 128, tk, bar, ch * BOX_COLS, h, j * BKV, b);
            sm90::tma_load_4d(kt + P::KV_TILE + ch * BKV * 128, tv, bar, ch * BOX_COLS, h,
                              j * BKV, b);
          }
          pipe.advance();
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<P::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int ld = H * D;
  float o[D / 2];
  float s[BKV / 2];
  uint32_t pa[NS][4];
  sm90::Pipe<P::STAGES> pipe;
  int n = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++n) {
    const int q0 = t % q_tiles * P::BQ;
    const int h = t / q_tiles % H;
    const int b = t / q_tiles / H;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {neg_inf(), neg_inf()};
    float l[2] = {0.0f, 0.0f};
    int prev = 0;
    sm90::mbar_wait(q_full, n & 1);

    for (int j = 0; j < nkv; ++j) {
      sm90::mbar_wait(&full[pipe.stage], pipe.phase);
      const uint8_t* kt = stages + pipe.stage * P::STAGE_BYTES;
      sm90::wgmma_fence();
#pragma unroll
      for (int st = 0; st < ksteps(D); ++st)
        wgmma_ss<BKV>(s, kmajor_step(q_tile, P::BQ * 128, wg * 64 * 128, st),
                      kmajor_step(kt, BKV * 128, 0, st), st > 0);
      sm90::wgmma_commit();
      if (j > 0) {  // O += P V of the previous tile
        const uint64_t dv = make_desc_mn(stages + prev * P::STAGE_BYTES + P::KV_TILE, BKV * 128);
#pragma unroll
        for (int st = 0; st < NS; ++st) wgmma_rs<D>(o, pa[st], dv + 128 * st);
        sm90::wgmma_commit();
      }
      if (j > 0) {
        sm90::wgmma_wait<1>();
      } else {
        sm90::wgmma_wait<0>();
      }
      sm90::fence_acc<BKV / 2>(s);

      // The online softmax on rows g and g + 8 of this warp's 16.
      if (j == nkv - 1 && Sk % BKV != 0) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i)
          if (j * BKV + sm90::frag_col(i) >= Sk) s[i] = neg_inf();
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * c);
        m[r] = mx[r];
        mc[r] = mx[r] * c;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(fmaf(s[i], c, -mc[r]));
        l[r] += s[i];
      }
      if (j > 0) {
        sm90::wgmma_wait<0>();
        sm90::fence_acc<D / 2>(o);
        fence_regs<NS>(pa);
        if (lane == 0) sm90::mbar_arrive(&empty[prev]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
      pack_a<NS>(pa, s);
      prev = pipe.stage;
      pipe.advance();
    }
    if (lane == 0) sm90::mbar_arrive(q_empty);  // past the last Q K^T of this tile
    {  // O += P V of the last tile
      const uint64_t dv = make_desc_mn(stages + prev * P::STAGE_BYTES + P::KV_TILE, BKV * 128);
      sm90::wgmma_fence();
#pragma unroll
      for (int st = 0; st < NS; ++st) wgmma_rs<D>(o, pa[st], dv + 128 * st);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc<D / 2>(o);
      fence_regs<NS>(pa);
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / l[r];
    }
    const int row0 = q0 + wg * 64;
    if (LSE && (lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + sm90::frag_row(2 * r);
        if (row < Sq) lse[((size_t)b * H + h) * Sq + row] = m[r] * c + log2f(l[r]);
      }
    }
    __nv_bfloat16* ob = out + (size_t)b * Sq * ld + h * D;
    if constexpr (P::STAGED) {  // 16-byte stores through this consumer's staging tile
      __nv_bfloat16* stg =
          reinterpret_cast<__nv_bfloat16*>(stages + P::STAGES * P::STAGE_BYTES) + wg * 64 * (D + 8);
      sm90::warpgroup_sync(wg);  // the previous tile's stores have read it
      stage_rows<D>(stg, o, inv[0], inv[1]);
      sm90::warpgroup_sync(wg);
      sm90::store_staged<D, D + 8>(stg, ob, ld, row0, 0, Sq, D);
    } else {  // bf16 pairs straight from the accumulators
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int row = row0 + sm90::frag_row(i);
        const float mul = inv[(i >> 1) & 1];
        if (row < Sq)
          *reinterpret_cast<uint32_t*>(ob + (size_t)row * ld + sm90::frag_col(i)) =
              pack2(o[i] * mul, o[i + 1] * mul);
      }
    }
  }
}

// The three entry points' kernels over the one body, named apart so that a
// profile tells them apart.

// The long-key inference forward (gmdx_flash_bsc).
template <int D>
__global__ void __launch_bounds__(FwdPlan<D>::THREADS, 1)
    flash_bsc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                     int B, int Sq, int Sk, int H, float c) {
  attention_sm90_body<D, false>(&tq, &tk, &tv, out, nullptr, B, Sq, Sk, H, c);
}

// The KV-resident inference attention, 256-4096 keys (gmdx_attention).
template <int D>
__global__ void __launch_bounds__(FwdPlan<D>::THREADS, 1)
    kvres_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                      int B, int Sq, int Sk, int H, float c) {
  attention_sm90_body<D, false>(&tq, &tk, &tv, out, nullptr, B, Sq, Sk, H, c);
}

// The training forward with the base-2 logsumexp (gmdx_flash_fwd).
template <int D>
__global__ void __launch_bounds__(FwdPlan<D>::THREADS, 1)
    train_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int B,
                          int Sq, int Sk, int H, float c) {
  attention_sm90_body<D, true>(&tq, &tk, &tv, out, lse, B, Sq, Sk, H, c);
}

// Launches `Kernel` (one of the __global__s above at D) with the forward's
// maps and plan. Returns sm90::TMA_MAP_REFUSED where cuTensorMapEncodeTiled
// refuses a map.
template <int D, bool LSE, auto Kernel>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Sk, int H, float c, cudaStream_t stream) {
  using P = FwdPlan<D>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
    attr = true;
  }
  if (Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!make_head_map(&tq, q, B, Sq, H, D, P::Q_ROWS) ||
      !make_head_map(&tk, k, B, Sk, H, D, P::KV_ROWS) ||
      !make_head_map(&tv, v, B, Sk, H, D, P::KV_ROWS))
    return sm90::TMA_MAP_REFUSED;
  const dim3 grid = P::grid(B, Sq, Sk, H);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if constexpr (LSE) {
    Kernel<<<grid, P::THREADS, P::BYTES, stream>>>(tq, tk, tv, o, lse, B, Sq, Sk, H, c);
  } else {
    Kernel<<<grid, P::THREADS, P::BYTES, stream>>>(tq, tk, tv, o, B, Sq, Sk, H, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn90
}  // namespace gmdx
