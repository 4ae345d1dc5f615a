// Hopper GEMM core for the conv, feed-forward and Winograd kernels: TMA
// loads into a ring of swizzled shared-memory stages, wgmma from shared
// memory, and a warp-specialised, persistent block.
//
// C[M, N] = A[M, K] @ B[N, K]^T, bf16 operands, fp32 accumulators. A block
// has three warpgroups (384 threads):
//   * warpgroup 2, the producer, gives back registers (setmaxnreg.dec) and
//     keeps the ring full: for each BK = 64 slice of K it waits for the
//     stage's `empty` mbarrier, then issues the TMA loads of the A tile
//     (BM x 64) and the B tile (BN x 64) with the stage's `full` mbarrier
//     counting their bytes. A kernel may instead gather A with cp.async
//     from all 128 producer threads (the conv's route for shapes no TMA box
//     covers); the stage's `full` mbarrier then also counts their arrivals.
//   * warpgroups 0 and 1, the consumers, take the registers (setmaxnreg.inc)
//     and each owns 64 rows of the 128-row tile: per slice they wait for
//     `full`, issue four wgmma.mma_async m64 x BN x k16 with both operands
//     described from shared memory, keep one slice's group in flight, and
//     release the previous stage to the producer through `empty`.
// Stages hold 128-byte rows (64 bf16 along K) in the SWIZZLE_128B layout the
// TMA writes and wgmma reads; every stage starts on a 1024-byte boundary.
//
// The block is persistent: it walks work units blockIdx.x, + gridDim.x, ...
// where a unit is (row tile, column tile, K split). The producer runs ahead
// across units, so one unit's epilogue overlaps the next unit's loads.
//
// Hooks a kernel supplies: the A producer (TMA box coordinates or a
// gather), the epilogue and, for K loops cut in segments, a fold between
// them. The epilogue runs on the accumulator registers (no fp32 C tile in
// shared memory): it writes its bf16 result into a small padded staging
// tile per consumer warpgroup and stores that with 16-byte stores, or
// writes fp32 results (split-K partials, Winograd products) straight from
// the registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace gmdx {
namespace sm90 {

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_BUDGET = 232448;  // dynamic shared memory a block may use

// Shared-memory plan of a kernel with BN-wide B tiles whose epilogue stages
// OUTW columns of bf16 per consumer warpgroup.
template <int BN, int OUTW>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int LDS = OUTW + 8;  // staging row stride (bf16): no bank conflicts
  static constexpr int STAGING_BYTES = 2 * 64 * LDS * 2;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - STAGING_BYTES - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int BYTES = 1024 + STAGES * STAGE_BYTES + STAGING_BYTES + (2 * STAGES + 2) * 8;
  static_assert(STAGES >= 3, "too few pipeline stages fit");
  static_assert(B_BYTES % 1024 == 0, "stages must stay 1024-byte aligned");
};

// Work units: (row tile, column tile, K split), the split fastest and then
// the column tile, so that neighbouring blocks share their A rows in L2.
struct Units {
  int m_tiles, n_tiles, split, slices, slices_per_split;
  __host__ __device__ int count() const { return m_tiles * n_tiles * split; }
  __device__ void decode(int u, int& mt, int& nt, int& s0, int& s1) const {
    const int sp = u % split;
    const int mn = u / split;
    nt = mn % n_tiles;
    mt = mn / n_tiles;
    s0 = sp * slices_per_split;
    s1 = min(slices, s0 + slices_per_split);
  }
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 16-byte cp.async; src-size 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's generic-proxy shared-memory writes (cp.async) visible
// to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier over one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma shared-memory descriptor of a K-major SWIZZLE_128B tile: 8-row
// groups 1024 bytes apart (SBO); LBO unused for this layout.
__device__ __forceinline__ uint64_t make_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64n64k16: 32 fp32 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// m64n128k16: 64 fp32 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// m64n160k16: 80 fp32 accumulators a thread.
__device__ __forceinline__ void wgmma_m64n160(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(BN == 64 || BN == 128 || BN == 160, "wgmma instance");
  if constexpr (BN == 64) {
    wgmma_m64n64(d, da, db, accumulate);
  } else if constexpr (BN == 128) {
    wgmma_m64n128(d, da, db, accumulate);
  } else {
    wgmma_m64n160(d, da, db, accumulate);
  }
}

// Fragment coordinates of accumulator i of an m64nN tile in this thread's
// warpgroup: rows 16 * warp + lane / 4 (+ 8), columns in pairs.
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int frag_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---------------------------------------------------------------------------
// The pipeline
// ---------------------------------------------------------------------------

template <int STAGES>
struct Pipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // Passes over k stages: another consumer warpgroup's unit.
  __device__ __forceinline__ void skip(int k) {
    const int total = stage + k;
    phase ^= (total / STAGES) & 1;
    stage = total % STAGES;
  }
};

// Barriers and stage pointers of a block's shared memory.
template <int BN, int OUTW>
struct Ring {
  using S = Smem<BN, OUTW>;
  uint8_t* stages;
  __nv_bfloat16* staging;  // 2 x 64 x LDS
  uint64_t* full;
  uint64_t* empty;
  uint64_t* turn;  // ping-pong: turn[w] opens warpgroup w's next K loop

  __device__ __forceinline__ explicit Ring(unsigned char* raw) {
    const uint32_t base = smem_u32(raw);
    uint8_t* p = raw + ((1024 - (base & 1023)) & 1023);
    stages = p;
    staging = reinterpret_cast<__nv_bfloat16*>(p + S::STAGES * S::STAGE_BYTES);
    full = reinterpret_cast<uint64_t*>(p + S::STAGES * S::STAGE_BYTES + S::STAGING_BYTES);
    empty = full + S::STAGES;
    turn = empty + S::STAGES;
  }
  __device__ __forceinline__ uint8_t* a(int stage) const { return stages + stage * S::STAGE_BYTES; }
  __device__ __forceinline__ uint8_t* b(int stage) const { return a(stage) + S::A_BYTES; }
  __device__ __forceinline__ __nv_bfloat16* staging_of(int wg) const {
    return staging + wg * 64 * S::LDS;
  }
};

// One unit's K loop on a consumer warpgroup. HALVES = 1 (cooperative):
// `acc` (BN / 2 floats) ends holding rows [64 * wg, 64 * wg + 64) of the
// tile. HALVES = 2 (ping-pong): `acc` (BN floats) holds all 128 rows, the
// first BN / 2 floats rows 0-63 and the rest rows 64-127; each k16 step is
// two wgmma on the same B.
template <int BN, int OUTW, int HALVES>
__device__ __forceinline__ void consume_unit(float* acc, const Ring<BN, OUTW>& ring,
                                             Pipe<Smem<BN, OUTW>::STAGES>& pipe, int n_slices,
                                             int wg) {
  const int lane = threadIdx.x & 31;
  const int row0 = HALVES == 1 ? wg * 64 : 0;
  int prev = -1;
  for (int s = 0; s < n_slices; ++s) {
    mbar_wait(&ring.full[pipe.stage], pipe.phase);
    const uint64_t db = make_desc(ring.b(pipe.stage));
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      const uint64_t da = make_desc(ring.a(pipe.stage) + (row0 + h * 64) * 128);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
        wgmma_tile<BN>(acc + h * (BN / 2), da + 2 * kk, db + 2 * kk, (s | kk) != 0);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(&ring.empty[prev]);
    }
    prev = pipe.stage;
    pipe.advance();
  }
  wgmma_wait<0>();
  fence_acc<HALVES * BN / 2>(acc);
  if (lane == 0 && prev >= 0) mbar_arrive(&ring.empty[prev]);
}

// Stores a consumer warpgroup's staged 64 x W bf16 tile with 16-byte
// stores to out (row stride ldo), rows < M and columns < N (N % 8 == 0).
template <int W, int LDS>
__device__ __forceinline__ void store_staged(const __nv_bfloat16* stg, __nv_bfloat16* out,
                                             int ldo, int m0, int n0, int M, int N) {
  constexpr int CH = W / 8;
  for (int c = threadIdx.x & 127; c < 64 * CH; c += 128) {
    const int r = c / CH;
    const int j = (c - r * CH) * 8;
    const int m = m0 + r;
    const int n = n0 + j;
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(out + (size_t)m * ldo + n) =
          *reinterpret_cast<const uint4*>(stg + r * LDS + j);
  }
}

// A segmented unit's K loop: runs of n slices, each folded into z by
// op.fold<g> (g a constant, so the fold's coefficients are immediates).
template <class Op, class R, class P, int... G>
__device__ __forceinline__ void consume_segments(const Op& op, float* z, float* acc,
                                                 const R& ring, P& pipe, int n, int wg,
                                                 std::integer_sequence<int, G...>) {
  ((consume_unit<Op::kBN, Op::kOutW, 1>(acc, ring, pipe, n, wg), op.template fold<G>(z, acc)),
   ...);
}

// An op's K segments (Op::kSegments where it declares one, else 1).
template <class Op, class = void>
struct Segments {
  static constexpr int value = 1;
};
template <class Op>
struct Segments<Op, std::void_t<decltype(Op::kSegments)>> {
  static constexpr int value = Op::kSegments;
};

// The warp-specialised persistent kernel. `Op` supplies:
//   Units units; static constexpr int kBN, kOutW;
//   static constexpr bool kGather, kPingPong;
//   __device__ void load(const Ring&, int stage, uint64_t* bar, const CUtensorMap* ta,
//                        const CUtensorMap* tb, int mt, int nt, int slice) const;
//     (TMA route: one thread issues the stage's loads)
//   __device__ void produce_gather(const Ring&, const CUtensorMap* tb) const;
//     (gather route: the whole producer warpgroup runs its own loop)
//   __device__ void epilogue(float* acc, const Ring&, int wg, int m0, int nt, int split) const;
//     (64 rows from m0: the accumulators of one wgmma row block)
// and, for a cooperative op whose units fold their K loop in segments:
//   static constexpr int kSegments, kFoldRegs;
//   template <int G> __device__ void fold(float* z, const float* acc) const;
// Each unit's K loop is then kSegments equal runs of slices; after run g
// the consumer hands its accumulators to fold (z: kFoldRegs floats a
// thread, zero at the unit's start) and the next run starts afresh; the
// epilogue receives z in place of the accumulators.
// Cooperative (kPingPong false): both consumer warpgroups work on every
// unit, 64 rows each. Ping-pong (kPingPong, units of one split): each
// warpgroup takes every other unit of the block whole, so that one
// warpgroup's epilogue runs while the other's wgmma keep the tensor cores
// busy; the right schedule where the epilogue is long beside a short K.
// The two K loops take turns (the `turn` mbarriers): a warpgroup starts its
// loop only when the other has finished one, so that no warpgroup waits on
// a stage's `full` barrier more than one round ahead of the producer, which
// the parity wait cannot tell apart.
template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
    ws_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   const Op op) {
  constexpr int BN = Op::kBN;
  constexpr int OUTW = Op::kOutW;
  using S = Smem<BN, OUTW>;
  extern __shared__ unsigned char smem_raw[];
  const Ring<BN, OUTW> ring(smem_raw);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&ring.full[s], Op::kGather ? 129 : 1);
      mbar_init(&ring.empty[s], Op::kPingPong ? CONSUMER_WARPS / 2 : CONSUMER_WARPS);
    }
    mbar_init(&ring.turn[0], 1);
    mbar_init(&ring.turn[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == 256) {
    if (!Op::kGather) tma_prefetch_map(&ta);
    tma_prefetch_map(&tb);
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<56>();
    if constexpr (Op::kGather) {
      op.produce_gather(ring, &tb);
    } else if (threadIdx.x == 256) {
      Pipe<S::STAGES> pipe;
      for (int u = blockIdx.x; u < op.units.count(); u += gridDim.x) {
        int mt, nt, s0, s1;
        op.units.decode(u, mt, nt, s0, s1);
        for (int s = s0; s < s1; ++s) {
          mbar_wait(&ring.empty[pipe.stage], pipe.phase ^ 1);
          mbar_expect_tx(&ring.full[pipe.stage], S::STAGE_BYTES);
          op.load(ring, pipe.stage, &ring.full[pipe.stage], &ta, &tb, mt, nt, s);
          pipe.advance();
        }
      }
    }
  } else if constexpr (Op::kPingPong) {
    setmaxnreg_inc<224>();
    Pipe<S::STAGES> pipe;
    const int n = op.units.slices;  // every unit: one split
    pipe.skip(wg * n);
    float acc[BN];
#pragma unroll
    for (int i = 0; i < BN; ++i) acc[i] = 0.0f;
    int k = 0;  // this warpgroup's units so far
    for (int u = blockIdx.x + wg * gridDim.x; u < op.units.count(); u += 2 * gridDim.x, ++k) {
      int mt, nt, s0, s1;
      op.units.decode(u, mt, nt, s0, s1);
      if (wg == 1 || k > 0) mbar_wait(&ring.turn[wg], (wg == 1 ? k : k - 1) & 1);
      consume_unit<BN, OUTW, 2>(acc, ring, pipe, n, wg);
      if ((threadIdx.x & 127) == 0) mbar_arrive(&ring.turn[wg ^ 1]);
      op.epilogue(acc, ring, wg, mt * BM, nt, 0);
      op.epilogue(acc + BN / 2, ring, wg, mt * BM + 64, nt, 0);
      pipe.skip(n);  // the other warpgroup's unit
    }
  } else {
    setmaxnreg_inc<224>();
    Pipe<S::STAGES> pipe;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int u = blockIdx.x; u < op.units.count(); u += gridDim.x) {
      int mt, nt, s0, s1;
      op.units.decode(u, mt, nt, s0, s1);
      if constexpr (Segments<Op>::value == 1) {
        consume_unit<BN, OUTW, 1>(acc, ring, pipe, s1 - s0, wg);
        op.epilogue(acc, ring, wg, mt * BM + wg * 64, nt, u % op.units.split);
      } else {
        float z[Op::kFoldRegs];
#pragma unroll
        for (int i = 0; i < Op::kFoldRegs; ++i) z[i] = 0.0f;
        consume_segments(op, z, acc, ring, pipe, (s1 - s0) / Segments<Op>::value, wg,
                         std::make_integer_sequence<int, Segments<Op>::value>{});
        op.epilogue(z, ring, wg, mt * BM + wg * 64, nt, 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; byte strides of dims
// 1..rank-1) with SWIZZLE_128B boxes and zero fill out of bounds. Built at
// every launch: the caching allocator reuses addresses, so a map is never
// kept. Returns false where cuTensorMapEncodeTiled refuses it.
inline bool make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                     const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i > 0) st[i - 1] = strides[i - 1];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), d, st, bx, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major (rows, cols) bf16 matrix read in (64 x box_rows) boxes.
inline bool make_map_2d(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {(uint32_t)BK, (uint32_t)box_rows};
  return make_map(map, base, 2, dims, strides, box);
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Error code of a launch whose tensor map cuTensorMapEncodeTiled refused.
constexpr int TMA_MAP_REFUSED = -1;

// The persistent grid of `units` units: one block per SM at most.
inline int persistent_grid(int units) { return units < num_sms() ? units : num_sms(); }

// Launches ws_gemm_kernel<Op> persistently.
template <class Op>
inline int launch(const CUtensorMap& ta, const CUtensorMap& tb, const Op& op, cudaStream_t st) {
  using S = Smem<Op::kBN, Op::kOutW>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(ws_gemm_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    attr = true;
  }
  const int units = op.units.count();
  if (units == 0) return 0;
  ws_gemm_kernel<Op><<<persistent_grid(units), THREADS, S::BYTES, st>>>(ta, tb, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace gmdx
