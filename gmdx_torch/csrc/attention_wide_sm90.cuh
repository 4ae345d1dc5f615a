// Flash attention at the VAE's single 512-wide head, forward and backward,
// over head-packed (B, S, H*512) bf16: the 1024^2 VAE mid block (16384
// tokens) under Stage-1 training and in the HDRTV decode.
//
// Replaces gmdx/kernels/flash_attention.py:_flash_forward (TPU kernel
// _flash_kernel) and _flash_backward (_flash_bwd_dkv_kernel,
// _flash_bwd_dq_kernel) at D = 512; flash_attention.cu's gmdx_flash_fwd and
// gmdx_flash_bwd dispatch here for that head dim (the backward after the dd
// = rowsum(dO * O) pre-pass, flash_bwd_dd_kernel).
//
// Why not attention_sm90.cuh's kernels as they are: a consumer warpgroup's
// m64 x 512 fp32 accumulator is 256 registers a thread, past the cap of 255,
// and a 64-row x 512 bf16 tile is 64 KB, so a resident Q tile beside a
// double-buffered K/V ring does not fit 227 KB. So the head dim is split
// across a 2-CTA cluster: CTA r holds columns [256 r, 256 r + 256) of every
// operand (four 64-column SWIZZLE_128B TMA boxes a row, through
// attention_sm90.cuh's 4-D head maps), and each CTA's output half is an
// m64 x n256 wgmma accumulator, 128 fp32 a consumer thread.
//
// Every kernel here has one shape: a cluster owns 128 rows (64 for each of
// a CTA's two consumer warpgroups), holds their half-width tiles resident,
// and streams the other side's half-width tiles, fed by a producer
// warpgroup through two 2-stage TMA rings: ring X holds the operand only the
// score products read and is released as soon as they are done, ring Y the
// operand the accumulating product reads, released after it, so that the
// next tile's score operand loads under this tile's exchange.
// Per streamed tile each consumer
//   1. forms its PARTIAL score product(s) over its 256 dims (wgmma SS,
//      m64 x TILE, 16 k16 steps: S, S^T, or also dP / dP^T);
//   2. pushes them into its peer consumer's receive buffer in the other CTA
//      (st.async through mapa, whose bytes complete a transaction on the
//      peer's `xfull` mbarrier, as a TMA load does; the peer's warps release
//      the single buffer by arriving on the sender's `xempty` at cluster
//      scope) and adds the peer's partial to its own. fp32 addition
//      commutes, so S0 + S1 in CTA 0 and S1 + S0 in CTA 1 are the same
//      bits: both CTAs run the same softmax and need no second exchange.
//      (Plain remote stores with 128 remote arrivals a tile on each
//      barrier were 1.4-1.5x slower; PERF.md.);
//   3. forms P (or dS) in registers and accumulates its own 256 output
//      columns with wgmma RS m64 x n256 (A from registers, B MN-major over
//      the four boxes), issued with the next tile's score products so that
//      it runs under the next exchange and softmax.
// Each CTA writes only its own 256 columns; rank 0 alone writes lse. The
// cluster ends on barrier.cluster, so no CTA leaves while its peer may
// still write into its shared memory or arrive on its barriers.
//
// The rounding convention (the narrow Hopper kernels'): Q stays as loaded,
// the scale is folded into exp2's FFMA, P = exp2(S c - m c) with c = scale *
// log2(e), lse = m c + log2(l); the backward recomputes P = exp2(S c - lse)
// from the same unrounded Q, so P's rows sum to one. P and dS are rounded
// to bf16 before their products.
//
// The four kernels (kind, rows owned, streamed tile, resident / streamed
// operands, products):
//   flash_fwd_wide_kernel     queries, 64 keys,  Q / (K, V):   S = Q K^T,
//                             online softmax, O += P V
//   flash_bwd_wide_dv_kernel  keys, 64 queries,  K / (Q, dO):  S^T = K Q^T,
//                             P^T = exp2(S^T c - lse), dV += P^T dO
//   flash_bwd_wide_dk_kernel  keys, 32 queries,  (K, V) / (Q, dO): S^T and
//                             dP^T = V dO^T, dS^T = P^T (dP^T - dd),
//                             dK += dS^T Q, dK *= scale
//   flash_bwd_wide_dq_kernel  queries, 32 keys,  (Q, dO) / (K, V): S and
//                             dP = dO V^T, dS = P (dP - dd), dQ += dS K,
//                             dQ *= scale
// One gradient a kernel: a 64-key dK + dV accumulator would be 2 x 64 x 512
// fp32 = 256 KB, the SM's whole register file. No atomics: every output row
// has one writer, so repeats are bit-identical. Keys past Sk are masked
// (the forward's S to -inf, dQ's P to 0), queries past Sq get lse = +inf
// (P = 0) and dd = 0, and rows past Sq or Sk write nothing; TMA's zeros pad
// the ragged tiles.
//
// Bound on the H100: the forward is 4 B H Sq Sk D operations, 1.11 ms at B
// 2, S 16384 (0.556 ms at B 1); the backward 10 B H Sq Sk D, 1.39 ms at B 1,
// S 16384. This design does the forward's 4 units and 16 in the backward
// against the function's 10 (dV: S^T and dV, 4; dK: S^T, dP^T and dK, 6;
// dQ: S, dP and dQ, 6), a 2.22 ms floor at B 1, S 16384. Both CTAs of a
// pair take every exp2 of their rows: 2 B H Sq Sk in the forward, 0.28 ms
// at B 2, S 16384 on the SFU (about 3.9 T/s), under its operations bound.
// The exchange moves B H Sq Sk fp32 each way per partial product, between
// SMs; on the card it, not the bound, sets the pace (PERF.md).
#pragma once

#include "attention_sm90.cuh"

namespace gmdx {
namespace wide90 {

using attn90::BOX_COLS;
using attn90::MAX_STAGES;
using attn90::min_int;
using sm90::SMEM_BUDGET;

constexpr int D = 512;
constexpr int HALF = D / 2;             // columns a CTA holds
constexpr int NCH = HALF / BOX_COLS;    // 64-column boxes of a half row
constexpr int OWNED = 128;              // rows a cluster owns, 64 a consumer
constexpr int CLUSTER = 2;
constexpr int THREADS = 384;            // a producer and two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int XFLOATS = 32;             // partial-product floats a consumer thread exchanges
static_assert((2 * CONSUMER_REGS + PRODUCER_REGS) * 128 <= 65536, "setmaxnreg split");

enum Kind : int { FWD = 0, DV = 1, DK = 2, DQ = 3 };

// The launch plan of each kind (kernels/flash_attention.py:wide_fwd_plan and
// wide_bwd_plans mirror it; gmdx_wide_plan reports it). Shared memory:
// 1024 bytes of alignment slack, the resident half tiles (NRES operands of
// 128 rows), STAGES stages of each ring (a streamed half tile of TILE rows
// each; ring Y's with their per-query rows: lse, and dd for dK), the two
// consumers' receive buffers (32 fp32 a thread, 16 KB a consumer) and 256
// bytes of mbarriers.
template <int KIND>
struct WidePlan {
  static constexpr bool KEYS_OWNED = KIND == DV || KIND == DK;
  static constexpr int TILE = KIND == DK || KIND == DQ ? 32 : 64;
  static constexpr int NRES = KIND == DK || KIND == DQ ? 2 : 1;  // also the partials exchanged
  static constexpr int ROWF = KIND == DV ? 1 : KIND == DK ? 2 : 0;
  // The streamed operand the accumulating product reads (ring Y): V or dO
  // (s1) for the forward and dV, Q or K (s0) for dK and dQ.
  static constexpr int BOP = KIND == FWD || KIND == DV ? 1 : 0;
  static constexpr int RES_BYTES = NRES * NCH * OWNED * 128;
  static constexpr int TILE_BYTES = NCH * TILE * 128;  // a streamed half tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // a stage of both rings
  static constexpr int ROW_BYTES = ROWF * TILE * 4;  // a stage's lse (and dd) rows
  static constexpr int XBUF_BYTES = 2 * 128 * XFLOATS * 4;
  static constexpr int STAGES = min_int(
      MAX_STAGES, (SMEM_BUDGET - 1024 - RES_BYTES - XBUF_BYTES - 256) / (STAGE_BYTES + ROW_BYTES));
  static constexpr int BYTES =
      1024 + RES_BYTES + STAGES * (STAGE_BYTES + ROW_BYTES) + XBUF_BYTES + 256;
  static_assert(NRES * TILE / 2 == XFLOATS, "exchange size");
  static_assert(STAGES >= 2 && BYTES <= SMEM_BUDGET, "plan does not fit");
  static dim3 grid(int B, int Sq, int Sk, int H) {
    const int rows = KEYS_OWNED ? Sk : Sq;
    return dim3(CLUSTER * ((rows + OWNED - 1) / OWNED), H, B);
  }
};

// ---------------------------------------------------------------------------
// Cluster and wgmma helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// All threads of both CTAs, converged or not.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of this CTA's shared `p` in the shared memory of CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  return r;
}

// Four floats into the peer CTA's shared memory at `addr`, their 16 bytes
// completing a transaction on the peer's mbarrier at `bar`.
__device__ __forceinline__ void st_async_peer4(uint32_t addr, const float* v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

// Arrives on the peer CTA's mbarrier at `addr`, releasing this thread's
// earlier accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// mbar_wait with acquire at cluster scope: the arrivals came from the peer.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// RS m64n256k16, A (four bf16x2 a thread) from registers, B MN-major from
// shared memory over four 64-column boxes: 128 accumulators.
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------

// acc += X B: X (the packed P, P^T or dS) from registers, B (V or dO for
// the forward and dV, Q or K for dK and dQ) ring Y's half tile `yt` read
// MN-major.
template <int KIND>
__device__ __forceinline__ void accumulate(float* acc, uint32_t (*xf)[4], const uint8_t* yt) {
  using P = WidePlan<KIND>;
  const uint64_t db = attn90::make_desc_mn(yt, P::TILE * 128);
#pragma unroll
  for (int s = 0; s < P::TILE / 16; ++s) wgmma_rs_n256(acc, xf[s], db + 128 * s);
}

// One kernel of the four. Maps: r0 (and r1) the resident operands, s0 and
// s1 the streamed ones, all with 64-column boxes; r* with 128-row boxes, s*
// with TILE-row boxes. The forward writes out and lse_out (rank 0); the
// backward kernels read lse_in (and dd) and write out (dV, dK or dQ).
template <int KIND>
__device__ __forceinline__ void wide_body(const CUtensorMap* r0, const CUtensorMap* r1,
                                          const CUtensorMap* s0, const CUtensorMap* s1,
                                          const float* __restrict__ lse_in,
                                          const float* __restrict__ dd,
                                          __nv_bfloat16* __restrict__ out,
                                          float* __restrict__ lse_out, int Sq, int Sk, int H,
                                          float c, float scale) {
  using P = WidePlan<KIND>;
  constexpr int T = P::TILE;
  constexpr int NT = T / 2;   // accumulators of one m64 x T product
  constexpr int KS = T / 16;  // k16 steps of the accumulating product
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  uint8_t* res = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* ring_x = res + P::RES_BYTES;  // STAGES half tiles, then ring Y's
  uint8_t* ring_y = ring_x + P::STAGES * P::TILE_BYTES;
  float* xbuf = reinterpret_cast<float*>(ring_y + P::STAGES * P::TILE_BYTES);
  float* lse_s = xbuf + 2 * 128 * XFLOATS;  // ring Y's rows: STAGES x T, then dd's
  float* dd_s = lse_s + P::STAGES * T;
  uint64_t* full_x = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(lse_s) +
                                                 P::STAGES * P::ROW_BYTES);
  uint64_t* empty_x = full_x + MAX_STAGES;
  uint64_t* full_y = empty_x + MAX_STAGES;
  uint64_t* empty_y = full_y + MAX_STAGES;
  uint64_t* res_full = empty_y + MAX_STAGES;
  uint64_t* xfull = res_full + 1;  // one a consumer: the peer's partial has landed
  uint64_t* xempty = xfull + 2;    // one a consumer: the peer has read ours

  const uint32_t rank = cluster_rank();
  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = (blockIdx.x / CLUSTER) * OWNED;
  const int col0 = rank * HALF;
  const int s_own = P::KEYS_OWNED ? Sk : Sq;
  const int s_str = P::KEYS_OWNED ? Sq : Sk;
  const int ntiles = (s_str + T - 1) / T;
  const size_t bh = (size_t)b * H + h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(&full_x[s], 1);
      sm90::mbar_init(&full_y[s], P::ROWF ? 1 + 32 : 1);  // the TMA thread (and the row warp)
      sm90::mbar_init(&empty_x[s], CONSUMER_WARPS);
      sm90::mbar_init(&empty_y[s], CONSUMER_WARPS);
    }
    sm90::mbar_init(res_full, 1);
    for (int w = 0; w < 2; ++w) {
      sm90::mbar_init(&xfull[w], 1);  // this consumer's expect_tx; the peer's bytes
      sm90::mbar_init(&xempty[w], 4);  // the peer consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both CTAs' barriers are initialised before either arrives remotely

  if (wg == 2) {
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3;
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(res_full, P::RES_BYTES);
      for (int ch = 0; ch < NCH; ++ch) {
        sm90::tma_load_4d(res + ch * OWNED * 128, r0, res_full, col0 + ch * BOX_COLS, h, row0, b);
        if (P::NRES == 2)
          sm90::tma_load_4d(res + (NCH + ch) * OWNED * 128, r1, res_full, col0 + ch * BOX_COLS,
                            h, row0, b);
      }
      const CUtensorMap* map_x = P::BOP == 1 ? s0 : s1;  // ring X's operand
      const CUtensorMap* map_y = P::BOP == 1 ? s1 : s0;  // ring Y's
      sm90::Pipe<P::STAGES> pipe;
      for (int t = 0; t < ntiles; ++t) {
        sm90::mbar_wait(&empty_x[pipe.stage], pipe.phase ^ 1);
        sm90::mbar_expect_tx(&full_x[pipe.stage], P::TILE_BYTES);
        uint8_t* xt = ring_x + pipe.stage * P::TILE_BYTES;
        for (int ch = 0; ch < NCH; ++ch)
          sm90::tma_load_4d(xt + ch * T * 128, map_x, &full_x[pipe.stage], col0 + ch * BOX_COLS, h,
                            t * T, b);
        sm90::mbar_wait(&empty_y[pipe.stage], pipe.phase ^ 1);
        sm90::mbar_expect_tx(&full_y[pipe.stage], P::TILE_BYTES);
        uint8_t* yt = ring_y + pipe.stage * P::TILE_BYTES;
        for (int ch = 0; ch < NCH; ++ch)
          sm90::tma_load_4d(yt + ch * T * 128, map_y, &full_y[pipe.stage], col0 + ch * BOX_COLS, h,
                            t * T, b);
        pipe.advance();
      }
    } else if (P::ROWF > 0 && warp == 1) {  // the streamed queries' lse (and dd) rows
      const int lane = threadIdx.x & 31;
      sm90::Pipe<P::STAGES> pipe;
      for (int t = 0; t < ntiles; ++t) {
        sm90::mbar_wait(&empty_y[pipe.stage], pipe.phase ^ 1);
        for (int r = lane; r < T; r += 32) {
          const int q = t * T + r;
          lse_s[pipe.stage * T + r] = q < Sq ? lse_in[bh * Sq + q] : attn90::pos_inf();
          if (P::ROWF == 2) dd_s[pipe.stage * T + r] = q < Sq ? dd[bh * Sq + q] : 0.0f;
        }
        sm90::mbar_arrive(&full_y[pipe.stage]);
        pipe.advance();
      }
    }
  } else {
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int lane = threadIdx.x & 31;
    const int tid = threadIdx.x & 127;
    const uint32_t peer = rank ^ 1;
    // This consumer's receive buffer: float4 q of thread t at (q * 128 + t) * 4.
    const float* rx = xbuf + wg * 128 * XFLOATS;
    const uint32_t tx = peer_addr(rx + tid * 4, peer);  // the same slot in the peer's buffer
    const uint32_t peer_full = peer_addr(&xfull[wg], peer);
    const uint32_t peer_empty = peer_addr(&xempty[wg], peer);

    float acc[2 * HALF / 4];  // m64 x 256: 128 a thread
#pragma unroll
    for (int i = 0; i < 2 * HALF / 4; ++i) acc[i] = 0.0f;
    float part[XFLOATS];  // the partial product(s), then P or dS in fp32
    uint32_t xf[KS][4];   // the previous tile's P or dS, bf16 A fragments
    float m[2] = {attn90::neg_inf(), attn90::neg_inf()};  // the forward's running max and sum
    float l[2] = {0.0f, 0.0f};
    float lrow[2] = {0.0f, 0.0f}, drow[2] = {0.0f, 0.0f};  // dQ's own rows
    if constexpr (KIND == DQ) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + wg * 64 + sm90::frag_row(2 * r);
        lrow[r] = row < Sq ? lse_in[bh * Sq + row] : attn90::pos_inf();
        drow[r] = row < Sq ? dd[bh * Sq + row] : 0.0f;
      }
    }
    sm90::Pipe<P::STAGES> pipe;
    int prev = 0;
    sm90::mbar_wait(res_full, 0);

    for (int j = 0; j < ntiles; ++j) {
      sm90::mbar_wait(&full_x[pipe.stage], pipe.phase);
      sm90::mbar_wait(&full_y[pipe.stage], pipe.phase);
      const uint8_t* xt = ring_x + pipe.stage * P::TILE_BYTES;
      const uint8_t* yt = ring_y + pipe.stage * P::TILE_BYTES;
      const uint8_t* st0 = P::BOP == 1 ? xt : yt;  // s0's and s1's half tiles
      const uint8_t* st1 = P::BOP == 1 ? yt : xt;
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < HALF / 16; ++s)
        attn90::wgmma_ss<T>(part, attn90::kmajor_step(res, OWNED * 128, wg * 64 * 128, s),
                            attn90::kmajor_step(st0, T * 128, 0, s), s > 0);
      if constexpr (P::NRES == 2) {
#pragma unroll
        for (int s = 0; s < HALF / 16; ++s)
          attn90::wgmma_ss<T>(part + NT,
                              attn90::kmajor_step(res + NCH * OWNED * 128, OWNED * 128,
                                                  wg * 64 * 128, s),
                              attn90::kmajor_step(st1, T * 128, 0, s), s > 0);
      }
      sm90::wgmma_commit();
      if (j > 0) {  // the previous tile's accumulating product, under this exchange
        accumulate<KIND>(acc, xf, ring_y + prev * P::TILE_BYTES);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
      } else {
        sm90::wgmma_wait<0>();
      }
      sm90::fence_acc<XFLOATS>(part);
      if (lane == 0) sm90::mbar_arrive(&empty_x[pipe.stage]);  // ring X is read

      // The exchange: ours into the peer's buffer, then the peer's onto ours.
      if (j > 0) mbar_wait_cluster(&xempty[wg], (j - 1) & 1);
#pragma unroll
      for (int q = 0; q < XFLOATS / 4; ++q)
        st_async_peer4(tx + q * 128 * 16, part + 4 * q, peer_full);
      if (tid == 0) sm90::mbar_expect_tx(&xfull[wg], 128 * XFLOATS * 4);
      mbar_wait_cluster(&xfull[wg], j & 1);
#pragma unroll
      for (int q = 0; q < XFLOATS / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(rx)[q * 128 + tid];
        part[4 * q] += v.x;
        part[4 * q + 1] += v.y;
        part[4 * q + 2] += v.z;
        part[4 * q + 3] += v.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive_peer(peer_empty);

      float alpha[2] = {1.0f, 1.0f};
      if constexpr (KIND == FWD) {  // the online softmax on rows g and g + 8 of this warp's 16
        if (j == ntiles - 1 && Sk % T != 0) {
#pragma unroll
          for (int i = 0; i < NT; ++i)
            if (j * T + sm90::frag_col(i) >= Sk) part[i] = attn90::neg_inf();
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < NT; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], part[i]);
        float mc[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = attn90::ex2((m[r] - mx[r]) * c);
          m[r] = mx[r];
          mc[r] = mx[r] * c;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int r = (i >> 1) & 1;
          part[i] = attn90::ex2(fmaf(part[i], c, -mc[r]));
          l[r] += part[i];
        }
      } else if constexpr (KIND == DQ) {  // rows are queries, columns keys
        const bool ragged = j == ntiles - 1 && Sk % T != 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int r = (i >> 1) & 1;
          float p = attn90::ex2(fmaf(part[i], c, -lrow[r]));
          if (ragged && j * T + sm90::frag_col(i) >= Sk) p = 0.0f;
          part[i] = p * (part[NT + i] - drow[r]);
        }
      } else {  // dV, dK: rows are keys, columns the stage's queries
        const float* ls = lse_s + pipe.stage * T;
        const float* ds = dd_s + pipe.stage * T;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int col = sm90::frag_col(i);
          const float p = attn90::ex2(fmaf(part[i], c, -ls[col]));
          if constexpr (KIND == DV) {
            part[i] = p;
          } else {
            part[i] = p * (part[NT + i] - ds[col]);
          }
        }
      }

      if (j > 0) {
        sm90::wgmma_wait<0>();
        sm90::fence_acc<2 * HALF / 4>(acc);
        attn90::fence_regs<KS>(xf);
        if (lane == 0) sm90::mbar_arrive(&empty_y[prev]);
        if constexpr (KIND == FWD) {
#pragma unroll
          for (int i = 0; i < 2 * HALF / 4; ++i) acc[i] *= alpha[(i >> 1) & 1];
        }
      }
      attn90::pack_a<KS>(xf, part);
      prev = pipe.stage;
      pipe.advance();
    }
    {  // the last tile's accumulating product
      sm90::wgmma_fence();
      accumulate<KIND>(acc, xf, ring_y + prev * P::TILE_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc<2 * HALF / 4>(acc);
      attn90::fence_regs<KS>(xf);
      if (lane == 0) sm90::mbar_arrive(&empty_y[prev]);
    }

    // The epilogue: this CTA's 256 columns of the 64 rows of this consumer,
    // times `scale` (1 for dV) or, in the forward, 1 / l.
    float mul[2] = {scale, scale};
    const int rows0 = row0 + wg * 64;
    if constexpr (KIND == FWD) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        mul[r] = 1.0f / l[r];
        const int row = rows0 + sm90::frag_row(2 * r);
        if (rank == 0 && (lane & 3) == 0 && row < Sq)
          lse_out[bh * Sq + row] = m[r] * c + log2f(l[r]);
      }
    }
    const int ld = H * D;
    __nv_bfloat16* ob = out + (size_t)b * s_own * ld + h * D + col0;
#pragma unroll
    for (int i = 0; i < 2 * HALF / 4; i += 2) {
      const int row = rows0 + sm90::frag_row(i);
      const float f = mul[(i >> 1) & 1];
      if (row < s_own)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * ld + sm90::frag_col(i)) =
            attn90::pack2(acc[i] * f, acc[i + 1] * f);
    }
  }
  cluster_sync();  // no CTA leaves while its peer may still write into it or arrive on it
}

// The four kernels over the one body, named apart so that a profile tells
// them apart.
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int Sq,
                          int Sk, int H, float c) {
  wide_body<FWD>(&tq, &tq, &tk, &tv, nullptr, nullptr, out, lse, Sq, Sk, H, c, 1.0f);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    flash_bwd_wide_dv_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse, __nv_bfloat16* __restrict__ dv,
                             int Sq, int Sk, int H, float c) {
  wide_body<DV>(&tk, &tk, &tq, &tdo, lse, nullptr, dv, nullptr, Sq, Sk, H, c, 1.0f);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    flash_bwd_wide_dk_kernel(const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             __nv_bfloat16* __restrict__ dk, int Sq, int Sk, int H, float c,
                             float scale) {
  wide_body<DK>(&tk, &tv, &tq, &tdo, lse, dd, dk, nullptr, Sq, Sk, H, c, scale);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    flash_bwd_wide_dq_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, float c,
                             float scale) {
  wide_body<DQ>(&tq, &tdo, &tk, &tv, lse, dd, dq, nullptr, Sq, Sk, H, c, scale);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <auto Kernel>
void allow_smem(int bytes) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attr = true;
  }
}

// The 4-D map of a head-packed 512-wide operand in 64-column boxes of `rows`.
inline bool head_map(CUtensorMap* map, const void* base, int B, int S, int H, int rows) {
  return attn90::make_head_map(map, base, B, S, H, D, rows);
}

// out (B, Sq, H*512) and lse (B, H, Sq); c = scale * log2(e).
inline int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                      int Sq, int Sk, int H, float c, cudaStream_t stream) {
  using P = WidePlan<FWD>;
  allow_smem<flash_fwd_wide_kernel>(P::BYTES);
  if (Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, Sq, H, OWNED) || !head_map(&tk, k, B, Sk, H, P::TILE) ||
      !head_map(&tv, v, B, Sk, H, P::TILE))
    return sm90::TMA_MAP_REFUSED;
  flash_fwd_wide_kernel<<<P::grid(B, Sq, Sk, H), THREADS, P::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H, c);
  return static_cast<int>(cudaGetLastError());
}

// dV, then dK, then dQ, after the dd pre-pass; c = scale * log2(e).
inline int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dd, void* dq, void* dk, void* dv, int B,
                      int Sq, int Sk, int H, float scale, float c, cudaStream_t stream) {
  using Pv = WidePlan<DV>;
  using Pk = WidePlan<DK>;
  using Pq = WidePlan<DQ>;
  allow_smem<flash_bwd_wide_dv_kernel>(Pv::BYTES);
  allow_smem<flash_bwd_wide_dk_kernel>(Pk::BYTES);
  allow_smem<flash_bwd_wide_dq_kernel>(Pq::BYTES);
  if (B == 0 || Sq == 0 || Sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap k_res, v_res, q_res, do_res, q_v, do_v, q_k, do_k, k_q, v_q;
  if (!head_map(&k_res, k, B, Sk, H, OWNED) || !head_map(&v_res, v, B, Sk, H, OWNED) ||
      !head_map(&q_res, q, B, Sq, H, OWNED) || !head_map(&do_res, dout, B, Sq, H, OWNED) ||
      !head_map(&q_v, q, B, Sq, H, Pv::TILE) || !head_map(&do_v, dout, B, Sq, H, Pv::TILE) ||
      !head_map(&q_k, q, B, Sq, H, Pk::TILE) || !head_map(&do_k, dout, B, Sq, H, Pk::TILE) ||
      !head_map(&k_q, k, B, Sk, H, Pq::TILE) || !head_map(&v_q, v, B, Sk, H, Pq::TILE))
    return sm90::TMA_MAP_REFUSED;
  using bf = __nv_bfloat16;
  flash_bwd_wide_dv_kernel<<<Pv::grid(B, Sq, Sk, H), THREADS, Pv::BYTES, stream>>>(
      k_res, q_v, do_v, lse, static_cast<bf*>(dv), Sq, Sk, H, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_wide_dk_kernel<<<Pk::grid(B, Sq, Sk, H), THREADS, Pk::BYTES, stream>>>(
      k_res, v_res, q_k, do_k, lse, dd, static_cast<bf*>(dk), Sq, Sk, H, c, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_wide_dq_kernel<<<Pq::grid(B, Sq, Sk, H), THREADS, Pq::BYTES, stream>>>(
      q_res, do_res, k_q, v_q, lse, dd, static_cast<bf*>(dq), Sq, Sk, H, c, scale);
  return static_cast<int>(cudaGetLastError());
}

// out[8]: cluster size, rows a CTA (the cluster's), streamed tile rows,
// stages, shared-memory bytes, grid x, y, z of kind KIND at (B, Sq, Sk, H).
template <int KIND>
void plan_fields(int* out, int B, int Sq, int Sk, int H) {
  using P = WidePlan<KIND>;
  const dim3 g = P::grid(B, Sq, Sk, H);
  const int f[8] = {CLUSTER, OWNED, P::TILE, P::STAGES, P::BYTES, (int)g.x, (int)g.y, (int)g.z};
  for (int i = 0; i < 8; ++i) out[i] = f[i];
}

}  // namespace wide90
}  // namespace gmdx
