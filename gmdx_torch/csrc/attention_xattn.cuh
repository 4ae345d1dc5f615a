// Short-K cross-attention on Hopper: head-packed (B, S, H*D) bf16 operands,
// head dims 40, 80 and 160, at most 128 keys (the 77 CLIP tokens).
//
// Replaces gmdx/kernels/flash_attention.py:cross_attention_shortk (TPU kernel
// _xattn_kernel, pallas_call in _xattn_forward_bsc). As on the TPU, every key
// of a head is resident at once, so nothing is online: per 64-query tile one
// score product, an exact row softmax (max, exp2, fp32 sum) and one P V
// product, with none of the running max and rescaling of the long-key
// kernels.
//
// Built on attention_sm90.cuh's pieces: 4-D TMA maps (D, H, S, B) in 64-column
// SWIZZLE_128B boxes, whose out-of-bounds zeros pad D = 40 to the box and the
// ragged key rows to the key tile; mbarriers; wgmma SS for S = Q K^T and RS
// (P from registers, V MN-major) for O = P V.
//
// The design (XattnPlan):
//   * Resident K and V. Each block owns one (batch, head), or one of the
//     `splits` contiguous runs of its 64-query tiles where B H blocks would
//     leave SMs idle, and the producer loads that head's K and V once by TMA
//     into KT rows (KT = Sk rounded up to 32, 80 or 128: 80 for 77 keys),
//     instead of once per 64-query block as the mma.sync kernel before it
//     did (about 100 MB of L2 reads at 16 x 4096 x 8 x 40). Every block
//     starts its run at the same tile offset, so the H heads of one query
//     row, 80-320 bytes each of one head-packed row, are read and written
//     at about the same time by neighbouring blocks.
//   * A ring of STAGES 64-row Q tiles, filled by one producer thread, feeds NC
//     consumer warpgroups (three at D = 40, two above; two at D = 40 lost
//     16-19 % on the H100); consumer w takes the run's tiles w, w + NC, ....
//   * The work is sized to the keys, not to a 128-key, 64-deep tile: S on
//     wgmma m64 x KT over ceil(D / 16) k16 steps (3 at D = 40), keys past Sk
//     masked to -inf in the accumulators, P = exp2(S c - m c) with the row sum
//     in fp32 before P is rounded to bf16 in place as the A fragments of P V,
//     which runs KT / 16 k16 steps. At 16 x 4096 x 8 x 40 that is 7.5 GFLOP,
//     7.6 us at the bf16 peak, under the 25 us of the bytes.
//   * The epilogue divides by the row sum and stores bf16 through a padded
//     staging tile of the consumer's own with 16-byte stores.
// Rounding: Q is not pre-scaled (TMA carries it to shared memory unchanged);
// the fp32 scores are scaled by c = scale * log2(e) inside exp2's FFMA, as in
// attention_sm90.cuh's forward. The TPU kernel and the plain version round
// scale * log2(e) * Q to bf16 instead; the two differ by that one rounding.
//
// Bound on the H100: bytes. Q and O are 42 MB each at 16 x 4096 x 8 x 40 and
// K and V 1.6 MB, against 7.5 GFLOP (about 90 operations a byte): 25 us at
// 3.35 TB/s. The 64-query tiles keep Q's reads and O's writes in flight
// across the consumers; the 42 M exp2s of that shape (11 us of the SFU's
// floor, masked keys included) overlap the other consumers' products.
#pragma once

#include "attention_sm90.cuh"

namespace gmdx {
namespace attn90 {

constexpr int XATTN_MAX_KEYS = 128;

// The S product's N: the key count rounded up to an instance.
__host__ __device__ constexpr int xattn_key_tile(int sk) { return sk <= 32 ? 32 : sk <= 80 ? 80 : 128; }

// The launch plan (kernels/flash_attention.py:xattn_plan mirrors it): NC
// consumer warpgroups of 64 queries beside one producer warpgroup; one
// head's K and V; two Q stages a consumer (one where two do not fit: d =
// 160 with 128 keys), beside the staging tiles; 1024 bytes of alignment
// slack and 256 of mbarriers. The stages are a multiple of the consumers,
// so that a stage always serves the same consumer (tile i takes stage
// i % STAGES and consumer i % NC): a consumer then waits for a stage's next
// fill only after its own previous use, and the mbarrier's phase parity
// cannot alias a fill still in flight. (With 4 stages for 3 consumers, a
// consumer could pass the parity test of an older fill that had not landed
// yet, TMA fills completing out of order; the card faulted.) The
// grid is B H splits blocks, splits = the SMs over B H (at least 1, at most
// the query tiles), so that one wave fills the card.
template <int D, int KT>
struct XattnPlan {
  static constexpr int NCH = chunks(D);
  static constexpr int NC = D == 40 ? 3 : 2;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int PRODUCER_REGS = NC == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = NC == 3 ? 160 : 232;
  static_assert((NC * CONSUMER_REGS + PRODUCER_REGS) * 128 <= 65536, "setmaxnreg split");
  static constexpr int KSTEPS = ksteps(D);
  static constexpr int Q_STAGE = NCH * 64 * 128;
  static constexpr int KV_BYTES = 2 * NCH * KT * 128;  // K, then V
  static constexpr int STG_BYTES = NC * 64 * (D + 8) * 2;
  static constexpr int FIXED = 1024 + KV_BYTES + STG_BYTES + 256;
  static constexpr int STAGES = NC * min_int(2, (SMEM_BUDGET - FIXED) / Q_STAGE / NC);
  static constexpr int BYTES = FIXED + STAGES * Q_STAGE;
  static_assert(STAGES >= NC, "too few stages fit");
  static int splits(int B, int Sq, int H) {
    const int q_tiles = (Sq + 63) / 64;
    const int s = sm90::num_sms() / (B * H);
    return s < 1 ? 1 : s < q_tiles ? s : q_tiles;
  }
};

template <int D, int KT>
__global__ void __launch_bounds__(XattnPlan<D, KT>::THREADS, 1)
    xattn_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                      int Sq, int Sk, int H, int splits, float c) {
  using P = XattnPlan<D, KT>;
  constexpr int NC = P::NC;
  constexpr int NCH = P::NCH;
  constexpr int NS = KT / 16;  // k16 steps of P V
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  uint8_t* kv = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* qs = kv + P::KV_BYTES;
  auto* stg_all = reinterpret_cast<__nv_bfloat16*>(qs + P::STAGES * P::Q_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + P::STAGES * P::Q_STAGE + P::STG_BYTES);
  uint64_t* empty = full + P::STAGES;
  uint64_t* kv_full = empty + P::STAGES;

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.x / splits;
  const int run = blockIdx.x % splits;
  const int h = bh % H;
  const int b = bh / H;
  const int q_tiles = (Sq + 63) / 64;
  const int i0 = (int)((long long)q_tiles * run / splits);  // this block's query tiles
  const int n = (int)((long long)q_tiles * (run + 1) / splits) - i0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);
    }
    sm90::mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int producer = NC * 128;
  if (threadIdx.x == producer) {
    sm90::tma_prefetch_map(&tq);
    sm90::tma_prefetch_map(&tk);
    sm90::tma_prefetch_map(&tv);
  }
  __syncthreads();

  if (wg == NC) {
    sm90::setmaxnreg_dec<P::PRODUCER_REGS>();
    if (threadIdx.x == producer) {
      sm90::mbar_expect_tx(kv_full, P::KV_BYTES);  // the head's K and V, once
      for (int ch = 0; ch < NCH; ++ch) {
        sm90::tma_load_4d(kv + ch * KT * 128, &tk, kv_full, ch * BOX_COLS, h, 0, b);
        sm90::tma_load_4d(kv + P::KV_BYTES / 2 + ch * KT * 128, &tv, kv_full, ch * BOX_COLS, h,
                          0, b);
      }
      sm90::Pipe<P::STAGES> pipe;
      for (int i = 0; i < n; ++i) {
        sm90::mbar_wait(&empty[pipe.stage], pipe.phase ^ 1);
        sm90::mbar_expect_tx(&full[pipe.stage], P::Q_STAGE);
        uint8_t* qt = qs + pipe.stage * P::Q_STAGE;
        for (int ch = 0; ch < NCH; ++ch)
          sm90::tma_load_4d(qt + ch * 64 * 128, &tq, &full[pipe.stage], ch * BOX_COLS, h,
                            (i0 + i) * 64, b);
        pipe.advance();
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<P::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int ld = H * D;
  __nv_bfloat16* stg = stg_all + wg * 64 * (D + 8);
  __nv_bfloat16* ob = out + (size_t)b * Sq * ld + h * D;
  float s[KT / 2];
  float o[D / 2];
  uint32_t pa[NS][4];
  sm90::mbar_wait(kv_full, 0);
  const uint64_t dv = make_desc_mn(kv + P::KV_BYTES / 2, KT * 128);
  for (int i = wg; i < n; i += NC) {
    const int stage = i % P::STAGES;
    sm90::mbar_wait(&full[stage], (i / P::STAGES) & 1);
    const uint8_t* qt = qs + stage * P::Q_STAGE;

    // S = Q K^T over ceil(D / 16) k16 steps.
    sm90::wgmma_fence();
#pragma unroll
    for (int st = 0; st < P::KSTEPS; ++st)
      wgmma_ss<KT>(s, kmajor_step(qt, 64 * 128, 0, st), kmajor_step(kv, KT * 128, 0, st), st > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc<KT / 2>(s);
    if (lane == 0) sm90::mbar_arrive(&empty[stage]);  // Q's stage is the producer's again

    // The exact softmax on rows g and g + 8 of this warp's 16.
    if (Sk < KT) {
#pragma unroll
      for (int j = 0; j < KT / 2; ++j)
        if (sm90::frag_col(j) >= Sk) s[j] = neg_inf();
    }
    float mc[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) mc[(j >> 1) & 1] = fmaxf(mc[(j >> 1) & 1], s[j]);
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      mc[r] *= c;
    }
#pragma unroll
    for (int j = 0; j < KT / 2; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = ex2(fmaf(s[j], c, -mc[r]));
      l[r] += s[j];
    }
    pack_a<NS>(pa, s);

    // O = P V, V MN-major.
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int st = 0; st < NS; ++st) wgmma_rs<D>(o, pa[st], dv + 128 * st);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc<D / 2>(o);
    fence_regs<NS>(pa);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.0f / l[r];
    }
    sm90::warpgroup_sync(wg);  // the previous tile's stores have read the staging tile
    stage_rows<D>(stg, o, inv[0], inv[1]);
    sm90::warpgroup_sync(wg);
    sm90::store_staged<D, D + 8>(stg, ob, ld, (i0 + i) * 64, 0, Sq, D);
  }
}

// Launches xattn_sm90_kernel<D, KT>. Returns sm90::TMA_MAP_REFUSED where
// cuTensorMapEncodeTiled refuses a map.
template <int D, int KT>
int launch_xattn(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
                 int H, float c, cudaStream_t stream) {
  using P = XattnPlan<D, KT>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(xattn_sm90_kernel<D, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         P::BYTES);
    attr = true;
  }
  if (B == 0 || Sq == 0) return 0;
  CUtensorMap tq, tk, tv;
  if (!make_head_map(&tq, q, B, Sq, H, D, 64) || !make_head_map(&tk, k, B, Sk, H, D, KT) ||
      !make_head_map(&tv, v, B, Sk, H, D, KT))
    return sm90::TMA_MAP_REFUSED;
  const int splits = P::splits(B, Sq, H);
  xattn_sm90_kernel<D, KT><<<B * H * splits, P::THREADS, P::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, splits, c);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_xattn_keys(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                      int Sk, int H, float c, cudaStream_t stream) {
  switch (xattn_key_tile(Sk)) {
    case 32: return launch_xattn<D, 32>(q, k, v, out, B, Sq, Sk, H, c, stream);
    case 80: return launch_xattn<D, 80>(q, k, v, out, B, Sq, Sk, H, c, stream);
    default: return launch_xattn<D, 128>(q, k, v, out, B, Sq, Sk, H, c, stream);
  }
}

// The plan at (B, Sq, Sk, H): out[8] = grid, key tile, k16 steps of S,
// Q stages, dynamic shared-memory bytes, runs a head's tiles are split
// into, consumer warpgroups, and the most query tiles a block takes.
template <int D, int KT>
void xattn_plan_fields(int* out, int B, int Sq, int H) {
  using P = XattnPlan<D, KT>;
  const int s = P::splits(B, Sq, H);
  const int q_tiles = (Sq + 63) / 64;
  const int fields[8] = {B * H * s, KT, P::KSTEPS, P::STAGES, P::BYTES, s, P::NC,
                         (q_tiles + s - 1) / s};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
}

template <int D>
void xattn_plan_keys(int* out, int B, int Sq, int Sk, int H) {
  switch (xattn_key_tile(Sk)) {
    case 32: return xattn_plan_fields<D, 32>(out, B, Sq, H);
    case 80: return xattn_plan_fields<D, 80>(out, B, Sq, H);
    default: return xattn_plan_fields<D, 128>(out, B, Sq, H);
  }
}

}  // namespace attn90
}  // namespace gmdx
