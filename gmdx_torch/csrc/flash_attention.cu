// Flash attention for training over head-packed (B, S, H*D) bf16: the
// forward that also writes the base-2 logsumexp, and the backward: a dd
// pre-pass and kernels that recompute the softmax blockwise from
// (Q, K, LSE).
//
// Replaces gmdx/kernels/flash_attention.py:_flash_forward (TPU kernel
// _flash_kernel) and _flash_backward (the dd = rowsum(dO * O) of its line
// 376, _flash_bwd_dkv_kernel, _flash_bwd_dq_kernel). The function is the
// TPU's; the layout is not: the TPU kernels took (B*H, S, D) after an XLA
// transpose, these kernels index the head-packed projections in place.
//
// Forward: attention_sm90.cuh's persistent forward as train_fwd_sm90_kernel,
// the form that writes lse (B, H, Sq) fp32, m c + log2(l) of the logits
// scaled by c = scale * log2(e) (the scale folded into exp2's FFMA; Q is not
// pre-scaled); its plan is mirrored by kernels/flash_attention.py:
// attention_fwd_plan. The VAE's single 512-wide head takes
// attention_wide_sm90.cuh's flash_fwd_wide_kernel instead, the head dim
// split over a CTA pair (its header says why).
//
// Backward, on attention_sm90.cuh's Hopper pieces (TMA ring, a producer
// warpgroup, two wgmma consumer warpgroups; 4-D tensor maps whose
// out-of-bounds zeros pad D to 64-column boxes and fill the ragged rows):
//   dd:  flash_bwd_dd_kernel, one thread per (batch, query, head): dd (B, H,
//        Sq) fp32 = rowsum(dO * O), one read of each.
//   dkv: grid (ceil(Sk/128), H, B). A block holds 128 keys of K and V, 64
//        for each consumer, and streams (Q, dO) tiles of NQ queries (64; 32
//        at D = 160) with their lse and dd rows. Per tile, c = scale log2 e:
//          S^T = K Q^T, dP^T = V dO^T       (wgmma, both from shared memory)
//          P^T = exp2(c S^T - lse),  dS^T = P^T (dP^T - dd)
//          dV += P^T dO, dK += dS^T Q       (wgmma, A from registers, B
//                                            MN-major)
//        and at the end dK *= scale: unscaled Q with the scale folded into
//        exp2's FFMA. Queries past Sq have lse = +inf, so P = 0.
//   dq:  grid (ceil(Sq/128), H, B). A block holds 128 queries of Q and dO and
//        streams (K, V) tiles of NK keys (128; 64 at D = 160): S = Q K^T,
//        dP = dO V^T, P = exp2(c S - lse) (0 past Sk), dS = P (dP - dd),
//        dQ += dS K; at the end dQ *= scale.
// No atomics: each gradient row has one writer, so a repeat is bit-identical.
// The VAE's single 512-wide head takes attention_wide_sm90.cuh's dV, dK and
// dQ kernels after the same dd pre-pass, on the same rounding convention.
// Within a consumer, the exp2 of P overlaps the dP^T product (dkv) and the
// two consumers' products overlap each other's softmax.
//
// Bound on the H100: the function needs 10 B H Sq Sk D operations (S, dV,
// dP, dK, dQ); this design does 14 (dkv and dq both recompute S and dP), on
// about 16 S H D bytes. Both kernels take one exp2 per score: 2 B H Sq Sk
// exp2 at 16 per SM per clock (about 3.9 T/s), 0.55 ms at B 8, S 4096, H 8,
// above the 0.434 ms operations bound at D = 40.
#include "attention_sm90.cuh"
#include "attention_wide_sm90.cuh"

namespace {

namespace s9 = gmdx::sm90;
namespace a9 = gmdx::attn90;
using a9::CONSUMER_WARPS;
using a9::THREADS;

// dd (B, H, Sq) = rowsum(dO * O) over each head's D columns (D % 8 == 0).
__global__ void __launch_bounds__(256)
    flash_bwd_dd_kernel(const __nv_bfloat16* __restrict__ out,
                        const __nv_bfloat16* __restrict__ dout, float* __restrict__ dd, int B,
                        int Sq, int H, int D) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Sq * H) return;
  const int h = idx % H;
  const long long bs = idx / H;
  const uint4* o = reinterpret_cast<const uint4*>(out + bs * H * D + h * D);
  const uint4* g = reinterpret_cast<const uint4*>(dout + bs * H * D + h * D);
  float acc = 0.0f;
  for (int c = 0; c < D / 8; ++c) {
    const uint4 ov = o[c], gv = g[c];
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 of = __bfloat1622float2(op[j]), gf = __bfloat1622float2(gp[j]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
  dd[((bs / Sq) * H + h) * Sq + bs % Sq] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                         const float* __restrict__ dd, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float c,
                         float scale) {
  using P = a9::DkvPlan<D>;
  constexpr int NCH = P::NCH;
  constexpr int NQ = P::NQ;
  constexpr int NS = NQ / 16;  // k16 steps of dV and dK
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = s9::smem_u32(smem_raw);
  uint8_t* k_tile = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* v_tile = k_tile + NCH * P::BK * 128;
  uint8_t* stages = k_tile + P::KV_BYTES;
  float* lse_s = reinterpret_cast<float*>(stages + P::STAGES * P::STAGE_BYTES);
  float* dd_s = lse_s + a9::MAX_STAGES * NQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + P::STAGES * P::STAGE_BYTES + P::ROWS_BYTES);
  uint64_t* empty = full + P::STAGES;
  uint64_t* kv_full = empty + P::STAGES;

  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * P::BK;
  const int nq = (Sq + NQ - 1) / NQ;
  const size_t bh = (size_t)b * H + h;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      s9::mbar_init(&full[s], 1 + 32);  // the TMA thread and the row warp
      s9::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    s9::mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    s9::setmaxnreg_dec<a9::PRODUCER_REGS>();
    const int warp = (threadIdx.x >> 5) & 3;
    s9::Pipe<P::STAGES> pipe;
    if (threadIdx.x == 256) {
      s9::mbar_expect_tx(kv_full, P::KV_BYTES);
      for (int ch = 0; ch < NCH; ++ch) {
        s9::tma_load_4d(k_tile + ch * P::BK * 128, &tk, kv_full, ch * a9::BOX_COLS, h, k0, b);
        s9::tma_load_4d(v_tile + ch * P::BK * 128, &tv, kv_full, ch * a9::BOX_COLS, h, k0, b);
      }
      for (int i = 0; i < nq; ++i) {
        s9::mbar_wait(&empty[pipe.stage], pipe.phase ^ 1);
        uint64_t* bar = &full[pipe.stage];
        s9::mbar_expect_tx(bar, P::STAGE_BYTES);
        uint8_t* qt = stages + pipe.stage * P::STAGE_BYTES;
        for (int ch = 0; ch < NCH; ++ch) {
          s9::tma_load_4d(qt + ch * NQ * 128, &tq, bar, ch * a9::BOX_COLS, h, i * NQ, b);
          s9::tma_load_4d(qt + (NCH + ch) * NQ * 128, &tdo, bar, ch * a9::BOX_COLS, h, i * NQ, b);
        }
        pipe.advance();
      }
    } else if (warp == 1) {  // the lse and dd rows of each tile
      const int lane = threadIdx.x & 31;
      for (int i = 0; i < nq; ++i) {
        s9::mbar_wait(&empty[pipe.stage], pipe.phase ^ 1);
        for (int r = lane; r < NQ; r += 32) {
          const int row = i * NQ + r;
          lse_s[pipe.stage * NQ + r] = row < Sq ? lse[bh * Sq + row] : a9::pos_inf();
          dd_s[pipe.stage * NQ + r] = row < Sq ? dd[bh * Sq + row] : 0.0f;
        }
        s9::mbar_arrive(&full[pipe.stage]);
        pipe.advance();
      }
    }
    return;
  }

  s9::setmaxnreg_inc<a9::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;
  float st[NQ / 2], dpt[NQ / 2];
  uint32_t pb[NS][4], dsb[NS][4];
  s9::Pipe<P::STAGES> pipe;
  s9::mbar_wait(kv_full, 0);

  for (int i = 0; i < nq; ++i) {
    s9::mbar_wait(&full[pipe.stage], pipe.phase);
    const uint8_t* qt = stages + pipe.stage * P::STAGE_BYTES;
    const uint8_t* dot = qt + NCH * NQ * 128;
    const float* ls = lse_s + pipe.stage * NQ;
    const float* ds = dd_s + pipe.stage * NQ;
    s9::wgmma_fence();
#pragma unroll
    for (int s = 0; s < a9::ksteps(D); ++s)
      a9::wgmma_ss<NQ>(st, a9::kmajor_step(k_tile, P::BK * 128, wg * 64 * 128, s),
                       a9::kmajor_step(qt, NQ * 128, 0, s), s > 0);
    s9::wgmma_commit();
#pragma unroll
    for (int s = 0; s < a9::ksteps(D); ++s)
      a9::wgmma_ss<NQ>(dpt, a9::kmajor_step(v_tile, P::BK * 128, wg * 64 * 128, s),
                       a9::kmajor_step(dot, NQ * 128, 0, s), s > 0);
    s9::wgmma_commit();
    s9::wgmma_wait<1>();
    s9::fence_acc<NQ / 2>(st);
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) st[j] = a9::ex2(fmaf(st[j], c, -ls[s9::frag_col(j)]));
    a9::pack_a<NS>(pb, st);
    s9::wgmma_fence();
    const uint64_t d_do = a9::make_desc_mn(dot, NQ * 128);
#pragma unroll
    for (int s = 0; s < NS; ++s) a9::wgmma_rs<D>(acc_dv, pb[s], d_do + 128 * s);
    s9::wgmma_commit();
    s9::wgmma_wait<1>();
    s9::fence_acc<NQ / 2>(dpt);
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) st[j] *= dpt[j] - ds[s9::frag_col(j)];
    a9::pack_a<NS>(dsb, st);
    s9::wgmma_fence();
    const uint64_t d_q = a9::make_desc_mn(qt, NQ * 128);
#pragma unroll
    for (int s = 0; s < NS; ++s) a9::wgmma_rs<D>(acc_dk, dsb[s], d_q + 128 * s);
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_acc<D / 2>(acc_dk);
    s9::fence_acc<D / 2>(acc_dv);
    a9::fence_regs<NS>(pb);
    a9::fence_regs<NS>(dsb);
    if (lane == 0) s9::mbar_arrive(&empty[pipe.stage]);
    pipe.advance();
  }

  // Both consumers are past their last read of K and V: their space stages
  // dK and dV.
  a9::consumers_sync(256);
  __nv_bfloat16* stg_k = reinterpret_cast<__nv_bfloat16*>(k_tile) + wg * 64 * (D + 8);
  __nv_bfloat16* stg_v = reinterpret_cast<__nv_bfloat16*>(v_tile) + wg * 64 * (D + 8);
  a9::stage_rows<D>(stg_k, acc_dk, scale, scale);
  a9::stage_rows<D>(stg_v, acc_dv, 1.0f, 1.0f);
  s9::warpgroup_sync(wg);
  const int ld = H * D;
  const size_t off = (size_t)b * Sk * ld + h * D;
  s9::store_staged<D, D + 8>(stg_k, dk + off, ld, k0 + wg * 64, 0, Sk, D);
  s9::store_staged<D, D + 8>(stg_v, dv + off, ld, k0 + wg * 64, 0, Sk, D);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const float* __restrict__ lse,
                        const float* __restrict__ dd, __nv_bfloat16* __restrict__ dq, int Sq,
                        int Sk, int H, float c, float scale) {
  using P = a9::DqPlan<D>;
  constexpr int NCH = P::NCH;
  constexpr int NK = P::NK;
  constexpr int NS = NK / 16;  // k16 steps of dQ
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = s9::smem_u32(smem_raw);
  uint8_t* q_tile = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* do_tile = q_tile + NCH * P::BQ * 128;
  uint8_t* stages = q_tile + P::QD_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + P::STAGES * P::STAGE_BYTES);
  uint64_t* empty = full + P::STAGES;
  uint64_t* qd_full = empty + P::STAGES;

  const int wg = threadIdx.x >> 7;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * P::BQ;
  const int nk = (Sk + NK - 1) / NK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      s9::mbar_init(&full[s], 1);
      s9::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    s9::mbar_init(qd_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    s9::setmaxnreg_dec<a9::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      s9::mbar_expect_tx(qd_full, P::QD_BYTES);
      for (int ch = 0; ch < NCH; ++ch) {
        s9::tma_load_4d(q_tile + ch * P::BQ * 128, &tq, qd_full, ch * a9::BOX_COLS, h, q0, b);
        s9::tma_load_4d(do_tile + ch * P::BQ * 128, &tdo, qd_full, ch * a9::BOX_COLS, h, q0, b);
      }
      s9::Pipe<P::STAGES> pipe;
      for (int j = 0; j < nk; ++j) {
        s9::mbar_wait(&empty[pipe.stage], pipe.phase ^ 1);
        uint64_t* bar = &full[pipe.stage];
        s9::mbar_expect_tx(bar, P::STAGE_BYTES);
        uint8_t* kt = stages + pipe.stage * P::STAGE_BYTES;
        for (int ch = 0; ch < NCH; ++ch) {
          s9::tma_load_4d(kt + ch * NK * 128, &tk, bar, ch * a9::BOX_COLS, h, j * NK, b);
          s9::tma_load_4d(kt + (NCH + ch) * NK * 128, &tv, bar, ch * a9::BOX_COLS, h, j * NK, b);
        }
        pipe.advance();
      }
    }
    return;
  }

  s9::setmaxnreg_inc<a9::CONSUMER_REGS>();
  const int lane = threadIdx.x & 31;
  const int row0 = q0 + wg * 64;
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + s9::frag_row(2 * r);
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lrow[r] = row < Sq ? lse[at] : a9::pos_inf();
    drow[r] = row < Sq ? dd[at] : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float sc[NK / 2], dp[NK / 2];
  uint32_t dsb[NS][4];
  s9::Pipe<P::STAGES> pipe;
  s9::mbar_wait(qd_full, 0);

  for (int j = 0; j < nk; ++j) {
    s9::mbar_wait(&full[pipe.stage], pipe.phase);
    const uint8_t* kt = stages + pipe.stage * P::STAGE_BYTES;
    const uint8_t* vt = kt + NCH * NK * 128;
    s9::wgmma_fence();
#pragma unroll
    for (int s = 0; s < a9::ksteps(D); ++s)
      a9::wgmma_ss<NK>(sc, a9::kmajor_step(q_tile, P::BQ * 128, wg * 64 * 128, s),
                       a9::kmajor_step(kt, NK * 128, 0, s), s > 0);
    s9::wgmma_commit();
#pragma unroll
    for (int s = 0; s < a9::ksteps(D); ++s)
      a9::wgmma_ss<NK>(dp, a9::kmajor_step(do_tile, P::BQ * 128, wg * 64 * 128, s),
                       a9::kmajor_step(vt, NK * 128, 0, s), s > 0);
    s9::wgmma_commit();
    s9::wgmma_wait<1>();
    s9::fence_acc<NK / 2>(sc);
    const bool ragged = j == nk - 1 && Sk % NK != 0;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
      sc[i] = a9::ex2(fmaf(sc[i], c, -lrow[(i >> 1) & 1]));
      if (ragged && j * NK + s9::frag_col(i) >= Sk) sc[i] = 0.0f;
    }
    s9::wgmma_wait<0>();
    s9::fence_acc<NK / 2>(dp);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) sc[i] *= dp[i] - drow[(i >> 1) & 1];
    a9::pack_a<NS>(dsb, sc);
    s9::wgmma_fence();
    const uint64_t d_k = a9::make_desc_mn(kt, NK * 128);
#pragma unroll
    for (int s = 0; s < NS; ++s) a9::wgmma_rs<D>(acc, dsb[s], d_k + 128 * s);
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_acc<D / 2>(acc);
    a9::fence_regs<NS>(dsb);
    if (lane == 0) s9::mbar_arrive(&empty[pipe.stage]);
    pipe.advance();
  }

  a9::consumers_sync(256);
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(q_tile) + wg * 64 * (D + 8);
  a9::stage_rows<D>(stg, acc, scale, scale);
  s9::warpgroup_sync(wg);
  const int ld = H * D;
  s9::store_staged<D, D + 8>(stg, dq + (size_t)b * Sq * ld + h * D, ld, row0, 0, Sq, D);
}

template <auto Kernel>
void allow_smem(int bytes) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attr = true;
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dd, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
               float scale, float c, cudaStream_t stream) {
  using Pk = a9::DkvPlan<D>;
  using Pq = a9::DqPlan<D>;
  allow_smem<flash_bwd_dkv_kernel<D>>(Pk::BYTES);
  allow_smem<flash_bwd_dq_kernel<D>>(Pq::BYTES);
  if (B == 0 || Sq == 0 || Sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap kq, kdo, kk, kv, qq, qdo, qk, qv;
  if (!a9::make_head_map(&kq, q, B, Sq, H, D, Pk::Q_ROWS) ||
      !a9::make_head_map(&kdo, dout, B, Sq, H, D, Pk::Q_ROWS) ||
      !a9::make_head_map(&kk, k, B, Sk, H, D, Pk::KV_ROWS) ||
      !a9::make_head_map(&kv, v, B, Sk, H, D, Pk::KV_ROWS) ||
      !a9::make_head_map(&qq, q, B, Sq, H, D, Pq::Q_ROWS) ||
      !a9::make_head_map(&qdo, dout, B, Sq, H, D, Pq::Q_ROWS) ||
      !a9::make_head_map(&qk, k, B, Sk, H, D, Pq::KV_ROWS) ||
      !a9::make_head_map(&qv, v, B, Sk, H, D, Pq::KV_ROWS))
    return s9::TMA_MAP_REFUSED;
  using bf = __nv_bfloat16;
  flash_bwd_dkv_kernel<D><<<Pk::grid(B, Sq, Sk, H), THREADS, Pk::BYTES, stream>>>(
      kq, kdo, kk, kv, lse, dd, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, H, c, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<Pq::grid(B, Sq, Sk, H), THREADS, Pq::BYTES, stream>>>(
      qq, qdo, qk, qv, lse, dd, static_cast<bf*>(dq), Sq, Sk, H, c, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, Sq, H*D); k, v: (B, Sk, H*D), contiguous bf16; lse: (B, H, Sq)
// fp32; c = scale * log2(e). Head dims 40, 80 and 160 (attention_sm90.cuh)
// and 512 (attention_wide_sm90.cuh); any other returns cudaErrorInvalidValue,
// a refused TMA map -1.
extern "C" int gmdx_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int H, int D, float c, void* stream) {
  using a9::launch_fwd;
  using a9::train_fwd_sm90_kernel;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 40:
      return launch_fwd<40, true, train_fwd_sm90_kernel<40>>(q, k, v, out, l, B, Sq, Sk, H, c, st);
    case 80:
      return launch_fwd<80, true, train_fwd_sm90_kernel<80>>(q, k, v, out, l, B, Sq, Sk, H, c, st);
    case 160:
      return launch_fwd<160, true, train_fwd_sm90_kernel<160>>(q, k, v, out, l, B, Sq, Sk, H, c,
                                                               st);
    case 512: return gmdx::wide90::launch_fwd(q, k, v, out, l, B, Sq, Sk, H, c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, dout, dq: (B, Sq, H*D); k, v, dk, dv: (B, Sk, H*D), contiguous bf16;
// lse, dd: (B, H, Sq) fp32. Launches the dK/dV kernel, then the dQ kernel
// (attention_sm90.cuh's at head dims 40/80/160), or the dV, dK and dQ
// kernels (attention_wide_sm90.cuh's at 512).
extern "C" int gmdx_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* dd, void* dq, void* dk, void* dv, int B,
                              int Sq, int Sk, int H, int D, float scale, float qscale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dd);
  switch (D) {
    case 40: return launch_bwd<40>(q, k, v, dout, l, d, dq, dk, dv, B, Sq, Sk, H, scale, qscale, st);
    case 80: return launch_bwd<80>(q, k, v, dout, l, d, dq, dk, dv, B, Sq, Sk, H, scale, qscale, st);
    case 160:
      return launch_bwd<160>(q, k, v, dout, l, d, dq, dk, dv, B, Sq, Sk, H, scale, qscale, st);
    case 512:
      return gmdx::wide90::launch_bwd(q, k, v, dout, l, d, dq, dk, dv, B, Sq, Sk, H, scale,
                                      qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out, dout: (B, Sq, H*D) contiguous bf16 with D % 8 == 0; dd: (B, H, Sq)
// fp32 = rowsum(dout * out) over each head.
extern "C" int gmdx_flash_bwd_dd(const void* out, const void* dout, void* dd, int B, int Sq,
                                 int H, int D, void* stream) {
  if (D % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = (long long)B * Sq * H;
  if (n == 0) return 0;
  flash_bwd_dd_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(dd), B, Sq, H, D);
  return static_cast<int>(cudaGetLastError());
}

// The plan of attention_wide_sm90.cuh's kernel `kind` (0 the forward, 1 dV,
// 2 dK, 3 dQ) at (B, Sq, Sk, H), for kernels/flash_attention.py:wide_fwd_plan
// and wide_bwd_plans to be held to; out[8] as wide90::plan_fields lays it out.
extern "C" int gmdx_wide_plan(int kind, int B, int Sq, int Sk, int H, int* out) {
  namespace w = gmdx::wide90;
  switch (kind) {
    case w::FWD: w::plan_fields<w::FWD>(out, B, Sq, Sk, H); return 0;
    case w::DV: w::plan_fields<w::DV>(out, B, Sq, Sk, H); return 0;
    case w::DK: w::plan_fields<w::DK>(out, B, Sq, Sk, H); return 0;
    case w::DQ: w::plan_fields<w::DQ>(out, B, Sq, Sk, H); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
