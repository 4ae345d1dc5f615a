// Short-K cross-attention over head-packed (B, S, H*D) bf16 operands, at most
// 128 keys (the 77 CLIP tokens).
//
// Replaces gmdx/kernels/flash_attention.py:cross_attention_shortk (TPU kernel
// _xattn_kernel, pallas_call in _xattn_forward_bsc). As on the TPU, the whole
// key range of a head is resident at once, so nothing is online: per head one
// score product, an exact row softmax (max, exp2, sum) and one PV product, with
// none of the running-max and rescaling of the long-key kernels.
//
// Layout: a block takes 64 queries of one (batch, head) and loads that head's
// whole K and V slice (rows past Sk zero-filled, 128 rows) into shared memory
// once, beside its Q tile: 35 KB at D = 40, 105 KB at D = 160. Each of the 4
// warps owns 16 query rows; S = Q K^T and O = P V run on mma.sync m16n8k16
// (bf16 in, fp32 accumulate), with the score accumulators re-used in
// registers as the A operand of P V. Q is pre-scaled by scale * log2(e) and
// rounded to bf16 as the TPU kernel does; P is rounded to bf16 for the PV
// product while the row sum is taken in fp32 before rounding, also as there.
// Key tiles past Sk are skipped (77 keys: 10 of the 16 score n-tiles and 5 of
// the 8 PV k-chunks), and keys past Sk inside a tile are masked to -inf.
//
// Bound on the H100: bytes. At (2, 4096, 320) with 77 keys q and out are
// 5.2 MB each against 0.8 GFLOP (about 80 operations a byte), so the kernel
// is a pass over Q and O; reading K and V once per block from L2 is what the
// resident design costs instead of an online loop.
#pragma once

#include "attention_fwd.cuh"

namespace gmdx_attn {

constexpr int XATTN_KEYS = 128;

template <int D>
constexpr int xattn_smem_bytes() { return (BQ + 2 * XATTN_KEYS) * ((D + 15) / 16 * 16 + 8) * 2; }

template <int D>
__global__ void __launch_bounds__(ATT_THREADS)
xattn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq, int Sk,
             int H, float qscale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;          // k-chunks of Q K^T
  constexpr int DT = DP / 8;           // n-tiles of P V
  constexpr int NT = XATTN_KEYS / 8;   // key n-tiles of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BQ * LD;
  __nv_bfloat16* sv = sk + XATTN_KEYS * LD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ld = H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * ld + h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * ld + h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * ld + h * D;

  zero_pad_cols<D, DP, LD>(sq, 1);
  zero_pad_cols<D, DP, LD, XATTN_KEYS>(sk, 2);  // sk and sv are consecutive tiles
  load_tile<D, LD>(sq, qb, q0, Sq, ld);
  load_tile<D, LD, XATTN_KEYS>(sk, kb, 0, Sk, ld);
  load_tile<D, LD, XATTN_KEYS>(sv, vb, 0, Sk, ld);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row in the 8-row group
  const int t = lane & 3;   // column pair

  uint32_t qf[KC][4];
  const __nv_bfloat16* qw = sq + warp * 16 * LD;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + (r & 1) * 8;
      const int col = kc * 16 + 2 * t + (r >> 1) * 8;
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qw + row * LD + col));
      qf[kc][r] = pack2(f.x * qscale, f.y * qscale);
    }
  }

  // S over the key tiles in use; masked keys (and skipped tiles) are -inf.
  const int nkt = (Sk + 7) / 8;
  float s[NT][4];
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    if (nt < nkt) {
      const __nv_bfloat16* kr = sk + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma16816(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + 2 * t + (e & 1);
      if (key >= Sk) s[nt][e] = neg_inf();
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  float lrow[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = exp2f(s[nt][e] - mx[e >> 1]);
      lrow[e >> 1] += s[nt][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
  }

  // O = P V over the 16-key chunks in use.
  const int nkc = (Sk + 15) / 16;
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < NT / 2; ++c) {
    if (c >= nkc) continue;
    uint32_t pa[4];
    pa[0] = pack2(s[2 * c][0], s[2 * c][1]);
    pa[1] = pack2(s[2 * c][2], s[2 * c][3]);
    pa[2] = pack2(s[2 * c + 1][0], s[2 * c + 1][1]);
    pa[3] = pack2(s[2 * c + 1][2], s[2 * c + 1][3]);
    const __nv_bfloat16* v0 = sv + (c * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const __nv_bfloat16* vp = v0 + dt * 8;
      const uint32_t b0 = pack_bf16(vp[0], vp[LD]);
      const uint32_t b1 = pack_bf16(vp[8 * LD], vp[9 * LD]);
      mma16816(o[dt], pa, b0, b1);
    }
  }

  __nv_bfloat16* ob = out + (size_t)b * Sq * ld + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    if (row >= Sq) continue;
    const float inv = 1.0f / lrow[i];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * ld + col) =
            pack2(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
      }
    }
  }
}

template <int D>
int launch_xattn(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
                 int H, float qscale, cudaStream_t stream) {
  constexpr int smem = xattn_smem_bytes<D>();
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(xattn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  xattn_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmdx_attn
