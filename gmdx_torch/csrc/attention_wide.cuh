// Flash attention forward for a 512-wide head over head-packed (B, S, H*512)
// bf16: the VAE mid block's single head, 16384 tokens at 1024^2.
//
// Replaces gmdx/kernels/flash_attention.py:_flash_forward (TPU kernel
// _flash_kernel) at D = 512; flash_attention.cu's gmdx_flash_fwd dispatches
// here for that head dim. It writes the base-2 logsumexp as the other
// forwards do (4 bytes a query), whether the caller keeps it or not.
//
// Why not attention_sm90.cuh's forward, which the narrow heads run: a
// consumer warpgroup's m64 x 512 output accumulator alone is 256 fp32 a
// thread, past the cap of 255; nor a 64-query mma.sync block whose warps keep
// their Q fragments and O rows in registers (384 a thread at D = 512) and
// five 64-row tiles in 333 KB of shared memory, past the 227 KB a block can
// have. So this kernel splits the work differently:
//   * A block (8 warps) owns 64 queries of one head. Q stays in shared memory
//     (pre-scaled in place by scale * log2(e), rounded to bf16 as the TPU
//     kernels do). K and V stream in tiles of 32 keys, double-buffered with
//     cp.async.
//   * S = Qs K^T for the 64 x 32 tile: warp w computes rows [16 (w % 4), +16)
//     x keys [16 (w / 4), +16) over all 512 dims (mma.sync m16n8k16, operands
//     by ldmatrix) and writes its fp32 scores to shared memory; keys past Sk
//     are masked to -inf there.
//   * The online softmax runs on all 256 threads, four to a row: the running
//     max and sum of each row and this tile's rescale factor live in shared
//     memory, P = exp2(S - m) is written there as bf16.
//   * O += P V: warp w owns all 64 rows x the 64 columns [64 w, +64), so its
//     fp32 accumulator is 4 x 8 fragments = 128 registers a thread; it
//     rescales them by the tile's factors, then multiplies P (ldmatrix) by V
//     (ldmatrix.trans).
// Shared memory: Q 64 x 520, K and V 2 x 32 x 520 bf16 (rows padded by 8 so
// that ldmatrix is free of bank conflicts), scores 64 x 36 fp32, P 64 x 40
// bf16, three 64-float row vectors: 214,784 bytes, one block an SM.
// Registers: the 128 of the accumulator plus fragments and addresses; the
// build prints ptxas's count and spills (chip_smoke.py, phase build).
//
// Bound on the H100: 4 Sq Sk D operations; at B 2, S 16384, D 512 that is
// 1.10 TFLOP, 1.11 ms at the bf16 peak, against 0.020 ms for its bytes:
// operations-bound. The design reads every Q and K operand from shared memory
// for each product (Q cannot stay in registers beside O), which caps the
// tensor-core rate well below the peak.
//
// The mma.sync helpers of attention_fwd.cuh serve this kernel alone: the
// short-K cross-attention, which shared them, runs on attention_sm90.cuh's
// pieces (attention_xattn.cuh).
#pragma once

#include "attention_fwd.cuh"

namespace gmdx_wide {

using gmdx_attn::cp_async16;
using gmdx_attn::cp_async_commit;
using gmdx_attn::cp_async_wait;
using gmdx_attn::mma16816;
using gmdx_attn::neg_inf;
using gmdx_attn::pack2;

constexpr int WD = 512;       // head dim
constexpr int WLD = WD + 8;   // row stride of the Q, K and V tiles (elements)
constexpr int WBQ = 64;       // queries per block
constexpr int WBK = 32;       // keys per tile
constexpr int WTHREADS = 256;
constexpr int SLD = WBK + 4;  // row stride of the fp32 score tile
constexpr int PLD = WBK + 8;  // row stride of the bf16 P tile
constexpr int WSMEM = (WBQ + 4 * WBK) * WLD * 2 + WBQ * SLD * 4 + WBQ * PLD * 2 + 3 * WBQ * 4;

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Rows [row0, row0 + NR) of one head into a [NR][WLD] tile; rows past `rows`
// are zero-filled.
template <int NR>
__device__ __forceinline__ void load_rows(__nv_bfloat16* tile, const __nv_bfloat16* base, int row0,
                                          int rows, int ld) {
  constexpr int CH = WD / 8;
  for (int c = threadIdx.x; c < NR * CH; c += WTHREADS) {
    const int r = c / CH;
    const int d = (c % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(tile + r * WLD + d, ok ? base + (size_t)(row0 + r) * ld + d : base, ok);
  }
}

// out (B, Sq, H*512) = softmax(scale * Q K^T) V; lse (B, H, Sq) fp32 gets
// m + log2(l) of the logits pre-scaled by scale * log2(e).
__global__ void __launch_bounds__(WTHREADS, 1)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, float qscale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + WBQ * WLD;      // 2 stages
  __nv_bfloat16* sv = sk + 2 * WBK * WLD;  // 2 stages
  float* ss = reinterpret_cast<float*>(sv + 2 * WBK * WLD);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(ss + WBQ * SLD);
  float* s_m = reinterpret_cast<float*>(sp + WBQ * PLD);  // running row max
  float* s_l = s_m + WBQ;                                  // running row sum
  float* s_a = s_l + WBQ;                                  // this tile's rescale

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * WBQ;
  const int ld = H * WD;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * ld + h * WD;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * ld + h * WD;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * ld + h * WD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_rows<WBQ>(sq, qb, q0, Sq, ld);
  load_rows<WBK>(sk, kb, 0, Sk, ld);
  load_rows<WBK>(sv, vb, 0, Sk, ld);
  cp_async_commit();
  if (tid < WBQ) {
    s_m[tid] = -1e30f;
    s_l[tid] = 0.0f;
  }

  float o[4][8][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) o[mt][nt][0] = o[mt][nt][1] = o[mt][nt][2] = o[mt][nt][3] = 0.0f;

  // S phase: this warp's 16 rows and 16 keys.
  const int mts = warp & 3;
  const int kh = warp >> 2;
  const __nv_bfloat16* qa = sq + (16 * mts + (lane & 15)) * WLD + (lane >> 4) * 8;
  const int krow = 16 * kh + (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
  // PV phase: this warp's 64 columns.
  const int c0 = 64 * warp;

  const int nkv = (Sk + WBK - 1) / WBK;
  for (int j = 0; j < nkv; ++j) {
    if (j + 1 < nkv) {
      load_rows<WBK>(sk + ((j + 1) & 1) * WBK * WLD, kb, (j + 1) * WBK, Sk, ld);
      load_rows<WBK>(sv + ((j + 1) & 1) * WBK * WLD, vb, (j + 1) * WBK, Sk, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (j == 0) {  // Qs = bf16(Q * scale * log2 e), in place
      constexpr int P2 = WD / 2;
      for (int i = tid; i < WBQ * P2; i += WTHREADS) {
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(sq + (i / P2) * WLD + (i % P2) * 2);
        const float2 f = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
      __syncthreads();
    }

    const __nv_bfloat16* kt = sk + (j & 1) * WBK * WLD;
    const __nv_bfloat16* vt = sv + (j & 1) * WBK * WLD;

    // S = Qs K^T over all 512 dims; the ldmatrix.x4 of K gives the B
    // fragments of two 8-key n-tiles.
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const __nv_bfloat16* kp = kt + krow * WLD + kcol;
#pragma unroll 8
    for (int kc = 0; kc < WD / 16; ++kc) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, qa + kc * 16);
      ldsm_x4(bk, kp + kc * 16);
      mma16816(s[0], a, bk[0], bk[1]);
      mma16816(s[1], a, bk[2], bk[3]);
    }
    const int key0 = j * WBK;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mts + g + (e >> 1) * 8;
        const int col = 16 * kh + nt * 8 + 2 * t + (e & 1);
        ss[row * SLD + col] = key0 + col < Sk ? s[nt][e] : neg_inf();
      }
    }
    __syncthreads();

    // Online softmax, four threads to a row, eight scores each.
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      const float* sr = ss + r * SLD + part * 8;
      float x[8];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = sr[i];
        mx = fmaxf(mx, x[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      __nv_bfloat16* pr = sp + r * PLD + part * 8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p0 = exp2f(x[2 * i] - m_new);
        const float p1 = exp2f(x[2 * i + 1] - m_new);
        sum += p0 + p1;
        *reinterpret_cast<uint32_t*>(pr + 2 * i) = pack2(p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read s_m[r]
      if (part == 0) {
        const float alpha = exp2f(m_old - m_new);
        s_m[r] = m_new;
        s_l[r] = s_l[r] * alpha + sum;
        s_a[r] = alpha;
      }
    }
    __syncthreads();

    // O = alpha O + P V on this warp's 64 columns.
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float a0 = s_a[16 * mt + g];
      const float a1 = s_a[16 * mt + g + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[mt][nt][0] *= a0;
        o[mt][nt][1] *= a0;
        o[mt][nt][2] *= a1;
        o[mt][nt][3] *= a1;
      }
    }
#pragma unroll
    for (int kc = 0; kc < WBK / 16; ++kc) {
      uint32_t bv[8][2];
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r4[4];
        ldsm_x4_t(r4, vt + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + c0 + 16 * np +
                          (lane >> 4) * 8);
        bv[2 * np][0] = r4[0];
        bv[2 * np][1] = r4[1];
        bv[2 * np + 1][0] = r4[2];
        bv[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, sp + (16 * mt + (lane & 15)) * PLD + 16 * kc + (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma16816(o[mt][nt], a, bv[nt][0], bv[nt][1]);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + (size_t)b * Sq * ld + h * WD;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * mt + g + 8 * i;
      if (q0 + r >= Sq) continue;
      const float inv = 1.0f / s_l[r];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ob + (size_t)(q0 + r) * ld + col) =
            pack2(o[mt][nt][2 * i] * inv, o[mt][nt][2 * i + 1] * inv);
      }
    }
  }
  if (tid < WBQ && q0 + tid < Sq) {
    lse[((size_t)b * H + h) * Sq + q0 + tid] = s_m[tid] + log2f(s_l[tid]);
  }
}

inline int launch_wide(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Sq, int Sk, int H, float qscale, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(flash_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WSMEM);
    attr = true;
  }
  dim3 grid((Sq + WBQ - 1) / WBQ, H, B);
  flash_fwd_wide_kernel<<<grid, WTHREADS, WSMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H,
      qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmdx_wide
