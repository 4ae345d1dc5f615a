// Online-softmax attention forward over head-packed (B, S, H*D) bf16, shared
// by attention.cu (the KV-resident inference kernel) and flash_attention.cu
// (the training forward, which also writes the base-2 logsumexp). The
// long-sequence forward runs on attention_sm90.cuh instead.
//
// Layout: a block takes 64 queries of one (batch, head); each of its 4 warps
// owns 16 query rows. Scores S = Q K^T and the output O = P V run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). The score accumulators are
// re-used in registers as the A operand of P V, so P never touches shared
// memory. Scores, the running max and the row sum are fp32; Q is pre-scaled
// by scale * log2(e) (rounded to bf16, as the TPU kernels do) and the
// exponentials are exp2.
//
// D (40, 80, 160) is not a multiple of 16: shared-memory tiles are DP =
// round_up(D, 16) wide and the pad columns are zero-filled once. Device
// memory is never padded. K/V tiles of 64 keys are double-buffered with
// cp.async; keys past Sk are masked to -inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gmdx_attn {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int ATT_THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Rows [row0, row0 + NR) of one head into a [NR][LD] tile; rows past `rows`
// are zero-filled.
template <int D, int LD, int NR = 64>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int row0, int rows, int ld) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < NR * CH; c += ATT_THREADS) {
    const int r = c / CH;
    const int d = (c % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(tile + r * LD + d, ok ? base + (size_t)(row0 + r) * ld + d : base, ok);
  }
}

// Zero the pad columns [D, DP) of `ntiles` consecutive [NR][LD] tiles.
template <int D, int DP, int LD, int NR = 64>
__device__ __forceinline__ void zero_pad_cols(__nv_bfloat16* tiles, int ntiles) {
  if constexpr (DP > D) {
    constexpr int PC = DP - D;
    const __nv_bfloat16 z = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < ntiles * NR * PC; i += ATT_THREADS) {
      const int t = i / (NR * PC);
      const int rem = i % (NR * PC);
      tiles[t * NR * LD + (rem / PC) * LD + D + rem % PC] = z;
    }
  }
}

// out (B, Sq, H*D) = softmax(scale * Q K^T) V; with LSE, lse (B, H, Sq) fp32
// gets the base-2 logsumexp of the scaled logits, m + log2(l).
template <int D, bool LSE>
__device__ __forceinline__ void attention_fwd_body(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, float qscale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;  // k-chunks of Q K^T
  constexpr int DT = DP / 8;   // n-tiles of P V
  constexpr int TILE = 64 * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + TILE;      // 2 stages
  __nv_bfloat16* sv = sk + 2 * TILE;  // 2 stages

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ld = H * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * ld + h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * ld + h * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * ld + h * D;

  zero_pad_cols<D, DP, LD>(sq, 5);
  load_tile<D, LD>(sq, qb, q0, Sq, ld);
  load_tile<D, LD>(sk, kb, 0, Sk, ld);
  load_tile<D, LD>(sv, vb, 0, Sk, ld);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row in the 8-row group
  const int t = lane & 3;   // column pair

  uint32_t qf[KC][4];
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float mrow[2] = {-1e30f, -1e30f};
  float lrow[2] = {0.0f, 0.0f};

  const int nkv = (Sk + BKV - 1) / BKV;
  for (int j = 0; j < nkv; ++j) {
    if (j + 1 < nkv) {
      load_tile<D, LD>(sk + ((j + 1) & 1) * TILE, kb, (j + 1) * BKV, Sk, ld);
      load_tile<D, LD>(sv + ((j + 1) & 1) * TILE, vb, (j + 1) * BKV, Sk, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (j == 0) {  // Q fragments, pre-scaled, kept in registers
      const __nv_bfloat16* qw = sq + warp * 16 * LD;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = g + (r & 1) * 8;
          const int col = kc * 16 + 2 * t + (r >> 1) * 8;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(qw + row * LD + col));
          qf[kc][r] = pack2(f.x * qscale, f.y * qscale);
        }
      }
    }

    const __nv_bfloat16* kt = sk + (j & 1) * TILE;
    const __nv_bfloat16* vt = sv + (j & 1) * TILE;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      const __nv_bfloat16* kr = kt + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) mma16816(s[nt], qf[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // Mask keys past Sk, then the online-softmax update for rows g and g + 8.
    const int key0 = j * BKV;
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        if (key >= Sk) s[nt][e] = neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f(mrow[i] - mx[i]);
      mrow[i] = mx[i];
      lrow[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mrow[e >> 1]);
        lrow[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the score accumulators of key n-tiles 2c, 2c+1 are the A
    // fragment of k-chunk c.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      pa[0] = pack2(s[2 * c][0], s[2 * c][1]);
      pa[1] = pack2(s[2 * c][2], s[2 * c][3]);
      pa[2] = pack2(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = pack2(s[2 * c + 1][2], s[2 * c + 1][3]);
      const __nv_bfloat16* v0 = vt + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* vp = v0 + dt * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16(vp[8 * LD], vp[9 * LD]);
        mma16816(o[dt], pa, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 1);
    lrow[i] += __shfl_xor_sync(0xffffffffu, lrow[i], 2);
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
    if (LSE && t == 0) lse[((size_t)b * H + h) * Sq + row] = mrow[i] + log2f(lrow[i]);
  }
}

template <int D, bool LSE>
__global__ void __launch_bounds__(ATT_THREADS)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, float qscale) {
  attention_fwd_body<D, LSE>(q, k, v, out, lse, Sq, Sk, H, qscale);
}

template <int D>
constexpr int fwd_smem_bytes() { return 5 * 64 * ((D + 15) / 16 * 16 + 8) * 2; }

template <int D, bool LSE>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Sk, int H, float qscale, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(attention_fwd_kernel<D, LSE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<D, LSE><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H,
      qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmdx_attn
