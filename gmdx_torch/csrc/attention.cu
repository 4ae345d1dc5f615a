// Exact-softmax self-attention over head-packed (B, S, H*D) bf16 operands.
//
// Replaces gmdx/kernels/flash_attention.py:attention_kv_resident (TPU kernel
// _kvres_kernel). The TPU kernel kept the whole K/V range of a head resident
// in VMEM and took the row softmax in one pass. On the H100, 4096 keys x 40
// dims of K and V are 640 KB, past the 227 KB of shared memory a block can
// hold, so this kernel loops over 64-key tiles with an online softmax
// (running max and sum, rescaling the output accumulator): the same exact
// function, reached another way.
//
// Layout: a block takes 64 queries of one (batch, head); each of its 4 warps
// owns 16 query rows. Scores S = Q K^T and the output O = P V run on
// mma.sync m16n8k16 (bf16 in, fp32 accumulate). The score accumulators are
// re-used in registers as the A operand of P V, so P never touches shared
// memory. Scores, the running max and the row sum are fp32; Q is pre-scaled
// by scale * log2(e) (rounded to bf16, as the TPU kernel does) and the
// exponentials are exp2.
//
// D (40, 80, 160) is not a multiple of 16: shared-memory tiles are DP =
// round_up(D, 16) wide and the pad columns are zero-filled once. Device
// memory is never padded. K/V tiles are double-buffered with cp.async.
//
// Bound on the H100: 4 * Sq * Sk * D operations on (2 Sq + 2 Sk) * H * D * 2
// bytes; at Sk = 4096, D = 40 that is about 1300 operations a byte:
// tensor-core bound, with the softmax's exp2 and the narrow D (40 of 48
// columns useful) as the overheads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int ATT_THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
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

// Rows [row0, row0 + 64) of one head into a [64][LD] tile; rows past `rows`
// are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int row0, int rows, int ld) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += ATT_THREADS) {
    const int r = c / CH;
    const int d = (c % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(tile + r * LD + d, ok ? base + (size_t)(row0 + r) * ld + d : base, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq,
                 int Sk, int H, float qscale) {
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

  if (DP != D) {  // zero the pad columns of all five tiles once
    const __nv_bfloat16 z = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < 5 * 64 * (DP - D); i += ATT_THREADS) {
      const int t = i / (64 * (DP - D));
      const int rem = i % (64 * (DP - D));
      sq[t * TILE + (rem / (DP - D)) * LD + D + rem % (DP - D)] = z;
    }
  }
  load_tile<D, LD>(sq, qb, q0, Sq, ld);
  load_tile<D, LD>(sk, kb, 0, Sk, ld);
  load_tile<D, LD>(sv, vb, 0, Sk, ld);
  asm volatile("cp.async.commit_group;\n" ::);

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
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
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
        if (key >= Sk) s[nt][e] = -__int_as_float(0x7f800000);  // -inf
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
    lrow[i] = 1.0f / lrow[i];
  }
  __nv_bfloat16* ob = out + (size_t)b * Sq * ld + h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + i * 8;
    if (row >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * ld + col) =
            pack2(o[dt][2 * i] * lrow[i], o[dt][2 * i + 1] * lrow[i]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
           float qscale, cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int smem = 5 * 64 * (DP + 8) * 2;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attention_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Sq, H*D), k and v: (B, Sk, H*D), out: (B, Sq, H*D), all contiguous
// bf16. Head dims are SD-1.5's 40, 80 and 160; any other returns
// cudaErrorInvalidValue.
extern "C" int gmdx_attention(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                              int Sk, int H, int D, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch<40>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    case 80: return launch<80>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    case 160: return launch<160>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
