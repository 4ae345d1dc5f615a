// Flash attention for training over head-packed (B, S, H*D) bf16: the
// forward that also writes the base-2 logsumexp, and the two backward
// kernels that recompute the softmax blockwise from (Q, K, LSE).
//
// Replaces gmdx/kernels/flash_attention.py:_flash_forward (TPU kernel
// _flash_kernel) and _flash_backward (_flash_bwd_dkv_kernel,
// _flash_bwd_dq_kernel). The function is the TPU's; the layout is not: the
// TPU kernels took (B*H, S, D) after an XLA transpose, these kernels index
// the head-packed projections in place with a row stride of H*D.
//
// Forward: attention_fwd.cuh with LSE on. lse (B, H, Sq) fp32 holds
// m + log2(l) of the logits pre-scaled by scale * log2(e). The VAE's single
// 512-wide head takes attention_wide.cuh's kernel instead (its header says
// why).
//
// Backward, as the TPU split it (the TPU's dQ-in-dKV fusion was a measured
// loss there; on this card an atomics-based dQ is a later choice):
//   dkv: grid (ceil(Sk/64), H, B). A block owns 64 keys, each of its 4 warps
//        16 of them, and walks the queries in tiles of NQ. Per tile, with
//        Qs = bf16(Q * scale * log2(e)):
//          S^T = K Qs^T,  P^T = exp2(S^T - lse),  dV += P^T dO,
//          dP^T = V dO^T, dS^T = P^T (dP^T - dd),  dK += dS^T Qs,
//        and at the end dK *= 1 / log2(e). dd = rowsum(dO * O) comes from
//        the wrapper (fp32, (B, H, Sq)).
//   dq:  grid (ceil(Sq/64), H, B). A block owns 64 queries and walks the
//        keys in tiles of 64: S = Qs K^T, P = exp2(S - lse), dP = dO V^T,
//        dS = P (dP - dd), dQ += dS K; at the end dQ *= scale.
// Every product runs on mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// score-shaped accumulators (P^T, dS^T, dS) are re-used in registers as
// the A operand of the next product, so they never touch shared memory.
// The A operands that stay fixed over the loop (K, V in dkv; Qs, dO in dq)
// are read from shared memory at each use rather than held in registers:
// at D = 160 the two fp32 accumulators of dkv alone take 160 registers a
// thread. For the same reason dkv takes 32-query tiles at D = 160.
//
// Ragged edges: keys past Sk are zero rows of K/V, masked to P = 0 in dq
// and never written in dkv; queries past Sq have Q = dO = 0, lse = dd = 0
// and are masked to P = 0 in dkv and never written in dq.
//
// Bound on the H100: operations. The backward does 14 * Sq * Sk * D (seven
// products of 2 Sq Sk D: S and dP in both kernels, then dV, dK and dQ) on
// about 16 S H D bytes; at S = 4096, D = 40 that is ~3600 operations a
// byte.
#include "attention_fwd.cuh"
#include "attention_wide.cuh"

namespace {

using namespace gmdx_attn;

constexpr float LN2 = 0.6931471805599453f;  // 1 / log2(e)

// A fragment (16 x 16, row-major) of rows [row0, row0 + 16), k-chunk kc, of
// a shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* tile, int row0, int kc,
                                       int g, int t) {
  const __nv_bfloat16* p = tile + (row0 + g) * LD + kc * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// In place: the first NR rows x D columns of `tile` times qscale, rounded
// to bf16 (the TPU kernels' pre-scaled Q).
template <int D, int LD, int NR>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* tile, float qscale) {
  constexpr int P = D / 2;
  for (int i = threadIdx.x; i < NR * P; i += ATT_THREADS) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(tile + (i / P) * LD + (i % P) * 2);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
  }
}

template <int D>
__host__ __device__ constexpr int dkv_nq() { return D > 80 ? 32 : 64; }

template <int D>
__global__ void __launch_bounds__(ATT_THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                     int Sk, int H, float qscale) {
  constexpr int NQ = dkv_nq<D>();
  constexpr int NT = NQ / 8;   // q n-tiles of S^T, dP^T
  constexpr int QC = NQ / 16;  // q k-chunks of dV, dK
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int KT = 64 * LD;
  constexpr int QT = NQ * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + KT;
  __nv_bfloat16* sq = sv + KT;       // 2 stages
  __nv_bfloat16* sdo = sq + 2 * QT;  // 2 stages
  float* sl = reinterpret_cast<float*>(sdo + 2 * QT);
  float* sd = sl + NQ;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * 64;
  const int ld = H * D;
  const size_t qoff = (size_t)b * Sq * ld + h * D;
  const size_t koff = (size_t)b * Sk * ld + h * D;
  const float* lseb = lse + ((size_t)b * H + h) * Sq;
  const float* ddb = dd + ((size_t)b * H + h) * Sq;

  zero_pad_cols<D, DP, LD, 64>(sk, 2);
  zero_pad_cols<D, DP, LD, NQ>(sq, 4);
  load_tile<D, LD, 64>(sk, k + koff, k0, Sk, ld);
  load_tile<D, LD, 64>(sv, v + koff, k0, Sk, ld);
  load_tile<D, LD, NQ>(sq, q + qoff, 0, Sq, ld);
  load_tile<D, LD, NQ>(sdo, dout + qoff, 0, Sq, ld);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr0 = warp * 16;  // this warp's key rows in the tile

  float acc_dk[DT][4], acc_dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.0f;
  }

  const int nq = (Sq + NQ - 1) / NQ;
  for (int i = 0; i < nq; ++i) {
    const int q0 = i * NQ;
    if (i + 1 < nq) {
      load_tile<D, LD, NQ>(sq + ((i + 1) & 1) * QT, q + qoff, q0 + NQ, Sq, ld);
      load_tile<D, LD, NQ>(sdo + ((i + 1) & 1) * QT, dout + qoff, q0 + NQ, Sq, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    __nv_bfloat16* qt = sq + (i & 1) * QT;
    const __nv_bfloat16* dot = sdo + (i & 1) * QT;
    scale_rows<D, LD, NQ>(qt, qscale);
    for (int r = threadIdx.x; r < NQ; r += ATT_THREADS) {
      const bool ok = q0 + r < Sq;
      sl[r] = ok ? lseb[q0 + r] : 0.0f;
      sd[r] = ok ? ddb[q0 + r] : 0.0f;
    }
    __syncthreads();

    // S^T = K Qs^T, then P^T = exp2(S^T - lse[q]) (0 past Sq).
    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      load_a<LD>(a, sk, kr0, kc, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* qr = qt + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma16816(p[nt], a, ld32(qr), ld32(qr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        p[nt][e] = q0 + col < Sq ? exp2f(p[nt][e] - sl[col]) : 0.0f;
      }
    }

    // dV += P^T dO (P^T's accumulators are the A fragments).
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      uint32_t pa[4];
      pa[0] = pack2(p[2 * c][0], p[2 * c][1]);
      pa[1] = pack2(p[2 * c][2], p[2 * c][3]);
      pa[2] = pack2(p[2 * c + 1][0], p[2 * c + 1][1]);
      pa[3] = pack2(p[2 * c + 1][2], p[2 * c + 1][3]);
      const __nv_bfloat16* d0 = dot + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* dp = d0 + dt * 8;
        mma16816(acc_dv[dt], pa, pack_bf16(dp[0], dp[LD]), pack_bf16(dp[8 * LD], dp[9 * LD]));
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - dd[q]) in place of P^T.
    float dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      load_a<LD>(a, sv, kr0, kc, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* dr = dot + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma16816(dpt[nt], a, ld32(dr), ld32(dr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] *= dpt[nt][e] - sd[nt * 8 + 2 * t + (e & 1)];
    }

    // dK += dS^T Qs.
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      uint32_t da[4];
      da[0] = pack2(p[2 * c][0], p[2 * c][1]);
      da[1] = pack2(p[2 * c][2], p[2 * c][3]);
      da[2] = pack2(p[2 * c + 1][0], p[2 * c + 1][1]);
      da[3] = pack2(p[2 * c + 1][2], p[2 * c + 1][3]);
      const __nv_bfloat16* q0p = qt + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* qp = q0p + dt * 8;
        mma16816(acc_dk[dt], da, pack_bf16(qp[0], qp[LD]), pack_bf16(qp[8 * LD], qp[9 * LD]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dkb = dk + koff;
  __nv_bfloat16* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + kr0 + g + i * 8;
    if (row >= Sk) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)row * ld + col) =
            pack2(acc_dk[dt][2 * i] * LN2, acc_dk[dt][2 * i + 1] * LN2);
        *reinterpret_cast<uint32_t*>(dvb + (size_t)row * ld + col) =
            pack2(acc_dv[dt][2 * i], acc_dv[dt][2 * i + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(ATT_THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, float scale,
                    float qscale) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int KC = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int TILE = 64 * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + TILE;
  __nv_bfloat16* sk = sdo + TILE;     // 2 stages
  __nv_bfloat16* sv = sk + 2 * TILE;  // 2 stages

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * 64;
  const int ld = H * D;
  const size_t qoff = (size_t)b * Sq * ld + h * D;
  const size_t koff = (size_t)b * Sk * ld + h * D;

  zero_pad_cols<D, DP, LD, 64>(sq, 6);
  load_tile<D, LD, 64>(sq, q + qoff, q0, Sq, ld);
  load_tile<D, LD, 64>(sdo, dout + qoff, q0, Sq, ld);
  load_tile<D, LD, 64>(sk, k + koff, 0, Sk, ld);
  load_tile<D, LD, 64>(sv, v + koff, 0, Sk, ld);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int qr0 = warp * 16;

  float lrow[2], drow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + g + i * 8;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lrow[i] = row < Sq ? lse[at] : 0.0f;
    drow[i] = row < Sq ? dd[at] : 0.0f;
  }
  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  const int nkv = (Sk + 63) / 64;
  for (int j = 0; j < nkv; ++j) {
    if (j + 1 < nkv) {
      load_tile<D, LD, 64>(sk + ((j + 1) & 1) * TILE, k + koff, (j + 1) * 64, Sk, ld);
      load_tile<D, LD, 64>(sv + ((j + 1) & 1) * TILE, v + koff, (j + 1) * 64, Sk, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      scale_rows<D, LD, 64>(sq, qscale);
      __syncthreads();
    }
    const __nv_bfloat16* kt = sk + (j & 1) * TILE;
    const __nv_bfloat16* vt = sv + (j & 1) * TILE;

    // S = Qs K^T and dP = dO V^T over this tile's 64 keys.
    float p[8][4], dpv[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = dpv[nt][e] = 0.0f;
    }
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, sq, qr0, kc, g, t);
      load_a<LD>(ado, sdo, qr0, kc, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* kr = kt + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        const __nv_bfloat16* vr = vt + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma16816(p[nt], aq, ld32(kr), ld32(kr + 8));
        mma16816(dpv[nt], ado, ld32(vr), ld32(vr + 8));
      }
    }
    // dS = P (dP - dd), P = exp2(S - lse) (0 past Sk), in place of P.
    const int key0 = j * 64;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        const float pe = key < Sk ? exp2f(p[nt][e] - lrow[e >> 1]) : 0.0f;
        p[nt][e] = pe * (dpv[nt][e] - drow[e >> 1]);
      }
    }
    // dQ += dS K.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t da[4];
      da[0] = pack2(p[2 * c][0], p[2 * c][1]);
      da[1] = pack2(p[2 * c][2], p[2 * c][3]);
      da[2] = pack2(p[2 * c + 1][0], p[2 * c + 1][1]);
      da[3] = pack2(p[2 * c + 1][2], p[2 * c + 1][3]);
      const __nv_bfloat16* k0p = kt + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const __nv_bfloat16* kp = k0p + dt * 8;
        mma16816(acc[dt], da, pack_bf16(kp[0], kp[LD]), pack_bf16(kp[8 * LD], kp[9 * LD]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + qr0 + g + i * 8;
    if (row >= Sq) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(dqb + (size_t)row * ld + col) =
            pack2(acc[dt][2 * i] * scale, acc[dt][2 * i + 1] * scale);
      }
    }
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* dd, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
               float scale, float qscale, cudaStream_t stream) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LD = DP + 8;
  constexpr int NQ = dkv_nq<D>();
  constexpr int smem_dkv = (2 * 64 + 4 * NQ) * LD * 2 + 2 * NQ * 4;
  constexpr int smem_dq = 6 * 64 * LD * 2;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_dkv);
    cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_dq);
    attr = true;
  }
  using bf = __nv_bfloat16;
  const bf* q_ = static_cast<const bf*>(q);
  const bf* k_ = static_cast<const bf*>(k);
  const bf* v_ = static_cast<const bf*>(v);
  const bf* do_ = static_cast<const bf*>(dout);
  flash_bwd_dkv_kernel<D><<<dim3((Sk + 63) / 64, H, B), ATT_THREADS, smem_dkv, stream>>>(
      q_, k_, v_, do_, lse, dd, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, H, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3((Sq + 63) / 64, H, B), ATT_THREADS, smem_dq, stream>>>(
      q_, k_, v_, do_, lse, dd, static_cast<bf*>(dq), Sq, Sk, H, scale, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, Sq, H*D); k, v: (B, Sk, H*D), contiguous bf16; lse: (B, H, Sq)
// fp32. Head dims 40, 80, 160 and 512; any other returns
// cudaErrorInvalidValue.
extern "C" int gmdx_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Sk, int H, int D, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 40: return gmdx_attn::launch_fwd<40, true>(q, k, v, out, l, B, Sq, Sk, H, qscale, st);
    case 80: return gmdx_attn::launch_fwd<80, true>(q, k, v, out, l, B, Sq, Sk, H, qscale, st);
    case 160: return gmdx_attn::launch_fwd<160, true>(q, k, v, out, l, B, Sq, Sk, H, qscale, st);
    case 512: return gmdx_wide::launch_wide(q, k, v, out, l, B, Sq, Sk, H, qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, dout, dq: (B, Sq, H*D); k, v, dk, dv: (B, Sk, H*D), contiguous bf16;
// lse, dd: (B, H, Sq) fp32. Launches the dK/dV kernel, then the dQ kernel.
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
