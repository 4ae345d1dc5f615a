// Flash attention backward for a 512-wide head over head-packed
// (B, S, H*512) bf16: the VAE mid block's single head under Stage-1
// training, 16384 tokens at 1024^2.
//
// Replaces gmdx/kernels/flash_attention.py:_flash_backward (TPU kernels
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel) at D = 512;
// flash_attention.cu's gmdx_flash_bwd dispatches here for that head dim,
// after the dd = rowsum(dO * O) pre-pass (flash_bwd_dd_kernel). Given the
// base-2 logsumexp of attention_wide.cuh's forward, with c = scale * log2 e:
//   Qs = bf16(Q * c)                    (the forward's rounding, in place)
//   P  = exp2(Qs K^T - lse)             (0 for keys past Sk)
//   dV = P^T dO,  dS = P (dO V^T - dd),  dK = dS^T Qs * ln 2,  dQ = dS K * scale
// P and dS are rounded to bf16 before their products, as the TPU kernels do.
// Recomputing P from the same bf16 Qs that wrote lse makes its rows sum to
// one; from an unrounded Q they would miss by about bf16 epsilon, a bias in
// every gradient.
//
// Why not attention_sm90.cuh's backward, which the narrow heads run: its
// dK/dV block keeps 128 keys x D of both accumulators in registers, 2 x 256
// fp32 a consumer thread at D = 512, and K, V for 64 keys alone take 128 KB
// of shared memory. So this kernel takes the forward's shape:
//   * Two kernels, each block owning 32 rows: dkv owns 32 keys (K, V
//     resident) and streams (Q, dO) tiles of 32 queries; dq owns 32 queries
//     (Qs, dO resident) and streams (K, V) tiles of 32 keys. Tiles arrive
//     by cp.async, double-buffered. 8 warps (256 threads) a block.
//   * Per tile, the two 32 x 32 products over all 512 dims (S and dP, or
//     S^T and dP^T in dkv) go to warps 0-3 and 4-7, a 16 x 16 block a warp
//     (mma.sync m16n8k16, operands by ldmatrix), fp32 results to shared
//     memory; all 256 threads then form P and dS (bf16) there.
//   * The accumulating products (dV and dK in dkv, dQ in dq) split D: warp
//     w owns the 64 columns [64 w, +64) of all 32 rows, so dK and dV take
//     2 x 2 x 8 fragments = 128 fp32 a thread (dQ 64), the forward's
//     budget; A (P^T, dS^T or dS) by ldmatrix, B (dO, Qs or K) by
//     ldmatrix.trans.
// Extra work: both kernels recompute S and dP, 14 B H Sq Sk D operations for
// the function's 10, and every block streams the whole other side (Q and dO
// Sk / 32 times, K and V Sq / 32 times, from L2: 32 MB at 16384 tokens).
// No atomics: every gradient row has one writer, so repeats are
// bit-identical.
// Shared memory: the resident pair 2 x 32 x 520 and the streamed pair 2 x 2
// x 32 x 520 bf16 (rows padded by 8 so that ldmatrix is free of bank
// conflicts), two 32 x 36 fp32 score tiles, two 32 x 40 bf16 tiles: 214,016
// bytes, one block an SM.
//
// Bound on the H100: 10 B H Sq Sk D operations; at B 1, S 16384, D 512 that
// is 1.37 TFLOP, 1.39 ms at the bf16 peak, against 0.14 ms for its exp2 (two
// a score, one in each kernel, at about 3.9 T/s) and 0.07 ms for its bytes:
// operations-bound. mma.sync from shared memory caps the rate well below
// the peak; the wgmma/TMA rebuild of both 512-wide kernels is ROADMAP work.
#pragma once

#include "attention_wide.cuh"

namespace gmdx_wide {

constexpr int BR = 32;               // rows a block owns
constexpr int BT = 32;               // rows a streamed tile holds
constexpr int FLD = BT + 4;          // row stride of the fp32 score tiles
constexpr int HLD = BT + 8;          // row stride of the bf16 P / dS tiles
constexpr float LN2 = 0.69314718055994531f;
constexpr int BWD_SMEM = (2 * BR + 4 * BT) * WLD * 2 + 2 * BR * FLD * 4 + 2 * BR * HLD * 2;

// Qs = bf16(Q * c) in place over a [NR][WLD] tile, as the forward rounds it.
template <int NR>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* tile, float c) {
  constexpr int P2 = WD / 2;
  for (int i = threadIdx.x; i < NR * P2; i += WTHREADS) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(tile + (i / P2) * WLD + (i % P2) * 2);
    const float2 f = __bfloat1622float2(*p);
    *p = __floats2bfloat162_rn(f.x * c, f.y * c);
  }
}

// f1 = a1 b1^T and f2 = a2 b2^T, each 32 x 32 over the 512 dims of [32][WLD]
// tiles, into [32][FLD] fp32: warps 0-3 the first, 4-7 the second, a 16 x 16
// block a warp.
__device__ __forceinline__ void score_products(const __nv_bfloat16* a1, const __nv_bfloat16* b1,
                                               const __nv_bfloat16* a2, const __nv_bfloat16* b2,
                                               float* f1, float* f2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool second = warp >= 4;
  const int mt = warp & 1;
  const int nh = (warp >> 1) & 1;
  const __nv_bfloat16* ap = (second ? a2 : a1) + (16 * mt + (lane & 15)) * WLD + (lane >> 4) * 8;
  const __nv_bfloat16* bp = (second ? b2 : b1) +
                            (16 * nh + (lane & 7) + ((lane >> 4) << 3)) * WLD +
                            ((lane >> 3) & 1) * 8;
  float c[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
#pragma unroll 8
  for (int kc = 0; kc < WD / 16; ++kc) {
    uint32_t a[4], b[4];
    ldsm_x4(a, ap + kc * 16);
    ldsm_x4(b, bp + kc * 16);
    mma16816(c[0], a, b[0], b[1]);
    mma16816(c[1], a, b[2], b[3]);
  }
  float* f = second ? f2 : f1;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[(16 * mt + g + (e >> 1) * 8) * FLD + 16 * nh + nt * 8 + 2 * t + (e & 1)] = c[nt][e];
}

// acc (32 rows x this warp's 64 columns [c0, +64)) += x y: x [32][HLD] bf16
// (32 x BT), y [BT][WLD] bf16 (BT x 512).
__device__ __forceinline__ void accumulate(float (&acc)[2][8][4], const __nv_bfloat16* x,
                                           const __nv_bfloat16* y, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc) {
    uint32_t bv[8][2];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t r4[4];
      ldsm_x4_t(r4, y + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + c0 + 16 * np +
                        (lane >> 4) * 8);
      bv[2 * np][0] = r4[0];
      bv[2 * np][1] = r4[1];
      bv[2 * np + 1][0] = r4[2];
      bv[2 * np + 1][1] = r4[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[4];
      ldsm_x4(a, x + (16 * mt + (lane & 15)) * HLD + 16 * kc + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma16816(acc[mt][nt], a, bv[nt][0], bv[nt][1]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
}

// Rows [row0, row0 + 32) of one head (those below `rows`) from acc * f, bf16.
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, const float (&acc)[2][8][4],
                                          float f, int row0, int rows, int ld, int c0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * mt + g + 8 * i;
      if (row0 + r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<uint32_t*>(base + (size_t)(row0 + r) * ld + c0 + nt * 8 + 2 * t) =
            pack2(acc[mt][nt][2 * i] * f, acc[mt][nt][2 * i + 1] * f);
    }
}

// dK, dV (B, Sk, H*512) for 32 keys a block; grid (ceil(Sk/32), H, B).
__global__ void __launch_bounds__(WTHREADS, 1)
flash_bwd_wide_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ dd, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float c) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + BR * WLD;
  __nv_bfloat16* sq = sv + BR * WLD;       // 2 stages
  __nv_bfloat16* sdo = sq + 2 * BT * WLD;  // 2 stages
  float* f1 = reinterpret_cast<float*>(sdo + 2 * BT * WLD);
  float* f2 = f1 + BR * FLD;
  __nv_bfloat16* hp = reinterpret_cast<__nv_bfloat16*>(f2 + BR * FLD);
  __nv_bfloat16* hds = hp + BR * HLD;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BR;
  const int ld = H * WD;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * ld + h * WD;
  const __nv_bfloat16* dob = dout + (size_t)b * Sq * ld + h * WD;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * ld + h * WD;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * ld + h * WD;
  const float* lrow = lse + ((size_t)b * H + h) * Sq;
  const float* drow = dd + ((size_t)b * H + h) * Sq;
  const int c0 = 64 * (threadIdx.x >> 5);

  load_rows<BR>(sk, kb, k0, Sk, ld);
  load_rows<BR>(sv, vb, k0, Sk, ld);
  load_rows<BT>(sq, qb, 0, Sq, ld);
  load_rows<BT>(sdo, dob, 0, Sq, ld);
  cp_async_commit();

  float acc_dk[2][8][4], acc_dv[2][8][4];
  zero_acc(acc_dk);
  zero_acc(acc_dv);

  const int nq = (Sq + BT - 1) / BT;
  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) {
      load_rows<BT>(sq + ((i + 1) & 1) * BT * WLD, qb, (i + 1) * BT, Sq, ld);
      load_rows<BT>(sdo + ((i + 1) & 1) * BT * WLD, dob, (i + 1) * BT, Sq, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    __nv_bfloat16* qt = sq + (i & 1) * BT * WLD;
    const __nv_bfloat16* dot = sdo + (i & 1) * BT * WLD;
    scale_rows<BT>(qt, c);
    __syncthreads();

    score_products(sk, qt, sv, dot, f1, f2);  // S^T = K Qs^T, dP^T = V dO^T
    __syncthreads();
    const int q0 = i * BT;
    for (int e = threadIdx.x; e < BR * BT; e += WTHREADS) {
      const int r = e / BT;
      const int col = e % BT;
      const bool ok = q0 + col < Sq;  // rows past Sq: zero Q and dO, P = 0
      const float l = ok ? lrow[q0 + col] : -neg_inf();
      const float p = exp2f(f1[r * FLD + col] - l);
      const float ds = p * (f2[r * FLD + col] - (ok ? drow[q0 + col] : 0.0f));
      hp[r * HLD + col] = __float2bfloat16_rn(p);
      hds[r * HLD + col] = __float2bfloat16_rn(ds);
    }
    __syncthreads();

    accumulate(acc_dv, hp, dot, c0);  // dV += P^T dO
    accumulate(acc_dk, hds, qt, c0);  // dK += dS^T Qs
    __syncthreads();
  }

  const size_t off = (size_t)b * Sk * ld + h * WD;
  store_acc(dk + off, acc_dk, LN2, k0, Sk, ld, c0);
  store_acc(dv + off, acc_dv, 1.0f, k0, Sk, ld, c0);
}

// dQ (B, Sq, H*512) for 32 queries a block; grid (ceil(Sq/32), H, B).
__global__ void __launch_bounds__(WTHREADS, 1)
flash_bwd_wide_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dd, __nv_bfloat16* __restrict__ dq, int Sq,
                         int Sk, int H, float c, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + BR * WLD;
  __nv_bfloat16* sk = sdo + BR * WLD;     // 2 stages
  __nv_bfloat16* sv = sk + 2 * BT * WLD;  // 2 stages
  float* f1 = reinterpret_cast<float*>(sv + 2 * BT * WLD);
  float* f2 = f1 + BR * FLD;
  __nv_bfloat16* hds = reinterpret_cast<__nv_bfloat16*>(f2 + BR * FLD);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BR;
  const int ld = H * WD;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * ld + h * WD;
  const __nv_bfloat16* dob = dout + (size_t)b * Sq * ld + h * WD;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * ld + h * WD;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * ld + h * WD;
  const float* lrow = lse + ((size_t)b * H + h) * Sq;
  const float* drow = dd + ((size_t)b * H + h) * Sq;
  const int c0 = 64 * (threadIdx.x >> 5);

  load_rows<BR>(sq, qb, q0, Sq, ld);
  load_rows<BR>(sdo, dob, q0, Sq, ld);
  load_rows<BT>(sk, kb, 0, Sk, ld);
  load_rows<BT>(sv, vb, 0, Sk, ld);
  cp_async_commit();

  float acc[2][8][4];
  zero_acc(acc);

  const int nk = (Sk + BT - 1) / BT;
  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {
      load_rows<BT>(sk + ((j + 1) & 1) * BT * WLD, kb, (j + 1) * BT, Sk, ld);
      load_rows<BT>(sv + ((j + 1) & 1) * BT * WLD, vb, (j + 1) * BT, Sk, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      scale_rows<BR>(sq, c);
      __syncthreads();
    }
    const __nv_bfloat16* kt = sk + (j & 1) * BT * WLD;
    const __nv_bfloat16* vt = sv + (j & 1) * BT * WLD;

    score_products(sq, kt, sdo, vt, f1, f2);  // S = Qs K^T, dP = dO V^T
    __syncthreads();
    const int key0 = j * BT;
    for (int e = threadIdx.x; e < BR * BT; e += WTHREADS) {
      const int r = e / BT;
      const int col = e % BT;
      const bool row_ok = q0 + r < Sq;
      const float l = row_ok ? lrow[q0 + r] : -neg_inf();
      const float p = key0 + col < Sk ? exp2f(f1[r * FLD + col] - l) : 0.0f;
      const float ds = p * (f2[r * FLD + col] - (row_ok ? drow[q0 + r] : 0.0f));
      hds[r * HLD + col] = __float2bfloat16_rn(ds);
    }
    __syncthreads();

    accumulate(acc, hds, kt, c0);  // dQ += dS K
    __syncthreads();
  }

  store_acc(dq + (size_t)b * Sq * ld + h * WD, acc, scale, q0, Sq, ld, c0);
}

inline int launch_wide_bwd(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* dd, void* dq, void* dk, void* dv, int B,
                           int Sq, int Sk, int H, float scale, float c, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(flash_bwd_wide_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         BWD_SMEM);
    cudaFuncSetAttribute(flash_bwd_wide_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         BWD_SMEM);
    attr = true;
  }
  if (B == 0 || Sq == 0 || Sk == 0) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const bf* dop = static_cast<const bf*>(dout);
  flash_bwd_wide_dkv_kernel<<<dim3((Sk + BR - 1) / BR, H, B), WTHREADS, BWD_SMEM, stream>>>(
      qp, kp, vp, dop, lse, dd, static_cast<bf*>(dk), static_cast<bf*>(dv), Sq, Sk, H, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_wide_dq_kernel<<<dim3((Sq + BR - 1) / BR, H, B), WTHREADS, BWD_SMEM, stream>>>(
      qp, kp, vp, dop, lse, dd, static_cast<bf*>(dq), Sq, Sk, H, c, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gmdx_wide
