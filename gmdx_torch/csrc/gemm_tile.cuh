// Shared tile-GEMM device routine for the conv and feed-forward kernels.
//
// C[M, N] = A[M, K] @ B[N, K]^T on bf16 tensor cores (WMMA 16x16x16, fp32
// accumulate). A block computes one BM x BN output tile with 8 warps (2 x 4,
// each warp 64 x 32); the K loop runs over BK-deep slices held in shared
// memory, double-buffered with cp.async so that the next slice's loads are in
// flight while the current one is multiplied.
//
// The three hooks a kernel supplies:
//   * an A loader that writes the [BM][BK] slice for (m0, k0) into shared
//     memory (a plain row-major read, an implicit im2col gather, or a
//     LayerNorm computed on the fly);
//   * a B loader that does the same for the [BN][BK] slice of the weight,
//     which is always stored (N, K) row-major, the layout of a torch Linear
//     weight, so that a slice row is 8-element (16-byte) chunks along K;
//   * an epilogue that reads the fp32 tile from shared memory and writes the
//     output (bias, GEGLU, residual) as bf16.
//
// This is the simple first version: mma through WMMA and cp.async double
// buffering. wgmma and TMA are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gmdx {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int SKEW = 8;              // bf16 elements of row padding
constexpr int LDS = BK + SKEW;       // shared row stride of the A and B slices
constexpr int LDC = BN + 4;          // shared row stride of the fp32 C tile
constexpr int GEMM_THREADS = 256;
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr int PIPE_BYTES = 2 * STAGE_ELEMS * 2;
constexpr int CTILE_BYTES = BM * LDC * 4;
constexpr int GEMM_SMEM_BYTES = PIPE_BYTES > CTILE_BYTES ? PIPE_BYTES : CTILE_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// B slice loader for an (N, K) row-major weight. With split > 0 the tile's
// first BN/2 rows are weight rows [nh0, nh0 + BN/2) and the last BN/2 are
// rows [split + nh0, ...): the hidden and gate halves of a GEGLU projection
// side by side, so one tile holds both operands of its output columns.
struct WeightLoader {
  const __nv_bfloat16* w;
  int n_rows;  // N (split == 0) or the half width (split > 0)
  int K;
  int split;

  __device__ __forceinline__ void operator()(__nv_bfloat16* sb, int n0, int k0, int tid) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * GEMM_THREADS;  // 512 chunks: 128 rows x 4
      int r = c >> 2;
      int kc = (c & 3) * 8;
      int k = k0 + kc;
      int n;
      bool ok;
      if (split > 0) {
        int j = r & (BN / 2 - 1);
        ok = n0 + j < n_rows;
        n = (r < BN / 2 ? 0 : split) + n0 + j;
      } else {
        n = n0 + r;
        ok = n < n_rows;
      }
      ok = ok && k < K;
      const __nv_bfloat16* src = ok ? w + (size_t)n * K + k : w;
      cp_async16(sb + r * LDS + kc, src, ok);
    }
  }
};

// A slice loader for a plain (M, K) row-major bf16 operand.
struct RowALoader {
  const __nv_bfloat16* a;
  int M, K;

  __device__ __forceinline__ void operator()(__nv_bfloat16* sa, int m0, int k0, int tid) const {
    const int kc = (tid & 3) * 8;
    const int k = k0 + kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + i * 64;
      const int m = m0 + r;
      const bool ok = m < M && k < K;
      cp_async16(sa + r * LDS + kc, ok ? a + (size_t)m * K + k : a, ok);
    }
  }
};

// One output tile: runs the K loop and leaves the fp32 result in shared
// memory (row stride LDC) for the epilogue. `smem` holds GEMM_SMEM_BYTES.
template <class ALoad, class BLoad>
__device__ __forceinline__ float* gemm_tile(const ALoad& aload, const BLoad& bload, int m0, int n0,
                                            int K, unsigned char* smem) {
  using namespace nvcuda;
  __nv_bfloat16* pipe = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 0..1: 64-row band
  const int wn = warp & 3;   // 0..3: 32-column band

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + BK - 1) / BK;
  aload(pipe, m0, 0, tid);
  bload(pipe + BM * LDS, n0, 0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      __nv_bfloat16* st = pipe + ((kt + 1) & 1) * STAGE_ELEMS;
      aload(st, m0, (kt + 1) * BK, tid);
      bload(st + BM * LDS, n0, (kt + 1) * BK, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* sa = pipe + (kt & 1) * STAGE_ELEMS;
    const __nv_bfloat16* sb = sa + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* ctile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ctile + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  return ctile;
}

}  // namespace gmdx
