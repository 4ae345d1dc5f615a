// Transformer feed-forward tail: s = x + a, h = LayerNorm(s),
// out = (h @ W1a + b1a) * gelu_erf(h @ W1b + b1b) @ W2 + b2 + s, over bf16
// tokens (M, dim) with dim 320, 640 or 1280.
//
// Replaces gmdx/kernels/geglu_ff.py:geglu_ff_ln with add= (TPU kernels
// _ff_add_ln_kernel and _ff_ln_kernel, which covered dims 320 and 640 only).
//
// gmdx_geglu_ff replaces gmdx/kernels/geglu_ff.py:geglu_ff (TPU kernel
// _ff_kernel, pallas_call in _ff_pallas): the same two GEMMs without the
// LayerNorm, out = GEGLU(x) @ W2 + b2 + residual. GEMM1 reads x with a plain
// cp.async loader; GEMM2 is the same kernel, with the residual in place of
// the summed stream (and no add without one). Same bound: 24 * M * dim^2
// operations, tensor-core bound at dims 320 and 640, the dims the JAX rule
// gives it.
//
// Two launches of the shared tile GEMM (gemm_tile.cuh):
//   1. GEMM1 with the add + LayerNorm in its A loader and the GEGLU in its
//      epilogue. Each block first takes fp32 row statistics of s for its
//      128 tokens; the loader then forms h slice by slice in shared memory.
//      A tile holds 64 hidden and the matching 64 gate columns of W1, so the
//      (tokens, 8*dim) pre-activation never goes to device memory; only the
//      (tokens, 4*dim) product does.
//   2. GEMM2 over that product with b2 and the residual s (recomputed from x
//      and a, rounded to bf16 as the plain version does) in its epilogue.
//
// Bound on the H100: 2 * M * dim * 12 * dim operations on about
// (3 * dim + 4 * dim) * 2 bytes a token plus the weights, some 1000
// operations a byte at dim 320: tensor-core bound. The (tokens, 4*dim)
// round trip through device memory is what a later fused version removes.
#include "gemm_tile.cuh"

using namespace gmdx;

namespace {

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// A loader of GEMM1: h = LN(bf16(x + a)) for 8 channels at a time, using the
// per-row mean and rstd the block computed before the K loop.
struct LnALoader {
  const __nv_bfloat16* x;
  const __nv_bfloat16* a;  // may be null
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const float* stats;  // shared: mean[BM], rstd[BM]
  int M, K;

  __device__ __forceinline__ void operator()(__nv_bfloat16* sa, int m0, int k0, int tid) const {
    const int kc = (tid & 3) * 8;
    const int k = k0 + kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + i * 64;
      const int m = m0 + r;
      float h[8];
      if (m < M && k < K) {
        float xv[8], g[8], bt[8];
        load8(x + (size_t)m * K + k, xv);
        if (a != nullptr) {
          float av[8];
          load8(a + (size_t)m * K + k, av);
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = bf16_round(xv[e] + av[e]);
        }
        load8(gamma + k, g);
        load8(beta + k, bt);
        const float mean = stats[r];
        const float rstd = stats[BM + r];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = (xv[e] - mean) * rstd * g[e] + bt[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = 0.0f;
      }
      *reinterpret_cast<uint4*>(sa + r * LDS + kc) = pack8(h);
    }
  }
};

// Two-pass fp32 statistics of s = bf16(x + a) for the block's rows.
__device__ void row_stats(const __nv_bfloat16* x, const __nv_bfloat16* a, int M, int K, float eps,
                          int m0, float* stats) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
    const int m = m0 + r;
    float mean = 0.0f, rstd = 0.0f;
    if (m < M) {
      float sum = 0.0f;
      for (int k = lane * 8; k < K; k += 256) {
        float xv[8];
        load8(x + (size_t)m * K + k, xv);
        if (a != nullptr) {
          float av[8];
          load8(a + (size_t)m * K + k, av);
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = bf16_round(xv[e] + av[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += xv[e];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      mean = sum / K;
      float sq = 0.0f;
      for (int k = lane * 8; k < K; k += 256) {
        float xv[8];
        load8(x + (size_t)m * K + k, xv);
        if (a != nullptr) {
          float av[8];
          load8(a + (size_t)m * K + k, av);
#pragma unroll
          for (int e = 0; e < 8; ++e) xv[e] = bf16_round(xv[e] + av[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = xv[e] - mean;
          sq += d * d;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      rstd = rsqrtf(sq / K + eps);
    }
    if (lane == 0) {
      stats[r] = mean;
      stats[BM + r] = rstd;
    }
  }
  __syncthreads();
}

// GEMM1's epilogue: act = (hidden + b1a) * gelu_erf(gate + b1b) for the
// tile's 64 hidden columns and their 64 gate columns.
__device__ __forceinline__ void geglu_epilogue(const float* ct, const __nv_bfloat16* b1,
                                               __nv_bfloat16* act, int m0, int nh0, int M,
                                               int inner) {
  for (int c = threadIdx.x; c < BM * (BN / 16); c += GEMM_THREADS) {
    const int r = c / (BN / 16);
    const int j = (c % (BN / 16)) * 8;
    const int m = m0 + r;
    const int n = nh0 + j;
    if (m >= M || n >= inner) continue;
    float bh[8], bg[8], v[8];
    load8(b1 + n, bh);
    load8(b1 + inner + n, bg);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float hid = ct[r * LDC + j + e] + bh[e];
      const float gate = ct[r * LDC + BN / 2 + j + e] + bg[e];
      v[e] = hid * gelu_erf(gate);
    }
    *reinterpret_cast<uint4*>(act + (size_t)m * inner + n) = pack8(v);
  }
}

__global__ void __launch_bounds__(GEMM_THREADS)
ff_gemm1_kernel(LnALoader al, WeightLoader bl, const __nv_bfloat16* __restrict__ b1,
                __nv_bfloat16* __restrict__ act, int M, int inner, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stats = reinterpret_cast<float*>(smem + GEMM_SMEM_BYTES);
  const int m0 = blockIdx.x * BM;
  const int nh0 = blockIdx.y * (BN / 2);
  row_stats(al.x, al.a, M, al.K, eps, m0, stats);
  al.stats = stats;
  geglu_epilogue(gemm_tile(al, bl, m0, nh0, al.K, smem), b1, act, m0, nh0, M, inner);
}

// GEMM1 of the LN-free feed-forward (gmdx_geglu_ff): x straight from memory.
__global__ void __launch_bounds__(GEMM_THREADS)
geglu_gemm1_kernel(RowALoader al, WeightLoader bl, const __nv_bfloat16* __restrict__ b1,
                   __nv_bfloat16* __restrict__ act, int M, int inner) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int nh0 = blockIdx.y * (BN / 2);
  geglu_epilogue(gemm_tile(al, bl, m0, nh0, al.K, smem), b1, act, m0, nh0, M, inner);
}

__global__ void __launch_bounds__(GEMM_THREADS)
ff_gemm2_kernel(RowALoader al, WeightLoader bl, const __nv_bfloat16* __restrict__ b2,
                const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                __nv_bfloat16* __restrict__ out, int M, int dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float* ct = gemm_tile(al, bl, m0, n0, al.K, smem);
  for (int c = threadIdx.x; c < BM * (BN / 8); c += GEMM_THREADS) {
    const int r = c / (BN / 8);
    const int j = (c % (BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + j;
    if (m >= M || n >= dim) continue;
    float bv[8], xv[8] = {}, v[8];
    load8(b2 + n, bv);
    if (x != nullptr) load8(x + (size_t)m * dim + n, xv);
    if (a != nullptr) {
      float av[8];
      load8(a + (size_t)m * dim + n, av);
#pragma unroll
      for (int e = 0; e < 8; ++e) xv[e] = bf16_round(xv[e] + av[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ct[r * LDC + j + e] + bv[e] + xv[e];
    *reinterpret_cast<uint4*>(out + (size_t)m * dim + n) = pack8(v);
  }
}

}  // namespace

// w1: (2 * inner, dim) rows [hidden | gate]; w2: (dim, inner); act: (M, inner)
// scratch. Every pointer is bf16; a may be null.
extern "C" int gmdx_geglu_ff_ln(const void* x, const void* a, const void* gamma, const void* beta,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* act, void* out, int M, int dim, int inner, float eps,
                                void* stream) {
  static bool attr = false;
  const int smem1 = GEMM_SMEM_BYTES + 2 * BM * 4;
  if (!attr) {
    cudaFuncSetAttribute(ff_gemm1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    cudaFuncSetAttribute(ff_gemm2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GEMM_SMEM_BYTES);
    attr = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(a);

  LnALoader al1{xb, ab, static_cast<const __nv_bfloat16*>(gamma),
                static_cast<const __nv_bfloat16*>(beta), nullptr, M, dim};
  WeightLoader bl1{static_cast<const __nv_bfloat16*>(w1), inner, dim, inner};
  dim3 g1((M + BM - 1) / BM, (inner + BN / 2 - 1) / (BN / 2));
  ff_gemm1_kernel<<<g1, GEMM_THREADS, smem1, st>>>(al1, bl1, static_cast<const __nv_bfloat16*>(b1),
                                                   static_cast<__nv_bfloat16*>(act), M, inner, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  RowALoader al2{static_cast<const __nv_bfloat16*>(act), M, inner};
  WeightLoader bl2{static_cast<const __nv_bfloat16*>(w2), dim, inner, 0};
  dim3 g2((M + BM - 1) / BM, (dim + BN - 1) / BN);
  ff_gemm2_kernel<<<g2, GEMM_THREADS, GEMM_SMEM_BYTES, st>>>(
      al2, bl2, static_cast<const __nv_bfloat16*>(b2), xb, ab, static_cast<__nv_bfloat16*>(out), M,
      dim);
  return static_cast<int>(cudaGetLastError());
}

// The LN-free feed-forward: x, residual (may be null), out: (M, dim); w1, b1,
// w2, b2 and the (M, inner) scratch act as for gmdx_geglu_ff_ln.
extern "C" int gmdx_geglu_ff(const void* x, const void* residual, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* act, void* out, int M, int dim,
                             int inner, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(geglu_gemm1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GEMM_SMEM_BYTES);
    cudaFuncSetAttribute(ff_gemm2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GEMM_SMEM_BYTES);
    attr = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowALoader al1{static_cast<const __nv_bfloat16*>(x), M, dim};
  WeightLoader bl1{static_cast<const __nv_bfloat16*>(w1), inner, dim, inner};
  dim3 g1((M + BM - 1) / BM, (inner + BN / 2 - 1) / (BN / 2));
  geglu_gemm1_kernel<<<g1, GEMM_THREADS, GEMM_SMEM_BYTES, st>>>(
      al1, bl1, static_cast<const __nv_bfloat16*>(b1), static_cast<__nv_bfloat16*>(act), M, inner);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  RowALoader al2{static_cast<const __nv_bfloat16*>(act), M, inner};
  WeightLoader bl2{static_cast<const __nv_bfloat16*>(w2), dim, inner, 0};
  dim3 g2((M + BM - 1) / BM, (dim + BN - 1) / BN);
  ff_gemm2_kernel<<<g2, GEMM_THREADS, GEMM_SMEM_BYTES, st>>>(
      al2, bl2, static_cast<const __nv_bfloat16*>(b2),
      static_cast<const __nv_bfloat16*>(residual), nullptr, static_cast<__nv_bfloat16*>(out), M,
      dim);
  return static_cast<int>(cudaGetLastError());
}
