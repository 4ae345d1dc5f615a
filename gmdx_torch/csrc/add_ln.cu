// Fused residual add + LayerNorm over bf16 tokens (M, C):
// s = bf16(x + y), h = (s - mean) * rsqrt(var + eps) * gamma + beta, with the
// mean and variance of the rounded s taken in fp32 and gamma, beta fp32.
//
// Replaces gmdx/kernels/geglu_ff.py:add_layer_norm (TPU kernel _add_ln_kernel,
// pallas_call in _add_ln_pallas): the transformer block's attn1 residual and
// norm2 under the fused_addln option. The TPU kernel took blocks of 256-1024
// tokens through VMEM; here one warp owns a token row and keeps it in
// registers (up to 8 chunks of 8 channels a lane, C <= 2048), so the row is
// read once, the sum written once, and the statistics are two warp
// reductions over registers (the variance about the mean, as the TPU kernel
// takes it).
//
// Bound on the H100: bytes, two bf16 reads and two bf16 writes an element
// (8 bytes against ~10 operations). 16-byte loads and stores, one row a
// warp, 8 rows a block.
#include "bf16x8.cuh"

using namespace gmdx;

namespace {

constexpr int ROWS_PER_BLOCK = 8;
constexpr int MAX_CHUNKS = 8;  // 8 x 32 lanes x 8 channels = 2048

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
add_ln_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              __nv_bfloat16* __restrict__ s_out, __nv_bfloat16* __restrict__ h_out, int M, int C,
              float eps) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (m >= M) return;
  const size_t base = (size_t)m * C;

  float sv[MAX_CHUNKS][8];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < C) {
      float xv[8], yv[8];
      load8(x + base + k, xv);
      load8(y + base + k, yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sv[i][e] = bf16_round(xv[e] + yv[e]);
        sum += sv[i][e];
      }
      *reinterpret_cast<uint4*>(s_out + base + k) = pack8(sv[i]);
    }
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if ((i * 32 + lane) * 8 < C) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = sv[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    const int k = (i * 32 + lane) * 8;
    if (k < C) {
      const float4* gp = reinterpret_cast<const float4*>(gamma + k);
      const float4* bp = reinterpret_cast<const float4*>(beta + k);
      const float4 g0 = gp[0], g1 = gp[1], b0 = bp[0], b1 = bp[1];
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float hv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) hv[e] = (sv[i][e] - mean) * rstd * g[e] + bt[e];
      *reinterpret_cast<uint4*>(h_out + base + k) = pack8(hv);
    }
  }
}

}  // namespace

// x, y, s_out, h_out: (M, C) contiguous bf16; gamma, beta: (C,) fp32.
// C % 8 == 0 and C <= 2048, else cudaErrorInvalidValue.
extern "C" int gmdx_add_ln(const void* x, const void* y, const void* gamma, const void* beta,
                           void* s_out, void* h_out, int M, int C, float eps, void* stream) {
  if (C % 8 != 0 || C > MAX_CHUNKS * 256) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  add_ln_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<__nv_bfloat16*>(s_out), static_cast<__nv_bfloat16*>(h_out), M, C, eps);
  return static_cast<int>(cudaGetLastError());
}
