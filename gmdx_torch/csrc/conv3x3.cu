// 3x3 stride-1 SAME convolution + bias over NHWC bf16, as an implicit GEMM.
//
// Replaces gmdx/kernels/winograd.py:winograd_conv3x3 (TPU kernel
// _wino_kernel, Winograd F(2x2, 3x3)).
//
// out[(b, y, x), o] = bias[o] + sum_{tap, c} in[b, y + ky - 1, x + kx - 1, c] * w[o, tap, c]
// is the product (pixels, 9*C) @ (9*C, O). The A operand is never built in
// device memory: the loader gathers each (128 pixels x 32 k) slice straight
// from the image, one 16-byte chunk of 8 channels at a time (C % 8 == 0, so
// a chunk never crosses a tap), zero-filling taps that fall off the border.
// With pre_padded the input already carries a 1-px zero border (the output of
// the GroupNorm kernel), and every tap is in range.
//
// Why implicit GEMM and not Winograd: on the TPU, F(2x2) cut the matrix-unit
// work 2.25x, and its input/output transforms ran on a vector unit that was
// otherwise idle. On the H100 the transforms would cost shared-memory passes
// and bf16 rounding of the transformed operands, while the direct product is
// one dense GEMM over the full 9*C depth that the tensor cores take as it is.
//
// Bound on the H100: at the UNet's shapes (64^2 x 320 to 8^2 x 1280, batch
// 2B under CFG) the product does 2*M*9C*O operations on M*C + 9*C*O + M*O
// elements, 100-700 operations a byte: tensor-core bound. The design keeps
// the 9x re-read of each input pixel inside L2 and shared memory and feeds
// the tensor cores from shared memory; the weight is repacked once, at load,
// to (O, 9*C) rows so that its slices are contiguous.
#include "gemm_tile.cuh"

using namespace gmdx;

namespace {

struct ConvALoader {
  const __nv_bfloat16* x;
  int Hin, Win, C, K, halo;  // halo: 1 for a raw image, 0 for a pre-padded one
  int M, H, W;

  __device__ __forceinline__ void operator()(__nv_bfloat16* sa, int m0, int k0, int tid) const {
    const int kc = (tid & 3) * 8;
    const int k = k0 + kc;
    const int tap = k / C;
    const int ci = k - tap * C;
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + i * 64;
      const int m = m0 + r;
      bool ok = m < M && k < K;
      const __nv_bfloat16* src = x;
      if (ok) {
        const int hw = H * W;
        const int b = m / hw;
        const int p = m - b * hw;
        const int y = p / W;
        const int xx = p - y * W;
        const int iy = y + ky - halo;
        const int ix = xx + kx - halo;
        ok = iy >= 0 && iy < Hin && ix >= 0 && ix < Win;
        if (ok) src = x + (((size_t)b * Hin + iy) * Win + ix) * C + ci;
      }
      cp_async16(sa + r * LDS + kc, src, ok);
    }
  }
};

__global__ void __launch_bounds__(GEMM_THREADS)
conv3x3_kernel(ConvALoader al, WeightLoader bl, const __nv_bfloat16* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int M, int O) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const float* ct = gemm_tile(al, bl, m0, n0, al.K, smem);
  for (int c = threadIdx.x; c < BM * (BN / 8); c += GEMM_THREADS) {
    const int r = c / (BN / 8);
    const int j = (c % (BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + j;
    if (m >= M || n >= O) continue;
    float v[8], bv[8];
    load8(bias + n, bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = ct[r * LDC + j + e] + bv[e];
    *reinterpret_cast<uint4*>(out + (size_t)m * O + n) = pack8(v);
  }
}

}  // namespace

extern "C" int gmdx_conv3x3(const void* x, const void* w, const void* bias, void* out, int B, int H,
                            int W, int C, int O, int pre_padded, void* stream) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GEMM_SMEM_BYTES);
    attr = true;
  }
  const int M = B * H * W;
  ConvALoader al;
  al.x = static_cast<const __nv_bfloat16*>(x);
  al.halo = pre_padded ? 0 : 1;
  al.Hin = pre_padded ? H + 2 : H;
  al.Win = pre_padded ? W + 2 : W;
  al.C = C;
  al.K = 9 * C;
  al.M = M;
  al.H = H;
  al.W = W;
  WeightLoader bl{static_cast<const __nv_bfloat16*>(w), O, 9 * C, 0};
  dim3 grid((M + BM - 1) / BM, (O + BN - 1) / BN);
  conv3x3_kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      al, bl, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, O);
  return static_cast<int>(cudaGetLastError());
}
