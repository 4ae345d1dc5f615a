// Winograd F(4x4, 3x3) convolution + bias over NHWC bf16.
//
// Replaces gmdx/kernels/winograd.py:_wino4_forward (TPU kernel _wino4_kernel),
// the conv the JAX package runs under GMDX_WINOGRAD_M=4. The arithmetic is
// the TPU kernel's: Cook-Toom matrices over the points {0, 1, -1, 2, -1/2}
// (B^T, G, A^T below), the input transform factored rows first, then
// columns, in fp32, V and the transformed weight U rounded to bf16, the 36
// transform-domain products accumulated in fp32, the output transform and
// the bias in fp32.
//
// The TPU kernel did all of it in VMEM in one grid step per image, with U
// built in-kernel once per call because the denoise scan would not hoist it.
// This first version takes three launches, counted as one call:
//   1. wino4_input_kernel: one thread per (6x6 patch, 2 channels) reads the
//      NHWC image, or its 1-px bordered form with pre_padded, with zeros past
//      it, and writes V[36][T][C] in bf16 (T = B * H/4 * W/4 tiles);
//   2. wino4_gemm_kernel: the 36 independent products M[p] = V[p] U[p]^T on
//      the shared tile GEMM (gemm_tile.cuh), blockIdx.z = p, fp32 out;
//   3. wino4_output_kernel: Y = A^T M A + bias per tile and 2 channels,
//      written bf16 (B, H, W, O).
// U[36][O][C] is made once per weight by the caller (the Conv3x3 module's
// cache), off the per-step path.
//
// Bound on the H100: 2 * 36 * T * C * O operations, 2.25x fewer than the
// direct conv's 9 * 16 per 4x4 tile; at the UNet's 64^2 x 320 level that is
// tensor-core bound. This version pays for its simplicity in bytes: V (2.25x
// the input) and the fp32 M (4.5x the output in bf16) pass through device
// memory, 4.8 GB of M at the VAE's 512^2 x 128 level for 16 images. Keeping
// V and M on chip (transforms fused into the GEMM's loader and epilogue) is
// the next version.
#include "gemm_tile.cuh"

using namespace gmdx;

namespace {

constexpr int WINO_THREADS = 256;

// B^T (6x6), A^T (4x6) of gmdx/kernels/winograd.py:_BT4/_AT4; entries folded
// at compile time in the unrolled loops below.
__device__ __forceinline__ constexpr float bt4(int r, int c) {
  constexpr float t[6][6] = {
      {1.0f, 1.5f, -2.0f, -1.5f, 1.0f, 0.0f},  {0.0f, -1.0f, -2.5f, -0.5f, 1.0f, 0.0f},
      {0.0f, 1.0f, 0.5f, -2.5f, 1.0f, 0.0f},   {0.0f, -0.5f, -1.0f, 0.5f, 1.0f, 0.0f},
      {0.0f, 2.0f, -1.0f, -2.0f, 1.0f, 0.0f},  {0.0f, 1.0f, 1.5f, -2.0f, -1.5f, 1.0f}};
  return t[r][c];
}

__device__ __forceinline__ constexpr float at4(int r, int c) {
  constexpr float t[4][6] = {{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f},
                             {0.0f, 1.0f, -1.0f, 2.0f, -0.5f, 0.0f},
                             {0.0f, 1.0f, 1.0f, 4.0f, 0.25f, 0.0f},
                             {0.0f, 1.0f, -1.0f, 8.0f, -0.125f, 1.0f}};
  return t[r][c];
}

// V[p][t][c, c+1] = (B^T d B)[xi][nu], p = 6 xi + nu, for the 6x6 patch d of
// tile t: image rows 4 ty - 1 .. 4 ty + 4 (stored rows 4 ty .. 4 ty + 5 of a
// pre-padded image), zero outside.
__global__ void __launch_bounds__(WINO_THREADS)
wino4_input_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ v, int B,
                   int H, int W, int C, int halo, int Hin, int Win) {
  const int tw = W / 4, th = H / 4;
  const int pairs = C / 2;
  const size_t T = (size_t)B * th * tw;
  const size_t idx = (size_t)blockIdx.x * WINO_THREADS + threadIdx.x;
  if (idx >= T * pairs) return;
  const size_t t = idx / pairs;
  const int c = (int)(idx - t * pairs) * 2;
  const int b = (int)(t / ((size_t)th * tw));
  const int r = (int)(t - (size_t)b * th * tw);
  const int ty = r / tw, tx = r - (r / tw) * tw;

  float2 d[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int iy = 4 * ty + i - halo;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int ix = 4 * tx + j - halo;
      d[i][j] = make_float2(0.0f, 0.0f);
      if (iy >= 0 && iy < Hin && ix >= 0 && ix < Win)
        d[i][j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + (((size_t)b * Hin + iy) * Win + ix) * C + c));
    }
  }
#pragma unroll
  for (int xi = 0; xi < 6; ++xi) {
    float2 rowt[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (bt4(xi, i) != 0.0f) {
          acc.x += bt4(xi, i) * d[i][j].x;
          acc.y += bt4(xi, i) * d[i][j].y;
        }
      }
      rowt[j] = acc;
    }
#pragma unroll
    for (int nu = 0; nu < 6; ++nu) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (bt4(nu, j) != 0.0f) {
          acc.x += bt4(nu, j) * rowt[j].x;
          acc.y += bt4(nu, j) * rowt[j].y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(v + ((size_t)(xi * 6 + nu) * T + t) * C + c) =
          __floats2bfloat162_rn(acc.x, acc.y);
    }
  }
}

// M[p] (T, O) fp32 = V[p] (T, C) @ U[p] (O, C)^T, p = blockIdx.z.
__global__ void __launch_bounds__(GEMM_THREADS)
wino4_gemm_kernel(const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ u,
                  float* __restrict__ m_out, int T, int C, int O) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int p = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  RowALoader al{v + (size_t)p * T * C, T, C};
  WeightLoader bl{u + (size_t)p * O * C, O, C, 0};
  const float* ct = gemm_tile(al, bl, m0, n0, C, smem);
  float* mp = m_out + (size_t)p * T * O;
  for (int c = threadIdx.x; c < BM * (BN / 4); c += GEMM_THREADS) {
    const int r = c / (BN / 4);
    const int j = (c % (BN / 4)) * 4;
    const int m = m0 + r;
    const int n = n0 + j;
    if (m >= T || n >= O) continue;
    *reinterpret_cast<float4*>(mp + (size_t)m * O + n) =
        make_float4(ct[r * LDC + j], ct[r * LDC + j + 1], ct[r * LDC + j + 2], ct[r * LDC + j + 3]);
  }
}

// Y[4 ty + i, 4 tx + q][o, o+1] = (A^T M A)[i][q] + bias, rows first as the
// TPU kernel sums them.
__global__ void __launch_bounds__(WINO_THREADS)
wino4_output_kernel(const float* __restrict__ m, const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int B, int H, int W, int O) {
  const int tw = W / 4, th = H / 4;
  const int pairs = O / 2;
  const size_t T = (size_t)B * th * tw;
  const size_t idx = (size_t)blockIdx.x * WINO_THREADS + threadIdx.x;
  if (idx >= T * pairs) return;
  const size_t t = idx / pairs;
  const int o = (int)(idx - t * pairs) * 2;
  const int b = (int)(t / ((size_t)th * tw));
  const int r = (int)(t - (size_t)b * th * tw);
  const int ty = r / tw, tx = r - (r / tw) * tw;

  float2 z[4][6];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int nu = 0; nu < 6; ++nu) z[i][nu] = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int xi = 0; xi < 6; ++xi) {
#pragma unroll
    for (int nu = 0; nu < 6; ++nu) {
      const float2 mv =
          *reinterpret_cast<const float2*>(m + ((size_t)(xi * 6 + nu) * T + t) * O + o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (at4(i, xi) != 0.0f) {
          z[i][nu].x += at4(i, xi) * mv.x;
          z[i][nu].y += at4(i, xi) * mv.y;
        }
      }
    }
  }
  const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + o));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16* row = out + (((size_t)b * H + 4 * ty + i) * W + 4 * tx) * O + o;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int nu = 0; nu < 6; ++nu) {
        if (at4(q, nu) != 0.0f) {
          acc.x += at4(q, nu) * z[i][nu].x;
          acc.y += at4(q, nu) * z[i][nu].y;
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(row + (size_t)q * O) =
          __floats2bfloat162_rn(acc.x + bv.x, acc.y + bv.y);
    }
  }
}

}  // namespace

// x: (B, H, W, C), or (B, H+2, W+2, C) with pre_padded; u: (36, O, C); bias:
// (O,); v: (36, T, C) bf16 and m: (36, T, O) fp32 scratch; out: (B, H, W, O).
// H, W multiples of 4; C, O multiples of 8, else cudaErrorInvalidValue.
extern "C" int gmdx_wino4(const void* x, const void* u, const void* bias, void* v, void* m,
                          void* out, int B, int H, int W, int C, int O, int pre_padded,
                          void* stream) {
  if (H % 4 || W % 4 || C % 8 || O % 8) return static_cast<int>(cudaErrorInvalidValue);
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(wino4_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         GEMM_SMEM_BYTES);
    attr = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int halo = pre_padded ? 0 : 1;
  const int Hin = pre_padded ? H + 2 : H;
  const int Win = pre_padded ? W + 2 : W;
  const size_t T = (size_t)B * (H / 4) * (W / 4);

  const size_t n_in = T * (C / 2);
  wino4_input_kernel<<<(unsigned)((n_in + WINO_THREADS - 1) / WINO_THREADS), WINO_THREADS, 0,
                       st>>>(static_cast<const __nv_bfloat16*>(x),
                             static_cast<__nv_bfloat16*>(v), B, H, W, C, halo, Hin, Win);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  dim3 grid((unsigned)((T + BM - 1) / BM), (O + BN - 1) / BN, 36);
  wino4_gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(u),
      static_cast<float*>(m), (int)T, C, O);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t n_out = T * (O / 2);
  wino4_output_kernel<<<(unsigned)((n_out + WINO_THREADS - 1) / WINO_THREADS), WINO_THREADS, 0,
                        st>>>(static_cast<const float*>(m),
                              static_cast<const __nv_bfloat16*>(bias),
                              static_cast<__nv_bfloat16*>(out), B, H, W, O);
  return static_cast<int>(cudaGetLastError());
}
