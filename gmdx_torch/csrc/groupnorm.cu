// GroupNorm (+ per-(b, c) bias before the statistics) + SiLU over NHWC bf16,
// with an optional 1-px zero-bordered output for the 3x3 conv kernel.
//
// Replaces gmdx/kernels/groupnorm.py:fused_group_norm_silu (TPU kernels
// _gn_onepass_kernel, _gn_onepass_pad_kernel, _stats_kernel, _apply_kernel)
// and gmdx/kernels/groupnorm.py:parity_gn_pad_silu (_gn_parity_pad_kernel;
// the temb pre-add is kept, the Winograd parity layout is not).
//
// y = act(((x + t[b, c]) - mean[b, g]) * rstd[b, g] * gamma[c] + beta[c]).
//
// The TPU ran its grid in order and could carry a whole image's sums in VMEM
// from one grid step to the next. Blocks on the H100 run in no order, so the
// reduction across blocks takes two launches:
//   1. stats: grid (splits, B); a block sums its slice of pixels into
//      per-group partial (sum, sum of squares) written to a scratch buffer;
//   2. apply: grid (splits, B); each block folds the partials of its image
//      into mean and rstd, then normalises its slice of (output) pixels,
//      writing zeros on the border when the output is padded.
// A block has (C / 8) * r threads, so each thread owns a fixed 8-channel
// chunk (one 16-byte load) and walks the pixels with stride r: its channels,
// scale, shift and temb stay in registers. The sums are taken about a
// per-group shift (the group's first element) to keep E[x^2] - E[x]^2 away
// from cancellation; statistics are fp32, combined in fp64.
//
// Bound on the H100: bytes. Two reads of x and one write of y, against ~10
// operations an element; the design moves 16 bytes per access and fills the
// card with splits x B blocks. The second read of x mostly hits L2 at the
// UNet's sizes (<= 21 MB per tensor at batch 4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXG = 64;

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

struct GnArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const __nv_bfloat16* temb;  // (B, C) or null
  __nv_bfloat16* out;
  float* partials;  // (B, splits, G, 2)
  int HW, W, C, G, splits, pad;
  float eps;
  int activate;
};

// Pixel range [p0, p1) of this block over `npix` pixels.
__device__ __forceinline__ void block_range(int npix, int splits, int& p0, int& p1) {
  const int per = (npix + splits - 1) / splits;
  p0 = blockIdx.x * per;
  p1 = min(npix, p0 + per);
}

__global__ void gn_stats_kernel(GnArgs a) {
  __shared__ float gsum[MAXG], gsq[MAXG];
  const int b = blockIdx.y;
  const int chunks = a.C / 8;
  const int r = blockDim.x / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  const int cg = a.C / a.G;
  for (int i = threadIdx.x; i < a.G; i += blockDim.x) gsum[i] = gsq[i] = 0.0f;
  __syncthreads();

  const __nv_bfloat16* xb = a.x + (size_t)b * a.HW * a.C;
  float t[8], shift[8], s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    t[e] = 0.0f;
    s1[e] = s2[e] = 0.0f;
  }
  if (a.temb != nullptr) load8(a.temb + (size_t)b * a.C + c0, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + e;
    const int gfirst = (c / cg) * cg;  // the group's first channel, pixel 0
    shift[e] = __bfloat162float(xb[gfirst]) + (a.temb != nullptr ? __bfloat162float(a.temb[(size_t)b * a.C + gfirst]) : 0.0f);
  }
  int p0, p1;
  block_range(a.HW, a.splits, p0, p1);
  if (threadIdx.x < chunks * r) {
    for (int p = p0 + threadIdx.x / chunks; p < p1; p += r) {
      float v[8];
      load8(xb + (size_t)p * a.C + c0, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[e] + t[e] - shift[e];
        s1[e] += d;
        s2[e] += d * d;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int g = (c0 + e) / cg;
      atomicAdd(&gsum[g], s1[e]);
      atomicAdd(&gsq[g], s2[e]);
    }
  }
  __syncthreads();
  float* part = a.partials + ((size_t)b * a.splits + blockIdx.x) * a.G * 2;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    part[2 * g] = gsum[g];
    part[2 * g + 1] = gsq[g];
  }
}

__global__ void gn_apply_kernel(GnArgs a) {
  __shared__ float gmean[MAXG], grstd[MAXG];
  const int b = blockIdx.y;
  const int chunks = a.C / 8;
  const int r = blockDim.x / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  const int cg = a.C / a.G;
  const __nv_bfloat16* xb = a.x + (size_t)b * a.HW * a.C;

  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    const float* part = a.partials + (size_t)b * a.splits * a.G * 2;
    double s1 = 0.0, s2 = 0.0;
    for (int s = 0; s < a.splits; ++s) {
      s1 += part[(size_t)s * a.G * 2 + 2 * g];
      s2 += part[(size_t)s * a.G * 2 + 2 * g + 1];
    }
    const double n = (double)a.HW * cg;
    const double md = s1 / n;
    double var = s2 / n - md * md;
    var = var > 0.0 ? var : 0.0;
    const int gfirst = g * cg;
    const float shift = __bfloat162float(xb[gfirst]) +
                        (a.temb != nullptr ? __bfloat162float(a.temb[(size_t)b * a.C + gfirst]) : 0.0f);
    gmean[g] = (float)md + shift;
    grstd[g] = rsqrtf((float)var + a.eps);
  }
  __syncthreads();
  if (threadIdx.x >= chunks * r) return;

  // y = x * scale + shift_c, with the temb folded into the shift.
  float sc[8], sh[8], gm[8], bt[8], t[8];
  load8(a.gamma + c0, gm);
  load8(a.beta + c0, bt);
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = 0.0f;
  if (a.temb != nullptr) load8(a.temb + (size_t)b * a.C + c0, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int g = (c0 + e) / cg;
    sc[e] = grstd[g] * gm[e];
    sh[e] = (t[e] - gmean[g]) * sc[e] + bt[e];
  }

  const int H = a.HW / a.W;
  const int Wo = a.W + 2 * a.pad;
  const int npix = (H + 2 * a.pad) * Wo;
  __nv_bfloat16* ob = a.out + (size_t)b * npix * a.C;
  int p0, p1;
  block_range(npix, a.splits, p0, p1);
  for (int p = p0 + threadIdx.x / chunks; p < p1; p += r) {
    float y[8];
    int src = p;
    bool border = false;
    if (a.pad) {
      const int py = p / Wo - 1;
      const int px = p % Wo - 1;
      border = py < 0 || py >= H || px < 0 || px >= a.W;
      src = py * a.W + px;
    }
    if (border) {
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = 0.0f;
    } else {
      float v[8];
      load8(xb + (size_t)src * a.C + c0, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float z = v[e] * sc[e] + sh[e];
        y[e] = a.activate ? z / (1.0f + __expf(-z)) : z;
      }
    }
    *reinterpret_cast<uint4*>(ob + (size_t)p * a.C + c0) = pack8(y);
  }
}

}  // namespace

// x: (B, H, W, C); out: (B, H + 2 pad, W + 2 pad, C); partials: B * splits *
// G * 2 floats of scratch. All tensors bf16 except partials. C % 8 == 0,
// C % G == 0, G <= 64, C / 8 <= 1024.
extern "C" int gmdx_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                    const void* temb, void* out, void* partials, int B, int H,
                                    int W, int C, int G, int splits, float eps, int activate,
                                    int pad, void* stream) {
  GnArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.temb = static_cast<const __nv_bfloat16*>(temb);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partials = static_cast<float*>(partials);
  a.HW = H * W;
  a.W = W;
  a.C = C;
  a.G = G;
  a.splits = splits;
  a.pad = pad;
  a.eps = eps;
  a.activate = activate;
  const int chunks = C / 8;
  const int threads = chunks * (chunks >= 512 ? 1 : 512 / chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, B);
  gn_stats_kernel<<<grid, threads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_apply_kernel<<<grid, threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
