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
// UNet's sizes (<= 21 MB per tensor at batch 4). When asked, the apply pass
// also writes each image's final per-group (mean, rstd) for the backward.
//
// Backward (gmdx_group_norm_silu_bwd) replaces gmdx/kernels/groupnorm.py:
// _gn_backward (TPU kernels _gn_bwd_reduce_kernel, _gn_bwd_apply_kernel).
// It recomputes xhat = (x + t - mean) * rstd from the statistics the forward
// saved (not recomputed in another order), and dy from the cotangent g
// through the SiLU derivative when the forward activated. Two launches, for
// the same reason as the forward:
//   1. reduce: grid (splits, B); a block sums over its pixels, per channel,
//      dy and dy * xhat (the partials of dbeta and dgamma, written as
//      (B, splits, 2, C)), and from those per group dxhat = dy * gamma and
//      dxhat * xhat (written as (B, splits, 2, G));
//   2. apply: grid (splits, B); each block folds its image's group partials
//      into m1 = mean(dxhat), m2 = mean(dxhat * xhat) and writes
//      dx = rstd * (dxhat - m1 - xhat * m2).
// The wrapper sums the channel partials over (B, splits) into dgamma and
// dbeta. A padded cotangent (the forward's pad_output) is read in place:
// its border, a constant of the forward, carries no gradient.
// Bound: bytes; x and g read twice, dx written once, ~30 operations an
// element.
#include "bf16x8.cuh"

using gmdx::load8;
using gmdx::pack8;

namespace {

constexpr int MAXG = 64;

struct GnArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const __nv_bfloat16* temb;  // (B, C) or null
  __nv_bfloat16* out;
  float* partials;  // (B, splits, G, 2)
  float* stats;     // (B, 2, G) final (mean, rstd), or null
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
    if (a.stats != nullptr && blockIdx.x == 0) {
      a.stats[(size_t)b * 2 * a.G + g] = gmean[g];
      a.stats[((size_t)b * 2 + 1) * a.G + g] = grstd[g];
    }
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

struct GnBwdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;  // (B, H, W, C), or (B, H+2, W+2, C) with gpad
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const __nv_bfloat16* temb;  // (B, C) or null
  const float* stats;         // (B, 2, G) (mean, rstd) of the forward
  __nv_bfloat16* dx;
  float* chpart;  // (B, splits, 2, C): sum dy, sum dy * xhat
  float* grpart;  // (B, splits, 2, G): sum dxhat, sum dxhat * xhat
  int HW, W, C, G, splits, gpad, activate;
};

// Per-thread constants of the backward for channels [c0, c0 + 8) of image b:
// the forward's shift (t - mean) and rstd, gamma and beta.
struct GnBwdChan {
  float sh[8], rs[8], gm[8], bt[8];
};

__device__ __forceinline__ void bwd_chan(const GnBwdArgs& a, int b, int c0, GnBwdChan& ch) {
  const int cg = a.C / a.G;
  float t[8];
  load8(a.gamma + c0, ch.gm);
  load8(a.beta + c0, ch.bt);
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = 0.0f;
  if (a.temb != nullptr) load8(a.temb + (size_t)b * a.C + c0, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int g = (c0 + e) / cg;
    ch.sh[e] = t[e] - a.stats[(size_t)b * 2 * a.G + g];
    ch.rs[e] = a.stats[((size_t)b * 2 + 1) * a.G + g];
  }
}

// xhat and dL/dy (through the SiLU when the forward activated) of pixel p.
__device__ __forceinline__ void bwd_pixel(const GnBwdArgs& a, int b, int p, int c0,
                                          const GnBwdChan& ch, float* xh, float* dy) {
  float v[8], gv[8];
  load8(a.x + ((size_t)b * a.HW + p) * a.C + c0, v);
  size_t gp = (size_t)b * a.HW + p;
  if (a.gpad) {
    const int H = a.HW / a.W;
    gp = ((size_t)b * (H + 2) + p / a.W + 1) * (a.W + 2) + p % a.W + 1;
  }
  load8(a.g + gp * a.C + c0, gv);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    xh[e] = (v[e] + ch.sh[e]) * ch.rs[e];
    if (a.activate) {
      const float y = xh[e] * ch.gm[e] + ch.bt[e];
      const float sig = 1.0f / (1.0f + __expf(-y));
      dy[e] = gv[e] * sig * (1.0f + y * (1.0f - sig));
    } else {
      dy[e] = gv[e];
    }
  }
}

__global__ void gn_bwd_reduce_kernel(GnBwdArgs a) {
  extern __shared__ float cs[];  // [2][C]
  const int b = blockIdx.y;
  const int chunks = a.C / 8;
  const int r = blockDim.x / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  const int cg = a.C / a.G;
  for (int i = threadIdx.x; i < 2 * a.C; i += blockDim.x) cs[i] = 0.0f;
  __syncthreads();

  GnBwdChan ch;
  bwd_chan(a, b, c0, ch);
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
  int p0, p1;
  block_range(a.HW, a.splits, p0, p1);
  for (int p = p0 + threadIdx.x / chunks; p < p1; p += r) {
    float xh[8], dy[8];
    bwd_pixel(a, b, p, c0, ch, xh, dy);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s1[e] += dy[e];
      s2[e] += dy[e] * xh[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    atomicAdd(&cs[c0 + e], s1[e]);
    atomicAdd(&cs[a.C + c0 + e], s2[e]);
  }
  __syncthreads();
  const size_t part = (size_t)b * a.splits + blockIdx.x;
  float* cp = a.chpart + part * 2 * a.C;
  for (int i = threadIdx.x; i < 2 * a.C; i += blockDim.x) cp[i] = cs[i];
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      const float gm = __bfloat162float(a.gamma[c]);
      t1 += gm * cs[c];
      t2 += gm * cs[a.C + c];
    }
    a.grpart[part * 2 * a.G + g] = t1;
    a.grpart[(part * 2 + 1) * a.G + g] = t2;
  }
}

__global__ void gn_bwd_apply_kernel(GnBwdArgs a) {
  __shared__ float gm1[MAXG], gm2[MAXG];
  const int b = blockIdx.y;
  const int chunks = a.C / 8;
  const int r = blockDim.x / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  const int cg = a.C / a.G;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    double t1 = 0.0, t2 = 0.0;
    for (int s = 0; s < a.splits; ++s) {
      const size_t part = (size_t)b * a.splits + s;
      t1 += a.grpart[part * 2 * a.G + g];
      t2 += a.grpart[(part * 2 + 1) * a.G + g];
    }
    const double n = (double)a.HW * cg;
    gm1[g] = (float)(t1 / n);
    gm2[g] = (float)(t2 / n);
  }
  __syncthreads();

  GnBwdChan ch;
  bwd_chan(a, b, c0, ch);
  float m1[8], m2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m1[e] = gm1[(c0 + e) / cg];
    m2[e] = gm2[(c0 + e) / cg];
  }
  int p0, p1;
  block_range(a.HW, a.splits, p0, p1);
  for (int p = p0 + threadIdx.x / chunks; p < p1; p += r) {
    float xh[8], dy[8], dx[8];
    bwd_pixel(a, b, p, c0, ch, xh, dy);
#pragma unroll
    for (int e = 0; e < 8; ++e) dx[e] = ch.rs[e] * (dy[e] * ch.gm[e] - m1[e] - xh[e] * m2[e]);
    *reinterpret_cast<uint4*>(a.dx + ((size_t)b * a.HW + p) * a.C + c0) = pack8(dx);
  }
}

}  // namespace

// x: (B, H, W, C); out: (B, H + 2 pad, W + 2 pad, C); partials: B * splits *
// G * 2 floats of scratch; stats: (B, 2, G) fp32 or null. All other tensors
// bf16. C % 8 == 0, C % G == 0, G <= 64, C / 8 <= 1024.
extern "C" int gmdx_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                    const void* temb, void* out, void* partials, void* stats,
                                    int B, int H, int W, int C, int G, int splits, float eps,
                                    int activate, int pad, void* stream) {
  GnArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.temb = static_cast<const __nv_bfloat16*>(temb);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partials = static_cast<float*>(partials);
  a.stats = static_cast<float*>(stats);
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

// x, dx: (B, H, W, C); g: the same, or (B, H+2, W+2, C) with gpad; stats:
// (B, 2, G) fp32 from the forward; chpart: B * splits * 2 * C and grpart:
// B * splits * 2 * G floats, written here (chpart is the caller's to sum
// into dbeta, dgamma). Other tensors bf16. The limits of the forward hold.
extern "C" int gmdx_group_norm_silu_bwd(const void* x, const void* g, const void* gamma,
                                        const void* beta, const void* temb, const void* stats,
                                        void* dx, void* chpart, void* grpart, int B, int H, int W,
                                        int C, int G, int splits, int activate, int gpad,
                                        void* stream) {
  GnBwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.temb = static_cast<const __nv_bfloat16*>(temb);
  a.stats = static_cast<const float*>(stats);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.chpart = static_cast<float*>(chpart);
  a.grpart = static_cast<float*>(grpart);
  a.HW = H * W;
  a.W = W;
  a.C = C;
  a.G = G;
  a.splits = splits;
  a.gpad = gpad;
  a.activate = activate;
  const int chunks = C / 8;
  const int threads = chunks * (chunks >= 512 ? 1 : 512 / chunks);
  const int smem = 2 * C * static_cast<int>(sizeof(float));
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(gn_bwd_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         2 * 8192 * static_cast<int>(sizeof(float)));
    attr = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, B);
  gn_bwd_reduce_kernel<<<grid, threads, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_bwd_apply_kernel<<<grid, threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
