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
// The forward is one launch in either of two forms, as the plan picks:
//   * gn_cluster_kernel, wherever an image fits the shared memory of 16 SMs
//     (the TPU kernel's one-pass form, whose whole image sat in VMEM, spread
//     over a cluster): one image per thread-block cluster of n CTAs (n <= 16;
//     16 is a non-portable cluster size). CTA r owns the contiguous pixel
//     slice [r P, (r + 1) P) (P = ceil(HW / n)), one byte range of NHWC,
//     which arrives by 1-D bulk copies (cp.async.bulk ... mbarrier::
//     complete_tx) in four pieces with an mbarrier each, so that the sums
//     start on the first piece while the others land. x is read from device
//     memory once.
//       - Sums: each thread owns an 8-channel chunk (16-byte accesses) and
//         walks the slice's pixels with stride R (R pixel rows in parallel),
//         four loads in flight, summing x + t - shift and its square in fp32
//         about each group's first element (the shift keeps E[x^2] - E[x]^2
//         away from cancellation). The block folds them in a fixed order
//         (rows per channel, then channels per group) into (G, 2) partials
//         in its own shared memory; no atomics, so a repeated call is
//         bit-identical.
//       - Cluster reduce: barrier.cluster, then every CTA reads all n
//         partials over distributed shared memory (mapa +
//         ld.shared::cluster, all n loads in flight) in rank order, in fp64:
//         the same mean and rstd in every CTA. Rank 0 writes the (mean,
//         rstd) stats the backward reads. A second cluster barrier keeps each
//         CTA's partials alive until every CTA has read them.
//       - Output: normalised from shared memory with 16-byte stores; with a
//         padded output the CTA that owns an image row's first (last) pixel
//         writes the left (right) border pixel, rank 0 the top row and rank
//         n - 1 the bottom row.
//   * The pair (gn_stats_kernel, then gn_apply_kernel), where it does not:
//     grid (splits, B) at about 528 blocks, two an SM; per-block partials
//     (the same fixed-order fold) in device memory, folded by every apply
//     block in fp64; x read twice, the second time mostly from L2.
// Measured on the H100 (PERF.md): only 7 clusters of 16 are resident at once
// (15 of 8, 30 of 4: cudaOccupancyMaxActiveClusters, one CTA an SM), so a
// batch of 16 runs in three waves; the cluster kernel's time is its CTAs'
// own rate (load, then sums, then stores, about 10 us each a wave at 160 KB
// a slice), not the card's memory rate. A two-read cluster form for the
// images that do not fit lost to the pair at every path shape at batch 8
// and 16 and was removed.
// The plan (gn_plan; kernels/groupnorm.py:group_norm_plan mirrors it, and
// gmdx_group_norm_plan reports it): the cluster kernel at the n of 1, 2, 4,
// 8, 16 whose slice fits and whose cost, ceil(B / RESIDENT_CLUSTERS[n]) *
// (slice bytes + WAVE_BYTES), is least, the smaller n on a tie: waves of the
// clusters the card holds at once, each as long as a CTA takes over its
// slice plus the wave's fixed cost (so one wave of 4-CTA clusters for the
// small images at batch 16, of 8-CTA clusters at batch 8); the pair where no
// slice fits.
//
// Bound on the H100: bytes. One read of x and one write of y, against ~10
// operations an element; the cluster kernel moves exactly that, the pair
// reads x twice.
//
// The split form (gmdx_group_norm_moments, gmdx_group_norm_apply), for an
// image whose rows lie on several ranks (spatial parallelism; the TPU
// kernel's stats and apply passes, _stats_kernel and _apply_kernel, with the
// reduction between them left to the caller): the pair's stats kernel over
// this rank's rows, then gn_moments_kernel folds its partials into each
// group's (mean, M2) of the rows in fp64; the caller merges every rank's
// (Chan's formula, equal counts) into the image's (mean, rstd) and
// gn_apply_kernel normalises the rows with them. Bound: bytes, x read once
// by each entry and y written once.
//
// Backward (gmdx_group_norm_silu_bwd) replaces gmdx/kernels/groupnorm.py:
// _gn_backward (TPU kernels _gn_bwd_reduce_kernel, _gn_bwd_apply_kernel,
// whose sequential grid axis carried the sums). It recomputes
// xhat = (x + t - mean) * rstd from the statistics the forward saved, and dy
// from the cotangent g through the SiLU derivative when the forward
// activated; dx = rstd (dy gamma - m1 - xhat m2) with m1, m2 the group means
// of dy gamma and dy gamma xhat; dgamma, dbeta the sums of dy xhat and dy;
// dtemb the sum of dx over each image's pixels. One cooperative launch of
// gn_bwd_kernel (its note below), every block resident, with one grid
// barrier between the sums and dx, and every sum - the block's, the
// image's, the parameters' - folded in a fixed order: no atomics in any
// sum, so a repeated call is bit-identical, and no reduction is left to the
// caller. A padded cotangent (the forward's pad_output) is read in place:
// its border, a constant of the forward, carries no gradient.
// Bound: bytes; x and g read once and dx written once, ~30 operations an
// element. The kernel reads x and g a second time after the barrier, newest
// pixels first so that what the first pass left in the 50 MB L2 serves it;
// where x + g exceed L2 (at batch 8: 64^2 x 640 84 MB, 64^2 x 960 126 MB,
// 32^2 x 1920 63 MB) up to that excess comes from device memory again, at
// most 5/3 of the bound's bytes.
#include "bf16x8.cuh"
#include "gemm_sm90.cuh"

using gmdx::load8;
using gmdx::pack8;
using gmdx::unpack8;
namespace sm90 = gmdx::sm90;

namespace {

constexpr int MAXG = 64;
constexpr int MAX_THREADS = 512;  // C <= 4096: an 8-channel chunk a thread
constexpr int UNROLL = 4;          // 16-byte loads a cluster-kernel thread keeps in flight
constexpr int LOAD_PIECES = 4;     // bulk copies (and mbarriers) of a resident slice
constexpr int CLUSTER_MAX = 16;    // non-portable above 8
// Clusters of 1, 2, 4, 8, 16 CTAs the H100 holds resident at once (one CTA
// an SM), as cudaOccupancyMaxActiveClusters reports them.
constexpr int RESIDENT_CLUSTERS[5] = {132, 66, 30, 15, 7};
// A wave's fixed cost (the fold and the cluster barriers, about 4 us) as the
// slice bytes a CTA loads and stores in that time (about 17 GB/s each way).
constexpr int WAVE_BYTES = 32768;
constexpr int PAIR_TARGET_BLOCKS = 528;  // about four blocks an SM

enum GnForm { GN_PAIR = 0, GN_RESIDENT = 1 };

struct GnArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const __nv_bfloat16* temb;  // (B, C) or null
  __nv_bfloat16* out;
  float* partials;  // the pair's (B, splits, G, 2)
  float* stats;     // (B, 2, G) final (mean, rstd), or null
  const float* stats_in;  // the split form's (B, 2, G) (mean, rstd) to apply, or null
  float* moments;         // the split form's (B, G, 2) (mean, M2) of the rows, or null
  int HW, W, C, G, pixels, pad;  // pixels: a CTA's (or pair block's) slice
  float eps;
  int activate;
};

// ---------------------------------------------------------------------------
// The plan
// ---------------------------------------------------------------------------

struct GnPlan {
  int form, cluster, pixels, smem, grid_x, grid_y, threads;
};

// (C / 8) * R threads: an 8-channel chunk each, R pixel rows in parallel.
int gn_threads(int C) {
  const int chunks = C / 8;
  return chunks * (chunks >= 512 ? 1 : 512 / chunks);
}

// Shared memory beside the slice: the fold's [2][R][C] fp32 sums, the (G, 2)
// partials, the (mean, rstd) of each group, the mbarriers.
int gn_fixed_bytes(int C) { return 64 * gn_threads(C) + 4 * MAXG * 4 + LOAD_PIECES * 8; }

int gn_pair_splits(int B, int hw, int C) {
  const int rows = (C / 8) >= 512 ? 1 : 512 / (C / 8);
  const int by_batch = (PAIR_TARGET_BLOCKS + B - 1) / B;
  const int by_rows = (hw + rows - 1) / rows;
  const int s = by_batch < by_rows ? by_batch : by_rows;
  return s > 1 ? s : 1;
}

// The plan's rule (see the note above).
GnPlan gn_plan(int B, int H, int W, int C) {
  const int hw = H * W, fixed = gn_fixed_bytes(C);
  GnPlan p{GN_PAIR, 1, 0, 0, 0, B, gn_threads(C)};
  int fit = 0;
  long long best = 0;
  for (int i = 0, n = 1; n <= CLUSTER_MAX && n <= hw; ++i, n *= 2) {
    const long long pixels = (hw + n - 1) / n;
    if (pixels * C * 2 + fixed > sm90::SMEM_BUDGET) continue;
    const int waves = (B + RESIDENT_CLUSTERS[i] - 1) / RESIDENT_CLUSTERS[i];
    const long long cost = waves * (pixels * C * 2 + WAVE_BYTES);
    if (!fit || cost < best) {
      fit = n;
      best = cost;
    }
  }
  if (!fit) {
    p.grid_x = gn_pair_splits(B, hw, C);
    p.pixels = (hw + p.grid_x - 1) / p.grid_x;
    p.smem = 64 * p.threads;
    return p;
  }
  p.form = GN_RESIDENT;
  p.cluster = fit;
  p.pixels = (hw + fit - 1) / fit;
  p.smem = fixed + p.pixels * C * 2;
  p.grid_x = fit;
  return p;
}

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two floats at p (this CTA's shared memory, 8-byte aligned) in the
// shared memory of cluster CTA `rank`.
__device__ __forceinline__ float2 ld_cluster2(const float* p, uint32_t rank) {
  uint32_t remote;
  float2 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(sm90::smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}

// `bytes` (a multiple of 16) from device memory into this CTA's shared
// memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// Per-thread constants of the forward for channels [c0, c0 + 8) of image b:
// the temb and each channel's shift (its group's first element, pixel 0).
struct GnChan {
  float t[8], shift[8];
};

__device__ __forceinline__ float group_shift(const GnArgs& a, int b, int g) {
  const int first = g * (a.C / a.G);
  return __bfloat162float(a.x[(size_t)b * a.HW * a.C + first]) +
         (a.temb != nullptr ? __bfloat162float(a.temb[(size_t)b * a.C + first]) : 0.0f);
}

__device__ __forceinline__ void fwd_chan(const GnArgs& a, int b, int c0, GnChan& ch) {
#pragma unroll
  for (int e = 0; e < 8; ++e) ch.t[e] = 0.0f;
  if (a.temb != nullptr) load8(a.temb + (size_t)b * a.C + c0, ch.t);
#pragma unroll
  for (int e = 0; e < 8; ++e) ch.shift[e] = group_shift(a, b, (c0 + e) / (a.C / a.G));
}

__device__ __forceinline__ void add_pixel(const float* v, const GnChan& ch, float* s1, float* s2) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d = v[e] + ch.t[e] - ch.shift[e];
    s1[e] += d;
    s2[e] += d * d;
  }
}

// Adds the shifted sums of rows p, p + r, ... < p1 of `src` (pixels of C
// channels) to s1 and s2, in that order; U loads are issued before their
// sums, so that each thread keeps that many in flight (the pair runs two
// blocks an SM at U = 1, which a larger U's registers would halve).
template <int U>
__device__ __forceinline__ void accumulate(const __nv_bfloat16* src, int C, int c0, int p, int p1,
                                           int r, const GnChan& ch, float* s1, float* s2) {
  for (; p + (U - 1) * r < p1; p += U * r) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) load8(src + (size_t)(p + u * r) * C + c0, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) add_pixel(v[u], ch, s1, s2);
  }
  for (; p < p1; p += r) {
    float v[8];
    load8(src + (size_t)p * C + c0, v);
    add_pixel(v, ch, s1, s2);
  }
}

// The block's per-group (sum, sum of squares) into part[2 g], part[2 g + 1]
// in a fixed order: every thread's 8 channel sums go to red ([2][R][C]:
// thread tid's chunk sits at tid * 8), are summed over the R rows per
// channel, then over each group's channels.
__device__ __forceinline__ void block_group_sums(const float* s1, const float* s2, float* red,
                                                 float* part, int C, int G, int rows) {
  const int T = blockDim.x;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[threadIdx.x * 8 + e] = s1[e];
    red[T * 8 + threadIdx.x * 8 + e] = s2[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * C; i += T) {
    float* r = red + (i / C) * T * 8 + i % C;
    float acc = r[0];
    for (int k = 1; k < rows; ++k) acc += r[k * C];
    r[0] = acc;
  }
  __syncthreads();
  const int cg = C / G;
  for (int i = threadIdx.x; i < 2 * G; i += T) {
    const float* r = red + (i / G) * T * 8 + (i % G) * cg;
    float acc = 0.0f;
    for (int k = 0; k < cg; ++k) acc += r[k];
    part[2 * (i % G) + i / G] = acc;
  }
  __syncthreads();
}

// Mean and rstd of group g from its shifted sums over the image.
__device__ __forceinline__ void group_moments(const GnArgs& a, int b, int g, double s1, double s2,
                                              float& mean, float& rstd) {
  const double n = (double)a.HW * (a.C / a.G);
  const double md = s1 / n;
  double var = s2 / n - md * md;
  var = var > 0.0 ? var : 0.0;
  mean = (float)md + group_shift(a, b, g);
  rstd = rsqrtf((float)var + a.eps);
}

// y of pixel gp (its 8 channels v) into the (padded) output `ob`, with the
// left (right) border pixel where gp is its row's first (last).
__device__ __forceinline__ void store_pixel(const GnArgs& a, __nv_bfloat16* ob, const float* sc,
                                            const float* sh, const float* v, int gp) {
  float y[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float z = v[e] * sc[e] + sh[e];
    y[e] = a.activate ? __fdividef(z, 1.0f + __expf(-z)) : z;
  }
  const int py = gp / a.W;
  const int px = gp - py * a.W;
  __nv_bfloat16* o = ob + ((size_t)(py + a.pad) * (a.W + 2 * a.pad) + px + a.pad) * a.C;
  *reinterpret_cast<uint4*>(o) = pack8(y);
  if (a.pad) {
    if (px == 0) *reinterpret_cast<uint4*>(o - a.C) = make_uint4(0, 0, 0, 0);
    if (px == a.W - 1) *reinterpret_cast<uint4*>(o + a.C) = make_uint4(0, 0, 0, 0);
  }
}

// y of pixels p, p + r, ... < p1 of `src` (local index; `gp0` the first
// pixel's index in the image), U loads in flight as in accumulate.
template <int U>
__device__ __forceinline__ void apply_rows(const GnArgs& a, int b, int c0, const float* sc,
                                           const float* sh, const __nv_bfloat16* src, int gp0,
                                           int p, int p1, int r) {
  const int H = a.HW / a.W;
  __nv_bfloat16* ob = a.out + (size_t)b * (H + 2 * a.pad) * (a.W + 2 * a.pad) * a.C + c0;
  for (; p + (U - 1) * r < p1; p += U * r) {
    float v[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) load8(src + (size_t)(p + u * r) * a.C + c0, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) store_pixel(a, ob, sc, sh, v[u], gp0 + p + u * r);
  }
  for (; p < p1; p += r) {
    float v[8];
    load8(src + (size_t)p * a.C + c0, v);
    store_pixel(a, ob, sc, sh, v, gp0 + p);
  }
}

// Zeros on output row `row` of a padded image, pixels q, q + r, ... < W + 2.
__device__ __forceinline__ void border_row(const GnArgs& a, int b, int c0, int row, int q, int r) {
  const int H = a.HW / a.W;
  const int Wo = a.W + 2;
  __nv_bfloat16* ob = a.out + ((size_t)b * (H + 2) + row) * Wo * a.C + c0;
  for (; q < Wo; q += r) *reinterpret_cast<uint4*>(ob + (size_t)q * a.C) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void scale_shift(const GnArgs& a, int c0, const float* t,
                                            const float* mean, const float* rstd, float* sc,
                                            float* sh) {
  float gm[8], bt[8];
  load8(a.gamma + c0, gm);
  load8(a.beta + c0, bt);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int g = (c0 + e) / (a.C / a.G);
    sc[e] = rstd[g] * gm[e];
    sh[e] = (t[e] - mean[g]) * sc[e] + bt[e];
  }
}

// ---------------------------------------------------------------------------
// The cluster forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MAX_THREADS, 1) gn_cluster_kernel(GnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y;
  const int rank = static_cast<int>(cluster_rank());
  const int n = static_cast<int>(cluster_size());
  const int chunks = a.C / 8;
  const int rows = blockDim.x / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  const int row = threadIdx.x / chunks;
  const int p0 = min(rank * a.pixels, a.HW);
  const int np = min(p0 + a.pixels, a.HW) - p0;
  auto* slice = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + (size_t)a.pixels * a.C * 2);
  float* part = red + 16 * blockDim.x;
  float* mean = part + 2 * MAXG;
  float* rstd = mean + MAXG;
  auto* bar = reinterpret_cast<uint64_t*>(rstd + MAXG);
  const __nv_bfloat16* xs = a.x + ((size_t)b * a.HW + p0) * a.C;  // the slice in device memory
  const int piece = (np + LOAD_PIECES - 1) / LOAD_PIECES;

  if (threadIdx.x == 0) {
    for (int k = 0; k < LOAD_PIECES; ++k) sm90::mbar_init(&bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < LOAD_PIECES; ++k) {
      const int q0 = min(k * piece, np);
      const int q1 = min(q0 + piece, np);
      const uint32_t bytes = (uint32_t)(q1 - q0) * a.C * 2;
      sm90::mbar_expect_tx(&bar[k], bytes);
      if (bytes > 0) bulk_load(slice + (size_t)q0 * a.C, xs + (size_t)q0 * a.C, bytes, &bar[k]);
    }
  }
  __syncthreads();

  GnChan ch;
  fwd_chan(a, b, c0, ch);
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
  for (int k = 0; k < LOAD_PIECES; ++k) {
    const int q0 = min(k * piece, np);
    sm90::mbar_wait(&bar[k], 0);
    accumulate<UNROLL>(slice, a.C, c0, q0 + row, min(q0 + piece, np), rows, ch, s1, s2);
  }
  block_group_sums(s1, s2, red, part, a.C, a.G, rows);

  cluster_arrive();  // this CTA's partials are published
  cluster_wait();
  if (threadIdx.x < a.G) {
    const int g = threadIdx.x;
    float2 pr[CLUSTER_MAX];  // every rank's loads issued before the first sum
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r)
      if (r < n) pr[r] = ld_cluster2(&part[2 * g], r);
    double t1 = 0.0, t2 = 0.0;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      if (r < n) {
        t1 += pr[r].x;
        t2 += pr[r].y;
      }
    }
    group_moments(a, b, g, t1, t2, mean[g], rstd[g]);
    if (a.stats != nullptr && rank == 0) {
      a.stats[(size_t)b * 2 * a.G + g] = mean[g];
      a.stats[((size_t)b * 2 + 1) * a.G + g] = rstd[g];
    }
  }
  cluster_arrive();  // done reading the other CTAs' partials
  __syncthreads();

  float sc[8], sh[8];
  scale_shift(a, c0, ch.t, mean, rstd, sc, sh);
  apply_rows<UNROLL>(a, b, c0, sc, sh, slice, p0, row, np, rows);
  if (a.pad) {
    if (rank == 0) border_row(a, b, c0, 0, row, rows);
    if (rank == n - 1) border_row(a, b, c0, a.HW / a.W + 1, row, rows);
  }
  cluster_wait();  // no CTA leaves while another may still read its partials
}

// ---------------------------------------------------------------------------
// The pair: per-block partials in device memory, folded by every apply block
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MAX_THREADS, 2) gn_stats_kernel(GnArgs a) {
  extern __shared__ float red[];
  const int b = blockIdx.y;
  const int chunks = a.C / 8;
  const int rows = blockDim.x / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  __shared__ float part[2 * MAXG];
  GnChan ch;
  fwd_chan(a, b, c0, ch);
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
  const int p0 = min((int)blockIdx.x * a.pixels, a.HW);
  const int p1 = min(p0 + a.pixels, a.HW);
  accumulate<1>(a.x + (size_t)b * a.HW * a.C, a.C, c0, p0 + threadIdx.x / chunks, p1, rows, ch,
                s1, s2);
  block_group_sums(s1, s2, red, part, a.C, a.G, rows);
  float* out = a.partials + ((size_t)b * gridDim.x + blockIdx.x) * a.G * 2;
  for (int i = threadIdx.x; i < 2 * a.G; i += blockDim.x) out[i] = part[i];
}

__global__ void __launch_bounds__(MAX_THREADS, 2) gn_apply_kernel(GnArgs a) {
  __shared__ float mean[MAXG], rstd[MAXG];
  const int b = blockIdx.y;
  const int chunks = a.C / 8;
  const int c0 = (threadIdx.x % chunks) * 8;
  for (int g = threadIdx.x; g < a.G; g += blockDim.x) {
    if (a.stats_in != nullptr) {  // the split form: the statistics of the whole image
      mean[g] = a.stats_in[(size_t)b * 2 * a.G + g];
      rstd[g] = a.stats_in[((size_t)b * 2 + 1) * a.G + g];
      continue;
    }
    const float* part = a.partials + (size_t)b * gridDim.x * a.G * 2;
    double s1 = 0.0, s2 = 0.0;
    for (unsigned s = 0; s < gridDim.x; ++s) {
      s1 += part[(size_t)s * a.G * 2 + 2 * g];
      s2 += part[(size_t)s * a.G * 2 + 2 * g + 1];
    }
    group_moments(a, b, g, s1, s2, mean[g], rstd[g]);
    if (a.stats != nullptr && blockIdx.x == 0) {
      a.stats[(size_t)b * 2 * a.G + g] = mean[g];
      a.stats[((size_t)b * 2 + 1) * a.G + g] = rstd[g];
    }
  }
  __syncthreads();
  float t[8], sc[8], sh[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = 0.0f;
  if (a.temb != nullptr) load8(a.temb + (size_t)b * a.C + c0, t);
  scale_shift(a, c0, t, mean, rstd, sc, sh);
  const int p0 = min((int)blockIdx.x * a.pixels, a.HW);
  const int p1 = min(p0 + a.pixels, a.HW);
  const int rows = blockDim.x / chunks;
  apply_rows<1>(a, b, c0, sc, sh, a.x + (size_t)b * a.HW * a.C, 0, p0 + threadIdx.x / chunks, p1,
                rows);
  if (a.pad) {
    if (blockIdx.x == 0) border_row(a, b, c0, 0, threadIdx.x / chunks, rows);
    if (blockIdx.x == gridDim.x - 1)
      border_row(a, b, c0, a.HW / a.W + 1, threadIdx.x / chunks, rows);
  }
}

// The split form's fold: image b's stats-kernel partials (`splits` of them,
// shifted about the rows' first element) into the rows' (mean, M2) a group,
// in fp64 and a fixed order: M2 = sum (v - mean)^2 = s2 - s1^2 / n.
__global__ void gn_moments_kernel(GnArgs a, int splits) {
  const int b = blockIdx.x;
  const int g = threadIdx.x;
  if (g >= a.G) return;
  const float* part = a.partials + (size_t)b * splits * a.G * 2;
  double s1 = 0.0, s2 = 0.0;
  for (int s = 0; s < splits; ++s) {
    s1 += part[(size_t)s * a.G * 2 + 2 * g];
    s2 += part[(size_t)s * a.G * 2 + 2 * g + 1];
  }
  const double n = (double)a.HW * (a.C / a.G);
  const double m2 = s2 - s1 * s1 / n;
  a.moments[((size_t)b * a.G + g) * 2] = (float)(s1 / n + group_shift(a, b, g));
  a.moments[((size_t)b * a.G + g) * 2 + 1] = (float)(m2 > 0.0 ? m2 : 0.0);
}

// The launch configuration of the cluster kernel for plan p (the function's
// attributes set first, as the occupancy query needs them too).
cudaLaunchConfig_t cluster_config(const GnPlan& p, cudaLaunchAttribute* attr, cudaStream_t st) {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(gn_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         sm90::SMEM_BUDGET);
    cudaFuncSetAttribute(gn_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid_x, p.grid_y);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of plan p that can be resident at once (0 for the pair).
int active_clusters(const GnPlan& p) {
  if (p.form == GN_PAIR) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, &attr, nullptr);
  int n = 0;
  cudaOccupancyMaxActiveClusters(&n, gn_cluster_kernel, &cfg);
  return n;
}

// ---------------------------------------------------------------------------
// The backward: one cooperative launch
// ---------------------------------------------------------------------------

// 16-byte loads of x and of g a thread keeps in flight: in the first walk,
// from device memory, and in the second, mostly from L2 (fewer, so that its
// larger set of per-channel constants fits 128 registers without a spill).
constexpr int BWD_UNROLL = 4;
constexpr int BWD_UNROLL_L2 = 2;
constexpr int FOLD_LOADS = 8;  // loads a lane keeps in flight in fold8
// Spins of a grid barrier (64 ns sleeps, seconds in all) after which a block
// traps rather than hang the card.
constexpr unsigned BARRIER_SPINS = 1u << 26;

struct GnBwdArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* g;  // (B, H, W, C), or (B, H+2, W+2, C) with gpad
  const __nv_bfloat16* gamma;
  const __nv_bfloat16* beta;
  const __nv_bfloat16* temb;  // (B, C) or null
  const float* stats;         // (B, 2, G) (mean, rstd) of the forward
  __nv_bfloat16* dx;
  float* dparams;  // (2, C): dbeta, then dgamma
  float* dtemb;    // (B, C), or null without temb
  float* chpart;   // (tiles, 2, C): a tile's sum dy, sum dy * xhat
  float* grpart;   // (tiles, 2, G): a tile's sum dxhat, sum dxhat * xhat
  float* tpart;    // (tiles, C): a tile's sum dx, or null without temb
  unsigned* sync;  // [0]: the grid barrier and exit count; [1 + b]: image b's tiles arrived
  int B, HW, W, C, G, splits, pixels, gpad, activate;
};

struct GnBwdPlan {
  int splits, images, pixels, threads, smem, resident;
};

// Dynamic shared memory: the fold's [2][R][C] fp32 sums, the (2, G) group
// means of the image in hand.
int gn_bwd_smem(int C) { return 64 * gn_threads(C) + 2 * MAXG * 4; }

// The plan's rule: as many blocks as the card holds at once (`resident` an
// SM on `sms` SMs), shared out over the B images as equal contiguous pixel
// ranges (splits an image, each of at least a pixel a row of threads), none
// of them empty; with more images than that, each block row takes images
// y, y + images, ...
GnBwdPlan gn_bwd_plan(int B, int H, int W, int C, int resident, int sms) {
  GnBwdPlan p;
  p.threads = gn_threads(C);
  p.smem = gn_bwd_smem(C);
  p.resident = resident;
  const int rows = p.threads / (C / 8);
  const int hw = H * W;
  const int cap = resident * sms;
  const int by_batch = B > 0 ? cap / B : cap;
  const int by_rows = (hw + rows - 1) / rows;
  const int splits = by_batch < by_rows ? by_batch : by_rows;
  p.pixels = splits > 1 ? (hw + splits - 1) / splits : hw;
  p.splits = p.pixels > 0 ? (hw + p.pixels - 1) / p.pixels : 1;
  p.images = B < cap / p.splits ? B : cap / p.splits;
  return p;
}

__device__ __forceinline__ uint32_t ld_acquire(const unsigned* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A grid-wide barrier among co-resident blocks: each block publishes its
// writes and adds one to *counter, then waits until `count` blocks have.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned spins = 0;
    while (ld_acquire(counter) < count) {
      __nanosleep(64);
      if (++spins == BARRIER_SPINS) __trap();
    }
  }
  __syncthreads();
}

// A thread's walk over pixels first, first + step, ... (step < 0 walks
// back) with each pixel's row and column, for the padded cotangent's
// address, kept without a division a pixel.
struct PixWalk {
  int p, py, px, dq, dr;
  __device__ PixWalk(int first, int step, int W)
      : p(first), py(first / W), px(first % W), dq(step / W), dr(step % W) {}
  __device__ void next(int step, int W) {
    p += step;
    py += dq;
    px += dr;
    if (px >= W) {
      px -= W;
      ++py;
    } else if (px < 0) {
      px += W;
      --py;
    }
  }
};

// Per-thread constants of the backward for channels [c0, c0 + 8) of image
// b, as affine maps of x: xhat = x rs + shr (shr = (t - mean) rstd) and the
// forward's pre-activation y = xhat gamma + beta = x ya + yb.
struct GnBwdChan {
  float rs[8], shr[8], ya[8], yb[8];
};

__device__ __forceinline__ void bwd_chan(const GnBwdArgs& a, int b, int c0, GnBwdChan& ch) {
  const int cg = a.C / a.G;
  float t[8], gm[8], bt[8];
  load8(a.gamma + c0, gm);
  load8(a.beta + c0, bt);
#pragma unroll
  for (int e = 0; e < 8; ++e) t[e] = 0.0f;
  if (a.temb != nullptr) load8(a.temb + (size_t)b * a.C + c0, t);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int g = (c0 + e) / cg;
    ch.rs[e] = a.stats[((size_t)b * 2 + 1) * a.G + g];
    ch.shr[e] = (t[e] - a.stats[(size_t)b * 2 * a.G + g]) * ch.rs[e];
    ch.ya[e] = ch.rs[e] * gm[e];
    ch.yb[e] = fmaf(ch.shr[e], gm[e], bt[e]);
  }
}

// dL/dy of one pixel's 8 channels x: the cotangent dy (in place) through
// the SiLU's derivative when the forward activated.
__device__ __forceinline__ void bwd_dy(const GnBwdArgs& a, const GnBwdChan& ch, const float* x,
                                       float* dy) {
  if (!a.activate) return;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = fmaf(x[e], ch.ya[e], ch.yb[e]);
    const float sig = __fdividef(1.0f, 1.0f + __expf(-y));
    dy[e] *= sig * fmaf(y, 1.0f - sig, 1.0f);
  }
}

// f(p, x, g) for the n pixels first, first + step, ... of image b: the
// 16-byte chunks at channel c0 of x and of the cotangent, U loads of each
// issued before the first f. LAST_USE reads them as the last use (evict
// first), else through the read-only path.
template <int U, bool LAST_USE, class F>
__device__ __forceinline__ void bwd_walk(const GnBwdArgs& a, int b, int c0, int first, int n,
                                         int step, F&& f) {
  const int H = a.HW / a.W;
  const __nv_bfloat16* xb = a.x + (size_t)b * a.HW * a.C + c0;
  const __nv_bfloat16* gb =
      a.g + (size_t)b * (a.gpad ? (H + 2) * (a.W + 2) : a.HW) * a.C + c0;
  auto ld = [](const __nv_bfloat16* q) {
    const uint4* u = reinterpret_cast<const uint4*>(q);
    if constexpr (LAST_USE) return __ldcs(u);
    else return __ldg(u);
  };
  // The padded cotangent holds pixel p at p + 2 py + W + 3.
  auto gpix = [&](const PixWalk& w) { return a.gpad ? w.p + 2 * w.py + a.W + 3 : w.p; };
  PixWalk w(first, step, a.W);
  for (; n >= U; n -= U) {
    uint4 xr[U], gr[U];
    int ps[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ps[u] = w.p;
      xr[u] = ld(xb + (size_t)w.p * a.C);
      gr[u] = ld(gb + (size_t)gpix(w) * a.C);
      w.next(step, a.W);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) f(ps[u], xr[u], gr[u]);
  }
  for (; n > 0; --n) {
    f(w.p, ld(xb + (size_t)w.p * a.C), ld(gb + (size_t)gpix(w) * a.C));
    w.next(step, a.W);
  }
}

// The block's per-channel sums of nq quantities, each thread's 8 at
// red[q][row][c0..c0 + 8) ([nq][R][C] fp32), folded over the R rows in a
// fixed order into red[q][0][c] and written to out[q * C + c].
__device__ __forceinline__ void fold_rows(float* red, float* out, int nq, int C, int rows) {
  const int T = blockDim.x;
  __syncthreads();
  for (int i = threadIdx.x; i < nq * C; i += T) {
    float* r = red + (i / C) * T * 8 + i % C;
    float acc = r[0];
    for (int k = 1; k < rows; ++k) acc += r[k * C];
    r[0] = acc;
    out[i] = acc;
  }
  __syncthreads();
}

// out[o] = scale * (the sum over parts p of src[p * stride + o]) for the
// outputs o0 .. o0 + 7 (< n), in fp64 and in a fixed order, by one warp:
// lane (j, k) = (lane % 8, lane / 8) sums output o0 + j over parts k, k + 4,
// ... (FOLD_LOADS loads in flight, 8 lanes reading 32 contiguous bytes),
// then two shuffle steps add the four k: (S0 + S1) + (S2 + S3). Every
// caller gets the same bits from the same partials.
__device__ __forceinline__ void fold8(const float* src, size_t stride, int parts, int n, int o0,
                                      double scale, float* out) {
  const int lane = threadIdx.x % 32;
  const int o = o0 + lane % 8;
  double acc = 0.0;
  if (o < n) {
    int p = lane / 8;
    for (; p + 4 * (FOLD_LOADS - 1) < parts; p += 4 * FOLD_LOADS) {
      float v[FOLD_LOADS];
#pragma unroll
      for (int u = 0; u < FOLD_LOADS; ++u) v[u] = __ldcg(src + (size_t)(p + 4 * u) * stride + o);
#pragma unroll
      for (int u = 0; u < FOLD_LOADS; ++u) acc += v[u];
    }
    for (; p < parts; p += 4) acc += __ldcg(src + (size_t)p * stride + o);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  if (lane < 8 && o < n) out[o] = (float)(acc * scale);
}

// One launch: block (s, y) owns pixel range s of images y, y + images, ...
//   1. per tile (image, range): sum dy and dy * xhat per channel over its
//      pixels (each thread an 8-channel chunk, R pixel rows in parallel,
//      BWD_UNROLL loads of x and of g in flight), folded in a fixed order,
//      written as the tile's channel partials and, weighted by gamma, its
//      group partials (dxhat, dxhat * xhat);
//   2. the grid barrier;
//   3. per tile: the image's group partials folded over its splits (fold8:
//      every block of the image the same bits); the range walked again,
//      newest first (mostly from L2), dx = rstd (dy gamma - m1 - xhat m2)
//      written with 16-byte evict-first stores; with a temb, the tile's sum
//      of dx per channel, and its arrival counted on the image's counter;
//   4. the parameters, 8 outputs a warp over all the grid's warps: dbeta and
//      dgamma from every tile's channel partials, and with a temb dtemb from
//      each image's tile sums, a warp first waiting for all of that image's
//      tiles to arrive.
// No atomics in any sum, so a repeated call is bit-identical. The last
// block out resets the barrier and the images' counters.
__global__ void __launch_bounds__(MAX_THREADS, 1) gn_bwd_kernel(GnBwdArgs a) {
  extern __shared__ __align__(16) float bsm[];
  float* red = bsm;                  // [2][R][C]
  float* m = bsm + 16 * blockDim.x;  // [2][G]: the image's m1, m2 of each group
  const int T = blockDim.x;
  const int warps = T / 32;  // full warps: a partial last one takes no fold job
  const int chunks = a.C / 8;
  const int rows = T / chunks;
  const int c0 = (threadIdx.x % chunks) * 8;
  const int row = threadIdx.x / chunks;
  const int cg = a.C / a.G;
  const unsigned nb = gridDim.x * gridDim.y;
  const int p0 = blockIdx.x * a.pixels;
  const int p1 = min(p0 + a.pixels, a.HW);
  const int n = p0 + row < p1 ? (p1 - p0 - row - 1) / rows + 1 : 0;  // this thread's pixels

  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    const size_t tile = (size_t)b * a.splits + blockIdx.x;
    GnBwdChan ch;
    bwd_chan(a, b, c0, ch);
    float s0[8] = {}, s1[8] = {};
    bwd_walk<BWD_UNROLL, false>(a, b, c0, p0 + row, n, rows,
                                [&](int, const uint4& xr, const uint4& gr) {
                                  float v[8], dy[8];
                                  unpack8(xr, v);
                                  unpack8(gr, dy);
                                  bwd_dy(a, ch, v, dy);
#pragma unroll
                                  for (int e = 0; e < 8; ++e) {
                                    s0[e] += dy[e];
                                    s1[e] = fmaf(dy[e], fmaf(v[e], ch.rs[e], ch.shr[e]), s1[e]);
                                  }
                                });
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[threadIdx.x * 8 + e] = s0[e];
      red[T * 8 + threadIdx.x * 8 + e] = s1[e];
    }
    fold_rows(red, a.chpart + tile * 2 * a.C, 2, a.C, rows);
    for (int i = threadIdx.x; i < 2 * a.G; i += T) {
      const float* r = red + (i / a.G) * T * 8 + (i % a.G) * cg;
      const __nv_bfloat16* gm = a.gamma + (i % a.G) * cg;
      float acc = 0.0f;
      for (int k = 0; k < cg; ++k) acc = fmaf(__bfloat162float(gm[k]), r[k], acc);
      a.grpart[tile * 2 * a.G + i] = acc;
    }
    __syncthreads();  // red is rewritten for the next image
  }

  grid_barrier(a.sync, nb);

  for (int b = blockIdx.y; b < a.B; b += gridDim.y) {
    const size_t tile = (size_t)b * a.splits + blockIdx.x;
    if (threadIdx.x < warps * 32) {
      for (int o0 = threadIdx.x / 32 * 8; o0 < 2 * a.G; o0 += warps * 8)
        fold8(a.grpart + (size_t)b * a.splits * 2 * a.G, 2 * a.G, a.splits, 2 * a.G, o0,
              1.0 / ((double)a.HW * cg), m);
    }
    __syncthreads();
    GnBwdChan ch;
    bwd_chan(a, b, c0, ch);
    // dx = rstd (dy gamma - m1 - xhat m2) = dy ya - (x dp + dq), with
    // dp = rstd^2 m2 and dq = rstd (m1 + shr m2).
    float dp[8], dq[8], dt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float m1 = m[(c0 + e) / cg], m2 = m[a.G + (c0 + e) / cg];
      dp[e] = ch.rs[e] * ch.rs[e] * m2;
      dq[e] = ch.rs[e] * fmaf(ch.shr[e], m2, m1);
      dt[e] = 0.0f;
    }
    __nv_bfloat16* dxb = a.dx + (size_t)b * a.HW * a.C + c0;
    bwd_walk<BWD_UNROLL_L2, true>(a, b, c0, p0 + row + (n - 1) * rows, n, -rows,
                               [&](int p, const uint4& xr, const uint4& gr) {
                                 float v[8], dy[8];
                                 unpack8(xr, v);
                                 unpack8(gr, dy);
                                 bwd_dy(a, ch, v, dy);
#pragma unroll
                                 for (int e = 0; e < 8; ++e) {
                                   dy[e] = fmaf(dy[e], ch.ya[e], -fmaf(v[e], dp[e], dq[e]));
                                   dt[e] += dy[e];
                                 }
                                 __stcs(reinterpret_cast<uint4*>(dxb + (size_t)p * a.C), pack8(dy));
                               });
    if (a.temb == nullptr) {
      __syncthreads();  // m is rewritten for the next image
      continue;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = dt[e];
    fold_rows(red, a.tpart + tile * a.C, 1, a.C, rows);  // ends in __syncthreads
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(a.sync + 1 + b, 1u);
    }
  }

  // The parameters' jobs of 8 outputs: dbeta and dgamma's, then each
  // image's dtemb's.
  if (threadIdx.x < warps * 32) {
    const int pjobs = (2 * a.C + 7) / 8, tjobs = (a.C + 7) / 8;
    const int jobs = pjobs + (a.temb != nullptr ? a.B * tjobs : 0);
    for (int j = (blockIdx.y * gridDim.x + blockIdx.x) * warps + threadIdx.x / 32; j < jobs;
         j += nb * warps) {
      if (j < pjobs) {
        fold8(a.chpart, 2 * a.C, a.B * a.splits, 2 * a.C, 8 * j, 1.0, a.dparams);
        continue;
      }
      const int b = (j - pjobs) / tjobs;
      unsigned spins = 0;
      while (ld_acquire(a.sync + 1 + b) < (unsigned)a.splits) {  // image b's tiles arrived
        __nanosleep(64);
        if (++spins == BARRIER_SPINS) __trap();
      }
      fold8(a.tpart + (size_t)b * a.splits * a.C, a.C, a.splits, a.C, 8 * ((j - pjobs) % tjobs),
            1.0, a.dtemb + (size_t)b * a.C);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(a.sync, 1u) == 2 * nb - 1) {  // every block is done
    a.sync[0] = 0;
    for (int b = 0; b < a.B; ++b) a.sync[1 + b] = 0;
  }
}

// Blocks of the backward at C channels that the card holds on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the card's SMs.
int bwd_resident(int C) {
  static int cached[MAX_THREADS + 1] = {};
  int& n = cached[C / 8];
  if (n == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gn_bwd_kernel, gn_threads(C), gn_bwd_smem(C));
  return n;
}

int device_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

// x: (B, H, W, C); out: (B, H + 2 pad, W + 2 pad, C); partials: the pair's
// B * splits * G * 2 floats of scratch (splits = the plan's grid_x; null for
// the cluster kernel); stats: (B, 2, G) fp32 or null. All other tensors
// bf16. C % 8 == 0, C % G == 0, G <= 64, C <= 4096.
extern "C" int gmdx_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                    const void* temb, void* out, void* partials, void* stats,
                                    int B, int H, int W, int C, int G, float eps, int activate,
                                    int pad, void* stream) {
  if (C % 8 || C % G || G > MAXG || C / 8 > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const GnPlan p = gn_plan(B, H, W, C);
  if (B == 0 || H * W == 0) return 0;
  GnArgs a = {};
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
  a.pixels = p.pixels;
  a.pad = pad;
  a.eps = eps;
  a.activate = activate;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.form == GN_PAIR) {
    static bool attr = false;
    if (!attr) {
      cudaFuncSetAttribute(gn_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           64 * MAX_THREADS);
      attr = true;
    }
    const dim3 grid(p.grid_x, p.grid_y);
    gn_stats_kernel<<<grid, p.threads, p.smem, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gn_apply_kernel<<<grid, p.threads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p, &attr, st);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gn_cluster_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The split form of the forward, for an image whose rows lie on several
// ranks (spatial parallelism): gmdx_group_norm_moments gives each group's
// (mean, M2) over this rank's rows, the caller merges every rank's into the
// whole image's (mean, rstd), and gmdx_group_norm_apply normalises the rows
// with them. Both run the pair's kernels at the pair's grid (gn_plan's
// splits for these rows), so x is read twice, as by the pair.
static GnArgs split_args(const void* x, const void* temb, int H, int W, int C, int G, int splits) {
  GnArgs a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.temb = static_cast<const __nv_bfloat16*>(temb);
  a.HW = H * W;
  a.W = W;
  a.C = C;
  a.G = G;
  a.pixels = (a.HW + splits - 1) / splits;
  return a;
}

// x: (B, H, W, C) bf16 (this rank's rows), temb (B, C) bf16 or null;
// partials: B * splits * G * 2 floats of scratch (splits = the pair's
// gn_pair_splits(B, H * W, C)); moments: (B, G, 2) fp32, written.
extern "C" int gmdx_group_norm_moments(const void* x, const void* temb, void* partials,
                                       void* moments, int B, int H, int W, int C, int G,
                                       void* stream) {
  if (C % 8 || C % G || G > MAXG || C / 8 > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H * W == 0) return 0;
  const int splits = gn_pair_splits(B, H * W, C);
  GnArgs a = split_args(x, temb, H, W, C, G, splits);
  a.partials = static_cast<float*>(partials);
  a.moments = static_cast<float*>(moments);
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(gn_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         64 * MAX_THREADS);
    attr = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = gn_threads(C);
  gn_stats_kernel<<<dim3(splits, B), threads, 64 * threads, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_moments_kernel<<<B, MAXG, 0, st>>>(a, splits);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, H, W, C) bf16 rows; stats: (B, 2, G) fp32 (mean, rstd) of the whole
// image; out: (B, H + 2 pad, W + 2 pad, C), its top and bottom border rows
// zero (the caller puts the neighbours' rows there).
extern "C" int gmdx_group_norm_apply(const void* x, const void* gamma, const void* beta,
                                     const void* temb, const void* stats, void* out, int B,
                                     int H, int W, int C, int G, int activate, int pad,
                                     void* stream) {
  if (C % 8 || C % G || G > MAXG || C / 8 > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H * W == 0) return 0;
  const int splits = gn_pair_splits(B, H * W, C);
  GnArgs a = split_args(x, temb, H, W, C, G, splits);
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.stats_in = static_cast<const float*>(stats);
  a.pad = pad;
  a.activate = activate;
  gn_apply_kernel<<<dim3(splits, B), gn_threads(C), 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The forward's plan at (B, H, W, C), for kernels/groupnorm.py:group_norm_plan
// to be held to: out[8] = form (0 the pair, 1 the cluster kernel), cluster
// size, pixels a CTA (pair block) takes, dynamic shared-memory bytes, grid x
// and y, threads a block, and the clusters that can be resident at once
// (cudaOccupancyMaxActiveClusters; 0 for the pair).
extern "C" int gmdx_group_norm_plan(int B, int H, int W, int C, int* out) {
  if (C % 8 || C / 8 > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const GnPlan p = gn_plan(B, H, W, C);
  const int fields[8] = {p.form, p.cluster, p.pixels, p.smem, p.grid_x, p.grid_y, p.threads,
                         active_clusters(p)};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return static_cast<int>(cudaGetLastError());
}

// x, dx: (B, H, W, C); g: the same, or (B, H+2, W+2, C) with gpad; stats:
// (B, 2, G) fp32 from the forward; dparams: (2, C) (dbeta, then dgamma) and
// dtemb: (B, C) fp32, written here (dtemb null without temb); chpart,
// grpart, tpart: tiles * 2 * C, tiles * 2 * G and tiles * C floats of
// scratch, tiles = B * splits (tpart null without temb); sync: 1 + B zeroed
// uint32, which the kernel leaves zeroed. splits and images are the caller's plan
// (kernels/groupnorm.py:group_norm_bwd_plan), which must be this one: the
// scratch is sized by it. Other tensors bf16. C % 8 == 0, C % G == 0,
// G <= 64, C <= 4096, else cudaErrorInvalidValue.
extern "C" int gmdx_group_norm_silu_bwd(const void* x, const void* g, const void* gamma,
                                        const void* beta, const void* temb, const void* stats,
                                        void* dx, void* dparams, void* dtemb, void* chpart,
                                        void* grpart, void* tpart, void* sync, int B,
                                        int H, int W, int C, int G, int splits, int images,
                                        int activate, int gpad, void* stream) {
  if (C % 8 || C % G || G > MAXG || C / 8 > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H * W == 0) return 0;
  const GnBwdPlan p = gn_bwd_plan(B, H, W, C, bwd_resident(C), device_sms());
  if (p.splits != splits || p.images != images || p.images == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GnBwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.gamma = static_cast<const __nv_bfloat16*>(gamma);
  a.beta = static_cast<const __nv_bfloat16*>(beta);
  a.temb = static_cast<const __nv_bfloat16*>(temb);
  a.stats = static_cast<const float*>(stats);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.dparams = static_cast<float*>(dparams);
  a.dtemb = static_cast<float*>(dtemb);
  a.chpart = static_cast<float*>(chpart);
  a.grpart = static_cast<float*>(grpart);
  a.tpart = static_cast<float*>(tpart);
  a.sync = static_cast<unsigned*>(sync);
  a.B = B;
  a.HW = H * W;
  a.W = W;
  a.C = C;
  a.G = G;
  a.splits = p.splits;
  a.pixels = p.pixels;
  a.gpad = gpad;
  a.activate = activate;
  void* args[] = {&a};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gn_bwd_kernel),
                                  dim3(p.splits, p.images), dim3(p.threads), args, p.smem,
                                  static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The backward's plan at (B, H, W, C), for kernels/groupnorm.py:
// group_norm_bwd_plan to be held to: out[7] = splits (blocks an image),
// images (block rows), pixels a block, threads a block, dynamic shared-memory
// bytes, blocks resident an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and the card's SMs.
extern "C" int gmdx_group_norm_bwd_plan(int B, int H, int W, int C, int* out) {
  if (C % 8 || C / 8 > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = device_sms();
  const GnBwdPlan p = gn_bwd_plan(B, H, W, C, bwd_resident(C), sms);
  const int fields[7] = {p.splits, p.images, p.pixels, p.threads, p.smem, p.resident, sms};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return static_cast<int>(cudaGetLastError());
}
