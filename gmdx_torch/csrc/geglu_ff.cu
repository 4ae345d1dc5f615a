// Transformer feed-forward tail: s = x + a, h = LayerNorm(s),
// out = (h @ W1a + b1a) * gelu_erf(h @ W1b + b1b) @ W2 + b2 + s, over bf16
// tokens (M, dim) with dim 320, 640 or 1280.
//
// gmdx_geglu_ff_ln replaces gmdx/kernels/geglu_ff.py:_ff_ln_pallas
// (pallas_call at :349; TPU kernels _ff_add_ln_kernel and _ff_ln_kernel,
// which covered dims 320 and 640 only). Three launches:
//   1. A row pre-pass, one warp a token: s = bf16(x + a), fp32 two-pass
//      statistics, h = bf16(LN(s)); h and s (with an add) go to device
//      memory. The LayerNorm is taken once a token, not once for every
//      column tile of GEMM1.
//   2. GEMM1 on the Hopper core (gemm_sm90.cuh): h @ W1^T by TMA, a B stage
//      holding 64 hidden and the matching 64 gate rows of W1 (two boxes), so
//      that hidden column j and gate column j + 64 sit in the same thread's
//      m64n128 fragment. The GEGLU runs on the accumulator registers: bias,
//      erf-GELU, the bf16 (tokens, 4*dim) product `act`. The (tokens,
//      8*dim) pre-activation never goes to device memory.
//   3. GEMM2 on the same core: act @ W2^T with BN dividing dim (160 at
//      320/640/1280), + b2 + s in the epilogue.
// s, h and act are rounded to bf16 where the JAX kernel's _ff_ln_body rounds
// them.
//
// gmdx_geglu_ff replaces gmdx/kernels/geglu_ff.py:geglu_ff (TPU kernel
// _ff_kernel, pallas_call in _ff_pallas): the same two GEMMs without the
// LayerNorm, out = GEGLU(x) @ W2 + b2 (+ residual), on the same core and
// the same launch plan (kernels/geglu_ff.py:geglu_ff_ln_plan). GEMM1's A
// map is over x itself: with no LayerNorm there is no row pre-pass. The
// residual add of GEMM2's epilogue is skipped where residual is null. The
// two instances are types of their own (NoLnGegluOp, NoLnOutOp), so that a
// profile tells their launches from the LN-fused FF's.
//
// Bound on the H100: 2 * M * dim * 12 * dim operations on about
// (3 * dim + 4 * dim) * 2 bytes a token plus the weights, some 1000
// operations a byte at dim 320: tensor-core bound. The (tokens, 4*dim)
// round trip of act (and h, s) through device memory is what remains
// between the kernel and its bound: keeping act on chip, as the TPU kernel
// keeps it in VMEM, is later work.
#include "bf16x8.cuh"
#include "gemm_sm90.cuh"

namespace ffln {
namespace s9 = gmdx::sm90;

// s = bf16(x + a) (x alone without a) for 8 channels at `off`.
__device__ __forceinline__ void load_s(const __nv_bfloat16* x, const __nv_bfloat16* a, size_t off,
                                       float* v) {
  gmdx::load8(x + off, v);
  if (a != nullptr) {
    float av[8];
    gmdx::load8(a + off, av);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = gmdx::bf16_round(v[e] + av[e]);
  }
}

// The row pre-pass: one warp a token. Two-pass fp32 statistics of s; the
// row's later passes read it again from L1.
__global__ void __launch_bounds__(256)
ln_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ gamma, const __nv_bfloat16* __restrict__ beta,
               __nv_bfloat16* __restrict__ s_out, __nv_bfloat16* __restrict__ h_out, int M,
               int dim, float eps) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (m >= M) return;
  const size_t row = (size_t)m * dim;
  float sum = 0.0f;
  for (int k = lane * 8; k < dim; k += 256) {
    float v[8];
    load_s(x, a, row + k, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / dim;
  float sq = 0.0f;
  for (int k = lane * 8; k < dim; k += 256) {
    float v[8];
    load_s(x, a, row + k, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / dim + eps);
  for (int k = lane * 8; k < dim; k += 256) {
    float v[8], g[8], b[8], h[8];
    load_s(x, a, row + k, v);
    gmdx::load8(gamma + k, g);
    gmdx::load8(beta + k, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = (v[e] - mean) * rstd * g[e] + b[e];
    *reinterpret_cast<uint4*>(h_out + row + k) = gmdx::pack8(h);
    if (s_out != nullptr) *reinterpret_cast<uint4*>(s_out + row + k) = gmdx::pack8(v);
  }
}

// GELU with erf by Abramowitz & Stegun 7.1.26 (absolute error of erf under
// 5e-7 in fp32, far inside the bf16 rounding of act): one approximate
// reciprocal, one exponential and a branch-free polynomial, where erff
// branches on |x|. GEMM1's epilogue is as long as its K loop, and this cut
// the FF's time by 4-5 % at dims 320/640 against erff (PERF.md).
__device__ __forceinline__ float gelu_erf_fast(float v) {
  const float x = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, x, 1.0f));
  const float p = fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f), t,
                            -0.284496736f), t, 0.254829592f) * t;
  const float erf_abs = 1.0f - p * __expf(-x * x);
  return 0.5f * v * (1.0f + copysignf(erf_abs, v));
}

// GEMM1: act = GEGLU(h @ W1^T + b1) for 64 hidden columns a unit.
struct Gemm1Op {
  static constexpr int kBN = 128;
  static constexpr int kOutW = 64;
  static constexpr bool kGather = false;
  static constexpr bool kPingPong = true;  // K is 5-20 slices; the GEGLU epilogue is long
  using R = s9::Ring<kBN, kOutW>;
  using S = s9::Smem<kBN, kOutW>;

  s9::Units units;
  int M, inner;
  const __nv_bfloat16* b1;
  __nv_bfloat16* act;

  __device__ __forceinline__ void load(const R& ring, int stage, uint64_t* bar,
                                       const CUtensorMap* ta, const CUtensorMap* tb, int mt,
                                       int nt, int s) const {
    s9::tma_load_2d(ring.a(stage), ta, bar, s * s9::BK, mt * s9::BM);
    s9::tma_load_2d(ring.b(stage), tb, bar, s * s9::BK, nt * 64);                  // hidden
    s9::tma_load_2d(ring.b(stage) + 64 * 128, tb, bar, s * s9::BK, inner + nt * 64);  // gate
  }

  __device__ __forceinline__ void epilogue(float* acc, const R& ring, int wg, int m_base, int nt,
                                           int) const {
    const int n0 = nt * 64;
    __nv_bfloat16* stg = ring.staging_of(wg);
    s9::warpgroup_sync(wg);
#pragma unroll
    for (int i = 0; i < kBN / 4; i += 2) {  // hidden at acc[i], its gate at acc[i + 32]
      const int c = s9::frag_col(i);
      const int n = n0 + c;
      float v0 = 0.0f, v1 = 0.0f;
      if (n < inner) {
        const float2 bh = s9::load_bf16x2(b1 + n);
        const float2 bg = s9::load_bf16x2(b1 + inner + n);
        v0 = (acc[i] + bh.x) * gelu_erf_fast(acc[i + kBN / 4] + bg.x);
        v1 = (acc[i + 1] + bh.y) * gelu_erf_fast(acc[i + 1 + kBN / 4] + bg.y);
      }
      *reinterpret_cast<__nv_bfloat162*>(stg + s9::frag_row(i) * S::LDS + c) =
          __floats2bfloat162_rn(v0, v1);
    }
    s9::warpgroup_sync(wg);
    s9::store_staged<kOutW, S::LDS>(stg, act, inner, m_base, n0, M, inner);
  }
};

// GEMM2: out = act @ W2^T + b2 + res (res may be null: nothing added).
template <int BN>
struct Gemm2Op {
  static constexpr int kBN = BN;
  static constexpr int kOutW = BN;
  static constexpr bool kGather = false;
  static constexpr bool kPingPong = false;
  using R = s9::Ring<BN, BN>;
  using S = s9::Smem<BN, BN>;

  s9::Units units;
  int M, dim;
  const __nv_bfloat16* b2;
  const __nv_bfloat16* res;
  __nv_bfloat16* out;

  __device__ __forceinline__ void load(const R& ring, int stage, uint64_t* bar,
                                       const CUtensorMap* ta, const CUtensorMap* tb, int mt,
                                       int nt, int s) const {
    s9::tma_load_2d(ring.a(stage), ta, bar, s * s9::BK, mt * s9::BM);
    s9::tma_load_2d(ring.b(stage), tb, bar, s * s9::BK, nt * BN);
  }

  __device__ __forceinline__ void epilogue(float* acc, const R& ring, int wg, int m_base, int nt,
                                           int) const {
    const int n0 = nt * BN;
    __nv_bfloat16* stg = ring.staging_of(wg);
    s9::warpgroup_sync(wg);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = s9::frag_row(i);
      const int c = s9::frag_col(i);
      const int m = m_base + r;
      const int n = n0 + c;
      float v0 = 0.0f, v1 = 0.0f;
      if (m < M && n < dim) {
        const float2 bv = s9::load_bf16x2(b2 + n);
        const float2 sv = res != nullptr ? s9::load_bf16x2(res + (size_t)m * dim + n)
                                         : make_float2(0.0f, 0.0f);
        v0 = acc[i] + bv.x + sv.x;
        v1 = acc[i + 1] + bv.y + sv.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(stg + r * S::LDS + c) = __floats2bfloat162_rn(v0, v1);
    }
    s9::warpgroup_sync(wg);
    s9::store_staged<BN, S::LDS>(stg, out, dim, m_base, n0, M, dim);
  }
};

// The LN-free FF's instances: the same ops under names of their own.
struct NoLnGegluOp : Gemm1Op {};
template <int BN>
struct NoLnOutOp : Gemm2Op<BN> {};

// GEMM1 of either FF: act = GEGLU(a @ W1^T + b1), a (M, dim) = h or x.
template <class Op>
int gemm1(const void* a, const void* w1, const void* b1, void* act, int M, int dim, int inner,
          cudaStream_t st) {
  CUtensorMap ta{}, tb{};
  if (!s9::make_map_2d(&ta, a, M, dim, s9::BM) || !s9::make_map_2d(&tb, w1, 2 * inner, dim, 64))
    return s9::TMA_MAP_REFUSED;
  Op op;
  const int k1 = (dim + s9::BK - 1) / s9::BK;
  op.units = {(M + s9::BM - 1) / s9::BM, (inner + 63) / 64, 1, k1, k1};
  op.M = M;
  op.inner = inner;
  op.b1 = static_cast<const __nv_bfloat16*>(b1);
  op.act = static_cast<__nv_bfloat16*>(act);
  return s9::launch(ta, tb, op, st);
}

template <class Op>
int gemm2_bn(const void* act, const void* w2, const void* b2, const void* res, void* out, int M,
             int dim, int inner, cudaStream_t st) {
  constexpr int BN = Op::kBN;
  CUtensorMap ta{}, tb{};
  if (!s9::make_map_2d(&ta, act, M, inner, s9::BM) || !s9::make_map_2d(&tb, w2, dim, inner, BN))
    return s9::TMA_MAP_REFUSED;
  Op op;
  const int k2 = (inner + s9::BK - 1) / s9::BK;
  op.units = {(M + s9::BM - 1) / s9::BM, (dim + BN - 1) / BN, 1, k2, k2};
  op.M = M;
  op.dim = dim;
  op.b2 = static_cast<const __nv_bfloat16*>(b2);
  op.res = static_cast<const __nv_bfloat16*>(res);
  op.out = static_cast<__nv_bfloat16*>(out);
  return s9::launch(ta, tb, op, st);
}

// GEMM2 of either FF: out = act @ W2^T + b2 (+ res), tile width bn2.
template <template <int> class Op>
int gemm2(const void* act, const void* w2, const void* b2, const void* res, void* out, int M,
          int dim, int inner, int bn2, cudaStream_t st) {
  if (bn2 == 160) return gemm2_bn<Op<160>>(act, w2, b2, res, out, M, dim, inner, st);
  if (bn2 == 128) return gemm2_bn<Op<128>>(act, w2, b2, res, out, M, dim, inner, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ffln

// w1: (2 * inner, dim) rows [hidden | gate]; w2: (dim, inner); h: (M, dim),
// s: (M, dim) (unused without a) and act: (M, inner) scratch. Every pointer
// is bf16; a may be null. bn2: GEMM2's tile width, 160 or 128.
extern "C" int gmdx_geglu_ff_ln(const void* x, const void* a, const void* gamma, const void* beta,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* h, void* s, void* act, void* out, int M, int dim, int inner,
                                float eps, int bn2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(a);
  __nv_bfloat16* sb = ab != nullptr ? static_cast<__nv_bfloat16*>(s) : nullptr;
  ffln::ln_rows_kernel<<<(M + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), ab, static_cast<const __nv_bfloat16*>(gamma),
      static_cast<const __nv_bfloat16*>(beta), sb, static_cast<__nv_bfloat16*>(h), M, dim, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = ffln::gemm1<ffln::Gemm1Op>(h, w1, b1, act, M, dim, inner, st);
  if (e != 0) return e;
  const void* res = sb != nullptr ? static_cast<const void*>(sb) : x;
  return ffln::gemm2<ffln::Gemm2Op>(act, w2, b2, res, out, M, dim, inner, bn2, st);
}

// The LN-free feed-forward: x, residual (may be null), out: (M, dim); w1, b1,
// w2, b2, the (M, inner) scratch act and bn2 as for gmdx_geglu_ff_ln.
extern "C" int gmdx_geglu_ff(const void* x, const void* residual, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* act, void* out, int M, int dim,
                             int inner, int bn2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = ffln::gemm1<ffln::NoLnGegluOp>(x, w1, b1, act, M, dim, inner, st);
  if (e != 0) return e;
  return ffln::gemm2<ffln::NoLnOutOp>(act, w2, b2, residual, out, M, dim, inner, bn2, st);
}
