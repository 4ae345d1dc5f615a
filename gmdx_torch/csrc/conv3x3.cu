// 3x3 stride-1 SAME convolution + bias over NHWC bf16, as an implicit GEMM
// on the Hopper GEMM core (gemm_sm90.cuh).
//
// Replaces gmdx/kernels/winograd.py:_wino_forward (pallas_call at :939;
// TPU kernel _wino_kernel, Winograd F(2x2, 3x3)).
//
// out[(b, y, x), o] = bias[o] + sum_{tap, c} in[b, y + ky - 1, x + kx - 1, c] * w[o, tap, c]
// is the product (pixels, 9*C) @ (9*C, O). The A operand is never built in
// device memory. The launch plan (gmdx_torch/kernels/winograd.py:
// conv3x3_plan, computed in Python so that the CPU tests check it) picks
// one of two producers:
//   * TMA (C % 64 == 0 and a 128-pixel tile that is a box of whole rows:
//     W | 128 or 128 | W). A 4D tensor map over the NHWC input (C, W_in,
//     H_in, B); for each 64-channel slice of each tap, one box (64, bw, bh,
//     bb) with bw * bh * bb = 128 output pixels in M order, at origin
//     (c0, x0 + kx - halo, y0 + ky - halo, b0). The TMA fills the box's
//     out-of-range elements with zeros: the SAME padding of a raw input
//     (halo 1); a pre-padded input (halo 0, the GroupNorm kernel's padded
//     output) is always in range.
//   * gather (other shapes with C % 8 == 0): the producer warpgroup's 128
//     threads own one tile row each and cp.async its eight 16-byte chunks a
//     slice, zero-filling taps off the border; each row's (b, y, x) is
//     decoded once per unit and the (tap, channel) position advances by
//     additions, with no division in the K loop.
// B is the packed weight (O, 9*C) from pack_weight, K-major, through a 2D
// map in (64, BN) boxes.
//
// Where a shape has too few output tiles to fill the SMs, the plan splits K
// (at 64-wide slices; with C % 64 == 0 a slice never straddles a tap). Each
// split writes fp32 partials from its registers, and a second pass sums
// them in split order: deterministic, as the end-to-end PSNR gates need.
//
// Why implicit GEMM and not Winograd: on the TPU, F(2x2) cut the matrix-unit
// work 2.25x, and its transforms ran on a vector unit that was otherwise
// idle. On the H100 the transforms would cost shared-memory passes and bf16
// rounding of the transformed operands, while the direct product is one
// dense GEMM over the full 9*C depth that the tensor cores take as it is.
//
// Bound on the H100: at the UNet's shapes (64^2 x 320 to 8^2 x 1280, batch
// 2B under CFG) the product does 2*M*9C*O operations on M*C + 9*C*O + M*O
// elements, 100-700 operations a byte: tensor-core bound. The 9x re-read of
// each input pixel stays in L2 and the TMA; the tensor cores read both
// operands from swizzled shared memory.
#include "gemm_sm90.cuh"

using namespace gmdx::sm90;

namespace {

// The launch's shapes and pointers, shared by every kernel instance.
struct ConvArgs {
  Units units;
  int M, O, W, HW, C, halo, c_slices;
  int Hin, Win, K;
  const __nv_bfloat16* x;
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  float* partial;  // (split, M, O) where split > 1
};

template <int BN, bool GATHER>
struct ConvOp : ConvArgs {
  static constexpr int kBN = BN;
  static constexpr int kOutW = BN;
  static constexpr bool kGather = GATHER;
  static constexpr bool kPingPong = false;  // K is long: the epilogue is a small share
  using R = Ring<BN, BN>;
  using S = Smem<BN, BN>;

  // TMA route: the stage's A box for (row tile mt, slice s) and its B box.
  __device__ __forceinline__ void load(const R& ring, int stage, uint64_t* bar,
                                       const CUtensorMap* ta, const CUtensorMap* tb, int mt,
                                       int nt, int s) const {
    const int m0 = mt * BM;
    const int b0 = m0 / HW;
    const int r = m0 - b0 * HW;
    const int y0 = r / W;
    const int x0 = r - y0 * W;
    const int tap = s / c_slices;
    const int c0 = (s - tap * c_slices) * BK;
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    tma_load_4d(ring.a(stage), ta, bar, c0, x0 + kx - halo, y0 + ky - halo, b0);
    tma_load_2d(ring.b(stage), tb, bar, s * BK, nt * BN);
  }

  // Gather route: all 128 producer threads; thread t owns tile row t.
  __device__ __forceinline__ void produce_gather(const R& ring, const CUtensorMap* tb) const {
    const int t = threadIdx.x - 256;
    Pipe<S::STAGES> pipe;
    int pending = -1;
    for (int u = blockIdx.x; u < units.count(); u += gridDim.x) {
      int mt, nt, s0, s1;
      units.decode(u, mt, nt, s0, s1);
      const int m = mt * BM + t;
      const bool row_ok = m < M;
      const int b = m / HW;
      const int p = m - b * HW;
      const int y = p / W;
      const int xx = p - y * W;
      int k = s0 * BK;
      int tap = k / C;
      int ci = k - tap * C;
      for (int s = s0; s < s1; ++s) {
        mbar_wait(&ring.empty[pipe.stage], pipe.phase ^ 1);
        const uint32_t row = smem_u32(ring.a(pipe.stage)) + t * 128;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ky = tap >= 6 ? 2 : (tap >= 3 ? 1 : 0);
          const int iy = y + ky - halo;
          const int ix = xx + (tap - 3 * ky) - halo;
          const bool ok = row_ok && k < K && iy >= 0 && iy < Hin && ix >= 0 && ix < Win;
          const __nv_bfloat16* src = ok ? x + (((size_t)b * Hin + iy) * Win + ix) * C + ci : x;
          cp_async16(row + ((j ^ (t & 7)) << 4), src, ok);  // the SWIZZLE_128B layout
          k += 8;
          ci += 8;
          if (ci == C) {
            ci = 0;
            ++tap;
          }
        }
        cp_async_commit();
        if (t == 0) {
          mbar_expect_tx(&ring.full[pipe.stage], S::B_BYTES);
          tma_load_2d(ring.b(pipe.stage), tb, &ring.full[pipe.stage], s * BK, nt * BN);
        }
        if (pending >= 0) {  // the previous slice's chunks have landed
          cp_async_wait<1>();
          fence_proxy_async();
          mbar_arrive(&ring.full[pending]);
        }
        pending = pipe.stage;
        pipe.advance();
      }
    }
    if (pending >= 0) {
      cp_async_wait<0>();
      fence_proxy_async();
      mbar_arrive(&ring.full[pending]);
    }
  }

  __device__ __forceinline__ void epilogue(float* acc, const R& ring, int wg, int m_base, int nt,
                                           int sp) const {
    const int n0 = nt * BN;
    if (units.split > 1) {  // fp32 partials straight from the registers
      float* dst = partial + (size_t)sp * M * O;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int m = m_base + frag_row(i);
        const int n = n0 + frag_col(i);
        if (m < M && n < O)
          *reinterpret_cast<float2*>(dst + (size_t)m * O + n) = make_float2(acc[i], acc[i + 1]);
      }
      return;
    }
    __nv_bfloat16* stg = ring.staging_of(wg);
    warpgroup_sync(wg);  // the previous unit's stores have read the staging tile
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int c = frag_col(i);
      const int n = n0 + c;
      const float2 bv = n < O ? load_bf16x2(bias + n) : make_float2(0.0f, 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(stg + frag_row(i) * S::LDS + c) =
          __floats2bfloat162_rn(acc[i] + bv.x, acc[i + 1] + bv.y);
    }
    warpgroup_sync(wg);
    store_staged<BN, S::LDS>(stg, out, O, m_base, n0, M, O);
  }
};

// Sums the split partials in split order, adds the bias, rounds to bf16.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const __nv_bfloat16* __restrict__ bias,
                                     __nv_bfloat16* __restrict__ out, int M, int O, int split) {
  const size_t chunks = (size_t)M * O / 8;
  const size_t plane = (size_t)M * O;
  for (size_t c = blockIdx.x * (size_t)blockDim.x + threadIdx.x; c < chunks;
       c += (size_t)gridDim.x * blockDim.x) {
    const size_t e = c * 8;
    const int n = (int)(e % O);
    float v[8];
    const float4* p = reinterpret_cast<const float4*>(partial + e);
    float4 lo = p[0], hi = p[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    for (int s = 1; s < split; ++s) {
      const float4* q = reinterpret_cast<const float4*>(partial + s * plane + e);
      lo = q[0];
      hi = q[1];
      v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
      v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
    }
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 b = load_bf16x2(bias + n + 2 * i);
      h[i] = __floats2bfloat162_rn(v[2 * i] + b.x, v[2 * i + 1] + b.y);
    }
    *reinterpret_cast<uint4*>(out + e) = u;
  }
}

template <int BN, bool GATHER>
int run(const CUtensorMap& ta, const CUtensorMap& tb, const ConvArgs& args, cudaStream_t st) {
  ConvOp<BN, GATHER> op;
  static_cast<ConvArgs&>(op) = args;
  int err = launch(ta, tb, op, st);
  if (err != 0 || args.units.split == 1) return err;
  const size_t chunks = (size_t)args.M * args.O / 8;
  const int blocks = (int)((chunks + 255) / 256 < 4096 ? (chunks + 255) / 256 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, st>>>(args.partial, args.bias, args.out, args.M,
                                               args.O, args.units.split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch plan's fields: route 0 = TMA (box bw x bh x bb), 1 = gather;
// bn 128 or 160; split K splits of slices_per_split 64-wide slices each.
// partial: (split, M, O) fp32 scratch where split > 1, else unused.
extern "C" int gmdx_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            void* partial, int B, int H, int W, int C, int O, int pre_padded,
                            int route, int bw, int bh, int bb, int bn, int split,
                            int slices_per_split, void* stream) {
  const int M = B * H * W;
  const int K = 9 * C;
  ConvArgs a;
  a.units.m_tiles = (M + BM - 1) / BM;
  a.units.n_tiles = (O + bn - 1) / bn;
  a.units.split = split;
  a.units.slices = (K + BK - 1) / BK;
  a.units.slices_per_split = slices_per_split;
  a.M = M;
  a.O = O;
  a.W = W;
  a.HW = H * W;
  a.C = C;
  a.halo = pre_padded ? 0 : 1;
  a.c_slices = C / BK;
  a.Hin = pre_padded ? H + 2 : H;
  a.Win = pre_padded ? W + 2 : W;
  a.K = K;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);

  CUtensorMap ta{}, tb{};
  if (!make_map_2d(&tb, w, O, K, bn)) return TMA_MAP_REFUSED;
  const bool gather = route != 0;
  if (!gather) {
    const uint64_t dims[4] = {(uint64_t)C, (uint64_t)a.Win, (uint64_t)a.Hin, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)C * 2, (uint64_t)a.Win * C * 2,
                                 (uint64_t)a.Hin * a.Win * C * 2};
    const uint32_t box[4] = {(uint32_t)BK, (uint32_t)bw, (uint32_t)bh, (uint32_t)bb};
    if (bw * bh * bb != BM || !make_map(&ta, x, 4, dims, strides, box)) return TMA_MAP_REFUSED;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 128) return gather ? run<128, true>(ta, tb, a, st) : run<128, false>(ta, tb, a, st);
  if (bn == 160) return gather ? run<160, true>(ta, tb, a, st) : run<160, false>(ta, tb, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
