// Winograd F(4x4, 3x3) convolution + bias over NHWC bf16, with its 36
// transform-domain products on the Hopper GEMM core (gemm_sm90.cuh).
//
// Replaces gmdx/kernels/winograd.py:_wino4_forward (TPU kernel _wino4_kernel),
// the conv the JAX package runs under GMDX_WINOGRAD_M=4. The arithmetic is
// the TPU kernel's: Cook-Toom matrices over the points {0, 1, -1, 2, -1/2}
// (B^T, G, A^T below), the input transform factored rows first, then
// columns, in fp32, V and the transformed weight U rounded to bf16, the 36
// transform-domain products accumulated in fp32, the output transform and
// the bias in fp32.
//
// The TPU kernel did all of it in VMEM in one grid step per image. On this
// card that full fusion would hold 24 fp32 planes of the output transform
// in registers beside the accumulators, which caps a tile at 16 columns and
// re-reads V O/16 times. Here V and half-transformed products pass through
// device memory, in three launches counted as one call, each laid out by
// gmdx_torch/kernels/winograd.py:winograd4_plan:
//   1. wino4_input_kernel: a block stages a slab of (4 ty + 2) image rows x
//      (4 tx + 2) columns x 8 cgt channels in shared memory (cp.async, 16
//      bytes a chunk, zeros past the image: SAME padding of a raw input),
//      so each input pixel is read once a block; a thread then transforms
//      one tile's 8 channels and writes V[36][T][C] (T = B * H/4 * W/4
//      tiles) with 16-byte stores.
//   2. One persistent ws_gemm_kernel over 3-D TMA maps of V (C, T, 36) and
//      U (C, O, 36), boxes (64, 128, 1) and (64, 64, 1): a row tile never
//      crosses into the next product, and rows past T (or channels past C)
//      are zero-filled. A unit is (nu, row tile, 64-wide column tile); its
//      K loop runs over the six xi x C. After each xi the consumer adds
//      A^T[i][xi] * acc into four planes z[i] (4 x 32 + 32 registers a
//      thread) and restarts the accumulator: the xi half of the output
//      transform, folded into the GEMM. The epilogue writes z[i][nu] from
//      the registers: 24 fp32 planes of (T, O) instead of the 36 of M.
//   3. wino4_output_kernel: Y = sum_nu A^T[q][nu] z[i][nu] + bias for one
//      tile's 8 channels a thread, 16-byte loads and stores, written bf16
//      (B, H, W, O).
// U[36][O][C] is made once per weight by the caller (the Conv3x3 module's
// cache), off the per-step path.
//
// Bound on the H100: 2 * 36 * T * C * O operations, 2.25x fewer than the
// direct conv's; but V and z in device memory make it bytes: at 16 x 64^2 x
// 320, x 44.6 MB, V 94.4 MB written and read, z 125.8 MB written and read,
// out 41.9 MB (0.157 ms at 3.35 TB/s). The 64-wide tile (more accumulators
// do not fit beside z) feeds the tensor cores 24 KB of stage a 64-deep
// slice, and the products run at about a quarter of the bf16 peak. At the
// VAE's 16 x 512^2 x 128 the bytes alone (13.4 GB) exceed the direct conv's
// operations bound: F(4x4) cannot beat a good direct conv at C = 128.
#include "bf16x8.cuh"
#include "gemm_sm90.cuh"

using namespace gmdx::sm90;

namespace {

constexpr int IN_THREADS = 128;
constexpr int OUT_THREADS = 128;
constexpr int BN = 64;
constexpr int OUTW = 8;  // the core's staging tile, unused: results leave from the registers

// B^T (6x6), A^T (4x6) of gmdx/kernels/winograd.py:_BT4/_AT4; entries folded
// at compile time in the unrolled loops below.
__host__ __device__ __forceinline__ constexpr float bt4(int r, int c) {
  constexpr float t[6][6] = {
      {1.0f, 1.5f, -2.0f, -1.5f, 1.0f, 0.0f},  {0.0f, -1.0f, -2.5f, -0.5f, 1.0f, 0.0f},
      {0.0f, 1.0f, 0.5f, -2.5f, 1.0f, 0.0f},   {0.0f, -0.5f, -1.0f, 0.5f, 1.0f, 0.0f},
      {0.0f, 2.0f, -1.0f, -2.0f, 1.0f, 0.0f},  {0.0f, 1.0f, 1.5f, -2.0f, -1.5f, 1.0f}};
  return t[r][c];
}

// B^T in constant memory, for the input transform's runtime row index.
__constant__ float c_bt4[6][6] = {
    {1.0f, 1.5f, -2.0f, -1.5f, 1.0f, 0.0f},  {0.0f, -1.0f, -2.5f, -0.5f, 1.0f, 0.0f},
    {0.0f, 1.0f, 0.5f, -2.5f, 1.0f, 0.0f},   {0.0f, -0.5f, -1.0f, 0.5f, 1.0f, 0.0f},
    {0.0f, 2.0f, -1.0f, -2.0f, 1.0f, 0.0f},  {0.0f, 1.0f, 1.5f, -2.0f, -1.5f, 1.0f}};

__host__ __device__ __forceinline__ constexpr float at4(int r, int c) {
  constexpr float t[4][6] = {{1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 0.0f},
                             {0.0f, 1.0f, -1.0f, 2.0f, -0.5f, 0.0f},
                             {0.0f, 1.0f, 1.0f, 4.0f, 0.25f, 0.0f},
                             {0.0f, 1.0f, -1.0f, 8.0f, -0.125f, 1.0f}};
  return t[r][c];
}

// The launch plan; kernels/winograd.py:winograd4_plan computes the same.
struct Plan {
  int T, th, tw, t_tiles, c_slices;
  int cgt, tx, ty, in_smem, in_grid_x, in_grid_y;  // input transform
  int out_grid;                                      // output transform
  Units units;                                       // the products
};

inline Plan make_plan(int B, int H, int W, int C, int O) {
  Plan p;
  p.th = H / 4;
  p.tw = W / 4;
  p.T = B * p.th * p.tw;
  p.t_tiles = (p.T + BM - 1) / BM;
  p.c_slices = (C + BK - 1) / BK;
  const int g8 = C / 8;
  p.cgt = g8 % 8 == 0 ? 8 : (g8 % 4 == 0 ? 4 : (g8 % 2 == 0 ? 2 : 1));
  p.tx = p.tw >= 8 ? 8 : 4;
  p.ty = IN_THREADS / p.cgt / p.tx;
  p.in_smem = (4 * p.ty + 2) * (4 * p.tx + 2) * p.cgt * 16;
  p.in_grid_x = B * ((p.th + p.ty - 1) / p.ty) * ((p.tw + p.tx - 1) / p.tx);
  p.in_grid_y = C / (8 * p.cgt);
  p.out_grid = (int)(((size_t)p.T * (O / 8) + OUT_THREADS - 1) / OUT_THREADS);
  p.units = {6 * p.t_tiles, (O + BN - 1) / BN, 1, 6 * p.c_slices, 6 * p.c_slices};
  return p;
}

// V[p][t][c..c+7] = (B^T d B)[xi][nu], p = 6 xi + nu, for the 6x6 patch d
// of tile t: image rows 4 ty - 1 .. 4 ty + 4 (stored rows 4 ty .. 4 ty + 5
// of a pre-padded image), zero outside. Block: tiles [ty0, ty0 + ty) x
// [tx0, tx0 + tx) of image b, channels [c0, c0 + 8 cgt).
__global__ void __launch_bounds__(IN_THREADS)
wino4_input_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ v, int th,
                   int tw, int C, int halo, int Hin, int Win, int cgt, int tx_n, int ty_n,
                   size_t T) {
  extern __shared__ __align__(16) uint4 slab[];  // (4 ty + 2, 4 tx + 2, cgt) chunks
  const int SR = 4 * ty_n + 2, SC = 4 * tx_n + 2;
  const int bx_n = (tw + tx_n - 1) / tx_n, by_n = (th + ty_n - 1) / ty_n;
  int blk = blockIdx.x;
  const int tx0 = (blk % bx_n) * tx_n;
  blk /= bx_n;
  const int ty0 = (blk % by_n) * ty_n;
  const int b = blk / by_n;
  const int c0 = blockIdx.y * 8 * cgt;
  const int y0 = 4 * ty0 - halo, x0 = 4 * tx0 - halo;

  const uint32_t slab_u32 = smem_u32(slab);
  for (int i = threadIdx.x; i < SR * SC * cgt; i += IN_THREADS) {
    const int g = i % cgt;
    const int px = i / cgt;
    const int iy = y0 + px / SC, ix = x0 + px % SC;
    const bool ok = iy >= 0 && iy < Hin && ix >= 0 && ix < Win;
    const __nv_bfloat16* src = ok ? x + (((size_t)b * Hin + iy) * Win + ix) * C + c0 + 8 * g : x;
    cp_async16(slab_u32 + i * 16, src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = threadIdx.x % cgt;
  const int tl = threadIdx.x / cgt;
  const int ly = tl / tx_n, lx = tl % tx_n;
  if (ty0 + ly >= th || tx0 + lx >= tw) return;
  const size_t t = ((size_t)b * th + ty0 + ly) * tw + tx0 + lx;
  __nv_bfloat16* vt = v + t * C + c0 + 8 * g;
  const uint4* d = slab + ((4 * ly) * SC + 4 * lx) * cgt + g;  // d[i][j] at (i SC + j) cgt
  // A loop, not unrolled: each xi loads its own patch values, since the
  // 36 x 8 of them kept across xi would not fit the registers. Its row of
  // B^T comes from constant memory (zeros included: adding 0 * d changes no
  // sum).
#pragma unroll 1
  for (int xi = 0; xi < 6; ++xi) {
    float rowt[6][8];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int e = 0; e < 8; ++e) rowt[j][e] = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float c = c_bt4[xi][i];
        float dv[8];
        gmdx::unpack8(d[(i * SC + j) * cgt], dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) rowt[j][e] += c * dv[e];
      }
    }
#pragma unroll
    for (int nu = 0; nu < 6; ++nu) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (bt4(nu, j) != 0.0f) {
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += bt4(nu, j) * rowt[j][e];
        }
      }
      *reinterpret_cast<uint4*>(vt + (size_t)(6 * xi + nu) * T * C) = gmdx::pack8(acc);
    }
  }
}

// The products on the core: unit (nu, row tile, column tile), K segments
// xi, out = z (24, T, O) with z[6 i + nu] = sum_xi A^T[i][xi] M[6 xi + nu],
// M[p] = V[p] U[p]^T.
struct Wino4Op {
  static constexpr int kBN = BN;
  static constexpr int kOutW = OUTW;
  static constexpr bool kGather = false;
  static constexpr bool kPingPong = false;
  static constexpr int kSegments = 6;
  static constexpr int kFoldRegs = 4 * (BN / 2);
  using R = Ring<BN, OUTW>;

  Units units;
  int T, O, t_tiles, c_slices;
  float* z;

  __device__ __forceinline__ void load(const R& ring, int stage, uint64_t* bar,
                                       const CUtensorMap* ta, const CUtensorMap* tb, int mt,
                                       int nt, int s) const {
    const int nu = mt / t_tiles;
    const int row0 = (mt - nu * t_tiles) * BM;
    const int xi = s / c_slices;
    const int c0 = (s - xi * c_slices) * BK;
    tma_load_3d(ring.a(stage), ta, bar, c0, row0, 6 * xi + nu);
    tma_load_3d(ring.b(stage), tb, bar, c0, nt * BN, 6 * xi + nu);
  }

  // After segment XI: z[i] += A^T[i][XI] * acc, the coefficients constants.
  template <int XI>
  __device__ __forceinline__ void fold(float* zr, const float* acc) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (at4(i, XI) != 0.0f) {
#pragma unroll
        for (int k = 0; k < BN / 2; ++k) zr[i * (BN / 2) + k] += at4(i, XI) * acc[k];
      }
    }
  }

  // zr: z[0..3] of this thread's fragment, one after another.
  __device__ __forceinline__ void epilogue(float* zr, const R&, int, int m_base, int nt,
                                           int) const {
    const int mt = m_base / BM;
    const int nu = mt / t_tiles;
    const int row = (mt - nu * t_tiles) * BM + (m_base - mt * BM);
    const int n0 = nt * BN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dst = z + (size_t)(6 * i + nu) * T * O;
#pragma unroll
      for (int k = 0; k < BN / 2; k += 2) {
        const int m = row + frag_row(k);
        const int n = n0 + frag_col(k);
        if (m < T && n < O)
          *reinterpret_cast<float2*>(dst + (size_t)m * O + n) =
              make_float2(zr[i * (BN / 2) + k], zr[i * (BN / 2) + k + 1]);
      }
    }
  }
};

// Y[4 ty + i, 4 tx + q][o..o+7] = sum_nu A^T[q][nu] z[i][nu] + bias from the
// 24 planes z[6 i + nu], one output row i at a time (48 registers of z).
__global__ void __launch_bounds__(OUT_THREADS)
wino4_output_kernel(const float* __restrict__ z, const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int th, int tw, int O, size_t T) {
  const int og = O / 8;
  const size_t idx = (size_t)blockIdx.x * OUT_THREADS + threadIdx.x;
  if (idx >= T * og) return;
  const size_t t = idx / og;
  const int o = (int)(idx - t * og) * 8;
  float bv[8];
  gmdx::load8(bias + o, bv);
  const int b = (int)(t / ((size_t)th * tw));
  const int r = (int)(t - (size_t)b * th * tw);
  const int ty = r / tw, tx = r - (r / tw) * tw;
  const int H = 4 * th, W = 4 * tw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float zz[6][8];
#pragma unroll
    for (int nu = 0; nu < 6; ++nu) {
      const float4* src =
          reinterpret_cast<const float4*>(z + ((size_t)(6 * i + nu) * T + t) * O + o);
      const float4 lo = src[0], hi = src[1];
      zz[nu][0] = lo.x; zz[nu][1] = lo.y; zz[nu][2] = lo.z; zz[nu][3] = lo.w;
      zz[nu][4] = hi.x; zz[nu][5] = hi.y; zz[nu][6] = hi.z; zz[nu][7] = hi.w;
    }
    __nv_bfloat16* row = out + (((size_t)b * H + 4 * ty + i) * W + 4 * tx) * O + o;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = 0.0f;
#pragma unroll
      for (int nu = 0; nu < 6; ++nu) {
        if (at4(q, nu) != 0.0f) {
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] += at4(q, nu) * zz[nu][e];
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] += bv[e];
      *reinterpret_cast<uint4*>(row + (size_t)q * O) = gmdx::pack8(y);
    }
  }
}

}  // namespace

// The plan's fields as the kernels launch them, for the tests and
// chip_smoke.py to hold kernels/winograd.py:winograd4_plan to:
// out[12] = units, grid, stages, smem bytes, cgt, tx, ty, input smem bytes,
// input grid x, y, output grid, tile width.
extern "C" int gmdx_wino4_plan(int B, int H, int W, int C, int O, int* out) {
  const Plan p = make_plan(B, H, W, C, O);
  const int units = p.units.count();
  const int vals[12] = {units,   persistent_grid(units), Smem<BN, OUTW>::STAGES,
                        Smem<BN, OUTW>::BYTES,  p.cgt, p.tx, p.ty, p.in_smem,
                        p.in_grid_x, p.in_grid_y, p.out_grid, BN};
  for (int i = 0; i < 12; ++i) out[i] = vals[i];
  return 0;
}

// x: (B, H, W, C), or (B, H+2, W+2, C) with pre_padded; u: (36, O, C); bias:
// (O,); v: (36, T, C) bf16 and z: (24, T, O) fp32 scratch; out: (B, H, W,
// O). H, W multiples of 4 and >= 16; C, O multiples of 8, else
// cudaErrorInvalidValue.
extern "C" int gmdx_wino4(const void* x, const void* u, const void* bias, void* v, void* z,
                          void* out, int B, int H, int W, int C, int O, int pre_padded,
                          void* stream) {
  if (H % 4 || W % 4 || H < 16 || W < 16 || C % 8 || O % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(B, H, W, C, O);
  const int halo = pre_padded ? 0 : 1;
  const int Hin = pre_padded ? H + 2 : H;
  const int Win = pre_padded ? W + 2 : W;

  wino4_input_kernel<<<dim3(p.in_grid_x, p.in_grid_y), IN_THREADS, p.in_smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(v), p.th, p.tw, C, halo,
      Hin, Win, p.cgt, p.tx, p.ty, (size_t)p.T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap tv{}, tu{};
  const uint64_t vdims[3] = {(uint64_t)C, (uint64_t)p.T, 36};
  const uint64_t vstrides[2] = {(uint64_t)C * 2, (uint64_t)p.T * C * 2};
  const uint32_t vbox[3] = {(uint32_t)BK, (uint32_t)BM, 1};
  const uint64_t udims[3] = {(uint64_t)C, (uint64_t)O, 36};
  const uint64_t ustrides[2] = {(uint64_t)C * 2, (uint64_t)O * C * 2};
  const uint32_t ubox[3] = {(uint32_t)BK, (uint32_t)BN, 1};
  if (!make_map(&tv, v, 3, vdims, vstrides, vbox) || !make_map(&tu, u, 3, udims, ustrides, ubox))
    return TMA_MAP_REFUSED;
  Wino4Op op;
  op.units = p.units;
  op.T = p.T;
  op.O = O;
  op.t_tiles = p.t_tiles;
  op.c_slices = p.c_slices;
  op.z = static_cast<float*>(z);
  const int e = launch(tv, tu, op, st);
  if (e != 0) return e;

  wino4_output_kernel<<<p.out_grid, OUT_THREADS, 0, st>>>(
      static_cast<const float*>(z), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), p.th, p.tw, O, (size_t)p.T);
  return static_cast<int>(cudaGetLastError());
}
