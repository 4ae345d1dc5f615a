// Fused residual add + LayerNorm over bf16 tokens (M, C):
// s = bf16(x + y), h = (s - mean) * rsqrt(var + eps) * gamma + beta, with the
// mean and variance of the rounded s taken in fp32 (the variance about the
// mean, as the TPU kernel takes it) and gamma, beta fp32.
//
// Replaces gmdx/kernels/geglu_ff.py:add_layer_norm (TPU kernel _add_ln_kernel,
// pallas_call in _add_ln_pallas): the transformer block's attn1 residual and
// norm2 under the fused_addln option. The TPU kernel took blocks of 256-1024
// tokens through VMEM with the grid's pipeline overlapping their copies.
//
// Bound on the H100: bytes, two bf16 reads and two bf16 writes an element
// (8 bytes against ~10 operations). A pure byte stream, so the kernel is a
// persistent ring of 1-D bulk copies (cp.async.bulk), two blocks an SM:
//   * A tile is R whole rows (R = 4 * max(1, 1280 / C): 16 at C = 320, 8 at
//     640, 4 at 1280; about 10 KB a tensor), one contiguous byte range of x
//     and one of y. Block b takes tiles b, b + blocks, ...
//   * Warp 4, the producer: one thread issues one bulk copy a tensor a tile
//     (cp.async.bulk.shared::cluster.global.mbarrier::complete_tx) into a
//     ring of STAGES stages with full/empty mbarriers, up to STAGES tiles
//     ahead of the consumers, from the block's first instructions on;
//     gamma and beta (a bulk copy each, on their own mbarrier) follow the
//     first tile's copies.
//   * Warps 0-3, the consumers: L lanes a row (8 at C = 320, 16 at 640, 32
//     at 1280 and in the generic instance), each lane K chunks of 8
//     channels (K = 5, exact, at the three widths: C is a template
//     parameter; the generic instance takes any C % 8 == 0 up to 2048 with
//     K = 8 behind a guard), interleaved so that a quarter-warp's 16-byte
//     shared-memory accesses are 128 contiguous bytes. A lane keeps its s in
//     registers: the sum and the centred sum of squares are shuffle trees
//     over the row's lanes. s and h go to one of two output stages; each
//     warp frees its input stage (empty mbarrier) once it has read it.
//   * Consumer thread 0 stores each output stage with two bulk copies
//     (cp.async.bulk.global.shared::cta, one bulk group a tile) after a
//     barrier of the consumers, and before that barrier waits until the
//     stores of two tiles back have read their stage.
// So the loads of tiles i + 1 ... i + STAGES, the sums of tile i and the
// stores of tile i - 1 are in flight together. The last tile may be short:
// its copies are its rows' bytes (C * 2, a multiple of 16). Pointers must be
// 16-byte aligned (the wrapper raises otherwise).
#include "bf16x8.cuh"
#include "gemm_sm90.cuh"

using namespace gmdx;

namespace {

constexpr int CONSUMER_WARPS = 4;
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;
constexpr int STAGES = 3;      // input ring: x and y tiles
constexpr int OUT_STAGES = 2;  // s and h tiles
constexpr int MAX_C = 2048;
constexpr int BLOCKS_PER_SM = 2;
constexpr int TILE_BYTES = 10240;  // a tensor's tile, at least a row a consumer warp

struct AddLnPlan {
  int rows, blocks, smem;
};

// Rows a tile: a multiple of the consumer warps, TILE_BYTES a tensor where
// that many rows make it (exactly at C = 320, 640, 1280).
__host__ __device__ __forceinline__ int tile_rows(int C) {
  const int k = TILE_BYTES / (CONSUMER_WARPS * C * 2);
  return CONSUMER_WARPS * (k > 1 ? k : 1);
}

int add_ln_smem(int C) {
  const int tile = tile_rows(C) * C * 2;
  return (2 * STAGES + 2 * OUT_STAGES) * tile + 2 * C * 4 + (2 * STAGES + 1) * 8;
}

// Tiles over persistent blocks: as many as fit BLOCKS_PER_SM an SM by
// shared memory (228 KB an SM, 1 KB of it reserved a block) on `sms` SMs.
AddLnPlan add_ln_plan(int M, int C, int sms) {
  AddLnPlan p;
  p.rows = tile_rows(C);
  p.smem = add_ln_smem(C);
  int per_sm = 233472 / (p.smem + 1024);
  per_sm = per_sm < BLOCKS_PER_SM ? per_sm : BLOCKS_PER_SM;
  const int tiles = (M + p.rows - 1) / p.rows;
  p.blocks = tiles < per_sm * sms ? tiles : per_sm * sms;
  return p;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(sm90::smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until every committed bulk store has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until every committed bulk store has completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
}

// Sum over the L lanes of a row (aligned groups of L lanes of the warp).
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CT = 320, 640, 1280: exact; CT = 0: any C % 8 == 0, C <= MAX_C.
template <int CT>
struct RowShape {
  static constexpr int L = CT == 320 ? 8 : CT == 640 ? 16 : 32;  // lanes a row
  static constexpr int K = CT == 0 ? MAX_C / 256 : CT / (8 * L);  // 8-channel chunks a lane
  static_assert(CT == 0 || CT == 8 * L * K, "C must be L lanes of K chunks");
};

// One row: x, y at xs, ys in shared memory; s, h into ss, hs.
template <int CT>
__device__ __forceinline__ void add_ln_row(const __nv_bfloat16* xs, const __nv_bfloat16* ys,
                                           __nv_bfloat16* ss, __nv_bfloat16* hs,
                                           const float* gamma, const float* beta, int C, int li,
                                           float eps) {
  using S = RowShape<CT>;
  const int chunks = C / 8;
  float v[S::K][8];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < S::K; ++k) {
    const int j = li + k * S::L;
    if (CT != 0 || j < chunks) {
      float xv[8], yv[8];
      load8(xs + 8 * j, xv);
      load8(ys + 8 * j, yv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[k][e] = bf16_round(xv[e] + yv[e]);
        sum += v[k][e];
      }
      *reinterpret_cast<uint4*>(ss + 8 * j) = pack8(v[k]);
    }
  }
  const float mean = row_sum<S::L>(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < S::K; ++k) {
    if (CT != 0 || li + k * S::L < chunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[k][e] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(row_sum<S::L>(sq) / C + eps);
#pragma unroll
  for (int k = 0; k < S::K; ++k) {
    const int j = li + k * S::L;
    if (CT != 0 || j < chunks) {
      const float4* gp = reinterpret_cast<const float4*>(gamma + 8 * j);
      const float4* bp = reinterpret_cast<const float4*>(beta + 8 * j);
      const float4 g0 = gp[0], g1 = gp[1], b0 = bp[0], b1 = bp[1];
      const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bt[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float hv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) hv[e] = fmaf((v[k][e] - mean) * rstd, g[e], bt[e]);
      *reinterpret_cast<uint4*>(hs + 8 * j) = pack8(hv);
    }
  }
}

template <int CT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
add_ln_ring_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   __nv_bfloat16* __restrict__ s_out, __nv_bfloat16* __restrict__ h_out, int M,
                   int C, float eps) {
  using S = RowShape<CT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = tile_rows(C);
  const size_t tile_elems = (size_t)R * C;
  auto* in = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][x, y][R * C]
  __nv_bfloat16* out = in + 2 * STAGES * tile_elems;  // [OUT_STAGES][s, h][R * C]
  float* gs = reinterpret_cast<float*>(out + 2 * OUT_STAGES * tile_elems);
  float* bs = gs + C;
  auto* full = reinterpret_cast<uint64_t*>(bs + C);
  uint64_t* empty = full + STAGES;
  uint64_t* params = empty + STAGES;  // gamma and beta landed
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = (M + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      sm90::mbar_init(&full[k], 1);
      sm90::mbar_init(&empty[k], CONSUMER_WARPS);
    }
    sm90::mbar_init(params, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      int i = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) sm90::mbar_wait(&empty[st], ((i / STAGES) - 1) & 1);
        const int rows = min(R, M - t * R);
        const uint32_t bytes = (uint32_t)rows * C * 2;
        sm90::mbar_expect_tx(&full[st], 2 * bytes);
        bulk_load(in + 2 * st * tile_elems, x + (size_t)t * tile_elems, bytes, &full[st]);
        bulk_load(in + (2 * st + 1) * tile_elems, y + (size_t)t * tile_elems, bytes, &full[st]);
        if (i == 0) {  // gamma and beta, small, land with the first tile
          sm90::mbar_expect_tx(params, 2 * C * 4);
          bulk_load(gs, gamma, C * 4, params);
          bulk_load(bs, beta, C * 4, params);
        }
      }
    }
    return;
  }

  constexpr int RP = 32 / S::L;  // rows a warp takes at once
  const int li = lane % S::L;
  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int st = i % STAGES;
    const int rows = min(R, M - t * R);
    const __nv_bfloat16* xs = in + 2 * st * tile_elems;
    const __nv_bfloat16* ys = xs + tile_elems;
    __nv_bfloat16* ss = out + 2 * (i % OUT_STAGES) * tile_elems;
    __nv_bfloat16* hs = ss + tile_elems;
    sm90::mbar_wait(&full[st], (i / STAGES) & 1);
    if (i == 0) sm90::mbar_wait(params, 0);
    // Every lane runs every pass (the shuffles take the whole warp); rows
    // past a short tile's end are computed from stale bytes and not stored.
    for (int r = warp * RP + lane / S::L; r < R; r += CONSUMER_WARPS * RP) {
      const size_t off = (size_t)r * C;
      add_ln_row<CT>(xs + off, ys + off, ss + off, hs + off, gs, bs, C, li, eps);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
    sm90::fence_proxy_async();
    if (threadIdx.x == 0) bulk_wait_read();  // tile i - 1's stores have read their stage
    consumers_sync();
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)rows * C * 2;
      bulk_store(s_out + (size_t)t * tile_elems, ss, bytes);
      bulk_store(h_out + (size_t)t * tile_elems, hs, bytes);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

}  // namespace

namespace {

int device_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The instance of C: exact at 320, 640, 1280, the generic one elsewhere.
template <int CT>
const void* instance() {
  static bool set = false;
  if (!set) {
    cudaFuncSetAttribute(add_ln_ring_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         sm90::SMEM_BUDGET);
    set = true;
  }
  return reinterpret_cast<const void*>(add_ln_ring_kernel<CT>);
}

const void* kernel_for(int C) {
  switch (C) {
    case 320: return instance<320>();
    case 640: return instance<640>();
    case 1280: return instance<1280>();
    default: return instance<0>();
  }
}

}  // namespace

// x, y, s_out, h_out: (M, C) contiguous bf16, 16-byte aligned; gamma, beta:
// (C,) fp32, 16-byte aligned. C % 8 == 0 and C <= 2048, else
// cudaErrorInvalidValue.
extern "C" int gmdx_add_ln(const void* x, const void* y, const void* gamma, const void* beta,
                           void* s_out, void* h_out, int M, int C, float eps, void* stream) {
  if (C <= 0 || C % 8 != 0 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const AddLnPlan p = add_ln_plan(M, C, device_sms());
  void* args[] = {&x, &y, &gamma, &beta, &s_out, &h_out, &M, &C, &eps};
  const cudaError_t err = cudaLaunchKernel(kernel_for(C), dim3(p.blocks), dim3(THREADS), args,
                                           p.smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan at (M, C), for kernels/geglu_ff.py:add_layer_norm_plan to be held
// to: out[7] = rows a tile, stages, blocks, threads a block, dynamic
// shared-memory bytes, the card's SMs, and the blocks an SM can hold
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; at least the plan's).
extern "C" int gmdx_add_ln_plan(int M, int C, int* out) {
  if (C <= 0 || C % 8 != 0 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = device_sms();
  const AddLnPlan p = add_ln_plan(M, C, sms);
  int resident = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel_for(C), THREADS, p.smem);
  const int fields[7] = {p.rows, STAGES, p.blocks, THREADS, p.smem, sms, resident};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return static_cast<int>(cudaGetLastError());
}
