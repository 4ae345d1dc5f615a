// mma.sync helpers shared by the two attention kernels that stay on
// pre-Hopper instructions: the short-K cross-attention (attention_xattn.cuh)
// and the 512-wide flash forward (attention_wide.cuh). Every other attention
// runs on attention_sm90.cuh.
//
// The helpers: 16-byte cp.async with zero fill, mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), bf16 packing, and the loads of 64-row tiles of one head
// of a head-packed (B, S, H*D) operand into [rows][LD] shared-memory tiles
// DP = round_up(D, 16) wide whose pad columns are zero-filled once (device
// memory is never padded). A block of these kernels takes BQ = 64 queries
// on 4 warps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gmdx_attn {

constexpr int BQ = 64;
constexpr int ATT_THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// Rows [row0, row0 + NR) of one head into a [NR][LD] tile; rows past `rows`
// are zero-filled.
template <int D, int LD, int NR = 64>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                          int row0, int rows, int ld) {
  constexpr int CH = D / 8;
  for (int c = threadIdx.x; c < NR * CH; c += ATT_THREADS) {
    const int r = c / CH;
    const int d = (c % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(tile + r * LD + d, ok ? base + (size_t)(row0 + r) * ld + d : base, ok);
  }
}

// Zero the pad columns [D, DP) of `ntiles` consecutive [NR][LD] tiles.
template <int D, int DP, int LD, int NR = 64>
__device__ __forceinline__ void zero_pad_cols(__nv_bfloat16* tiles, int ntiles) {
  if constexpr (DP > D) {
    constexpr int PC = DP - D;
    const __nv_bfloat16 z = __float2bfloat16(0.0f);
    for (int i = threadIdx.x; i < ntiles * NR * PC; i += ATT_THREADS) {
      const int t = i / (NR * PC);
      const int rem = i % (NR * PC);
      tiles[t * NR * LD + (rem / PC) * LD + D + rem % PC] = z;
    }
  }
}

}  // namespace gmdx_attn
