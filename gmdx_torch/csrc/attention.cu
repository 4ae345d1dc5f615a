// Exact-softmax self-attention over head-packed (B, S, H*D) bf16 operands.
//
// Replaces gmdx/kernels/flash_attention.py:attention_kv_resident (TPU kernel
// _kvres_kernel). The TPU kernel kept the whole K/V range of a head resident
// in VMEM and took the row softmax in one pass. On the H100, 4096 keys x 40
// dims of K and V are 640 KB, past the 227 KB of shared memory a block can
// hold, so this kernel loops over 64-key tiles with an online softmax
// (running max and sum, rescaling the output accumulator): the same exact
// function, reached another way. The kernel body lives in attention_fwd.cuh,
// which the training forward (flash_attention.cu) instantiates with the
// logsumexp output; this file instantiates it without.
//
// Bound on the H100: 4 * Sq * Sk * D operations on (2 Sq + 2 Sk) * H * D * 2
// bytes; at Sk = 4096, D = 40 that is about 1300 operations a byte:
// tensor-core bound, with the softmax's exp2 and the narrow D (40 of 48
// columns useful) as the overheads.
//
// gmdx_flash_bsc replaces gmdx/kernels/flash_attention.py:flash_attention_bsc
// (TPU kernel _flash_bsc_kernel): the same exact-softmax forward over
// head-packed operands, for the self-attention past 4096 keys (the UNet's and
// the ControlNet's first level at 1024^2: 16384 tokens, 8 heads of 40). The
// TPU kernel's blocks of 512 queries x 2048 keys, its per-head scratch
// replicated H times and its unrolled head loop were ways to fill VMEM; here
// it is attention_sm90.cuh's Hopper forward (TMA ring, wgmma, 64 queries
// for each consumer warpgroup: three at D = 40, two above, their softmax
// overlapping the others' products through the warp schedulers alone),
// whose note gives the design and the bound: at B 2, S 16384, H 8, D 40 the exp2 floor (1.10 ms)
// is above the operations bound (0.695 ms) and far above the bytes' (0.025).
//
// gmdx_xattn replaces gmdx/kernels/flash_attention.py:cross_attention_shortk
// (TPU kernel _xattn_kernel): the short-K cross-attention of
// attention_xattn.cuh, whose note gives its design and bound.
#include "attention_fwd.cuh"
#include "attention_sm90.cuh"
#include "attention_xattn.cuh"

// q: (B, Sq, H*D), k and v: (B, Sk, H*D), out: (B, Sq, H*D), all contiguous
// bf16. Head dims are SD-1.5's 40, 80 and 160; any other returns
// cudaErrorInvalidValue.
extern "C" int gmdx_attention(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                              int Sk, int H, int D, float qscale, void* stream) {
  using gmdx_attn::launch_fwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch_fwd<40, false>(q, k, v, out, nullptr, B, Sq, Sk, H, qscale, st);
    case 80: return launch_fwd<80, false>(q, k, v, out, nullptr, B, Sq, Sk, H, qscale, st);
    case 160: return launch_fwd<160, false>(q, k, v, out, nullptr, B, Sq, Sk, H, qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Same operands and head dims as gmdx_attention; any Sk >= 1 (keys past Sk
// are masked, no logsumexp). Returns -1 where the driver refuses a TMA map.
extern "C" int gmdx_flash_bsc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                              int Sk, int H, int D, float qscale, void* stream) {
  using gmdx::attn90::flash_bsc_kernel;
  using gmdx::attn90::launch_fwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_fwd<40, false, flash_bsc_kernel<40>>(q, k, v, out, nullptr, B, Sq, Sk, H,
                                                         qscale, st);
    case 80:
      return launch_fwd<80, false, flash_bsc_kernel<80>>(q, k, v, out, nullptr, B, Sq, Sk, H,
                                                         qscale, st);
    case 160:
      return launch_fwd<160, false, flash_bsc_kernel<160>>(q, k, v, out, nullptr, B, Sq, Sk, H,
                                                           qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The forward with the base-2 logsumexp of the scaled logits, lse (B, H,
// Sq) fp32, as gmdx_flash_fwd (flash_attention.cu) returns it: the
// attention_sm90.cuh form of the training forward. Same operands, head dims
// and return codes as gmdx_flash_bsc.
extern "C" int gmdx_attention_sm90_lse(const void* q, const void* k, const void* v, void* out,
                                       void* lse, int B, int Sq, int Sk, int H, int D,
                                       float qscale, void* stream) {
  using gmdx::attn90::attention_sm90_lse_kernel;
  using gmdx::attn90::launch_fwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 40:
      return launch_fwd<40, true, attention_sm90_lse_kernel<40>>(q, k, v, out, l, B, Sq, Sk, H,
                                                                 qscale, st);
    case 80:
      return launch_fwd<80, true, attention_sm90_lse_kernel<80>>(q, k, v, out, l, B, Sq, Sk, H,
                                                                 qscale, st);
    case 160:
      return launch_fwd<160, true, attention_sm90_lse_kernel<160>>(q, k, v, out, l, B, Sq, Sk,
                                                                   H, qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch plans of attention_sm90.cuh's kernels at (B, Sq, Sk, H, D), for
// the wrappers' Python plans to be held to: kind 0 the forward, 1 the dK/dV
// kernel, 2 the dQ kernel; out[9] = rows a block owns, rows of a streamed
// tile, stages, dynamic shared-memory bytes, the grid's three dims, and the
// box rows of the Q (and dO) and the K (and V) maps.
template <class P>
int plan_fields(int* out, int B, int Sq, int Sk, int H) {
  const dim3 g = P::grid(B, Sq, Sk, H);
  const int fields[9] = {P::OWNED, P::TILE,       P::STAGES, P::BYTES,  static_cast<int>(g.x),
                         static_cast<int>(g.y), static_cast<int>(g.z), P::Q_ROWS, P::KV_ROWS};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return 0;
}

template <int D>
int plan_of(int kind, int* out, int B, int Sq, int Sk, int H) {
  using namespace gmdx::attn90;
  switch (kind) {
    case 0: return plan_fields<FwdPlan<D>>(out, B, Sq, Sk, H);
    case 1: return plan_fields<DkvPlan<D>>(out, B, Sq, Sk, H);
    case 2: return plan_fields<DqPlan<D>>(out, B, Sq, Sk, H);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gmdx_attention_sm90_plan(int kind, int B, int Sq, int Sk, int H, int D, int* out) {
  switch (D) {
    case 40: return plan_of<40>(kind, out, B, Sq, Sk, H);
    case 80: return plan_of<80>(kind, out, B, Sq, Sk, H);
    case 160: return plan_of<160>(kind, out, B, Sq, Sk, H);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Same operands and head dims as gmdx_attention, with 1 <= Sk <= 128 keys.
extern "C" int gmdx_xattn(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                          int Sk, int H, int D, float qscale, void* stream) {
  using gmdx_attn::launch_xattn;
  if (Sk < 1 || Sk > gmdx_attn::XATTN_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch_xattn<40>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    case 80: return launch_xattn<80>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    case 160: return launch_xattn<160>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
