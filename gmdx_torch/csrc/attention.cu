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
// (TPU kernel _flash_bsc_kernel): the same online-softmax forward over
// head-packed operands, for the self-attention past 4096 keys (the UNet's and
// the ControlNet's first level at 1024^2: 16384 tokens, 8 heads of 40). The
// TPU kernel's blocks of 512 queries x 2048 keys, its per-head scratch
// replicated H times and its unrolled head loop were ways to fill VMEM; here
// a block takes 64 queries of one head and streams the keys in 64-key tiles
// (256 tiles at Sk = 16384), so nothing grows with the sequence. It is the
// body of attention_fwd.cuh under its own kernel name (flash_bsc_kernel), so
// it is counted and timed apart from the KV-resident calls. At B 2, S 16384,
// H 8, D 40 it is operations-bound: 687 GFLOP, 0.695 ms at the bf16 peak,
// against 0.025 ms for its bytes.
//
// gmdx_xattn replaces gmdx/kernels/flash_attention.py:cross_attention_shortk
// (TPU kernel _xattn_kernel): the short-K cross-attention of
// attention_xattn.cuh, whose note gives its design and bound.
#include "attention_fwd.cuh"
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

// Same operands and head dims as gmdx_attention; any Sk (keys past Sk are
// masked, no logsumexp).
extern "C" int gmdx_flash_bsc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                              int Sk, int H, int D, float qscale, void* stream) {
  using gmdx_attn::launch_bsc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch_bsc<40>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    case 80: return launch_bsc<80>(q, k, v, out, B, Sq, Sk, H, qscale, st);
    case 160: return launch_bsc<160>(q, k, v, out, B, Sq, Sk, H, qscale, st);
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
