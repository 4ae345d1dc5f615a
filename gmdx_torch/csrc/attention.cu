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
#include "attention_fwd.cuh"

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
