// Exact-softmax attention over head-packed (B, S, H*D) bf16 operands: the
// inference entry points and the Hopper forward's plan report.
//
// gmdx_attention replaces gmdx/kernels/flash_attention.py:attention_kv_resident
// (TPU kernel _kvres_kernel): self-attention with 256-4096 keys, every
// SD-1.5 UNet self-attention at 512^2 and the lower levels at 1024^2. The TPU
// kernel kept the whole K/V range of a head resident in VMEM and took the row
// softmax in one pass; on the H100 that fits at none of these shapes (the
// note of attention_sm90.cuh says why), so kvres_sm90_kernel streams the keys
// through attention_sm90.cuh's TMA ring with an online softmax: the same exact
// function, reached another way.
//
// gmdx_flash_bsc replaces gmdx/kernels/flash_attention.py:flash_attention_bsc
// (TPU kernel _flash_bsc_kernel): the same forward for the self-attention past
// 4096 keys (the UNet's and the ControlNet's first level at 1024^2: 16384
// tokens, 8 heads of 40), as flash_bsc_kernel. The TPU kernel's blocks of 512
// queries x 2048 keys, its per-head scratch replicated H times and its
// unrolled head loop were ways to fill VMEM.
//
// Both run attention_sm90.cuh's persistent forward (TMA ring, wgmma, 64
// queries for each consumer warpgroup, their softmax overlapping the others'
// products through the warp schedulers alone), whose note gives the design
// and the bound; its plan (FwdPlan) is mirrored by
// kernels/flash_attention.py:attention_fwd_plan.
//
// gmdx_xattn replaces gmdx/kernels/flash_attention.py:cross_attention_shortk
// (TPU kernel _xattn_kernel): the short-K cross-attention of
// attention_xattn.cuh (xattn_sm90_kernel, on the same core's pieces), whose
// note gives its design and bound; gmdx_xattn_plan reports its plan.
#include "attention_sm90.cuh"
#include "attention_xattn.cuh"

namespace a9 = gmdx::attn90;

// q: (B, Sq, H*D), k and v: (B, Sk, H*D), out: (B, Sq, H*D), all contiguous
// bf16, any Sk >= 1 (keys past Sk are masked); c = scale * log2(e). Head
// dims 40, 80 and 160; any other returns cudaErrorInvalidValue, a refused
// TMA map -1.
extern "C" int gmdx_attention(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                              int Sk, int H, int D, float c, void* stream) {
  using a9::kvres_sm90_kernel;
  using a9::launch_fwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_fwd<40, false, kvres_sm90_kernel<40>>(q, k, v, out, nullptr, B, Sq, Sk, H, c,
                                                          st);
    case 80:
      return launch_fwd<80, false, kvres_sm90_kernel<80>>(q, k, v, out, nullptr, B, Sq, Sk, H, c,
                                                          st);
    case 160:
      return launch_fwd<160, false, kvres_sm90_kernel<160>>(q, k, v, out, nullptr, B, Sq, Sk, H,
                                                            c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Same operands, head dims and return codes as gmdx_attention.
extern "C" int gmdx_flash_bsc(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                              int Sk, int H, int D, float c, void* stream) {
  using a9::flash_bsc_kernel;
  using a9::launch_fwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return launch_fwd<40, false, flash_bsc_kernel<40>>(q, k, v, out, nullptr, B, Sq, Sk, H, c,
                                                         st);
    case 80:
      return launch_fwd<80, false, flash_bsc_kernel<80>>(q, k, v, out, nullptr, B, Sq, Sk, H, c,
                                                         st);
    case 160:
      return launch_fwd<160, false, flash_bsc_kernel<160>>(q, k, v, out, nullptr, B, Sq, Sk, H,
                                                           c, st);
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
  switch (kind) {
    case 0: return plan_fields<a9::FwdPlan<D>>(out, B, Sq, Sk, H);
    case 1: return plan_fields<a9::DkvPlan<D>>(out, B, Sq, Sk, H);
    case 2: return plan_fields<a9::DqPlan<D>>(out, B, Sq, Sk, H);
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

// Same operands and head dims as gmdx_attention, with 1 <= Sk <= 128 keys;
// c = scale * log2(e).
extern "C" int gmdx_xattn(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                          int Sk, int H, int D, float c, void* stream) {
  using a9::launch_xattn_keys;
  if (Sk < 1 || Sk > a9::XATTN_MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return launch_xattn_keys<40>(q, k, v, out, B, Sq, Sk, H, c, st);
    case 80: return launch_xattn_keys<80>(q, k, v, out, B, Sq, Sk, H, c, st);
    case 160: return launch_xattn_keys<160>(q, k, v, out, B, Sq, Sk, H, c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The short-K kernel's plan at (B, Sq, Sk, H, D), for
// kernels/flash_attention.py:xattn_plan to be held to; out[8] as
// xattn_plan_fields (attention_xattn.cuh) lays it out.
extern "C" int gmdx_xattn_plan(int B, int Sq, int Sk, int H, int D, int* out) {
  if (Sk < 1 || Sk > a9::XATTN_MAX_KEYS) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 40: a9::xattn_plan_keys<40>(out, B, Sq, Sk, H); return 0;
    case 80: a9::xattn_plan_keys<80>(out, B, Sq, Sk, H); return 0;
    case 160: a9::xattn_plan_keys<160>(out, B, Sq, Sk, H); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
