"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper takes the plain version for a tensor on the CPU and launches
its CUDA kernel (``gmdx_torch/csrc``, built at first use by ``_build``) for a
tensor on the card; it raises for what the kernel does not take. There is no
switch that sends a CUDA tensor to the plain version: a caller who wants it
calls the ``*_plain`` function (the models' ``use_kernels=False``).

Under autograd (:func:`needs_grad`) the models take the differentiated
routes: ``torch.autograd.Function``s whose forward and backward are kernels
where the JAX package's custom VJPs call Pallas kernels (attention,
GroupNorm, the conv's training forward), and a recompute of the plain
version where they recompute jnp (the GEGLU FF and add + LayerNorm
backwards).

``LAUNCHES`` counts each wrapper's kernel launches, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import torch

# The H100 SXM's SMs, and what one SM holds: registers, shared memory (each
# block also reserves 1 KiB of it), warps, blocks. The kernels' Python plans
# count resident blocks with them.
NUM_SMS = 132
SM_REGISTERS, SM_SMEM, SM_WARPS, SM_BLOCKS = 65536, 233472, 64, 32

LAUNCHES = {
    "attention_kv_resident": 0,
    "conv3x3": 0,
    "group_norm_silu": 0,
    "group_norm_moments": 0,
    "group_norm_apply": 0,
    "geglu_ff_ln": 0,
    "flash_attention_fwd": 0,
    "flash_attention_fwd_d512": 0,
    "flash_attention_bsc": 0,
    "flash_attention_bwd": 0,
    "flash_attention_bwd_d512": 0,
    "group_norm_silu_bwd": 0,
    "group_norm_bwd_sums": 0,
    "group_norm_bwd_apply": 0,
    "cross_attention_shortk": 0,
    "add_layer_norm": 0,
    "geglu_ff": 0,
    "winograd4_conv3x3": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd will differentiate through a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


def check_fp32(name: str, *tensors: torch.Tensor) -> None:
    """Validate the fp32 side operands of a launch (contiguous, on the card)."""
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous fp32 CUDA tensor, got "
                             f"{t.dtype} on {t.device}")


def check_kernel_operands(name: str, *tensors: torch.Tensor | None) -> int:
    """Validate the operands of a kernel launch (bf16, contiguous, one CUDA
    device) and return the current stream's handle."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: operands must all lie on the card")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
    return torch.cuda.current_stream(dev).cuda_stream


__all__ = [
    "NUM_SMS", "SM_REGISTERS", "SM_SMEM", "SM_WARPS", "SM_BLOCKS",
    "LAUNCHES", "reset_launch_counts", "launch_counts", "needs_grad", "check_fp32",
    "check_kernel_operands",
]
