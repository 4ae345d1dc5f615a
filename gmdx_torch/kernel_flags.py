"""The JAX package's kernel toggles as flags of the port's command-line tools.

gmdx reads ``GMDX_XATTN_KERNEL``, ``GMDX_FUSED_ADDLN``, ``GMDX_WINOGRAD_M``
and ``GMDX_WINOGRAD_TRAIN`` from the environment at trace time, so a toggle
holds for every module of a run. The port reads no environment switch: its
CLIs take the same choices as flags (:func:`add_kernel_flags`) and set them
with :func:`gmdx_torch.models.layers.set_kernel_options` on every module
they build (:func:`apply_kernel_flags`). The defaults are gmdx's.
"""

from __future__ import annotations

import argparse


def add_kernel_flags(parser: argparse.ArgumentParser, *, train: bool) -> None:
    """``--xattn_kernel``, ``--fused_addln`` and ``--winograd_m``; with
    ``train``, ``--winograd_train`` too."""
    g = parser.add_argument_group("kernel options (the JAX package's GMDX_* toggles)")
    g.add_argument("--xattn_kernel", action="store_true",
                   help="the short-K kernel for the 77-key cross-attention of the two widest "
                        "UNet levels, under autograd the flash kernels at 77 keys "
                        "(GMDX_XATTN_KERNEL=1)")
    g.add_argument("--fused_addln", action="store_true",
                   help="the transformer block's attn1 residual and norm2 in one add + "
                        "LayerNorm kernel (GMDX_FUSED_ADDLN=1)")
    g.add_argument("--winograd_m", type=int, choices=(2, 4), default=2,
                   help="4: Winograd F(4x4) for the 3x3 convs it tiles; 2: the implicit-GEMM "
                        "conv kernel everywhere (GMDX_WINOGRAD_M, default 2)")
    if train:
        g.add_argument("--winograd_train", action="store_true",
                       help="the conv kernel of --winograd_m as the training forward, the "
                            "direct conv's gradients backward (GMDX_WINOGRAD_TRAIN=1)")


def kernel_options(args: argparse.Namespace) -> dict:
    """The options the parsed flags give, as ``set_kernel_options`` takes them."""
    return {"xattn_kernel": args.xattn_kernel, "fused_addln": args.fused_addln,
            "winograd_m": args.winograd_m,
            "winograd_train": getattr(args, "winograd_train", False)}


def apply_kernel_flags(args: argparse.Namespace, *modules) -> None:
    """Set the flags' options on every module under each of ``modules``
    (None entries skipped), as gmdx's environment holds for all of them."""
    from gmdx_torch.models.layers import set_kernel_options

    for m in modules:
        if m is not None:
            set_kernel_options(m, **kernel_options(args))


__all__ = ["add_kernel_flags", "kernel_options", "apply_kernel_flags"]
