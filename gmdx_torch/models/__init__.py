"""UNet and VAE modules of the port (counterpart of ``gmdx.models``)."""

from gmdx_torch.models.layers import set_use_kernels
from gmdx_torch.models.unet2d import (
    SD15_GM_UNET_CONFIG,
    SD15_UNET_CONFIG,
    TINY_UNET_CONFIG,
    UNet2DConditionModel,
    UNetConfig,
)
from gmdx_torch.models.vae import (
    SD15_VAE_CONFIG,
    TINY_VAE_CONFIG,
    AutoencoderKL,
    VAEConfig,
)

__all__ = [
    "set_use_kernels",
    "UNet2DConditionModel",
    "UNetConfig",
    "SD15_UNET_CONFIG",
    "SD15_GM_UNET_CONFIG",
    "TINY_UNET_CONFIG",
    "AutoencoderKL",
    "VAEConfig",
    "SD15_VAE_CONFIG",
    "TINY_VAE_CONFIG",
]
