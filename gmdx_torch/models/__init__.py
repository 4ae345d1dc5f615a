"""UNet, ControlNet, VAE, CLIP text, tokenizer, and Stage-1's LoRA, VGG19
and discriminator modules of the port (counterpart of ``gmdx.models``)."""

from gmdx_torch.models.clip_text import (
    CLIP_VIT_L_CONFIG,
    TINY_CLIP_CONFIG,
    CLIPTextConfig,
    CLIPTextModel,
)
from gmdx_torch.models.controlnet import (
    SD15_CONTROLNET_CONFIG,
    TINY_CONTROLNET_CONFIG,
    ConditioningEmbedding,
    ControlNetConfig,
    ControlNetModel,
)
from gmdx_torch.models.discriminator import Discriminator
from gmdx_torch.models.layers import set_kernel_options, set_use_kernels
from gmdx_torch.models.lora import LoRAConfig, init_lora_params, lora_targets, merge_lora
from gmdx_torch.models.tokenizer import CLIPTokenizer
from gmdx_torch.models.unet2d import (
    SD15_GM_UNET_CONFIG,
    SD15_UNET_CONFIG,
    TINY_UNET_CONFIG,
    UNet2DConditionModel,
    UNetConfig,
    inflate_conv_in,
)
from gmdx_torch.models.vae import (
    SD15_VAE_CONFIG,
    TINY_VAE_CONFIG,
    AutoencoderKL,
    VAEConfig,
)
from gmdx_torch.models.vgg import VGG19Features

__all__ = [
    "Discriminator",
    "LoRAConfig",
    "init_lora_params",
    "lora_targets",
    "merge_lora",
    "VGG19Features",
    "set_use_kernels",
    "set_kernel_options",
    "CLIPTextModel",
    "CLIPTextConfig",
    "CLIP_VIT_L_CONFIG",
    "TINY_CLIP_CONFIG",
    "CLIPTokenizer",
    "ControlNetModel",
    "ControlNetConfig",
    "ConditioningEmbedding",
    "SD15_CONTROLNET_CONFIG",
    "TINY_CONTROLNET_CONFIG",
    "inflate_conv_in",
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
