"""I/O of the port (counterpart of ``gmdx.io``): .hdr export and weights."""

from gmdx_torch.io.convert import (
    clip_text_state_dict_from_flax,
    controlnet_state_dict_from_flax,
    controlnet_state_dict_from_unet,
    load_clip_text,
    load_controlnet,
    load_unet,
    load_vae,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from gmdx_torch.io.hdr import read_hdr, save_hdr_image, write_hdr

__all__ = [
    "clip_text_state_dict_from_flax",
    "controlnet_state_dict_from_flax",
    "controlnet_state_dict_from_unet",
    "load_clip_text",
    "load_controlnet",
    "load_unet",
    "load_vae",
    "unet_state_dict_from_flax",
    "vae_state_dict_from_flax",
    "read_hdr",
    "write_hdr",
    "save_hdr_image",
]
