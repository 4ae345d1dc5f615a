"""I/O of the port (counterpart of ``gmdx.io``): .hdr export, PNG in and out,
safetensors param trees, pipeline directories and weight conversion. The
port reads safetensors and PNG itself (numpy and zlib)."""

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
from gmdx_torch.io.image import from_model_output, load_image, save_image, to_model_input
from gmdx_torch.io.params import load_params, save_params
from gmdx_torch.io.pipeline import load_component, load_pipeline, save_pipeline

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
    "load_image",
    "save_image",
    "to_model_input",
    "from_model_output",
    "load_params",
    "save_params",
    "load_component",
    "load_pipeline",
    "save_pipeline",
]
