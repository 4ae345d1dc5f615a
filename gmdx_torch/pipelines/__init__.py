"""Pipelines of the port (counterpart of ``gmdx.pipelines``)."""

from gmdx_torch.pipelines.controlnet import (
    StableDiffusionControlNetHDRPipeline,
    upconvert_sdr_to_hdrtv,
)
from gmdx_torch.pipelines.dual import StableDiffusionDualUNetPipeline
from gmdx_torch.pipelines.gm import StableDiffusionGMPipeline

__all__ = [
    "StableDiffusionControlNetHDRPipeline",
    "StableDiffusionDualUNetPipeline",
    "StableDiffusionGMPipeline",
    "upconvert_sdr_to_hdrtv",
]
