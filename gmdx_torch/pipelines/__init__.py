"""Pipelines of the port (counterpart of ``gmdx.pipelines``)."""

from gmdx_torch.pipelines.controlnet import (
    StableDiffusionControlNetHDRPipeline,
    upconvert_sdr_to_hdrtv,
)
from gmdx_torch.pipelines.dual import StableDiffusionDualUNetPipeline
from gmdx_torch.pipelines.gm import StableDiffusionGMPipeline
from gmdx_torch.pipelines.pp import PipelinedDualUNet, pp_stage_groups

__all__ = [
    "PipelinedDualUNet",
    "StableDiffusionControlNetHDRPipeline",
    "StableDiffusionDualUNetPipeline",
    "StableDiffusionGMPipeline",
    "pp_stage_groups",
    "upconvert_sdr_to_hdrtv",
]
