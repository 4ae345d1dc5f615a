"""Pipelines of the port (counterpart of ``gmdx.pipelines``)."""

from gmdx_torch.pipelines.dual import StableDiffusionDualUNetPipeline
from gmdx_torch.pipelines.gm import StableDiffusionGMPipeline

__all__ = ["StableDiffusionDualUNetPipeline", "StableDiffusionGMPipeline"]
