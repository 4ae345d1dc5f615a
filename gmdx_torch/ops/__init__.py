"""HDR ops of the port (counterpart of ``gmdx.ops``)."""

from gmdx_torch.ops.reconstruct import apply_gm_to_sdr

__all__ = ["apply_gm_to_sdr"]
