"""HDR ops of the port (counterpart of ``gmdx.ops``): Eq. (1), the
tone-mapping operators, the BT.2020 -> BT.709 gamut compression and the
camera-exposure augmentation of Stage-1 training."""

from gmdx_torch.ops.exposure import (
    EXPOSURE_LEVELS,
    RandomExposureAdjust,
    apply_inv_sigmoid_curve,
    discretize_to_uint16,
    hdr_to_ldr,
    random_exposure_adjust,
    sample_camera_curve,
)
from gmdx_torch.ops.gamut import BT2020_TO_BT709, gamut_compress
from gmdx_torch.ops.reconstruct import apply_gm_to_sdr
from gmdx_torch.ops.tmo import (
    choose_tmo,
    fix_mulog_tmo,
    hard_clip_tmo,
    linear_scale_tmo,
    mulog_tmo,
    random_tmo,
    tmo_2446a,
)

__all__ = [
    "apply_gm_to_sdr",
    "BT2020_TO_BT709",
    "gamut_compress",
    "choose_tmo",
    "fix_mulog_tmo",
    "hard_clip_tmo",
    "linear_scale_tmo",
    "mulog_tmo",
    "random_tmo",
    "tmo_2446a",
    "EXPOSURE_LEVELS",
    "RandomExposureAdjust",
    "apply_inv_sigmoid_curve",
    "discretize_to_uint16",
    "hdr_to_ldr",
    "random_exposure_adjust",
    "sample_camera_curve",
]
