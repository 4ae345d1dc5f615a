"""Time gmdx_torch's GroupNorm forward on one H100 at every path shape.

    python scripts/torch/time_group_norm.py [TAG] [--paths=NAME,...]

Run from the root of a checkout (or of a copy, such as the parent commit
unpacked under ``build/``: each copy builds its own kernels; the script
imports ``chip_smoke`` and ``gmdx_torch`` from the working directory). At
every GroupNorm shape of the four paths, with the padded output and the
SiLU of a resnet's first norm, it prints one JSON line with three means of
20 launches (ms, CUDA events) of ``group_norm_silu`` (the copy's own plan,
or in a copy without plans the stats + apply pair) and of
``F.silu(F.group_norm(...))`` over the NCHW view as the yardstick; the
relative L2 error of ``group_norm_silu`` against the fp32 plain version;
the bound (x read once, y written once, at 3.35 TB/s); the plan where the
copy has one; and the card's name and power limit. To compare plans or
kernels, run it from the root of each copy in turns in one call.

Paths (batch of the GroupNorm calls): ``unet512`` the 512^2 UNet at the
serving and sdr2hdr CFG batch 16; ``train`` the same UNet at the Stage-2
batch 8; ``dec512`` the VAE decoder of SDR + GM latents at 16; ``enc512``
the sdr2hdr encode at 8; ``unet1024`` the 1024^2 UNet and ControlNet at the
CFG batch 2; ``dec1024`` the 1024^2 decode at 2. ``--paths`` keeps those
named. TAG is copied into every line, to tell copies apart when several
run in turns in one call.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gmdx_torch.kernels import _build  # noqa: E402
from gmdx_torch.kernels import groupnorm as gn  # noqa: E402

# (H, W, C) of each model's GroupNorm calls (distinct shapes), from the
# SD-1.5 configs (tests/test_torch_norm_plan.py collects them by a forward
# on the meta device).
UNET_64 = [(8, 8, 1280), (8, 8, 2560), (16, 16, 640), (16, 16, 1280), (16, 16, 1920),
           (16, 16, 2560), (32, 32, 320), (32, 32, 640), (32, 32, 960), (32, 32, 1280),
           (32, 32, 1920), (64, 64, 320), (64, 64, 640), (64, 64, 960)]
UNET_128 = [(2 * h, 2 * w, c) for h, w, c in UNET_64]
DEC_64 = [(64, 64, 512), (128, 128, 512), (256, 256, 256), (256, 256, 512), (512, 512, 128),
          (512, 512, 256)]
ENC_512 = [(64, 64, 512), (128, 128, 256), (128, 128, 512), (256, 256, 128), (256, 256, 256),
           (512, 512, 128)]
DEC_128 = [(2 * h, 2 * w, c) for h, w, c in DEC_64]
PATHS = {"unet512": (16, UNET_64), "train": (8, UNET_64), "dec512": (16, DEC_64),
         "enc512": (8, ENC_512), "unet1024": (2, UNET_128), "dec1024": (2, DEC_128)}


def main() -> None:
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = argv[0] if argv else ""
    only = [a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--paths=")]
    if not torch.cuda.is_available():
        raise SystemExit("time_group_norm: no CUDA device")
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    smi = cs.nvidia_smi_line()
    plan_of = getattr(gn, "group_norm_plan", None)
    for path, (b, shapes) in PATHS.items():
        if only and path not in only[0]:
            continue
        for h, w, c in shapes:
            x = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
            g = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
            be = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
            ref = gn.group_norm_silu_plain(x.float(), g.float(), be.float(), pad_output=True)
            fns = {"default": lambda: gn.group_norm_silu(x, g, be, pad_output=True)}
            row = {"tag": tag, "path": path, "shape": [b, h, w, c], "device": smi}
            if plan_of is not None:
                row["plan"] = plan_of(b, h, w, c).__dict__
            x_nchw = x.permute(0, 3, 1, 2)
            fns["library"] = lambda: F.silu(F.group_norm(x_nchw, 32, g, be, 1e-5))
            for name, fn in fns.items():
                if name != "library":
                    row[f"{name}_rel_l2"] = cs.compare(fn(), ref)[1]
                row[f"{name}_ms"] = [cs.time_ms(fn, iters=20) for _ in range(3)]
            nbytes = (x.numel() + b * (h + 2) * (w + 2) * c + 2 * c) * 2
            row["bound_ms"] = nbytes / cs.HBM_BYTES_S * 1e3
            print(json.dumps(row), flush=True)
            del x, ref, x_nchw


if __name__ == "__main__":
    main()
