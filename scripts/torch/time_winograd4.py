"""Time gmdx_torch's Winograd F(4x4, 3x3) kernel on one H100, beside F.conv2d
and the implicit-GEMM conv3x3 kernel.

    python scripts/torch/time_winograd4.py [TAG] [--iters=N]

Run from the root of a checkout (or of a copy whose gmdx_torch/csrc holds a
variant of the kernel: each copy builds its own kernels). For the four F(4x4)
shapes of the single-UNet SDR->HDR path at batch 8 (the UNet's three levels
at CFG batch 16, the VAE decoder's 512^2 x 128 for 8 SDR + 8 GM frames),
pre-padded, it prints one JSON line a shape and kernel: for F(4x4) the
relative L2 error against the plain version, three means of N launches
(ms, CUDA events) and each of its three device kernels' mean time over 5
launches (torch.profiler); for F.conv2d and conv3x3 the three means. TAG is copied into
every line, to tell copies apart when several are run in turns in one call.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gmdx_torch.kernels import _build  # noqa: E402
from gmdx_torch.kernels import winograd as wk  # noqa: E402

SHAPES = ((16, 64, 320, 320), (16, 32, 640, 640), (16, 16, 1280, 1280), (16, 512, 128, 128))


def kernel_times(fn) -> dict:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:90]: ev.self_device_time_total / ev.count / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = args[0] if args else ""
    iters = next((int(a.split("=", 1)[1]) for a in sys.argv[1:] if a.startswith("--iters=")), 20)
    if not torch.cuda.is_available():
        raise SystemExit("time_winograd4: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    smi = cs.nvidia_smi_line()

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    for b, hw, c, o in SHAPES:
        x = F.pad(rnd(b, hw, hw, c), (0, 0, 1, 1, 1, 1))
        w = rnd(o, c, 3, 3, scale=(9 * c) ** -0.5)
        bias = rnd(o, scale=0.1)
        u, wp = wk.pack_weight4(w, torch.bfloat16), wk.pack_weight(w)
        x_nchw = x[:, 1:-1, 1:-1].permute(0, 3, 1, 2)
        ref = wk.winograd4_conv3x3_plain(x, u, bias, pre_padded=True)
        base = {"tag": tag, "shape": [b, hw, hw, c, o, "pre_padded"], "device": smi}
        for name, fn in (("F.conv2d", lambda: F.conv2d(x_nchw, w, bias, padding=1)),
                         ("conv3x3", lambda: wk.conv3x3(x, wp, bias, pre_padded=True))):
            print(json.dumps({**base, "kernel": name,
                              "ms": [cs.time_ms(fn, iters=iters) for _ in range(3)]}), flush=True)

        def wino():
            return wk.winograd4_conv3x3(x, u, bias, pre_padded=True)

        _, rel = cs.compare(wino(), ref)
        ms = [cs.time_ms(wino, iters=iters) for _ in range(3)]
        print(json.dumps({**base, "kernel": "winograd4_conv3x3", "rel_l2": rel, "ms": ms,
                          "kernels_ms": kernel_times(wino)}), flush=True)
        del x, x_nchw, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
