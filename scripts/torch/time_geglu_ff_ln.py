"""Time gmdx_torch's LN-fused GEGLU feed-forward kernel on one H100.

    python scripts/torch/time_geglu_ff_ln.py [TAG]

Run from the root of a checkout (or of a copy whose gmdx_torch/csrc holds a
variant of the kernel: each copy builds its own kernels). For the three
transformer widths of the SD-1.5 UNet at CFG batch 16 it prints one JSON line:
the relative L2 error against the fp32 plain version, three means of 20
launches (ms, CUDA events) and each device kernel's mean time over 5 launches
(torch.profiler). TAG is copied into every line, to tell copies apart when
several are run in turns in one call.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gmdx_torch.kernels import _build  # noqa: E402
from gmdx_torch.kernels.geglu_ff import geglu_ff_ln, geglu_ff_ln_plain  # noqa: E402


def main() -> None:
    tag = sys.argv[1] if len(sys.argv) > 1 else ""
    if not torch.cuda.is_available():
        raise SystemExit("time_geglu_ff_ln: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    for s, dim in ((4096, 320), (1024, 640), (256, 1280)):
        inner = 4 * dim
        args = [rnd(16, s, dim), rnd(16, s, dim), (rnd(dim, scale=0.2).float() + 1).to(torch.bfloat16),
                rnd(dim, scale=0.2), rnd(2 * inner, dim, scale=dim ** -0.5), rnd(2 * inner, scale=0.1),
                rnd(dim, inner, scale=inner ** -0.5), rnd(dim, scale=0.1)]
        _, rel = cs.compare(geglu_ff_ln(*args), geglu_ff_ln_plain(*(a.float() for a in args)))
        ms = [cs.time_ms(lambda: geglu_ff_ln(*args), iters=20) for _ in range(3)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                geglu_ff_ln(*args)
            torch.cuda.synchronize()
        kernels = {ev.key: ev.self_device_time_total / ev.count / 1e3 for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
        print(json.dumps({"tag": tag, "dim": dim, "tokens": 16 * s, "rel_l2": rel, "ms": ms,
                          "kernels_ms": kernels, "device": cs.nvidia_smi_line()}), flush=True)


if __name__ == "__main__":
    main()
