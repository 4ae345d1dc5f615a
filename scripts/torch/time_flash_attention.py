"""Time gmdx_torch's Hopper attention kernels on one H100.

    python scripts/torch/time_flash_attention.py [TAG]

Run from the root of a checkout (or of a copy whose gmdx_torch/csrc holds a
variant of the kernels: each copy builds its own). Prints one JSON line per
shape: ``flash_attention_bsc`` at the 1024^2 path's first level (16384
tokens, 8 heads of 40; the CFG batch 2 and the GM UNet's batch 1) and
``flash_attention_bwd`` at the Stage-2 step's three self-attention levels at
batch 8, each with its relative L2 error against the fp32 plain version,
three means of 20 launches (ms, CUDA events), the same for one SDPA call
(forward, or backward through autograd), and each device kernel's mean time
over 5 launches (torch.profiler). TAG is copied into every line, to tell
copies apart when several are run in turns in one call.
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
from gmdx_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bsc, flash_attention_bsc_plain, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_fwd_plain,
)


def kernels_ms(fn) -> dict:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / ev.count / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}


def main() -> None:
    tag = sys.argv[1] if len(sys.argv) > 1 else ""
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_attention: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    smi = cs.nvidia_smi_line()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def emit(kernel, shape, rel, fn, lib):
        print(json.dumps({
            "tag": tag, "kernel": kernel, "shape": shape, "rel_l2": rel,
            "ms": [cs.time_ms(fn, iters=20) for _ in range(3)],
            "sdpa_ms": [cs.time_ms(lib, iters=20) for _ in range(3)],
            "kernels_ms": kernels_ms(fn), "device": smi}), flush=True)

    s, heads, d = 16384, 8, 40
    for b in (2, 1):
        q, k, v = (rnd(b, s, heads * d) for _ in range(3))
        qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
        _, rel = cs.compare(flash_attention_bsc(q, k, v, heads),
                            flash_attention_bsc_plain(q.float(), k.float(), v.float(), heads))
        emit("flash_attention_bsc", [b, s, heads, d], rel,
             lambda: flash_attention_bsc(q, k, v, heads),
             lambda: F.scaled_dot_product_attention(qh, kh, vh))
        del q, k, v, qh, kh, vh

    for s, c in ((4096, 320), (1024, 640), (256, 1280)):
        d = c // heads
        q, k, v, dout = (rnd(8, s, c) for _ in range(4))
        out, lse = flash_attention_fwd(q, k, v, heads)
        f32 = [t.float() for t in (q, k, v)]
        ref_out, ref_lse = flash_attention_fwd_plain(*f32, heads, d**-0.5)
        got = flash_attention_bwd(q, k, v, out, lse, dout, heads)
        ref = flash_attention_bwd_plain(*f32, ref_out, ref_lse, dout.float(), heads, d**-0.5)
        rel = max(cs.compare(a, r)[1] for a, r in zip(got, ref))
        qh, kh, vh = (t.view(8, s, heads, d).transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out_l = F.scaled_dot_product_attention(qh, kh, vh)
        dout_h = dout.view(8, s, heads, d).transpose(1, 2)
        emit("flash_attention_bwd", [8, s, heads, d], rel,
             lambda: flash_attention_bwd(q, k, v, out, lse, dout, heads),
             lambda: torch.autograd.grad(out_l, (qh, kh, vh), dout_h, retain_graph=True))


if __name__ == "__main__":
    main()
