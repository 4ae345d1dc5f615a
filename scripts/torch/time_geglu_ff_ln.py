"""Time gmdx_torch's LN-fused GEGLU feed-forward kernel, or its add +
LayerNorm kernel, on one H100.

    python scripts/torch/time_geglu_ff_ln.py [TAG]
    python scripts/torch/time_geglu_ff_ln.py [TAG] --add-ln

Run from the root of a checkout (or of a copy whose gmdx_torch/csrc holds a
variant of the kernel: each copy builds its own kernels; the script imports
``chip_smoke`` and ``gmdx_torch`` from the working directory, so it may be
run by path from another copy's root). For the three transformer widths of
the SD-1.5 UNet at CFG batch 16 it prints one JSON line: the relative L2
error against the fp32 plain version, three means of 20 launches (ms, CUDA
events) and each device kernel's mean time over 5 launches
(torch.profiler). With ``--add-ln`` it times ``add_layer_norm`` instead at
the four shapes of a GM-UNet call of the SDR->HDR path at CFG 16 (the
64^2, 32^2, 16^2 levels and the 8^2 mid block), beside ``x + y`` then
``F.layer_norm`` as the yardstick, with the bound (two bf16 reads and two
writes an element at 3.35 TB/s) and the plan where the copy has one. Every
line carries the card's name and power limit; TAG is copied into every
line, to tell copies apart when several are run in turns in one call.
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
from gmdx_torch.kernels import geglu_ff as ff  # noqa: E402

CFG_BATCH = 16
ADD_LN_SHAPES = ((4096, 320), (1024, 640), (256, 1280), (64, 1280))


def kernels_ms(fn, iters: int = 5) -> dict[str, float]:
    """Each device kernel's mean time a call of ``fn`` (torch.profiler)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / iters / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}


def time_ff(tag: str, smi: str, rnd) -> None:
    for s, dim in ((4096, 320), (1024, 640), (256, 1280)):
        inner = 4 * dim
        args = [rnd(CFG_BATCH, s, dim), rnd(CFG_BATCH, s, dim),
                (rnd(dim, scale=0.2).float() + 1).to(torch.bfloat16), rnd(dim, scale=0.2),
                rnd(2 * inner, dim, scale=dim ** -0.5), rnd(2 * inner, scale=0.1),
                rnd(dim, inner, scale=inner ** -0.5), rnd(dim, scale=0.1)]
        _, rel = cs.compare(ff.geglu_ff_ln(*args), ff.geglu_ff_ln_plain(*(a.float() for a in args)))
        ms = [cs.time_ms(lambda: ff.geglu_ff_ln(*args), iters=20) for _ in range(3)]
        print(json.dumps({"tag": tag, "dim": dim, "tokens": CFG_BATCH * s, "rel_l2": rel, "ms": ms,
                          "kernels_ms": kernels_ms(lambda: ff.geglu_ff_ln(*args)),
                          "device": smi}), flush=True)


def time_add_ln(tag: str, smi: str, rnd) -> None:
    plan_of = getattr(ff, "add_layer_norm_plan", None)
    for s, c in ADD_LN_SHAPES:
        x, y = rnd(CFG_BATCH, s, c), rnd(CFG_BATCH, s, c)
        gam = rnd(c, scale=0.2).float() + 1.0
        bet = rnd(c, scale=0.2).float()
        g16, b16 = gam.to(torch.bfloat16), bet.to(torch.bfloat16)
        fns = {"default": lambda: ff.add_layer_norm(x, y, gam, bet),
               "library": lambda: F.layer_norm(x + y, (c,), g16, b16, 1e-5)}
        row = {"tag": tag, "kind": "add_ln", "shape": [CFG_BATCH, s, c], "device": smi}
        if plan_of is not None:
            row["plan"] = plan_of(CFG_BATCH * s, c).__dict__
        row["rel_l2"] = max(cs.compare(a, r)[1] for a, r in
                            zip(fns["default"](), ff.add_layer_norm_plain(x, y, gam, bet)))
        for name, fn in fns.items():
            row[f"{name}_ms"] = [cs.time_ms(fn, iters=20) for _ in range(3)]
            row[f"{name}_kernels_ms"] = kernels_ms(fn)
        row["bound_ms"] = 4 * x.numel() * 2 / cs.HBM_BYTES_S * 1e3
        print(json.dumps(row), flush=True)


def main() -> None:
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = argv[0] if argv else ""
    if not torch.cuda.is_available():
        raise SystemExit("time_geglu_ff_ln: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    smi = cs.nvidia_smi_line()
    (time_add_ln if "--add-ln" in sys.argv else time_ff)(tag, smi, rnd)


if __name__ == "__main__":
    main()
