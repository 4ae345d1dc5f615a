"""Time gmdx_torch's Hopper attention kernels on one H100.

    python scripts/torch/time_flash_attention.py [TAG] [--kernels=NAME,...]

Run from the root of a checkout (or of a copy whose gmdx_torch/csrc holds a
variant of the kernels: each copy builds its own; the script imports
``chip_smoke`` and ``gmdx_torch`` from the working directory). Prints one
JSON line per shape, each with its relative L2 error against the fp32 plain
version, three means of 20 launches (ms, CUDA events), the same for one SDPA
call (forward, or backward through autograd), each device kernel's mean time
over 5 launches (torch.profiler) and the card's name and power limit:
  * ``attention_kv_resident`` at the 512^2 UNet's three self-attention levels
    at the serving CFG batch 16 and at the 1024^2 levels it takes (4096 x 80,
    1024 x 160, 256 x 160) at batches 2 and 1;
  * ``flash_attention_fwd`` (with its logsumexp) at the Stage-2 step's three
    levels at batch 8;
  * ``flash_attention_bsc`` at the 1024^2 path's first level (16384 tokens, 8
    heads of 40) at batches 2 and 1;
  * ``flash_attention_bwd`` at the Stage-2 step's three levels at batch 8;
  * ``cross_attention_shortk`` (77 keys) at the 512^2 GM UNet's three
    levels at the sdr2hdr CFG batch 16, and its 64^2 and 32^2 levels at the
    smoke's CFG batch 4, each with its plan (``xattn_plan``, where the copy
    has it);
  * ``flash_attention_fwd_d512`` at the VAE's 512-wide head: the HDRTV
    decode's 2 x 16384 and Stage 1's 1 x 16384 and 4 x 9216, and
    ``flash_attention_bwd_d512`` at Stage 1's two (each kernel of the
    backward, dd pre-pass included, in ``kernels_ms``);
  * ``host_us``: the host time of one ``attention_kv_resident`` and one
    ``flash_attention_fwd`` call (launches queued without a synchronise, at
    a small shape the card finishes faster than the host issues it).
Each forward line names its plan (``attention_fwd_plan``, where the copy has
it). ``--kernels`` keeps only the rows of the kernels named (and
``host_us``).
TAG is copied into every line, to tell copies apart when several run in
turns in one call.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gmdx_torch.kernels import _build  # noqa: E402
from gmdx_torch.kernels import flash_attention as fa  # noqa: E402
from gmdx_torch.kernels.attention import (  # noqa: E402
    attention_kv_resident, attention_kv_resident_plain,
)

KVRES_SHAPES = [(16, 4096, 40), (16, 1024, 80), (16, 256, 160), (2, 4096, 80), (2, 1024, 160),
                (2, 256, 160), (1, 4096, 80), (1, 1024, 160), (1, 256, 160)]
TRAIN_SHAPES = [(8, 4096, 40), (8, 1024, 80), (8, 256, 160)]
XATTN_SHAPES = [(16, 4096, 40), (16, 1024, 80), (16, 256, 160), (4, 4096, 40), (4, 1024, 80)]


def kernels_ms(fn) -> dict:
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: ev.self_device_time_total / ev.count / 1e3 for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}


def host_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def main() -> None:
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = argv[0] if argv else ""
    only = [a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--kernels=")]
    keep = (lambda name: True) if not only else (lambda name: name in only[0] or name == "host_us")
    if not torch.cuda.is_available():
        raise SystemExit("time_flash_attention: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    smi = cs.nvidia_smi_line()
    plan_of = getattr(fa, "attention_fwd_plan", None)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def emit(kernel, shape, rel, fn, lib, **extra):
        print(json.dumps({
            "tag": tag, "kernel": kernel, "shape": shape, "rel_l2": rel,
            "ms": [cs.time_ms(fn, iters=20) for _ in range(3)],
            "sdpa_ms": [cs.time_ms(lib, iters=20) for _ in range(3)] if lib else None,
            "kernels_ms": kernels_ms(fn), "device": smi, **extra}), flush=True)

    def forward_rows(kernel, shapes, wrapper, plain):
        heads = 8
        for b, s, d in shapes if keep(kernel) else ():
            q, k, v = (rnd(b, s, heads * d) for _ in range(3))
            f32 = [t.float() for t in (q, k, v)]
            ref = plain(*f32, heads)
            qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731

            def errs(got):
                got, want = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
                return max(cs.compare(g, w)[1] for g, w in zip(got, want))

            extra = {}
            if plan_of is not None:
                extra["plan"] = plan_of(b, s, s, heads, d).__dict__
            emit(kernel, [b, s, heads, d], errs(wrapper(q, k, v, heads)),
                 lambda: wrapper(q, k, v, heads), lib, **extra)
            del q, k, v, f32, ref, qh, kh, vh

    forward_rows("attention_kv_resident", KVRES_SHAPES, attention_kv_resident,
                 attention_kv_resident_plain)
    forward_rows("flash_attention_fwd", TRAIN_SHAPES,
                 lambda q, k, v, h: fa.flash_attention_fwd(q, k, v, h),
                 lambda q, k, v, h: fa.flash_attention_fwd_plain(q, k, v, h, (q.shape[-1] // h) ** -0.5))
    forward_rows("flash_attention_bsc", [(2, 16384, 40), (1, 16384, 40)],
                 fa.flash_attention_bsc, fa.flash_attention_bsc_plain)

    heads = 8
    for s, c in ((4096, 320), (1024, 640), (256, 1280)) if keep("flash_attention_bwd") else ():
        d = c // heads
        q, k, v, dout = (rnd(8, s, c) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, heads)
        f32 = [t.float() for t in (q, k, v)]
        ref_out, ref_lse = fa.flash_attention_fwd_plain(*f32, heads, d**-0.5)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, heads)
        ref = fa.flash_attention_bwd_plain(*f32, ref_out, ref_lse, dout.float(), heads, d**-0.5)
        rel = max(cs.compare(a, r)[1] for a, r in zip(got, ref))
        qh, kh, vh = (t.view(8, s, heads, d).transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out_l = F.scaled_dot_product_attention(qh, kh, vh)
        dout_h = dout.view(8, s, heads, d).transpose(1, 2)
        emit("flash_attention_bwd", [8, s, heads, d], rel,
             lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, heads),
             lambda: torch.autograd.grad(out_l, (qh, kh, vh), dout_h, retain_graph=True))

    d = 512
    for b, s in ((2, 16384), (1, 16384), (4, 9216)) if keep("flash_attention_fwd_d512") else ():
        q, k, v = (rnd(b, s, d) for _ in range(3))
        ref = fa.flash_attention_fwd_plain(*(t.float() for t in (q, k, v)), 1, d**-0.5)
        rel = max(cs.compare(g, r)[1] for g, r in zip(fa.flash_attention_fwd(q, k, v, 1), ref))
        qh, kh, vh = (t.view(b, s, 1, d).transpose(1, 2) for t in (q, k, v))
        emit("flash_attention_fwd_d512", [b, s, 1, d], rel,
             lambda: fa.flash_attention_fwd(q, k, v, 1), cs._sdpa_backend(qh, kh, vh)[1])
        del q, k, v, ref, qh, kh, vh
    for b, s in ((1, 16384), (4, 9216)) if keep("flash_attention_bwd_d512") else ():
        q, k, v, dout = (rnd(b, s, d) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, 1)
        ref = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out)), lse,
                                           dout.float(), 1, d**-0.5)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, 1)
        rel = max(cs.compare(g, r)[1] for g, r in zip(got, ref))
        del ref, got
        qh, kh, vh, dh = (t.view(b, s, 1, d).transpose(1, 2) for t in (q, k, v, dout))
        emit("flash_attention_bwd_d512", [b, s, 1, d], rel,
             lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, 1),
             cs._sdpa_bwd_backend(qh, kh, vh, dh)[1])
        del q, k, v, dout, out, lse, qh, kh, vh, dh
        torch.cuda.empty_cache()

    xplan_of = getattr(fa, "xattn_plan", None)
    for b, s, d in XATTN_SHAPES if keep("cross_attention_shortk") else ():
        q = rnd(b, s, heads * d)
        k, v = rnd(b, 77, heads * d), rnd(b, 77, heads * d)
        ref = fa.cross_attention_shortk_plain(q, k, v, heads)
        qh = q.view(b, s, heads, d).transpose(1, 2)
        kh, vh = (t.view(b, 77, heads, d).transpose(1, 2) for t in (k, v))
        extra = {"plan": xplan_of(b, s, 77, heads, d).__dict__} if xplan_of else {}
        emit("cross_attention_shortk", [b, s, 77, heads, d],
             cs.compare(fa.cross_attention_shortk(q, k, v, heads), ref)[1],
             lambda: fa.cross_attention_shortk(q, k, v, heads),
             lambda: F.scaled_dot_product_attention(qh, kh, vh), **extra)
        del q, k, v, ref, qh, kh, vh

    q, k, v = (rnd(1, 256, 320) for _ in range(3))
    print(json.dumps({
        "tag": tag, "kernel": "host_us", "shape": [1, 256, 8, 40],
        "attention_kv_resident_us": host_us(lambda: attention_kv_resident(q, k, v, 8)),
        "flash_attention_fwd_us": host_us(lambda: fa.flash_attention_fwd(q, k, v, 8)),
        "device": smi}), flush=True)


if __name__ == "__main__":
    main()
