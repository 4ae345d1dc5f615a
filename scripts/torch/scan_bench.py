"""Device time against dispatch time of the port's hot paths: the
counterpart of ``scripts/tools/scan_bench.py``.

The JAX tool times N chained iterations inside one compiled ``lax.scan``.
Here the same N chained iterations are captured into one CUDA graph on
static buffers and replayed: the replay's seconds an iteration are what the
card needs with no host in the way, and the eager chained loop on the same
buffers gives what the port's op-by-op dispatch gets. Each workload chains
its output back into the carry, as the JAX tool's do, so no iteration can
be skipped or run beside another.

    python scripts/torch/scan_bench.py --workload unet_fwd --iters 20
    python scripts/torch/scan_bench.py --workload unet_fwd --channels-last
    python scripts/torch/scan_bench.py --workload unet_fwd --xattn_kernel --fused_addln --winograd_m 4
    python scripts/torch/scan_bench.py --workload vae_decode --batch 16
    python scripts/torch/scan_bench.py --workload attention --seq 16384 --heads 8 --head-dim 40
    python scripts/torch/scan_bench.py --workload unet_fwd --size tiny --res 64 --device cpu

The kernel flags (``gmdx_torch.kernel_flags``) stand for the JAX tool's
``GMDX_*`` variables. The run prints one JSON line: the graph's and the
eager loop's s/iteration, one eager call's kernel launches and the launches
counted while the graph was captured (the counts are kept in Python, so a
replay counts none), whether the replay's output equals the eager loop's
bit for bit, and the card's name and power limit. A capture that fails
raises naming the workload; nothing is timed eagerly in its place. With
``--device cpu`` only the eager chained loop runs (plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

# Model configurations by --size: the full SD-1.5 widths, or the tiny ones
# of the CPU tests. ctx: the text context's (tokens, width).
SIZES = ("sd15", "tiny")


def configs(size: str) -> dict:
    from gmdx_torch import models

    if size == "sd15":
        return {"unet": models.SD15_UNET_CONFIG, "gm_unet": models.SD15_GM_UNET_CONFIG,
                "vae": models.SD15_VAE_CONFIG, "clip": models.CLIP_VIT_L_CONFIG,
                "ctx": (77, 768)}
    tiny = models.TINY_UNET_CONFIG
    return {"unet": tiny, "gm_unet": dataclasses.replace(tiny, in_channels=8),
            "vae": models.TINY_VAE_CONFIG, "clip": models.TINY_CLIP_CONFIG,
            "ctx": (77, tiny.cross_attention_dim)}


def vae_factor(vae) -> int:
    """The VAE's downsampling factor: 8 at SD-1.5 width."""
    return 2 ** (len(vae.config.block_out_channels) - 1)


# The chained bodies (carry -> carry), shared with the tests, which hold
# them against the JAX tool's on the same weights.


def unet_fwd_body(unet, t: torch.Tensor, ctx: torch.Tensor, channels_last: bool):
    """The GM UNet's noise prediction at ``t``, doubled to the input's
    channels and averaged with it."""
    axis = -1 if channels_last else 1

    def body(x):
        eps = unet(x, t, ctx, channels_last=channels_last)
        return torch.cat([eps, eps], dim=axis) * 0.5 + x * 0.5

    return body


def vae_decode_body(vae):
    """A decode, the image strided back to the latent's size (its 3
    channels and the first once more) and mixed into the latent."""
    f = vae_factor(vae)

    def body(z):
        pooled = vae.decode(z)[:, :, ::f, ::f]
        return z * 0.9 + 0.1 * torch.cat([pooled, pooled[:, :1]], dim=1)

    return body


def conv3x3_body(conv):
    """One 3x3 SAME conv (NHWC), its output tiled or cut to the input's
    channels and averaged with it."""
    c, o = conv.in_channels, conv.out_channels

    def body(x):
        out = conv(x)
        reps = c // o
        chained = torch.cat([out] * reps, dim=-1) if reps > 1 else out
        return x * 0.5 + 0.5 * chained[..., :c]

    return body


def attention_body(k, v, heads: int, xattn_kernel: bool = False):
    """Head-packed attention through the port's dispatch
    (``attention_packed``), averaged with the queries."""
    from gmdx_torch.kernels.attention import attention_packed

    def body(q):
        out = attention_packed(q, k, v, heads, xattn_kernel=xattn_kernel)
        return (q * 0.5 + 0.5 * out).to(q.dtype)

    return body


# The workloads at the flags' shapes, with seeded random weights and inputs:
# (body, carry, the modules the kernel flags go on).


def _gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def unet_fwd(args, dev):
    from gmdx_torch.models import UNet2DConditionModel

    cfg = configs(args.size)
    torch.manual_seed(0)
    with torch.device(dev):
        unet = UNet2DConditionModel(cfg["gm_unet"]).to(torch.bfloat16).eval()
    h = args.res // 8
    g = _gen(dev, 1)
    shape = (args.batch, h, h, 8) if args.channels_last else (args.batch, 8, h, h)
    x = torch.randn(shape, generator=g, device=dev)
    ctx = torch.randn(args.batch, *cfg["ctx"], generator=g, device=dev).to(torch.bfloat16)
    t = torch.tensor(501, dtype=torch.int32, device=dev)  # on the device: no copy a call
    return unet_fwd_body(unet, t, ctx, args.channels_last), x, [unet]


def vae_decode(args, dev):
    from gmdx_torch.models import AutoencoderKL

    torch.manual_seed(0)
    with torch.device(dev):
        vae = AutoencoderKL(configs(args.size)["vae"]).to(torch.bfloat16).eval()
    h = args.res // vae_factor(vae)
    z = torch.randn(args.batch, 4, h, h, generator=_gen(dev, 2), device=dev)
    return vae_decode_body(vae), z, [vae]


def conv3x3(args, dev):
    from gmdx_torch.models.layers import Conv3x3

    wdt = getattr(torch, args.weight_dtype)
    g = _gen(dev, 0)
    with torch.device(dev):
        conv = Conv3x3(args.in_ch, args.out_ch).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g, device=dev) * 0.02)
        conv.bias.zero_()
    conv.to(wdt)
    h = args.res // 8
    x = torch.randn(args.batch, h, h, args.in_ch, generator=_gen(dev, 1),
                    device=dev).to(torch.bfloat16)
    return conv3x3_body(conv), x, [conv]


def attention(args, dev):
    c = args.heads * args.head_dim
    g = _gen(dev, 0)
    q, k, v = (torch.randn(args.batch, args.seq, c, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    return attention_body(k, v, args.heads, args.xattn_kernel), q, []


WORKLOADS = {"unet_fwd": unet_fwd, "vae_decode": vae_decode,
             "conv3x3": conv3x3, "attention": attention}


def chain(body, x, n: int):
    for _ in range(n):
        x = body(x)
    return x


def _best_s(run, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


@torch.no_grad()
def time_scan(body, carry: torch.Tensor, iters: int, repeats: int = 3, *,
              name: str = "workload") -> dict:
    """Seconds an iteration of ``body`` (carry -> carry) chained ``iters``
    times: one eager call first (it builds the kernels and fills the weight
    operands' caches), then on the card the ``iters`` calls captured into
    one CUDA graph on static buffers, the best of ``repeats`` replays, and
    the eager chained loop on the same input. On the CPU the eager loop
    alone. A capture that fails raises, naming ``name``."""
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.utils import sync

    reset_launch_counts()
    sync(body(carry))
    out = {"iters": iters, "repeats": repeats,
           "launches_per_call": {k: n for k, n in launch_counts().items() if n}}
    if not carry.is_cuda:
        out["eager_s_per_iter"] = _best_s(lambda: chain(body, carry, iters), repeats) / iters
        return out
    static_in = carry.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the capture's stream meets every op once beforehand
        sync(body(static_in))
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=stream):
            static_out = chain(body, static_in, iters)
    except RuntimeError as e:
        raise RuntimeError(f"scan_bench: capturing {name} into a CUDA graph failed: {e}") from e
    out["capture_s"] = time.perf_counter() - t0
    out["captured_launches"] = {k: n for k, n in launch_counts().items() if n}

    def replay():
        graph.replay()
        torch.cuda.synchronize()

    replay()
    out["s_per_iter"] = _best_s(replay, repeats) / iters
    graph_out = static_out.clone()
    eager = {}

    def eager_loop():
        eager["out"] = sync(chain(body, static_in, iters))

    out["eager_s_per_iter"] = _best_s(eager_loop, repeats) / iters
    out["graph_equals_eager"] = _bits_equal(graph_out, eager["out"])
    out["graph_output_finite"] = bool(torch.isfinite(graph_out).all())
    return out


def parse_args(argv=None):
    from gmdx_torch.kernel_flags import add_kernel_flags

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="unet_fwd")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--channels-last", action="store_true")
    ap.add_argument("--in-ch", type=int, default=320)
    ap.add_argument("--out-ch", type=int, default=320)
    ap.add_argument("--weight-dtype", default="float32")
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16384)
    ap.add_argument("--head-dim", type=int, default=40)
    ap.add_argument("--size", choices=SIZES, default="sd15",
                    help="model widths: SD-1.5's, or the tiny test configs")
    ap.add_argument("--device", default="cuda")
    add_kernel_flags(ap, train=False)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from gmdx_torch import resolve_device
    from gmdx_torch.kernel_flags import apply_kernel_flags, kernel_options
    from gmdx_torch.utils import card_line

    args = parse_args(argv)
    dev = resolve_device(args.device)
    body, carry, modules = WORKLOADS[args.workload](args, dev)
    apply_kernel_flags(args, *modules)
    row = {"tool": "scan_bench", "workload": args.workload, "batch": args.batch,
           "res": args.res, "size": args.size, "channels_last": args.channels_last,
           "kernel_options": kernel_options(args), "device": str(dev),
           "card": card_line() if dev.type == "cuda" else None}
    if args.workload == "conv3x3":
        row.update(in_ch=args.in_ch, out_ch=args.out_ch, weight_dtype=args.weight_dtype)
    elif args.workload == "attention":
        row.update(seq=args.seq, heads=args.heads, head_dim=args.head_dim)
    row.update(time_scan(body, carry, args.iters, name=args.workload))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
