"""Where the host's time goes in the single-UNet denoise loop of each sampler,
on one H100.

    python scripts/torch/time_sampler_host.py [TAG] [--rounds=3] [--repeats=5]

Run from the root of a checkout: it imports ``chip_smoke`` and
``gmdx_torch`` from the working directory. It builds the full-width SD-1.5
GM UNet (8 input channels, seeded random bf16 weights) in the single-UNet
pipeline and runs the loop of ``chip_smoke.py``'s ``samplers`` phase (512²,
batch 2, CFG 7.5) with PNDM and each sampler of that phase, in ``--rounds``
interleaved rounds (PNDM, DDIM η 0, DDIM η 0.5, DPM-Solver++, LCM, then
again), so that a slow reading that follows the sampler and one that
follows the time of the run can be told apart. Each loop gives one JSON
line:

- ``wall_ms_per_iter``: the median of ``--repeats`` timed loops (host clock,
  synchronised before and after), and every repeat;
- ``enqueue_ms_per_iter``: the host's time until the loop returns, before
  the final synchronise, split into the UNet calls, the scheduler steps and
  the rest (the CFG arithmetic, the concat, the loop's own Python);
- ``thread_cpu_ms_per_iter``: the host thread's CPU time over the same loop
  (below the enqueue time when the thread was off its core);
- ``syncs``: the host synchronisations the loop makes
  (``torch.cuda.set_sync_debug_mode("warn")``);
- ``device_allocs``: the caching allocator's device allocations in the
  timed loops (``num_device_alloc``);
- ``loadavg``: the machine's one-minute load average after the row;
- of one loop under ``torch.profiler``: device time an iteration, the
  CPU self time of the top host ops and the counts of the CUDA runtime
  calls.

Each line carries TAG and the card's name and power limit.
"""

import json
import os
import statistics
import sys
import time
import warnings

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch import nn  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402


class HostTimer:
    """Wraps a callable and sums the host time spent in its calls."""

    def __init__(self, fn):
        self.fn, self.s = fn, 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.s += time.perf_counter() - t0


def profile_loop(run, n_iter: int) -> dict:
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    host, runtime, device_us = [], {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            device_us += ev.self_device_time_total
            continue
        if ev.key.startswith("cuda"):
            runtime[ev.key] = ev.count
        host.append((ev.self_cpu_time_total, ev.key, ev.count))
    host.sort(reverse=True)
    return {"device_ms_per_iter": device_us / 1e3 / n_iter,
            "host_top": [{"op": k[:60], "self_cpu_ms_per_iter": us / 1e3 / n_iter, "count": n}
                         for us, k, n in host[:15]],
            "runtime_calls": runtime}


def main() -> None:
    tag = next((a for a in sys.argv[1:] if not a.startswith("--")), "")
    opts = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--"))
    rounds, repeats = int(opts.get("rounds", 3)), int(opts.get("repeats", 5))
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)

    from gmdx_torch.models import SD15_GM_UNET_CONFIG, UNet2DConditionModel
    from gmdx_torch.pipelines import StableDiffusionGMPipeline
    from gmdx_torch.schedulers import PNDMScheduler

    torch.manual_seed(0)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(SD15_GM_UNET_CONFIG).to(torch.bfloat16).eval()
    pipe = StableDiffusionGMPipeline(unet, nn.Identity(), PNDMScheduler(), device="cuda")
    unet_timer = HostTimer(pipe.unet)
    pipe.unet = unet_timer
    gen = torch.Generator(device="cuda").manual_seed(40)
    latents = torch.randn(2, 4, 64, 64, device="cuda", generator=gen)
    sdr_lat = torch.randn(2, 4, 64, 64, device="cuda", generator=gen)
    cond = torch.randn(2, 77, 768, device="cuda", generator=gen).to(torch.bfloat16)
    uncond = torch.randn(2, 77, 768, device="cuda", generator=gen).to(torch.bfloat16)
    cases = (("pndm", PNDMScheduler(), 0.0, 2),) + cs.sampler_schedulers()

    for rnd in range(rounds):
        for name, sched, eta, steps in cases:
            step_timer = HostTimer(type(sched).step.__get__(sched))
            sched.step = step_timer  # scheduler_step reads the signature off the class
            pipe.scheduler = sched
            g = torch.Generator(device="cuda").manual_seed(42)

            def run():
                with torch.no_grad():
                    return pipe.denoise(sdr_lat, cond, uncond, latents, num_inference_steps=steps,
                                        guidance_scale=7.5, eta=eta, generator=g)

            n_iter = pipe._num_steps(steps)
            run()  # warm-up
            torch.cuda.synchronize()
            walls, enq, cpu, unet_s, step_s = [], [], [], [], []
            allocs0 = torch.cuda.memory_stats().get("num_device_alloc", 0)
            for _ in range(repeats):
                unet_timer.s = step_timer.s = 0.0
                torch.cuda.synchronize()
                c0, t0 = time.thread_time(), time.perf_counter()
                run()
                t1, c1 = time.perf_counter(), time.thread_time()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                enq.append(t1 - t0)
                cpu.append(c1 - c0)
                unet_s.append(unet_timer.s)
                step_s.append(step_timer.s)
            allocs = torch.cuda.memory_stats().get("num_device_alloc", 0) - allocs0
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            syncs = sorted({str(w.message).splitlines()[0][:100] for w in caught})

            def per_iter_ms(xs):
                return statistics.median(xs) * 1e3 / n_iter

            line = {"tool": "time_sampler_host", "tag": tag, "device": smi, "round": rnd,
                    "sampler": name, "eta": eta, "steps": steps, "iterations": n_iter,
                    "wall_ms_per_iter": per_iter_ms(walls),
                    "walls_ms_per_iter": [w * 1e3 / n_iter for w in walls],
                    "enqueue_ms_per_iter": per_iter_ms(enq),
                    "unet_host_ms_per_iter": per_iter_ms(unet_s),
                    "step_host_ms_per_iter": per_iter_ms(step_s),
                    "rest_host_ms_per_iter": per_iter_ms(
                        [e - u - s for e, u, s in zip(enq, unet_s, step_s)]),
                    "thread_cpu_ms_per_iter": per_iter_ms(cpu),
                    "syncs": len(caught), "sync_kinds": syncs, "device_allocs": allocs,
                    "loadavg": os.getloadavg()[0]}
            if rnd == 0:
                line["profile"] = profile_loop(run, n_iter)
            print(json.dumps(line), flush=True)
            del sched.step


if __name__ == "__main__":
    main()
