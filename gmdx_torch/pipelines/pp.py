"""Pipeline parallelism for the dual-UNet text-to-HDR sampler, on
``torch.distributed``: the counterpart of ``gmdx/pipelines/pp.py``.

The GM branch reads the SDR branch's x0 prediction each step and the SDR
branch never reads the GM branch, so the two chains form a two-stage
pipeline:

  stage 0 (SDR): the CFG-doubled SDR UNet and its scheduler step, emitting
      each step's x0;
  stage 1 (GM): the conditional-only GM UNet on [x0 ‖ gm latents] and its
      step, one chunk behind stage 0.

The JAX module is one controller that drives two submeshes through async
dispatch. The port runs one process a card, so each stage's host
dispatches only its own UNet. The first half of the ranks is stage 0 and
the second half stage 1 (``pp_stage_meshes``' split); within a stage the
ranks split the batch rows (data parallelism, ``gmdx_torch.dist.mesh.
batch_rows``), and rank i of stage 0 and rank i + half of stage 1 hold the
same rows and form a two-rank pair group. The loop runs in chunks of
``chunk`` steps: after each, stage 0 sends its x0 stack (chunk, b, h, w, 4),
fp32, to its pair, which runs that chunk of GM steps on it; after the last,
stage 0 sends its final latents too, so that the main path's one batched
decode of the SDR and GM latents runs on stage 1. The hop
(``gmdx_torch.dist.pairs``) is one broadcast over the pair; stage 0 issues
it asynchronously and waits on it only after its last chunk, and the loop
holds no host synchronisation, so stage 0 runs on while stage 1 works one
chunk behind.

Both stages run the step bodies of ``gmdx_torch.pipelines.dual``
(:func:`~gmdx_torch.pipelines.dual.sdr_step`,
:func:`~gmdx_torch.pipelines.dual.gm_step`), the sequential loop's algebra
itself. Randomness: the sequential loop draws each step's SDR noise, then
its GM noise, from one generator; a stage replays that stream from the same
generator state, keeps its own branch's draws and drops the other's, and
under data parallelism keeps its rows of each whole-batch draw
(``randn_rows``'s rule). With a generator, one rank a stage and the same
initial latents, a pipelined run is the sequential run bit for bit.

The sequential loop's ``low_memory``, ``return_intermediates`` and
``on_step`` are not taken (the JAX wrapper has none of them), and a
ControlNet pipeline raises: its SDR prediction adds the ControlNet's
residuals, which the JAX wrapper, calling the SDR UNet alone, would drop.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.distributed as dist

from gmdx_torch.dist import multihost, pairs
from gmdx_torch.dist.mesh import batch_rows
from gmdx_torch.pipelines.controlnet import StableDiffusionControlNetHDRPipeline
from gmdx_torch.pipelines.dual import StableDiffusionDualUNetPipeline, gm_step, sdr_step
from gmdx_torch.pipelines.gm import _draws_noise, _step_kwarg_names

# The components a rank of each stage holds: the SDR UNet on stage 0; the
# GM UNet, and the VAE and text encoder for the caller's encode and
# decode, on stage 1 (where the final latents land), as ``place_params``
# places them.
STAGE_MODULES = (("unet",), ("gm_unet", "vae", "text_encoder"))
STAGE_COMPONENTS = (STAGE_MODULES[0] + ("scheduler",),
                    STAGE_MODULES[1] + ("tokenizer", "scheduler"))


@dataclasses.dataclass(frozen=True)
class StageGroups:
    """This rank's place in the two-stage layout."""

    stage: int  # 0: the SDR stage, 1: the GM stage
    ranks: tuple[int, ...]  # this stage's ranks
    data_group: object  # the ProcessGroup of this stage's ranks (its batch rows)
    data_size: int
    data_rank: int
    pair_group: object  # the ProcessGroup {i, i + half} of this rank's pair
    pair: tuple[int, int]  # (its stage-0 rank, its stage-1 rank)


def pp_stage_ranks(world: int) -> tuple[list[int], list[int]]:
    """(stage 0's ranks, stage 1's ranks): the first half of the world and
    the second, as ``pp_stage_meshes`` splits the devices; a world under 2
    or odd raises ValueError."""
    if world < 2 or world % 2:
        raise ValueError(f"pipeline parallelism needs an even rank count >= 2, got {world}")
    half = world // 2
    return list(range(half)), list(range(half, world))


def pp_stage_groups() -> StageGroups:
    """The two stages over the process group already joined, or joined here
    from torchrun's environment (``multihost.initialize``): each stage's
    data group and the pair groups; every rank makes every group, in the
    same order. Returns this rank's :class:`StageGroups`."""
    multihost.initialize()
    world, rank = multihost.world_size(), multihost.rank()
    stages = pp_stage_ranks(world)
    half = world // 2
    data_groups = [dist.new_group(r) for r in stages]
    pair_groups = pairs.pair_groups(half)
    stage, i = divmod(rank, half)
    return StageGroups(stage, tuple(stages[stage]), data_groups[stage], half, i,
                       pair_groups[i], (i, i + half))


class PipelinedDualUNet:
    """Two-stage pipelined wrapper around a
    :class:`~gmdx_torch.pipelines.dual.StableDiffusionDualUNetPipeline`.

    ``pipe`` supplies the modules and the scheduler; on a stage-0 rank it
    needs ``unet``, on a stage-1 rank ``gm_unet``, and the wrapper drops
    the other stage's modules from it (:meth:`place`): build each rank's
    pipeline with only its own (None for the rest), or load them with
    :meth:`from_pretrained`, so that no rank allocates the other stage's
    UNet. ``chunk`` is the pipeline's granularity in denoise steps: smaller
    chunks shrink the fill bubble (one chunk of SDR steps) and pay more
    hops. ``groups`` defaults to :func:`pp_stage_groups`.
    """

    def __init__(self, pipe, chunk: int = 5, groups: StageGroups | None = None):
        if isinstance(pipe, StableDiffusionControlNetHDRPipeline):
            raise TypeError(
                "PipelinedDualUNet runs the SDR UNet alone, as the JAX wrapper does, so it "
                "would drop a ControlNet's residuals; run the ControlNet pipeline as it is")
        if not isinstance(pipe, StableDiffusionDualUNetPipeline):
            raise TypeError(f"PipelinedDualUNet wraps a StableDiffusionDualUNetPipeline, "
                            f"got {type(pipe).__name__}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.pipe, self.chunk = pipe, chunk
        self.groups = pp_stage_groups() if groups is None else groups
        self.place()

    @classmethod
    def from_pretrained(cls, path: str, chunk: int = 5, *, device: str | torch.device = "cuda",
                        groups: StageGroups | None = None) -> PipelinedDualUNet:
        """The wrapper over a pipeline directory (``init_pipeline.py
        --dual``), each rank loading only its stage's components
        (:data:`STAGE_COMPONENTS`) on its device (``cuda:<local rank>``)."""
        from gmdx_torch.io.pipeline import load_pipeline

        groups = pp_stage_groups() if groups is None else groups
        dev = multihost.device(device)
        bundle = load_pipeline(path, device=dev, components=STAGE_COMPONENTS[groups.stage])
        mods = bundle["modules"]
        pipe = StableDiffusionDualUNetPipeline(
            mods.get("unet"), mods.get("vae"), bundle["scheduler"], mods.get("gm_unet"),
            text_encoder=mods.get("text_encoder"), tokenizer=bundle["tokenizer"], device=dev)
        return cls(pipe, chunk, groups)

    def place(self) -> None:
        """This rank's modules only (the counterpart of ``place_params``):
        the other stage's are dropped from the pipeline; this stage's UNet
        must be there."""
        stage = self.groups.stage
        own = STAGE_MODULES[stage][0]
        if getattr(self.pipe, own) is None:
            raise ValueError(f"a stage-{stage} rank needs the pipeline's {own}")
        for name in STAGE_MODULES[1 - stage]:
            setattr(self.pipe, name, None)

    # -- the hop ------------------------------------------------------------
    def _send(self, t: torch.Tensor):
        return pairs.send(t.float(), self.groups.pair_group, self.groups.pair[0])

    def _recv(self, shape) -> torch.Tensor:
        return pairs.recv(shape, self.groups.pair_group, self.groups.pair[0],
                          device=self.pipe.device)

    # -- the loop -----------------------------------------------------------
    @torch.no_grad()
    def denoise_dual(
        self,
        prompt_embeds: torch.Tensor,
        negative_prompt_embeds: torch.Tensor | None,
        latents: torch.Tensor,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        eta: float = 0.0,
        generator: torch.Generator | None = None,
        step_noise: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Pipelined drop-in for the sequential ``denoise_dual``: the same
        arguments, the whole batch on every rank (embeddings (B, 77, D),
        latents (B, 4, h, w), ``step_noise[i]`` the (SDR, GM) pair, NHWC;
        ``generator`` on the pipeline's device, in the same state on every
        rank). Each rank takes its stage's rows of the batch.

        Returns on a stage-0 rank (its rows of the SDR latents, None), on a
        stage-1 rank (its rows of the SDR latents, received from its pair,
        and of the GM latents), each (b, 4, h, w) fp32 on the pipeline's
        device."""
        pipe, g = self.pipe, self.groups
        dev, sched = pipe.device, pipe.scheduler
        if latents.shape[0] % g.data_size:
            raise ValueError(f"a stage of {g.data_size} ranks does not split a batch of "
                             f"{latents.shape[0]} rows")
        b = latents.shape[0] // g.data_size
        start, total = batch_rows(b, g)
        rows = slice(start, start + b)
        lat = latents[rows].to(dev, torch.float32).permute(0, 2, 3, 1).contiguous()
        cond = prompt_embeds[rows].to(dev)
        state = sched.init_state(num_inference_steps)
        n_steps = pipe._num_steps(num_inference_steps)
        generator = pipe._default_generator(generator, step_noise)
        names = _step_kwarg_names(type(sched))

        def noise(i: int) -> torch.Tensor | None:
            """This stage's noise of step ``i``, its rows: the explicit one of
            ``step_noise[i]``'s (SDR, GM) pair, or where that is None the
            generator's draw, made for each branch in turn as the sequential
            loop makes it."""
            given = (None, None) if step_noise is None else step_noise[i]
            drawn = (generator is not None and "noise" in names
                     and _draws_noise(sched, state, eta, names))
            out = None
            for branch, n in enumerate(given):
                if n is None and drawn:
                    n = torch.randn((total, *lat.shape[1:]), generator=generator,
                                    device=lat.device, dtype=lat.dtype)
                if branch == g.stage and n is not None:
                    out = n[rows].to(dev)
            return out

        chunks = [(s, min(s + self.chunk, n_steps)) for s in range(0, n_steps, self.chunk)]
        if g.stage == 0:
            neg = negative_prompt_embeds
            uncond = None if neg is None else neg[rows].to(dev)
            context = cond if uncond is None else torch.cat([uncond, cond])

            def sdr_eps(x, t, c):
                return pipe.unet(x, t, c, channels_last=True)

            works = []
            for s, e in chunks:
                x0s = []
                for i in range(s, e):
                    lat, x0 = sdr_step(sched, state, sdr_eps, lat, context, cond=cond,
                                       uncond=uncond, guidance_scale=guidance_scale,
                                       guidance_rescale=guidance_rescale, eta=eta,
                                       generator=None, noise=noise(i))
                    x0s.append(x0)
                works.append(self._send(torch.stack(x0s)))
            works.append(self._send(lat))
            for w in works:
                w.wait()
            return lat.permute(0, 3, 1, 2).contiguous(), None

        gm_lat = lat
        for s, e in chunks:
            x0s = self._recv((e - s, *lat.shape))
            for k, i in enumerate(range(s, e)):
                gm_lat = gm_step(sched, state, pipe.gm_unet, x0s[k], gm_lat, cond, eta=eta,
                                 generator=None, noise=noise(i))
        sdr = self._recv(lat.shape)
        return sdr.permute(0, 3, 1, 2).contiguous(), gm_lat.permute(0, 3, 1, 2).contiguous()


__all__ = ["PipelinedDualUNet", "StageGroups", "pp_stage_groups", "pp_stage_ranks",
           "STAGE_COMPONENTS", "STAGE_MODULES"]
