"""Stage-1 VAE-LoRA + GAN trainer of the port (the counterpart of
``scripts/stage1/train_vqgan_lora.py``: the same flags, plus ``--device``).

Parquet metadata (column sdr; read without pyarrow) -> the paired transforms
-> a side-stream device prefetch -> the optional exposure-clip augmentation
(``--clip_pixel``, prob 0.7, on the batch where it lies, its draws host
scalars) -> generator and discriminator steps alternating on the batch
index, ``(i // ga) % 2 == 0`` for the generator
(``gmdx_torch.train.stage1``: recon + VGG19 perceptual + adaptive-weight
adversarial through Eq. (1), the TMO and the gamut compression at qmax 49;
hinge + gradient penalty) -> the global step, EMA, logs and checkpoints at
each optimizer update (``--gradient_accumulation_steps`` micro-steps a
window) -> validation (at most four PNGs to gain maps and HDR at qmax 49)
-> ``finetuned_VAE/`` (a pipeline directory with the merged VAE, the EMA
shadow's under ``--use_ema``, and the tokenizer) and ``discriminator/``, in
the layout the JAX package writes and reads.

On the card the VAE keeps float32 master weights and computes in bfloat16
(the kernels' type), as the discriminator and VGG19 do; on the CPU
everything is float32. ``--gradient_checkpointing`` recomputes the VAE's
blocks in the backward pass. Each batch's posterior draws come from a
generator on the device seeded from (--seed, batch index), its augmentation
draws from a CPU generator seeded from (--seed, batch index, 1), the
counterparts of ``fold_in(key, i)``; a resumed run skips the batches its
checkpoint consumed and numbers the rest from there, so it draws what an
uninterrupted one would.

    python scripts/torch/train_vqgan_lora.py --pretrained_model_name_or_path DIR \\
        --train_metadata data.parquet --output_dir OUT --resolution 512 \\
        --train_batch_size 4 --clip_pixel --use_ema \\
        [--perceptual_ckpt vgg19.pth] [--device cpu]

On several cards, one process a card (``gmdx_torch.dist``):
``torchrun --nproc_per_node N scripts/torch/train_vqgan_lora.py ...
--shard_strategy {ddp,zero1,fsdp}``. --train_batch_size is per rank; each
rank loads and steps its rows of the global batch, the posterior draws are
the rank's rows of the global batch's, the adaptive weight's probes are
averaged over the ranks, and rank 0 writes the logs, checkpoints (the
one-process format), validation and artifacts.

Left out, each raising: --shard_strategy tp / sp (ROADMAP Queue 1 item 9),
--dataset_name without --train_metadata (ROADMAP Queue 1 item 5) and
--push_to_hub.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

logger = logging.getLogger("gmdx_torch.stage1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stage-1 VAE-LoRA GAN training.")
    # data
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--dataset_cache_dir", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--train_data_dir", type=str, default=None)
    p.add_argument("--train_metadata", type=str, default=None)
    p.add_argument("--image_column", type=str, default="sdr")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    # model
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--model_config_name_or_path", type=str, default=None)
    p.add_argument("--discriminator_config_name_or_path", type=str, default=None)
    p.add_argument("--non_ema_revision", type=str, default=None)
    # losses / tmo
    p.add_argument("--vae_loss", type=str, default="l2", choices=["l1", "l2"])
    p.add_argument("--bright_tmo", type=str, default="fix_mulog",
                   choices=["fix_mulog", "hard_clip", "linear_scale"])
    p.add_argument("--tmo_2446a", action="store_true")
    p.add_argument("--clip_pixel", action="store_true")
    p.add_argument("--non_zero_loss", action="store_true")
    p.add_argument("--timm_model_backend", type=str, default="vgg19")
    p.add_argument("--timm_model_layers", type=str, default=None)
    p.add_argument("--timm_model_offset", type=int, default=0)
    p.add_argument("--perceptual_ckpt", type=str, default=None,
                   help="pretrained VGG19 weights (torchvision/timm layout; "
                        ".safetensors/.pth/.pt/.bin); without it the perceptual term is a "
                        "random projection and a warning is logged")
    # training
    p.add_argument("--output_dir", type=str, default="vqgan-lora-model")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--shard_strategy", choices=["ddp", "zero1", "fsdp", "tp", "sp"],
                   default="ddp", help="ddp, zero1 or fsdp across the ranks (tp and sp "
                                       "raise)")
    p.add_argument("--tp_size", type=int, default=2)
    p.add_argument("--sp_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--discr_learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--discr_lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--allow_tf32", action="store_true")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=[None, "no", "fp16", "bf16"])
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    p.add_argument("--rank", type=int, default=64, dest="lora_rank")
    # logging / checkpoints / validation
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--tracker_project_name", type=str, default="gmdx-stage1")
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--log_grad_norm_steps", type=int, default=500)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--async_checkpointing", action="store_true",
                   help="a save returns once the state is on the host; the disk write runs "
                        "on a thread (still atomic)")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--val_images_dir", type=str, default=None)
    p.add_argument("--validation_images", type=str, default=None, nargs="+")
    p.add_argument("--validation_steps", type=int, default=500)
    p.add_argument("--debug_mode", action="store_true")
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--local_rank", type=int, default=int(os.environ.get("LOCAL_RANK", -1)))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.train_metadata is None and args.dataset_name is None:
        p.error("need --train_metadata (parquet) or --dataset_name")
    if args.push_to_hub:
        p.error("--push_to_hub is not supported (no network egress in this "
                "build); final artifacts are written to --output_dir — upload "
                "them out-of-band")
    return args


def log_validation(args, cfg, vae, params, step, val_dir, metrics_log=None):
    """At most four PNGs of --val_images_dir: encode, sample, decode to the
    gain map, HDR by Eq. (1) at qmax 49; ``hdr_step<step>_<i>.hdr`` and a
    ``grid_step<step>_<i>.png`` strip (SDR | GM | mu-law TMO of the HDR),
    the grids to the tracker, the HDR ranges to ``evaluation_log.txt``."""
    import numpy as np
    import torch

    from gmdx_torch import stream_seed
    from gmdx_torch.io import load_image, save_hdr_image, save_image, to_model_input
    from gmdx_torch.ops import apply_gm_to_sdr, mulog_tmo
    from gmdx_torch.train.stage1 import gm_forward

    images = sorted(glob.glob(os.path.join(args.val_images_dir, "*.png")))
    if not images:
        return
    os.makedirs(val_dir, exist_ok=True)
    dev = next(vae.parameters()).device
    ranges = []
    for i, path in enumerate(images[:4]):
        sdr01 = load_image(path, size=(args.resolution, args.resolution))
        x = torch.from_numpy(to_model_input(sdr01)).to(dev)
        gen = torch.Generator(device=dev).manual_seed(stream_seed(args.seed or 0, i, 2))
        with torch.no_grad():
            gm = gm_forward(cfg, vae, params, x, generator=gen)[0].float().cpu()
        sdr = torch.from_numpy(np.ascontiguousarray(sdr01.transpose(2, 0, 1)))
        hdr = apply_gm_to_sdr(gm, sdr, qmax=49.0)
        processed = mulog_tmo(hdr)
        name = f"step{step}_{i}"
        save_hdr_image(os.path.join(val_dir, f"hdr_{name}.hdr"),
                       hdr.permute(1, 2, 0).numpy(), qmax=49.0)
        strip = torch.cat([sdr, gm, processed.clamp(0, 1)], dim=-1).permute(1, 2, 0).numpy()
        save_image(os.path.join(val_dir, f"grid_{name}.png"), strip)
        if metrics_log is not None:
            metrics_log.log_images(step, {f"validation/grid_{i}": strip})
        ranges.append((float(hdr.min()), float(hdr.max())))
    with open(os.path.join(val_dir, "evaluation_log.txt"), "a") as f:
        f.write(f"step {step}: hdr ranges {ranges}\n")


def debug_strip(cfg, vae, trainables, batch, generator, tmo_fn, path):
    """--debug_mode: the generator forward with the step's (pre-update)
    trainables and posterior draw; a sdr | gm | hdr | tmo | target strip
    of the first four samples, one a row, written to ``path``."""
    import numpy as np
    import torch

    from gmdx_torch.io import save_image
    from gmdx_torch.ops import apply_gm_to_sdr, gamut_compress
    from gmdx_torch.train.stage1 import effective_vae_params, gm_forward

    with torch.no_grad():
        miss = batch["miss_pixel_values"]
        sdr01 = (miss + 1.0) / 2.0
        target01 = (batch["pixel_values"] + 1.0) / 2.0
        params = effective_vae_params(cfg, vae, trainables)
        gm = gm_forward(cfg, vae, params, miss, generator=generator).float()
        hdr = apply_gm_to_sdr(gm, sdr01, qmax=cfg.qmax)
        tmo = gamut_compress(tmo_fn(hdr, qmax=cfg.qmax))
        strip = torch.cat([t.float() for t in (sdr01, gm, hdr, tmo, target01)], dim=-1)
    strip = np.clip(strip[:4].cpu().numpy(), 0.0, 1.0)
    grid = np.concatenate(list(strip), axis=-2)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_image(path, np.transpose(grid, (1, 2, 0)))


def load_training_vae(pipe_dir: str, dev, gradient_checkpointing: bool):
    """The directory's VAE with float32 master weights, computing in
    bfloat16 on the card; in training mode (its blocks recomputed in the
    backward pass under ``gradient_checkpointing``)."""
    import torch

    from gmdx_torch.io import load_component
    from gmdx_torch.models import AutoencoderKL

    loaded = load_component(os.path.join(pipe_dir, "vae"), device=dev, dtype=torch.float32)
    cfg = dataclasses.replace(loaded.config, remat=gradient_checkpointing)
    if gradient_checkpointing:
        logger.info("gradient checkpointing (remat) enabled on the VAE")
    with torch.device("meta"):
        vae = AutoencoderKL(cfg, dtype=torch.bfloat16 if dev.type == "cuda" else None)
    vae.load_state_dict(loaded.state_dict(), strict=True, assign=True)
    return vae.to(dev).train()


def main(argv=None) -> dict:
    """Train; returns {"state", "start_step" (the resumed checkpoint's step,
    else 0), "global_step", "losses" (the logged step_gen_loss /
    step_discr_loss by step), "metrics" (every logged row), "cadence"
    ([batch index, "gen" | "discr", synced] per batch), "saved_digests"
    (checkpoint step -> tensor digest), "restored_digest" (of the state
    right after a resume, else None), "output_dir"}."""
    args = parse_args(argv)
    from gmdx_torch import dist

    dist.check_strategy(args.shard_strategy, "stage1")
    if args.train_metadata is None:
        raise NotImplementedError(
            "--dataset_name without --train_metadata: the port reads parquet metadata only "
            "(ROADMAP Queue 1 item 5)")
    logging.basicConfig(level=logging.INFO)
    joined = not dist.is_initialized() and dist.initialize()

    import torch

    from gmdx_torch import resolve_device, stream_seed
    from gmdx_torch.data import ParquetImageDataset, device_prefetch, make_dataloader
    from gmdx_torch.io import load_pipeline, save_pipeline
    from gmdx_torch.io.convert import load_vgg19_checkpoint
    from gmdx_torch.io.pipeline import save_component
    from gmdx_torch.models import AutoencoderKL, Discriminator, LoRAConfig, VGG19Features
    from gmdx_torch.ops import choose_tmo, random_exposure_adjust
    from gmdx_torch.train import MetricsLogger, make_manager, resolve_resume_step
    from gmdx_torch.train import restore_state, save_state
    from gmdx_torch.train.checkpoint import state_digest
    from gmdx_torch.train.optim import run_sizes
    from gmdx_torch.train.stage1 import (
        Stage1Config, effective_vae_params, init_state, init_trainables, make_disc_step,
        make_ema_step, make_gen_step, make_optimizers, trainables_like,
    )

    dev = dist.device(resolve_device(args.device))
    main_rank = dist.is_main_process()
    pipe_dir = args.pretrained_model_name_or_path
    tokenizer = load_pipeline(pipe_dir, device=dev, components=("tokenizer",))["tokenizer"]
    vae = load_training_vae(pipe_dir, dev, args.gradient_checkpointing)
    compute = torch.bfloat16 if dev.type == "cuda" else None
    if args.mixed_precision == "fp16":
        logger.warning("--mixed_precision fp16: the port computes in bfloat16 on the card "
                       "(the kernels' type) and in float32 on the CPU")

    torch.manual_seed(args.seed or 0)
    with torch.device(dev):
        discriminator = Discriminator(dtype=compute)
        vgg = VGG19Features(dtype=compute)
    if args.perceptual_ckpt:
        vgg.load_state_dict(load_vgg19_checkpoint(args.perceptual_ckpt), strict=True)
        logger.info("loaded pretrained VGG19 from %s", args.perceptual_ckpt)
    else:
        logger.warning(
            "--perceptual_ckpt not given: the VGG19 perceptual loss is RANDOMLY INITIALIZED — "
            "a random feature projection, not the reference's pretrained timm-VGG19 loss "
            "(train_vqgan_lora.py:837-863). Training runs, but Stage-1 quality will not "
            "match the reference. Provide torchvision/timm vgg19 ImageNet weights via "
            "--perceptual_ckpt.")

    n_dev = dist.data_parallel_size()  # the ranks; --train_batch_size is per rank
    lr, dlr = args.learning_rate, args.discr_learning_rate
    if args.scale_lr:
        scale = args.gradient_accumulation_steps * args.train_batch_size * n_dev
        lr, dlr = lr * scale, dlr * scale
    cfg = Stage1Config(vae_loss=args.vae_loss,
                       lora=LoRAConfig(rank=args.lora_rank, alpha=float(args.lora_rank)),
                       use_ema=args.use_ema)
    tmo_fn = choose_tmo(args.bright_tmo, use_2446a=args.tmo_2446a)

    dataset = ParquetImageDataset(args.train_metadata)
    n_samples = (len(dataset) if args.max_train_samples is None
                 else min(args.max_train_samples, len(dataset)))
    ga = args.gradient_accumulation_steps
    # max_train_steps counts optimizer updates (ceil(batches / ga) an epoch).
    sizes = run_sizes(n_samples=n_samples, train_batch_size=args.train_batch_size, n_dev=n_dev,
                      gradient_accumulation_steps=ga, max_train_steps=args.max_train_steps,
                      num_train_epochs=args.num_train_epochs)
    steps_per_epoch, max_train_steps = sizes["steps_per_epoch"], sizes["max_train_steps"]

    gen = torch.Generator(device=dev).manual_seed(args.seed or 0)
    trainables = init_trainables(gen, vae, cfg)
    optimizers = make_optimizers(
        trainables, discriminator, learning_rate=lr, discr_learning_rate=dlr,
        lr_scheduler=args.lr_scheduler, discr_lr_scheduler=args.discr_lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps, num_training_steps=max_train_steps,
        beta1=args.adam_beta1, beta2=args.adam_beta2, weight_decay=args.adam_weight_decay,
        epsilon=args.adam_epsilon, max_grad_norm=args.max_grad_norm,
        gradient_accumulation_steps=ga)
    state = dist.apply_shard_strategy(
        init_state(cfg, trainables, discriminator, optimizers), args.shard_strategy,
        param_fields=("trainables", "disc_params", "ema"),
        opt_fields=("opt_state", "disc_opt_state"))
    gen_step = make_gen_step(cfg, vae=vae, discriminator=discriminator, vgg=vgg, tmo_fn=tmo_fn,
                             device=dev)
    disc_step = make_disc_step(cfg, vae=vae, discriminator=discriminator, tmo_fn=tmo_fn,
                               device=dev)
    ema_step = make_ema_step(cfg) if args.use_ema else None

    manager = make_manager(args.output_dir, max_to_keep=args.checkpoints_total_limit,
                           async_checkpointing=args.async_checkpointing)
    global_step = 0
    restored_digest = None
    resume_step = resolve_resume_step(args.output_dir, args.resume_from_checkpoint)
    if resume_step is not None:
        restore_state(manager, resume_step, state)
        global_step = resume_step
        restored_digest = state_digest(state)
        logger.info("resumed from checkpoint step %d", resume_step)
    elif args.resume_from_checkpoint:
        logger.warning("checkpoint '%s' does not exist. starting a new training run",
                       args.resume_from_checkpoint)

    # A checkpoint at update S has consumed S * ga batches: skipping them,
    # and numbering the batches from there, resumes the data order, the
    # draws and the generator / discriminator cadence where they were.
    consumed_batches = global_step * ga
    loader = make_dataloader(
        dataset, tokenizer, batch_size=args.train_batch_size * n_dev,
        resolution=args.resolution, center_crop=args.center_crop,
        random_flip=args.random_flip, seed=args.seed or 0,
        num_workers=args.dataloader_num_workers, max_samples=args.max_train_samples,
        skip_batches=consumed_batches, process_shard=True)
    metrics_log = MetricsLogger(os.path.join(args.output_dir, args.logging_dir),
                                backend=args.report_to, project=args.tracker_project_name,
                                config=vars(args))
    logger.info("***** Running training ***** steps=%d", max_train_steps)
    if args.clip_pixel:
        logger.info("Using exposure clip!, prob: 0.7")

    losses, rows, cadence, saved_digests = {}, [], [], {}
    t_last = time.time()
    batches = device_prefetch(({"pixel_values": b["pixel_values"]} for b in loader), dev)
    for i, batch in enumerate(batches, start=consumed_batches):
        if global_step >= max_train_steps:
            break
        seed = stream_seed(args.seed or 0, i)
        pixel_values = batch["pixel_values"]
        miss = pixel_values
        if args.clip_pixel:
            aug = torch.Generator().manual_seed(stream_seed(args.seed or 0, i, 1))
            clipped, _ = random_exposure_adjust(aug, (pixel_values + 1.0) / 2.0, prob=0.7)
            miss = clipped * 2.0 - 1.0
        step_batch = {"pixel_values": pixel_values, "miss_pixel_values": miss}
        if args.debug_mode and i % 50 == 0:
            with state.optimizer.gathered():
                if main_rank:
                    debug_strip(cfg, vae, state.trainables, step_batch,
                                torch.Generator(device=dev).manual_seed(seed), tmo_fn,
                                os.path.join(args.output_dir, "debug_train",
                                             f"step_{i}_concat_image.png"))
        step_gen = torch.Generator(device=dev).manual_seed(seed)
        if ((i // ga) % 2) == 0:
            state, m = gen_step(state, step_batch, step_gen)
            tag = "gen"
        else:
            state, m = disc_step(state, step_batch, step_gen)
            tag = "discr"
        synced = (i + 1) % ga == 0
        cadence.append([i, tag, synced])
        # Between optimizer updates (gradient accumulation) nothing else
        # advances: the step count, EMA, logs and checkpoints wait.
        if not synced:
            continue
        global_step += 1
        if ema_step is not None:
            ema_step(state)

        if global_step % args.log_steps == 0 or global_step == 1:
            dt = time.time() - t_last
            t_last = time.time()
            scalars = {f"step_{tag}_loss": float(m["gen_loss" if tag == "gen" else "disc_loss"])}
            scalars.update({k: float(v) for k, v in m.items()
                            if k not in ("gen_loss", "disc_loss", "module_grad_norms")})
            scalars["samples_per_sec"] = (
                args.log_steps * ga * args.train_batch_size * n_dev / dt
                if global_step > 1 else 0.0)
            metrics_log.log(global_step, scalars)
            losses[global_step] = scalars[f"step_{tag}_loss"]
            rows.append({"step": global_step, **scalars})
            logger.info("step %d [%s] loss %.5f", global_step, tag,
                        scalars[f"step_{tag}_loss"])
        if global_step % args.checkpointing_steps == 0:
            saved_digests[global_step] = save_state(manager, global_step, state,
                                                    wait=not args.async_checkpointing)
            logger.info("saved state to checkpoint_%d", global_step)
        if args.val_images_dir and global_step % args.validation_steps == 0:
            with torch.no_grad(), state.optimizer.gathered():
                if main_rank:
                    eff = effective_vae_params(cfg, vae, state.trainables)
                    log_validation(args, cfg, vae, eff, global_step,
                                   os.path.join(args.output_dir, "validation"),
                                   metrics_log=metrics_log)
            dist.barrier("gmdx_validation")
    batches.close()

    # Final artifacts: the merged VAE (the EMA shadow's under --use_ema) as
    # a pipeline directory with the tokenizer, and the discriminator, from
    # rank 0 (every rank gathers what fsdp sharded).
    manager.wait_until_finished()
    dist.barrier("gmdx_final")
    shadow = state.ema.full() if state.ema is not None else None
    with torch.no_grad(), state.optimizer.gathered(), state.disc_optimizer.gathered():
        if main_rank:
            trained = (trainables_like(state.trainables, shadow) if shadow is not None
                       else state.trainables)
            eff = {k: v.detach().float() for k, v in
                   effective_vae_params(cfg, vae, trained).items()}
            with torch.device("meta"):
                final_vae = AutoencoderKL(dataclasses.replace(vae.config, remat=False))
            final_vae.load_state_dict(eff, strict=True, assign=True)
            save_pipeline(os.path.join(args.output_dir, "finetuned_VAE"),
                          components={"vae": final_vae}, tokenizer=tokenizer)
            save_component(os.path.join(args.output_dir, "discriminator"),
                           state.discriminator)
    metrics_log.close()
    dist.barrier("gmdx_saved")
    if joined:
        dist.shutdown()
    logger.info("training complete; artifacts in %s", args.output_dir)
    return {"state": state, "start_step": resume_step or 0, "global_step": global_step,
            "losses": losses, "metrics": rows, "cadence": cadence,
            "saved_digests": saved_digests, "restored_digest": restored_digest,
            "output_dir": args.output_dir}


if __name__ == "__main__":
    main()
