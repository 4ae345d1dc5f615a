"""ControlNet trainer of the port (the counterpart of
``scripts/controlnet/train_controlnet.py``: the same flags, plus
``--device``) for the SDR->HDRTV pipeline.

Parquet metadata (the Stage-2 schema, read without pyarrow) -> the paired
transforms -> a side-stream device prefetch -> the ControlNet step
(``gmdx_torch.train.controlnet``: the SDR frame is the denoising target and
the control image, epsilon MSE through the frozen UNet, clipped AdamW on the
ControlNet only) -> the global step, EMA, logs (the mean loss of the last
window, every 10 updates) and checkpoints at each optimizer update ->
``controlnet/``, a component directory (the EMA shadow under ``--use_ema``)
that either package loads.

The ControlNet starts from ``--controlnet_ckpt`` or from a copy of the
UNet's encoder with zero convs (``controlnet_state_dict_from_unet``), sized
to the UNet (SD-1.5, or the tiny test configs); the UNet must be the
4-channel SDR UNet. On the card the ControlNet keeps float32 master weights
and computes in bfloat16 (the kernels' type); the UNet, VAE and text
encoder are frozen in bfloat16. On the CPU everything is float32.
``--mixed_precision`` sets the latents' dtype, as in the JAX script. Each
batch's draws come from a generator seeded from (--seed, batch index), so a
resumed run draws what an uninterrupted one would.

    python scripts/torch/train_controlnet.py --pretrained_model_name_or_path DIR \\
        --train_metadata data.parquet --output_dir OUT --resolution 512 \\
        --train_batch_size 4 --use_ema [--device cpu]

On several cards, one process a card (``gmdx_torch.dist``):
``torchrun --nproc_per_node N scripts/torch/train_controlnet.py ...
--shard_strategy {ddp,zero1,fsdp}``; --train_batch_size is per rank, and
rank 0 writes the logs, checkpoints (the one-process format) and
``controlnet/``, as in the Stage-2 trainer.

Left out, raising: --shard_strategy tp / sp (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

logger = logging.getLogger("gmdx_torch.controlnet")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ControlNet training.")
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True,
                   help="pipeline dir with unet/vae/text_encoder/tokenizer")
    p.add_argument("--controlnet_ckpt", type=str, default=None,
                   help="start from a ControlNet component dir (default: the UNet's encoder)")
    p.add_argument("--train_metadata", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="controlnet-model")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=[None, "no", "fp16", "bf16"])
    p.add_argument("--tp_size", type=int, default=2)
    p.add_argument("--sp_size", type=int, default=2)
    p.add_argument("--shard_strategy", choices=["ddp", "zero1", "fsdp", "tp", "sp"],
                   default="ddp", help="ddp, zero1 or fsdp across the ranks (tp and sp "
                                       "raise)")
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--tracker_project_name", type=str, default="gmdx-controlnet")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--async_checkpointing", action="store_true",
                   help="a save returns once the state is on the host; the disk write runs "
                        "on a thread (still atomic)")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_controlnet(args, unet, dev):
    """The trained ControlNet (float32 master weights, bfloat16 compute on
    the card, in training mode): from --controlnet_ckpt, or sized to the
    UNet (SD-1.5's config, else the tiny one over the UNet's config) and
    started from its encoder."""
    import torch

    from gmdx_torch.io import load_component
    from gmdx_torch.io.convert import controlnet_state_dict_from_unet
    from gmdx_torch.models import SD15_CONTROLNET_CONFIG, TINY_CONTROLNET_CONFIG
    from gmdx_torch.models import ControlNetModel

    if args.controlnet_ckpt:
        loaded = load_component(args.controlnet_ckpt, device=dev, dtype=torch.float32)
        cfg, sd = loaded.config, loaded.state_dict()
        logger.info("loaded ControlNet from %s", args.controlnet_ckpt)
    else:
        cfg = (SD15_CONTROLNET_CONFIG if unet.config.block_out_channels[0] >= 320
               else dataclasses.replace(TINY_CONTROLNET_CONFIG, unet=unet.config))
        if cfg.unet.block_out_channels != unet.config.block_out_channels:
            cfg = dataclasses.replace(cfg, unet=unet.config)
        torch.manual_seed(args.seed or 0)
        with torch.device(dev):
            fresh = ControlNetModel(cfg)
        # The encoder's copy from the stored float32 weights (the frozen
        # UNet on the card holds them in bfloat16).
        stored = load_component(os.path.join(args.pretrained_model_name_or_path, "unet"),
                                device=dev, dtype=torch.float32)
        sd = controlnet_state_dict_from_unet(fresh.state_dict(), stored.state_dict())
        del stored, fresh
        logger.info("initialized ControlNet from the UNet encoder")
    with torch.device("meta"):
        controlnet = ControlNetModel(cfg, dtype=torch.bfloat16 if dev.type == "cuda" else None)
    controlnet.load_state_dict(sd, strict=True, assign=True)
    return controlnet.to(dev).train()


def main(argv=None) -> dict:
    """Train; returns {"state", "start_step", "global_step", "losses"
    (logged train_loss by step), "saved_digests", "restored_digest",
    "output_dir"}."""
    args = parse_args(argv)
    from gmdx_torch import dist

    dist.check_strategy(args.shard_strategy, "controlnet")
    logging.basicConfig(level=logging.INFO)
    os.makedirs(args.output_dir, exist_ok=True)
    joined = not dist.is_initialized() and dist.initialize()

    import numpy as np
    import torch

    from gmdx_torch import resolve_device, stream_seed
    from gmdx_torch.data import ParquetImageDataset, device_prefetch, make_dataloader
    from gmdx_torch.io import load_pipeline
    from gmdx_torch.io.pipeline import save_component
    from gmdx_torch.schedulers import DDPMScheduler
    from gmdx_torch.train import (
        ControlNetTrainConfig, MetricsLogger, init_controlnet_state, make_controlnet_ema_step,
        make_controlnet_train_step, make_manager, resolve_resume_step, restore_state,
        save_state,
    )
    from gmdx_torch.train.checkpoint import state_digest
    from gmdx_torch.train.optim import run_sizes

    dev = dist.device(resolve_device(args.device))
    main_rank = dist.is_main_process()
    if args.seed is not None:
        np.random.seed(args.seed)
    bundle = load_pipeline(args.pretrained_model_name_or_path, device=dev,
                           components=("unet", "vae", "text_encoder", "tokenizer"))
    unet = bundle["modules"]["unet"]
    vae, text = bundle["modules"]["vae"], bundle["modules"]["text_encoder"]
    tokenizer = bundle["tokenizer"]
    if unet.config.in_channels != 4:
        raise SystemExit(
            "ControlNet conditions the 4-channel SDR UNet; got "
            f"in_channels={unet.config.in_channels} (pass the base pipeline, "
            "not the 8-channel GM UNet)")
    controlnet = build_controlnet(args, unet, dev)

    dataset = ParquetImageDataset(args.train_metadata)
    n_samples = (len(dataset) if args.max_train_samples is None
                 else min(args.max_train_samples, len(dataset)))
    n_dev = dist.data_parallel_size()  # the ranks; --train_batch_size is per rank
    ga = args.gradient_accumulation_steps
    # max_train_steps counts optimizer updates (ceil(batches / ga) an epoch).
    sizes = run_sizes(n_samples=n_samples, train_batch_size=args.train_batch_size, n_dev=n_dev,
                      gradient_accumulation_steps=ga, max_train_steps=args.max_train_steps,
                      num_train_epochs=args.num_train_epochs)
    steps_per_epoch, max_train_steps = sizes["steps_per_epoch"], sizes["max_train_steps"]

    cfg = ControlNetTrainConfig(
        learning_rate=args.learning_rate, lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps, max_train_steps=max_train_steps,
        gradient_accumulation_steps=ga, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon, max_grad_norm=args.max_grad_norm,
        use_8bit_adam=args.use_8bit_adam, use_ema=args.use_ema,
        weight_dtype={"bf16": torch.bfloat16, "fp16": torch.float16}.get(
            args.mixed_precision, torch.float32),
    )
    train_step = make_controlnet_train_step(cfg, unet=unet, vae=vae, text_encoder=text,
                                            controlnet=controlnet,
                                            noise_scheduler=DDPMScheduler(), device=dev)
    state = dist.apply_shard_strategy(init_controlnet_state(cfg, controlnet),
                                      args.shard_strategy, param_fields=("params", "ema"),
                                      opt_fields=("opt_state",))
    ema_step = make_controlnet_ema_step(cfg) if args.use_ema else None

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

    # A checkpoint at update S has consumed S * ga batches: skip them and
    # number the batches from there.
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
    logger.info("***** ControlNet training ***** steps=%d batch=%dx%d", max_train_steps,
                args.train_batch_size, n_dev)

    def host_batches():
        for batch in loader:
            # Target = control = the SDR frame (the SDR->HDRTV recipe).
            yield {"image": batch["pixel_values"], "cond": batch["pixel_values"],
                   "input_ids": batch["input_ids"]}

    losses, saved_digests = {}, {}
    t_last = time.time()
    window_loss = []
    batches = device_prefetch(host_batches(), dev)
    for i, batch in enumerate(batches, start=consumed_batches):
        if global_step >= max_train_steps:
            break
        gen = torch.Generator(device=dev).manual_seed(stream_seed(args.seed or 0, i))
        state, m = train_step(state, batch, gen)
        window_loss.append(m["loss"])
        # Between optimizer updates nothing else advances.
        if (i + 1) % ga != 0:
            continue
        global_step += 1
        if ema_step is not None:
            ema_step(state)
        last_window, window_loss = window_loss, []
        if global_step % 10 == 0 or global_step == 1:
            loss = sum(float(x) for x in last_window) / len(last_window)
            dt = time.time() - t_last
            t_last = time.time()
            sps = 10 * ga * args.train_batch_size * n_dev / dt if global_step > 1 else 0
            metrics_log.log(global_step, {"train_loss": loss,
                                          "grad_norm": float(m["grad_norm"]),
                                          "samples_per_sec": sps})
            losses[global_step] = loss
            logger.info("step %d loss %.5f %.1f samples/s", global_step, loss, sps)
        if global_step % args.checkpointing_steps == 0:
            saved_digests[global_step] = save_state(manager, global_step, state,
                                                    wait=not args.async_checkpointing)
            logger.info("checkpoint at step %d", global_step)
    batches.close()

    metrics_log.close()
    manager.wait_until_finished()
    dist.barrier("gmdx_final")
    with torch.no_grad():
        shadow = state.ema.full() if state.ema is not None else None
        with state.optimizer.gathered():
            if shadow is not None:
                for p, s in zip(state.optimizer.model_params, shadow):
                    p.copy_(s)
            if main_rank:
                save_component(os.path.join(args.output_dir, "controlnet"), controlnet)
    dist.barrier("gmdx_saved")
    if joined:
        dist.shutdown()
    logger.info("saved ControlNet to %s/controlnet", args.output_dir)
    return {"state": state, "start_step": resume_step or 0, "global_step": global_step,
            "losses": losses, "saved_digests": saved_digests,
            "restored_digest": restored_digest, "output_dir": args.output_dir}


if __name__ == "__main__":
    main()
