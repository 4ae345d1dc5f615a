"""Stage-2 GM-UNet trainer of the port (the counterpart of
``scripts/stage2/train_gm_unet.py``: the same flags, plus ``--device``).

Parquet metadata (columns sdr / gainmap / text, read without pyarrow) ->
paired transforms (PIL's BILINEAR in numpy) -> a side-stream device
prefetch -> the Stage-2 step (``gmdx_torch.train.stage2``: VAE-encode both
images or sample the cached posteriors, epsilon MSE on the GM latents,
clipped AdamW, EMA at each optimizer update) -> checkpoints in the port's
own format (``checkpoint_<step>/``; a resumed run is the same run) ->
validation through the single-UNet GM pipeline (PNDM, 49 steps, at most
four images) -> a complete pipeline directory that either package loads.

On the card the UNet keeps float32 master weights and computes in bfloat16
(the kernels' type), the frozen VAE and text encoder run in bfloat16;
``--mixed_precision`` sets the latents' dtype, as in the JAX script. On the
CPU everything is float32. Each batch's noise comes from a fresh generator
seeded from (--seed, batch index), the counterpart of ``fold_in(key, i)``,
so a resumed run draws what an uninterrupted one would.

    python scripts/torch/train_gm_unet.py --pretrained_model_name_or_path DIR \\
        --train_metadata data.parquet --output_dir OUT --resolution 512 \\
        --train_batch_size 8 --use_ema [--cache_latents --center_crop] [--device cpu]

On several cards, one process a card (``gmdx_torch.dist``):

    torchrun --nproc_per_node 8 scripts/torch/train_gm_unet.py ... \\
        --shard_strategy {ddp,zero1,fsdp}

--train_batch_size is per rank; the global batch is it times the world
size, each rank loading and stepping its own rows of it, and the run is the
one-process run on the global batch (``gmdx_torch.dist.mesh``). Logs,
checkpoints (the one-process format), validation and the final pipeline
come from rank 0.

Tensor and spatial parallelism, as the JAX trainer's:

    torchrun --nproc_per_node 4 scripts/torch/train_gm_unet.py ... \\
        --shard_strategy tp --tp_size 2      # or: --shard_strategy sp --sp_size 2

lay the ranks out as a data x model grid of (world / size, size), ranks r
and r + 1 in one model group (``tpctx.join_train_parallel``). A model
group steps one per-rank batch together: the global batch is
--train_batch_size times world / size, and so is --scale_lr's factor. tp:
each rank holds its slices of the UNet's parameters, moments and EMA (the
JAX package's rule, ``gmdx_torch.dist.tp``); sp: each rank holds its rows
of every image (split along H) and the parameters whole. Checkpoints, the
validation UNet and the final pipeline are whole, in the one-process
format.

--xattn_kernel, --fused_addln, --winograd_m {2,4} and --winograd_train
stand for the JAX package's GMDX_XATTN_KERNEL, GMDX_FUSED_ADDLN,
GMDX_WINOGRAD_M and GMDX_WINOGRAD_TRAIN toggles (``gmdx_torch.kernel_flags``),
set on every module: the trained UNet, the frozen VAE and text encoder, and
the validation UNet.

Left out, raising: --dataset_name without --train_metadata (ROADMAP Queue 1
item 5).
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

logger = logging.getLogger("gmdx_torch.stage2")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Stage-2 GM-UNet training.")
    # data
    p.add_argument("--dataset_name", type=str, default=None)
    p.add_argument("--dataset_config_name", type=str, default=None)
    p.add_argument("--dataset_cache_dir", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--train_data_dir", type=str, default=None)
    p.add_argument("--train_metadata", type=str, default=None,
                   help="parquet file with columns sdr/gainmap/text")
    p.add_argument("--image_column", type=str, default="sdr")
    p.add_argument("--caption_column", type=str, default="text")
    p.add_argument("--max_train_samples", type=int, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--center_crop", action="store_true")
    p.add_argument("--random_flip", action="store_true")
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    # model
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True,
                   help="pipeline dir with unet/vae/text_encoder/tokenizer")
    p.add_argument("--revision", type=str, default=None)
    p.add_argument("--variant", type=str, default=None)
    p.add_argument("--non_ema_revision", type=str, default=None)
    p.add_argument("--scheduler_config", type=str, default=None,
                   help="override scheduler config dir for validation")
    # training
    p.add_argument("--output_dir", type=str, default="gm-unet-model")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--num_train_epochs", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=None)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true")
    p.add_argument("--shard_strategy", choices=["ddp", "zero1", "fsdp", "tp", "sp"],
                   default="ddp", help="ddp, zero1 or fsdp across the ranks; tp: tensor "
                                       "parallelism over a data x model grid; sp: each "
                                       "image's rows split over the model axis")
    p.add_argument("--tp_size", type=int, default=2,
                   help="model-axis size of --shard_strategy tp (>= 2, dividing the world)")
    p.add_argument("--sp_size", type=int, default=2,
                   help="ranks that split one image's rows under --shard_strategy sp (>= 2, "
                        "dividing the world)")
    p.add_argument("--cache_latents", action="store_true",
                   help="precompute the frozen VAE's posterior (mean, std) once and train "
                        "from it (the per-step sampling stays on the device); requires "
                        "--center_crop and no --random_flip")
    p.add_argument("--latent_cache_path", type=str, default=None,
                   help="latent-cache .npz (scripts/torch/precompute_latents.py, or the JAX "
                        "package's) to load instead of building the cache")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--lr_scheduler", type=str, default="constant")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--dream_training", action="store_true")
    p.add_argument("--dream_detail_preservation", type=float, default=1.0)
    p.add_argument("--use_x0_conditioning", action="store_true")
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--allow_tf32", action="store_true")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--offload_ema", action="store_true")
    p.add_argument("--foreach_ema", action="store_true")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--prediction_type", type=str, default=None)
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--input_perturbation", type=float, default=0.0)
    p.add_argument("--mixed_precision", type=str, default=None,
                   choices=[None, "no", "fp16", "bf16"])
    p.add_argument("--enable_xformers_memory_efficient_attention", action="store_true")
    # logging / checkpoints / validation
    p.add_argument("--logging_dir", type=str, default="logs")
    p.add_argument("--report_to", type=str, default="tensorboard")
    p.add_argument("--tracker_project_name", type=str, default="gmdx-stage2")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--async_checkpointing", action="store_true",
                   help="a save returns once the state is on the host; the disk write runs "
                        "on a thread (still atomic)")
    p.add_argument("--resume_from_checkpoint", type=str, default=None)
    p.add_argument("--validation_prompts", type=str, default=None, nargs="+")
    p.add_argument("--validation_prompt_file", type=str, default=None)
    p.add_argument("--validation_image_dir", type=str, default=None)
    p.add_argument("--validation_epochs", type=int, default=5)
    p.add_argument("--push_to_hub", action="store_true")
    p.add_argument("--hub_token", type=str, default=None)
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--local_rank", type=int, default=int(os.environ.get("LOCAL_RANK", -1)))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from gmdx_torch.kernel_flags import add_kernel_flags

    add_kernel_flags(p, train=True)
    args = p.parse_args(argv)

    if args.dream_training or args.use_x0_conditioning:
        p.error("--dream_training/--use_x0_conditioning are not implemented "
                "(they are dead flags in the reference, SURVEY.md C11)")
    if args.train_metadata is None and args.dataset_name is None:
        p.error("need --train_metadata (parquet) or --dataset_name")
    if args.latent_cache_path and not args.cache_latents:
        args.cache_latents = True  # the path implies the cached path
    if args.cache_latents and (args.random_flip or not args.center_crop):
        p.error("--cache_latents/--latent_cache_path require --center_crop and "
                "no --random_flip (latents are cached for one deterministic "
                "preprocess per sample)")
    if args.push_to_hub:
        p.error("--push_to_hub is not supported (no network egress in this "
                "build); final artifacts are written to --output_dir — upload "
                "them out-of-band")
    return args


def log_validation(args, pipe, step, val_dir, metrics_log=None):
    """PNDM 49 steps on each of the first four PNGs of
    --validation_image_dir (prompts in turn): the gain map as
    ``gm_step<step>_<i>.png`` and the HDR of Eq. (1) at qmax 49 as
    ``hdr_step<step>_<i>.hdr``; the gain maps also go to the tracker."""
    import numpy as np
    import torch

    from gmdx_torch import stream_seed
    from gmdx_torch.io import load_image, save_hdr_image, save_image, to_model_input
    from gmdx_torch.ops import apply_gm_to_sdr

    os.makedirs(val_dir, exist_ok=True)
    prompts = args.validation_prompts or ["high dynamic range photograph"]
    images = (sorted(glob.glob(os.path.join(args.validation_image_dir, "*.png")))
              if args.validation_image_dir else [])
    if not images:
        logger.info("validation: no images, skipping")
        return
    for i, img_path in enumerate(images[:4]):
        sdr01 = load_image(img_path, size=(args.resolution, args.resolution))
        gens = [torch.Generator(device=pipe.device).manual_seed(
            stream_seed(args.seed or 0, i, k, 1)) for k in range(2)]
        sdr_latent = pipe.encode_sdr(torch.from_numpy(to_model_input(sdr01)), gens[0])
        gm_latent = pipe(sdr_latent, prompts[i % len(prompts)], generator=gens[1],
                         num_inference_steps=49, output_type="latent")
        gm01 = (pipe.decode_latents(gm_latent)[0] / 2 + 0.5).clamp(0, 1).float().cpu()
        name = f"step{step}_{i}"
        save_image(os.path.join(val_dir, f"gm_{name}.png"), gm01.permute(1, 2, 0).numpy())
        hdr = apply_gm_to_sdr(gm01, torch.from_numpy(np.ascontiguousarray(
            sdr01.transpose(2, 0, 1))), qmax=49.0)
        save_hdr_image(os.path.join(val_dir, f"hdr_{name}.hdr"), hdr.permute(1, 2, 0).numpy(),
                       qmax=49.0)
        if metrics_log is not None:
            metrics_log.log_images(step, {f"validation/gm_{i}": gm01.permute(1, 2, 0).numpy()})
    logger.info("validation images written to %s", val_dir)


def build_latent_cache(dataset, tokenizer, vae, vae_params, args, batch_size):
    """The latent cache of --cache_latents: --latent_cache_path loaded (its
    resolution and fingerprint checked), or one pass built in memory
    (across ranks: built once, by rank 0, into the output directory, under
    ``main_process_first``, and loaded from there by the others)."""
    from gmdx_torch.dist import main_process_first, world_size
    from gmdx_torch.train.latent_cache import (
        compute_latent_cache, latent_cache_fingerprint, load_latent_cache, save_latent_cache,
    )

    fingerprint = latent_cache_fingerprint(args.train_metadata, len(dataset), vae_params)
    path = args.latent_cache_path
    if path is None and world_size() > 1:
        path = os.path.join(args.output_dir, f"latent_cache_{args.resolution}.npz")
        with main_process_first():
            if not os.path.exists(path):
                save_latent_cache(path, compute_latent_cache(
                    dataset, tokenizer, vae, resolution=args.resolution,
                    enc_batch=min(16, max(1, batch_size)),
                    num_workers=args.dataloader_num_workers, max_samples=args.max_train_samples),
                    resolution=args.resolution, fingerprint=fingerprint)
    if path:
        cache = load_latent_cache(path, resolution=args.resolution, fingerprint=fingerprint)
        if args.max_train_samples:
            cache = {k: v[:args.max_train_samples] for k, v in cache.items()}
        logger.info("loaded precomputed latent cache (%d samples) from %s",
                    cache["input_ids"].shape[0], path)
        return cache
    return compute_latent_cache(
        dataset, tokenizer, vae, resolution=args.resolution,
        enc_batch=min(16, max(1, batch_size)), num_workers=args.dataloader_num_workers,
        max_samples=args.max_train_samples)


def cached_latent_loader(cache, batch_size, seed=0, num_epochs=None, skip_batches=0):
    """Shuffled epochs over the latent cache (``default_rng(seed + epoch)``),
    the ragged tail dropped; ``skip_batches`` fast-forwards a resume."""
    import numpy as np

    n = next(iter(cache.values())).shape[0]
    if n < batch_size:
        raise ValueError(f"cache ({n}) smaller than batch size ({batch_size})")
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = np.random.default_rng(seed + epoch).permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            if skip_batches > 0:
                skip_batches -= 1
                continue
            idx = order[start:start + batch_size]
            yield {k: v[idx] for k, v in cache.items()}
        epoch += 1


def load_training_unet(pipe_dir: str, dev, gradient_checkpointing: bool):
    """The directory's UNet with float32 master weights, computing in
    bfloat16 on the card, in training mode; a vanilla 4-channel UNet gets
    the GM UNet's 8-channel conv_in (tiled, x0.5)."""
    import torch

    from gmdx_torch.io import load_component
    from gmdx_torch.models import UNet2DConditionModel, inflate_conv_in

    loaded = load_component(os.path.join(pipe_dir, "unet"), device=dev, dtype=torch.float32)
    cfg, sd = loaded.config, loaded.state_dict()
    if cfg.in_channels == 4:
        sd = inflate_conv_in(sd, 8, scale=0.5)
        cfg = dataclasses.replace(cfg, in_channels=8)
        logger.info("inflated conv_in 4 -> 8 channels")
    if gradient_checkpointing:
        cfg = dataclasses.replace(cfg, remat=True)
        logger.info("gradient checkpointing (remat) enabled")
    with torch.device("meta"):
        unet = UNet2DConditionModel(cfg, dtype=torch.bfloat16 if dev.type == "cuda" else None)
    unet.load_state_dict(sd, strict=True, assign=True)
    return unet.to(dev).train()


def main(argv=None) -> dict:
    """Train; returns {"state", "start_step" (the resumed checkpoint's step,
    else 0), "global_step", "losses" (logged train_loss by step),
    "saved_digests" (checkpoint step -> tensor digest), "restored_digest"
    (of the state right after a resume, else None), "output_dir"}."""
    args = parse_args(argv)
    from gmdx_torch import dist

    if args.train_metadata is None:
        raise NotImplementedError(
            "--dataset_name without --train_metadata: the port reads parquet metadata only "
            "(ROADMAP Queue 1 item 5)")
    logging.basicConfig(level=logging.INFO)
    joined = not dist.is_initialized() and dist.initialize()
    layout = None  # the data x model grid of tp / sp
    if args.shard_strategy in dist.MODEL_STRATEGIES:
        from gmdx_torch.dist import tpctx

        layout = tpctx.join_train_parallel(
            args.shard_strategy, args.sp_size if args.shard_strategy == "sp" else args.tp_size)

    import numpy as np
    import torch

    from gmdx_torch import resolve_device, stream_seed
    from gmdx_torch.data import ParquetImageDataset, device_prefetch, make_dataloader
    from gmdx_torch.io import load_pipeline, save_pipeline
    from gmdx_torch.io.params import load_params
    from gmdx_torch.kernel_flags import apply_kernel_flags
    from gmdx_torch.models import UNet2DConditionModel
    from gmdx_torch.pipelines import StableDiffusionGMPipeline
    from gmdx_torch.schedulers import DDPMScheduler, PNDMScheduler
    from gmdx_torch.train import (
        MetricsLogger, Stage2Config, init_state, make_ema_step, make_manager, make_train_step,
        resolve_resume_step, restore_state, save_state,
    )
    from gmdx_torch.train.checkpoint import state_digest
    from gmdx_torch.dist.tp import assign_state_dict
    from gmdx_torch.train.optim import data_parallel as optim_data_parallel
    from gmdx_torch.train.optim import run_sizes

    dev = dist.device(resolve_device(args.device))
    main_rank = dist.is_main_process()
    if args.seed is not None:
        np.random.seed(args.seed)
    pipe_dir = args.pretrained_model_name_or_path
    bundle = load_pipeline(pipe_dir, device=dev, components=("vae", "text_encoder", "tokenizer"))
    vae, text = bundle["modules"]["vae"], bundle["modules"]["text_encoder"]
    tokenizer = bundle["tokenizer"]
    unet = load_training_unet(pipe_dir, dev, args.gradient_checkpointing)
    apply_kernel_flags(args, unet, vae, text)

    lr = args.learning_rate
    # The data axis: the ranks, or under tp / sp the model groups (a group
    # steps one per-rank batch together); --train_batch_size is per rank.
    n_dev = dist.data_parallel_size() if layout is None else layout.data_size
    if args.scale_lr:
        lr = lr * args.gradient_accumulation_steps * args.train_batch_size * n_dev

    dataset = ParquetImageDataset(args.train_metadata)
    n_samples = (len(dataset) if args.max_train_samples is None
                 else min(args.max_train_samples, len(dataset)))
    ga = args.gradient_accumulation_steps
    # max_train_steps counts optimizer updates (ceil(batches / ga) an epoch).
    sizes = run_sizes(n_samples=n_samples, train_batch_size=args.train_batch_size, n_dev=n_dev,
                      gradient_accumulation_steps=ga, max_train_steps=args.max_train_steps,
                      num_train_epochs=args.num_train_epochs)
    steps_per_epoch, max_train_steps = sizes["steps_per_epoch"], sizes["max_train_steps"]

    cfg = Stage2Config(
        learning_rate=lr, gradient_accumulation_steps=ga, lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps, max_train_steps=max_train_steps,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, noise_offset=args.noise_offset,
        input_perturbation=args.input_perturbation, snr_gamma=args.snr_gamma,
        use_8bit_adam=args.use_8bit_adam, prediction_type=args.prediction_type or "epsilon",
        use_ema=args.use_ema,
        weight_dtype={"bf16": torch.bfloat16, "fp16": torch.float16}.get(
            args.mixed_precision, torch.float32),
    )
    train_step = make_train_step(cfg, unet=unet, vae=vae, text_encoder=text,
                                 noise_scheduler=DDPMScheduler(), device=dev, layout=layout)
    trained = [n for n, p in unet.named_parameters() if p.requires_grad]
    state = dist.apply_shard_strategy(init_state(cfg, unet), args.shard_strategy,
                                      param_fields=("params", "ema"), opt_fields=("opt_state",),
                                      layout=layout)
    data_parallel = optim_data_parallel(state.optimizer)

    def whole(tensors):
        """The trained tensors whole (tp: gathered over the model group)."""
        return list(tensors) if data_parallel is None else data_parallel.whole(tensors)
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

    global_bs = args.train_batch_size * n_dev
    # Rows by data index: the ranks of a model group take the same ones.
    shard = (None, None) if layout is None else (layout.data_rank, layout.data_size)
    # A checkpoint at update S has consumed S * ga batches: skipping them,
    # and numbering the batches from there, makes the resumed stream (data
    # order, noise, accumulation phase) the uninterrupted run's.
    consumed_batches = global_step * ga
    if args.cache_latents:
        vae_params = load_params(os.path.join(pipe_dir, "vae", "params.safetensors"))
        cache = build_latent_cache(dataset, tokenizer, vae, vae_params, args, global_bs)
        # Every rank walks the global batches and takes its own rows.
        loader = (dist.shard_batch(b, *shard) for b in cached_latent_loader(
            cache, global_bs, seed=args.seed or 0, skip_batches=consumed_batches))
    else:
        loader = make_dataloader(
            dataset, tokenizer, batch_size=global_bs, resolution=args.resolution,
            center_crop=args.center_crop, random_flip=args.random_flip, seed=args.seed or 0,
            num_workers=args.dataloader_num_workers, max_samples=args.max_train_samples,
            skip_batches=consumed_batches, process_shard=True, process_index=shard[0],
            process_count=shard[1])

    metrics_log = MetricsLogger(os.path.join(args.output_dir, args.logging_dir),
                                backend=args.report_to, project=args.tracker_project_name,
                                config=vars(args))
    logger.info("***** Running training ***** steps=%d batch=%dx%d", max_train_steps,
                args.train_batch_size, n_dev)

    def host_batches():
        for batch in loader:
            if not args.cache_latents:  # else latent stats + input_ids
                batch = {"sdr": batch["pixel_values"], "gm": batch["gainmap_values"],
                         "input_ids": batch["input_ids"]}
            # sp: this rank's rows of each image, split on the host.
            yield (dist.spatial_batch(batch, layout) if args.shard_strategy == "sp"
                   else batch)

    val_unet = None
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
        # Between optimizer updates (gradient accumulation) nothing else
        # advances: the step count, EMA, logs and checkpoints wait.
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
            scalars = {"train_loss": loss, "grad_norm": float(m["grad_norm"]),
                       "samples_per_sec": sps}
            scalars.update({f"grad_norm/{k}": float(v)
                            for k, v in m["module_grad_norms"].items()})
            metrics_log.log(global_step, scalars)
            losses[global_step] = loss
            logger.info("step %d loss %.5f grad %.3f %.1f samples/s", global_step, loss,
                        float(m["grad_norm"]), sps)
        if global_step % args.checkpointing_steps == 0:
            saved_digests[global_step] = save_state(manager, global_step, state,
                                                    wait=not args.async_checkpointing)
            logger.info("saved state to checkpoint_%d", global_step)
        if (args.validation_image_dir
                and global_step % (args.validation_epochs * steps_per_epoch) == 0):
            if val_unet is None and main_rank:
                with torch.device("meta"):
                    val_unet = UNet2DConditionModel(dataclasses.replace(unet.config, remat=False))
                val_unet = val_unet.to_empty(device=dev).to(next(vae.parameters()).dtype).eval()
                apply_kernel_flags(args, val_unet)
            with torch.no_grad():
                # Every rank gathers (fsdp); rank 0 alone validates.
                shadow = state.ema.full() if state.ema is not None else None
                with state.optimizer.gathered():
                    src = whole(shadow if shadow is not None else state.optimizer.model_params)
                    if main_rank:
                        params = dict(val_unet.named_parameters())
                        for n, t in zip(trained, src):
                            params[n].copy_(t)
                del shadow
            if main_rank:
                pipe = StableDiffusionGMPipeline(val_unet, vae, PNDMScheduler(),
                                                 text_encoder=text, tokenizer=tokenizer,
                                                 device=dev)
                log_validation(args, pipe, global_step,
                               os.path.join(args.output_dir, "validation"),
                               metrics_log=metrics_log)
            dist.barrier("gmdx_validation")
    batches.close()

    # The final pipeline: the EMA shadow (or the trained weights) as its
    # UNet, the frozen components copied as stored; rank 0 writes it.
    manager.wait_until_finished()
    dist.barrier("gmdx_final")
    out_dir = os.path.join(args.output_dir, "save_pipeline")
    with torch.no_grad():
        shadow = state.ema.full() if state.ema is not None else None
        with state.optimizer.gathered():
            if shadow is not None:
                for p, s in zip(state.optimizer.model_params, shadow):
                    p.copy_(s)
            if args.shard_strategy == "tp":  # the module whole again, for the pipeline
                full = dict(zip(trained, whole(state.optimizer.model_params)))
                assign_state_dict(unet, {k: full.get(k, v) for k, v in unet.state_dict().items()})
            if main_rank:
                save_pipeline(out_dir, components={"unet": unet}, tokenizer=tokenizer,
                              scheduler=PNDMScheduler(),
                              copy_from={k: os.path.join(pipe_dir, k)
                                         for k in ("vae", "text_encoder")})
    metrics_log.close()
    dist.barrier("gmdx_saved")
    if joined:
        dist.shutdown()
    logger.info("training complete; pipeline saved to %s", out_dir)
    return {"state": state, "start_step": resume_step or 0, "global_step": global_step,
            "losses": losses,
            "saved_digests": saved_digests, "restored_digest": restored_digest,
            "output_dir": args.output_dir}


if __name__ == "__main__":
    main()
