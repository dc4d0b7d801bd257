"""Fine-tune SD-1.x, SD-2.x or SDXL on the Goodreads covers (counterpart
of ``sdbc_tpu/cli/finetune.py``), on the card unless ``--device cpu``,
one process per card.

    python -m sdbc_tpu_torch.cli.finetune --data_root ./goodreads \\
        --num_examples 12000 --train_text_encoder --no-train_unet \\
        --epochs 12 --grad_acc_steps 16

On N cards, one process each (``cli.common.maybe_init_distributed``):

    SDBC_MULTIHOST=1 python -m torch.distributed.run --nproc_per_node N \\
        -m sdbc_tpu_torch.cli.finetune ... [--tp k] [--fsdp]

or COORDINATOR_ADDRESS=host:port SDBC_NUM_PROCESSES=N SDBC_PROCESS_ID=i
per process.  The ranks form a (data, model = --tp) mesh: --batch_size is
per data rank, each rank loads its rows of the global micro-batch and the
gradients are averaged over the data group; --tp cuts the UNet and text
encoders Megatron-style, --fsdp shards parameters and AdamW moments
(ZeRO-3).  Rank 0 alone prints, logs, renders grids and writes
checkpoints (the sharded leaves gathered to it one at a time).

The JAX CLI's flags and refusals: full fine-tuning (EMA, min-SNR, offset
noise, 8-bit AdamW, gradient checkpointing, on by default with
--train_unet), LoRA (--lora_rank), textual inversion (--ti_token), prior
preservation (--prior_class_prompt, --prior_generate) and cached latents
(--cache_latents); a checkpoint on each new best mean loss over a fixed
window (--ckpts_per_epoch a epoch), a preemption checkpoint at the next
step boundary after SIGTERM/SIGINT, and a final one
(``utils/checkpoint.py``, the JAX package's layout); --resume continues
the run's latest complete checkpoint (masters, optimizer moments and
step, EMA shadow, adapters) from the start of its epoch.  The family
comes from --model_family (a fresh init) or the checkpoint: SD-2.x trains
on the v-prediction loss, SDXL on both encoders' ids (the second
tokenizer from the checkpoint's ``tokenizer_2/``, else the first) with the
text-time conditioning, the refiner on bigG alone; textual inversion on
SDXL learns one row block per encoder at shared ids.  --train_controlnet
trains a ControlNet branch alone (--controlnet_path's, else a fresh one
cloned from the base UNet with a generator seeded from --seed), its hint
from each image (--control_hint); checkpoints carry the branch, and
--resume continues it.  wandb exits naming what it needs
(``common.refuse_unported``).

The noise, timesteps and posterior draws come from one ``torch.Generator``
seeded from --seed on the host (``trainer.host_draws``), so a card run and
a CPU run of the same flags see the same draws.  --profile_dir writes a
``torch.profiler`` trace of this run's steps 3-5.  ``main`` returns the
run's figures (step and loader-wait times, losses, checkpoint bytes and
seconds, the resume's load seconds).
"""
from __future__ import annotations

import argparse
import copy
import os
import signal
import time

import numpy as np
import torch

from sdbc_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    # reference hyperparameters: finetune_sd.py:25-48
    p.add_argument("--learning_rate", type=float, default=5e-6)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--num_examples", type=int, default=12000)
    p.add_argument("--batch_size", type=int, default=1,
                   help="per-device micro batch")
    p.add_argument("--grad_acc_steps", type=int, default=16)
    p.add_argument("--data_root", type=str, default="./")
    common.add_img_size_arg(p)
    p.add_argument("--legible_text_prob", type=float, default=0.1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--wandb_key", type=str, default="",
                   help="wandb tracking (not ported: refused)")
    p.add_argument("--ckpts_per_epoch", type=int, default=4)
    common.bool_flag(p, "use_8bit_adam", False,
                     "blockwise-int8 Adam moments (bitsandbytes equivalent)")
    common.bool_flag(p, "scale_lr", False,
                     "scale lr by grad_accum*batch (reference's opt-in "
                     "scale_lr branch, finetune_sd.py:367-371)")
    common.bool_flag(p, "train_unet", False)
    common.bool_flag(p, "train_text_encoder", True)
    common.bool_flag(p, "train_controlnet", False,
                     "train a ControlNet branch with the whole base "
                     "model frozen (arXiv:2302.05543; models/controlnet.py)"
                     ". Starts from --controlnet_path if given, else clones "
                     "the base UNet's encoder half; the hint comes from "
                     "each training image (--control_hint)")
    p.add_argument("--control_hint", type=str, default="edges",
                   choices=["edges", "image"],
                   help="ControlNet training hint (with --train_controlnet)")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="> 0 trains LoRA adapters of this rank on the "
                        "attention projections of the selected components "
                        "instead of full fine-tuning (train/lora.py); "
                        "checkpoints store the frozen base + lora.npz")
    p.add_argument("--lora_alpha", type=float, default=8.0,
                   help="LoRA scale numerator: dW = (alpha/rank) * A@B")
    p.add_argument("--ti_token", type=str, default="",
                   help="textual inversion: register this placeholder and "
                        "train ONLY its new embedding rows; training "
                        "prompts gain ', in the style of <token>'")
    p.add_argument("--ti_vectors", type=int, default=1,
                   help="embedding rows the placeholder expands to")
    p.add_argument("--ti_init_token", type=str, default="",
                   help="initializer word whose mean embedding seeds the "
                        "new rows (default: embedding-table mean)")
    p.add_argument("--prior_class_prompt", type=str, default="",
                   help="enable DreamBooth prior preservation: every "
                        "micro-batch also trains class images under THIS "
                        "prompt, weighted by --prior_weight")
    p.add_argument("--prior_images_dir", type=str, default="",
                   help="directory of class images for the prior term "
                        "(default <output_dir>/prior_class)")
    p.add_argument("--prior_weight", type=float, default=1.0,
                   help="prior-preservation loss weight")
    p.add_argument("--prior_generate", type=int, default=0,
                   help="before training, generate class images with the "
                        "resolved BASE model until --prior_images_dir "
                        "holds this many")
    p.add_argument("--prior_batch_size", type=int, default=0,
                   help="class images per micro-batch (0 = --batch_size)")
    p.add_argument("--prior_gen_steps", type=int, default=50,
                   help="sampler steps for --prior_generate")
    p.add_argument("--min_snr_gamma", type=float, default=0.0,
                   help="min-SNR loss weighting (arXiv:2303.09556; 0 = off)")
    p.add_argument("--noise_offset", type=float, default=0.0,
                   help="offset-noise strength (0 = off)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="> 0 keeps an EMA shadow of the trained components "
                        "(decay min(d, (1+t)/(10+t))); checkpoints store "
                        "raw masters + ema/, loads serve the EMA weights")
    p.add_argument("--grad_ckpt", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="gradient checkpointing (default: on with "
                        "--train_unet, as in the reference "
                        "finetune_sd.py:146-149)")
    p.add_argument("--remat_mode", type=str, default="block",
                   choices=["block", "selective"],
                   help="grad-ckpt granularity: 'block' remats whole "
                        "ResBlocks/transformers; 'selective' keeps the "
                        "attention outside the checkpoint regions")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size: the ranks form a (data x "
                        "model=tp) mesh and the UNet and text encoders "
                        "are cut Megatron-style over `model` "
                        "(parallel/specs.py)")
    common.bool_flag(p, "fsdp", False,
                     "ZeRO-3: shard parameters and AdamW moments over the "
                     "`data` axis (parallel/specs.py fsdp_specs); each "
                     "shard is gathered at use and its gradient "
                     "reduce-scattered")
    common.bool_flag(p, "include_desc", False)
    common.bool_flag(p, "cache_latents", False,
                     "precompute VAE posterior moments once per dataset "
                     "and train from the cache (train/latent_cache.py)")
    common.bool_flag(p, "resume", False, "resume from run's latest checkpoint")
    common.bool_flag(p, "final_grids", False,
                     "render prompt grids after training")
    p.add_argument("--profile_dir", type=str, default="",
                   help="torch.profiler trace output dir (traces this "
                        "run's steps 3-5)")
    return p


def _refuse(args) -> None:
    """The JAX CLI's refusals of flag combinations, then the unported
    features."""
    common.refuse_unported(args, unused={"tp": 1})
    sharded = args.tp > 1 or args.fsdp
    if sharded and args.use_8bit_adam:
        raise SystemExit("--use_8bit_adam cannot combine with --fsdp/--tp: "
                         "the fused int8 update kernel is not partitionable "
                         "over sharded state (FSDP alone already shards the "
                         "fp32 moments)")
    use_lora, use_ti = args.lora_rank > 0, bool(args.ti_token)
    if args.train_controlnet:
        if use_lora or use_ti:
            raise SystemExit("--train_controlnet is a full-branch mode; it "
                             "cannot combine with --lora_rank/--ti_token")
        if sharded:
            raise SystemExit("--train_controlnet with --tp/--fsdp is not "
                             "wired up (the spec walkers don't cover the "
                             "branch tree) — use plain data parallelism")
        if args.cache_latents:
            raise SystemExit("--train_controlnet derives its conditioning "
                             "hint from the pixel batch — incompatible with "
                             "--cache_latents")
        if args.train_unet:
            raise SystemExit("--train_controlnet freezes the whole base "
                             "model (the arXiv:2302.05543 protocol) — drop "
                             "--train_unet")
        if args.train_text_encoder:
            # the reference's default-True flag: the protocol freezes it
            print("--train_controlnet: freezing the text encoder (the base "
                  "model stays untouched)")
            args.train_text_encoder = False
    if args.prior_class_prompt and args.cache_latents:
        raise SystemExit("--prior_class_prompt is incompatible with "
                         "--cache_latents (the class set has no latent "
                         "cache) — drop one")
    if args.prior_generate and not args.prior_class_prompt:
        raise SystemExit("--prior_generate needs --prior_class_prompt "
                         "(the prompt the class images are generated and "
                         "trained under)")
    if use_ti and use_lora:
        raise SystemExit("--ti_token and --lora_rank are mutually "
                         "exclusive: pick one parameter-efficient mode")
    if use_ti and args.ema_decay > 0:
        raise SystemExit("--ema_decay cannot combine with --ti_token: the "
                         "checkpoint's ema/ overlay holds component trees, "
                         "not embedding rows")
    if use_ti and sharded:
        raise SystemExit("--ti_token trains a handful of embedding rows; "
                         "TP/FSDP buy nothing and the spec walkers don't "
                         "cover the rows tree — use plain data parallelism")
    if use_lora and args.ema_decay > 0:
        raise SystemExit("--ema_decay cannot combine with --lora_rank: an "
                         "adapter shadow has no component slot in the "
                         "checkpoint's ema/ overlay — drop one")
    if use_lora and sharded:
        raise SystemExit("--lora_rank trains <1% of the parameters; "
                         "sharding the base weights buys nothing and the "
                         "TP/FSDP spec walkers don't cover adapter trees — "
                         "use plain data parallelism (adapters replicate)")


def _restore_adapters(state, resume_path, args, ti_ids, is_xl: bool):
    """A LoRA or TI resume: the saved adapter copied into the fresh
    state's tensors (the optimizer's leaves stay the same objects)."""
    if args.lora_rank > 0:
        from sdbc_tpu_torch.train import lora as lora_mod

        lpath = os.path.join(resume_path, "lora.npz")
        if not os.path.exists(lpath):
            raise SystemExit(
                f"--lora_rank resume from {resume_path} which has no "
                "lora.npz (a full-finetune checkpoint) — resume without "
                "--lora_rank, or start a fresh LoRA run on it via --ckpt")
        restored, lmeta = lora_mod.load_lora(lpath)
        live = state.trainable["lora"]
        if (int(lmeta["rank"]) != args.lora_rank
                or float(lmeta["alpha"]) != args.lora_alpha
                or set(restored) != set(live)):
            raise SystemExit(
                f"checkpoint adapter is rank {lmeta['rank']} alpha "
                f"{lmeta['alpha']} over {len(restored)} projections but the "
                f"CLI asked for rank {args.lora_rank} alpha "
                f"{args.lora_alpha} over {len(live)} — the restored Adam "
                "moments would be wrong; match the flags or start a new run")
        with torch.no_grad():
            for k, ab in restored.items():
                for x in "ab":
                    live[k][x].copy_(ab[x])
    if args.ti_token:
        from sdbc_tpu_torch.train import textual_inversion as ti_mod

        tpath = os.path.join(resume_path, "ti.npz")
        if not os.path.exists(tpath):
            raise SystemExit(
                f"--ti_token resume from {resume_path} which has no "
                "ti.npz — resume without --ti_token, or start a fresh "
                "inversion on it via --ckpt")
        rows, tmeta = ti_mod.load_ti(tpath)
        if (tmeta["token"] != args.ti_token.strip().lower()
                or list(tmeta["ids"]) != list(ti_ids)):
            raise SystemExit(
                f"checkpoint inversion is {tmeta['token']!r} ids "
                f"{tmeta['ids']} but the CLI asked for {args.ti_token!r} "
                f"ids {ti_ids} — match the flags or start a new run")
        if ("rows2" in tmeta) != is_xl:
            raise SystemExit(
                "checkpoint inversion encoder count does not match the "
                "model family (dual-encoder ti.npz needs SDXL and vice "
                "versa) — start a new run")
        with torch.no_grad():
            state.trainable["ti"]["rows"].copy_(rows)
            if is_xl:
                state.trainable["ti"]["rows2"].copy_(tmeta["rows2"])


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else np.ascontiguousarray(v))
            for k, v in batch.items()}


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.resolve_img_size(args)
    _refuse(args)
    use_lora, use_ti = args.lora_rank > 0, bool(args.ti_token)
    use_prior = bool(args.prior_class_prompt)
    with common.distributed(args, args.tp, args.tp > 1 or args.fsdp) as mesh:
        return _main(args, mesh, use_lora, use_ti, use_prior)


def _main(args, mesh, use_lora, use_ti, use_prior):
    if args.prior_generate and mesh is not None \
            and torch.distributed.get_world_size() > 1:
        raise SystemExit("--prior_generate is single-host only — "
                         "pre-generate the class set once and point every "
                         "host at --prior_images_dir")
    device = common.resolve_device(args)
    root = common.is_root()
    log = print if root else (lambda *a, **k: None)
    from sdbc_tpu_torch.data.dataset import (DatasetConfig, GoodreadsDataset,
                                             make_dataloader)
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.train import trainer as trainer_mod
    from sdbc_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                              make_train_step, merged_params)
    from sdbc_tpu_torch.utils import checkpoint as ckpt_mod
    from sdbc_tpu_torch.utils.profiling import StepTimer
    from sdbc_tpu_torch.utils.tracking import Tracker

    grad_ckpt = args.train_unet if args.grad_ckpt is None else args.grad_ckpt
    dt = common.compute_dtype(args)

    # resume resolution first: the tokenizer and dataset bind to the
    # resumed config, and no fresh weights are built only to be dropped
    resume_meta, resume_path, load_s = {}, None, 0.0
    if args.resume:
        resume_path = ckpt_mod.latest_checkpoint(args.output_dir,
                                                 args.run_id)
    if resume_path:
        import dataclasses

        log(f"resuming from {resume_path}")
        t_load = time.perf_counter()
        # the raw masters (never the EMA overlay) and, for an adapter run,
        # the raw base: the adapter and the shadow restore separately
        models, cfg = ckpt_mod.load_pipeline(
            resume_path, device=device, merge_lora=not use_lora,
            merge_ti=not use_ti, use_ema=False)
        if args.scheduler is not None:
            cfg = dataclasses.replace(cfg, scheduler=args.scheduler)
        resume_meta = ckpt_mod.load_metadata(resume_path)
        load_s = time.perf_counter() - t_load
    else:
        # fp32 masters; the trainer casts the frozen components
        models, cfg = common.resolve_params_cfg(args, dtype=torch.float32)
    if args.train_controlnet and "controlnet" not in models:
        # a fresh branch: the base UNet's encoder half, zero output convs
        # (step 0 reproduces the base exactly)
        from sdbc_tpu_torch.models import controlnet as cn_mod

        if cfg.controlnet is None:
            cfg = cfg.with_controlnet()
        models = dict(models)
        models["controlnet"] = cn_mod.from_unet(
            models["unet"], torch.Generator().manual_seed(args.seed ^ 0xC0),
            cfg.controlnet, device=device)
        log("fresh ControlNet cloned from the base UNet encoder")
    is_xl = cfg.is_sdxl
    if use_ti and cfg.refiner:
        raise SystemExit("--ti_token is not wired for the refiner flavor "
                         "— invert on the base model instead")
    tok = common.make_tokenizer(args, cfg.clip.vocab_size)
    tok2 = None
    if is_xl:
        if cfg.clip2.ctx != cfg.clip.ctx:
            raise SystemExit("SDXL training assumes both encoders share one "
                             f"context length (got {cfg.clip.ctx} vs "
                             f"{cfg.clip2.ctx})")
        # as SDPipeline falls back: the two tokenizers differ only in the
        # pad id, which the bigG encoder ignores past the end token
        tok2 = common.make_tokenizer2(args, cfg) or tok
    ti_ids, ti_init_ids = None, None
    if use_ti:
        ti_ids = tok.add_placeholder(args.ti_token, args.ti_vectors)
        if is_xl and tok2 is not tok:
            # each encoder sees the token through its own tokenizer: the
            # ids must index the one shared block of appended rows
            ti_ids2 = tok2.add_placeholder(args.ti_token, args.ti_vectors)
            if ti_ids2 != ti_ids:
                raise SystemExit(
                    f"--ti_token registered at ids {ti_ids} in the first "
                    f"tokenizer but {ti_ids2} in tokenizer_2 (different "
                    "base vocabularies?) — SDXL inversion needs one "
                    "shared id block")
        if args.ti_init_token:
            ti_init_ids = tok._token_ids(args.ti_init_token)
        log(f"textual inversion: {args.ti_token!r} -> ids {ti_ids}"
              + (f" (init from {args.ti_init_token!r})"
                 if args.ti_init_token else "")
              + (" [dual-encoder]" if is_xl else ""))

    dcfg = DatasetConfig(
        data_root=args.data_root, img_size=args.img_size,
        size=args.num_examples, legible_text_prob=args.legible_text_prob,
        include_desc=args.include_desc, max_length=cfg.clip.ctx,
        seed=args.seed, prompt_bank=args.prompt_bank,
        style_token=args.ti_token.strip().lower() if use_ti else "")
    ds = GoodreadsDataset(dcfg, tok, tokenizer2=tok2)
    if use_ti and len(ds):
        import random as _random

        probe = ds.prompt_for(0, rng=_random.Random(0))
        if not set(ti_ids) <= set(tok.encode(probe, cfg.clip.ctx)):
            log(f"WARNING: sample prompt truncates the {args.ti_token!r} "
                  f"placeholder out of the {cfg.clip.ctx}-token context "
                  f"(prompt: {probe!r}); such examples contribute no "
                  "inversion gradient")

    prior_set = None
    if use_prior:
        from sdbc_tpu_torch.train import prior as prior_mod

        prior_dir = args.prior_images_dir or os.path.join(
            args.output_dir, "prior_class")
        if args.prior_generate:
            pipe = SDPipeline(models, cfg, tok, device=device,
                              compute_dtype=dt, tokenizer2=tok2)
            made = prior_mod.generate_class_images(
                pipe, args.prior_class_prompt, args.prior_generate,
                prior_dir, img_size=args.img_size,
                batch_size=max(args.batch_size, 4),
                num_inference_steps=args.prior_gen_steps, seed=args.seed)
            del pipe
            if made:
                log(f"prior set: {made} class images generated into "
                      f"{prior_dir}")
        prior_set = prior_mod.PriorSet(prior_dir, args.prior_class_prompt,
                                       tok, args.img_size,
                                       max_length=cfg.clip.ctx,
                                       tokenizer2=tok2)
        log(f"prior preservation: {len(prior_set)} class images under "
              f"{args.prior_class_prompt!r}, weight {args.prior_weight}")

    dp, tp_exclude = 1, ()
    if mesh is not None:
        from sdbc_tpu_torch.parallel import specs as spec_mod
        from sdbc_tpu_torch.parallel.mesh import mesh_shape

        dp = mesh_shape(mesh)["data"]
        if args.tp > 1:
            try:
                tp_exclude = spec_mod.validate_tp(cfg, args.tp)
            except ValueError as e:
                raise SystemExit(f"--tp {args.tp}: {e}")
            if tp_exclude:
                log(f"TP{args.tp}: replicating {', '.join(tp_exclude)} "
                    "(head count not divisible; the UNet still shards)")
    micro_global = args.batch_size * dp
    global_batch = micro_global * args.grad_acc_steps
    if len(ds) < global_batch:
        if mesh is None:
            raise SystemExit(
                f"dataset has {len(ds)} examples but one optimizer step "
                f"consumes {global_batch} (batch_size {args.batch_size} x "
                f"grad_acc {args.grad_acc_steps}) — lower them or add data")
        raise SystemExit(
            f"dataset has {len(ds)} examples but one optimizer step consumes "
            f"{global_batch} (batch_size {args.batch_size} x {dp} devices x "
            f"grad_acc {args.grad_acc_steps}) — lower them or add data")
    steps_per_epoch = len(ds) // global_batch
    total_steps = steps_per_epoch * args.epochs

    tcfg = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        num_examples=total_steps,  # cosine horizon = total optimizer steps
        grad_accum=args.grad_acc_steps, micro_batch=args.batch_size,
        train_unet=args.train_unet,
        train_text_encoder=args.train_text_encoder, grad_ckpt=grad_ckpt,
        remat_mode=args.remat_mode, use_8bit_adam=args.use_8bit_adam,
        lr_scale_by_dp=args.scale_lr, lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha, ti_token=args.ti_token,
        ti_vectors=args.ti_vectors, ema_decay=args.ema_decay,
        min_snr_gamma=args.min_snr_gamma, noise_offset=args.noise_offset,
        prior_weight=args.prior_weight if use_prior else 0.0,
        train_controlnet=args.train_controlnet,
        control_hint=args.control_hint,
        dual_text_encoder=is_xl, refiner=cfg.refiner)

    base_host = None
    if use_lora or use_ti:
        # the untouched fp32 base, for checkpoints (the state's frozen
        # copies are cast to the compute dtype in place)
        base_host = {k: copy.deepcopy(m).cpu() for k, m in models.items()}
    state = init_train_state(
        models, tcfg, compute_dtype=dt, device=device,
        generator=torch.Generator().manual_seed(args.seed ^ 0x10A),
        ti_init_ids=ti_init_ids, dp_size=dp)
    del models
    if use_lora:
        from sdbc_tpu_torch.train import lora as lora_mod

        log(f"LoRA rank {args.lora_rank} alpha {args.lora_alpha}: "
              f"{len(state.trainable['lora'])} adapted projections, "
              f"{lora_mod.count_params(state.trainable['lora']):,} "
              "trainable parameters")
    if resume_path:
        t_load = time.perf_counter()
        _restore_adapters(state, resume_path, args, ti_ids, is_xl)
        opt_state = ckpt_mod.load_opt_state(
            resume_path, state.opt_state, state.trainable,
            tcfg.max_grad_norm)
        if opt_state is not None:
            state.opt_state = opt_state
            state.step = int(resume_meta.get("step", 0))
        if args.ema_decay > 0:
            if ckpt_mod.load_ema(resume_path, template=state.ema) is None:
                log("resume: checkpoint has no ema/ — EMA shadow starts "
                      "from the restored masters")
        if device.type == "cuda":
            torch.cuda.synchronize()
        load_s += time.perf_counter() - t_load
    latents_mm = None
    if args.cache_latents:
        from sdbc_tpu_torch.train import latent_cache as lc

        # the weights the in-step loss would use: the compute-dtype-cast
        # frozen VAE
        cache_path = lc.build_latent_cache(
            ds, state.frozen["vae"], dt, batch=max(args.batch_size, 8),
            num_workers=args.num_workers)
        latents_mm = lc.open_latent_cache(cache_path)

    if args.tp > 1 or args.fsdp:
        # every rank read the full trees above; each keeps its shard
        trainer_mod.shard_train_state(state, mesh, tp=args.tp > 1,
                                      fsdp=args.fsdp, exclude=tp_exclude)
    elif mesh is not None:
        from sdbc_tpu_torch.parallel.mesh import replicate_tree

        replicate_tree([state.trainable, state.frozen, state.ema], mesh)
    step_fn = make_train_step(cfg, tcfg, compute_dtype=dt, device=device,
                              cached_latents=latents_mm is not None,
                              mesh=mesh, dp_size=dp)
    stats = {"losses": [], "step_s": [], "loader_wait_s": [], "saves": [],
             "steps_per_epoch": steps_per_epoch, "load_s": load_s}

    last_save = {}

    def save_ckpt(path, metadata):
        t0 = time.perf_counter()
        if use_ti:
            metadata = {**metadata, "ti_token": args.ti_token,
                        "ti_vectors": args.ti_vectors}
        elif args.ema_decay > 0:
            metadata = {**metadata, "ema_decay": args.ema_decay}
        if last_save == {"path": path, "step": state.step}:
            # the final save right after a best-loss save of the same
            # step: the trees on disk hold this state already
            ckpt_mod.save_metadata(path, metadata, cfg)
            stats["saves"].append({"path": path, "bytes": 0,
                                   "seconds": time.perf_counter() - t0})
            return
        opt_tree = ckpt_mod.opt_state_tree(state.opt_state, state.trainable,
                                           tcfg.max_grad_norm, lazy=True)
        if use_ti:
            rows = state.trainable["ti"]
            # an SDXL embedding carries the second encoder's rows fourth
            ti = (rows["rows"].detach().cpu(), args.ti_token.strip().lower(),
                  ti_ids) + ((rows["rows2"].detach().cpu(),)
                             if "rows2" in rows else ())
            nbytes = ckpt_mod.save_pipeline(
                path, base_host, cfg, opt_state=opt_tree, metadata=metadata,
                ti=ti)
        elif use_lora:
            nbytes = ckpt_mod.save_pipeline(
                path, base_host, cfg, opt_state=opt_tree, metadata=metadata,
                lora={k: {x: t.detach().cpu() for x, t in ab.items()}
                      for k, ab in state.trainable["lora"].items()},
                lora_rank=args.lora_rank, lora_alpha=args.lora_alpha)
        else:
            nbytes = ckpt_mod.save_pipeline(
                path, merged_params(state), cfg, opt_state=opt_tree,
                metadata=metadata, ema=state.ema)
        last_save.update(path=path, step=state.step)
        stats["saves"].append({"path": path, "bytes": nbytes,
                               "seconds": time.perf_counter() - t0})

    tracker = (Tracker(args.output_dir, args.run_id,
                       config={**vars(args), "total_steps": total_steps,
                               "dp": dp})
               if root else _NoTracker())
    gen = torch.Generator().manual_seed(args.seed)
    best_mean_loss = float(resume_meta.get("best_mean_loss", np.inf))
    gstep = int(resume_meta.get("step", 0))
    ckpt_every = max(steps_per_epoch // args.ckpts_per_epoch, 1)

    # preemption: SIGTERM/SIGINT → finish the step, checkpoint, return
    preempted = {"flag": False}

    def _on_term(signum, frame):
        log(f"signal {signum}: checkpointing at next step boundary")
        preempted["flag"] = True

    old_handlers = {sig: signal.signal(sig, _on_term)
                    for sig in (signal.SIGTERM, signal.SIGINT)}
    profiler = None
    run_steps = 0
    timer = StepTimer(global_batch, n_chips=(
        1 if mesh is None else torch.distributed.get_world_size()), warmup=1)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    try:
        # a mid-epoch resume restarts that epoch's loader from its start
        start_epoch = min(gstep // steps_per_epoch, args.epochs)
        if start_epoch:
            log(f"resume: continuing at epoch {start_epoch}/{args.epochs} "
                  f"(step {gstep})")
        for epoch in range(start_epoch, args.epochs):
            # with a mesh each rank loads its rows of the global batch
            loader = make_dataloader(ds, micro_batch=micro_global,
                                     grad_accum=args.grad_acc_steps,
                                     seed=args.seed + epoch,
                                     num_workers=args.num_workers,
                                     latent_cache=latents_mm, epoch=epoch,
                                     mesh=mesh)
            if prior_set is not None:
                from sdbc_tpu_torch.train.prior import augment_loader

                loader = augment_loader(loader, prior_set.batches(
                    (args.prior_batch_size or args.batch_size) * dp,
                    args.grad_acc_steps, seed=args.seed + epoch, mesh=mesh))
            running, running_n = 0.0, 0
            t0 = time.perf_counter()
            it = iter(loader)
            while True:
                tw = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                stats["loader_wait_s"].append(time.perf_counter() - tw)
                if root and args.profile_dir and run_steps == 2 \
                        and profiler is None:
                    from torch.profiler import ProfilerActivity, profile

                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if device.type == "cuda"
                        else [])
                    profiler = profile(activities=acts)
                    profiler.__enter__()
                batch = _to_torch(batch)
                if mesh is None:
                    draws = trainer_mod.host_draws(gen, cfg, tcfg, batch)
                    state, metrics = step_fn(state, batch, draws=draws)
                else:
                    # the global batch's draws from the one host stream,
                    # each rank keeping its rows
                    state, metrics = step_fn(state, batch, generator=gen)
                loss = float(metrics["loss"])
                sync()
                gstep += 1
                run_steps += 1
                if profiler is not None and run_steps >= 5:
                    _stop_profile(profiler, args.profile_dir)
                    profiler = None
                running += loss
                running_n += 1
                timer.times.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                stats["losses"].append(loss)
                warm = len(timer.times) > timer.warmup
                imgs_per_s = (timer.images_per_sec_per_chip() if warm
                              else 0.0)
                skipped = int(metrics.get("notfinite_count", 0))
                tracker.log({"loss": loss, "epoch": epoch,
                             "skipped_updates": skipped,
                             **({"images_per_sec": imgs_per_s}
                                if warm else {})}, step=gstep)
                warn = "" if metrics.get("finite", True) else \
                    f"  [non-finite update SKIPPED; {skipped} total]"
                rate = f" ({imgs_per_s:.2f} img/s)" if warm else " (warm-up)"
                log(f"epoch {epoch} step {gstep} loss {loss:.4f}"
                      f"{rate}{warn}", flush=True)

                if gstep % ckpt_every == 0:
                    # a fixed window per checkpoint interval
                    mean_loss = running / running_n
                    running, running_n = 0.0, 0
                    tracker.log({"mean_loss": mean_loss}, step=gstep)
                    if mean_loss < best_mean_loss:
                        best_mean_loss = mean_loss
                        path = ckpt_mod.new_checkpoint_path(
                            args.output_dir, args.run_id, gstep)
                        log(f"new best mean loss {mean_loss:.4f}; saving "
                              f"{path}")
                        save_ckpt(path, metadata={
                            "step": gstep, "epoch": epoch,
                            "best_mean_loss": best_mean_loss,
                            "mean_loss": mean_loss})
                        tracker.log_artifact(path)

                if mesh is not None:
                    # one decision for every rank (a signal may reach one)
                    preempted["flag"] = bool(_any_rank(preempted["flag"],
                                                       mesh))
                if preempted["flag"]:
                    if profiler is not None:
                        _stop_profile(profiler, args.profile_dir)
                        profiler = None
                    path = ckpt_mod.new_checkpoint_path(
                        args.output_dir, args.run_id, gstep)
                    save_ckpt(path, metadata={
                        "step": gstep, "epoch": epoch,
                        "best_mean_loss": best_mean_loss,
                        "preempted": True})
                    log(f"preemption checkpoint saved: {path}")
                    tracker.finish()
                    stats.update(step_s=list(timer.times), final=path,
                                 preempted=True)
                    return stats
        if profiler is not None:
            _stop_profile(profiler, args.profile_dir)
            profiler = None
        final = ckpt_mod.new_checkpoint_path(args.output_dir, args.run_id,
                                             gstep)
        save_ckpt(final, metadata={"step": gstep, "epoch": args.epochs,
                                   "best_mean_loss": best_mean_loss,
                                   "final": True})
        log(f"saved final checkpoint: {final}")

        if args.final_grids:
            from sdbc_tpu_torch.eval.visualize import visualize_prompts

            served = merged_params(state, tcfg, use_ema=state.ema is not None)
            if args.tp > 1 or args.fsdp:
                from sdbc_tpu_torch.parallel.shard import gathered_copies

                served = gathered_copies(served)
        if args.final_grids and root:
            pipe = SDPipeline(served, cfg, tok, device=device,
                              compute_dtype=dt, tokenizer2=tok2)
            grid_dir = os.path.join(tracker.dir, "grids")
            _, _, path = visualize_prompts(
                pipe, include_desc=False, img_size=args.img_size,
                inference_steps=50 if not args.tiny else 4,
                save_dir=grid_dir, seed=args.seed)
            log(f"grid saved: {path}")
        tracker.finish()
        stats.update(step_s=list(timer.times), final=final, preempted=False)
        return stats
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)


class _NoTracker:
    """The tracker of a rank other than 0: rank 0 alone logs."""

    dir = ""

    def log(self, *args, **kwargs) -> None:
        pass

    log_artifact = finish = log


def _any_rank(flag: bool, mesh) -> bool:
    from sdbc_tpu_torch.parallel import comm
    from sdbc_tpu_torch.parallel.mesh import mesh_device

    return comm.all_reduce_scalars([float(flag)], None,
                                   device=mesh_device(mesh))[0] > 0


def _stop_profile(profiler, out_dir: str) -> None:
    profiler.__exit__(None, None, None)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"profile of steps 3-5 written: {path}")


if __name__ == "__main__":
    main()
