"""Shared CLI plumbing (counterpart of the part of ``sdbc_tpu/cli/common.py``
that the inference, precalc_fid_stats and fid CLIs use): boolean flags,
model resolution, tokenizer, compute dtype.

Booleans are ``argparse.BooleanOptionalAction`` (--flag / --no-flag), not
the reference's ``type=bool`` footgun (finetune_sd.py:27).

One flag the JAX CLIs lack: ``--device`` (default ``cuda``; ``cpu`` for
the tests), the counterpart of ``JAX_PLATFORMS``.  The CLIs run where it
says and nowhere else: ``cuda`` without a CUDA device is an error.

The JAX CLIs' flags of features the port has not taken yet are parsed and
refused: each exits with a message naming what is missing
(``refuse_unported``), none is ignored.
"""
from __future__ import annotations

import argparse

import torch

# flag → (value meaning "not used", what it needs)
_UNPORTED_FLAGS = {
    "ckpt": ("", "orbax checkpoints (utils/checkpoint.py, ROADMAP Queue 1 "
                 "item 7); use --diffusers_ckpt"),
    "wandb_artifact_run": ("", "wandb artifacts (ROADMAP Queue 1 item 7)"),
    "wandb_key": ("", "wandb artifacts (ROADMAP Queue 1 item 7)"),
    "lora_path": ("", "LoRA (train/lora.py, ROADMAP Queue 1 item 5)"),
    "ti_path": ("", "textual inversion (ROADMAP Queue 1 item 5)"),
    "controlnet_path": ("", "ControlNet (ROADMAP Queue 1 item 9)"),
    "control_image": ("", "ControlNet (ROADMAP Queue 1 item 9)"),
    "controlnet_scale": (1.0, "ControlNet (ROADMAP Queue 1 item 9)"),
    "model_family": ("sd15", "the SD-2.x and SDXL families (ROADMAP Queue "
                             "1 item 9)"),
    "tp": (0, "multi-device serving (ROADMAP Queue 1 item 8)"),
    "fsdp": (0, "multi-device training (ROADMAP Queue 1 item 8)"),
    "spatial": (False, "multi-device serving (ROADMAP Queue 1 item 8)"),
    "refiner_ckpt": ("", "the SDXL refiner ensemble (ROADMAP Queue 1 "
                         "item 9)"),
    "safety_checker": ("", "the safety checker and the CLIP vision tower "
                           "(ROADMAP Queue 1 item 6)"),
    "summarize": (None, "the BART summarizer (ROADMAP Queue 1 item 9)"),
    "bart_ckpt": ("", "the BART summarizer (ROADMAP Queue 1 item 9)"),
}


def refuse_unported(args) -> None:
    """SystemExit naming the first flag of an unported feature that is set
    (``--no-summarize`` is allowed: it turns the summarizer off)."""
    for name, (unused, what) in _UNPORTED_FLAGS.items():
        value = getattr(args, name, unused)
        if name == "summarize" and value is False:
            continue
        if value != unused:
            raise SystemExit(f"--{name} needs {what}, which sdbc_tpu_torch "
                             "has not ported yet")


def bool_flag(parser: argparse.ArgumentParser, name: str, default: bool,
              help: str = "") -> None:
    parser.add_argument(f"--{name}", action=argparse.BooleanOptionalAction,
                        default=default, help=help)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; cpu for "
                        "tests and machines without a card)")


def resolve_device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    return dev


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ckpt", type=str, default="",
                   help="checkpoint dir (utils/checkpoint.py layout; not "
                        "ported yet)")
    p.add_argument("--diffusers_ckpt", type=str, default="",
                   help="diffusers save_pretrained dir of an SD-1.x model "
                        "(ported on the fly, models/port.py)")
    p.add_argument("--wandb_artifact_run", type=str, default="",
                   help="wandb run id (not ported yet)")
    p.add_argument("--wandb_artifact_version", type=str, default="latest")
    p.add_argument("--output_dir", type=str, default="./outputs")
    p.add_argument("--run_id", type=str, default="dev")
    p.add_argument("--tokenizer_dir", type=str, default="",
                   help="dir with CLIP vocab.json+merges.txt")
    p.add_argument("--scheduler", type=str, default=None,
                   choices=["ddim", "pndm", "ddpm", "dpm", "dpm_sde",
                            "euler_a", "lms", "unipc", "lcm", "heun"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--prompt_bank", type=str, default="native",
                   choices=["native", "reference"],
                   help="'reference' renders byte-exact reference template "
                        "strings for apples-to-apples FID/grid comparisons")
    p.add_argument("--lora_path", type=str, default="",
                   help="lora.npz adapter (not ported yet)")
    p.add_argument("--ti_path", type=str, default="",
                   help="textual-inversion embedding (not ported yet)")
    p.add_argument("--controlnet_path", type=str, default="",
                   help="ControlNet dir (not ported yet)")
    p.add_argument("--model_family", type=str, default="sd15",
                   choices=["sd15", "sd21", "sdxl"],
                   help="architecture preset for fresh inits (only sd15 is "
                        "ported)")
    bool_flag(p, "zero_snr", False,
              "rescale the beta schedule to exactly zero terminal SNR "
              "(arXiv:2305.08891; v-prediction models, ddim/unipc)")
    p.add_argument("--timestep_spacing", type=str, default=None,
                   choices=["leading", "trailing"],
                   help="inference grid construction (default 'leading')")
    bool_flag(p, "tiny", False, "tiny test config instead of SD-1.5")
    bool_flag(p, "bf16", True, "bfloat16 compute")
    add_device_arg(p)


def add_img_size_arg(p):
    p.add_argument("--img_size", type=int, default=None,
                   help="image side in pixels (default 512; 32 with --tiny)")


def resolve_img_size(args):
    """Default --img_size against --tiny AFTER parsing (the tiny VAE only
    downsamples 2x, so --tiny at 512 would build a 256x256 latent)."""
    if args.img_size is None:
        args.img_size = 32 if getattr(args, "tiny", False) else 512


def make_tokenizer(args, vocab_size: int):
    """``--tokenizer_dir``'s CLIP BPE tables, else the hash fallback over
    ``vocab_size`` ids."""
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    if args.tokenizer_dir:
        return CLIPTokenizer.from_pretrained(args.tokenizer_dir)
    return CLIPTokenizer.fallback(vocab_size)


def compute_dtype(args):
    return torch.bfloat16 if args.bf16 else torch.float32


def resolve_params_cfg(args):
    """(models, cfg): ``--diffusers_ckpt``'s SD-1.x weights ported on the
    fly (shapes from its config.json files), else a fresh init (tiny or
    SD-1.5 shapes) from ``--seed``.  The modules live on ``--device`` in the
    compute dtype (``--bf16``).

    Zero-egress: there is no HF-hub branch; pretrained weights enter via
    ``--diffusers_ckpt`` (``models/port.py``)."""
    import dataclasses

    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig,
                                                   as_modules, init_models)

    device = resolve_device(args)
    dtype = compute_dtype(args)
    sched = args.scheduler or "ddim"
    if args.diffusers_ckpt:
        from sdbc_tpu_torch.models.port import (
            pipeline_config_from_diffusers, port_diffusers_checkpoint)

        cfg = pipeline_config_from_diffusers(args.diffusers_ckpt, sched)
        models = as_modules(port_diffusers_checkpoint(args.diffusers_ckpt),
                            cfg, device)
        models = {k: m.to(dtype) for k, m in models.items()}
    else:
        cfg = PipelineConfig.tiny(sched) if args.tiny \
            else PipelineConfig.sd15(sched)
        if not args.tiny:
            print("WARNING: no --diffusers_ckpt given; using RANDOM SD-1.5 "
                  "weights (zero-egress image — port real weights via "
                  "models/port.py)")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        models = init_models(cfg, device=device, generator=gen, dtype=dtype)
    over = {}
    if getattr(args, "zero_snr", False):
        over["rescale_zero_snr"] = True
    if getattr(args, "timestep_spacing", None):
        over["timestep_spacing"] = args.timestep_spacing
    if over:
        cfg = dataclasses.replace(
            cfg, schedule=dataclasses.replace(cfg.schedule, **over))
    return models, cfg
