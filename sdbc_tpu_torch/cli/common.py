"""Shared CLI plumbing (counterpart of ``sdbc_tpu/cli/common.py`` for one
device): boolean flags, model resolution (``--ckpt``, ``--diffusers_ckpt``
or a fresh init of ``--model_family``) with the ``--lora_path`` /
``--ti_path`` merges and the ``--controlnet_path`` branches, the SDXL
refiner (``resolve_refiner``), tokenizers
with placeholder tokens (SDXL's second: ``make_tokenizer2``), compute
dtype.

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
import contextlib
import dataclasses
import os
import socket

import torch

# flag → (value meaning "not used", what it needs)
_UNPORTED_FLAGS = {
    "wandb_artifact_run": ("", "wandb artifacts (the card's machine has "
                               "no wandb; ROADMAP Queue 1 item 8)"),
    "wandb_key": ("", "wandb tracking (the card's machine has no wandb; "
                      "ROADMAP Queue 1 item 8)"),
    "spatial": (False, "row-sharded serving (ROADMAP Queue 1 item 5.2)"),
}


def maybe_init_distributed(args=None):
    """Join the process group when the environment says so (the JAX
    package's launcher contract); untouched single-process runs return
    None.  Two wire-ups:

      - a launcher (``python -m torch.distributed.run``): SDBC_MULTIHOST=1
        and the launcher's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT /
        LOCAL_RANK;
      - explicit: COORDINATOR_ADDRESS (host:port of rank 0) with
        SDBC_NUM_PROCESSES and SDBC_PROCESS_ID (and LOCAL_RANK, default the
        process id modulo the cards).

    The backend follows ``args.device``: NCCL for ``cuda``, each rank on
    ``cuda:LOCAL_RANK`` (``args.device`` is set to it), gloo for ``cpu``.
    Returns (rank, world size)."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    if not (os.environ.get("SDBC_MULTIHOST") == "1" or coord):
        return None
    import torch.distributed as dist

    if dist.is_initialized():  # idempotent
        return dist.get_rank(), dist.get_world_size()
    if coord:
        need = [v for v in ("SDBC_NUM_PROCESSES", "SDBC_PROCESS_ID")
                if v not in os.environ]
        if need:
            raise SystemExit(f"COORDINATOR_ADDRESS={coord} is set but "
                             f"{' and '.join(need)} "
                             f"{'is' if len(need) == 1 else 'are'} not: the "
                             "explicit wire-up needs COORDINATOR_ADDRESS, "
                             "SDBC_NUM_PROCESSES and SDBC_PROCESS_ID")
        rank = int(os.environ["SDBC_PROCESS_ID"])
        world = int(os.environ["SDBC_NUM_PROCESSES"])
        init = f"tcp://{coord}"
    else:
        need = [v for v in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                            "MASTER_PORT") if v not in os.environ]
        if need:
            raise SystemExit(f"SDBC_MULTIHOST=1 needs the launcher's "
                             f"{', '.join(need)} (python -m "
                             "torch.distributed.run sets them)")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        init = "env://"
    device = torch.device(getattr(args, "device", "cuda") if args is not None
                          else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available "
                             "(pass --device cpu for gloo on the CPU)")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if args is not None:
            args.device = f"cuda:{local}"
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    return rank, world


@contextlib.contextmanager
def distributed(args, tp: int, want_mesh: bool):
    """The CLI's mesh, or None: join the process group the environment
    names (``maybe_init_distributed``), then lay a (data, model=tp) mesh
    over its ranks.  A one-process run that asks for one (--tp, --fsdp)
    gets a world-1 group on a free local port, destroyed on exit."""
    import torch.distributed as dist

    joined = maybe_init_distributed(args)
    if not (joined or want_mesh):
        yield None
        return
    from sdbc_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mcfg = MeshConfig(model=max(int(tp), 1))
    try:
        mcfg.resolve(dist.get_world_size() if joined else 1)
    except ValueError as e:
        raise SystemExit(f"--tp {tp}: {e}")
    own = not dist.is_initialized()
    if own:
        dev = resolve_device(args)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=0, world_size=1)
    try:
        yield make_mesh(mcfg, device=resolve_device(args))
    finally:
        if own:
            dist.destroy_process_group()


def is_root() -> bool:
    """Rank 0, or a single-process run: the one that prints and writes."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def refuse_unported(args, unused=None) -> None:
    """SystemExit naming the first flag of an unported feature that is set.
    ``unused``: {flag: value} for a CLI whose "not used" value differs
    from the table's (the finetune CLI's ``--tp 1``)."""
    for name, (off, what) in _UNPORTED_FLAGS.items():
        off = (unused or {}).get(name, off)
        if getattr(args, name, off) != off:
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
                   help="checkpoint dir (utils/checkpoint.py layout) "
                        "written by sdbc_tpu_torch or by sdbc_tpu's "
                        "save_pipeline")
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
                   help="lora.npz adapter (train/lora.py) merged into the "
                        "resolved base weights at load")
    p.add_argument("--ti_path", type=str, default="",
                   help="ti.npz textual-inversion embedding "
                        "(train/textual_inversion.py) merged into the "
                        "resolved base at load; its placeholder token "
                        "registers on the tokenizer")
    p.add_argument("--controlnet_path", type=str, default="",
                   help="diffusers ControlNetModel dir (or a pipeline dir "
                        "with controlnet/) attached to the base model "
                        "(models/controlnet.py); comma-separated for "
                        "multi-ControlNet (residuals sum)")
    p.add_argument("--model_family", type=str, default="sd15",
                   choices=["sd15", "sd21", "sdxl"],
                   help="architecture preset for FRESH inits (checkpoint / "
                        "diffusers loads take the family from their own "
                        "configs); composes with --tiny (toy shapes of the "
                        "same family)")
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


def _collect_added_tokens(args) -> dict:
    """The placeholder tokens of a ``--ckpt``'s ``added_tokens.json`` and
    of ``--ti_path``'s embedding, {token: ids} (without them the
    placeholder would BPE into ordinary tokens and miss the learned
    rows)."""
    import json
    import os

    added = {}
    atp = os.path.join(getattr(args, "ckpt", "") or "", "added_tokens.json")
    if getattr(args, "ckpt", "") and os.path.exists(atp):
        with open(atp) as f:
            added = {k: (v if isinstance(v, list) else [v])
                     for k, v in json.load(f).items()}
    if getattr(args, "ti_path", ""):
        from sdbc_tpu_torch.train import textual_inversion as ti_mod

        _, meta = ti_mod.load_ti(args.ti_path)
        added.update(ti_mod.added_tokens_entry(meta))
    return added


def make_tokenizer(args, vocab_size: int):
    """``--tokenizer_dir``'s CLIP BPE tables, else the hash fallback over
    the base ids; ``--ti_path``'s placeholder registered unless the dir
    registers its own.  ``vocab_size``: the model's, which counts the
    appended textual-inversion rows (``resolve_params_cfg``)."""
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    added = _collect_added_tokens(args)
    if args.tokenizer_dir:
        tok = CLIPTokenizer.from_pretrained(args.tokenizer_dir)
    else:
        # the hash buckets span only the base vocab, below the placeholder
        # ids
        tok = CLIPTokenizer.fallback(
            vocab_size - sum(len(v) for v in added.values()))
    if added and not tok.added_tokens:
        tok.added_tokens.update(added)
    return tok


def make_tokenizer2(args, cfg):
    """SDXL's second (bigG) tokenizer: the ``tokenizer_2/`` of
    ``--diffusers_ckpt`` or ``--ckpt`` (its "!" pad differs from
    CLIP-L's); None for single-encoder families or when no dir ships one
    (``SDPipeline`` then uses the first, whose pad id only differs)."""
    if cfg.clip2 is None:
        return None
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    for base in (getattr(args, "diffusers_ckpt", "") or "",
                 getattr(args, "ckpt", "") or ""):
        d = os.path.join(base, "tokenizer_2") if base else ""
        if d and os.path.exists(os.path.join(d, "vocab.json")):
            tok2 = CLIPTokenizer.from_pretrained(d)
            # a placeholder token sits at the same ids in both (one base
            # vocabulary)
            added = _collect_added_tokens(args)
            if added and not tok2.added_tokens:
                tok2.added_tokens.update(added)
            return tok2
    return None


def compute_dtype(args):
    return torch.bfloat16 if args.bf16 else torch.float32


def _merge_adapters(args, models, cfg):
    """``--lora_path`` then ``--ti_path`` merged into copies of
    ``models``; with TI each extended encoder's vocab counts the appended
    rows and pools on the base vocab's last id, as the JAX CLIs do."""
    if getattr(args, "lora_path", ""):
        from sdbc_tpu_torch.train import lora as lora_mod

        models = lora_mod.merge_file(models, args.lora_path)
        print(f"merged LoRA adapter {args.lora_path}")
    if getattr(args, "ti_path", ""):
        from sdbc_tpu_torch.train import textual_inversion as ti_mod

        models, meta = ti_mod.merge_file(models, args.ti_path)
        cfg = ti_mod.extend_config(cfg, meta)
        print(f"merged textual inversion {args.ti_path} "
              f"({meta['token']!r})")
    return models, cfg


def _cast(models: dict, dtype) -> dict:
    """Every component (a list of ControlNet branches too) in ``dtype``."""
    return {k: [m.to(dtype) for m in v] if isinstance(v, list)
            else v.to(dtype) for k, v in models.items()}


def _attach_controlnets(args, models, cfg, device, dtype):
    """``--controlnet_path``'s branches (comma-separated: several, whose
    residuals sum) attached as ``models["controlnet"]`` with the config's
    ``controlnet``; each must have the base UNet's encoder layout
    (compared with ``out_channels``, which a ControlNet config lacks,
    set to the base's)."""
    from sdbc_tpu_torch.models import controlnet as controlnet_mod
    from sdbc_tpu_torch.models.convert import load_jax_params
    from sdbc_tpu_torch.models.port import load_controlnet

    branches, cn_cfg = [], None
    for one in [p for p in args.controlnet_path.split(",") if p]:
        if not os.path.isdir(one):
            raise SystemExit(f"--controlnet_path {one}: no ControlNet "
                             "directory there")
        tree, cn_cfg = load_controlnet(one)
        probe = dataclasses.replace(cn_cfg.unet,
                                    out_channels=cfg.unet.out_channels)
        if probe != cfg.unet:
            raise SystemExit(
                f"--controlnet_path {one}: its UNet layout {cn_cfg.unet} "
                f"does not match the base model's {cfg.unet} — the "
                "injected residual shapes would disagree")
        cn_cfg = dataclasses.replace(cn_cfg, unet=probe)
        branches.append(load_jax_params(controlnet_mod.init(
            cn_cfg, device=device), tree).to(dtype).requires_grad_(False))
        print(f"attached ControlNet {one}")
    models = dict(models)
    models["controlnet"] = branches[0] if len(branches) == 1 else branches
    return models, dataclasses.replace(cfg, controlnet=cn_cfg)


def resolve_params_cfg(args, dtype=None):
    """(models, cfg): ``--diffusers_ckpt``'s weights ported on the fly
    (shapes from its config.json files), else ``--ckpt``'s checkpoint
    (``utils/checkpoint.py``: the EMA shadow, LoRA and TI merged as saved;
    its scheduler unless ``--scheduler``), else a fresh init of
    ``--model_family`` (its tiny shapes with ``--tiny``: ``tiny_xl`` for
    sdxl, ``tiny`` with v-prediction for sd21) from ``--seed``; then
    ``--lora_path`` and ``--ti_path`` merged (``_merge_adapters``) and
    ``--controlnet_path``'s branches attached.  The
    modules live on ``--device`` in ``dtype`` (default: the compute dtype,
    ``--bf16``; the finetune CLI asks for fp32 masters); loaded weights
    are merged in their saved dtypes before the cast, a fresh init (made
    in ``dtype``) with its deltas in fp32 and the sums rounded once.

    Zero-egress: there is no HF-hub branch; pretrained weights enter via
    ``--diffusers_ckpt`` (``models/port.py``) or ``--ckpt``."""
    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig,
                                                   as_modules, init_models)

    device = resolve_device(args)
    dtype = dtype or compute_dtype(args)
    sched = args.scheduler or "ddim"
    if getattr(args, "ckpt", "") and not args.diffusers_ckpt:
        from sdbc_tpu_torch.utils import checkpoint as ckpt_mod

        models, cfg = ckpt_mod.load_pipeline(args.ckpt, device=device)
        if args.scheduler is not None:
            cfg = dataclasses.replace(cfg, scheduler=args.scheduler)
        models, cfg = _merge_adapters(args, models, cfg)
        models = _cast(models, dtype)
    elif args.diffusers_ckpt:
        from sdbc_tpu_torch.models.port import (
            pipeline_config_from_diffusers, port_diffusers_checkpoint)

        cfg = pipeline_config_from_diffusers(args.diffusers_ckpt, sched)
        models = as_modules(port_diffusers_checkpoint(args.diffusers_ckpt),
                            cfg, device)
        models, cfg = _merge_adapters(args, models, cfg)
        models = _cast(models, dtype)
    else:
        family = getattr(args, "model_family", "sd15")
        cfg = PipelineConfig.family(family, args.tiny, sched)
        if not args.tiny:
            print(f"WARNING: no --diffusers_ckpt given; using RANDOM "
                  f"{family} weights (zero-egress image — port real "
                  "weights via models/port.py)")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        models = init_models(cfg, device=device, generator=gen, dtype=dtype)
        models, cfg = _merge_adapters(args, models, cfg)
    over = {}
    if getattr(args, "zero_snr", False):
        over["rescale_zero_snr"] = True
    if getattr(args, "timestep_spacing", None):
        over["timestep_spacing"] = args.timestep_spacing
    if over:
        cfg = dataclasses.replace(
            cfg, schedule=dataclasses.replace(cfg.schedule, **over))
    if getattr(args, "controlnet_path", ""):
        models, cfg = _attach_controlnets(args, models, cfg, device, dtype)
    return models, cfg


def resolve_refiner(args, scheduler: str, dtype=None):
    """``--refiner_ckpt``'s (models, cfg): a diffusers dir (found by its
    ``unet/config.json``) or a port checkpoint, on ``--device`` in
    ``dtype`` (default the compute dtype).  The scheduler is forced to the
    base's: the handoff resumes mid-grid, so both stages step one grid
    (``EnsemblePipeline`` checks the schedule too)."""
    from sdbc_tpu_torch.diffusion.pipeline import as_modules

    path = args.refiner_ckpt
    device = resolve_device(args)
    dtype = dtype or compute_dtype(args)
    if os.path.exists(os.path.join(path, "unet", "config.json")):
        from sdbc_tpu_torch.models.port import (
            pipeline_config_from_diffusers, port_diffusers_checkpoint)

        cfg = pipeline_config_from_diffusers(path, scheduler)
        models = as_modules(port_diffusers_checkpoint(path), cfg, device)
    else:
        from sdbc_tpu_torch.utils import checkpoint as ckpt_mod

        models, cfg = ckpt_mod.load_pipeline(path, device=device)
        cfg = dataclasses.replace(cfg, scheduler=scheduler)
    if not cfg.refiner:
        raise SystemExit(
            f"--refiner_ckpt {path} is not a refiner layout (expected "
            "text_encoder_2 WITHOUT text_encoder + a text_time addition "
            "embedding): pass the base model via --ckpt/--diffusers_ckpt "
            "instead")
    return {k: m.to(dtype) for k, m in models.items()}, cfg
