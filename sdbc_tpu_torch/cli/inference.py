"""Inference CLI (counterpart of ``sdbc_tpu/cli/inference.py``): modes
default / calc_fid / enter_prompt, on the card unless ``--device cpu``.

    python -m sdbc_tpu_torch.cli.inference --mode calc_fid \\
        --diffusers_ckpt ./sd15 --fid_stats_path ./fid_stats.npz

  default      the prompt-grid configurations with fixed latents
  calc_fid     generate --num_imgs covers over df_test + FID vs --fid_stats_path
  enter_prompt one custom prompt → PNG (img2img, inpainting, hires-fix)

``--model_family sd21|sdxl`` picks the family of a fresh init;
``--refiner_ckpt`` (an SDXL refiner: a diffusers dir or a checkpoint)
serves the base → refiner ensemble, handing over at ``--refiner_frac``.
``--lora_path`` / ``--ti_path`` merge an adapter or a learned embedding at
load (SD-1.x); ``--safety_checker`` blacks out flagged images.
``--controlnet_path`` attaches ControlNet branches (comma-separated),
which enter_prompt drives with ``--control_image`` (one image per branch)
and ``--controlnet_scale``; a ``--ckpt`` of an inpainting UNet
(``in_channels`` 9) inpaints ``--init_image`` under ``--mask_image``.
The default mode's (summarize, include_desc) = (T,T) grid summarizes
df_test's descriptions with ``--bart_ckpt``'s DistilBART
(``models/bart.py``) on ``--device``.

Every sampling-profile flag goes through one ``SampleSpec``.  Flags of
features not ported yet exit with a message (``common.refuse_unported``).
df_test.csv is read without pandas (``data.dataset.read_csv_rows``); PIL
is imported only where input images are read (enter_prompt's PNGs are
written by ``utils/png.py``) or FID images written.
"""
from __future__ import annotations

import argparse
import json
import os
import re

from sdbc_tpu_torch.cli import common


def _scale_list(s: str):
    """--controlnet_scale parser: '0.8' → float, '0.8,1.2' → [floats]."""
    vals = [float(v) for v in s.split(",") if v]
    return vals if len(vals) > 1 else vals[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    p.add_argument("--mode", type=str, default="default",
                   choices=["default", "calc_fid", "enter_prompt"])
    p.add_argument("--data_root", type=str, default="./")
    p.add_argument("--batch_size", type=int, default=4,
                   help="generation batch (reference: max 4 on a 16GB GPU)")
    p.add_argument("--num_imgs", type=int, default=4000)
    p.add_argument("--save_dir", type=str, default="./generated")
    common.add_img_size_arg(p)
    p.add_argument("--num_inference_steps", type=int, default=50,
                   help="50-step DDIM is the reference-exact protocol; the "
                        "fast serving profile is --scheduler dpm "
                        "--num_inference_steps 25")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--clip_skip", type=int, default=0,
                   help="2 conditions the UNet on the text encoder's "
                        "penultimate hidden state (0/1 = full encoder)")
    p.add_argument("--guidance_rescale", type=float, default=0.0,
                   help="CFG rescale factor (arXiv:2305.08891; 0 = off)")
    p.add_argument("--fid_stats_path", type=str, default="./fid_stats.npz")
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--negative_prompt", type=str, default="",
                   help="CFG unconditional text (enter_prompt mode)")
    p.add_argument("--init_image", type=str, default="",
                   help="enter_prompt mode: path to an image → img2img")
    p.add_argument("--mask_image", type=str, default="",
                   help="with --init_image: a mask (white = regenerate) → "
                        "inpainting")
    p.add_argument("--strength", type=float, default=0.8,
                   help="img2img strength in (0,1]")
    p.add_argument("--control_image", type=str, default="",
                   help="enter_prompt mode: ControlNet conditioning image "
                        "(edges, depth, ...) for --controlnet_path; "
                        "comma-separated for multi-ControlNet (one per "
                        "branch)")
    p.add_argument("--refiner_ckpt", type=str, default="",
                   help="SDXL refiner checkpoint (either package's "
                        "checkpoint or a diffusers dir): ensemble-of-expert-denoisers serving, the "
                        "base runs the high-noise share, the refiner the "
                        "tail (diffusion/ensemble.py)")
    p.add_argument("--refiner_frac", type=float, default=0.8,
                   help="denoising handoff fraction for --refiner_ckpt "
                        "(base runs [0, frac), refiner [frac, 1])")
    p.add_argument("--controlnet_scale", type=_scale_list, default=1.0,
                   help="ControlNet residual multiplier; comma-separated "
                        "for one scale per branch")
    common.bool_flag(p, "prompt_weighting", False,
                     "the prompt-emphasis syntax ('(word:1.3)', '((up))', "
                     "'[down]') and long prompts over several CLIP windows")
    p.add_argument("--max_prompt_chunks", type=int, default=3,
                   help="with --prompt_weighting: max 77-token CLIP windows")
    p.add_argument("--samples_per_prompt", type=int, default=None,
                   help="images per prompt/template (grids default 2; "
                        "enter_prompt defaults 1)")
    p.add_argument("--wandb_key", type=str, default="")
    p.add_argument("--bart_ckpt", type=str, default="",
                   help="transformers BART dir (DistilBART-CNN: weights, "
                        "vocab.json, merges.txt) for --summarize")
    p.add_argument("--hires_scale", type=float, default=0.0,
                   help="enter_prompt mode: hires-fix — compose at "
                        "img_size/scale, upscale, finish with a strength-"
                        "bounded img2img pass at full size (0 = off)")
    p.add_argument("--hires_strength", type=float, default=0.7,
                   help="second-stage img2img strength for --hires_scale")
    p.add_argument("--hires_steps", type=int, default=0,
                   help="second-stage grid size (0 = --num_inference_steps)")
    p.add_argument("--hires_mode", type=str, default="latent",
                   choices=["latent", "image"],
                   help="'latent' resizes the raw first-pass latents, "
                        "'image' decodes, upscales pixels and re-encodes")
    common.bool_flag(p, "karras_sigmas", False,
                     "the Karras et al. 2022 rho=7 sigma grid "
                     "(euler_a/lms/dpm/dpm_sde/heun)")
    p.add_argument("--safety_checker", type=str, default="",
                   help="diffusers safety_checker dir: run the CLIP-vision "
                        "StableDiffusionSafetyChecker on decoded images "
                        "(flagged images are blacked out; default off, as "
                        "in the reference)")
    p.add_argument("--freeu", type=str, default="",
                   help="FreeU (arXiv:2309.11497): 'auto' picks the "
                        "family preset, or 4 comma-separated floats "
                        "b1,b2,s1,s2")
    p.add_argument("--cfg_interval", type=str, default="",
                   help="classifier-free guidance only on the steps in "
                        "[lo,hi) grid fractions, e.g. '0.0,0.7' "
                        "(arXiv:2404.07724)")
    p.add_argument("--cache_interval", type=int, default=0,
                   help=">1: DeepCache-style fast sampling")
    p.add_argument("--cache_tail", type=int, default=0,
                   help="DeepCache: trailing ResNets run fresh on cached "
                        "steps (0 = conservative default)")
    p.add_argument("--tp", type=int, default=0,
                   help="multi-device serving: 0 = one device (default); "
                        ">=1 lays a (data x model=tp) mesh over the ranks "
                        "(one process per card, cli/common.py "
                        "maybe_init_distributed), shards the batch over "
                        "`data` and, for tp>1, the weights Megatron-style "
                        "over `model` (parallel/specs.py)")
    common.bool_flag(p, "spatial", False,
                     "row-sharded serving (not ported yet: ROADMAP Queue "
                     "1 item 5.2)")
    common.bool_flag(p, "batch_generate", True)
    # tri-state: unset → the default mode renders the summarize grid when
    # its inputs are there and skips it otherwise; --summarize forces it
    # (missing inputs are an error); --no-summarize drops it
    p.add_argument("--summarize", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="summarize book descriptions into prompts (needs "
                        "--bart_ckpt; the default mode renders it when its "
                        "inputs are there, reference inference.py:463-466)")
    p.add_argument("--include_desc", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="append book descriptions to prompts (needs "
                        "df_test.csv under --data_root; default mode "
                        "auto-runs it when available)")
    return p


def _resolve_freeu(args, cfg):
    """--freeu '' → None; 'auto' → the family preset of the RESOLVED config
    (a checkpoint overrides --model_family): SDXL, v-prediction (SD-2.1)
    or SD-1.5; 'b1,b2,s1,s2' → tuple."""
    from sdbc_tpu_torch.models import unet as unet_mod

    spec = (args.freeu or "").strip()
    if not spec:
        return None
    if spec == "auto":
        if cfg.is_sdxl:
            return unet_mod.FREEU_SDXL
        if cfg.schedule.prediction_type == "v_prediction":
            return unet_mod.FREEU_SD21
        return unet_mod.FREEU_SD15
    try:
        vals = tuple(float(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(f"--freeu must be 'auto' or 4 comma-separated "
                         f"floats, got {spec!r}")
    if len(vals) != 4:
        raise SystemExit(f"--freeu takes 4 values b1,b2,s1,s2, got "
                         f"{len(vals)}")
    return vals


def _resolve_cfg_interval(args):
    """--cfg_interval '' → None; 'lo,hi' → (float, float)."""
    spec = (args.cfg_interval or "").strip()
    if not spec:
        return None
    try:
        vals = tuple(float(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(f"--cfg_interval must be 2 comma-separated step "
                         f"fractions lo,hi, got {spec!r}")
    if len(vals) != 2 or not 0.0 <= vals[0] <= vals[1] <= 1.0:
        raise SystemExit(f"--cfg_interval takes 0 <= lo <= hi <= 1, got "
                         f"{spec!r}")
    return vals


def build_summarizer(args):
    """``--bart_ckpt``'s DistilBART as a ``models.bart.Summarizer`` on
    ``--device`` in fp32 (DistilBART-CNN-12-6's config, as the JAX CLI
    fixes it), with the dir's byte-level BPE tables (checked before the
    weights are read)."""
    from sdbc_tpu_torch.data.bart_tokenizer import BartTokenizer
    from sdbc_tpu_torch.models import bart
    from sdbc_tpu_torch.models.convert import load_jax_params
    from sdbc_tpu_torch.models.port import load_state_dict, port_bart

    for fname in ("vocab.json", "merges.txt"):
        if not os.path.exists(os.path.join(args.bart_ckpt, fname)):
            raise SystemExit(f"--summarize needs vocab.json + merges.txt in "
                             f"{args.bart_ckpt} (missing {fname})")
    model = load_jax_params(
        bart.init(bart.BartConfig.distilbart_cnn(),
                  device=common.resolve_device(args)),
        port_bart(load_state_dict(args.bart_ckpt))).requires_grad_(False)
    return bart.Summarizer(model, BartTokenizer.from_pretrained(
        args.bart_ckpt))


def make_safety_checker(args):
    """``--safety_checker``'s ``ClipSafetyChecker`` on ``--device``, or
    None."""
    if not args.safety_checker:
        return None
    from sdbc_tpu_torch.models.port import safety_checker_from_dir
    from sdbc_tpu_torch.models.safety import ClipSafetyChecker

    tree, sc_cfg = safety_checker_from_dir(args.safety_checker)
    print(f"safety checker: {args.safety_checker} (ViT {sc_cfg.layers}x"
          f"{sc_cfg.hidden} @ {sc_cfg.image_size})")
    return ClipSafetyChecker(tree, sc_cfg, device=args.device)


def make_ensemble(args, pipe):
    """``--refiner_ckpt``: the base ``pipe`` and the refiner as an
    ``EnsemblePipeline`` handing over at ``--refiner_frac``."""
    from sdbc_tpu_torch.diffusion.ensemble import EnsemblePipeline
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline

    rf_models, rf_cfg = common.resolve_refiner(args, pipe.cfg.scheduler)
    rf_pipe = SDPipeline(rf_models, rf_cfg, pipe.tokenizer,
                         device=args.device,
                         compute_dtype=common.compute_dtype(args),
                         tokenizer2=common.make_tokenizer2(args, rf_cfg))
    print(f"ensemble serving: refiner {args.refiner_ckpt} takes over at "
          f"{args.refiner_frac:.0%} of the denoising run")
    return EnsemblePipeline(pipe, rf_pipe, handoff=args.refiner_frac)


def profile_spec(args, cfg):
    """The one sampling-profile ``SampleSpec`` of the flags, shared by
    every mode."""
    from sdbc_tpu_torch.diffusion.spec import SampleSpec

    return SampleSpec(
        cache_interval=args.cache_interval, cache_tail=args.cache_tail,
        use_karras_sigmas=args.karras_sigmas,
        freeu=_resolve_freeu(args, cfg),
        cfg_interval=_resolve_cfg_interval(args),
        guidance_rescale=args.guidance_rescale, clip_skip=args.clip_skip)


def _enter_prompt(args, pipe, spec, save_dir):
    if not args.prompt:
        raise SystemExit("--prompt is required with --mode enter_prompt")
    if args.mask_image and not args.init_image:
        raise SystemExit("--mask_image (inpainting) requires --init_image")
    init_image = mask_image = control_image = None
    if args.init_image:
        from PIL import Image

        if not os.path.exists(args.init_image):
            raise SystemExit(f"--init_image {args.init_image} not found")
        init_image = Image.open(args.init_image)
        if args.mask_image:
            if not os.path.exists(args.mask_image):
                raise SystemExit(f"--mask_image {args.mask_image} not found")
            mask_image = Image.open(args.mask_image)
    if args.control_image:
        from PIL import Image

        paths = [c for c in args.control_image.split(",") if c]
        for one in paths:
            if not os.path.exists(one):
                raise SystemExit(f"--control_image {one} not found")
        # comma-separated: one image per --controlnet_path branch
        control_image = ([Image.open(one) for one in paths]
                         if len(paths) > 1 else Image.open(paths[0]))
    spec = spec.replace(
        height=args.img_size, width=args.img_size,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, seed=args.seed,
        negative_prompt=args.negative_prompt or None,
        num_images_per_prompt=args.samples_per_prompt,
        control_image=control_image, controlnet_scale=args.controlnet_scale,
        prompt_weighting=args.prompt_weighting,
        max_prompt_chunks=args.max_prompt_chunks)
    if args.hires_scale:
        if init_image is not None:
            raise SystemExit("--hires_scale drives both stages itself and "
                             "cannot combine with --init_image (use "
                             "--strength img2img instead)")
        from sdbc_tpu_torch.diffusion.ensemble import EnsemblePipeline

        if isinstance(pipe, EnsemblePipeline):
            raise SystemExit("--hires_scale is not wired up for "
                             "--refiner_ckpt ensemble serving (the refiner "
                             "already runs a tail pass)")
        spec = spec.replace(hires_scale=args.hires_scale,
                            hires_strength=args.hires_strength,
                            hires_steps=args.hires_steps,
                            hires_mode=args.hires_mode)
    else:
        spec = spec.replace(init_image=init_image, strength=args.strength,
                            mask_image=mask_image)
    import numpy as np

    from sdbc_tpu_torch.utils import png

    imgs = pipe.generate([args.prompt], spec)
    if not common.is_root():
        return
    # prompt text becomes a filename: strip path separators
    stem = re.sub(r"[/\\\0]", "_", args.prompt)[:64] or "prompt"
    for i, im in enumerate(imgs):
        suffix = f"-{i}" if len(imgs) > 1 else ""
        out = os.path.join(save_dir, f"{stem}{suffix}.png")
        # numpy_to_pil's rounding, encoded by utils/png.py (no PIL)
        with open(out, "wb") as f:
            f.write(png.encode(np.uint8(np.round(im * 255.0))))
        print(f"saved {out}")


def _calc_fid(args, pipe, spec, save_dir):
    import torch

    from sdbc_tpu_torch.data.dataset import read_csv_rows
    from sdbc_tpu_torch.eval.fid import calculate_fid_given_paths
    from sdbc_tpu_torch.eval.generate import get_fid_images
    from sdbc_tpu_torch.models.inception import InceptionConfig

    # validate the stats path BEFORE hours of image generation
    if not os.path.exists(args.fid_stats_path):
        raise SystemExit(f"{args.fid_stats_path} not found — run python -m "
                         "sdbc_tpu_torch.cli.precalc_fid_stats first")
    rows = read_csv_rows(os.path.join(args.data_root, "df_test.csv"))
    get_fid_images(pipe, save_dir, rows, num_imgs=args.num_imgs,
                   batch_size=args.batch_size, img_size=args.img_size,
                   inference_steps=args.num_inference_steps,
                   guidance_scale=args.guidance_scale, seed=args.seed,
                   prompt_bank=args.prompt_bank, spec=spec,
                   save=common.is_root())
    if not common.is_root():
        return
    icfg = InceptionConfig.tiny() if args.tiny else InceptionConfig.fid()
    fid = calculate_fid_given_paths((save_dir, args.fid_stats_path),
                                    cfg=icfg, image_size=args.img_size,
                                    verbose=True, device=pipe.device)
    print(f"FID: {fid:.4f}")
    with open(os.path.join(save_dir, "fid_score.txt"), "w") as f:
        f.write(f"{fid}\n")
    if pipe.device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(pipe.device)
        print(f"peak device memory: {peak / 2**30:.2f} GiB")


def _default_grids(args, pipe, spec, save_dir):
    from sdbc_tpu_torch.eval.visualize import visualize_prompts

    root = common.is_root()
    if root:
        with open(os.path.join(save_dir, "hyperparams.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)
    test_csv = os.path.join(args.data_root, "df_test.csv")
    want_desc = args.include_desc is not False
    want_sum = args.summarize is not False and args.include_desc is not False
    if args.include_desc and not os.path.exists(test_csv):
        raise SystemExit(f"--include_desc needs {test_csv}")
    # an explicit --summarize forces the config: missing inputs are an
    # error, not a skip
    if args.summarize and not args.bart_ckpt:
        raise SystemExit("--summarize needs --bart_ckpt")
    if args.summarize and args.include_desc is False:
        raise SystemExit("--summarize summarizes book descriptions; it "
                         "cannot combine with --no-include_desc")
    if args.summarize and not os.path.exists(test_csv):
        raise SystemExit(f"--summarize needs {test_csv} (source of the "
                         "descriptions)")
    have_desc = want_desc and os.path.exists(test_csv)
    have_sum = want_sum and bool(args.bart_ckpt) and have_desc
    if args.prompt_bank == "reference" and not os.path.exists(test_csv):
        # the reference grid interpolates (author, title) df_test rows
        raise SystemExit(f"--prompt_bank reference needs {test_csv}")
    summarizer, descriptions, rows = None, None, None
    if have_desc or args.prompt_bank == "reference":
        from sdbc_tpu_torch.data.dataset import read_csv_rows

        rows = read_csv_rows(test_csv)
        n_desc = max(16, args.samples_per_prompt)
        descriptions = [str(r["book_desc"]) for _, r in rows[:n_desc]]
    if have_sum:
        summarizer = build_summarizer(args)
    # the reference's default mode renders (summarize, include_desc) =
    # (F,F), (T,T), (F,T) (inference.py:458-471); a config whose inputs
    # are missing is skipped with a log
    configs = [(False, False)]
    if have_sum:
        configs.append((True, True))
    elif want_sum:
        print("skipping summarize grid config (needs --bart_ckpt and "
              "df_test.csv)")
    if have_desc:
        configs.append((False, True))
    elif want_desc:
        print(f"skipping include_desc grid config (no {test_csv})")
    for summarize, include_desc in configs:
        prompts_override = None
        if args.prompt_bank == "reference":
            import random as _random

            from sdbc_tpu_torch.data import templates as tmpl

            head = rows[:args.samples_per_prompt]
            pairs = [(str(r["book_authors"]), str(r["book_title"]))
                     for _, r in head]
            descs = None
            if summarize:
                descs = [summarizer(d, max_length=15)
                         for d in descriptions[:args.samples_per_prompt]]
            elif include_desc:
                descs = descriptions[:args.samples_per_prompt]
            prompts_override = tmpl.reference_grid_prompts(
                pairs, args.samples_per_prompt, include_desc=include_desc,
                descriptions=descs, rng=_random.Random(args.seed))
        _, _, path = visualize_prompts(
            pipe, summarize=summarize, include_desc=include_desc,
            summarizer=summarizer, descriptions=descriptions,
            samples_per_prompt=args.samples_per_prompt,
            img_size=args.img_size, inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale,
            batch_generate=args.batch_generate, batch_size=args.batch_size,
            save_dir=save_dir if root else None, seed=args.seed,
            prompts_override=prompts_override, spec=spec,
            # keep native- and reference-bank grids apart in one save_dir
            name_suffix=("" if args.prompt_bank == "native"
                         else f",bank={args.prompt_bank}"))
        if root:
            print(f"grid saved: {path}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.refuse_unported(args)
    common.resolve_img_size(args)
    if args.samples_per_prompt is None:
        args.samples_per_prompt = 1 if args.mode == "enter_prompt" else 2
    if args.controlnet_scale != 1.0 and not args.control_image:
        raise SystemExit("--controlnet_scale scales the residuals of a "
                         "ControlNet's --control_image, and none is given")
    with common.distributed(args, args.tp, args.tp >= 1) as mesh:
        _main(args, mesh)


def _main(args, mesh):
    """Every rank runs the same calls (the pipeline's collectives); rank 0
    alone writes."""
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline

    models, cfg = common.resolve_params_cfg(args)
    if args.control_image and cfg.controlnet is None:
        raise SystemExit("--control_image needs a ControlNet: pass "
                         "--controlnet_path or a --ckpt from a "
                         "--train_controlnet run")
    tok = common.make_tokenizer(args, cfg.clip.vocab_size)
    pipe = SDPipeline(models, cfg, tok, device=args.device,
                      compute_dtype=common.compute_dtype(args),
                      safety_checker=make_safety_checker(args),
                      tokenizer2=common.make_tokenizer2(args, cfg),
                      mesh=mesh)
    if args.refiner_ckpt:
        pipe = make_ensemble(args, pipe)
    save_dir = os.path.join(args.save_dir, f"{args.run_id} inference")
    if common.is_root():
        os.makedirs(save_dir, exist_ok=True)
    spec = profile_spec(args, cfg)
    if args.mode == "enter_prompt":
        _enter_prompt(args, pipe, spec, save_dir)
    elif args.mode == "calc_fid":
        _calc_fid(args, pipe, spec, save_dir)
    else:
        _default_grids(args, pipe, spec, save_dir)


if __name__ == "__main__":
    main()
