"""Inference CLI (counterpart of ``sdbc_tpu/cli/inference.py``): modes
default / calc_fid / enter_prompt, on the card unless ``--device cpu``.

    python -m sdbc_tpu_torch.cli.inference --mode calc_fid \\
        --diffusers_ckpt ./sd15 --fid_stats_path ./fid_stats.npz

  default      the prompt-grid configurations with fixed latents
  calc_fid     generate --num_imgs covers over df_test + FID vs --fid_stats_path
  enter_prompt one custom prompt → PNG (img2img, inpainting, hires-fix)

Every sampling-profile flag goes through one ``SampleSpec``.  Flags of
features not ported yet exit with a message (``common.refuse_unported``).
PIL and pandas are imported only where files are read or written.
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
                   help="ControlNet conditioning image (not ported yet)")
    p.add_argument("--refiner_ckpt", type=str, default="",
                   help="SDXL refiner checkpoint (not ported yet)")
    p.add_argument("--refiner_frac", type=float, default=0.8,
                   help="denoising handoff fraction for --refiner_ckpt")
    p.add_argument("--controlnet_scale", type=_scale_list, default=1.0,
                   help="ControlNet residual multiplier (not ported yet)")
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
                   help="BART dir for --summarize (not ported yet)")
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
                   help="diffusers safety_checker dir (not ported yet)")
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
                   help="multi-device serving (not ported yet)")
    common.bool_flag(p, "spatial", False,
                     "row-sharded serving (not ported yet)")
    common.bool_flag(p, "batch_generate", True)
    p.add_argument("--summarize", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="summarize book descriptions (not ported yet; "
                        "--no-summarize is accepted)")
    p.add_argument("--include_desc", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="append book descriptions to prompts (needs "
                        "df_test.csv under --data_root; default mode "
                        "auto-runs it when available)")
    return p


def _resolve_freeu(args, cfg):
    """--freeu '' → None; 'auto' → the family preset; 'b1,b2,s1,s2' → tuple."""
    from sdbc_tpu_torch.models import unet as unet_mod

    spec = (args.freeu or "").strip()
    if not spec:
        return None
    if spec == "auto":
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
    init_image = mask_image = None
    if args.init_image:
        from PIL import Image

        if not os.path.exists(args.init_image):
            raise SystemExit(f"--init_image {args.init_image} not found")
        init_image = Image.open(args.init_image)
        if args.mask_image:
            if not os.path.exists(args.mask_image):
                raise SystemExit(f"--mask_image {args.mask_image} not found")
            mask_image = Image.open(args.mask_image)
    spec = spec.replace(
        height=args.img_size, width=args.img_size,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, seed=args.seed,
        negative_prompt=args.negative_prompt or None,
        num_images_per_prompt=args.samples_per_prompt,
        prompt_weighting=args.prompt_weighting,
        max_prompt_chunks=args.max_prompt_chunks)
    if args.hires_scale:
        if init_image is not None:
            raise SystemExit("--hires_scale drives both stages itself and "
                             "cannot combine with --init_image (use "
                             "--strength img2img instead)")
        spec = spec.replace(hires_scale=args.hires_scale,
                            hires_strength=args.hires_strength,
                            hires_steps=args.hires_steps,
                            hires_mode=args.hires_mode)
    else:
        spec = spec.replace(init_image=init_image, strength=args.strength,
                            mask_image=mask_image)
    pils = pipe.numpy_to_pil(pipe.generate([args.prompt], spec))
    # prompt text becomes a filename: strip path separators
    stem = re.sub(r"[/\\\0]", "_", args.prompt)[:64] or "prompt"
    for i, im in enumerate(pils):
        suffix = f"-{i}" if len(pils) > 1 else ""
        out = os.path.join(save_dir, f"{stem}{suffix}.png")
        im.save(out)
        print(f"saved {out}")


def _calc_fid(args, pipe, spec, save_dir):
    import pandas as pd
    import torch

    from sdbc_tpu_torch.eval.fid import calculate_fid_given_paths
    from sdbc_tpu_torch.eval.generate import get_fid_images
    from sdbc_tpu_torch.models.inception import InceptionConfig

    # validate the stats path BEFORE hours of image generation
    if not os.path.exists(args.fid_stats_path):
        raise SystemExit(f"{args.fid_stats_path} not found — run python -m "
                         "sdbc_tpu_torch.cli.precalc_fid_stats first")
    df_test = pd.read_csv(os.path.join(args.data_root, "df_test.csv"),
                          index_col=0)
    get_fid_images(pipe, save_dir, df_test, num_imgs=args.num_imgs,
                   batch_size=args.batch_size, img_size=args.img_size,
                   inference_steps=args.num_inference_steps,
                   guidance_scale=args.guidance_scale, seed=args.seed,
                   prompt_bank=args.prompt_bank, spec=spec)
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

    with open(os.path.join(save_dir, "hyperparams.json"), "w") as f:
        json.dump(vars(args), f, indent=2, default=str)
    test_csv = os.path.join(args.data_root, "df_test.csv")
    want_desc = args.include_desc is not False
    if args.include_desc and not os.path.exists(test_csv):
        raise SystemExit(f"--include_desc needs {test_csv}")
    have_desc = want_desc and os.path.exists(test_csv)
    if args.prompt_bank == "reference" and not os.path.exists(test_csv):
        # the reference grid interpolates (author, title) df_test rows
        raise SystemExit(f"--prompt_bank reference needs {test_csv}")
    descriptions, df_test = None, None
    if have_desc or args.prompt_bank == "reference":
        import pandas as pd

        df_test = pd.read_csv(test_csv, index_col=0)
        n_desc = max(16, args.samples_per_prompt)
        descriptions = [str(d) for d in df_test["book_desc"].head(n_desc)]
    # the reference's default mode renders (summarize, include_desc) =
    # (F,F), (T,T), (F,T) (inference.py:458-471); the summarizer is not
    # ported, so (T,T) is skipped with a log
    configs = [(False, False)]
    if args.summarize is not False and want_desc:
        print("skipping summarize grid config (the BART summarizer is not "
              "ported yet)")
    if have_desc:
        configs.append((False, True))
    elif want_desc:
        print(f"skipping include_desc grid config (no {test_csv})")
    for summarize, include_desc in configs:
        prompts_override = None
        if args.prompt_bank == "reference":
            import random as _random

            from sdbc_tpu_torch.data import templates as tmpl

            head = df_test.head(args.samples_per_prompt)
            rows = [(str(r["book_authors"]), str(r["book_title"]))
                    for _, r in head.iterrows()]
            descs = (descriptions[:args.samples_per_prompt] if include_desc
                     else None)
            prompts_override = tmpl.reference_grid_prompts(
                rows, args.samples_per_prompt, include_desc=include_desc,
                descriptions=descs, rng=_random.Random(args.seed))
        _, _, path = visualize_prompts(
            pipe, summarize=summarize, include_desc=include_desc,
            descriptions=descriptions,
            samples_per_prompt=args.samples_per_prompt,
            img_size=args.img_size, inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale,
            batch_generate=args.batch_generate, batch_size=args.batch_size,
            save_dir=save_dir, seed=args.seed,
            prompts_override=prompts_override, spec=spec,
            # keep native- and reference-bank grids apart in one save_dir
            name_suffix=("" if args.prompt_bank == "native"
                         else f",bank={args.prompt_bank}"))
        print(f"grid saved: {path}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.refuse_unported(args)
    common.resolve_img_size(args)
    if args.samples_per_prompt is None:
        args.samples_per_prompt = 1 if args.mode == "enter_prompt" else 2
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline

    models, cfg = common.resolve_params_cfg(args)
    pipe = SDPipeline(models, cfg,
                      common.make_tokenizer(args, cfg.clip.vocab_size),
                      device=args.device,
                      compute_dtype=common.compute_dtype(args))
    save_dir = os.path.join(args.save_dir, f"{args.run_id} inference")
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
