"""SDPipeline — the host-side serving object (counterpart of
``sdbc_tpu/diffusion/pipeline.py``): tokenization (plain or weighted,
``data/prompt_weights.py``), batch buckets, latents, img2img / inpaint
inputs (the dedicated inpainting UNet's masked image too), ControlNet
images and the sampling options around ``graph.sample``, for SD-1.x,
SD-2.x and SDXL (both tokenizers, the refiner's aesthetic scores);
``generate`` serves a ``SampleSpec`` (``diffusion/spec.py``), ``hires``
the two-stage hires-fix.  The SDXL base → refiner ensemble is
``diffusion/ensemble.py``."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sdbc_tpu_torch.diffusion.graph import (  # noqa: F401  (re-export)
    COMPONENT_INITS, PipelineConfig, img2img_t_start, init_models,
    model_configs, preprocess_image, preprocess_mask, sample)
from sdbc_tpu_torch.models import controlnet as controlnet_mod
from sdbc_tpu_torch.models.convert import load_jax_params
from sdbc_tpu_torch.models.safety import apply_safety_checker
from sdbc_tpu_torch.utils.image import resize


def as_modules(params_or_modules: dict, cfg: PipelineConfig, device) -> dict:
    """The components of ``graph.model_configs(cfg)``: modules as given, or
    modules built from JAX parameter trees (nested numpy, see
    ``models.convert``) kept in fp32 like the JAX masters; with
    ``cfg.controlnet`` also a "controlnet" entry, one branch or a list.
    Other entries (a refiner tree's absent text encoder) are not
    taken."""
    out = {}
    if cfg.controlnet is not None and "controlnet" in params_or_modules:
        value = params_or_modules["controlnet"]
        cns = [m if isinstance(m, torch.nn.Module) else load_jax_params(
            controlnet_mod.init(cfg.controlnet, device=device), m)
            for m in controlnet_mod.branches(value)]
        cns = [m.requires_grad_(False) for m in cns]
        out["controlnet"] = cns if isinstance(value, (list, tuple)) \
            else cns[0]
    for name, sub in model_configs(cfg).items():
        if name not in params_or_modules:
            raise KeyError(f"{name} is missing: a "
                           f"{'refiner' if cfg.refiner else 'pipeline'} "
                           f"config runs {sorted(model_configs(cfg))}")
        value = params_or_modules[name]
        if not isinstance(value, torch.nn.Module):
            value = load_jax_params(
                COMPONENT_INITS[name](sub, device=device), value)
        out[name] = value.requires_grad_(False)
    return out


def _per_image(arr, b: int, what: str):
    """One array (numpy or tensor) for every requested image: a single one
    is repeated."""
    if arr.shape[0] == 1 and b > 1:
        arr = (arr.expand(b, *arr.shape[1:]) if torch.is_tensor(arr)
               else np.tile(arr, (b,) + (1,) * (arr.ndim - 1)))
    if arr.shape[0] != b:
        raise ValueError(f"{arr.shape[0]} {what} for {b} requested images "
                         "(pass 1, or one per image)")
    return arr


def _pad_to(arr: np.ndarray, n: int, fill: float) -> np.ndarray:
    """``arr`` padded along the batch with ``fill`` up to ``n`` rows."""
    if arr.shape[0] >= n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, np.float32)
    return np.concatenate([arr, pad], axis=0)


class SDPipeline:
    """Tokenize → ``sample`` → numpy images, the diffusers-pipeline shape.
    Runs on the card unless the caller passes ``device="cpu"``.
    ``attn_impl``: force the UNet's attention implementation ("xla",
    ...; ``ops.attention``) instead of the sampling dispatch "inference".
    The scheduler is ``cfg.scheduler`` (``graph.SCHEDULERS``).
    ``safety_checker``: an optional ``checker(images, prompts) -> (images,
    flags)`` (``models/safety.py``) run on the requested decoded images
    only; its flags are kept in ``last_nsfw_flags``.  ``tokenizer2``: SDXL's
    second (bigG) tokenizer; without one the first serves both (their BPE
    tables match; only the pad id differs, which bigG ignores past the
    end token).

    ``mesh`` (``parallel.make_mesh``): serving over several ranks, every
    rank calling the pipeline alike.  The batch bucket rounds up to a
    multiple of the data axis; each data rank samples its rows of the
    global batch from the global draws (the latents and every stochastic
    draw are drawn for the whole batch on every rank, then cut) and the
    images are gathered over the data group, so every rank returns the
    global result.  A ``model`` axis > 1 cuts the weights Megatron-style
    (``parallel.specs.tp_specs`` with ``validate_tp``'s exclusions): each
    rank computes with its heads and channels.  The weights are first
    broadcast from rank 0; modules given are broadcast and cut in place.
    ``spatial`` (row sharding) is not ported."""

    def __init__(self, params_or_modules: dict, cfg: PipelineConfig,
                 tokenizer, device="cuda", compute_dtype=torch.bfloat16,
                 attn_impl: Optional[str] = None, safety_checker=None,
                 tokenizer2=None, mesh=None, spatial: bool = False):
        if spatial:
            raise ValueError("spatial=True (latent rows sharded over the "
                             "data axis) is not ported yet: ROADMAP Queue "
                             "1 item 5.2")
        self.attn_impl = attn_impl or "inference"
        self.device = torch.device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.tokenizer2 = tokenizer2
        if cfg.is_sdxl and tokenizer2 is None:
            self.tokenizer2 = tokenizer
        self.compute_dtype = compute_dtype
        self.models = as_modules(params_or_modules, cfg, self.device)
        self.mesh = mesh
        if mesh is not None:
            from sdbc_tpu_torch.parallel import shard as shard_mod
            from sdbc_tpu_torch.parallel import specs as spec_mod
            from sdbc_tpu_torch.parallel.mesh import (mesh_shape,
                                                      replicate_tree)

            replicate_tree(self.models, mesh)
            m = mesh_shape(mesh)["model"]
            if m > 1:
                shard_mod.shard_modules(
                    self.models, mesh, tp=True,
                    exclude=spec_mod.validate_tp(cfg, m))
        self.safety_checker = safety_checker
        self.last_nsfw_flags = None

    def tokenize(self, prompts) -> torch.Tensor:
        ids = np.asarray(self.tokenizer.batch_encode(prompts,
                                                     self.cfg.clip.ctx),
                         np.int64)
        return torch.from_numpy(ids).to(self.device)

    def tokenize2(self, prompts) -> torch.Tensor:
        ids = np.asarray(self.tokenizer2.batch_encode(prompts,
                                                      self.cfg.clip2.ctx),
                         np.int64)
        return torch.from_numpy(ids).to(self.device)

    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

    def _latents(self, latents, b: int, height: int, width: int,
                 generator: torch.Generator,
                 bucket: Optional[int] = None) -> torch.Tensor:
        """Initial noise for ``bucket`` rows (default ``b``): drawn from
        ``generator``, or the given latents (at most ``b``) with the last
        one repeated."""
        bucket = b if bucket is None else bucket
        c = self.cfg.latent_channels
        if latents is None:
            f = self.cfg.vae_scale
            return torch.randn((bucket, height // f, width // f, c),
                               generator=generator, device=self.device,
                               dtype=torch.float32)
        lat = (latents if torch.is_tensor(latents)
               else torch.from_numpy(np.array(latents, np.float32)))
        if lat.ndim == 3:
            lat = lat[None]
        # accept torch-layout NCHW fixed latents (the parity protocol)
        if lat.shape[-1] != c and lat.shape[1] == c:
            lat = lat.permute(0, 2, 3, 1)
        if lat.shape[0] > b:
            # against the REQUESTED count, not the bucket: extra latents
            # would silently feed the padding rows
            raise ValueError(f"{lat.shape[0]} latents for {b} requested "
                             "images")
        if lat.shape[0] < bucket:
            lat = torch.cat([lat] + [lat[-1:]] * (bucket - lat.shape[0]),
                            dim=0)
        return lat.to(self.device, torch.float32).contiguous()

    def _encode_weighted(self, prompts, negative_prompt,
                         max_prompt_chunks: int):
        """Token ids and weights of both CFG branches
        (``batch_encode_weighted``) through each tokenizer (SDXL: both),
        all padded to one window count: [cond, cond_w, uncond, uncond_w]
        per tokenizer."""
        from sdbc_tpu_torch.data.prompt_weights import batch_encode_weighted

        ctx = self.cfg.clip.ctx
        toks = [self.tokenizer]
        if self.cfg.is_sdxl:
            toks.append(self.tokenizer2)
        probe = [batch_encode_weighted(tok, t, ctx, max_prompt_chunks)
                 for tok in toks for t in (prompts, negative_prompt)]
        k = max(ids.shape[1] // ctx for ids, _ in probe)
        out = []
        for tok in toks:
            for texts in (prompts, negative_prompt):
                ids, w = batch_encode_weighted(tok, texts, ctx,
                                               max_prompt_chunks,
                                               min_chunks=k)
                out += [torch.from_numpy(ids.astype(np.int64)).to(
                    self.device), torch.from_numpy(w).to(self.device)]
        return out

    def __call__(self, prompts, *, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 latents: Optional[np.ndarray] = None, seed: int = 42,
                 decode: bool = True, cache_interval: int = 0,
                 cache_tail: int = 0, negative_prompt=None,
                 num_images_per_prompt: int = 1, init_image=None,
                 init_latents=None, strength: float = 0.8, mask_image=None,
                 guidance_rescale: float = 0.0, clip_skip: int = 0,
                 use_karras_sigmas: bool = False, freeu=None,
                 cfg_interval=None, control_image=None,
                 controlnet_scale: float = 1.0,
                 prompt_weighting: bool = False, max_prompt_chunks: int = 3,
                 aesthetic_score: float = 6.0,
                 negative_aesthetic_score: float = 2.5,
                 denoising_start: Optional[float] = None,
                 denoising_end: Optional[float] = None,
                 draws: Optional[dict] = None) -> np.ndarray:
        """``negative_prompt``: str or per-prompt list encoded as the CFG
        unconditional branch instead of "".  ``latents``: NHWC or NCHW
        (e.g. ``utils.prng.per_sample_fixed_latents``); without them the
        initial noise is drawn from a ``torch.Generator`` seeded ``seed``,
        which then goes on to the sampler (stochastic schedulers,
        init_image's posterior draw); ``draws`` replaces the sampler's
        draws (``graph.sample``).  ``num_images_per_prompt``: each prompt
        repeated, with its own latents.

        The batch is padded up to the next of ``BATCH_BUCKETS`` (empty
        prompts, the last latent repeated, zero init images and latents,
        masks of ones) and only the requested images are returned.

        ``prompt_weighting=True``: the emphasis syntax "(word:1.3)",
        "((up))", "[down]" and long prompts over up to
        ``max_prompt_chunks`` 77-token windows (``data/prompt_weights.py``);
        both CFG branches are padded to one window count.

        ``init_image`` (PIL or array, ``preprocess_image``) is img2img: the
        image is VAE-encoded and noised to ``strength``'s start point, and
        the remaining steps run; ``latents`` are then the added noise.
        ``mask_image`` (white = regenerate, ``preprocess_mask``) also
        inpaints.  ``init_latents``: model-space latents (array or tensor)
        instead of an image.  ``denoising_end`` stops at round(n·end) (pair
        with decode=False); ``denoising_start`` resumes from handed-over
        ``latents`` at round(n·start).  ``aesthetic_score`` and
        ``negative_aesthetic_score`` condition a refiner (other configs
        ignore them, as the JAX package does).  With an inpainting UNet
        (``cfg.is_inpaint_unet``) ``init_image`` + ``mask_image`` go to the
        channel concat instead: the mask binarised at 0.5, masked pixels
        set to 0.5, a full denoise from the noise.  ``control_image``: a
        PIL image or array for the pipeline's ControlNet (one repeated
        over the batch, or one per image), or a list, one per branch;
        ``controlnet_scale`` a float or one per branch.  The other options
        are ``graph.sample``'s.
        Returns (B, H, W, 3) float32 numpy images in [0, 1], or the raw
        latents with decode=False."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if cfg_interval is not None and len(tuple(cfg_interval)) != 2:
            raise ValueError(f"cfg_interval takes exactly 2 floats (lo, hi "
                             f"step fractions), got {tuple(cfg_interval)}")
        if freeu is not None and len(tuple(freeu)) != 4:
            raise ValueError(f"freeu takes exactly 4 floats (b1, b2, s1, "
                             f"s2), got {tuple(freeu)}")
        if mask_image is not None and init_image is None:
            raise ValueError("mask_image (inpainting) requires init_image")
        if init_latents is not None and init_image is not None:
            raise ValueError("init_latents (latent-space img2img) and "
                             "init_image (pixel-space img2img) are mutually "
                             "exclusive")
        b = len(prompts)
        if negative_prompt is None:
            negative_prompt = [""] * b
        elif isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * b
        elif len(negative_prompt) != b:
            raise ValueError(f"{len(negative_prompt)} negative prompts for "
                             f"{b} prompts")
        if num_images_per_prompt > 1:
            rep = lambda xs: [x for x in xs for _ in
                              range(num_images_per_prompt)]
            prompts, negative_prompt = rep(prompts), rep(negative_prompt)
            b = len(prompts)
            if latents is not None and latents.shape[0] != b:
                raise ValueError("explicit latents must be batched to "
                                 "prompts*num_images_per_prompt (identical "
                                 "latents would yield identical images)")
        # pad a ragged batch up to a bucket: a few batch shapes instead of
        # one per batch size
        bucket = next((s for s in self.BATCH_BUCKETS if s >= b), b)
        if self.mesh is not None:
            # a multiple of the data axis: the batch always shards
            from sdbc_tpu_torch.parallel.mesh import mesh_shape

            n = mesh_shape(self.mesh)["data"]
            bucket = -(-bucket // n) * n
        prompts = list(prompts) + [""] * (bucket - b)
        negative_prompt = list(negative_prompt) + [""] * (bucket - b)
        if denoising_start is not None and latents is None:
            raise ValueError("denoising_start requires latents= (the base "
                             "stage's decode=False output)")
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        lat = self._latents(latents, b, height, width, gen, bucket)

        t_start, t_end = 0, None
        if denoising_end is not None:
            if not 0.0 < denoising_end <= 1.0:
                raise ValueError(f"denoising_end must be in (0, 1], got "
                                 f"{denoising_end}")
            t_end = int(round(num_inference_steps * denoising_end))
        if denoising_start is not None:
            if init_image is not None or init_latents is not None:
                raise ValueError("denoising_start resumes from raw handed-"
                                 "over latents; it cannot combine with "
                                 "init_image/init_latents (use strength for "
                                 "img2img)")
            if not 0.0 <= denoising_start < 1.0:
                raise ValueError(f"denoising_start must be in [0, 1), got "
                                 f"{denoising_start}")
            t_start = int(round(num_inference_steps * denoising_start))
        img_arr = mask_arr = lat_init = masked_arr = None
        f = self.cfg.vae_scale
        if init_image is not None:
            img_arr = _pad_to(_per_image(
                preprocess_image(init_image, height, width), b,
                "init images"), bucket, 0.0)
            if mask_image is not None and self.cfg.is_inpaint_unet:
                # the image conditions the UNet through its masked VAE
                # latent: masked pixels set to 0.5 (diffusers' 0 in
                # [-1, 1]) under the pixel mask binarised at 0.5
                pm = _pad_to(_per_image(
                    preprocess_mask(mask_image, height, width), b, "masks"),
                    img_arr.shape[0], 1.0)
                pm = (pm >= 0.5).astype(np.float32)
                masked_arr = img_arr * (1.0 - pm) + 0.5 * pm
                img_arr = None  # no re-noising
            else:
                t_start = img2img_t_start(num_inference_steps, strength,
                                          self.cfg.schedule.steps_offset)
            if mask_image is not None:
                mask_arr = _pad_to(_per_image(
                    preprocess_mask(mask_image, height // f, width // f), b,
                    "masks"), bucket, 1.0)
                if masked_arr is not None:
                    mask_arr = (mask_arr >= 0.5).astype(np.float32)
        elif self.cfg.is_inpaint_unet:
            raise ValueError("this checkpoint is a dedicated inpainting "
                             "UNet (conv_in takes mask + masked-image "
                             "channels): pass init_image + mask_image — "
                             "plain text-to-image is undefined for it")
        if init_latents is not None:
            lat_init = (init_latents if torch.is_tensor(init_latents)
                        else torch.from_numpy(np.array(init_latents,
                                                       np.float32))).to(
                self.device, torch.float32)
            want = (height // f, width // f, self.cfg.latent_channels)
            if tuple(lat_init.shape[1:]) != want:
                raise ValueError(
                    f"init_latents shape {tuple(lat_init.shape[1:])} does "
                    f"not match the requested {height}x{width} latent grid "
                    f"{want}")
            lat_init = _per_image(lat_init, b, "init latents")
            if bucket > b:
                lat_init = torch.cat([lat_init, lat_init.new_zeros(
                    (bucket - b,) + want)], dim=0)
            t_start = img2img_t_start(num_inference_steps, strength,
                                      self.cfg.schedule.steps_offset)
        ctrl = None
        if control_image is not None:
            def prep_ctrl(img):
                return torch.from_numpy(_pad_to(_per_image(
                    preprocess_image(img, height, width), b,
                    "control images"), bucket, 0.0)).to(self.device)

            # a list: one image per branch (multi-ControlNet)
            ctrl = ([prep_ctrl(c) for c in control_image]
                    if isinstance(control_image, (list, tuple))
                    else prep_ctrl(control_image))
        cond2 = uncond2 = cond_w2 = uncond_w2 = None
        if prompt_weighting:
            enc = self._encode_weighted(prompts, negative_prompt,
                                        max_prompt_chunks)
            cond, cond_w, uncond, uncond_w = enc[:4]
            if self.cfg.is_sdxl:
                cond2, cond_w2, uncond2, uncond_w2 = enc[4:]
        else:
            cond, uncond = self.tokenize(prompts), self.tokenize(
                negative_prompt)
            cond_w = uncond_w = None
            if self.cfg.is_sdxl:
                cond2 = self.tokenize2(prompts)
                uncond2 = self.tokenize2(negative_prompt)
        on_device = lambda a: None if a is None \
            else torch.from_numpy(a).to(self.device)
        rows = None
        if self.mesh is not None:
            # this rank's rows of every batch input; the draws inside
            # ``sample`` are cut the same way
            from sdbc_tpu_torch.parallel.mesh import host_local_batch_indices

            idx = host_local_batch_indices(bucket, self.mesh)
            rows = (idx, bucket)
            cut = lambda a: None if a is None else (
                [cut(x) for x in a] if isinstance(a, list)
                else a[torch.from_numpy(idx).to(a.device)]
                if torch.is_tensor(a) else a[idx])
            cond, uncond, lat, lat_init, ctrl = map(
                cut, (cond, uncond, lat, lat_init, ctrl))
            cond_w, uncond_w, cond2, uncond2, cond_w2, uncond_w2 = map(
                cut, (cond_w, uncond_w, cond2, uncond2, cond_w2, uncond_w2))
            img_arr, mask_arr, masked_arr = map(
                cut, (img_arr, mask_arr, masked_arr))
        out = sample(self.models, cond, uncond, lat,
                     float(guidance_scale), cfg=self.cfg,
                     num_inference_steps=num_inference_steps,
                     compute_dtype=self.compute_dtype, decode=decode,
                     cache_interval=cache_interval, cache_tail=cache_tail,
                     attn_impl=self.attn_impl, init_image=on_device(img_arr),
                     init_latents=lat_init, t_start=t_start,
                     t_end=t_end, mask=on_device(mask_arr),
                     guidance_rescale=float(guidance_rescale),
                     clip_skip=int(clip_skip),
                     use_karras_sigmas=bool(use_karras_sigmas),
                     freeu=tuple(float(v) for v in freeu) if freeu else None,
                     cfg_interval=tuple(float(v) for v in cfg_interval)
                     if cfg_interval is not None else None,
                     cond_weights=cond_w, uncond_weights=uncond_w,
                     cond_ids2=cond2, uncond_ids2=uncond2,
                     cond_weights2=cond_w2, uncond_weights2=uncond_w2,
                     aesthetic_score=float(aesthetic_score),
                     negative_aesthetic_score=float(
                         negative_aesthetic_score),
                     masked_image=on_device(masked_arr), control_image=ctrl,
                     controlnet_scale=controlnet_scale,
                     generator=gen, draws=draws, rows=rows)
        if self.mesh is not None:
            from sdbc_tpu_torch.parallel import comm

            out = comm.all_gather(out.contiguous(),
                                  self.mesh.get_group("data"), dim=0)
        out = out[:b].float().cpu().numpy()
        if decode and self.safety_checker is not None:
            out, self.last_nsfw_flags = apply_safety_checker(
                self.safety_checker, out, prompts[:b])
        return out

    def generate(self, prompts, spec):
        """Serve one ``SampleSpec`` (``diffusion/spec.py``): the hires
        two-stage flow when ``spec.hires_scale`` > 1, else one call;
        ``spec.call_kwargs()`` is the only expansion site."""
        if spec.hires_scale and spec.hires_scale > 1.0:
            return self.hires(prompts, **spec.hires_kwargs())
        return self(prompts, **spec.call_kwargs())

    def hires(self, prompts, *, height: int = 1024, width: int = 1024,
              hires_scale: float = 2.0, hires_strength: float = 0.7,
              hires_steps: Optional[int] = None, hires_mode: str = "latent",
              num_inference_steps: int = 50, seed: int = 42,
              latents=None, decode: bool = True, **kw):
        """Two-stage hires-fix: compose at height/width ÷ ``hires_scale``
        (snapped to 64 px), upscale, then finish with an img2img pass at
        the target size and ``hires_strength``.

        hires_mode:
          "latent" — bicubic-resize the raw first-pass latents
            (``utils.image.resize``, JAX's bicubic) and re-noise them, on
            the card; no VAE round trip.
          "image"  — decode, bicubic-upscale in pixels, clip to [0, 1],
            re-encode through the VAE (``img2img``).
        ``hires_steps``: the second stage's grid (default
        ``num_inference_steps``); with strength s about s·steps UNet steps
        run.  The second stage draws from seed ``seed ^ 0x9E3779B9``.
        Remaining kwargs go to BOTH stages."""
        if hires_mode not in ("latent", "image"):
            raise ValueError(f"hires_mode must be 'latent' or 'image', "
                             f"got {hires_mode!r}")
        for bad in ("strength", "init_image", "init_latents", "mask_image",
                    "denoising_start", "denoising_end"):
            if bad in kw:
                raise ValueError(f"hires() drives both stages itself — "
                                 f"{bad} cannot be passed through (use "
                                 "hires_strength for the second stage)")
        if hires_scale <= 1.0:
            raise ValueError(f"hires_scale must be > 1 (got {hires_scale}) "
                             "— use a plain call for same-size sampling")
        if self.cfg.scheduler in ("pndm", "lms"):
            raise ValueError("hires needs a t_start-capable scheduler "
                             "(ddim/dpm/ddpm/euler_a/...) — the PNDM/LMS "
                             "warmup does not truncate at the second "
                             "stage's strength start")
        f = self.cfg.vae_scale
        # the UNet's down path at vae_scale 8: 64 px
        m = f * 8
        snap = lambda v: max(m, int(round(v / hires_scale / m)) * m)
        bh, bw = snap(height), snap(width)
        if height % m or width % m:
            raise ValueError(f"hires target {height}x{width} must be a "
                             f"multiple of {m}")
        out1 = self(prompts, height=bh, width=bw,
                    num_inference_steps=num_inference_steps, seed=seed,
                    latents=latents, decode=(hires_mode == "image"), **kw)
        steps2 = hires_steps if hires_steps is not None \
            else num_inference_steps
        # a second-stage stream apart from any user's adjacent seeds
        seed2 = int(np.uint32(seed) ^ np.uint32(0x9E3779B9))
        first = torch.from_numpy(out1).to(self.device)
        if hires_mode == "latent":
            n, c = first.shape[0], first.shape[-1]
            up = resize(first, (n, height // f, width // f, c))
            return self(prompts, height=height, width=width,
                        init_latents=up, strength=hires_strength,
                        num_inference_steps=steps2, seed=seed2,
                        decode=decode, **kw)
        up = resize(first, (first.shape[0], height, width, 3))
        return self.img2img(prompts, torch.clamp(up, 0.0, 1.0).cpu().numpy(),
                            strength=hires_strength, height=height,
                            width=width, num_inference_steps=steps2,
                            seed=seed2, decode=decode, **kw)

    def img2img(self, prompts, image, *, strength: float = 0.8, **kw):
        """Image-to-image: re-diffuse ``image`` under ``prompts`` (the
        diffusers Img2Img surface); height/width default to an array's own
        size.  strength ∈ (0, 1]: how much of the run to re-apply."""
        if not hasattr(image, "convert"):
            arr = np.asarray(image)
            kw.setdefault("height", arr.shape[-3])
            kw.setdefault("width", arr.shape[-2])
        return self(prompts, init_image=image, strength=strength, **kw)

    def inpaint(self, prompts, image, mask_image, *, strength: float = 0.8,
                **kw):
        """Inpainting: regenerate the white region of ``mask_image`` inside
        ``image`` (the diffusers Inpaint surface, with the per-step blend at
        the next noise level — see ``sample``)."""
        if not hasattr(image, "convert"):
            arr = np.asarray(image)
            kw.setdefault("height", arr.shape[-3])
            kw.setdefault("width", arr.shape[-2])
        return self(prompts, init_image=image, mask_image=mask_image,
                    strength=strength, **kw)

    def numpy_to_pil(self, imgs: np.ndarray):
        from PIL import Image

        return [Image.fromarray(np.uint8(np.round(i * 255.0))) for i in imgs]
