"""SDPipeline — the host-side serving object (counterpart of
``sdbc_tpu/diffusion/pipeline.py``): tokenization, latents, img2img /
inpaint inputs and the SD-1.x options around ``graph.sample``."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sdbc_tpu_torch.diffusion.graph import (  # noqa: F401  (re-export)
    PipelineConfig, img2img_t_start, init_models, preprocess_image,
    preprocess_mask, sample)
from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models import unet as unet_mod
from sdbc_tpu_torch.models import vae as vae_mod
from sdbc_tpu_torch.models.convert import load_jax_params

_BUILDERS = {"text_encoder": clip_mod.init, "unet": unet_mod.init,
             "vae": vae_mod.init}


def as_modules(params_or_modules: dict, cfg: PipelineConfig, device) -> dict:
    """Modules as given, or modules built from JAX parameter trees (nested
    numpy, see ``models.convert``) kept in fp32 like the JAX masters."""
    sub_cfg = {"text_encoder": cfg.clip, "unet": cfg.unet, "vae": cfg.vae}
    out = {}
    for name, build in _BUILDERS.items():
        value = params_or_modules[name]
        if not isinstance(value, torch.nn.Module):
            value = load_jax_params(build(sub_cfg[name], device=device), value)
        out[name] = value.requires_grad_(False)
    return out


def _per_image(arr: np.ndarray, b: int, what: str) -> np.ndarray:
    """One array for every requested image: a single one is repeated."""
    if arr.shape[0] == 1 and b > 1:
        arr = np.tile(arr, (b,) + (1,) * (arr.ndim - 1))
    if arr.shape[0] != b:
        raise ValueError(f"{arr.shape[0]} {what} for {b} requested images "
                         "(pass 1, or one per image)")
    return arr


class SDPipeline:
    """Tokenize → ``sample`` → numpy images, the diffusers-pipeline shape.
    Runs on the card unless the caller passes ``device="cpu"``.
    ``attn_impl``: force the UNet's attention implementation ("xla",
    ...; ``ops.attention``) instead of the sampling dispatch "inference".
    The scheduler is ``cfg.scheduler`` (``graph.SCHEDULERS``)."""

    def __init__(self, params_or_modules: dict, cfg: PipelineConfig,
                 tokenizer, device="cuda", compute_dtype=torch.bfloat16,
                 attn_impl: Optional[str] = None):
        self.attn_impl = attn_impl or "inference"
        self.device = torch.device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        self.models = as_modules(params_or_modules, cfg, self.device)

    def tokenize(self, prompts) -> torch.Tensor:
        ids = np.asarray(self.tokenizer.batch_encode(prompts,
                                                     self.cfg.clip.ctx),
                         np.int64)
        return torch.from_numpy(ids).to(self.device)

    def _latents(self, latents, b: int, height: int, width: int,
                 generator: torch.Generator) -> torch.Tensor:
        c = self.cfg.latent_channels
        if latents is None:
            f = self.cfg.vae_scale
            return torch.randn((b, height // f, width // f, c),
                               generator=generator, device=self.device,
                               dtype=torch.float32)
        lat = torch.as_tensor(np.asarray(latents, np.float32)
                              if not torch.is_tensor(latents) else latents)
        if lat.ndim == 3:
            lat = lat[None]
        # accept torch-layout NCHW fixed latents (the parity protocol)
        if lat.shape[-1] != c and lat.shape[1] == c:
            lat = lat.permute(0, 2, 3, 1)
        if lat.shape[0] > b:
            raise ValueError(f"{lat.shape[0]} latents for {b} requested "
                             "images")
        if lat.shape[0] < b:
            lat = torch.cat([lat] + [lat[-1:]] * (b - lat.shape[0]), dim=0)
        return lat.to(self.device, torch.float32).contiguous()

    def __call__(self, prompts, *, height: int = 512, width: int = 512,
                 num_inference_steps: int = 50, guidance_scale: float = 7.5,
                 latents: Optional[np.ndarray] = None, seed: int = 42,
                 decode: bool = True, cache_interval: int = 0,
                 cache_tail: int = 0, negative_prompt=None,
                 num_images_per_prompt: int = 1, init_image=None,
                 init_latents=None, strength: float = 0.8, mask_image=None,
                 guidance_rescale: float = 0.0, clip_skip: int = 0,
                 use_karras_sigmas: bool = False, freeu=None,
                 cfg_interval=None,
                 denoising_start: Optional[float] = None,
                 denoising_end: Optional[float] = None) -> np.ndarray:
        """``negative_prompt``: str or per-prompt list encoded as the CFG
        unconditional branch instead of "".  ``latents``: NHWC or NCHW
        (e.g. ``utils.prng.per_sample_fixed_latents``); without them the
        initial noise is drawn from a ``torch.Generator`` seeded ``seed``,
        which then goes on to the sampler (stochastic schedulers,
        init_image's posterior draw).  ``num_images_per_prompt``: each
        prompt repeated, with its own latents.

        ``init_image`` (PIL or array, ``preprocess_image``) is img2img: the
        image is VAE-encoded and noised to ``strength``'s start point, and
        the remaining steps run; ``latents`` are then the added noise.
        ``mask_image`` (white = regenerate, ``preprocess_mask``) also
        inpaints.  ``init_latents``: model-space latents instead of an
        image.  ``denoising_end`` stops at round(n·end) (pair with
        decode=False); ``denoising_start`` resumes from handed-over
        ``latents`` at round(n·start).  The other options are
        ``graph.sample``'s.  Returns (B, H, W, 3) float32 numpy images in
        [0, 1], or the raw latents with decode=False."""
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
        if denoising_start is not None and latents is None:
            raise ValueError("denoising_start requires latents= (the base "
                             "stage's decode=False output)")
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        lat = self._latents(latents, b, height, width, gen)

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
        img_arr = mask_arr = lat_init = None
        f = self.cfg.vae_scale
        if init_image is not None:
            img_arr = _per_image(preprocess_image(init_image, height, width),
                                 b, "init images")
            t_start = img2img_t_start(num_inference_steps, strength,
                                      self.cfg.schedule.steps_offset)
            if mask_image is not None:
                mask_arr = _per_image(preprocess_mask(mask_image, height // f,
                                                      width // f), b, "masks")
        if init_latents is not None:
            lat_init = np.asarray(init_latents, np.float32)
            want = (height // f, width // f, self.cfg.latent_channels)
            if tuple(lat_init.shape[1:]) != want:
                raise ValueError(
                    f"init_latents shape {tuple(lat_init.shape[1:])} does "
                    f"not match the requested {height}x{width} latent grid "
                    f"{want}")
            lat_init = _per_image(lat_init, b, "init latents")
            t_start = img2img_t_start(num_inference_steps, strength,
                                      self.cfg.schedule.steps_offset)
        on_device = lambda a: None if a is None \
            else torch.from_numpy(a).to(self.device)
        out = sample(self.models, self.tokenize(prompts),
                     self.tokenize(negative_prompt), lat,
                     float(guidance_scale), cfg=self.cfg,
                     num_inference_steps=num_inference_steps,
                     compute_dtype=self.compute_dtype, decode=decode,
                     cache_interval=cache_interval, cache_tail=cache_tail,
                     attn_impl=self.attn_impl, init_image=on_device(img_arr),
                     init_latents=on_device(lat_init), t_start=t_start,
                     t_end=t_end, mask=on_device(mask_arr),
                     guidance_rescale=float(guidance_rescale),
                     clip_skip=int(clip_skip),
                     use_karras_sigmas=bool(use_karras_sigmas),
                     freeu=tuple(float(v) for v in freeu) if freeu else None,
                     cfg_interval=tuple(float(v) for v in cfg_interval)
                     if cfg_interval is not None else None,
                     generator=gen)
        return out.float().cpu().numpy()

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
