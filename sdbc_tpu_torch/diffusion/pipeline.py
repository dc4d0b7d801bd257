"""SDPipeline — the host-side serving object (counterpart of
``sdbc_tpu/diffusion/pipeline.py``): tokenization and latent handling
around ``graph.sample``, for the DDIM + CFG text-to-image path."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sdbc_tpu_torch.diffusion.graph import (  # noqa: F401  (re-export)
    PipelineConfig, init_models, sample)
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


class SDPipeline:
    """Tokenize → ``sample`` → numpy images, the diffusers-pipeline shape.
    Runs on the card unless the caller passes ``device="cpu"``.
    ``attn_impl``: force the UNet's attention implementation ("xla",
    ...; ``ops.attention``) instead of the sampling dispatch "inference"."""

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
                 seed: int) -> torch.Tensor:
        c = self.cfg.latent_channels
        if latents is None:
            f = self.cfg.vae_scale
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            return torch.randn((b, height // f, width // f, c), generator=g,
                               device=self.device, dtype=torch.float32)
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
                 negative_prompt=None) -> np.ndarray:
        """``negative_prompt``: str or per-prompt list encoded as the CFG
        unconditional branch instead of "".  ``latents``: NHWC or NCHW
        (e.g. ``utils.prng.per_sample_fixed_latents``); without them the
        initial noise is drawn from a ``torch.Generator`` seeded ``seed``.
        Returns (B, H, W, 3) float32 numpy images in [0, 1]."""
        if isinstance(prompts, str):
            prompts = [prompts]
        b = len(prompts)
        if negative_prompt is None:
            negative_prompt = [""] * b
        elif isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * b
        elif len(negative_prompt) != b:
            raise ValueError(f"{len(negative_prompt)} negative prompts for "
                             f"{b} prompts")
        lat = self._latents(latents, b, height, width, seed)
        imgs = sample(self.models, self.tokenize(prompts),
                      self.tokenize(negative_prompt), lat,
                      float(guidance_scale), cfg=self.cfg,
                      num_inference_steps=num_inference_steps,
                      compute_dtype=self.compute_dtype,
                      attn_impl=self.attn_impl)
        return imgs.cpu().numpy()
