"""Classifier-free-guidance sampling (counterpart of
``sdbc_tpu/diffusion/graph.py``), for the DDIM + CFG + VAE-decode path.

CLIP encode of both branches → ``num_inference_steps`` DDIM steps with the
UNet on the CFG-doubled batch (time projections hoisted by
``unet.precompute_temb``) → per-image VAE decode → images in [0, 1].  The
JAX package's casts are kept: the latent is carried in the compute dtype,
the UNet output is split and combined in fp32, ``ddim_step`` casts back to
the latent's dtype.  PyTorch runs eagerly, so the loop is a Python loop.
"""
from __future__ import annotations

import dataclasses

import torch

from sdbc_tpu_torch.diffusion import schedulers as sched_mod
from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models import unet as unet_mod
from sdbc_tpu_torch.models import vae as vae_mod


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    clip: clip_mod.CLIPTextConfig
    unet: unet_mod.UNetConfig
    vae: vae_mod.VAEConfig
    schedule: sched_mod.ScheduleConfig
    scheduler: str = "ddim"

    @property
    def vae_scale(self) -> int:
        """Spatial down-factor of the VAE (8 for SD-1.x)."""
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @property
    def latent_channels(self) -> int:
        return self.vae.latent_channels

    @staticmethod
    def sd15(scheduler: str = "ddim") -> "PipelineConfig":
        return PipelineConfig(clip_mod.CLIPTextConfig.sd15(),
                              unet_mod.UNetConfig.sd15(),
                              vae_mod.VAEConfig.sd15(),
                              sched_mod.ScheduleConfig.sd15(), scheduler)

    @staticmethod
    def tiny(scheduler: str = "ddim") -> "PipelineConfig":
        return PipelineConfig(clip_mod.CLIPTextConfig.tiny(),
                              unet_mod.UNetConfig.tiny(),
                              vae_mod.VAEConfig.tiny(),
                              sched_mod.ScheduleConfig.sd15(), scheduler)


def init_models(cfg: PipelineConfig, *, device, generator,
                dtype=torch.float32) -> dict:
    """Random-init text encoder, UNet and VAE from one ``torch.Generator``."""
    kw = dict(device=device, generator=generator, dtype=dtype)
    return {"text_encoder": clip_mod.init(cfg.clip, **kw),
            "unet": unet_mod.init(cfg.unet, **kw),
            "vae": vae_mod.init(cfg.vae, **kw)}


def encode_text(text_encoder, ids, cfg: PipelineConfig,
                compute_dtype=torch.bfloat16, clip_skip: int = 0):
    """``clip_skip``: 0/1 = full encoder, 2 = penultimate layer, ...  Ids
    wider than the encoder context (a multiple of it) are encoded window by
    window and concatenated along the sequence."""
    ctx = cfg.clip.ctx
    b, width = ids.shape
    if width % ctx:
        raise ValueError(f"token ids width {width} is not a multiple of the "
                         f"encoder context {ctx}")
    emb = clip_mod.apply(text_encoder, ids.reshape(-1, ctx), compute_dtype,
                         skip_layers=max(clip_skip - 1, 0))
    return emb.reshape(b, width, emb.shape[-1])


def cfg_combine(out_u, out_c, guidance_scale: float):
    """Classifier-free guidance on fp32 model outputs (no rescale)."""
    return out_u + guidance_scale * (out_c - out_u)


_UNPORTED = ("init_image", "init_latents", "mask", "masked_image",
             "control_image", "cache_interval", "cfg_interval", "freeu",
             "use_karras_sigmas", "guidance_rescale", "t_start", "t_end",
             "cond_ids2", "uncond_ids2", "time_ids", "cond_weights",
             "uncond_weights", "pack_heads", "clip_skip")


@torch.inference_mode()
def sample(models: dict, cond_ids, uncond_ids, latents, guidance_scale, *,
           cfg: PipelineConfig, num_inference_steps: int = 50,
           compute_dtype=torch.bfloat16, attn_impl: str = "inference",
           **unported):
    """Run the DDIM + CFG sampling path.

    models: {"text_encoder", "unet", "vae"} modules
    cond_ids/uncond_ids: (B, ctx) integer token ids on the models' device
    latents: (B, h/8, w/8, 4) NHWC initial noise
    attn_impl: the UNet's attention dispatch ("inference" = the fixed-cap
    kernel; "xla" forces plain attention; see ``ops.attention``)
    Returns (B, H, W, 3) fp32 images in [0, 1].
    """
    if cfg.scheduler != "ddim":
        raise NotImplementedError(f"scheduler {cfg.scheduler!r} is not ported")
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"sample() got an unexpected argument {name!r}")
        if value not in (None, False, 0, 0.0):
            raise NotImplementedError(f"sample({name}=...) is not ported")
    if cond_ids.shape[1] != uncond_ids.shape[1]:
        raise ValueError(f"cond/uncond token widths differ "
                         f"({cond_ids.shape[1]} vs {uncond_ids.shape[1]})")
    device = latents.device
    dt = compute_dtype
    sched = sched_mod.make_schedule(cfg.schedule, device)
    unet = models["unet"]

    ctx_c = encode_text(models["text_encoder"], cond_ids, cfg, dt)
    ctx_u = encode_text(models["text_encoder"], uncond_ids, cfg, dt)
    context = torch.cat([ctx_u, ctx_c], dim=0)  # (2B, ctx, hidden)
    lat = latents.to(dt)

    ts = sched_mod.ddim_timesteps(cfg.schedule, num_inference_steps)
    ratio = sched_mod.inference_stride(cfg.schedule, num_inference_steps)
    tproj = unet_mod.precompute_temb(unet, ts.to(device), dtype=dt)
    for i, t in enumerate(ts.tolist()):
        lat2 = torch.cat([lat, lat], dim=0)
        tb = torch.full((lat2.shape[0],), t, dtype=torch.int64, device=device)
        out = unet_mod.apply(unet, lat2, tb, context, attn_impl=attn_impl,
                             temb_proj=unet_mod.index_temb(tproj, i))
        out_u, out_c = out.float().chunk(2, dim=0)
        lat = sched_mod.ddim_step(sched, cfg_combine(out_u, out_c,
                                                     guidance_scale),
                                  t, t - ratio, lat)

    lat_s = lat.to(dt) / cfg.vae.scaling_factor
    vae = models["vae"]
    if lat.shape[0] > 1 and lat.shape[1] * lat.shape[2] >= 4096:
        # image by image: bounds the decode's activation memory at 512²
        img = torch.cat([vae_mod.decode(vae, lat_s[j:j + 1])
                         for j in range(lat_s.shape[0])], dim=0)
    else:
        img = vae_mod.decode(vae, lat_s)
    return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
