"""Classifier-free-guidance sampling (counterpart of
``sdbc_tpu/diffusion/graph.py``): every scheduler and sampling option of
the JAX package's ``sample``, for SD-1.x, SD-2.x and SDXL (the dual text
encoder with the pooled text-time conditioning, and the refiner's
aesthetic-score flavour), with ControlNet branches (``control_image``,
one branch or several) and the dedicated inpainting UNet
(``masked_image``).

CLIP encode of both branches → the scheduler loop with the UNet on the
CFG-doubled batch (time projections hoisted by ``unet.precompute_temb``)
→ per-image VAE decode → images in [0, 1].  The JAX package's casts are
kept: the latent is carried in the compute dtype, the UNet output is split
and combined in fp32, each scheduler step casts back to the latent's
dtype.  PyTorch runs eagerly, so the loop is a Python loop over host
timesteps (``_scheduler_loop``); each branch of the JAX graph's
``jnp.where``/``lax.cond`` on a traced value becomes the same Python
branch, and every table the loop indexes lies on the latents' device, so
no step reads a device value back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sdbc_tpu_torch.diffusion import schedulers as sched_mod
from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models import controlnet as controlnet_mod
from sdbc_tpu_torch.models import unet as unet_mod
from sdbc_tpu_torch.models import vae as vae_mod
from sdbc_tpu_torch.ops import nn as nn_mod

SCHEDULERS = ("ddim", "pndm", "ddpm", "lms", "dpm", "dpm_sde", "unipc",
              "lcm", "heun", "euler_a")
# the schedulers that draw fresh noise every step
STOCHASTIC = ("ddpm", "euler_a", "dpm_sde", "lcm")
# the σ-space samplers that take the Karras grid
KARRAS = ("euler_a", "lms", "dpm", "dpm_sde", "heun")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    clip: clip_mod.CLIPTextConfig
    unet: unet_mod.UNetConfig
    vae: vae_mod.VAEConfig
    schedule: sched_mod.ScheduleConfig
    # one of SCHEDULERS
    scheduler: str = "ddim"
    # SDXL's second text encoder (OpenCLIP bigG with its projection): the
    # models then hold "text_encoder_2", and the UNet takes the pooled
    # embed through its text-time embedding
    clip2: Optional[clip_mod.CLIPTextConfig] = None
    # the SDXL refiner: bigG alone ("text_encoder_2"; clip = clip2 so the
    # tokenizer plumbing is unchanged) and 5 micro-conditioning ids, the
    # last an aesthetic score per CFG branch
    refiner: bool = False
    # the ControlNet branch's config (``with_controlnet``): the models
    # then hold "controlnet", one branch or a list (multi-ControlNet)
    controlnet: Optional[controlnet_mod.ControlNetConfig] = None

    @property
    def is_sdxl(self) -> bool:
        return self.clip2 is not None

    @property
    def vae_scale(self) -> int:
        """Spatial down-factor of the VAE (8 for SD-1.x)."""
        return 2 ** (len(self.vae.block_out_channels) - 1)

    @property
    def latent_channels(self) -> int:
        return self.vae.latent_channels

    @property
    def is_inpaint_unet(self) -> bool:
        """A dedicated inpainting UNet (the runwayml/sd-inpainting
        layout): conv_in takes latent ⧺ mask ⧺ masked-image latent = 2·C+1
        channels, and a mask goes to the channel concat of ``sample``'s
        ``masked_image`` instead of the per-step blend."""
        return self.unet.in_channels == 2 * self.vae.latent_channels + 1

    def with_controlnet(self) -> "PipelineConfig":
        """This config with the matching ControlNet branch: the base UNet's
        encoder layout and the embedder ramp of the VAE's down-factor
        (``controlnet.conditioning_ramp``)."""
        cn = controlnet_mod.ControlNetConfig(
            unet=self.unet,
            conditioning_channels=controlnet_mod.conditioning_ramp(
                self.vae_scale))
        return dataclasses.replace(self, controlnet=cn)

    @staticmethod
    def sd15(scheduler: str = "ddim") -> "PipelineConfig":
        return PipelineConfig(clip_mod.CLIPTextConfig.sd15(),
                              unet_mod.UNetConfig.sd15(),
                              vae_mod.VAEConfig.sd15(),
                              sched_mod.ScheduleConfig.sd15(), scheduler)

    @staticmethod
    def sd21(scheduler: str = "ddim",
             prediction_type: str = "v_prediction") -> "PipelineConfig":
        """SD-2.x: the OpenCLIP ViT-H text encoder, per-level heads,
        v-prediction (SD-2.1 768; ``prediction_type="epsilon"`` for the
        512 base); the SD-1.x VAE."""
        sched = dataclasses.replace(sched_mod.ScheduleConfig.sd15(),
                                    prediction_type=prediction_type)
        return PipelineConfig(clip_mod.CLIPTextConfig.sd2(),
                              unet_mod.UNetConfig.sd21(),
                              vae_mod.VAEConfig.sd15(), sched, scheduler)

    @staticmethod
    def sdxl(scheduler: str = "ddim") -> "PipelineConfig":
        """SDXL base: CLIP-L ⧺ bigG penultimate states (2048 wide), the
        pooled text and size/crop ids through the text-time embedding,
        the 3-level depth-(–, 2, 10) UNet, VAE scale 0.13025; 1024²."""
        return PipelineConfig(clip_mod.CLIPTextConfig.sd15(),
                              unet_mod.UNetConfig.sdxl(),
                              vae_mod.VAEConfig.sdxl(),
                              sched_mod.ScheduleConfig.sd15(), scheduler,
                              clip2=clip_mod.CLIPTextConfig.sdxl_g())

    @staticmethod
    def sdxl_refiner(scheduler: str = "ddim") -> "PipelineConfig":
        """SDXL refiner: bigG alone, aesthetic-score micro-conditioning;
        the tail model of the base → refiner ensemble."""
        big_g = clip_mod.CLIPTextConfig.sdxl_g()
        return PipelineConfig(big_g, unet_mod.UNetConfig.sdxl_refiner(),
                              vae_mod.VAEConfig.sdxl(),
                              sched_mod.ScheduleConfig.sd15(), scheduler,
                              clip2=big_g, refiner=True)

    @staticmethod
    def family(name: str, tiny: bool = False,
               scheduler: str = "ddim") -> "PipelineConfig":
        """``--model_family name``'s config; with ``tiny`` its toy shapes:
        ``tiny_xl`` for sdxl, ``tiny`` with v-prediction for sd21."""
        if not tiny:
            return {"sd15": PipelineConfig.sd15, "sd21": PipelineConfig.sd21,
                    "sdxl": PipelineConfig.sdxl}[name](scheduler)
        if name == "sdxl":
            return PipelineConfig.tiny_xl(scheduler)
        cfg = PipelineConfig.tiny(scheduler)
        if name == "sd21":  # the family's v-prediction objective
            cfg = dataclasses.replace(cfg, schedule=dataclasses.replace(
                cfg.schedule, prediction_type="v_prediction"))
        return cfg

    @staticmethod
    def tiny(scheduler: str = "ddim") -> "PipelineConfig":
        return PipelineConfig(clip_mod.CLIPTextConfig.tiny(),
                              unet_mod.UNetConfig.tiny(),
                              vae_mod.VAEConfig.tiny(),
                              sched_mod.ScheduleConfig.sd15(), scheduler)

    @staticmethod
    def tiny_xl(scheduler: str = "ddim") -> "PipelineConfig":
        """Toy SDXL: every family path at test size; addition_embed_dim
        40 = 16 (clip2 projection) + 6 × 4 (time ids)."""
        clip2 = dataclasses.replace(clip_mod.CLIPTextConfig.tiny(),
                                    projection_dim=16)
        return PipelineConfig(clip_mod.CLIPTextConfig.tiny(),
                              unet_mod.UNetConfig.tiny_xl(),
                              vae_mod.VAEConfig.tiny(),
                              sched_mod.ScheduleConfig.sd15(), scheduler,
                              clip2=clip2)

    @staticmethod
    def tiny_xl_refiner(scheduler: str = "ddim") -> "PipelineConfig":
        """Toy refiner: addition_embed_dim 36 = 16 + 5 × 4; context the
        tiny bigG's 32."""
        clip2 = dataclasses.replace(clip_mod.CLIPTextConfig.tiny(),
                                    projection_dim=16)
        u = dataclasses.replace(unet_mod.UNetConfig.tiny_xl(),
                                cross_attention_dim=32,
                                addition_embed_dim=36)
        return PipelineConfig(clip2, u, vae_mod.VAEConfig.tiny(),
                              sched_mod.ScheduleConfig.sd15(), scheduler,
                              clip2=clip2, refiner=True)


def model_configs(cfg: PipelineConfig) -> dict:
    """{component: its config} of the models ``cfg`` runs: the text
    encoder (not in a refiner), SDXL's second encoder, the UNet and the
    VAE."""
    out = {} if cfg.refiner else {"text_encoder": cfg.clip}
    if cfg.is_sdxl:
        out["text_encoder_2"] = cfg.clip2
    out.update(unet=cfg.unet, vae=cfg.vae)
    return out


COMPONENT_INITS = {"text_encoder": clip_mod.init,
                   "text_encoder_2": clip_mod.init, "unet": unet_mod.init,
                   "vae": vae_mod.init}


def init_models(cfg: PipelineConfig, *, device, generator,
                dtype=torch.float32) -> dict:
    """Random-init the components of ``model_configs`` from one
    ``torch.Generator``."""
    kw = dict(device=device, generator=generator, dtype=dtype)
    return {name: COMPONENT_INITS[name](sub, **kw)
            for name, sub in model_configs(cfg).items()}


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


def encode_text_xl(models, ids, ids2, cfg: PipelineConfig,
                   compute_dtype=torch.bfloat16, clip_skip: int = 0,
                   weights=None, weights2=None):
    """SDXL's dual-encoder conditioning → (context, pooled).

    ids/ids2: (B, ctx·k) from the CLIP-L and the bigG tokenizer (k > 1:
    each window encoded alone; the pooled embed from the first window).
    The context is CLIP-L's ⧺ bigG's penultimate hidden states without the
    final LayerNorm (the refiner: bigG's alone); ``clip_skip`` 0/1/2 mean
    that state, 3 one layer earlier.  pooled: bigG's projected pooled
    output of its full stack.  ``weights``/``weights2``: token weights of
    each encoder's states, mean-restored per encoder; the pooled embed is
    never weighted."""
    if ids.shape[1] != ids2.shape[1]:
        raise ValueError(
            f"SDXL dual-encoder contexts differ: ids {ids.shape[1]} vs ids2 "
            f"{ids2.shape[1]} tokens (the states are concatenated feature-"
            "wise, so both tokenizers encode at one length)")
    skip = max(clip_skip - 1, 1)
    ctx = cfg.clip.ctx
    b, width = ids.shape
    if width % ctx:
        raise ValueError(f"token ids width {width} is not a multiple of the "
                         f"encoder context {ctx}")
    h1 = None
    if not cfg.refiner:
        h1 = clip_mod.apply(models["text_encoder"], ids.reshape(-1, ctx),
                            compute_dtype, skip_layers=skip, final_ln=False)
        h1 = h1.reshape(b, width, h1.shape[-1])
    h2, pooled = clip_mod.apply_with_pooled(
        models["text_encoder_2"], ids2.reshape(-1, ctx), compute_dtype,
        skip_layers=skip)
    h2 = h2.reshape(b, width, h2.shape[-1])
    pooled = pooled.reshape(b, width // ctx, -1)[:, 0]
    if h1 is not None and weights is not None:
        h1 = _apply_token_weights(h1, weights)
    if weights2 is not None:
        h2 = _apply_token_weights(h2, weights2)
    if cfg.refiner:
        return h2, pooled
    return torch.cat([h1, h2], dim=-1), pooled


def xl_added_cond(pooled, time_ids, fourier_dim: int):
    """pooled ⧺ Fourier(time_ids): the text-time embedding's input (fp32).
    Each id gets ``fourier_dim`` features of the timestep embedding's
    sinusoids (diffusers add_time_proj)."""
    b = time_ids.shape[0]
    ft = nn_mod.timestep_embedding(time_ids.reshape(-1), fourier_dim,
                                   dtype=torch.float32).reshape(b, -1)
    return torch.cat([pooled.float(), ft], dim=-1)


def xl_time_ids(cfg: PipelineConfig, lat_shape, time_ids=None,
                aesthetic_score: float = 6.0,
                negative_aesthetic_score: float = 2.5, device="cpu"):
    """The uncond ⧺ cond micro-conditioning ids (2B, 6), or the refiner's
    (2B, 5): (H, W, 0, 0) and the negative / positive aesthetic score.
    ``time_ids`` (B, 6) default to (H, W, 0, 0, H, W) of the latents'
    image size; a refiner derives its own and refuses them."""
    b = lat_shape[0]
    hh = float(lat_shape[1] * cfg.vae_scale)
    ww = float(lat_shape[2] * cfg.vae_scale)
    if cfg.refiner:
        if time_ids is not None:
            raise ValueError("refiner configs derive their own (orig, crop, "
                             "aesthetic) time ids: use aesthetic_score/"
                             "negative_aesthetic_score instead of time_ids")
        base4 = torch.tensor([[hh, ww, 0.0, 0.0]],
                             device=device).expand(b, 4)

        def score(v):
            return torch.full((b, 1), float(np.float32(v)), device=device)

        return torch.cat([torch.cat([base4, score(negative_aesthetic_score)],
                                    dim=-1),
                          torch.cat([base4, score(aesthetic_score)], dim=-1)],
                         dim=0)
    if time_ids is None:
        time_ids = torch.tensor([[hh, ww, 0.0, 0.0, hh, ww]],
                                device=device).expand(b, 6)
    time_ids = torch.as_tensor(time_ids, device=device).float()
    return torch.cat([time_ids, time_ids], dim=0)


def _apply_token_weights(emb, w):
    """Scale each token's hidden state by its prompt weight, then restore
    the per-sample mean (guarded against a zero mean)."""
    emb_f = emb.float()
    mean0 = emb_f.mean(dim=(1, 2), keepdim=True)
    out = emb_f * w.float()[..., None]
    mean1 = out.mean(dim=(1, 2), keepdim=True)
    small = torch.abs(mean1) < 1e-7
    safe = torch.where(small, torch.ones_like(mean1), mean1)
    return (out * torch.where(small, torch.ones_like(mean1), mean0 / safe)
            ).to(emb.dtype)


def cfg_combine(out_u, out_c, guidance_scale: float,
                guidance_rescale: float = 0.0):
    """Classifier-free guidance on fp32 model outputs; ``guidance_rescale``
    > 0 renormalises toward the conditional branch's std and lerps
    (arXiv:2305.08891 eq. 16)."""
    out = out_u + guidance_scale * (out_c - out_u)
    if guidance_rescale > 0.0:
        dims = tuple(range(1, out.dim()))
        std_c = torch.std(out_c, dim=dims, keepdim=True, correction=0)
        std_g = torch.clamp(torch.std(out, dim=dims, keepdim=True,
                                      correction=0), min=1e-8)
        out = (guidance_rescale * (out * std_c / std_g)
               + (1.0 - guidance_rescale) * out)
    return out


def _scheduler_loop(lo: int, hi: int, lat, model_at, update, state=None,
                    noise_at=None):
    """The one loop behind every scheduler (with and without DeepCache).

    model_at(i, lat, cache) -> (t, out, cache): the grid point, the guided
      model output there and the DeepCache trunk cache (None uncached);
    update(i, t, out, lat, state, noise) -> (state, lat): the scheduler's
      work after the model call (eps/x0 conversion, the step, the inpaint
      blend);
    noise_at(i): the step's standard-normal draw for the stochastic
      schedulers, taken before the model call as in the JAX package.
    """
    cache = None
    for i in range(lo, hi):
        noise = None if noise_at is None else noise_at(i)
        t, out, cache = model_at(i, lat, cache)
        state, lat = update(i, t, out, lat, state, noise)
    return lat


# an argument of the JAX package's ``sample`` that is not ported: head
# packing (a TPU layout hook, ROADMAP "Do not port"), with its default
_UNPORTED = {"pack_heads": None}


def _refuse_unported(unported: dict) -> None:
    for name, value in unported.items():
        if name not in _UNPORTED:
            raise TypeError(f"sample() got an unexpected argument {name!r}")
        if value is not None and value is not False:
            raise NotImplementedError(f"sample({name}=...) is not ported")


def _check_options(cfg: PipelineConfig, n: int, *, cache_interval,
                   init_image, init_latents, t_start, t_end, mask,
                   use_karras_sigmas, cfg_interval, masked_image=None,
                   control_image=None, has_controlnet=False):
    """The JAX package's refusals of option combinations, with its
    exception types.  Returns (cfg_lo, cfg_hi): the guided step range of
    ``cfg_interval`` (None without it)."""
    sch = cfg.scheduler
    if sch not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {sch}")
    cached = bool(cache_interval and cache_interval > 1)
    if cached and sch not in ("ddim", "dpm"):
        raise ValueError("cache_interval (DeepCache fast mode) is implemented "
                         "for the ddim and dpm schedulers only")
    blend_mask = mask is not None and masked_image is None
    if (init_image is not None or init_latents is not None or t_start
            or blend_mask) and sch in ("pndm", "lms"):
        raise ValueError("img2img/inpaint (init_image/t_start/mask) is not "
                         "implemented for pndm and lms — their multistep "
                         "warm-up does not truncate cleanly at t_start")
    if init_latents is not None and init_image is not None:
        raise ValueError("init_latents (latent-space img2img) and init_image "
                         "(pixel-space img2img) are mutually exclusive")
    if init_latents is not None and masked_image is not None:
        raise ValueError("init_latents cannot combine with masked_image (the "
                         "dedicated inpainting UNet is a full denoise from "
                         "pure noise)")
    if masked_image is not None:
        if not cfg.is_inpaint_unet:
            raise ValueError(
                f"masked_image is the channel-concat inpainting protocol — "
                f"it needs an inpainting UNet (in_channels == "
                f"{2 * cfg.latent_channels + 1}, got {cfg.unet.in_channels})")
        if mask is None:
            raise ValueError("masked_image requires mask")
        if init_image is not None or t_start:
            raise ValueError("masked_image starts from pure noise — "
                             "init_image/t_start (the re-noising protocol) "
                             "cannot combine with it")
        if cached:
            raise ValueError("masked_image cannot combine with "
                             "cache_interval — the cached trunk is shaped "
                             "for the plain latent input")
    elif cfg.is_inpaint_unet:
        raise ValueError("this config is a dedicated inpainting UNet "
                         f"(in_channels={cfg.unet.in_channels}): every call "
                         "must pass masked_image + mask (plain text-to-image "
                         "is undefined for its conv_in)")
    if cfg.schedule.timestep_spacing == "trailing" and sch == "pndm":
        raise ValueError("timestep_spacing='trailing' is not implemented "
                         "for pndm (its warm-up re-runs the second grid "
                         "point, which the trailing grid does not define)")
    if cfg.schedule.rescale_zero_snr and sch not in ("ddim", "unipc"):
        raise ValueError(
            "rescale_zero_snr schedules sample from exactly zero SNR, where "
            "the eps-parameterised steps divide by alpha=0 and the "
            "sigma-space samplers' terminal sigma is infinite — use the ddim "
            "or unipc schedulers")
    if blend_mask and sch == "unipc":
        raise ValueError("inpainting (mask) is not implemented for unipc — "
                         "the per-step blend invalidates the corrector's "
                         "last_sample")
    if blend_mask and init_image is None and init_latents is None:
        raise ValueError("mask (inpainting) requires init_image")
    if use_karras_sigmas and sch not in KARRAS:
        raise ValueError("use_karras_sigmas applies to the sigma-space "
                         f"samplers ({', '.join(KARRAS)}) only — ddim/pndm/"
                         "ddpm/unipc/lcm are defined on the integer grid")
    cfg_lo = cfg_hi = None
    if cfg_interval is not None:
        lo, hi = cfg_interval
        if not 0.0 <= lo <= hi <= 1.0:
            raise ValueError(f"cfg_interval must be 0 <= lo <= hi <= 1, "
                             f"got {cfg_interval}")
        if cached:
            raise ValueError("cfg_interval cannot combine with "
                             "cache_interval — the DeepCache trunk cache is "
                             "shaped for the 2B CFG batch")
        if control_image is not None:
            raise ValueError("cfg_interval cannot combine with "
                             "control_image — the hoisted ControlNet "
                             "conditioning embeddings are built for the 2B "
                             "CFG batch")
        if sch == "pndm":
            raise ValueError("cfg_interval is not implemented for pndm — its "
                             "warm-up grid is longer than "
                             "num_inference_steps")
        cfg_lo, cfg_hi = int(round(lo * n)), int(round(hi * n))
    if not 0 <= t_start <= n:
        raise ValueError(f"t_start={t_start} outside [0, {n}]")
    if t_end is not None:
        if sch in ("pndm", "lms", "unipc"):
            raise ValueError("t_end (denoising_end) is implemented for the "
                             "single-step schedulers only — the PNDM/LMS/"
                             "UniPC multistep state does not hand off "
                             "cleanly")
        if not t_start <= t_end <= n:
            raise ValueError(f"t_end={t_end} outside [{t_start}, {n}]")
        if mask is not None:
            raise ValueError("t_end cannot combine with mask (a truncated "
                             "run would hand off a half-blended composite)")
    if control_image is not None:
        if not has_controlnet or cfg.controlnet is None:
            raise ValueError("control_image needs models['controlnet'] and "
                             "cfg.controlnet (PipelineConfig.with_controlnet)")
        if cached:
            raise ValueError("control_image cannot combine with "
                             "cache_interval — the ControlNet residuals land "
                             "inside the cached trunk (a reused trunk would "
                             "silently freeze the conditioning)")
    return cfg_lo, cfg_hi


def _rows_of_draws(draws: dict, idx) -> dict:
    """Injected global draws cut to rows ``idx``."""
    idx = np.asarray(idx)
    cut = lambda x: torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                    else x)[torch.from_numpy(idx)]
    out = {}
    for k, v in draws.items():
        if k == "step":
            out[k] = ({i: cut(x) for i, x in v.items()}
                      if isinstance(v, dict) else [cut(x) for x in v])
        else:
            out[k] = cut(v)
    return out


@torch.inference_mode()
def sample(models: dict, cond_ids, uncond_ids, latents, guidance_scale, *,
           cfg: PipelineConfig, num_inference_steps: int = 50,
           compute_dtype=torch.bfloat16, decode: bool = True,
           cache_interval: int = 0, cache_tail: int = 0,
           attn_impl: str = "inference", chunked_decode=None,
           init_image=None, init_latents=None, t_start: int = 0,
           t_end: Optional[int] = None, mask=None,
           guidance_rescale: float = 0.0, clip_skip: int = 0,
           use_karras_sigmas: bool = False, freeu=None, cfg_interval=None,
           cond_weights=None, uncond_weights=None,
           cond_ids2=None, uncond_ids2=None, time_ids=None,
           cond_weights2=None, uncond_weights2=None,
           aesthetic_score: float = 6.0,
           negative_aesthetic_score: float = 2.5, masked_image=None,
           control_image=None, controlnet_scale=1.0,
           generator: Optional[torch.Generator] = None,
           draws: Optional[dict] = None, rows=None, **unported):
    """Run the CFG sampling path of ``cfg.scheduler``.

    models: the modules of ``model_configs(cfg)`` ({"text_encoder",
      "unet", "vae"}, with "text_encoder_2" for SDXL; a refiner has no
      "text_encoder")
    cond_ids/uncond_ids: (B, ctx·k) integer token ids on the models' device
    latents: (B, h/8, w/8, 4) NHWC initial noise (with init_image /
      init_latents: the noise added to the init latents)
    generator: ``torch.Generator`` on the latents' device for the
      stochastic schedulers (STOCHASTIC) and init_image's posterior draw —
      the counterpart of the JAX package's ``key``
    draws: injected standard-normal draws instead of the generator's:
      {"step": one latent-shaped draw per loop index i (a list or a dict;
      used up by every step of a stochastic scheduler, the last one too),
      "enc": init_image's posterior ε, "masked": masked_image's}
    rows: (row indices, global batch) when the batch inputs are one data
      rank's rows of a global batch (``SDPipeline(mesh=)``): every draw,
      the generator's or an injected one, is the global batch's, cut to
      these rows
    attn_impl: the UNet's attention dispatch ("inference" = the fixed-cap
      kernel; "xla" forces plain attention; see ``ops.attention``)
    cache_interval / cache_tail: DeepCache (ddim and dpm) — the UNet's deep
      trunk recomputed every cache_interval steps from t_start, reused in
      between (``unet.apply``'s cache_tail)
    init_image: (B, H, W, 3) in [0, 1] — img2img: VAE-encoded, noised to
      grid index t_start (``img2img_t_start``); init_latents: model-space
      latents instead (no VAE encode)
    mask: (B, h/8, w/8, 1) in [0, 1], 1 = regenerate — after each step the
      kept region is the init latents at the next noise level
    t_end: stop at grid index t_end (denoising_end; pair with decode=False)
    guidance_rescale, clip_skip, use_karras_sigmas, freeu, cfg_interval,
    cond_weights/uncond_weights: as in the JAX package's ``sample``
    cond_ids2/uncond_ids2, cond_weights2/uncond_weights2 (SDXL, cfg.clip2
      set): the second tokenizer's ids and weights; time_ids: (B, 6)
      micro-conditioning (orig h/w, crop top/left, target h/w; default the
      latents' image size); aesthetic_score/negative_aesthetic_score: the
      refiner's cond/uncond scores (``xl_time_ids``)
    masked_image: (B, H, W, 3) in [0, 1] — the dedicated inpainting UNet
      (``cfg.is_inpaint_unet``): its VAE latent (one posterior draw) and
      ``mask`` are concatenated to the latents, [latents, mask,
      masked-image latents], on every UNet call of both CFG halves; a full
      denoise from ``latents``, no blend, no re-noising
    control_image: (B, H, W, 3) in [0, 1], or a list of them, one per
      branch of ``models["controlnet"]`` (one module or a list); each
      branch's conditioning embedding is computed once a call on the CFG
      batch and its residuals, times ``controlnet_scale`` (a float, or
      one per branch), summed into the UNet's skips every step
    Returns (B, H, W, 3) fp32 images in [0, 1], or the latents (compute
    dtype) with decode=False.
    """
    _refuse_unported(unported)
    n = num_inference_steps
    cfg_lo, cfg_hi = _check_options(
        cfg, n, cache_interval=cache_interval, init_image=init_image,
        init_latents=init_latents, t_start=t_start, t_end=t_end, mask=mask,
        use_karras_sigmas=use_karras_sigmas, cfg_interval=cfg_interval,
        masked_image=masked_image, control_image=control_image,
        has_controlnet="controlnet" in models)
    if cond_ids.shape[1] != uncond_ids.shape[1]:
        raise ValueError(f"cond/uncond token widths differ "
                         f"({cond_ids.shape[1]} vs {uncond_ids.shape[1]})")
    draws = draws or {}
    if rows is not None:
        draws = _rows_of_draws(draws, rows[0])
    sch = cfg.scheduler
    pt = cfg.schedule.prediction_type
    device = latents.device
    dt = compute_dtype
    cached = bool(cache_interval and cache_interval > 1)
    t_stop = n if t_end is None else t_end
    sched = sched_mod.make_schedule(cfg.schedule, device)
    unet = models["unet"]

    def randn(shape, name):
        if generator is None:
            raise ValueError(f"scheduler {sch!r} / init_image needs a "
                             f"torch.Generator or injected {name!r} draws")
        if rows is not None:
            full = torch.randn((rows[1],) + tuple(shape[1:]),
                               generator=generator, device=device,
                               dtype=torch.float32)
            return full[torch.from_numpy(np.asarray(rows[0])).to(device)]
        return torch.randn(tuple(shape), generator=generator, device=device,
                           dtype=torch.float32)

    def on_device(x):
        return None if x is None else torch.as_tensor(x, device=device)

    added2 = None
    if cfg.is_sdxl:
        if cond_ids2 is None or uncond_ids2 is None:
            raise ValueError("SDXL configs (cfg.clip2 set) need cond_ids2/"
                             "uncond_ids2 from the second tokenizer")
        ctx_c, pool_c = encode_text_xl(
            models, cond_ids, on_device(cond_ids2), cfg, dt,
            clip_skip=clip_skip, weights=on_device(cond_weights),
            weights2=on_device(cond_weights2))
        ctx_u, pool_u = encode_text_xl(
            models, uncond_ids, on_device(uncond_ids2), cfg, dt,
            clip_skip=clip_skip, weights=on_device(uncond_weights),
            weights2=on_device(uncond_weights2))
        # uncond ⧺ cond rows, as the context below
        added2 = xl_added_cond(
            torch.cat([pool_u, pool_c], dim=0),
            xl_time_ids(cfg, latents.shape, on_device(time_ids),
                        aesthetic_score, negative_aesthetic_score, device),
            cfg.unet.addition_time_embed_dim)
    else:
        te = models["text_encoder"]
        ctx_c = encode_text(te, cond_ids, cfg, dt, clip_skip=clip_skip)
        ctx_u = encode_text(te, uncond_ids, cfg, dt, clip_skip=clip_skip)
        if cond_weights is not None:
            ctx_c = _apply_token_weights(ctx_c, on_device(cond_weights))
        if uncond_weights is not None:
            ctx_u = _apply_token_weights(ctx_u, on_device(uncond_weights))
    context = torch.cat([ctx_u, ctx_c], dim=0)  # (2B, ctx, hidden)
    lat = latents.to(dt)

    orig_lat = noise0 = None
    if init_image is not None:
        mean, logvar = vae_mod.encode_moments(
            models["vae"], on_device(init_image).to(dt) * 2.0 - 1.0)
        eps = draws.get("enc")
        eps = randn(mean.shape, "enc") if eps is None else on_device(eps)
        orig_lat = (vae_mod.sample(mean, logvar, eps=eps).float()
                    * cfg.vae.scaling_factor)
        noise0 = latents.float()
    elif init_latents is not None:
        orig_lat = on_device(init_latents).float()
        noise0 = latents.float()

    def noise_to(t):
        """Start latent: the init latents noised to timestep ``t``."""
        tb = torch.full((orig_lat.shape[0],), int(t), dtype=torch.int64,
                        device=device)
        return sched_mod.ddpm_add_noise(sched, orig_lat, noise0, tb).to(dt)

    def noised_at_sigma(s):
        a = 1.0 / (1.0 + s.float() ** 2)
        return torch.sqrt(a) * orig_lat + torch.sqrt(1.0 - a) * noise0

    inpaint_extra = None
    if masked_image is not None:
        # the inpainting UNet's extra input channels, computed once: the
        # mask and the masked image's latent (its own posterior draw)
        mm, mlv = vae_mod.encode_moments(
            models["vae"], on_device(masked_image).to(dt) * 2.0 - 1.0)
        eps = draws.get("masked")
        eps = randn(mm.shape, "masked") if eps is None else on_device(eps)
        mlat = (vae_mod.sample(mm, mlv, eps=eps).float()
                * cfg.vae.scaling_factor)
        inpaint_extra = torch.cat([on_device(mask).float(), mlat],
                                  dim=-1).to(dt)

    cns = cond_embs = cscales = None
    if control_image is not None:
        # the conditioning embeddings depend on the images alone: once a
        # call, on the CFG batch; one image and one scale per branch
        cns = controlnet_mod.branches(models["controlnet"])
        imgs = controlnet_mod.branches(control_image)
        if len(imgs) != len(cns):
            raise ValueError(
                f"{len(imgs)} control images for {len(cns)} ControlNet "
                "branches — pass exactly one image per branch")
        scales = (list(controlnet_scale)
                  if isinstance(controlnet_scale, (list, tuple))
                  else [controlnet_scale] * len(cns))
        if len(scales) != len(cns):
            raise ValueError(
                f"{len(scales)} controlnet scales for {len(cns)} branches "
                "— pass one scale, or one per branch")
        cond_embs = [controlnet_mod.embed_cond(
            cn, torch.cat([on_device(img)] * 2, dim=0).to(dt))
            for cn, img in zip(cns, imgs)]
        cscales = [torch.tensor(float(sc), dtype=torch.float32,
                                device=device) for sc in scales]

    def control_residuals(lat2, ctps):
        """The branches' summed residuals at this step (``ctps``: each
        branch's slice of the hoisted time projections)."""
        total = None
        for cn, ce, sc, cp in zip(cns, cond_embs, cscales, ctps):
            r = controlnet_mod.apply(cn, lat2, None, context, ce,
                                     conditioning_scale=sc,
                                     attn_impl=attn_impl, temb_proj=cp)
            total = r if total is None else (
                tuple(a + b for a, b in zip(total[0], r[0])),
                total[1] + r[1])
        return total

    blend = blend_sigma = None
    if mask is not None and masked_image is None:
        keep = 1.0 - on_device(mask).float()

        def _blend(lat_next, noised):
            out = noised * keep + lat_next.float() * (1.0 - keep)
            return out.to(lat_next.dtype)

        def blend(lat_next, t_next):
            """The kept region at t_next's noise level (the clean init
            latents once t_next < 0)."""
            if t_next < 0:
                return _blend(lat_next, orig_lat)
            tb = torch.full((orig_lat.shape[0],), int(t_next),
                            dtype=torch.int64, device=device)
            return _blend(lat_next, sched_mod.ddpm_add_noise(
                sched, orig_lat, noise0, tb))

        def blend_sigma(lat_next, s_next):
            """The kept region at a continuous σ (σ = 0: the clean init)."""
            return _blend(lat_next, noised_at_sigma(s_next))

    def combine(out):
        out_u, out_c = out.float().chunk(2, dim=0)
        return cfg_combine(out_u, out_c, guidance_scale, guidance_rescale)

    def model_out(lat, tp, i):
        """The guided model output at ``lat`` with step ``i``'s time
        projections ``tp`` (the branches' under "ctrl"); outside
        ``cfg_interval`` one cond-only evaluation at batch B."""
        if cfg_lo is not None and not cfg_lo <= i < cfg_hi:
            if added2 is not None:
                # the per-sample tables hold the uncond ⧺ cond rows: the
                # cond half
                tp = unet_mod.map_temb(lambda a: a[a.shape[0] // 2:], tp)
            if inpaint_extra is not None:
                lat = torch.cat([lat, inpaint_extra], dim=-1)
            return unet_mod.apply(unet, lat, None, ctx_c,
                                  attn_impl=attn_impl, temb_proj=tp,
                                  freeu=freeu).float()
        lat2 = torch.cat([lat, lat], dim=0)
        if inpaint_extra is not None:
            lat2 = torch.cat([lat2, torch.cat([inpaint_extra] * 2, dim=0)],
                             dim=-1)
        residuals = None
        if cns is not None:
            tp = dict(tp)
            residuals = control_residuals(lat2, tp.pop("ctrl"))
        out = unet_mod.apply(unet, lat2, None, context, attn_impl=attn_impl,
                             temb_proj=tp, freeu=freeu,
                             control_residuals=residuals)
        return combine(out)

    def model_out_cached(lat, tp, i, cache):
        """DeepCache: the full UNet (returning its deep trunk) every
        ``cache_interval`` steps counted from t_start, else the shallow
        head and fresh tail on the cached trunk."""
        lat2 = torch.cat([lat, lat], dim=0)
        kw = dict(attn_impl=attn_impl, temb_proj=tp, cache_tail=cache_tail)
        if (i - t_start) % cache_interval == 0:
            out, cache = unet_mod.apply(unet, lat2, None, context,
                                        return_deep=True, freeu=freeu, **kw)
        else:
            out = unet_mod.apply(unet, lat2, None, context,
                                 cached_deep=cache, **kw)
        return combine(out), cache

    def to_eps(out, t, lat):
        """eps-parameterised model output (v-prediction converted)."""
        if pt != "epsilon":
            out, _ = sched_mod.to_eps_x0(sched, out, t, lat, pt)
        return out

    # the grid: host values ``ts_host`` (branches, timesteps), the same on
    # the device for the time projections; σ-space samplers also get the σ
    # grid on the host (``sig_np``) and the device (``sig``)
    sigma_space = sch == "heun" or (use_karras_sigmas and sch in KARRAS)
    if sigma_space:
        grid = sched_mod.karras_grid if use_karras_sigmas \
            else sched_mod.leading_sigma_grid
        sig_np, ts_np = grid(cfg.schedule, n)
        sig = torch.from_numpy(sig_np).to(device)
        ts_dev = torch.from_numpy(ts_np).to(device)
        ts_host = ts_np.tolist()
    else:
        if sch == "pndm":
            ts = sched_mod.pndm_timesteps(cfg.schedule, n)
        elif sch == "lcm":
            ts = sched_mod.lcm_timesteps(cfg.schedule, n)
        else:
            ts = sched_mod.ddim_timesteps(cfg.schedule, n)
        ts_host, ts_dev = ts.tolist(), ts.to(device)
    ratio = None if sch == "lcm" \
        else sched_mod.inference_stride(cfg.schedule, n)
    if orig_lat is not None:
        if t_start >= n:
            lat = orig_lat.to(dt)
        elif sigma_space:
            lat = noised_at_sigma(sig[t_start]).to(dt)
        else:
            lat = noise_to(ts_host[t_start])
    tproj = unet_mod.precompute_temb(unet, ts_dev, dtype=dt,
                                     added_cond=added2)
    if cns is not None:
        # the branches' tables ride under "ctrl" (index_temb slices them
        # with the UNet's), on the same grid: continuous timesteps on the
        # Karras σ grid
        tproj["ctrl"] = [controlnet_mod.precompute_temb(
            cn, ts_dev, dtype=dt, added_cond=added2) for cn in cns]

    def model_at(i, lat, cache):
        tp = unet_mod.index_temb(tproj, i)
        if cached:
            out, cache = model_out_cached(lat, tp, i, cache)
            return ts_host[i], out, cache
        return ts_host[i], model_out(lat, tp, i), cache

    step_draws = draws.get("step")

    def noise_at(i):
        if step_draws is not None:
            return on_device(step_draws[i])
        return randn(lat.shape, "step")

    lo, hi = t_start, t_stop
    state = None

    def eps_at_sigma(out, i, x):
        return sched_mod.sigma_to_eps_x0(out, sig[i], x, pt)[0]

    def last_first_order(i):
        """The lower-order-final safeguard below 15 steps."""
        return n < 15 and i == n - 1

    if sch == "ddim":
        def update(i, t, out, lat, state, noise):
            nlat = sched_mod.ddim_step(sched, out, t, t - ratio, lat,
                                       prediction_type=pt)
            return state, nlat if blend is None else blend(nlat, t - ratio)

    elif sch in ("dpm", "dpm_sde") and sigma_space:
        state = sched_mod.dpm_init_state(lat.shape, device)

        def update(i, t, out, lat, state, noise):
            eps = eps_at_sigma(out, i, lat)
            first = last_first_order(i)
            if sch == "dpm":
                state, lat = sched_mod.dpm_step_sigma(
                    state, eps, sig[i], sig[i + 1], lat, first_order=first)
            else:
                state, lat = sched_mod.dpm_sde_step_sigma(
                    state, eps, sig[i], sig[i + 1], lat, noise,
                    first_order=first)
            if blend_sigma is not None:
                lat = blend_sigma(lat, sig[i + 1])
            return state, lat

    elif sch in ("dpm", "dpm_sde"):
        state = sched_mod.dpm_init_state(lat.shape, device)

        def update(i, t, out, lat, state, noise):
            eps = to_eps(out, t, lat)
            first = last_first_order(i)
            if sch == "dpm":
                state, lat = sched_mod.dpm_step(
                    sched, cfg.schedule, state, eps, t, t - ratio, lat,
                    first_order=first)
            else:
                state, lat = sched_mod.dpm_sde_step(
                    sched, cfg.schedule, state, eps, t, t - ratio, lat,
                    noise, first_order=first)
            return state, lat if blend is None else blend(lat, t - ratio)

    elif sch == "unipc":
        state = sched_mod.unipc_init_state(lat.shape, device)

        def update(i, t, out, lat, state, noise):
            _, x0 = sched_mod.to_eps_x0(sched, out, t, lat, pt)
            return sched_mod.unipc_step(sched, state, x0, t, t - ratio, lat,
                                        last_step=i == t_stop - 1)

    elif sch == "lcm":
        ts_next = ts_host[1:] + [-1]

        def update(i, t, out, lat, state, noise):
            _, x0 = sched_mod.to_eps_x0(sched, out, t, lat, pt)
            nlat = sched_mod.lcm_step(sched, x0, t, ts_next[i], lat, noise,
                                      last_step=i == n - 1)
            return state, nlat if blend is None else blend(nlat, ts_next[i])

    elif sch == "heun":
        def update(i, t, out, lat, state, noise):
            eps1 = eps_at_sigma(out, i, lat)
            mid = sched_mod.euler_step_sigma(eps1, sig[i], sig[i + 1], lat)
            # the corrector's evaluation takes step i's cfg_interval choice
            out2 = model_out(mid, unet_mod.index_temb(tproj, i + 1), i)
            eps2 = eps_at_sigma(out2, i + 1, mid)
            nlat = sched_mod.heun_step_sigma(eps1, eps2, sig[i], sig[i + 1],
                                             lat)
            if blend_sigma is not None:
                nlat = blend_sigma(nlat, sig[i + 1])
            return state, nlat

        hi = max(t_stop - 1, lo)  # the last step runs after the loop

    elif sch == "euler_a" and sigma_space:
        def update(i, t, out, lat, state, noise):
            eps = eps_at_sigma(out, i, lat)
            nlat = sched_mod.euler_step_sigma(eps, sig[i], sig[i + 1], lat,
                                              noise=noise, ancestral=True)
            if blend_sigma is not None:
                nlat = blend_sigma(nlat, sig[i + 1])
            return state, nlat

    elif sch == "euler_a":
        def update(i, t, out, lat, state, noise):
            nlat = sched_mod.euler_step(sched, to_eps(out, t, lat), t,
                                        t - ratio, lat, noise=noise,
                                        ancestral=True)
            return state, nlat if blend is None else blend(nlat, t - ratio)

    elif sch == "lms":
        state = sched_mod.lms_init_state(lat.shape, device=device)
        table = sched_mod.lms_coeff_table_sigmas(sig_np) if sigma_space \
            else sched_mod.lms_coeff_table(cfg.schedule, n)
        coeffs = torch.from_numpy(table).to(device)

        def update(i, t, out, lat, state, noise):
            if sigma_space:
                return sched_mod.lms_step_sigma(
                    state, eps_at_sigma(out, i, lat), sig[i], sig[i + 1],
                    lat, coeffs[i])
            return sched_mod.lms_step(sched, state, to_eps(out, t, lat), t,
                                      t - ratio, lat, coeffs[i])

        lo, hi = 0, n

    elif sch == "pndm":
        state = sched_mod.pndm_init_state(lat.shape, lat.dtype, device)

        def update(i, t, out, lat, state, noise):
            return sched_mod.pndm_step(sched, cfg.schedule, state,
                                       to_eps(out, t, lat), t, lat, n)

        lo, hi = 0, len(ts_host)

    else:  # ddpm
        def update(i, t, out, lat, state, noise):
            # the posterior over the actual stride (see ddpm_step)
            nlat = sched_mod.ddpm_step(sched, to_eps(out, t, lat), t, lat,
                                       noise, clip_sample=False,
                                       t_prev=t - ratio)
            return state, nlat if blend is None else blend(nlat, t - ratio)

    lat = _scheduler_loop(lo, hi, lat, model_at, update, state,
                          noise_at if sch in STOCHASTIC else None)

    if sch == "heun" and t_stop > t_start:
        i_n = t_stop - 1
        eps_n = eps_at_sigma(model_out(lat, unet_mod.index_temb(tproj, i_n),
                                       i_n), i_n, lat)
        if t_stop < n and float(sig_np[i_n + 1]) > 0:
            # a truncated grid (denoising_end): σ_{i+1} > 0 has a model
            # evaluation, so the corrector stays
            mid = sched_mod.euler_step_sigma(eps_n, sig[i_n], sig[i_n + 1],
                                             lat)
            out2 = model_out(mid, unet_mod.index_temb(tproj, i_n + 1), i_n)
            lat = sched_mod.heun_step_sigma(
                eps_n, eps_at_sigma(out2, i_n + 1, mid), sig[i_n],
                sig[i_n + 1], lat)
        else:
            # the terminal step of a full run: plain Euler to σ = 0
            lat = sched_mod.euler_step_sigma(eps_n, sig[i_n], sig[i_n + 1],
                                             lat)
        if blend_sigma is not None:
            lat = blend_sigma(lat, sig[i_n + 1])

    if not decode:
        return lat
    lat_s = lat.to(dt) / cfg.vae.scaling_factor
    vae = models["vae"]
    if chunked_decode is None:
        chunked_decode = True  # one device: image by image at 512²
    if chunked_decode and lat.shape[0] > 1 \
            and lat.shape[1] * lat.shape[2] >= 4096:
        # image by image: bounds the decode's activation memory at 512²
        img = torch.cat([vae_mod.decode(vae, lat_s[j:j + 1])
                         for j in range(lat_s.shape[0])], dim=0)
    else:
        img = vae_mod.decode(vae, lat_s)
    return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)


def img2img_t_start(num_inference_steps: int, strength: float,
                    steps_offset: int = 0) -> int:
    """diffusers img2img strength → loop start index: init_timestep =
    min(int(steps·strength) + offset, steps); t_start = steps −
    init_timestep + offset (clipped at 0)."""
    if not 0.0 < strength <= 1.0:
        raise ValueError(f"strength must be in (0, 1], got {strength}")
    init_timestep = min(int(num_inference_steps * strength) + steps_offset,
                        num_inference_steps)
    return max(num_inference_steps - init_timestep + steps_offset, 0)


def preprocess_image(image, height: int, width: int) -> np.ndarray:
    """PIL image / (H,W,3) / (B,H,W,3) array → (B,H,W,3) float32 in [0,1].
    PIL inputs are bicubic-resized to (width, height); arrays must match
    already; uint8 arrays are scaled by 1/255."""
    if hasattr(image, "convert"):  # PIL.Image duck-type
        from PIL import Image

        image = image.convert("RGB")
        if image.size != (width, height):
            image = image.resize((width, height), Image.BICUBIC)
        return (np.asarray(image, np.float32) / 255.0)[None]
    arr = np.asarray(image)
    if arr.ndim == 3:
        arr = arr[None]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"init image must be (H,W,3) or (B,H,W,3), "
                         f"got {arr.shape}")
    if arr.shape[1] != height or arr.shape[2] != width:
        raise ValueError(f"init image array is {arr.shape[1]}x{arr.shape[2]} "
                         f"but height/width = {height}x{width}; resize it "
                         "or pass a PIL image to resize automatically")
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    return arr.astype(np.float32)


def preprocess_mask(mask, lat_h: int, lat_w: int) -> np.ndarray:
    """Inpainting mask → (B, lat_h, lat_w, 1) float32, 1 = regenerate: a
    PIL image (L, nearest-resized to the latent grid) or an array at image
    or latent resolution (pixel arrays max-pooled down, so a partly masked
    latent cell regenerates)."""
    if hasattr(mask, "convert"):
        from PIL import Image

        m = mask.convert("L").resize((lat_w, lat_h), Image.NEAREST)
        arr = (np.asarray(m, np.float32) / 255.0)[None]
    else:
        arr = np.asarray(mask, np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.ndim == 4 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.ndim != 3:
            raise ValueError(f"mask must be (H,W) or (B,H,W), got {arr.shape}")
        if arr.shape[1:] != (lat_h, lat_w):
            fh, fw = arr.shape[1] // lat_h, arr.shape[2] // lat_w
            if fh * lat_h != arr.shape[1] or fw * lat_w != arr.shape[2]:
                raise ValueError(
                    f"mask {arr.shape[1]}x{arr.shape[2]} is neither the "
                    f"latent grid {lat_h}x{lat_w} nor an integer multiple")
            arr = arr.reshape(arr.shape[0], lat_h, fh, lat_w, fw).max((2, 4))
    if arr.min() < 0.0 or arr.max() > 1.0:
        raise ValueError("mask values must lie in [0, 1]")
    return arr[..., None].astype(np.float32)
