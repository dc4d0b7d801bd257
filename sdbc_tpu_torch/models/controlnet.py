"""ControlNet — the spatially-conditioned control branch (counterpart of
``sdbc_tpu/models/controlnet.py``; arXiv:2302.05543).

A trainable copy of the UNet's encoder half (conv_in, the down blocks and
the mid block, SDXL's ``add_mlp`` too) that reads a conditioning image
(edges, a sketch, a layout) and gives the frozen base UNet one residual
per skip tensor and one for the mid block's output, through zero-init
1×1 convs: a fresh branch leaves the base exactly as it was.

The encoder half is built from the UNet's own modules (``unet.
down_blocks``, ``_Mid``, ``_TimeMLP``), so its parameter names are the
JAX tree's and ``from_unet`` copies the base's subtrees.  Beside them:

- ``cond_embedding``: conv_in (3 → cc[0]), then per step of the ramp a
  3×3 conv and a stride-2 3×3 conv (``blocks.<k>``, a list as in the JAX
  tree), then a zero-init conv_out to ``block_out_channels[0]``: the
  (N, H, W, 3) image in [0, 1] at latent resolution.  The number of
  stride-2 convs must be the VAE's down-factor's log2.
- ``zero_down.<k>`` / ``zero_mid``: the zero-init 1×1 convs.

Convolutions are NHWC with HWIO weights as in the rest of the port.  The
branch's spatial transformers are the UNet's ``Transformer``: sampling
(``attn_impl="inference"``) takes the fixed-cap flash kernel and the fused
GEGLU kernel on CUDA where the base would, training ("auto") the training
flash kernels.  Sampling hoists ``embed_cond`` (the image alone decides
it) and the time projections (``precompute_temb``) out of the loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from sdbc_tpu_torch.models import unet as unet_mod
from sdbc_tpu_torch.ops import nn


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    unet: unet_mod.UNetConfig = dataclasses.field(
        default_factory=unet_mod.UNetConfig)
    # the conditioning embedder's channel ramp: len - 1 stride-2 convs, so
    # the spatial reduction must be the VAE's (8 for SD: 512² → 64²)
    conditioning_channels: Tuple[int, ...] = (16, 32, 96, 256)

    @property
    def spatial_reduction(self) -> int:
        return 2 ** (len(self.conditioning_channels) - 1)

    @staticmethod
    def sd15() -> "ControlNetConfig":
        """The layout of ``lllyasviel/sd-controlnet-canny``."""
        return ControlNetConfig()

    @staticmethod
    def tiny() -> "ControlNetConfig":
        # the tiny pipeline's 2-level VAE (f2): one stride-2 conv
        return ControlNetConfig(unet=unet_mod.UNetConfig.tiny(),
                                conditioning_channels=(8, 16))


def conditioning_ramp(vae_scale: int) -> Tuple[int, ...]:
    """The embedder ramp for a VAE of down-factor ``vae_scale`` (the JAX
    package's ``PipelineConfig.with_controlnet``): f8 (SD-1.x/2.x) the
    diffusers (16, 32, 96, 256), shallower VAEs (the tiny) a truncated
    ramp, deeper ones extended at the widest stage."""
    n = int(math.log2(vae_scale)) + 1
    if n == 4:
        return (16, 32, 96, 256)
    if n < 4:
        return (8, 16, 96, 256)[:n]
    return (16, 32, 96, 256) + (256,) * (n - 4)


def num_skips(cfg: unet_mod.UNetConfig) -> int:
    """conv_in + one per down-block ResBlock + one per downsample."""
    return len(unet_mod.skip_channels(cfg))


def _skip_channels(cfg: unet_mod.UNetConfig):
    return unet_mod.skip_channels(cfg)


def _zero_conv(cin: int, cout: int, kernel: int = 1, *, device,
               generator=None, dtype=torch.float32):
    """A conv of zero weight and bias (left empty without a generator,
    for ``load_jax_params`` to fill)."""
    conv = nn.Conv2d(cin, cout, kernel, device=device, generator=None,
                     dtype=dtype)
    if generator is not None:
        with torch.no_grad():
            conv.weight.zero_()
            conv.bias.zero_()
    return conv


class CondEmbedding(tnn.Module):
    def __init__(self, cfg: ControlNetConfig, **kw):
        super().__init__()
        cc = cfg.conditioning_channels
        self.conv_in = nn.Conv2d(3, cc[0], 3, **kw)
        self.blocks = tnn.ModuleList()
        for i in range(len(cc) - 1):
            self.blocks.append(nn.Conv2d(cc[i], cc[i], 3, **kw))
            self.blocks.append(nn.Conv2d(cc[i], cc[i + 1], 3, **kw))
        # zero-init: a fresh branch starts as an exact no-op on the base
        self.conv_out = _zero_conv(cc[-1], cfg.unet.block_out_channels[0],
                                   3, **kw)


class ControlNet(tnn.Module):
    """The branch's parameters (names follow the JAX tree).  With a
    ``generator``: a random encoder half (``from_unet`` starts from a
    base instead) and zero output convs; without one, left uninitialised
    for ``models.convert.load_jax_params``."""

    def __init__(self, cfg: ControlNetConfig, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.cfg = cfg
        u = cfg.unet
        ch, ted = u.block_out_channels, u.time_embed_dim
        self.conv_in = nn.Conv2d(u.in_channels, ch[0], 3, **kw)
        self.time_mlp = unet_mod._TimeMLP(ch[0], ted, **kw)
        if u.addition_embed_dim:  # SDXL: conditioned like the base
            self.add_mlp = unet_mod._TimeMLP(u.addition_embed_dim, ted, **kw)
        self.down, skip_ch = unet_mod.down_blocks(u, **kw)
        self.mid = unet_mod._Mid(ch[-1], u.cross_attention_dim, ted,
                                 u.heads_per_level[-1],
                                 u.depth_per_level[-1], **kw)
        self.cond_embedding = CondEmbedding(cfg, **kw)
        self.zero_down = tnn.ModuleList(_zero_conv(c, c, **kw)
                                        for c in skip_ch)
        self.zero_mid = _zero_conv(ch[-1], ch[-1], **kw)


def init(cfg: ControlNetConfig, *, device, generator=None,
         dtype=torch.float32) -> ControlNet:
    return ControlNet(cfg, device=device, generator=generator, dtype=dtype)


# the base UNet's subtrees a branch starts from
SHARED = ("conv_in", "time_mlp", "add_mlp", "down", "mid")


@torch.no_grad()
def from_unet(unet, generator: torch.Generator, cfg: ControlNetConfig, *,
              device=None, dtype=torch.float32) -> ControlNet:
    """A branch cloned from the base ``unet``'s encoder half (the
    arXiv:2302.05543 start): its conv_in, time MLP, down and mid blocks
    (and SDXL's ``add_mlp``) copied, the conditioning embedder drawn from
    ``generator`` and the output convs zero, so step 0 reproduces the base
    exactly.  ``device``: the generator's device by default."""
    device = device if device is not None else generator.device
    cn = ControlNet(cfg, device=device, generator=None, dtype=dtype)
    for name in SHARED:
        if hasattr(cn, name):
            dst, src = getattr(cn, name), getattr(unet, name)
            for p, q in zip(dst.parameters(), src.parameters(), strict=True):
                p.copy_(q.to(p.dtype))
    kw = dict(device=device, generator=generator, dtype=dtype)
    cn.cond_embedding = CondEmbedding(cfg, **kw)
    for conv in (*cn.zero_down, cn.zero_mid):
        conv.weight.zero_()
        conv.bias.zero_()
    return cn


def branches(value) -> list:
    """One branch or a list of them (multi-ControlNet) as a list."""
    return list(value) if isinstance(value, (list, tuple)) else [value]


def embed_cond(model: ControlNet, control_image):
    """(N, H, W, 3) control image in [0, 1] → (N, h, w, ch0) at latent
    resolution (JAX ``controlnet.py:144-160``).  Depends only on the
    image: sampling computes it once a call."""
    ce = model.cond_embedding
    x = control_image
    if x.shape[-1] != 3:
        raise ValueError(f"control image must be (N, H, W, 3), got "
                         f"{tuple(x.shape)}")
    x = F.silu(ce.conv_in(x))
    for i in range(0, len(ce.blocks), 2):
        x = F.silu(ce.blocks[i](x))
        x = F.silu(ce.blocks[i + 1](x, stride=2, padding=1))
    return ce.conv_out(x)


_SOBEL = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def edge_hint(pixels):
    """Sobel-edge conditioning hint (JAX ``controlnet.py:163-185``):
    (N, H, W, 3) in [-1, 1] → [0, 1], the gradient magnitude of the grey
    image (zero padding) over its per-image maximum, on 3 channels."""
    gray = pixels.float().mean(dim=-1, keepdim=True) * 0.5 + 0.5
    kx = torch.tensor(_SOBEL, dtype=torch.float32, device=pixels.device)
    w = torch.stack([kx, kx.t()])[:, None]       # (2, 1, 3, 3) OIHW
    g = F.conv2d(gray.permute(0, 3, 1, 2), w, padding=1)
    mag = torch.sqrt(g[:, :1] ** 2 + g[:, 1:] ** 2).permute(0, 2, 3, 1)
    peak = mag.amax(dim=(1, 2, 3), keepdim=True)
    mag = mag / torch.clamp(peak, min=1e-6)
    return mag.expand(*mag.shape[:-1], 3)


def training_hint(pixels, kind: str):
    """The training hint (JAX ``controlnet.py:188-195``): "edges" the
    Sobel magnitude, "image" the target image itself in [0, 1]."""
    if kind == "edges":
        return edge_hint(pixels)
    if kind == "image":
        return pixels.float() * 0.5 + 0.5
    raise ValueError(f"unknown control hint {kind!r} (edges | image)")


def precompute_temb(model: ControlNet, timesteps, dtype=torch.bfloat16,
                    added_cond=None):
    """``unet.precompute_temb`` for the branch (down and mid only; JAX
    ``controlnet.py:198-227``): (T, cout) tables, or (T, N, 1, 1, cout)
    with SDXL's ``added_cond`` (required exactly when the config sets
    ``addition_embed_dim``)."""
    u = model.cfg.unet
    if (added_cond is None) != (not u.addition_embed_dim):
        raise ValueError("precompute_temb: added_cond must be passed "
                         "exactly when cfg.unet.addition_embed_dim is set")
    temb = unet_mod._temb_mlp(model, timesteps, dtype)
    if added_cond is not None:
        aug = unet_mod._add_embedding(model, added_cond)
        temb = temb[:, None, :] + aug[None].to(temb.dtype)  # (T, N, ted)
    st = F.silu(temb)

    def proj(r):
        out = r.temb(st)
        return out if added_cond is None else out[:, :, None, None]

    return {"down": [{"resnets": [proj(r) for r in blk.resnets]}
                     for blk in model.down],
            "mid": {"resnet1": proj(model.mid.resnet1),
                    "resnet2": proj(model.mid.resnet2)}}


def apply(model: ControlNet, latents, timesteps, encoder_hidden_states,
          cond_emb, *, conditioning_scale=1.0, remat: bool = False,
          attn_impl: str = "auto", temb_proj=None, added_cond=None):
    """The encoder half's forward → (down residuals, mid residual) (JAX
    ``controlnet.py:230-303``), in the order of the base UNet's skip
    appends, for ``unet.apply(control_residuals=...)``.

    ``cond_emb``: ``embed_cond``'s output.  ``conditioning_scale``: a
    float or a 0-d tensor, cast to the latents' dtype and multiplied into
    every residual.  ``remat``: each ResBlock and spatial transformer
    checkpointed (the JAX branch's "block" granularity).  ``temb_proj``:
    this step's slice of ``precompute_temb``, else ``timesteps`` (floats
    allowed: the sinusoids take continuous t) embedded inline, with
    SDXL's ``added_cond``."""
    u = model.cfg.unet
    if temb_proj is None and (added_cond is None) != \
            (not u.addition_embed_dim):
        raise ValueError("added_cond must be passed exactly when "
                         "cfg.unet.addition_embed_dim is set (SDXL "
                         "ControlNet)")
    if added_cond is not None and temb_proj is not None:
        raise ValueError("added_cond is already in the temb_proj tables "
                         "(precompute_temb added_cond): pass only one")
    g = u.norm_groups
    ctx = encoder_hidden_states
    if temb_proj is None:
        temb = unet_mod._temb_mlp(model, timesteps, latents.dtype)
        if added_cond is not None:
            temb = temb + unet_mod._add_embedding(model, added_cond).to(
                temb.dtype)
        tp_down = [{"resnets": [None] * len(b.resnets)} for b in model.down]
        tp_mid = {"resnet1": None, "resnet2": None}
    else:
        temb = None
        tp_down, tp_mid = temb_proj["down"], temb_proj["mid"]

    def res(r, h, tp):
        if remat:
            return unet_mod._checkpoint(r, h, temb, g, tp)
        return r(h, temb, g, tp)

    def tfm(t, h):
        if remat:
            return unet_mod._checkpoint(t, h, ctx, g, attn_impl)
        return t(h, ctx, g, attn_impl)

    h = model.conv_in(latents) + cond_emb.to(latents.dtype)
    skips = [h]
    for blk, tp in zip(model.down, tp_down):
        for j, r in enumerate(blk.resnets):
            h = res(r, h, tp["resnets"][j])
            if len(blk.attns):
                h = tfm(blk.attns[j], h)
            skips.append(h)
        if hasattr(blk, "downsample"):
            h = blk.downsample(h, stride=2, padding=1)
            skips.append(h)
    h = res(model.mid.resnet1, h, tp_mid["resnet1"])
    h = tfm(model.mid.attn, h)
    h = res(model.mid.resnet2, h, tp_mid["resnet2"])

    s = torch.as_tensor(conditioning_scale, device=latents.device).to(
        latents.dtype)
    down = tuple(z(sk) * s for z, sk in zip(model.zero_down, skips))
    return down, model.zero_mid(h) * s
