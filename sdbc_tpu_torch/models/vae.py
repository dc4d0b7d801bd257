"""AutoencoderKL — SD-1.x VAE (counterpart of ``sdbc_tpu/models/vae.py``).

NHWC activations, GroupNorm(32, eps 1e-6) + SiLU, single-head mid-block
attention through the "auto" dispatch: plain attention for SD's 512-wide
head, as in the JAX package, unless ``SDBC_ATTN_IMPL`` forces "flash" or
"flash_tt", whose forward kernels take it.  ``decode`` serves sampling; ``encode_moments`` (batched or
image by image), ``sample`` and ``encode`` serve training.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn as tnn

from sdbc_tpu_torch.ops import nn
from sdbc_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def sdxl() -> "VAEConfig":
        """SDXL's VAE: the SD-1.x architecture with retrained weights and
        their diffusers scaling factor."""
        return VAEConfig(scaling_factor=0.13025)

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                         norm_groups=8)


class ResBlock(tnn.Module):
    def __init__(self, cin, cout, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(cin, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        self.norm2 = nn.GroupNorm(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        self.shortcut = nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x, groups):
        h = self.conv1(self.norm1(x, groups, act="silu"))
        h = self.conv2(self.norm2(h, groups, act="silu"))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class Attn(tnn.Module):
    """Single-head spatial self-attention at the mid block."""

    def __init__(self, ch, **kw):
        super().__init__()
        self.norm = nn.GroupNorm(ch, **kw)
        self.q, self.k = nn.Linear(ch, ch, **kw), nn.Linear(ch, ch, **kw)
        self.v, self.o = nn.Linear(ch, ch, **kw), nn.Linear(ch, ch, **kw)

    def forward(self, x, groups):
        n, h, w, c = x.shape
        y = self.norm(x, groups).reshape(n, h * w, c)
        a = attention(self.q(y)[:, None], self.k(y)[:, None],
                      self.v(y)[:, None])[:, 0]
        return x + self.o(a).reshape(n, h, w, c)


class _Mid(tnn.Module):
    def __init__(self, ch, **kw):
        super().__init__()
        self.resnet1 = ResBlock(ch, ch, **kw)
        self.attn = Attn(ch, **kw)
        self.resnet2 = ResBlock(ch, ch, **kw)


class _Block(tnn.Module):
    def __init__(self, resnets):
        super().__init__()
        self.resnets = tnn.ModuleList(resnets)


class _Coder(tnn.Module):
    pass


class VAE(tnn.Module):
    def __init__(self, cfg: VAEConfig, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.cfg = cfg
        ch = cfg.block_out_channels
        lc = cfg.latent_channels

        enc = _Coder()
        enc.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, **kw)
        enc.down = tnn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            blk = _Block(ResBlock(cin if j == 0 else cout, cout, **kw)
                         for j in range(cfg.layers_per_block))
            if i < len(ch) - 1:
                blk.downsample = nn.Conv2d(cout, cout, 3, **kw)
            enc.down.append(blk)
            cin = cout
        enc.mid = _Mid(ch[-1], **kw)
        enc.norm_out = nn.GroupNorm(ch[-1], **kw)
        enc.conv_out = nn.Conv2d(ch[-1], 2 * lc, 3, **kw)
        self.encoder = enc

        dec = _Coder()
        dec.conv_in = nn.Conv2d(lc, ch[-1], 3, **kw)
        dec.mid = _Mid(ch[-1], **kw)
        dec.up = tnn.ModuleList()
        rev = list(reversed(ch))
        cin = rev[0]
        for i, cout in enumerate(rev):
            blk = _Block(ResBlock(cin if j == 0 else cout, cout, **kw)
                         for j in range(cfg.layers_per_block + 1))
            if i < len(rev) - 1:
                blk.upsample = nn.Conv2d(cout, cout, 3, **kw)
            dec.up.append(blk)
            cin = cout
        dec.norm_out = nn.GroupNorm(rev[-1], **kw)
        dec.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, **kw)
        self.decoder = dec

        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1, **kw)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1, **kw)


def init(cfg: VAEConfig, *, device, generator=None,
         dtype=torch.float32) -> VAE:
    return VAE(cfg, device=device, generator=generator, dtype=dtype)


def prefer_chunked_encode(batch: int, h: int, w: int) -> bool:
    """True when the trainer encodes image by image: 512²-class images with
    a batch > 1 on one device (the JAX package's rule, so both packages
    take the same graph shape for the same inputs)."""
    return batch > 1 and h * w >= 262144


def encode_moments(model: VAE, x):
    """x: (N,H,W,3) in [-1,1] → (mean, logvar) each (N,H/8,W/8,latent),
    logvar clipped to [-30, 20]."""
    g = model.cfg.norm_groups
    enc = model.encoder
    h = enc.conv_in(x)
    for blk in enc.down:
        for r in blk.resnets:
            h = r(h, g)
        if hasattr(blk, "downsample"):
            h = F.pad(h, (0, 0, 0, 1, 0, 1))  # asymmetric: bottom/right only
            h = blk.downsample(h, stride=2, padding=0)
    h = enc.mid.resnet1(h, g)
    h = enc.mid.attn(h, g)
    h = enc.mid.resnet2(h, g)
    h = enc.norm_out(h, g, act="silu")
    h = enc.conv_out(h)
    mean, logvar = model.quant_conv(h).chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def encode_moments_chunked(model: VAE, x):
    """``encode_moments`` computed image by image (``prefer_chunked_encode``
    picks it)."""
    parts = [encode_moments(model, x[i:i + 1]) for i in range(x.shape[0])]
    return (torch.cat([m for m, _ in parts]),
            torch.cat([lv for _, lv in parts]))


def sample(mean, logvar, generator=None, eps=None):
    """Reparameterised draw from the diagonal Gaussian posterior, in fp32,
    cast back to mean's dtype.  The standard normal ``eps`` is given, or
    drawn from ``generator``."""
    std = torch.exp(0.5 * logvar.float())
    if eps is None:
        if generator is None:
            raise ValueError("vae.sample needs a torch.Generator or eps")
        eps = torch.randn(mean.shape, generator=generator,
                          device=mean.device, dtype=torch.float32)
    return (mean.float() + std * eps.float()).to(mean.dtype)


def encode(model: VAE, x, generator=None, eps=None):
    mean, logvar = encode_moments(model, x)
    return sample(mean, logvar, generator=generator, eps=eps)


def decode(model: VAE, z):
    """z: (N,h,w,latent) (already un-scaled by the caller) → (N,8h,8w,3)
    in [-1, 1]."""
    g = model.cfg.norm_groups
    dec = model.decoder
    h = model.post_quant_conv(z)
    h = dec.conv_in(h)
    h = dec.mid.resnet1(h, g)
    h = dec.mid.attn(h, g)
    h = dec.mid.resnet2(h, g)
    for blk in dec.up:
        for r in blk.resnets:
            h = r(h, g)
        if hasattr(blk, "upsample"):
            h = blk.upsample(nn.upsample_nearest_2x(h))
    h = dec.norm_out(h, g, act="silu")
    return dec.conv_out(h)
