"""NN primitives (counterpart of ``sdbc_tpu/ops/nn.py``).

Public functions take and return NHWC activations, as the JAX package does.
Parameters keep the JAX package's layouts: linear weights ``(in, out)``,
conv weights HWIO (so an optimizer that walks a leaf's elements in memory
order, like the 8-bit AdamW's 2048-element blocks, sees the same order).
Norm statistics are fp32; the result is cast back to the input dtype.

These stay plain PyTorch (cuDNN convolutions, ``F.group_norm``): the JAX
package leaves them to XLA too.  ``SDBC_GN_FUSED=1`` (read at call time)
sends the GroupNorms that ``pallas_groupnorm.eligible`` admits to the fused
kernel, as it sends them to the Pallas kernel in the JAX package.  The ``nn.Module`` wrappers below name their
parameters ``weight``/``bias`` so a module's ``state_dict`` keys follow the
JAX tree paths (``down.0.resnets.1.conv1.weight`` ↔
``["down"][0]["resnets"][1]["conv1"]["w"]``).

Every initialiser takes an explicit ``torch.Generator`` (on ``device``); with
``generator=None`` parameters are left uninitialised for
``models.convert.load_jax_params`` to fill.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sdbc_tpu_torch.ops import pallas_groupnorm


# ---------------------------------------------------------------------------
# initialisers


def _normal(shape, generator, device, dtype, std=1.0):
    if generator is None:
        return torch.empty(shape, device=device, dtype=dtype)
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).mul_(std).to(dtype)


def _uniform(shape, bound, generator, device, dtype):
    if generator is None:
        return torch.empty(shape, device=device, dtype=dtype)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return (u * (2 * bound) - bound).to(dtype)


def _const(shape, value, generator, device, dtype):
    if generator is None:
        return torch.empty(shape, device=device, dtype=dtype)
    return torch.full(shape, float(value), device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# plain functions on tensors


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with ``weight`` stored (in, out)."""
    y = torch.matmul(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def conv2d(x, weight, bias=None, stride: int = 1, padding="SAME"):
    """NHWC conv with an HWIO weight.  padding: 'SAME' (stride 1) | int.

    The NHWC input is a channels-last NCHW view; the weight goes to the
    convolution as a channels-last OIHW copy in the input's dtype."""
    if padding == "SAME":
        if stride != 1:
            raise ValueError("SAME padding is only defined here for stride 1")
        padding = weight.shape[0] // 2
    w = weight.permute(3, 2, 0, 1).to(x.dtype,
                                      memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w,
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-6,
               act: Optional[str] = None):
    """GroupNorm over contiguous channel groups of an NHWC tensor
    (channel ``ch`` → group ``ch // (C/G)``), fp32 statistics and affine,
    optional fused SiLU, cast back to the input dtype."""
    if act in (None, "silu") and os.environ.get("SDBC_GN_FUSED", "0") == "1" \
            and pallas_groupnorm.eligible(x, num_groups):
        return pallas_groupnorm.fused_group_norm(x, weight, bias, num_groups,
                                                 eps, act)
    dt = x.dtype
    xf = x.float().permute(0, 3, 1, 2)
    y = F.group_norm(xf, num_groups, weight.float(), bias.float(), eps)
    if act == "silu":
        y = F.silu(y)
    elif act is not None:
        raise ValueError(f"unknown act {act}")
    return y.to(dt).permute(0, 2, 3, 1)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(dt)


def embedding(ids, table):
    return F.embedding(ids, table)


def quick_gelu(x):
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def timestep_embedding(t, dim: int, dtype=torch.float32):
    """Sinusoidal embedding, SD-1.x layout [cos | sin] (flip_sin_to_cos,
    downscale_freq_shift=0).  t: (B,) → (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def upsample_nearest_2x(x):
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, h * 2, w * 2, c)


# ---------------------------------------------------------------------------
# modules (parameter holders; names follow the JAX tree)


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, *,
                 device, generator=None, dtype=torch.float32):
        super().__init__()
        # normal/sqrt(fan_in) weights + zero bias, as the JAX package
        self.weight = nn.Parameter(_normal((in_dim, out_dim), generator,
                                           device, dtype,
                                           1.0 / math.sqrt(in_dim)))
        self.bias = (nn.Parameter(_const((out_dim,), 0.0, generator, device,
                                         dtype)) if use_bias else None)

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 use_bias: bool = True, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        bound = 1.0 / math.sqrt(in_ch * kernel * kernel)
        self.weight = nn.Parameter(_uniform((kernel, kernel, in_ch, out_ch),
                                            bound, generator, device, dtype))
        self.bias = (nn.Parameter(_uniform((out_ch,), bound, generator,
                                           device, dtype))
                     if use_bias else None)

    def forward(self, x, stride: int = 1, padding="SAME"):
        return conv2d(x, self.weight, self.bias, stride, padding)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(_const((channels,), 1.0, generator, device,
                                          dtype))
        self.bias = nn.Parameter(_const((channels,), 0.0, generator, device,
                                        dtype))

    def forward(self, x, num_groups: int, eps: float = 1e-6, act=None):
        return group_norm(x, self.weight, self.bias, num_groups, eps, act)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(_const((dim,), 1.0, generator, device,
                                          dtype))
        self.bias = nn.Parameter(_const((dim,), 0.0, generator, device,
                                        dtype))

    def forward(self, x, eps: float = 1e-5):
        return layer_norm(x, self.weight, self.bias, eps)


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(_normal((vocab, dim), generator, device,
                                           dtype, 0.02))

    def forward(self, ids):
        return embedding(ids, self.weight)
