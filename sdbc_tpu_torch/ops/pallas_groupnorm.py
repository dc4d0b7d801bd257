"""Fused GroupNorm(+SiLU) (counterpart of ``sdbc_tpu/ops/pallas_groupnorm.py``).

``nn.group_norm`` routes here under ``SDBC_GN_FUSED=1`` when ``eligible``
holds: the JAX package's rule, with its TPU test replaced by a CUDA one —
the channels divide into the groups and one sample's fp32 working copy is
at most 6 MiB (kept as it is, so the same tensors take the kernel in both
packages).  At SD-1.5 512² that admits the UNet's 64²×320 tensors, every
32² tensor up to 1280 channels and all 16² and 8² ones; not 64²×640/960,
32²×1920 or any VAE tensor.

The math (``group_norm_fused_ref``, the kernel's formula): fp32 channel
sums s1 = Σx and s2 = Σx² over the rows, group sums of those, mean =
s1/count and var = max(s2/count − mean², 0) with count = rows·C/G,
inv = rsqrt(var + eps); per channel a = inv·scale and b = bias − mean·a;
y = x·a + b, SiLU if asked, cast back to x's dtype.

On CUDA the forward is the kernel of ``csrc/group_norm.cu``; on a CPU tensor
it is ``group_norm_fused_ref``.  The gradient recomputes through
``group_norm_fused_ref`` under autograd, as the JAX package's custom VJP
does through its reference (it has no backward kernel either).
"""
from __future__ import annotations

from typing import Optional

import torch

from sdbc_tpu_torch.ops import _kernels

VMEM_BYTES_LIMIT = 6 * 1024 * 1024  # the JAX rule's per-sample fp32 budget
CHUNK_ROWS = 64  # rows per block of the kernel's statistics and apply passes


def _on_cuda(x) -> bool:
    return x.is_cuda


def fits(shape, num_groups: int) -> bool:
    """The JAX rule on a shape (N, ..., C): C divides into the groups and
    one sample's fp32 copy is at most 6 MiB."""
    per_sample = 4
    for n in shape[1:]:
        per_sample *= n
    return shape[-1] % num_groups == 0 and per_sample <= VMEM_BYTES_LIMIT


def eligible(x, num_groups: int) -> bool:
    return _on_cuda(x) and fits(tuple(x.shape), num_groups)


def group_norm_fused_ref(x, weight, bias, num_groups: int, eps: float,
                         act: Optional[str] = None):
    """The plain version, over (N, ..., C) with the kernel's formula."""
    n, c = x.shape[0], x.shape[-1]
    cpg = c // num_groups
    xf = x.reshape(n, -1, c).float()
    count = float(xf.shape[1] * cpg)
    s1 = xf.sum(dim=1).view(n, num_groups, cpg).sum(dim=-1)
    s2 = (xf * xf).sum(dim=1).view(n, num_groups, cpg).sum(dim=-1)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(cpg, dim=1) * weight.float()
    b = bias.float() - mean.repeat_interleave(cpg, dim=1) * a
    y = xf * a[:, None, :] + b[:, None, :]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def _launch(x, weight, bias, num_groups: int, eps: float, silu: bool):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gn_fused kernel takes bfloat16 or float32, got "
                        f"{x.dtype}")
    if x.dim() < 2 or x.numel() == 0 or x.shape[-1] % num_groups:
        raise ValueError(f"gn_fused: {tuple(x.shape)} with {num_groups} "
                         f"groups")
    n, c = x.shape[0], x.shape[-1]
    x3 = x.contiguous().reshape(n, -1, c)
    chunks = -(-x3.shape[1] // CHUNK_ROWS)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x3)
    part = torch.empty((n, chunks, 2, c), **f32)
    ab = torch.empty((n, 2, c), **f32)
    _kernels.group_norm(x3, weight.float().contiguous(),
                        bias.float().contiguous(), y, part, ab, num_groups,
                        CHUNK_ROWS, eps, silu)
    return y.reshape(x.shape)


class _FusedGroupNorm(torch.autograd.Function):
    """The custom VJP ``_gn``: the kernel forward, a backward through the
    plain reference."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, act)
        if x.device.type == "cpu":
            return group_norm_fused_ref(x, weight, bias, num_groups, eps, act)
        if x.device.type != "cuda":
            raise ValueError(f"gn_fused: no kernel for device {x.device}")
        return _launch(x, weight, bias, num_groups, eps, act == "silu")

    @staticmethod
    def backward(ctx, gy):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in (x, weight, bias)]
            y = group_norm_fused_ref(*xs, *ctx.cfg)
            dx, dw, db = torch.autograd.grad(y, xs, gy)
        return dx, dw, db, None, None, None


def fused_group_norm(x, weight, bias, num_groups: int = 32,
                     eps: float = 1e-6, act: Optional[str] = None):
    """Drop-in for ``nn.group_norm`` when ``eligible`` holds: NHWC (or
    N…C) ``x``, per-channel ``weight``/``bias``."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act}")
    return _FusedGroupNorm.apply(x, weight, bias, num_groups, eps, act)
