"""Attention dispatch (counterpart of ``sdbc_tpu/ops/attention.py``).

Shapes are (B, H, S, D) for ``plain_attention``/``attention`` and the
projection layout (B, S, H, D) for ``attention_bshd_inference``.

impl:
  "auto"      — the training flash kernel (``flash_attention``, with its
                gradient) for a tensor on CUDA that the JAX package's
                ``_flash_eligible`` admits: non-causal, ≥ 256 KV tokens,
                ≥ 128 queries, head dim ≤ 256 and B·H·Sq ≤ 300000 rows;
                ``plain_attention`` otherwise (the 77-token
                cross-attention, the 8² mid block, CLIP, the VAE's 512-wide
                head, and every CPU tensor)
  "inference" — sampling dispatch: the fixed-cap flash kernel for a tensor on
                CUDA with ≥ 256 non-causal KV tokens, ``plain_attention``
                otherwise (the 77-token cross-attention, the 8² mid block,
                CLIP, and every CPU tensor)
"""
from __future__ import annotations

from typing import Optional

import torch

from sdbc_tpu_torch.ops import flash_attention

# the flash kernels pay off for the UNet's spatial self-attention only
_MIN_FLASH_KV = 256
# training flash: the JAX package's _flash_eligible limits
_MIN_FLASH_Q = 128
_MAX_FLASH_D = 256
_MAX_FLASH_ROWS = 300000


def plain_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """softmax(q kᵀ · scale) v with fp32 logits and softmax; a causal mask
    with sq != sk is right-aligned (query i sees keys 0..i+(sk-sq))."""
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi + (sk - sq),
                                    torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def _flash_dispatch(q, k, causal: bool, seq_dim: int) -> bool:
    return q.is_cuda and not causal and k.shape[seq_dim] >= _MIN_FLASH_KV


def _flash_eligible(q, k, causal: bool) -> bool:
    """The training flash rule over head-major (B, H, S, D) tensors."""
    sq, d = q.shape[-2], q.shape[-1]
    rows = q.numel() // d
    return (_flash_dispatch(q, k, causal, -2) and sq >= _MIN_FLASH_Q
            and d <= _MAX_FLASH_D and rows <= _MAX_FLASH_ROWS)


def attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
              impl: str = "auto"):
    if impl not in ("auto", "inference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "inference" and _flash_dispatch(q, k, causal, -2):
        return flash_attention.flash_attention_fixed(q, k, v, scale=scale)
    if impl == "auto" and _flash_eligible(q, k, causal):
        return flash_attention.flash_attention(q, k, v, scale=scale)
    return plain_attention(q, k, v, causal=causal, scale=scale)


def attention_bshd_inference(q4, k4, v4, *, scale: Optional[float] = None):
    """Inference attention over (B, S, H, D) projection-layout tensors: the
    fixed-cap kernel reads the heads in place through its strides; every
    other case goes through the head-major dispatch (same math)."""
    if _flash_dispatch(q4, k4, False, 1):
        return flash_attention.flash_attention_fixed_bshd(q4, k4, v4,
                                                          scale=scale)
    tr = lambda t: t.transpose(1, 2)
    return tr(attention(tr(q4), tr(k4), tr(v4), scale=scale,
                        impl="inference"))
