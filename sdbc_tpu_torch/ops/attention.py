"""Attention dispatch (counterpart of ``sdbc_tpu/ops/attention.py``).

Shapes are (B, H, S, D) for ``plain_attention``/``attention`` and the
projection layout (B, S, H, D) for ``attention_bshd_inference``.

impl:
  "auto"      — the training flash kernel (``flash_attention``, with its
                gradient) for a tensor on CUDA that the JAX package's
                ``_flash_eligible`` admits: ≥ 256 KV tokens (or any with
                ``SDBC_ATTN_CROSS`` set to other than "xla"), ≥ 128
                queries, head dim ≤ 256 and B·H·Sq ≤ ``SDBC_FLASH_MAX_ROWS``
                (300000) rows; ``plain_attention`` otherwise (the 77-token
                cross-attention, the 8² mid block, the VAE's 512-wide head,
                and every CPU tensor)
  "inference" — sampling dispatch: the fixed-cap flash kernel for a tensor on
                CUDA with ≥ 256 non-causal KV tokens, ``plain_attention``
                otherwise (the 77-token cross-attention, the 8² mid block,
                CLIP, and every CPU tensor)
  "xla"       — ``plain_attention`` (the JAX name, so one switch works in
                both packages)
  "flash"     — the training flash kernel, with no eligibility check
  "flash_tt"  — the transposed-layout training flash kernel
                (``flash_attention_tt``)

The rules read no dtype and no head dim beyond the JAX package's: its
kernels take any dtype and pad any head dim.  Each kernel entry point
takes a CUDA tensor that its tensor-core kernel does not take (fp32, a
head dim that is not a multiple of 8) to the CUDA-core kernel of the same
function (``flash_simt``).

``SDBC_ATTN_IMPL`` (read at call time) overrides "auto" and "inference"; an
unknown value raises.  With it set, ``attention_bshd_inference`` leaves the
projection-layout kernel for the head-major dispatch.  Causal attention
reaches no kernel: the flash entry points send it to ``plain_attention``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from sdbc_tpu_torch.ops import flash_attention, flash_attention_tt

IMPLS = ("auto", "inference", "xla", "flash", "flash_tt")
# the flash kernels pay off for the UNet's spatial self-attention only
_MIN_FLASH_KV = 256
# training flash: the JAX package's _flash_eligible limits
_MIN_FLASH_Q = 128
_MAX_FLASH_D = 256


def _on_cuda(t) -> bool:
    return t.is_cuda


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
    """The fixed-cap (inference) rule."""
    return _on_cuda(q) and not causal and k.shape[seq_dim] >= _MIN_FLASH_KV


def _flash_eligible(q, k) -> bool:
    """The training flash rule over head-major (B, H, S, D) tensors."""
    if not _on_cuda(q):
        return False
    sq, d = q.shape[-2], q.shape[-1]
    if k.shape[-2] < _MIN_FLASH_KV \
            and os.environ.get("SDBC_ATTN_CROSS", "xla") == "xla":
        return False
    rows = q.numel() // d
    if rows > int(os.environ.get("SDBC_FLASH_MAX_ROWS", "300000")):
        return False
    return sq >= _MIN_FLASH_Q and d <= _MAX_FLASH_D


def attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
              impl: str = "auto"):
    if impl in ("auto", "inference"):
        impl = os.environ.get("SDBC_ATTN_IMPL", impl)
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "inference":
        if _flash_dispatch(q, k, causal, -2):
            return flash_attention.flash_attention_fixed(q, k, v, scale=scale)
        return plain_attention(q, k, v, causal=causal, scale=scale)
    if impl == "flash" or (impl == "auto" and _flash_eligible(q, k)):
        return flash_attention.flash_attention(q, k, v, causal=causal,
                                               scale=scale)
    if impl == "flash_tt":
        return flash_attention_tt.flash_attention_tt(q, k, v, causal=causal,
                                                     scale=scale)
    return plain_attention(q, k, v, causal=causal, scale=scale)


def attention_bshd_inference(q4, k4, v4, *, scale: Optional[float] = None):
    """Inference attention over (B, S, H, D) projection-layout tensors: the
    fixed-cap kernel reads the heads in place through its strides unless
    ``SDBC_ATTN_IMPL`` is set; every other case goes through the head-major
    dispatch (same math)."""
    if _flash_dispatch(q4, k4, False, 1) and "SDBC_ATTN_IMPL" not in os.environ:
        return flash_attention.flash_attention_fixed_bshd(q4, k4, v4,
                                                          scale=scale)
    tr = lambda t: t.transpose(1, 2)
    return tr(attention(tr(q4), tr(k4), tr(v4), scale=scale,
                        impl="inference"))
