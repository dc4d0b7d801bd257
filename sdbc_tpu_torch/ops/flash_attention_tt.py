"""Transposed-layout training flash attention (counterpart of
``sdbc_tpu/ops/flash_attention_tt.py``), reached by ``attention(impl=
"flash_tt")`` or ``SDBC_ATTN_IMPL=flash_tt``.

The forward computes what the training forward computes (q prescaled by
scale·log2e in fp32 and rounded once to the input dtype, a running max in
log2 units, p rounded to v's dtype before the PV product, the natural-log
LSE = m·ln2 + ln l), from head-dim-major (B·H, D, S) operands built as the
JAX package's ``to_tt`` builds them, and writes its output the same way;
the caller gets the (B, H, Sq, D) view of it.  On CUDA that is the
head-dim-major variant of K5's TMA-fed wgmma kernel: for head dims up to
256 that of ``csrc/flash_fwd_sm90.cu``, above (up to 512) that of
``csrc/flash_fwd_wide_sm90.cu``; what those do not take goes to the
natural-layout forward that ``flash_attention.route`` names, the same
function (fp32 at head dims that are a multiple of 8 up to 256 the
3xTF32 kernel of ``flash_tf32``, the rest the CUDA-core forward of
``flash_simt``); on a CPU tensor it is
``flash_attention.flash_attention_ref``, the plain version of the same
function.  ``_FlashTT``'s backward is the training backward
(``flash_attention_bwd.flash_bwd``) over the unscaled q and the residuals
in the natural layout.
"""
from __future__ import annotations

from typing import Optional

import torch

from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as fa
from sdbc_tpu_torch.ops.flash_attention_bwd import flash_bwd


def to_tt(x):
    """(B, H, S, D) → a contiguous head-dim-major (B, H, D, S8) copy, the
    sequence zero-padded to a multiple of 8 (the kernel's 16-byte loads)."""
    b, h, s, d = x.shape
    xt = x.new_zeros((b, h, d, s + (-s) % 8))
    xt[..., :s] = x.transpose(-1, -2)
    return xt


def flash_fwd_tt(q, k, v, scale: float):
    """(out (B, H, Sq, D), lse (B, H, Sq) fp32) of the transposed-layout
    forward: the kernel on CUDA (head dims up to 256 the wgmma kernel of
    ``csrc/flash_fwd_sm90.cu``, wider ones ``csrc/flash_fwd_wide_sm90.cu``'s),
    the plain version on the CPU."""
    if fa._on_cpu(q):
        return fa.flash_attention_ref(q, k, v, scale)
    if fa._route(q, k, v, fixed=False) != "flash_fwd":
        # the natural-layout forward of the same function: fp32 at head
        # dims the 3xTF32 kernel takes, the CUDA-core kernel for the rest
        return fa.flash_fwd(q, k, v, scale)
    fa._check_train_inputs(q, k, v)
    b, h, sq, d = q.shape
    # the output rows padded to a multiple of 8 as well: TMA's 16-byte
    # row stride; the caller sees the first Sq columns
    ot = torch.empty((b, h, d, sq + (-sq) % 8), dtype=q.dtype,
                     device=q.device)[..., :sq]
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    launch = _kernels.flash_fwd_tt if d <= 256 else _kernels.flash_fwd_tt_wide
    launch(to_tt(q), to_tt(k), to_tt(v), ot, lse, k.shape[2],
           scale * fa.LOG2E)
    return ot.transpose(-1, -2), lse


class _FlashTT(torch.autograd.Function):
    """The custom VJP ``_flash_tt``: saves (q, k, v, out, lse) with q
    unscaled; the backward is ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd_tt(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, g.to(out.dtype), lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention_tt(q, k, v, *, causal: bool = False,
                       scale: Optional[float] = None):
    """Transposed-layout flash attention over head-major (B, H, S, D)
    inputs, with its gradient.  Causal attention goes to
    ``plain_attention``, as the JAX package sends it to XLA."""
    if causal:
        from sdbc_tpu_torch.ops.attention import plain_attention

        return plain_attention(q, k, v, causal=True, scale=scale)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return _FlashTT.apply(q, k, v, scale)
