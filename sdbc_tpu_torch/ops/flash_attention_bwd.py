"""Flash attention backward (counterpart of
``sdbc_tpu/ops/flash_attention_bwd.py``).

Two kernels over the saved log-sum-exp rows, no S×S matrix in device
memory: the dq kernel walks the KV sequence for each 64-row q tile, the
dk/dv kernel walks the q sequence for each 64-row KV tile
(``csrc/flash_train.cu``).  The JAX package's reformulation is kept:

- qs = scale·q and kl = log2e·k, each folded in fp32 and rounded ONCE to
  the operand dtype (the kernels do it on the way into shared memory);
- lse2 = lse·log2e and delta = Σ(dO∘O) in fp32 (delta is a plain torch
  reduction here, as it is an XLA reduction outside the Pallas kernels);
- p = exp2(qs·klᵀ − lse2) and ds0 = p∘(dO·Vᵀ − delta) rounded to the
  operand dtype;
- dq = (scale/log2e)·Σ ds0·kl, dk = Σ ds0ᵀ·qs, dv = Σ p̂ᵀ·dO with p̂
  rounded to dO's dtype.

On a CPU tensor ``flash_bwd`` computes ``flash_bwd_ref``, the plain
version of the same math.
"""
from __future__ import annotations

import torch

from sdbc_tpu_torch.ops import _kernels

LOG2E = 1.4426950408889634


def _fold(x, mult: float):
    """x·mult in fp32, rounded once back to x's dtype."""
    return (x.float() * mult).to(x.dtype)


def flash_bwd_ref(q, k, v, o, do, lse, scale: float):
    """Plain (dq, dk, dv) over head-major (B, H, S, D) tensors; lse is the
    forward's (B, H, Sq) natural-log LSE."""
    dt = q.dtype
    qs, kl = _fold(q, scale), _fold(k, LOG2E)
    lse2 = lse.float() * LOG2E
    delta = (do.float() * o.float()).sum(dim=-1)
    s2 = torch.matmul(qs.float(), kl.float().transpose(-1, -2))
    p = torch.exp2(s2 - lse2[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds0 = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.matmul(ds0, kl.float()) * (scale / LOG2E)
    dk = torch.matmul(ds0.transpose(-1, -2), qs.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, o, do, lse, scale: float):
    """(dq, dk, dv) for non-causal flash attention: the two kernels on
    CUDA, ``flash_bwd_ref`` on the CPU.  The gradients come back as
    (B, H, S, D) views over (B, S, H, D) memory, the layout the UNet's
    head split came from."""
    from sdbc_tpu_torch.ops import flash_attention as fa

    if fa._on_cpu(q):
        return flash_bwd_ref(q, k, v, o, do, lse, scale)
    fa._check_train_inputs(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} {do.dtype} / o "
                         f"{tuple(o.shape)} vs q {tuple(q.shape)} {q.dtype}")
    q, k, v, do = (fa.kernel_view(t) for t in (q, k, v, do))
    lse = lse.float().contiguous()
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    dq = fa.bhsd_empty_like(q)
    dk, dv = fa.bhsd_empty_like(k), fa.bhsd_empty_like(v)
    _kernels.flash_bwd_dq(q, k, v, do, lse, delta, dq, scale, scale / LOG2E)
    _kernels.flash_bwd_dkv(q, k, v, do, lse, delta, dk, dv, scale)
    return dq, dk, dv
