"""Flash attention backward (counterpart of
``sdbc_tpu/ops/flash_attention_bwd.py``).

Two kernels over the saved log-sum-exp rows, no S×S matrix in device
memory: the dq kernel walks the KV sequence for each q tile, the dk/dv
kernel walks the q sequence for each KV tile.  The JAX package's
reformulation is kept, and so is the split of the work between its
wrapper and its kernels:

- the wrapper (``prepare``, plain torch) folds qs = scale·q and
  kl = log2e·k, each in fp32 and rounded ONCE to the operand dtype, and
  computes lse2 = lse·log2e and delta = Σ(dO∘O) in fp32, zero-padded to a
  whole number of 128-row q tiles (JAX's ``lse_p``/``delta_p``);
- the kernels compute p = exp2(qs·klᵀ − lse2) and ds0 = p∘(dO·Vᵀ − delta)
  rounded to the operand dtype, and
  dq = (scale/log2e)·Σ ds0·kl, dk = Σ ds0ᵀ·qs, dv = Σ p̂ᵀ·dO with p̂ rounded
  to dO's dtype.

On CUDA both kernels take ``prepare``'s inputs: head dims up to
``SM90_MAX_D`` run the TMA-fed ``wgmma`` kernels of
``csrc/flash_bwd_sm90.cu``, wider ones (up to 512, as the JAX backward pads
any head dim) those of ``csrc/flash_bwd_wide_sm90.cu``, where a cluster of
two CTAs splits the head dim; fp32 with a head dim that is a multiple of
8 up to 160 the 3xTF32 kernels of ``flash_bwd_tf32``
(``csrc/flash_bwd_tf32_sm90.cu``, which fold qs and kl themselves); the
rest (``flash_attention.route_bwd``: head dims that are not a multiple of
8, fp32 above 160) the CUDA-core kernels of ``flash_simt``.  On a CPU
tensor ``flash_bwd`` computes ``flash_bwd_ref``, the plain version of the
same math;
``flash_bwd_prepared_ref`` is the plain version of what the kernels compute
from ``prepare``'s padded inputs.
"""
from __future__ import annotations

import torch

from sdbc_tpu_torch.ops import _kernels, flash_bwd_tf32

LOG2E = 1.4426950408889634
# head dims of csrc/flash_bwd_sm90.cu; wider ones run flash_bwd_wide_sm90.cu
SM90_MAX_D = 192
Q_TILE = 128  # the dq kernel's q rows per block: lse2/delta pad to it


def _fold(x, mult: float):
    """x·mult in fp32, rounded once back to x's dtype.  One multiply does
    it: PyTorch multiplies a bf16 or fp16 tensor by a Python float in fp32
    and rounds the product once, the values of ``(x.float() * mult).to(
    x.dtype)`` in one kernel instead of three (held bitwise on the CPU and
    on the card by the tests)."""
    return x * mult


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


def prepare_vectors(o, do, lse):
    """(lse2, delta): lse·log2e and Σ(dO∘O) in fp32, contiguous
    (B, H, Sq_pad), zero past Sq, Sq_pad a multiple of ``Q_TILE``."""
    b, h, sq = lse.shape
    pad = -sq % Q_TILE
    # few launches: below 64² tokens the call is host-bound (zeros only
    # where there is a pad; o promoted to fp32 exactly inside the multiply)
    vec = (torch.zeros if pad else torch.empty)(
        (2, b, h, sq + pad), dtype=torch.float32, device=lse.device)
    torch.mul(lse, LOG2E, out=vec[0, ..., :sq])
    torch.sum(do.float() * o, dim=-1, out=vec[1, ..., :sq])
    return vec[0], vec[1]


def prepare(q, k, o, do, lse, scale: float):
    """The wgmma kernels' inputs, as the JAX wrapper prepares its Pallas
    kernels': (qs, kl, lse2, delta) with qs and kl folded once (q's
    layout) and ``prepare_vectors``' lse2 and delta."""
    return (_fold(q, scale), _fold(k, LOG2E)) + prepare_vectors(o, do, lse)


def flash_bwd_prepared_ref(qs, kl, v, do, lse2, delta, scale: float):
    """Plain (dq, dk, dv) from ``prepare``'s inputs, as the kernels see
    them: qs and dO rows past Sq zero (the tensor maps' fill) against the
    zero pad of lse2 and delta, so those rows take p = 1 and ds0 = 0."""
    dt = qs.dtype
    sq, sq_pad = qs.shape[2], lse2.shape[-1]
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, sq_pad - sq))
    qsp, dop = pad(qs), pad(do)
    p = torch.exp2(torch.matmul(qsp, kl.float().transpose(-1, -2))
                   - lse2[..., None])
    dp = torch.matmul(dop, v.float().transpose(-1, -2))
    ds0 = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.matmul(ds0, kl.float()) * (scale / LOG2E)
    dk = torch.matmul(ds0.transpose(-1, -2), qsp)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dop)
    return dq[..., :sq, :].to(dt), dk.to(kl.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, o, do, lse, scale: float):
    """(dq, dk, dv) for non-causal flash attention: the two kernels on
    CUDA, ``flash_bwd_ref`` on the CPU.  The gradients come back as
    (B, H, S, D) views over (B, S, H, D) memory, the layout the UNet's
    head split came from."""
    from sdbc_tpu_torch.ops import flash_attention as fa, flash_simt

    if fa._on_cpu(q):
        return flash_bwd_ref(q, k, v, o, do, lse, scale)
    dtype = q.dtype if q.dtype == k.dtype == v.dtype else None
    kernel = fa.route_bwd(dtype, q.shape[-1])[0]
    if kernel == "flash_bwd_simt_dq":
        qs, kl, lse2, delta = prepare(q, k, o, do, lse, scale)
        return flash_simt.bwd(qs, kl, v, do, lse2, delta, scale)
    if kernel == "flash_bwd_dq_tf32":
        return flash_bwd_tf32.bwd(q, k, v, do, *prepare_vectors(o, do, lse),
                                  scale)
    fa._check_train_inputs(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash_bwd: do {tuple(do.shape)} {do.dtype} / o "
                         f"{tuple(o.shape)} vs q {tuple(q.shape)} {q.dtype}")
    v, do = fa.kernel_view(v), fa.kernel_view(do)
    dq = fa.bhsd_empty_like(q)
    dk, dv = fa.bhsd_empty_like(k), fa.bhsd_empty_like(v)
    qs, kl, lse2, delta = prepare(q, k, o, do, lse, scale)
    ins = (fa.kernel_view(qs), fa.kernel_view(kl), v, do, lse2, delta)
    if q.shape[-1] <= SM90_MAX_D:
        _kernels.flash_bwd_dq(*ins, dq, scale / LOG2E)
        _kernels.flash_bwd_dkv(*ins, dk, dv)
    else:
        _kernels.flash_bwd_dq_wide(*ins, dq, scale / LOG2E)
        _kernels.flash_bwd_dkv_wide(*ins, dk, dv)
    return dq, dk, dv
