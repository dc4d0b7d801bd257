"""Flash attention on the CUDA cores (``csrc/flash_simt.cu``) for the calls
no tensor-core kernel takes (``flash_attention.route`` and ``route_bwd``
say which): head dims that are not a multiple of 8, fp32 forwards above
256 and fp32 backwards above 160.  bf16 or fp32, head dims up to
``MAX_D``, any strides: the JAX package's kernels take any dtype and pad
any head dim, so its dispatch sends these calls to a kernel too.

The same functions as the tensor-core kernels, with the same rounding
points (``flash_attention.fixed_cap_attention_ref``,
``flash_attention.flash_attention_ref``, and
``flash_attention_bwd.flash_bwd_ref`` from ``prepare``'s inputs are their
plain versions).  The wrappers of ``flash_attention``,
``flash_attention_bwd`` and ``flash_attention_tt`` call these on CUDA
tensors that their tensor-core kernel does not take; on a CPU tensor those
wrappers compute the plain versions.
"""
from __future__ import annotations

import torch

from sdbc_tpu_torch.ops import _kernels

LOG2E = 1.4426950408889634
DTYPES = (torch.bfloat16, torch.float32)
MAX_D = 512


def takes(q, k, v) -> bool:
    """The kernels take q, k and v of one dtype, bf16 or fp32, with a head
    dim up to ``MAX_D``."""
    return (q.dtype == k.dtype == v.dtype and q.dtype in DTYPES
            and q.shape[-1] <= MAX_D)


def check_inputs(q, k, v) -> None:
    """Raises unless ``takes(q, k, v)`` and the (B, H, S, D) shapes agree
    on one device."""
    if q.shape[-1] > MAX_D:
        raise ValueError(f"flash_simt kernels take head dims ≤ {MAX_D}, got "
                         f"{q.shape[-1]}")
    if not takes(q, k, v):
        raise TypeError(f"flash_simt kernels take q, k, v of one dtype, "
                        f"bfloat16 or float32, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_simt: {name} on {t.device}, q on "
                             f"{q.device}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d or q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_simt: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")


def fixed_cap(q, k, v, o, scale: float):
    """The fixed cap into ``o``; all (B, H, S, D) views of any strides."""
    check_inputs(q, k, v)
    _kernels.flash_simt_fwd(q, k, v, o, None, scale * LOG2E, fixed=True)
    return o


def fwd(q, k, v, scale: float):
    """(out, lse) of the training forward over (B, H, S, D) views of any
    strides: out contiguous in q's dtype, lse (B, H, Sq) fp32."""
    check_inputs(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _kernels.flash_simt_fwd(q, k, v, o, lse, scale * LOG2E, fixed=False)
    return o, lse


def bwd(qs, kl, v, do, lse2, delta, scale: float):
    """(dq, dk, dv) from ``flash_attention_bwd.prepare``'s inputs: the dq
    kernel and the dk/dv kernel, the gradients contiguous."""
    check_inputs(qs, kl, v)
    if do.shape != qs.shape or do.dtype != qs.dtype:
        raise ValueError(f"flash_simt: do {tuple(do.shape)} {do.dtype} vs q "
                         f"{tuple(qs.shape)} {qs.dtype}")
    dq = torch.empty(qs.shape, dtype=qs.dtype, device=qs.device)
    dk = torch.empty(kl.shape, dtype=kl.dtype, device=kl.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _kernels.flash_simt_bwd_dq(qs, kl, v, do, lse2, delta, dq,
                               scale / LOG2E)
    _kernels.flash_simt_bwd_dkv(qs, kl, v, do, lse2, delta, dk, dv)
    return dq, dk, dv

