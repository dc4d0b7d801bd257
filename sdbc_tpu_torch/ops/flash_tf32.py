"""The fp32 attention forward on the tensor cores
(``csrc/flash_fwd_tf32_sm90.cu`` up to head dim 256,
``csrc/flash_fwd_tf32_wide_sm90.cu`` above: the VAE's 512-wide head): the
fixed cap and the training forward for fp32 q/k/v with a head dim that is
a multiple of 8, up to ``MAX_D``.
Each product runs as three tf32 products of the operands' hi and lo parts
(x = tf32(x) + tf32(x - tf32(x))), which keeps fp32's accuracy to about
2⁻²¹ at the tensor cores' tf32 rate.

The same functions as the bf16 kernels and ``flash_simt``, with the same
rounding points (``flash_attention.fixed_cap_attention_ref`` and
``flash_attention.flash_attention_ref`` are their plain versions).  One
call launches a split pre-pass (k and v into hi and lo parts, v transposed)
into a scratch buffer, then the attention kernel (above head dim 256 a
cluster of two CTAs a 64-row q tile, each with half the head dim); it is
counted once.  The
wrappers of ``flash_attention`` call these on the CUDA tensors
``flash_attention.route`` sends here; on a CPU tensor those wrappers
compute the plain versions.
"""
from __future__ import annotations

import torch

from sdbc_tpu_torch.ops import _kernels

LOG2E = 1.4426950408889634
MAX_D = 512
MAX_NARROW_D = 256  # csrc/flash_fwd_tf32_sm90.cu's widest head


def takes(q, k, v) -> bool:
    """The kernel takes fp32 q, k and v with a head dim that is a multiple
    of 8, up to ``MAX_D``."""
    d = q.shape[-1]
    return (q.dtype == k.dtype == v.dtype == torch.float32
            and d <= MAX_D and d % 8 == 0)


def check_inputs(q, k, v) -> None:
    """Raises unless ``takes(q, k, v)`` and the (B, H, S, D) shapes agree
    on one device."""
    if not takes(q, k, v):
        raise ValueError(f"flash_tf32 kernel takes float32 q, k, v with head "
                         f"dims ≤ {MAX_D} that are a multiple of 8, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}, {q.shape[-1]}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_tf32: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_tf32: q must be 4-D, got {tuple(q.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d or q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_tf32: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")


def _q_view(q):
    """``q`` itself when TMA can read it through its strides (a contiguous
    head dim, the other strides multiples of 4 floats, 16-byte aligned),
    else a contiguous copy."""
    st = q.stride()
    if st[3] == 1 and not (st[0] | st[1] | st[2]) % 4 \
            and q.data_ptr() % 16 == 0:
        return q
    return q.contiguous()


def _launch(q, k, v, o, lse, scale: float, fixed: bool) -> None:
    check_inputs(q, k, v)
    st = o.stride()
    if st[3] != 1 or (st[0] | st[1] | st[2]) % 2 or o.data_ptr() % 8:
        raise ValueError(f"flash_tf32: o needs a contiguous head dim and even "
                         f"strides, got {st}")
    b, h, _, d = q.shape
    skp = -(-k.shape[2] // 8) * 8
    scratch = torch.empty(4 * b * h * skp * d, dtype=torch.float32,
                          device=q.device)
    launch = _kernels.flash_tf32 if d <= MAX_NARROW_D \
        else _kernels.flash_tf32_wide
    launch(_q_view(q), k, v, o, lse, scratch, scale * LOG2E, fixed=fixed)


def fixed_cap(q, k, v, o, scale: float):
    """The fixed cap into ``o``; (B, H, S, D) views (o with a contiguous
    head dim and even strides)."""
    _launch(q, k, v, o, None, scale, True)
    return o


def fwd(q, k, v, o, lse, scale: float):
    """The training forward into ``o`` (as ``fixed_cap``'s) and the
    natural-log LSE into ``lse``, a contiguous (B, H, Sq) fp32 tensor."""
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_tf32: lse must be a contiguous float32 "
                         f"{tuple(q.shape[:3])} tensor, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    _launch(q, k, v, o, lse, scale, False)
    return o, lse
