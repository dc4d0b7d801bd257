"""The fp32 attention backward on the tensor cores
(``csrc/flash_bwd_tf32_sm90.cu``): the dq and dk/dv kernels for fp32 q/k/v
with a head dim that is a multiple of 8, up to ``MAX_D``.  Each product
runs as three tf32 products of the operands' hi and lo parts
(x = tf32(x) + tf32(x - tf32(x))), which keeps fp32's accuracy to about
2⁻²¹ at the tensor cores' tf32 rate.

The same function as the bf16 kernels and ``flash_simt.bwd``, with the
same rounding points (``flash_attention_bwd.flash_bwd_prepared_ref`` on
``prepare``'s inputs is its plain version): qs = scale·q and kl = log2e·k,
one fp32 multiply each, are folded by the kernels' split pre-pass, which
writes every operand as hi and lo parts, and the three that a product reads
along the sequence (qsᵀ, dOᵀ, klᵀ) transposed, into a scratch buffer once a
call.  One call launches the pre-pass and the dq kernel (counted once as
``flash_bwd_dq_tf32``), then the dk/dv kernel (``flash_bwd_dkv_tf32``).
``flash_attention_bwd.flash_bwd`` calls ``bwd`` on the CUDA tensors
``flash_attention.route_bwd`` sends here; on a CPU tensor it computes the
plain version.
"""
from __future__ import annotations

import torch

from sdbc_tpu_torch.ops import _kernels

LOG2E = 1.4426950408889634
MAX_D = 160


def takes(q, k, v) -> bool:
    """The kernels take fp32 q, k and v with a head dim that is a multiple
    of 8, up to ``MAX_D``."""
    d = q.shape[-1]
    return (q.dtype == k.dtype == v.dtype == torch.float32
            and d <= MAX_D and d % 8 == 0)


def scratch_floats(b: int, h: int, sq: int, sk: int, d: int) -> int:
    """The floats of one call's scratch: hi and lo parts of qs, dO (Sq
    rows), kl and V (Sk rows), and of qsᵀ, dOᵀ (Sq rounded up to 8
    positions) and klᵀ (Sk rounded up to 8), each D wide."""
    sqp, skp = -(-sq // 8) * 8, -(-sk // 8) * 8
    return 4 * b * h * (sq + sk) * d + b * h * d * (4 * sqp + 2 * skp)


def check_inputs(q, k, v, do) -> None:
    """Raises unless ``takes(q, k, v)``, ``do`` is q's shape in fp32 and the
    (B, H, S, D) shapes agree on one device."""
    if not takes(q, k, v):
        raise ValueError(f"flash_bwd_tf32 kernels take float32 q, k, v with "
                         f"head dims ≤ {MAX_D} that are a multiple of 8, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}, {q.shape[-1]}")
    for name, t in (("k", k), ("v", v), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"flash_bwd_tf32: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"flash_bwd_tf32: q must be 4-D, got "
                         f"{tuple(q.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d or q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError(f"flash_bwd_tf32: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if do.shape != q.shape or do.dtype != torch.float32:
        raise ValueError(f"flash_bwd_tf32: do {tuple(do.shape)} {do.dtype} "
                         f"vs q {tuple(q.shape)} float32")


def _check_vectors(q, lse2, delta) -> None:
    from sdbc_tpu_torch.ops.flash_attention_bwd import Q_TILE

    sq = q.shape[2]
    for name, t in (("lse2", lse2), ("delta", delta)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape[:-1] != q.shape[:2] or t.shape[-1] < sq \
                or t.shape[-1] % Q_TILE or t.device != q.device:
            raise ValueError(f"flash_bwd_tf32: {name} must be a contiguous "
                             f"float32 (B, H, Sq_pad) tensor, Sq_pad a "
                             f"multiple of {Q_TILE} ≥ {sq}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def bwd(q, k, v, do, lse2, delta, scale: float):
    """(dq, dk, dv) of the backward over (B, H, S, D) fp32 views of any
    strides, from the unscaled q and k and ``prepare``'s lse2 and delta:
    the gradients as (B, H, S, D) views over (B, S, H, D) memory, as the
    bf16 kernels give them."""
    from sdbc_tpu_torch.ops.flash_attention import bhsd_empty_like

    check_inputs(q, k, v, do)
    _check_vectors(q, lse2, delta)
    b, h, sq, d = q.shape
    dq = bhsd_empty_like(q)
    dk, dv = bhsd_empty_like(k), bhsd_empty_like(v)
    scratch = torch.empty(scratch_floats(b, h, sq, k.shape[2], d),
                          dtype=torch.float32, device=q.device)
    _kernels.flash_bwd_dq_tf32(q, k, v, do, lse2, delta, dq, scratch, scale,
                               scale / LOG2E)
    _kernels.flash_bwd_dkv_tf32(q, k, lse2, delta, dk, dv, scratch)
    return dq, dk, dv
