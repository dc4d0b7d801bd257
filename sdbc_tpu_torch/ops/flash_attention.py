"""Flash attention (counterpart of ``sdbc_tpu/ops/flash_attention.py``):
the fixed-cap inference kernel and the training kernel with its gradient.

Training (``flash_attention``): the online-softmax forward of the JAX
package's ``_fwd_kernel`` — q prescaled by scale·log2e in fp32 and rounded
once to the input dtype, a running row max in log2 space, fp32
accumulation, p rounded to v's dtype before the PV product — emitting the
output and the natural-log LSE = m·ln2 + ln l.  ``_FlashAttention`` is the
custom VJP ``_flash``: it saves (q, k, v, out, lse) and its backward is
``flash_attention_bwd.flash_bwd``.  On CUDA the forward runs the wgmma
kernel of ``csrc/flash_fwd_sm90.cu`` (head dims up to 256) or that of
``csrc/flash_fwd_wide_sm90.cu`` (above 256: two consumers split the head
dim, a cluster of two CTAs the keys), the backward the kernels of
``csrc/flash_bwd_sm90.cu`` (up to 192) or ``csrc/flash_bwd_wide_sm90.cu``
(above: a cluster of two CTAs splits the head dim);
on a CPU tensor they compute the plain versions
``flash_attention_ref`` and ``flash_attention_bwd.flash_bwd_ref``.

Both directions take head dims up to 512 (the VAE's single head, which
the ``SDBC_ATTN_IMPL=flash`` override sends here), as the JAX backward
pads any head dim; "auto" routes only up to 256, as the JAX package's
``_flash_eligible`` admits.

The bf16 tensor-core kernels take bf16 q, k and v with a head dim that
is a multiple of 8, up to 512 (``takes``; the int8 one up to 256); their
input checks raise on anything else.  The JAX package's kernels take any
dtype and pad any head dim, so the forward wrappers choose a kernel by
dtype and head dim alone (``route``): fp32 with a head dim that is a
multiple of 8 up to 256 goes to the 3xTF32 kernel of ``flash_tf32``
(``csrc/flash_fwd_tf32_sm90.cu``), everything else the bf16 kernels do not
take (head dims that are not a multiple of 8, fp32 above 256) to the
CUDA-core kernels of ``flash_simt``: the same function, up to head dim
512, in bf16 or fp32.  The transposed layout routes the same way; the
backward routes by its twin ``route_bwd``: fp32 with a head dim that is a
multiple of 8 up to 160 to the 3xTF32 kernels of ``flash_bwd_tf32``
(``csrc/flash_bwd_tf32_sm90.cu``), the rest the bf16 kernels do not take
to ``flash_simt``.

Inference (fixed cap):

Math (the JAX package's ``_fixed_kernel_bshd``/``_fixed_kernel_raw``/
``_fixed_kernel``): q is prescaled by scale·log2e in fp32 and rounded to the
input dtype; s = q·kᵀ accumulates in fp32; p = exp2(min(s, 60)); l = Σp in
fp32; o = (p → dtype)·v / max(l, 1e-37).  No running max: the cap makes this
EXACT fp32 softmax while natural logits stay ≤ 60/log2e ≈ 41.6 (trained SD
models stay O(10)); beyond that the softmax is distorted, not clipped.
Non-causal, no LSE, no gradient — sampling only.

Both entry points run ONE CUDA kernel (``csrc/flash_fwd_sm90.cu``, the
training forward's template without the running max; above head dim 256
the fixed-cap variant of ``csrc/flash_fwd_wide_sm90.cu``'s) that takes
(batch, seq, head) strides: the projection layout (B, S, H, D) and the head-major
layout (B, H, S, D) differ only in the TMA tensor maps built from them;
rows past S and head-dim columns past D load as zeros (the head dim is
padded to a multiple of 64) and stores past them are dropped.  On a CPU tensor the wrappers compute
``fixed_cap_attention_ref``, the plain PyTorch version of the same math.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from sdbc_tpu_torch.ops import _kernels, flash_bwd_tf32, flash_simt, flash_tf32
from sdbc_tpu_torch.ops.flash_attention_bwd import flash_bwd

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
CAP = 60.0  # log2-space clamp; see module docstring
# the widest heads the tensor-core kernels take: the VAE's 512-wide head
# (above 256 the kernels of csrc/flash_fwd_wide_sm90.cu and
# csrc/flash_bwd_wide_sm90.cu); the int8 kernel's
MAX_D = 512
MAX_INT8_D = 256


def _takes(q, k, v, max_d: int) -> bool:
    d = q.shape[-1]
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and d <= max_d and d % 8 == 0)


def takes(q, k, v) -> bool:
    """The bf16 tensor-core kernels (the fixed cap, the training forward
    and backward) take bf16 q, k and v with a head dim (the last dim) that
    is a multiple of 8, up to ``MAX_D``; ``route`` says which kernel takes
    the others."""
    return _takes(q, k, v, MAX_D)


def route(dtype, d: int, *, fixed: bool) -> str:
    """The kernel a forward call on CUDA tensors of ``dtype`` (None: q, k
    and v disagree) and head dim ``d`` runs, by the name of its launch
    count: bf16 with ``d`` a multiple of 8 up to ``MAX_D`` → the bf16
    tensor-core kernels (``flash_fixed``, ``flash_fwd``); fp32 with ``d``
    a multiple of 8 up to ``flash_tf32.MAX_D`` → the 3xTF32 kernel
    (``flash_fixed_tf32``, ``flash_fwd_tf32``); anything else → the
    CUDA-core kernel (``flash_fixed_simt``, ``flash_fwd_simt``), which
    raises on what it does not take either."""
    kind = "fixed" if fixed else "fwd"
    if d % 8 == 0:
        if dtype == torch.bfloat16 and d <= MAX_D:
            return f"flash_{kind}"
        if dtype == torch.float32 and d <= flash_tf32.MAX_D:
            return f"flash_{kind}_tf32"
    return f"flash_{kind}_simt"


def route_bwd(dtype, d: int) -> tuple:
    """The kernels a backward call on CUDA tensors of ``dtype`` (None: q, k
    and v disagree) and head dim ``d`` runs, by the names of their launch
    counts (dq, dk/dv), as ``route`` names a forward's: bf16 with ``d`` a
    multiple of 8 up to ``MAX_D`` → the bf16 tensor-core kernels; fp32 with
    ``d`` a multiple of 8 up to ``flash_bwd_tf32.MAX_D`` → the 3xTF32
    kernels; anything else → the CUDA-core kernels, which raise on what
    they do not take either."""
    if d % 8 == 0:
        if dtype == torch.bfloat16 and d <= MAX_D:
            return ("flash_bwd_dq", "flash_bwd_dkv")
        if dtype == torch.float32 and d <= flash_bwd_tf32.MAX_D:
            return ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")
    return ("flash_bwd_simt_dq", "flash_bwd_simt_dkv")


def _route(q, k, v, fixed: bool) -> str:
    dtype = q.dtype if q.dtype == k.dtype == v.dtype else None
    return route(dtype, q.shape[-1], fixed=fixed)


def fixed_cap_attention_ref(q, k, v, scale: Optional[float] = None):
    """Plain fixed-cap attention over head-major (B, H, S, D) tensors, with
    the kernel's rounding points (q prescaled then rounded to the input
    dtype, p rounded to v's dtype before the PV product)."""
    dt = q.dtype
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    qp = (q.float() * (scale * LOG2E)).to(dt)
    s = torch.matmul(qp.float(), k.float().transpose(-1, -2))
    p = torch.exp2(torch.clamp(s, max=CAP))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / torch.clamp(l, min=1e-37)).to(dt)


def _check_cuda_inputs(q, k, v, max_d: int = MAX_D):
    """What the kernel takes (``takes``; the int8 one head dims up to
    ``MAX_INT8_D``) on one CUDA device, as 4-D (B, S, H, D) logical views
    with a contiguous head dim and 16-byte aligned rows.  (Runs on every
    launch: each test reads a tensor attribute once.)"""
    if not _takes(q, k, v, max_d):
        raise ValueError(f"flash_fixed kernel takes bfloat16 q, k, v with "
                         f"head dims ≤ {max_d} that are a multiple of 8, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}, {q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if len(st) != 4:
            raise ValueError(f"flash_fixed: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if st[3] != 1 or (st[0] | st[1] | st[2]) % 8 or t.data_ptr() % 16:
            raise ValueError(f"flash_fixed: {name} needs a contiguous head "
                             f"dim and 16-byte aligned rows, strides {st}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_fixed: q on {q.device}, k on {k.device}, v "
                         f"on {v.device}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h \
            or k.shape[3] != d:
        raise ValueError(f"flash_fixed: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("flash_fixed: empty sequence")


def _launch(q, k, v, o, scale: float):
    """q/k/v/o as (B, S, H, D) logical views of any stride: K1's kernel up
    to head dim 256, the wide kernel's fixed-cap variant above."""
    _check_cuda_inputs(q, k, v)
    if q.shape[-1] <= 256:
        _kernels.flash_fixed(q, k, v, o, scale * LOG2E)
    else:
        tr = lambda t: t.transpose(1, 2)
        _kernels.flash_fixed_wide(tr(q), tr(k), tr(v), tr(o), scale * LOG2E)
    return o


def _on_cpu(t) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {t.device}")
    return False


def flash_attention_fixed_bshd(q, k, v, *, scale: Optional[float] = None):
    """Fixed-cap attention over (B, S, H, D) projection-layout inputs."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    tr = lambda t: t.transpose(1, 2)
    if _on_cpu(q):
        return tr(fixed_cap_attention_ref(tr(q), tr(k), tr(v), scale))
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel = _route(q, k, v, fixed=True)
    if kernel == "flash_fixed":
        return _launch(q, k, v, o, scale)
    if kernel == "flash_fixed_tf32":
        flash_tf32.fixed_cap(tr(q), tr(k), tr(v), tr(o), scale)
    else:
        flash_simt.fixed_cap(tr(q), tr(k), tr(v), tr(o), scale)
    return o


def logit_bound(q, k, scale: float) -> float:
    """An upper bound on the natural logits, scale·max‖q‖·max‖k‖ over the
    rows, in fp32 (the JAX package's ``SDBC_ATTN_DEBUG`` estimate)."""
    qn = q.float().square().sum(-1).sqrt().max()
    kn = k.float().square().sum(-1).sqrt().max()
    return float(scale * qn * kn)


def flash_attention_fixed(q, k, v, *, scale: Optional[float] = None):
    """Fixed-cap attention over head-major (B, H, S, D) inputs.

    The cap makes it exact only while the natural logits stay ≤ 41.6:
    ``SDBC_ATTN_DEBUG=1`` prints a per-call upper bound on them
    (``logit_bound``), as the JAX package does; ``SDBC_ATTN_IMPL=xla``
    bypasses the kernel."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if os.environ.get("SDBC_ATTN_DEBUG") == "1":
        print(f"[sdbc flash-fixed] logit upper bound "
              f"{logit_bound(q, k, scale):.1f} (exact while <= 41.6; if "
              f"larger use SDBC_ATTN_IMPL=xla)")
    if _on_cpu(q):
        return fixed_cap_attention_ref(q, k, v, scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel = _route(q, k, v, fixed=True)
    if kernel == "flash_fixed_tf32":
        return flash_tf32.fixed_cap(q, k, v, o, scale)
    if kernel == "flash_fixed_simt":
        return flash_simt.fixed_cap(q, k, v, o, scale)
    tr = lambda t: t.transpose(1, 2)
    _launch(tr(q), tr(k), tr(v), tr(o), scale)
    return o


# ---------------------------------------------------------------------------
# training flash attention (forward with LSE + custom gradient)


def flash_attention_ref(q, k, v, scale: float):
    """Plain training forward over head-major (B, H, S, D) tensors →
    (out (B, H, Sq, D) in q's dtype, lse (B, H, Sq) fp32 natural log).

    The kernel's rounding points: q prescaled in fp32 and rounded to the
    input dtype, logits in log2 units, fp32 softmax statistics, p rounded
    to v's dtype before the PV product.  The kernel rescales per 64-row KV
    tile with a running max; this takes the row max at once, which is the
    same math (the two round p at different offsets in bf16 only)."""
    dt = q.dtype
    qp = (q.float() * (scale * LOG2E)).to(dt)
    s = torch.matmul(qp.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    lse = (m * LN2 + torch.log(l))[..., 0]
    return o.to(dt), lse


def _check_train_inputs(q, k, v):
    """What the training kernels take (``takes``): (B, H, S, D) on one
    CUDA device, matching batch/head/dim."""
    if not takes(q, k, v):
        raise ValueError(f"flash_attention kernel takes bfloat16 q, k, v "
                         f"with head dims ≤ {MAX_D} that are a multiple"
                         f" of 8, got {q.dtype}/{k.dtype}/{v.dtype}, "
                         f"{q.shape[-1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.shape[2] == 0 or k.shape[2] == 0:
        raise ValueError("flash_attention: empty sequence")


def kernel_view(t):
    """``t`` itself when the kernels can read it through its strides (a
    contiguous head dim, 16-byte aligned rows), else a contiguous copy."""
    st = t.stride()
    if st[3] == 1 and not (st[0] | st[1] | st[2]) % 8 \
            and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def bhsd_empty_like(t):
    """An uninitialised (B, H, S, D) view over (B, S, H, D) memory: the
    projection layout the UNet splits heads from, so the caller's merge of
    the heads is free."""
    b, h, s, d = t.shape
    return torch.empty_strided((b, h, s, d), (s * h * d, d, h * d, 1),
                               dtype=t.dtype, device=t.device)


def flash_fwd(q, k, v, scale: float):
    """(out, lse) of the training forward: on CUDA the kernel ``route``
    names (bf16: ``_kernels.flash_fwd`` up to head dim 256,
    ``_kernels.flash_fwd_wide`` above; fp32: ``flash_tf32.fwd``; both
    write out in the projection layout, ``bhsd_empty_like``;
    ``flash_simt.fwd`` for the rest), on the CPU the plain version."""
    if _on_cpu(q):
        return flash_attention_ref(q, k, v, scale)
    kernel = _route(q, k, v, fixed=False)
    if kernel == "flash_fwd_simt":
        return flash_simt.fwd(q, k, v, scale)
    if kernel == "flash_fwd":
        _check_train_inputs(q, k, v)
        q, k, v = kernel_view(q), kernel_view(k), kernel_view(v)
    o = bhsd_empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if kernel == "flash_fwd_tf32":
        return flash_tf32.fwd(q, k, v, o, lse, scale)
    launch = _kernels.flash_fwd if q.shape[-1] <= 256 \
        else _kernels.flash_fwd_wide
    launch(q, k, v, o, lse, scale * LOG2E)
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """The custom VJP ``_flash``: saves (q, k, v, out, lse); the backward
    recomputes p from the LSE (``flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, g.to(out.dtype), lse, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Training flash attention over head-major (B, H, S, D) inputs, with
    its gradient.  Causal attention goes to ``plain_attention``, as the JAX
    package sends it to XLA."""
    if causal:
        from sdbc_tpu_torch.ops.attention import plain_attention

        return plain_attention(q, k, v, causal=True, scale=scale)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return _FlashAttention.apply(q, k, v, scale)


# ---------------------------------------------------------------------------
# int8 QKᵀ fixed-cap attention (the JAX package's ``_flash_fixed_fwd_int8``;
# nothing dispatches it, in either package).  The kernel quantizes q and k
# itself, as ``quantize_rows`` does.


def quantize_rows(x):
    """The JAX wrapper's ``quant``: per-row absmax over the head dim in fp32,
    s = max(absmax, 1e-8)/127, round(x/s) half to even → (int8 values,
    fp32 row scales of shape (..., S, 1))."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.round(xf / s).to(torch.int8), s


def fixed_cap_int8_ref(q, k, v, scale: Optional[float] = None):
    """Plain int8-QK fixed-cap attention over head-major (B, H, S, D):
    s = int32(qi·kiᵀ)·qs·ks with scale·log2e folded into qs, p = exp2(min(s,
    60)), l = Σp in fp32, o = (p → v's dtype)·v / max(l, 1e-37).  The int
    product is exact in fp32 (and in TF32) while D·127² < 2²⁴."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    qi, qs = quantize_rows(q)
    ki, ks = quantize_rows(k)
    qs = qs * (scale * LOG2E)
    exact = torch.float32 if q.shape[-1] * 127 * 127 < 2 ** 24 \
        else torch.float64
    si = torch.matmul(qi.to(exact), ki.to(exact).transpose(-1, -2)).float()
    p = torch.exp2(torch.clamp(si * qs * ks.transpose(-1, -2), max=CAP))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / torch.clamp(l, min=1e-37)).to(q.dtype)


def flash_attention_fixed_int8(q, k, v, *, scale: Optional[float] = None):
    """int8-QK fixed-cap attention over head-major (B, H, S, D) inputs (any
    batch/head/seq strides the fixed-cap kernel takes; no copy): on CUDA
    the kernels of ``csrc/flash_int8_sm90.cu`` — a pre-pass quantizes k,
    the attention kernel q — on the CPU, ``fixed_cap_int8_ref``."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if _on_cpu(q):
        return fixed_cap_int8_ref(q, k, v, scale)
    tr = lambda t: t.transpose(1, 2)
    _check_cuda_inputs(tr(q), tr(k), tr(v), MAX_INT8_D)
    b, h, _, d = q.shape
    sk = k.shape[2]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    k8 = torch.empty((b, h, sk, -(-d // 16) * 16), dtype=torch.int8,
                     device=q.device)
    ks = torch.empty((b, h, -(-sk // 128) * 128), dtype=torch.float32,
                     device=q.device)
    _kernels.flash_fixed_int8(q, k, v, o, k8, ks, scale * LOG2E)
    return o
