"""Fused GEGLU feed-forward (counterpart of ``sdbc_tpu/ops/geglu_ff.py``).

``y + (val·gelu_erf(gate))·W2 + b2`` with ``[val, gate] = LN(y)·W1 + b1``:
LayerNorm eps 1e-5 with fp32 statistics, the up-projection rounded to the
compute dtype before ``+ b1``, val the first 4c columns of W1 and gate the
last 4c.  On CUDA this is one kernel (``csrc/geglu_ff_sm90.cu``: TMA-fed
``wgmma``, the GEGLU in registers) that keeps the 4c-wide hidden on chip;
on a CPU tensor the wrappers compute ``geglu_ff_ref``, the plain PyTorch
version with the same rounding points.
Sampling only: no gradient.
"""
from __future__ import annotations

import torch

from sdbc_tpu_torch.ops import _kernels

_MAX_C = 640  # the JAX package's rule: it does not fuse wider rows


def _default_block(c: int) -> int:
    # the JAX package's row blocks; kept so eligibility (and thus where the
    # sampling path fuses) is the same in both packages
    return 1024 if c <= 320 else 256


def ff_fused_eligible(y) -> bool:
    """The fused kernel applies: a tensor on CUDA, c ≤ 640, and the row count
    divides the JAX package's row block (the same rule as the JAX package,
    with "tensor on CUDA" in place of "TPU backend")."""
    rows = y.shape[0] * y.shape[1]
    c = y.shape[-1]
    return (y.is_cuda and c <= _MAX_C
            and rows % min(_default_block(c), rows) == 0)


def geglu_ff_ref(y, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """Plain version over (rows, c), with the kernel's rounding points."""
    dt = y.dtype
    inner = w1.shape[1] // 2
    x = y.float()
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=1, keepdim=True)
    xn = (xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(dt)
    h = torch.matmul(xn.float(), w1.float()).to(dt)
    h = (h + b1.to(dt)).float()
    val, gate = h[:, :inner], h[:, inner:]
    a = val * (0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)))
    o = torch.matmul(a.to(dt).float(), w2.float()) + b2.float()
    return (x + o).to(dt)


def _check_cuda_inputs(y, gamma, beta, w1, b1, w2, b2):
    rows, c = y.shape
    want = {"y": (y, (rows, c), torch.bfloat16),
            "gamma": (gamma, (c,), torch.float32),
            "beta": (beta, (c,), torch.float32),
            "w1": (w1, (c, 8 * c), torch.bfloat16),
            "b1": (b1, (8 * c,), torch.bfloat16),
            "w2": (w2, (4 * c, c), torch.bfloat16),
            "b2": (b2, (c,), torch.bfloat16)}
    for name, (t, shape, dtype) in want.items():
        if t.device != y.device:
            raise ValueError(f"geglu_ff: {name} on {t.device}, y on "
                             f"{y.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"geglu_ff kernel takes {name} {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"geglu_ff: {name} must be contiguous and "
                             "32-byte aligned")
    if rows == 0 or c % 32 or c > _MAX_C or (c > 320 and c % 64):
        raise ValueError(f"geglu_ff kernel takes rows > 0 and c a multiple "
                         f"of 32 up to 320 or of 64 up to {_MAX_C}, got "
                         f"rows={rows} c={c}")


def geglu_ff_rows(y, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """Fused FF over (rows, c)."""
    if y.device.type == "cpu":
        return geglu_ff_ref(y, gamma, beta, w1, b1, w2, b2, eps)
    if y.device.type != "cuda":
        raise ValueError(f"geglu_ff: no kernel for device {y.device}")
    _check_cuda_inputs(y, gamma, beta, w1, b1, w2, b2)
    out = torch.empty_like(y)
    _kernels.geglu_ff(y, gamma, beta, w1, b1, w2, b2, out, eps)
    return out


def geglu_ff(y, ln, geglu, ff_out, *, eps: float = 1e-5):
    """Fused ``y + FF(LN(y))`` over (b, s, c); ``ln``/``geglu``/``ff_out``
    are the transformer's ``ln3``/``geglu``/``ff_out`` modules."""
    b, s, c = y.shape
    dt = y.dtype
    out = geglu_ff_rows(
        y.reshape(b * s, c).contiguous(),
        ln.weight.float().contiguous(), ln.bias.float().contiguous(),
        geglu.weight.to(dt).contiguous(), geglu.bias.to(dt).contiguous(),
        ff_out.weight.to(dt).contiguous(), ff_out.bias.to(dt).contiguous(),
        eps)
    return out.reshape(b, s, c)
