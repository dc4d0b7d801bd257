"""Fused GEGLU feed-forward (counterpart of ``sdbc_tpu/ops/geglu_ff.py``).

``y + (val·gelu_erf(gate))·W2 + b2`` with ``[val, gate] = LN(y)·W1 + b1``:
LayerNorm eps 1e-5 with fp32 statistics, the up-projection rounded to the
compute dtype before ``+ b1``, val the first 4c columns of W1 and gate the
last 4c.  On CUDA this is one kernel that keeps the 4c-wide hidden on
chip, named by ``route``: for bf16 rows it takes (``takes``: c a multiple
of 32, of 64 above 320) ``csrc/geglu_ff_sm90.cu`` (TMA-fed ``wgmma``, the
GEGLU in registers), for fp32 rows of the same widths
``csrc/geglu_ff_tf32_sm90.cu`` (3xTF32 ``wgmma``: each product as three
tf32 products of hi and lo parts, after a split pre-pass of the weights
into a scratch buffer), for the others (other widths up to 640: the JAX
package's kernel takes any dtype and width) ``csrc/geglu_ff_simt.cu`` on
the CUDA cores; on a CPU tensor the wrappers compute ``geglu_ff_ref``, the
plain PyTorch version with the same rounding points.
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


def _width_ok(c: int) -> bool:
    return c <= _MAX_C and c % (32 if c <= 320 else 64) == 0


def takes(y) -> bool:
    """The bf16 tensor-core kernel takes bf16 rows of a width c that is a
    multiple of 32 up to 320 or of 64 up to 640; ``takes_tf32`` fp32 rows
    of the same widths; the CUDA-core kernel bf16 or fp32 rows of any width
    up to 640 (``takes_simt``)."""
    return y.dtype == torch.bfloat16 and _width_ok(y.shape[-1])


def takes_tf32(y) -> bool:
    """The 3xTF32 kernel takes fp32 rows of the widths ``takes`` allows."""
    return y.dtype == torch.float32 and _width_ok(y.shape[-1])


def route(dtype, c: int) -> str:
    """The kernel a call on CUDA rows of ``dtype`` and width ``c`` runs, by
    the name of its launch count: bf16 at the widths ``takes`` allows →
    ``geglu_ff``; fp32 at those widths → ``geglu_ff_tf32``; anything else →
    ``geglu_ff_simt``, which raises on what it does not take either."""
    if _width_ok(c):
        if dtype == torch.bfloat16:
            return "geglu_ff"
        if dtype == torch.float32:
            return "geglu_ff_tf32"
    return "geglu_ff_simt"


def takes_simt(y) -> bool:
    """The CUDA-core kernel takes bf16 or fp32 rows up to c = 640."""
    return y.dtype in (torch.bfloat16, torch.float32) and y.shape[-1] <= _MAX_C


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


_TAKES = {"geglu_ff": (takes, "tensor-core kernel takes bf16 rows of c a "
                              "multiple of 32 up to 320 or of 64 up to 640"),
          "geglu_ff_tf32": (takes_tf32, "3xTF32 kernel takes fp32 rows of c "
                                        "a multiple of 32 up to 320 or of 64 "
                                        "up to 640"),
          "geglu_ff_simt": (takes_simt, "CUDA-core kernel takes bf16 or fp32 "
                                        "rows of c ≤ 640")}


def _check_cuda_inputs(y, gamma, beta, w1, b1, w2, b2,
                       kernel: str = "geglu_ff"):
    """What ``kernel`` takes (``_TAKES``): contiguous rows and weights in
    y's dtype, the LayerNorm's in fp32, on y's device; 32-byte aligned for
    the bf16 tensor-core kernel, 16-byte for the 3xTF32 one."""
    rows, c = y.shape
    accepts, what = _TAKES[kernel]
    if not accepts(y) or rows == 0:
        raise ValueError(f"geglu_ff {what}, got {rows} rows of c={c} in "
                         f"{y.dtype}")
    align = {"geglu_ff": 32, "geglu_ff_tf32": 16}.get(kernel, 1)
    dt = y.dtype
    want = {"gamma": (gamma, (c,), torch.float32),
            "beta": (beta, (c,), torch.float32),
            "w1": (w1, (c, 8 * c), dt), "b1": (b1, (8 * c,), dt),
            "w2": (w2, (4 * c, c), dt), "b2": (b2, (c,), dt),
            "y": (y, (rows, c), dt)}
    for name, (t, shape, dtype) in want.items():
        if t.device != y.device:
            raise ValueError(f"geglu_ff: {name} on {t.device}, y on "
                             f"{y.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"geglu_ff kernel takes {name} {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"geglu_ff: {name} must be contiguous (and "
                             f"{align}-byte aligned for the {kernel} "
                             f"kernel)")


def _on_cpu(y) -> bool:
    """True for a CPU tensor, False for a CUDA one; raises for any other
    device (no kernel, no plain fallback)."""
    if y.device.type == "cpu":
        return True
    if y.device.type != "cuda":
        raise ValueError(f"geglu_ff: no kernel for device {y.device}")
    return False


def scratch_floats(c: int) -> int:
    """Floats of the 3xTF32 kernel's scratch: W1ᵀ (8c, c) and W2ᵀ (c, 4c),
    each as hi and lo parts."""
    return 24 * c * c


def geglu_ff_rows(y, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5):
    """Fused FF over (rows, c): on CUDA the kernel ``route`` names, on the
    CPU the plain version."""
    if _on_cpu(y):
        return geglu_ff_ref(y, gamma, beta, w1, b1, w2, b2, eps)
    kernel = route(y.dtype, y.shape[-1])
    _check_cuda_inputs(y, gamma, beta, w1, b1, w2, b2, kernel=kernel)
    out = torch.empty_like(y)
    if kernel == "geglu_ff_tf32":
        scratch = torch.empty(scratch_floats(y.shape[-1]),
                              dtype=torch.float32, device=y.device)
        _kernels.geglu_ff_tf32(y, gamma, beta, w1, b1, w2, b2, out, scratch,
                               eps)
    else:
        getattr(_kernels, kernel)(y, gamma, beta, w1, b1, w2, b2, out, eps)
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
