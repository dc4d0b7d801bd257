"""dtype helpers (counterpart of ``sdbc_tpu/utils/dtypes.py``).

Parameters are kept in the dtype the caller chose (fp32 for CPU parity,
bf16 for sampling on the card); activations run in the compute dtype and
the numerically sensitive reductions (norm statistics, softmax, scheduler
math) in fp32.
"""
from __future__ import annotations

import torch


def set_fp32_matmul_exact() -> None:
    """Full-precision fp32 matmuls and convolutions (no TF32).

    cuDNN convolutions default to TF32 on the card; every fp32 comparison
    against the JAX package turns both switches off.  The bf16 sampling
    path is unaffected by them (its products are bf16 already).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cast_floating(x, dtype):
    """``x`` with its floating-point tensors cast to ``dtype`` (integer
    tensors untouched): an ``nn.Module`` is cast in place (its floating
    parameters and buffers) and returned."""
    if isinstance(x, torch.nn.Module):
        return x.to(dtype)
    return x.to(dtype) if x.is_floating_point() else x
