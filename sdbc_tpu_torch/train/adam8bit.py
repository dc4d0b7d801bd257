"""Blockwise 8-bit AdamW (counterpart of ``sdbc_tpu/train/adam8bit.py``).

Moments of every leaf with at least ``min_8bit_size`` elements are stored
as int8 with one fp32 absmax per 2048-element row: m as sign·sqrt, v as a
4th root (the closed-form stand-in for bitsandbytes' dynamic map that keeps
tiny v entries representable).  One step per leaf dequantizes, updates the
moments, applies p −= lr·(m̂/(√v̂+eps) + wd·p) with the bias corrections
1 − exp(step·ln b), and requantizes with the row's new absmax (round half
to even, clip to ±127).  Smaller leaves keep fp32 moments.

On CUDA a leaf's step is one launch of ``csrc/adam8bit.cu``, which reads
and writes the parameter, its gradient and the moments in place; on the
CPU ``adam8_update`` computes ``adam8_update_ref``, the plain version of
the same math.  The per-row scale is stored as (rows,): the JAX package
broadcasts it to 128 lanes only for the TPU's layout.

The port updates parameters in place (the JAX transformation returns
updates).  A leaf is one tensor, or a list of same-shape tensors that the
JAX package holds as one array stacked on a new leading axis (the CLIP
text encoder's layers, ``trainer.optimizer_leaves``): the size rule, the
2048-element rows and the fp32 moments' shape apply to the stacked array,
which the update builds, steps and copies back to the parts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Union

import numpy as np
import torch

from sdbc_tpu_torch.ops import _kernels

BLOCK = 2048           # quantization block (one row)
MIN_8BIT_SIZE = 16384  # the reference's bitsandbytes min_8bit_size


@dataclasses.dataclass
class Quant8State:
    mq: torch.Tensor  # int8 (rows, BLOCK)
    ms: torch.Tensor  # fp32 (rows,) per-row absmax of m
    vq: torch.Tensor  # int8 (rows, BLOCK)
    vs: torch.Tensor  # fp32 (rows,)


@dataclasses.dataclass
class FP32Moments:
    m: torch.Tensor
    v: torch.Tensor


@dataclasses.dataclass
class Adam8State:
    count: int
    per_leaf: List[Union[Quant8State, FP32Moments]]


def bias_corrections(step: int, b1: float, b2: float):
    """(1 − exp(step·ln b1), 1 − exp(step·ln b2)) in fp32, as the TPU kernel
    computes them (b**step as exp(step·ln b))."""
    s = torch.tensor(float(step), dtype=torch.float32)
    bc = [1.0 - torch.exp(s * torch.tensor(math.log(b), dtype=torch.float32))
          for b in (b1, b2)]
    return float(bc[0]), float(bc[1])


def _fp32_bias_correction(decay: float, step: int) -> float:
    """1 − decay**step in fp32 (the small-leaf path's formula)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(step))


def _quant(x, amax, power_root: int):
    norm = x / amax[:, None]
    if power_root == 2:
        mapped = torch.sign(norm) * torch.sqrt(norm.abs())
    else:
        mapped = torch.sqrt(torch.sqrt(torch.clamp(norm, min=0.0)))
    return torch.clamp(torch.round(mapped * 127.0), -127, 127).to(torch.int8)


def adam8_update_ref(p, g, st: Quant8State, lr: float, step: int, *,
                     b1: float, b2: float, eps: float, wd: float) -> None:
    """Plain version of the fused step on one leaf, in place on ``p`` and
    ``st`` (the tail of the last row is padded with zeros, which the JAX
    package pads with too and which leave the row's absmax unchanged)."""
    n = p.numel()
    rows = st.mq.shape[0]
    pad = rows * BLOCK - n

    def rows2d(x):
        return torch.nn.functional.pad(x.reshape(-1).float(),
                                       (0, pad)).reshape(rows, BLOCK)

    gf, pf = rows2d(g), rows2d(p)
    mq = st.mq.float() / 127.0
    m = torch.sign(mq) * mq * mq * st.ms[:, None]
    vq = st.vq.float() / 127.0
    v = (vq * vq) * (vq * vq) * st.vs[:, None]
    m = b1 * m + (1.0 - b1) * gf
    v = b2 * v + (1.0 - b2) * gf * gf
    bc1, bc2 = bias_corrections(step, b1, b2)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
    p.copy_((pf - lr * upd).reshape(-1)[:n].reshape(p.shape))
    ms = torch.clamp(m.abs().amax(dim=1), min=1e-24)
    vs = torch.clamp(v.abs().amax(dim=1), min=1e-24)
    st.mq.copy_(_quant(m, ms, 2))
    st.vq.copy_(_quant(v, vs, 4))
    st.ms.copy_(ms)
    st.vs.copy_(vs)


def _check_leaf(p, g, st: Quant8State) -> None:
    rows = -(-p.numel() // BLOCK)
    for name, t, dt, shape in (("p", p, torch.float32, None),
                               ("g", g, torch.float32, None),
                               ("mq", st.mq, torch.int8, (rows, BLOCK)),
                               ("ms", st.ms, torch.float32, (rows,)),
                               ("vq", st.vq, torch.int8, (rows, BLOCK)),
                               ("vs", st.vs, torch.float32, (rows,))):
        if t.device != p.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"adam8: {name} must be contiguous {dt} on "
                             f"{p.device}, got {t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"adam8: {name} shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if g.numel() != p.numel():
        raise ValueError(f"adam8: g has {g.numel()} elements, p {p.numel()}")


def adam8_update(p, g, st: Quant8State, lr: float, step: int, *,
                 b1: float, b2: float, eps: float, wd: float) -> None:
    """One fused 8-bit AdamW step on one leaf, in place: the kernel on
    CUDA, ``adam8_update_ref`` on the CPU."""
    if p.device.type == "cpu":
        return adam8_update_ref(p, g, st, lr, step, b1=b1, b2=b2, eps=eps,
                                wd=wd)
    if p.device.type != "cuda":
        raise ValueError(f"adam8: no kernel for device {p.device}")
    _check_leaf(p, g, st)
    bc1, bc2 = bias_corrections(step, b1, b2)
    _kernels.adam8(p, g, st.mq, st.ms, st.vq, st.vs, lr, bc1, bc2, b1,
                   1.0 - b1, b2, 1.0 - b2, eps, wd)


def leaf_parts(leaf) -> list:
    """The tensors of one leaf (a tensor, or a list of stacked parts)."""
    return list(leaf) if isinstance(leaf, (list, tuple)) else [leaf]


def _stacked(parts):
    """The leaf as one array: the tensor itself, or its parts stacked on a
    new leading axis (a copy)."""
    return parts[0] if len(parts) == 1 else torch.stack(parts)


class AdamW8bit:
    """AdamW with blockwise-int8 moments over a list of leaves, updated in
    place (bitsandbytes' AdamW8bit as the JAX package has it)."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 min_8bit_size: int = MIN_8BIT_SIZE):
        self.schedule = (learning_rate if callable(learning_rate)
                         else (lambda _: learning_rate))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.min_8bit_size = min_8bit_size

    def leaf_init(self, leaf):
        parts = leaf_parts(leaf)
        dev = parts[0].device
        shape = parts[0].shape if len(parts) == 1 \
            else (len(parts), *parts[0].shape)
        n = math.prod(shape)
        if n >= self.min_8bit_size:
            rows = -(-n // BLOCK)
            z8 = lambda: torch.zeros((rows, BLOCK), dtype=torch.int8,
                                     device=dev)
            z32 = lambda: torch.zeros((rows,), dtype=torch.float32,
                                      device=dev)
            return Quant8State(mq=z8(), ms=z32(), vq=z8(), vs=z32())
        z = lambda: torch.zeros(shape, dtype=torch.float32, device=dev)
        return FP32Moments(m=z(), v=z())

    def init(self, params) -> Adam8State:
        return Adam8State(count=0, per_leaf=[self.leaf_init(p)
                                             for p in params])

    @torch.no_grad()
    def update(self, grads, state: Adam8State, params) -> Adam8State:
        step = state.count + 1
        lr = float(self.schedule(state.count))
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        for g, leaf, st in zip(grads, params, state.per_leaf):
            parts = leaf_parts(leaf)
            p, g = _stacked(parts), _stacked(leaf_parts(g))
            if isinstance(st, Quant8State):
                adam8_update(p, g, st, lr, step, b1=b1, b2=b2, eps=eps,
                             wd=wd)
            else:
                gf = g.float()
                st.m.mul_(b1).add_((1 - b1) * gf)
                st.v.mul_(b2).add_((1 - b2) * gf * gf)
                m_hat = st.m / _fp32_bias_correction(b1, step)
                v_hat = st.v / _fp32_bias_correction(b2, step)
                upd = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
                p.add_((-lr * upd).to(p.dtype))
            if len(parts) > 1:
                for t, x in zip(parts, p):
                    t.copy_(x)
        state.count = step
        return state


def adamw8bit(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 1e-4,
              min_8bit_size: int = MIN_8BIT_SIZE) -> AdamW8bit:
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay, min_8bit_size)
