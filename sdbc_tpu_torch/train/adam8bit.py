"""Blockwise 8-bit AdamW (counterpart of ``sdbc_tpu/train/adam8bit.py``).

Moments of every leaf with at least ``min_8bit_size`` elements are stored
as int8 with one fp32 absmax per 2048-element row: m as sign·sqrt, v as a
4th root (the closed-form stand-in for bitsandbytes' dynamic map that keeps
tiny v entries representable).  One step per leaf dequantizes, updates the
moments, applies p −= lr·(m̂/(√v̂+eps) + wd·p) with the bias corrections
1 − exp(step·ln b), and requantizes with the row's new absmax (round half
to even, clip to ±127).  Smaller leaves keep fp32 moments.

On CUDA one launch of ``csrc/adam8bit.cu`` steps every 8-bit leaf of an
optimizer step (``adam8_update_leaves``: a table of the leaves' pointers
copied to the card each step, the gradients being new tensors every
step), reading and writing the parameters, gradients and moments in
place; on the CPU it computes ``adam8_update_leaves_ref``, which
addresses the elements as the kernel does, and ``adam8_update`` (one
leaf) ``adam8_update_ref``: the plain version of the same math.  The
per-row scale is stored as (rows,): the JAX package broadcasts it to 128
lanes only for the TPU's layout.

The port updates parameters in place (the JAX transformation returns
updates).  A leaf is one tensor, or a list of same-shape tensors that the
JAX package holds as one array stacked on a new leading axis (the CLIP
text encoder's layers, ``trainer.optimizer_leaves``): the size rule, the
2048-element rows and the fp32 moments' shape apply to the stacked array.
An 8-bit leaf's element i lives in part i // part_n at i % part_n, where
the kernel reads and writes it; a small leaf's update builds the stacked
array, steps it and copies it back to the parts.
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


def _step_rows(pf, gf, mq, ms, vq, vs, lr: float, step: int, *, b1: float,
               b2: float, eps: float, wd: float):
    """The fused step's math on (rows, BLOCK) fp32 parameters and gradients
    (zero past a leaf's end) and their moments: (new parameters, mq, ms,
    vq, vs)."""
    mq = mq.float() / 127.0
    m = torch.sign(mq) * mq * mq * ms[:, None]
    vq = vq.float() / 127.0
    v = (vq * vq) * (vq * vq) * vs[:, None]
    m = b1 * m + (1.0 - b1) * gf
    v = b2 * v + (1.0 - b2) * gf * gf
    bc1, bc2 = bias_corrections(step, b1, b2)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
    ms = torch.clamp(m.abs().amax(dim=1), min=1e-24)
    vs = torch.clamp(v.abs().amax(dim=1), min=1e-24)
    return pf - lr * upd, _quant(m, ms, 2), ms, _quant(v, vs, 4), vs


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

    pn, mq, ms, vq, vs = _step_rows(rows2d(p), rows2d(g), st.mq, st.ms,
                                    st.vq, st.vs, lr, step, b1=b1, b2=b2,
                                    eps=eps, wd=wd)
    p.copy_(pn.reshape(-1)[:n].reshape(p.shape))
    for dst, src in ((st.mq, mq), (st.ms, ms), (st.vq, vq), (st.vs, vs)):
        dst.copy_(src)


def _checked_ptr(name, t, dt, dev, shape, align: int) -> int:
    """``t``'s address, after checking it is what the kernel takes: a
    contiguous ``dt`` tensor of ``shape`` on device index ``dev``, its
    address a multiple of ``align``."""
    ptr = t.data_ptr()
    if t.dtype is not dt or t.get_device() != dev or not t.is_contiguous():
        raise ValueError(f"adam8: {name} must be contiguous {dt} on device "
                         f"{dev}, got {t.dtype} on {t.device}")
    if t.shape != shape:
        raise ValueError(f"adam8: {name} shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if ptr % align:
        raise ValueError(f"adam8: {name} is not {align}-byte aligned (the "
                         f"kernel's vector accesses)")
    return ptr


def leaf_table(leaves):
    """The kernel's table of 8-bit leaves, each ``(p parts, g parts,
    Quant8State)``: int64 words, per leaf (first global row, n, part
    length, first part, mq, ms, vq, vs pointers), then per part (p, g
    pointers); and the number of global rows.  Checks every tensor the
    kernel reads or writes (raises on what it does not take)."""
    dev = leaves[0][0][0].get_device()
    f32, i8 = torch.float32, torch.int8
    words, part_words, row = [], [], 0
    for parts, grads, st in leaves:
        shape = parts[0].shape
        part_n = parts[0].numel()
        n = part_n * len(parts)
        rows = -(-n // BLOCK)
        if len(grads) != len(parts):
            raise ValueError(f"adam8: {len(grads)} gradient parts for "
                             f"{len(parts)} parameter parts")
        if n >= 2 ** 31 - BLOCK:
            raise ValueError(f"adam8: a leaf of {n} elements (the kernel "
                             f"indexes a leaf in 32 bits)")
        words += [row, n, part_n, len(part_words) // 2,
                  _checked_ptr("mq", st.mq, i8, dev, (rows, BLOCK), 16),
                  _checked_ptr("ms", st.ms, f32, dev, (rows,), 4),
                  _checked_ptr("vq", st.vq, i8, dev, (rows, BLOCK), 16),
                  _checked_ptr("vs", st.vs, f32, dev, (rows,), 4)]
        for p, g in zip(parts, grads):
            part_words += [_checked_ptr("p", p, f32, dev, shape, 16),
                           _checked_ptr("g", g, f32, dev, shape, 16)]
        row += rows
    return np.array(words + part_words, dtype=np.uint64).view(np.int64), row


def adam8_update_leaves_ref(leaves, lr: float, step: int, *, b1: float,
                            b2: float, eps: float, wd: float) -> None:
    """Plain version of the multi-leaf kernel, addressing the elements as
    it does: the step's global rows, row → leaf by the leaves' first rows,
    element i of a leaf → part i // part_n at i % part_n; in place on
    every part and moment."""
    part_n = [parts[0].numel() for parts, _, _ in leaves]
    n = np.array([pn * len(parts) for pn, (parts, _, _) in
                  zip(part_n, leaves)], dtype=np.int64)
    rows = -(-n // BLOCK)
    row0 = np.concatenate([[0], np.cumsum(rows)[:-1]])
    part0 = np.concatenate([[0], np.cumsum([len(p) for p, _, _ in
                                            leaves])[:-1]])
    flat_p = [t.reshape(-1) for parts, _, _ in leaves for t in parts]
    flat_g = [t.reshape(-1) for _, grads, _ in leaves for t in grads]
    base = np.concatenate([[0], np.cumsum([t.numel() for t in flat_p])])
    r = np.arange(int(rows.sum()))
    leaf = np.searchsorted(row0, r, side="right") - 1
    i = (r - row0[leaf])[:, None] * BLOCK + np.arange(BLOCK)[None]
    valid = i < n[leaf][:, None]
    pn = np.array(part_n, dtype=np.int64)[leaf][:, None]
    addr = base[part0[leaf][:, None] + i // pn] + i % pn
    all_p, all_g = torch.cat(flat_p), torch.cat(flat_g)
    addr = torch.from_numpy(np.where(valid, addr, 0)).to(all_p.device)
    valid = torch.from_numpy(valid).to(all_p.device)
    pf = torch.where(valid, all_p[addr], 0.0)
    gf = torch.where(valid, all_g[addr].float(), 0.0)
    cat = lambda name: torch.cat([getattr(st, name) for _, _, st in leaves])
    pn_, mq, ms, vq, vs = _step_rows(pf, gf, cat("mq"), cat("ms"), cat("vq"),
                                     cat("vs"), lr, step, b1=b1, b2=b2,
                                     eps=eps, wd=wd)
    all_p[addr[valid]] = pn_[valid]
    for t, new in zip(flat_p, torch.split(all_p, [t.numel() for t in
                                                   flat_p])):
        t.copy_(new)
    for name, new in (("mq", mq), ("ms", ms), ("vq", vq), ("vs", vs)):
        for (_, _, st), part in zip(leaves, torch.split(new, rows.tolist())):
            getattr(st, name).copy_(part)


def adam8_update_leaves(leaves, lr: float, step: int, *, b1: float,
                        b2: float, eps: float, wd: float) -> None:
    """One fused 8-bit AdamW step on every leaf of ``leaves``, each ``(p
    parts, g parts, Quant8State)``, in place: one kernel launch on CUDA
    (the table copied to the card), ``adam8_update_leaves_ref`` on the
    CPU."""
    if not leaves:
        return
    dev = leaves[0][0][0].device
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd)
    if dev.type == "cpu":
        return adam8_update_leaves_ref(leaves, lr, step, **kw)
    if dev.type != "cuda":
        raise ValueError(f"adam8: no kernel for device {dev}")
    words, rows = leaf_table(leaves)
    # a pinned staging copy, kept by PyTorch's host allocator until the
    # copy to the card has run
    table = torch.from_numpy(words).pin_memory().to(dev, non_blocking=True)
    bc1, bc2 = bias_corrections(step, b1, b2)
    _kernels.adam8(table, len(leaves), rows, lr, bc1, bc2, b1, 1.0 - b1, b2,
                   1.0 - b2, eps, wd)


def adam8_update(p, g, st: Quant8State, lr: float, step: int, *,
                 b1: float, b2: float, eps: float, wd: float) -> None:
    """One fused 8-bit AdamW step on one leaf, in place: the kernel (a
    table of one leaf) on CUDA, ``adam8_update_ref`` on the CPU."""
    if p.device.type == "cpu":
        return adam8_update_ref(p, g, st, lr, step, b1=b1, b2=b2, eps=eps,
                                wd=wd)
    adam8_update_leaves([([p], [g], st)], lr, step, b1=b1, b2=b2, eps=eps,
                        wd=wd)


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
        eight = []
        for g, leaf, st in zip(grads, params, state.per_leaf):
            parts = leaf_parts(leaf)
            if isinstance(st, Quant8State):  # in place, in one launch below
                eight.append((parts, leaf_parts(g), st))
                continue
            p, g = _stacked(parts), _stacked(leaf_parts(g))
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
        adam8_update_leaves(eight, lr, step, b1=b1, b2=b2, eps=eps, wd=wd)
        state.count = step
        return state


def adamw8bit(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 1e-4,
              min_8bit_size: int = MIN_8BIT_SIZE) -> AdamW8bit:
    return AdamW8bit(learning_rate, b1, b2, eps, weight_decay, min_8bit_size)
