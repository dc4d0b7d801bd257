"""Fused GroupNorm(+SiLU) (counterpart of ``sdbc_tpu/ops/pallas_groupnorm.py``).

``nn.group_norm`` routes here under ``SDBC_GN_FUSED=1`` when ``eligible``
holds: the JAX package's rule, with its TPU test replaced by a CUDA one —
the channels divide into the groups and one sample's fp32 working copy is
at most 6 MiB (kept as it is, so the same tensors take the kernel in both
packages).  At SD-1.5 512² that admits the UNet's 64²×320 tensors, every
32² tensor up to 1280 channels and all 16² and 8² ones; not 64²×640/960,
32²×1920 or any VAE tensor.

The math (``group_norm_fused_ref``, the kernel's formula): fp32 channel
sums s1 = Σx and s2 = Σx² over the rows, group sums of those, mean =
s1/count and var = max(s2/count − mean², 0) with count = rows·C/G,
inv = rsqrt(var + eps); per channel a = inv·scale and b = bias − mean·a;
y = x·a + b, SiLU if asked, cast back to x's dtype.

On CUDA the forward is one launch of the kernel of
``csrc/group_norm_sm90.cu``: one thread-block cluster per sample, the
sample's rows split over its CTAs and held in their shared memory between
the statistics and the normalisation, the statistics reduced over
distributed shared memory.  ``plan`` lays a call out (cluster size, threads,
resident rows) from the card's cluster occupancy.  On a CPU tensor the
forward is ``group_norm_fused_ref``.  The gradient recomputes through
``group_norm_fused_ref`` under autograd, as the JAX package's custom VJP
does through its reference (it has no backward kernel either).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from sdbc_tpu_torch.ops import _kernels

VMEM_BYTES_LIMIT = 6 * 1024 * 1024  # the JAX rule's per-sample fp32 budget
# the kernel's limits (csrc/group_norm_sm90.cu)
SMEM_MAX = 232448  # dynamic shared memory a block may use (227 KB)
MAX_THREADS = 512
MAX_CLUSTER = 16  # the non-portable cluster size
HEAD_BYTES = 128  # the mbarrier
# a sample is spread over no more CTAs than leave each this many bytes
MIN_CTA_BYTES = 8192


def _on_cuda(x) -> bool:
    return x.is_cuda


def fits(shape, num_groups: int) -> bool:
    """The JAX rule on a shape (N, ..., C): C divides into the groups and
    one sample's fp32 copy is at most 6 MiB."""
    per_sample = 4
    for n in shape[1:]:
        per_sample *= n
    return shape[-1] % num_groups == 0 and per_sample <= VMEM_BYTES_LIMIT


def eligible(x, num_groups: int) -> bool:
    return _on_cuda(x) and fits(tuple(x.shape), num_groups)


def group_norm_fused_ref(x, weight, bias, num_groups: int, eps: float,
                         act: Optional[str] = None):
    """The plain version, over (N, ..., C) with the kernel's formula."""
    n, c = x.shape[0], x.shape[-1]
    cpg = c // num_groups
    xf = x.reshape(n, -1, c).float()
    count = float(xf.shape[1] * cpg)
    s1 = xf.sum(dim=1).view(n, num_groups, cpg).sum(dim=-1)
    s2 = (xf * xf).sum(dim=1).view(n, num_groups, cpg).sum(dim=-1)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(cpg, dim=1) * weight.float()
    b = bias.float() - mean.repeat_interleave(cpg, dim=1) * a
    y = xf * a[:, None, :] + b[:, None, :]
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


@dataclass(frozen=True)
class Plan:
    """How one call lays out on the card: one cluster of ``cluster`` CTAs
    per sample, CTA r taking rows [r·hw/cluster, (r+1)·hw/cluster); in each,
    ``threads`` threads of which ``lanes`` × ``cv`` own (row lane, vector
    column) items of ``vec`` channels (16 bytes, or 1 channel); the first
    ``resident`` rows of a CTA's slab held in shared memory (one bulk copy
    on the 16-byte path); ``smem`` bytes of dynamic shared memory;
    ``waves`` rounds of clusters a batch takes (1 when the card holds them
    all at once)."""

    hw: int
    cluster: int
    threads: int
    lanes: int
    cv: int
    vec: int
    resident: int
    smem: int
    waves: int

    def row_ranges(self):
        return [(r * self.hw // self.cluster,
                 (r + 1) * self.hw // self.cluster)
                for r in range(self.cluster)]

    @property
    def rows_max(self) -> int:
        return -(-self.hw // self.cluster)

    @property
    def reread(self) -> bool:
        """Whether rows past ``resident`` are read twice (from the L2)."""
        return self.resident < self.rows_max


def slab_offset(groups: int, cluster: int, lanes: int, cv: int,
                vec: int) -> int:
    """Bytes of the kernel's shared memory before the slab (as
    ``csrc/group_norm_sm90.cu::slab_offset``): the mbarrier, fp32 group
    sums (2, G), the receive buffer (cluster, 2, G) and the lane partials
    (2, lanes, cv·vec), rounded up to 128."""
    floats = 2 * groups + 2 * cluster * groups + 2 * lanes * cv * vec
    return -(-(HEAD_BYTES + 4 * floats) // 128) * 128


def plan(n: int, hw: int, c: int, dtype, groups: int = 32,
         occupancy: Optional[Callable[[int, int, int], int]] = None,
         aligned: bool = True) -> Plan:
    """Lay out one call over (n, hw, c) in ``dtype`` (bf16 or fp32).

    16-byte vectors when a row is whole vectors and the base ``aligned``,
    else one channel an access.  A sample spreads over up to 16 CTAs (no
    thinner than ``MIN_CTA_BYTES`` a CTA, at least a row each), each CTA
    holding as many of its rows as shared memory takes.  The fewest waves
    win (n clusters over ``occupancy(cluster, threads, smem)``, the card's
    ``cudaOccupancyMaxActiveClusters``; None: all at once), then the
    largest cluster.  (CTAs sized to fit two an SM, so that 16-CTA
    clusters hold batch 8 at once, ran slower on the H100: the card packs
    two on an SM.)"""
    elem = {torch.bfloat16: 2, torch.float32: 4}[dtype]
    vec = 16 // elem if aligned and (c * elem) % 16 == 0 else 1
    nv = c // vec
    cv = -(-nv // -(-nv // MAX_THREADS))  # column chunks of <= MAX_THREADS
    row_bytes = c * elem
    top = max(1, min(MAX_CLUSTER, hw, hw * row_bytes // MIN_CTA_BYTES))
    best = None
    for cs in range(top, 0, -1):
        rows_max = -(-hw // cs)
        lanes = max(1, min(rows_max, MAX_THREADS // cv))
        threads = -(-lanes * cv // 32) * 32
        head = slab_offset(groups, cs, lanes, cv, vec)
        if head > SMEM_MAX:
            continue
        resident = min(rows_max, (SMEM_MAX - head) // row_bytes)
        smem = head + resident * row_bytes
        held = occupancy(cs, threads, smem) if occupancy else n
        if held < 1:
            continue
        p = Plan(hw=hw, cluster=cs, threads=threads, lanes=lanes, cv=cv,
                 vec=vec, resident=resident, smem=smem, waves=-(-n // held))
        if p.waves == 1:
            return p
        if best is None or p.waves < best.waves:
            best = p
    if best is None:
        raise ValueError(f"gn_fused: no layout of ({n}, {hw}, {c}) with "
                         f"{groups} groups fits {SMEM_MAX} bytes of shared "
                         f"memory")
    return best


_plans = {}
_occupancy = {}


def card_occupancy(dtype, aligned: bool, silu: bool, device):
    """``occupancy`` for ``plan`` on the card ``device``: the kernel's
    ``cudaOccupancyMaxActiveClusters`` for its instantiation, each reading
    kept."""
    def occupancy(cs, threads, smem):
        key = (dtype, aligned, silu, cs, threads, smem, device)
        if key not in _occupancy:
            _occupancy[key] = _kernels.group_norm_max_clusters(
                dtype, aligned, silu, cs, threads, smem)
        return _occupancy[key]
    return occupancy


def _card_plan(n, hw, c, dtype, groups, aligned, silu, device) -> Plan:
    key = (n, hw, c, dtype, groups, aligned, silu, device)
    p = _plans.get(key)
    if p is None:
        # the occupancy is the card's of x (device None: no card to ask)
        with (contextlib.nullcontext() if device is None
              else torch.cuda.device(device)):
            p = _plans[key] = plan(
                n, hw, c, dtype, groups,
                card_occupancy(dtype, aligned, silu, device), aligned)
    return p


def _param(t):
    """A scale or bias as the kernel reads it: bf16 or fp32, contiguous."""
    if t.dtype is not torch.bfloat16 and t.dtype is not torch.float32:
        t = t.float()
    return t.contiguous()


_launches = {}


def _launch(x, weight, bias, num_groups: int, eps: float, silu: bool):
    """One launch: the layout is worked out (and checked) once per shape,
    dtypes, groups, eps, act, alignment and card, then kept."""
    x = x.contiguous()
    weight, bias = _param(weight), _param(bias)
    key = (x.shape, x.dtype, weight.shape, weight.dtype, bias.shape,
           bias.dtype, num_groups, eps, silu, x.data_ptr() % 16 == 0,
           x.get_device())
    launch = _launches.get(key)
    if launch is None:
        launch = _launches[key] = _configure(x, weight, bias, num_groups,
                                             eps, silu)
    y = torch.empty_like(x)
    _kernels.group_norm(x, weight, bias, y, launch)
    return y


def _configure(x, weight, bias, num_groups: int, eps: float, silu: bool):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gn_fused kernel takes bfloat16 or float32, got "
                        f"{x.dtype}")
    n, c = x.shape[0], x.shape[-1]
    if x.dim() < 2 or x.numel() == 0 or c % num_groups \
            or weight.numel() != c or bias.numel() != c:
        raise ValueError(f"gn_fused: {tuple(x.shape)} with {num_groups} "
                         f"groups, scale {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}")
    hw = x.numel() // (n * c)
    p = _card_plan(n, hw, c, x.dtype, num_groups, x.data_ptr() % 16 == 0,
                   silu, x.device.index)
    return _kernels.group_norm_launch(n, hw, c, num_groups, p, eps, silu,
                                      x.dtype, weight.dtype, bias.dtype)


def _forward(x, weight, bias, num_groups, eps, act):
    if x.is_cuda:
        return _launch(x, weight, bias, num_groups, eps, act == "silu")
    if x.device.type == "cpu":
        return group_norm_fused_ref(x, weight, bias, num_groups, eps, act)
    raise ValueError(f"gn_fused: no kernel for device {x.device}")


class _FusedGroupNorm(torch.autograd.Function):
    """The custom VJP ``_gn``: the kernel forward, a backward through the
    plain reference."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, act)
        return _forward(x, weight, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, gy):
        x, weight, bias = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(True) for t in (x, weight, bias)]
            y = group_norm_fused_ref(*xs, *ctx.cfg)
            dx, dw, db = torch.autograd.grad(y, xs, gy)
        return dx, dw, db, None, None, None


def fused_group_norm(x, weight, bias, num_groups: int = 32,
                     eps: float = 1e-6, act: Optional[str] = None):
    """Drop-in for ``nn.group_norm`` when ``eligible`` holds: NHWC (or
    N…C) ``x``, per-channel ``weight``/``bias``."""
    if act not in (None, "silu"):
        raise ValueError(f"unknown act {act}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _FusedGroupNorm.apply(x, weight, bias, num_groups, eps, act)
    return _forward(x, weight, bias, num_groups, eps, act)
