"""Collectives over the mesh's groups: the one module of the port that
calls ``torch.distributed``.

The backend follows the device: NCCL for CUDA tensors, gloo for CPU
tensors.  One exception is explicit: gloo with CUDA tensors, which only a
run of several ranks on one card takes (NCCL refuses two ranks on one
device).  gloo takes CUDA tensors for all-reduce and broadcast only, so
there the other collectives copy through pinned host memory: that is
``staged``, counted per operation in ``STAGED`` and never taken under
NCCL (``staged`` raises on any backend but gloo).

A ``group`` of None is every rank (the default group).

The autograd functions are the tensor- and data-parallel operators:

  - ``copy_to`` / ``reduce_from``: Megatron's f and g (identity forward
    with an all-reduce backward; an all-reduce forward with an identity
    backward) over the model group;
  - ``scatter_to`` / ``gather_from``: this rank's slice of the last dim
    (backward: the all-gather) and its inverse;
  - ``fsdp_gather``: a sharded parameter gathered at use (all-gather
    along its shard dim, or a broadcast from the rank that owns a whole
    layer), its gradient reduce-scattered (or reduced to the owner) in
    the backward pass.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

# host-staged collectives of the gloo-with-CUDA-tensors case, per operation
STAGED = {"all_gather": 0, "reduce_scatter": 0, "reduce": 0}

# gradient buckets of the data-parallel all-reduce (not tuned)
BUCKET_BYTES = 256 * 2 ** 20


def reset_staged() -> None:
    for k in STAGED:
        STAGED[k] = 0


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _global(group, group_rank: int) -> int:
    return (group_rank if group is None
            else dist.get_global_rank(group, group_rank))


def staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``t`` over ``group`` goes through host
    memory: gloo with a CUDA tensor."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


# the names torch 2.13 gives the flat collectives (older releases: the
# *_tensor ones, which 2.13 deprecates)
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


# ---------------------------------------------------------------------------
# plain collectives


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce (gloo takes CUDA tensors here)."""
    dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """In-place broadcast from group rank ``src``."""
    dist.broadcast(t, src=_global(group, src), group=group)
    return t


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``, in group
    rank order."""
    n = size(group)
    x = t.movedim(dim, 0).contiguous()
    if staged(x, group):
        STAGED["all_gather"] += 1
        src = _host(x)
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, pin_memory=True)
        _all_gather_flat(out, src, group=group)
        out = out.to(t.device, non_blocking=False)
    else:
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather_flat(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group of ``t``, this rank's chunk along ``dim``."""
    n = size(group)
    x = t.movedim(dim, 0).contiguous()
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    if staged(x, group):
        STAGED["reduce_scatter"] += 1
        src = _host(x)
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        _reduce_scatter_flat(out, src, group=group)
        out = out.to(t.device)
    else:
        out = x.new_empty(shape)
        _reduce_scatter_flat(out, x, group=group)
    return out.movedim(0, dim)


def reduce_(t: torch.Tensor, group, dst: int) -> torch.Tensor:
    """The sum over the group of ``t`` into group rank ``dst``'s ``t``
    (the others' ``t`` is left undefined)."""
    if staged(t, group):
        STAGED["reduce"] += 1
        h = _host(t.contiguous())
        dist.reduce(h, dst=_global(group, dst), group=group)
        t.copy_(h)
        return t
    dist.reduce(t, dst=_global(group, dst), group=group)
    return t


def all_reduce_mean_(tensors: List[torch.Tensor], group) -> None:
    """Replace every tensor by its mean over ``group``, through a few flat
    buffers (one per ``BUCKET_BYTES`` of each dtype), not one collective
    per tensor."""
    n = size(group)
    by_key: dict = {}
    for t in tensors:
        if t.numel():
            by_key.setdefault((t.dtype, t.device), []).append(t)
    for group_ts in by_key.values():
        bucket, nbytes = [], 0
        for t in group_ts + [None]:
            if t is not None and (not bucket or nbytes + t.numel()
                                  * t.element_size() <= BUCKET_BYTES):
                bucket.append(t)
                nbytes += t.numel() * t.element_size()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(n)
            at = 0
            for b in bucket:
                b.copy_(flat[at:at + b.numel()].view_as(b))
                at += b.numel()
            if t is not None:
                bucket, nbytes = [t], t.numel() * t.element_size()


def all_reduce_scalars(values: List[float], group,
                       op=dist.ReduceOp.SUM, device="cpu") -> List[float]:
    """Reduce a few host scalars over ``group`` in one fp64 collective."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op, group=group)
    return t.tolist()


def shard_of(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (a copy)."""
    n = size(group)
    return t.chunk(n, dim=dim)[rank(group)].contiguous()


# ---------------------------------------------------------------------------
# tensor-parallel operators


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shard_of(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=g.dim() - 1), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group, dim=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        return shard_of(g, ctx.group, -1), None


def copy_to(x, tp):
    """Identity forward; the gradient all-reduced over the model group."""
    return _CopyTo.apply(x, tp.group)


def reduce_from(x, tp):
    """The sum over the model group of the partial products ``x``."""
    return _ReduceFrom.apply(x, tp.group)


def scatter_to(x, tp):
    """This rank's slice of the last dim of a replicated ``x``."""
    return _ScatterTo.apply(x, tp.group)


def gather_from(x, tp):
    """The model group's last-dim slices concatenated."""
    return _GatherFrom.apply(x, tp.group)


# ---------------------------------------------------------------------------
# FSDP: a parameter gathered at use


class _FsdpSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(shard, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _FsdpOwner(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, group, owner, shape):
        ctx.group, ctx.owner = group, owner
        ctx.mine = rank(group) == owner
        full = (shard.detach().clone() if ctx.mine
                else shard.new_empty(shape))
        return broadcast_(full, group, owner)

    @staticmethod
    def backward(ctx, g):
        g = reduce_(g.contiguous().clone(), ctx.group, ctx.owner)
        return (g if ctx.mine else g.new_empty((0,))), None, None, None


def fsdp_gather(shard, info):
    """The full parameter of an FSDP shard (``info``: a
    ``parallel.shard.FsdpShard``)."""
    if info.owner is None:
        return _FsdpSplit.apply(shard, info.group, info.dim)
    return _FsdpOwner.apply(shard, info.group, info.owner, info.shape)
