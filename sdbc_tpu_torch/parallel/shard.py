"""The specs of ``parallel.specs`` applied to the port's modules.

``shard_modules`` cuts every parameter to this rank's part, in place (the
``Parameter`` objects stay, so optimizer leaves keep pointing at them),
and marks each one with its ``ShardInfo`` (``p._sdbc_shard``):

  - tensor parallelism (``model``): the rank keeps its slice of the spec's
    dim and computes with it; the modules whose weights are cut get a
    ``TPGroup`` (``mha.tp``, ``resblock.tp``, a transformer block's
    ``ff_tp``, a transformer's ``proj_tp``, CLIP's ``attn.tp`` /
    ``mlp.tp``), which their forward reads (``models/unet.py``,
    ``models/clip.py``);
  - FSDP (``data``, ZeRO-3): the rank keeps its chunk of the spec's dim;
    a stacked leaf sharded on its layer axis leaves each layer whole on
    the rank that owns it (an empty tensor elsewhere).  The module's
    class becomes a subclass whose attribute access gathers the shard
    (``comm.fsdp_gather``): every use gathers, in the forward pass and in
    a remat recompute, and the backward pass reduce-scatters (or reduces
    to the owner) the gradient.  ``named_parameters`` and ``state_dict``
    still give the shards.

A sharded leaf is always cut from the full leaf that was carried across
(``models.convert``): there is no second conversion path.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch

from sdbc_tpu_torch.parallel import comm


class _Shared:
    """Deep copies share the process group (a group cannot be copied)."""

    def __deepcopy__(self, memo):
        return self


@dataclasses.dataclass(eq=False)
class TPGroup(_Shared):
    group: object
    size: int
    rank: int


@dataclasses.dataclass(eq=False)
class FsdpShard(_Shared):
    group: object
    dim: Optional[int]      # the port tensor's shard dim (None: owner mode)
    owner: Optional[int]    # group rank holding a whole layer, or None
    shape: tuple            # the gathered (TP-local) shape


@dataclasses.dataclass(eq=False)
class ShardInfo(_Shared):
    shape: tuple                       # the full parameter's shape
    tp_dim: Optional[int] = None       # the port tensor's model-axis dim
    tp: Optional[TPGroup] = None
    fsdp: Optional[FsdpShard] = None


def info(p) -> Optional[ShardInfo]:
    return getattr(p, "_sdbc_shard", None)


def mark_like(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst`` (an optimizer moment, an EMA copy) marked as ``src``'s
    shard."""
    if info(src) is not None:
        dst._sdbc_shard = info(src)
    return dst


_LAYER = re.compile(r"(?:^|\.)(?:layers|blocks)\.(\d+)\.[^.]+\.")

_GATHERING: dict = {}


def _gathering_class(cls):
    sub = _GATHERING.get(cls)
    if sub is None:
        def __getattr__(self, name):
            value = torch.nn.Module.__getattr__(self, name)
            i = info(value)
            if i is not None and i.fsdp is not None \
                    and isinstance(value, torch.nn.Parameter):
                return comm.fsdp_gather(value, i.fsdp)
            return value

        sub = type(cls.__name__, (cls,), {"__getattr__": __getattr__,
                                          "_fsdp_base": cls})
        _GATHERING[cls] = sub
    return sub


@torch.no_grad()
def shard_modules(models: dict, mesh, *, tp: bool = False,
                  fsdp: bool = False, exclude: tuple = (),
                  min_size: int = 2 ** 12, specs: Optional[dict] = None
                  ) -> dict:
    """Cut ``{component: module}`` to this rank's part in place (module
    docstring); returns the {path: spec} applied.  ``specs`` may be
    given (e.g. the parameters' own, for an EMA copy)."""
    from sdbc_tpu_torch.models.convert import jax_key, stacked
    from sdbc_tpu_torch.parallel.mesh import mesh_shape

    if specs is None:
        from sdbc_tpu_torch.parallel import specs as S

        specs = S.tp_specs(models, mesh, exclude=exclude) if tp else None
        if fsdp:
            specs = S.fsdp_specs(models, mesh, base=specs,
                                 min_size=min_size)
    shape = mesh_shape(mesh)
    tpg = (TPGroup(mesh.get_group("model"), shape["model"],
                   mesh.get_local_rank("model")) if shape["model"] > 1
           else None)
    dgroup = mesh.get_group("data")
    n, drank = shape["data"], mesh.get_local_rank("data")
    for comp, value in models.items():
        mods = (list(enumerate(value)) if isinstance(value, (list, tuple))
                else [(None, value)])
        for i, mod in mods:
            head = comp if i is None else f"{comp}/{i}"
            owners = set()
            for name, p in list(mod.named_parameters()):
                if info(p) is not None:
                    raise ValueError(f"{head}.{name} is sharded already")
                key = jax_key(mod, name)
                spec = specs[head + "/" + "/".join(k for k, _ in key)]
                if not spec:
                    continue
                spec = spec + (None,) * (
                    p.dim() + stacked(key) - len(spec))
                layer_axis = None
                if stacked(key):
                    layer_axis, spec = spec[0], spec[1:]
                if layer_axis == "model":
                    raise ValueError(f"{head}.{name}: a stacked layer axis "
                                     "cannot carry the model axis")
                si = ShardInfo(shape=tuple(p.shape))
                t = p.data
                if "model" in spec:
                    si.tp_dim, si.tp = spec.index("model"), tpg
                    t = t.chunk(tpg.size, dim=si.tp_dim)[tpg.rank]
                if "data" in spec:
                    d = spec.index("data")
                    si.fsdp = FsdpShard(dgroup, d, None, tuple(t.shape))
                    t = t.chunk(n, dim=d)[drank]
                elif layer_axis == "data":
                    layers = sum(1 for q, _ in mod.named_parameters()
                                 if jax_key(mod, q) == key)
                    owner = int(_LAYER.search(name).group(1)) // (
                        layers // n)
                    si.fsdp = FsdpShard(dgroup, None, owner,
                                        tuple(t.shape))
                    if owner != drank:
                        t = t.new_empty((0,))
                p.data = t.contiguous().clone()
                p._sdbc_shard = si
                owner_name = name.rpartition(".")[0]
                if si.fsdp is not None:
                    owners.add(owner_name)
            for owner_name in owners:
                sub = mod.get_submodule(owner_name) if owner_name else mod
                sub.__class__ = _gathering_class(type(sub))
            if tpg is not None:
                _mark_tp(mod, tpg, head)
    return specs


def _cut(module, *names) -> list:
    """Which of a module's named sub-module weights are model-sharded."""
    out = []
    for n in names:
        sub = getattr(module, n, None)
        w = None if sub is None else sub._parameters.get("weight")
        out.append(w is not None and info(w) is not None
                   and info(w).tp is not None)
    return out


def _mark_tp(module, tpg: TPGroup, where: str) -> None:
    """Set the TP markers of every block whose weights the specs cut,
    refusing a half-cut block (its forward would mix layouts)."""
    from sdbc_tpu_torch.models import clip as clip_mod
    from sdbc_tpu_torch.models import unet as unet_mod

    def whole(flags, what):
        if any(flags) and not all(flags):
            raise ValueError(f"{where}: {what} is only partly "
                             "model-sharded; the TP rules cut it whole")
        return all(flags)

    for name, m in module.named_modules():
        label = where + ("." + name if name else "")
        if isinstance(m, (unet_mod.MHA, clip_mod._Attn)):
            if whole(_cut(m, "q", "k", "v", "o"), label):
                m.tp = tpg
        elif isinstance(m, unet_mod.ResBlock):
            if whole(_cut(m, "conv1", "temb", "norm2", "conv2"), label):
                m.tp = tpg
        elif isinstance(m, clip_mod._MLP):
            if whole(_cut(m, "fc1", "fc2"), label):
                m.tp = tpg
        if hasattr(m, "geglu"):
            if whole(_cut(m, "geglu", "ff_out"), label):
                m.ff_tp = tpg
        if isinstance(m, unet_mod.Transformer) and _cut(m, "proj_out")[0]:
            m.proj_tp = tpg


def full_tensor(t: torch.Tensor, dst: Optional[int] = 0
                ) -> Optional[torch.Tensor]:
    """The full value of a (possibly) sharded tensor: every rank takes
    part; with ``dst`` a global rank, only that rank gets it (None
    elsewhere), with ``dst=None`` every rank does.  One tensor at a time,
    so no rank holds a second full copy of a model."""
    import torch.distributed as dist

    i = info(t)
    if i is None:
        return t.detach() if dst is None or dist.get_rank() == dst else None
    x = t.detach()
    if i.fsdp is not None:
        f = i.fsdp
        if f.owner is None:
            x = comm.all_gather(x, f.group, f.dim)
        else:
            full = x.clone() if comm.rank(f.group) == f.owner \
                else x.new_empty(f.shape)
            x = comm.broadcast_(full, f.group, f.owner)
    if i.tp is not None:
        x = comm.all_gather(x, i.tp.group, i.tp_dim)
    if dst is not None and dist.get_rank() != dst:
        return None
    return x


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``full`` as ``like`` (a sharded tensor) holds
    it: for a resume, every rank reads the full tree and keeps its
    shard."""
    i = info(like)
    if i is None:
        return full
    t = full
    if i.tp is not None:
        t = t.chunk(i.tp.size, dim=i.tp_dim)[i.tp.rank]
    if i.fsdp is not None:
        f = i.fsdp
        if f.owner is None:
            t = t.chunk(comm.size(f.group), dim=f.dim)[comm.rank(f.group)]
        elif comm.rank(f.group) != f.owner:
            t = t.new_empty((0,))
    return t


def gathered_copies(models: dict, dst: int = 0) -> Optional[dict]:
    """Full copies of sharded ``{component: module}`` on global rank
    ``dst`` (None on the others), gathered leaf by leaf: for a final grid
    rendered by one rank.  The copies are plain modules again."""
    import copy

    import torch.distributed as dist

    mine = dist.get_rank() == dst
    out = {}
    for comp, value in models.items():
        mods = value if isinstance(value, (list, tuple)) else [value]
        copies = []
        for mod in mods:
            full = {name: full_tensor(p, dst)
                    for name, p in mod.named_parameters()}
            if not mine:
                continue
            c = copy.deepcopy(mod)
            for sub in c.modules():
                base = getattr(type(sub), "_fsdp_base", None)
                if base is not None:
                    sub.__class__ = base
                for attr in ("tp", "ff_tp", "proj_tp"):
                    sub.__dict__.pop(attr, None)
            for name, p in c.named_parameters():
                p.data = full[name].clone()
                p.__dict__.pop("_sdbc_shard", None)
            copies.append(c)
        if mine:
            out[comp] = copies if isinstance(value, (list, tuple)) \
                else copies[0]
    return out if mine else None
