"""Checkpoint save/load (counterpart of ``sdbc_tpu/utils/checkpoint.py``)
in the JAX package's on-disk layout, one tree per component:

    <dir>/unet/ <dir>/vae/ <dir>/text_encoder/   (params)
    <dir>/text_encoder_2/                         (SDXL's second encoder)
    <dir>/controlnet/                             (a ControlNet branch, or
                                                   a list of branches)
    <dir>/opt_state/                              (optional optimizer state)
    <dir>/ema/                                    (optional EMA shadow)
    <dir>/lora.npz, <dir>/ti.npz + added_tokens.json  (adapters)
    <dir>/metadata.json                           (step, best loss, ...)
    <dir>/config.json                             (written last)

Each tree is what orbax's ``StandardCheckpointer`` restores: a
``_METADATA`` file naming every leaf by its key path (dict keys and list
indices) and, per leaf, a zarr-v2 array named by the path joined with
``.``.  The port writes a tree without OCDBT (``"use_ocdbt": false,
"use_zarr3": false``): per leaf a directory holding its ``.zarray``
(``"compressor": null``) and one raw chunk ``0.0…``.  Leaves are named by
the JAX tree (``models/convert.py`` ``jax_tree_leaves``) and keep their
dtypes: under bf16 a full fine-tune's frozen components are the
compute-dtype copies, as the JAX package saves them.  ``opt_state/`` is the
JAX optax tree (``apply_if_finite`` over the optional clip and AdamW or the
8-bit AdamW), so the JAX package's ``load_pipeline`` and
``load_opt_state(path, opt.init(...))`` restore what the port saves.

The readers also take what the JAX package's ``save_pipeline`` writes:
OCDBT trees (``"use_ocdbt": true``, ``utils/ocdbt.py``) whose chunks are
zstd frames (``utils/zstd.py``, the port's own decoder), one chunk a shard
for a leaf saved under a mesh (``utils/zarr.py``).  A zarr3 tree is
refused; the JAX package writes zarr v2.

``config.json`` is written last: it marks a complete checkpoint, and
``latest_checkpoint`` skips a directory without it (a save cut by a kill).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from sdbc_tpu_torch.diffusion.graph import (COMPONENT_INITS,
                                            PipelineConfig, model_configs)
from sdbc_tpu_torch.diffusion.schedulers import ScheduleConfig
from sdbc_tpu_torch.models.clip import CLIPTextConfig
from sdbc_tpu_torch.models.controlnet import ControlNetConfig
from sdbc_tpu_torch.models.convert import stacked
from sdbc_tpu_torch.models.unet import UNetConfig
from sdbc_tpu_torch.models.vae import VAEConfig
from sdbc_tpu_torch.utils import zarr
from sdbc_tpu_torch.utils.ocdbt import OcdbtStore

# "controlnet" only in a ControlNet run's checkpoints: save and load skip
# an absent component
COMPONENTS = ("text_encoder", "text_encoder_2", "unet", "vae", "controlnet")

# a key path: ((key, is_list_index), ...)
Key = Tuple[Tuple[str, bool], ...]

_ZARR_DTYPE = {torch.float32: "<f4", torch.float16: "<f2",
               torch.bfloat16: "bfloat16", torch.int8: "|i1",
               torch.int32: "<i4", torch.int64: "<i8", torch.bool: "|b1",
               torch.uint8: "|u1"}
# the value types of orbax's leaves that hold an array
_LEAF_TYPES = ("jax.Array", "np.ndarray", "scalar")

# ---------------------------------------------------------------------------
# one tree on disk


def _leaf_dir(key: Key) -> str:
    return ".".join(k for k, _ in key)


# a leaf that is an empty container: an empty optax state (EmptyState) or
# an empty list of the parameter tree (a UNet block without attention)
EMPTY_STATE, EMPTY_LIST = "None", "List"


class Stacked(list):
    """A stacked tower's leaf as its layers' tensors, stacked when
    written (after any gather: ``write_tree``)."""


def _root() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    from sdbc_tpu_torch.parallel import comm

    comm.barrier()


def _full(t):
    """A leaf's full value on rank 0 (None on the others): a sharded
    tensor (``parallel.shard``) gathered, one leaf at a time, every rank
    taking part; a ``Stacked`` leaf's layers gathered, then stacked."""
    import torch.distributed as dist

    if isinstance(t, Stacked):
        parts = [_full(x) for x in t]
        return None if parts[0] is None else torch.stack(parts)
    if not dist.is_initialized():
        return t.detach()
    from sdbc_tpu_torch.parallel.shard import full_tensor

    return full_tensor(t, dst=0)


def write_tree(path: str, leaves: list) -> int:
    """Write ``leaves`` ((key path, tensor, ``Stacked`` or
    ``EMPTY_STATE`` / ``EMPTY_LIST``), in the JAX flatten order) as one
    tree under ``path``.  Returns the bytes written.  Under
    ``torch.distributed`` every rank calls it alike: sharded leaves are
    gathered to rank 0 one at a time, and rank 0 alone writes."""
    root = _root()
    if root:
        os.makedirs(path, exist_ok=True)
    meta, total = {}, 0
    for key, t in leaves:
        km = [{"key": k, "key_type": 1 if seq else 2} for k, seq in key]
        name = str(tuple(k for k, _ in key))
        if isinstance(t, str):
            meta[name] = {"key_metadata": km, "value_metadata": {
                "value_type": t, "skip_deserialize": True}}
            continue
        t = _full(t)
        if not root:
            continue
        if t.dtype not in _ZARR_DTYPE:
            raise TypeError(f"{_leaf_dir(key)}: no zarr dtype for {t.dtype}")
        shape = list(t.shape)
        meta[name] = {"key_metadata": km, "value_metadata": {
            "value_type": "jax.Array", "skip_deserialize": False,
            "write_shape": shape}}
        d = os.path.join(path, _leaf_dir(key))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, ".zarray"), "w") as f:
            json.dump({"chunks": shape, "compressor": None,
                       "dimension_separator": ".",
                       "dtype": _ZARR_DTYPE[t.dtype], "fill_value": None,
                       "filters": None, "order": "C", "shape": shape,
                       "zarr_format": 2}, f)
        host = t.contiguous().cpu()
        if host.dtype == torch.bfloat16:
            host = host.view(torch.int16)
        host.numpy().tofile(os.path.join(d, ".".join("0" * len(shape))
                                         or "0"))
        total += host.numel() * host.element_size()
    if not root:
        return 0
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": meta, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    return total


def read_tree(path: str) -> Dict[Key, torch.Tensor]:
    """{key path: tensor} of a tree orbax's ``StandardCheckpointer`` wrote:
    by the JAX package (OCDBT, zstd chunks) or by ``write_tree`` (a
    directory a leaf).  Empty states are left out; each tensor is in its
    saved dtype on the host (a scalar leaf 0-d)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise zarr.ZarrError(f"{path}: a zarr3 tree (\"use_zarr3\": true); "
                             "sdbc_tpu_torch reads zarr v2, which the JAX "
                             "package writes")
    names = {}
    for entry in meta["tree_metadata"].values():
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            continue
        key = tuple((k["key"], k["key_type"] == 1)
                    for k in entry["key_metadata"])
        if value.get("value_type") not in _LEAF_TYPES:
            raise ValueError(f"{path}: leaf {_leaf_dir(key)} has value_type "
                             f"{value.get('value_type')!r}, not one of "
                             f"{_LEAF_TYPES}")
        names[key] = _leaf_dir(key)
    store = (OcdbtStore(path) if meta.get("use_ocdbt")
             else zarr.DirStore(path))
    arrays = zarr.read_arrays(store, list(names.values()))
    return {key: arrays[name] for key, name in names.items()}


def nest(flat: Dict[Key, torch.Tensor]) -> dict:
    """Nested dicts of a flat {key path: tensor} tree, list indices as
    string keys (``models.convert.load_jax_params`` reads them as it reads
    lists)."""
    root: dict = {}
    for key, t in flat.items():
        node = root
        for k, _ in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1][0]] = t
    return root


# ---------------------------------------------------------------------------
# components


def module_tree(module: torch.nn.Module, lazy: bool = False) -> list:
    """[(key path, tensor or EMPTY_LIST)] of a component, in the JAX
    flatten order: its parameters (``jax_tree_leaves``) and the empty
    lists of its tree (an empty ``ModuleList``); ``lazy`` leaves a
    stacked leaf ``Stacked`` for ``write_tree`` to gather and stack."""
    from sdbc_tpu_torch.models.convert import jax_tree_parts, stacked

    empty = [(tuple((k, k.isdigit()) for k in name.split(".")), EMPTY_LIST)
             for name, m in module.named_modules()
             if isinstance(m, torch.nn.ModuleList) and len(m) == 0]
    # lazy: the parameters themselves (their shard marks are read when
    # written), not detached copies
    leaves = [(k, (Stacked(ts) if lazy else torch.stack(
                   [t.detach() for t in ts]))
               if len(ts) > 1 or stacked(k) else
               (ts[0] if lazy else ts[0].detach()))
              for k, ts in jax_tree_parts(module)]
    return sorted(leaves + empty, key=lambda kv: sort_key(kv[0]))


def sort_key(key: Key) -> tuple:
    """The JAX flatten order of key paths: dict keys sorted, list indices
    in order."""
    return tuple((0, int(k), "") if seq else (1, 0, k) for k, seq in key)


def component_tree(value, lazy: bool = False) -> list:
    """``module_tree`` of a component: a module, or a list of ControlNet
    branches (each one's leaves under its list index)."""
    if isinstance(value, (list, tuple)):
        return [(((str(i), True),) + k, t) for i, m in enumerate(value)
                for k, t in module_tree(m, lazy)]
    return module_tree(value, lazy)


def load_component(flat: Dict[Key, torch.Tensor], name: str,
                   cfg: PipelineConfig, device="cpu"):
    """The module of component ``name`` from its tree, in the tree's dtype
    (fp32 when its leaves disagree); a "controlnet" tree saved as a list
    gives a list of branches."""
    from sdbc_tpu_torch.models import controlnet as controlnet_mod
    from sdbc_tpu_torch.models.convert import load_jax_params

    if name == "controlnet":
        if cfg.controlnet is None:
            raise ValueError("a controlnet/ tree needs the config's "
                             "'controlnet' entry")
        if all(key[0][1] for key in flat):   # a list of branches
            parts: Dict[str, dict] = {}
            for key, t in flat.items():
                parts.setdefault(key[0][0], {})[key[1:]] = t
            return [load_component(parts[str(i)], name, cfg, device)
                    for i in range(len(parts))]
        init, sub = controlnet_mod.init, cfg.controlnet
    else:
        init, sub = COMPONENT_INITS[name], model_configs(cfg)[name]
    dtypes = {t.dtype for t in flat.values()}
    dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
    module = init(sub, device=device, dtype=dtype)
    return load_jax_params(module, nest(flat)).requires_grad_(False)


def save_pipeline(path: str, models: dict, cfg: PipelineConfig,
                  opt_state: Optional[list] = None,
                  metadata: Optional[dict] = None,
                  lora: Optional[dict] = None, lora_rank: int = 0,
                  lora_alpha: float = 0.0,
                  ema: Optional[dict] = None,
                  ti: Optional[tuple] = None) -> int:
    """Save ``models`` ({component: module}; "controlnet" may be a list
    of branches) in their dtypes; returns the bytes of the trees written.

    ``opt_state``: the optimizer state as ``opt_state_tree`` gives it.
    ``lora``: an adapter dict (``train/lora.py``), stored as ``lora.npz``
    beside the untouched base.  ``ema``: {component: module}, the EMA
    shadow of the trained components.  ``ti``: (rows, token, ids) or, for
    an SDXL embedding, (rows, token, ids, rows2), stored as ``ti.npz`` and
    ``added_tokens.json``.

    Under ``torch.distributed`` every rank calls it alike: sharded leaves
    are gathered to rank 0 one leaf at a time and rank 0 writes; the
    others wait at a barrier, and ``config.json`` is written after
    everyone's data."""
    path = os.path.abspath(path)
    root = _root()
    if root:
        os.makedirs(path, exist_ok=True)
    total = 0
    for comp in COMPONENTS:
        if comp in models:
            total += write_tree(os.path.join(path, comp),
                                component_tree(models[comp], lazy=True))
    if opt_state is not None:
        total += write_tree(os.path.join(path, "opt_state"), opt_state)
    if ema is not None:
        bad = set(ema) - set(COMPONENTS)
        if bad:
            raise ValueError(f"ema tree may only hold component subtrees "
                             f"{COMPONENTS}, got extra keys {sorted(bad)}")
        leaves = [(((comp, False),) + k, t) for comp in sorted(ema)
                  for k, t in module_tree(ema[comp], lazy=True)]
        total += write_tree(os.path.join(path, "ema"), leaves)
    if not root:
        _barrier()   # rank 0's adapters and metadata
        _barrier()
        return total
    if lora is not None:
        from sdbc_tpu_torch.train import lora as lora_mod

        lora_mod.save_lora(os.path.join(path, "lora.npz"), lora, lora_rank,
                           lora_alpha)
    if ti is not None:
        from sdbc_tpu_torch.train import textual_inversion as ti_mod

        rows, token, ids = ti[:3]
        ti_mod.save_ti(os.path.join(path, "ti.npz"), rows, token, ids,
                       rows2=ti[3] if len(ti) > 3 else None)
        with open(os.path.join(path, "added_tokens.json"), "w") as f:
            json.dump({token: list(map(int, ids))}, f, indent=2)
    _barrier()
    save_metadata(path, metadata, cfg)
    _barrier()
    return total


def save_metadata(path: str, metadata: Optional[dict],
                  cfg: PipelineConfig) -> None:
    """``metadata.json``, then ``config.json``: the completeness marker
    comes last.  Alone, it rewrites the metadata of a checkpoint whose
    trees hold the current state already.  Rank 0 alone writes."""
    if not _root():
        return
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(metadata or {}, f, indent=2, default=float)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_json(cfg), f, indent=2)


def load_pipeline(path: str, device="cpu", merge_lora: bool = True,
                  use_ema: bool = True, merge_ti: bool = True):
    """→ (models, cfg): the components in their saved dtypes on
    ``device``; the ``ema/`` shadow overlaid (``use_ema``), then
    ``lora.npz`` merged (``merge_lora``) and ``ti.npz`` merged with the
    config's vocab counting its rows (``merge_ti``), as the JAX package
    loads.  The optimizer state goes into a train state through
    ``load_opt_state``."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_json(json.load(f))
    models = {}
    for comp in COMPONENTS:
        cpath = os.path.join(path, comp)
        if os.path.exists(cpath):
            # read on the host, copied once into the module on ``device``
            models[comp] = load_component(read_tree(cpath), comp, cfg,
                                          device)
    if use_ema and os.path.exists(os.path.join(path, "ema")):
        models.update(load_ema(path, device=device, cfg=cfg))
    lpath = os.path.join(path, "lora.npz")
    if merge_lora and os.path.exists(lpath):
        from sdbc_tpu_torch.train import lora as lora_mod

        models = lora_mod.merge_file(models, lpath)
    tpath = os.path.join(path, "ti.npz")
    if merge_ti and os.path.exists(tpath):
        from sdbc_tpu_torch.train import textual_inversion as ti_mod

        models, meta = ti_mod.merge_file(models, tpath)
        cfg = ti_mod.extend_config(cfg, meta)
    return models, cfg


def load_ema(path: str, template: Optional[dict] = None, device="cpu",
             cfg: Optional[PipelineConfig] = None):
    """The ``ema/`` shadow, or None without one: copied into ``template``
    ({component: module}, returned) when given, else new modules (``cfg``:
    the checkpoint's, read from its config.json when not given)."""
    from sdbc_tpu_torch.models.convert import load_jax_params

    epath = os.path.join(os.path.abspath(path), "ema")
    if not os.path.exists(epath):
        return None
    flat = read_tree(epath)
    parts: Dict[str, dict] = {}
    for key, t in flat.items():
        parts.setdefault(key[0][0], {})[key[1:]] = t
    if template is not None:
        with torch.no_grad():
            for comp, sub in parts.items():
                load_jax_params(template[comp], nest(sub))
        return template
    if cfg is None:
        with open(os.path.join(os.path.abspath(path), "config.json")) as f:
            cfg = config_from_json(json.load(f))
    return {comp: load_component(sub, comp, cfg, device)
            for comp, sub in parts.items()}


def load_metadata(path: str) -> dict:
    mpath = os.path.join(path, "metadata.json")
    if not os.path.exists(mpath):
        return {}
    with open(mpath) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# optimizer state in the JAX optax layout


def _k(*names) -> Key:
    return tuple((str(n), isinstance(n, int)) for n in names)


def _adam_prefix(max_grad_norm: float):
    """(leaves before the AdamW state, its key prefix): ``apply_if_finite``
    over ``chain([clip_by_global_norm,] adamw)``, the clip's state empty."""
    if max_grad_norm > 0:
        return [(_k("inner_state", 0), EMPTY_STATE)], _k("inner_state", 1)
    return [], _k("inner_state", 0)


def opt_state_tree(opt_state, trainable: dict, max_grad_norm: float,
                   lazy: bool = False) -> list:
    """The port's ``trainer.OptState`` as the JAX optax tree's leaves, in
    its flatten order: the 8-bit moments per leaf in the JAX tree's leaf
    order, each (rows,) scale broadcast to the JAX (rows, 128); the fp32
    moments (``optax.adamw``: scale_by_adam, add_decayed_weights,
    scale_by_learning_rate) as trees of the trainable parameters."""
    from sdbc_tpu_torch.train import adam8bit
    from sdbc_tpu_torch.train.trainer import optimizer_leaf_keys

    keys = optimizer_leaf_keys(trainable)
    order = sorted(range(len(keys)), key=lambda i: sort_key(keys[i]))
    i32 = lambda x: torch.tensor(int(x), dtype=torch.int32)
    out = [(_k("notfinite_count"), i32(opt_state.notfinite_count)),
           (_k("last_finite"), torch.tensor(bool(opt_state.last_finite))),
           (_k("total_notfinite"), i32(opt_state.total_notfinite))]
    head, pre = _adam_prefix(max_grad_norm)
    out += head
    inner = opt_state.inner
    if isinstance(inner, adam8bit.Adam8State):
        out.append((pre + _k("count"), i32(inner.count)))
        one = _one_layer_towers(trainable, keys)
        for j, i in enumerate(order):
            st, lp = inner.per_leaf[i], pre + _k("per_leaf", j)
            if isinstance(st, adam8bit.Quant8State):
                wide = lambda s: s[:, None].expand(s.shape[0], 128)
                out += [(lp + _k("mq"), st.mq), (lp + _k("ms"), wide(st.ms)),
                        (lp + _k("vq"), st.vq), (lp + _k("vs"), wide(st.vs))]
            else:
                lift = (lambda t: t[None]) if one[i] else (lambda t: t)
                out += [(lp + _k("m"), lift(st.m)),
                        (lp + _k("v"), lift(st.v))]
        return out
    sl = _part_slices(trainable)
    out.append((pre + _k(0, "count"), i32(inner.count)))
    for name, moments in (("mu", inner.mu), ("nu", inner.nu)):
        tree = [(keys[i], _leaf_value(moments[sl[i]], keys[i], lazy))
                for i in order]
        tree += [(((c, False),) + k, t) for c, m in trainable.items()
                 if isinstance(m, torch.nn.Module)
                 for k, t in module_tree(m, lazy=True) if isinstance(t, str)]
        out += [(pre + _k(0, name) + k, t)
                for k, t in sorted(tree, key=lambda kv: sort_key(kv[0]))]
    out += [(pre + _k(1), EMPTY_STATE),
            (pre + _k(2, "count"), i32(inner.count))]
    return out


def _one_layer_towers(trainable: dict, keys: list) -> List[bool]:
    """Per optimizer leaf: a stacked tower's leaf of one layer, whose fp32
    moments the 8-bit optimizer keeps as the layer's shape and the JAX
    tree stacked, with a leading axis of 1."""
    from sdbc_tpu_torch.train.trainer import optimizer_leaves

    return [len(parts) == 1 and stacked(key)
            for parts, key in zip(optimizer_leaves(trainable), keys)]


def _part_slices(trainable: dict) -> list:
    from sdbc_tpu_torch.train.adam8bit import leaf_parts
    from sdbc_tpu_torch.train.trainer import optimizer_leaves

    out, at = [], 0
    for leaf in optimizer_leaves(trainable):
        n = len(leaf_parts(leaf))
        out.append(slice(at, at + n))
        at += n
    return out


def _leaf_value(parts: list, key: Key, lazy: bool = False):
    """One JAX leaf from its parts: a stacked tower's layers stacked
    (``lazy``: when written)."""
    if not stacked(key):
        return parts[0]
    return Stacked(parts) if lazy else torch.stack(parts)


@torch.no_grad()
def load_opt_state(path: str, template, trainable: dict,
                   max_grad_norm: float):
    """Fill ``template`` (a ``trainer.OptState`` of the same trainable
    leaves, e.g. a fresh state's) from ``<path>/opt_state`` bit for bit
    and return it; None when the checkpoint has no optimizer state."""
    from sdbc_tpu_torch.train import adam8bit
    from sdbc_tpu_torch.train.trainer import optimizer_leaf_keys

    opath = os.path.join(os.path.abspath(path), "opt_state")
    if not os.path.exists(opath):
        return None
    flat = {tuple(k for k, _ in key): t for key, t in read_tree(opath).items()}
    plain = lambda key: tuple(k for k, _ in key)

    def get(key):
        name = plain(key)
        if name not in flat:
            raise KeyError(f"{opath}: no leaf {'.'.join(name)} (saved with "
                           "another optimizer or trainable set?)")
        return flat[name]

    def fill(dst, src):
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"{opath}: shape {tuple(src.shape)} vs the "
                             f"state's {tuple(dst.shape)}")
        dst.copy_(src.to(dst.dtype))

    keys = optimizer_leaf_keys(trainable)
    order = sorted(range(len(keys)), key=lambda i: sort_key(keys[i]))
    template.notfinite_count = int(get(_k("notfinite_count")))
    template.last_finite = bool(get(_k("last_finite")))
    template.total_notfinite = int(get(_k("total_notfinite")))
    _, pre = _adam_prefix(max_grad_norm)
    inner = template.inner
    if isinstance(inner, adam8bit.Adam8State):
        inner.count = int(get(pre + _k("count")))
        one = _one_layer_towers(trainable, keys)

        def drop(src, dst):
            # (1, …) as the JAX tree stacks it; the layer's own shape as
            # the port's checkpoints of earlier versions hold it
            return src[0] if tuple(src.shape) == (1,) + tuple(dst.shape) \
                else src

        for j, i in enumerate(order):
            st, lp = inner.per_leaf[i], pre + _k("per_leaf", j)
            if isinstance(st, adam8bit.Quant8State):
                fill(st.mq, get(lp + _k("mq")))
                fill(st.ms, get(lp + _k("ms"))[:, 0])
                fill(st.vq, get(lp + _k("vq")))
                fill(st.vs, get(lp + _k("vs"))[:, 0])
            else:
                for name, dst in (("m", st.m), ("v", st.v)):
                    src = get(lp + _k(name))
                    fill(dst, drop(src, dst) if one[i] else src)
        return template
    inner.count = int(get(pre + _k(0, "count")))
    sl = _part_slices(trainable)
    for name, moments in (("mu", inner.mu), ("nu", inner.nu)):
        for i, key in enumerate(keys):
            src = get(pre + _k(0, name) + key)
            parts = moments[sl[i]]
            if not stacked(key):
                fill(parts[0], src)
            else:
                for dst, s in zip(parts, src):
                    fill(dst, s)
    return template


# ---------------------------------------------------------------------------
# config (de)serialisation


def config_to_json(cfg: PipelineConfig) -> dict:
    """The JAX package's config.json of ``cfg`` (per-level heads and depths
    as lists; the ControlNet ramp, SDXL's ``clip2`` and the refiner flag
    when set)."""
    out = {"clip": dataclasses.asdict(cfg.clip),
           "unet": dataclasses.asdict(cfg.unet),
           "vae": dataclasses.asdict(cfg.vae),
           "schedule": dataclasses.asdict(cfg.schedule),
           "scheduler": cfg.scheduler}
    if cfg.controlnet is not None:
        # the branch's encoder layout is the base UNet's: only the ramp
        out["controlnet"] = {"conditioning_channels":
                             list(cfg.controlnet.conditioning_channels)}
    if cfg.clip2 is not None:
        out["clip2"] = dataclasses.asdict(cfg.clip2)
    if cfg.refiner:
        out["refiner"] = True
    return out


def config_from_json(d: dict) -> PipelineConfig:
    def tup(x):
        return tuple(x) if isinstance(x, list) else x

    unet_cfg = UNetConfig(**{k: tup(v) for k, v in d["unet"].items()})
    controlnet = None
    if "controlnet" in d:
        controlnet = ControlNetConfig(
            unet=unet_cfg, conditioning_channels=tup(
                d["controlnet"]["conditioning_channels"]))
    return PipelineConfig(
        clip=CLIPTextConfig(**d["clip"]),
        unet=unet_cfg,
        vae=VAEConfig(**{k: tup(v) for k, v in d["vae"].items()}),
        schedule=ScheduleConfig(**d["schedule"]),
        scheduler=d.get("scheduler", "ddim"),
        clip2=CLIPTextConfig(**d["clip2"]) if d.get("clip2") else None,
        refiner=bool(d.get("refiner", False)), controlnet=controlnet)


# ---------------------------------------------------------------------------
# versioned runs


def run_dir(output_dir: str, run_id: str) -> str:
    return os.path.join(output_dir, "runs", run_id)


def latest_checkpoint(output_dir: str, run_id: str) -> Optional[str]:
    """Newest COMPLETE checkpoint: one with a config.json (written last by
    ``save_pipeline``), so a save cut by a kill is skipped."""
    base = run_dir(output_dir, run_id)
    if not os.path.isdir(base):
        return None
    cands = [d for d in os.listdir(base)
             if d.startswith("ckpt-")
             and os.path.exists(os.path.join(base, d, "config.json"))]
    if not cands:
        return None
    latest = max(cands, key=lambda d: int(d.split("-")[1]))
    return os.path.join(base, latest)


def new_checkpoint_path(output_dir: str, run_id: str, step: int) -> str:
    return os.path.join(run_dir(output_dir, run_id), f"ckpt-{step}")
