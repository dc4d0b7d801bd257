"""Weights from the JAX package's parameter trees into the port's modules.

The caller hands over the JAX tree as nested dicts/lists of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.  Mapping:

- tree path → module path: dict keys and list indices joined by ``.``;
- leaf names: ``w``/``scale``/``table`` → ``weight``, ``b``/``bias`` → ``bias``;
  any other leaf keeps its name: the Inception extractor's batch-norm
  leaves ``beta``/``mean``/``var``/``gamma`` (``models/inception.py``), the
  bare arrays of the CLIP vision tower (``class_embedding``) and of the
  safety head (``concept_embeds``, ``concept_weights``,
  ``special_care_embeds``, ``special_care_weights``, ``models/safety.py``);
- conv kernels stay HWIO and linear weights (in, out);
- a stacked ``layers`` tree (a dict, one leading layer axis per leaf: the
  CLIP text and vision towers, wherever they sit in the tree) is split
  into ``layers.<i>.…``, and so is a stacked ``blocks`` tree (the blocks
  of a depth > 1 UNet transformer, one leading depth axis) into
  ``blocks.<k>.…``; a ``blocks`` list (the ControlNet conditioning
  embedder's convs, ``blocks.<k>.weight``) is a list like any other.

Raises on any leaf without a parameter or buffer, any parameter or buffer
left unset, and any shape that disagrees.

``jax_tree_leaves`` is the inverse: a module's parameters as the JAX
tree's (key path, tensor) leaves, the leaf name from the module that owns
the parameter (``Linear``/``Conv2d`` → ``w``/``b``, ``GroupNorm``/
``LayerNorm`` → ``scale``/``bias``, ``Embedding`` → ``table``) and a
tower's ``layers.<i>.…`` (a transformer's ``blocks.<k>.…``) stacked
again.  Every numeric key of these trees
is a list index.

``load_adam8_state`` carries an 8-bit AdamW state across the same way.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_LEAF = {"w": "weight", "scale": "weight", "table": "weight",
         "b": "bias", "bias": "bias"}
# the trees stacked along a leading axis: CLIP's layers, a deep
# transformer's blocks
STACKED = ("layers", "blocks")
# a stacked tree's index in a parameter name: one followed by a submodule
# and a leaf (``layers.3.attn.q.weight``), not by a leaf alone (the
# embedder's ``cond_embedding.blocks.0.weight``, a plain list)
STACKED_INDEX = re.compile(r"(^|\.)(layers|blocks)\.\d+\.(?=[^.]+\.)")


def _flatten(node, prefix, out):
    if isinstance(node, dict):
        for k, v in node.items():
            # a list read back as a dict of indices is no stacked tree
            if k in STACKED and isinstance(v, dict) \
                    and not all(str(i).isdigit() for i in v):
                stacked = {}
                _flatten(v, [], stacked)
                for name, arr in stacked.items():
                    for i in range(arr.shape[0]):
                        out[".".join(prefix + [k, str(i), name])] = arr[i]
            else:
                _flatten(v, prefix + [str(k)], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, prefix + [str(i)], out)
    else:
        out[".".join(prefix[:-1] + [_LEAF.get(prefix[-1], prefix[-1])])] = \
            node if torch.is_tensor(node) else np.asarray(node)


def _flatten_jax_tree(module: torch.nn.Module, tree) -> dict:
    """Port parameter name → numpy array, per the mapping above."""
    flat = {}
    _flatten(tree, [], flat)
    return flat


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``module`` in place; returns it."""
    flat = _flatten_jax_tree(module, tree)
    params = {**dict(module.named_buffers()),
              **dict(module.named_parameters())}
    extra = sorted(set(flat) - set(params))
    if extra:
        raise KeyError(f"{len(extra)} JAX leaves have no parameter in "
                       f"{type(module).__name__}: {extra[:8]}")
    missing = sorted(set(params) - set(flat))
    if missing:
        raise KeyError(f"{len(missing)} parameters of {type(module).__name__} "
                       f"left unset: {missing[:8]}")
    for name, arr in flat.items():
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {arr.shape} vs port "
                             f"{tuple(p.shape)}")
        src = arr if torch.is_tensor(arr) else torch.from_numpy(np.array(arr))
        p.copy_(src.to(p.dtype))
    return module


def _jax_names(module: torch.nn.Module) -> dict:
    """Parameter leaf name → JAX leaf name, by the owning module's class."""
    from sdbc_tpu_torch.ops import nn

    names = {}
    for cls, leaves in ((nn.Linear, ("w", "b")), (nn.Conv2d, ("w", "b")),
                        (nn.GroupNorm, ("scale", "bias")),
                        (nn.LayerNorm, ("scale", "bias")),
                        (nn.Embedding, ("table", None))):
        if isinstance(module, cls):
            names["weight"] = leaves[0]
            if leaves[1]:
                names["bias"] = leaves[1]
    return names


_LAYER = re.compile(r"^(.*?)\b(layers|blocks)\.(\d+)\.([^.]+\..*)$")


def jax_key(module: torch.nn.Module, name: str) -> tuple:
    """The JAX key path of parameter ``name`` of ``module``, as
    ((key, is_list_index), ...), with a stacked tower's layer index (a
    deep transformer's block index) left out (``layers.3.attn.q.weight`` →
    layers/attn/q/w)."""
    owner, _, leaf = name.rpartition(".")
    leaf = _jax_names(module.get_submodule(owner) if owner else module) \
        .get(leaf, leaf)
    path = (owner + "." if owner else "") + leaf
    m = _LAYER.match(path)
    if m:
        path = f"{m.group(1)}{m.group(2)}.{m.group(4)}"
    return tuple((k, k.isdigit()) for k in path.split("."))


def jax_tree_parts(module: torch.nn.Module) -> list:
    """[(JAX key path, [tensors])] of every parameter and buffer of
    ``module``, in the module's order: a stacked tower's layers listed
    under their one key, any other leaf alone (the tensors themselves,
    not detached)."""
    stacks: dict = {}
    order = []
    tensors = {**dict(module.named_buffers()),
               **dict(module.named_parameters())}
    for name, t in tensors.items():
        key = jax_key(module, name)
        if key not in stacks:
            stacks[key] = []
            order.append(key)
        stacks[key].append(t)
    return [(k, stacks[k]) for k in order]


def jax_tree_leaves(module: torch.nn.Module) -> list:
    """[(JAX key path, tensor)] of every parameter and buffer of
    ``module``, in the module's order; a stacked tower's layers become one
    (L, ...) tensor per name (a copy), the others are the parameters
    themselves (detached)."""
    return [(k, ts[0].detach() if len(ts) == 1 and not stacked(k)
             else torch.stack([t.detach() for t in ts]))
            for k, ts in jax_tree_parts(module)]


def stacked(key: tuple) -> bool:
    """Whether a JAX key path lies in a stacked tree (``STACKED``, not
    followed by a list index)."""
    return any(k in STACKED and not nxt[1]
               for (k, _), nxt in zip(key, key[1:]))


def load_adam8_state(jax_state, device="cpu"):
    """The port's ``train.adam8bit.Adam8State`` from the JAX package's
    ``Adam8State`` (as numpy: ``jax.tree.map(np.asarray, state)``).

    ``count`` is kept; per leaf, in the JAX order, a ``Quant8State`` keeps
    its int8 (rows, 2048) moments and drops the 128-lane broadcast of its
    scales to (rows,), and ``FP32Moments`` are copied.  The port's leaves
    (``trainer.optimizer_leaves``) stack the CLIP layers as the JAX tree
    does, but list them in module order: the caller orders its leaves as
    the JAX tree flattens them."""
    from sdbc_tpu_torch.train import adam8bit

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device, dtype)

    per_leaf = []
    for leaf in jax_state.per_leaf:
        if hasattr(leaf, "mq"):
            per_leaf.append(adam8bit.Quant8State(
                mq=t(leaf.mq, torch.int8), ms=t(np.asarray(leaf.ms)[:, 0],
                                                torch.float32),
                vq=t(leaf.vq, torch.int8), vs=t(np.asarray(leaf.vs)[:, 0],
                                                torch.float32)))
        else:
            per_leaf.append(adam8bit.FP32Moments(
                m=t(leaf.m, torch.float32), v=t(leaf.v, torch.float32)))
    return adam8bit.Adam8State(count=int(np.asarray(jax_state.count)),
                               per_leaf=per_leaf)
