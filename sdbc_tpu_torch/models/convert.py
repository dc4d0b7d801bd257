"""Weights from the JAX package's parameter trees into the port's modules.

The caller hands over the JAX tree as nested dicts/lists of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.  Mapping:

- tree path → module path: dict keys and list indices joined by ``.``;
- leaf names: ``w``/``scale``/``table`` → ``weight``, ``b``/``bias`` → ``bias``;
  the Inception extractor's batch-norm leaves ``beta``/``mean``/``var``/
  ``gamma`` keep their names (``models/inception.py``);
- conv kernels stay HWIO and linear weights (in, out);
- CLIP's stacked ``layers`` tree (one leading layer axis per leaf) is split
  into ``layers.<i>.…``.

Raises on any leaf without a parameter, any parameter left unset, and any
shape that disagrees.

``load_adam8_state`` carries an 8-bit AdamW state across the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from sdbc_tpu_torch.models.clip import CLIPTextModel

_LEAF = {"w": "weight", "scale": "weight", "table": "weight",
         "b": "bias", "bias": "bias",
         **{k: k for k in ("beta", "mean", "var", "gamma")}}


def _flatten(node, prefix, out):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, prefix + [str(k)], out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, prefix + [str(i)], out)
    else:
        if prefix[-1] not in _LEAF:
            raise KeyError(f"unknown leaf {'/'.join(prefix)}")
        out[".".join(prefix[:-1] + [_LEAF[prefix[-1]]])] = np.asarray(node)


def _flatten_jax_tree(module: torch.nn.Module, tree) -> dict:
    """Port parameter name → numpy array, per the mapping above."""
    flat = {}
    if isinstance(module, CLIPTextModel) and "layers" in tree:
        tree = dict(tree)
        stacked = {}
        _flatten(tree.pop("layers"), [], stacked)
        for name, arr in stacked.items():
            for i in range(arr.shape[0]):
                flat[f"layers.{i}.{name}"] = arr[i]
    _flatten(tree, [], flat)
    return flat


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``module`` in place; returns it."""
    flat = _flatten_jax_tree(module, tree)
    params = dict(module.named_parameters())
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
        p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
    return module


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
