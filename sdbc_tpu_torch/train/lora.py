"""LoRA adapters (counterpart of ``sdbc_tpu/train/lora.py``), on modules.

An adapter is a flat dict keyed by the dotted JAX tree path of the adapted
linear, ``{"a": (..., in, r), "b": (..., r, out)}``; ΔW = scale·(a @ b) with
scale = α / r.  ``models.convert`` maps tree paths to module paths one for
one (leaf ``w`` → ``weight``, linear weights stay (in, out)), so
``"unet.down.0.attns.0.attn1.q"`` is
``models["unet"].get_submodule("down.0.attns.0.attn1.q").weight``.  The
JAX tree's stacked trees keep their single path and leading axis: CLIP's
layers (``"text_encoder.layers.attn.q"``, SDXL's
``"text_encoder_2.layers.attn.q"``) hold ``a: (L, in, r)`` and
``b: (L, r, out)``, layer ``i`` taking ``a[i] @ b[i]``, and so do a deep
transformer's blocks (``"unet.down.1.attns.0.blocks.attn1.q"``,
``a: (depth, in, r)``).

Serving merges once up front: ``apply_lora`` / ``merge_file`` return
merged copies of the components an adapter touches (the others shared) and
leave the base modules untouched, so a daemon serves the base next to each
adapter.  The delta is computed in fp32 and the sum rounded once to the
weight's dtype.  Training (``TrainConfig.lora_rank``) merges without
copies: ``merged_weights`` gives W + scale·(a @ b) of the adapted
projections only, in the same rounding order and differentiable in a and
b, and the trainer puts them in place of the frozen weights for a forward
and its backward.  Files are the JAX package's ``sdbc_lora_v1`` ``.npz``:
a file written by either package loads in the other.
"""
from __future__ import annotations

import copy
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sdbc_tpu_torch.models.convert import STACKED_INDEX
from sdbc_tpu_torch.ops import nn

# the UNet's self/cross attention ("attn1"/"attn2") and CLIP's ("attn"):
# the diffusers LoRA convention (attention projections only)
DEFAULT_CONTAINERS = ("attn1", "attn2", "attn")
DEFAULT_PROJECTIONS = ("q", "k", "v", "o")

def _linears(models: dict) -> Dict[str, Tuple[bool, list]]:
    """Dotted JAX path → (stacked, [modules]) for every linear (and conv,
    as the JAX package's ``_is_linear`` counts any ``{"w"}`` of rank ≥ 2)
    of the components; a CLIP tower's ``layers.<i>.…`` (a deep
    transformer's ``blocks.<k>.…``) share one stacked path, one module per
    layer."""
    out: Dict[str, Tuple[bool, list]] = {}
    for comp, module in models.items():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                flat = STACKED_INDEX.sub(r"\1\2.", name)
                out.setdefault(f"{comp}.{flat}", (flat != name, []))[1] \
                    .append(m)
    return out


def _targets(models, components, containers, projections):
    for path, (stacked, mods) in _linears(models).items():
        parts = path.split(".")
        if parts[0] in components and parts[-1] in projections \
                and any(c in parts[:-1] for c in containers):
            yield path, stacked, [m.weight for m in mods]


def _shape(stacked: bool, weights: list) -> tuple:
    w = tuple(weights[0].shape)
    return (len(weights),) + w if stacked else w


def init_lora(generator: torch.Generator, models: dict, rank: int,
              components: Tuple[str, ...],
              containers: Tuple[str, ...] = DEFAULT_CONTAINERS,
              projections: Tuple[str, ...] = DEFAULT_PROJECTIONS,
              ) -> Dict[str, dict]:
    """A zero-delta adapter for every targeted projection: a ~
    U(±1/sqrt(fan_in)) (the PEFT init), b = 0, fp32 on the generator's
    device."""
    if rank < 1:
        raise ValueError(f"LoRA rank must be >= 1, got {rank}")
    out: Dict[str, dict] = {}
    dev = generator.device
    for path, stacked, weights in _targets(models, components, containers,
                                           projections):
        shape = _shape(stacked, weights)
        bound = 1.0 / (shape[-2] ** 0.5)
        a = torch.rand(shape[:-1] + (rank,), generator=generator,
                       device=dev) * (2 * bound) - bound
        b = torch.zeros(shape[:-2] + (rank, shape[-1]), device=dev)
        out[path] = {"a": a, "b": b}
    if not out:
        raise ValueError(
            f"no LoRA targets found for components={components} "
            f"containers={containers} projections={projections}")
    return out


@torch.no_grad()
def apply_lora(models: dict, lora: Dict[str, dict], scale: float) -> dict:
    """``models`` with w ← w + scale·(a @ b) at every adapter path: merged
    copies of the components the adapter touches, the others shared, the
    input untouched.  Raises if an adapter path matches no linear."""
    touched = {k.split(".", 1)[0] for k in lora}
    out = {name: copy.deepcopy(m) if name in touched else m
           for name, m in models.items()}
    for m, w in merged_weights(
            {k: m for k, m in out.items() if k in touched}, lora, scale):
        m.weight.copy_(w)
    return out


def merged_weights(models: dict, lora: Dict[str, dict], scale: float):
    """[(module, W + scale·(a @ b))] for every adapted projection, the
    delta in fp32 and the sum rounded once to the weight's dtype (the JAX
    package's ``apply_lora`` order), differentiable in a and b.  Raises if
    an adapter path matches no linear."""
    table = _linears(models)
    missing = sorted(set(lora) - set(table))
    if missing:
        raise ValueError(
            f"LoRA adapter paths not found in params: {missing[:5]} "
            f"(+{max(len(missing) - 5, 0)} more) — wrong component tree?")
    out = []
    for path, ab in lora.items():
        stacked, mods = table[path]
        weights = [m.weight for m in mods]
        dev = weights[0].device
        a, b = (ab[x] if torch.is_tensor(ab[x])
                else torch.from_numpy(np.array(ab[x])) for x in "ab")
        delta = torch.matmul(a.to(dev, torch.float32),
                             b.to(dev, torch.float32)) * scale
        if tuple(delta.shape) != _shape(stacked, weights):
            raise ValueError(f"LoRA adapter {path}: delta "
                             f"{tuple(delta.shape)} vs weight "
                             f"{_shape(stacked, weights)}")
        for m, d in zip(mods, delta if stacked else delta[None]):
            out.append((m, (m.weight.float() + d).to(m.weight.dtype)))
    return out


def lora_scale(rank: int, alpha: float) -> float:
    return alpha / rank


def count_params(lora: Dict[str, dict]) -> int:
    return sum(int(np.prod(v["a"].shape)) + int(np.prod(v["b"].shape))
               for v in lora.values())


# ---------------------------------------------------------------------------
# serialization: one portable .npz per adapter


def _np32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def save_lora(path: str, lora: Dict[str, dict], rank: int,
              alpha: float) -> None:
    arrays = {}
    for k, v in lora.items():
        arrays[k + ".a"] = _np32(v["a"])
        arrays[k + ".b"] = _np32(v["b"])
    meta = json.dumps({"rank": rank, "alpha": alpha, "format": "sdbc_lora_v1"})
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def load_lora(path: str) -> Tuple[Dict[str, dict], dict]:
    """→ (adapter dict of fp32 CPU tensors, {"rank", "alpha", ...})."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out: Dict[str, dict] = {}
        for k in z.files:
            if k == "__meta__":
                continue
            base, kind = k.rsplit(".", 1)
            out.setdefault(base, {})[kind] = torch.from_numpy(
                np.asarray(z[k], np.float32))
    bad = [k for k, v in out.items() if set(v) != {"a", "b"}]
    if bad:
        raise ValueError(f"malformed LoRA file {path}: incomplete pairs {bad}")
    return out, meta


def merge_file(models: dict, path: str,
               scale: Optional[float] = None) -> dict:
    """Load ``path`` and merge it into copies of ``models`` (the serving
    entry point; ``apply_lora``)."""
    lora, meta = load_lora(path)
    if scale is None:
        scale = lora_scale(int(meta["rank"]), float(meta["alpha"]))
    return apply_lora(models, lora, scale)
