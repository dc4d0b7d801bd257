"""InceptionV3 pool3 (2048-d) feature extractor for FID (counterpart of
``sdbc_tpu/models/inception.py``, with its parameter tree's names).

The standard InceptionV3 feature path of the reference's frozen TF graph
(``classify_image_graph_def.pb``, fid.py:36-66) up to ``pool_3:0``: stem
convs → 3× 35x35 inception blocks → grid reduction → 4× 17x17 blocks →
grid reduction → 2× 8x8 blocks → global average pool.

Conventions of the JAX module, kept exactly:
  - input is raw RGB in [0, 255]; ``features`` applies the graph's own
    preprocessing — JAX's antialiased bilinear resize to 299² and
    (x − 128) / 128 — after the resize;
  - every conv is followed by batch-norm with running mean and variance,
    eps 1e-3, an optional scale ``gamma`` (pytorch-fid ports carry one; the
    2015 graph has none) and ``beta``, then ReLU;
  - VALID or SAME padding per conv, as the JAX tree's forward gives it;
  - the 3×3 average pools divide by the count of in-image taps
    (``count_include_pad=False``);
  - the last 8×8 block max-pools (stride 1, SAME) where the others average.

Convolutions and pools are plain ``torch.nn.functional`` (cuDNN), as the
JAX package leaves them to XLA.  ``features`` runs in strict fp32 on the
card (TF32 off for the call, the previous switches restored): FID values
are compared across runs, so the extractor's rounding should be the fp32
one the JAX package's has.

Parameters: a conv ``weight`` in HWIO and ``beta``/``mean``/``var``
(``gamma``) per unit; ``save_npz``/``load_npz`` read and write the JAX
package's flat ``a/b/0/c`` ``.npz`` without JAX, so a JAX-written archive
loads directly (``from_tree``).  ``init`` draws random weights from a
``torch.Generator``: they differ from the JAX package's random init.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdbc_tpu_torch.utils.dtypes import fp32_exact
from sdbc_tpu_torch.utils.image import resize


@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    image_size: int = 299
    feature_dim: int = 2048
    width_mult: float = 1.0  # tiny test configs scale channel counts

    @staticmethod
    def fid() -> "InceptionConfig":
        return InceptionConfig()

    @staticmethod
    def tiny() -> "InceptionConfig":
        return InceptionConfig(image_size=75, width_mult=0.125)


def _scale(c, m):
    return max(int(round(c * m)), 8) if m != 1.0 else c


class CBR(nn.Module):
    """conv (HWIO ``weight``, no bias) + batch-norm + ReLU."""

    def __init__(self, cin, cout, kh, kw, *, gamma: bool, device,
                 generator=None):
        super().__init__()
        if generator is None:
            w = torch.empty((kh, kw, cin, cout), device=device)
        else:
            w = torch.randn((kh, kw, cin, cout), generator=generator,
                            device=device) * (2.0 / (kh * kw * cin)) ** 0.5
        self.weight = nn.Parameter(w)
        self.beta = nn.Parameter(torch.zeros(cout, device=device))
        self.mean = nn.Parameter(torch.zeros(cout, device=device))
        self.var = nn.Parameter(torch.ones(cout, device=device))
        self.gamma = (nn.Parameter(torch.ones(cout, device=device))
                      if gamma else None)

    def forward(self, x, stride: int = 1, padding: str = "SAME"):
        """x: NCHW fp32."""
        kh, kw = self.weight.shape[:2]
        pad = (kh // 2, kw // 2) if padding == "SAME" else 0
        y = F.conv2d(x, self.weight.permute(3, 2, 0, 1), stride=stride,
                     padding=pad)
        y = (y - self.mean[:, None, None]) * torch.rsqrt(
            self.var[:, None, None] + 1e-3)
        if self.gamma is not None:
            y = y * self.gamma[:, None, None]
        return F.relu(y + self.beta[:, None, None])


def _max_pool(x, k=3, s=2, same=False):
    return F.max_pool2d(x, k, s, padding=k // 2 if same else 0)


def _avg_pool_same(x, k=3):
    return F.avg_pool2d(x, k, 1, padding=k // 2, count_include_pad=False)


class Inception(nn.Module):
    """The pool3 path; submodule names follow the JAX tree
    (``stem.c1``, ``mixed35.0.b1x1``, ``red17.b3x3``, ...)."""

    def __init__(self, cfg: InceptionConfig = InceptionConfig(), *,
                 device="cuda", generator=None, gamma: bool = False):
        super().__init__()
        self.cfg = cfg
        m = cfg.width_mult
        s = lambda c: _scale(c, m)
        unit = lambda cin, cout, kh, kw: CBR(cin, cout, kh, kw, gamma=gamma,
                                             device=device,
                                             generator=generator)
        units = lambda spec: nn.ModuleDict(
            {name: unit(*args) for name, args in spec})
        self.stem = units([("c1", (3, s(32), 3, 3)),
                           ("c2", (s(32), s(32), 3, 3)),
                           ("c3", (s(32), s(64), 3, 3)),
                           ("c4", (s(64), s(80), 1, 1)),
                           ("c5", (s(80), s(192), 3, 3))])
        cin = s(192)
        self.mixed35 = nn.ModuleList()
        for pool_ch in (32, 64, 64):
            self.mixed35.append(units([
                ("b1x1", (cin, s(64), 1, 1)),
                ("b5x5_1", (cin, s(48), 1, 1)),
                ("b5x5_2", (s(48), s(64), 5, 5)),
                ("b3x3_1", (cin, s(64), 1, 1)),
                ("b3x3_2", (s(64), s(96), 3, 3)),
                ("b3x3_3", (s(96), s(96), 3, 3)),
                ("pool", (cin, s(pool_ch), 1, 1))]))
            cin = s(64) * 2 + s(96) + s(pool_ch)
        self.red17 = units([("b3x3", (cin, s(384), 3, 3)),
                            ("b3x3d_1", (cin, s(64), 1, 1)),
                            ("b3x3d_2", (s(64), s(96), 3, 3)),
                            ("b3x3d_3", (s(96), s(96), 3, 3))])
        cin = cin + s(384) + s(96)
        self.mixed17 = nn.ModuleList()
        for mid in (128, 160, 160, 192):
            mid, out = s(mid), s(192)
            self.mixed17.append(units([
                ("b1x1", (cin, out, 1, 1)),
                ("b7x7_1", (cin, mid, 1, 1)),
                ("b7x7_2", (mid, mid, 1, 7)),
                ("b7x7_3", (mid, out, 7, 1)),
                ("b7x7d_1", (cin, mid, 1, 1)),
                ("b7x7d_2", (mid, mid, 7, 1)),
                ("b7x7d_3", (mid, mid, 1, 7)),
                ("b7x7d_4", (mid, mid, 7, 1)),
                ("b7x7d_5", (mid, out, 1, 7)),
                ("pool", (cin, out, 1, 1))]))
            cin = s(192) * 4
        self.red8 = units([("b3x3_1", (cin, s(192), 1, 1)),
                           ("b3x3_2", (s(192), s(320), 3, 3)),
                           ("b7x7_1", (cin, s(192), 1, 1)),
                           ("b7x7_2", (s(192), s(192), 1, 7)),
                           ("b7x7_3", (s(192), s(192), 7, 1)),
                           ("b7x7_4", (s(192), s(192), 3, 3))])
        cin = cin + s(320) + s(192)
        self.mixed8 = nn.ModuleList()
        for _ in range(2):
            self.mixed8.append(units([
                ("b1x1", (cin, s(320), 1, 1)),
                ("b3x3_1", (cin, s(384), 1, 1)),
                ("b3x3_2a", (s(384), s(384), 1, 3)),
                ("b3x3_2b", (s(384), s(384), 3, 1)),
                ("b3x3d_1", (cin, s(448), 1, 1)),
                ("b3x3d_2", (s(448), s(384), 3, 3)),
                ("b3x3d_3a", (s(384), s(384), 1, 3)),
                ("b3x3d_3b", (s(384), s(384), 3, 1)),
                ("pool", (cin, s(192), 1, 1))]))
            cin = s(320) + 2 * s(384) + 2 * s(384) + s(192)

    def forward(self, x):
        """x: (N, 3, H, W) fp32 after the preprocessing → (N, C)."""
        st = self.stem
        x = st["c1"](x, stride=2, padding="VALID")
        x = st["c2"](x, padding="VALID")
        x = st["c3"](x)
        x = _max_pool(x)
        x = st["c4"](x, padding="VALID")
        x = st["c5"](x, padding="VALID")
        x = _max_pool(x)
        for p in self.mixed35:
            x = torch.cat([p["b1x1"](x), p["b5x5_2"](p["b5x5_1"](x)),
                           p["b3x3_3"](p["b3x3_2"](p["b3x3_1"](x))),
                           p["pool"](_avg_pool_same(x))], dim=1)
        r = self.red17
        b1 = r["b3x3d_2"](r["b3x3d_1"](x))
        x = torch.cat([r["b3x3"](x, stride=2, padding="VALID"),
                       r["b3x3d_3"](b1, stride=2, padding="VALID"),
                       _max_pool(x)], dim=1)
        for p in self.mixed17:
            b2 = x
            for name in ("b7x7d_1", "b7x7d_2", "b7x7d_3", "b7x7d_4",
                         "b7x7d_5"):
                b2 = p[name](b2)
            x = torch.cat([p["b1x1"](x),
                           p["b7x7_3"](p["b7x7_2"](p["b7x7_1"](x))), b2,
                           p["pool"](_avg_pool_same(x))], dim=1)
        r = self.red8
        b1 = r["b7x7_3"](r["b7x7_2"](r["b7x7_1"](x)))
        x = torch.cat([r["b3x3_2"](r["b3x3_1"](x), stride=2,
                                   padding="VALID"),
                       r["b7x7_4"](b1, stride=2, padding="VALID"),
                       _max_pool(x)], dim=1)
        for i, p in enumerate(self.mixed8):
            b1 = p["b3x3_1"](x)
            b2 = p["b3x3d_2"](p["b3x3d_1"](x))
            # the 2015 FID graph max-pools in the LAST 8x8 block
            pooled = (_max_pool(x, 3, 1, same=True)
                      if i == len(self.mixed8) - 1 else _avg_pool_same(x))
            x = torch.cat([p["b1x1"](x), p["b3x3_2a"](b1), p["b3x3_2b"](b1),
                           p["b3x3d_3a"](b2), p["b3x3d_3b"](b2),
                           p["pool"](pooled)], dim=1)
        return x.mean(dim=(2, 3))


def init(cfg: InceptionConfig = InceptionConfig(), *, generator=None,
         device="cuda", gamma: bool = False) -> Inception:
    """Random weights from ``generator`` (a ``torch.Generator`` on
    ``device``): normal · sqrt(2 / fan_in) convs, beta 0, mean 0, var 1;
    with ``generator=None`` the conv weights are left for a loader."""
    return Inception(cfg, device=device, generator=generator,
                     gamma=gamma).requires_grad_(False)


def from_tree(tree, cfg: InceptionConfig = InceptionConfig(), *,
              device="cuda") -> Inception:
    """The module holding a JAX-layout parameter tree (nested numpy, as
    ``load_npz`` and ``models.port.port_fid_inception`` give it); a tree
    whose units carry ``gamma`` builds units with a BN scale."""
    from sdbc_tpu_torch.models.convert import load_jax_params

    gamma = "gamma" in tree["stem"]["c1"]
    return load_jax_params(init(cfg, device=device, gamma=gamma), tree)


@torch.inference_mode()
def features(model: Inception, images) -> torch.Tensor:
    """images: (N, H, W, 3) RGB in [0, 255] (array or tensor) → pool3
    features (N, C) fp32 on the model's device, in strict fp32.

    Applies the frozen graph's own preprocessing: JAX's antialiased
    bilinear resize to the config's size, then (x − 128) / 128."""
    size = model.cfg.image_size
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                        else images).to(device, torch.float32)
    with fp32_exact():
        if x.shape[1] != size or x.shape[2] != size:
            x = resize(x, (x.shape[0], size, size, 3), "bilinear")
        x = (x - 128.0) / 128.0
        return model(x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))


def _tree_of(model_or_tree):
    if not isinstance(model_or_tree, nn.Module):
        return model_or_tree
    tree: dict = {}
    for name, p in model_or_tree.named_parameters():
        parts = name.split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node["w" if parts[-1] == "weight" else parts[-1]] = \
            p.detach().cpu().numpy()
    return _lists(tree)


def _lists(node):
    """Digit-keyed dicts → lists (the JAX tree's block lists)."""
    if isinstance(node, dict):
        if node and all(k.isdigit() for k in node):
            return [_lists(node[str(i)]) for i in range(len(node))]
        return {k: _lists(v) for k, v in node.items()}
    return node


def save_npz(path: str, model_or_tree) -> None:
    """Flatten a module or parameter tree to an 'a/b/0/c'-keyed npz (the
    JAX package's format: conv weights ``w`` in HWIO)."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            flat[prefix] = np.asarray(node)

    walk(_tree_of(model_or_tree), "")
    np.savez(path, **flat)


def load_npz(path: str):
    """Load a flat 'a/b/0/c' weight archive → nested numpy tree."""
    tree: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = flat[key]
    return _lists(tree)
