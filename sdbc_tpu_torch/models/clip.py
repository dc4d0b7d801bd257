"""CLIP text encoder (counterpart of ``sdbc_tpu/models/clip.py``).

12 pre-LN transformer layers, quick-GELU MLPs, causal self-attention over 77
tokens, final LayerNorm.  The JAX package stacks the layers into one scanned
tree; here they are a ``ModuleList`` (``layers.0.attn.q.weight`` ↔
``["layers"]["attn"]["q"]["w"][0]``) walked by a loop.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn as tnn

from sdbc_tpu_torch.ops import nn
from sdbc_tpu_torch.ops.attention import plain_attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp: int = 3072
    ctx: int = 77
    eps: float = 1e-5
    act: str = "quick_gelu"

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=4,
                              mlp=64, ctx=16)


class _Attn(tnn.Module):
    def __init__(self, h, **kw):
        super().__init__()
        self.q, self.k = nn.Linear(h, h, **kw), nn.Linear(h, h, **kw)
        self.v, self.o = nn.Linear(h, h, **kw), nn.Linear(h, h, **kw)


class _MLP(tnn.Module):
    def __init__(self, h, mlp, **kw):
        super().__init__()
        self.fc1 = nn.Linear(h, mlp, **kw)
        self.fc2 = nn.Linear(mlp, h, **kw)


class _Layer(tnn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden, **kw)
        self.attn = _Attn(cfg.hidden, **kw)
        self.ln2 = nn.LayerNorm(cfg.hidden, **kw)
        self.mlp = _MLP(cfg.hidden, cfg.mlp, **kw)

    def forward(self, x, cfg: CLIPTextConfig):
        b, s, h = x.shape
        hd = h // cfg.heads

        def split_heads(t):
            return t.reshape(b, s, cfg.heads, hd).transpose(1, 2)

        y = self.ln1(x, cfg.eps)
        q = split_heads(self.attn.q(y))
        k = split_heads(self.attn.k(y))
        v = split_heads(self.attn.v(y))
        a = plain_attention(q, k, v, causal=True)
        a = a.transpose(1, 2).reshape(b, s, h)
        x = x + self.attn.o(a)

        y = self.mlp.fc1(self.ln2(x, cfg.eps))
        if cfg.act != "quick_gelu":
            raise NotImplementedError(f"CLIP act {cfg.act!r} is not ported")
        return x + self.mlp.fc2(nn.quick_gelu(y))


class CLIPTextModel(tnn.Module):
    def __init__(self, cfg: CLIPTextConfig, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden, **kw)
        self.position_embedding = nn.Embedding(cfg.ctx, cfg.hidden, **kw)
        self.layers = tnn.ModuleList(_Layer(cfg, **kw)
                                     for _ in range(cfg.layers))
        self.final_ln = nn.LayerNorm(cfg.hidden, **kw)


def init(cfg: CLIPTextConfig, *, device, generator=None,
         dtype=torch.float32) -> CLIPTextModel:
    return CLIPTextModel(cfg, device=device, generator=generator, dtype=dtype)


def apply(model: CLIPTextModel, input_ids, compute_dtype=torch.float32,
          skip_layers: int = 0, final_ln: bool = True):
    """input_ids: (B, ctx) int64 → last hidden state (B, ctx, hidden).

    ``skip_layers`` stops that many layers early (CLIP-skip); ``final_ln``
    False returns the stop layer's raw hidden state."""
    cfg = model.cfg
    if not 0 <= skip_layers < cfg.layers:
        raise ValueError(f"skip_layers={skip_layers} outside [0, {cfg.layers})")
    x = model.token_embedding(input_ids)
    pos = model.position_embedding.weight[: input_ids.shape[1]]
    x = (x + pos[None]).to(compute_dtype)
    for layer in model.layers[: cfg.layers - skip_layers]:
        x = layer(x, cfg)
    if not final_ln:
        return x
    return model.final_ln(x, cfg.eps)
