"""CLIP text encoder and vision tower (counterpart of
``sdbc_tpu/models/clip.py``).

Text: 12 pre-LN transformer layers, quick-GELU MLPs, causal self-attention
over 77 tokens, final LayerNorm; optionally a bias-free ``text_projection``
of the pooled output (``apply_with_pooled``).  SD-2.x's OpenCLIP ViT-H
tower (``sd2``) and SDXL's OpenCLIP bigG tower (``sdxl_g``) are the same
layers at other widths with the exact-erf GELU.  Vision (the safety checker's
and CLIPScore's image half, ``transformers.CLIPVisionModel``): a bias-free
conv patch embedding, a prepended class token, learned positions, a
pre-LayerNorm, the same layers without the causal mask, and a post-LayerNorm
of the class token only.  The JAX package stacks the layers into one scanned
tree; here they are a ``ModuleList`` (``layers.0.attn.q.weight`` ↔
``["layers"]["attn"]["q"]["w"][0]``) walked by a loop.  The 77- and
257-token attentions are plain PyTorch, as they are plain XLA there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn as tnn

from sdbc_tpu_torch.ops import nn
from sdbc_tpu_torch.ops.attention import plain_attention
from sdbc_tpu_torch.parallel import comm


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
    # CLIPTextModelWithProjection: the pooled output through a bias-free
    # hidden → projection_dim linear; None = no projection weights
    projection_dim: Optional[int] = None
    # the <|endoftext|> id pooling looks for; None = vocab_size − 1 (set it
    # when vocab_size counts appended textual-inversion rows)
    eot_id: Optional[int] = None

    @staticmethod
    def sd15() -> "CLIPTextConfig":
        return CLIPTextConfig()

    @staticmethod
    def sd2() -> "CLIPTextConfig":
        """SD-2.x's text encoder: the OpenCLIP ViT-H text tower as diffusers
        ships it (23 layers: the penultimate-layer cut is in the config),
        hidden 1024, exact-erf GELU."""
        return CLIPTextConfig(hidden=1024, layers=23, heads=16, mlp=4096,
                              act="gelu")

    @staticmethod
    def sdxl_g() -> "CLIPTextConfig":
        """SDXL's second encoder: the OpenCLIP bigG text tower (32 layers,
        hidden 1280, exact-erf GELU) with a 1280-wide text projection, the
        pooled conditioning's source."""
        return CLIPTextConfig(hidden=1280, layers=32, heads=20, mlp=5120,
                              act="gelu", projection_dim=1280)

    @staticmethod
    def tiny() -> "CLIPTextConfig":
        return CLIPTextConfig(vocab_size=1000, hidden=32, layers=2, heads=4,
                              mlp=64, ctx=16)


_ACTS = {"quick_gelu": nn.quick_gelu,
         # transformers' "gelu" is the exact erf form
         "gelu": lambda x: torch.nn.functional.gelu(x, approximate="none")}


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

    def forward(self, x, cfg, causal: bool = True):
        # tensor parallelism (``parallel.shard``): q/k/v and fc1 hold this
        # rank's columns (its heads), o and fc2 the matching rows, whose
        # partial products are all-reduced before their biases
        tpa = getattr(self.attn, "tp", None)
        tpm = getattr(self.mlp, "tp", None)
        b, s, h = x.shape
        heads = cfg.heads if tpa is None else cfg.heads // tpa.size
        hd = h // cfg.heads

        def split_heads(t):
            return t.reshape(b, s, heads, hd).transpose(1, 2)

        y = self.ln1(x, cfg.eps)
        if tpa is not None:
            y = comm.copy_to(y, tpa)
        q = split_heads(self.attn.q(y))
        k = split_heads(self.attn.k(y))
        v = split_heads(self.attn.v(y))
        a = plain_attention(q, k, v, causal=causal)
        a = a.transpose(1, 2).reshape(b, s, heads * hd)
        x = x + _row(self.attn.o, a, tpa)

        y = self.ln2(x, cfg.eps)
        if tpm is not None:
            y = comm.copy_to(y, tpm)
        y = self.mlp.fc1(y)
        act = _ACTS.get(cfg.act)
        if act is None:
            raise ValueError(f"unsupported CLIP hidden_act {cfg.act!r}")
        return x + _row(self.mlp.fc2, act(y), tpm)


def _row(lin, x, tp):
    """``lin(x)``; for a row-sharded ``lin`` the partial products summed
    over the model group, then the bias."""
    if tp is None:
        return lin(x)
    return comm.reduce_from(nn.linear(x, lin.weight), tp) \
        + lin.bias.to(x.dtype)


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
        self.text_projection = (
            nn.Linear(cfg.hidden, cfg.projection_dim, use_bias=False, **kw)
            if cfg.projection_dim else None)


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


def apply_with_pooled(model: CLIPTextModel, input_ids,
                      compute_dtype=torch.float32, skip_layers: int = 0,
                      eot_id: Optional[int] = None):
    """One encoder pass → (hidden, pooled).

    hidden: the state ``skip_layers`` layers early, without the final
    LayerNorm (B, ctx, hidden); pooled: the whole stack's final-LN output at
    the FIRST ``eot_id`` position of each row, through ``text_projection``
    when the model has one (B, projection_dim or hidden).  ``eot_id``
    defaults to ``cfg.eot_id``, else ``cfg.vocab_size − 1``."""
    cfg = model.cfg
    if not 0 <= skip_layers < cfg.layers:
        raise ValueError(f"skip_layers={skip_layers} outside [0, {cfg.layers})")
    x = model.token_embedding(input_ids)
    pos = model.position_embedding.weight[: input_ids.shape[1]]
    x = (x + pos[None]).to(compute_dtype)
    cut = cfg.layers - skip_layers
    hidden = x
    for i, layer in enumerate(model.layers):
        x = layer(x, cfg)
        if i + 1 == cut:
            hidden = x
    x = model.final_ln(x, cfg.eps)
    if eot_id is None:
        eot_id = cfg.eot_id if cfg.eot_id is not None else cfg.vocab_size - 1
    # transformers pools at the first eos (argmax of the match mask; row 0
    # where a row has none)
    eot_pos = torch.argmax((input_ids == eot_id).to(torch.int32), dim=1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_pos]
    if model.text_projection is not None:
        pooled = model.text_projection(pooled)
    return hidden, pooled


# ---------------------------------------------------------------------------
# vision tower


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    mlp: int = 4096
    patch: int = 14
    image_size: int = 224
    eps: float = 1e-5
    act: str = "quick_gelu"

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1

    @staticmethod
    def sd_safety() -> "CLIPVisionConfig":
        """The vision tower of CompVis/stable-diffusion-safety-checker
        (CLIP ViT-L/14 at 224²)."""
        return CLIPVisionConfig()

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(hidden=32, layers=2, heads=4, mlp=64,
                                patch=8, image_size=32)


# CLIPImageProcessor constants (openai/clip-vit-large-patch14)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionModel(tnn.Module):
    def __init__(self, cfg: CLIPVisionConfig, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.cfg = cfg
        self.class_embedding = tnn.Parameter(nn._normal(
            (cfg.hidden,), generator, device, dtype, 0.02))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden, cfg.patch,
                                         use_bias=False, **kw)
        self.position_embedding = nn.Embedding(cfg.num_positions,
                                               cfg.hidden, **kw)
        self.pre_ln = nn.LayerNorm(cfg.hidden, **kw)
        self.layers = tnn.ModuleList(_Layer(cfg, **kw)
                                     for _ in range(cfg.layers))
        self.post_ln = nn.LayerNorm(cfg.hidden, **kw)


def vision_init(cfg: CLIPVisionConfig, *, device, generator=None,
                dtype=torch.float32) -> CLIPVisionModel:
    return CLIPVisionModel(cfg, device=device, generator=generator,
                           dtype=dtype)


def vision_apply(model: CLIPVisionModel, pixels,
                 compute_dtype=torch.float32):
    """pixels: (B, S, S, 3), already CLIP-normalized → (last_hidden
    (B, N+1, hidden) before the post-LayerNorm, pooled (B, hidden): the
    post-LayerNorm of the class token)."""
    cfg = model.cfg
    if tuple(pixels.shape[1:]) != (cfg.image_size, cfg.image_size, 3):
        raise ValueError(f"vision tower expects (B, {cfg.image_size}, "
                         f"{cfg.image_size}, 3), got {tuple(pixels.shape)}")
    x = model.patch_embedding(pixels.to(compute_dtype), stride=cfg.patch,
                              padding=0)
    b = x.shape[0]
    x = x.reshape(b, -1, cfg.hidden)
    cls = model.class_embedding.to(compute_dtype)[None, None].expand(
        b, 1, cfg.hidden)
    x = torch.cat([cls, x], dim=1)
    x = x + model.position_embedding.weight[None].to(compute_dtype)
    x = model.pre_ln(x, cfg.eps)
    for layer in model.layers:
        x = layer(x, cfg, causal=False)
    return x, model.post_ln(x[:, 0], cfg.eps)
