"""CLIPScore — prompt ↔ cover alignment (counterpart of
``sdbc_tpu/eval/clip_score.py``; Hessel et al. 2021, arXiv:2104.08718):

    CLIPScore(img, txt) = w · max(cos(E_img, E_txt), 0),   w = 2.5

with E_txt the text tower's pooled output through ``text_projection`` and
E_img the vision tower's through ``visual_projection``; the norms are taken
in fp32.  Images are CLIP-preprocessed on the scorer's device
(``models.safety.clip_preprocess``: JAX's bicubic resize + per-channel
normalization).  ``models.port.clip_model_from_dir`` gives the weights of a
transformers CLIPModel dir.  fp32 scoring keeps TF32 off.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn as tnn

from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models.convert import load_jax_params
from sdbc_tpu_torch.models.safety import clip_preprocess
from sdbc_tpu_torch.ops import nn
from sdbc_tpu_torch.utils.dtypes import fp32_exact

CLIPSCORE_W = 2.5
_NEEDS_PROJECTION = ("ClipScorer needs a projected text tower "
                     "(CLIPTextModelWithProjection layout) — the embedding "
                     "spaces of the two towers only align through the "
                     "projections")


class ClipModel(tnn.Module):
    """Both towers and the visual projection (the text projection lives in
    the text tower); the JAX tree {"text", "vision", "visual_projection"}
    loads into it through ``models.convert.load_jax_params``."""

    def __init__(self, text_cfg: clip_mod.CLIPTextConfig,
                 vision_cfg: clip_mod.CLIPVisionConfig, *, device,
                 generator=None, dtype=torch.float32):
        super().__init__()
        if not text_cfg.projection_dim:
            raise ValueError(_NEEDS_PROJECTION)
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.text = clip_mod.init(text_cfg, **kw)
        self.vision = clip_mod.vision_init(vision_cfg, **kw)
        self.visual_projection = nn.Linear(vision_cfg.hidden,
                                           text_cfg.projection_dim,
                                           use_bias=False, **kw)


class ClipScorer:
    """``model``: a ``ClipModel``, or a JAX tree {"text" (with
    text_projection), "vision", "visual_projection"} built on ``device``
    (the card unless the caller passes "cpu")."""

    def __init__(self, model, text_cfg: clip_mod.CLIPTextConfig,
                 vision_cfg: clip_mod.CLIPVisionConfig, tokenizer,
                 compute_dtype=torch.float32, device="cuda"):
        if not isinstance(model, ClipModel):
            if "text_projection" not in model["text"]:
                raise ValueError(_NEEDS_PROJECTION)
            model = load_jax_params(ClipModel(text_cfg, vision_cfg,
                                              device=device), model)
        self.model = model.requires_grad_(False)
        self.text_cfg = text_cfg
        self.vision_cfg = vision_cfg
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def cosines(self, images, prompts: Sequence[str]) -> np.ndarray:
        """images: (B, H, W, 3) float in [0, 1] (any H/W) or uint8 → the
        per-pair cosine similarities (B,)."""
        images = np.asarray(images)
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        if images.ndim != 4 or images.shape[0] != len(prompts):
            raise ValueError(f"{images.shape} images vs {len(prompts)} "
                             "prompts (need one prompt per image)")
        m = self.model
        dev = m.visual_projection.weight.device
        pix = clip_preprocess(images, self.vision_cfg.image_size, dev)
        ids = torch.from_numpy(np.asarray(self.tokenizer.batch_encode(
            list(prompts), self.text_cfg.ctx), np.int64)).to(dev)
        with fp32_exact():
            _, t = clip_mod.apply_with_pooled(m.text, ids,
                                              compute_dtype=self.compute_dtype)
            _, v = clip_mod.vision_apply(m.vision, pix,
                                         compute_dtype=self.compute_dtype)
            v = m.visual_projection(v)
            t = t / torch.linalg.vector_norm(t.float(), dim=-1, keepdim=True)
            v = v / torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True)
            return torch.sum(t * v, dim=-1).float().cpu().numpy()

    def score(self, images, prompts, w: float = CLIPSCORE_W) -> np.ndarray:
        """CLIPScore per pair: w · max(cos, 0) (arXiv:2104.08718 eq. 1)."""
        return w * np.maximum(self.cosines(images, prompts), 0.0)
