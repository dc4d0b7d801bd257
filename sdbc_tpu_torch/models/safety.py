"""Safety checker (counterpart of ``sdbc_tpu/models/safety.py``).

The pipeline slot is an optional callable ``checker(images, prompts) ->
(images, nsfw_flags)`` applied to decoded outputs (``SDPipeline``); None is
the reference's operating mode.  ``BlocklistSafetyChecker`` blacks out
images whose prompt names a blocked term; ``ClipSafetyChecker`` is
diffusers' StableDiffusionSafetyChecker: the CLIP ViT-L/14 image embedding
through a bias-free visual projection, its cosine against 17 learned
concept embeddings minus their thresholds (+0.01 on every concept score of
an image that matches one of the 3 special-care concepts); an image with
any positive concept score is flagged and set to 0.0.

The checker runs in strict fp32 (TF32 off for its matmuls and its patch
convolution), as the JAX default does.  Its input resize is JAX's
antialiased bicubic (``utils.image.resize``), not ``F.interpolate``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn as tnn

from sdbc_tpu_torch.models import clip as clip_mod
from sdbc_tpu_torch.models.convert import load_jax_params
from sdbc_tpu_torch.ops import nn
from sdbc_tpu_torch.utils.dtypes import fp32_exact
from sdbc_tpu_torch.utils.image import resize


class BlocklistSafetyChecker:
    """Prompt-term blocklist checker implementing the pipeline interface."""

    def __init__(self, blocked_terms: Sequence[str] = ()):
        self.blocked_terms = [t.lower() for t in blocked_terms]

    def __call__(self, images: np.ndarray,
                 prompts: Optional[Sequence[str]] = None
                 ) -> Tuple[np.ndarray, List[bool]]:
        if not prompts:
            return images, [False] * len(images)
        flags = [any(t in p.lower() for t in self.blocked_terms)
                 for p in prompts]
        return _black_out(images, flags), flags


def apply_safety_checker(checker, images: np.ndarray,
                         prompts: Optional[Sequence[str]] = None):
    """None-compatible application (the reference runs without a checker)."""
    if checker is None:
        return images, [False] * len(images)
    return checker(images, prompts)


def _black_out(images: np.ndarray, flags) -> np.ndarray:
    """A copy of ``images`` with each flagged one set to 0.0 (the upstream
    checker's black image)."""
    out = np.array(images, copy=True)
    for i, bad in enumerate(flags):
        if bad:
            out[i] = 0.0
    return out


def clip_preprocess(images, image_size: int = 224,
                    device="cpu") -> torch.Tensor:
    """(B, H, W, 3) float in [0, 1] (array or tensor) → CLIP-normalized
    (B, S, S, 3) float32 on ``device``: JAX's bicubic resize (antialiased
    when it shrinks) to the tower's square input, then per-channel
    (x − mean) / std.  Square inputs, so CLIPImageProcessor's
    resize + center crop is this resize."""
    x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                        else images).to(device, torch.float32)
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3), got "
                         f"{tuple(x.shape)}")
    with fp32_exact():
        if x.shape[1] != image_size or x.shape[2] != image_size:
            x = resize(x, (x.shape[0], image_size, image_size, 3), "bicubic")
        mean = torch.tensor(clip_mod.CLIP_IMAGE_MEAN, device=x.device)
        std = torch.tensor(clip_mod.CLIP_IMAGE_STD, device=x.device)
        return (x - mean) / std


class SafetyModel(tnn.Module):
    """StableDiffusionSafetyChecker's weights: the vision tower, the
    visual projection and the concept tables with their thresholds
    (buffers; ``models.port.port_safety_checker`` gives the JAX tree of a
    diffusers checkpoint, ``models.convert.load_jax_params`` fills them)."""

    def __init__(self, cfg: clip_mod.CLIPVisionConfig,
                 projection_dim: int = 768, concepts: int = 17,
                 special: int = 3, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.vision = clip_mod.vision_init(cfg, **kw)
        self.visual_projection = nn.Linear(cfg.hidden, projection_dim,
                                           use_bias=False, **kw)
        for name, shape in (("concept_embeds", (concepts, projection_dim)),
                            ("special_care_embeds", (special,
                                                     projection_dim))):
            self.register_buffer(name, nn._normal(shape, generator, device,
                                                  dtype))
        for name, n in (("concept_weights", concepts),
                        ("special_care_weights", special)):
            self.register_buffer(name, nn._uniform((n,), 0.1, generator,
                                                   device, dtype))


def safety_from_tree(tree, cfg: clip_mod.CLIPVisionConfig,
                     device="cpu") -> SafetyModel:
    """A ``SafetyModel`` of the shapes of a JAX safety-checker tree
    (``port_safety_checker``), filled from it."""
    proj = np.asarray(tree["concept_embeds"])
    model = SafetyModel(cfg, projection_dim=proj.shape[1],
                        concepts=proj.shape[0],
                        special=np.asarray(tree["special_care_embeds"]
                                           ).shape[0], device=device)
    return load_jax_params(model, tree).requires_grad_(False)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class ClipSafetyChecker:
    """StableDiffusionSafetyChecker on the port's CLIP vision tower, on the
    device its ``SafetyModel`` lies on.  ``model``: a ``SafetyModel``, or a
    JAX tree (``port_safety_checker``) built on ``device``."""

    def __init__(self, model, cfg: Optional[clip_mod.CLIPVisionConfig] = None,
                 device="cuda"):
        self.cfg = cfg or clip_mod.CLIPVisionConfig.sd_safety()
        if not isinstance(model, SafetyModel):
            model = safety_from_tree(model, self.cfg, device)
        self.model = model.requires_grad_(False)

    @torch.inference_mode()
    def scores(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """→ (concept_scores (B, K), special_scores (B, S)) as numpy;
        > 0 is a match."""
        m = self.model
        x = clip_preprocess(images, self.cfg.image_size,
                            m.concept_embeds.device)
        with fp32_exact():
            _, pooled = clip_mod.vision_apply(m.vision, x)
            emb = _unit(m.visual_projection(pooled))
            special = (emb @ _unit(m.special_care_embeds).T
                       - m.special_care_weights[None])
            adjust = (special > 0).any(dim=1).float() * 0.01
            concept = (emb @ _unit(m.concept_embeds).T
                       - m.concept_weights[None] + adjust[:, None])
        return concept.cpu().numpy(), special.cpu().numpy()

    def __call__(self, images: np.ndarray,
                 prompts: Optional[Sequence[str]] = None
                 ) -> Tuple[np.ndarray, List[bool]]:
        concept, _ = self.scores(images)
        flags = [bool(f) for f in (concept > 0).any(axis=1)]
        return _black_out(images, flags), flags
