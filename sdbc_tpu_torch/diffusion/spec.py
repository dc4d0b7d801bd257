"""SampleSpec — the one sampling-request carrier (counterpart of
``sdbc_tpu/diffusion/spec.py``, with its field names and defaults).

A ``SampleSpec`` carries a whole request; ``SDPipeline.generate(prompts,
spec)`` routes it (the hires two-stage flow when ``hires_scale`` > 1, a
plain call otherwise), and ``call_kwargs()`` is the one place the fields
expand back into ``SDPipeline.__call__``'s keywords.

The JAX module also lists which fields are static and which traced under
``jax.jit`` (``STATIC_FIELDS``/``TRACED_FIELDS``): that describes XLA's
compile cache, which an eager PyTorch pipeline does not have, so the lists
are not carried over.

One behaviour differs on purpose: with ``hires_scale`` > 1 the JAX
``hires_kwargs`` silently drops the single-stage img2img fields
(``init_image``, ``init_latents``, ``mask_image``, ``strength``,
``denoising_start``/``denoising_end``); here a hires spec that sets any of
them away from its default raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple, Union

# single-stage fields that hires drives itself (the second stage's
# init_latents/strength come from the first stage and hires_strength)
_HIRES_DRIVEN = ("init_image", "init_latents", "mask_image", "strength",
                 "denoising_start", "denoising_end")
_HIRES = ("hires_scale", "hires_strength", "hires_steps", "hires_mode")


@dataclasses.dataclass(frozen=True)
class SampleSpec:
    """One sampling request.  Field semantics = SDPipeline.__call__."""

    # geometry / protocol
    height: int = 512
    width: int = 512
    num_inference_steps: int = 50
    num_images_per_prompt: int = 1
    decode: bool = True
    # guidance
    guidance_scale: float = 7.5
    guidance_rescale: float = 0.0
    cfg_interval: Optional[Tuple[float, float]] = None
    # scheduler knobs
    cache_interval: int = 0
    cache_tail: int = 0
    use_karras_sigmas: bool = False
    freeu: Optional[Tuple[float, float, float, float]] = None
    clip_skip: int = 0
    denoising_start: Optional[float] = None
    denoising_end: Optional[float] = None
    # prompts / conditioning
    negative_prompt: Union[None, str, Sequence[str]] = None
    prompt_weighting: bool = False
    max_prompt_chunks: int = 3
    seed: int = 42
    latents: Any = None
    # img2img / inpaint / controlnet
    init_image: Any = None
    init_latents: Any = None
    strength: float = 0.8
    mask_image: Any = None
    control_image: Any = None
    controlnet_scale: Union[float, Sequence[float]] = 1.0
    # SDXL micro-conditioning
    aesthetic_score: float = 6.0
    negative_aesthetic_score: float = 2.5
    # hires-fix second stage (hires_scale > 1 activates)
    hires_scale: float = 0.0
    hires_strength: float = 0.7
    hires_steps: int = 0
    hires_mode: str = "latent"

    def call_kwargs(self) -> dict:
        """Expand into SDPipeline.__call__ kwargs (the ONE expansion site).

        Hires fields are routing information for ``generate`` and are
        excluded — __call__ does not accept them.
        """
        # no dataclasses.asdict: it deep-copies values, and latents /
        # init images are big host arrays
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)}
        for k in _HIRES:
            d.pop(k)
        return d

    def hires_kwargs(self) -> dict:
        """Expand into SDPipeline.hires kwargs.  hires drives both stages
        itself, so a single-stage img2img/handoff field set away from its
        default is refused instead of dropped."""
        d = self.call_kwargs()
        for k in _HIRES_DRIVEN:
            v, default = d.pop(k), _DEFAULTS[k]
            # arrays are compared by identity: only None is their default
            if (v is not None) if default is None else v != default:
                raise ValueError(
                    f"a hires spec (hires_scale={self.hires_scale}) drives "
                    f"both stages itself and cannot take {k}; use "
                    "hires_strength for the second stage, or a plain spec "
                    "for img2img/inpainting")
        d.update(hires_scale=self.hires_scale,
                 hires_strength=self.hires_strength,
                 hires_steps=self.hires_steps or None,
                 hires_mode=self.hires_mode)
        return d

    def replace(self, **kw) -> "SampleSpec":
        return dataclasses.replace(self, **kw)


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(SampleSpec)}
