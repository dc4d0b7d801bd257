"""EnsemblePipeline — the SDXL base → refiner serving wrapper (counterpart
of ``sdbc_tpu/diffusion/ensemble.py``); the class docstring gives the
handoff protocol."""
from __future__ import annotations

import numpy as np

from sdbc_tpu_torch.diffusion.pipeline import SDPipeline

# inputs of the base stage only: the refiner resumes from the handed-over
# latents, so image or latent initialization does not apply to it
_STAGE1_ONLY = ("latents", "init_image", "init_latents", "strength",
                "control_image", "controlnet_scale")


class EnsemblePipeline:
    """SDXL base → refiner ensemble of expert denoisers.

    The base runs the high-noise share of the grid (``denoising_end=
    handoff``, raw latents out) and the refiner resumes at the same grid
    index (``denoising_start=handoff``, no re-noising): diffusers'
    StableDiffusionXLPipeline + Img2ImgPipeline ensemble.  It is called as
    ``SDPipeline`` is (the CLI modes and the evaluation code call it the
    same way); img2img's ``strength`` truncates the base stage's start, and
    inpainting masks are refused (a truncated run would hand over a
    half-blended composite)."""

    BATCH_BUCKETS = SDPipeline.BATCH_BUCKETS

    def __init__(self, base: SDPipeline, refiner: SDPipeline,
                 handoff: float = 0.8):
        if not refiner.cfg.refiner:
            raise ValueError("EnsemblePipeline's second model must be a "
                             "refiner config (PipelineConfig.refiner=True)")
        if base.cfg.refiner:
            raise ValueError("EnsemblePipeline's first model is the base "
                             "(got a refiner config in the base slot)")
        if base.cfg.schedule != refiner.cfg.schedule \
                or base.cfg.scheduler != refiner.cfg.scheduler:
            raise ValueError(
                "base and refiner must share the schedule AND scheduler: the "
                "handoff resumes mid-grid, so the two stages' timestep grids "
                f"must be identical (base {base.cfg.scheduler}/"
                f"{base.cfg.schedule} vs refiner {refiner.cfg.scheduler}/"
                f"{refiner.cfg.schedule})")
        if base.cfg.vae_scale != refiner.cfg.vae_scale:
            raise ValueError("base and refiner VAEs disagree on the latent "
                             "geometry (vae_scale): the handed-over latents "
                             "would decode at another resolution")
        if not 0.0 < handoff < 1.0:
            raise ValueError(f"handoff must be in (0, 1), got {handoff}")
        self.base = base
        self.refiner = refiner
        self.handoff = float(handoff)
        self.cfg = base.cfg
        self.device = base.device

    def __call__(self, prompts, *, aesthetic_score: float = 6.0,
                 negative_aesthetic_score: float = 2.5, decode: bool = True,
                 **kw):
        if kw.get("mask_image") is not None:
            raise ValueError("inpainting through the ensemble is not "
                             "supported (the handoff would blend against an "
                             "intermediate noise level): inpaint on the base "
                             "model, then refine with img2img")
        lat = self.base(prompts, decode=False, denoising_end=self.handoff,
                        **kw)
        kw2 = {k: v for k, v in kw.items() if k not in _STAGE1_ONLY}
        return self.refiner(prompts, latents=lat,
                            denoising_start=self.handoff, decode=decode,
                            aesthetic_score=aesthetic_score,
                            negative_aesthetic_score=negative_aesthetic_score,
                            **kw2)

    def img2img(self, prompts, image, *, strength: float = 0.3, **kw):
        return SDPipeline.img2img(self, prompts, image, strength=strength,
                                  **kw)

    def generate(self, prompts, spec):
        """Serve one ``SampleSpec`` (``SDPipeline.generate``).  The ensemble
        drives the handoff itself, so hires and per-call denoising bounds
        are refused rather than misrouted."""
        if spec.hires_scale and spec.hires_scale > 1.0:
            raise ValueError("hires is not available under --refiner_ckpt "
                             "ensemble serving (the refiner already runs a "
                             "tail pass)")
        if spec.denoising_start is not None or spec.denoising_end is not None:
            raise ValueError("the ensemble sets denoising_start/end from "
                             "--refiner_frac; they cannot be requested per "
                             "call")
        kw = spec.call_kwargs()
        for k in ("denoising_start", "denoising_end"):
            kw.pop(k)
        return self(prompts, **kw)

    def numpy_to_pil(self, imgs: np.ndarray):
        return self.base.numpy_to_pil(imgs)
