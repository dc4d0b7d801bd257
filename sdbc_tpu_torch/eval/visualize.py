"""Prompt-grid visualisation — the de-facto regression test of the reference
(counterpart of ``sdbc_tpu/eval/visualize.py``).

Replaces ``visualize_prompts`` (reference inference.py:194-383 and the
train-side twin finetune_sd.py:161-295, SURVEY.md C4/C5): render every test
template × samples_per_prompt with FIXED latents (seeded once, one latent per
sample — inference.py:263-274), batched generation, and save a labelled grid
PNG named by its flag configuration.  Fixed seed + same checkpoint ⇒
pixel-identical grids (SURVEY.md §4 "golden-eyeball evaluation").
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from sdbc_tpu_torch.data import templates
from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents


def visualize_prompts(pipeline, *, summarize: bool = False,
                      include_desc: bool = False,
                      descriptions: Optional[List[str]] = None,
                      samples_per_prompt: int = 2,
                      img_size: int = 512,
                      inference_steps: int = 50,
                      guidance_scale: float = 7.5,
                      batch_generate: bool = True,
                      batch_size: int = 4,
                      save_dir: Optional[str] = None,
                      seed: int = 42,
                      test_templates: Optional[List[str]] = None,
                      prompts_override: Optional[List[str]] = None,
                      name_suffix: str = "", spec=None):
    """Generate the qualitative-eval grid; returns (images, prompts, path)
    — path is None when save_dir is unset.

    include_desc=True appends the description placeholder with the RAW
    description (the reference, inference.py:324-330); ``summarize=True``
    (a DistilBART summary instead) raises until the summarizer is ported
    (ROADMAP Queue 1 item 9); otherwise the fixed test templates
    are used as-is.  prompts_override supplies a pre-rendered (template ×
    sample) prompt list (the --prompt_bank reference path) and bypasses
    the template expansion.  name_suffix distinguishes grid files that
    share a flag configuration (e.g. different prompt banks).
    """
    if summarize and not include_desc:
        raise ValueError("summarize requires include_desc "
                         "(reference assertion, inference.py:248-250)")
    if summarize:
        raise NotImplementedError("summarize: the BART summarizer is not "
                                  "ported yet (ROADMAP Queue 1 item 9)")
    if prompts_override is not None:
        if len(prompts_override) % samples_per_prompt:
            raise ValueError("len(prompts_override) must be a multiple of "
                             "samples_per_prompt")
        prompts = list(prompts_override)
        n_rows = len(prompts) // samples_per_prompt
    else:
        prompts_base = list(test_templates or templates.TEST_TEMPLATES)

        if include_desc:
            # the reference appends the description placeholder whenever
            # include_desc is set (inference.py:324-330; its
            # batch_generate=False fallback for the raw case is a torch
            # ragged-batch artifact — the 77-token pad makes batching fine)
            if not descriptions:
                raise ValueError("include_desc=True needs descriptions")
            placeholders = templates.padded_placeholders(len(prompts_base))
            descs = list(descriptions[: len(prompts_base)])
            while len(descs) < len(prompts_base):
                descs.append(descs[-1])
            prompts_base = [ph.format(summary=s)
                            for ph, s in zip(placeholders, descs)]

        prompts = [p for p in prompts_base for _ in range(samples_per_prompt)]
        n_rows = len(prompts_base)

    f = pipeline.cfg.vae_scale
    lat_shape = (pipeline.cfg.latent_channels, img_size // f, img_size // f)
    latents = per_sample_fixed_latents(len(prompts), lat_shape, seed=seed)

    from sdbc_tpu_torch.diffusion.spec import SampleSpec

    # optional profile spec (DeepCache/Karras/FreeU/...); geometry, steps
    # and guidance stay pinned by the explicit arguments
    base_spec = (spec or SampleSpec()).replace(
        height=img_size, width=img_size,
        num_inference_steps=inference_steps,
        guidance_scale=guidance_scale)
    images = []
    step = batch_size if batch_generate else 1
    for i in range(0, len(prompts), step):
        chunk = prompts[i:i + step]
        out = pipeline.generate(
            chunk, base_spec.replace(latents=latents[i:i + len(chunk)]))
        images.append(out)
    images = np.concatenate(images, axis=0)

    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(
            save_dir, f"summerize={summarize},include_desc={include_desc}"
                      f"{name_suffix}.png")
        save_grid(images, prompts, path,
                  cols=samples_per_prompt, rows=n_rows)
        return images, prompts, path
    return images, prompts, None


def save_grid(images: np.ndarray, prompts: List[str], path: str,
              rows: int, cols: int) -> None:
    """Matplotlib grid with prompt titles (reference inference.py:282-375)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(rows, cols, figsize=(cols * 4, rows * 4))
    axes = np.atleast_2d(np.asarray(axes)).reshape(rows, cols)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            ax = axes[r, c]
            ax.axis("off")
            if i < len(images):
                ax.imshow(np.clip(images[i], 0, 1))
                ax.set_title(prompts[i][:60], fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
