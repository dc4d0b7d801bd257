"""FID image generation — batched, resume-aware cover sampling over df_test
(counterpart of ``sdbc_tpu/eval/generate.py``).

Replaces ``get_fid_images`` (reference inference.py:153-187, SURVEY.md C12):
iterate test-set rows, build one random training-template prompt per row from
(author, title), generate 512² covers at 50 steps / cfg 7.5, save as
``<row-id>.jpg``; resume by counting files already in save_dir
(inference.py:158-162).  Unlike the reference, per-batch exceptions are logged
rather than silently swallowed (inference.py:180-182).
"""
from __future__ import annotations

import os
import random
import traceback
from typing import Optional

import numpy as np

from sdbc_tpu_torch.data import templates


def get_fid_images(pipeline, save_dir: str, df_test, *, num_imgs: int = 4000,
                   batch_size: int = 4, img_size: int = 512,
                   inference_steps: int = 50, guidance_scale: float = 7.5,
                   seed: int = 42, verbose: bool = True,
                   prompt_bank: str = "native", spec=None) -> int:
    """Generate up to num_imgs covers; returns the number generated this call.

    Raises RuntimeError if any batch failed: a partial image set would
    silently bias the downstream FID (the caller scores whatever is in
    save_dir).  Re-running resumes and retries only the missing rows.
    """
    os.makedirs(save_dir, exist_ok=True)
    # count .jpg only — calc_fid writes fid_score.txt into the same dir
    already = len([f for f in os.listdir(save_dir) if f.endswith(".jpg")])
    if verbose and already:
        print(f"resuming: {already} images already in {save_dir}")
    rng = random.Random(seed + already)

    from sdbc_tpu_torch.diffusion.spec import SampleSpec

    # ``spec`` carries the full sampling profile (DeepCache, Karras grids,
    # FreeU, guidance-interval...) — previously the CLI's profile flags
    # were silently dropped on the calc_fid path (caught by the round-5
    # ladder: the deepcache point produced bit-identical images to plain
    # dpm); geometry/steps/guidance are still pinned by the explicit args
    base_spec = (spec or SampleSpec()).replace(
        height=img_size, width=img_size,
        num_inference_steps=inference_steps,
        guidance_scale=guidance_scale)

    rows = list(df_test.index)[: num_imgs]
    todo = [idx for idx in rows
            if not os.path.exists(os.path.join(save_dir, f"{idx}.jpg"))]
    generated = 0
    failed = []
    from PIL import Image

    for start in range(0, len(todo), batch_size):
        batch_ids = todo[start:start + batch_size]
        prompts = []
        for idx in batch_ids:
            row = df_test.loc[idx]
            author = str(row.get("book_authors", ""))
            title = str(row.get("book_title", ""))
            if prompt_bank == "reference":
                # reference FID prompts: inference.py:165-172 bank
                prompts.append(templates.reference_fid_prompt(
                    author, title, rng=rng))
            else:
                prompts.append(templates.format_training_prompt(
                    author, title, rng=rng))
        try:
            imgs = pipeline.generate(prompts, base_spec.replace(
                seed=seed + start))
            for idx, img in zip(batch_ids, imgs):
                arr = np.uint8(np.round(np.clip(img, 0, 1) * 255.0))
                # atomic write: a SIGKILL mid-save must not leave a
                # truncated <idx>.jpg that the file-count resume would
                # then skip (reference resumes the same way but writes
                # in place, inference.py:177-179)
                dst = os.path.join(save_dir, f"{idx}.jpg")
                tmp = dst + ".tmp"
                Image.fromarray(arr).save(tmp, format="JPEG")
                os.replace(tmp, dst)
                generated += 1
        except Exception:
            print(f"batch {batch_ids} failed:")
            traceback.print_exc()
            failed.extend(batch_ids)
        if verbose:
            print(f"\rFID images {already + generated}/{num_imgs}",
                  end="", flush=True)
    if verbose:
        print()
    if failed:
        raise RuntimeError(
            f"{len(failed)} of {len(todo)} FID images failed to generate "
            f"(first: {failed[:4]}); scoring the partial set would bias "
            "FID — re-run to retry the missing rows")
    return generated
