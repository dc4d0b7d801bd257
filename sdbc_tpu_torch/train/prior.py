"""Prior preservation (DreamBooth, arXiv:2208.12242), the data half
(counterpart of ``sdbc_tpu/train/prior.py``): a deterministic class-image
batcher whose batches ride alongside the instance loader
(``augment_loader``), and the self-generation of the class set
(``generate_class_images``, written as PNG by ``utils/png.py``: no PIL).
The loss weighting is ``TrainConfig.prior_weight`` (train/trainer.py).
"""
from __future__ import annotations

import os
import random
from typing import Iterator

import numpy as np

from sdbc_tpu_torch.utils.image import decode_and_prepare

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class PriorSet:
    """A directory of class images + ONE class prompt, tokenized once
    (with SDXL's ``tokenizer2`` also by the second tokenizer)."""

    def __init__(self, class_dir: str, class_prompt: str, tokenizer,
                 img_size: int, max_length: int = 77, tokenizer2=None):
        if not class_prompt:
            raise ValueError("prior preservation needs a class prompt "
                             "(e.g. 'a book cover')")
        self.class_dir = class_dir
        self.class_prompt = class_prompt
        self.img_size = img_size
        self.paths = sorted(
            os.path.join(class_dir, f) for f in os.listdir(class_dir)
            if f.lower().endswith(_IMG_EXTS)) \
            if os.path.isdir(class_dir) else []
        if not self.paths:
            raise ValueError(f"no class images under {class_dir} — "
                             "pre-generate them (generate_class_images / "
                             "--prior_generate) or point at an existing set")
        self.ids = np.asarray(tokenizer.encode(class_prompt, max_length),
                              np.int32)
        self.ids2 = (np.asarray(tokenizer2.encode(class_prompt, max_length),
                                np.int32)
                     if tokenizer2 is not None else None)

    def __len__(self) -> int:
        return len(self.paths)

    def batches(self, micro_batch: int, grad_accum: int = 1,
                seed: int = 42, mesh=None) -> Iterator[dict]:
        """Infinite deterministic stream of {"prior_pixel_values": (A, B,
        S, S, 3), "prior_input_ids": (A, B, ctx)[, "prior_input_ids_2"]}:
        the class set cycles in a seed-shuffled order reshuffled each
        pass.  With ``mesh``, ``micro_batch`` is the global one and each
        rank decodes only its rows, as ``data/dataset.make_dataloader``."""
        step = micro_batch * grad_accum
        rng = random.Random(seed)
        local_sel = None
        if mesh is not None:
            from sdbc_tpu_torch.parallel.mesh import host_local_batch_indices

            local_micro = host_local_batch_indices(micro_batch, mesh)
            local_sel = np.concatenate(
                [a * micro_batch + local_micro for a in range(grad_accum)])
            micro_batch = len(local_micro)

        def infinite_order():
            while True:
                order = list(range(len(self.paths)))
                rng.shuffle(order)
                yield from order

        it = infinite_order()
        while True:
            idxs = [next(it) for _ in range(step)]
            if local_sel is not None:
                idxs = [idxs[i] for i in local_sel]
            pixels = np.stack([decode_and_prepare(self.paths[i],
                                                  self.img_size)
                               for i in idxs])
            a = len(idxs) // micro_batch
            out = {"prior_pixel_values": pixels.reshape(
                       a, micro_batch, *pixels.shape[1:])}
            for key, ids in (("prior_input_ids", self.ids),
                             ("prior_input_ids_2", self.ids2)):
                if ids is not None:
                    out[key] = np.broadcast_to(
                        ids, (a, micro_batch, ids.shape[0])).copy()
            yield out


def augment_loader(loader: Iterator[dict],
                   prior_batches: Iterator[dict]) -> Iterator[dict]:
    """Merge a prior_* batch into every instance batch."""
    for batch in loader:
        merged = dict(batch)
        merged.update(next(prior_batches))
        yield merged


def generate_class_images(pipe, class_prompt: str, num_images: int,
                          out_dir: str, *, img_size: int = 512,
                          batch_size: int = 4, num_inference_steps: int = 50,
                          guidance_scale: float = 7.5, seed: int = 0,
                          log=print) -> int:
    """Top up ``out_dir`` to ``num_images`` class images with the base
    model (existing images count); returns how many were generated.  Batch
    k draws its latents from seed ``seed + <images already made>``; images
    are rounded to uint8 as the JAX package's ``numpy_to_pil`` rounds."""
    from sdbc_tpu_torch.utils import png

    os.makedirs(out_dir, exist_ok=True)
    have = sum(f.lower().endswith(_IMG_EXTS) for f in os.listdir(out_dir))
    made = 0
    while have + made < num_images:
        n = min(batch_size, num_images - have - made)
        imgs = pipe([class_prompt] * n, height=img_size, width=img_size,
                    num_inference_steps=num_inference_steps,
                    guidance_scale=guidance_scale, seed=seed + made)
        for im in imgs:
            # skip taken indices so existing images are never overwritten
            idx = have + made
            path = os.path.join(out_dir, f"class-{idx:05d}.png")
            while os.path.exists(path):
                idx += 1
                path = os.path.join(out_dir, f"class-{idx:05d}.png")
            with open(path, "wb") as f:
                f.write(png.encode(np.uint8(np.round(np.asarray(im)
                                                     * 255.0))))
            made += 1
        log(f"prior set: generated {made} class images "
            f"({have + made}/{num_images})")
    return made
