"""Image helpers (counterpart of ``sdbc_tpu/utils/image.py``): grid
rendering, dtype/range conversion, and the separable resize that
``jax.image.resize`` computes.

``resize`` is JAX's ``scale_and_translate`` written out: one weight matrix
per resized axis (the Keys cubic kernel with a = −0.5, or the triangle
kernel, widened by the down-scale factor when antialiasing, each column
renormalised to sum to 1), applied with one ``tensordot`` per axis.
``F.interpolate(mode="bicubic")`` is a different resize (a = −0.75, edge
replication, no renormalisation), 0.30 apart on a 64²→128² latent
upsample, so it is not used.  Bilinear goes through the same weight
matrices, so the FID input resize (512²→299², antialiased) is JAX's too.

PIL is imported only where files are read or images pasted.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def image_grid(imgs, rows: int, cols: int):
    """Paste PIL images into a rows x cols grid (reference finetune_sd.py:51-60)."""
    from PIL import Image

    assert len(imgs) == rows * cols, f"need {rows * cols} images, got {len(imgs)}"
    w, h = imgs[0].size
    grid = Image.new("RGB", size=(cols * w, rows * h))
    for i, img in enumerate(imgs):
        grid.paste(img, box=(i % cols * w, i // cols * h))
    return grid


def to_uint8(x) -> torch.Tensor:
    """[0,1] float image -> uint8, rounding half to even like ``jnp.round``."""
    x = torch.as_tensor(x)
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def normalize_to_pm1(x) -> torch.Tensor:
    """uint8/float [0,255] image -> float32 in [-1, 1] (reference utils.py:143)."""
    return torch.as_tensor(np.asarray(x, np.float32)) / 127.5 - 1.0


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f = np.float32
    out = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    out = np.where(x >= 1.0, ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x
                   + f(2.0), out)
    return np.where(x >= 2.0, f(0.0), out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int, method: str,
                  antialias: bool = True) -> np.ndarray:
    """(n_in, n_out) float32 resampling weights of one axis, computed in
    float32 step by step as ``jax.image.scale_and_translate`` builds them
    for a plain resize (the scale is a float32 ``n_out / n_in``)."""
    f32 = np.float32
    kernel = _KERNELS[method]
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale)
    w = kernel(x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in) - f32(0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize(x, shape, method: str = "bicubic",
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for ``method`` in
    bicubic/bilinear: every axis whose size changes is resampled by its
    weight matrix.  ``x`` is a tensor (any device) or an array; the result
    is a floating tensor on ``x``'s device."""
    if method not in _KERNELS:
        raise ValueError(f"resize method {method!r}: only "
                         f"{sorted(_KERNELS)} are ported")
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.float()
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} must have one entry per "
                         f"dimension of x {tuple(x.shape)}")
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.from_numpy(weight_matrix(n_in, int(n_out), method,
                                           antialias)).to(x.device, x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


def resize_bicubic(img, size_hw) -> torch.Tensor:
    """Bicubic resize of an HWC or NHWC image, as the JAX package's
    ``resize_bicubic`` (reference uses PIL BICUBIC, utils.py:131)."""
    h, w = size_hw
    img = torch.as_tensor(img)
    if img.ndim == 3:
        return resize(img, (h, w, img.shape[-1]))
    return resize(img, (img.shape[0], h, w, img.shape[-1]))


def decode_and_prepare(path: str, size: int = 512) -> np.ndarray:
    """Host-side: JPEG open -> RGB -> bicubic resize -> [-1,1] float32 HWC.

    Mirrors CustomDataset.__getitem__ preprocessing (reference utils.py:119-146)
    and emits NHWC, as the JAX package does.
    """
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BICUBIC)
        arr = np.asarray(im, dtype=np.float32)
    return arr / 127.5 - 1.0
