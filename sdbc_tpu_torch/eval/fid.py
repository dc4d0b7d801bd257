"""FID: InceptionV3 pool3 activations + Fréchet distance (counterpart of
``sdbc_tpu/eval/fid.py``).

  - activations come from ``models.inception`` in fixed-size batches on
    the extractor's device (the reference uses batches of 50 through a TF
    session, fid.py:91-103); the last short batch is zero-padded and the
    pad rows sliced off, instead of being dropped (the reference's
    remainder bug, fid.py:90-91, is not copied);
  - statistics over image files stream with float64 running moments;
  - the Fréchet distance is computed on the host in float64 with symmetric
    eigendecompositions, tr sqrt(Σ1 Σ2) = tr sqrt(S Σ2 S), S = sqrtm(Σ1)
    by eigh, with the reference's eps-on-diagonal retry (fid.py:143-152);
  - ``_handle_path``: an image directory or a precomputed .npz{mu, sigma}
    file (fid.py:288-302).
"""
from __future__ import annotations

import functools
import os
import pathlib
import sys
from typing import Tuple

import numpy as np

from sdbc_tpu_torch.models import inception as inception_mod


# ---------------------------------------------------------------------------
# activations


def get_activations(images: np.ndarray, model, batch_size: int = 50,
                    verbose: bool = False) -> np.ndarray:
    """images: (N, H, W, 3) RGB in [0, 255] → (N, C) pool3 features
    (float32, host).  Fixed-size batches: the final short batch is
    zero-padded and the pad rows sliced off."""
    n = images.shape[0]
    out = []
    for start in range(0, n, batch_size):
        chunk = np.asarray(images[start:start + batch_size])
        valid = chunk.shape[0]
        if valid < batch_size:
            pad = np.zeros((batch_size - valid,) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        feats = inception_mod.features(model, chunk)
        out.append(feats[:valid].cpu().numpy())
        if verbose:
            print(f"\rFID activations {start + valid}/{n}", end="", flush=True)
    if verbose:
        print()
    return np.concatenate(out, axis=0)


def calculate_activation_statistics(images: np.ndarray, model,
                                    batch_size: int = 50,
                                    verbose: bool = False):
    acts = get_activations(images, model, batch_size, verbose)
    return np.mean(acts, axis=0), np.cov(acts, rowvar=False)


def activation_statistics_from_files(files, model, batch_size: int = 50,
                                     image_size: int = 512,
                                     verbose: bool = False):
    """Streaming mu/sigma over image files without holding all images in
    RAM: float64 running sums of the activations and their outer
    products."""
    from sdbc_tpu_torch.utils.image import decode_and_prepare

    count = 0
    s1 = s2 = None
    files = list(files)

    def flush(batch):
        nonlocal count, s1, s2
        if not batch:
            return
        imgs = (np.stack(batch) + 1.0) * 127.5  # [-1,1] → [0,255]
        acts = get_activations(imgs, model, batch_size=batch_size)
        acts64 = acts.astype(np.float64)
        if s1 is None:
            dim = acts64.shape[1]
            s1 = np.zeros((dim,), np.float64)
            s2 = np.zeros((dim, dim), np.float64)
        count += acts.shape[0]
        s1 += acts64.sum(axis=0)
        s2 += acts64.T @ acts64

    batch = []
    for i, f in enumerate(files):
        batch.append(decode_and_prepare(str(f), image_size))
        if len(batch) == batch_size:
            flush(batch)
            batch = []
            if verbose:
                print(f"\rFID stats {i + 1}/{len(files)}", end="", flush=True)
    flush(batch)
    if verbose:
        print()
    if count < 2:
        raise ValueError(
            f"need at least 2 images for FID statistics, got {count} "
            "(check the data path / file extensions)")
    mu = s1 / count
    sigma = (s2 - count * np.outer(mu, mu)) / (count - 1)
    return mu, sigma


# ---------------------------------------------------------------------------
# Fréchet distance


def _trace_sqrt_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr sqrt(Σ1 Σ2) via symmetric eigendecompositions (all-real path)."""
    w, v = np.linalg.eigh(sigma1)
    w = np.clip(w, 0.0, None)
    s = (v * np.sqrt(w)) @ v.T
    # M = S Σ2 S is symmetric PSD with eig(M) = eig(Σ1 Σ2)
    m = s @ sigma2 @ s
    m = (m + m.T) / 2.0
    ev = np.clip(np.linalg.eigvalsh(m), 0.0, None)
    return float(np.sum(np.sqrt(ev)))


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """||mu1-mu2||² + tr(Σ1 + Σ2 - 2 sqrt(Σ1 Σ2)), with the reference's
    eps-diagonal retry for near-singular covariances (fid.py:111-162)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    try:
        tr_sqrt = _trace_sqrt_product(sigma1, sigma2)
        if not np.isfinite(tr_sqrt):
            raise FloatingPointError("non-finite trace")
    except (np.linalg.LinAlgError, FloatingPointError):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_sqrt = _trace_sqrt_product(sigma1 + offset, sigma2 + offset)

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * tr_sqrt)


# ---------------------------------------------------------------------------
# path handling + top-level API (reference fid.py:288-319)


_IMG_EXTS = (".jpg", ".jpeg", ".png")


def _list_images(path: str):
    return sorted(p for p in pathlib.Path(path).iterdir()
                  if p.suffix.lower() in _IMG_EXTS)


def _handle_path(path: str, model, batch_size: int = 50,
                 image_size: int = 512, verbose: bool = False):
    """``model`` may be a zero-arg callable, resolved only for image dirs
    (two .npz stats need no Inception weights)."""
    if str(path).endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    files = _list_images(path)
    if not files:
        raise RuntimeError(f"no images found in {path}")
    if callable(model) and not isinstance(model, inception_mod.Inception):
        model = model()
    return activation_statistics_from_files(files, model, batch_size,
                                            image_size, verbose)


def calculate_fid_given_paths(paths: Tuple[str, str], model=None, cfg=None,
                              batch_size: int = 50, image_size: int = 512,
                              verbose: bool = False,
                              device="cuda") -> float:
    """FID between two paths (image dirs or precomputed .npz stats).

    ``model``: an ``Inception`` module or a zero-arg callable returning one,
    resolved once and only if an image dir is present; None resolves
    ``default_params(cfg, device)``."""
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    if model is None:
        model = functools.partial(default_params,
                                  cfg or inception_mod.InceptionConfig.fid(),
                                  device=device)
    if not isinstance(model, inception_mod.Inception):
        model = functools.lru_cache(maxsize=1)(model)  # resolve once
    m1, s1 = _handle_path(paths[0], model, batch_size, image_size, verbose)
    m2, s2 = _handle_path(paths[1], model, batch_size, image_size, verbose)
    return calculate_frechet_distance(m1, s1, m2, s2)


_WEIGHTS_ENV = "SDBC_INCEPTION_WEIGHTS"


def default_params(cfg=None, device="cuda") -> inception_mod.Inception:
    """The Inception extractor on ``device``.

    SDBC_INCEPTION_WEIGHTS may point at:
      - pt_inception-2015-12-05-*.pth (pytorch-fid's port of the reference's
        frozen TF graph, fid.py:273) → numeric FID parity with the reference;
      - a .npz of that state dict (pytorch-fid key names);
      - a .npz in the JAX package's flat tree format (``inception.save_npz``;
        a JAX-written one loads directly).
    Unset → random weights from ``torch.Generator`` seed 2015, with a
    warning: FID deltas only, and not comparable with the JAX package's
    random init (a FID is comparable across packages only with one weights
    file)."""
    cfg = cfg or inception_mod.InceptionConfig.fid()
    path = os.environ.get(_WEIGHTS_ENV, "")
    if path and os.path.exists(path):
        from sdbc_tpu_torch.models.port import (load_fid_inception,
                                                port_fid_inception)

        if path.endswith((".pth", ".pt")):
            tree = load_fid_inception(path)
        else:
            with np.load(path) as flat:
                pt_keys = any(k.startswith("Conv2d_1a") for k in flat.files)
                tree = (port_fid_inception(dict(flat)) if pt_keys
                        else None)
            if tree is None:
                tree = inception_mod.load_npz(path)
        return inception_mod.from_tree(tree, cfg, device=device)
    import torch

    print(
        "WARNING: SDBC_INCEPTION_WEIGHTS is unset — using RANDOM Inception "
        "weights (torch.Generator seed 2015).  FID values are "
        "self-consistent deltas only and are NOT comparable to any "
        "published or reference statistic, nor to the JAX package's random "
        "init: a FID compares across packages only with the same weights "
        "file.  Point SDBC_INCEPTION_WEIGHTS at pt_inception-2015-12-05-*.pth "
        "(or a ported .npz) for real FID.", file=sys.stderr, flush=True)
    gen = torch.Generator(device=device).manual_seed(2015)
    return inception_mod.init(cfg, generator=gen, device=device)
