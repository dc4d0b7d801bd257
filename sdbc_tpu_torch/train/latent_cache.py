"""Dataset-level VAE latent cache for fine-tuning (counterpart of
``sdbc_tpu/train/latent_cache.py``, ``--cache_latents``).

The training VAE encode is deterministic and stop-gradient, so the
per-image posterior moments (mean, logvar) are computed once per dataset
and reused every epoch: training samples mean + exp(½·logvar)·eps with
fresh noise (``trainer.diffusion_loss``), minus the whole VAE forward.

Layout (under ``<data_root>/latent_cache/<fingerprint>/``):
  mean.npy / logvar.npy : float32 (N, H/8, W/8, latent_channels)
  meta.json             : fingerprint inputs + a VAE parameter checksum

Moments are computed in the training compute dtype and stored as float32
(a lossless widening of bf16); callers pass the weights the loss would
use, the compute-dtype-cast frozen VAE (``state.frozen["vae"]``).  The
checksum is this package's own (per-parameter sums of the module in its
order), so a cache directory opens only in the package that built it: the
JAX package's checksum over its tree names another directory.
"""
from __future__ import annotations

import concurrent.futures as cf
import glob
import hashlib
import json
import os
import shutil
import time
from typing import Optional, Tuple

import numpy as np
import torch

from sdbc_tpu_torch.models import vae as vae_mod


def _vae_checksum(vae: torch.nn.Module) -> str:
    """Cheap, order-stable content checksum of the VAE's parameters: the
    leaf count, then each parameter's float64 sum and size."""
    tensors = list(vae.state_dict().values())
    acc = hashlib.sha256()
    acc.update(str(len(tensors)).encode())
    for t in tensors:
        acc.update(np.array([t.double().sum().item(), t.numel()],
                            np.float64).tobytes())
    return acc.hexdigest()[:16]


def _fingerprint(dataset, compute_dtype) -> dict:
    cfg = dataset.cfg
    ids = ",".join(str(i) for i in dataset.index)
    return {
        "n": len(dataset),
        "img_size": cfg.img_size,
        "csv_name": cfg.csv_name,
        "index_hash": hashlib.sha256(ids.encode()).hexdigest()[:16],
        "compute_dtype": str(compute_dtype).removeprefix("torch."),
    }


def cache_dir_for(dataset, vae, compute_dtype,
                  root: Optional[str] = None) -> Tuple[str, dict]:
    meta = _fingerprint(dataset, compute_dtype)
    meta["vae_checksum"] = _vae_checksum(vae)
    key = hashlib.sha256(
        json.dumps(meta, sort_keys=True).encode()).hexdigest()[:16]
    base = root or os.path.join(dataset.cfg.data_root, "latent_cache")
    return os.path.join(base, key), meta


@torch.no_grad()
def _encode(vae, pixels: np.ndarray, compute_dtype):
    """Moments of one batch, as ``trainer.diffusion_loss`` encodes (the
    per-image encode at the shapes ``prefer_chunked_encode`` names)."""
    dev = next(vae.parameters()).device
    px = torch.from_numpy(pixels).to(dev, compute_dtype)
    if vae_mod.prefer_chunked_encode(*px.shape[:3]):
        mean, logvar = vae_mod.encode_moments_chunked(vae, px)
    else:
        mean, logvar = vae_mod.encode_moments(vae, px)
    return mean.float().cpu().numpy(), logvar.float().cpu().numpy()


def _sweep_orphans(path: str) -> None:
    """Remove tmp dirs of dead processes untouched for an hour."""
    for stale in glob.glob(f"{path}.tmp.*"):
        try:
            os.kill(int(stale.rsplit(".", 1)[1]), 0)
            continue  # a live local process
        except ValueError:
            continue  # not our naming scheme
        except PermissionError:
            continue  # alive under another uid
        except ProcessLookupError:
            pass
        try:
            newest = max((os.path.getmtime(os.path.join(stale, f))
                          for f in os.listdir(stale)), default=0.0)
            if time.time() - newest > 3600:
                shutil.rmtree(stale, ignore_errors=True)
        except OSError:
            pass


def build_latent_cache(dataset, vae, compute_dtype, batch: int = 8,
                       root: Optional[str] = None, num_workers: int = 4,
                       verbose: bool = True) -> str:
    """Encode every dataset image once; returns the cache directory.
    Idempotent: a directory with a matching meta.json is reused.  Built in
    a private tmp dir, then renamed into place.  Under
    ``torch.distributed`` (a shared filesystem) rank 0 builds it and the
    other ranks wait for it at a barrier."""
    import torch.distributed as dist

    from sdbc_tpu_torch.parallel import comm

    path, meta = cache_dir_for(dataset, vae, compute_dtype, root)
    if dist.is_initialized():
        if dist.get_rank() == 0:
            try:
                _build(dataset, vae, compute_dtype, batch, path, meta,
                       num_workers, verbose)
            finally:
                comm.barrier()
            return path
        comm.barrier()
        if not _hit_dir(path, meta):
            raise RuntimeError(f"rank 0 built no latent cache at {path}")
        return path
    return _build(dataset, vae, compute_dtype, batch, path, meta,
                  num_workers, verbose)


def _build(dataset, vae, compute_dtype, batch, path, meta, num_workers,
           verbose) -> str:
    from sdbc_tpu_torch.data.dataset import decode_pixels

    if _hit_dir(path, meta):
        if verbose:
            print(f"latent cache hit: {path}")
        return path
    _sweep_orphans(path)
    final_path, path = path, f"{path}.tmp.{os.getpid()}"
    os.makedirs(path, exist_ok=True)

    n = len(dataset)
    f = 2 ** (len(vae.cfg.block_out_channels) - 1)
    hw = dataset.cfg.img_size // f
    shape = (n, hw, hw, vae.cfg.latent_channels)
    mean_mm = np.lib.format.open_memmap(os.path.join(path, "mean.npy"),
                                        mode="w+", dtype=np.float32,
                                        shape=shape)
    logvar_mm = np.lib.format.open_memmap(os.path.join(path, "logvar.npy"),
                                          mode="w+", dtype=np.float32,
                                          shape=shape)

    def load_pixels(indices):
        return decode_pixels(dataset, indices, num_workers)

    with cf.ThreadPoolExecutor(max_workers=1) as prefetcher:
        future = None
        for start in range(0, n, batch):
            idxs = list(range(start, min(start + batch, n)))
            if future is None:
                future = prefetcher.submit(load_pixels, idxs)
            pixels = future.result()
            if start + batch < n:
                future = prefetcher.submit(load_pixels, list(
                    range(start + batch, min(start + 2 * batch, n))))
            # the tail padded to the batch: one encode shape throughout
            pad = batch - len(idxs)
            if pad:
                pixels = np.concatenate(
                    [pixels, np.repeat(pixels[-1:], pad, axis=0)])
            mean, logvar = _encode(vae, pixels, compute_dtype)
            mean_mm[idxs] = mean[: len(idxs)]
            logvar_mm[idxs] = logvar[: len(idxs)]
            if verbose and (start // batch) % 50 == 0:
                print(f"latent cache: {min(start + batch, n)}/{n}",
                      flush=True)
    mean_mm.flush()
    logvar_mm.flush()
    with open(os.path.join(path, "meta.json"), "w") as f_:
        json.dump(meta, f_, sort_keys=True)
    del mean_mm, logvar_mm
    try:
        os.rename(path, final_path)
    except OSError:
        # a concurrent process renamed first (the same content: the
        # directory key is the whole fingerprint)
        if not _hit_dir(final_path, meta):
            raise
        shutil.rmtree(path, ignore_errors=True)
    if verbose:
        print(f"latent cache built: {final_path}")
    return final_path


def _hit_dir(path: str, meta: dict) -> bool:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return False
    with open(meta_path) as f:
        return json.load(f) == meta


def open_latent_cache(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Memory-mapped (mean, logvar) arrays."""
    mean = np.load(os.path.join(path, "mean.npy"), mmap_mode="r")
    logvar = np.load(os.path.join(path, "logvar.npy"), mmap_mode="r")
    return mean, logvar
