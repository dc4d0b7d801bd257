"""Goodreads book-cover dataset + host input pipeline (counterpart of
``sdbc_tpu/data/dataset.py``, one device: no ``mesh``).

CSV-driven example list; per-example image decode → RGB → bicubic resize
to img_size² → [-1,1] float32 (NHWC) → random training-template prompt
(optional legible-text suffix w.p. ``legible_text_prob``, optional
description) → CLIP ids padded to ``max_length``.

The CSV is read with the standard library's ``csv`` (no pandas) with the
semantics of ``pd.read_csv(index_col=0)`` for what the dataset uses:
pandas' default missing-value strings (the empty field, "NA", "nan", ...)
are NaN, and a column whose every value parses as an integer (float,
boolean) holds integers (floats, booleans), an integer column with a
missing value floats.  So the index renders as pandas renders it ("007"
→ ``7.jpg``), an empty author or title becomes "nan" through
``str(...)``, and a description is used only when it is a string.

Prompt draws are keyed on (seed, idx, epoch or per-index visit) through
``random.Random(hash(...))``, as in the JAX package (a tuple of ints
hashes the same in every process).  The loader decodes on a thread pool
with one batch of look-ahead and yields fixed-shape (grad_accum, micro,
...) numpy batches.
"""
from __future__ import annotations

import concurrent.futures as cf
import csv
import dataclasses
import os
import random
import re
import threading
from typing import Iterator, List, Optional

import numpy as np

from sdbc_tpu_torch.data import templates
from sdbc_tpu_torch.utils.image import decode_and_prepare, is_png

# pandas' default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_INT = re.compile(r"^\s*[+-]?\d+\s*$")
_TRUE = {"True", "TRUE", "true"}
_FALSE = {"False", "FALSE", "false"}


def _as_float(s: str):
    if "_" in s:
        return None
    try:
        return float(s)
    except ValueError:
        return None


def _column(raw: List[str]) -> list:
    """One CSV column's values as ``pd.read_csv`` types them."""
    na = [v in NA_VALUES for v in raw]
    vals = [v for v, m in zip(raw, na) if not m]
    nan = float("nan")
    if vals and all(_INT.match(v) for v in vals):
        if any(na):
            return [nan if m else float(int(v)) for v, m in zip(raw, na)]
        return [int(v) for v in raw]
    if vals and all(_as_float(v) is not None for v in vals):
        return [nan if m else _as_float(v) for v, m in zip(raw, na)]
    if vals and not any(na) and all(v in _TRUE or v in _FALSE
                                    for v in vals):
        return [v in _TRUE for v in raw]
    return [nan if m else v for v, m in zip(raw, na)]


def read_csv(path: str):
    """(index, columns): ``pd.read_csv(path, index_col=0)``'s index values
    and {column name: values}, typed by ``_column``."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    header, body = rows[0], rows[1:]
    width = len(header)
    for i, r in enumerate(body):
        if len(r) != width:
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, the "
                             f"header {width}")
    cols = [_column([r[j] for r in body]) for j in range(width)]
    return cols[0], {name: cols[j] for j, name in enumerate(header)
                     if j > 0}


def read_csv_rows(path: str) -> list:
    """``read_csv``'s table as [(index value, {column: value})] in file
    order: ``pd.read_csv(path, index_col=0).iterrows()`` without
    pandas."""
    index, cols = read_csv(path)
    return [(idx, {name: col[i] for name, col in cols.items()})
            for i, idx in enumerate(index)]


@dataclasses.dataclass
class DatasetConfig:
    data_root: str = "./"
    csv_name: str = "df_train.csv"
    img_size: int = 512                 # reference utils.py:74
    size: Optional[int] = None          # cap on examples (training_size)
    legible_text_prob: float = 0.1      # reference utils.py:87
    include_desc: bool = False
    max_length: int = 77
    seed: int = 42
    use_native: bool = True  # C++ decode core when built (native/loader.cc)
    # "native" or "reference" (byte-exact reference strings, templates.py)
    prompt_bank: str = "native"
    # textual inversion: a registered placeholder appended to every
    # training prompt as ", in the style of <tok>"
    style_token: str = ""


class GoodreadsDataset:
    """The preprocessed Goodreads cover CSV: image paths and prompts by
    index (``make_dataloader`` decodes and batches them)."""

    def __init__(self, cfg: DatasetConfig, tokenizer, tokenizer2=None):
        """``tokenizer2``: SDXL's second (bigG) tokenizer; when set, every
        batch also carries ``input_ids_2``, the same prompt through it."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.tokenizer2 = tokenizer2
        index, self.columns = read_csv(os.path.join(cfg.data_root,
                                                    cfg.csv_name))
        self.index = index
        if cfg.size is not None:
            if cfg.size > len(index):
                print(f"WARNING: requested {cfg.size} examples but the "
                      f"dataset has {len(index)}; using all of them")
            self.index = index[: cfg.size]
        self.image_dir = os.path.join(cfg.data_root, "images", "images")
        self._visit_lock = threading.Lock()
        self._visit_counts: dict = {}
        self._epoch: Optional[int] = None

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Key prompt draws on (seed, idx, epoch) instead of the per-process
        visit count (``make_dataloader(epoch=...)`` calls this)."""
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.index)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.image_dir, f"{self.index[idx]}.jpg")

    def row(self, idx: int) -> dict:
        return {name: col[idx] for name, col in self.columns.items()}

    def _prompt_rng(self, idx: int) -> random.Random:
        if self._epoch is not None:
            visit = self._epoch
        else:
            with self._visit_lock:
                visit = self._visit_counts.get(idx, 0)
                self._visit_counts[idx] = visit + 1
        return random.Random(hash((self.cfg.seed, idx, visit)))

    def prompt_for(self, idx: int, rng: Optional[random.Random] = None) -> str:
        row = self.row(idx)
        desc = None
        if self.cfg.include_desc and isinstance(row.get("book_desc"), str):
            desc = row["book_desc"]
        author = str(row.get("book_authors", ""))
        title = str(row.get("book_title", ""))
        if rng is None:
            rng = self._prompt_rng(idx)
        if self.cfg.prompt_bank == "reference":
            prompt = templates.format_reference_training_prompt(
                author, title, desc=desc, rng=rng,
                legible_text_prob=self.cfg.legible_text_prob,
                include_desc=self.cfg.include_desc)
        else:
            prompt = templates.format_training_prompt(
                author, title, desc=desc, rng=rng,
                legible_text_prob=self.cfg.legible_text_prob)
        if self.cfg.style_token:
            prompt = f"{prompt}, in the style of {self.cfg.style_token}"
        return prompt


def decode_pixels(dataset: GoodreadsDataset, indices, num_workers: int = 4,
                  pool=None) -> np.ndarray:
    """Decode dataset images → (N, S, S, 3) float32 in [-1, 1].

    The one pixel-decode dispatch shared by ``make_dataloader`` and the
    latent-cache build: JPEGs through the native library when it builds
    (``cfg.use_native``), PNGs (whatever their file name) through
    ``utils/png.py``, the rest through PIL (``pool``: an optional thread
    pool for that path)."""
    from sdbc_tpu_torch.data import native_loader

    size = dataset.cfg.img_size
    paths = [dataset.image_path(i) for i in indices]
    out = np.empty((len(paths), size, size, 3), np.float32)
    rest = list(range(len(paths)))
    if dataset.cfg.use_native and native_loader.available():
        png = {i for i in rest if is_png(paths[i])}
        jpeg = [i for i in rest if i not in png]
        if jpeg:
            out[jpeg] = native_loader.decode_batch(
                [paths[i] for i in jpeg], size, threads=num_workers)
        rest = sorted(png)

    def one(i):
        try:
            return decode_and_prepare(paths[i], size)
        except ImportError as e:
            raise RuntimeError(
                f"{paths[i]}: no decoder: the native loader did not build "
                f"({native_loader.unavailable_reason()}) and PIL is not "
                "installed") from e

    mapper = pool.map if pool is not None else map
    for i, img in zip(rest, mapper(one, rest)):
        out[i] = img
    return out


def make_dataloader(dataset: GoodreadsDataset, micro_batch: int,
                    grad_accum: int = 1, shuffle: bool = True,
                    seed: int = 42, num_workers: int = 4,
                    drop_last: bool = True, latent_cache=None,
                    epoch: Optional[int] = None, mesh=None
                    ) -> Iterator[dict]:
    """Yield {"pixel_values": (A, B, H, W, 3) float32, "input_ids": (A, B,
    77) int32} numpy batches (with the dataset's ``tokenizer2`` also
    "input_ids_2", each prompt drawn once and encoded by both); with
    ``latent_cache`` ((mean, logvar) arrays
    of ``train.latent_cache.open_latent_cache``) "latent_mean" /
    "latent_logvar" instead of pixels.  Thread-pool decode with one-batch
    look-ahead.  ``epoch`` keys the prompt draws (``set_epoch``).

    With ``mesh`` (``parallel.make_mesh``), ``micro_batch`` stays the
    GLOBAL micro-batch and each rank loads only its rows of it
    (``host_local_batch_indices``): the same order and, with ``epoch``,
    the same per-index prompt draws as the one-process loader, B being
    the rank's share."""
    dataset.set_epoch(epoch)
    step = micro_batch * grad_accum
    order = list(range(len(dataset)))
    rng = random.Random(seed)
    if shuffle:
        rng.shuffle(order)
    n_batches = len(order) // step if drop_last else -(-len(order) // step)
    local_sel, mb = None, micro_batch
    if mesh is not None:
        from sdbc_tpu_torch.parallel.mesh import host_local_batch_indices

        local_micro = host_local_batch_indices(micro_batch, mesh)
        local_sel = np.concatenate(
            [a * micro_batch + local_micro for a in range(grad_accum)])
        mb = len(local_micro)

    def load_batch(batch_indices):
        if local_sel is not None:
            batch_indices = [batch_indices[i] for i in local_sel]
        prompts = [dataset.prompt_for(i) for i in batch_indices]

        def encode(tok):
            return np.stack([np.asarray(tok.encode(pr, dataset.cfg.max_length),
                                        np.int32) for pr in prompts])

        if latent_cache is not None:
            cmean, clogvar = latent_cache
            idx = np.asarray(batch_indices)
            payload = {"latent_mean": np.ascontiguousarray(cmean[idx]),
                       "latent_logvar": np.ascontiguousarray(clogvar[idx])}
        else:
            payload = {"pixel_values": decode_pixels(
                dataset, batch_indices, num_workers, pool=pil_pool)}
        payload["input_ids"] = encode(dataset.tokenizer)
        if dataset.tokenizer2 is not None:
            payload["input_ids_2"] = encode(dataset.tokenizer2)
        a = len(batch_indices) // mb
        return {k: v.reshape(a, mb, *v.shape[1:])
                for k, v in payload.items()}

    def pad_to_step(idxs):
        while len(idxs) < step:
            idxs = idxs + order[: step - len(idxs)]
        return idxs

    with cf.ThreadPoolExecutor(max_workers=1) as prefetcher, \
            cf.ThreadPoolExecutor(max_workers=num_workers) as pil_pool:
        future = None
        for b in range(n_batches):
            if future is None:
                future = prefetcher.submit(
                    load_batch, pad_to_step(order[b * step:(b + 1) * step]))
            batch = future.result()
            if b + 1 < n_batches:
                future = prefetcher.submit(
                    load_batch,
                    pad_to_step(order[(b + 1) * step:(b + 2) * step]))
            yield batch

