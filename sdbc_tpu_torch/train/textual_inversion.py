"""Textual inversion (counterpart of ``sdbc_tpu/train/textual_inversion.py``):
learned rows of the CLIP token-embedding table for a placeholder token.

``merge`` extends a copy of the text encoder's ``token_embedding`` by the
rows, cast to the table's dtype, so the placeholder ids (base vocab + k,
``data/tokenizer.py`` ``add_placeholder``) look up the learned rows; the
copy's config counts the appended rows and keeps pooling on the true
``<|endoftext|>`` id.  Files are the JAX package's ``sdbc_ti_v1`` ``.npz``
(rows, token, ids; ``rows2`` for a dual-encoder SDXL embedding, the
second encoder's rows at the same ids).  Training the rows is
``TrainConfig.ti_token`` (``train/trainer.py``, which appends them to the
frozen tables for each forward and backward).
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def init_rows(table, n_vectors: int, init_ids: Optional[List[int]] = None):
    """(n_vectors, hidden) fp32 rows seeded from the base table: the mean
    embedding of ``init_ids`` (an initializer word), else the table mean."""
    table = torch.as_tensor(table).float()
    seed = table[list(init_ids)].mean(dim=0) if init_ids else table.mean(0)
    return seed[None, :].repeat(n_vectors, 1)


@torch.no_grad()
def _extend_table(encoder, rows):
    te = copy.deepcopy(encoder)
    table = te.token_embedding.weight
    rows = torch.as_tensor(rows).to(table.device, table.dtype)
    te.token_embedding.weight = torch.nn.Parameter(
        torch.cat([table, rows], dim=0), requires_grad=table.requires_grad)
    cfg = te.cfg
    te.cfg = dataclasses.replace(
        cfg, vocab_size=cfg.vocab_size + rows.shape[0],
        eot_id=cfg.eot_id if cfg.eot_id is not None else cfg.vocab_size - 1)
    return te


def merge(models: dict, rows, rows2=None) -> dict:
    """``models`` with a copy of the text encoder whose embedding table is
    extended by ``rows``; the input untouched.  ``rows2`` (SDXL's second
    encoder) needs a ``text_encoder_2``."""
    if rows2 is not None and "text_encoder_2" not in models:
        raise ValueError("rows2 given but params carry no text_encoder_2 — "
                         "a dual-encoder embedding cannot merge into a "
                         "single-encoder model")
    out = dict(models)
    out["text_encoder"] = _extend_table(models["text_encoder"], rows)
    if rows2 is not None:
        out["text_encoder_2"] = _extend_table(models["text_encoder_2"],
                                              rows2)
    return out


# ---------------------------------------------------------------------------
# serialization: one portable .npz per learned embedding


def _np32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def save_ti(path: str, rows, token: str, ids: List[int],
            rows2=None) -> None:
    """``rows2``: the second encoder's rows of a dual-encoder (SDXL)
    embedding, in the same row order."""
    meta = json.dumps({"token": token, "ids": list(map(int, ids)),
                       "dual": rows2 is not None,
                       "format": "sdbc_ti_v1"})
    arrays = {"rows": _np32(rows),
              "__meta__": np.frombuffer(meta.encode(), np.uint8)}
    if rows2 is not None:
        arrays["rows2"] = _np32(rows2)
    np.savez(path, **arrays)


def load_ti(path: str) -> Tuple[torch.Tensor, dict]:
    """→ (rows fp32, {"token", "ids", ["rows2"], ...}); a dual-encoder file
    carries its second table's rows in ``meta["rows2"]``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        rows = torch.from_numpy(np.asarray(z["rows"], np.float32))
        if "rows2" in z:
            meta["rows2"] = torch.from_numpy(np.asarray(z["rows2"],
                                                        np.float32))
    if rows.ndim != 2 or len(meta.get("ids", ())) != rows.shape[0]:
        raise ValueError(f"malformed textual-inversion file {path}: "
                         f"rows {tuple(rows.shape)} vs ids {meta.get('ids')}")
    if "rows2" in meta and meta["rows2"].shape[0] != rows.shape[0]:
        raise ValueError(f"malformed textual-inversion file {path}: "
                         f"rows2 {tuple(meta['rows2'].shape)} disagrees with "
                         f"rows {tuple(rows.shape)} on the vector count")
    return rows, meta


def merge_file(models: dict, path: str) -> Tuple[dict, dict]:
    """Load ``path`` and merge → (models, meta).  Raises unless the ids
    continue the embedding table (base .. base + n − 1), and on a
    single-/dual-encoder mismatch between the file and the model."""
    rows, meta = load_ti(path)
    base = models["text_encoder"].token_embedding.weight.shape[0]
    want = list(range(base, base + rows.shape[0]))
    if list(meta["ids"]) != want:
        raise ValueError(
            f"textual-inversion ids {meta['ids']} do not continue this "
            f"model's embedding table (vocab {base}, expected {want}) — "
            "trained against a different base?")
    rows2 = meta.get("rows2")
    if rows2 is None and "text_encoder_2" in models:
        raise ValueError(
            "single-encoder textual-inversion file on a dual-encoder "
            "(SDXL) model — the second encoder would tokenize the "
            "placeholder into untrained rows; train with the SDXL family")
    if rows2 is not None and "text_encoder_2" in models:
        base2 = models["text_encoder_2"].token_embedding.weight.shape[0]
        if base2 != base:
            raise ValueError(
                f"the two encoders' vocabularies differ ({base} vs "
                f"{base2}) — the shared placeholder ids cannot index both "
                "appended row blocks")
    return merge(models, rows, rows2=rows2), meta


def extend_config(cfg, meta: dict):
    """The PipelineConfig of a model ``merge_file`` extended: each encoder
    that took rows counts them and keeps pooling on the base vocab's last
    id."""
    n = len(meta["ids"])

    def grown(clip):
        return dataclasses.replace(
            clip, vocab_size=clip.vocab_size + n,
            eot_id=clip.eot_id if clip.eot_id is not None
            else clip.vocab_size - 1)

    cfg = dataclasses.replace(cfg, clip=grown(cfg.clip))
    if "rows2" in meta and cfg.clip2 is not None:
        cfg = dataclasses.replace(cfg, clip2=grown(cfg.clip2))
    return cfg


def added_tokens_entry(meta: dict) -> Dict[str, List[int]]:
    """added_tokens.json payload for a loaded ti meta dict."""
    return {meta["token"]: list(map(int, meta["ids"]))}
