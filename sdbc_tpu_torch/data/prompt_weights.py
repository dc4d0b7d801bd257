"""Weighted-prompt parsing and long-prompt chunked encoding (a copy of
``sdbc_tpu/data/prompt_weights.py``, numpy only; the tests hold the two to
the same output on one tokenizer).

Community prompt-emphasis syntax (the A1111/compel convention — a serving
capability of every production SD stack; the reference's diffusers-0.7.2
engine predates it, so this is a beyond-reference surface):

  ``(text)``        attention to ``text`` is multiplied by 1.1
  ``((text))``      nested: 1.1 * 1.1
  ``[text]``        divided by 1.1
  ``(text:1.4)``    explicit multiplier (applies to the whole group)
  ``\\(literal\\)`` escaped brackets are literal characters

Weights multiply the CLIP hidden states token-wise AFTER encoding, then the
per-sample mean is restored (diffusion/graph.py:_apply_token_weights) so
the overall conditioning magnitude — which the UNet was trained against —
is preserved while the relative emphasis shifts.

Long prompts: CLIP's context is 77 tokens; prompts beyond 75 content tokens
are split into consecutive 75-token windows, each encoded independently with
its own BOS/EOS (the position table and the causal mask are per-window), and
the windows concatenated along the sequence axis for cross-attention — the
standard community chunking scheme.  Cross-attention is length-agnostic, so
the UNet consumes the 77*k context unchanged.

This parser is an original implementation of the published *syntax*; it
shares no code with any webui.
"""
from __future__ import annotations

import math
import re
from typing import List, Sequence, Tuple

import numpy as np

_EMPHASIS_UP = 1.1  # the conventional step for one level of ()/[]

_NUM_CLOSE = re.compile(r"\s*([+-]?(?:\d+(?:\.\d*)?|\.\d+))\s*\)")


def parse_weighted_prompt(text: str) -> List[Tuple[str, float]]:
    """``"a ((big)) cat:"`` → ``[("a ", 1.0), ("big", 1.21), (" cat:", 1.0)]``.

    Returns (fragment, weight) pairs covering the input in order, with
    adjacent equal-weight fragments merged.  Unbalanced brackets degrade
    gracefully: an unmatched opener applies its default multiplier to the
    rest of the prompt; an unmatched closer is a literal character.
    """
    frags: List[List] = []  # [text, weight]
    round_open: List[int] = []   # index into frags where each '(' opened
    square_open: List[int] = []
    buf: List[str] = []

    def flush():
        if buf:
            frags.append(["".join(buf), 1.0])
            buf.clear()

    def scale(start: int, mult: float):
        for f in frags[start:]:
            f[1] *= mult

    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\\" and i + 1 < n and text[i + 1] in "()[]\\:":
            buf.append(text[i + 1])
            i += 2
        elif c == "(":
            flush()
            round_open.append(len(frags))
            i += 1
        elif c == "[":
            flush()
            square_open.append(len(frags))
            i += 1
        elif c == ")" and round_open:
            flush()
            scale(round_open.pop(), _EMPHASIS_UP)
            i += 1
        elif c == "]" and square_open:
            flush()
            scale(square_open.pop(), 1.0 / _EMPHASIS_UP)
            i += 1
        elif c == ":" and round_open:
            m = _NUM_CLOSE.match(text, i + 1)
            if m:  # "(group:1.4)" — explicit weight closes the group
                flush()
                scale(round_open.pop(), float(m.group(1)))
                i = m.end()  # .end() is absolute (match(text, pos))
            else:  # ordinary colon inside a group
                buf.append(c)
                i += 1
        else:  # includes unmatched ')' / ']' → literal
            buf.append(c)
            i += 1
    flush()
    # unclosed groups apply to everything after their opener
    for start in round_open:
        scale(start, _EMPHASIS_UP)
    for start in square_open:
        scale(start, 1.0 / _EMPHASIS_UP)

    merged: List[Tuple[str, float]] = []
    for t, w in frags:
        if merged and math.isclose(merged[-1][1], w):
            merged[-1] = (merged[-1][0] + t, merged[-1][1])
        else:
            merged.append((t, w))
    return merged or [("", 1.0)]


def encode_weighted(tokenizer, text: str, ctx: int = 77,
                    max_chunks: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize a weighted prompt into ``k`` chunked windows.

    Returns ``(ids, weights)`` of shape ``(k * ctx,)`` where
    ``k = ceil(content_tokens / (ctx - 2))`` clipped to ``[1, max_chunks]``
    (content beyond ``max_chunks`` windows is truncated — the analogue of
    the single-window truncation at 75 tokens).  Each window carries its own
    BOS/EOS/pad (weight 1.0 — specials were never emphasised).

    The fragments are tokenized independently; CLIP's BPE closes every word
    with ``</w>``, so splitting at the whitespace boundaries emphasis
    naturally falls on reproduces the unsplit token stream (mid-word
    emphasis re-segments that word, same as every implementation of this
    syntax).
    """
    ids: List[int] = []
    ws: List[float] = []
    for frag, w in parse_weighted_prompt(text):
        tid = tokenizer._token_ids(frag)
        ids.extend(tid)
        ws.extend([w] * len(tid))
    body = ctx - 2
    k = max(1, min(max_chunks, -(-len(ids) // body) if ids else 1))
    ids, ws = ids[:k * body], ws[:k * body]
    out_ids = np.full((k, ctx), tokenizer.pad_id, np.int32)
    out_w = np.ones((k, ctx), np.float32)
    for c in range(k):
        seg, sw = ids[c * body:(c + 1) * body], ws[c * body:(c + 1) * body]
        out_ids[c, 0] = tokenizer.bot_id
        out_ids[c, 1:1 + len(seg)] = seg
        out_ids[c, 1 + len(seg)] = tokenizer.eot_id
        out_w[c, 1:1 + len(sw)] = sw
    return out_ids.reshape(-1), out_w.reshape(-1)


def batch_encode_weighted(tokenizer, texts: Sequence[str], ctx: int = 77,
                          max_chunks: int = 3,
                          min_chunks: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Batch version; every row is padded to the batch's max chunk count
    with empty windows (BOS+EOS+pad, weight 1) so the array is rectangular.
    ``min_chunks`` lets the caller force a common width across SEPARATE
    batches (the CFG cond/uncond pair must agree on sequence length).
    Returns ``(ids, weights)`` of shape ``(B, k_max * ctx)``.
    """
    rows = [encode_weighted(tokenizer, t, ctx, max_chunks) for t in texts]
    k_max = max([min_chunks] + [r[0].shape[0] // ctx for r in rows])
    ids = np.full((len(rows), k_max * ctx), tokenizer.pad_id, np.int32)
    ws = np.ones((len(rows), k_max * ctx), np.float32)
    empty = np.full((ctx,), tokenizer.pad_id, np.int32)
    empty[0], empty[1] = tokenizer.bot_id, tokenizer.eot_id
    for b, (rid, rw) in enumerate(rows):
        ids[b, :rid.shape[0]] = rid
        ws[b, :rw.shape[0]] = rw
        for c in range(rid.shape[0] // ctx, k_max):
            ids[b, c * ctx:(c + 1) * ctx] = empty
    return ids, ws
