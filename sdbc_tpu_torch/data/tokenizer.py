"""CLIP BPE tokenizer (counterpart of ``sdbc_tpu/data/tokenizer.py``).

The sampling path's part of it, so the port loads nothing of the JAX
package: lowercase, whitespace-clean, regex pre-tokenize, byte-level unicode
mapping, BPE merges with an end-of-word ``</w>`` marker, ``<|startoftext|>``
… ``<|endoftext|>``, padded to max length with the declared pad token (EOT
for SD-1.x).  Vocab files (``vocab.json`` + ``merges.txt``) come from a
checkpoint directory; ``fallback`` hashes words into fixed buckets (not
token-compatible with real CLIP) so the stack runs without downloaded files.
Placeholder tokens (textual inversion, ``add_placeholder`` or a dir's
``added_tokens.json``) are matched verbatim before BPE and expand to their
ids after the base vocabulary; ``decode`` inverts a BPE encoding.
"""
from __future__ import annotations

import functools
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte→unicode visible-char mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clip_pattern():
    # the real CLIP pattern needs \p{L}/\p{N} classes (third-party `regex`);
    # an ASCII approximation on stdlib `re` only as a last resort
    try:
        import regex

        return regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    except ImportError:
        import warnings

        warnings.warn(
            "third-party 'regex' not available: CLIP pre-tokenization "
            "falls back to an ASCII approximation; non-ASCII prompts will "
            "tokenize differently from the checkpoint's trained tokenizer",
            stacklevel=2)
        return re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)


_PAT = _clip_pattern()


def hash_bucket(piece: str, buckets: int) -> int:
    """FNV-1a — stable across processes (unlike Python's randomized hash())."""
    h = 0x811C9DC5
    for ch in piece.encode("utf-8"):
        h = ((h ^ ch) * 0x01000193) & 0xFFFFFFFF
    return h % buckets


class CLIPTokenizer:
    """CLIP byte-pair tokenizer with max-length padding and truncation."""

    BOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 merges: Optional[List[Tuple[str, str]]] = None,
                 vocab_size: int = 49408, pad_token: Optional[str] = None,
                 added_tokens: Optional[Dict[str, List[int]]] = None):
        self.byte_encoder = _bytes_to_unicode()
        self.vocab_size = vocab_size
        if vocab is not None:
            self.encoder = vocab
            self.bpe_ranks = {m: i for i, m in enumerate(merges or [])}
            self.hash_mode = False
        else:
            self.encoder = {self.BOT: vocab_size - 2, self.EOT: vocab_size - 1}
            self.bpe_ranks = {}
            self.hash_mode = True
        self.bot_id = self.encoder[self.BOT]
        self.eot_id = self.encoder[self.EOT]
        # SD-2.x declares pad_token "!" (id 0), and pad ids reach the
        # cross-attention
        self.pad_id = (self.encoder[pad_token] if pad_token is not None
                       else self.eot_id)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.cache: Dict[str, str] = {}
        # placeholder string → its ids at and above the base vocab
        self.added_tokens: Dict[str, List[int]] = dict(added_tokens or {})

    @property
    def total_vocab(self) -> int:
        """Base vocab + appended placeholder rows (the embedding-table
        length a model trained with these tokens carries)."""
        return self.vocab_size + sum(len(v)
                                     for v in self.added_tokens.values())

    def add_placeholder(self, token: str, n_vectors: int = 1) -> List[int]:
        """Register ``token`` as ``n_vectors`` new ids appended after the
        current vocabulary (id = total_vocab + k).  Lowercased, as the
        prompts are; idempotent for an identical re-registration."""
        token = token.strip().lower()
        if not token:
            raise ValueError("placeholder token must be non-empty")
        if token in self.added_tokens:
            ids = self.added_tokens[token]
            if len(ids) != n_vectors:
                raise ValueError(
                    f"placeholder {token!r} already registered with "
                    f"{len(ids)} vectors, asked for {n_vectors}")
            return list(ids)
        base = self.total_vocab
        ids = list(range(base, base + n_vectors))
        self.added_tokens[token] = ids
        return ids

    def _split_added(self, text: str):
        """→ [(segment, ids or None)] with placeholder strings isolated,
        longest first."""
        segs: List[Tuple[str, Optional[List[int]]]] = [(text, None)]
        for tok in sorted(self.added_tokens, key=len, reverse=True):
            ids = self.added_tokens[tok]
            out: List[Tuple[str, Optional[List[int]]]] = []
            for seg, seg_ids in segs:
                if seg_ids is not None:
                    out.append((seg, seg_ids))
                    continue
                for i, part in enumerate(seg.split(tok)):
                    if i:
                        out.append((tok, ids))
                    if part:
                        out.append((part, None))
            segs = out
        return segs

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """vocab.json + merges.txt from a tokenizer directory, honouring its
        declared pad_token (special_tokens_map.json / tokenizer_config.json)
        and its placeholder tokens (added_tokens.json: ours {token: [ids]},
        HF's {token: id}).
        """
        with open(os.path.join(path, "vocab.json")) as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt")) as f:
            lines = f.read().split("\n")
        # skip only the "#version" header: a '#'-leading line can be a merge
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges = []
        for line in lines:
            if line.strip():
                a, _, b = line.partition(" ")
                merges.append((a, b.strip()))
        pad = None
        for meta in ("special_tokens_map.json", "tokenizer_config.json"):
            mp = os.path.join(path, meta)
            if pad is None and os.path.exists(mp):
                with open(mp) as f:
                    tok = json.load(f).get("pad_token")
                if isinstance(tok, dict):  # AddedToken serialization
                    tok = tok.get("content")
                if isinstance(tok, str) and tok in vocab:
                    pad = tok
        added = None
        ap = os.path.join(path, "added_tokens.json")
        if os.path.exists(ap):
            with open(ap) as f:
                raw = json.load(f)
            added = {k: (v if isinstance(v, list) else [v])
                     for k, v in raw.items()}
        return cls(vocab=vocab, merges=merges, vocab_size=len(vocab),
                   pad_token=pad, added_tokens=added)

    @classmethod
    def fallback(cls, vocab_size: int = 49408) -> "CLIPTokenizer":
        return cls(vocab=None, vocab_size=vocab_size)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _token_ids(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        segments = (self._split_added(text) if self.added_tokens
                    else [(text, None)])
        for seg, seg_ids in segments:
            if seg_ids is not None:
                ids.extend(seg_ids)
                continue
            for tok in _PAT.findall(seg):
                tok_bytes = "".join(self.byte_encoder[b]
                                    for b in tok.encode("utf-8"))
                for piece in self._bpe(tok_bytes).split(" "):
                    if self.hash_mode:
                        # a stable bucket that avoids the two special ids
                        ids.append(hash_bucket(piece, self.vocab_size - 2))
                    else:
                        ids.append(self.encoder.get(piece, self.eot_id))
        return ids

    def encode(self, text: str, max_length: int = 77) -> List[int]:
        ids = ([self.bot_id] + self._token_ids(text)[: max_length - 2]
               + [self.eot_id])
        return ids + [self.pad_id] * (max_length - len(ids))

    def batch_encode(self, texts: Sequence[str], max_length: int = 77):
        return [self.encode(t, max_length) for t in texts]

    def decode(self, ids: Sequence[int]) -> str:
        """Text of a BPE encoding without the special ids; a placeholder
        renders once, at the first of its ids.  "" in hash mode (buckets
        are not invertible)."""
        if self.hash_mode:
            return ""
        added_first = {v[0]: (k + "</w>") for k, v in self.added_tokens.items()}
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        text = "".join(
            added_first.get(int(i)) or self.decoder.get(int(i), "")
            for i in ids
            if int(i) not in (self.bot_id, self.eot_id, self.pad_id))
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>",
                                                             " ").strip()
