"""BART's byte-level BPE tokenizer (counterpart of
``sdbc_tpu/data/bart_tokenizer.py``, for ``models.bart.Summarizer``).

The reference tokenizes descriptions with ``AutoTokenizer.from_pretrained(
"sshleifer/distilbart-cnn-12-6")`` (inference.py:293-318); this reads the
same local ``vocab.json`` + ``merges.txt``.  Against the CLIP BPE of
``data/tokenizer.py`` (whose byte → unicode map, pair set and FNV hash it
shares): no lowercasing, no ``</w>`` end-of-word marker, a leading space
belongs to its token (the "Ġ" of the byte map), and the special tokens are
``<s> <pad> </s> <unk>``.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

from sdbc_tpu_torch.data.tokenizer import (_bytes_to_unicode, _get_pairs,
                                           hash_bucket)


@functools.lru_cache()
def _gpt2_pattern():
    # GPT-2/RoBERTa pre-tokenization needs \p{L}/\p{N} (third-party
    # `regex`); on the standard library's `re` an ASCII approximation
    try:
        import regex

        return regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
            r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    except ImportError:
        import re
        import warnings

        # non-ASCII text (accented names, curly quotes: common in book
        # descriptions) splits differently under the approximation
        warnings.warn(
            "third-party 'regex' not available: BART pre-tokenization falls "
            "back to an ASCII approximation of the GPT-2 pattern; summaries "
            "of non-ASCII text will diverge from the trained checkpoint",
            stacklevel=2)
        return re.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?[a-zA-Z]+| ?[0-9]+|"""
            r""" ?[^\sa-zA-Z0-9]+|\s+(?!\S)|\s+""")


class BartTokenizer:
    """Byte-level BPE with BART's special tokens.

    ``encode(text, max_length)`` is the reference's ``tokenizer(description,
    max_length=1024, truncation=True, padding="max_length").input_ids``:
    ``<s> tokens </s>``, truncated to ``max_length`` (``</s>`` kept),
    padded with ``<pad>``.
    """

    BOS, PAD, EOS, UNK = "<s>", "<pad>", "</s>", "<unk>"

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 merges: Optional[List[Tuple[str, str]]] = None,
                 vocab_size: int = 50264):
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if vocab is not None:
            self.encoder = dict(vocab)
            self.bpe_ranks = {m: i for i, m in enumerate(merges or [])}
            self.hash_mode = False
            self.vocab_size = max(len(self.encoder), vocab_size)
        else:
            # deterministic stand-in without files (not BART-compatible)
            self.encoder = {self.BOS: 0, self.PAD: 1, self.EOS: 2, self.UNK: 3}
            self.bpe_ranks = {}
            self.hash_mode = True
            self.vocab_size = vocab_size
        for tok, default in ((self.BOS, 0), (self.PAD, 1), (self.EOS, 2),
                             (self.UNK, 3)):
            self.encoder.setdefault(tok, default)
        self.bos_id = self.encoder[self.BOS]
        self.pad_id = self.encoder[self.PAD]
        self.eos_id = self.encoder[self.EOS]
        self.unk_id = self.encoder[self.UNK]
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.cache: Dict[str, str] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "BartTokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        # transformers drops the first line unconditionally; only a
        # "#version" header is skipped here, so a headerless file keeps its
        # first merge (a rule may begin with '#': "# #"), as in the JAX
        # package
        if lines and lines[0].startswith("#version"):
            lines = lines[1:]
        merges: List[Tuple[str, str]] = []
        for line in lines:
            if line.strip():
                a, _, b = line.partition(" ")
                merges.append((a, b.strip()))
        return cls(vocab=vocab, merges=merges)

    @classmethod
    def fallback(cls, vocab_size: int = 50264) -> "BartTokenizer":
        """Hash buckets instead of BPE tables (``decode`` gives "")."""
        return cls(vocab=None, vocab_size=vocab_size)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        pairs = _get_pairs(word)
        if not pairs:
            return token
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
        ids: List[int] = []
        for tok in _gpt2_pattern().findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped).split(" "):
                if self.hash_mode:
                    ids.append(4 + hash_bucket(piece, self.vocab_size - 4))
                else:
                    ids.append(self.encoder.get(piece, self.unk_id))
        return ids

    def encode(self, text: str, max_length: int = 1024) -> List[int]:
        ids = ([self.bos_id] + self._token_ids(text)[: max_length - 2]
               + [self.eos_id])
        return ids + [self.pad_id] * (max_length - len(ids))

    def batch_encode(self, texts: Sequence[str], max_length: int = 1024):
        return [self.encode(t, max_length) for t in texts]

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        if self.hash_mode:
            return ""  # hash buckets are not invertible
        # transformers' skip_special_tokens drops <unk> too
        special = {self.bos_id, self.pad_id, self.eos_id, self.unk_id}
        text = "".join(
            self.decoder.get(int(i), "") for i in ids
            if not (skip_special_tokens and int(i) in special))
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").strip()
