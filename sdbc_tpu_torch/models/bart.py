"""BART seq2seq summarizer at DistilBART-CNN's shapes, with beam search
(counterpart of ``sdbc_tpu/models/bart.py``).

The reference summarizes each book description with
``sshleifer/distilbart-cnn-12-6`` (beam search, 3 beams, min 2 and max 15
tokens; inference.py:293-318) and renders the summary into a prompt.
The architecture: post-LN encoder and decoder, learned positions at
BART's offset 2, the output projection tied to the input embedding, exact
GELU, masks as -1e9 on fp32 logits.  Attention is plain matmuls, as it is
plain einsum in the JAX package (no kernel of the repo's takes it).

Parameters follow the JAX tree (``shared_embedding.table``,
``encoder.<i>.self_attn.q.w``, ...), so ``models.convert.load_jax_params``
fills a module from ``models.port.port_bart``'s tree; linear weights are
(in, out).  Beam search is the JAX package's algorithm: one full
fixed-width decoder pass a step, its row ``step`` read, log-softmax in
fp32, the beam bookkeeping on the host in float64 numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdbc_tpu_torch.ops import nn as ops_nn
from sdbc_tpu_torch.utils.dtypes import fp32_exact


@dataclasses.dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 50264
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 6
    heads: int = 16
    ffn: int = 4096
    max_pos: int = 1024
    pos_offset: int = 2          # BART's learned-position offset
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    decoder_start_id: int = 2    # the decoder starts from </s>
    # generation forces <s> as the first generated token
    # (forced_bos_token_id=0 in distilbart-cnn's config) ...
    forced_bos_id: int = 0
    # ... and </s> as the last at max_length (forced_eos_token_id=2)
    forced_eos_id: int = 2

    @staticmethod
    def distilbart_cnn() -> "BartConfig":
        return BartConfig()

    @staticmethod
    def tiny() -> "BartConfig":
        return BartConfig(vocab_size=128, d_model=32, encoder_layers=2,
                          decoder_layers=2, heads=4, ffn=64, max_pos=64)


class _Attention(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.q = ops_nn.Linear(d, d, **kw)
        self.k = ops_nn.Linear(d, d, **kw)
        self.v = ops_nn.Linear(d, d, **kw)
        self.o = ops_nn.Linear(d, d, **kw)

    def forward(self, x, kv, heads: int, mask=None, causal: bool = False):
        b, s, d = x.shape
        hd = d // heads

        def split(t):
            return t.reshape(b, -1, heads, hd).transpose(1, 2)

        # BART scales the query by d_head**-0.5 before the product
        q = split(self.q(x)) * (hd ** -0.5)
        k, v = split(self.k(kv)), split(self.v(kv))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if causal:
            sq, sk = logits.shape[-2:]
            keep = torch.ones((sq, sk), dtype=torch.bool,
                              device=x.device).tril()
            logits = logits.masked_fill(~keep, -1e9)
        if mask is not None:  # (b, sk), True = a real token
            logits = logits.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v)
        return self.o(out.transpose(1, 2).reshape(b, s, d))


class _Layer(nn.Module):
    def __init__(self, cfg: BartConfig, cross: bool, **kw):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _Attention(d, **kw)
        self.self_ln = ops_nn.LayerNorm(d, **kw)
        if cross:
            self.cross_attn = _Attention(d, **kw)
            self.cross_ln = ops_nn.LayerNorm(d, **kw)
        self.fc1 = ops_nn.Linear(d, cfg.ffn, **kw)
        self.fc2 = ops_nn.Linear(cfg.ffn, d, **kw)
        self.final_ln = ops_nn.LayerNorm(d, **kw)

    def ffn(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class BartModel(nn.Module):
    def __init__(self, cfg: BartConfig, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator, dtype=dtype)
        n_pos = cfg.max_pos + cfg.pos_offset
        self.shared_embedding = ops_nn.Embedding(cfg.vocab_size, cfg.d_model,
                                                 **kw)
        self.enc_pos = ops_nn.Embedding(n_pos, cfg.d_model, **kw)
        self.dec_pos = ops_nn.Embedding(n_pos, cfg.d_model, **kw)
        self.enc_ln_emb = ops_nn.LayerNorm(cfg.d_model, **kw)
        self.dec_ln_emb = ops_nn.LayerNorm(cfg.d_model, **kw)
        self.encoder = nn.ModuleList(_Layer(cfg, False, **kw)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(_Layer(cfg, True, **kw)
                                     for _ in range(cfg.decoder_layers))


def init(cfg: BartConfig, *, device, generator=None,
         dtype=torch.float32) -> BartModel:
    """A BART module; its weights drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; None leaves them for
    ``load_jax_params``)."""
    return BartModel(cfg, device=device, generator=generator, dtype=dtype)


def encode(model: BartModel, ids, mask=None):
    """ids (B, S) → the encoder states (B, S, d); ``mask`` True at real
    tokens (default: ids other than the pad id)."""
    cfg = model.cfg
    if mask is None:
        mask = ids != cfg.pad_id
    pos = model.enc_pos.weight[cfg.pos_offset:cfg.pos_offset + ids.shape[1]]
    x = model.enc_ln_emb(model.shared_embedding(ids) + pos[None])
    for layer in model.encoder:
        x = layer.self_ln(x + layer.self_attn(x, x, cfg.heads, mask=mask))
        x = layer.final_ln(x + layer.ffn(x))
    return x


def decode_logits(model: BartModel, dec_ids, enc_states, enc_mask=None):
    """The full-prefix decoder pass → logits (B, T, vocab)."""
    cfg = model.cfg
    pos = model.dec_pos.weight[cfg.pos_offset:
                               cfg.pos_offset + dec_ids.shape[1]]
    x = model.dec_ln_emb(model.shared_embedding(dec_ids) + pos[None])
    for layer in model.decoder:
        x = layer.self_ln(x + layer.self_attn(x, x, cfg.heads, causal=True))
        x = layer.cross_ln(x + layer.cross_attn(x, enc_states, cfg.heads,
                                                mask=enc_mask))
        x = layer.final_ln(x + layer.ffn(x))
    return torch.matmul(x, model.shared_embedding.weight.to(x.dtype).T)


def _beam_step(model, beams, enc, enc_mask, step: int) -> np.ndarray:
    """Log-probabilities (fp32, on the host) of the token after position
    ``step`` of each beam: the whole fixed-width decoder pass, row
    ``step`` read (the causal mask keeps later positions out of it)."""
    logits = decode_logits(model, beams, enc, enc_mask)
    return torch.log_softmax(logits[:, step].float(), dim=-1).cpu().numpy()


@torch.no_grad()
def beam_search(model: BartModel, input_ids, *, num_beams: int = 3,
                max_length: int = 15, min_length: int = 2,
                trace: list = None) -> np.ndarray:
    """One sequence's best token ids (decoder start included), the
    reference's beam settings (inference.py:313-318: 3 beams, min 2, max
    ~15): forced <s> first, forced </s> at ``max_length``, no </s> before
    ``min_length`` tokens, finished beams ranked by score / length.
    ``trace``: a list that receives each step's (beams, candidate scores)
    as the selection sees them (float64, beams × vocab)."""
    cfg = model.cfg
    device = model.shared_embedding.weight.device
    input_ids = np.atleast_2d(np.asarray(input_ids))
    if input_ids.shape[0] != 1:
        raise ValueError("beam_search takes one description at a time")
    ids = torch.from_numpy(input_ids.astype(np.int64)).to(device)
    enc_mask = ids != cfg.pad_id
    enc = encode(model, ids, enc_mask).repeat_interleave(num_beams, 0)
    enc_mask = enc_mask.repeat_interleave(num_beams, 0)

    beams = np.full((num_beams, max_length + 1), cfg.pad_id, np.int64)
    beams[:, 0] = cfg.decoder_start_id
    scores = np.array([0.0] + [-1e9] * (num_beams - 1), np.float64)
    finished: list = []
    for step in range(max_length):
        logp = _beam_step(model, torch.from_numpy(beams).to(device), enc,
                          enc_mask, step)
        if step == 0 and cfg.forced_bos_id is not None:
            keep = logp[:, cfg.forced_bos_id].copy()
            logp[:, :] = -1e9
            logp[:, cfg.forced_bos_id] = keep
        if step == max_length - 1 and cfg.forced_eos_id is not None:
            keep = logp[:, cfg.forced_eos_id].copy()
            logp[:, :] = -1e9
            logp[:, cfg.forced_eos_id] = keep
        if step + 1 < min_length:
            logp[:, cfg.eos_id] = -1e9
        flat = (scores[:, None] + logp).reshape(-1)
        if trace is not None:
            trace.append((beams.copy(), flat.reshape(num_beams, -1)))
        top = np.argpartition(-flat, 2 * num_beams)[: 2 * num_beams]
        top = top[np.argsort(-flat[top])]
        new_beams, new_scores = [], []
        for idx in top:
            b, tok = divmod(int(idx), logp.shape[1])
            cand = beams[b].copy()
            cand[step + 1] = tok
            if tok == cfg.eos_id:
                finished.append((flat[idx] / (step + 1), cand))
            else:
                new_beams.append(cand)
                new_scores.append(flat[idx])
            if len(new_beams) == num_beams:
                break
        while len(new_beams) < num_beams:  # every candidate ended
            new_beams.append(beams[0])
            new_scores.append(-1e9)
        beams = np.stack(new_beams)
        scores = np.array(new_scores)
        if len(finished) >= num_beams:
            break
    if not finished:
        finished = [(scores[i] / max_length, beams[i])
                    for i in range(num_beams)]
    finished.sort(key=lambda x: -x[0])
    return finished[0][1]


class Summarizer:
    """Description text → a short summary, on the model's device; fp32
    products stay fp32 on the card (TF32 off for the call), as the JAX
    summarizer runs on fp32 trees."""

    def __init__(self, model: BartModel, tokenizer, num_beams: int = 3,
                 input_max: int = 1024):
        self.model = model
        self.cfg = model.cfg
        self.tok = tokenizer
        self.num_beams = num_beams
        self.input_max = min(input_max, model.cfg.max_pos)

    def ids(self, text: str, max_length: int = 15, min_length: int = 2,
            trace: list = None) -> np.ndarray:
        """The best beam's token ids for ``text`` (``trace``: as
        ``beam_search``'s)."""
        ids = np.asarray(self.tok.encode(text, self.input_max),
                         np.int64)[None]
        with fp32_exact():
            return beam_search(self.model, ids, num_beams=self.num_beams,
                               max_length=max_length, min_length=min_length,
                               trace=trace)

    def __call__(self, text: str, max_length: int = 15,
                 min_length: int = 2) -> str:
        return self.tok.decode(self.ids(text, max_length,
                                        min_length).tolist())
