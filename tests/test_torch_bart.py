"""The port's DistilBART summarizer against the JAX package's on the CPU at
``BartConfig.tiny()`` in fp32: the byte-level BPE tokenizer (encode,
truncation keeping ``</s>``, decode, the hash fallback, the merges files'
header rule), ``port_bart`` on one transformers-named state dict, the
encoder and decoder logits (within 1e-5), beam-search ids (forced BOS,
forced EOS, ``min_length``) and the ``Summarizer``'s text and strict
fp32."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data.bart_tokenizer import BartTokenizer as JTok
from sdbc_tpu.models import bart as jbart
from sdbc_tpu.models import port as jport
from sdbc_tpu_torch.data.bart_tokenizer import BartTokenizer as TTok
from sdbc_tpu_torch.data.tokenizer import _bytes_to_unicode
from sdbc_tpu_torch.models import bart as tbart
from sdbc_tpu_torch.models import port as tport
from sdbc_tpu_torch.models.convert import load_jax_params
from tests.torch_threads import one_thread  # noqa: F401

LOGIT_ATOL = 1e-5
MERGES = [("b", "o"), ("o", "k"), ("bo", "ok"), ("Ġ", "b"), ("Ġ", "o"),
          ("Ġ", "t"), ("h", "e"), ("Ġt", "he")]


def write_vocab(d, size: int = 128, merges=MERGES) -> str:
    """A byte-level BPE vocabulary of ``size`` ids: the four specials, the
    merged pieces, then single byte characters up to ``size`` (every id a
    tiny BART can emit decodes to text)."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in "abcdefghijklmnopqrstuvwxyz" + "Ġ":
        vocab[c] = len(vocab)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    for ch in _bytes_to_unicode().values():
        if len(vocab) == size:
            break
        vocab.setdefault(ch, len(vocab))
    with open(d / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(d / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
    return str(d)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("bart_vocab"))


TEXTS = ["book", "ok book the", "the book ok book, the end.",
         "Book OK — “Zoë’s” café 42", "zzz ok  book\n\nthe"]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_encodes_as_jax(vocab_dir, text):
    j, t = JTok.from_pretrained(vocab_dir), TTok.from_pretrained(vocab_dir)
    for n in (24, 6):
        assert t.encode(text, n) == j.encode(text, n)
    ids = t.encode(text, 24)
    assert t.decode(ids) == j.decode(ids)
    assert t.decode(ids, skip_special_tokens=False) == \
        j.decode(ids, skip_special_tokens=False)


def test_tokenizer_truncation_keeps_eos_and_decodes(vocab_dir):
    t = TTok.from_pretrained(vocab_dir)
    ids = t.encode("the book " * 40, max_length=8)
    assert len(ids) == 8 and ids[0] == t.bos_id and ids[-1] == t.eos_id
    assert t.decode(t.encode("ok the book", 16)) == "ok the book"
    assert t.encode("ok", 8)[-1] == t.pad_id


def test_tokenizer_fallback_matches_jax():
    j, t = JTok.fallback(2000), TTok.fallback(2000)
    text = "Some long description of a plot, with café names."
    assert t.encode(text, 64) == j.encode(text, 64)
    assert all(0 <= i < 2000 for i in t.encode(text, 64))
    assert t.decode(t.encode(text, 64)) == j.decode(j.encode(text, 64)) == ""


@pytest.mark.parametrize("first", ["#version: 0.2\n", ""])
def test_merges_header_rule_matches_jax(tmp_path, first):
    """Only a "#version" header line is skipped: a headerless file keeps
    its first merge (the JAX package's divergence from transformers), and
    a '#'-initial rule is a merge."""
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "a": 4, "b": 5,
             "ab": 6, "#": 7, "##": 8}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(first + "a b\n# #\n")
    j, t = JTok.from_pretrained(str(tmp_path)), TTok.from_pretrained(
        str(tmp_path))
    assert t.bpe_ranks == j.bpe_ranks == {("a", "b"): 0, ("#", "#"): 1}
    assert t.encode("ab ##", 8) == j.encode("ab ##", 8)
    assert t.encode("ab", 6)[:3] == [0, 6, 2]


def bart_state_dict(cfg, seed: int = 0, eos_boost: float = 0.0) -> dict:
    """A transformers ``BartForConditionalGeneration``-named state dict of
    random weights (``eos_boost`` scales up the </s> embedding row, so
    beams end before ``max_length``)."""
    rng = np.random.default_rng(seed)
    d, sd = cfg.d_model, {}

    def rand(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def lin(name, i, o):
        sd[f"{name}.weight"] = rand(o, i, scale=i ** -0.5)
        sd[f"{name}.bias"] = rand(o, scale=0.1)

    def ln(name):
        sd[f"{name}.weight"] = 1 + rand(d, scale=0.1)
        sd[f"{name}.bias"] = rand(d, scale=0.1)

    sd["model.shared.weight"] = rand(cfg.vocab_size, d, scale=0.3)
    sd["model.shared.weight"][cfg.eos_id] *= 1 + eos_boost
    for side in ("encoder", "decoder"):
        sd[f"model.{side}.embed_positions.weight"] = rand(
            cfg.max_pos + cfg.pos_offset, d, scale=0.1)
        ln(f"model.{side}.layernorm_embedding")
    for side, n in (("encoder", cfg.encoder_layers),
                    ("decoder", cfg.decoder_layers)):
        for i in range(n):
            p = f"model.{side}.layers.{i}"
            for a in ("self_attn",) + (("encoder_attn",) if side ==
                                       "decoder" else ()):
                for q in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{p}.{a}.{q}", d, d)
                ln(f"{p}.{a}_layer_norm")
            lin(f"{p}.fc1", d, cfg.ffn)
            lin(f"{p}.fc2", cfg.ffn, d)
            ln(f"{p}.final_layer_norm")
    sd["final_logits_bias"] = np.zeros((1, cfg.vocab_size), np.float32)
    return sd


_MODELS = {}


def pair(eos_boost: float = 0.0):
    """(JAX tree, port module) of one state dict."""
    if eos_boost not in _MODELS:
        sd = bart_state_dict(tbart.BartConfig.tiny(), eos_boost=eos_boost)
        model = tbart.init(tbart.BartConfig.tiny(), device="cpu")
        _MODELS[eos_boost] = (jport.port_bart(sd),
                              load_jax_params(model, tport.port_bart(sd)))
    return _MODELS[eos_boost]


def test_port_bart_gives_the_jax_tree():
    sd = bart_state_dict(tbart.BartConfig.tiny(), seed=4)
    jt, tt = jport.port_bart(sd), tport.port_bart(sd)
    assert jax.tree.structure(jt) == jax.tree.structure(tt)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(tt)):
        assert b.dtype == np.float32 and np.array_equal(np.asarray(a), b)
    assert len(tt["encoder"]) == 2 and "cross_attn" in tt["decoder"][1]


def test_encode_and_decode_logits_match_jax():
    jt, model = pair()
    cfg = jbart.BartConfig.tiny()
    ids = np.array([[0, 5, 9, 11, 17, 3, 2, 1, 1, 1],
                    [0, 7, 8, 2, 1, 1, 1, 1, 1, 1]])
    dec = np.array([[2, 0, 7, 9, 4], [2, 0, 30, 2, 1]])
    enc_j = jbart.encode(jt, jnp.asarray(ids, jnp.int32), cfg)
    with torch.no_grad():
        enc_t = tbart.encode(model, torch.from_numpy(ids))
        logit_t = tbart.decode_logits(model, torch.from_numpy(dec), enc_t,
                                      torch.from_numpy(ids != cfg.pad_id))
    np.testing.assert_allclose(enc_t.numpy(), np.asarray(enc_j),
                               atol=LOGIT_ATOL)
    logit_j = jbart.decode_logits(jt, jnp.asarray(dec, jnp.int32), enc_j,
                                  cfg, enc_mask=jnp.asarray(ids != cfg.pad_id))
    assert logit_t.shape == (2, 5, cfg.vocab_size)
    np.testing.assert_allclose(logit_t.numpy(), np.asarray(logit_j),
                               atol=LOGIT_ATOL)


# (eos_boost, num_beams, max_length, min_length): the plain weights run
# to the forced </s>; the boosted ones end beams early unless min_length
# holds them
BEAMS = [(0.0, 3, 8, 2), (6.0, 3, 8, 2), (6.0, 2, 7, 5)]


@pytest.mark.parametrize("boost,beams,max_len,min_len", BEAMS)
def test_beam_search_matches_jax(boost, beams, max_len, min_len):
    jt, model = pair(boost)
    cfg = jbart.BartConfig.tiny()
    ids = np.array([[0, 5, 9, 11, 17, 3, 2, 1]])
    want = jbart.beam_search(jt, ids.astype(np.int32), cfg, num_beams=beams,
                             max_length=max_len, min_length=min_len)
    got = tbart.beam_search(model, ids, num_beams=beams, max_length=max_len,
                            min_length=min_len)
    np.testing.assert_array_equal(got, want)
    assert got[0] == cfg.decoder_start_id and got[1] == cfg.forced_bos_id
    end = list(got[1:]).index(cfg.eos_id) + 1 if cfg.eos_id in got[1:] \
        else None
    if boost == 0.0:
        assert end == max_len  # the forced </s>
    else:
        assert end is not None and min_len <= end
        if min_len == 2:
            assert end < max_len  # a beam ended on its own


def test_summarizer_text_matches_jax(vocab_dir):
    jt, model = pair(6.0)
    cfg = jbart.BartConfig.tiny()
    j = jbart.Summarizer(jt, cfg, JTok.from_pretrained(vocab_dir),
                         num_beams=3, input_max=24)
    t = tbart.Summarizer(model, TTok.from_pretrained(vocab_dir),
                         num_beams=3, input_max=24)
    text = "the book, ok: the book the end"
    assert t(text, max_length=6) == j(text, max_length=6)
    assert t.ids(text, max_length=6).tolist()[0] == cfg.decoder_start_id
    plain = tbart.Summarizer(pair()[1], TTok.from_pretrained(vocab_dir),
                             input_max=24)
    assert plain(text, max_length=6) == jbart.Summarizer(
        pair()[0], cfg, JTok.from_pretrained(vocab_dir),
        input_max=24)(text, max_length=6) != ""


def test_summarizer_runs_strict_fp32(vocab_dir, monkeypatch):
    """The ``Summarizer``'s search runs with TF32 off (the JAX summarizer's
    fp32 products) and gives the caller's switches back after it."""
    seen, real = [], tbart.beam_search

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(*a, **kw)

    monkeypatch.setattr(tbart, "beam_search", spy)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tbart.Summarizer(pair()[1], TTok.from_pretrained(vocab_dir),
                         input_max=24)("the book", max_length=4)
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    assert seen == [(False, False)] and after == (True, True)
