"""The serving halves of LoRA and textual inversion in the port
(``train/lora.py``, ``train/textual_inversion.py``), the tokenizer's
placeholder tokens and ``decode`` (``data/tokenizer.py``), and the CLI's
``--lora_path`` / ``--ti_path`` (``cli/common.py``), against the JAX package
on the CPU.

Tolerances: merged weights within 1e-6 relative to the JAX
``apply_lora``'s (fp32 on both sides; the delta's matmul sums in another
order); token ids, TI tables and the .npz contents exactly; the images of
one tiny config through both CLIs' ``resolve_params_cfg`` with the same
injected latents within 1e-3 (the goldens' pipeline tolerance)."""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.cli import common as jcommon
from sdbc_tpu.cli import inference as jinf
from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from sdbc_tpu.diffusion.pipeline import SDPipeline as JSDPipeline
from sdbc_tpu.models import port as jport
from sdbc_tpu.train import lora as jlora
from sdbc_tpu.train import textual_inversion as jti
from sdbc_tpu_torch.cli import common
from sdbc_tpu_torch.cli import inference as tinf
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion.pipeline import SDPipeline, as_modules
from sdbc_tpu_torch.models.convert import _flatten_jax_tree
from sdbc_tpu_torch.train import lora as tlora
from sdbc_tpu_torch.train import textual_inversion as tti
from tests.torch_threads import one_thread  # noqa: F401

MERGE_RTOL = 1e-6
IMAGE_ATOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def adapter(tiny_params):
    """A rank-2 JAX adapter on the UNet and CLIP's stacked layers with a
    nonzero delta (b = 0 at init would merge to the base)."""
    lora = jlora.init_lora(jax.random.key(1), tiny_params, 2,
                           components=("unet", "text_encoder"))
    keys = jax.random.split(jax.random.key(2), len(lora))
    return {k: {"a": np.asarray(v["a"]),
                "b": np.asarray(jax.random.normal(kk, v["b"].shape) * 0.05)}
            for kk, (k, v) in zip(keys, lora.items())}


@pytest.fixture(scope="module")
def modules(tiny_cfg, tiny_params):
    return as_modules(_np(tiny_params), tiny_cfg, "cpu")


def _state(models):
    return {(c, k): v.detach().clone() for c, m in models.items()
            for k, v in m.state_dict().items()}


def test_init_lora_targets_match_jax(tiny_params, modules):
    for comps in (("unet", "text_encoder"), ("text_encoder",), ("vae",)):
        ref = jlora.init_lora(jax.random.key(1), tiny_params, 2,
                              components=comps)
        got = tlora.init_lora(torch.Generator().manual_seed(1), modules, 2,
                              components=comps)
        assert sorted(got) == sorted(ref)
        for k, v in got.items():
            assert v["a"].shape == ref[k]["a"].shape
            assert v["b"].shape == ref[k]["b"].shape
            assert not v["b"].any()
            bound = 1.0 / v["a"].shape[-2] ** 0.5
            assert v["a"].abs().max() <= bound
    with pytest.raises(ValueError, match="no LoRA targets"):
        tlora.init_lora(torch.Generator(), modules, 2, components=("nope",))
    with pytest.raises(ValueError, match="rank must be >= 1"):
        tlora.init_lora(torch.Generator(), modules, 0, components=("unet",))


def test_lora_merge_matches_jax(tiny_params, modules, adapter, tmp_path):
    """The merge of one adapter file (UNet linears and CLIP's stacked
    layers) against ``apply_lora`` on the JAX tree: each merged weight
    within 1e-6 relative; the base modules unchanged; the untouched VAE
    shared."""
    path = str(tmp_path / "style.npz")
    jlora.save_lora(path, adapter, 2, 4.0)
    before = _state(modules)
    merged = tlora.merge_file(modules, path)
    ref = jlora.apply_lora(tiny_params, adapter, jlora.lora_scale(2, 4.0))
    for comp in ("unet", "text_encoder"):
        assert merged[comp] is not modules[comp]
        want = _flatten_jax_tree(merged[comp], _np(ref[comp]))
        got = {k: v.detach().numpy()
               for k, v in merged[comp].named_parameters()}
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            err = np.abs(got[k] - w).max()
            assert err <= MERGE_RTOL * max(np.abs(w).max(), 1.0), k
    assert merged["vae"] is modules["vae"]
    moved = merged["unet"].get_submodule(
        "down.0.attns.0.attn1.q").weight
    assert not torch.equal(moved, modules["unet"].get_submodule(
        "down.0.attns.0.attn1.q").weight)
    for key, v in _state(modules).items():
        assert torch.equal(v, before[key]), key


def test_lora_merge_into_bf16_rounds_once(modules, adapter):
    """On a module held in bf16 the weight goes to fp32, takes the fp32
    delta and is rounded once."""
    one = {"text_encoder.layers.attn.q": adapter["text_encoder.layers.attn.q"]}
    bf = {"text_encoder": copy.deepcopy(modules["text_encoder"]).to(
        torch.bfloat16)}
    merged = tlora.apply_lora(bf, one, 2.0)
    a, b = (torch.tensor(one["text_encoder.layers.attn.q"][x])
            for x in "ab")
    for i, layer in enumerate(merged["text_encoder"].layers):
        w0 = bf["text_encoder"].layers[i].attn.q.weight
        want = (w0.float() + (a[i] @ b[i]) * 2.0).to(torch.bfloat16)
        assert layer.attn.q.weight.dtype == torch.bfloat16
        assert torch.equal(layer.attn.q.weight, want)


def test_lora_unmatched_path_raises(modules, adapter):
    bad = {"unet.down.0.attns.0.attn9.q": adapter[
        "unet.down.0.attns.0.attn1.q"]}
    before = _state(modules)
    with pytest.raises(ValueError, match="adapter paths not found"):
        tlora.apply_lora(modules, bad, 1.0)
    with pytest.raises(ValueError, match="adapter paths not found"):
        tlora.apply_lora(modules, {"missing.layer.q": bad[
            "unet.down.0.attns.0.attn9.q"]}, 1.0)
    for key, v in _state(modules).items():
        assert torch.equal(v, before[key])


def test_lora_files_load_in_either_package(adapter, tmp_path):
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jlora.save_lora(jpath, adapter, 2, 4.0)
    got, meta = tlora.load_lora(jpath)
    assert meta == {"rank": 2, "alpha": 4.0, "format": "sdbc_lora_v1"}
    tlora.save_lora(tpath, got, 2, 4.0)
    back, jmeta = jlora.load_lora(tpath)
    assert jmeta == meta and sorted(back) == sorted(adapter)
    for k, v in adapter.items():
        for x in "ab":
            np.testing.assert_array_equal(got[k][x].numpy(), v[x])
            np.testing.assert_array_equal(np.asarray(back[k][x]), v[x])
    assert tlora.count_params(got) == jlora.count_params(adapter)
    np.savez(str(tmp_path / "bad.npz"), **{
        "__meta__": np.frombuffer(b'{"rank": 2, "alpha": 1}', np.uint8),
        "unet.x.q.a": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="incomplete pairs"):
        tlora.load_lora(str(tmp_path / "bad.npz"))


@pytest.fixture(scope="module")
def ti_file(tmp_path_factory, tiny_cfg):
    rows = np.random.default_rng(3).standard_normal(
        (2, tiny_cfg.clip.hidden)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("ti") / "style.npz")
    base = tiny_cfg.clip.vocab_size
    jti.save_ti(path, rows, "<cover-style>", [base, base + 1])
    return path, rows


def test_ti_merge_matches_jax(tiny_params, modules, ti_file, tmp_path):
    path, rows = ti_file
    jmerged, jmeta = jti.merge_file(tiny_params, path)
    tmerged, tmeta = tti.merge_file(modules, path)
    assert tmeta["token"] == jmeta["token"] and tmeta["ids"] == jmeta["ids"]
    table = tmerged["text_encoder"].token_embedding.weight.detach().numpy()
    np.testing.assert_array_equal(
        table, np.asarray(jmerged["text_encoder"]["token_embedding"]["table"]))
    te = tmerged["text_encoder"]
    assert te.cfg.vocab_size == 1002 and te.cfg.eot_id == 999
    assert modules["text_encoder"].token_embedding.weight.shape[0] == 1000
    assert tmerged["unet"] is modules["unet"]
    assert tti.added_tokens_entry(tmeta) == jti.added_tokens_entry(jmeta)
    # means over the table: fp32 sums in another order
    for args in ((2, [3, 5]), (1,)):
        np.testing.assert_allclose(
            tti.init_rows(table[:1000], *args).numpy(),
            np.asarray(jti.init_rows(table[:1000], *args)), rtol=1e-5,
            atol=1e-8)
    # a file written by the port loads in the JAX package, and back
    tpath = str(tmp_path / "t.npz")
    tti.save_ti(tpath, torch.from_numpy(rows), "<cover-style>", [1000, 1001])
    jrows, jm = jti.load_ti(tpath)
    np.testing.assert_array_equal(np.asarray(jrows), rows)
    assert jm["token"] == "<cover-style>" and jm["dual"] is False


def test_ti_errors_match_jax(tiny_params, modules, tmp_path):
    rows = np.ones((1, 32), np.float32)
    cases = {"ids": dict(ids=[5]),
             "dual": dict(ids=[1000], rows2=rows),
             "malformed": dict(ids=[1000, 1001])}
    for name, kw in cases.items():
        path = str(tmp_path / f"{name}.npz")
        jti.save_ti(path, rows, "<x>", **kw)
        with pytest.raises(ValueError) as jerr:
            jti.merge_file(tiny_params, path)
        with pytest.raises(ValueError) as terr:
            tti.merge_file(modules, path)
        assert str(terr.value).split(":")[0] == \
            str(jerr.value).split(":")[0], name
    ok = str(tmp_path / "ok.npz")
    jti.save_ti(ok, rows, "<x>", [1000])
    with pytest.raises(ValueError, match="single-encoder"):
        tti.merge_file({**modules, "text_encoder_2": modules[
            "text_encoder"]}, ok)


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    """A miniature vocab.json/merges.txt with an added_tokens.json."""
    d = tmp_path_factory.mktemp("vocab")
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz<>-":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = [("b", "o"), ("o", "k</w>"), ("bo", "ok</w>"), ("c", "o")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    n = len(vocab)
    (d / "added_tokens.json").write_text(json.dumps(
        {"<sty>": [n, n + 1], "<one>": n + 2}))
    return str(d)


@pytest.mark.parametrize("text", [
    "a book cover in <sty> style", "<STY><one> cook  book", "book",
    "<one>", "a <sty-x> cover"])
def test_tokenizer_placeholders_and_decode_match_jax(vocab_dir, text):
    t = CLIPTokenizer.from_pretrained(vocab_dir)
    j = JTokenizer.from_pretrained(vocab_dir)
    assert t.added_tokens == j.added_tokens
    assert t.total_vocab == j.total_vocab
    assert t.encode(text, 24) == j.encode(text, 24)
    ids = t.encode(text, 24)
    assert t.decode(ids) == j.decode(ids)
    for tok in (CLIPTokenizer.fallback(500), JTokenizer.fallback(500)):
        assert tok.add_placeholder("<New>", 3) == [500, 501, 502]
        assert tok.add_placeholder("<new>", 3) == [500, 501, 502]
        assert tok.add_placeholder("<two>") == [503]
        assert tok.total_vocab == 504 and tok.decode([1, 2]) == ""
    tf, jf = CLIPTokenizer.fallback(500), JTokenizer.fallback(500)
    for tok in (tf, jf):
        tok.add_placeholder("<new>", 2)
    assert tf.encode(text + " <new>", 24) == jf.encode(text + " <new>", 24)
    with pytest.raises(ValueError, match="already registered"):
        tf.add_placeholder("<new>", 1)
    with pytest.raises(ValueError, match="non-empty"):
        tf.add_placeholder("  ")


def test_resolve_params_cfg_lora_and_ti_match_jax_cli(tiny_params, tiny_cfg,
                                                      adapter, ti_file,
                                                      tmp_path):
    """--diffusers_ckpt of one tiny export with --lora_path and --ti_path
    through both CLIs' resolve_params_cfg and make_tokenizer: the same
    config and token ids, and the images of a placeholder prompt with the
    same injected latents within 1e-3."""
    export = jport.export_diffusers_checkpoint(tiny_params, tiny_cfg,
                                               str(tmp_path / "sd"))
    lpath = str(tmp_path / "style.npz")
    jlora.save_lora(lpath, adapter, 2, 4.0)
    flags = ["--tiny", "--no-bf16", "--diffusers_ckpt", export,
             "--lora_path", lpath, "--ti_path", ti_file[0]]
    jargs = jinf.build_parser().parse_args(flags)
    targs = tinf.build_parser().parse_args(flags + ["--device", "cpu"])
    common.refuse_unported(targs)
    jparams, jcfg = jcommon.resolve_params_cfg(jargs)
    models, tcfg = common.resolve_params_cfg(targs)
    assert (tcfg.clip.vocab_size, tcfg.clip.eot_id) == \
        (jcfg.clip.vocab_size, jcfg.clip.eot_id) == (1002, 999)
    jtok = jcommon.make_tokenizer(jargs, jcfg.clip.vocab_size)
    ttok = common.make_tokenizer(targs, tcfg.clip.vocab_size)
    prompt = ["a <cover-style> book cover", "plain cover"]
    assert ttok.batch_encode(prompt, 16) == jtok.batch_encode(prompt, 16)
    assert 1000 in ttok.encode(prompt[0], 16)
    lat = np.random.default_rng(7).standard_normal(
        (2, 16, 16, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_inference_steps=3, latents=lat)
    ref = JSDPipeline(jparams, jcfg, jtok, compute_dtype=jnp.float32)(
        prompt, **kw)
    got = SDPipeline(models, tcfg, ttok, device="cpu",
                     compute_dtype=torch.float32)(prompt, **kw)
    np.testing.assert_allclose(got, ref, atol=IMAGE_ATOL)
    plain = SDPipeline(as_modules(_np(tiny_params), tiny_cfg, "cpu"),
                       tiny_cfg, CLIPTokenizer.fallback(1000), device="cpu",
                       compute_dtype=torch.float32)(prompt, **kw)
    assert np.abs(got - plain).max() > 10 * IMAGE_ATOL  # the merges moved it


@pytest.mark.parametrize("flag", ["--lora_path", "--ti_path",
                                  "--safety_checker"])
def test_ported_flags_are_accepted(flag):
    """The three flags this port takes no longer exit through
    refuse_unported (the others still do: test_torch_cli.py)."""
    args = tinf.build_parser().parse_args(["--tiny", flag, "x"])
    common.refuse_unported(args)
    assert flag[2:] not in common._UNPORTED_FLAGS
