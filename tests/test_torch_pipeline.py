"""The sdbc_tpu_torch sampling slice (DDIM + CFG + VAE decode) against
sdbc_tpu, on the CPU at the tiny config in fp32."""
import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data import tokenizer as jtok
from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion import schedulers as jsched
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion import schedulers as tsched
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, SDPipeline
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "tiny_goldens.npz")


@pytest.fixture(scope="module")
def tcfg():
    return PipelineConfig.tiny()


@pytest.fixture(scope="module")
def tokenizer(tcfg):
    return CLIPTokenizer.fallback(tcfg.clip.vocab_size)


@pytest.fixture(scope="module")
def pipe(tiny_params, tcfg, tokenizer):
    return SDPipeline(jax.tree.map(np.asarray, tiny_params), tcfg, tokenizer,
                      device="cpu", compute_dtype=torch.float32)


def test_pipeline_golden(pipe):
    """The call of tests/test_goldens.py::test_pipeline_golden."""
    _kernels.reset_launch_counts()
    latents = per_sample_fixed_latents(1, (4, 8, 8), seed=42)
    img = pipe(["golden prompt"], num_inference_steps=4, latents=latents)
    np.testing.assert_allclose(img, np.load(GOLDENS)["pipe_img"], atol=1e-3)
    # on the CPU the kernel wrappers take their plain versions
    assert set(_kernels.launches.values()) == {0}


def test_sample_matches_jax_with_negative_prompt(tiny_params, pipe, tokenizer):
    prompts = ["a gothic novel cover", "a cookbook cover"]
    negative = ["blurry", "low quality text"]
    ctx = pipe.cfg.clip.ctx
    cond = np.asarray(tokenizer.batch_encode(prompts, ctx), np.int32)
    uncond = np.asarray(tokenizer.batch_encode(negative, ctx), np.int32)
    lat = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref = jgraph.sample(tiny_params, jnp.asarray(cond), jnp.asarray(uncond),
                        jnp.asarray(lat), jax.random.key(0), 7.5,
                        cfg=JPipelineConfig.tiny(), num_inference_steps=4,
                        compute_dtype=jnp.float32, chunked_decode=True)
    _kernels.reset_launch_counts()
    out = tgraph.sample(pipe.models, torch.from_numpy(cond).long(),
                        torch.from_numpy(uncond).long(),
                        torch.from_numpy(lat), 7.5, cfg=pipe.cfg,
                        num_inference_steps=4, compute_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)
    assert set(_kernels.launches.values()) == {0}
    # the SDPipeline route (negative prompts, NHWC latents) gives the same
    img = pipe(prompts, negative_prompt=negative, num_inference_steps=4,
               latents=lat)
    np.testing.assert_allclose(img, out.numpy(), atol=1e-6)


PROMPTS = ["A Fantasy novel cover,  with a DRAGON!", "l'étranger — 2nd ed.",
           "", "a " * 40]


def _vocab_dir(d):
    """A miniature vocab.json/merges.txt in the CLIP format, SD-2 pad."""
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz!":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    merges = [("b", "o"), ("o", "k</w>"), ("bo", "ok</w>"), ("e", "r</w>")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    (d / "special_tokens_map.json").write_text(json.dumps({"pad_token": "!"}))
    return str(d)


@pytest.mark.parametrize("mode", ["fallback", "vocab"])
def test_tokenizer_matches_jax_package(mode, tmp_path):
    if mode == "fallback":
        ref, tok = jtok.CLIPTokenizer.fallback(1000), CLIPTokenizer.fallback(1000)
    else:
        d = _vocab_dir(tmp_path)
        ref, tok = (jtok.CLIPTokenizer.from_pretrained(d),
                    CLIPTokenizer.from_pretrained(d))
        assert tok.pad_id == ref.pad_id != tok.eot_id  # the declared "!"
    assert tok.batch_encode(PROMPTS, 16) == ref.batch_encode(PROMPTS, 16)
    if mode == "vocab":
        # a dir's placeholder tokens register as in the JAX package
        (tmp_path / "added_tokens.json").write_text('{"<cover>": [99]}')
        ref, tok = (jtok.CLIPTokenizer.from_pretrained(str(tmp_path)),
                    CLIPTokenizer.from_pretrained(str(tmp_path)))
        assert tok.added_tokens == ref.added_tokens == {"<cover>": [99]}
        texts = [p + " <cover>" for p in PROMPTS]
        assert tok.batch_encode(texts, 16) == ref.batch_encode(texts, 16)


def test_ddim_schedule_and_step_match_jax():
    jcfg, tcfg_ = jsched.ScheduleConfig.sd15(), tsched.ScheduleConfig.sd15()
    js, ts = jsched.make_schedule(jcfg), tsched.make_schedule(tcfg_)
    # fp32 linspace and a 1000-term cumulative product: ulp-level drift
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), rtol=1e-5)
    np.testing.assert_array_equal(tsched.ddim_timesteps(tcfg_, 50).numpy(),
                                  np.asarray(jsched.ddim_timesteps(jcfg, 50)))
    x, eps = (np.random.default_rng(s).standard_normal((2, 4, 4, 4)).astype(
        np.float32) for s in (1, 2))
    for t, t_prev in ((981, 961), (19, -1)):
        ref = jsched.ddim_step(js, jnp.asarray(eps), t, t_prev, jnp.asarray(x))
        out = tsched.ddim_step(ts, torch.from_numpy(eps), t, t_prev,
                               torch.from_numpy(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_nchw_latents_and_latent_padding(pipe):
    nchw = per_sample_fixed_latents(1, (4, 8, 8), seed=3)
    a = pipe._latents(nchw, 2, 64, 64, 0)
    assert tuple(a.shape) == (2, 8, 8, 4)
    torch.testing.assert_close(a[0], a[1])  # padded with the last latent
    with pytest.raises(ValueError):
        pipe._latents(np.zeros((3, 8, 8, 4), np.float32), 2, 64, 64, 0)


# SDXL's cond_ids2 / time_ids are ported (tests/test_torch_sdxl.py); a
# single-encoder config ignores them, as the JAX package does.  Of the
# others only pack_heads is unported: ControlNet and the inpainting UNet
# (tests/test_torch_controlnet.py, tests/test_torch_inpaint_unet.py)
# refuse a config without their model, and a scale without a control
# image changes nothing
@pytest.mark.parametrize("option", ["control_image", "masked_image",
                                    "controlnet_scale", "pack_heads"])
def test_unported_sampling_options_raise(pipe, option):
    ids = torch.zeros((1, pipe.cfg.clip.ctx), dtype=torch.int64)
    kw = dict(cfg=pipe.cfg, num_inference_steps=2,
              compute_dtype=torch.float32)
    lat = torch.zeros(1, 8, 8, 4)
    if option == "controlnet_scale":
        torch.testing.assert_close(
            tgraph.sample(pipe.models, ids, ids, lat, 7.5, **kw,
                          controlnet_scale=2),
            tgraph.sample(pipe.models, ids, ids, lat, 7.5, **kw),
            rtol=0, atol=0)
        return
    err = NotImplementedError if option == "pack_heads" else ValueError
    with pytest.raises(err, match=option):
        tgraph.sample(pipe.models, ids, ids, lat, 7.5, **kw,
                      **{option: 2})


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_never_imports_jax():
    pkg = os.path.join(ROOT, "sdbc_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sdbc_tpu"), (path, mod)
