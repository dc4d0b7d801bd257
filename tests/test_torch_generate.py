"""The port's request surface against sdbc_tpu, on the CPU at the tiny
config in fp32: the copies of ``data/prompt_weights.py`` and
``data/templates.py``, ``utils/image.resize`` against ``jax.image.resize``,
``SampleSpec``, and ``SDPipeline``'s batch buckets, prompt weighting,
``generate`` and ``hires`` (both modes) on one JAX parameter tree.

Tolerances: the copies exactly; the resize to 1e-5 of the largest entry;
images to the pipeline goldens' 1e-3 (``tests/test_torch_pipeline.py``).
The port draws its noise from ``torch.Generator``; where a JAX run draws
internally (hires' second stage, the posterior of the image mode's
encode) the port is given the JAX key schedule's draws (``Injected``)."""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data import prompt_weights as jpw
from sdbc_tpu.data import templates as jtemplates
from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from sdbc_tpu.diffusion import spec as jspec
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from sdbc_tpu.diffusion.pipeline import SDPipeline as JSDPipeline
from sdbc_tpu_torch.data import prompt_weights as tpw
from sdbc_tpu_torch.data import templates as ttemplates
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import pipeline as tpipeline
from sdbc_tpu_torch.diffusion import spec as tspec
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, SDPipeline
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.utils.image import resize
from tests.test_torch_remat import _chip_smoke
from tests.test_torch_sample_options import counted  # noqa: F401
from tests.test_torch_samplers import jax_draws

ATOL = 1e-3
RESIZE_RTOL = 1e-5

WEIGHTED = ["a ((big)) cat:", "(gothic:1.3) novel [cover]",
            "unbalanced (open and ] close", r"escaped \(literal\) text",
            "a (very:0.5) long prompt " + "with many words " * 12,
            "", "plain prompt"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module (tiny tensors; the tier-1 run's
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("text", WEIGHTED)
def test_prompt_weights_copy_matches(text):
    tok = CLIPTokenizer.fallback(1000)
    assert tpw.parse_weighted_prompt(text) == jpw.parse_weighted_prompt(text)
    for ctx, chunks in ((16, 3), (77, 2)):
        for a, b in zip(tpw.encode_weighted(tok, text, ctx, chunks),
                        jpw.encode_weighted(tok, text, ctx, chunks)):
            np.testing.assert_array_equal(a, b)
    batch = [text, "short", WEIGHTED[4]]
    for a, b in zip(tpw.batch_encode_weighted(tok, batch, 16, 3, 2),
                    jpw.batch_encode_weighted(tok, batch, 16, 3, 2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_templates_copy_matches(seed):
    for name in ("TRAINING_TEMPLATES", "SUMMARY_PLACEHOLDERS",
                 "TEST_TEMPLATES", "LEGIBLE_SUFFIX",
                 "REFERENCE_TRAINING_TEMPLATES",
                 "REFERENCE_INFERENCE_TRAINING_TEMPLATES",
                 "REFERENCE_INFERENCE_TEST_TEMPLATES"):
        assert getattr(ttemplates, name) == getattr(jtemplates, name), name
    rows = [("Ann Author", "A Title"), ("B. Writer", "Other")]
    calls = [
        lambda m, r: m.format_training_prompt("A", "T", "desc", rng=r,
                                              legible_text_prob=0.5),
        lambda m, r: m.reference_fid_prompt("A", "T", rng=r),
        lambda m, r: m.format_reference_training_prompt(
            "A", "T", "d", rng=r, legible_text_prob=0.5, include_desc=True),
        lambda m, r: m.reference_grid_prompts(
            rows, 3, include_desc=True, descriptions=["x", "y"], rng=r),
        lambda m, r: m.padded_placeholders(13, rng=r),
    ]
    for call in calls:
        assert call(ttemplates, random.Random(seed)) \
            == call(jtemplates, random.Random(seed))


@pytest.mark.parametrize("shape,out,method", [
    ((2, 16, 16, 4), (2, 32, 32, 4), "bicubic"),   # hires' latent upsample
    ((1, 40, 36, 3), (1, 17, 23, 3), "bicubic"),   # down, antialiased
    ((1, 512, 512, 3), (1, 299, 299, 3), "bilinear"),  # the FID input
])
def test_resize_matches_jax(shape, out, method):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if method == "bilinear":
        x = (x * 64.0 + 128.0).clip(0, 255)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize(torch.from_numpy(x), out, method).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RESIZE_RTOL * np.abs(ref).max()


def test_image_helpers_match_jax(tmp_path):
    from PIL import Image

    from sdbc_tpu.utils import image as jimage
    from sdbc_tpu_torch.utils import image as timage

    x = np.random.default_rng(2).uniform(-0.01, 1.01, (2, 12, 10, 3)).astype(
        np.float32)
    x[0, 0, 0] = 0.5 / 255.0  # a half-way rounding case
    np.testing.assert_array_equal(timage.to_uint8(x).numpy(),
                                  np.asarray(jimage.to_uint8(jnp.asarray(x))))
    np.testing.assert_array_equal(
        timage.normalize_to_pm1(x * 255).numpy(),
        np.asarray(jimage.normalize_to_pm1(x * 255)))
    for img in (x, x[0]):
        ref = np.asarray(jimage.resize_bicubic(jnp.asarray(img), (7, 9)))
        got = timage.resize_bicubic(torch.from_numpy(img), (7, 9)).numpy()
        assert np.abs(got - ref).max() <= RESIZE_RTOL * np.abs(ref).max()
    path = str(tmp_path / "c.jpg")
    Image.fromarray((x[0] * 255).clip(0, 255).astype(np.uint8)).save(path)
    np.testing.assert_array_equal(timage.decode_and_prepare(path, 16),
                                  jimage.decode_and_prepare(path, 16))
    pil = [Image.fromarray(np.full((4, 6, 3), i * 40, np.uint8))
           for i in range(6)]
    np.testing.assert_array_equal(
        np.asarray(timage.image_grid(pil, 2, 3)),
        np.asarray(jimage.image_grid(pil, 2, 3)))


def test_sample_spec_fields_and_expansions_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jspec.SampleSpec)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tspec.SampleSpec)]
    assert tf == jf
    kw = dict(height=64, width=96, num_inference_steps=7, seed=3,
              negative_prompt="blurry", cfg_interval=(0.1, 0.9),
              prompt_weighting=True, hires_scale=2.0, hires_steps=5,
              hires_mode="image")
    j, t = jspec.SampleSpec(**kw), tspec.SampleSpec(**kw)
    assert t.call_kwargs() == j.call_kwargs()
    assert t.hires_kwargs() == j.hires_kwargs()
    assert t.replace(seed=9).seed == 9
    # JAX drops the img2img fields of a hires spec; the port refuses them
    img = np.zeros((1, 64, 96, 3), np.float32)
    assert "init_image" not in j.replace(init_image=img).hires_kwargs()
    for field, value in (("init_image", img), ("strength", 0.5),
                         ("init_latents", img), ("denoising_end", 0.5)):
        with pytest.raises(ValueError, match=field):
            t.replace(**{field: value}).hires_kwargs()


@pytest.fixture(scope="module")
def tree(tiny_params):
    """The tiny tree with a nonzero final-LN bias: token weights restore
    each sample's hidden-state mean, which is rounding noise at zero."""
    tree = jax.tree.map(np.asarray, tiny_params)
    te = dict(tree["text_encoder"])
    ln = dict(te["final_ln"])
    ln["bias"] = np.random.default_rng(1).standard_normal(
        ln["bias"].shape).astype(np.float32) * 0.5
    te["final_ln"] = ln
    return dict(tree, text_encoder=te)


@pytest.fixture(scope="module")
def pipes(tree):
    jcfg, tcfg = JPipelineConfig.tiny(), PipelineConfig.tiny()
    jpipe = JSDPipeline(jax.tree.map(jnp.asarray, tree), jcfg,
                        JTokenizer.fallback(jcfg.clip.vocab_size),
                        compute_dtype=jnp.float32)
    tpipe = Injected(tree, tcfg, CLIPTokenizer.fallback(tcfg.clip.vocab_size),
                     device="cpu", compute_dtype=torch.float32)
    return jpipe, tpipe


class Injected(SDPipeline):
    """The port's pipeline given the JAX pipeline's draws: without latents
    ``lkey, key = split(key(seed))`` and the initial noise from lkey, else
    key(seed); the sampler's draws from key as ``jax_draws`` replays them
    (with init_image the posterior's ε first)."""

    def __call__(self, prompts, *, seed=42, latents=None, height=512,
                 width=512, num_inference_steps=50, **kw):
        n = len([prompts] if isinstance(prompts, str) else prompts)
        n *= kw.get("num_images_per_prompt", 1)
        bucket = next(s for s in self.BATCH_BUCKETS if s >= n)
        f = self.cfg.vae_scale
        shape = (bucket, height // f, width // f, self.cfg.latent_channels)
        key = jax.random.key(seed)
        if latents is None:
            lkey, key = jax.random.split(key)
            latents = np.asarray(jax.random.normal(lkey, shape))[:n]
        enc = shape if kw.get("init_image") is not None else None
        draws = jax_draws(key, shape, 0, num_inference_steps, enc)
        return super().__call__(prompts, seed=seed, latents=latents,
                                height=height, width=width,
                                num_inference_steps=num_inference_steps,
                                draws=draws, **kw)


PROMPTS3 = ["a gothic novel cover", "a cookbook cover", "a space opera"]


def test_bucket_padding_matches_jax(pipes, monkeypatch):
    """3 prompts run as bucket 4 (the last latent repeated, "" prompts) and
    return 3 images, the JAX pipeline's."""
    jpipe, tpipe = pipes
    lat = np.random.default_rng(5).standard_normal((3, 16, 16, 4)).astype(
        np.float32)
    kw = dict(height=32, width=32, num_inference_steps=4,
              negative_prompt="blurry")
    ref = jpipe(PROMPTS3, latents=lat, **kw)
    batches = []
    real = tpipeline.sample

    def record(models, cond, uncond, latents, *a, **k):
        batches.append((cond.shape[0], latents.shape[0]))
        return real(models, cond, uncond, latents, *a, **k)

    monkeypatch.setattr(tpipeline, "sample", record)
    _kernels.reset_launch_counts()
    got = SDPipeline.__call__(tpipe, PROMPTS3, latents=lat, **kw)
    assert batches == [(4, 4)]
    assert got.shape == ref.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert set(_kernels.launches.values()) == {0}


def test_prompt_weighting_matches_jax(pipes):
    """A weighted prompt over two 16-token windows (the tiny encoder's
    context), against a one-window negative prompt padded to two."""
    jpipe, tpipe = pipes
    prompts = ["a (gothic:1.3) novel with [faded] ((raven))",
               "a cookbook cover"]
    kw = dict(height=32, width=32, num_inference_steps=3,
              prompt_weighting=True, negative_prompt="(blurry:1.2)")
    ids, _ = tpw.batch_encode_weighted(tpipe.tokenizer, prompts, 16, 3)
    assert ids.shape[1] == 32
    lat = np.random.default_rng(6).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    ref = jpipe(prompts, latents=lat, **kw)
    got = tpipe(prompts, latents=lat, **kw)
    np.testing.assert_allclose(got, ref, atol=ATOL)
    plain = tpipe(prompts, latents=lat, **dict(kw, prompt_weighting=False))
    assert np.abs(plain - got).max() > 10 * ATOL


@pytest.mark.parametrize("mode", ["latent", "image"])
def test_hires_matches_jax(pipes, mode):
    """SampleSpec → generate → hires, both stages, against the JAX
    pipeline's ``hires``: 16² composed, 32² finished at strength 0.6; the
    second stage's noise (and the image mode's posterior draw) from the
    JAX key schedule of seed ^ 0x9E3779B9."""
    jpipe, tpipe = pipes
    lat = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    kw = dict(height=32, width=32, hires_scale=2.0, hires_strength=0.6,
              hires_mode=mode, num_inference_steps=4, seed=11, latents=lat,
              negative_prompt="blurry")
    ref = jpipe.hires(PROMPTS3[:2], **kw)
    spec = tspec.SampleSpec(**{k: v for k, v in kw.items()})
    got = tpipe.generate(PROMPTS3[:2], spec)
    assert got.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_hires_and_call_refusals(pipes):
    _, tpipe = pipes
    kw = dict(height=32, width=32, num_inference_steps=2)
    with pytest.raises(ValueError, match="hires_scale must be > 1"):
        tpipe.hires(["x"], hires_scale=1.0, **kw)
    with pytest.raises(ValueError, match="multiple of 16"):
        tpipe.hires(["x"], hires_scale=2.0, height=40, width=32,
                    num_inference_steps=2)
    with pytest.raises(ValueError, match="strength cannot be passed"):
        tpipe.hires(["x"], strength=0.5, **kw)
    with pytest.raises(ValueError, match="hires_mode"):
        tpipe.hires(["x"], hires_mode="pixel", **kw)
    pndm = SDPipeline(tpipe.models, dataclasses.replace(
        tpipe.cfg, scheduler="pndm"), tpipe.tokenizer, device="cpu",
        compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="t_start-capable"):
        pndm.hires(["x"], **kw)
    for name, value in (("control_image", np.zeros((32, 32, 3))),
                        ("controlnet_scale", 0.5), ("aesthetic_score", 5.0),
                        ("negative_aesthetic_score", 3.0)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe(["x"], **{name: value}, **kw)
    imgs = tpipe.numpy_to_pil(np.full((2, 4, 4, 3), 0.5, np.float32))
    assert len(imgs) == 2 and imgs[0].size == (4, 4)


@pytest.mark.parametrize("n,hires", [(3, 0.0), (2, 2.0)])
def test_chip_smoke_generate_launch_counts(counted, pipes, n, hires):
    """``chip_smoke.generate_launches`` (the bucket's UNet batch; hires'
    second stage from its strength) against the dispatch on the CPU."""
    cs = _chip_smoke()
    _, tpipe = pipes
    pipe = SDPipeline(tpipe.models, PipelineConfig.tiny("dpm"),
                      tpipe.tokenizer, device="cpu",
                      compute_dtype=torch.float32)
    spec = tspec.SampleSpec(height=32, width=32, num_inference_steps=4,
                            hires_scale=hires, hires_strength=0.7)
    out = pipe.generate(PROMPTS3[:n], spec)
    assert out.shape == (n, 32, 32, 3)
    want = cs.generate_launches(pipe.cfg, n, 4, 32, "dpm",
                                hires_scale=hires, hires_strength=0.7)
    assert counted.get("flash_fixed", 0) == want["flash_fixed"] > 0
    assert counted.get("geglu_ff", 0) == want["geglu_ff"] > 0
