"""The sampling options of the port's ``sample`` (cfg_interval, guidance
rescale, clip skip, FreeU, DeepCache, token weights, img2img from an image
or latents, inpainting) against sdbc_tpu's on the CPU at the tiny config
in fp32; the UNet's FreeU and DeepCache split against the JAX
``unet.apply``; the refused option combinations; the ``SDPipeline``
surface that routes to them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from sdbc_tpu.models import unet as junet
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               as_modules)
from sdbc_tpu_torch.models import unet as tunet
from tests.test_torch_samplers import (ATOL, LAT_SHAPE, ids, latents,  # noqa
                                       models, one_thread, run_both)
from tests.torch_threads import one_thread  # noqa: F401

IMG_SHAPE = (2, 32, 32, 3)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(6).uniform(size=IMG_SHAPE).astype(
        np.float32)


@pytest.fixture(scope="module")
def mask():
    """Regenerate the left half of each latent."""
    m = np.zeros(LAT_SHAPE[:3] + (1,), np.float32)
    m[:, :, :LAT_SHAPE[2] // 2] = 1.0
    return m


OPTIONS = {
    "cfg_interval": ("ddim", 4, dict(cfg_interval=(0.25, 0.75))),
    "cfg_interval-heun-karras": ("heun", 3, dict(cfg_interval=(0.3, 0.7),
                                                 use_karras_sigmas=True)),
    "guidance_rescale": ("dpm", 3, dict(guidance_rescale=0.7)),
    "clip_skip": ("ddim", 3, dict(clip_skip=2)),
    "freeu": ("ddim", 3, dict(freeu=tunet.FREEU_SD15)),
    "cache_interval-ddim": ("ddim", 4, dict(cache_interval=2)),
    "cache_interval-dpm-tail1": ("dpm", 4, dict(cache_interval=2,
                                                cache_tail=1)),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(tiny_params, models, ids, latents, name):
    scheduler, steps, kw = OPTIONS[name]
    ref, out = run_both(tiny_params, models, ids, latents, scheduler, steps,
                        **kw)
    assert out.shape == ref.shape == IMG_SHAPE
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_token_weights_match_jax(tiny_params, ids, latents):
    """On a text encoder whose final LayerNorm has a nonzero bias, as a
    trained CLIP's has: at the zero init the hidden states' mean is
    rounding noise (~1e-9), under the mean restoration's 1e-7 guard, and
    the restoration would not run."""
    cfg = PipelineConfig.tiny()
    rng = np.random.default_rng(8)
    params = dict(tiny_params)
    te = dict(params["text_encoder"])
    te["final_ln"] = dict(te["final_ln"], bias=jnp.asarray(
        rng.normal(0.1, 0.1, cfg.clip.hidden).astype(np.float32)))
    params["text_encoder"] = te
    models = as_modules(jax.tree.map(np.asarray, params), cfg, "cpu")
    w_c, w_u = (rng.uniform(0.5, 1.5, (2, cfg.clip.ctx)).astype(np.float32)
                for _ in range(2))
    ref, out = run_both(params, models, ids, latents, "ddim", 3,
                        cond_weights=w_c, uncond_weights=w_u)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    plain, _ = run_both(params, models, ids, latents, "ddim", 3)
    assert np.abs(plain - ref).max() > 10 * ATOL  # the weights moved it


# img2img / inpainting: (scheduler, karras, t_start, with mask); the
# stochastic ones check that the posterior's ε comes before the step draws
IMG2IMG = {
    "ddim": ("ddim", False, 1, False),
    "euler_a-karras": ("euler_a", True, 1, False),
    "ddim-inpaint": ("ddim", False, 1, True),
    "ddpm-inpaint": ("ddpm", False, 2, True),
    "dpm-karras-inpaint": ("dpm", True, 1, True),
}


@pytest.mark.parametrize("name", list(IMG2IMG))
def test_init_image_matches_jax(tiny_params, models, ids, latents, image,
                                mask, name):
    scheduler, karras, t_start, masked = IMG2IMG[name]
    kw = dict(use_karras_sigmas=karras) if karras else {}
    if masked:
        kw["mask"] = mask
    ref, out = run_both(tiny_params, models, ids, latents, scheduler, 4,
                        lo=t_start, enc_shape=LAT_SHAPE, init_image=image,
                        t_start=t_start, **kw)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_init_latents_matches_jax(tiny_params, models, ids, latents):
    init = np.random.default_rng(9).standard_normal(LAT_SHAPE).astype(
        np.float32)
    ref, out = run_both(tiny_params, models, ids, latents, "dpm", 4, lo=2,
                        init_latents=init, t_start=2, decode=False)
    np.testing.assert_allclose(out, ref, atol=ATOL)


# ---------------------------------------------------------------------------
# the UNet's FreeU and DeepCache split against the JAX UNet


@pytest.fixture(scope="module")
def unet_inputs():
    cfg = PipelineConfig.tiny()
    rng = np.random.default_rng(10)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, cfg.clip.ctx, cfg.unet.cross_attention_dim)
                              ).astype(np.float32)
    return lat, np.array([17, 903], np.int64), ctx


def _both_unets(tiny_params, models, inputs, **kw):
    lat, t, ctx = inputs
    jcfg = JPipelineConfig.tiny().unet
    ref = junet.apply(tiny_params["unet"], jnp.asarray(lat),
                      jnp.asarray(t, jnp.int32), jnp.asarray(ctx), jcfg,
                      **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v) for k, v in kw.items()})
    with torch.no_grad():
        out = tunet.apply(models["unet"], torch.from_numpy(lat),
                          torch.from_numpy(t), torch.from_numpy(ctx),
                          **{k: (torch.from_numpy(v)
                                 if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()})
    return ref, out


@pytest.mark.parametrize("cache_tail", [0, 1])
def test_unet_deep_split_matches_jax(tiny_params, models, unet_inputs,
                                     cache_tail):
    lat, t, ctx = (torch.from_numpy(a) for a in unet_inputs)
    with torch.no_grad():
        plain = tunet.apply(models["unet"], lat, t, ctx)
        for kw in (dict(cache_tail=cache_tail),
                   dict(cache_tail=cache_tail, return_deep=True)):
            out = tunet.apply(models["unet"], lat, t, ctx, **kw)
            out = out[0] if isinstance(out, tuple) else out
            # the uncached forward is today's forward, bit for bit
            assert torch.equal(out, plain)
    (jout, jdeep), (out, deep) = _both_unets(
        tiny_params, models, unet_inputs, return_deep=True,
        cache_tail=cache_tail)
    np.testing.assert_allclose(deep.numpy(), np.asarray(jdeep), atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-4)
    # a reuse step: the shallow head and fresh tail on another input's trunk
    cached = np.random.default_rng(11).standard_normal(
        tuple(deep.shape)).astype(np.float32)
    jref, out = _both_unets(tiny_params, models, unet_inputs,
                            cached_deep=cached, cache_tail=cache_tail)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=1e-4)


def test_unet_freeu_matches_jax(tiny_params, models, unet_inputs):
    ref, out = _both_unets(tiny_params, models, unet_inputs,
                           freeu=tunet.FREEU_SD15)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    lat, t, ctx = (torch.from_numpy(a) for a in unet_inputs)
    with torch.no_grad():
        plain = tunet.apply(models["unet"], lat, t, ctx)
        # FreeU changes the output, and unit scales give today's bits
        assert not torch.allclose(out, plain, atol=1e-3)
        assert torch.equal(tunet.apply(models["unet"], lat, t, ctx,
                                       freeu=(1.0, 1.0, 1.0, 1.0)), plain)


@pytest.mark.parametrize("hw,threshold,scale", [((16, 16), 1, 0.2),
                                                ((9, 12), 2, 0.9)])
def test_fourier_filter_matches_jax(hw, threshold, scale):
    x = np.random.default_rng(12).standard_normal((2,) + hw + (5,)).astype(
        np.float32)
    ref = junet.fourier_filter(jnp.asarray(x), threshold, scale)
    out = tunet.fourier_filter(torch.from_numpy(x), threshold, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert tunet.FREEU_SD21 == junet.FREEU_SD21
    assert tunet.FREEU_SDXL == junet.FREEU_SDXL


# ---------------------------------------------------------------------------
# refusals: each combination the JAX package refuses raises its exception
# type in both packages (nothing is compiled)

_Z_IMG = np.zeros((1, 32, 32, 3), np.float32)
_Z_MASK = np.zeros((1, 16, 16, 1), np.float32)
_Z_LAT = np.zeros((1, 16, 16, 4), np.float32)
REFUSED = {
    "cache_interval-pndm": ("pndm", {}, dict(cache_interval=2)),
    "init_image-pndm": ("pndm", {}, dict(init_image=_Z_IMG)),
    "t_start-lms": ("lms", {}, dict(t_start=1)),
    "init_latents+init_image": ("ddim", {}, dict(init_latents=_Z_LAT,
                                                 init_image=_Z_IMG)),
    "trailing-pndm": ("pndm", dict(timestep_spacing="trailing"), {}),
    "zero_snr-dpm": ("dpm", dict(rescale_zero_snr=True,
                                 prediction_type="v_prediction"), {}),
    "zero_snr-epsilon": ("ddim", dict(rescale_zero_snr=True), {}),
    "mask-unipc": ("unipc", {}, dict(init_image=_Z_IMG, mask=_Z_MASK)),
    "mask-without-init": ("ddim", {}, dict(mask=_Z_MASK)),
    "karras-ddim": ("ddim", {}, dict(use_karras_sigmas=True)),
    "cfg_interval-range": ("ddim", {}, dict(cfg_interval=(0.6, 0.2))),
    "cfg_interval+cache": ("ddim", {}, dict(cfg_interval=(0.1, 0.6),
                                            cache_interval=2)),
    "cfg_interval-pndm": ("pndm", {}, dict(cfg_interval=(0.1, 0.6))),
    "t_start-range": ("ddim", {}, dict(t_start=3)),
    "t_end-unipc": ("unipc", {}, dict(t_end=1)),
    "t_end-before-start": ("ddim", {}, dict(t_start=2, t_end=1)),
    "t_end+mask": ("ddim", {}, dict(init_image=_Z_IMG, mask=_Z_MASK,
                                    t_end=1)),
    "steps-0": ("ddim", {}, dict(num_inference_steps=0)),
    "unknown-scheduler": ("ddim2", {}, {}),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_combination_raises_like_jax(tiny_params, models, name):
    import dataclasses

    from sdbc_tpu.diffusion import schedulers as jsched
    from sdbc_tpu_torch.diffusion import schedulers as tsched

    scheduler, schedule, kw = REFUSED[name]
    kw = {"num_inference_steps": 2, **kw}
    jcfg = dataclasses.replace(JPipelineConfig.tiny(scheduler),
                               schedule=jsched.ScheduleConfig(**schedule))
    tcfg = dataclasses.replace(PipelineConfig.tiny(scheduler),
                               schedule=tsched.ScheduleConfig(**schedule))
    ids = np.zeros((1, jcfg.clip.ctx), np.int32)
    with pytest.raises(Exception) as ref:
        jgraph.sample(tiny_params, jnp.asarray(ids), jnp.asarray(ids),
                      jnp.asarray(_Z_LAT), jax.random.key(0), 7.5, cfg=jcfg,
                      compute_dtype=jnp.float32,
                      **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v) for k, v in kw.items()})
    with pytest.raises(ref.type):
        tgraph.sample(models, torch.from_numpy(ids).long(),
                      torch.from_numpy(ids).long(), torch.from_numpy(_Z_LAT),
                      7.5, cfg=tcfg, compute_dtype=torch.float32,
                      generator=torch.Generator(),
                      **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                             else v) for k, v in kw.items()})
    assert ref.type is ValueError


def test_cond_uncond_widths_must_agree(models):
    cfg = PipelineConfig.tiny()
    ids = torch.zeros((1, cfg.clip.ctx), dtype=torch.int64)
    with pytest.raises(ValueError, match="widths differ"):
        tgraph.sample(models, ids, torch.cat([ids, ids], dim=1),
                      torch.zeros(LAT_SHAPE[1:])[None], 7.5, cfg=cfg,
                      num_inference_steps=2, compute_dtype=torch.float32)


def test_stochastic_scheduler_needs_generator_or_draws(models):
    cfg = PipelineConfig.tiny("euler_a")
    ids = torch.zeros((1, cfg.clip.ctx), dtype=torch.int64)
    with pytest.raises(ValueError, match="Generator"):
        tgraph.sample(models, ids, ids, torch.zeros(LAT_SHAPE[1:])[None],
                      7.5, cfg=cfg, num_inference_steps=2,
                      compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# host helpers and the SDPipeline surface


def test_host_helpers_match_jax():
    for steps, strength in ((50, 0.8), (10, 0.6), (4, 1.0), (25, 0.05)):
        assert tgraph.img2img_t_start(steps, strength) == \
            jgraph.img2img_t_start(steps, strength)
    with pytest.raises(ValueError):
        tgraph.img2img_t_start(10, 0.0)
    rng = np.random.default_rng(13)
    img = (rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tgraph.preprocess_image(img, 32, 32),
                                  jgraph.preprocess_image(img, 32, 32))
    m = (rng.uniform(size=(2, 32, 32)) > 0.7).astype(np.float32)
    np.testing.assert_array_equal(tgraph.preprocess_mask(m, 16, 16),
                                  jgraph.preprocess_mask(m, 16, 16))
    for bad in (np.zeros((32, 31), np.float32), m + 1.0):
        with pytest.raises(ValueError):
            tgraph.preprocess_mask(bad, 16, 16)


@pytest.fixture(scope="module")
def pipe(models):
    cfg = PipelineConfig.tiny()
    return SDPipeline(models, cfg, CLIPTokenizer.fallback(cfg.clip.vocab_size),
                      device="cpu", compute_dtype=torch.float32)


def test_pipeline_img2img_and_inpaint_route_to_sample(pipe, image, mask):
    """``img2img``/``inpaint`` give ``sample``'s result with the strength's
    start index, the preprocessed inputs and the seed's generator."""
    prompts = ["a book cover", "a map"]
    lat = np.random.default_rng(14).standard_normal(LAT_SHAPE).astype(
        np.float32)
    ids = pipe.tokenize(prompts)
    uids = pipe.tokenize(["", ""])
    for inpaint in (False, True):
        kw = dict(strength=0.5, num_inference_steps=4, latents=lat, seed=7)
        out = (pipe.inpaint(prompts, image, mask[..., 0], **kw) if inpaint
               else pipe.img2img(prompts, image, **kw))
        ref = tgraph.sample(
            pipe.models, ids, uids, torch.from_numpy(lat), 7.5, cfg=pipe.cfg,
            num_inference_steps=4, compute_dtype=torch.float32,
            init_image=torch.from_numpy(image), t_start=2,
            mask=torch.from_numpy(mask) if inpaint else None,
            generator=torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(out, ref.numpy())
    with pytest.raises(ValueError, match="requires init_image"):
        pipe(prompts, mask_image=mask, num_inference_steps=2)


def test_pipeline_options_route_to_sample(pipe):
    """The SD-1.x options of ``__call__`` reach ``sample`` unchanged;
    denoising_end/start split one run at the same grid index, and
    num_images_per_prompt repeats each prompt with its own latents."""
    kw = dict(height=32, width=32, num_inference_steps=4, seed=3,
              guidance_rescale=0.5, clip_skip=2, freeu=(1.1, 1.2, 0.9, 0.8))
    full = pipe(["a cover"], **kw)
    ids, uids = pipe.tokenize(["a cover"]), pipe.tokenize([""])
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn((1,) + LAT_SHAPE[1:], generator=gen)
    ref = tgraph.sample(pipe.models, ids, uids, lat, 7.5, cfg=pipe.cfg,
                        num_inference_steps=4, compute_dtype=torch.float32,
                        guidance_rescale=0.5, clip_skip=2,
                        freeu=(1.1, 1.2, 0.9, 0.8), generator=gen)
    np.testing.assert_array_equal(full, ref.numpy())
    head = pipe(["a cover"], denoising_end=0.5, decode=False, **kw)
    assert head.shape == (1,) + LAT_SHAPE[1:]
    tail = pipe(["a cover"], denoising_start=0.5, latents=head, **kw)
    np.testing.assert_allclose(tail, full, atol=1e-5)
    many = pipe(["a cover", "a map"], height=32, width=32,
                num_images_per_prompt=2, num_inference_steps=2, decode=False)
    assert many.shape == (4,) + LAT_SHAPE[1:]
    assert not np.allclose(many[0], many[1])
    with pytest.raises(ValueError, match="cfg_interval"):
        pipe(["a cover"], cfg_interval=(0.1,), num_inference_steps=2)


# ---------------------------------------------------------------------------
# chip_smoke.py's launch counts of the samplers, held to the dispatch on the
# CPU: the device checks patched to "card", each kernel entry counted (on a
# CPU tensor each still computes its plain version)


@pytest.fixture
def counted(monkeypatch):
    from sdbc_tpu_torch.ops import attention as tattn
    from sdbc_tpu_torch.ops import flash_attention as tflash
    from sdbc_tpu_torch.ops import geglu_ff as tgeglu

    for var in ("SDBC_GN_FUSED", "SDBC_ATTN_IMPL", "SDBC_ATTN_CROSS",
                "SDBC_FLASH_MAX_ROWS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tattn, "_on_cuda", lambda t: True)

    def eligible_on_card(y):  # the rule with "tensor on CUDA" taken as met
        rows, c = y.shape[0] * y.shape[1], y.shape[-1]
        return c <= tgeglu._MAX_C and \
            rows % min(tgeglu._default_block(c), rows) == 0

    monkeypatch.setattr(tgeglu, "ff_fused_eligible", eligible_on_card)
    counts = {}

    def wrap(mod, name, key):
        orig = getattr(mod, name)

        def counting(*args, **kw):
            counts[key] = counts.get(key, 0) + 1
            return orig(*args, **kw)
        monkeypatch.setattr(mod, name, counting)

    wrap(tflash, "flash_fwd", "flash_fwd")
    wrap(tflash, "flash_attention_fixed", "flash_fixed")
    wrap(tflash, "flash_attention_fixed_bshd", "flash_fixed")
    wrap(tgeglu, "geglu_ff", "geglu_ff")
    return counts


def _chip_smoke():
    from tests.test_torch_remat import _chip_smoke as load

    return load()


# (scheduler, steps, sample options): the paths whose evaluation counts
# differ from one a step
LAUNCH_RUNS = [
    ("heun", 3, dict(use_karras_sigmas=True, cfg_interval=(0.3, 0.7))),
    ("heun", 4, dict(t_end=3)),
    ("pndm", 3, {}),
    ("lms", 3, {}),
    ("ddim", 4, dict(cache_interval=2, cache_tail=1)),
    ("dpm", 5, dict(cache_interval=2, init_image="img", t_start=1)),
    ("ddpm", 4, dict(init_image="img", mask="mask", t_start=2)),
    ("euler_a", 4, dict(t_end=3, decode=False)),
]


@pytest.mark.parametrize("run", range(len(LAUNCH_RUNS)))
def test_chip_smoke_sampler_launch_counts(counted, models, image, mask, run):
    cs = _chip_smoke()
    scheduler, n, opts = LAUNCH_RUNS[run]
    cfg = PipelineConfig.tiny(scheduler)
    kw = {k: {"img": torch.from_numpy(image),
              "mask": torch.from_numpy(mask)}.get(v, v)
          if isinstance(v, str) else v for k, v in opts.items()}
    ids = torch.zeros((2, cfg.clip.ctx), dtype=torch.int64)
    tgraph.sample(models, ids, ids, torch.zeros(LAT_SHAPE), 7.5, cfg=cfg,
                  num_inference_steps=n, compute_dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0), **kw)
    evals = cs.evals_of(scheduler, n, opts)
    want = cs.sampler_launches(cfg, 16, 2, evals, opts.get("cache_tail", 0))
    # the tiny VAE's 64-wide mid attention takes the training flash kernel
    # in each encode and decode
    vae = opts.get("decode", True) + ("init_image" in opts)
    assert counted.get("flash_fixed", 0) == want["flash_fixed"] > 0
    assert counted.get("geglu_ff", 0) == want["geglu_ff"] > 0
    assert counted.get("flash_fwd", 0) == vae
    if opts.get("cache_interval"):
        assert "reuse" in evals


def test_chip_smoke_sampler_evals():
    """The evaluation counts the chip run holds its launches to."""
    cs = _chip_smoke()
    assert len(cs.sampler_evals("heun", 10)) == 19
    assert len(cs.sampler_evals("pndm", 10)) == 11
    assert len(cs.sampler_evals("ddim", 10, t_start=4)) == 6
    ev = cs.sampler_evals("ddim", 10, cfg_interval=(0.1, 0.6))
    assert ev.count("guided") == 5 and ev.count("cond") == 5
    ev = cs.sampler_evals("ddim", 10, cache_interval=3)
    assert ev.count("guided") == 4 and ev.count("reuse") == 6
    sd = PipelineConfig.sd15()
    assert cs.expected_launches(sd, 64, 8) == (15, 10)
    assert cs.expected_launches(sd, 64, 4) == (15, 10)
    # a reuse step at SD-1.5: down[0]'s two transformers and up[-1]'s three
    assert cs.shallow_launches(sd, 64, 8) == (5, 5)
    assert cs.shallow_launches(sd, 64, 8, cache_tail=1) == (1, 1)
