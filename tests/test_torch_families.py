"""The SD-2.x family and the model configs of SD-2.x and SDXL in the port,
against sdbc_tpu on the CPU in fp32: the CLIP towers with the exact-erf
GELU and the projected pooled output, the UNet with per-level heads,
SDXL's UNet with the text-time embedding (inline and hoisted), the SD-2.x
v-prediction sample and its diffusers import, and the CLI's --model_family
sd21.

Tolerances (tests/test_goldens.py:35-65): 1e-4 per model output, 1e-3 for
a pipeline image; configs and imported weights are equal."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.diffusion.pipeline import SDPipeline as JSDPipeline
from sdbc_tpu.models import clip as jclip
from sdbc_tpu.models import port as jport
from sdbc_tpu.models import unet as junet
from sdbc_tpu.models import vae as jvae
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               as_modules)
from sdbc_tpu_torch.models import clip as tclip
from sdbc_tpu_torch.models import port as tport
from sdbc_tpu_torch.models import unet as tunet
from sdbc_tpu_torch.models import vae as tvae
from sdbc_tpu_torch.models.convert import load_jax_params
from tests.torch_threads import one_thread  # noqa: F401

MODEL_ATOL = 1e-4
IMAGE_ATOL = 1e-3


def jittered(tree, seed: int):
    """A parameter tree (numpy) moved off its zero biases and unit scales
    (a trained model's shape: a nonzero final-LN bias makes the token
    weights' mean restoration meaningful)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + np.float32(0.02) * rng.
                        standard_normal(np.shape(a)).astype(np.float32), tree)


def port_init_tree(cfg, seed: int) -> dict:
    """The JAX-layout tree (nested dicts and lists of numpy) of the port's
    random init of ``cfg``'s components, jittered: the JAX package's init
    runs op by op on the CPU, which takes tens of seconds at tiny_xl."""
    from sdbc_tpu_torch.diffusion.pipeline import init_models
    from sdbc_tpu_torch.models.port import module_jax_tree

    models = init_models(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    return jittered({name: module_jax_tree(m) for name, m in models.items()},
                    seed + 1)


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def rand(shape, seed: int):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --------------------------------------------------------------- configs

CONFIGS = [("clip", "sd2"), ("clip", "sdxl_g"), ("unet", "sd21"),
           ("unet", "sdxl"), ("unet", "sdxl_refiner"), ("unet", "tiny_xl"),
           ("vae", "sdxl"), ("pipeline", "sd21"), ("pipeline", "sdxl"),
           ("pipeline", "sdxl_refiner"), ("pipeline", "tiny_xl"),
           ("pipeline", "tiny_xl_refiner")]
_CLASSES = {"clip": (jclip.CLIPTextConfig, tclip.CLIPTextConfig),
            "unet": (junet.UNetConfig, tunet.UNetConfig),
            "vae": (jvae.VAEConfig, tvae.VAEConfig),
            "pipeline": (JCfg, PipelineConfig)}


def _fields(cfg) -> dict:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _fields(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)
                if f.name != "controlnet"}
    return cfg


@pytest.mark.parametrize("kind,name", CONFIGS,
                         ids=[f"{k}.{n}" for k, n in CONFIGS])
def test_family_configs_match_jax(kind, name):
    jcls, tcls = _CLASSES[kind]
    want, got = getattr(jcls, name)(), getattr(tcls, name)()
    assert _fields(got) == _fields(want)
    if kind == "unet":
        assert got.heads_per_level == want.heads_per_level
        assert got.depth_per_level == want.depth_per_level
    if kind == "pipeline":
        assert (got.is_sdxl, got.refiner, got.vae_scale) == \
            (want.is_sdxl, want.refiner, want.vae_scale)


# ------------------------------------------------------------------ CLIP

def _clip_cfgs(**kw):
    return (dataclasses.replace(jclip.CLIPTextConfig.tiny(), **kw),
            dataclasses.replace(tclip.CLIPTextConfig.tiny(), **kw))


@pytest.mark.parametrize("skip", [0, 1])
def test_clip_gelu_matches_jax(skip):
    """SD-2.x's tower: the exact-erf GELU, with and without CLIP skip."""
    jc, tc = _clip_cfgs(act="gelu")
    params = jittered(jclip.init(jax.random.key(1), jc), 2)
    ids = np.random.default_rng(3).integers(0, 999, (2, jc.ctx))
    want = jax.jit(functools.partial(jclip.apply, cfg=jc, skip_layers=skip))(
        params, jnp.asarray(ids))
    model = load_jax_params(tclip.init(tc, device="cpu"), as_np(params))
    with torch.no_grad():
        got = tclip.apply(model, torch.from_numpy(ids), skip_layers=skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODEL_ATOL)


def test_clip_projected_pooled_matches_jax():
    """SDXL's bigG: the penultimate state without the final LayerNorm and
    the projected pooled output at the first end token."""
    jc, tc = _clip_cfgs(act="gelu", projection_dim=16)
    params = jittered(jclip.init(jax.random.key(4), jc), 5)
    ids = np.random.default_rng(6).integers(0, 998, (3, jc.ctx))
    ids[0, 5] = ids[1, 9] = ids[1, 12] = jc.vocab_size - 1  # row 2: none
    wh, wp = jax.jit(functools.partial(jclip.apply_with_pooled, cfg=jc,
                                       skip_layers=1))(params,
                                                       jnp.asarray(ids))
    model = load_jax_params(tclip.init(tc, device="cpu"), as_np(params))
    with torch.no_grad():
        th, tp = tclip.apply_with_pooled(model, torch.from_numpy(ids),
                                         skip_layers=1)
        final = tclip.apply(model, torch.from_numpy(ids), final_ln=False,
                            skip_layers=1)
    assert tp.shape == (3, 16)
    np.testing.assert_allclose(th.numpy(), np.asarray(wh), atol=MODEL_ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(wp), atol=MODEL_ATOL)
    np.testing.assert_array_equal(final.numpy(), th.numpy())


# ------------------------------------------------------------------ UNet

def _heads_cfg(mod):
    """A tiny SD-2.x-shaped UNet: per-level heads at one head dim."""
    return dataclasses.replace(mod.UNetConfig.tiny(), attention_heads=(2, 4),
                               cross_attn_blocks=(True, True))


UNETS = {"per-level heads": (_heads_cfg, None),
         "tiny_xl added_cond": (lambda mod: mod.UNetConfig.tiny_xl(), 40)}


@functools.lru_cache(maxsize=None)
def _unet_case(name):
    """(port config, JAX tree, inputs, JAX output) of a UNet case; the JAX
    forward compiled once."""
    make, add_dim = UNETS[name]
    jc, tc = make(junet), make(tunet)
    params = jittered(junet.init(jax.random.key(7), jc), 8)
    lat = rand((2, 8, 8, 4), 9)
    ctx = rand((2, 16, jc.cross_attention_dim), 10)
    t = np.array([30, 700])
    ac = None if add_dim is None else rand((2, add_dim), 11)
    fwd = jax.jit(functools.partial(junet.apply, cfg=jc, attn_impl="xla"))
    want = fwd(params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
               added_cond=None if ac is None else jnp.asarray(ac))
    return tc, params, (lat, t, ctx, ac), np.asarray(want)


@pytest.mark.parametrize("name", sorted(UNETS))
@pytest.mark.parametrize("impl", ["auto", "inference"])
def test_unet_matches_jax(name, impl):
    tc, params, (lat, t, ctx, ac), want = _unet_case(name)
    model = load_jax_params(tunet.init(tc, device="cpu"), as_np(params))
    with torch.no_grad():
        got = tunet.apply(model, torch.from_numpy(lat), torch.from_numpy(t),
                          torch.from_numpy(ctx), attn_impl=impl,
                          added_cond=None if ac is None
                          else torch.from_numpy(ac))
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_ATOL)


def test_precompute_temb_added_cond_matches_inline_and_jax():
    """The hoisted per-sample tables (T, N, 1, 1, cout) give the inline
    embedding's forward, and equal the JAX package's tables."""
    jc, tc = junet.UNetConfig.tiny_xl(), tunet.UNetConfig.tiny_xl()
    params = jittered(junet.init(jax.random.key(12), jc), 13)
    model = load_jax_params(tunet.init(tc, device="cpu"), as_np(params))
    ts, ac = np.array([900, 500, 100]), rand((2, 40), 14)
    lat, ctx = rand((2, 8, 8, 4), 15), rand((2, 16, 64), 16)
    want = jax.jit(functools.partial(junet.precompute_temb, cfg=jc,
                                     dtype=jnp.float32))(
        params, jnp.asarray(ts), added_cond=jnp.asarray(ac))
    with torch.no_grad():
        tables = tunet.precompute_temb(model, torch.from_numpy(ts),
                                       torch.float32,
                                       added_cond=torch.from_numpy(ac))
        hoisted = tunet.apply(model, torch.from_numpy(lat), None,
                              torch.from_numpy(ctx),
                              temb_proj=tunet.index_temb(tables, 1))
        inline = tunet.apply(model, torch.from_numpy(lat),
                             torch.tensor([500, 500]), torch.from_numpy(ctx),
                             added_cond=torch.from_numpy(ac))
    got_leaves = jax.tree.leaves(tunet.map_temb(lambda a: a.numpy(), tables))
    want_leaves = jax.tree.leaves(as_np(want))
    assert [a.shape for a in got_leaves] == [a.shape for a in want_leaves]
    assert got_leaves[0].shape[:4] == (3, 2, 1, 1)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, b, atol=MODEL_ATOL)
    np.testing.assert_allclose(hoisted.numpy(), inline.numpy(),
                               atol=MODEL_ATOL)
    with pytest.raises(ValueError, match="added_cond"):
        tunet.precompute_temb(model, torch.from_numpy(ts), torch.float32)
    with pytest.raises(ValueError, match="pass only one"):
        tunet.apply(model, torch.from_numpy(lat), None,
                    torch.from_numpy(ctx),
                    temb_proj=tunet.index_temb(tables, 1),
                    added_cond=torch.from_numpy(ac))


# --------------------------------------------------- SD-2.x: v-prediction

def _sd2_tiny(mod_cfg, clip_mod, unet_mod):
    """The tiny config of ``--tiny --model_family sd21`` with SD-2.x's
    other traits: the GELU tower and per-level heads."""
    cfg = mod_cfg.tiny("ddim")
    return dataclasses.replace(
        cfg, clip=dataclasses.replace(cfg.clip, act="gelu"),
        unet=_heads_cfg(unet_mod),
        schedule=dataclasses.replace(cfg.schedule,
                                     prediction_type="v_prediction"))


@pytest.fixture(scope="module")
def sd2():
    jc = _sd2_tiny(JCfg, jclip, junet)
    tc = _sd2_tiny(PipelineConfig, tclip, tunet)
    ks = jax.random.split(jax.random.key(21), 3)
    params = jittered({"text_encoder": jclip.init(ks[0], jc.clip),
                       "unet": junet.init(ks[1], jc.unet),
                       "vae": jvae.init(ks[2], jc.vae)}, 22)
    return jc, tc, params


@pytest.mark.parametrize("scheduler", ["ddim", "dpm"])
def test_sd21_v_prediction_sample_matches_jax(sd2, scheduler):
    jc, tc, params = sd2
    jc = dataclasses.replace(jc, scheduler=scheduler)
    tc = dataclasses.replace(tc, scheduler=scheduler)
    lat = rand((2, 16, 16, 4), 23)
    kw = dict(height=32, width=32, num_inference_steps=4, latents=lat,
              negative_prompt=["blurry", ""])
    prompts = ["a gothic novel cover", "a cookbook cover"]
    want = JSDPipeline(params, jc, JTokenizer.fallback(jc.clip.vocab_size),
                       compute_dtype=jnp.float32)(prompts, **kw)
    got = SDPipeline(as_np(params), tc, CLIPTokenizer.fallback(
        tc.clip.vocab_size), device="cpu", compute_dtype=torch.float32)(
        prompts, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=IMAGE_ATOL)


def test_sd21_diffusers_import_matches_jax(sd2, tmp_path):
    """A tiny SD-2.x directory written by the JAX exporter: the port's
    import gives the exported tree and the JAX importer's config."""
    jc, tc, params = sd2
    root = jport.export_diffusers_checkpoint(params, jc, str(tmp_path))
    got = tport.port_diffusers_checkpoint(root)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), got, as_np(params))
    cfg = tport.pipeline_config_from_diffusers(root)
    assert _fields(cfg) == _fields(jport.pipeline_config_from_diffusers(root))
    assert cfg.unet.attention_heads == (2, 4)
    assert cfg.schedule.prediction_type == "v_prediction"
    a = as_modules(got, cfg, "cpu")
    b = as_modules(as_np(params), tc, "cpu")
    for name in a:
        for (n, x), y in zip(a[name].state_dict().items(),
                             b[name].state_dict().values()):
            assert torch.equal(x, y), (name, n)


def _jax_family(name, tiny, scheduler):
    """The JAX CLI's ``--model_family name [--tiny]`` config
    (``sdbc_tpu/cli/common.py``'s rule, without its weight init)."""
    if not tiny:
        return getattr(JCfg, name)(scheduler)
    if name == "sdxl":
        return JCfg.tiny_xl(scheduler)
    cfg = JCfg.tiny(scheduler)
    if name == "sd21":
        cfg = dataclasses.replace(cfg, schedule=dataclasses.replace(
            cfg.schedule, prediction_type="v_prediction"))
    return cfg


FAMILIES = [(f, t) for f in ("sd15", "sd21", "sdxl") for t in (False, True)]


@pytest.mark.parametrize("name,tiny", FAMILIES,
                         ids=[f + ("-tiny" if t else "") for f, t in FAMILIES])
def test_family_config_follows_the_jax_cli(name, tiny):
    """``PipelineConfig.family``, which the CLIs and the card check both
    read, gives the JAX CLI's config for every family, full and tiny."""
    got = PipelineConfig.family(name, tiny, "dpm")
    assert _fields(got) == _fields(_jax_family(name, tiny, "dpm"))
    assert got.is_sdxl == (name == "sdxl")


def test_cli_model_family_sd21(tmp_path):
    """``--tiny --model_family sd21``: the JAX CLI's config (tiny with
    v-prediction) and an image on the CPU."""
    from sdbc_tpu.cli import inference as jinf
    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as tinf

    flags = ["--tiny", "--model_family", "sd21"]
    args = tinf.build_parser().parse_args(flags + ["--device", "cpu"])
    _, cfg = common.resolve_params_cfg(args)
    jargs = jinf.build_parser().parse_args(flags)
    assert _fields(cfg) == _fields(jinf.common.resolve_params_cfg(jargs)[1])
    assert cfg.schedule.prediction_type == "v_prediction"
    tinf.main(flags + ["--device", "cpu", "--no-bf16", "--mode",
                       "enter_prompt", "--prompt", "a cover",
                       "--num_inference_steps", "2", "--save_dir",
                       str(tmp_path), "--freeu", "auto"])
    assert os.path.exists(tmp_path / "dev inference" / "a cover.png")


def test_sd_family_ignores_aesthetic_scores(sd2):
    """Outside a refiner the aesthetic scores condition nothing (the JAX
    package reads them only for the refiner's time ids)."""
    _, tc, params = sd2
    pipe = SDPipeline(as_np(params), tc, CLIPTokenizer.fallback(
        tc.clip.vocab_size), device="cpu", compute_dtype=torch.float32)
    kw = dict(height=32, width=32, num_inference_steps=2,
              latents=rand((1, 16, 16, 4), 24))
    np.testing.assert_array_equal(
        pipe(["a cover"], **kw),
        pipe(["a cover"], aesthetic_score=3.0, negative_aesthetic_score=1.0,
             **kw))


def test_sample_cond_ids2_ignored_outside_sdxl(sd2):
    """``graph.sample`` takes the SDXL arguments for every family, as the
    JAX ``sample`` does; a single-encoder config ignores them."""
    from sdbc_tpu_torch.diffusion import graph as tgraph

    _, tc, params = sd2
    models = as_modules(as_np(params), tc, "cpu")
    ids = torch.zeros((1, tc.clip.ctx), dtype=torch.int64)
    lat = torch.from_numpy(rand((1, 16, 16, 4), 25))
    kw = dict(cfg=tc, num_inference_steps=2, compute_dtype=torch.float32)
    a = tgraph.sample(models, ids, ids, lat, 7.5, **kw)
    b = tgraph.sample(models, ids, ids, lat, 7.5, cond_ids2=ids,
                      uncond_ids2=ids, **kw)
    assert torch.equal(a, b)
