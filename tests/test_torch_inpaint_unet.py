"""The dedicated 9-channel inpainting UNet (the runwayml/sd-inpainting
layout) in the port against sdbc_tpu on the CPU in fp32 at the tiny
config: ``sample(masked_image=...)`` (the masked image's latent from its
own injected draw, [latents, mask, masked latents] on both CFG halves,
with ``cfg_interval`` too), the pipeline's mask binarisation and masked
pixels, and the refusals with JAX's exception types.

The trees are the port's random init, jittered (``tests/
test_torch_controlnet.py``'s helpers).  Tolerances (tests/
test_goldens.py:35-65): 1e-3 a pipeline image."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion import pipeline as jpipeline
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.models import port as jport
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion import pipeline as tpipeline
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               as_modules, init_models)
from sdbc_tpu_torch.models import port as tport
from tests.test_torch_controlnet import jittered, rand, tree_of
from tests.test_torch_samplers import jax_draws
from tests.torch_threads import one_thread  # noqa: F401

IMAGE_ATOL = 1e-3
PROMPTS = ["a gothic novel cover", "a cookbook cover"]
LAT = (2, 16, 16, 4)


def inpaint_cfg(cls):
    cfg = cls.tiny()
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, in_channels=2 * cfg.vae.latent_channels + 1))


@pytest.fixture(scope="module")
def setup():
    tcfg, jcfg = inpaint_cfg(PipelineConfig), inpaint_cfg(JCfg)
    models = init_models(tcfg, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    tree = jittered({k: tree_of(m) for k, m in models.items()}, 5)
    tok = CLIPTokenizer.fallback(tcfg.clip.vocab_size)
    ids = [np.asarray(tok.batch_encode(p, tcfg.clip.ctx), np.int32)
           for p in (PROMPTS, ["blurry", ""])]
    rng = np.random.default_rng(6)
    image = rng.random((2, 32, 32, 3), dtype=np.float32)
    mask_px = np.zeros((2, 32, 32, 1), np.float32)
    mask_px[:, 8:24, 4:20] = 1.0
    return dict(tcfg=tcfg, jcfg=jcfg, tree=tree, ids=ids,
                models=as_modules(tree, tcfg, "cpu"), lat=rand(LAT, 7),
                mask=mask_px[:, ::2, ::2],            # the latent grid
                masked=image * (1.0 - mask_px) + 0.5 * mask_px)


def test_inpaint_configs_match_jax(setup):
    assert setup["tcfg"].is_inpaint_unet and setup["jcfg"].is_inpaint_unet
    assert not PipelineConfig.tiny().is_inpaint_unet
    assert setup["tcfg"].latent_channels == 4
    unet = {"in_channels": 9, "block_out_channels": [32, 64],
            "layers_per_block": 1, "cross_attention_dim": 32,
            "attention_head_dim": 4, "norm_num_groups": 8,
            "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
            "up_block_types": ["UpBlock2D", "CrossAttnUpBlock2D"]}
    assert dataclasses.asdict(tport.unet_config_from_diffusers(unet)) == \
        dataclasses.asdict(setup["tcfg"].unet) == dataclasses.asdict(
            jport.unet_config_from_diffusers(unet))


# DDIM; euler_a (stochastic: the step draws after the masked image's)
# with guidance on the first half of the steps only
CASES = {"ddim": ("ddim", None), "euler_a-cfg_interval": ("euler_a",
                                                          (0.0, 0.5))}


@pytest.mark.parametrize("case", list(CASES))
def test_inpaint_sample_matches_jax(setup, case):
    scheduler, interval = CASES[case]
    s = setup
    key = jax.random.key(13)
    cond, uncond = s["ids"]
    ref = jgraph.sample(
        s["tree"], jnp.asarray(cond), jnp.asarray(uncond),
        jnp.asarray(s["lat"]), key, 7.5,
        cfg=dataclasses.replace(s["jcfg"], scheduler=scheduler),
        num_inference_steps=3, compute_dtype=jnp.float32,
        mask=jnp.asarray(s["mask"]), masked_image=jnp.asarray(s["masked"]),
        cfg_interval=interval)
    d = jax_draws(key, LAT, 0, 3, enc_shape=LAT)
    out = tgraph.sample(
        s["models"], torch.from_numpy(cond).long(),
        torch.from_numpy(uncond).long(), torch.from_numpy(s["lat"]), 7.5,
        cfg=dataclasses.replace(s["tcfg"], scheduler=scheduler),
        num_inference_steps=3, compute_dtype=torch.float32,
        mask=torch.from_numpy(s["mask"]),
        masked_image=torch.from_numpy(s["masked"]), cfg_interval=interval,
        draws={"masked": d["enc"], "step": d["step"]})
    assert out.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=IMAGE_ATOL)


def _captured(monkeypatch, module, make_pipe):
    """The keyword arguments ``module``'s pipeline hands its ``sample``
    for one inpainting call of the UNet (not run)."""
    seen = {}

    def fake(*a, **kw):
        seen.update(kw)
        raise StopIteration

    monkeypatch.setattr(module, "sample", fake)
    img = np.random.default_rng(2).random((32, 32, 3), dtype=np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[5:21, 9:30] = 0.7           # fractional: binarised at 0.5
    mask[0:3, 0:3] = 0.3
    with pytest.raises(StopIteration):
        make_pipe().inpaint(["a", "b", "c"], img, mask,
                            num_inference_steps=3)
    return {k: (None if v is None else np.asarray(v))
            for k, v in seen.items()
            if k in ("mask", "masked_image", "init_image", "t_start")}


def test_pipeline_inpaint_inputs_match_jax(setup, monkeypatch):
    """``SDPipeline.inpaint`` on an inpainting UNet: the pixel mask
    binarised at 0.5, masked pixels set to 0.5, the latent-grid mask
    binarised, padded to the batch bucket (masks of ones), no re-noising
    (t_start 0, no init image) — the JAX pipeline's arrays."""
    from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer

    s = setup
    got = _captured(monkeypatch, tpipeline, lambda: SDPipeline(
        s["models"], s["tcfg"], CLIPTokenizer.fallback(
            s["tcfg"].clip.vocab_size), device="cpu",
        compute_dtype=torch.float32))
    want = _captured(monkeypatch, jpipeline, lambda: jpipeline.SDPipeline(
        s["tree"], s["jcfg"], JTokenizer.fallback(s["jcfg"].clip.vocab_size),
        compute_dtype=jnp.float32))
    assert set(got) == set(want)
    for k in got:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["masked_image"].shape == (4, 32, 32, 3)
    assert set(np.unique(got["mask"])) == {0.0, 1.0}


REFUSALS = {
    "text-to-image": dict(),
    "img2img without mask": dict(init_image=True),
    "masked_image without mask": dict(masked_image=True),
    "init_image with masked_image": dict(masked_image=True, mask=True,
                                         init_image=True),
    "init_latents": dict(masked_image=True, mask=True, init_latents=True),
    "cache_interval": dict(masked_image=True, mask=True, cache_interval=2),
    "base UNet": dict(masked_image=True, mask=True, base=True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_inpaint_refusals_match_jax(setup, case):
    s = setup
    opts = dict(REFUSALS[case])
    base = opts.pop("base", False)
    arrays = {"masked_image": s["masked"], "mask": s["mask"],
              "init_image": s["masked"], "init_latents": s["lat"]}
    kw = {k: (arrays[k] if v is True else v) for k, v in opts.items()}
    cond, uncond = s["ids"]
    jcfg = JCfg.tiny() if base else s["jcfg"]
    with pytest.raises(Exception) as want:
        jgraph.sample(s["tree"], jnp.asarray(cond), jnp.asarray(uncond),
                      jnp.asarray(s["lat"]), jax.random.key(0), 7.5,
                      cfg=jcfg, num_inference_steps=2,
                      compute_dtype=jnp.float32,
                      **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in kw.items()})
    with pytest.raises(want.type, match=re.escape(
            " ".join(str(want.value).split()[:2]))):
        tgraph.sample(s["models"], torch.from_numpy(cond).long(),
                      torch.from_numpy(uncond).long(),
                      torch.from_numpy(s["lat"]), 7.5,
                      cfg=PipelineConfig.tiny() if base else s["tcfg"],
                      num_inference_steps=2, compute_dtype=torch.float32,
                      **{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                         else v for k, v in kw.items()})


def test_pipeline_refuses_text_to_image(setup):
    pipe = SDPipeline(setup["models"], setup["tcfg"],
                      CLIPTokenizer.fallback(setup["tcfg"].clip.vocab_size),
                      device="cpu", compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="dedicated inpainting UNet"):
        pipe(["a"], height=32, width=32, num_inference_steps=2)
