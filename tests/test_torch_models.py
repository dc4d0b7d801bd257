"""sdbc_tpu_torch models against sdbc_tpu's golden activations (tiny config,
fp32, CPU), with the JAX parameters converted by ``load_jax_params``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.models import unet as junet
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
from sdbc_tpu_torch.models import clip as tclip
from sdbc_tpu_torch.models import unet as tunet
from sdbc_tpu_torch.models import vae as tvae
from sdbc_tpu_torch.models.convert import load_jax_params
from tests.torch_threads import one_thread  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "tiny_goldens.npz")


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.fixture(scope="module")
def tcfg():
    return PipelineConfig.tiny()


@pytest.fixture(scope="module")
def np_params(tiny_params):
    return jax.tree.map(np.asarray, tiny_params)


@pytest.fixture(scope="module")
def tmodels(tcfg, np_params):
    return {
        "text_encoder": load_jax_params(tclip.init(tcfg.clip, device="cpu"),
                                        np_params["text_encoder"]),
        "unet": load_jax_params(tunet.init(tcfg.unet, device="cpu"),
                                np_params["unet"]),
        "vae": load_jax_params(tvae.init(tcfg.vae, device="cpu"),
                               np_params["vae"]),
    }


def _unet_inputs(tcfg):
    lat = np.asarray(jax.random.normal(jax.random.key(10), (1, 8, 8, 4)))
    ctx = np.asarray(jax.random.normal(
        jax.random.key(11), (1, tcfg.clip.ctx, tcfg.unet.cross_attention_dim)))
    return torch.from_numpy(np.array(lat)), torch.from_numpy(np.array(ctx))


@torch.no_grad()
def test_clip_golden(tcfg, tmodels, goldens):
    ids = torch.arange(2 * tcfg.clip.ctx).reshape(2, -1) % tcfg.clip.vocab_size
    h = tclip.apply(tmodels["text_encoder"], ids)
    np.testing.assert_allclose(h.numpy(), goldens["clip_out"], atol=1e-4)


@torch.no_grad()
def test_unet_golden(tcfg, tmodels, goldens):
    lat, ctx = _unet_inputs(tcfg)
    eps = tunet.apply(tmodels["unet"], lat, torch.tensor([500]), ctx)
    np.testing.assert_allclose(eps.numpy(), goldens["unet_out"], atol=1e-4)


@torch.no_grad()
def test_vae_decode_golden(tmodels, goldens):
    dec = tvae.decode(tmodels["vae"], torch.from_numpy(goldens["vae_mean"]))
    np.testing.assert_allclose(dec.numpy(), goldens["vae_dec"], atol=1e-4)


@torch.no_grad()
def test_unet_hoisted_temb_equals_inline(tcfg, tmodels):
    lat, ctx = _unet_inputs(tcfg)
    ts = torch.tensor([750, 500, 250, 0])
    tables = tunet.precompute_temb(tmodels["unet"], ts, dtype=torch.float32)
    for i in (0, 2):
        hoisted = tunet.apply(tmodels["unet"], lat, ts[i:i + 1], ctx,
                              attn_impl="inference",
                              temb_proj=tunet.index_temb(tables, i))
        inline = tunet.apply(tmodels["unet"], lat, ts[i:i + 1], ctx,
                             attn_impl="inference")
        np.testing.assert_allclose(hoisted.numpy(), inline.numpy(),
                                   atol=1e-5)


@torch.no_grad()
def test_precompute_temb_matches_jax(tcfg, tiny_params, tmodels):
    ts = np.array([981, 500, 1])
    ref = junet.precompute_temb(tiny_params["unet"], jnp.asarray(ts),
                                junet.UNetConfig.tiny(), dtype=jnp.float32)
    out = tunet.precompute_temb(tmodels["unet"], torch.from_numpy(ts),
                                dtype=torch.float32)
    np.testing.assert_allclose(out["mid"]["resnet2"].numpy(),
                               np.asarray(ref["mid"]["resnet2"]), atol=1e-4)
    np.testing.assert_allclose(out["up"][1]["resnets"][1].numpy(),
                               np.asarray(ref["up"][1]["resnets"][1]),
                               atol=1e-4)


def test_load_jax_params_raises_on_missing_or_extra_leaf(tcfg, np_params):
    tree = {k: v for k, v in np_params["vae"].items()}
    tree.pop("post_quant_conv")
    with pytest.raises(KeyError, match="left unset"):
        load_jax_params(tvae.init(tcfg.vae, device="cpu"), tree)
    tree = dict(np_params["vae"], extra_conv={"w": np.zeros((1, 1, 4, 4))})
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_params(tvae.init(tcfg.vae, device="cpu"), tree)
    bad = dict(np_params["text_encoder"],
               final_ln={"scale": np.ones(7), "bias": np.zeros(7)})
    with pytest.raises(ValueError, match="final_ln.weight"):
        load_jax_params(tclip.init(tcfg.clip, device="cpu"), bad)


def test_parameter_names_follow_jax_tree(tmodels):
    names = dict(tmodels["unet"].named_parameters())
    assert "down.0.attns.0.attn1.q.weight" in names
    assert "up.1.resnets.1.shortcut.weight" in names
    assert names["conv_in.weight"].shape == (3, 3, 4, 32)  # HWIO, as JAX
    assert names["time_mlp.fc1.weight"].shape == (32, 128)  # (in, out)
    assert "layers.1.mlp.fc2.bias" in dict(
        tmodels["text_encoder"].named_parameters())


def test_generator_init_is_seeded(tcfg):
    a = tunet.init(tcfg.unet, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    b = tunet.init(tcfg.unet, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    assert torch.all(a.norm_out.weight == 1) and torch.all(a.conv_in.bias != 0)


def test_deep_transformers_are_refused(tcfg):
    """Depth > 1 transformers build (the SDXL layout: ``blocks.<k>``), and
    gradient checkpointing through them, once refused, runs: both remat
    modes give no remat's output and input gradient."""
    import dataclasses

    cfg = dataclasses.replace(tcfg.unet, transformer_depth=2)
    model = tunet.init(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert "down.0.attns.0.blocks.1.attn1.q.weight" in dict(
        model.named_parameters())
    lat, ctx = _unet_inputs(tcfg)

    def run(**kw):
        x = lat.clone().requires_grad_(True)
        out = tunet.apply(model, x, torch.tensor([1]), ctx, **kw)
        out.square().mean().backward()
        return out.detach(), x.grad

    out, grad = run()
    for mode in ("block", "selective"):
        o, g = run(remat=True, remat_mode=mode)
        torch.testing.assert_close(o, out, rtol=0, atol=0)
        torch.testing.assert_close(g, grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("option", ["control_residuals", "added_cond"])
def test_unet_unported_options_raise(tcfg, tmodels, option):
    """Both options are ported (ControlNet, SDXL) and refuse what JAX
    refuses: residuals of another count than the skips, ``added_cond`` on
    a UNet without the text-time embedding."""
    lat, ctx = _unet_inputs(tcfg)
    value = ((lat,), lat) if option == "control_residuals" else True
    with pytest.raises(ValueError, match=option):
        tunet.apply(tmodels["unet"], lat, torch.tensor([1]), ctx,
                    **{option: value})
