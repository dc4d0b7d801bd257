"""The port's UNet and VAE against the independent diffusers-0.7.2 NumPy
mirror (``tests/diffusers_mirror.py``), on a tiny JAX parameter tree
loaded with ``load_jax_params`` — the counterpart of
``tests/test_numpy_mirror.py``, at its inputs and tolerances.  The mirror
shares no code with either package, so a slip in the port's GEGLU split,
attention scale, GroupNorm eps, skip order or time embedding shows here
even where the JAX package would share it."""
import jax
import numpy as np
import pytest
import torch

from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
from sdbc_tpu_torch.models import unet as tunet
from sdbc_tpu_torch.models import vae as tvae
from tests import diffusers_mirror as mirror
from tests.torch_threads import one_thread  # noqa: F401

RTOL = ATOL = 1e-4  # tests/test_numpy_mirror.py


@pytest.fixture(scope="module")
def np_tree(tiny_params):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tiny_params)


@pytest.fixture(scope="module")
def models(tiny_params):
    return as_modules(jax.tree.map(np.asarray, tiny_params),
                      PipelineConfig.tiny(), "cpu")


@pytest.mark.parametrize("impl", ["inference", "auto"])
def test_unet_matches_diffusers_mirror(tiny_cfg, np_tree, models, impl):
    cfg = tiny_cfg.unet
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(2, 8, 8, cfg.in_channels)).astype(np.float32)
    ctx = rng.normal(size=(2, 7, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([17, 903], np.int64)
    with torch.no_grad():
        ours = tunet.apply(models["unet"], torch.from_numpy(lat),
                           torch.from_numpy(t), torch.from_numpy(ctx),
                           attn_impl=impl).numpy()
    ref = mirror.unet_forward(np_tree["unet"], lat, t, ctx, cfg)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_unet_mirror_sees_a_time_embedding_slip(tiny_cfg, np_tree, models):
    """The comparison has teeth: the port's UNet with [sin | cos] in place
    of [cos | sin] leaves the mirror's tolerance."""
    cfg = tiny_cfg.unet
    rng = np.random.default_rng(1)
    lat = rng.normal(size=(1, 8, 8, cfg.in_channels)).astype(np.float32)
    ctx = rng.normal(size=(1, 7, cfg.cross_attention_dim)).astype(np.float32)
    t = np.array([500], np.int64)
    ref = mirror.unet_forward(np_tree["unet"], lat, t, ctx, cfg)
    orig = tunet.nn.timestep_embedding

    def flipped(ts, dim, dtype=torch.float32):
        e = orig(ts, dim, dtype)
        return torch.cat([e[:, dim // 2:], e[:, :dim // 2]], dim=-1)

    tunet.nn.timestep_embedding = flipped
    try:
        with torch.no_grad():
            ours = tunet.apply(models["unet"], torch.from_numpy(lat),
                               torch.from_numpy(t),
                               torch.from_numpy(ctx)).numpy()
    finally:
        tunet.nn.timestep_embedding = orig
    assert not np.allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_vae_matches_diffusers_mirror(tiny_cfg, np_tree, models):
    cfg = tiny_cfg.vae
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        mean, logvar = tvae.encode_moments(models["vae"], torch.from_numpy(x))
        dec = tvae.decode(models["vae"], mean).numpy()
    mean_n, logvar_n = mirror.vae_encode_moments(np_tree["vae"], x, cfg)
    np.testing.assert_allclose(mean.numpy(), mean_n, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), logvar_n, rtol=RTOL,
                               atol=ATOL)
    dec_n = mirror.vae_decode(np_tree["vae"], mean.numpy(), cfg)
    np.testing.assert_allclose(dec, dec_n, rtol=RTOL, atol=ATOL)
