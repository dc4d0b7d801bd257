"""The sdbc_tpu_torch fine-tuning step against sdbc_tpu's, on the CPU at the
tiny config in fp32.

The JAX step draws its VAE eps, noise and timesteps from ``jax.random``;
the test rebuilds those draws from the same key (``split(key,
grad_accum)``, then ``split(k, 3)`` per micro-batch, as
``sdbc_tpu/train/trainer.py`` does) and injects them into the port.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               as_modules)
from sdbc_tpu_torch.models import vae as tvae
from sdbc_tpu_torch.models.convert import _flatten_jax_tree
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.train import adam8bit as tadam8
from sdbc_tpu_torch.train import trainer as ttrainer
from tests.torch_threads import one_thread  # noqa: F401

GRAD_ACCUM, MICRO, HW = 2, 2, 32
LR, STEPS = 1e-3, 2
# fp32 on both sides: the gradients agree to ~1e-5 of each leaf's largest
# entry (summation order).  Adam divides each gradient by its own running
# magnitude, so an element whose gradient is rounding noise (a cancelling
# sum) takes an O(lr) step of arbitrary sign in either package: a few such
# elements per leaf are held only to Adam's bound, |Δ| ≤ 2·lr per step.
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
MAX_NOISY_SHARE = 1e-4
# The attention key biases have an identically zero gradient (softmax is
# invariant to a per-row constant): all their entries are such noise.
NOISE_ONLY = ("attn.k.bias", "attn1.k.bias", "attn2.k.bias")


@pytest.fixture(scope="module")
def tcfg_pipe():
    return PipelineConfig.tiny()


@pytest.fixture(scope="module")
def np_params(tiny_params):
    return jax.tree.map(np.asarray, tiny_params)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"pixel_values": (rng.standard_normal(
                (GRAD_ACCUM, MICRO, HW, HW, 3)) * 0.5).astype(np.float32),
            "input_ids": rng.integers(0, cfg.clip.vocab_size,
                                      (GRAD_ACCUM, MICRO, cfg.clip.ctx),
                                      dtype=np.int64).astype(np.int32)}


def _jax_draws(key, cfg):
    """The per-micro-batch (eps, noise, t, offset) the JAX step draws from
    ``key``."""
    lat = HW // cfg.vae_scale
    shape = (MICRO, lat, lat, cfg.latent_channels)
    t = lambda a: torch.from_numpy(np.array(a))
    draws = []
    for k in jax.random.split(key, GRAD_ACCUM):
        kvae, knoise, kt = jax.random.split(k, 3)
        _, koff = jax.random.split(knoise)  # offset noise, drawn after
        draws.append({
            "eps": t(jax.random.normal(kvae, shape, jnp.float32)),
            "noise": t(jax.random.normal(knoise, shape, jnp.float32)),
            "t": t(jax.random.randint(kt, (MICRO,), 0,
                                      cfg.schedule.num_train_timesteps)),
            "offset": t(jax.random.normal(
                koff, (MICRO, 1, 1, cfg.latent_channels), jnp.float32))})
    return draws


def _port_state(np_params, cfg, tcfg):
    modules = as_modules(np_params, cfg, "cpu")
    return ttrainer.init_train_state(modules, tcfg, compute_dtype=torch.float32,
                                     device="cpu")


def _assert_params_match(jax_tree, module):
    flat = _flatten_jax_tree(module, jax.tree.map(np.asarray, jax_tree))
    params = dict(module.named_parameters())
    assert set(flat) == set(params)
    noisy = total = 0
    for name, arr in flat.items():
        diff = np.abs(params[name].detach().numpy() - arr)
        assert diff.max() <= 2 * LR * STEPS, (name, diff.max())
        if not name.endswith(NOISE_ONLY):
            noisy += int((diff > PARAM_ATOL).sum())
            total += diff.size
    assert noisy <= MAX_NOISY_SHARE * total, (noisy, total)


# the fp32-AdamW case also turns on every loss and optimizer option of the
# slice (each off in the other case)
@pytest.mark.parametrize("use_8bit_adam,options", [
    (True, {}),
    (False, dict(ema_decay=0.9, max_grad_norm=1.0, min_snr_gamma=5.0,
                 noise_offset=0.1))])
def test_train_step_matches_jax(tiny_params, np_params, tcfg_pipe,
                                use_8bit_adam, options):
    tcfg_kw = dict(train_unet=True, train_text_encoder=True,
                   grad_accum=GRAD_ACCUM, micro_batch=MICRO,
                   learning_rate=LR, num_examples=100,
                   use_8bit_adam=use_8bit_adam, **options)
    from sdbc_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig

    jcfg = JPipelineConfig.tiny()
    jstate = jtrainer.init_train_state(tiny_params,
                                       jtrainer.TrainConfig(**tcfg_kw),
                                       compute_dtype=jnp.float32)
    jstep = jtrainer.make_train_step(jcfg, jtrainer.TrainConfig(**tcfg_kw),
                                     compute_dtype=jnp.float32)
    tcfg = ttrainer.TrainConfig(**tcfg_kw)
    state = _port_state(np_params, tcfg_pipe, tcfg)
    step = ttrainer.make_train_step(tcfg_pipe, tcfg,
                                    compute_dtype=torch.float32, device="cpu")
    if use_8bit_adam:
        leaves = state.opt_state.inner.per_leaf
        # the 64-channel 3x3 convs (36864 elements) take the 8-bit path
        assert any(isinstance(s, tadam8.Quant8State) for s in leaves)
        assert any(isinstance(s, tadam8.FP32Moments) for s in leaves)
    _kernels.reset_launch_counts()
    for i in range(STEPS):
        batch = _batch(tcfg_pipe, seed=i)
        key = jax.random.key(100 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, key)
        state, m = step(state, {k: torch.from_numpy(v.astype(np.int64)
                                                    if v.dtype == np.int32
                                                    else v)
                                for k, v in batch.items()},
                        draws=_jax_draws(key, tcfg_pipe))
        np.testing.assert_allclose(m["loss"], float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        assert m["finite"] and bool(jm["finite"])
    assert state.step == STEPS and state.opt_state.inner.count == STEPS
    for name in ("unet", "text_encoder"):
        _assert_params_match(jstate.trainable[name], state.trainable[name])
        if options:
            _assert_params_match(jstate.ema[name], state.ema[name])
    assert set(_kernels.launches.values()) == {0}  # CPU: plain versions


def test_nan_guard_skips_update(np_params, tcfg_pipe):
    tcfg = ttrainer.TrainConfig(train_unet=False, train_text_encoder=True,
                                grad_accum=1, learning_rate=1e-3,
                                num_examples=100)
    state = _port_state(np_params, tcfg_pipe, tcfg)
    step = ttrainer.make_train_step(tcfg_pipe, tcfg,
                                    compute_dtype=torch.float32, device="cpu")
    good = {k: torch.from_numpy(v[:1].astype(np.int64) if v.dtype == np.int32
                                else v[:1])
            for k, v in _batch(tcfg_pipe).items()}
    bad = {k: v.clone() for k, v in good.items()}
    bad["pixel_values"][0, 0, 0, 0, 0] = float("nan")
    params = ttrainer.trainable_params(state.trainable)
    before = [p.detach().clone() for p in params]
    gen = lambda: torch.Generator().manual_seed(0)
    state, m = step(state, bad, generator=gen())
    assert not m["finite"] and m["notfinite_count"] == 1
    for a, p in zip(before, params):
        torch.testing.assert_close(p.detach(), a, rtol=0, atol=0)
    assert state.opt_state.inner.count == 0  # the inner state did not move
    # the count is cumulative: a finite step in between does not reset it
    state, m2 = step(state, good, generator=gen())
    assert m2["finite"] and m2["notfinite_count"] == 1
    assert state.opt_state.inner.count == 1
    assert any(float((p.detach() - a).abs().max()) > 0
               for a, p in zip(before, params))
    _, m3 = step(state, bad, generator=gen())
    assert not m3["finite"] and m3["notfinite_count"] == 2


def test_nothing_to_train_rejected(np_params, tcfg_pipe):
    tcfg = ttrainer.TrainConfig(train_unet=False, train_text_encoder=False)
    with pytest.raises(ValueError, match="nothing to train"):
        _port_state(np_params, tcfg_pipe, tcfg)
    # ControlNet training is ported (tests/test_torch_controlnet.py): it
    # needs a branch to train
    tcfg = ttrainer.TrainConfig(train_controlnet=True,
                                train_text_encoder=False)
    with pytest.raises(ValueError, match="train_controlnet needs"):
        _port_state(np_params, tcfg_pipe, tcfg)


def test_encode_moments_chunked_matches_batched(np_params, tcfg_pipe):
    from sdbc_tpu.models import vae as jvae

    vae = as_modules(np_params, tcfg_pipe, "cpu")["vae"]
    x = np.random.default_rng(3).uniform(-1, 1, (3, HW, HW, 3)).astype(
        np.float32)
    with torch.no_grad():
        mean, logvar = tvae.encode_moments(vae, torch.from_numpy(x))
        cmean, clogvar = tvae.encode_moments_chunked(vae, torch.from_numpy(x))
    torch.testing.assert_close(cmean, mean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(clogvar, logvar, atol=1e-5, rtol=1e-5)
    jmean, jlogvar = jvae.encode_moments(np_params["vae"], jnp.asarray(x),
                                         tcfg_pipe.vae)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-4)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), atol=1e-4)
    assert tvae.prefer_chunked_encode(2, 512, 512)
    assert not tvae.prefer_chunked_encode(1, 512, 512)
    assert not tvae.prefer_chunked_encode(2, 256, 256)


def test_entry_points_default_to_the_card():
    for fn in (SDPipeline.__init__, ttrainer.init_train_state,
               ttrainer.make_train_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
