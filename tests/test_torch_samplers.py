"""Every scheduler of the port's ``sample`` against sdbc_tpu's, on the CPU
at the tiny config in fp32 (32² image, batch 2 with CFG), on one JAX
parameter tree loaded with ``load_jax_params``.  The stochastic schedulers
get the JAX package's draws injected: its key schedule replayed
(``jax_draws``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JPipelineConfig
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
from sdbc_tpu_torch.ops import _kernels
from tests.torch_threads import one_thread  # noqa: F401

# the pipeline tolerance of tests/test_torch_pipeline.py
ATOL = 1e-3
PROMPTS = ["a gothic novel cover", "a cookbook cover"]
NEGATIVE = ["blurry", ""]
LAT_SHAPE = (2, 16, 16, 4)  # the tiny VAE (scale 2): a 32² image


def jax_draws(key, lat_shape, lo: int, hi: int, enc_shape=None):
    """The JAX package's draws as ``sample(draws=...)`` takes them: with
    init_image ``k_enc, key = split(key)`` and the posterior's ε first,
    then ``k, sub = split(k)`` before each model call, the step's noise
    ``normal(sub, lat_shape)`` — one per loop index, used or not."""
    out = {}
    if enc_shape is not None:
        k_enc, key = jax.random.split(key)
        out["enc"] = np.asarray(jax.random.normal(k_enc, enc_shape,
                                                  jnp.float32))
    steps, k = {}, key
    for i in range(lo, hi):
        k, sub = jax.random.split(k)
        steps[i] = np.asarray(jax.random.normal(sub, lat_shape, jnp.float32))
    out["step"] = steps
    return out


@pytest.fixture(scope="module")
def models(tiny_params):
    return as_modules(jax.tree.map(np.asarray, tiny_params),
                      PipelineConfig.tiny(), "cpu")


@pytest.fixture(scope="module")
def ids():
    cfg = PipelineConfig.tiny()
    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    return (np.asarray(tok.batch_encode(PROMPTS, cfg.clip.ctx), np.int32),
            np.asarray(tok.batch_encode(NEGATIVE, cfg.clip.ctx), np.int32))


@pytest.fixture(scope="module")
def latents():
    return np.random.default_rng(5).standard_normal(LAT_SHAPE).astype(
        np.float32)


def run_both(tiny_params, models, ids, lat, scheduler, steps, *,
             schedule=None, lo=0, hi=None, enc_shape=None, **kw):
    """The JAX ``sample`` and the port's on the same tree, ids, latents and
    draws (the step draws of loop indices ``lo``..``hi``, the posterior's
    ε of ``enc_shape``); options in ``kw`` go to both.  Returns (jax,
    port) as numpy."""
    jcfg, tcfg = JPipelineConfig.tiny(scheduler), PipelineConfig.tiny(
        scheduler)
    if schedule is not None:
        import dataclasses

        from sdbc_tpu.diffusion import schedulers as jsched
        from sdbc_tpu_torch.diffusion import schedulers as tsched
        jcfg = dataclasses.replace(jcfg, schedule=jsched.ScheduleConfig(
            **schedule))
        tcfg = dataclasses.replace(tcfg, schedule=tsched.ScheduleConfig(
            **schedule))
    key = jax.random.key(3)
    cond, uncond = ids
    ref = jgraph.sample(tiny_params, jnp.asarray(cond), jnp.asarray(uncond),
                        jnp.asarray(lat), key, 7.5, cfg=jcfg,
                        num_inference_steps=steps, compute_dtype=jnp.float32,
                        chunked_decode=True,
                        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v) for k, v in kw.items()})
    draws = jax_draws(key, lat.shape, lo, steps if hi is None else hi,
                      enc_shape)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    _kernels.reset_launch_counts()
    out = tgraph.sample(models, torch.from_numpy(cond).long(),
                        torch.from_numpy(uncond).long(),
                        torch.from_numpy(lat), 7.5, cfg=tcfg,
                        num_inference_steps=steps,
                        compute_dtype=torch.float32, draws=draws, **tkw)
    # on the CPU the kernel wrappers take their plain versions
    assert set(_kernels.launches.values()) == {0}
    return np.asarray(ref), out.numpy()


# the 15 scheduler variants: each scheduler, and the Karras grid of each
# σ-space sampler; lcm runs on its distillation grid at 4 steps
VARIANTS = [(s, False) for s in tgraph.SCHEDULERS] + [
    (s, True) for s in tgraph.KARRAS]


@pytest.mark.parametrize("scheduler,karras", VARIANTS,
                         ids=[s + ("-karras" if k else "")
                              for s, k in VARIANTS])
def test_scheduler_matches_jax(tiny_params, models, ids, latents, scheduler,
                               karras):
    steps = 4 if scheduler == "lcm" else 3
    kw = dict(use_karras_sigmas=True) if karras else {}
    ref, out = run_both(tiny_params, models, ids, latents, scheduler, steps,
                        **kw)
    assert out.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("scheduler", ["ddim", "unipc"])
def test_v_prediction_zero_snr_trailing_matches_jax(tiny_params, models, ids,
                                                    latents, scheduler):
    schedule = dict(prediction_type="v_prediction", rescale_zero_snr=True,
                    timestep_spacing="trailing")
    ref, out = run_both(tiny_params, models, ids, latents, scheduler, 3,
                        schedule=schedule, guidance_rescale=0.7)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("scheduler,karras", [("euler_a", False),
                                              ("heun", True)])
def test_truncated_grid_latents_match_jax(tiny_params, models, ids, latents,
                                          scheduler, karras):
    """t_end with decode=False: the raw latents of a run stopped early (the
    ensemble handoff; heun keeps its corrector at σ > 0)."""
    ref, out = run_both(tiny_params, models, ids, latents, scheduler, 4,
                        hi=3, t_end=3, decode=False,
                        use_karras_sigmas=karras)
    assert out.shape == ref.shape == LAT_SHAPE
    np.testing.assert_allclose(out, ref, atol=ATOL)
