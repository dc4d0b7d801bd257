"""sdbc_tpu_torch's data- and tensor-parallel sampling against sdbc_tpu's,
on the CPU: one 2-rank gloo run of ``tests/torch_parallel_worker.py``
(the port alone, no jax) of ``SDPipeline(mesh=)`` on a data-2 and a
model-2 mesh, against the JAX package's pipeline on meshes of the same
shape from conftest's virtual devices, fed the same numpy parameters and
latents.

Tolerances: against the JAX mesh at the port's pipeline parity bound
(atol 1e-3, tests/test_torch_pipeline.py); a port mesh against the
port's one-process call at the JAX TP test's 1e-4 (the partitioned sums'
order).
"""
import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdbc_tpu.parallel import mesh as jmesh
from tests.torch_parallel_harness import (HW, launch_worker, tiny_trees,
                                          worker_results)
from tests.torch_threads import one_thread  # noqa: F401

SAMPLE = dict(prompts=["a gothic novel cover", "a cookbook cover",
                       "a space opera", "a quiet memoir"],
              hw=32, steps=2, seed=7, guidance=7.5)


@pytest.fixture(scope="module")
def sample_run(tiny_cfg, tmp_path_factory):
    """The worker's results (both ranks) and the JAX package's on the
    data-2 and model-2 meshes, computed while the worker runs."""
    tmp = str(tmp_path_factory.mktemp("sample_run"))
    np_params, tiny_params = tiny_trees()
    lat = np.random.default_rng(11).standard_normal(
        (len(SAMPLE["prompts"]), HW // tiny_cfg.vae_scale,
         HW // tiny_cfg.vae_scale, tiny_cfg.latent_channels)).astype(
        np.float32)
    ranks = launch_worker({"params": np_params, "train": {},
                           "sample": dict(SAMPLE, latents=lat)}, tmp)
    devs = jax.devices()[:2]
    meshes = {"sample_dp": jmesh.MeshConfig(data=2),
              "sample_tp": jmesh.MeshConfig(data=1, model=2)}

    def jax_sample(mcfg):
        from sdbc_tpu.data.tokenizer import CLIPTokenizer
        from sdbc_tpu.diffusion.pipeline import SDPipeline

        tok = CLIPTokenizer.fallback(tiny_cfg.clip.vocab_size)
        mesh = jmesh.make_mesh(mcfg, devices=devs)
        return SDPipeline(tiny_params, tiny_cfg, tok,
                          compute_dtype=jnp.float32, mesh=mesh)(
            SAMPLE["prompts"], height=HW, width=HW,
            num_inference_steps=SAMPLE["steps"], seed=SAMPLE["seed"],
            guidance_scale=SAMPLE["guidance"], latents=lat)

    with cf.ThreadPoolExecutor(len(meshes)) as ex:
        futs = {k: ex.submit(jax_sample, m) for k, m in meshes.items()}
        ref = {k: f.result() for k, f in futs.items()}
    return worker_results(ranks, tmp), ref


@pytest.mark.parametrize("which", ["sample_dp", "sample_tp"])
def test_sampling_matches_jax_mesh(sample_run, which):
    ranks, ref = sample_run
    for r in ranks:
        assert r[which].shape == ref[which].shape
        np.testing.assert_allclose(r[which], ref[which], atol=1e-3)
    # TP cut every transformer and ResBlock of the UNet and CLIP's layers
    # (tiny: 4 heads, 8 groups) to the rank's half
    assert ranks[0]["tp_cut"] == ranks[1]["tp_cut"]
    assert all(ranks[0]["tp_cut"].values()), ranks[0]["tp_cut"]
    np.testing.assert_allclose(ranks[0]["sample_dp"],
                               ranks[0]["sample_tp"], atol=1e-4)


def test_dp_stochastic_sampling_draws_the_global_batch(sample_run):
    """euler_a draws fresh noise every step: each data rank cuts its rows
    out of the global batch's draws, so the DP call equals one process's
    call with the same seed."""
    ranks, _ = sample_run
    for r in ranks:
        dp, one = r["sample_dp_euler_a"]
        np.testing.assert_allclose(dp, one, atol=1e-4)
