"""sdbc_tpu_torch's data-parallel step with 8-bit AdamW against sdbc_tpu's,
on the CPU: one 2-rank gloo run of ``tests/torch_parallel_worker.py``
(the port alone, no jax; each rank runs 8-bit AdamW on its full replica)
against the JAX package's 8-bit step on a data-2 mesh of conftest's
virtual devices, fed the same numpy parameters and draws.

Tolerances: loss rtol 1e-4; parameters rtol 1e-4, atol 1e-5, the
Adam-noise elements held to Adam's bound; the fp32 moments and the 8-bit
rows' scales rtol 1e-4 (tests/torch_parallel_harness.py, as
tests/test_parallel.py:100-105 and tests/test_torch_train.py).
"""
import jax
import numpy as np
import pytest

from sdbc_tpu.parallel import mesh as jmesh
from tests.torch_parallel_harness import (GLOBAL_MICRO, LR,
                                          assert_moments_close,
                                          assert_tree_close, jax_train,
                                          launch_worker, tiny_trees,
                                          train_inputs, worker_results)
from tests.torch_threads import one_thread  # noqa: F401

CASES = {
    "dp8": dict(tcfg=dict(train_unet=True, train_text_encoder=True,
                          grad_accum=1, micro_batch=GLOBAL_MICRO // 2,
                          learning_rate=LR, num_examples=100,
                          use_8bit_adam=True),
                accum=1, seed=2, moments=True),
}


@pytest.fixture(scope="module")
def dp8_run(tiny_cfg, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dp8_run"))
    np_params, params = tiny_trees(seed=2)
    train, keys = train_inputs(tiny_cfg, CASES)
    ranks = launch_worker({"params": np_params, "train": train}, tmp)
    dp = jmesh.make_mesh(jmesh.MeshConfig(data=2), devices=jax.devices()[:2])
    ref = jax_train(tiny_cfg, params, CASES["dp8"], *keys["dp8"], dp)
    return worker_results(ranks, tmp), ref


def test_dp_8bit_step_matches_one_process(dp8_run):
    """The DP step equals the JAX data-2 step, itself the one-process step
    (tests/test_parallel.py): the parameters, and the moments, which a
    gradient scaled as a whole (a sum in place of the data-group mean)
    moves where AdamW's normalised update does not."""
    ranks, ref = dp8_run
    for r in ranks:
        got = r["dp8"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        assert got["finite"]
        for comp, tree in got["trainable"].items():
            assert_tree_close(ref["trainable"][comp], tree, LR)
    assert ranks[1]["dp8"]["moments"] is None
    moments = ranks[0]["dp8"]["moments"]
    # the 3x3 convs (36864 elements) take the 8-bit path, small leaves fp32
    names = {k[-1] for k, _ in moments}
    assert {"mq", "ms", "m"} <= names, names
    assert_moments_close(ref["opt_state"], moments)
    for comp, tree in ranks[0]["dp8"]["trainable"].items():
        for name, a in tree.items():
            np.testing.assert_array_equal(a, ranks[1]["dp8"]["trainable"]
                                          [comp][name])
