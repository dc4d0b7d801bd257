"""sdbc_tpu_torch's tensor-parallel training step against sdbc_tpu's, on
the CPU: one 2-rank gloo run of ``tests/torch_parallel_worker.py`` (the
port alone) of the TP step (model 2), against the JAX package's step on
a (data 1, model 2) mesh of conftest's virtual devices with its state cut
by the JAX ``tp_specs``, fed the same numpy parameters and draws.  (Its
compile alone takes most of this file's time.)  The DP and FSDP steps
are in ``tests/test_torch_parallel_dp.py``, the finetune CLI's sharded
run in ``tests/test_torch_parallel_cli.py``.

Tolerances: loss rtol 1e-4; parameters rtol 1e-4, atol 1e-5, the
Adam-noise elements held to Adam's bound (tests/torch_parallel_harness.py,
as tests/test_parallel.py:100-105 and tests/test_torch_train.py).
"""
import jax
import numpy as np
import pytest

from sdbc_tpu.parallel import mesh as jmesh
from sdbc_tpu.parallel import specs as jspecs
from tests.torch_parallel_harness import (GLOBAL_MICRO, LR,
                                          assert_tree_close, jax_train,
                                          launch_worker, tiny_trees,
                                          train_inputs, worker_results)
from tests.torch_threads import one_thread  # noqa: F401

CASES = {
    # Megatron-style TP on a (data 1, model 2) mesh, with clipping: the
    # global norm sums the shards' squares over the model group
    "tp": dict(tcfg=dict(train_unet=True, train_text_encoder=True,
                         grad_accum=1, micro_batch=GLOBAL_MICRO,
                         learning_rate=LR, num_examples=100,
                         max_grad_norm=1.0),
               shard=dict(tp=True), tp_mesh=True, accum=1, seed=3),
}

@pytest.fixture(scope="module")
def tp_run(tiny_cfg, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_run"))
    np_params, params = tiny_trees(seed=1)
    train, keys = train_inputs(tiny_cfg, CASES)
    ranks = launch_worker({"params": np_params, "train": train}, tmp)

    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=1, model=2),
                           devices=jax.devices()[:2])
    ref = {"tp": jax_train(tiny_cfg, params, CASES["tp"], *keys["tp"], mesh,
                           lambda st, m: jspecs.tp_specs(st, m))}
    return worker_results(ranks, tmp), ref


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax_mesh(tp_run, case):
    ranks, ref = tp_run
    for r in ranks:
        got = r[case]
        np.testing.assert_allclose(got["loss"], ref[case]["loss"],
                                   rtol=1e-4)
        assert got["finite"]
        for comp, tree in got["trainable"].items():
            assert_tree_close(ref[case]["trainable"][comp], tree, LR)
        if ref[case]["ema"] is not None:
            for comp, tree in got["ema"].items():
                assert_tree_close(ref[case]["ema"][comp], tree, LR)
