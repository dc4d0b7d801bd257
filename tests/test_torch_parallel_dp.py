"""sdbc_tpu_torch's data-parallel and FSDP training steps against
sdbc_tpu's, on the CPU: one 2-rank gloo run of
``tests/torch_parallel_worker.py`` (the port alone, no jax) against the
JAX package's step on a data-2 mesh of conftest's virtual devices, fed
the same numpy parameters and draws; each FSDP rank's share of the
sharded leaves and their moments; and the dataloader's rows per rank.

Tolerances: loss rtol 1e-4; parameters rtol 1e-4, atol 1e-5, the
Adam-noise elements held to Adam's bound; the optimizer's moments rtol
1e-4 (tests/torch_parallel_harness.py, as tests/test_parallel.py:100-105
and tests/test_torch_train.py).
"""
import os

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

ACCUM = 2
DP_TCFG = dict(train_unet=True, train_text_encoder=True, grad_accum=ACCUM,
               micro_batch=GLOBAL_MICRO // 2, learning_rate=LR,
               num_examples=100, ema_decay=0.9, max_grad_norm=1.0,
               prior_weight=1.0)
TRAIN_CASES = {
    # the mode-C-like step in fp32 (both components, grad accumulation)
    # with EMA, clipping and prior preservation (the class rows ride the
    # data axis too): one JAX compile covers the DP and the DP prior step
    "dp": dict(tcfg=DP_TCFG, accum=ACCUM, seed=0, prior=True, moments=True),
    # ZeRO-3 over data 2 on the same batch and draws: min_size lowered (as
    # tests/test_parallel.py does) so the tiny leaves shard, CLIP's stacked
    # layers on the layer axis among them.  Held to the JAX step on the
    # same data-2 mesh ("dp"): the JAX package's test_fsdp_train_step_
    # matches_dp holds its FSDP-sharded state to that step (rtol 1e-5),
    # and its own sharded compile would double this file's time
    "fsdp": dict(tcfg=DP_TCFG, shard=dict(fsdp=True, min_size=64),
                 accum=ACCUM, seed=0, prior=True, moments=True),
}


@pytest.fixture(scope="module")
def dp_run(tiny_cfg, tmp_path_factory):
    """The worker's results (both ranks) and the JAX package's, computed
    while the worker runs."""
    from tests.data_fixtures import build_fake_dataset

    tmp = str(tmp_path_factory.mktemp("dp_run"))
    data_root = build_fake_dataset(os.path.join(tmp, "data"), n_train=16,
                                   n_test=2, img_size=32)
    np_params, tiny_params = tiny_trees()
    train, keys = train_inputs(tiny_cfg, TRAIN_CASES)
    ranks = launch_worker({"params": np_params, "train": train,
                           "data_root": data_root}, tmp)
    dp = jmesh.make_mesh(jmesh.MeshConfig(data=2), devices=jax.devices()[:2])
    ref = jax_train(tiny_cfg, tiny_params, TRAIN_CASES["dp"], *keys["dp"],
                    dp)
    return worker_results(ranks, tmp), ref


@pytest.mark.parametrize("case", ["dp", "fsdp"])
def test_dp_steps_match_jax_mesh(dp_run, case):
    ranks, ref = dp_run
    for r in ranks:
        got = r[case]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        assert got["finite"]
        for comp, tree in got["trainable"].items():
            assert_tree_close(ref["trainable"][comp], tree, LR)
        for comp, tree in got.get("ema", {}).items():
            assert_tree_close(ref["ema"][comp], tree, LR)
    # the moments, gathered whole to rank 0
    assert ranks[1][case]["moments"] is None
    assert_moments_close(ref["opt_state"], ranks[0][case]["moments"])
    # every rank holds the same replica
    for comp, tree in ranks[0][case]["trainable"].items():
        for name, a in tree.items():
            np.testing.assert_array_equal(a, ranks[1][case]["trainable"]
                                          [comp][name])


def test_dataloader_rows_per_rank(dp_run):
    """Each rank loads its rows of every global micro-batch: the same
    order and the same per-index prompt draws as one process."""
    ranks, _ = dp_run
    plain = ranks[0]["loader"][0]
    assert all(r["loader"][0][0]["input_ids"].shape[1] == GLOBAL_MICRO
               for r in ranks)
    for b, batch in enumerate(plain):
        for k, v in batch.items():
            got = np.concatenate([r["loader"][1][b][k] for r in ranks],
                                 axis=1)
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_fsdp_ranks_hold_half_of_each_sharded_leaf(dp_run):
    """Each rank holds half of every sharded leaf (a stacked CLIP leaf
    sharded on its layer axis: whole layers, half of them) and half of
    its two AdamW moments."""
    ranks, _ = dp_run
    sizes = [r["fsdp"]["shards"] for r in ranks]
    assert sizes[0].keys() == sizes[1].keys()
    assert len(sizes[0]) > 50, len(sizes[0])
    assert any(k.startswith("text_encoder/layers/") for k in sizes[0])
    for key in sizes[0]:
        for s in sizes:
            local, full, moments = s[key]
            assert 2 * local == full and moments == full, (key, s[key])
