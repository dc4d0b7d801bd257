"""The finetune CLI's sharded training in several processes, on the CPU:
``--fsdp --final_grids`` in 2 processes through the SDBC_* launcher
contract (``cli.common.maybe_init_distributed``, gloo), whose final
checkpoint the JAX ``load_pipeline`` reads and finds equal to the
one-process run's.  (The TP step is held to the JAX step in
``tests/test_torch_parallel_tp.py``.)

Tolerances: the loss rtol 1e-4; the parameters rtol 1e-4, atol 1e-5, the
Adam-noise elements held to Adam's bound (tests/torch_parallel_harness.py,
as tests/test_parallel.py:100-105 and tests/test_torch_train.py).
"""
import json
import os

import jax
import numpy as np
import pytest

from sdbc_tpu_torch.models.convert import _flatten_jax_tree
from tests.torch_parallel_harness import Ranks, assert_tree_close
from tests.torch_threads import one_thread  # noqa: F401

FT_LR = 1e-3


def _ft_argv(data, out, *extra):
    return ["-m", "sdbc_tpu_torch.cli.finetune", "--tiny", "--device",
            "cpu", "--no-bf16", "--data_root", data, "--output_dir", out,
            "--num_examples", "2", "--grad_acc_steps", "1",
            "--ckpts_per_epoch", "1", "--num_workers", "1",
            "--learning_rate", str(FT_LR), "--train_unet", "--epochs", "1",
            *extra]


@pytest.fixture(scope="module")
def fsdp_cli(tmp_path_factory):
    from tests.data_fixtures import build_fake_dataset

    tmp = str(tmp_path_factory.mktemp("fsdp_cli"))
    data = build_fake_dataset(os.path.join(tmp, "ds"), n_train=2, n_test=2)
    outs = {k: os.path.join(tmp, k) for k in ("fsdp2", "one")}
    runs = {"fsdp2": Ranks(_ft_argv(data, outs["fsdp2"], "--batch_size", "1",
                                    "--fsdp", "--final_grids")),
            "one": Ranks(_ft_argv(data, outs["one"], "--batch_size", "2"),
                         n=1, contract=False)}
    return outs, {k: r.wait() for k, r in runs.items()}


def test_finetune_fsdp_two_processes_matches_one(fsdp_cli):
    """--fsdp in 2 processes (--batch_size 1 per data rank) and one
    process (--batch_size 2): the final checkpoints, read by the JAX
    load_pipeline, agree, and so do the logged losses."""
    from sdbc_tpu.utils import checkpoint as jckpt

    outs, _ = fsdp_cli
    trees = []
    for out in (outs["fsdp2"], outs["one"]):
        path = os.path.join(out, "runs", "dev")
        with open(os.path.join(path, "events.jsonl")) as f:
            steps = [json.loads(l) for l in f if '"loss"' in l]
        assert [e["step"] for e in steps] == [1]
        final = sorted(d for d in os.listdir(path)
                       if d.startswith("ckpt-"))[-1]
        params, _ = jckpt.load_pipeline(os.path.join(path, final))
        trees.append((params, steps[0]["loss"]))
    (p2, loss2), (p1, loss1) = trees
    np.testing.assert_allclose(loss2, loss1, rtol=1e-4)
    for comp in ("unet", "text_encoder", "vae"):
        assert_tree_close(p1[comp], _flatten_jax_tree(
            None, jax.tree.map(np.asarray, p2[comp])), FT_LR)


def test_finetune_two_processes_rank0_writes(fsdp_cli):
    """Rank 0 alone logs, and with --final_grids alone draws the grid
    from the gathered models."""
    outs, logs = fsdp_cli
    assert sum("step 1 loss" in l for l in logs["fsdp2"][0].splitlines()) \
        == 1
    assert "step 1 loss" not in logs["fsdp2"][1]
    grids = os.listdir(os.path.join(outs["fsdp2"], "runs", "dev", "grids"))
    assert grids and "grid saved" in logs["fsdp2"][0] \
        and "grid saved" not in logs["fsdp2"][1]


def test_inference_two_processes_rank0_writes(tmp_path):
    """The inference CLI over a data-2 mesh of 2 processes (--tp 1): both
    ranks sample, rank 0 alone writes the images."""
    save = str(tmp_path / "out")
    logs = Ranks(["-m", "sdbc_tpu_torch.cli.inference", "--tiny", "--device",
                  "cpu", "--no-bf16", "--mode", "enter_prompt", "--prompt",
                  "a cover", "--samples_per_prompt", "2", "--img_size", "32",
                  "--num_inference_steps", "2", "--tp", "1", "--save_dir",
                  save]).wait()
    out = os.path.join(save, "dev inference")
    assert sorted(os.listdir(out)) == ["a cover-0.png", "a cover-1.png"]
    assert logs[0].count("saved ") == 2 and "saved " not in logs[1]
