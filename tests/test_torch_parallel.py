"""sdbc_tpu_torch.parallel against sdbc_tpu.parallel, on the CPU, with no
process started: the mesh geometry, the rows each process loads, and the
TP / FSDP partition specs leaf by leaf on the tiny, tiny_xl and SD-1.5
trees (SD-1.5 built by shape only: ``jax.eval_shape`` and
``torch.device("meta")``), error for error; the CLIs' refusals and the
launcher contract's messages.

The 2-rank gloo runs of ``tests/torch_parallel_worker.py`` (the port
alone, no jax) against the JAX package on meshes of the same shape are
in ``tests/test_torch_parallel_dp.py`` (the DP and FSDP steps, the
loader's rows), ``tests/test_torch_parallel_dp8.py`` (DP with 8-bit
AdamW), ``tests/test_torch_parallel_tp.py`` (the TP step) and
``tests/test_torch_parallel_sample.py`` (DP and TP sampling); the
2-process finetune CLI in ``tests/test_torch_parallel_cli.py``.
"""
import argparse
import types

import jax
import numpy as np
import pytest
import torch

from sdbc_tpu.parallel import mesh as jmesh
from sdbc_tpu.parallel import specs as jspecs
from sdbc_tpu_torch.parallel import mesh as tmesh
from sdbc_tpu_torch.parallel import specs as tspecs
from tests.torch_threads import one_thread  # noqa: F401


# ---------------------------------------------------------------------------
# mesh geometry and per-process rows


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("data,model,slices,n", [
    (-1, 1, 1, 8), (-1, 2, 1, 8), (4, 2, 1, 8), (2, 2, 1, 8), (-1, 3, 1, 8),
    (-1, 1, 2, 8), (-1, 1, 3, 6), (4, 1, 3, 4), (-1, 8, 1, 8),
    (-1, 2, 2, 2)])
def test_mesh_config_resolve_matches_jax(data, model, slices, n):
    j = jmesh.MeshConfig(data=data, model=model, num_slices=slices)
    t = tmesh.MeshConfig(data=data, model=model, num_slices=slices)
    assert _outcome(t.resolve, n) == _outcome(j.resolve, n)


PMAPS = [
    np.array([[0, 0], [1, 1], [0, 0], [1, 1]]),     # non-contiguous
    np.array([[0, 1], [1, 1]]),                     # a model-split row
    np.arange(8).reshape(8, 1),                     # one rank per coord
    np.arange(8).reshape(4, 2),                     # TP pairs
    np.array([[0], [0], [1], [1]]),                 # contiguous blocks
]


@pytest.mark.parametrize("pmap", PMAPS, ids=range(len(PMAPS)))
def test_local_data_coords_match_jax(pmap):
    for proc in range(int(pmap.max()) + 2):
        assert tmesh._local_data_coords(pmap, proc) == \
            jmesh._local_data_coords(pmap, proc)


class _Dev:
    def __init__(self, process_index):
        self.process_index = process_index


@pytest.mark.parametrize("pmap", PMAPS, ids=range(len(PMAPS)))
@pytest.mark.parametrize("global_batch", [8, 12, 6])
def test_host_local_rows_match_jax(pmap, global_batch, monkeypatch):
    """Rows (indices and the contiguous slice) per process, with the JAX
    functions on a mesh of devices carrying ``pmap``'s process indices and
    the port's on a mesh of ``pmap``'s ranks: the same rows, the same
    errors (an indivisible batch, non-contiguous rows)."""
    jm = types.SimpleNamespace(
        devices=np.vectorize(_Dev, otypes=[object])(pmap),
        shape={"data": pmap.shape[0], "model": pmap.shape[1]})
    tm = types.SimpleNamespace(mesh=torch.from_numpy(pmap),
                               size=lambda i: pmap.shape[i])
    for proc in range(int(pmap.max()) + 2):
        monkeypatch.setattr(jax, "process_index", lambda: proc)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: proc)
        for fn in ("host_local_batch_indices", "host_local_batch_slice"):
            want = _outcome(getattr(jmesh, fn), global_batch, jm)
            got = _outcome(getattr(tmesh, fn), global_batch, tm)
            if want[0] == "ok" and fn.endswith("indices"):
                want = ("ok", want[1].tolist())
                got = ("ok", got[1].tolist())
            assert got == want, (fn, proc)


def test_shard_batch_keeps_this_ranks_rows(monkeypatch):
    """``shard_batch`` / ``make_global_batch``: a rank holds only its rows
    (batch dim 0, or 1 for the (accum, micro) batches), on its device;
    rank-0 leaves (scalars) pass whole."""
    pmap = np.arange(4).reshape(4, 1)
    tm = types.SimpleNamespace(mesh=torch.from_numpy(pmap),
                               size=lambda i: pmap.shape[i],
                               device_type="cpu")
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    x = {"a": np.arange(16).reshape(8, 2), "s": np.float32(3.0)}
    got = tmesh.shard_batch(x, tm)
    np.testing.assert_array_equal(got["a"].numpy(), x["a"][4:6])
    assert float(got["s"]) == 3.0
    acc = tmesh.shard_batch({"b": np.zeros((2, 8, 3))}, tm, batch_dim=1)
    assert tuple(acc["b"].shape) == (2, 2, 3)
    local = tmesh.make_global_batch({"b": np.ones((2, 2, 3))}, tm)
    assert torch.is_tensor(local["b"]) and tuple(local["b"].shape) == \
        (2, 2, 3)


# ---------------------------------------------------------------------------
# partition specs


def _cfgs(name):
    from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig as TCfg

    return getattr(JCfg, name)(), getattr(TCfg, name)()


def _trees(name):
    """(JAX params by shape, port modules on the meta device)."""
    from sdbc_tpu.models import clip, unet, vae
    from sdbc_tpu_torch.diffusion.graph import init_models

    jcfg, tcfg = _cfgs(name)

    def init():
        ks = jax.random.split(jax.random.key(0), 4)
        p = {"text_encoder": clip.init(ks[0], jcfg.clip),
             "unet": unet.init(ks[1], jcfg.unet),
             "vae": vae.init(ks[2], jcfg.vae)}
        if jcfg.clip2 is not None:
            p["text_encoder_2"] = clip.init(ks[3], jcfg.clip2)
        return p

    return (jax.eval_shape(init),
            init_models(tcfg, device="meta", generator=None))


def _jax_flat(spec_tree) -> dict:
    from jax.sharding import PartitionSpec as P

    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jspecs._path_str(path): tuple(s) for path, s in flat}


@pytest.fixture(scope="module")
def spec_trees():
    return {n: _trees(n) for n in ("tiny", "tiny_xl", "sd15")}


@pytest.mark.parametrize("name", ["tiny", "tiny_xl", "sd15"])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_specs_match_jax_leaf_by_leaf(spec_trees, name, m):
    jtree, tmods = spec_trees[name]
    jcfg, tcfg = _cfgs(name)
    excl = _outcome(jspecs.validate_tp, jcfg, m)
    assert _outcome(tspecs.validate_tp, tcfg, m) == excl
    excl = excl[1] if excl[0] == "ok" else ()
    jtp = _jax_flat(jspecs.tp_specs(jtree, m, exclude=excl))
    ttp = tspecs.tp_specs(tmods, m, exclude=excl)
    assert ttp == jtp
    assert any(v for v in ttp.values())
    for base_j, base_t in ((None, None), (jspecs.tp_specs(jtree, m,
                                                          exclude=excl),
                                          ttp)):
        for min_size in (2 ** 12, 64):
            jf = _jax_flat(jspecs.fsdp_specs(jtree, m, base=base_j,
                                             min_size=min_size))
            tf = tspecs.fsdp_specs(tmods, m, base=base_t, min_size=min_size)
            assert tf == jf
    # one component alone, named
    assert tspecs.tp_specs(tmods["unet"], m, component="unet") == {
        k: v for k, v in ttp.items() if k.startswith("unet/")}


@pytest.mark.parametrize("name", ["sd15", "sd21", "sdxl", "tiny"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 16])
def test_validate_tp_matches_jax(name, m):
    jcfg, tcfg = _cfgs(name)
    assert _outcome(tspecs.validate_tp, tcfg, m) == \
        _outcome(jspecs.validate_tp, jcfg, m)


def test_specs_reject_int8_adam_state():
    from sdbc_tpu_torch.diffusion.graph import init_models
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.train import trainer as T

    state = T.init_train_state(
        init_models(PipelineConfig.tiny(), device="cpu",
                    generator=torch.Generator().manual_seed(0)),
        T.TrainConfig(train_text_encoder=True, train_unet=True,
                      use_8bit_adam=True, num_examples=8),
        compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tspecs.tp_specs(state, 2)
    with pytest.raises(ValueError, match="int8"):
        tspecs.fsdp_specs(state, 2)
    with pytest.raises(ValueError, match="int8"):
        T.shard_train_state(state, None, fsdp=True)
    # size-1 axes are no-ops, not errors
    assert not any(tspecs.tp_specs(state, 1).values())
    assert not any(tspecs.fsdp_specs(state, 1).values())


# ---------------------------------------------------------------------------
# the CLIs' refusals and the launcher contract


@pytest.mark.parametrize("flags,what", [
    (["--fsdp", "--use_8bit_adam"], "--use_8bit_adam cannot combine with "
                                     "--fsdp/--tp"),
    (["--tp", "2", "--use_8bit_adam"], "--use_8bit_adam cannot combine"),
    (["--tp", "2", "--train_controlnet"], "--train_controlnet with "
                                          "--tp/--fsdp is not wired up"),
    (["--fsdp", "--lora_rank", "2"], "--lora_rank trains <1% of the "
                                     "parameters"),
    (["--tp", "2", "--ti_token", "x"], "--ti_token trains a handful"),
    (["--tp", "2"], r"--tp 2: mesh 0x2 != 1 devices"),
])
def test_finetune_refuses_as_jax(flags, what):
    from sdbc_tpu_torch.cli import finetune

    with pytest.raises(SystemExit, match=what):
        finetune.main(["--tiny", "--device", "cpu"] + flags)
    assert not torch.distributed.is_initialized()


def test_prior_generate_is_single_process(monkeypatch):
    from sdbc_tpu_torch.cli import common, finetune

    @__import__("contextlib").contextmanager
    def two_ranks(args, tp, want):
        yield object()

    monkeypatch.setattr(common, "distributed", two_ranks)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(SystemExit, match="--prior_generate is single-host "
                                         "only"):
        finetune.main(["--tiny", "--device", "cpu", "--prior_class_prompt",
                       "a cover", "--prior_generate", "2"])


def test_inference_refuses_spatial_and_a_mesh_too_big():
    from sdbc_tpu_torch.cli import inference

    base = ["--tiny", "--device", "cpu", "--mode", "enter_prompt",
            "--prompt", "x"]
    with pytest.raises(SystemExit, match=r"item 5\.2.*not ported yet"):
        inference.main(base + ["--tp", "1", "--spatial"])
    with pytest.raises(SystemExit, match=r"--tp 2: mesh 0x2 != 1 devices"):
        inference.main(base + ["--tp", "2"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,what", [
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1", "SDBC_NUM_PROCESSES": "2"},
     "SDBC_PROCESS_ID is not"),
    ({"COORDINATOR_ADDRESS": "127.0.0.1:1"},
     "SDBC_NUM_PROCESSES and SDBC_PROCESS_ID are not"),
    ({"SDBC_MULTIHOST": "1"}, "needs the launcher's RANK"),
])
def test_maybe_init_distributed_names_what_is_missing(env, what,
                                                      monkeypatch):
    from sdbc_tpu_torch.cli import common

    for k in ("COORDINATOR_ADDRESS", "SDBC_NUM_PROCESSES", "SDBC_PROCESS_ID",
              "SDBC_MULTIHOST", "RANK", "WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert common.maybe_init_distributed(
        argparse.Namespace(device="cpu")) is None
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match=what):
        common.maybe_init_distributed(argparse.Namespace(device="cpu"))


def test_spatial_pipeline_refused():
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, SDPipeline

    with pytest.raises(ValueError, match=r"item 5\.2"):
        SDPipeline({}, PipelineConfig.tiny(), None, device="cpu",
                   spatial=True)
