"""Worker of the port's parallel tests (tests/test_torch_parallel_*.py):
one rank of a 2-rank gloo group on the CPU, joined through the port's
own launcher contract (``cli.common.maybe_init_distributed``:
COORDINATOR_ADDRESS, SDBC_NUM_PROCESSES, SDBC_PROCESS_ID).

It imports torch and the port only (asserted: ``jax`` is not in
``sys.modules``), reads the test's inputs (numpy parameters of the tiny
config, global batches and the JAX package's global draws) from
$SDBC_PAR_IN, and runs:

  - the train steps the inputs name (``train``): each on the data (or,
    with ``tp_mesh``, the model) axis, cut by ``shard_train_state`` as
    ``shard`` says (FSDP: with each sharded leaf's local size and its
    moments'), and with ``moments`` the optimizer state in the JAX
    optax tree's flatten order (``utils.checkpoint.opt_state_tree``);
  - with ``sample``: data- and tensor-parallel sampling through
    SDPipeline(mesh=), and a stochastic scheduler's DP call against this
    rank's one-process call;
  - with ``data_root``: the dataloader's rows per rank and the
    one-process loader's;

and writes its results to $SDBC_PAR_OUT/rank<r>.pkl.
"""
import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sdbc_tpu_torch.cli.common import maybe_init_distributed  # noqa: E402


def _tensor(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                            else np.ascontiguousarray(a))


def _full_trees(trainable):
    from sdbc_tpu_torch.parallel.shard import full_tensor

    return {comp: {n: full_tensor(p, dst=None).numpy().copy()
                   for n, p in m.named_parameters()}
            for comp, m in trainable.items()}


def _shard_sizes(state):
    """{JAX path: (local elements, full elements, moments' local
    elements)} of every FSDP-sharded trainable leaf."""
    from sdbc_tpu_torch.models.convert import jax_key
    from sdbc_tpu_torch.parallel.shard import info
    from sdbc_tpu_torch.train.trainer import _flat, optimizer_leaves

    params = _flat(optimizer_leaves(state.trainable))
    mu = dict(zip(map(id, params), state.opt_state.inner.mu))
    nu = dict(zip(map(id, params), state.opt_state.inner.nu))
    out = {}
    for comp, m in state.trainable.items():
        for n, p in m.named_parameters():
            i = info(p)
            if i is None or i.fsdp is None:
                continue
            key = comp + "/" + "/".join(k for k, _ in jax_key(m, n))
            loc, full, mom = out.get(key, (0, 0, 0))
            out[key] = (loc + p.numel(), full + int(np.prod(i.shape)),
                        mom + mu[id(p)].numel() + nu[id(p)].numel())
    return out


def _moments(state, tcfg):
    """[(JAX key path, numpy leaf)] of the optimizer state, every leaf
    gathered whole (None on ranks other than 0)."""
    from sdbc_tpu_torch.utils.checkpoint import _full, opt_state_tree

    out = []
    for key, t in opt_state_tree(state.opt_state, state.trainable,
                                 tcfg.max_grad_norm, lazy=True):
        if isinstance(t, str):   # a frozen leaf's empty node
            continue
        t = _full(t)   # every rank takes part in each leaf's gather
        if t is not None:
            out.append((tuple(k for k, _ in key), t.numpy().copy()))
    return out or None


def train_case(inp, case, mesh):
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
    from sdbc_tpu_torch.train import trainer as T

    from sdbc_tpu_torch.parallel.mesh import host_local_batch_indices

    c = inp["train"][case]
    cfg = PipelineConfig.tiny()
    tcfg = T.TrainConfig(**c["tcfg"])

    state = T.init_train_state(as_modules(inp["params"], cfg, "cpu"), tcfg,
                               compute_dtype=torch.float32, device="cpu")
    if c.get("shard"):
        T.shard_train_state(state, mesh, **c["shard"])
    step = T.make_train_step(cfg, tcfg, compute_dtype=torch.float32,
                             device="cpu", mesh=mesh)
    # this rank's rows of the global micro-batches
    batch = {}
    for k, v in c["batch"].items():
        idx = host_local_batch_indices(v.shape[1], mesh)
        batch[k] = _tensor(v[:, idx])
    draws = [{k: _tensor(v) for k, v in d.items()} for d in c["draws"]]
    state, m = step(state, batch, draws=draws)
    out = {"loss": m["loss"], "finite": m["finite"],
           "trainable": _full_trees(state.trainable)}
    if c.get("moments"):
        out["moments"] = _moments(state, tcfg)
    if state.ema is not None:
        out["ema"] = _full_trees(state.ema)
    if c.get("shard", {}).get("fsdp"):
        out["shards"] = _shard_sizes(state)
    return out


def sample_case(inp, mesh, scheduler="ddim"):
    import dataclasses

    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, SDPipeline

    s = inp["sample"]
    cfg = dataclasses.replace(PipelineConfig.tiny(), scheduler=scheduler)
    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    kw = dict(height=s["hw"], width=s["hw"],
              num_inference_steps=s["steps"], seed=s["seed"],
              guidance_scale=s["guidance"])
    if scheduler == "ddim":
        kw["latents"] = s["latents"]
    pipe = SDPipeline(inp["params"], cfg, tok, device="cpu",
                      compute_dtype=torch.float32, mesh=mesh)
    out = pipe(s["prompts"], **kw)
    if scheduler == "ddim":
        return out, _tp_cut(pipe.models)
    one = SDPipeline(inp["params"], cfg, tok, device="cpu",
                     compute_dtype=torch.float32)(s["prompts"], **kw)
    return out, one


def _tp_cut(models) -> dict:
    """{block kind: whether every such block is cut to this rank's
    half}: the evidence that TP ran on sliced weights."""
    from sdbc_tpu_torch.models import clip as clip_mod
    from sdbc_tpu_torch.models import unet as unet_mod

    kinds = {"mha": (unet_mod.MHA, "tp", "q"),
             "resblock": (unet_mod.ResBlock, "tp", "conv1"),
             "ff": (unet_mod.Transformer, "ff_tp", "ff_out"),
             "proj_out": (unet_mod.Transformer, "proj_tp", "proj_out"),
             "clip_attn": (clip_mod._Attn, "tp", "q"),
             "clip_mlp": (clip_mod._MLP, "tp", "fc1")}
    out = {}
    for kind, (cls, flag, sub) in kinds.items():
        blocks = [m for comp in ("unet", "text_encoder")
                  for m in models[comp].modules() if isinstance(m, cls)]
        out[kind] = bool(blocks) and all(
            getattr(m, flag, None) is not None
            and getattr(m, sub).weight.numel() * 2
            == int(np.prod(getattr(m, sub).weight._sdbc_shard.shape))
            for m in blocks)
    return out


def loader_case(inp, mesh):
    from sdbc_tpu_torch.data.dataset import (DatasetConfig, GoodreadsDataset,
                                             make_dataloader)
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    dcfg = DatasetConfig(data_root=inp["data_root"], img_size=32,
                         max_length=16)
    tok = CLIPTokenizer.fallback(512)
    kw = dict(micro_batch=4, grad_accum=2, shuffle=True, seed=3,
              num_workers=1, epoch=1)
    plain = list(make_dataloader(GoodreadsDataset(dcfg, tok), **kw))
    ranked = list(make_dataloader(GoodreadsDataset(dcfg, tok), mesh=mesh,
                                  **kw))
    return plain, ranked


def main():
    assert "jax" not in sys.modules and "sdbc_tpu" not in sys.modules
    rank, world = maybe_init_distributed(argparse.Namespace(device="cpu"))
    assert world == 2
    with open(os.environ["SDBC_PAR_IN"], "rb") as f:
        inp = pickle.load(f)
    from sdbc_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    dp = make_mesh(MeshConfig(data=2), device="cpu")
    tp = make_mesh(MeshConfig(model=2), device="cpu")
    res = {"rank": rank}
    for case, c in inp["train"].items():
        res[case] = train_case(inp, case, tp if c.get("tp_mesh") else dp)
    if "sample" in inp:
        res["sample_dp"] = sample_case(inp, dp)[0]
        res["sample_tp"], res["tp_cut"] = sample_case(inp, tp)
        res["sample_dp_euler_a"] = sample_case(inp, dp, "euler_a")
    if "data_root" in inp:
        res["loader"] = loader_case(inp, dp)
    assert "jax" not in sys.modules and "sdbc_tpu" not in sys.modules
    with open(os.path.join(os.environ["SDBC_PAR_OUT"],
                           f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
