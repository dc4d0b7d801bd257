"""Write ``tests/data/jax_ckpt_tiny/``: a checkpoint of the JAX package's
``save_pipeline``, which ``sdbc_tpu_torch``'s readers are held to on the CPU
(``tests/test_torch_jax_checkpoint.py``) and on the card
(``chip_smoke.py``'s ``jax-ckpt`` phase).

The pipeline is ``PipelineConfig.tiny()`` cut so that the directory stays
under 2 MB: a one-level UNet (32 channels, attention at head dim 8, so the
card's attention and feed-forward kernels take it), a one-layer text
encoder, a (8, 16) VAE.  Random weights from ``--seed``; nothing is
downloaded.  The text encoder is trained for ``--steps`` steps of the JAX
train step with 8-bit AdamW and an EMA shadow (bf16 compute, the frozen
UNet and VAE saved as their bf16 copies, as the JAX finetune CLI saves
them), then the whole state is placed on an 8-device CPU mesh under the
JAX package's FSDP rules (``parallel/specs.py::fsdp_specs``; the int8
optimizer state, which those rules refuse to shard, replicated) and saved,
so leaves sharded over the mesh are stored one chunk a shard.

Beside the checkpoint: ``digests.json``, each leaf's SHA-256, dtype and
shape per tree (from the JAX tree before the save), and ``fixture.json``,
the finetune CLI flags that resume it.

    python experiments/make_jax_ckpt_fixture.py [--out DIR] [--seed N]

Imports the JAX package; it is not part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from jax.sharding import Mesh  # noqa: E402
from jax.tree_util import (DictKey, GetAttrKey, SequenceKey,  # noqa: E402
                           tree_flatten_with_path)

from sdbc_tpu.diffusion.pipeline import PipelineConfig  # noqa: E402
from sdbc_tpu.models import clip, unet, vae  # noqa: E402
from sdbc_tpu.parallel import specs  # noqa: E402
from sdbc_tpu.parallel.mesh import replicate_tree  # noqa: E402
from sdbc_tpu.train import trainer  # noqa: E402
from sdbc_tpu.utils import checkpoint  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "jax_ckpt_tiny")
LIMIT = 2 * 1024 * 1024
# the finetune CLI's flags that train (and so resume) this state
TRAIN = dict(train_unet=False, train_text_encoder=True, use_8bit_adam=True,
             ema_decay=0.9, learning_rate=1e-3, grad_accum=1, micro_batch=2,
             num_examples=64)


def fixture_config() -> PipelineConfig:
    cfg = PipelineConfig.tiny()
    return dataclasses.replace(
        cfg,
        unet=dataclasses.replace(cfg.unet, block_out_channels=(32,),
                                 cross_attn_blocks=(True,)),
        clip=dataclasses.replace(cfg.clip, layers=1),
        vae=dataclasses.replace(cfg.vae, block_out_channels=(8, 16),
                                norm_groups=4))


def _path(path) -> str:
    out = []
    for q in path:
        out.append(str(q.key) if isinstance(q, DictKey) else
                   str(q.idx) if isinstance(q, SequenceKey) else
                   q.name if isinstance(q, GetAttrKey) else str(q))
    return ".".join(out)


def digests(tree) -> dict:
    """{leaf path: {sha256, dtype, shape}} of a tree's array leaves."""
    out = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        a = np.asarray(jax.device_get(leaf))
        out[_path(path)] = {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
                            "dtype": str(a.dtype), "shape": list(a.shape)}
    return out


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)

    cfg = fixture_config()
    k1, k2, k3, key = jax.random.split(jax.random.key(args.seed), 4)
    params = {"text_encoder": clip.init(k1, cfg.clip),
              "unet": unet.init(k2, cfg.unet), "vae": vae.init(k3, cfg.vae)}
    tcfg = trainer.TrainConfig(**TRAIN)
    state = trainer.init_train_state(params, tcfg,
                                     compute_dtype=jnp.bfloat16)
    step = trainer.make_train_step(cfg, tcfg, compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(args.seed)
    size = 32
    for _ in range(args.steps):
        batch = {
            "pixel_values": jnp.asarray(rng.uniform(
                -1, 1, (1, 2, size, size, 3)).astype(np.float32)),
            "input_ids": jnp.asarray(rng.integers(
                0, cfg.clip.vocab_size, (1, 2, cfg.clip.ctx)).astype(
                    np.int32))}
        key, sub = jax.random.split(key)
        state, metrics = step(state, batch, sub)
        print(f"step {int(state.step)} loss {float(metrics['loss']):.5f}")

    # the save: params and the EMA shadow sharded over an 8-device mesh
    # by the JAX FSDP rules, the int8 optimizer state replicated
    mesh = Mesh(np.array(jax.devices()).reshape(8, 1), ("data", "model"))
    models = trainer.merged_params(state, tcfg)
    models = specs.shard_tree(models, mesh, specs.fsdp_specs(models, mesh))
    ema = {"text_encoder": state.ema["text_encoder"]}
    ema = specs.shard_tree(ema, mesh, specs.fsdp_specs(ema, mesh))
    opt_state = replicate_tree(state.opt_state, mesh)
    sharded = [_path(path) for path, leaf in tree_flatten_with_path(
        models)[0] if len(leaf.sharding.device_set) > 1
        and not leaf.sharding.is_fully_replicated]
    meta = {"step": int(state.step), "epoch": 0,
            "best_mean_loss": float(metrics["loss"])}
    want = {comp: digests(models[comp]) for comp in models}
    want["ema"] = digests(ema)
    want["opt_state"] = digests(opt_state)
    shutil.rmtree(args.out, ignore_errors=True)
    checkpoint.save_pipeline(args.out, models, cfg, opt_state=opt_state,
                             metadata=meta, ema=ema)
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(want, f, indent=1, sort_keys=True)
    with open(os.path.join(args.out, "fixture.json"), "w") as f:
        json.dump({"train": TRAIN, "seed": args.seed, "steps": args.steps,
                   "sharded_leaves": len(sharded)}, f, indent=1)
    total = dir_bytes(args.out)
    print(f"{args.out}: {total} bytes, {len(sharded)} leaves sharded over "
          "the mesh")
    if total > LIMIT:
        raise SystemExit(f"{total} bytes > {LIMIT}")


if __name__ == "__main__":
    main()
