"""Full width, on the CPU: a checkpoint of SD-1.5 written by the JAX
package's ``save_pipeline``, read by ``sdbc_tpu_torch``'s readers and by
the JAX package's, bit for bit, both timed.

The checkpoint: SD-1.5's components with random weights from ``--seed``
(N(0, 0.02); the UNet and text encoder fp32, as mode C's masters, the VAE
bf16, as its frozen copy) and an 8-bit AdamW ``opt_state`` over mode C's
trainable set (UNet and text encoder; random codes, scales, fp32 moments,
a count of 10), about 6.5 GB under ``--dir``.  Its leaves are filled on the
host from ``jax.eval_shape`` of the JAX inits, so nothing is traced or
compiled.  Then, each in a fresh process and in turns (JAX, port, JAX,
port), ``load_pipeline(path)`` and ``load_opt_state`` of each package;
each prints its wall time and the SHA-256 of every leaf, which must equal
the digests taken before the save.  The second run of each is the one
reported (the first warms the page cache; both are warm reads).

    python experiments/torch_jax_ckpt_read.py --dir DIR [--seed N] [--keep]

The port's reads import no JAX; writing and the JAX reads import the JAX
package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODE_C = dict(train_text_encoder=True, train_unet=True, use_8bit_adam=True,
              grad_accum=4, num_examples=1000)


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    return jax


def _digest(a) -> dict:
    import numpy as np

    a = np.asarray(a)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "dtype": a.dtype.name, "shape": list(a.shape)}


def _jax_digests(tree) -> dict:
    from jax.tree_util import (DictKey, GetAttrKey, SequenceKey,
                               tree_flatten_with_path)

    def name(path):
        return ".".join(str(q.key) if isinstance(q, DictKey) else
                        str(q.idx) if isinstance(q, SequenceKey) else
                        q.name if isinstance(q, GetAttrKey) else str(q)
                        for q in path)

    return {name(p): _digest(leaf)
            for p, leaf in tree_flatten_with_path(tree)[0]}


def _mode_c_opt(jax, trainable):
    from sdbc_tpu.train import trainer

    return jax.eval_shape(trainer.make_optimizer(
        trainer.TrainConfig(**MODE_C)).init, trainable)


def write(path: str, seed: int) -> None:
    jax = _jax()
    import jax.numpy as jnp
    import ml_dtypes
    import numpy as np

    from sdbc_tpu.diffusion.pipeline import PipelineConfig
    from sdbc_tpu.models import clip, unet, vae
    from sdbc_tpu.utils import checkpoint

    cfg = PipelineConfig.sd15()
    rng = np.random.default_rng(seed)
    key = jax.random.key(seed)

    def fill(shapes, dtype):
        return jax.tree.map(lambda s: jnp.asarray(
            (rng.standard_normal(s.shape, np.float32) * 0.02).astype(dtype)),
            shapes)

    params = {
        "text_encoder": fill(jax.eval_shape(lambda: clip.init(key, cfg.clip)),
                             np.float32),
        "unet": fill(jax.eval_shape(lambda: unet.init(key, cfg.unet)),
                     np.float32),
        "vae": fill(jax.eval_shape(lambda: vae.init(key, cfg.vae)),
                    ml_dtypes.bfloat16)}
    trainable = {k: params[k] for k in ("text_encoder", "unet")}

    def state_leaf(path, s):
        if s.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, s.shape, np.int8))
        if getattr(path[-1], "name", "") in ("ms", "vs"):
            # a row's scale, broadcast over the 128 lanes
            return jnp.asarray(np.repeat(rng.random(
                (s.shape[0], 1), np.float32), s.shape[1], axis=1))
        if jnp.issubdtype(s.dtype, jnp.floating):
            return jnp.asarray(rng.random(s.shape, np.float32).astype(
                s.dtype))
        return jnp.asarray(np.full(s.shape, 10, s.dtype))

    opt = jax.tree_util.tree_map_with_path(state_leaf,
                                           _mode_c_opt(jax, trainable))
    digests = {c: _jax_digests(v) for c, v in params.items()}
    digests["opt_state"] = _jax_digests(opt)
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    checkpoint.save_pipeline(path, params, cfg, opt_state=opt,
                             metadata={"step": 10})
    secs = time.perf_counter() - t0
    with open(os.path.join(path, "digests.json"), "w") as f:
        json.dump(digests, f)
    total = sum(os.path.getsize(os.path.join(d, x))
                for d, _, fs in os.walk(path) for x in fs)
    print(json.dumps({"written_bytes": total, "save_s": secs,
                      "leaves": sum(map(len, digests.values()))}))


def read_jax(path: str) -> None:
    jax = _jax()
    from sdbc_tpu.utils import checkpoint

    t0 = time.perf_counter()
    params, _ = checkpoint.load_pipeline(path)
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    template = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=one),
        _mode_c_opt(jax, {k: params[k] for k in ("text_encoder", "unet")}))
    opt = checkpoint.load_opt_state(path, template)
    jax.block_until_ready((params, opt))
    secs = time.perf_counter() - t0
    digests = {c: _jax_digests(v) for c, v in params.items()}
    digests["opt_state"] = _jax_digests(opt)
    _report("jax", path, secs, digests)


def read_port(path: str) -> None:
    sys.path.insert(0, REPO)
    import torch

    from sdbc_tpu_torch.train import trainer
    from sdbc_tpu_torch.utils import checkpoint

    def dig(t):
        t = t.detach().contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return {"sha256": hashlib.sha256(raw.numpy().tobytes()).hexdigest(),
                "dtype": str(t.dtype).replace("torch.", ""),
                "shape": list(t.shape)}

    name = lambda key: ".".join(k for k, _ in key)
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    models, _ = checkpoint.load_pipeline(path, device="cpu")
    secs = time.perf_counter() - t0
    # the components as read, before the trainer takes them
    digests = {c: {name(k): dig(t) for k, t in checkpoint.module_tree(m)
                   if not isinstance(t, str)} for c, m in models.items()}
    state = trainer.init_train_state(models, trainer.TrainConfig(**MODE_C),
                                     compute_dtype=torch.float32,
                                     device="cpu")
    t1 = time.perf_counter()
    checkpoint.load_opt_state(path, state.opt_state, state.trainable, 0.0)
    secs += time.perf_counter() - t1
    digests["opt_state"] = {name(k): dig(t) for k, t in
                            checkpoint.opt_state_tree(
                                state.opt_state, state.trainable, 0.0)
                            if not isinstance(t, str)}
    if "jax" in sys.modules:
        raise SystemExit("the port's read imported jax")
    _report("port", path, secs, digests)


def _report(who: str, path: str, secs: float, digests: dict) -> None:
    with open(os.path.join(path, "digests.json")) as f:
        want = json.load(f)
    bad = [f"{c}.{k}" for c in want for k in want[c]
           if digests.get(c, {}).get(k) != want[c][k]]
    extra = [f"{c}.{k}" for c in digests for k in digests[c]
             if k not in want.get(c, {})]
    print(json.dumps({"reader": who, "load_s": secs,
                      "leaves": sum(map(len, digests.values())),
                      "mismatched": bad[:8], "n_mismatched": len(bad),
                      "extra": extra[:8]}))


def _child(*args) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"{args}: rc {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keep", action="store_true",
                   help="keep the checkpoint (default: removed after)")
    p.add_argument("--child", choices=["write", "jax", "port"],
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    path = os.path.abspath(args.dir)
    if args.child == "write":
        write(path, args.seed)
        return 0
    if args.child:
        (read_jax if args.child == "jax" else read_port)(path)
        return 0
    try:
        print("write", _child("--dir", path, "--seed", str(args.seed),
                              "--child", "write"), flush=True)
        runs = {"jax": [], "port": []}
        for who in ("jax", "port", "jax", "port"):
            r = _child("--dir", path, "--child", who)
            runs[who].append(r)
            print(who, r, flush=True)
        ok = all(r["n_mismatched"] == 0 and not r["extra"]
                 for rs in runs.values() for r in rs)
        cpu = next((ln.split(":", 1)[1].strip() for ln in open(
            "/proc/cpuinfo") if ln.startswith("model name")), "unknown")
        print(json.dumps({
            "host": f"{cpu}, {os.cpu_count()} cores",
            "jax_load_s": runs["jax"][1]["load_s"],
            "port_load_s": runs["port"][1]["load_s"],
            "ratio": runs["port"][1]["load_s"] / runs["jax"][1]["load_s"],
            "bit_equal": ok}))
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(path, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
