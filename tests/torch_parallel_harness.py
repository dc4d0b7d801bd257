"""Shared by the port's parallel tests: the 2-rank gloo worker launch
(``tests/torch_parallel_worker.py``) and the checks of trained trees.

Every launch takes a free port and its own timeout (``TIMEOUT`` s) and,
past it, kills its whole process group: a hang fails one test, not the
suite."""
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdbc_tpu_torch.models.convert import _flatten_jax_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
TIMEOUT = 120

# the JAX package's own DP/TP tests (tests/test_parallel.py:100-105): the
# mesh's reductions sum in another order than one device does
RTOL, ATOL = 1e-4, 1e-5
# Adam divides each gradient by its own magnitude: an element whose
# gradient is rounding noise (a cancelling sum) takes an O(lr) step of
# either sign in either package, so such elements are held to Adam's
# bound |Δ| ≤ 2·lr only (tests/test_torch_train.py); the attention key
# biases' gradient is identically zero, all their entries are such noise
MAX_NOISY_SHARE = 1e-4
NOISE_ONLY = ("attn.k.bias", "attn1.k.bias", "attn2.k.bias")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "COORDINATOR_ADDRESS",
                        "SDBC_NUM_PROCESSES", "SDBC_PROCESS_ID",
                        "SDBC_MULTIHOST", "LOCAL_RANK", "RANK",
                        "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=ROOT, **extra)
    return env


class Ranks:
    """``n`` processes of ``argv`` joined by the SDBC_* contract."""

    def __init__(self, argv, n: int = 2, env=None, timeout=TIMEOUT,
                 cwd=None, contract: bool = True):
        port = free_port()
        self.timeout, self.t0 = timeout, time.time()

        def rank_env(i):
            if not contract:   # a plain one-process run
                return clean_env(**(env or {}))
            return clean_env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                             SDBC_NUM_PROCESSES=str(n),
                             SDBC_PROCESS_ID=str(i), **(env or {}))

        # each rank's output to a file: a pipe left unread while waiting
        # for another rank could block it inside a collective
        self.logs = [tempfile.TemporaryFile() for _ in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable] + list(argv), cwd=cwd or ROOT, env=rank_env(i),
            stdout=self.logs[i], stderr=subprocess.STDOUT,
            start_new_session=True) for i in range(n)]

    def _read(self) -> list:
        out = []
        for f in self.logs:
            f.seek(0)
            out.append(f.read().decode(errors="replace"))
        return out

    def wait(self) -> list:
        """Every rank's output; fails (after killing them all) on a
        timeout or a non-zero exit."""
        for p in self.procs:
            left = max(self.timeout - (time.time() - self.t0), 1)
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    try:
                        os.killpg(q.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    q.wait()
                raise AssertionError(
                    f"ranks timed out after {self.timeout} s:\n"
                    + "\n====\n".join(self._read()))
        logs = self._read()
        bad = [p.returncode for p in self.procs]
        assert bad == [0] * len(bad), \
            f"rank exits {bad}:\n" + "\n====\n".join(logs)
        return logs


def launch_worker(inp: dict, tmp: str) -> Ranks:
    path = os.path.join(tmp, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return Ranks([WORKER], env={"SDBC_PAR_IN": path, "SDBC_PAR_OUT": tmp})


def worker_results(ranks: Ranks, tmp: str) -> list:
    ranks.wait()
    out = []
    for r in range(len(ranks.procs)):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def jax_train_draws(key, n: int, accum: int, lat: int, channels: int,
                    timesteps: int) -> list:
    """The per-micro-batch draws the JAX step takes from ``key`` for
    ``n`` latent rows (``split(key, grad_accum)``, then ``split(k, 3)``
    per micro-batch, as ``sdbc_tpu/train/trainer.py`` does)."""
    import jax.numpy as jnp

    shape = (n, lat, lat, channels)
    draws = []
    for k in jax.random.split(key, accum):
        kvae, knoise, kt = jax.random.split(k, 3)
        draws.append({
            "eps": np.asarray(jax.random.normal(kvae, shape, jnp.float32)),
            "noise": np.asarray(jax.random.normal(knoise, shape,
                                                  jnp.float32)),
            "t": np.asarray(jax.random.randint(kt, (n,), 0, timesteps))})
    return draws


def assert_tree_close(jax_tree, port: dict, lr: float, steps: int = 1,
                      rtol: float = RTOL, atol: float = ATOL) -> None:
    """A trained component (port: {parameter name: array}) against the
    JAX package's tree: within rtol/atol, the Adam-noise elements within
    Adam's bound (module docstring)."""
    flat = _flatten_jax_tree(None, jax.tree.map(np.asarray, jax_tree))
    assert set(flat) == set(port)
    noisy = total = 0
    for name, want in flat.items():
        got = port[name]
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr * steps, (name, diff.max())
        bad = diff > atol + rtol * np.abs(want)
        if not name.endswith(NOISE_ONLY):
            noisy += int(bad.sum())
            total += diff.size
    assert noisy <= MAX_NOISY_SHARE * total, (noisy, total)


# the moments are the gradient (AdamW's m) and its square (v) summed over
# the data group and the micro-batches in another order: held to RTOL,
# and to an absolute MOMENT_ATOL of the largest first (second) moment of
# the state for elements near zero (a cancelling sum), with the Adam-noise
# share; AdamW's normalised step leaves the parameters blind to a scale of
# the gradient (a sum in place of the mean), the moments are not
MOMENT_ATOL = 1e-6


def assert_moments_close(jax_opt_state, port: list) -> None:
    """The port's optimizer state (``[(JAX key path, array)]`` in the
    optax tree's flatten order) against the JAX package's: the counters
    and flags equal, the fp32 moments and the 8-bit rows' scales within
    RTOL / MOMENT_ATOL; the int8 codes (which a rounding can move by one
    step) are left to the scales and the parameters."""
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_opt_state)]
    assert len(want) == len(port), (len(want), len(port))

    def order(key):
        return 1 if set(key) & {"mu", "m", "ms"} else (
            2 if set(key) & {"nu", "v", "vs"} else 0)

    scale = {o: max((float(np.abs(w).max()) for (k, _), w in zip(port, want)
                     if order(k) == o and w.size), default=0.0)
             for o in (0, 1, 2)}
    noisy = total = 0
    for (key, got), w in zip(port, want):
        assert got.shape == w.shape, (key, got.shape, w.shape)
        if w.dtype == np.int8:
            continue
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(got, w, err_msg=str(key))
            continue
        bad = np.abs(got - w) > MOMENT_ATOL * scale[order(key)] \
            + RTOL * np.abs(w)
        noisy += int(bad.sum())
        total += w.size
    assert total and noisy <= MAX_NOISY_SHARE * total, (noisy, total)


GLOBAL_MICRO, HW, LR = 4, 32, 1e-4


def _batch(cfg, accum, micro, seed, prior=False):
    rng = np.random.default_rng(seed)

    def part(prefix=""):
        return {prefix + "pixel_values": (rng.standard_normal(
                    (accum, micro, HW, HW, 3)) * 0.5).astype(np.float32),
                prefix + "input_ids": rng.integers(
                    0, cfg.clip.vocab_size, (accum, micro, cfg.clip.ctx),
                    dtype=np.int64).astype(np.int32)}

    out = part()
    if prior:
        out.update(part("prior_"))
    return out


def jax_train(tiny_cfg, tiny_params, c, batch, key, mesh, shard=None):
    from sdbc_tpu.parallel import mesh as jmesh
    from sdbc_tpu.parallel import specs as jspecs
    from sdbc_tpu.train import trainer as jt

    jc = {k: v for k, v in c["tcfg"].items() if k != "micro_batch"}
    tcfg = jt.TrainConfig(micro_batch=c["tcfg"]["micro_batch"], **jc)
    # one compiled program, not one per leaf of the eager init
    state = jax.jit(lambda p: jt.init_train_state(
        p, tcfg, compute_dtype=jnp.float32))(tiny_params)
    state = (jspecs.shard_tree(state, mesh, shard(state, mesh)) if shard
             else jmesh.replicate_tree(state, mesh))
    step = jt.make_train_step(tiny_cfg, tcfg, mesh=mesh,
                              dp_size=mesh.shape["data"],
                              compute_dtype=jnp.float32)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                    key)
    return {"loss": float(m["loss"]), "trainable": state.trainable,
            "ema": state.ema, "opt_state": state.opt_state}


def train_inputs(tiny_cfg, cases):
    """The worker's train cases and, per case, (batch, key)."""
    lat = HW // tiny_cfg.vae_scale
    out, keys = {}, {}
    for name, c in cases.items():
        prior = c.get("prior", False)
        batch = _batch(tiny_cfg, c["accum"], GLOBAL_MICRO, c["seed"], prior)
        key = jax.random.key(100 + c["seed"])
        n = GLOBAL_MICRO * (2 if prior else 1)
        out[name] = {k: v for k, v in c.items()
                     if k in ("tcfg", "shard", "moments", "tp_mesh")}
        out[name].update(batch=batch, draws=jax_train_draws(
            key, n, c["accum"], lat, tiny_cfg.latent_channels,
            tiny_cfg.schedule.num_train_timesteps))
        keys[name] = (batch, key)
    return out, keys


def tiny_trees(seed: int = 0):
    """(numpy trees, JAX trees) of a tiny model initialised by the port
    (``models.port.module_jax_tree``): no JAX init to compile."""
    from sdbc_tpu_torch.diffusion.graph import init_models
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.models.port import module_jax_tree

    models = init_models(PipelineConfig.tiny(), device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    np_params = {k: module_jax_tree(m) for k, m in models.items()}
    return np_params, jax.tree.map(jnp.asarray, np_params)
