"""The port's fine-tuning entry point on the CPU at the tiny config: the
LoRA, textual-inversion, prior-preservation and cached-latent steps of
``sdbc_tpu_torch/train/trainer.py`` against the JAX package's
``make_train_step`` (fp32, the JAX draws and initial adapters injected),
and ``python -m sdbc_tpu_torch.cli.finetune`` end to end: save, the
SIGTERM checkpoint, a bit-exact resume and the refused flags.

Step tolerances: the loss to 1e-5 relative; the AdamW first moments
(0.1 × the gradient after one step) to 1e-4 of their largest entry plus
1e-7; the trained tensors to 1e-4 (at lr 2e-5, Adam's first step moves
each element by at most 2·lr + wd, so a gradient of rounding-noise size
whose sign differs stays inside)."""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey, SequenceKey, tree_flatten_with_path

from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu.utils import checkpoint as jckpt
from sdbc_tpu_torch.cli import finetune as tft
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
from sdbc_tpu_torch.train import trainer as ttrainer
from sdbc_tpu_torch.utils import checkpoint as tckpt
from tests.data_fixtures import build_fake_dataset
from tests.torch_threads import one_thread  # noqa: F401

ACCUM, MICRO, PRIOR, HW = 1, 2, 1, 32
LR = 2e-5
LOSS_RTOL, MU_RTOL, MU_ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-7, 1e-4


@pytest.fixture(scope="module")
def np_params(tiny_params):
    return jax.tree.map(np.asarray, tiny_params)


def _batch(cfg, mode, rng):
    vocab = cfg.clip.vocab_size + (2 if mode == "ti" else 0)
    ids = lambda n: rng.integers(0, vocab, (ACCUM, n, cfg.clip.ctx),
                                 dtype=np.int64).astype(np.int32)
    px = lambda n: (rng.standard_normal((ACCUM, n, HW, HW, 3)) * 0.5
                    ).astype(np.float32)
    b = {"input_ids": ids(MICRO)}
    if mode == "cached":
        lat = (ACCUM, MICRO, HW // 2, HW // 2, 4)
        b["latent_mean"] = rng.standard_normal(lat).astype(np.float32)
        b["latent_logvar"] = (rng.standard_normal(lat) * 0.3 - 1.0).astype(
            np.float32)
    else:
        b["pixel_values"] = px(MICRO)
    if mode == "prior":
        b["prior_pixel_values"] = px(PRIOR)
        b["prior_input_ids"] = ids(PRIOR)
    return b


def _jax_draws(key, n):
    """The JAX step's per-micro-batch eps, noise, t for ``n`` rows."""
    shape = (n, HW // 2, HW // 2, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    out = []
    for k in jax.random.split(key, ACCUM):
        kvae, knoise, kt = jax.random.split(k, 3)
        out.append({"eps": t(jax.random.normal(kvae, shape, jnp.float32)),
                    "noise": t(jax.random.normal(knoise, shape,
                                                 jnp.float32)),
                    "t": t(jax.random.randint(kt, (n,), 0, 1000))})
    return out


def _keyed(tree):
    return {tuple(str(q.key) if isinstance(q, DictKey) else str(q.idx)
                  for q in path): np.asarray(v)
            for path, v in tree_flatten_with_path(tree)[0]}


MODES = {
    "lora": dict(lora_rank=2, lora_alpha=4.0, train_unet=True),
    "ti": dict(ti_token="<sty>", ti_vectors=2, train_text_encoder=False),
    "prior": dict(prior_weight=0.5),
    "cached": dict(),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_step_matches_jax(tiny_params, np_params, mode):
    kw = dict(grad_accum=ACCUM, micro_batch=MICRO, learning_rate=LR,
              num_examples=100, **MODES[mode])
    jtc = jtrainer.TrainConfig(**kw)
    jstate = jtrainer.init_train_state(tiny_params, jtc,
                                       compute_dtype=jnp.float32,
                                       key=jax.random.key(3))
    jstep = jtrainer.make_train_step(JCfg.tiny(), jtc,
                                     compute_dtype=jnp.float32,
                                     cached_latents=mode == "cached")
    tcfg = ttrainer.TrainConfig(**kw)
    state = ttrainer.init_train_state(
        as_modules(np_params, PipelineConfig.tiny(), "cpu"), tcfg,
        compute_dtype=torch.float32, device="cpu")
    if mode in ("lora", "ti"):  # the JAX initial adapter
        with torch.no_grad():
            want = _keyed(jstate.trainable)
            ours = dict(zip(ttrainer.optimizer_leaf_keys(state.trainable),
                            ttrainer.optimizer_leaves(state.trainable)))
            assert {tuple(k for k, _ in key) for key in ours} == set(want)
            for key, (t,) in ours.items():
                t.copy_(torch.from_numpy(want[tuple(k for k, _ in key)]))
    batch = _batch(PipelineConfig.tiny(), mode, np.random.default_rng(4))
    key = jax.random.key(9)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       key)
    step = ttrainer.make_train_step(PipelineConfig.tiny(), tcfg,
                                    compute_dtype=torch.float32,
                                    device="cpu",
                                    cached_latents=mode == "cached")
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    n = MICRO + (PRIOR if mode == "prior" else 0)
    state, m = step(state, tb, draws=_jax_draws(key, n))
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
    # the first moments: 0.1 × the gradient, at every JAX tree leaf
    jadam = _keyed(jstate.opt_state.inner_state[0][0].mu)
    ours = {tuple(k for k, _ in key[4:]): t for key, t in
            tckpt.opt_state_tree(state.opt_state, state.trainable, 0.0)
            if len(key) > 4 and key[3][0] == "mu" and not isinstance(t, str)}
    assert set(ours) == set(jadam)
    top = max(np.abs(v).max() for v in jadam.values())
    for k, v in jadam.items():
        np.testing.assert_allclose(ours[k].numpy(), v,
                                   atol=MU_RTOL * top + MU_ATOL, err_msg=k)
    got = {tuple(k for k, _ in key): ts for key, ts in zip(
        ttrainer.optimizer_leaf_keys(state.trainable),
        ttrainer.optimizer_leaves(state.trainable))}
    for k, v in _keyed(jstate.trainable).items():
        t = torch.stack(got[k]) if len(got[k]) > 1 or "layers" in k \
            else got[k][0]
        np.testing.assert_allclose(t.detach().numpy(), v, atol=PARAM_ATOL,
                                   err_msg=str(k))


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return build_fake_dataset(str(tmp_path_factory.mktemp("ft") / "ds"),
                              n_train=8, n_test=2)


def _argv(data, out, *extra):
    return ["--tiny", "--device", "cpu", "--no-bf16", "--data_root", data,
            "--output_dir", out, "--num_examples", "4", "--batch_size", "2",
            "--grad_acc_steps", "1", "--ckpts_per_epoch", "1",
            "--num_workers", "1", "--learning_rate", "1e-3", *extra]


def _disk(path, name):
    return {tuple(k for k, _ in key): t for key, t in
            tckpt.read_tree(os.path.join(path, name)).items()}


def _state_trees(state, tcfg_max_norm=0.0):
    out = {"opt_state": {tuple(k for k, _ in key): t for key, t in
                         tckpt.opt_state_tree(state.opt_state,
                                              state.trainable, tcfg_max_norm)
                         if not isinstance(t, str)}}
    if "lora" in state.trainable or "ti" in state.trainable:
        out["adapter"] = {tuple(k for k, _ in key): ts[0].detach()
                          for key, ts in zip(
                              ttrainer.optimizer_leaf_keys(state.trainable),
                              ttrainer.optimizer_leaves(state.trainable))}
        return out
    for comp, m in state.trainable.items():
        out[comp] = {tuple(k for k, _ in key): t for key, t in
                     tckpt.module_tree(m) if not isinstance(t, str)}
    if state.ema is not None:
        out["ema"] = {(comp,) + tuple(k for k, _ in key): t
                      for comp, m in state.ema.items()
                      for key, t in tckpt.module_tree(m)
                      if not isinstance(t, str)}
    return out


def _assert_bits(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture
def capture(monkeypatch):
    """The state each step function sees: first call and last return."""
    seen = {}
    real = ttrainer.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, *args, **kwargs):
            if "first" not in seen:
                seen["first"] = state
                seen["first_trees"] = {k: {n: t.clone() for n, t in v.items()}
                                       for k, v in _state_trees(
                                           state).items()}
                seen["first_step"] = state.step
                seen["first_count"] = state.opt_state.inner.count
            if seen.get("sigterm"):
                seen["sigterm"] = False
                signal.raise_signal(signal.SIGTERM)
            out = step(state, *args, **kwargs)
            seen["last"] = out[0]
            return out

        return wrapped

    monkeypatch.setattr(ttrainer, "make_train_step", make)
    return seen


def test_cli_trains_saves_and_resumes_exactly(tmp_path, data, capture):
    """Full fine-tune (UNet + text encoder, 8-bit AdamW, EMA, remat by
    default): 2 epochs of 2 steps, a checkpoint each epoch; then --resume
    for a third epoch reloads the masters, moments, EMA and step of the
    last checkpoint bit for bit before its first step."""
    out = str(tmp_path / "out")
    argv = _argv(data, out, "--train_unet", "--use_8bit_adam",
                 "--ema_decay", "0.9", "--profile_dir",
                 str(tmp_path / "prof"), "--epochs", "2")
    stats = tft.main(argv)
    # the profiler traced this run's steps 3-4 (of 4)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert len(stats["losses"]) == 4 and np.isfinite(stats["losses"]).all()
    final = tckpt.latest_checkpoint(out, "dev")
    assert final.endswith("ckpt-4") and stats["final"] == final
    saved = _state_trees(capture["last"])
    for name, tree in saved.items():
        _assert_bits(_disk(final, name), tree)
    # the JAX package restores the port's checkpoint (EMA overlaid)
    params, cfg = jckpt.load_pipeline(final)
    assert set(params) == {"text_encoder", "unet", "vae"}
    assert tckpt.load_metadata(final)["step"] == 4
    capture.clear()
    stats2 = tft.main(argv[:-1] + ["3", "--resume"])
    assert capture["first_step"] == 4
    assert capture["first_count"] == 4
    for name, tree in capture["first_trees"].items():
        _assert_bits(tree, saved[name])
    assert len(stats2["losses"]) == 2
    assert tckpt.latest_checkpoint(out, "dev").endswith("ckpt-6")
    events = (tmp_path / "out" / "runs" / "dev" / "events.jsonl").read_text()
    assert '"loss"' in events and '"mean_loss"' in events


def test_cli_sigterm_checkpoints_and_restores_handlers(tmp_path, data,
                                                       capture):
    before = signal.getsignal(signal.SIGTERM)
    capture["sigterm"] = True
    out = str(tmp_path / "out")
    stats = tft.main(_argv(data, out, "--epochs", "2"))
    assert stats["preempted"] and len(stats["losses"]) == 1
    assert tckpt.load_metadata(stats["final"]) == {
        "step": 1, "epoch": 0, "best_mean_loss": float("inf"),
        "preempted": True}
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("mode,extra", [
    ("lora", ["--lora_rank", "2", "--train_unet"]),
    ("ti", ["--ti_token", "<sty>", "--ti_vectors", "2",
            "--no-train_text_encoder"]),
    ("prior", ["--prior_class_prompt", "a book cover", "--prior_generate",
               "2", "--prior_gen_steps", "2"]),
    ("cache", ["--cache_latents", "--final_grids"]),
])
def test_cli_modes_end_to_end(tmp_path, data, capture, mode, extra):
    """Each mode trains one epoch, saves a checkpoint the JAX
    ``load_pipeline`` restores (adapters merged), and an adapter run's
    --resume restores the adapter bit for bit."""
    out = str(tmp_path / "out")
    argv = _argv(data, out, "--epochs", "1", *extra)
    stats = tft.main(argv)
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 2
    final = stats["final"]
    files = set(os.listdir(final))
    assert {"config.json", "metadata.json", "opt_state", "unet"} <= files
    assert ("lora.npz" in files) == (mode == "lora")
    assert ({"ti.npz", "added_tokens.json"} <= files) == (mode == "ti")
    params, cfg = jckpt.load_pipeline(final)
    if mode == "ti":
        assert cfg.clip.vocab_size == JCfg.tiny().clip.vocab_size + 2
    if mode == "prior":
        assert sorted(os.listdir(os.path.join(out, "prior_class"))) == \
            ["class-00000.png", "class-00001.png"]
    if mode == "cache":
        grids = os.path.join(out, "runs", "dev", "grids")
        assert os.listdir(grids) and os.listdir(os.path.join(
            data, "latent_cache"))
    if mode in ("lora", "ti"):
        saved = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in _state_trees(capture["last"]).items()}
        capture.clear()
        stats = tft.main(_argv(data, out, "--epochs", "2", "--resume",
                               *extra))
        assert capture["first_step"] == 2 and len(stats["losses"]) == 2
        for name, tree in saved.items():
            _assert_bits(capture["first_trees"][name], tree)


# each case: its id, the flags and the message they exit with.  The SDXL
# family and ControlNet train since their ports; the ControlNet cases
# keep their ids for the refusals --train_controlnet keeps
REFUSED = [
    ("--train_controlnet", ["--train_controlnet", "--lora_rank", "2"],
     "--train_controlnet is a full-branch mode"),
    # --tp and --fsdp are ported (tests/test_torch_parallel*.py): one
    # process has no model axis of 2, and FSDP keeps the JAX refusal of
    # the 8-bit moments
    ("--tp 2", ["--tp", "2"], r"--tp 2: mesh 0x2 != 1 devices"),
    ("--fsdp", ["--fsdp", "--use_8bit_adam"],
     "--use_8bit_adam cannot combine with --fsdp/--tp"),
    ("--model_family sdxl", ["--model_family", "sdxl", "--train_controlnet",
                             "--train_unet"],
     "--train_controlnet freezes the whole base model"),
    ("--wandb_key k", ["--wandb_key", "k"], "wandb.*not ported yet"),
]


@pytest.mark.parametrize("flags,what", [c[1:] for c in REFUSED],
                         ids=[c[0] for c in REFUSED])
def test_unported_flags_exit_with_their_feature(flags, what):
    with pytest.raises(SystemExit, match=f"(?s){what}"):
        tft.main(["--tiny", "--device", "cpu"] + flags)


@pytest.mark.parametrize("flags,what", [
    (["--lora_rank", "2", "--ti_token", "x"], "mutually exclusive"),
    (["--lora_rank", "2", "--ema_decay", "0.9"], "--ema_decay cannot"),
    (["--prior_generate", "2"], "needs --prior_class_prompt"),
    (["--prior_class_prompt", "x", "--cache_latents"], "incompatible"),
])
def test_flag_combinations_refused_as_jax(flags, what):
    with pytest.raises(SystemExit, match=what):
        tft.main(["--tiny", "--device", "cpu"] + flags)


def test_training_alias_and_grad_ckpt_default():
    from sdbc_tpu_torch.cli import training

    assert training.main is tft.main
    p = tft.build_parser()
    assert p.parse_args([]).grad_ckpt is None
    assert p.parse_args([]).device == "cuda"
    from sdbc_tpu.cli import finetune as jft

    ours = {a.dest for a in p._actions} - {"help", "device"}
    assert ours == {a.dest for a in jft.build_parser()._actions} - {"help"}
