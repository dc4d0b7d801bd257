"""The fine-tuning entry point on the SD-2.x and SDXL families, on the CPU
in fp32 at the tiny configs: the tiny_xl LoRA, textual-inversion and
prior-preservation steps against the JAX package's (the JAX draws and
initial adapters injected; adapters on the depth-2 transformers' stacked
blocks and on ``text_encoder_2``, the inversion's ``rows2``, the class
batch's ``prior_input_ids_2``), the data path's ``input_ids_2``, and
``python -m sdbc_tpu_torch.cli.finetune --tiny --model_family sd21|sdxl``
(and a refiner ``--ckpt``) end to end: a checkpoint the JAX
``load_pipeline`` and ``load_opt_state`` restore equal, a bit-exact
``--resume``, the inversion's encoder-count check and the JAX CLI's
refusals.

Tolerances: ``tests/test_torch_finetune.py``'s."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data import dataset as jds
from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTok
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.train import prior as jprior
from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu.utils import checkpoint as jckpt
from sdbc_tpu_torch.cli import finetune as tft
from sdbc_tpu_torch.data import dataset as tds
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, as_modules,
                                               init_models)
from sdbc_tpu_torch.train import prior as tprior
from sdbc_tpu_torch.train import textual_inversion as tti
from sdbc_tpu_torch.train import trainer as ttrainer
from sdbc_tpu_torch.utils import checkpoint as tckpt
from tests.data_fixtures import build_fake_dataset
from tests.test_torch_checkpoint import _flat
from tests.test_torch_families import port_init_tree
from tests.test_torch_finetune import (  # noqa: F401
    LOSS_RTOL, LR, MU_ATOL, MU_RTOL, PARAM_ATOL, _argv, _assert_bits,
    _disk, _jax_draws, _keyed, _state_trees, capture, data)
from tests.test_torch_train_families import jax_keyed
from tests.torch_threads import one_thread  # noqa: F401

ACCUM, MICRO, PRIOR, HW = 1, 2, 1, 32


@pytest.fixture(scope="module")
def xl_tree():
    return port_init_tree(PipelineConfig.tiny_xl(), 7)


def _batch(cfg, mode, rng):
    vocab = cfg.clip.vocab_size + (2 if mode == "ti" else 0)
    ids = lambda n: rng.integers(0, vocab, (ACCUM, n, cfg.clip.ctx),
                                 dtype=np.int64).astype(np.int32)
    px = lambda n: (rng.standard_normal((ACCUM, n, HW, HW, 3)) * 0.5
                    ).astype(np.float32)
    b = {"input_ids": ids(MICRO), "input_ids_2": ids(MICRO),
         "pixel_values": px(MICRO)}
    if mode == "prior":
        b.update(prior_pixel_values=px(PRIOR), prior_input_ids=ids(PRIOR),
                 prior_input_ids_2=ids(PRIOR))
    return b


MODES = {
    "lora": dict(lora_rank=2, lora_alpha=4.0, train_unet=True),
    "ti": dict(ti_token="<sty>", ti_vectors=2, train_text_encoder=False),
    "prior": dict(prior_weight=0.5),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_xl_adapter_step_matches_jax(xl_tree, mode):
    """One tiny_xl step of LoRA (UNet and both encoders: a depth-2
    transformer's ``blocks`` adapted as one stacked path, as JAX
    ``init_lora`` gives it), textual inversion (``rows`` and ``rows2``)
    or prior preservation (both encoders trained, the class batch's
    second ids) against the JAX step: the adapter's keys and shapes, the
    loss, every first moment and every trained tensor."""
    kw = dict(grad_accum=ACCUM, micro_batch=MICRO, learning_rate=LR,
              num_examples=100, dual_text_encoder=True, **MODES[mode])
    jtc = jtrainer.TrainConfig(**kw)
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, xl_tree),
                                       jtc, compute_dtype=jnp.float32,
                                       key=jax.random.key(3))
    jstep = jtrainer.make_train_step(JCfg.tiny_xl(), jtc,
                                     compute_dtype=jnp.float32)
    tcfg = ttrainer.TrainConfig(**kw)
    state = ttrainer.init_train_state(
        as_modules(xl_tree, PipelineConfig.tiny_xl(), "cpu"), tcfg,
        compute_dtype=torch.float32, device="cpu")
    want = _keyed(jstate.trainable)
    ours = dict(zip(ttrainer.optimizer_leaf_keys(state.trainable),
                    ttrainer.optimizer_leaves(state.trainable)))
    if mode != "prior":  # the JAX initial adapter, key for key
        assert {tuple(k for k, _ in key): tuple(t.shape)
                for key, (t,) in ours.items()} == \
            {k: v.shape for k, v in want.items()}
        with torch.no_grad():
            for key, (t,) in ours.items():
                t.copy_(torch.from_numpy(np.array(
                    want[tuple(k for k, _ in key)])))
    if mode == "lora":
        a = want[("lora", "unet.down.1.attns.0.blocks.attn1.q", "a")]
        assert a.shape == (2, 64, 2)  # (depth, in, rank)
        assert any(k[1].startswith("text_encoder_2.layers.") for k in want)
    if mode == "ti":
        assert set(want) == {("ti", "rows"), ("ti", "rows2")}
    batch = _batch(PipelineConfig.tiny_xl(), mode, np.random.default_rng(4))
    key = jax.random.key(9)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       key)
    step = ttrainer.make_train_step(PipelineConfig.tiny_xl(), tcfg,
                                    compute_dtype=torch.float32,
                                    device="cpu")
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in batch.items()}
    n = MICRO + (PRIOR if mode == "prior" else 0)
    state, m = step(state, tb, draws=_jax_draws(key, n))
    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=LOSS_RTOL)
    jadam = _keyed(jstate.opt_state.inner_state[0][0].mu)
    mu = {tuple(k for k, _ in key[4:]): t for key, t in
          tckpt.opt_state_tree(state.opt_state, state.trainable, 0.0)
          if len(key) > 4 and key[3][0] == "mu" and not isinstance(t, str)}
    assert set(mu) == set(jadam)
    top = max(np.abs(v).max() for v in jadam.values())
    for k, v in jadam.items():
        np.testing.assert_allclose(mu[k].numpy(), v,
                                   atol=MU_RTOL * top + MU_ATOL, err_msg=k)
    got = {tuple(k for k, _ in key): ts for key, ts in zip(
        ttrainer.optimizer_leaf_keys(state.trainable),
        ttrainer.optimizer_leaves(state.trainable))}
    for k, v in _keyed(jstate.trainable).items():
        t = torch.stack(got[k]) if len(got[k]) > 1 or "layers" in k \
            or "blocks" in k else got[k][0]
        np.testing.assert_allclose(t.detach().numpy(), v, atol=PARAM_ATOL,
                                   err_msg=str(k))


def test_loader_and_prior_carry_second_ids(tmp_path):
    """With ``tokenizer2`` the loader's batches (pixels, and the cached
    latents' payload) and the prior set's carry the second tokenizer's
    ids of the same prompts, equal to the JAX package's."""
    root = build_fake_dataset(str(tmp_path / "ds"), n_train=4, n_test=1)
    mk = lambda mod: mod.DatasetConfig(data_root=root, img_size=32,
                                       max_length=16, seed=5,
                                       use_native=False)
    jd = jds.GoodreadsDataset(mk(jds), JTok.fallback(1000),
                              tokenizer2=JTok.fallback(900))
    td = tds.GoodreadsDataset(mk(tds), TTok.fallback(1000),
                              tokenizer2=TTok.fallback(900))
    jb = next(jds.make_dataloader(jd, micro_batch=2, grad_accum=2, seed=3,
                                  num_workers=1, epoch=0))
    tb = next(tds.make_dataloader(td, micro_batch=2, grad_accum=2, seed=3,
                                  num_workers=1, epoch=0))
    assert set(tb) == set(jb) == {"pixel_values", "input_ids",
                                  "input_ids_2"}
    for k in ("input_ids", "input_ids_2"):
        np.testing.assert_array_equal(tb[k], jb[k])
    assert not np.array_equal(tb["input_ids"], tb["input_ids_2"])
    cache = (np.zeros((4, 16, 16, 4), np.float32),) * 2
    cb = next(tds.make_dataloader(td, micro_batch=2, grad_accum=2, seed=3,
                                  num_workers=1, epoch=0,
                                  latent_cache=cache))
    assert set(cb) == {"latent_mean", "latent_logvar", "input_ids",
                       "input_ids_2"}
    np.testing.assert_array_equal(cb["input_ids_2"], tb["input_ids_2"])
    d = os.path.join(root, "images", "images")
    js = jprior.PriorSet(d, "a book cover", JTok.fallback(1000), 32,
                         max_length=16, tokenizer2=JTok.fallback(900))
    ts = tprior.PriorSet(d, "a book cover", TTok.fallback(1000), 32,
                         max_length=16, tokenizer2=TTok.fallback(900))
    a, b = next(js.batches(2, 2, seed=1)), next(ts.batches(2, 2, seed=1))
    assert set(a) == set(b) and "prior_input_ids_2" in b
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def refiner_ckpt(tmp_path_factory):
    """A port checkpoint of a random tiny_xl_refiner."""
    path = str(tmp_path_factory.mktemp("rf") / "ck")
    cfg = PipelineConfig.tiny_xl_refiner()
    tckpt.save_pipeline(path, init_models(
        cfg, device="cpu", generator=torch.Generator().manual_seed(2)), cfg)
    return path


def _assert_jax_restores(path):
    """The JAX ``load_pipeline`` of ``path`` equals the port's, adapters
    merged and the EMA overlaid in both."""
    params, cfg = jckpt.load_pipeline(path)
    models, tcfg = tckpt.load_pipeline(path)
    assert set(params) == set(models)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        tckpt.config_from_json(tckpt.config_to_json(tcfg)))
    for comp, m in models.items():
        want = {tuple(str(k) for k, _ in key): v
                for key, v in _flat(params[comp]).items()}
        got = {tuple(k for k, _ in key): t.numpy() for key, t in
               tckpt.module_tree(m) if not isinstance(t, str)}
        assert set(got) == set(want), comp
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=str(k))
    return params, cfg


CLI_CASES = {
    "sd21 full": ["--model_family", "sd21", "--train_unet",
                  "--use_8bit_adam", "--ema_decay", "0.9"],
    "sdxl full": ["--model_family", "sdxl", "--train_unet",
                  "--use_8bit_adam", "--remat_mode", "selective"],
    "sdxl lora": ["--model_family", "sdxl", "--lora_rank", "2",
                  "--train_unet"],
    "sdxl ti": ["--model_family", "sdxl", "--ti_token", "<sty>",
                "--ti_vectors", "2", "--no-train_text_encoder"],
    "refiner full": ["--train_unet", "--use_8bit_adam"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_family_end_to_end(tmp_path, data, capture, refiner_ckpt,
                               case):
    """Each case trains one epoch of 2 steps and saves a checkpoint that
    the JAX ``load_pipeline`` restores equal to the port's own load (and,
    for the full fine-tunes, ``load_opt_state`` over the JAX trainable
    tree); then --resume for a second epoch sees the saved state bit for
    bit before its first step."""
    extra = list(CLI_CASES[case])
    if case.startswith("refiner"):
        extra += ["--ckpt", refiner_ckpt]
    out = str(tmp_path / "out")
    stats = tft.main(_argv(data, out, "--epochs", "1", *extra))
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 2
    final = stats["final"]
    files = set(os.listdir(final))
    want_comps = {"sd21": {"text_encoder"}, "sdxl": {
        "text_encoder", "text_encoder_2"}, "refiner": {"text_encoder_2"}}[
        case.split()[0]] | {"unet", "vae", "opt_state"}
    assert want_comps <= files
    assert ("text_encoder" in files) != case.startswith("refiner")
    params, cfg = _assert_jax_restores(final)
    if case == "sd21 full":
        assert cfg.schedule.prediction_type == "v_prediction"
        assert "ema" in files
    if case == "sdxl ti":
        rows, meta = tti.load_ti(os.path.join(final, "ti.npz"))
        assert rows.shape == (2, 32) and meta["rows2"].shape == (2, 32)
        base = JCfg.tiny_xl()
        assert (cfg.clip.vocab_size, cfg.clip2.vocab_size) == \
            (base.clip.vocab_size + 2, base.clip2.vocab_size + 2)
    if case.endswith("full"):
        # the JAX optimizer restores the port's moments over its tree
        tc = tckpt.config_from_json(tckpt.config_to_json(
            tckpt.load_pipeline(final)[1]))
        jtc = jtrainer.TrainConfig(train_unet=True, use_8bit_adam=True,
                                   dual_text_encoder=tc.is_sdxl,
                                   refiner=tc.refiner,
                                   ema_decay=0.9 if "sd21" in case else 0)
        trainable = {k: params[k] for k in jtc.trainable_keys()}
        restored = jckpt.load_opt_state(
            final, jtrainer.make_optimizer(jtc).init(trainable))
        want = _disk(final, "opt_state")
        got = jax_keyed(restored)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          v.view(torch.int16).numpy()
                                          if v.dtype == torch.bfloat16
                                          else v.numpy(), err_msg=str(k))
    if case.startswith("refiner"):
        with pytest.raises(SystemExit, match="refiner flavor"):
            tft.main(_argv(data, str(tmp_path / "o2"), "--ckpt",
                           refiner_ckpt, "--ti_token", "<s>"))
        return
    saved = {k: {n: t.clone() for n, t in v.items()}
             for k, v in _state_trees(capture["last"]).items()}
    capture.clear()
    stats = tft.main(_argv(data, out, "--epochs", "2", "--resume", *extra))
    assert capture["first_step"] == 2 and len(stats["losses"]) == 2
    for name, tree in saved.items():
        _assert_bits(capture["first_trees"][name], tree)
    if case == "sdxl ti":
        # a single-encoder embedding cannot resume an SDXL inversion
        last = tckpt.latest_checkpoint(out, "dev")
        rows, meta = tti.load_ti(os.path.join(last, "ti.npz"))
        tti.save_ti(os.path.join(last, "ti.npz"), rows, meta["token"],
                    meta["ids"])
        with pytest.raises(SystemExit, match="encoder count"):
            tft.main(_argv(data, out, "--epochs", "3", "--resume", *extra))
