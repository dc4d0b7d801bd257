"""The port's checkpoints (``sdbc_tpu_torch/utils/checkpoint.py``) against
the JAX package's ``sdbc_tpu/utils/checkpoint.py`` on the CPU, at the tiny
config: what the port saves, the JAX ``load_pipeline`` and
``load_opt_state`` restore to exactly the tree the JAX package's own save
gives (dtypes included, every leaf bit for bit); the port reads its own
trees back bit for bit (JAX-written ones: test_torch_jax_checkpoint.py)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey, SequenceKey, tree_flatten_with_path

from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.models import unet as junet
from sdbc_tpu.train import lora as jlora
from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu.utils import checkpoint as jckpt
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
from sdbc_tpu_torch.models.convert import load_adam8_state
from sdbc_tpu_torch.train import adam8bit as tadam8
from sdbc_tpu_torch.train import lora as tlora
from sdbc_tpu_torch.train import trainer as ttrainer
from sdbc_tpu_torch.utils import checkpoint as tckpt
from tests.torch_threads import one_thread  # noqa: F401


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{path string: numpy leaf} with the path's key kinds."""
    out = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        key = tuple((q.key, "d") if isinstance(q, DictKey) else
                    (q.idx, "s") if isinstance(q, SequenceKey) else
                    (q.name, "a") for q in path)
        out[key] = np.asarray(leaf)
    return out


def _assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb), sorted(set(fa) ^ set(fb))[:5]
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, (k, fa[k].dtype, fb[k].dtype)
        assert fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k].view(np.uint8), fb[k].view(np.uint8)), k


@pytest.fixture(scope="module")
def np_params(tiny_params):
    return _np(tiny_params)


def _modules(np_params):
    return as_modules(np_params, PipelineConfig.tiny(), "cpu")


def _adapter(np_params, seed=0):
    """A LoRA adapter over the JAX tree's targets with random a and b."""
    rng = np.random.default_rng(seed)
    base = jlora.init_lora(jax.random.key(seed), np_params, 2,
                           components=("unet", "text_encoder"))
    return {k: {x: (rng.standard_normal(v[x].shape) * 0.1).astype(np.float32)
                for x in "ab"} for k, v in base.items()}


@pytest.mark.parametrize("kind", ["full bf16", "ema", "lora", "ti"])
def test_port_save_restored_by_jax_load_pipeline(tmp_path, tiny_params,
                                                 np_params, kind):
    """The JAX ``load_pipeline`` (EMA overlay, LoRA merge, TI merge as
    each kind has them) gives the same tree from the port's save as from
    the JAX package's own save of the same weights."""
    jcfg = JCfg.tiny()
    tcfg_port = PipelineConfig.tiny()
    jargs, targs = {}, {}
    if kind == "full bf16":
        # a full fine-tune under bf16: the frozen components are saved as
        # their compute-dtype copies, the trained one as its fp32 master
        kw = dict(train_unet=True, train_text_encoder=False)
        jstate = jtrainer.init_train_state(
            tiny_params, jtrainer.TrainConfig(**kw),
            compute_dtype=jnp.bfloat16)
        jparams = jtrainer.merged_params(jstate)
        state = ttrainer.init_train_state(
            _modules(np_params), ttrainer.TrainConfig(**kw),
            compute_dtype=torch.bfloat16, device="cpu")
        models = ttrainer.merged_params(state)
    else:
        jparams, models = tiny_params, _modules(np_params)
    if kind == "ema":
        shadow = junet.init(jax.random.key(7), jcfg.unet)
        jargs["ema"] = {"unet": shadow}
        targs["ema"] = {"unet": as_modules(
            {**np_params, "unet": _np(shadow)}, tcfg_port, "cpu")["unet"]}
    elif kind == "lora":
        ad = _adapter(np_params)
        jargs.update(lora=ad, lora_rank=2, lora_alpha=4.0)
        targs.update(lora={k: {x: torch.from_numpy(v[x]) for x in "ab"}
                           for k, v in ad.items()},
                     lora_rank=2, lora_alpha=4.0)
    elif kind == "ti":
        rows = np.random.default_rng(1).standard_normal(
            (2, jcfg.clip.hidden)).astype(np.float32)
        ids = [jcfg.clip.vocab_size, jcfg.clip.vocab_size + 1]
        jargs["ti"] = (rows, "<sty>", ids)
        targs["ti"] = (torch.from_numpy(rows), "<sty>", ids)
    meta = {"step": 3, "best_mean_loss": 0.25}
    jckpt.save_pipeline(str(tmp_path / "jax"), jparams, jcfg,
                        metadata=meta, **jargs)
    tckpt.save_pipeline(str(tmp_path / "port"), models, tcfg_port,
                        metadata=meta, **targs)
    want, wcfg = jckpt.load_pipeline(str(tmp_path / "jax"))
    got, gcfg = jckpt.load_pipeline(str(tmp_path / "port"))
    _assert_same_tree(got, want)
    assert gcfg == wcfg
    if kind == "full bf16":
        assert {v.dtype for v in _flat(got["vae"]).values()} \
            == {jnp.dtype(jnp.bfloat16)}
        assert {v.dtype for v in _flat(got["unet"]).values()} \
            == {jnp.dtype(jnp.float32)}
    assert jckpt.load_metadata(str(tmp_path / "port")) == meta
    for name in ("lora.npz", "ti.npz", "added_tokens.json"):
        assert os.path.exists(tmp_path / "port" / name) \
            == os.path.exists(tmp_path / "jax" / name)
    # the port reads its own save back: the same merged weights
    tmodels, tcfg2 = tckpt.load_pipeline(str(tmp_path / "port"))
    assert tcfg2 == dataclasses.replace(
        tcfg_port, clip=dataclasses.replace(
            tcfg_port.clip, vocab_size=wcfg.clip.vocab_size,
            eot_id=wcfg.clip.eot_id))
    for comp, module in tmodels.items():
        back = {k: t.float().numpy() for k, t in tckpt.module_tree(module)
                if not isinstance(t, str)}
        ref = {tuple((k, isinstance(k, int)) for k, _ in key): v
               for key, v in _flat(want[comp]).items()}
        ref = {tuple((str(k), s) for k, s in key): v for key, v in
               ref.items()}
        assert set(back) == set(ref), comp
        for k, v in ref.items():
            assert np.array_equal(np.asarray(v, np.float32), back[k]), (comp, k)


def _fill(state, seed=0):
    """Random values in every moment of a port optimizer state."""
    g = torch.Generator().manual_seed(seed)
    inner = state.opt_state.inner
    if isinstance(inner, tadam8.Adam8State):
        for st in inner.per_leaf:
            if isinstance(st, tadam8.Quant8State):
                for q in (st.mq, st.vq):
                    q.copy_(torch.randint(-127, 128, q.shape, generator=g))
                for s in (st.ms, st.vs):
                    s.copy_(torch.rand(s.shape, generator=g))
            else:
                st.m.copy_(torch.randn(st.m.shape, generator=g))
                st.v.copy_(torch.rand(st.v.shape, generator=g))
    else:
        for t in inner.mu + inner.nu:
            t.copy_(torch.randn(t.shape, generator=g))
    inner.count = 5
    state.opt_state.notfinite_count = 1
    state.opt_state.total_notfinite = 2
    state.opt_state.last_finite = False


@pytest.mark.parametrize("mode", ["8bit clip", "fp32", "lora fp32"])
def test_opt_state_restored_by_jax_load_opt_state(tmp_path, tiny_params,
                                                  np_params, mode):
    """The JAX ``load_opt_state(path, opt.init(trainable))`` restores the
    port's optimizer state: the counters, and every moment of every leaf
    at its JAX tree position (8-bit leaves through ``load_adam8_state``);
    the port's own ``load_opt_state`` gives the state back bit for bit."""
    kw = dict(train_unet=True, train_text_encoder=True,
              use_8bit_adam=mode.startswith("8bit"),
              max_grad_norm=1.0 if "clip" in mode else 0.0)
    if mode.startswith("lora"):
        kw["lora_rank"] = 2
    jtc = jtrainer.TrainConfig(**kw)
    jstate = jtrainer.init_train_state(tiny_params, jtc,
                                       compute_dtype=jnp.float32)
    state = ttrainer.init_train_state(
        _modules(np_params), ttrainer.TrainConfig(**kw),
        compute_dtype=torch.float32, device="cpu")
    _fill(state)
    path = str(tmp_path / "ck")
    tckpt.save_pipeline(path, ttrainer.merged_params(
        state, ttrainer.TrainConfig(**kw)), PipelineConfig.tiny(),
        opt_state=tckpt.opt_state_tree(state.opt_state, state.trainable,
                                       kw["max_grad_norm"]))
    opt = jtrainer.make_optimizer(jtc)
    restored = jckpt.load_opt_state(path, opt.init(jstate.trainable))
    assert int(restored.notfinite_count) == 1
    assert int(restored.total_notfinite) == 2
    assert not bool(restored.last_finite)
    keys = ttrainer.optimizer_leaf_keys(state.trainable)
    order = sorted(range(len(keys)), key=lambda i: tckpt.sort_key(keys[i]))
    inner = state.opt_state.inner
    if kw["use_8bit_adam"]:
        back = load_adam8_state(_np(restored.inner_state[1]))
        assert back.count == 5
        for j, i in enumerate(order):
            a, b = back.per_leaf[j], inner.per_leaf[i]
            assert type(a) is type(b)
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name))
    else:
        adam = restored.inner_state[0][0]
        assert int(adam.count) == 5
        assert int(restored.inner_state[0][2].count) == 5
        for name, moments in (("mu", adam.mu), ("nu", adam.nu)):
            flat = {tuple(str(k) for k, _ in key): v
                    for key, v in _flat(moments).items()}
            ours = getattr(inner, name)
            at = 0
            for i, leaf in enumerate(ttrainer.optimizer_leaves(
                    state.trainable)):
                parts = ours[at:at + len(leaf)]
                at += len(leaf)
                ref = flat[tuple(k for k, _ in keys[i])]
                got = torch.stack(parts) if "layers" in [
                    k for k, _ in keys[i]] else parts[0]
                assert np.array_equal(got.numpy(), ref), keys[i]
    fresh = ttrainer.init_train_state(
        _modules(np_params), ttrainer.TrainConfig(**kw),
        compute_dtype=torch.float32, device="cpu")
    if mode.startswith("lora"):
        fresh.trainable = state.trainable
    back = tckpt.load_opt_state(path, fresh.opt_state, fresh.trainable,
                                kw["max_grad_norm"])
    assert (back.notfinite_count, back.total_notfinite, back.last_finite) \
        == (1, 2, False)
    for a, b in zip(_moments(back), _moments(state.opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _moments(opt_state):
    inner = opt_state.inner
    if isinstance(inner, tadam8.Adam8State):
        return [getattr(st, f.name) for st in inner.per_leaf
                for f in dataclasses.fields(st)]
    return inner.mu + inner.nu


@pytest.mark.parametrize("name", ["tiny", "sd15"])
def test_config_json_matches_jax(name):
    want = jckpt.config_to_json(getattr(JCfg, name)())
    got = tckpt.config_to_json(getattr(PipelineConfig, name)())
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert tckpt.config_from_json(want) == getattr(PipelineConfig, name)()


def test_latest_checkpoint_skips_incomplete(tmp_path, np_params):
    out = str(tmp_path)
    cfg = PipelineConfig.tiny()
    models = {"vae": _modules(np_params)["vae"]}
    tckpt.save_pipeline(tckpt.new_checkpoint_path(out, "r", 4), models, cfg)
    torn = tckpt.new_checkpoint_path(out, "r", 9)
    tckpt.save_pipeline(torn, models, cfg)
    os.remove(os.path.join(torn, "config.json"))
    assert tckpt.latest_checkpoint(out, "r") == \
        tckpt.new_checkpoint_path(out, "r", 4)
    assert jckpt.latest_checkpoint(out, "r") == \
        tckpt.latest_checkpoint(out, "r")
    assert tckpt.latest_checkpoint(out, "other") is None


def test_lora_training_merge_matches_serving_merge(np_params):
    """The training merge (``lora.merged_weights``, swapped in by
    ``trainer.merged``) gives the serving merge's weights bit for bit and
    puts the frozen parameters back after the block."""
    models = _modules(np_params)
    ad = {k: {x: torch.from_numpy(v[x]) for x in "ab"}
          for k, v in _adapter(np_params, seed=3).items()}
    served = tlora.apply_lora(models, ad, 2.0)
    tcfg = ttrainer.TrainConfig(lora_rank=2, lora_alpha=4.0)
    before = {k: dict(m.named_parameters()) for k, m in models.items()}
    with ttrainer.merged({"lora": ad}, models, tcfg) as merged:
        for comp in ("unet", "text_encoder"):
            live = {n: p for n, p in merged[comp].named_parameters()}
            for n, p in served[comp].named_parameters():
                assert torch.equal(live[n], p), (comp, n)
    for k, m in models.items():
        for n, p in m.named_parameters():
            assert p is before[k][n]
