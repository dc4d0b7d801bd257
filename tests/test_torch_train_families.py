"""Training the SD-2.x and SDXL families in the port against sdbc_tpu, on
the CPU in fp32 at the tiny configs: the SD-2.1 v-prediction step with
min-SNR, the tiny_xl step over the UNet and both encoders (8-bit AdamW
under remat "block"; fp32 AdamW with EMA, clipping, offset noise and
min-SNR under remat "selective"), the tiny_xl_refiner step, gradient
checkpointing through depth-2 transformers against no remat, the
optimizer's leaves against the JAX trainable tree, and every leaf of the
full-size SDXL UNet and bigG on torch's ``meta`` device against
``jax.eval_shape`` of the JAX init.

The JAX draws are injected as ``tests/test_torch_train.py`` does; the
tolerances are that file's (the loss to ``LOSS_RTOL``, parameters within
``PARAM_ATOL`` but for a ``MAX_NOISY_SHARE`` held to Adam's bound)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import (DictKey, GetAttrKey, SequenceKey,
                           tree_flatten_with_path)

from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.train import adam8bit as tadam8
from sdbc_tpu_torch.train import trainer as ttrainer
from sdbc_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_families import _fields, port_init_tree
from tests.test_torch_remat import counted  # noqa: F401
from tests.test_torch_train import (GRAD_ACCUM, LOSS_RTOL, MAX_NOISY_SHARE,
                                    MICRO, NOISE_ONLY, PARAM_ATOL, STEPS,
                                    _assert_params_match, _batch,
                                    _jax_draws)
from tests.torch_threads import one_thread  # noqa: F401

LR = 1e-3


def jax_keyed(tree) -> dict:
    """{key path of names: leaf} of a JAX tree (dict keys, list indices,
    NamedTuple fields)."""
    def name(q):
        if isinstance(q, DictKey):
            return str(q.key)
        if isinstance(q, SequenceKey):
            return str(q.idx)
        if isinstance(q, GetAttrKey):
            return q.name
        raise TypeError(q)

    return {tuple(name(q) for q in path): leaf
            for path, leaf in tree_flatten_with_path(tree)[0]}


def family(name: str):
    """(JAX config, port config, JAX-layout numpy tree) of a tiny family
    config: ``--tiny --model_family sd21`` (tiny with v-prediction),
    tiny_xl, tiny_xl_refiner."""
    if name == "sd21":
        tc = PipelineConfig.family("sd21", tiny=True)
        jc = JCfg.tiny()
        jc = dataclasses.replace(jc, schedule=dataclasses.replace(
            jc.schedule, prediction_type="v_prediction"))
    else:
        tc = getattr(PipelineConfig, name)()
        jc = getattr(JCfg, name)()
    assert _fields(tc) == _fields(jc)
    return jc, tc, port_init_tree(tc, {"sd21": 3, "tiny_xl": 7,
                                       "tiny_xl_refiner": 17}[name])


def family_batch(cfg, seed: int) -> dict:
    """``tests/test_torch_train.py``'s batch, with SDXL's second ids."""
    b = _batch(cfg, seed)
    if cfg.is_sdxl:
        b["input_ids_2"] = np.random.default_rng(seed + 50).integers(
            0, cfg.clip2.vocab_size, b["input_ids"].shape).astype(np.int32)
    return b


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def port_run(tree, tc, tcfg, steps: int):
    """The port's state after ``steps`` steps with the JAX draws of keys
    100 + i, and its losses."""
    state = ttrainer.init_train_state(as_modules(tree, tc, "cpu"), tcfg,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    step = ttrainer.make_train_step(tc, tcfg, compute_dtype=torch.float32,
                                    device="cpu")
    losses = []
    for i in range(steps):
        state, m = step(state, as_torch(family_batch(tc, i)),
                        draws=_jax_draws(jax.random.key(100 + i), tc))
        assert m["finite"]
        losses.append(m["loss"])
    return state, losses


CASES = {
    # SD-2.x: the v target, min-SNR weighted by min(SNR, γ)/(SNR + 1)
    "sd21 v-prediction": ("sd21", dict(min_snr_gamma=5.0)),
    "tiny_xl 8-bit remat block": ("tiny_xl", dict(
        use_8bit_adam=True, grad_ckpt=True, remat_mode="block")),
    "tiny_xl fp32 options remat selective": ("tiny_xl", dict(
        ema_decay=0.9, max_grad_norm=1.0, noise_offset=0.1,
        min_snr_gamma=5.0, grad_ckpt=True, remat_mode="selective")),
    "tiny_xl_refiner": ("tiny_xl_refiner", dict(use_8bit_adam=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_family_step_matches_jax(case):
    name, options = CASES[case]
    jc, tc, tree = family(name)
    kw = dict(train_unet=True, train_text_encoder=True,
              grad_accum=GRAD_ACCUM, micro_batch=MICRO, learning_rate=LR,
              num_examples=100, dual_text_encoder=tc.is_sdxl,
              refiner=tc.refiner, **options)
    jtc = jtrainer.TrainConfig(**kw)
    jstate = jtrainer.init_train_state(jax.tree.map(jnp.asarray, tree), jtc,
                                       compute_dtype=jnp.float32)
    jstep = jtrainer.make_train_step(jc, jtc, compute_dtype=jnp.float32)
    tcfg = ttrainer.TrainConfig(**kw)
    assert tcfg.trainable_keys() == jtc.trainable_keys()
    _kernels.reset_launch_counts()
    state, losses = port_run(tree, tc, tcfg, STEPS)
    for i, loss in enumerate(losses):
        batch = {k: jnp.asarray(v) for k, v in family_batch(tc, i).items()}
        jstate, jm = jstep(jstate, batch, jax.random.key(100 + i))
        assert bool(jm["finite"])
        np.testing.assert_allclose(loss, float(jm["loss"]), rtol=LOSS_RTOL)
    assert state.step == STEPS and state.opt_state.inner.count == STEPS
    for comp in tcfg.trainable_keys():
        _assert_params_match(jstate.trainable[comp], state.trainable[comp])
        if tcfg.ema_decay:
            _assert_params_match(jstate.ema[comp], state.ema[comp])
    # the optimizer state in the JAX layout: every leaf, its shape, and so
    # each leaf's 8-bit/fp32 choice
    want = {k: np.shape(v) for k, v in jax_keyed(jstate.opt_state).items()}
    got = {tuple(k for k, _ in key): tuple(t.shape)
           for key, t in tckpt.opt_state_tree(state.opt_state,
                                              state.trainable,
                                              tcfg.max_grad_norm)
           if not isinstance(t, str)}
    assert got == want
    if tcfg.use_8bit_adam:
        kinds = {type(s) for s in state.opt_state.inner.per_leaf}
        assert kinds == {tadam8.Quant8State, tadam8.FP32Moments}
    assert set(_kernels.launches.values()) == {0}  # CPU: plain versions
    if tcfg.grad_ckpt:
        # the same step without remat
        plain, plain_losses = port_run(
            tree, tc, dataclasses.replace(tcfg, grad_ckpt=False), STEPS)
        np.testing.assert_allclose(losses, plain_losses, rtol=LOSS_RTOL)
        for comp in tcfg.trainable_keys():
            _assert_modules_match(state.trainable[comp],
                                  plain.trainable[comp])


def _assert_modules_match(module, ref):
    """``_assert_params_match`` between two modules: the summation order
    of the gradients may differ, so Adam's bound holds a few elements."""
    noisy = total = 0
    for (name, p), q in zip(module.named_parameters(), ref.parameters()):
        diff = (p - q).abs().detach()
        assert float(diff.max()) <= 2 * LR * STEPS, name
        if not name.endswith(NOISE_ONLY):
            noisy += int((diff > PARAM_ATOL).sum())
            total += diff.numel()
    assert noisy <= MAX_NOISY_SHARE * total, (noisy, total)


def test_sdxl_needs_second_ids_and_consistent_flags():
    """As in JAX: a batch without ``input_ids_2`` raises; the family flags
    of the TrainConfig must match the PipelineConfig."""
    _, tc, tree = family("tiny_xl")
    tcfg = ttrainer.TrainConfig(train_unet=True, grad_accum=1,
                                dual_text_encoder=True)
    state = ttrainer.init_train_state(as_modules(tree, tc, "cpu"), tcfg,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    step = ttrainer.make_train_step(tc, tcfg, compute_dtype=torch.float32,
                                    device="cpu")
    batch = as_torch(family_batch(tc, 0))
    del batch["input_ids_2"]
    with pytest.raises(ValueError, match="input_ids_2"):
        step(state, {k: v[:1] for k, v in batch.items()},
             generator=torch.Generator().manual_seed(0))
    for kw, cfg, what in [
            (dict(), tc, "dual_text_encoder"),
            (dict(dual_text_encoder=True), PipelineConfig.tiny(),
             "dual_text_encoder"),
            (dict(refiner=True, dual_text_encoder=True), tc, "refiner"),
            (dict(refiner=True), PipelineConfig.tiny_xl_refiner(),
             "implies dual_text_encoder")]:
        with pytest.raises(ValueError, match=what):
            ttrainer.make_train_step(cfg, ttrainer.TrainConfig(**kw),
                                     compute_dtype=torch.float32,
                                     device="cpu")
    # the refiner has no first encoder; TI has nothing to compose into
    rf = ttrainer.TrainConfig(refiner=True, dual_text_encoder=True)
    assert rf.trainable_keys() == ("text_encoder_2",)
    with pytest.raises(ValueError, match="refiner"):
        ttrainer.init_train_state(
            as_modules(family("tiny_xl_refiner")[2],
                       PipelineConfig.tiny_xl_refiner(), "cpu"),
            dataclasses.replace(rf, ti_token="<s>"),
            compute_dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("mode", ["block", "selective"])
def test_remat_through_depth2_matches_no_remat(mode):
    """The tiny_xl UNet's output and every parameter gradient under
    ``remat_mode`` (depth-2 transformers: each block checkpointed whole
    under "selective", the FF nested inside) equal no remat's."""
    from sdbc_tpu_torch.models import unet as tunet

    _, tc, tree = family("tiny_xl")
    unet = as_modules(tree, tc, "cpu")["unet"].requires_grad_(True)
    rng = np.random.default_rng(5)
    lat = torch.from_numpy(rng.standard_normal((2, 16, 16, 4)).astype(
        np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(
        np.float32))
    added = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    t = torch.tensor([3, 700])

    def grads(**kw):
        unet.zero_grad()
        out = tunet.apply(unet, lat, t, ctx, added_cond=added, **kw)
        (out ** 2).mean().backward()
        return out.detach(), {n: p.grad.clone()
                              for n, p in unet.named_parameters()}

    out0, g0 = grads()
    out1, g1 = grads(remat=True, remat_mode=mode)
    torch.testing.assert_close(out1, out0, rtol=0, atol=0)
    assert any("blocks.1." in n for n in g0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-7,
                                   msg=n)


def test_optimizer_leaf_keys_are_the_jax_trainable_tree():
    """tiny_xl's optimizer leaves (UNet + both encoders): one leaf per
    JAX key path, in the JAX flatten order once sorted, each of the JAX
    leaf's shape (a deep transformer's ``blocks.<k>`` and a tower's
    ``layers.<i>`` stacked)."""
    _, tc, tree = family("tiny_xl")
    tcfg = ttrainer.TrainConfig(train_unet=True, dual_text_encoder=True)
    jtc = jtrainer.TrainConfig(train_unet=True, dual_text_encoder=True)
    jtrain, _ = jtrainer._split_params(tree, jtc, compute_dtype=jnp.float32)
    want = {k: np.shape(v) for k, v in jax_keyed(jtrain).items()}
    state = ttrainer.init_train_state(as_modules(tree, tc, "cpu"), tcfg,
                                      compute_dtype=torch.float32,
                                      device="cpu")
    keys = ttrainer.optimizer_leaf_keys(state.trainable)
    leaves = ttrainer.optimizer_leaves(state.trainable)
    names = [tuple(k for k, _ in key) for key in keys]
    assert len(set(names)) == len(names)
    got = {n: (len(ts),) + tuple(ts[0].shape) if len(ts) > 1
           or "layers" in n or "blocks" in n else tuple(ts[0].shape)
           for n, ts in zip(names, leaves)}
    assert got == want
    assert any("blocks" in n for n in names)
    assert sorted(names, key=lambda n: tckpt.sort_key(
        tuple((k, k.isdigit()) for k in n))) == list(jax_keyed(jtrain))


def test_full_size_sdxl_leaves_match_jax_on_meta():
    """The full SDXL base UNet and OpenCLIP-bigG built on the ``meta``
    device (nothing allocated): every optimizer leaf's shape and its
    8-bit/fp32 choice (``MIN_8BIT_SIZE``) equal the JAX package's, from
    ``jax.eval_shape`` of its init; a depth-10 block's GEGLU bias is
    10,240 elements a block, 8-bit only stacked."""
    from sdbc_tpu.models import clip as jclip
    from sdbc_tpu.models import unet as junet
    from sdbc_tpu.train.adam8bit import MIN_8BIT_SIZE as JMIN
    from sdbc_tpu_torch.diffusion.graph import init_models

    assert tadam8.MIN_8BIT_SIZE == JMIN
    cfg = PipelineConfig.sdxl()
    models = init_models(cfg, device="meta", generator=None)
    trainable = {k: models[k] for k in ("unet", "text_encoder_2")}
    jcfg = JCfg.sdxl()
    shapes = {
        "unet": jax.eval_shape(lambda k: junet.init(k, jcfg.unet),
                               jax.random.key(0)),
        "text_encoder_2": jax.eval_shape(lambda k: jclip.init(k, jcfg.clip2),
                                         jax.random.key(0))}
    want = {k: (s.shape, int(np.prod(s.shape)) >= JMIN)
            for k, s in jax_keyed(shapes).items()}
    opt = tadam8.AdamW8bit(1e-5)
    got = {}
    for key, leaf in zip(ttrainer.optimizer_leaf_keys(trainable),
                         ttrainer.optimizer_leaves(trainable)):
        st = opt.leaf_init(leaf)
        shape = tuple(leaf[0].shape) if len(leaf) == 1 and not \
            tckpt.stacked(key) else (len(leaf),) + tuple(leaf[0].shape)
        got[tuple(k for k, _ in key)] = (shape,
                                         isinstance(st, tadam8.Quant8State))
    assert got == want
    bias = ("unet", "down", "2", "attns", "0", "blocks", "geglu", "b")
    assert got[bias] == ((10, 10240), True)


LAUNCH_CASES = [("tiny_xl", None, {}), ("tiny_xl", "block", {}),
                ("tiny_xl", "selective", {}),
                ("tiny_xl_refiner", "block", {}),
                ("sd21 tiny", "selective", {}),
                ("tiny_xl", "block", dict(lora_rank=2)),
                ("tiny_xl", "block", dict(ti_token="<sty>", ti_vectors=2,
                                          train_unet=False,
                                          train_text_encoder=False))]


@pytest.mark.parametrize("name,remat,kw", LAUNCH_CASES,
                         ids=[f"{n} {r} {'lora' if 'lora_rank' in k else 'ti' if k else 'full'}"
                              for n, r, k in LAUNCH_CASES])
def test_chip_smoke_family_train_launch_counts(counted, name, remat, kw):
    """``chip_smoke.expected_train_launches`` of a family step (a depth-2
    transformer's attention recomputed under "selective" too; the VAE
    encode's mid attention) against the dispatch on the CPU, the device
    checks patched to "card"; at full width SDXL 1024² (micro-batch 1,
    grad_accum 2) and SD-2.1 768² (2, 4) under remat "block" give the
    launches the families-train phase holds."""
    from sdbc_tpu_torch.diffusion.pipeline import init_models
    from tests.test_torch_remat import _chip_smoke

    cs = _chip_smoke()
    cfg = cs.family_cfg(name)
    img = 32 if name.startswith("sd21") else 64
    tcfg = cs._family_tcfg(cfg, grad_accum=2, micro_batch=2,
                           num_examples=100, grad_ckpt=remat is not None,
                           remat_mode=remat or "block", **kw)
    batch = {k: torch.from_numpy(v) for k, v in cs._train_batch(
        cfg, 2, 2, img, np.random.default_rng(3)).items()}
    state = ttrainer.init_train_state(
        init_models(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0)),
        tcfg, compute_dtype=torch.float32, device="cpu")
    step = ttrainer.make_train_step(cfg, tcfg, compute_dtype=torch.float32,
                                    device="cpu")
    step(state, batch, generator=torch.Generator().manual_seed(1))
    want = cs.expected_train_launches(cfg, tcfg, img, 0)
    assert {k: counted.get(k, 0) for k in want if k != "adam8"} == \
        {k: v for k, v in want.items() if k != "adam8"}
    assert want["flash_fwd"] > want["flash_bwd_dq"] > 0 or remat is None
    for fam, img, micro, accum, fwd, bwd in (("sdxl", 1024, 1, 2, 280, 140),
                                             ("sd21", 768, 2, 4, 120, 60)):
        full = cs.family_cfg(fam)
        t = cs._family_tcfg(full, grad_accum=accum, micro_batch=micro,
                            grad_ckpt=True, remat_mode="block")
        w = cs.expected_train_launches(full, t, img, 1)
        assert (w["flash_fwd"], w["flash_bwd_dq"], w["flash_bwd_dkv"],
                w["adam8"]) == (fwd, bwd, bwd, 1)
