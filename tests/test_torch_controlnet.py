"""ControlNet in the port against sdbc_tpu on the CPU in fp32, at the tiny
and tiny_xl configs: the conditioning embedder, the hoisted time
projections, the branch's forward, the UNet with its residuals, ``sample``
with one and two branches, a ControlNet train step's loss and gradients,
the diffusers import, checkpoints across the packages and the CLIs.

Every tree is the port's random init moved off its zero convs (``jittered``,
``tests/test_torch_families.py``'s): with zero output convs the residuals
are exactly 0 and parity would prove nothing; one test holds a fresh
``from_unet`` branch to the base instead.  Tolerances
(tests/test_goldens.py:35-65): 1e-4 a model output, 1e-3 a pipeline
image."""
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.models import controlnet as jcn
from sdbc_tpu.models import port as jport
from sdbc_tpu.models import unet as junet
from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu.utils import checkpoint as jckpt
from sdbc_tpu_torch.cli import finetune as tft
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               as_modules, init_models)
from sdbc_tpu_torch.models import controlnet as tcn
from sdbc_tpu_torch.models import port as tport
from sdbc_tpu_torch.models import unet as tunet
from sdbc_tpu_torch.models.convert import _flatten_jax_tree, load_jax_params
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_finetune import (_argv, _assert_bits, _disk,
                                       _state_trees, capture, data)
from tests.torch_threads import one_thread  # noqa: F401

MODEL_ATOL = 1e-4
IMAGE_ATOL = 1e-3


def jittered(tree, seed: int, scale: float = 0.02):
    """A tree (numpy) moved off its zero convs, zero biases and unit
    scales."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + np.float32(scale) * rng.
                        standard_normal(np.shape(a)).astype(np.float32), tree)


def tree_of(module) -> dict:
    """The JAX-layout tree (nested dicts and lists of numpy) of a port
    module."""
    return tport.module_jax_tree(module)


def rand(shape, seed: int, scale: float = 1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


class Family:
    """One config's JAX and port configs (with the branch) and jittered
    trees: the base components and two ControlNet branches."""

    def __init__(self, name: str):
        self.tcfg = getattr(PipelineConfig, name)().with_controlnet()
        self.jcfg = getattr(JCfg, name)().with_controlnet()
        models = init_models(self.tcfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        self.base = jittered({k: tree_of(m) for k, m in models.items()}, 1)
        self.cns = [jittered(tree_of(tcn.init(
            self.tcfg.controlnet, device="cpu",
            generator=torch.Generator().manual_seed(10 + i))), 20 + i)
            for i in range(2)]
        self.models = as_modules(self.base, self.tcfg, "cpu")
        self.branches = [load_jax_params(tcn.init(self.tcfg.controlnet,
                                                  device="cpu"), t)
                         for t in self.cns]

    def added_cond(self, n: int, seed: int = 5):
        u = self.tcfg.unet
        return None if not u.addition_embed_dim else rand(
            (n, u.addition_embed_dim), seed)


@pytest.fixture(scope="module")
def fams():
    return {name: Family(name) for name in ("tiny", "tiny_xl")}


@pytest.fixture(scope="module")
def tiny(fams):
    return fams["tiny"]


FAMILIES = ["tiny", "tiny_xl"]


def _inputs(fam, n: int = 2):
    u = fam.tcfg.unet
    lat = rand((n, 8, 8, u.in_channels), 1)
    ctx = rand((n, fam.tcfg.clip.ctx, u.cross_attention_dim), 2)
    img = np.random.default_rng(3).random((n, 8 * fam.tcfg.vae_scale,
                                           8 * fam.tcfg.vae_scale, 3),
                                          dtype=np.float32)
    return lat, ctx, img


# ------------------------------------------------------------------ config

def test_controlnet_configs_match_jax():
    for name in ("tiny", "tiny_xl", "sd15", "sd21", "sdxl"):
        got = getattr(PipelineConfig, name)().with_controlnet().controlnet
        want = getattr(JCfg, name)().with_controlnet().controlnet
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert tcn.ControlNetConfig.sd15() == tcn.ControlNetConfig()
    assert dataclasses.asdict(tcn.ControlNetConfig.tiny()) == \
        dataclasses.asdict(jcn.ControlNetConfig.tiny())
    for scale in (2, 4, 8, 16, 32):
        assert tcn.conditioning_ramp(scale) == dataclasses.replace(
            JCfg.tiny(), vae=dataclasses.replace(
                JCfg.tiny().vae, block_out_channels=(8,) * (
                    int(np.log2(scale)) + 1))).with_controlnet() \
            .controlnet.conditioning_channels
    u = PipelineConfig.sd15().unet
    assert tcn.num_skips(u) == jcn.num_skips(u) == 12
    assert tcn._skip_channels(u) == jcn._skip_channels(u)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", FAMILIES)
def test_embed_cond_matches_jax(fams, name):
    fam = fams[name]
    _, _, img = _inputs(fam)
    want = jcn.embed_cond(fam.cns[0], jnp.asarray(img), fam.jcfg.controlnet)
    got = tcn.embed_cond(fam.branches[0], torch.from_numpy(img))
    assert tuple(got.shape) == (2, 8, 8, fam.tcfg.unet.block_out_channels[0])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_precompute_temb_matches_unhoisted_and_jax(fams, name):
    """The hoisted tables against JAX's, and the branch's forward on them
    against its inline time embedding (SDXL: with ``added_cond``)."""
    fam = fams[name]
    lat, ctx, img = _inputs(fam)
    ts = np.array([999.0, 500.0, 37.5], np.float32)
    added = fam.added_cond(2)
    want = jcn.precompute_temb(fam.cns[0], jnp.asarray(ts),
                               fam.jcfg.controlnet, dtype=jnp.float32,
                               added_cond=None if added is None
                               else jnp.asarray(added))
    cn = fam.branches[0]
    ta = None if added is None else torch.from_numpy(added)
    got = tcn.precompute_temb(cn, torch.from_numpy(ts), torch.float32,
                              added_cond=ta)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.detach().numpy(), np.asarray(w), atol=MODEL_ATOL), got, want)
    emb = tcn.embed_cond(cn, torch.from_numpy(img))
    lt, ct = torch.from_numpy(lat), torch.from_numpy(ctx)
    hoisted = tcn.apply(cn, lt, None, ct, emb,
                        temb_proj=tunet.index_temb(got, 1))
    inline = tcn.apply(cn, lt, torch.full((2,), 500.0), ct, emb,
                       added_cond=ta)
    jax.tree.map(lambda a, b: torch.testing.assert_close(
        a, b, rtol=1e-5, atol=1e-5), hoisted, inline)


@pytest.mark.parametrize("name", FAMILIES)
def test_apply_matches_jax(fams, name):
    """The branch's residuals (conditioning scale 0.7) and the UNet with
    them, against JAX."""
    fam = fams[name]
    lat, ctx, img = _inputs(fam)
    t = np.array([10, 700])
    added = fam.added_cond(2)
    jadd = None if added is None else jnp.asarray(added)
    jemb = jcn.embed_cond(fam.cns[0], jnp.asarray(img), fam.jcfg.controlnet)
    jres = jax.jit(lambda p, lt, ct, e, a: jcn.apply(
        p, lt, jnp.asarray(t, jnp.int32), ct, e, fam.jcfg.controlnet,
        conditioning_scale=0.7, added_cond=a))(
        fam.cns[0], jnp.asarray(lat), jnp.asarray(ctx), jemb, jadd)
    cn = fam.branches[0]
    tadd = None if added is None else torch.from_numpy(added)
    lt, ct = torch.from_numpy(lat), torch.from_numpy(ctx)
    res = tcn.apply(cn, lt, torch.from_numpy(t), ct,
                    tcn.embed_cond(cn, torch.from_numpy(img)),
                    conditioning_scale=0.7, added_cond=tadd)
    assert len(res[0]) == tcn.num_skips(fam.tcfg.unet)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g.detach().numpy(), np.asarray(w), atol=MODEL_ATOL), res, jres)
    assert max(float(r.detach().abs().max()) for r in res[0]) > 1e-3
    # the UNet with those residuals (each on its saved skip)
    want = jax.jit(lambda p, lt, ct, r, a: junet.apply(
        p, lt, jnp.asarray(t, jnp.int32), ct, fam.jcfg.unet,
        control_residuals=r, added_cond=a))(
        fam.base["unet"], jnp.asarray(lat), jnp.asarray(ctx), jres, jadd)
    got = tunet.apply(fam.models["unet"], lt, torch.from_numpy(t), ct,
                      control_residuals=res, added_cond=tadd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=MODEL_ATOL)
    plain = tunet.apply(fam.models["unet"], lt, torch.from_numpy(t), ct,
                        added_cond=tadd)
    assert float((got - plain).detach().abs().max()) > 1e-3


@pytest.mark.parametrize("name", FAMILIES)
def test_jax_from_unet_tree_round_trips(fams, name):
    """A JAX ``from_unet`` tree (SDXL: with ``add_mlp`` and the depth-2
    transformer's stacked ``blocks``) carried into the port and back
    (``module_tree``), leaf for leaf; two of them as a list through
    ``as_modules``."""
    fam = fams[name]
    jtree = jax.tree.map(np.asarray, jcn.from_unet(
        fam.base["unet"], jax.random.key(7), fam.jcfg.controlnet))
    module = load_jax_params(tcn.init(fam.tcfg.controlnet, device="cpu"),
                             jtree)
    back = tree_of(module)
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    jax.tree.map(np.testing.assert_array_equal, back, jtree)
    for k in ("conv_in", "time_mlp", "down", "mid"):
        jax.tree.map(np.testing.assert_array_equal, back[k],
                     fam.base["unet"][k])
    two = as_modules({**fam.base, "controlnet": [jtree, fam.cns[0]]},
                     fam.tcfg, "cpu")["controlnet"]
    assert len(two) == 2
    jax.tree.map(np.testing.assert_array_equal, tree_of(two[1]),
                 fam.cns[0])


def test_fresh_branch_reproduces_the_base(tiny):
    """``from_unet``: the base's encoder half, zero output convs, so the
    residuals are exactly 0 and the UNet's output and a sampled image are
    the base's, bit for bit."""
    unet = tiny.models["unet"]
    cn = tcn.from_unet(unet, torch.Generator().manual_seed(3),
                       tiny.tcfg.controlnet)
    for name in ("conv_in", "time_mlp", "down", "mid"):
        for p, q in zip(getattr(cn, name).parameters(),
                        getattr(unet, name).parameters()):
            assert torch.equal(p, q) and p is not q
    lat, ctx, img = _inputs(tiny)
    lt, ct = torch.from_numpy(lat), torch.from_numpy(ctx)
    t = torch.tensor([3, 600])
    res = tcn.apply(cn, lt, t, ct, tcn.embed_cond(cn, torch.from_numpy(img)))
    assert all(float(r.detach().abs().max()) == 0.0
               for r in (*res[0], res[1]))
    torch.testing.assert_close(
        tunet.apply(unet, lt, t, ct, control_residuals=res),
        tunet.apply(unet, lt, t, ct), rtol=0, atol=0)
    ids = torch.zeros((2, tiny.tcfg.clip.ctx), dtype=torch.int64)
    kw = dict(cfg=tiny.tcfg, num_inference_steps=2,
              compute_dtype=torch.float32)
    models = {**tiny.models, "controlnet": cn}
    lat0 = torch.from_numpy(rand((2, 16, 16, 4), 4))
    base = tgraph.sample(models, ids, ids, lat0, 7.5, **kw)
    ctrl = tgraph.sample(models, ids, ids, lat0, 7.5,
                         control_image=torch.from_numpy(
                             np.random.default_rng(0).random(
                                 (2, 32, 32, 3), dtype=np.float32)), **kw)
    torch.testing.assert_close(ctrl, base, rtol=0, atol=0)


def test_residual_order_on_every_deepcache_boundary(tiny):
    """The residuals follow the skips' append order whatever the DeepCache
    boundary (``cache_tail``) splits the head from the trunk."""
    lat, ctx, _ = _inputs(tiny)
    lt, ct = torch.from_numpy(lat), torch.from_numpy(ctx)
    t = torch.tensor([5, 400])
    res = tcn.apply(tiny.branches[0], lt, t, ct,
                    torch.zeros(2, 8, 8, 32))
    want = tunet.apply(tiny.models["unet"], lt, t, ct, control_residuals=res)
    for tail in (1, 2):
        got = tunet.apply(tiny.models["unet"], lt, t, ct, cache_tail=tail,
                          control_residuals=res)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="DeepCache"):
        tunet.apply(tiny.models["unet"], lt, t, ct, return_deep=True,
                    control_residuals=res)


def test_edge_and_training_hints_match_jax():
    px = rand((2, 16, 16, 3), 6, 0.5)
    for kind in ("edges", "image"):
        np.testing.assert_allclose(
            tcn.training_hint(torch.from_numpy(px), kind).numpy(),
            np.asarray(jcn.training_hint(jnp.asarray(px), kind)),
            atol=1e-6)
    with pytest.raises(ValueError, match="unknown control hint"):
        tcn.training_hint(torch.from_numpy(px), "depth")


# ----------------------------------------------------------------- sample

PROMPTS = ["a gothic novel cover", "a cookbook cover"]


def _ids(cfg):
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    return (np.asarray(tok.batch_encode(PROMPTS, cfg.clip.ctx), np.int32),
            np.asarray(tok.batch_encode(["blurry", ""], cfg.clip.ctx),
                       np.int32))


def _controls(n: int):
    rng = np.random.default_rng(8)
    return [rng.random((2, 32, 32, 3), dtype=np.float32) for _ in range(n)]


# one branch on DDIM with a scale; two on DPM-Solver++ over the Karras σ
# grid (the branch's time projections on continuous timesteps) with one
# scale per branch
SAMPLE_CASES = {"one-ddim": ("ddim", False, 1, 0.8),
                "two-dpm-karras": ("dpm", True, 2, [0.6, 1.3])}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_matches_jax(tiny, case):
    scheduler, karras, n, scale = SAMPLE_CASES[case]
    cond, uncond = _ids(tiny.tcfg)
    lat = rand((2, 16, 16, 4), 9)
    imgs = _controls(n)
    one = n == 1
    jparams = {**tiny.base, "controlnet": tiny.cns[0] if one
               else tiny.cns[:n]}
    jcfg = dataclasses.replace(tiny.jcfg, scheduler=scheduler)
    ref = jgraph.sample(
        jparams, jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(lat),
        jax.random.key(3), 7.5, cfg=jcfg, num_inference_steps=3,
        compute_dtype=jnp.float32, use_karras_sigmas=karras,
        control_image=jnp.asarray(imgs[0]) if one
        else [jnp.asarray(i) for i in imgs], controlnet_scale=scale)
    models = {**tiny.models, "controlnet": tiny.branches[0] if one
              else tiny.branches[:n]}
    _kernels.reset_launch_counts()
    out = tgraph.sample(
        models, torch.from_numpy(cond).long(),
        torch.from_numpy(uncond).long(), torch.from_numpy(lat), 7.5,
        cfg=dataclasses.replace(tiny.tcfg, scheduler=scheduler),
        num_inference_steps=3, compute_dtype=torch.float32,
        use_karras_sigmas=karras,
        control_image=torch.from_numpy(imgs[0]) if one
        else [torch.from_numpy(i) for i in imgs], controlnet_scale=scale)
    assert set(_kernels.launches.values()) == {0}  # CPU: plain versions
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=IMAGE_ATOL)
    plain = tgraph.sample(
        tiny.models, torch.from_numpy(cond).long(),
        torch.from_numpy(uncond).long(), torch.from_numpy(lat), 7.5,
        cfg=dataclasses.replace(tiny.tcfg, scheduler=scheduler),
        num_inference_steps=3, compute_dtype=torch.float32,
        use_karras_sigmas=karras)
    assert float((out - plain).abs().max()) > 1e-3  # the control acts


def test_pipeline_control_image_and_zero_scale(tiny):
    """``SDPipeline``: one control image tiles over the batch (equal to
    passing it per image), and a zero scale gives the base's image."""
    pipe = SDPipeline({**tiny.models, "controlnet": tiny.branches[0]},
                      tiny.tcfg, _tokenizer(tiny.tcfg), device="cpu",
                      compute_dtype=torch.float32)
    kw = dict(height=32, width=32, num_inference_steps=2,
              latents=rand((2, 16, 16, 4), 11))
    img = _controls(1)[0][0]
    one = pipe(PROMPTS, control_image=img, **kw)
    np.testing.assert_array_equal(
        pipe(PROMPTS, control_image=np.stack([img, img]), **kw), one)
    base = pipe(PROMPTS, **kw)
    assert np.abs(one - base).max() > 1e-3
    np.testing.assert_allclose(
        pipe(PROMPTS, control_image=img, controlnet_scale=0.0, **kw), base,
        atol=1e-6)


def _tokenizer(cfg):
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    return CLIPTokenizer.fallback(cfg.clip.vocab_size)


# ------------------------------------------------------------------ train

def test_train_loss_and_branch_gradients_match_jax(tiny):
    """One micro-batch of a ControlNet step (the Sobel hint, the base
    frozen): the loss and every gradient of the branch against JAX's, with
    the JAX draws injected; gradient checkpointing changes no bit of
    them."""
    from sdbc_tpu.diffusion import schedulers as jsched
    from sdbc_tpu_torch.diffusion import schedulers as tsched
    from sdbc_tpu_torch.train import trainer as ttrainer

    rng = np.random.default_rng(12)
    batch = {"pixel_values": (rng.standard_normal((2, 32, 32, 3))
                              * 0.5).astype(np.float32),
             "input_ids": rng.integers(0, tiny.tcfg.clip.vocab_size,
                                       (2, tiny.tcfg.clip.ctx)).astype(
                                           np.int32)}
    key = jax.random.key(21)
    kw = dict(train_controlnet=True, train_text_encoder=False)
    jt = jtrainer.TrainConfig(**kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda tr: jtrainer.diffusion_loss(
            tr, {k: v for k, v in tiny.base.items()}, jb, key, tiny.jcfg,
            jt, jsched.make_schedule(tiny.jcfg.schedule),
            compute_dtype=jnp.float32)))({"controlnet": tiny.cns[0]})
    kvae, knoise, kt = jax.random.split(key, 3)
    t = lambda a: torch.from_numpy(np.array(a))
    draws = {"eps": t(jax.random.normal(kvae, (2, 16, 16, 4), jnp.float32)),
             "noise": t(jax.random.normal(knoise, (2, 16, 16, 4),
                                          jnp.float32)),
             "t": t(jax.random.randint(kt, (2,), 0, 1000))}
    tb = {"pixel_values": torch.from_numpy(batch["pixel_values"]),
          "input_ids": torch.from_numpy(batch["input_ids"]).long()}
    sched = tsched.make_schedule(tiny.tcfg.schedule)
    want = _flatten_jax_tree(None, jax.tree.map(
        np.asarray, jgrads["controlnet"]))
    grads = {}
    for ckpt in (False, True):
        cn = load_jax_params(tcn.init(tiny.tcfg.controlnet, device="cpu"),
                             tiny.cns[0])
        models = {**tiny.models, "controlnet": cn}
        loss = ttrainer.diffusion_loss(
            models, tb, tiny.tcfg,
            ttrainer.TrainConfig(grad_ckpt=ckpt, **kw), sched,
            torch.float32, draws=draws)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        grads[ckpt] = {n: p.grad.numpy() for n, p in cn.named_parameters()}
        assert all(p.grad is None for p in tiny.models["unet"].parameters())
    assert set(grads[False]) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(grads[False][name], w,
                                   atol=MODEL_ATOL * scale, err_msg=name)
        np.testing.assert_array_equal(grads[True][name], grads[False][name])
    assert np.abs(grads[False]["zero_mid.weight"]).max() > 0


def test_training_guards_match_jax(tiny):
    """The refusals of ``init_train_state`` and the loss, with JAX's
    exception types."""
    from sdbc_tpu_torch.train import trainer as ttrainer

    def both(models_t, params_j, **kw):
        errs = []
        for fn, models in ((
                lambda m: jtrainer.init_train_state(
                    m, jtrainer.TrainConfig(**kw), compute_dtype=jnp.float32),
                params_j),
                (lambda m: ttrainer.init_train_state(
                    dict(m), ttrainer.TrainConfig(**kw),
                    compute_dtype=torch.float32, device="cpu"), models_t)):
            with pytest.raises(Exception) as e:
                fn(models)
            errs.append(e.type)
        assert errs[0] is errs[1], errs
        return errs[1]

    cn = {"controlnet": tiny.branches[0]}
    jcn_ = {"controlnet": tiny.cns[0]}
    assert both({**tiny.models, **cn}, {**tiny.base, **jcn_},
                train_controlnet=True, train_unet=True,
                train_text_encoder=False) is ValueError
    assert both({**tiny.models, **cn}, {**tiny.base, **jcn_},
                train_controlnet=True, train_text_encoder=False,
                lora_rank=2) is ValueError
    assert both(tiny.models, tiny.base, train_controlnet=True,
                train_text_encoder=False) is ValueError
    assert both({**tiny.models, "controlnet": tiny.branches},
                {**tiny.base, "controlnet": tiny.cns},
                train_controlnet=True, train_text_encoder=False) is ValueError
    assert ttrainer.TrainConfig(train_controlnet=True).trainable_keys() == \
        ("controlnet",)


# ----------------------------------------------------------------- import

def _diffusers_dir(root, tree, cfg):
    """A diffusers ControlNetModel dir of ``tree`` (the JAX package's
    ``export_controlnet``) under ``root/controlnet``."""
    import json

    from safetensors.numpy import save_file

    u = cfg.unet
    d = os.path.join(root, "controlnet")
    os.makedirs(d)
    save_file(jport.export_controlnet(tree),
              os.path.join(d, "diffusion_pytorch_model.safetensors"))
    conf = {"in_channels": u.in_channels,
            "block_out_channels": list(u.block_out_channels),
            "layers_per_block": u.layers_per_block,
            "cross_attention_dim": u.cross_attention_dim,
            "attention_head_dim": u.attention_heads,
            "norm_num_groups": u.norm_groups,
            "down_block_types": ["CrossAttnDownBlock2D" if c
                                 else "DownBlock2D"
                                 for c in u.cross_attn_blocks],
            "conditioning_embedding_out_channels":
                list(cfg.conditioning_channels)}
    if u.addition_embed_dim:
        conf.update(addition_embed_type="text_time",
                    projection_class_embeddings_input_dim=(
                        u.addition_embed_dim),
                    addition_time_embed_dim=u.addition_time_embed_dim,
                    transformer_layers_per_block=list(u.depth_per_level))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(conf, f)
    return d


@pytest.mark.parametrize("name", FAMILIES)
def test_load_controlnet_matches_jax(fams, name, tmp_path):
    """A dir the JAX package's ``export_controlnet`` writes: the port's
    ``load_controlnet`` gives JAX's ``load_controlnet`` tree and config
    (found through the pipeline dir's ``controlnet/``), leaf for leaf."""
    fam = fams[name]
    _diffusers_dir(str(tmp_path), fam.cns[0], fam.jcfg.controlnet)
    tree, cfg = tport.load_controlnet(str(tmp_path))
    jtree, jcfg = jport.load_controlnet(str(tmp_path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    flat = _flatten_jax_tree(None, tree)
    jflat = _flatten_jax_tree(None, jax.tree.map(np.asarray, jtree))
    assert set(flat) == set(jflat)
    for k, v in jflat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    module = load_jax_params(tcn.init(cfg, device="cpu"), tree)
    assert set(flat) == {n for n, _ in module.named_parameters()}
    assert tcn.ControlNetConfig(unet=dataclasses.replace(
        cfg.unet, out_channels=4), conditioning_channels=(
            cfg.conditioning_channels)) == fam.tcfg.controlnet
    with pytest.raises(ValueError, match="channel order"):
        tport.controlnet_config_from_diffusers(
            {"controlnet_conditioning_channel_order": "bgr"})


# -------------------------------------------------------------- refusals

def _refusal_cases(tiny):
    one = _controls(1)[0]
    return {
        "cfg_interval": dict(control_image=one, cfg_interval=(0.0, 0.5)),
        "cache_interval": dict(control_image=one, cache_interval=2),
        "no branch": dict(control_image=one, branches=None),
        "image count": dict(control_image=[one, one]),
        "scale count": dict(control_image=one, controlnet_scale=[1.0, 2.0]),
    }


@pytest.mark.parametrize("case", ["cfg_interval", "cache_interval",
                                  "no branch", "image count",
                                  "scale count"])
def test_sample_refusals_match_jax(tiny, case):
    kw = _refusal_cases(tiny)[case]
    branch = kw.pop("branches", 0)
    cond, uncond = _ids(tiny.tcfg)
    lat = rand((2, 16, 16, 4), 9)
    jp = dict(tiny.base)
    tm = dict(tiny.models)
    if branch is not None:
        jp["controlnet"], tm["controlnet"] = tiny.cns[0], tiny.branches[0]
    with pytest.raises(Exception) as want:
        jgraph.sample(jp, jnp.asarray(cond), jnp.asarray(uncond),
                      jnp.asarray(lat), jax.random.key(0), 7.5,
                      cfg=tiny.jcfg, num_inference_steps=2,
                      compute_dtype=jnp.float32, **{
                          k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                              else [jnp.asarray(x) for x in v]
                              if isinstance(v, list) and k == "control_image"
                              else v) for k, v in kw.items()})
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
               else [torch.from_numpy(x) for x in v]
               if isinstance(v, list) and k == "control_image" else v)
           for k, v in kw.items()}
    # the same type, and the message's first words
    with pytest.raises(want.type, match=re.escape(
            " ".join(str(want.value).split()[:2]))):
        tgraph.sample(tm, torch.from_numpy(cond).long(),
                      torch.from_numpy(uncond).long(),
                      torch.from_numpy(lat), 7.5, cfg=tiny.tcfg,
                      num_inference_steps=2, compute_dtype=torch.float32,
                      **tkw)


# ------------------------------------------------------------ checkpoints

def test_config_with_controlnet_loads_from_the_jax_layout():
    for name in ("tiny", "sd15", "sdxl"):
        jcfg = getattr(JCfg, name)().with_controlnet()
        cfg = tckpt.config_from_json(jckpt.config_to_json(jcfg))
        assert dataclasses.asdict(cfg.controlnet) == \
            dataclasses.asdict(jcfg.controlnet)
        back = jckpt.config_from_json(tckpt.config_to_json(cfg))
        assert dataclasses.asdict(back.controlnet) == \
            dataclasses.asdict(jcfg.controlnet)


def test_checkpoint_with_branches_round_trips(tiny, tmp_path):
    """One branch and a list of branches (multi-ControlNet) saved and
    loaded in the port, and restored by the JAX package, leaf for leaf."""
    for value in (tiny.branches[0], tiny.branches):
        path = str(tmp_path / f"ck{isinstance(value, list)}")
        tckpt.save_pipeline(path, {**tiny.models, "controlnet": value},
                            tiny.tcfg)
        models, cfg = tckpt.load_pipeline(path)
        assert cfg.controlnet == tiny.tcfg.controlnet
        got = tcn.branches(models["controlnet"])
        assert isinstance(models["controlnet"], list) == \
            isinstance(value, list)
        for a, b in zip(got, tcn.branches(value)):
            for (n, p), (m, q) in zip(a.named_parameters(),
                                      b.named_parameters()):
                assert n == m and torch.equal(p, q), n
    params, jcfg = jckpt.load_pipeline(str(tmp_path / "ckFalse"))
    flat = _flatten_jax_tree(None, jax.tree.map(np.asarray,
                                                params["controlnet"]))
    for n, p in tiny.branches[0].named_parameters():
        np.testing.assert_array_equal(flat[n], p.detach().numpy(), n)
    assert dataclasses.asdict(jcfg.controlnet) == \
        dataclasses.asdict(tiny.jcfg.controlnet)


def test_cli_train_controlnet_saves_for_jax_and_resumes_exactly(
        tmp_path, data, capture):
    """``cli.finetune --train_controlnet``: a fresh branch from the base
    UNet trains one epoch (the text encoder frozen with its message), its
    checkpoint carries the branch, which the JAX package's
    ``load_pipeline`` restores leaf for leaf; --resume continues from its
    masters, moments and step bit for bit."""
    out = str(tmp_path / "out")
    argv = _argv(data, out, "--train_controlnet", "--use_8bit_adam",
                 "--epochs", "1")
    stats = tft.main(argv)
    assert np.isfinite(stats["losses"]).all() and len(stats["losses"]) == 2
    final = stats["final"]
    assert "controlnet" in os.listdir(final)
    last = capture["last"]
    assert set(last.trainable) == {"controlnet"}
    saved = {k: {n: t.clone() for n, t in v.items()}
             for k, v in _state_trees(last).items()}
    for name, tree in saved.items():
        _assert_bits(_disk(final, name), tree)
    params, jcfg = jckpt.load_pipeline(final)
    assert jcfg.controlnet is not None
    flat = _flatten_jax_tree(None, jax.tree.map(np.asarray,
                                                params["controlnet"]))
    for n, p in last.trainable["controlnet"].named_parameters():
        np.testing.assert_array_equal(flat[n], p.detach().numpy(), n)
    assert np.abs(flat["zero_mid.weight"]).max() > 0  # trained
    capture.clear()
    stats2 = tft.main(argv[:-1] + ["2", "--resume"])
    assert capture["first_step"] == 2 and len(stats2["losses"]) == 2
    for name, tree in saved.items():
        _assert_bits(capture["first_trees"][name], tree)


@pytest.mark.parametrize("flags,what", [
    (["--lora_rank", "2"], "full-branch mode"),
    (["--cache_latents"], "incompatible with --cache_latents"),
    (["--train_unet"], "drop --train_unet")])
def test_cli_train_controlnet_refusals(flags, what):
    with pytest.raises(SystemExit, match=what):
        tft.main(["--tiny", "--device", "cpu", "--train_controlnet"] + flags)


# -------------------------------------------------------------------- CLI

def test_cli_inference_with_two_controlnets(fams, tmp_path):
    """``cli.inference --controlnet_path a,b --control_image x,y
    --controlnet_scale s,t``: the PNG is the pipeline's image of the
    resolved models with both branches; a branch of another layout and a
    control image without a branch exit with their message."""
    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as tinf
    from sdbc_tpu_torch.utils import png

    tiny, xl = fams["tiny"], fams["tiny_xl"]
    dirs = []
    for i in range(2):
        root = str(tmp_path / f"cn{i}")
        _diffusers_dir(root, tiny.cns[i], tiny.jcfg.controlnet)
        dirs.append(root)
    imgs = []
    for i, img in enumerate(_controls(2)):
        path = str(tmp_path / f"c{i}.png")
        u8 = np.uint8(np.round(img[0] * 255.0))
        with open(path, "wb") as f:
            f.write(png.encode(u8))
        imgs.append((path, u8.astype(np.float32) / 255.0))
    base = ["--tiny", "--device", "cpu", "--no-bf16", "--mode",
            "enter_prompt", "--prompt", "a cover", "--num_inference_steps",
            "2", "--save_dir", str(tmp_path / "gen")]
    flags = ["--controlnet_path", ",".join(dirs), "--control_image",
             ",".join(p for p, _ in imgs), "--controlnet_scale", "0.5,1.5"]
    tinf.main(base + flags)
    from PIL import Image

    got = np.asarray(Image.open(tmp_path / "gen" / "dev inference" /
                                "a cover.png"), np.float32)
    args = tinf.build_parser().parse_args(base + flags)
    common.resolve_img_size(args)
    models, cfg = common.resolve_params_cfg(args)
    assert len(models["controlnet"]) == 2
    pipe = SDPipeline(models, cfg, _tokenizer(cfg), device="cpu",
                      compute_dtype=torch.float32)
    want = pipe(["a cover"], height=32, width=32, num_inference_steps=2,
                seed=args.seed, control_image=[a for _, a in imgs],
                controlnet_scale=[0.5, 1.5])[0]
    assert np.abs(got - np.round(want * 255.0)).max() <= 1
    other = str(tmp_path / "xl")
    _diffusers_dir(other, xl.cns[0], xl.jcfg.controlnet)
    with pytest.raises(SystemExit, match="does not match"):
        tinf.main(base + ["--controlnet_path", other])
    with pytest.raises(SystemExit, match="needs a ControlNet"):
        tinf.main(base + ["--control_image", imgs[0][0]])
