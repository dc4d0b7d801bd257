"""Gradient checkpointing of sdbc_tpu_torch's UNet (``unet.apply(remat=True,
remat_mode=...)``) against sdbc_tpu's, on the CPU at the tiny config in
fp32: the gradient of Σ out² over every UNet parameter, one JAX graph per
mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.models import unet as junet
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
from sdbc_tpu_torch.models import unet as tunet
from sdbc_tpu_torch.models.convert import _flatten_jax_tree, load_jax_params
from sdbc_tpu_torch.train import trainer as ttrainer
from tests.torch_threads import one_thread  # noqa: F401

GRAD_ATOL = 1e-4  # fp32, JAX vs the port: summation order only
SELF_ATOL = 1e-6  # the port with and without checkpointing


@pytest.fixture(scope="module")
def setup(tiny_params):
    cfg = PipelineConfig.tiny()
    np_unet = jax.tree.map(np.asarray, tiny_params["unet"])
    model = load_jax_params(tunet.init(cfg.unet, device="cpu"), np_unet)
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal(
        (2, cfg.clip.ctx, cfg.unet.cross_attention_dim)).astype(np.float32)
    t = np.array([10, 700])
    return cfg, tiny_params["unet"], model, (lat, t, ctx)


def _port_grads(model, inputs, **kw):
    lat, t, ctx = (torch.from_numpy(a) for a in inputs)
    model.zero_grad()
    out = tunet.apply(model, lat, t, ctx, **kw)
    (out ** 2).sum().backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["block", "selective"])
def test_remat_gradients_match_jax(setup, mode):
    cfg, jparams, model, inputs = setup
    lat, t, ctx = (jnp.asarray(a) for a in inputs)

    def loss(p):
        out = junet.apply(p, lat, t, ctx, junet.UNetConfig.tiny(),
                          remat=True, remat_mode=mode)
        return jnp.sum(out ** 2)

    jgrads = _flatten_jax_tree(model, jax.tree.map(
        np.asarray, jax.grad(loss)(jparams)))
    grads = _port_grads(model, inputs, remat=True, remat_mode=mode)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["block", "selective"])
def test_remat_gradients_match_no_remat(setup, mode):
    _, _, model, inputs = setup
    plain = _port_grads(model, inputs)
    ckpt = _port_grads(model, inputs, remat=True, remat_mode=mode)
    for name, g in ckpt.items():
        torch.testing.assert_close(g, plain[name], atol=SELF_ATOL, rtol=0)


def test_remat_options(setup):
    _, _, model, inputs = setup
    lat, t, ctx = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError, match="remat_mode"):
        tunet.apply(model, lat, t, ctx, remat=True, remat_mode="dots")
    cfg = ttrainer.TrainConfig(train_unet=True, grad_ckpt=True,
                               remat_mode="selective")
    assert cfg.grad_ckpt and cfg.remat_mode == "selective"
    with pytest.raises(ValueError, match="remat_mode"):
        ttrainer.TrainConfig(grad_ckpt=True, remat_mode="dots")


# ---------------------------------------------------------------------------
# chip_smoke.py's launch counts, held to the dispatch on the CPU: the device
# checks patched to "card", each kernel entry point wrapped by a counter
# (on a CPU tensor each still computes its plain version)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def counted(monkeypatch):
    from sdbc_tpu_torch.ops import attention as tattn
    from sdbc_tpu_torch.ops import flash_attention as tflash
    from sdbc_tpu_torch.ops import flash_attention_tt as ttt
    from sdbc_tpu_torch.ops import pallas_groupnorm as tpgn

    for var in ("SDBC_GN_FUSED", "SDBC_ATTN_IMPL", "SDBC_ATTN_CROSS",
                "SDBC_FLASH_MAX_ROWS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tattn, "_on_cuda", lambda t: True)
    monkeypatch.setattr(tpgn, "_on_cuda", lambda t: True)
    counts = {}

    def wrap(mod, name, *keys):
        orig = getattr(mod, name)

        def counting(*args, **kw):
            for key in keys:
                counts[key] = counts.get(key, 0) + 1
            return orig(*args, **kw)
        monkeypatch.setattr(mod, name, counting)

    wrap(tflash, "flash_fwd", "flash_fwd")
    wrap(tflash, "flash_attention_fixed", "flash_fixed")
    wrap(tflash, "flash_attention_fixed_bshd", "flash_fixed")
    wrap(ttt, "flash_fwd_tt", "flash_tt")
    wrap(tflash, "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")
    wrap(ttt, "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")
    wrap(tpgn, "fused_group_norm", "gn_fused")
    return counts


@pytest.mark.parametrize("switches", [False, True])
@pytest.mark.parametrize("remat", [None, "block", "selective"])
def test_chip_smoke_train_launch_counts(counted, monkeypatch, remat,
                                        switches):
    from sdbc_tpu_torch.diffusion.pipeline import init_models

    cs = _chip_smoke()
    cfg = PipelineConfig.tiny()
    tcfg = cs._train_cfg(grad_accum=2, micro_batch=2, num_examples=100,
                         grad_ckpt=remat is not None,
                         remat_mode=remat or "block")
    if switches:
        for var, value in cs.SWITCHES.items():
            monkeypatch.setenv(var, value)
    rng = np.random.default_rng(11)
    batch = {"pixel_values": torch.from_numpy(
                 rng.uniform(-1, 1, (2, 2, 32, 32, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(
                 rng.integers(0, cfg.clip.vocab_size, (2, 2, cfg.clip.ctx)))}
    state = ttrainer.init_train_state(
        init_models(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0)),
        tcfg, compute_dtype=torch.float32, device="cpu")
    step = ttrainer.make_train_step(cfg, tcfg, compute_dtype=torch.float32,
                                    device="cpu")
    step(state, batch, generator=torch.Generator().manual_seed(1))
    want = cs.expected_train_launches(cfg, tcfg, 32, 0, switches=switches)
    assert {k: counted.get(k, 0) for k in want if k != "adam8"} == \
        {k: v for k, v in want.items() if k != "adam8"}
    assert want["flash_tt" if switches else "flash_fwd"] > 0
    assert (want["gn_fused"] > 0) == switches


def test_chip_smoke_sampling_launch_counts(counted, monkeypatch):
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline, init_models

    cs = _chip_smoke()
    cfg = PipelineConfig.tiny()
    monkeypatch.setenv("SDBC_GN_FUSED", "1")
    models = init_models(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    pipe = SDPipeline(models, cfg, CLIPTokenizer.fallback(cfg.clip.vocab_size),
                      "cpu", torch.float32)
    pipe(["a book cover", "a cover"], height=32, width=32,
         num_inference_steps=2)
    flash, _ = cs.expected_launches(cfg, 16, 4)
    assert counted["flash_fixed"] == 2 * flash
    assert counted["gn_fused"] == 2 * cs.gn_launches(cfg, 16) \
        + cs.vae_gn_launches(cfg, 16, "decode") > 0
    # at SD-1.5 512² the UNet has eligible GroupNorms, the VAE none
    sd = PipelineConfig.sd15()
    assert cs.gn_launches(sd, 64) > 0
    assert cs.vae_gn_launches(sd, 64, "decode") == 0
    assert cs.vae_gn_launches(sd, 512, "encode") == 0
    assert cs.n_transformers(sd.unet) == 16


def test_chip_smoke_gn_sites_match_sd15():
    """The GroupNorm sites chip_smoke.py records at SD-1.5 512² (meta
    device): the fused GroupNorm's rule admits every UNet tensor but
    64²×640/960 and 32²×1920, and no VAE tensor; under remat (either mode)
    every UNet site but ``norm_out`` is recomputed."""
    from sdbc_tpu_torch.ops.pallas_groupnorm import fits

    cs = _chip_smoke()
    sd = PipelineConfig.sd15()
    plain = cs.unet_gn_sites(sd, 64)
    # 22 ResBlocks × 2, 16 transformers, norm_out
    assert len(plain) == 61 and not any(ck for *_, ck in plain)
    refused = {(shape[1], shape[3]) for shape, g, _, _ in plain
               if not fits(shape, g)}
    assert refused == {(64, 640), (64, 960), (32, 1920)}
    for mode in ("block", "selective"):
        sites = cs.unet_gn_sites(sd, 64, mode)
        assert [s[:3] for s in sites] == [s[:3] for s in plain]
        assert [ck for *_, ck in sites] == [True] * 60 + [False]
    for part, hw in (("decode", 64), ("encode", 512)):
        sites = cs.vae_gn_sites(sd, hw, part)
        assert sites and not any(fits(shape, g) for shape, g, _, _ in sites)


def test_chip_smoke_fp32_launches_move_to_the_cuda_core_kernels():
    """In fp32 each bf16 tensor-core kernel's count of a run goes to its
    fp32 counterpart: the forwards, the backward and the FF to the 3xTF32
    kernels (csrc/flash_fwd_tf32_sm90.cu, csrc/flash_bwd_tf32_sm90.cu,
    csrc/geglu_ff_tf32_sm90.cu); the other kernels keep theirs."""
    from sdbc_tpu_torch.ops import _kernels

    cs = _chip_smoke()
    want = dict.fromkeys(_kernels.launches, 0)
    want.update(flash_fixed=12, geglu_ff=6, flash_fwd=3, flash_bwd_dq=2,
                flash_bwd_dkv=2, adam8=1)
    got = cs.fp32_launches(want)
    assert set(got) == set(_kernels.launches)
    assert {k: v for k, v in got.items() if v} == {
        "flash_fixed_tf32": 12, "geglu_ff_tf32": 6, "flash_fwd_tf32": 3,
        "flash_bwd_dq_tf32": 2, "flash_bwd_dkv_tf32": 2, "adam8": 1}
    assert set(cs.FP32_OF.values()) <= set(_kernels.launches)
    assert set(cs.MAIN_PATH) == set(_kernels.launches)


@pytest.mark.parametrize("config", ["tiny", "sd15"])
def test_chip_smoke_fp32_forwards_all_take_the_tf32_kernel(config):
    """``FP32_OF`` sends every fp32 forward of the tiny and SD-1.5 configs
    to the 3xTF32 kernel: each attention head dim of their UNets and VAEs
    routes there in fp32.  The --no-bf16 DDIM-10 call at 512² and batch 4
    launches it 15 times an evaluation, 150 in all."""
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.ops import flash_attention as tflash

    cs = _chip_smoke()
    cfg = getattr(PipelineConfig, config)()
    u = cfg.unet
    heads = [c // u.attention_heads for c in u.block_out_channels]
    vae_head = cfg.vae.block_out_channels[-1]
    dims = heads + ([vae_head] if config == "tiny" else [])
    for d in dims:
        assert tflash.route(torch.float32, d, fixed=True) \
            == cs.FP32_OF["flash_fixed"]
        assert tflash.route(torch.float32, d, fixed=False) \
            == cs.FP32_OF["flash_fwd"]
    if config == "sd15":
        # the VAE's 512-wide head goes to the wide 3xTF32 kernel (the fp32
        # decode paths of the fp32-sampling phase)
        assert tflash.route(torch.float32, vae_head, fixed=True) \
            == "flash_fixed_tf32"
        want = cs.fp32_launches(cs.generate_launches(
            PipelineConfig.sd15("ddim"), 4, 10, 512, "ddim"))
        assert {k: v for k, v in want.items() if v} == {
            "flash_fixed_tf32": 150, "geglu_ff_tf32": 100}


def test_chip_smoke_fp32_train_step_takes_the_tf32_backward():
    """The train-fp32 phase's counts: every attention head dim of SD-1.5's
    UNet routes its fp32 backward to the 3xTF32 kernels (``FP32_OF``), so
    the mode-C step (micro-batch 2, 4 micro-batches) makes 60 forward, 60
    dq and 60 dk/dv launches on them and one 8-bit AdamW launch, none on
    the CUDA-core backward."""
    from sdbc_tpu_torch.ops import flash_attention as tflash

    cs = _chip_smoke()
    sd = PipelineConfig.sd15()
    u = sd.unet
    for d in {c // u.attention_heads for c in u.block_out_channels}:
        assert tflash.route_bwd(torch.float32, d) == (
            cs.FP32_OF["flash_bwd_dq"], cs.FP32_OF["flash_bwd_dkv"])
    tcfg = cs._train_cfg(grad_accum=4, micro_batch=2, num_examples=1000)
    want = cs.fp32_launches(cs.expected_train_launches(sd, tcfg, 512, 289))
    assert {k: v for k, v in want.items() if v} == {
        "flash_fwd_tf32": 60, "flash_bwd_dq_tf32": 60,
        "flash_bwd_dkv_tf32": 60, "adam8": 1}
    assert cs.MAIN_PATH["flash_bwd_dq_tf32"] == "train fp32"
