"""SDXL in the port against sdbc_tpu, on the CPU in fp32 at the tiny_xl and
tiny_xl_refiner configs: the dual-encoder conditioning, ``sample`` (DDIM,
DPM, cfg_interval, DeepCache, explicit time ids, the JAX draws injected for
the stochastic euler_a), the refiner's aesthetic conditioning,
``EnsemblePipeline``, img2img, the diffusers import of the JAX exporter's
directories, a port-written checkpoint restored by the JAX
``load_pipeline``, the CLIs, and ``chip_smoke.py``'s launch counts for the
families.

Tolerances (tests/test_goldens.py:35-65): 1e-4 for a model output (the
encoders), 1e-3 for a pipeline image or sampled latents; imported and
restored weights are equal."""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion.pipeline import EnsemblePipeline as JEnsemble
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.diffusion.pipeline import SDPipeline as JSDPipeline
from sdbc_tpu.models import port as jport
from sdbc_tpu.utils import checkpoint as jckpt
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion.ensemble import EnsemblePipeline
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               as_modules)
from sdbc_tpu_torch.diffusion.spec import SampleSpec
from sdbc_tpu_torch.models import port as tport
from sdbc_tpu_torch.utils import checkpoint as tckpt
from tests.test_torch_checkpoint import _assert_same_tree
from tests.test_torch_families import _fields, as_np, port_init_tree, rand
from tests.test_torch_finetune import _argv, data  # noqa: F401
from tests.test_torch_sample_options import counted  # noqa: F401
from tests.test_torch_samplers import jax_draws
from tests.torch_threads import one_thread  # noqa: F401

MODEL_ATOL = 1e-4
IMAGE_ATOL = 1e-3
PROMPTS = ["a gothic novel cover", "a cookbook cover"]
LAT = (2, 16, 16, 4)  # the tiny VAE (scale 2): a 32² image


@pytest.fixture(scope="module")
def xl():
    """(JAX config, port config, JAX-layout numpy tree) of tiny_xl."""
    return (JCfg.tiny_xl(), PipelineConfig.tiny_xl(),
            port_init_tree(PipelineConfig.tiny_xl(), 7))


@pytest.fixture(scope="module")
def rf():
    """(JAX config, port config, tree) of tiny_xl_refiner: bigG, the UNet
    and the VAE only."""
    return (JCfg.tiny_xl_refiner(), PipelineConfig.tiny_xl_refiner(),
            port_init_tree(PipelineConfig.tiny_xl_refiner(), 17))


def _pipes(case, scheduler="ddim"):
    jc, tc, params = case
    jc = dataclasses.replace(jc, scheduler=scheduler)
    tc = dataclasses.replace(tc, scheduler=scheduler)
    jp = JSDPipeline(params, jc, JTokenizer.fallback(jc.clip.vocab_size),
                     compute_dtype=jnp.float32)
    tp = SDPipeline(as_np(params), tc, CLIPTokenizer.fallback(
        tc.clip.vocab_size), device="cpu", compute_dtype=torch.float32)
    return jp, tp


@pytest.fixture(scope="module")
def xl_pipes(xl):
    return _pipes(xl)


@pytest.fixture(scope="module")
def rf_pipes(rf):
    return _pipes(rf)


# ------------------------------------------------------------ conditioning

def test_encode_text_xl_chunked_weighted_matches_jax(xl):
    """Two 16-token windows each encoder, per-encoder token weights: the
    2048-wide (here 64) context and the first window's pooled embed."""
    jc, tc, params = xl
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 998, (2, 2 * jc.clip.ctx))
    ids2 = rng.integers(0, 998, (2, 2 * jc.clip.ctx))
    ids[:, 7] = ids2[:, 9] = ids2[:, 20] = jc.clip.vocab_size - 1
    w, w2 = (rng.uniform(0.7, 1.4, ids.shape).astype(np.float32)
             for _ in range(2))
    enc = jax.jit(functools.partial(jgraph.encode_text_xl, cfg=jc,
                                    compute_dtype=jnp.float32))
    want = enc(params, jnp.asarray(ids), jnp.asarray(ids2),
               weights=jnp.asarray(w), weights2=jnp.asarray(w2))
    models = as_modules(as_np(params), tc, "cpu")
    t = torch.from_numpy
    with torch.no_grad():
        got = tgraph.encode_text_xl(models, t(ids), t(ids2), tc,
                                    torch.float32, weights=t(w),
                                    weights2=t(w2))
    assert got[0].shape == (2, 2 * jc.clip.ctx, 64) and got[1].shape == (2, 16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=MODEL_ATOL)
    with pytest.raises(ValueError, match="contexts differ"):
        tgraph.encode_text_xl(models, t(ids), t(ids2[:, :16]), tc)


# ---------------------------------------------------------------- sample

SAMPLES = [("ddim", {}), ("dpm", dict(cfg_interval=(0.25, 0.75))),
           ("ddim", dict(cache_interval=2)),
           ("dpm", dict(cache_interval=2, cache_tail=1)),
           ("euler_a", dict(time_ids=np.array(
               [[48, 40, 4, 0, 32, 32], [32, 32, 0, 0, 32, 32]],
               np.float32)))]


@pytest.mark.parametrize("run", range(len(SAMPLES)),
                         ids=[f"{s} {' '.join(o)}" for s, o in SAMPLES])
def test_sdxl_sample_matches_jax(xl, run):
    jc, tc, params = xl
    scheduler, opts = SAMPLES[run]
    jc = dataclasses.replace(jc, scheduler=scheduler)
    tc = dataclasses.replace(tc, scheduler=scheduler)
    tok = CLIPTokenizer.fallback(tc.clip.vocab_size)
    ids = [np.asarray(tok.batch_encode(p, tc.clip.ctx), np.int32)
           for p in (PROMPTS, ["blurry", ""])]
    lat, key, n = rand(LAT, 5), jax.random.key(3), 4
    want = jgraph.sample(
        params, jnp.asarray(ids[0]), jnp.asarray(ids[1]), jnp.asarray(lat),
        key, 7.5, cfg=jc, num_inference_steps=n, compute_dtype=jnp.float32,
        cond_ids2=jnp.asarray(ids[0]), uncond_ids2=jnp.asarray(ids[1]),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in opts.items()})
    t = torch.from_numpy
    got = tgraph.sample(
        as_modules(as_np(params), tc, "cpu"), t(ids[0]).long(),
        t(ids[1]).long(), t(lat), 7.5, cfg=tc, num_inference_steps=n,
        compute_dtype=torch.float32, cond_ids2=t(ids[0]),
        uncond_ids2=t(ids[1]), draws=jax_draws(key, LAT, 0, n),
        **{k: t(v) if isinstance(v, np.ndarray) else v
           for k, v in opts.items()})
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=IMAGE_ATOL)


def test_sdxl_sample_needs_second_ids(xl):
    _, tc, params = xl
    ids = torch.zeros((1, tc.clip.ctx), dtype=torch.int64)
    with pytest.raises(ValueError, match="cond_ids2"):
        tgraph.sample(as_modules(as_np(params), tc, "cpu"), ids, ids,
                      torch.zeros(1, 16, 16, 4), 7.5, cfg=tc,
                      num_inference_steps=2, compute_dtype=torch.float32)


@pytest.mark.parametrize("mode", ["weighted img2img", "inpaint"])
def test_sdxl_pipeline_img2img_inpaint_matches_jax(xl_pipes, mode):
    """Both tokenizers under prompt weighting over two windows with the
    negative prompt through both, on img2img; and the latent-blend
    inpainting, through the same call."""
    jp, tp = xl_pipes
    img = np.random.default_rng(6).uniform(0, 1, (32, 32, 3)).astype(
        np.float32)
    kw = dict(height=32, width=32, num_inference_steps=4,
              latents=rand(LAT, 7), init_image=img, strength=0.75)
    prompts = PROMPTS
    if mode == "inpaint":
        mask = np.zeros((32, 32), np.float32)
        mask[8:24, 4:20] = 1.0
        kw["mask_image"] = mask
    else:
        prompts = ["a (dark:1.3) cover, " + ", ".join(
            f"word{i}" for i in range(14)), "b"]
        kw.update(negative_prompt="a [blurry] mess", prompt_weighting=True)
    want = jp(prompts, **kw)
    eps = jax.random.normal(jax.random.split(jax.random.key(42))[0],
                            (2, 16, 16, 4), jnp.float32)
    got = tp(prompts, draws={"enc": np.asarray(eps)}, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=IMAGE_ATOL)


# --------------------------------------------------------------- refiner

def test_refiner_aesthetic_conditioning_matches_jax(rf_pipes):
    jp, tp = rf_pipes
    kw = dict(height=32, width=32, num_inference_steps=3,
              latents=rand(LAT, 9), aesthetic_score=7.5,
              negative_aesthetic_score=1.0)
    want = jp(PROMPTS, **kw)
    got = tp(PROMPTS, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=IMAGE_ATOL)
    assert not np.array_equal(got, tp(PROMPTS, **dict(kw,
                                                      aesthetic_score=6.0)))
    # SampleSpec's aesthetic fields reach the call
    np.testing.assert_array_equal(tp.generate(PROMPTS, SampleSpec(**kw)),
                                  got)
    assert "text_encoder" not in tp.models
    ids = tp.tokenize(["x"])
    with pytest.raises(ValueError, match="aesthetic_score"):
        tgraph.sample(tp.models, ids, ids, torch.zeros(1, 16, 16, 4), 7.5,
                      cfg=tp.cfg, cond_ids2=ids, uncond_ids2=ids,
                      time_ids=torch.zeros(1, 6), num_inference_steps=2,
                      compute_dtype=torch.float32)


def test_ensemble_matches_jax(xl_pipes, rf_pipes):
    """Base to 0.6 of the grid, the refiner from there: the JAX ensemble's
    images, and the port's ensemble equals its explicit two-stage call."""
    kw = dict(height=32, width=32, num_inference_steps=5,
              latents=rand(LAT, 11))
    want = JEnsemble(xl_pipes[0], rf_pipes[0], handoff=0.6)(PROMPTS, **kw)
    ens = EnsemblePipeline(xl_pipes[1], rf_pipes[1], handoff=0.6)
    got = ens(PROMPTS, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=IMAGE_ATOL)
    lat = xl_pipes[1](PROMPTS, decode=False, denoising_end=0.6, **kw)
    two = rf_pipes[1](PROMPTS, latents=lat, denoising_start=0.6,
                      **{k: v for k, v in kw.items() if k != "latents"})
    np.testing.assert_array_equal(got, two)
    spec = SampleSpec(height=32, width=32, num_inference_steps=5,
                      latents=kw["latents"])
    np.testing.assert_array_equal(ens.generate(PROMPTS, spec), got)


ENSEMBLE_REFUSALS = [
    ("refiner slot", lambda x, r: EnsemblePipeline(x, x), "must be a refiner"),
    ("base slot", lambda x, r: EnsemblePipeline(r, r), "base slot"),
    ("handoff", lambda x, r: EnsemblePipeline(x, r, handoff=1.0),
     "handoff"),
    ("scheduler", lambda x, r: EnsemblePipeline(SDPipeline(
        x.models, dataclasses.replace(x.cfg, scheduler="dpm"), x.tokenizer,
        device="cpu"), r), "share the schedule"),
    ("mask", lambda x, r: EnsemblePipeline(x, r)(
        ["a"], height=32, width=32, num_inference_steps=2,
        init_image=np.zeros((32, 32, 3), np.float32),
        mask_image=np.ones((16, 16), np.float32)), "inpaint"),
    ("hires", lambda x, r: EnsemblePipeline(x, r).generate(
        ["a"], SampleSpec(hires_scale=2.0)), "hires"),
    ("bounds", lambda x, r: EnsemblePipeline(x, r).generate(
        ["a"], SampleSpec(denoising_end=0.5)), "refiner_frac"),
]


@pytest.mark.parametrize("case", range(len(ENSEMBLE_REFUSALS)),
                         ids=[c[0] for c in ENSEMBLE_REFUSALS])
def test_ensemble_refusals(xl_pipes, rf_pipes, case):
    _, make, match = ENSEMBLE_REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        make(xl_pipes[1], rf_pipes[1])


def test_ensemble_img2img_drops_stage1_inputs(xl_pipes, rf_pipes):
    """init_latents and strength reach the base stage only (the JAX
    ensemble hands init_latents on to the refiner, which refuses them
    beside denoising_start)."""
    ens = EnsemblePipeline(xl_pipes[1], rf_pipes[1], handoff=0.8)
    out = ens(["a"], height=32, width=32, num_inference_steps=5,
              init_latents=rand((1, 16, 16, 4), 12), strength=0.6,
              latents=rand((1, 16, 16, 4), 13))
    assert out.shape == (1, 32, 32, 3) and np.isfinite(out).all()


# -------------------------------------------------------- import and save

@pytest.mark.parametrize("which", ["xl", "rf"])
def test_diffusers_import_matches_jax(xl, rf, which, tmp_path):
    """The JAX exporter's SDXL (and refiner) directory: the port imports
    the exported tree, the JAX importer's config, and modules equal to
    ``load_jax_params`` of the tree."""
    jc, tc, params = {"xl": xl, "rf": rf}[which]
    root = jport.export_diffusers_checkpoint(params, jc, str(tmp_path))
    got = tport.port_diffusers_checkpoint(root)
    assert sorted(got) == sorted(params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), got, as_np(params))
    cfg = tport.pipeline_config_from_diffusers(root)
    assert _fields(cfg) == _fields(jport.pipeline_config_from_diffusers(root))
    assert cfg == tc
    a, b = as_modules(got, cfg, "cpu"), as_modules(as_np(params), tc, "cpu")
    assert sorted(a) == sorted(b)
    for name in a:
        for (n, x), y in zip(a[name].state_dict().items(),
                             b[name].state_dict().values()):
            assert torch.equal(x, y), (name, n)


@pytest.mark.parametrize("which", ["xl", "rf"])
def test_checkpoint_restored_by_jax(xl, rf, which, tmp_path):
    """A port-written SDXL (refiner) checkpoint: the JAX ``load_pipeline``
    restores the JAX-saved tree (text_encoder_2, the stacked ``blocks``,
    add_mlp) and config; the port reads its own save back."""
    jc, tc, params = {"xl": xl, "rf": rf}[which]
    models = as_modules(as_np(params), tc, "cpu")
    jckpt.save_pipeline(str(tmp_path / "jax"), params, jc)
    tckpt.save_pipeline(str(tmp_path / "port"), models, tc)
    want, wcfg = jckpt.load_pipeline(str(tmp_path / "jax"))
    got, gcfg = jckpt.load_pipeline(str(tmp_path / "port"))
    _assert_same_tree(got, want)
    assert gcfg == wcfg == jc
    back, bcfg = tckpt.load_pipeline(str(tmp_path / "port"))
    assert bcfg == tc and sorted(back) == sorted(models)
    for name, m in models.items():
        for (n, x), y in zip(m.state_dict().items(),
                             back[name].state_dict().values()):
            assert torch.equal(x, y), (name, n)


@pytest.mark.parametrize("name", ["sd21", "sdxl", "sdxl_refiner",
                                  "tiny_xl", "tiny_xl_refiner"])
def test_config_json_matches_jax_families(name):
    want = jckpt.config_to_json(getattr(JCfg, name)())
    got = tckpt.config_to_json(getattr(PipelineConfig, name)())
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert tckpt.config_from_json(json.loads(json.dumps(want))) == \
        getattr(PipelineConfig, name)()


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def exports(xl, rf, tmp_path_factory):
    root = tmp_path_factory.mktemp("xl_exports")
    return {w: jport.export_diffusers_checkpoint(c[2], c[0],
                                                 str(root / w))
            for w, c in (("xl", xl), ("rf", rf))}


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path), np.float32)


def test_cli_inference_refiner_ensemble(exports, xl_pipes, rf_pipes,
                                        tmp_path):
    """``cli.inference --diffusers_ckpt <xl> --refiner_ckpt <refiner>``
    writes the ensemble's image (the fixed-seed noise the pipeline draws);
    hires is refused under the ensemble."""
    from sdbc_tpu_torch.cli import inference as tinf

    base = ["--device", "cpu", "--no-bf16", "--mode", "enter_prompt",
            "--prompt", "a cover", "--img_size", "32",
            "--num_inference_steps", "4", "--save_dir", str(tmp_path),
            "--diffusers_ckpt", exports["xl"], "--refiner_ckpt",
            exports["rf"], "--refiner_frac", "0.5", "--seed", "5"]
    tinf.main(base)
    ens = EnsemblePipeline(xl_pipes[1], rf_pipes[1], handoff=0.5)
    want = ens(["a cover"], height=32, width=32, num_inference_steps=4,
               seed=5)
    got = _png(tmp_path / "dev inference" / "a cover.png")
    assert np.abs(got - np.round(want[0] * 255.0)).max() <= 1
    with pytest.raises(SystemExit, match="hires"):
        tinf.main(base + ["--hires_scale", "2"])
    with pytest.raises(SystemExit, match="not a refiner layout"):
        tinf.main(base[:-6] + ["--refiner_ckpt", exports["xl"]])


def test_cli_inference_model_family_sdxl(tmp_path):
    """``--tiny --model_family sdxl``: the JAX CLI's tiny_xl config, an
    image on the CPU, and FreeU 'auto' picks the SDXL preset."""
    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as tinf
    from sdbc_tpu_torch.models import unet as tunet

    flags = ["--tiny", "--model_family", "sdxl"]
    args = tinf.build_parser().parse_args(flags + ["--device", "cpu",
                                                   "--freeu", "auto"])
    models, cfg = common.resolve_params_cfg(args)
    # the JAX CLI's --tiny --model_family sdxl (cli/common.py:349)
    assert cfg == PipelineConfig.tiny_xl()
    assert _fields(cfg) == _fields(JCfg.tiny_xl())
    assert sorted(models) == ["text_encoder", "text_encoder_2", "unet",
                              "vae"]
    assert tinf._resolve_freeu(args, cfg) == tunet.FREEU_SDXL
    tinf.main(flags + ["--device", "cpu", "--no-bf16", "--mode",
                       "enter_prompt", "--prompt", "a cover",
                       "--num_inference_steps", "2", "--save_dir",
                       str(tmp_path), "--freeu", "auto"])
    assert os.path.exists(tmp_path / "dev inference" / "a cover.png")


# features once refused on SDXL (the ids stay): the adapter file each
# case's flag names
XL_REFUSALS = [
    ("inference", ["--lora_path", "a.npz"], "lora"),
    ("inference", ["--ti_path", "t.npz"], "ti"),
    ("serve", ["--lora_bank", "s=a.npz"], "lora"),
    ("finetune", [], None),
]


def _xl_adapter_file(kind: str, path: str) -> None:
    """A random tiny_xl LoRA adapter over the JAX ``init_lora`` targets of
    the UNet and both encoders, or a dual-encoder inversion of 2 rows."""
    from sdbc_tpu.train import lora as jlora
    from sdbc_tpu_torch.train import lora as tlora
    from sdbc_tpu_torch.train import textual_inversion as tti

    cfg = PipelineConfig.tiny_xl()
    rng = np.random.default_rng(3)
    if kind == "ti":
        v = cfg.clip.vocab_size
        tti.save_ti(path, rng.standard_normal((2, 32)).astype(np.float32),
                    "<sty>", [v, v + 1],
                    rows2=rng.standard_normal((2, 32)).astype(np.float32))
        return
    base = jlora.init_lora(jax.random.key(0), port_init_tree(cfg, 7), 2,
                           components=("unet", "text_encoder",
                                       "text_encoder_2"))
    tlora.save_lora(path, {k: {x: (rng.standard_normal(v[x].shape) * 0.1)
                               .astype(np.float32) for x in "ab"}
                           for k, v in base.items()}, 2, 4.0)


def _np_tree(models) -> dict:
    return {k: tckpt.nest({key: t.detach().numpy() for key, t in
                           tckpt.module_tree(m) if not isinstance(t, str)})
            for k, m in models.items()}


def _leaves(tree) -> dict:
    return {tuple(str(getattr(q, "key", getattr(q, "idx", q)))
                  for q in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("case", range(len(XL_REFUSALS)),
                         ids=[f"{c} {' '.join(f)}" for c, f, _ in
                              XL_REFUSALS])
def test_xl_training_features_refused(case, tmp_path, data):
    """Adapters on an SDXL model and fine-tuning the family, refused until
    the families' training was ported, now run: --lora_path and --ti_path
    merge an SDXL adapter (LoRA on the depth-2 transformers' stacked
    blocks and on text_encoder_2; an inversion's rows2) equal to the JAX
    ``merge_file`` on the same base and the inference CLI writes its
    image; --lora_bank serves the adapter; the finetune CLI trains."""
    from sdbc_tpu.train import lora as jlora
    from sdbc_tpu.train import textual_inversion as jti
    from sdbc_tpu_torch.cli import common, finetune, inference, serve

    cli, flags, kind = XL_REFUSALS[case]
    base = ["--tiny", "--device", "cpu", "--no-bf16", "--model_family",
            "sdxl"]
    if cli == "finetune":
        stats = finetune.main(_argv(data, str(tmp_path / "out"), "--epochs",
                                    "1", "--model_family", "sdxl"))
        assert np.isfinite(stats["losses"]).all()
        assert {"text_encoder", "text_encoder_2"} <= set(
            os.listdir(stats["final"]))
        return
    flag, value = flags
    path = str(tmp_path / value.split("=")[-1])
    _xl_adapter_file(kind, path)
    arg = f"s={path}" if cli == "serve" else path
    if cli == "serve":
        args = serve.build_parser().parse_args(base + [flag, arg])
        pipe, lora_pipes = serve.load_pipelines(args)
        models, merged = pipe.models, lora_pipes["s"].models
        assert lora_pipes["s"].tokenizer2 is not None
    else:
        parser = inference.build_parser()
        models, _ = common.resolve_params_cfg(parser.parse_args(base))
        merged, cfg = common.resolve_params_cfg(
            parser.parse_args(base + [flag, arg]))
    tree = _np_tree(models)
    if kind == "ti":
        want, _ = jti.merge_file(tree, path)
        v = PipelineConfig.tiny_xl().clip.vocab_size
        assert (cfg.clip.vocab_size, cfg.clip2.vocab_size) == (v + 2, v + 2)
    else:
        want = jlora.merge_file(tree, path)
    want, got, before = _leaves(want), _leaves(_np_tree(merged)), \
        _leaves(tree)
    assert set(got) == set(want) == set(before)
    changed = {k for k, v in before.items()
               if v.shape != want[k].shape or not np.array_equal(v, want[k])}
    assert any(k[0] == "text_encoder_2" for k in changed)
    if kind == "lora":
        assert any("blocks" in k for k in changed)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6,
                                   err_msg=str(k))
    if cli == "inference":
        inference.main(base + [flag, arg, "--mode", "enter_prompt",
                               "--prompt", "a cover",
                               "--num_inference_steps", "2", "--save_dir",
                               str(tmp_path)])
        assert os.path.exists(tmp_path / "dev inference" / "a cover.png")


def test_serve_ensemble_lone_request_equals_generate(exports, xl_pipes,
                                                     rf_pipes):
    """``cli.serve --refiner_ckpt``: a lone request equals the ensemble's
    ``generate`` in every pixel; per-request schedulers and hires are
    refused under it."""
    from sdbc_tpu_torch.cli import serve
    from tests.test_torch_serve import _error, _image, _u8

    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--no-bf16", "--img_size", "32",
         "--num_inference_steps", "3", "--diffusers_ckpt", exports["xl"],
         "--refiner_ckpt", exports["rf"], "--port", "0"])
    pipe, lora = serve.load_pipelines(args)
    assert isinstance(pipe, EnsemblePipeline) and not lora
    handler, _ = serve.make_app(pipe, args)
    from http.server import ThreadingHTTPServer
    import threading

    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        got = _image(url, {"prompt": "a cover", "seed": 4})
        ens = EnsemblePipeline(xl_pipes[1], rf_pipes[1], handoff=0.8)
        want = ens.generate(["a cover"], SampleSpec(
            height=32, width=32, num_inference_steps=3, seed=4))
        np.testing.assert_array_equal(got, _u8(want)[0])
        for req, what in (({"scheduler": "heun"}, "scheduler"),
                          ({"hires_scale": 2.0}, "hires")):
            code, err, _ = _error(url, {"prompt": "x", **req})
            assert code == 400 and what in err
    finally:
        srv.shutdown()
        handler.close()
        srv.server_close()


# --------------------------------------------------- chip_smoke's counts

def _chip_smoke():
    from tests.test_torch_remat import _chip_smoke as load

    return load()


FAMILY_RUNS = [
    ("tiny_xl 64²", "xl", (64, 64), {}),
    ("tiny_xl 64x96", "xl", (64, 96), {}),
    ("tiny_xl cfg_interval", "xl", (64, 64), dict(cfg_interval=(0.25, 0.75))),
    ("tiny_xl DeepCache", "xl", (64, 64), dict(cache_interval=2)),
    ("ensemble", "ens", (64, 64), {}),
]


@pytest.mark.parametrize("run", range(len(FAMILY_RUNS)),
                         ids=[r[0] for r in FAMILY_RUNS])
def test_chip_smoke_families_launch_counts(counted, xl_pipes, rf_pipes,
                                           run):
    """``chip_smoke.family_launches`` (per-level depths and heads, (h, w)
    latents) against the counted dispatch on the CPU; SD-1.x's counts are
    unchanged."""
    cs = _chip_smoke()
    _, kind, (h, w), opts = FAMILY_RUNS[run]
    n, lat = 4, (h // 2, w // 2)
    if kind == "xl":
        xl_pipes[1](["a"], height=h, width=w, num_inference_steps=n, **opts)
        want = cs.family_launches(xl_pipes[1].cfg, lat, 1, n, **opts)
    else:
        EnsemblePipeline(xl_pipes[1], rf_pipes[1], handoff=0.5)(
            ["a"], height=h, width=w, num_inference_steps=n)
        want = cs.family_launches(xl_pipes[1].cfg, lat, 1, n,
                                  refiner=rf_pipes[1].cfg, handoff=0.5)
    assert counted.get("flash_fixed", 0) == want["flash_fixed"] > 0
    assert counted.get("geglu_ff", 0) == want["geglu_ff"] > 0
    sd = PipelineConfig.sd15()
    assert cs.expected_launches(sd, 64, 8) == (15, 10)
    assert cs.expected_launches(sd, (64, 64), 4) == (15, 10)
    assert cs.expected_launches(PipelineConfig.sd21(), 96, 2) == (15, 10)
    assert cs.expected_launches(PipelineConfig.sdxl(), 128, 2) == (70, 10)
    assert cs.expected_launches(PipelineConfig.sdxl(), (152, 104), 2) \
        == (70, 0)
