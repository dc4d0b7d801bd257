"""The port's weight import and FID stack against sdbc_tpu, on the CPU:
``models/inception.py`` (through the converter and through a JAX-written
``.npz``), ``eval/fid.py`` (Fréchet distance, streaming statistics, the
path API), ``models/port.py`` (the safetensors reader, a diffusers SD-1.x
dir written by the JAX exporter, the pytorch-fid Inception port).

Tolerances: Inception features to 1e-4 of the largest feature; statistics
to 1e-4 of their largest entry; FID numbers to 1e-4 relative; ported
trees and the safetensors reader exactly; images to 1e-3."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from sdbc_tpu.diffusion.pipeline import SDPipeline as JSDPipeline
from sdbc_tpu.eval import fid as jfid
from sdbc_tpu.models import inception as jinc
from sdbc_tpu.models import port as jport
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
from sdbc_tpu_torch.eval import fid as tfid
from sdbc_tpu_torch.models import inception as tinc
from sdbc_tpu_torch.models import port as tport
from tests.test_inception_port import _synthesize_state_dict
from tests.torch_threads import one_thread  # noqa: F401

FEAT_RTOL = 1e-4
STAT_RTOL = 1e-4
FID_RTOL = 1e-4
ATOL = 1e-3
CFG = jinc.InceptionConfig.tiny()
TCFG = tinc.InceptionConfig.tiny()


@pytest.fixture(scope="module")
def jtree():
    return jinc.init(jax.random.key(0), CFG)


@pytest.fixture(scope="module")
def tmodel(jtree):
    return tinc.from_tree(jax.tree.map(np.asarray, jtree), TCFG,
                          device="cpu")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("imgs")
    for i in range(7):
        arr = rng.randint(0, 255, (40, 40, 3)).astype(np.uint8)
        Image.fromarray(arr).save(d / f"{i}.jpg")
    return str(d)


def _close(got, ref, rtol):
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def test_inception_features_match_jax(jtree, tmodel, tmp_path):
    """Through the converter, and through a JAX-written flat .npz; the
    port's own save_npz reads back in JAX."""
    x = np.random.default_rng(0).uniform(0, 255, (3, 64, 64, 3)).astype(
        np.float32)
    ref = np.asarray(jinc.features(jtree, jnp.asarray(x), CFG))
    _close(tinc.features(tmodel, x).numpy(), ref, FEAT_RTOL)
    jinc.save_npz(str(tmp_path / "jax.npz"), jtree)
    from_npz = tinc.from_tree(tinc.load_npz(str(tmp_path / "jax.npz")), TCFG,
                              device="cpu")
    _close(tinc.features(from_npz, x).numpy(), ref, FEAT_RTOL)
    tinc.save_npz(str(tmp_path / "port.npz"), tmodel)
    back = jinc.load_npz(str(tmp_path / "port.npz"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), back, jtree)


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 40, 16))
    mu1, mu2 = a.mean(0), b.mean(0) + 0.3
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    ref = jfid.calculate_frechet_distance(mu1, s1, mu2, s2)
    got = tfid.calculate_frechet_distance(mu1, s1, mu2, s2)
    assert got == pytest.approx(ref, rel=1e-12)
    assert abs(tfid.calculate_frechet_distance(mu1, s1, mu1, s1)) < 1e-8
    # a singular covariance takes the eps-diagonal path in both
    s0 = np.zeros((16, 16))
    assert tfid.calculate_frechet_distance(mu1, s0, mu2, s2) == \
        pytest.approx(jfid.calculate_frechet_distance(mu1, s0, mu2, s2),
                      rel=1e-12)


def test_activations_and_statistics_match_jax(jtree, tmodel, image_dir,
                                              tmp_path):
    """Batched activations with a padded remainder, streaming statistics
    over files, and calculate_fid_given_paths over (dir, dir) and
    (dir, .npz)."""
    x = np.random.default_rng(1).uniform(0, 255, (5, 40, 40, 3)).astype(
        np.float32)
    _close(tfid.get_activations(x, tmodel, batch_size=3),
           jfid.get_activations(x, jtree, CFG, batch_size=3), FEAT_RTOL)
    files = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir))
    jm, js = jfid.activation_statistics_from_files(files, jtree, CFG, 3, 32)
    tm, ts = tfid.activation_statistics_from_files(files, tmodel, 3, 32)
    _close(tm, jm, STAT_RTOL)
    _close(ts, js, STAT_RTOL)
    half = [f for f in files[:4]]
    other = tmp_path / "other"
    other.mkdir()
    for f in half:
        os.symlink(f, other / os.path.basename(f))
    np.savez(tmp_path / "stats.npz", mu=jm, sigma=js)
    for pair in ((image_dir, str(other)),
                 (str(other), str(tmp_path / "stats.npz"))):
        ref = jfid.calculate_fid_given_paths(pair, jtree, CFG, 3, 32)
        got = tfid.calculate_fid_given_paths(pair, tmodel, batch_size=3,
                                             image_size=32)
        assert ref > 0
        assert got == pytest.approx(ref, rel=FID_RTOL)
    with pytest.raises(RuntimeError, match="Invalid path"):
        tfid.calculate_fid_given_paths((image_dir, "/nonexistent"), tmodel)


def test_default_params_resolution(jtree, tmp_path, monkeypatch, capsys):
    """SDBC_INCEPTION_WEIGHTS: a flat-tree .npz and a pytorch-fid .npz load
    the same extractor; unset, seed-2015 random weights with a warning."""
    jinc.save_npz(str(tmp_path / "tree.npz"), jtree)
    monkeypatch.setenv("SDBC_INCEPTION_WEIGHTS", str(tmp_path / "tree.npz"))
    x = np.random.default_rng(2).uniform(0, 255, (2, 75, 75, 3))
    ref = np.asarray(jinc.features(jtree, jnp.asarray(x, jnp.float32), CFG))
    _close(tinc.features(tfid.default_params(TCFG, "cpu"), x).numpy(), ref,
           FEAT_RTOL)
    np.savez(tmp_path / "pt.npz", **_synthesize_state_dict(
        jax.tree.map(np.asarray, jtree)))
    monkeypatch.setenv("SDBC_INCEPTION_WEIGHTS", str(tmp_path / "pt.npz"))
    model = tfid.default_params(TCFG, "cpu")
    assert model.stem["c1"].gamma is not None
    _close(tinc.features(model, x).numpy(), ref, FEAT_RTOL)
    monkeypatch.delenv("SDBC_INCEPTION_WEIGHTS")
    a = tfid.default_params(TCFG, "cpu")
    assert "RANDOM Inception" in capsys.readouterr().err
    b = tfid.default_params(TCFG, "cpu")
    torch.testing.assert_close(a.stem["c1"].weight, b.stem["c1"].weight)


def test_port_fid_inception_matches_jax(jtree, tmp_path):
    """A pytorch-fid-named state dict (gamma 1) through both ports: the
    same trees, from a dict, a .npz and a torch .pth."""
    flat = _synthesize_state_dict(jax.tree.map(np.asarray, jtree))
    ref = jport.port_fid_inception(flat)
    eq = lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                    np.asarray(b))
    jax.tree.map(eq, tport.port_fid_inception(flat), ref)
    torch.save({k: torch.from_numpy(np.copy(v)) for k, v in flat.items()},
               tmp_path / "pt_inception.pth")
    np.savez(tmp_path / "pt_inception.npz", **flat)
    for name in ("pt_inception.pth", "pt_inception.npz"):
        jax.tree.map(eq, tport.load_fid_inception(str(tmp_path / name)), ref)


def test_safetensors_reader_matches_library(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")  # noqa: F841 (bf16 dtype)
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
               "fp16": torch.randn(7, generator=g).half(),
               "fp32": torch.randn(2, 3, 4, generator=g),
               "i64": torch.arange(-3, 6), "scalar": torch.tensor(1.5)}
    save_file(tensors, str(tmp_path / "t.safetensors"),
              metadata={"format": "pt"})
    ref = load_file(str(tmp_path / "t.safetensors"))
    got = tport.read_safetensors(str(tmp_path / "t.safetensors"))
    assert set(got) == set(ref)
    for k, v in ref.items():
        want = v.astype(np.float32) if k == "bf16" else v
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want)


@pytest.fixture(scope="module")
def export_dir(tiny_cfg, tiny_params, tmp_path_factory):
    return jport.export_diffusers_checkpoint(
        tiny_params, tiny_cfg, str(tmp_path_factory.mktemp("sd_tiny")))


def test_port_diffusers_checkpoint_matches_jax(export_dir):
    """A tiny SD-1.x dir written by the JAX exporter: the same trees and
    config as the JAX port's, and the same images."""
    jparams = jport.port_diffusers_checkpoint(export_dir)
    jcfg = jport.pipeline_config_from_diffusers(export_dir, "ddim")
    tparams = tport.port_diffusers_checkpoint(export_dir)
    tcfg = tport.pipeline_config_from_diffusers(export_dir, "ddim")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), tparams, jparams)
    for part in ("unet", "vae", "clip"):
        t, j = getattr(tcfg, part), getattr(jcfg, part)
        for name in type(t).__dataclass_fields__:
            assert getattr(t, name) == getattr(j, name), (part, name)
    assert tcfg.schedule.prediction_type == jcfg.schedule.prediction_type
    lat = np.random.default_rng(4).standard_normal((2, 16, 16, 4)).astype(
        np.float32)
    kw = dict(height=32, width=32, num_inference_steps=3, latents=lat)
    prompts = ["a ported cover", "another"]
    ref = JSDPipeline(jparams, jcfg, JTokenizer.fallback(
        jcfg.clip.vocab_size), compute_dtype=jnp.float32)(prompts, **kw)
    got = SDPipeline(tparams, tcfg, CLIPTokenizer.fallback(
        tcfg.clip.vocab_size), device="cpu",
        compute_dtype=torch.float32)(prompts, **kw)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_port_refuses_unported_layouts(export_dir, tmp_path):
    """The layouts no family of either package has are refused; SD-2.x's
    per-block heads and SDXL's text-time embedding are read (their parity
    is in tests/test_torch_sdxl.py)."""
    assert tport.unet_config_from_diffusers(
        {"attention_head_dim": [5, 10]}).attention_heads == (5, 10)
    with pytest.raises(ValueError, match="addition_embed_type"):
        tport.unet_config_from_diffusers({"addition_embed_type": "text"})
    with pytest.raises(ValueError, match="projection_class_embeddings"):
        tport.unet_config_from_diffusers({"addition_embed_type":
                                          "text_time"})
    assert tport.clip_config_from_diffusers(
        {"architectures": ["CLIPTextModelWithProjection"],
         "projection_dim": 1280}).projection_dim == 1280
    # a second encoder beside a UNet without the text-time embedding is
    # no SDXL layout
    for comp, cfg in (("unet", {}), ("text_encoder_2", {})):
        os.makedirs(tmp_path / comp)
        with open(tmp_path / comp / "config.json", "w") as f:
            json.dump(cfg, f)
    with pytest.raises(ValueError, match="not an SDXL layout"):
        tport.pipeline_config_from_diffusers(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tport.port_diffusers_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tport.load_state_dict(str(tmp_path / "text_encoder_2"))
