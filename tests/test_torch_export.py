"""The port's diffusers exporters and safetensors writer against the JAX
package's on the CPU: each ``export_*`` on one tree in the JAX layout (the
port's random init of a tiny config, jittered, as numpy) gives the same
names, shapes and bits; ``export_diffusers_checkpoint`` the same files and
JSON; each package reads the other's directory back to the tree; the port
reads its own directory into a pipeline whose tiny DDIM images equal the
source pipeline's.  Families: SD-1.x, SD-2.x's per-level heads, SDXL
(``add_mlp``, stacked blocks, CLIP with ``text_projection``), the refiner,
the 9-channel inpainting UNet and SD-1.x / SDXL ControlNet."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from sdbc_tpu.models import port as jport
from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                               init_models)
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.models import controlnet as tcn
from sdbc_tpu_torch.models import port as tport
from sdbc_tpu_torch.models.unet import UNetConfig
from tests.torch_threads import one_thread  # noqa: F401


def _sd21_tiny():
    """The tiny config with SD-2.x's per-level head counts and
    v-prediction."""
    cfg = PipelineConfig.family("sd21", tiny=True)
    u = dataclasses.replace(UNetConfig.tiny(), attention_heads=(2, 4),
                            cross_attn_blocks=(True, True))
    return dataclasses.replace(cfg, unet=u)


def _inpaint_tiny():
    cfg = PipelineConfig.tiny()
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet,
                                                             in_channels=9))


FAMILIES = {"sd15": PipelineConfig.tiny, "sd21": _sd21_tiny,
            "sdxl": PipelineConfig.tiny_xl,
            "refiner": PipelineConfig.tiny_xl_refiner,
            "inpaint": _inpaint_tiny}


def jitter(tree, seed: int):
    """``tree`` moved off its zero biases and unit scales (exports of
    zeros would prove little)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + np.float32(0.02) * rng.standard_normal(
        a.shape).astype(np.float32)).astype(np.float32), tree)


_TREES = {}


def trees(family: str) -> dict:
    """The JAX-layout trees of ``family``'s components (and its ControlNet
    branch for sd15 and sdxl), from the port's init through
    ``pipeline_trees``."""
    if family not in _TREES:
        cfg = FAMILIES[family]()
        gen = torch.Generator().manual_seed(len(_TREES))
        models = init_models(cfg, device="cpu", generator=gen)
        if family in ("sd15", "sdxl"):
            models["controlnet"] = tcn.init(cfg.with_controlnet().controlnet,
                                            device="cpu", generator=gen)
            out = tport.pipeline_trees(models)
            out["controlnet"] = tport.module_jax_tree(models["controlnet"])
        else:
            out = tport.pipeline_trees(models)
        _TREES[family] = (cfg, jitter(out, 7 + len(_TREES)))
    return _TREES[family]


def assert_same_dict(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert np.array_equal(x, y), k


def assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and np.array_equal(x, y)


EXPORTS = [("sd15", "unet"), ("sd15", "vae"), ("sd15", "text_encoder"),
           ("sd21", "unet"), ("sdxl", "unet"), ("sdxl", "text_encoder_2"),
           ("refiner", "unet"), ("inpaint", "unet"), ("sd15", "controlnet"),
           ("sdxl", "controlnet")]
EXPORTERS = {"unet": "export_unet", "vae": "export_vae",
             "text_encoder": "export_clip_text",
             "text_encoder_2": "export_clip_text",
             "controlnet": "export_controlnet"}


@pytest.mark.parametrize("family,comp", EXPORTS,
                         ids=[f"{f}-{c}" for f, c in EXPORTS])
def test_exporter_matches_jax(family, comp):
    _, tree = trees(family)
    name = EXPORTERS[comp]
    theirs = getattr(jport, name)(tree[comp])
    ours = getattr(tport, name)(tree[comp])
    assert_same_dict(ours, theirs)
    if comp == "text_encoder_2":
        assert "text_projection.weight" in ours
    if family == "sdxl" and comp == "unet":
        assert "add_embedding.linear_1.weight" in ours
        assert any(".transformer_blocks.1." in k for k in ours)
        assert ours["down_blocks.1.attentions.0.proj_in.weight"].ndim == 2


def _files(root: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            out[os.path.relpath(os.path.join(dirpath, n), root)] = \
                os.path.join(dirpath, n)
    return out


_DIRS = {}


def exported(family: str, tmp_path_factory):
    """(cfg, tree, JAX-written dir, port-written dir) of ``family``."""
    if family not in _DIRS:
        cfg, tree = trees(family)
        pipe_tree = {k: v for k, v in tree.items() if k != "controlnet"}
        root = tmp_path_factory.mktemp(f"export_{family}")
        jdir = jport.export_diffusers_checkpoint(pipe_tree, cfg,
                                                 str(root / "jax"))
        tdir = tport.export_diffusers_checkpoint(pipe_tree, cfg,
                                                 str(root / "port"))
        _DIRS[family] = (cfg, pipe_tree, jdir, tdir)
    return _DIRS[family]


@pytest.mark.parametrize("family", ["sd15", "sd21", "sdxl", "refiner"])
def test_export_dir_matches_jax(family, tmp_path_factory):
    """The same file list, the same JSON after ``json.load``, and the same
    tensors as ``safetensors.numpy`` reads them."""
    from safetensors.numpy import load_file

    _, _, jdir, tdir = exported(family, tmp_path_factory)
    jf, tf = _files(jdir), _files(tdir)
    assert sorted(jf) == sorted(tf)
    for rel in jf:
        if rel.endswith(".json"):
            with open(jf[rel]) as a, open(tf[rel]) as b:
                assert json.load(a) == json.load(b), rel
        else:
            assert_same_dict(load_file(tf[rel]), load_file(jf[rel]))


@pytest.mark.parametrize("family", ["sd15", "sdxl", "refiner"])
def test_each_package_reads_the_others_dir(family, tmp_path_factory):
    """The JAX importer (through ``safetensors.numpy``) reads the port's
    directory back to the tree, the port's importer the JAX one's, and
    both read the configs back to the source's."""
    cfg, tree, jdir, tdir = exported(family, tmp_path_factory)
    assert_same_tree(jax.tree.map(np.asarray,
                                  jport.port_diffusers_checkpoint(tdir)),
                     tree)
    assert_same_tree(tport.port_diffusers_checkpoint(jdir), tree)
    back = tport.pipeline_config_from_diffusers(tdir)
    assert (back.unet, back.vae, back.clip, back.clip2, back.refiner) == \
        (cfg.unet, cfg.vae, cfg.clip, cfg.clip2, cfg.refiner)


@pytest.mark.parametrize("family", ["sd15", "sd21"])
def test_reimported_pipeline_gives_the_same_images(family, tmp_path_factory):
    """``pipeline_trees`` of a pipeline, exported, read back by the port:
    the same weights and the same tiny DDIM images (v-prediction read back
    from the scheduler config for sd21)."""
    cfg, tree, _, _ = exported(family, tmp_path_factory)
    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    src = SDPipeline(tree, cfg, tok, device="cpu",
                     compute_dtype=torch.float32)
    out = str(tmp_path_factory.mktemp(f"reexport_{family}"))
    tport.export_diffusers_checkpoint(tport.pipeline_trees(src), cfg, out)
    back_cfg = tport.pipeline_config_from_diffusers(out)
    assert back_cfg.schedule.prediction_type == cfg.schedule.prediction_type
    back = SDPipeline(tport.port_diffusers_checkpoint(out), back_cfg, tok,
                      device="cpu", compute_dtype=torch.float32)
    for name, m in src.models.items():
        for (k, a), (_, b) in zip(m.state_dict().items(),
                                  back.models[name].state_dict().items()):
            assert torch.equal(a, b), (name, k)
    lat = np.random.default_rng(3).standard_normal((2, 16, 16, 4)) \
        .astype(np.float32)
    kw = dict(height=32, width=32, num_inference_steps=3, latents=lat)
    a = src(["a cover", "a dragon"], **kw)
    b = back(["a cover", "a dragon"], **kw)
    assert np.array_equal(a, b)


def test_pipeline_trees_of_a_jax_tree(tmp_path):
    """A JAX-layout tree loaded into a pipeline comes back from
    ``pipeline_trees`` bit for bit (the stacked CLIP layers and the
    empty lists of blocks without attention kept)."""
    cfg, tree = trees("sdxl")
    pipe_tree = {k: v for k, v in tree.items() if k != "controlnet"}
    pipe = SDPipeline(pipe_tree, cfg, CLIPTokenizer.fallback(
        cfg.clip.vocab_size), device="cpu", compute_dtype=torch.float32)
    assert_same_tree(tport.pipeline_trees(pipe), pipe_tree)


def test_write_safetensors_is_read_by_safetensors(tmp_path):
    """``safetensors.numpy.load_file`` reads what the writer writes, a
    transposed view in its logical order, every dtype of the reader; the
    port's reader reads it back too; a dtype without a safetensors name is
    refused."""
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    base = rng.standard_normal((5, 7)).astype(np.float32)
    sd = {"view": base.T, "f64": rng.standard_normal(3),
          "f16": base[:2].astype(np.float16), "i64": np.arange(4),
          "i32": np.arange(3, dtype=np.int32),
          "i16": np.arange(2, dtype=np.int16),
          "i8": np.arange(-2, 2, dtype=np.int8),
          "u8": np.arange(3, dtype=np.uint8),
          "bool": np.array([True, False, True]),
          "empty": np.zeros((0, 2), np.float32), "scalar": np.float32(2.5)}
    assert not sd["view"].flags.c_contiguous
    path = str(tmp_path / "x.safetensors")
    n = tport.write_safetensors(sd, path)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert (8 + int.from_bytes(f.read(8), "little")) % 8 == 0
    for got in (load_file(path), tport.read_safetensors(path)):
        assert_same_dict(got, {k: np.asarray(v) for k, v in sd.items()})
    with pytest.raises(ValueError, match="complex64"):
        tport.write_safetensors({"c": np.zeros(2, np.complex64)}, path)
