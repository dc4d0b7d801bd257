"""The port's image-scoring stack against the JAX package on the CPU: the
CLIP vision tower and ``apply_with_pooled`` (``models/clip.py``), the
safety checkers (``models/safety.py``), their weight import
(``models/port.py``), CLIPScore (``eval/clip_score.py``, ``cli/clip_score.py``)
and ``SDPipeline``'s safety slot.

Tolerances (tiny configs, fp32 on both sides, the same seed-made numpy
inputs): the towers' outputs within 1e-4 of their largest entry; the CLIP
preprocessing (JAX's antialiased bicubic, per-channel normalization) within
1e-5 of its largest entry; the checker's scores within 1e-4 and its flags
and blacked-out images equal; the CLIPScore cosines and scores within 1e-5;
the porters' trees exactly."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.cli import clip_score as jcli
from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTokenizer
from sdbc_tpu.diffusion.pipeline import SDPipeline as JSDPipeline
from sdbc_tpu.eval import clip_score as jscore
from sdbc_tpu.models import clip as jclip
from sdbc_tpu.models import port as jport
from sdbc_tpu.models import safety as jsafety
from sdbc_tpu.ops import nn as jnn
from sdbc_tpu_torch.cli import clip_score as tcli
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
from sdbc_tpu_torch.eval import clip_score as tscore
from sdbc_tpu_torch.models import clip as tclip
from sdbc_tpu_torch.models import port as tport
from sdbc_tpu_torch.models import safety as tsafety
from sdbc_tpu_torch.models.convert import load_jax_params
from tests.data_fixtures import build_fake_dataset
from tests.torch_threads import one_thread  # noqa: F401

TOWER_TOL = 1e-4
PREP_TOL = 1e-5
SCORE_TOL = 1e-4
COS_TOL = 1e-5
VCFG = tclip.CLIPVisionConfig.tiny()
JVCFG = jclip.CLIPVisionConfig.tiny()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def _same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(
        np.asarray(x), np.asarray(y)), a, b)


@pytest.fixture(scope="module")
def vision_tree():
    return _np(jclip.vision_init(jax.random.key(0), JVCFG))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    return rng.random((3, 32, 32, 3)).astype(np.float32)


def test_vision_apply_matches_jax(vision_tree):
    pix = np.random.default_rng(1).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    jh, jp = jclip.vision_apply(vision_tree, jnp.asarray(pix), JVCFG)
    model = load_jax_params(tclip.vision_init(VCFG, device="cpu"),
                            vision_tree)
    with torch.no_grad():
        th, tp = tclip.vision_apply(model, torch.from_numpy(pix))
    _close(th.numpy(), jh, TOWER_TOL)
    _close(tp.numpy(), jp, TOWER_TOL)


def test_vision_tower_refuses_a_wrong_shape(vision_tree):
    model = load_jax_params(tclip.vision_init(VCFG, device="cpu"),
                            vision_tree)
    for shape in ((2, 3, 32, 32), (2, 16, 16, 3), (2, 32, 32, 4)):
        with pytest.raises(ValueError, match="vision tower expects"):
            tclip.vision_apply(model, torch.zeros(shape))


@pytest.mark.parametrize("skip", [0, 1])
def test_apply_with_pooled_projection_and_eot_match_jax(skip):
    """A projected text tower whose <|endoftext|> id is not the vocab's
    last: the pooled row of each input is its first eot."""
    jcfg = dataclasses.replace(jclip.CLIPTextConfig.tiny(),
                               projection_dim=16, eot_id=7)
    tcfg = dataclasses.replace(tclip.CLIPTextConfig.tiny(),
                               projection_dim=16, eot_id=7)
    tree = _np(jclip.init(jax.random.key(3), jcfg))
    tree["final_ln"]["bias"] = np.random.default_rng(2).standard_normal(
        32).astype(np.float32)
    ids = np.random.default_rng(4).integers(10, 900, (3, 16))
    ids[0, 5] = ids[0, 9] = 7
    ids[1, 12] = 7
    jh, jp = jclip.apply_with_pooled(tree, jnp.asarray(ids, jnp.int32), jcfg,
                                     skip_layers=skip)
    model = load_jax_params(tclip.init(tcfg, device="cpu"), tree)
    with torch.no_grad():
        th, tp = tclip.apply_with_pooled(model, torch.from_numpy(ids),
                                         skip_layers=skip)
    assert tp.shape == (3, 16)
    _close(th.numpy(), jh, TOWER_TOL)
    _close(tp.numpy(), jp, TOWER_TOL)


@pytest.mark.parametrize("size", [512, 32])
def test_clip_preprocess_matches_jax(size):
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(
        np.float32)
    ref = jsafety.clip_preprocess(x, 224)
    got = tsafety.clip_preprocess(x, 224).numpy()
    _close(got, ref, PREP_TOL)


def _safety_tree(vision_tree, images):
    """A tiny checker tree whose first concept is image 0's own projected
    embedding (so image 0 is flagged) and whose first special-care concept
    is image 1's (so image 1's concept scores move up by 0.01)."""
    rng = np.random.default_rng(9)
    proj = _np(jnn.init_linear(jax.random.key(4), 32, 16, use_bias=False))
    pix = jsafety.clip_preprocess(images, 32)
    _, pooled = jclip.vision_apply(vision_tree, jnp.asarray(pix), JVCFG)
    emb = np.asarray(jnn.linear(proj, pooled))
    concepts = rng.standard_normal((4, 16)).astype(np.float32)
    concepts[0] = emb[0]
    special = rng.standard_normal((2, 16)).astype(np.float32)
    special[0] = emb[1]
    return {"vision": vision_tree, "visual_projection": proj,
            "concept_embeds": concepts,
            "concept_weights": np.full(4, 0.9, np.float32),
            "special_care_embeds": special,
            "special_care_weights": np.full(2, 0.9, np.float32)}


def test_clip_safety_checker_matches_jax(vision_tree, images):
    tree = _safety_tree(vision_tree, images)
    jc = jsafety.ClipSafetyChecker(tree, JVCFG)
    tc = tsafety.ClipSafetyChecker(tree, VCFG, device="cpu")
    jconcept, jspecial = jc.scores(images)
    tconcept, tspecial = tc.scores(images)
    assert np.abs(tconcept - jconcept).max() <= SCORE_TOL
    assert np.abs(tspecial - jspecial).max() <= SCORE_TOL
    jimgs, jflags = jc(images)
    timgs, tflags = tc(images)
    assert tflags == jflags == [True, False, False]
    np.testing.assert_array_equal(timgs, jimgs)
    np.testing.assert_array_equal(timgs[0], 0.0)
    np.testing.assert_array_equal(timgs[1:], images[1:])


def test_blocklist_and_apply_match_jax(images):
    prompts = ["a nice cover", "a FORBIDDEN thing", "fine"]
    for checker_of in (lambda m: m.BlocklistSafetyChecker(["forbidden"]),
                       lambda m: None):
        for p in (prompts, None):
            jimgs, jflags = jsafety.apply_safety_checker(
                checker_of(jsafety), images, p)
            timgs, tflags = tsafety.apply_safety_checker(
                checker_of(tsafety), images, p)
            assert tflags == jflags
            np.testing.assert_array_equal(timgs, jimgs)
    assert images[1].max() > 0  # the input untouched


def _hf_vision_sd(seed=3):
    from transformers import CLIPVisionConfig as HFCfg
    from transformers import CLIPVisionModel

    torch.manual_seed(seed)
    hf = CLIPVisionModel(HFCfg(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=32, patch_size=8))
    return {k: v.numpy() for k, v in hf.state_dict().items()}


def _tiny_hf_clip():
    from transformers import CLIPConfig, CLIPModel
    from transformers import CLIPTextConfig as HTC
    from transformers import CLIPVisionConfig as HVC

    cfg = CLIPConfig.from_text_vision_configs(
        HTC(vocab_size=99, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=16, eos_token_id=98, bos_token_id=97),
        HVC(hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, image_size=32, patch_size=8),
        projection_dim=16)
    torch.manual_seed(11)
    return CLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clipmodel")
    _tiny_hf_clip().save_pretrained(d)
    return str(d)


def test_porters_match_jax(tmp_path, clip_dir):
    """port_clip_vision (both key layouts), port_safety_checker,
    safety_checker_from_dir and clip_model_from_dir on state dicts in
    transformers' key layout: the JAX porters' trees and configs."""
    import json

    from safetensors.numpy import save_file

    sd = _hf_vision_sd()
    _same_tree(tport.port_clip_vision(sd), jport.port_clip_vision(sd))
    bare = {k[len("vision_model."):]: v for k, v in sd.items()}
    _same_tree(tport.port_clip_vision(bare), jport.port_clip_vision(bare))
    rng = np.random.default_rng(0)
    full = {f"vision_model.{k}": v for k, v in sd.items()}
    full.update({
        "visual_projection.weight": rng.standard_normal((16, 32)).astype(
            np.float32),
        "concept_embeds": rng.standard_normal((17, 16)).astype(np.float32),
        "concept_embeds_weights": rng.random(17).astype(np.float32),
        "special_care_embeds": rng.standard_normal((3, 16)).astype(
            np.float32),
        "special_care_embeds_weights": rng.random(3).astype(np.float32)})
    _same_tree(tport.port_safety_checker(full),
               jport.port_safety_checker(full))
    save_file(full, str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"vision_config": {"hidden_size": 32,
                                     "intermediate_size": 64,
                                     "num_hidden_layers": 2,
                                     "num_attention_heads": 4,
                                     "image_size": 32, "patch_size": 8}}, f)
    ttree, tcfg = tport.safety_checker_from_dir(str(tmp_path))
    jtree, jcfg = jport.safety_checker_from_dir(str(tmp_path))
    _same_tree(ttree, jtree)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    ttree, ttc, tvc = tport.clip_model_from_dir(clip_dir)
    jtree, jtc, jvc = jport.clip_model_from_dir(clip_dir)
    _same_tree(ttree, jtree)
    assert dataclasses.asdict(ttc) == dataclasses.asdict(jtc)
    assert dataclasses.asdict(tvc) == dataclasses.asdict(jvc)
    with pytest.raises(ValueError, match="no CLIP vision encoder layers"):
        tport.port_clip_vision({})


def test_clip_text_projection_port_and_config():
    """port_clip_text takes text_projection; a WithProjection config gets
    its projection_dim, a plain one none."""
    sd = {k: v.numpy() for k, v in _tiny_hf_clip().state_dict().items()
          if k.startswith("text_model.") or k == "text_projection.weight"}
    tree = tport.port_clip_text(sd)
    assert tree["text_projection"]["w"].shape == (32, 16)
    _same_tree(tree, jport.port_clip_text(sd))
    for arch, want in ((["CLIPTextModelWithProjection"], 16),
                       (["CLIPTextModel"], None)):
        raw = {"architectures": arch, "projection_dim": 16}
        assert tport.clip_config_from_diffusers(raw).projection_dim == want
        assert jport.clip_config_from_diffusers(raw).projection_dim == want


@pytest.fixture(scope="module")
def scorers(clip_dir):
    jtree, jtc, jvc = jport.clip_model_from_dir(clip_dir)
    ttree, ttc, tvc = tport.clip_model_from_dir(clip_dir)
    jtc = dataclasses.replace(jtc, eot_id=98)
    ttc = dataclasses.replace(ttc, eot_id=98)
    js = jscore.ClipScorer(jtree, jtc, jvc, JTokenizer.fallback(99))
    ts = tscore.ClipScorer(ttree, ttc, tvc, CLIPTokenizer.fallback(99),
                           device="cpu")
    return js, ts


def test_clip_scorer_matches_jax(scorers, clip_dir):
    js, ts = scorers
    rng = np.random.default_rng(6)
    imgs = rng.random((3, 48, 48, 3)).astype(np.float32)
    prompts = ["a dragon over a castle", "a red thriller", "sunset beach"]
    ref = js.cosines(imgs, prompts)
    got = ts.cosines(imgs, prompts)
    assert got.shape == (3,) and np.abs(got - ref).max() <= COS_TOL
    assert np.abs(ts.score(imgs, prompts)
                  - js.score(imgs, prompts)).max() <= COS_TOL
    u8 = np.uint8(np.round(imgs * 255))
    np.testing.assert_array_equal(
        ts.cosines(u8, prompts),
        ts.cosines(u8.astype(np.float32) / 255.0, prompts))
    assert np.abs(ts.cosines(u8, prompts)
                  - js.cosines(u8, prompts)).max() <= COS_TOL
    with pytest.raises(ValueError, match="one prompt per image"):
        ts.cosines(imgs, prompts[:2])
    tree, tcfg, vcfg = tport.clip_model_from_dir(clip_dir)
    tree["text"].pop("text_projection")
    with pytest.raises(ValueError, match="projected text tower"):
        tscore.ClipScorer(tree, tcfg, vcfg, CLIPTokenizer.fallback(99),
                          device="cpu")
    with pytest.raises(ValueError, match="projected text tower"):
        tscore.ClipModel(dataclasses.replace(tcfg, projection_dim=None),
                         vcfg, device="cpu")


def test_clip_score_cli_matches_jax(tmp_path, clip_dir, capsys):
    """Both CLIs on one images dir and csv with one CLIPModel dir: the same
    rows, the scores within 1e-5."""
    from PIL import Image

    data = build_fake_dataset(str(tmp_path / "data"), n_train=1, n_test=3)
    import pandas as pd

    df = pd.read_csv(os.path.join(data, "df_test.csv"), index_col=0)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(8)
    for i in df.index:
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            imgs / f"{i}.png")
    (imgs / "notes.png").write_bytes(b"")  # no row id: skipped
    rows = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.csv")
        main(["--images_dir", str(imgs), "--data_root", data,
              "--clip_ckpt", clip_dir, "--batch_size", "2",
              "--out_csv", out] + extra)
        rows[name] = pd.read_csv(out)
    assert list(rows["port"]["file"]) == list(rows["jax"]["file"])
    assert list(rows["port"]["prompt"]) == list(rows["jax"]["prompt"])
    assert len(rows["port"]) == len(df)
    np.testing.assert_allclose(rows["port"]["clip_score"],
                               rows["jax"]["clip_score"], atol=COS_TOL)
    capsys.readouterr()
    tcli.main(["--images_dir", str(imgs), "--data_root", data,
               "--device", "cpu"])
    assert "MEANINGLESS" in capsys.readouterr().out


class _Recorder:
    """A blocklist checker that records how many images it was given."""

    def __init__(self, checker):
        self.checker, self.seen = checker, []

    def __call__(self, images, prompts=None):
        self.seen.append((len(images), list(prompts)))
        return self.checker(images, prompts)


def test_pipeline_safety_slot_matches_jax(tiny_cfg, tiny_params):
    """3 prompts in a bucket of 4: the checker sees the 3 decoded images
    and their prompts only, and the flags and blacked-out images are the
    JAX pipeline's."""
    prompts = ["a calm cover", "a FORBIDDEN cover", "another calm one"]
    lat = np.random.default_rng(2).standard_normal(
        (3, 16, 16, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_inference_steps=2, latents=lat)
    jrec = _Recorder(jsafety.BlocklistSafetyChecker(["forbidden"]))
    trec = _Recorder(tsafety.BlocklistSafetyChecker(["forbidden"]))
    jp = JSDPipeline(tiny_params, tiny_cfg,
                     JTokenizer.fallback(tiny_cfg.clip.vocab_size),
                     compute_dtype=jnp.float32, safety_checker=jrec)
    tp = SDPipeline(_np(tiny_params), tiny_cfg,
                    CLIPTokenizer.fallback(tiny_cfg.clip.vocab_size),
                    device="cpu", compute_dtype=torch.float32,
                    safety_checker=trec)
    assert tp.last_nsfw_flags is None
    ref = jp(prompts, **kw)
    got = tp(prompts, **kw)
    assert tp.last_nsfw_flags == jp.last_nsfw_flags == [False, True, False]
    assert trec.seen == jrec.seen == [(3, prompts)]
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    tp(prompts, decode=False, **kw)  # latents out: no check
    assert len(trec.seen) == 1
