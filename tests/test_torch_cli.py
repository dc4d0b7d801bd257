"""The port's three evaluation CLIs (``sdbc_tpu_torch.cli.inference``,
``precalc_fid_stats``, ``fid``) end to end on the CPU at the tiny config,
on a ``tests/data_fixtures.build_fake_dataset`` dir, against the JAX
package's CLIs; and the port's import rule.

Tolerances: the default mode's grid PNGs within 1/255 of the JAX CLI's
(both sample from ``per_sample_fixed_latents`` on the weights of one tiny
diffusers export); the FID statistics to 1e-4 of their largest entry and
the FID numbers to 1e-4 relative, with ``SDBC_INCEPTION_WEIGHTS`` naming
one tiny weights file."""
import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdbc_tpu.cli import fid as jfid_cli
from sdbc_tpu.cli import inference as jinf
from sdbc_tpu.cli import precalc_fid_stats as jpf
from sdbc_tpu.models import port as jport
from sdbc_tpu_torch.cli import common
from sdbc_tpu_torch.cli import fid as tfid_cli
from sdbc_tpu_torch.cli import inference as tinf
from sdbc_tpu_torch.cli import precalc_fid_stats as tpf
from sdbc_tpu_torch.models import inception as tinc
from tests.data_fixtures import build_fake_dataset
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-4
FID_RTOL = 1e-4
TINY = ["--tiny", "--no-bf16", "--num_inference_steps", "3"]


@pytest.fixture(scope="module")
def env(tmp_path_factory, tiny_cfg, tiny_params):
    root = tmp_path_factory.mktemp("cli")
    data = build_fake_dataset(str(root / "data"), n_train=2, n_test=4)
    export = jport.export_diffusers_checkpoint(tiny_params, tiny_cfg,
                                               str(root / "sd_tiny"))
    weights = str(root / "inception_tiny.npz")
    gen = torch.Generator().manual_seed(3)
    tinc.save_npz(weights, tinc.init(tinc.InceptionConfig.tiny(),
                                     generator=gen, device="cpu"))
    return {"root": root, "data": data, "export": export,
            "weights": weights}


def _png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.int16)


def test_default_mode_grid_matches_jax(env):
    """--mode default --diffusers_ckpt: one grid (no df_test under
    --data_root), 13 fixed-latent prompts in one bucket-16 call."""
    grids = {}
    for name, main, extra in (("jax", jinf.main, []),
                              ("port", tinf.main, ["--device", "cpu"])):
        save = env["root"] / f"grid_{name}"
        main(TINY + extra + ["--mode", "default",
                             "--diffusers_ckpt", env["export"],
                             "--data_root", str(env["root"]),
                             "--samples_per_prompt", "1",
                             "--batch_size", "16",
                             "--save_dir", str(save)])
        grids[name] = _png(save / "dev inference" /
                           "summerize=False,include_desc=False.png")
    assert grids["port"].shape == grids["jax"].shape
    assert np.abs(grids["port"] - grids["jax"]).max() <= 1


def test_fid_clis_match_jax(env, tmp_path, monkeypatch, capsys):
    """precalc_fid_stats and fid on the fake dataset with one tiny weights
    file: the same statistics and the same FID numbers."""
    monkeypatch.setenv("SDBC_INCEPTION_WEIGHTS", env["weights"])
    stats = {}
    for name, main, extra in (("jax", jpf.main, []),
                              ("port", tpf.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npz")
        main(["--data_root", env["data"], "--tiny", "--img_size", "32",
              "--batch_size", "3", "--out", out] + extra)
        with np.load(out) as f:
            stats[name] = (f["mu"], f["sigma"])
    for got, ref in zip(stats["port"], stats["jax"]):
        assert np.abs(got - ref).max() <= STAT_RTOL * np.abs(ref).max()
    images = os.path.join(env["data"], "images", "images")
    capsys.readouterr()
    fids = {}
    for name, main, extra in (("jax", jfid_cli.main, []),
                              ("port", tfid_cli.main, ["--device", "cpu"])):
        main([images, str(tmp_path / "jax.npz"), "--tiny", "--img_size",
              "32", "--batch_size", "4"] + extra)
        fids[name] = float(re.findall(r"FID: (\S+)",
                                      capsys.readouterr().out)[-1])
    assert fids["jax"] > 0
    assert fids["port"] == pytest.approx(fids["jax"], rel=FID_RTOL)


def test_calc_fid_and_enter_prompt_write_files(env, tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setenv("SDBC_INCEPTION_WEIGHTS", env["weights"])
    stats = str(tmp_path / "stats.npz")
    tpf.main(["--data_root", env["data"], "--tiny", "--device", "cpu",
              "--out", stats])
    base = TINY + ["--device", "cpu", "--save_dir", str(tmp_path)]
    tinf.main(base + ["--mode", "calc_fid", "--data_root", env["data"],
                      "--fid_stats_path", stats, "--num_imgs", "3",
                      "--batch_size", "2", "--run_id", "fid"])
    out = tmp_path / "fid inference"
    assert sorted(os.listdir(out)) == ["2.jpg", "3.jpg", "4.jpg",
                                       "fid_score.txt"]
    assert float((out / "fid_score.txt").read_text()) > 0
    init = str(tmp_path / "init.png")
    mask = str(tmp_path / "mask.png")
    Image.fromarray(np.full((32, 32, 3), 90, np.uint8)).save(init)
    m = np.zeros((32, 32), np.uint8)
    m[:, 16:] = 255
    Image.fromarray(m).save(mask)
    runs = {"img2img": ["--init_image", init, "--strength", "0.6"],
            "inpaint": ["--init_image", init, "--mask_image", mask],
            "hires": ["--hires_scale", "2", "--img_size", "64",
                      "--hires_mode", "image"],
            "weighted": ["--prompt_weighting", "--samples_per_prompt", "2",
                         "--scheduler", "dpm", "--karras_sigmas"]}
    for run_id, extra in runs.items():
        tinf.main(base + ["--mode", "enter_prompt", "--prompt",
                          "a (cover:1.2)", "--run_id", run_id] + extra)
        files = sorted(os.listdir(tmp_path / f"{run_id} inference"))
        want = (["a (cover:1.2)-0.png", "a (cover:1.2)-1.png"]
                if run_id == "weighted" else ["a (cover:1.2).png"])
        assert files == want, run_id
    with pytest.raises(SystemExit, match="--hires_scale drives both"):
        tinf.main(base + ["--mode", "enter_prompt", "--prompt", "x",
                          "--hires_scale", "2", "--init_image", init])


def test_ckpt_flag_loads_a_port_checkpoint(env, tmp_path, tiny_params):
    """--ckpt serves the weights it holds: the same image as
    --diffusers_ckpt of the same weights; a checkpoint the JAX package
    wrote of them serves the port checkpoint's image."""
    import jax

    from sdbc_tpu.utils import checkpoint as jckpt
    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig,
                                                   as_modules)
    from sdbc_tpu_torch.utils import checkpoint as tckpt

    ck = str(tmp_path / "port_ckpt")
    tckpt.save_pipeline(ck, as_modules(jax.tree.map(np.asarray, tiny_params),
                                       PipelineConfig.tiny(), "cpu"),
                        PipelineConfig.tiny())
    base = TINY + ["--device", "cpu", "--save_dir", str(tmp_path),
                   "--mode", "enter_prompt", "--prompt", "a cover"]
    tinf.main(base + ["--ckpt", ck, "--run_id", "ck"])
    tinf.main(base + ["--diffusers_ckpt", env["export"], "--run_id", "df"])
    a = _png(tmp_path / "ck inference" / "a cover.png")
    b = _png(tmp_path / "df inference" / "a cover.png")
    assert np.abs(a - b).max() <= 1
    jck = str(tmp_path / "jax_ckpt")
    jckpt.save_pipeline(jck, tiny_params, jinf.common.resolve_params_cfg(
        jinf.build_parser().parse_args(["--tiny"]))[1])
    tinf.main(base + ["--ckpt", jck, "--run_id", "jk"])
    assert np.array_equal(_png(tmp_path / "jk inference" / "a cover.png"), a)


def _bart_dir(root) -> str:
    """A tiny DistilBART-layout dir: transformers-named weights of
    ``BartConfig.tiny()`` written by ``write_safetensors`` and a byte-level
    vocabulary covering its 128 ids."""
    from sdbc_tpu_torch.models import bart as tbart
    from sdbc_tpu_torch.models.port import write_safetensors
    from tests.test_torch_bart import bart_state_dict, write_vocab

    root.mkdir()
    write_safetensors(bart_state_dict(tbart.BartConfig.tiny(), seed=2),
                      str(root / "model.safetensors"))
    return write_vocab(root)


def test_default_mode_summarize_grid_matches_jax(env, tmp_path,
                                                 monkeypatch):
    """--mode default --summarize --bart_ckpt on a df_test.csv: both CLIs
    render (summarize, include_desc) = (F,F), (T,T), (F,T) in that order,
    with the same prompts (the (T,T) ones holding the DistilBART
    summaries) and the (T,T) grid within 1/255.  Both CLIs build the
    summarizer with DistilBART-CNN's config whatever the dir holds: each is
    given the tiny one here."""
    import random

    from sdbc_tpu.eval import visualize as jvis
    from sdbc_tpu.models import bart as jbart
    from sdbc_tpu_torch.data.dataset import read_csv_rows
    from sdbc_tpu_torch.eval import visualize as tvis
    from sdbc_tpu_torch.models import bart as tbart

    bart = _bart_dir(tmp_path / "bart")
    for mod in (jbart, tbart):
        monkeypatch.setattr(mod.BartConfig, "distilbart_cnn",
                            staticmethod(mod.BartConfig.tiny))
    runs = {}
    for name, main, vis, extra in (
            ("jax", jinf.main, jvis, []),
            ("port", tinf.main, tvis, ["--device", "cpu"])):
        seen = []
        real = vis.visualize_prompts

        def spy(*a, _real=real, _seen=seen, **kw):
            out = _real(*a, **kw)
            _seen.append((kw["summarize"], kw["include_desc"], out[1]))
            return out

        monkeypatch.setattr(vis, "visualize_prompts", spy)
        random.seed(0)  # the placeholders past the tenth template
        save = tmp_path / f"grid_{name}"
        main(TINY + extra + ["--mode", "default",
                             "--diffusers_ckpt", env["export"],
                             "--data_root", env["data"], "--summarize",
                             "--bart_ckpt", bart, "--samples_per_prompt",
                             "1", "--batch_size", "16",
                             "--save_dir", str(save)])
        runs[name] = (seen, _png(save / "dev inference" /
                                 "summerize=True,include_desc=True.png"))
    (jseen, jgrid), (tseen, tgrid) = runs["jax"], runs["port"]
    assert [c[:2] for c in tseen] == [(False, False), (True, True),
                                      (False, True)]
    assert tseen == jseen
    summarizer = tinf.build_summarizer(tinf.build_parser().parse_args(
        ["--device", "cpu", "--bart_ckpt", bart]))
    descs = [str(r["book_desc"]) for _, r in read_csv_rows(os.path.join(
        env["data"], "df_test.csv"))]
    summaries = [summarizer(d) for d in descs]
    assert all(summaries) and summaries != descs
    assert len(tseen[1][2]) == 13
    for i, prompt in enumerate(tseen[1][2]):  # descriptions padded to 13
        assert summaries[min(i, len(descs) - 1)] in prompt
    assert tgrid.shape == jgrid.shape
    assert np.abs(tgrid - jgrid).max() <= 1


# the summarize grid's refusals, the JAX CLI's: each case the flags past
# --mode default, whether df_test.csv is there, and the message
SUMMARIZE_ERRORS = [
    (["--summarize"], True, "--summarize needs --bart_ckpt"),
    (["--summarize", "--bart_ckpt", "BART", "--no-include_desc"], True,
     "cannot combine with --no-include_desc"),
    (["--summarize", "--bart_ckpt", "BART"], False,
     "--summarize needs .*df_test.csv"),
    (["--summarize", "--bart_ckpt", "EMPTY"], True,
     "vocab.json \\+ merges.txt"),
]


@pytest.mark.parametrize("flags,with_csv,what", SUMMARIZE_ERRORS,
                         ids=["no-bart", "no-desc", "no-csv", "no-vocab"])
def test_summarize_errors_match_jax(env, tmp_path, flags, with_csv, what):
    (tmp_path / "empty").mkdir()
    bart = env["root"] / "bart_errors"
    bart.mkdir(exist_ok=True)
    flags = [str(bart) if f == "BART" else str(tmp_path / "empty")
             if f == "EMPTY" else f for f in flags]
    data = env["data"] if with_csv else str(tmp_path / "empty")
    for main, extra in ((jinf.main, []), (tinf.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=what):
            main(TINY + extra + ["--mode", "default", "--data_root", data,
                                 "--diffusers_ckpt", env["export"],
                                 "--save_dir", str(tmp_path)] + flags)


def test_csv_rows_read_as_pandas_reads_them(tmp_path):
    """``read_csv_rows`` against ``pd.read_csv(index_col=0).iterrows()`` on
    Goodreads-like descriptions: quoted commas, quotes, newlines,
    non-ASCII text and an empty field."""
    import pandas as pd

    from sdbc_tpu_torch.data.dataset import read_csv_rows

    df = pd.DataFrame({
        "book_authors": ["Zoë Brontë", "J. R. R. Tolkien", "", "O'Brien"],
        "book_desc": ['A "hero", a sword, and a quest.\nPart two: home.',
                      "Épopée — « roman » en 3 tomes;\r\nfin", None,
                      "Tabs\tand, commas,, and \"quotes\"\n\n"],
        "book_title": ["Wuthering, Heights", "The Hobbit", "NA", "42"]},
        index=[17, 3, 8, 250])
    path = tmp_path / "df_test.csv"
    df.to_csv(path)
    want = [(idx, dict(row)) for idx, row in
            pd.read_csv(path, index_col=0).iterrows()]
    got = read_csv_rows(str(path))
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert list(a) == list(b)
        assert [str(v) for v in a.values()] == [str(v) for v in b.values()]
        assert [isinstance(v, str) for v in a.values()] == \
            [isinstance(v, str) for v in b.values()]


# each case: the flags and the message they exit with; the ControlNet
# flags are ported (tests/test_torch_controlnet.py) and keep their cases
# for the refusals left to them: a missing dir, an image without a
# branch, a scale without an image
REFUSED = [
    (["--wandb_artifact_run", "abc"], "wandb.*not ported yet"),
    (["--wandb_key", "k"], "wandb.*not ported yet"),
    (["--controlnet_path", "cn"], "--controlnet_path cn: no ControlNet"),
    (["--control_image", "c.png"], "--control_image needs a ControlNet"),
    (["--controlnet_scale", "0.5"], "--controlnet_scale .* ControlNet"),
    # --tp is ported (tests/test_torch_parallel*.py): one process has no
    # model axis of 2; row sharding waits for ROADMAP Queue 1 item 5.2
    (["--tp", "2"], r"--tp 2: mesh 0x2 != 1 devices"),
    (["--tp", "1", "--spatial"], r"row-sharded.*item 5\.2.*not ported yet"),
]


@pytest.mark.parametrize("flags,what", REFUSED,
                         ids=[" ".join(f) for f, _ in REFUSED])
def test_unported_flags_exit_with_their_feature(flags, what):
    with pytest.raises(SystemExit, match=f"(?s){what}"):
        tinf.main(["--tiny", "--device", "cpu", "--mode", "enter_prompt",
                   "--prompt", "x"] + flags)


def test_device_flag_has_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser = tinf.build_parser()
    assert parser.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        common.resolve_params_cfg(parser.parse_args(["--tiny"]))
    with pytest.raises(SystemExit, match="no CUDA device"):
        tfid_cli.main(["a.npz", "b.npz"])


def _port_modules():
    pkg = os.path.join(ROOT, "sdbc_tpu_torch")
    for dirpath, _, names in os.walk(pkg):
        for n in sorted(names):
            if n.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, n), ROOT)
                yield rel[:-3].replace(os.sep, ".").removesuffix(".__init__")


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of sdbc_tpu_torch names jax or sdbc_tpu in an import, and
    importing every one of them in a fresh interpreter loads neither (nor
    PIL or pandas, which only file I/O imports, nor orbax, tensorstore or
    zstandard)."""
    mods = list(_port_modules())
    for name in ("cli.inference", "cli.serve", "cli.clip_score",
                 "models.safety", "eval.clip_score", "train.lora",
                 "train.textual_inversion", "utils.png", "cli.finetune",
                 "cli.training", "cli.preprocess", "utils.checkpoint",
                 "utils.tracking", "utils.profiling", "data.dataset",
                 "data.native_loader", "data.preprocess",
                 "train.latent_cache", "train.prior", "models.bart",
                 "data.bart_tokenizer"):
        assert f"sdbc_tpu_torch.{name}" in mods
    for mod in mods:
        path = os.path.join(ROOT, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(ROOT, *mod.split("."), "__init__.py")
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "sdbc_tpu"), (mod, name)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sdbc_tpu', 'PIL', 'pandas', 'orbax', "
            "'tensorstore', 'zstandard'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
