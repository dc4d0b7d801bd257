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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = 1e-4
FID_RTOL = 1e-4
TINY = ["--tiny", "--no-bf16", "--num_inference_steps", "3"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


REFUSED = [
    (["--ckpt", "run"], "orbax"),
    (["--wandb_artifact_run", "abc"], "wandb"),
    (["--wandb_key", "k"], "wandb"),
    (["--lora_path", "a.npz"], "LoRA"),
    (["--ti_path", "t.npz"], "textual inversion"),
    (["--controlnet_path", "cn"], "ControlNet"),
    (["--control_image", "c.png"], "ControlNet"),
    (["--controlnet_scale", "0.5"], "ControlNet"),
    (["--model_family", "sd21"], "SD-2.x and SDXL"),
    (["--model_family", "sdxl"], "SD-2.x and SDXL"),
    (["--tp", "2"], "multi-device"),
    (["--tp", "1", "--spatial"], "multi-device"),
    (["--refiner_ckpt", "rf"], "refiner"),
    (["--safety_checker", "sc"], "safety checker"),
    (["--summarize"], "BART"),
    (["--bart_ckpt", "bart"], "BART"),
]


@pytest.mark.parametrize("flags,what", REFUSED,
                         ids=[" ".join(f) for f, _ in REFUSED])
def test_unported_flags_exit_with_their_feature(flags, what):
    with pytest.raises(SystemExit, match=f"(?s){what}.*not ported yet"):
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
    PIL or pandas, which only file I/O imports)."""
    mods = list(_port_modules())
    assert "sdbc_tpu_torch.cli.inference" in mods
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
            "('jax', 'jaxlib', 'sdbc_tpu', 'PIL', 'pandas'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
