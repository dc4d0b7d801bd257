"""The port's data path against the JAX package's on the CPU: the Goodreads
dataset and loader (``sdbc_tpu_torch/data/dataset.py``, its stdlib CSV
reader against ``pd.read_csv``), the decoders (PIL, the native library,
PNG without PIL), the latent cache, the prior set, the tracker's files
and preprocessing.  Pixels and prompts are held bit for bit; the cached
moments to 1e-4 (two packages' fp32 VAE encodes)."""
import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

from sdbc_tpu.data import dataset as jds
from sdbc_tpu.data import native_loader as jnative
from sdbc_tpu.data import preprocess as jpre
from sdbc_tpu.data.tokenizer import CLIPTokenizer as JTok
from sdbc_tpu.train import prior as jprior
from sdbc_tpu.utils import tracking as jtracking
from sdbc_tpu_torch.data import dataset as tds
from sdbc_tpu_torch.data import native_loader as tnative
from sdbc_tpu_torch.data import preprocess as tpre
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from sdbc_tpu_torch.train import prior as tprior
from sdbc_tpu_torch.utils import png
from sdbc_tpu_torch.utils import tracking as ttracking
from tests.data_fixtures import build_fake_dataset
from tests.torch_threads import one_thread  # noqa: F401

LATENT_ATOL = 1e-4
IMG = 32


def _write_dataset(root, n=8, png_every=0):
    """A Goodreads-layout dataset whose CSV has zero-padded integer ids,
    an empty author, a quoted title holding a comma and a missing
    description; every ``png_every``-th image is a PNG under its .jpg
    name."""
    from PIL import Image

    img_dir = os.path.join(root, "images", "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(1)
    rows = []
    for i in range(n):
        author = "" if i == 2 else f"Author {i}"
        title = "Dust, and Ash" if i == 3 else f"Title {i}"
        desc = "" if i == 4 else f"A description number {i}."
        rows.append([f"{i:03d}", author, desc, title])
        arr = rng.randint(0, 255, (IMG + 8 * (i % 2), IMG, 3)).astype(
            np.uint8)
        path = os.path.join(img_dir, f"{i}.jpg")
        if png_every and i % png_every == 0:
            arr = arr[:IMG]  # a PNG at the training size
            with open(path, "wb") as f:
                f.write(png.encode(arr))
        else:
            Image.fromarray(arr).save(path, format="JPEG")
    with open(os.path.join(root, "df_train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "book_authors", "book_desc", "book_title"])
        w.writerows(rows)
    return root


def _pair(root, **kw):
    jt, tt = JTok.fallback(1000), TTok.fallback(1000)
    jcfg = jds.DatasetConfig(data_root=root, img_size=IMG, max_length=16,
                             seed=5, **kw)
    tcfg = tds.DatasetConfig(data_root=root, img_size=IMG, max_length=16,
                             seed=5, **kw)
    return jds.GoodreadsDataset(jcfg, jt), tds.GoodreadsDataset(tcfg, tt)


@pytest.mark.parametrize("kw", [dict(), dict(include_desc=True,
                                             legible_text_prob=0.5,
                                             style_token="<sty>"),
                                dict(prompt_bank="reference",
                                     include_desc=True)],
                         ids=["native", "desc+style", "reference"])
def test_dataset_prompts_and_index_match_jax(tmp_path, kw):
    jd, td = _pair(_write_dataset(str(tmp_path)), **kw)
    assert len(td) == len(jd)
    assert [td.image_path(i) for i in range(len(td))] == \
        [jd.image_path(i) for i in range(len(jd))]
    assert td.image_path(0).endswith(os.sep + "0.jpg")  # "000" → 0
    for epoch in (0, 3):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        assert [td.prompt_for(i) for i in range(len(td))] == \
            [jd.prompt_for(i) for i in range(len(jd))]
    assert "nan" in td.prompt_for(2) or kw.get("prompt_bank")


def test_loader_batches_match_jax(tmp_path):
    """Batch order, prompts' token ids, shapes and pixels of two epochs,
    JPEG through PIL and PNG-in-.jpg through utils/png.py."""
    jd, td = _pair(_write_dataset(str(tmp_path), png_every=3),
                   use_native=False)
    for epoch in (0, 1):
        jb = list(jds.make_dataloader(jd, micro_batch=2, grad_accum=2,
                                      seed=7 + epoch, num_workers=2,
                                      epoch=epoch))
        tb = list(tds.make_dataloader(td, micro_batch=2, grad_accum=2,
                                      seed=7 + epoch, num_workers=2,
                                      epoch=epoch))
        assert len(tb) == len(jb) == 2
        for a, b in zip(jb, tb):
            assert set(a) == set(b) == {"pixel_values", "input_ids"}
            assert b["pixel_values"].shape == (2, 2, IMG, IMG, 3)
            assert b["pixel_values"].dtype == np.float32
            np.testing.assert_array_equal(b["input_ids"], a["input_ids"])
            np.testing.assert_array_equal(b["pixel_values"],
                                          a["pixel_values"])


def test_png_decodes_without_pil(tmp_path, monkeypatch):
    root = _write_dataset(str(tmp_path), png_every=1)
    jd, td = _pair(root, use_native=False)
    want = np.stack([jds.decode_and_prepare(jd.image_path(i), IMG)
                     for i in range(len(jd))])
    monkeypatch.setitem(sys.modules, "PIL", None)
    got = tds.decode_pixels(td, list(range(len(td))))
    np.testing.assert_array_equal(got, want)


def test_native_decode_matches_jax(tmp_path):
    """The port's build of native/loader.cc (under build/sdbc_tpu_torch/)
    decodes the JPEGs to the JAX package's library's bits."""
    if not (tnative.available() and jnative.available()):
        pytest.skip(f"the native library does not build here: "
                    f"{tnative.unavailable_reason()}")
    assert os.path.dirname(tnative._LIB_PATH).endswith(
        os.path.join("build", "sdbc_tpu_torch"))
    jd, td = _pair(_write_dataset(str(tmp_path), png_every=4))
    idx = list(range(len(td)))
    np.testing.assert_array_equal(tds.decode_pixels(td, idx),
                                  _jax_pixels(jd, idx))


def _jax_pixels(jd, idx):
    """The JAX package's pixels: its native library for JPEGs, PIL for the
    PNG-in-.jpg files (which that library cannot read)."""
    out = []
    for i in idx:
        path = jd.image_path(i)
        with open(path, "rb") as f:
            is_png = f.read(8) == png.SIGNATURE
        out.append(jds.decode_and_prepare(path, IMG) if is_png
                   else jnative.decode_batch([path], IMG)[0])
    return np.stack(out)


def test_no_decoder_names_both(tmp_path, monkeypatch):
    root = _write_dataset(str(tmp_path))
    _, td = _pair(root)
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="(?s)native loader.*PIL"):
        tds.decode_pixels(td, [1])


def test_csv_reader_types_columns_as_pandas(tmp_path):
    import pandas as pd

    path = tmp_path / "x.csv"
    path.write_text(",a,b,c,d,e\n007,1,x,,1.5,True\n8,,\"y, z\",NA,2,"
                    "False\n09,3,nan,w,,true\n")
    df = pd.read_csv(path, index_col=0)
    index, cols = tds.read_csv(str(path))
    assert [str(i) for i in index] == [str(i) for i in df.index]
    for name in df.columns:
        assert [str(v) for v in cols[name]] == \
            [str(df.iloc[i][name]) for i in range(len(df))], name
        assert [isinstance(v, str) for v in cols[name]] == \
            [isinstance(df.iloc[i][name], str) for i in range(len(df))]


def test_latent_cache_matches_jax(tmp_path, tiny_params, tiny_cfg):
    import jax

    from sdbc_tpu.train import latent_cache as jlc
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, as_modules
    from sdbc_tpu_torch.train import latent_cache as tlc

    root = build_fake_dataset(str(tmp_path / "ds"), n_train=5, n_test=1)
    jd, td = _pair(root, use_native=False)
    np_params = jax.tree.map(np.asarray, tiny_params)
    vae = as_modules(np_params, PipelineConfig.tiny(), "cpu")["vae"]
    jpath = jlc.build_latent_cache(jd, tiny_params["vae"], tiny_cfg.vae,
                                   np.float32, batch=2,
                                   root=str(tmp_path / "j"), verbose=False)
    tpath = tlc.build_latent_cache(td, vae, torch.float32, batch=2,
                                   root=str(tmp_path / "t"), verbose=False)
    assert tlc.build_latent_cache(td, vae, torch.float32, batch=2,
                                  root=str(tmp_path / "t"),
                                  verbose=False) == tpath  # a cache hit
    for a, b in zip(jlc.open_latent_cache(jpath),
                    tlc.open_latent_cache(tpath)):
        assert a.shape == b.shape == (5, 16, 16, 4) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=LATENT_ATOL)
    tmeta = json.load(open(os.path.join(tpath, "meta.json")))
    jmeta = json.load(open(os.path.join(jpath, "meta.json")))
    assert {k: v for k, v in tmeta.items() if k != "vae_checksum"} == \
        {k: v for k, v in jmeta.items() if k != "vae_checksum"}
    # the cache feeds the loader in place of pixels
    batch = next(tds.make_dataloader(td, micro_batch=2, grad_accum=1,
                                     latent_cache=tlc.open_latent_cache(
                                         tpath)))
    assert set(batch) == {"latent_mean", "latent_logvar", "input_ids"}
    assert batch["latent_mean"].shape == (1, 2, 16, 16, 4)


def test_prior_set_matches_jax(tmp_path):
    from PIL import Image

    d = tmp_path / "class"
    d.mkdir()
    rng = np.random.RandomState(2)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3)).astype(np.uint8)
                        ).save(d / f"c{i}.jpg")
    with open(d / "c3.png", "wb") as f:
        f.write(png.encode(rng.randint(0, 255, (IMG, IMG, 3)).astype(
            np.uint8)))
    js = jprior.PriorSet(str(d), "a book cover", JTok.fallback(1000), IMG,
                         max_length=16)
    ts = tprior.PriorSet(str(d), "a book cover", TTok.fallback(1000), IMG,
                         max_length=16)
    jb, tb = js.batches(2, 2, seed=3), ts.batches(2, 2, seed=3)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    with pytest.raises(ValueError, match="no class images"):
        tprior.PriorSet(str(tmp_path / "none"), "x", TTok.fallback(1000), 8)


def test_generate_class_images_writes_pngs(tmp_path):
    imgs = np.random.default_rng(0).uniform(0, 1, (3, 8, 8, 3)).astype(
        np.float32)

    def pipe(prompts, **kw):
        return imgs[: len(prompts)]

    (tmp_path / "class-00000.png").write_bytes(png.encode(
        np.zeros((8, 8, 3), np.uint8)))
    made = tprior.generate_class_images(pipe, "x", 3, str(tmp_path),
                                        img_size=8, batch_size=2,
                                        log=lambda *_: None)
    assert made == 2
    names = sorted(os.listdir(tmp_path))
    assert names == ["class-00000.png", "class-00001.png", "class-00002.png"]
    got = png.decode((tmp_path / "class-00001.png").read_bytes())
    np.testing.assert_array_equal(got, np.uint8(np.round(imgs[0] * 255.0)))


def test_tracker_files_match_jax(tmp_path):
    config = {"lr": 1e-4, "run": "x", "path": tmp_path}
    logs = [({"loss": 0.5, "epoch": 0, "skipped_updates": 0}, 1),
            ({"mean_loss": 0.25}, 2)]
    for mod, sub in ((jtracking, "j"), (ttracking, "t")):
        tr = mod.Tracker(str(tmp_path / sub), "run", config=config)
        for m, step in logs:
            tr.log(m, step=step)
        tr.log_artifact(str(tmp_path))
        tr.finish()

    def read(sub):
        base = tmp_path / sub / "runs" / "run"
        events = [json.loads(line) for line in
                  (base / "events.jsonl").read_text().splitlines()]
        for e in events:
            assert isinstance(e.pop("ts"), float)
        return events, (base / "hyperparams.json").read_text()

    assert read("t") == read("j")
    with pytest.raises(NotImplementedError, match="wandb"):
        ttracking.Tracker(str(tmp_path), "r", wandb_key="k")


def test_preprocess_matches_jax(tmp_path):
    outs = []
    for sub, mod in (("j", jpre), ("t", tpre)):
        root = build_fake_dataset(str(tmp_path / sub), n_train=6, n_test=2,
                                  with_source=True)
        with open(os.path.join(root, "images", "images", "3.jpg"), "wb") as f:
            f.write(b"\xff\xd8 truncated")
        mod.preprocess(root, n_test=2, verbose=False)
        outs.append([open(os.path.join(root, n)).read() for n in
                     ("df_train.csv", "df_test.csv",
                      "dropped_non_English.csv")])
    assert outs[0] == outs[1]
    assert "Книга" in outs[1][2]
