"""Reading what the JAX package's ``save_pipeline`` writes, on the CPU: the
port's zstd decoder (``sdbc_tpu_torch/utils/zstd.py``) against the
``zstandard`` module's frames, its OCDBT store (``utils/ocdbt.py``) against
tensorstore's keys and bytes, and its ``load_pipeline`` / ``load_ema`` /
``load_opt_state`` (``utils/checkpoint.py``) against the JAX package's on
the same directories, leaf for leaf and bit for bit: plain, EMA, LoRA and
TI saves, a tiny_xl save, a two-branch ControlNet save, and the committed
fixture ``tests/data/jax_ckpt_tiny/`` (``experiments/
make_jax_ckpt_fixture.py``: 8-bit AdamW, an EMA shadow, saved under an
8-device mesh so that leaves span several chunks) against its digests.
Then a DDIM-2 image from the fixture, and ``cli/finetune.py --resume`` from
it."""
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import (DictKey, GetAttrKey, SequenceKey,
                           tree_flatten_with_path)

from sdbc_tpu.diffusion import graph as jgraph
from sdbc_tpu.diffusion.pipeline import PipelineConfig as JCfg
from sdbc_tpu.train import lora as jlora
from sdbc_tpu.train import trainer as jtrainer
from sdbc_tpu.utils import checkpoint as jckpt
from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
from sdbc_tpu_torch.diffusion import graph as tgraph
from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
from sdbc_tpu_torch.train import trainer as ttrainer
from sdbc_tpu_torch.utils import checkpoint as tckpt
from sdbc_tpu_torch.utils import ocdbt, zarr, zstd
from tests.test_torch_families import port_init_tree
from tests.torch_threads import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "jax_ckpt_tiny")
# the goldens' pipeline-image tolerance (tests/test_goldens.py)
IMAGE_ATOL = 1e-3


# ------------------------------------------------------------------ helpers


def _path(path) -> tuple:
    return tuple(str(q.key) if isinstance(q, DictKey) else
                 str(q.idx) if isinstance(q, SequenceKey) else
                 q.name if isinstance(q, GetAttrKey) else str(q)
                 for q in path)


def _bits(x) -> np.ndarray:
    """An array's bytes as integers of its width (bf16 too)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().contiguous()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "") if isinstance(
        x, torch.Tensor) else np.asarray(x).dtype.name


def _jax_flat(tree) -> dict:
    return {_path(p): leaf for p, leaf in tree_flatten_with_path(tree)[0]}


def _port_flat(leaves) -> dict:
    """{path: tensor} of ``[(key path, tensor or empty mark)]``."""
    return {tuple(k for k, _ in key): t for key, t in leaves
            if not isinstance(t, str)}


def _assert_bit_equal(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want))[:6])
    for k in want:
        g, w = got[k], want[k]
        assert _dtype(g) == _dtype(w), (what, k, _dtype(g), _dtype(w))
        assert tuple(g.shape) == tuple(np.shape(w)), (what, k)
        assert np.array_equal(_bits(g), _bits(w)), (what, k)


def _models_vs_jax(models: dict, params: dict, what: str) -> None:
    for comp, value in params.items():
        _assert_bit_equal(_port_flat(tckpt.component_tree(models[comp])),
                          _jax_flat(value), f"{what} {comp}")
    assert set(models) == set(params), what


def _jnp(tree, dtype=np.float32):
    """A numpy tree as JAX arrays of ``dtype`` (cast on the host: no XLA
    program a leaf)."""
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a).astype(dtype)),
                        tree)


def _shapes(fn, *args):
    """``fn(*args)``'s structure as arrays on one device, to restore onto
    (``jax.eval_shape``: no XLA program a leaf)."""
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                       sharding=one),
                        jax.eval_shape(fn, *args))


def _random_state(template, seed: int):
    """A JAX state of ``template``'s structure (a function's shapes from
    ``jax.eval_shape``) with random moments and counts of 5."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(s.dtype)
                              if jnp.issubdtype(s.dtype, jnp.floating)
                              else np.full(s.shape, 5, s.dtype)), template)


# ------------------------------------------------------------- (a) zstd

LEVELS = [-5, 1, 3, 9, 19]


@pytest.fixture(scope="module")
def zstd_inputs():
    import ml_dtypes

    rng = np.random.default_rng(0)
    with open(os.path.join(ROOT, "ROADMAP.md"), "rb") as f:
        text = f.read()[:40000]
    return {
        # over 128 KiB: several blocks
        "bf16 N(0, 0.02)": rng.normal(0, 0.02, 80000).astype(
            ml_dtypes.bfloat16).tobytes(),
        "fp32": rng.normal(0, 1, 8000).astype(np.float32).tobytes(),
        "zeros (RLE)": bytes(150000),
        "random bytes (raw blocks)": rng.bytes(20000),
        "text": text,
        "empty": b"",
    }


@pytest.mark.parametrize("level", LEVELS)
def test_zstd_decodes_zstandard_frames(zstd_inputs, level):
    zs = pytest.importorskip("zstandard")
    for checksum, size in ((True, True), (False, False), (True, False),
                           (False, True)):
        c = zs.ZstdCompressor(level=level, write_checksum=checksum,
                              write_content_size=size)
        for name, data in zstd_inputs.items():
            if (checksum, size) in ((True, False), (False, True)) \
                    and len(data) > 40000:
                continue   # the header flags alone: the short inputs
            frame = c.compress(data)
            assert zstd.decompress(frame, len(data)) == data, (name, level)
            if size:
                assert zstd.content_size(frame) == len(data)
                assert zstd.decompress(frame) == data
            else:
                assert zstd.content_size(frame) is None


def test_zstd_frames_streams_and_corruption(zstd_inputs):
    zs = pytest.importorskip("zstandard")
    bf16, text = zstd_inputs["bf16 N(0, 0.02)"], zstd_inputs["text"]
    # a streamed frame (no content size, blocks as written), concatenated
    # with a skippable frame and a second frame
    stream = zs.ZstdCompressor(level=3).compressobj()
    frame = b"".join([stream.compress(bf16[:70000]), stream.flush(
        zs.COMPRESSOBJ_FLUSH_BLOCK), stream.compress(bf16[70000:]),
        stream.flush()])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"12345"
    both = frame + skip + zs.ZstdCompressor(level=1).compress(text)
    assert zstd.decompress(both, len(bf16) + len(text)) == bf16 + text
    out = zstd.decompress_many([frame, both], [len(bf16), len(bf16)
                                               + len(text)])
    assert out[0].tobytes() == bf16 and out[1].tobytes() == bf16 + text
    # a flipped byte under the checksum, a short output, a truncated frame
    good = zs.ZstdCompressor(level=3, write_checksum=True).compress(text)
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(bad), len(text))
    with pytest.raises(zstd.ZstdError, match="checksum"):
        tail = bytearray(good)
        tail[-1] ^= 1
        zstd.decompress(bytes(tail), len(text))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(good, len(text) - 1)
    with pytest.raises(zstd.ZstdError, match="truncated"):
        zstd.decompress(good[:len(good) // 2], len(text))
    # the same frame naming dictionary 7 (a one-byte Dictionary_ID)
    plain = zs.ZstdCompressor(level=3, write_content_size=False).compress(
        text)
    assert plain[4] == 0   # no flags: a window descriptor follows
    named = plain[:4] + bytes([1]) + plain[5:6] + bytes([7]) + plain[6:]
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(named, len(text))


def test_zstd_threads_stress(zstd_inputs):
    """More threads than cores over many small frames, the interpreter
    switching often: every output whole (each thread keeps its own
    decoder state)."""
    import sys

    zs = pytest.importorskip("zstandard")
    data = [zstd_inputs["fp32"][i * 997:(i + 1) * 997 + i] for i in range(24)]
    frames = [zs.ZstdCompressor(level=1 + i % 5).compress(d)
              for i, d in enumerate(data)] * 16
    sizes = [len(d) for d in data] * 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = zstd.decompress_many(frames, sizes, workers=32)
    finally:
        sys.setswitchinterval(old)
    assert [o.tobytes() for o in out] == data * 16


def test_crc32c_known_vectors():
    # RFC 3720 B.4 and the usual check value
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA
    assert zstd.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert zstd.crc32c(bytes(range(32))) == 0x46DD794E
    assert zstd.crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C
    assert zstd.crc32c(b"") == 0


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "zstd_decode.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(zstd, "SOURCE", bad)
    monkeypatch.setattr(zstd, "_lib", None)
    from sdbc_tpu_torch.ops import _kernels

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed.*error"):
        zstd.load()


# ------------------------------------------------- JAX-written directories


def _tiny_tree(cfg, seed: int) -> dict:
    import ml_dtypes

    tree = port_init_tree(cfg, seed)
    # the frozen VAE as its bf16 copy, the rest fp32, as a fine-tune saves
    return {k: _jnp(v, ml_dtypes.bfloat16 if k == "vae" else np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """Directories the JAX package's ``save_pipeline`` wrote: "tiny" (two
    ControlNet branches, an EMA shadow, a LoRA adapter, a TI embedding and
    an fp32 AdamW state with clipping beside the components) and "xl"
    (tiny_xl, with ``text_encoder_2``)."""
    from sdbc_tpu_torch.models.controlnet import init as cn_init
    from sdbc_tpu_torch.models.port import module_jax_tree

    root = tmp_path_factory.mktemp("jax_written")
    cfg = JCfg.tiny().with_controlnet()
    params = _tiny_tree(PipelineConfig.tiny(), 0)
    rng = np.random.default_rng(1)
    lora = {k: {x: (rng.standard_normal(v[x].shape) * 0.1).astype(np.float32)
                for x in "ab"}
            for k, v in jax.eval_shape(
                lambda p: jlora.init_lora(jax.random.key(1), p, 2, components=(
                    "unet", "text_encoder")), params).items()}
    rows = rng.standard_normal((2, cfg.clip.hidden)).astype(np.float32)
    ids = [cfg.clip.vocab_size, cfg.clip.vocab_size + 1]
    tcfg = jtrainer.TrainConfig(train_unet=True, train_text_encoder=True,
                                max_grad_norm=1.0)
    trainable = {k: params[k] for k in ("text_encoder", "unet")}
    opt = _random_state(jax.eval_shape(jtrainer.make_optimizer(tcfg).init,
                                       trainable), 2)
    ccfg = PipelineConfig.tiny().with_controlnet().controlnet
    branches = [_jnp(module_jax_tree(cn_init(
        ccfg, device="cpu", generator=torch.Generator().manual_seed(s))))
        for s in (5, 6)]
    out = {"tiny": str(root / "tiny"), "xl": str(root / "xl")}
    jckpt.save_pipeline(
        out["tiny"], {**params, "controlnet": branches}, cfg, opt_state=opt,
        metadata={"step": 5},
        ema={"unet": jax.tree.map(lambda x: np.asarray(x) * np.float32(0.5),
                                  params["unet"])},
        lora=lora, lora_rank=2, lora_alpha=4.0, ti=(rows, "<sty>", ids))
    jckpt.save_pipeline(out["xl"], _tiny_tree(PipelineConfig.tiny_xl(), 4),
                        JCfg.tiny_xl())
    return out


@pytest.fixture(scope="module")
def jax_read():
    """The JAX package's readers, each call made once per module."""
    memo = {}

    def read(fn, path, **kw):
        key = (fn.__name__, path, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = fn(path, **kw)
        return memo[key]

    return read


# ------------------------------------------------------------- (b) OCDBT


def _tensorstore_kv(path):
    ts = pytest.importorskip("tensorstore")
    return ts.KvStore.open(f"file://{os.path.abspath(path)}/|ocdbt:"
                           ).result()


def _assert_store_matches(path):
    kv = _tensorstore_kv(path)
    store = ocdbt.OcdbtStore(path)
    want = sorted(k.decode() for k in kv.list().result())
    assert store.keys() == want, path
    got = store.read_many(want)
    reads = [kv.read(key) for key in want]
    for key, value, read in zip(want, got, reads):
        assert value == read.result().value, (path, key)
    assert store.read(want[0]) == got[0]


def test_ocdbt_keys_and_bytes_match_tensorstore(jax_dirs):
    # chunks a shard (the fixture's FSDP-sharded UNet), the 8-bit state,
    # a list of branches, and a per-process database of its own
    for path in (os.path.join(FIXTURE, "unet"),
                 os.path.join(FIXTURE, "opt_state"),
                 os.path.join(jax_dirs["tiny"], "controlnet"),
                 os.path.join(FIXTURE, "unet", "ocdbt.process_0")):
        _assert_store_matches(path)


def test_ocdbt_interior_nodes_and_version_tree(tmp_path):
    """A database with a B+tree of height > 0, values inline and in data
    files, and versions in version-tree nodes (small nodes, arity 2, one
    commit a write)."""
    ts = pytest.importorskip("tensorstore")
    path = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 400,
                                     "version_tree_arity_log2": 1,
                                     "max_inline_value_bytes": 16}}
                         ).result()
    for i in range(60):
        kv.write(f"key{i % 7:02d}/{i:03d}", b"v%d" % i * (1 + i % 9)).result()
    _assert_store_matches(path)
    assert ocdbt.OcdbtStore(path).versions() == list(range(1, 62))


def test_ocdbt_refuses_a_damaged_manifest(tmp_path):
    path = str(tmp_path / "unet")
    shutil.copytree(os.path.join(FIXTURE, "unet"), path)
    mpath = os.path.join(path, "manifest.ocdbt")
    with open(mpath, "rb") as f:
        data = bytearray(f.read())
    data[20] ^= 1
    with open(mpath, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        ocdbt.OcdbtStore(path)
    with open(mpath, "wb") as f:
        f.write(bytes(data[:10]))
    with pytest.raises(ocdbt.OcdbtError, match="too short"):
        ocdbt.OcdbtStore(path)


# (shape, chunks, zarr dtype, zstd, fill value, the part written)
ZARR_CASES = {
    "ragged": ((7, 5, 3), (3, 2, 3), "<f4", True, None, None),
    "runs": ((10, 4), (4, 4), "<i4", True, None, None),
    "raw": ((9, 6), (4, 6), "<f2", False, None, None),
    "bf16": ((5, 6), (2, 4), "bfloat16", True, None, None),
    "missing": ((6, 4), (2, 2), "<f4", True, 1.5, (slice(0, 3), slice(1, 4))),
    "bool": ((11,), (4,), "|b1", False, None, None),
    "scalar": ((), (), "<f4", True, None, None),
}


@pytest.mark.parametrize("kvstore", ["ocdbt", "file"])
def test_zarr_chunk_grid_matches_tensorstore(tmp_path, kvstore):
    """Arrays tensorstore's zarr v2 driver wrote, read back by
    ``zarr.read_arrays``: edge chunks cropped in every dimension, chunks
    that are whole runs of rows (decoded in place) with a ragged last run,
    uncompressed chunks, unwritten chunks holding the fill value, and a 0-d
    array; in an OCDBT database and as files under a directory."""
    ts = pytest.importorskip("tensorstore")
    path = str(tmp_path / "tree")
    base = ({"driver": "ocdbt", "base": f"file://{path}/"}
            if kvstore == "ocdbt" else {"driver": "file", "path": path})
    rng = np.random.default_rng(7)
    want = {}
    for name, (shape, chunks, dtype, comp, fill, part) in ZARR_CASES.items():
        meta = {"shape": list(shape), "chunks": list(chunks), "dtype": dtype,
                "compressor": {"id": "zstd", "level": 1} if comp else None,
                "fill_value": fill, "dimension_separator": "."}
        arr = ts.open({"driver": "zarr", "kvstore": base, "path": name,
                       "metadata": meta, "create": True}).result()
        data = rng.standard_normal(shape)
        data = (data > 0 if dtype == "|b1" else
                (data * 1000).astype(np.int32) if dtype == "<i4" else
                data.astype(arr.dtype.numpy_dtype))
        sl = part or ()
        arr[sl].write(data[sl]).result()
        full = np.full(shape, fill if fill is not None else 0,
                       arr.dtype.numpy_dtype)
        full[sl] = data[sl]
        want[name] = full
    store = (ocdbt.OcdbtStore(path) if kvstore == "ocdbt"
             else zarr.DirStore(path))
    got = zarr.read_arrays(store, list(ZARR_CASES))
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == zarr.DTYPES[ZARR_CASES[name][2]][0], name
        np.testing.assert_array_equal(_bits(got[name]), _bits(w), name)
    assert "missing/2.0" not in store


# ---------------------------------------------------- (c) the slice's readers


NO_OVERLAY = dict(use_ema=False, merge_lora=False, merge_ti=False)


@pytest.mark.parametrize("kind", ["plain", "ema lora ti", "xl"])
def test_load_pipeline_matches_jax(jax_dirs, jax_read, kind):
    """The components as saved (the ControlNet branches a list), with the
    EMA overlay, LoRA merge and TI merge each package applies, and a
    tiny_xl save's ``text_encoder_2`` (``load_ema`` alone: the fixture's
    test)."""
    path = jax_dirs["xl" if kind == "xl" else "tiny"]
    kw = NO_OVERLAY if kind == "plain" else {}
    want, wcfg = jax_read(jckpt.load_pipeline, path, **kw)
    got, gcfg = tckpt.load_pipeline(path, **kw)
    _models_vs_jax(got, want, kind)
    assert tckpt.config_to_json(gcfg) == jckpt.config_to_json(wcfg)
    if kind == "plain":
        assert isinstance(got["controlnet"], list) \
            and len(got["controlnet"]) == 2
    elif kind == "xl":
        assert "text_encoder_2" in got


def test_load_opt_state_fp32_adamw_matches_jax(jax_dirs, jax_read):
    path = jax_dirs["tiny"]
    kw = dict(train_unet=True, train_text_encoder=True, max_grad_norm=1.0)
    models, _ = tckpt.load_pipeline(path, **NO_OVERLAY)
    del models["controlnet"]
    state = ttrainer.init_train_state(models, ttrainer.TrainConfig(**kw),
                                      compute_dtype=torch.float32,
                                      device="cpu")
    back = tckpt.load_opt_state(path, state.opt_state, state.trainable, 1.0)
    params, _ = jax_read(jckpt.load_pipeline, path, **NO_OVERLAY)
    trainable = {k: params[k] for k in ("text_encoder", "unet")}
    want = jckpt.load_opt_state(path, _shapes(
        jtrainer.make_optimizer(jtrainer.TrainConfig(**kw)).init, trainable))
    _assert_bit_equal(_port_flat(tckpt.opt_state_tree(back, state.trainable,
                                                      1.0)),
                      _jax_flat(want), "opt_state")


@pytest.fixture(scope="module")
def fixture_digests():
    with open(os.path.join(FIXTURE, "digests.json")) as f:
        return json.load(f)


def _assert_digests(flat: dict, want: dict, what: str) -> None:
    assert set(flat) == set(want), (what, sorted(set(flat) ^ set(want))[:6])
    for k, w in want.items():
        t = flat[k]
        assert _dtype(t) == w["dtype"] and list(t.shape) == w["shape"], \
            (what, k)
        digest = hashlib.sha256(_bits(t).tobytes()).hexdigest()
        assert digest == w["sha256"], (what, k)


def _fixture_train(trainable_only=False):
    with open(os.path.join(FIXTURE, "fixture.json")) as f:
        train = json.load(f)["train"]
    keys = ("train_unet", "train_text_encoder", "use_8bit_adam",
            "ema_decay")
    return {k: train[k] for k in keys} if trainable_only else train


@pytest.fixture(scope="module")
def jax_fixture(jax_read):
    """The JAX package's reads of the fixture: the components without the
    EMA overlay, the optimizer state (onto the shapes of ``opt.init`` of
    its trainable set), and that TrainConfig."""
    params, _ = jax_read(jckpt.load_pipeline, FIXTURE, use_ema=False)
    jt = jtrainer.TrainConfig(**_fixture_train(True))
    opt = jckpt.load_opt_state(FIXTURE, _shapes(
        jtrainer.make_optimizer(jt).init,
        {"text_encoder": params["text_encoder"]}))
    return params, opt, jt


def test_fixture_reads_bit_for_bit(fixture_digests, jax_fixture, jax_read):
    """The mesh-sharded fixture: every tree's leaves against the digests
    the JAX tree gave before the save, and the port's readers against the
    JAX package's on it (the 8-bit codes and scales, the EMA)."""
    for comp, want in fixture_digests.items():
        tree = tckpt.read_tree(os.path.join(FIXTURE, comp))
        _assert_digests({".".join(k for k, _ in key): t
                         for key, t in tree.items()}, want, comp)
    params, jopt, _ = jax_fixture
    got, _ = tckpt.load_pipeline(FIXTURE, use_ema=False)
    _models_vs_jax(got, params, "fixture")
    _models_vs_jax(tckpt.load_ema(FIXTURE), jax_read(jckpt.load_ema,
                                                     FIXTURE), "fixture ema")
    tcfg = ttrainer.TrainConfig(**_fixture_train(True))
    state = ttrainer.init_train_state(got, tcfg, compute_dtype=torch.float32,
                                      device="cpu")
    back = tckpt.load_opt_state(FIXTURE, state.opt_state, state.trainable,
                                0.0)
    _assert_bit_equal(_port_flat(tckpt.opt_state_tree(back, state.trainable,
                                                      0.0)),
                      _jax_flat(jopt), "fixture opt_state")


# ----------------------------------------------------- (d) sampling from it


def test_fixture_samples_as_jax(jax_read):
    """DDIM-2 with injected latents from the fixture, each package loading
    it (the EMA overlaid) with its own reader: the goldens' pipeline
    tolerance."""
    params, jcfg = jax_read(jckpt.load_pipeline, FIXTURE)
    models, cfg = tckpt.load_pipeline(FIXTURE)
    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    cond = np.asarray(tok.batch_encode(["a gothic novel cover", "a cookbook"],
                                       cfg.clip.ctx), np.int32)
    uncond = np.asarray(tok.batch_encode(["", ""], cfg.clip.ctx), np.int32)
    lat = np.random.default_rng(7).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    ref = jgraph.sample(params, jnp.asarray(cond), jnp.asarray(uncond),
                        jnp.asarray(lat), jax.random.key(0), 7.5, cfg=jcfg,
                        num_inference_steps=2, compute_dtype=jnp.float32,
                        chunked_decode=True)
    out = tgraph.sample(models, torch.from_numpy(cond).long(),
                        torch.from_numpy(uncond).long(),
                        torch.from_numpy(lat), 7.5, cfg=cfg,
                        num_inference_steps=2, compute_dtype=torch.float32)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=IMAGE_ATOL)


# ----------------------------------------------------------- (e) --resume


@contextlib.contextmanager
def _first_state():
    """Wrap ``trainer.make_train_step``: the optimizer tree and step the
    CLI's first step sees, copied before the step."""
    seen = {}
    real = ttrainer.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, *args, **kwargs):
            if "step" not in seen:
                seen["step"] = state.step
                seen["opt"] = {k: t.clone() for k, t in _port_flat(
                    tckpt.opt_state_tree(state.opt_state, state.trainable,
                                         0.0)).items()}
                seen["ema"] = {c: {k: t.clone() for k, t in _port_flat(
                    tckpt.module_tree(m)).items()}
                    for c, m in state.ema.items()}
            return step(state, *args, **kwargs)

        return wrapped

    ttrainer.make_train_step = make
    try:
        yield seen
    finally:
        ttrainer.make_train_step = real


def test_finetune_cli_resumes_a_jax_run(tmp_path, fixture_digests,
                                        jax_fixture):
    from sdbc_tpu_torch.cli import finetune
    from tests.data_fixtures import build_fake_dataset

    with open(os.path.join(FIXTURE, "metadata.json")) as f:
        step = json.load(f)["step"]
    out = tmp_path / "out"
    shutil.copytree(FIXTURE, out / "runs" / "jax" / f"ckpt-{step}")
    data = build_fake_dataset(str(tmp_path / "ds"), 2, 2)
    train = _fixture_train()
    flags = ["--tiny", "--device", "cpu", "--no-bf16", "--data_root", data,
             "--output_dir", str(out), "--run_id", "jax", "--resume",
             "--num_examples", "2", "--batch_size", "2", "--grad_acc_steps",
             "1", "--epochs", str(step + 1), "--ckpts_per_epoch", "1",
             "--num_workers", "1", "--learning_rate",
             str(train["learning_rate"]), "--ema_decay",
             str(train["ema_decay"]), "--use_8bit_adam",
             "--no-train_unet", "--train_text_encoder"]
    with _first_state() as seen:
        stats = finetune.main(flags)
    assert seen["step"] == step
    assert len(stats["losses"]) == 1 and np.isfinite(stats["losses"][0])
    # the optimizer state the step saw is the JAX package's load, bit for bit
    params, want, jt = jax_fixture
    _assert_bit_equal(seen["opt"], _jax_flat(want), "resumed opt_state")
    _assert_digests({".".join(k): t for k, t in seen["opt"].items()},
                    fixture_digests["opt_state"], "resumed opt_state")
    _assert_digests({".".join((c,) + k): t for c, tree in seen["ema"].items()
                     for k, t in tree.items()},
                    fixture_digests["ema"], "resumed ema")
    # the port's checkpoint after the step restores in the JAX package, the
    # one-layer tower's fp32 moments in the JAX tree's stacked shape
    final = tckpt.new_checkpoint_path(str(out), "jax", step + 1)
    again = _jax_flat(jckpt.load_opt_state(final, _shapes(
        jtrainer.make_optimizer(jt).init,
        {"text_encoder": params["text_encoder"]})))
    assert {k: np.shape(v) for k, v in again.items()} == \
        {k: np.shape(v) for k, v in _jax_flat(want).items()}
    assert [int(v) for k, v in again.items() if k[-1] == "count"] == \
        [step + 1]


def test_one_layer_tower_state_in_the_layer_shape_loads(tmp_path):
    """The fixture's one-layer text encoder keeps its 8-bit state's small
    fp32 moments stacked, (1, …), as the JAX tree does; a port checkpoint
    holding them in the layer's own shape, as the port wrote them before,
    loads into the same state."""
    models, _ = tckpt.load_pipeline(FIXTURE, use_ema=False)
    tc = ttrainer.TrainConfig(**_fixture_train(True))
    fresh = lambda: ttrainer.init_train_state(
        models, tc, compute_dtype=torch.float32, device="cpu")
    state = fresh()
    want = tckpt.load_opt_state(FIXTURE, state.opt_state, state.trainable,
                                tc.max_grad_norm)
    leaves, lowered = [], 0
    for key, t in tckpt.opt_state_tree(want, state.trainable,
                                       tc.max_grad_norm):
        if key[-1][0] in ("m", "v") and t.dim() > 1 and t.shape[0] == 1:
            t, lowered = t[0], lowered + 1
        leaves.append((key, t))
    assert lowered > 0
    path = str(tmp_path / "ck")
    tckpt.write_tree(os.path.join(path, "opt_state"), leaves)
    state = fresh()
    got = tckpt.load_opt_state(path, state.opt_state, state.trainable,
                               tc.max_grad_norm)
    assert got.inner.count == want.inner.count
    for a, b in zip(got.inner.per_leaf, want.inner.per_leaf):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name))


# ----------------------------------------------------------- (f) refusal


def test_zarr3_tree_is_refused(tmp_path):
    path = str(tmp_path / "vae")
    shutil.copytree(os.path.join(FIXTURE, "vae"), path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    meta["use_zarr3"] = True
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(zarr.ZarrError, match="zarr3"):
        tckpt.read_tree(path)
