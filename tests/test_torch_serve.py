"""The port's serving daemon (``sdbc_tpu_torch/cli/serve.py``) at the tiny
config on the CPU, on an ephemeral port with a stdlib client, mirroring
``tests/test_serve.py``'s surface; and its stdlib PNG codec
(``sdbc_tpu_torch/utils/png.py``) against PIL.

A lone request's pixels equal the port's ``SDPipeline.generate`` on the same
seed and spec exactly (that ``generate`` is held to JAX in
``tests/test_torch_generate.py``); a coalesced batch's equal one direct call
on the jobs' own noise exactly; the PNG codec's pixels equal PIL's
exactly."""
import base64
import contextlib
import io
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from sdbc_tpu.cli import serve as jserve
from sdbc_tpu_torch.cli import common
from sdbc_tpu_torch.cli import serve
from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
from sdbc_tpu_torch.diffusion.spec import SampleSpec
from sdbc_tpu_torch.train import lora as tlora
from sdbc_tpu_torch.utils import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--tiny", "--device", "cpu", "--no-bf16", "--num_inference_steps",
        "2", "--max_batch", "4"]
SPEC = SampleSpec(height=32, width=32, num_inference_steps=2)


def _args(*extra):
    args = serve.build_parser().parse_args(BASE + list(extra))
    common.refuse_unported(args)
    common.resolve_img_size(args)
    return args


@pytest.fixture(scope="module")
def pipe():
    models, cfg = common.resolve_params_cfg(_args())
    return SDPipeline(models, cfg, common.make_tokenizer(_args(), 1000),
                      device="cpu", compute_dtype=torch.float32)


@contextlib.contextmanager
def serving(pipe, *extra, lora_pipes=None):
    from http.server import ThreadingHTTPServer

    handler, state = serve.make_app(pipe, _args(*extra),
                                    lora_pipes=lora_pipes)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", state
    finally:
        srv.shutdown()
        srv.server_close()
        handler.close()
        t.join(timeout=10)


@pytest.fixture(scope="module")
def server(pipe):
    with serving(pipe) as s:
        yield s


def _post(url, payload):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.headers["Content-Type"], r.read()


def _image(url, payload) -> np.ndarray:
    ctype, body = _post(url, payload)
    assert ctype == "image/png" and body[:8] == png.SIGNATURE
    return png.decode(body)


def _error(url, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, payload)
    return ei.value.code, json.loads(ei.value.read())["error"], \
        ei.value.headers


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        return json.loads(r.read())


def _u8(imgs):
    return np.uint8(np.round(np.asarray(imgs) * 255.0))


def _concurrently(fn, items):
    out, threads = {}, []
    for i, item in enumerate(items):
        def run(i=i, item=item):
            try:
                out[i] = fn(item)
            except urllib.error.HTTPError as e:
                out[i] = e.code
        threads.append(threading.Thread(target=run))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return [out[i] for i in range(len(items))]


def test_healthz_and_lone_png_equals_generate(server, pipe):
    url, state = server
    body = _healthz(url)
    assert body["ok"] is True and body["lora_adapters"] == []
    for key in ("requests", "errors", "busy", "batches", "batched_images",
                "started", "pending_jobs", "rejected_overload", "timed_out",
                "latency_p50_s", "latency_p95_s"):
        assert key in body
    a = _image(url, {"prompt": "a tiny cover", "seed": 7})
    want = _u8(pipe.generate(["a tiny cover"], SPEC.replace(seed=7)))[0]
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(
        _image(url, {"prompt": "a tiny cover", "seed": 7}), a)
    assert not np.array_equal(
        _image(url, {"prompt": "a tiny cover", "seed": 8}), a)
    assert state["requests"] >= 3


def test_batch_answers_base64(server, pipe):
    url, _ = server
    ctype, body = _post(url, {"prompt": "two covers", "num_images": 2,
                              "seed": 3})
    assert ctype == "application/json"
    imgs = [png.decode(base64.b64decode(x))
            for x in json.loads(body)["images"]]
    want = _u8(pipe.generate(["two covers"], SPEC.replace(
        seed=3, num_images_per_prompt=2)))
    np.testing.assert_array_equal(np.stack(imgs), want)


def test_bad_requests_and_unknown_paths(server):
    url, _ = server
    for payload, msg in (({}, "prompt"),
                         ({"prompt": "x", "num_images": 99}, "num_images"),
                         ({"prompt": "x", "num_images": "many"}, "int"),
                         ({"prompt": "x", "size": 48}, "size")):
        code, err, _ = _error(url, payload)
        assert code == 400 and msg in err
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert ei.value.code == 404
    req = urllib.request.Request(url + "/nope", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 404
    assert _healthz(url)["ok"]


def test_compatible_requests_coalesce_into_one_batch(pipe):
    """Three compatible requests inside the window: one batch of 3, each on
    its own seed's noise (the pipeline's draw for a lone call, over its
    bucket), exactly one direct call on those latents."""
    seeds = [1, 2, 3]
    with serving(pipe, "--batch_window_ms", "1500") as (url, state):
        got = _concurrently(lambda s: _image(url, {"prompt": "coalesce me",
                                                   "seed": s}), seeds)
        assert state["batches"] == 1 and state["batched_images"] == 3
    assert not np.array_equal(got[0], got[1])
    jobs = [serve._Job("coalesce me", "", 1, 2, 7.5, 0.0, False, s, 32)
            for s in seeds]
    lat = torch.cat([serve.job_latents(pipe, j) for j in jobs])
    want = _u8(pipe(["coalesce me"] * 3, height=32, width=32,
                    num_inference_steps=2, latents=lat, seed=1))
    # the batch's order is its queue's: match the images as a set
    assert sorted(map(bytes, got)) == sorted(map(bytes, want))
    gen = torch.Generator().manual_seed(5)
    three = serve._Job("p", "", 3, 2, 7.5, 0.0, False, 5, 32)
    np.testing.assert_array_equal(
        serve.job_latents(pipe, three),
        pipe._latents(None, 3, 32, 32, gen, bucket=4)[:3])


def test_incompatible_requests_stay_apart(pipe):
    with serving(pipe, "--batch_window_ms", "1500") as (url, state):
        got = _concurrently(lambda steps: _image(url, {
            "prompt": "split us", "seed": 1,
            "num_inference_steps": steps}), [2, 3])
        assert len(got) == 2 and state["batches"] == 2


def test_img2img_inpaint_and_their_checks(server, pipe):
    url, _ = server
    rng = np.random.default_rng(3)
    init = rng.integers(0, 256, (32, 32, 3), np.uint8)
    b64 = base64.b64encode(png.encode(init)).decode()
    got = _image(url, {"prompt": "redraw", "seed": 5, "init_image": b64,
                       "strength": 0.5})
    want = _u8(pipe.generate(["redraw"], SPEC.replace(
        seed=5, init_image=init[None].astype(np.float32) / 255.0,
        strength=0.5)))[0]
    np.testing.assert_array_equal(got, want)
    mask = np.zeros((32, 32), np.uint8)
    mask[:, 16:] = 255
    b64m = base64.b64encode(_filtered_png(mask, [0])).decode()
    got = _image(url, {"prompt": "inpaint", "seed": 5, "init_image": b64,
                       "mask_image": b64m, "strength": 0.5})
    want = _u8(pipe.generate(["inpaint"], SPEC.replace(
        seed=5, init_image=init[None].astype(np.float32) / 255.0,
        mask_image=mask[None].astype(np.float32) / 255.0,
        strength=0.5)))[0]
    np.testing.assert_array_equal(got, want)
    for payload, msg in (
            ({"prompt": "x", "mask_image": b64m}, "init_image"),
            ({"prompt": "x", "init_image": b64, "strength": 2.0},
             "strength"),
            ({"prompt": "x", "init_image": "!!notbase64!!"}, "decode"),
            ({"prompt": "x", "init_image": base64.b64encode(
                png.encode(init)[:60]).decode()}, "decode")):
        code, err, _ = _error(url, payload)
        assert code == 400 and msg in err


def test_pil_decodes_a_jpeg_and_another_size(server):
    """A JPEG init, and a PNG of another size, go through PIL as the JAX
    daemon decodes them (convert, then bicubic / nearest to the size)."""
    from PIL import Image

    url, _ = server
    rng = np.random.default_rng(4)
    big = Image.fromarray(rng.integers(0, 256, (48, 48, 3), np.uint8))
    for fmt in ("JPEG", "PNG"):
        buf = io.BytesIO()
        big.save(buf, format=fmt)
        want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert(
            "RGB").resize((32, 32), Image.BICUBIC), np.float32) / 255.0
        got = serve.decode_image(base64.b64encode(buf.getvalue()).decode(),
                                 32, "RGB")
        np.testing.assert_array_equal(got, want)
    small = Image.fromarray(rng.integers(0, 256, (16, 16), np.uint8))
    buf = io.BytesIO()
    small.save(buf, format="PNG")
    np.testing.assert_array_equal(
        serve.decode_image(base64.b64encode(buf.getvalue()).decode(), 32,
                           "L"),
        np.asarray(small.resize((32, 32), Image.NEAREST), np.float32) / 255)
    buf = io.BytesIO()
    big.save(buf, format="JPEG")
    _image(url, {"prompt": "from a jpeg", "size": 32, "init_image":
                 base64.b64encode(buf.getvalue()).decode()})


def test_hires_and_its_checks(server):
    url, _ = server
    assert _image(url, {"prompt": "big", "seed": 5, "hires_scale": 2.0,
                        "hires_strength": 0.6, "hires_steps": 2}
                  ).shape == (32, 32, 3)
    init = base64.b64encode(png.encode(np.zeros((32, 32, 3),
                                                np.uint8))).decode()
    for payload, msg in (
            ({"prompt": "x", "hires_scale": 1.0}, "hires_scale"),
            ({"prompt": "x", "hires_scale": 2.0, "hires_strength": 2.0},
             "hires_strength"),
            ({"prompt": "x", "hires_scale": 2.0, "init_image": init},
             "init_image")):
        code, err, _ = _error(url, payload)
        assert code == 400 and msg in err


def test_lora_bank(pipe, tmp_path):
    """A named adapter gives its merged pipeline's image, unlike the
    base's; unknown names are 400s; the adapter's copy leaves the base."""
    lora = tlora.init_lora(torch.Generator().manual_seed(1), pipe.models,
                           2, components=("unet", "text_encoder"))
    gen = torch.Generator().manual_seed(2)
    lora = {k: {"a": v["a"], "b": torch.randn(v["b"].shape, generator=gen)
                * 0.05} for k, v in lora.items()}
    path = str(tmp_path / "style.npz")
    tlora.save_lora(path, lora, 2, 4.0)
    merged = tlora.merge_file(pipe.models, path)
    assert merged["vae"] is pipe.models["vae"]
    styled = SDPipeline(merged, pipe.cfg, pipe.tokenizer, device="cpu",
                        compute_dtype=torch.float32)
    with serving(pipe, "--lora_bank", f"style={path}",
                 lora_pipes={"style": styled}) as (url, _):
        base = _image(url, {"prompt": "a cover", "seed": 3})
        got = _image(url, {"prompt": "a cover", "seed": 3, "lora": "style"})
        assert not np.array_equal(base, got)
        np.testing.assert_array_equal(got, _u8(styled.generate(
            ["a cover"], SPEC.replace(seed=3)))[0])
        code, err, _ = _error(url, {"prompt": "x", "lora": "nope"})
        assert code == 400 and "unknown lora adapter" in err
        assert _healthz(url)["lora_adapters"] == ["style"]


def test_per_request_scheduler(server, pipe):
    url, _ = server
    base = _image(url, {"prompt": "solver pick", "seed": 5})
    heun = _image(url, {"prompt": "solver pick", "seed": 5,
                        "scheduler": "heun"})
    import dataclasses

    view = SDPipeline(pipe.models, dataclasses.replace(pipe.cfg,
                                                       scheduler="heun"),
                      pipe.tokenizer, device="cpu",
                      compute_dtype=torch.float32)
    assert not np.array_equal(base, heun)
    np.testing.assert_array_equal(heun, _u8(view.generate(
        ["solver pick"], SPEC.replace(seed=5)))[0])
    np.testing.assert_array_equal(
        _image(url, {"prompt": "solver pick", "seed": 5,
                     "scheduler": "ddim"}), base)
    code, err, _ = _error(url, {"prompt": "x", "scheduler": "plms9000"})
    assert code == 400 and "unknown scheduler" in err


def test_healthz_latency_percentiles(pipe):
    with serving(pipe) as (url, _):
        h = _healthz(url)
        assert h["latency_p50_s"] is None and h["requests"] == 0
        _image(url, {"prompt": "a cover"})
        _image(url, {"prompt": "a cover", "seed": 1})
        h = _healthz(url)
    assert h["latency_p50_s"] is not None and h["latency_p50_s"] >= 0
    assert h["latency_p95_s"] >= h["latency_p50_s"]


# --controlnet_path is ported (tests/test_torch_controlnet.py): its case
# holds the refusal of a missing dir
@pytest.mark.parametrize("flags,what", [
    (["--wandb_artifact_run", "run"], "wandb.*not ported yet"),
    (["--controlnet_path", "cn"], "--controlnet_path cn: no ControlNet")])
def test_serve_refuses_unported_flags(flags, what):
    with pytest.raises(SystemExit, match=f"(?s){what}"):
        serve.main(BASE + flags)


def test_serve_loads_a_port_checkpoint(pipe, tmp_path):
    """--ckpt (a port checkpoint, utils/checkpoint.py) serves the weights
    it holds."""
    from sdbc_tpu_torch.utils import checkpoint as ckpt

    path = str(tmp_path / "ck")
    ckpt.save_pipeline(path, pipe.models, pipe.cfg)
    loaded, _ = serve.load_pipelines(_args("--ckpt", path))
    for name, m in pipe.models.items():
        for (n, a), b in zip(m.state_dict().items(),
                             loaded.models[name].state_dict().values()):
            assert torch.equal(a, b), (name, n)


@pytest.mark.parametrize("kw", [
    {}, {"seed": 9}, {"steps": 3}, {"gs": 5.0}, {"gr": 0.7}, {"pw": True},
    {"size": 64}, {"init": np.zeros(1)}, {"init": np.zeros(1), "mask": 1},
    {"init": np.zeros(1), "strength": 0.31},
    {"hires": (2.0, 0.7, 0)}, {"hires": (2.0, 0.7, 0), "seed": 9},
    {"lora": "style"}, {"scheduler": "heun"}])
def test_job_key_matches_jax(kw):
    args = dict(prompt="p", neg="", n=1, steps=2, gs=7.5, gr=0.0, pw=False,
                seed=1, size=32)
    args.update(kw)
    assert serve._Job(**args).key() == jserve._Job(**args).key()
    base = dict(prompt="q", neg="n", n=2, steps=2, gs=7.5, gr=0.0,
                pw=False, seed=1, size=32)
    same = serve._Job(**args).key() == serve._Job(**base).key()
    assert same == (jserve._Job(**args).key() == jserve._Job(**base).key())


def test_admission_bound_answers_503(pipe):
    with serving(pipe, "--batch_window_ms", "1000",
                 "--max_pending", "2") as (url, state):
        got = _concurrently(lambda s: _post(url, {"prompt": "load",
                                                  "seed": s}), [1, 2, 3])
        codes = sorted(g if isinstance(g, int) else 200 for g in got)
        assert codes == [200, 200, 503]
        assert state["rejected_overload"] == 1
        assert state["pending_jobs"] == 0
        req = urllib.request.Request(url + "/generate", data=b"{}")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(req, timeout=30)


def test_expired_request_answers_504_and_is_dropped(pipe):
    with serving(pipe, "--batch_window_ms", "600",
                 "--request_timeout_s", "0.05") as (url, state):
        code, err, _ = _error(url, {"prompt": "late"})
        assert code == 504 and "request_timeout_s" in err
        deadline = time.monotonic() + 10
        while state["pending_jobs"] and time.monotonic() < deadline:
            time.sleep(0.05)
        assert state["timed_out"] == 1 and state["pending_jobs"] == 0
        assert state["batches"] == 0


def test_failed_batch_setup_answers_500_and_frees_its_slots(pipe,
                                                            monkeypatch):
    """Two img2img jobs coalesce; one init image decodes to another shape,
    so stacking the batch's images raises before generation: both waiters
    get 500, their slots are freed and the next request is served.  A seed
    no generator takes fails the same way."""
    real = serve.decode_image

    def decode(b64, size, mode):
        """A base64 string with a trailing space decodes to half the
        height."""
        img = real(b64.strip(), size, mode)
        return img[:size // 2] if b64.endswith(" ") else img

    monkeypatch.setattr(serve, "decode_image", decode)
    init = base64.b64encode(png.encode(np.zeros((32, 32, 3),
                                                np.uint8))).decode()
    with serving(pipe, "--batch_window_ms", "1500",
                 "--max_pending", "2") as (url, state):
        got = _concurrently(lambda odd: _post(url, {
            "prompt": "x", "init_image": init + odd}), ["", " "])
        assert got == [500, 500]
        assert state["pending_jobs"] == 0 and state["batches"] == 1
        code, err, _ = _error(url, {"prompt": "x", "seed": 2 ** 70})
        assert code == 500 and "Overflow" in err
        assert _image(url, {"prompt": "next"}).shape == (32, 32, 3)
        assert state["pending_jobs"] == 0 and state["batches"] == 3


# ---------------------------------------------------------------------------
# the PNG codec


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of ``img`` whose row y uses filter type
    filters[y % len(filters)] (written here, decoded by PIL and the port)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    out, prev = bytearray(), np.zeros(w * ch, np.int32)
    for y in range(h):
        cur, ft = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - left
        elif ft == 2:
            f = cur - prev
        elif ft == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = cur - pred
        out += bytes([ft]) + (f % 256).astype(np.uint8).tobytes()
        prev = cur
    color = {1: 0, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    chunk = lambda k, d: (struct.pack(">I", len(d)) + k + d + struct.pack(
        ">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(13, 11), (13, 11, 3), (13, 11, 4)],
                         ids=["L", "RGB", "RGBA"])
def test_png_codec_matches_pil(shape):
    from PIL import Image

    rng = np.random.default_rng(len(shape))
    img = rng.integers(0, 256, shape, np.uint8)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        data = _filtered_png(img, filters)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), img)  # a valid PNG
        np.testing.assert_array_equal(png.decode(data), img)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(png.decode(buf.getvalue()), img)
    for mode in ("L", "RGB"):
        np.testing.assert_array_equal(
            png.convert(img, mode),
            np.asarray(Image.fromarray(img).convert(mode)))
    if len(shape) == 3 and shape[2] == 3:
        enc = png.encode(img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
            enc))), img)
        np.testing.assert_array_equal(png.decode(enc), img)


def test_png_refusals():
    from PIL import Image

    for mode, arr in (("P", np.zeros((4, 4), np.uint8)),
                      ("I;16", np.zeros((4, 4), np.uint16))):
        buf = io.BytesIO()
        Image.fromarray(arr, mode=mode if mode == "P" else None).save(
            buf, format="PNG")
        with pytest.raises(png.PNGUnsupported):
            png.decode(buf.getvalue())
    data = bytearray(png.encode(np.zeros((4, 4, 3), np.uint8)))
    data[-20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a...")
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            png.encode(bad)
    with pytest.raises(ValueError, match="only L and RGB"):
        png.convert(np.zeros((4, 4), np.uint8), "RGBA")


_NO_PIL = r'''
import base64, importlib.abc, json, sys, threading, urllib.error
import urllib.request

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
from http.server import ThreadingHTTPServer
import numpy as np, torch
from sdbc_tpu_torch.cli import common, serve
from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
from sdbc_tpu_torch.utils import png
from tests.torch_threads import one_thread  # noqa: F401

args = serve.build_parser().parse_args(sys.argv[2:])
common.resolve_img_size(args)
models, cfg = common.resolve_params_cfg(args)
pipe = SDPipeline(models, cfg, common.make_tokenizer(args, 1000),
                  device="cpu", compute_dtype=torch.float32)
handler, _ = serve.make_app(pipe, args)
srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
threading.Thread(target=srv.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{srv.server_address[1]}/generate"
init = base64.b64encode(png.encode(np.full((32, 32, 3), 90, np.uint8)))
jpeg = base64.b64encode(open(sys.argv[1], "rb").read())
out = {}
for name, req in (("png", {"prompt": "a cover"}),
                  ("img2img", {"prompt": "a cover",
                               "init_image": init.decode()}),
                  ("jpeg", {"prompt": "a cover",
                            "init_image": jpeg.decode()})):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=json.dumps(req).encode()), timeout=120) as r:
            out[name] = [r.status, png.decode(r.read()).shape]
    except urllib.error.HTTPError as e:
        out[name] = [e.code, json.loads(e.read())["error"]]
srv.shutdown()
handler.close()
out["pil_loaded"] = any(m.split(".")[0] == "PIL" for m in sys.modules)
print(json.dumps(out))
'''


def test_daemon_png_path_runs_without_pil(tmp_path):
    """In a process where PIL cannot be imported: a PNG answer and a base64
    PNG img2img request are served, a JPEG init answers 400 naming PIL."""
    from PIL import Image

    jpeg = str(tmp_path / "init.jpg")
    Image.fromarray(np.full((32, 32, 3), 90, np.uint8)).save(jpeg)
    out = subprocess.run(
        [sys.executable, "-c", _NO_PIL, jpeg] + BASE,
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["png"] == [200, [32, 32, 3]]
    assert res["img2img"] == [200, [32, 32, 3]]
    assert res["jpeg"][0] == 400 and "PIL" in res["jpeg"][1]
    assert res["pil_loaded"] is False
