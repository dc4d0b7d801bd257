"""HTTP serving daemon (counterpart of ``sdbc_tpu/cli/serve.py``): the
resident pipeline served over plain HTTP, stdlib only, on the card unless
``--device cpu``.

    POST /generate   {"prompt": "...", ["negative_prompt"], ["seed"],
                      ["num_inference_steps"], ["guidance_scale"],
                      ["guidance_rescale"], ["num_images"], ["size"],
                      ["prompt_weighting"], ["init_image" (base64 PNG/JPEG)],
                      ["strength"], ["mask_image" (base64, white=inpaint)],
                      ["hires_scale"], ["hires_strength"], ["hires_steps"],
                      ["lora" (adapter name from --lora_bank)],
                      ["scheduler" (per-request solver)]}
        → image/png (one image) or JSON {"images": [base64 png, ...]}
    GET  /healthz    → {"ok": true, "requests": N, "batches": M, ...}

    python -m sdbc_tpu_torch.cli.serve --scheduler dpm \\
        --num_inference_steps 25 --diffusers_ckpt ./sd15

Dynamic batching: one batcher thread coalesces queued jobs with equal
``_Job.key()`` (FIFO, up to --max_batch images) into one
``SDPipeline.generate`` call; --batch_window_ms waits that long after a job
arrives for more.  A coalesced job keeps its own seed's initial noise: the
noise ``SDPipeline`` draws for a lone call of that job (a
``torch.Generator`` seeded with it, over the job's batch bucket, the first
n rows).  A lone job passes no noise, so the pipeline draws it and the
stochastic schedulers' noise from its seed exactly as a direct call does:
a lone request reproduces ``pipe.generate(prompt, SampleSpec(seed=...))``
pixel for pixel.  A batch whose setup or generation raises answers 500 to
each of its waiters and frees their admission slots; the batcher goes on.

Answers are encoded by ``utils/png.py`` (no PIL).  Init images and masks
that are 8-bit L/RGB/RGBA PNGs of the request size are decoded there too;
a JPEG, or a PNG of another size or kind, goes through PIL as in the JAX
daemon (bicubic for the image, nearest for the mask), and where PIL is not
installed the request answers 400 naming it.

``--model_family sd21|sdxl`` serves a fresh init of that family (a
checkpoint brings its own); ``--refiner_ckpt`` serves the SDXL base →
refiner ensemble (``diffusion/ensemble.py``; no per-request scheduler, no
hires, no --lora_bank under it).  --lora_bank, --lora_path and --ti_path
on an SDXL model, and the flags of other unported features, exit naming
their feature.
"""
from __future__ import annotations

import argparse
import base64
import binascii
import collections
import dataclasses
import io
import json
import queue as queue_mod
import threading
import time
import traceback

import numpy as np
import torch

from sdbc_tpu_torch.cli import common
from sdbc_tpu_torch.utils import png


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_args(p)
    common.add_img_size_arg(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--cache_interval", type=int, default=0,
                   help="DeepCache interval for the serving profile "
                        "(ddim/dpm; 0 = exact)")
    p.add_argument("--cache_tail", type=int, default=0)
    p.add_argument("--max_batch", type=int, default=4,
                   help="largest num_images per request AND the dynamic "
                        "batcher's coalescing cap")
    p.add_argument("--allowed_sizes", type=str, default="",
                   help="comma-separated square sizes accepted via the "
                        "request 'size' field (default: --img_size only)")
    p.add_argument("--batch_window_ms", type=int, default=0,
                   help="extra wait after a job arrives to coalesce more "
                        "requests into its batch (0 = no added latency: "
                        "only jobs that queued during the previous "
                        "generation coalesce)")
    p.add_argument("--freeu", type=str, default="",
                   help="FreeU decoder rebalancing for the whole serving "
                        "profile: 'auto' (family preset) or b1,b2,s1,s2")
    p.add_argument("--cfg_interval", type=str, default="",
                   help="guidance-interval profile 'lo,hi' (grid "
                        "fractions, arXiv:2404.07724): CFG runs only on "
                        "steps in [lo,hi)")
    p.add_argument("--refiner_ckpt", type=str, default="",
                   help="SDXL refiner checkpoint/diffusers dir: serve the "
                        "base->refiner ensemble (EnsemblePipeline)")
    p.add_argument("--refiner_frac", type=float, default=0.8)
    p.add_argument("--lora_bank", type=str, default="",
                   help="comma-separated name=path LoRA adapters served "
                        "side by side: requests pick one via the 'lora' "
                        "field (absent = base weights).  Each adapter is "
                        "merged once at startup into its own copy of the "
                        "components it adapts (the VAE is shared)")
    common.bool_flag(p, "warmup", True,
                     "run one batch-1 call before accepting traffic")
    p.add_argument("--max_pending", type=int, default=32,
                   help="admission bound: jobs queued or running; beyond "
                        "it /generate answers 503 + Retry-After")
    p.add_argument("--request_timeout_s", type=float, default=300.0,
                   help="per-request deadline (queue wait + generation); "
                        "an expired request answers 504 and, if still "
                        "queued, is dropped before it takes a batch slot "
                        "(0 disables)")
    return p


class Overloaded(RuntimeError):
    """Admission-control rejection (--max_pending exceeded) → HTTP 503."""


class RequestTimeout(RuntimeError):
    """Per-request deadline expired (--request_timeout_s) → HTTP 504."""


class BatchFailed(RuntimeError):
    """The batch a validated request ran in raised → HTTP 500."""


class _Job:
    __slots__ = ("prompt", "neg", "n", "steps", "gs", "gr", "pw", "seed",
                 "size", "init", "mask", "strength", "hires", "lora",
                 "scheduler", "event", "images", "error", "cancelled")

    def __init__(self, prompt, neg, n, steps, gs, gr, pw, seed, size,
                 init=None, mask=None, strength=0.8, hires=None, lora="",
                 scheduler=""):
        self.prompt, self.neg, self.n = prompt, neg, n
        self.steps, self.gs, self.gr, self.pw = steps, gs, gr, pw
        self.seed, self.size = seed, size
        self.init, self.mask, self.strength = init, mask, strength
        self.hires = hires  # (scale, strength, steps) or None
        self.lora = lora    # adapter name ("" = base weights)
        self.scheduler = scheduler  # "" = the daemon's startup scheduler
        self.event = threading.Event()
        self.images = None
        self.error = None
        self.cancelled = False  # set by a timed-out waiter; batcher drops

    def key(self):
        """Jobs sharing this key run in one pipeline call: the same step
        count, guidance, weighting, size, img2img kind (and strength),
        hires tuple, adapter and scheduler.  Hires jobs also key on their
        seed: both stages draw noise from the head job's seed."""
        return (self.steps, self.gs, self.gr, self.pw, self.size,
                self.init is not None, self.mask is not None,
                round(self.strength, 4) if self.init is not None else None,
                self.hires,
                self.seed if self.hires is not None else None,
                self.lora, self.scheduler)


def _decode_with_pil(raw: bytes, size: int, mode: str) -> np.ndarray:
    """The JAX daemon's decode: PIL open, convert, resize to size² (bicubic
    for RGB, nearest for the mask)."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"this image (a JPEG, or a PNG other than an 8-bit L/RGB/RGBA "
            f"one of {size}x{size}) needs PIL (Pillow), which is not "
            "installed here")
    try:
        img = Image.open(io.BytesIO(raw))
        img.load()
    except Exception as e:  # PIL raises many types for bad data
        raise ValueError(f"could not decode base64 image: {e}")
    img = img.convert(mode)
    if img.size != (size, size):
        img = img.resize((size, size),
                         Image.BICUBIC if mode == "RGB" else Image.NEAREST)
    return np.asarray(img, np.float32) / 255.0


def decode_image(b64: str, size: int, mode: str) -> np.ndarray:
    """base64 PNG/JPEG → float32 [0, 1] array (size, size[, 3]) in mode
    "RGB" or "L"."""
    try:
        raw = base64.b64decode(b64, validate=True)
    except (binascii.Error, ValueError) as e:
        raise ValueError(f"could not decode base64 image: {e}")
    if raw[:8] == png.SIGNATURE:
        try:
            img = png.decode(raw)
        except png.PNGUnsupported:
            img = None
        except ValueError as e:
            raise ValueError(f"could not decode base64 image: {e}")
        if img is not None and img.shape[:2] == (size, size):
            return png.convert(img, mode).astype(np.float32) / 255.0
    return _decode_with_pil(raw, size, mode)


def job_latents(pipe, job: _Job):
    """The initial noise ``pipe`` draws for a lone call of ``job``: a
    generator seeded with its seed on the pipeline's device, ``randn`` over
    the job's batch bucket, the first n rows (on CUDA a draw of 3 rows is
    no prefix of a draw of 4)."""
    bucket = next((s for s in pipe.BATCH_BUCKETS if s >= job.n), job.n)
    f = pipe.cfg.vae_scale
    gen = torch.Generator(device=pipe.device).manual_seed(job.seed)
    return torch.randn((bucket, job.size // f, job.size // f,
                        pipe.cfg.latent_channels), generator=gen,
                       device=pipe.device, dtype=torch.float32)[:job.n]


def make_app(pipe, args, lora_pipes=None):
    """→ (handler_class, state dict); ``handler_class.close()`` stops the
    batcher thread.  Split from main() for tests.

    ``lora_pipes``: optional {name: SDPipeline} of adapter-merged
    pipelines served side by side (request field "lora"); "" is the base
    ``pipe``.  Per-request scheduler views share their pipeline's modules
    (no weights are copied)."""
    from http.server import BaseHTTPRequestHandler

    from sdbc_tpu_torch.cli.inference import (_resolve_cfg_interval,
                                              _resolve_freeu)
    from sdbc_tpu_torch.diffusion.ensemble import EnsemblePipeline
    from sdbc_tpu_torch.diffusion.graph import SCHEDULERS
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.diffusion.spec import SampleSpec

    pipes = {"": pipe, **(lora_pipes or {})}
    ensemble = isinstance(pipe, EnsemblePipeline)
    sched_views = {}

    def pipe_for(lora: str, scheduler: str):
        base = pipes[lora]
        if not scheduler or scheduler == base.cfg.scheduler:
            return base
        if (lora, scheduler) not in sched_views:
            sched_views[(lora, scheduler)] = SDPipeline(
                base.models, dataclasses.replace(base.cfg,
                                                 scheduler=scheduler),
                base.tokenizer, device=base.device,
                compute_dtype=base.compute_dtype, attn_impl=base.attn_impl,
                safety_checker=base.safety_checker,
                tokenizer2=base.tokenizer2)
        return sched_views[(lora, scheduler)]

    jobs: "queue_mod.Queue[_Job]" = queue_mod.Queue()
    pending: "collections.deque[_Job]" = collections.deque()
    state = {"requests": 0, "errors": 0, "busy": False, "batches": 0,
             "batched_images": 0, "started": time.time(),
             "pending_jobs": 0, "rejected_overload": 0,
             "timed_out": 0}
    lock = threading.Lock()  # guards the counters of state
    stop = threading.Event()

    def bump(key: str, n: int = 1) -> None:
        with lock:
            state[key] += n

    def _admit(job: _Job) -> None:
        """Hold the jobs queued or running below --max_pending."""
        with lock:
            if state["pending_jobs"] >= args.max_pending:
                state["rejected_overload"] += 1
                raise Overloaded(
                    f"server overloaded: {state['pending_jobs']} jobs "
                    f"pending (--max_pending {args.max_pending}); retry "
                    "later")
            state["pending_jobs"] += 1
        jobs.put(job)

    # rolling request latencies (s, queue wait + generation) for /healthz
    latencies: "collections.deque[float]" = collections.deque(maxlen=512)

    f = pipe.cfg.vae_scale
    sizes = sorted({int(s) for s in
                    (args.allowed_sizes.split(",") if args.allowed_sizes
                     else []) if s.strip()} | {args.img_size})
    for s in sizes:
        if s % (f * 8) or s <= 0:
            raise SystemExit(f"--allowed_sizes: {s} is not a positive "
                             f"multiple of {f * 8}")
    freeu = _resolve_freeu(args, pipe.cfg)
    cfg_interval = _resolve_cfg_interval(args)

    def run_batch(batch):
        """One pipeline call for the batch; everything after the batch is
        taken sits in the try, so no failure stops the batcher or keeps
        an admission slot."""
        try:
            head = batch[0]
            # key() guarantees one (adapter, scheduler) pair per batch
            bpipe = pipe_for(head.lora, head.scheduler)
            prompts = [j.prompt for j in batch for _ in range(j.n)]
            spec = SampleSpec(height=head.size, width=head.size,
                              num_inference_steps=head.steps,
                              guidance_scale=head.gs,
                              guidance_rescale=head.gr,
                              negative_prompt=[j.neg for j in batch
                                               for _ in range(j.n)],
                              # the stochastic schedulers' noise: the head
                              # job's stream (exact for lone jobs only)
                              seed=head.seed,
                              cache_interval=args.cache_interval,
                              cache_tail=args.cache_tail,
                              freeu=freeu, cfg_interval=cfg_interval,
                              prompt_weighting=head.pw)
            if head.hires is not None:
                # key() makes the whole batch share the tuple and the seed
                hs, hstr, hsteps = head.hires
                spec = spec.replace(hires_scale=hs, hires_strength=hstr,
                                    hires_steps=hsteps)
            else:
                if len(batch) > 1:
                    spec = spec.replace(latents=torch.cat(
                        [job_latents(bpipe, j) for j in batch]))
                if head.init is not None:  # key(): the whole batch has one
                    spec = spec.replace(
                        init_image=np.stack([j.init for j in batch
                                             for _ in range(j.n)]),
                        strength=head.strength,
                        mask_image=None if head.mask is None else np.stack(
                            [j.mask for j in batch for _ in range(j.n)]))
            imgs = bpipe.generate(prompts, spec)
            off = 0
            for j in batch:
                j.images = imgs[off:off + j.n]
                off += j.n
        except Exception as e:  # reported to every waiter of the batch
            traceback.print_exc()
            for j in batch:
                j.error = e
        finally:
            with lock:
                state["batches"] += 1
                state["batched_images"] += sum(j.n for j in batch)
                state["pending_jobs"] -= len(batch)
            for j in batch:
                j.event.set()

    def drain_queue():
        while True:
            try:
                pending.append(jobs.get_nowait())
            except queue_mod.Empty:
                return

    def batcher():
        while not stop.is_set():
            if not pending:
                try:
                    pending.append(jobs.get(timeout=1.0))
                except queue_mod.Empty:
                    continue
            if args.batch_window_ms > 0:
                time.sleep(args.batch_window_ms / 1000.0)
            drain_queue()
            head = pending.popleft()
            if head.cancelled:  # its waiter already answered 504
                bump("pending_jobs", -1)
                continue
            batch, total = [head], head.n
            i = 0
            while i < len(pending):  # FIFO among compatible jobs
                cand = pending[i]
                if cand.cancelled:
                    del pending[i]
                    bump("pending_jobs", -1)
                elif cand.key() == head.key() \
                        and total + cand.n <= args.max_batch:
                    del pending[i]
                    batch.append(cand)
                    total += cand.n
                else:
                    i += 1
            state["busy"] = True
            try:
                run_batch(batch)
            finally:
                state["busy"] = False

    threading.Thread(target=batcher, daemon=True,
                     name="sdbc-serve-batcher").start()

    def generate(req: dict):
        prompt = req.get("prompt")
        if not isinstance(prompt, str) or not prompt.strip():
            raise ValueError("'prompt' (non-empty string) is required")
        n = int(req.get("num_images", 1))
        if not 1 <= n <= args.max_batch:
            raise ValueError(f"num_images must be in [1, {args.max_batch}]")
        size = int(req.get("size", args.img_size))
        if size not in sizes:
            raise ValueError(f"size must be one of {sizes} "
                             "(--allowed_sizes)")
        if req.get("mask_image") and not req.get("init_image"):
            raise ValueError("mask_image (inpainting) requires init_image")
        init = mask = None
        if req.get("init_image"):
            init = decode_image(req["init_image"], size, "RGB")
            strength = float(req.get("strength", 0.8))
            if not 0.0 < strength <= 1.0:
                raise ValueError(f"strength must be in (0, 1], got "
                                 f"{strength}")
            if req.get("mask_image"):
                mask = decode_image(req["mask_image"], size, "L")
        lora = str(req.get("lora") or "")
        if lora and lora not in pipes:
            raise ValueError(
                f"unknown lora adapter {lora!r}; served: "
                f"{sorted(n for n in pipes if n) or '(none — --lora_bank)'}")
        scheduler = str(req.get("scheduler") or "")
        if scheduler:
            if scheduler not in SCHEDULERS:
                raise ValueError(f"unknown scheduler {scheduler!r}; one "
                                 f"of {list(SCHEDULERS)}")
            if ensemble:
                raise ValueError("per-request scheduler is not available "
                                 "under --refiner_ckpt ensemble serving")
            if scheduler == pipes[lora].cfg.scheduler:
                # the daemon's own scheduler: the same pipeline, so
                # explicit-name and default requests coalesce
                scheduler = ""
        hires = None
        if req.get("hires_scale"):
            if ensemble:
                raise ValueError("hires_scale is not available under "
                                 "--refiner_ckpt ensemble serving")
            if init is not None:
                raise ValueError("hires_scale cannot combine with "
                                 "init_image (it drives both stages "
                                 "itself)")
            hs = float(req["hires_scale"])
            if hs <= 1.0:
                raise ValueError(f"hires_scale must be > 1, got {hs}")
            hstr = float(req.get("hires_strength", 0.7))
            if not 0.0 < hstr <= 1.0:
                raise ValueError(f"hires_strength must be in (0, 1], got "
                                 f"{hstr}")
            hires = (round(hs, 4), round(hstr, 4),
                     int(req.get("hires_steps", 0)))
        job = _Job(prompt=prompt,
                   neg=str(req.get("negative_prompt") or ""),
                   n=n,
                   steps=int(req.get("num_inference_steps",
                                     args.num_inference_steps)),
                   gs=float(req.get("guidance_scale", args.guidance_scale)),
                   gr=float(req.get("guidance_rescale", 0.0)),
                   pw=bool(req.get("prompt_weighting", False)),
                   seed=int(req.get("seed", 42)),
                   size=size, init=init, mask=mask,
                   strength=float(req.get("strength", 0.8)), hires=hires,
                   lora=lora, scheduler=scheduler)
        t_enq = time.monotonic()
        _admit(job)  # raises Overloaded at the --max_pending bound
        if not job.event.wait(args.request_timeout_s or None):
            # still queued: the batcher drops it; if already running, the
            # batch completes and its images are discarded
            job.cancelled = True
            bump("timed_out")
            raise RequestTimeout(
                f"request exceeded --request_timeout_s "
                f"{args.request_timeout_s:g}s (queue wait + generation)")
        latencies.append(time.monotonic() - t_enq)
        if job.error is not None:
            raise BatchFailed(f"{type(job.error).__name__}: "
                              f"{job.error}") from job.error
        return [png.encode(np.uint8(np.round(im * 255.0)))
                for im in job.images]

    class Handler(BaseHTTPRequestHandler):
        @staticmethod
        def close():
            """Stop the batcher thread (it exits within a second)."""
            stop.set()

        def log_message(self, fmt, *a):  # one-line access log to stdout
            print(f"[serve] {self.address_string()} {fmt % a}", flush=True)

        def _send(self, code, body: bytes, ctype="application/json",
                  headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj, headers=()):
            self._send(code, json.dumps(obj).encode(), headers=headers)

        def do_GET(self):
            if self.path == "/healthz":
                lat = sorted(latencies)
                pct = (lambda p: round(lat[min(len(lat) - 1,
                                               int(p * len(lat)))], 3)) \
                    if lat else (lambda p: None)
                with lock:
                    snapshot = dict(state)
                self._json(200, {"ok": True,
                                 "latency_p50_s": pct(0.50),
                                 "latency_p95_s": pct(0.95),
                                 "lora_adapters": sorted(n for n in pipes
                                                         if n),
                                 **snapshot})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                pngs = generate(req)
                bump("requests")
                if len(pngs) == 1:
                    self._send(200, pngs[0], ctype="image/png")
                else:
                    self._json(200, {"images": [
                        base64.b64encode(p).decode() for p in pngs]})
            except ValueError as e:
                bump("errors")
                self._json(400, {"error": str(e)})
            except Overloaded as e:
                bump("errors")
                self._json(503, {"error": str(e)},
                           headers=[("Retry-After", "5")])
            except RequestTimeout as e:
                bump("errors")
                self._json(504, {"error": str(e)})
            except Exception as e:  # keep the daemon alive
                bump("errors")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler, state


def model_bytes(models: dict, names) -> int:
    """Bytes the parameters of ``models[name]`` for each name hold."""
    return sum(p.numel() * p.element_size() for n in names
               for p in models[n].parameters())


def load_pipelines(args):
    """(pipe, lora_pipes) for parsed arguments, as ``main`` serves them:
    the resolved model (``common.resolve_params_cfg``), the base →
    refiner ``EnsemblePipeline`` with ``--refiner_ckpt``, and one pipeline
    per ``--lora_bank`` adapter on merged copies of the components it
    adapts (printing the bytes each copy holds)."""
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline

    models, cfg = common.resolve_params_cfg(args)
    if args.lora_bank and args.refiner_ckpt:
        raise SystemExit("--lora_bank cannot combine with --refiner_ckpt "
                         "(adapters merge into the base model, not the "
                         "ensemble)")
    tok = common.make_tokenizer(args, cfg.clip.vocab_size)
    tok2 = common.make_tokenizer2(args, cfg)
    dtype = common.compute_dtype(args)
    pipe = SDPipeline(models, cfg, tok, device=args.device,
                      compute_dtype=dtype, tokenizer2=tok2)
    if args.refiner_ckpt:
        from sdbc_tpu_torch.cli.inference import make_ensemble

        pipe = make_ensemble(args, pipe)
    lora_pipes = {}
    if args.lora_bank:
        from sdbc_tpu_torch.train import lora as lora_mod

        for entry in args.lora_bank.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, _, path = entry.partition("=")
            if not name or not path:
                raise SystemExit(f"--lora_bank entry {entry!r} is not "
                                 "name=path")
            merged = lora_mod.merge_file(models, path)
            copied = [k for k in merged if merged[k] is not models[k]]
            lora_pipes[name] = SDPipeline(merged, cfg, tok,
                                          device=args.device,
                                          compute_dtype=dtype,
                                          tokenizer2=tok2)
            print(f"[serve] lora adapter {name!r} merged from {path}: a "
                  f"copy of {copied} holding "
                  f"{model_bytes(merged, copied)} bytes", flush=True)
    return pipe, lora_pipes


def warmup(pipe, args) -> None:
    """One batch-1 call of the serving profile, as the JAX daemon warms
    up."""
    from sdbc_tpu_torch.cli.inference import (_resolve_cfg_interval,
                                              _resolve_freeu)

    print(f"[serve] warming up ({args.num_inference_steps} steps, "
          f"{args.img_size}px, scheduler {pipe.cfg.scheduler})...",
          flush=True)
    t0 = time.time()
    pipe(["warmup"], height=args.img_size, width=args.img_size,
         num_inference_steps=args.num_inference_steps,
         cache_interval=args.cache_interval, cache_tail=args.cache_tail,
         freeu=_resolve_freeu(args, pipe.cfg),
         cfg_interval=_resolve_cfg_interval(args))
    print(f"[serve] warmup done in {time.time() - t0:.1f}s", flush=True)


def main(argv=None):
    from http.server import ThreadingHTTPServer

    args = build_parser().parse_args(argv)
    common.refuse_unported(args)
    common.resolve_img_size(args)
    pipe, lora_pipes = load_pipelines(args)
    if args.warmup:
        warmup(pipe, args)
    handler, _ = make_app(pipe, args, lora_pipes=lora_pipes)
    srv = ThreadingHTTPServer((args.host, args.port), handler)
    print(f"[serve] listening on http://{args.host}:{args.port} "
          "(POST /generate, GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        handler.close()
        srv.server_close()


if __name__ == "__main__":
    main()
