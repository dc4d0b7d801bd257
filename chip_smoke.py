"""Drive the PyTorch/CUDA port (``sdbc_tpu_torch``) once on one H100.

    python3 chip_smoke.py

Phases, in order; each prints one line, and any failure raises (exit code
non-zero, no result line):

1. device  — a CUDA device of capability 9.0, and its ``nvidia-smi`` name
             and power limit;
2. build   — compile ``sdbc_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes SD-1.5 512² batch-4 sampling gives it (bf16 inputs;
             the plain version in fp32 on the same bf16 values), with
             CUDA-event medians of both;
4. parity  — the whole slice at the tiny config (32² image, 4 DDIM steps,
             batch 2 with CFG): bf16 on the card against fp32 on the CPU,
             with both kernels launched;
5. slice   — SD-1.5 at full width (random init from seed 0, bf16), 512²,
             batch 4, DDIM-50, CFG 7.5, through ``SDPipeline.__call__``:
             a warm-up call, then a timed call whose kernel launch counts
             must be exactly what the UNet's shape implies;
6. profile — device time by kernel over one UNet evaluation at full width,
             its wall time (hence the device's idle share), and the wall
             times of the text encode and the VAE decode.

Then a JSON line of per-kernel results, the ``nvidia-smi`` line again, and
the result line ``{"ok": true, "device": {...}}``.  No JAX is imported.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Tolerances (max abs error against the plain version, bf16 kernel vs fp32
# plain on the same bf16 inputs).  Attention: unit-normal q/k/v, outputs are
# convex combinations of v rows (|o| ≲ 3), so bf16 rounding of q, p and o
# gives errors of a few 1e-3.  GEGLU: outputs y + FF(y) with |o| up to ~8;
# one bf16 ulp there is 0.03, and the hidden and LN tile are rounded too.
FLASH_TOL = 2e-2
GEGLU_TOL = 5e-2
# Whole tiny slice, bf16 on the card vs fp32 on the CPU (same bf16-valued
# weights): CFG 7.5 amplifies the bf16 rounding of the UNet output.
PARITY_TOL = 3e-2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def expected_launches(cfg, lat_hw: int, rows_batch: int):
    """(flash, geglu) launches per UNet evaluation: one flash call per
    spatial self-attention with ≥ 256 tokens, one fused FF per transformer
    the GEGLU eligibility rule admits."""
    from sdbc_tpu_torch.ops.geglu_ff import _MAX_C, _default_block

    u = cfg.unet
    flash = geglu = 0
    levels = [(i, c, lat_hw // 2 ** i, u.layers_per_block)
              for i, c in enumerate(u.block_out_channels)]
    levels += [(i, c, lat_hw // 2 ** i, u.layers_per_block + 1)
               for i, c in enumerate(u.block_out_channels)]
    mid = len(u.block_out_channels) - 1
    sites = [(c, hw) for i, c, hw, n in levels if u.cross_attn_blocks[i]
             for _ in range(n)]
    sites.append((u.block_out_channels[-1], lat_hw // 2 ** mid))
    for c, hw in sites:
        tokens = hw * hw
        rows = rows_batch * tokens
        flash += tokens >= 256
        geglu += c <= _MAX_C and rows % min(_default_block(c), rows) == 0
    return flash, geglu


def phase_device():
    import torch

    from sdbc_tpu_torch.utils.dtypes import set_fp32_matmul_exact

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False — this script needs a "
             "CUDA device and has no CPU fallback")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"capability {cap}: the kernels are built for sm_90a (Hopper)")
    # fp32 products in full fp32 everywhere (the plain versions, the fp32
    # logits of plain attention); the bf16 slice is unaffected otherwise
    set_fp32_matmul_exact()
    smi = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} cap {cap} "
          f"count {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda} tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32} | nvidia-smi: {smi}", flush=True)
    return smi


def phase_build():
    from sdbc_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.load()
    secs = time.perf_counter() - t0
    log = _kernels.BUILD_DIR / "nvcc.log"
    lines = log.read_text().splitlines() if log.exists() else []
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
            if "Used " in ln and " registers" in ln]
    spills = [ln.strip() for ln in lines
              if "spill stores" in ln and " 0 bytes spill stores" not in ln]
    built = (f"nvcc {_kernels.build_seconds:.1f} s"
             if _kernels.build_seconds is not None else "reused")
    print(f"[build] {lib.name} in {secs:.1f} s ({built}); ptxas: "
          f"{len(regs)} kernels, max {max(regs, default=0)} registers, "
          f"{len(spills)} spilling {spills[:4]}", flush=True)
    return secs


def phase_kernels():
    import torch

    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import geglu_ff as gf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    rows = []

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    tr = lambda t: t.transpose(1, 2)
    # (label, layout, q shape, kv seq): the three slice levels in the
    # projection layout, one head-major call, one ragged call
    flash_cases = [("bshd 64^2 d40", "bshd", (8, 4096, 8, 40), 4096),
                   ("bshd 32^2 d80", "bshd", (8, 1024, 8, 80), 1024),
                   ("bshd 16^2 d160", "bshd", (8, 256, 8, 160), 256),
                   ("bhsd 32^2 d80", "bhsd", (8, 8, 1024, 80), 1024),
                   ("bshd ragged Sq200 Sk300 d40", "bshd", (2, 200, 8, 40),
                    300)]
    flash_err, flash_ms, flash_plain_ms = 0.0, None, None
    for label, layout, qshape, sk in flash_cases:
        kshape = list(qshape)
        kshape[1 if layout == "bshd" else 2] = sk
        q, k, v = randn(*qshape), randn(*kshape), randn(*kshape)
        if layout == "bshd":
            kern = lambda: fa.flash_attention_fixed_bshd(q, k, v)
            plain = lambda: tr(fa.fixed_cap_attention_ref(
                tr(q).float(), tr(k).float(), tr(v).float()))
        else:
            kern = lambda: fa.flash_attention_fixed(q, k, v)
            plain = lambda: fa.fixed_cap_attention_ref(q.float(), k.float(),
                                                       v.float())
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref).abs().max().item()
        if not torch.isfinite(out).all() or not err <= FLASH_TOL:
            fail(f"flash {label}: max abs err {err} > {FLASH_TOL}")
        ms, pms = median_ms(kern, 20), median_ms(plain, 5)
        del ref
        print(f"[kernels] flash_fixed {label}: max_abs_err {err:.3e} "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms", flush=True)
        flash_err = max(flash_err, err)
        if flash_ms is None:
            flash_ms, flash_plain_ms = ms, pms
    rows.append({"name": "flash_fixed", "route": "cuda",
                 "source": "sdbc_tpu_torch/csrc/flash_fixed.cu",
                 "replaces": "sdbc_tpu/ops/flash_attention.py:314",
                 "max_abs_err": flash_err, "ms": flash_ms,
                 "plain_ms": flash_plain_ms})

    geglu_err, geglu_ms, geglu_plain_ms = 0.0, None, None
    for rows_n, c in ((32768, 320), (8192, 640)):
        y = randn(rows_n, c)
        gamma = randn(c, scale=0.1, dtype=torch.float32) + 1.0
        beta = randn(c, scale=0.1, dtype=torch.float32)
        w1, b1 = randn(c, 8 * c, scale=c ** -0.5), randn(8 * c, scale=0.02)
        w2, b2 = randn(4 * c, c, scale=(4 * c) ** -0.5), randn(c, scale=0.02)
        args = (y, gamma, beta, w1, b1, w2, b2)
        kern = lambda: gf.geglu_ff_rows(*args)
        plain = lambda: gf.geglu_ff_ref(*(t.float() for t in args))
        out = kern()
        torch.cuda.synchronize()
        err = (out.float() - plain()).abs().max().item()
        if not torch.isfinite(out).all() or not err <= GEGLU_TOL:
            fail(f"geglu ({rows_n}, {c}): max abs err {err} > {GEGLU_TOL}")
        ms, pms = median_ms(kern, 20), median_ms(plain, 10)
        # the unfused bf16 feed-forward the model runs where the kernel
        # does not apply (cuBLAS products, hidden through HBM)
        unfused = lambda: unfused_ff(*args)
        ums = median_ms(unfused, 20)
        print(f"[kernels] geglu_ff ({rows_n}, {c}): max_abs_err {err:.3e} "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms unfused-bf16 "
              f"{ums:.4f} ms", flush=True)
        geglu_err = max(geglu_err, err)
        if geglu_ms is None:
            geglu_ms, geglu_plain_ms = ms, pms
    rows.append({"name": "geglu_ff", "route": "cuda",
                 "source": "sdbc_tpu_torch/csrc/geglu_ff.cu",
                 "replaces": "sdbc_tpu/ops/geglu_ff.py:46",
                 "max_abs_err": geglu_err, "ms": geglu_ms,
                 "plain_ms": geglu_plain_ms})
    return rows


def unfused_ff(y, gamma, beta, w1, b1, w2, b2):
    import torch.nn.functional as F

    from sdbc_tpu_torch.ops import nn

    z = nn.linear(nn.layer_norm(y, gamma, beta), w1, b1)
    val, gate = z.chunk(2, dim=-1)
    return y + nn.linear(val * F.gelu(gate), w2, b2)


def _tokenizer(cfg):
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    return CLIPTokenizer.fallback(cfg.clip.vocab_size)


def phase_parity():
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                                   init_models)
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    cfg = PipelineConfig.tiny()
    models = init_models(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    gpu = {k: copy.deepcopy(m).to("cuda", torch.bfloat16)
           for k, m in models.items()}
    cpu = {k: copy.deepcopy(m).to("cpu", torch.float32)
           for k, m in gpu.items()}  # the same bf16-valued weights
    prompts = ["a book cover", "a mystery novel cover"]
    lat = per_sample_fixed_latents(2, (4, 16, 16), 42)
    kw = dict(height=32, width=32, num_inference_steps=4, latents=lat)
    ref = SDPipeline(cpu, cfg, _tokenizer(cfg), "cpu", torch.float32)(
        prompts, **kw)
    _kernels.reset_launch_counts()
    out = SDPipeline(gpu, cfg, _tokenizer(cfg), "cuda", torch.bfloat16)(
        prompts, **kw)
    counts = dict(_kernels.launches)
    err = float(np.abs(out - ref).max())
    flash, geglu = expected_launches(cfg, 16, 4)
    want = {"flash_fixed": 4 * flash, "geglu_ff": 4 * geglu}
    print(f"[parity] tiny 32^2 batch 2 DDIM-4: image max abs err {err:.3e} "
          f"(tol {PARITY_TOL}), launches {counts} (expected {want})",
          flush=True)
    if out.shape != (2, 32, 32, 3) or not np.isfinite(out).all():
        fail(f"tiny slice output {out.shape} not finite")
    if not err <= PARITY_TOL:
        fail(f"tiny slice: card vs CPU max abs err {err} > {PARITY_TOL}")
    if counts != want or min(counts.values()) == 0:
        fail(f"tiny slice launch counts {counts}, expected {want}")


def _slice_setup():
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                                   init_models)

    cfg = PipelineConfig.sd15()
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = init_models(cfg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
    return cfg, SDPipeline(models, cfg, _tokenizer(cfg), "cuda",
                           torch.bfloat16)


PROMPTS = ["a fantasy novel cover with a dragon over a castle",
           "a minimalist thriller book cover, red and black",
           "a romance novel cover at sunset on a beach",
           "a science fiction cover with a starship and a ringed planet"]


def phase_slice(cfg, pipe, smi: str):
    import numpy as np
    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    lat = per_sample_fixed_latents(4, (4, 64, 64), 42)
    kw = dict(height=512, width=512, num_inference_steps=50,
              guidance_scale=7.5, latents=lat)
    t0 = time.perf_counter()
    pipe(PROMPTS, **kw)  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    imgs = pipe(PROMPTS, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    flash, geglu = expected_launches(cfg, 64, 8)
    want = {"flash_fixed": 50 * flash, "geglu_ff": 50 * geglu}
    print(f"[slice] SD-1.5 512^2 batch 4 DDIM-50 CFG 7.5 bf16: "
          f"{secs:.3f} s/call, {4 / secs:.4f} images/s, warm-up "
          f"{warm:.3f} s, peak {peak / 2 ** 30:.2f} GiB, launches {counts} "
          f"(expected {want}) | {smi}", flush=True)
    if imgs.shape != (4, 512, 512, 3) or not np.isfinite(imgs).all():
        fail(f"slice images {imgs.shape} not all finite")
    if imgs.min() < 0.0 or imgs.max() > 1.0:
        fail("slice images outside [0, 1]")
    if want != {"flash_fixed": 750, "geglu_ff": 500} or counts != want:
        fail(f"slice launch counts {counts}, expected {want}")
    if "jax" in sys.modules:
        fail("jax was imported")
    return counts, secs


def phase_profile(pipe):
    """Device time by kernel over one UNet evaluation (CFG batch 8, 64²)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdbc_tpu_torch.models import unet as unet_mod

    dev = torch.device("cuda")
    unet = pipe.models["unet"]
    g = torch.Generator(device=dev).manual_seed(7)
    lat = torch.randn((8, 64, 64, 4), generator=g, device=dev).bfloat16()
    ctx = torch.randn((8, 77, 768), generator=g, device=dev).bfloat16()
    tb = torch.full((8,), 500, device=dev)
    run = lambda: unet_mod.apply(unet, lat, tb, ctx, attn_impl="inference")
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    # kernel-level events only: an operator's own device time repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev_us(e) for e in events)
    if total == 0:
        print("[profile] UNet eval: device time not measured (profiler saw "
              "no device time)", flush=True)
        return
    top = sorted(events, key=lambda e: -dev_us(e))[:10]
    summary = [(e.key[:60], round(dev_us(e) / 1e3, 3)) for e in top]
    # stage wall times (host clock around synchronized work, medians)
    from sdbc_tpu_torch.diffusion import graph
    from sdbc_tpu_torch.models import vae as vae_mod

    z = torch.randn((4, 64, 64, 4), generator=g, device=dev).bfloat16()
    ids = pipe.tokenize(PROMPTS)
    with torch.inference_mode():
        unet_ms = wall_ms(run, 5)
        vae_ms = wall_ms(lambda: [vae_mod.decode(pipe.models["vae"],
                                                 z[j:j + 1])
                                  for j in range(4)], 3)
        text_ms = wall_ms(lambda: graph.encode_text(
            pipe.models["text_encoder"], ids, pipe.cfg, torch.bfloat16), 5)
    print(f"[profile] UNet eval (batch 8, 64^2): wall {unet_ms:.3f} ms, "
          f"kernels {total / 1e3:.3f} ms (device idle "
          f"{100 * (1 - total / 1e3 / unet_ms):.1f}%); text encode (4 "
          f"prompts) {text_ms:.3f} ms; VAE decode (4 images) {vae_ms:.3f} "
          f"ms; top kernels (ms): {summary}", flush=True)


def main() -> int:
    if not (ROOT / "sdbc_tpu_torch").is_dir():
        fail(f"run from a checkout of the repo: no sdbc_tpu_torch/ beside "
             f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    smi = phase_device()
    phase_build()
    rows = phase_kernels()
    phase_parity()
    cfg, pipe = _slice_setup()
    counts, _ = phase_slice(cfg, pipe, smi)
    phase_profile(pipe)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
