"""Drive the PyTorch/CUDA port (``sdbc_tpu_torch``) once on one H100.

    python3 chip_smoke.py

Phases, in order; each prints one or more lines, and any failure raises
(exit code non-zero, no result line):

1. device       — a CUDA device of capability 9.0, and its ``nvidia-smi``
                  name and power limit;
2. build        — compile ``sdbc_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
                  (one nvcc per source, all started together);
3. kernels      — each sampling kernel against its plain PyTorch version on
                  the card, at the shapes SD-1.5 512² batch-4 sampling gives
                  it (bf16 inputs; the plain version in fp32 on the same
                  bf16 values), with CUDA-event medians of the kernel, the
                  plain version and the one PyTorch call computing the same
                  function (where there is one): the fixed-cap attention
                  (timed against SDPA in alternating rounds, with its share
                  of the bound; also at the VAE's 512-wide head and at
                  hires-fix's 1024² shape (2,16384,8,40), held to the
                  plain version on every 16th query), GEGLU (timed against the unfused bf16
                  feed-forward in alternating rounds, with its share of
                  the bound), the fused GroupNorm (the UNet's
                  GroupNorm inputs at batch 8, one ragged case) and the
                  int8-QK attention (also held to 4% of exact attention
                  and two calls to the same bits, timed against K1 and
                  SDPA in alternating rounds, with the CUDA kernels of one
                  call — k's quantizing pre-pass and the attention kernel
                  — counted by the profiler);
                  the build phase prints the wgmma kernels' registers,
                  spills and SASS op counts (flash forward in both layouts
                  up to head dim 256 and above, backward up to 192 and
                  above, GEGLU, the int8-QK attention with its
                  instructions per score) and the
                  8-bit AdamW kernel's instructions per element;
4. train-kernels — the same for the training kernels at the shapes the
                  mode-C fine-tuning step gives them (flash forward, timed
                  like the fixed-cap attention, dq and
                  dk/dv at micro-batch 2, 8 heads, 64²/32²/16² tokens, one
                  ragged case, each kernel alone and the whole backward
                  call against SDPA's flash backward in alternating rounds;
                  the 8-bit AdamW on a leaf with a ragged last
                  row, then in one launch over all 289 8-bit leaves of a
                  mode-C step at their real sizes, seven of them stacked,
                  against the step's bytes bound), the transposed-layout
                  forward at the same cases plus the 77-key
                  cross-attention, the 8² mid block and the VAE's 512-wide
                  head (also held to the forward's output, at 512 bit for
                  bit; timed against SDPA — its flash forward up to head
                  dim 256, its default dispatch at 512 — and the forward
                  in alternating rounds), the forward at the 512-wide head
                  and the backward at it (the wide kernels: the whole call
                  against the plain version and against SDPA's backward in
                  alternating rounds, the backend named, each kernel's card
                  time against its bound, 20 calls back to back; at 64²,
                  32² and a ragged case);
   simt-kernels — the CUDA-core kernels, for what the tensor-core ones do
                  not take, in fp32 at SD-1.5's 64² level: the fixed cap at
                  sampling batch 8, the training forward, dq and dk/dv at
                  the mode-C step's micro-batch 2, the fused FF at the
                  sampling rows; each against its plain version and timed
                  against SDPA (forward, backward) in alternating rounds;
5. parity       — the sampling slice at the tiny config (32² image, 4 DDIM
                  steps, batch 2 with CFG): bf16 on the card against fp32
                  on the CPU, with both sampling kernels launched; then the
                  same under SDBC_GN_FUSED=1, with exact fused GroupNorm
                  launches; then fp32 on the card, every attention and FF
                  call on the CUDA-core kernels, with exact launches;
   sampler-parity — every scheduler variant of ``sample`` (the ten
                  schedulers and the Karras grid of the five σ-space ones)
                  and each sampling option (cfg_interval, guidance rescale,
                  clip skip, FreeU, DeepCache, token weights, img2img from
                  an image or latents, inpainting, t_end, v-prediction on a
                  zero-SNR trailing grid) at the tiny config, bf16 on the
                  card against fp32 on the CPU with the same injected
                  draws, with exact K1/K4 launches from the evaluation
                  count of each run;
6. slice        — SD-1.5 at full width (random init from seed 0, bf16),
                  512², batch 4, DDIM-50, CFG 7.5, through
                  ``SDPipeline.__call__``: a warm-up call, then a timed call
                  whose kernel launch counts must be exactly what the UNet's
                  shape implies;
   decode       — one VAE decode of a 64² latent under
                  SDBC_ATTN_IMPL=flash (one K5 launch at the 512-wide
                  head), then under SDBC_ATTN_IMPL=inference (one launch of
                  the wide kernel's fixed-cap variant at that head), each
                  against the default decode on the same latent;
7. profile      — device time by kernel over one UNet evaluation at full
                  width, its wall time (hence the device's idle share), and
                  the wall times of the text encode and the VAE decode;
8. switches     — one full-width sampling call under SDBC_GN_FUSED=1, with
                  exact fused GroupNorm launches;
   samplers     — SD-1.5 at full width through ``SDPipeline``: every
                  scheduler variant at 10 steps (lcm at 4), DDIM-10 with
                  cfg_interval, DeepCache, FreeU + guidance rescale + clip
                  skip, img2img, inpainting and decode=False, each with
                  finite results and exact K1/K4 launches from its UNet
                  evaluations (heun 19, pndm 11, a DeepCache reuse step 5
                  and 5); then dpm-25, the CLI's serving profile, warmed up
                  and timed (s/call, images/s, peak memory);
   generate     — the evaluation entry points at full width:
                  ``cli.common.resolve_params_cfg`` on parsed
                  ``cli.inference`` arguments (random SD-1.5, bf16), then
                  ``SDPipeline.generate`` with the CLI's serving profile
                  (dpm-25, CFG 7.5, 512²) on 4 prompts (bucket 4), 6
                  prompts padded to bucket 8, a ``prompt_weighting`` call
                  over two CLIP windows, and hires-fix to 1024² (latent
                  mode, strength 0.7; K1 at (2,16384,8,40)), each timed
                  after a warm-up with exact K1/K4 launches (the second
                  stage's evaluations from its strength); then FID: the
                  Inception extractor's features of the generated images
                  on the card (strict fp32) against the CPU's
                  (``INCEPTION_TOL``), its ms per batch of 50, and the
                  statistics and Fréchet distances (a set against itself
                  within ``FID_SELF_TOL`` of tr Σ); no PIL, no pandas;
9. train-parity — one optimizer step of the tiny config (grad_accum 2,
                  micro 2, 8-bit AdamW) bf16 on the card against fp32 on the
                  CPU with the same injected draws, all four training
                  kernels launched; then the same with grad_ckpt (block)
                  under SDBC_GN_FUSED=1 and SDBC_ATTN_IMPL=flash_tt; then
                  fp32 on the card (the flash forward and backward on the
                  CUDA-core kernels, the 8-bit AdamW's launch);
10. train       — the JAX package's bench mode C (``bench.py``): SD-1.5 at
                  full width (random init, fp32 masters, bf16 compute),
                  UNet + text encoder trained, 8-bit AdamW, 512², micro-batch
                  2, grad_accum 4, through ``init_train_state`` /
                  ``make_train_step``: a warm-up step, then timed steps with
                  finite losses, moved parameters and exact launch counts,
                  and a device-time profile of one step;
11. train-ckpt  — the same with gradient checkpointing, remat_mode "block"
                  and "selective", each with its own profiled step (s/step
                  and peak memory beside the no-remat run; flash forwards
                  doubled under "block" only);
12. switches    — one mode-C step under SDBC_GN_FUSED=1 and
                  SDBC_ATTN_IMPL=flash_tt: every attention call (the VAE
                  encode's 512-wide head included) through the
                  transposed-layout forward, none through the other.

Every environment variable a phase sets is restored after it.

Then a JSON line of per-kernel results (each kernel's launches on its
path, ``MAIN_PATH``, and on every path where it launched: the full-width
ones, the tiny fp32 ones and each sampler run, each counted over its own
run), the ``nvidia-smi`` line again, and the result line
``{"ok": true, "device": {...}}``.  No JAX is imported.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Tolerances (max abs error against the plain version, bf16 kernel vs fp32
# plain on the same bf16 inputs).  Attention (outputs and gradients, every
# attention kernel): 2% of the plain result's largest entry plus 1e-3.
# bf16 rounding of q, p and o (and of ds0 / p summed over the sequence in
# the backward) stays well inside; a bound scaled to the result is needed
# because over 4096 unit-normal keys the outputs are averages of size
# ~0.03, and one 64-key tile dropped or counted twice moves them by ~1e-2.
# GEGLU: outputs y + FF(y) with |o| up to ~8; one bf16 ulp there is 0.03,
# and the hidden and LN tile are rounded too.
ATTN_REL_TOL, ATTN_ABS_TOL = 2e-2, 1e-3
GEGLU_TOL = 5e-2
# Whole tiny slice, bf16 on the card vs fp32 on the CPU (same bf16-valued
# weights): CFG 7.5 amplifies the bf16 rounding of the UNet output.
PARITY_TOL = 3e-2
# Training kernels against their plain versions on the same bf16 inputs:
# the attention outputs and gradients as above (the forward kernel rounds p
# at its running max, the plain version at the row max); the LSE is fp32
# over the same bf16 logits.  8-bit AdamW: fp32 on both sides (FMA
# contraction, sqrt/exp rounding): the parameters within 1e-6, the int8
# moments off by one on ≤ 0.1% of entries.
LSE_TOL = 1e-3
# Fused GroupNorm, bf16 kernel vs the fp32 plain version on the same bf16
# input: the kernel rounds its fp32 result to bf16 once (half an ulp,
# 2^-9 relative), and sums in another order than the plain version (fp32,
# ~1e-6 of the statistics); per element |err| ≤ 2^-8·|ref| + 1e-3.
GN_REL_TOL, GN_ABS_TOL = 2.0 ** -8, 1e-3
# int8-QK attention against exact (fp32 softmax) attention: JAX's test
# bound, tests/test_ops.py (per-row int8 scales cost ~1-2% of the range).
INT8_EXACT_TOL = 0.04
# The CUDA-core kernels in fp32 against their fp32 plain versions: both in
# fp32, summed in other orders over up to 4096 keys (exp2 and erf an ulp
# or two apart): 1e-4 of the plain result's largest entry plus 1e-6.  In
# bf16 (the fixed cap at head dim 512) the attention tolerance above.
SIMT_FP32_REL_TOL, SIMT_FP32_ABS_TOL = 1e-4, 1e-6
ADAM_P_TOL = 1e-6
ADAM_Q_SHARE = 1e-3
# Tiny train step, bf16 on the card vs fp32 on the CPU: the loss within 2%
# (bf16 activations); Adam normalises each gradient, so elements whose
# gradient is near zero may step either way — the update vectors are held
# to a cosine similarity ≥ 0.9 and every element to the difference of two
# opposite first Adam steps.  Before Adam, the gradients of one micro-batch
# of every UNet self-attention projection (q, k, v, out weights: what the
# flash forward and its two backward kernels feed) are each held to a
# relative error ‖card − cpu‖ / ‖cpu‖ ≤ 5%: bf16 rounding gives ~1%, while
# one of the four 64-key tiles of the 256-token attention lost in dq, dk or
# dv would give ~25%.
TRAIN_LOSS_RTOL = 2e-2
TRAIN_GRAD_RTOL = 5e-2
HELD_GRADS = tuple(f".attn1.{w}.weight" for w in "qkvo")
TRAIN_UPDATE_COS = 0.9
TRAIN_STEP_BOUND = 2.2  # × lr: Adam's first step is ≤ lr·(1 + wd·|p|)

# NVIDIA H100 SXM peaks (data sheet, dense, 700 W): bf16 tensor FLOP/s and
# HBM bytes/s; exp2 on the special-function units: 16 results per SM per
# clock (CUDA C programming guide, compute capability 9.0) × 132 SMs ×
# 1.83 GHz (the clock behind the 989 TFLOP/s figure).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
PEAK_EX2 = 16 * 132 * 1.83e9
PEAK_FP32 = 67e12  # fp32 outside the tensor cores


def bound(nbytes: float, flops: float = 0.0, exps: float = 0.0,
          fp32_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over their peak rates (bf16 tensor FLOPs, exp2s, fp32
    operations outside the tensor cores)."""
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = max(flops / PEAK_BF16_FLOPS, exps / PEAK_EX2,
                fp32_ops / PEAK_FP32)
    if t_ops > t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def attn_bound(b, h, sq, sk, d, matmuls: int, in_rows, out_rows,
               extra_bytes=0.0):
    """Bound of an attention kernel: ``matmuls`` products of 2·Sq·Sk·D
    FLOPs and one exp2 per score; bf16 tensors of ``in_rows`` / ``out_rows``
    (B, H, rows, D) read / written once, plus ``extra_bytes``."""
    flops = matmuls * 2.0 * b * h * sq * sk * d
    nbytes = 2.0 * b * h * d * (sum(in_rows) + sum(out_rows)) + extra_bytes
    return bound(nbytes, flops, float(b * h * sq * sk))


def attn_err(out, ref):
    """(max abs error, tolerance) of an attention output or gradient."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    return err, ATTN_REL_TOL * ref.abs().max().item() + ATTN_ABS_TOL


def simt_err(out, ref):
    """(max abs error, tolerance) of a CUDA-core kernel's result: fp32 as
    ``SIMT_FP32_REL_TOL`` says, bf16 as ``attn_err``."""
    if str(out.dtype) != "torch.float32":
        return attn_err(out, ref)
    ref = ref.float()
    err = (out - ref).abs().max().item()
    return err, SIMT_FP32_REL_TOL * ref.abs().max().item() + SIMT_FP32_ABS_TOL


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


def paired_ms(fns, reps: int = 10, rounds: int = 4):
    """``median_ms`` of each of ``fns`` (a kernel and the library call it
    is held against), taken in alternating order over ``rounds`` rounds
    (a, b, b, a, ...): the median over the rounds of each one's median, so
    drift in the card's clocks during the phase favours neither."""
    got = [[] for _ in fns]
    for r in range(rounds):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            got[i].append(median_ms(fns[i], reps))
    return [statistics.median(g) for g in got]


def back_to_back_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Card ms per call of ``fn`` issued ``n`` times between two CUDA events
    (the median over ``reps``): the host enqueues ahead of the card, so its
    launch path is hidden wherever a call takes the card longer than the
    host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def host_us(fn, reps: int = 100) -> float:
    """Host microseconds per call of ``fn`` issued back to back without a
    synchronize (the enqueue rate): the host's share of a launch-bound
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e6


def device_ms(fn, kernel, n: int = 20, warm: int = 2):
    """Card ms per call of ``fn`` spent in kernels whose name holds
    ``kernel``: their device time over the last ``n`` of ``warm + n`` calls
    in a ``torch.profiler`` trace (CUPTI's kernel records), over ``n``.  The
    ``warm`` calls inside the trace absorb the tracer's start, which can
    lose a record (one of 20 once); fails unless the trace has between
    ``n`` and ``warm + n`` such kernels (so not two a call).  Given a tuple
    of names, a tuple of times from one trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(warm + n):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    out = []
    for name in (kernel,) if isinstance(kernel, str) else kernel:
        us = [e.time_range.elapsed_us() for e in events if name in e.name]
        if not n <= len(us) <= warm + n:
            fail(f"device_ms: {len(us)} {name} kernels in the trace of "
                 f"{warm + n} calls")
        out.append(sum(us[-n:]) / n / 1e3)
    return out[0] if isinstance(kernel, str) else tuple(out)


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


def transformer_launches(c: int, hw: int, rows_batch: int):
    """(flash, geglu) launches of one spatial transformer at ``c`` channels
    on an ``hw``² map of batch ``rows_batch``: the fixed-cap flash call
    from 256 tokens, the fused FF where the GEGLU eligibility rule admits
    its rows."""
    from sdbc_tpu_torch.ops.geglu_ff import _MAX_C, _default_block

    tokens = hw * hw
    rows = rows_batch * tokens
    return (int(tokens >= 256),
            int(c <= _MAX_C and rows % min(_default_block(c), rows) == 0))


def expected_launches(cfg, lat_hw: int, rows_batch: int):
    """(flash, geglu) launches per UNet evaluation: one flash call per
    spatial self-attention with ≥ 256 tokens, one fused FF per transformer
    the GEGLU eligibility rule admits."""
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
        f, g = transformer_launches(c, hw, rows_batch)
        flash += f
        geglu += g
    return flash, geglu


def shallow_launches(cfg, lat_hw: int, rows_batch: int, cache_tail: int = 0):
    """(flash, geglu) launches of a DeepCache reuse evaluation: the shallow
    head (conv_in and the first ct−1 ResBlocks of down[0]) and the fresh
    tail (the last ct ResBlocks of up[-1]), each ResBlock with its level-0
    transformer; ct = cache_tail, 0 meaning all of up[-1]'s
    (``unet.apply``)."""
    u = cfg.unet
    total = u.layers_per_block + 1
    ct = cache_tail if 0 < cache_tail <= total else total
    n = (2 * ct - 1) * u.cross_attn_blocks[0]
    f, g = transformer_launches(u.block_out_channels[0], lat_hw, rows_batch)
    return n * f, n * g


def sampler_evals(scheduler: str, n: int, *, t_start: int = 0, t_end=None,
                  cfg_interval=None, cache_interval: int = 0):
    """The UNet evaluations of one ``sample`` call, in order, as the loop
    of ``graph.sample`` makes them: "guided" (the CFG batch 2B), "cond"
    (outside ``cfg_interval``: the cond branch alone, batch B) or "reuse"
    (a DeepCache step on the cached trunk, batch 2B).  PNDM runs n+1
    evaluations from index 0; LMS n from 0; Heun two a step and one for
    its last (two when ``t_end`` truncates the grid)."""
    t_stop = n if t_end is None else t_end
    lo_hi = None
    if cfg_interval is not None:
        lo_hi = (int(round(cfg_interval[0] * n)),
                 int(round(cfg_interval[1] * n)))

    def kind(i):
        if lo_hi is not None and not lo_hi[0] <= i < lo_hi[1]:
            return "cond"
        return "guided"

    if scheduler == "heun":
        evals = [kind(i) for i in range(t_start, t_stop - 1) for _ in "ab"]
        if t_stop > t_start:
            evals += [kind(t_stop - 1)] * (1 + (t_stop < n))
        return evals
    lo, hi = {"pndm": (0, n + 1), "lms": (0, n)}.get(scheduler,
                                                      (t_start, t_stop))
    return ["reuse" if cache_interval > 1 and (i - t_start) % cache_interval
            else kind(i) for i in range(lo, hi)]


def sampler_launches(cfg, lat_hw: int, b: int, evals,
                     cache_tail: int = 0) -> dict:
    """Kernel launches of the UNet evaluations ``evals``
    (``sampler_evals``) at batch ``b`` images: K1 (``flash_fixed``) and K4
    (``geglu_ff``) per evaluation, every other count 0."""
    from sdbc_tpu_torch.ops import _kernels

    want = dict.fromkeys(_kernels.launches, 0)
    for kind in evals:
        if kind == "reuse":
            f, g = shallow_launches(cfg, lat_hw, 2 * b, cache_tail)
        else:
            f, g = expected_launches(cfg, lat_hw, b if kind == "cond"
                                     else 2 * b)
        want["flash_fixed"] += f
        want["geglu_ff"] += g
    return want


def generate_launches(cfg, n_prompts: int, steps: int, img: int,
                      scheduler: str = "dpm", hires_scale: float = 0.0,
                      hires_strength: float = 0.7) -> dict:
    """K1/K4 launches of one ``SDPipeline.generate`` call of ``n_prompts``
    at img² (``sampler_launches``): the UNet runs the batch bucket; with
    ``hires_scale`` the first stage composes at img ÷ scale (snapped to
    8·vae_scale px) and the second runs the evaluations left from
    ``img2img_t_start`` of ``hires_strength`` at img²."""
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline, img2img_t_start

    b = next(s for s in SDPipeline.BATCH_BUCKETS if s >= n_prompts)
    f = cfg.vae_scale
    if not hires_scale:
        return sampler_launches(cfg, img // f, b,
                                sampler_evals(scheduler, steps))
    m = 8 * f
    base = max(m, int(round(img / hires_scale / m)) * m)
    first = sampler_launches(cfg, base // f, b,
                             sampler_evals(scheduler, steps))
    t_start = img2img_t_start(steps, hires_strength,
                              cfg.schedule.steps_offset)
    second = sampler_launches(cfg, img // f, b, sampler_evals(
        scheduler, steps, t_start=t_start))
    return {k: first[k] + second[k] for k in first}


def n_transformers(u) -> int:
    """Spatial transformers of one UNet: each makes two attention calls."""
    levels = sum(u.cross_attn_blocks)
    return levels * u.layers_per_block + levels * (u.layers_per_block + 1) + 1


def recorded_gn_sites(run):
    """(shape, groups, act, recomputed) of every ``nn.group_norm`` call
    ``run()`` makes, on the meta device (shapes only, nothing computed);
    ``recomputed``: inside one of the UNet's gradient-checkpointed regions,
    so called again in the backward pass.  The calls are recorded, not
    dispatched; attention is left out (its output takes q's shape) and each
    region runs inline once."""
    import torch

    from sdbc_tpu_torch.models import unet as unet_mod
    from sdbc_tpu_torch.models import vae as vae_mod
    from sdbc_tpu_torch.ops import nn

    sites, depth = [], [0]

    def record(x, weight, bias, num_groups=32, eps=1e-6, act=None):
        sites.append((tuple(x.shape), num_groups, act, depth[0] > 0))
        return x

    def inline(fn, *args, **_):
        depth[0] += 1
        try:
            return fn(*args)
        finally:
            depth[0] -= 1

    def attend(q, k, v, **_):
        return q

    stubs = [(nn, "group_norm", record), (unet_mod, "checkpoint", inline),
             (unet_mod, "attention", attend),
             (unet_mod, "attention_bshd_inference", attend),
             (vae_mod, "attention", attend)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stubs]
    for mod, name, fn in stubs:
        setattr(mod, name, fn)
    try:
        with torch.no_grad():
            run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return sites


def _fused(sites) -> int:
    """Launches of the fused GroupNorm over recorded sites, by the dispatch
    rule of ``nn.group_norm`` (each recomputed site twice)."""
    from sdbc_tpu_torch.ops.pallas_groupnorm import fits

    return sum((1 + ck) * (act in (None, "silu") and fits(shape, g))
               for shape, g, act, ck in sites)


def unet_gn_sites(cfg, lat_hw: int, remat_mode=None):
    """The GroupNorm sites of one UNet forward at batch 1 (``remat_mode``:
    with gradient checkpointing in that mode)."""
    import torch

    from sdbc_tpu_torch.models import unet as unet_mod

    meta = dict(device="meta")
    model = unet_mod.init(cfg.unet, **meta)
    return recorded_gn_sites(lambda: unet_mod.apply(
        model, torch.empty(1, lat_hw, lat_hw, cfg.unet.in_channels, **meta),
        torch.zeros(1, dtype=torch.int64, **meta),
        torch.empty(1, cfg.clip.ctx, cfg.unet.cross_attention_dim, **meta),
        remat=remat_mode is not None, remat_mode=remat_mode or "block"))


def vae_gn_sites(cfg, hw: int, part: str):
    """The GroupNorm sites of one VAE encode (``hw``: the image side) or
    decode (``hw``: the latent side) of one image."""
    import torch

    from sdbc_tpu_torch.models import vae as vae_mod

    meta = dict(device="meta")
    model = vae_mod.init(cfg.vae, **meta)
    if part == "encode":
        x = torch.empty(1, hw, hw, cfg.vae.in_channels, **meta)
        return recorded_gn_sites(lambda: vae_mod.encode_moments(model, x))
    z = torch.empty(1, hw, hw, cfg.vae.latent_channels, **meta)
    return recorded_gn_sites(lambda: vae_mod.decode(model, z))


def gn_launches(cfg, lat_hw: int, remat_mode=None) -> int:
    """Fused GroupNorm launches of one UNet forward (and, under
    ``remat_mode``, its recompute in the backward pass)."""
    return _fused(unet_gn_sites(cfg, lat_hw, remat_mode))


def vae_gn_launches(cfg, hw: int, part: str) -> int:
    return _fused(vae_gn_sites(cfg, hw, part))


def expected_train_launches(cfg, tcfg, img_hw: int, n8: int,
                            switches: bool = False):
    """Kernel launches of one optimizer step: ``switches`` = under
    ``SWITCHES`` (the fused GroupNorm and the transposed-layout flash for
    every attention call, the VAE encode's included), else the default
    dispatch.  Under ``remat`` the GroupNorms of the checkpointed regions
    (as recorded) run twice; only "block" recomputes the attention."""
    from sdbc_tpu_torch.models.vae import prefer_chunked_encode
    from sdbc_tpu_torch.ops import _kernels

    lat = img_hw // cfg.vae_scale
    micro, accum = tcfg.micro_batch, tcfg.grad_accum
    encodes = micro if prefer_chunked_encode(micro, img_hw, img_hw) else 1
    remat = tcfg.remat_mode if tcfg.grad_ckpt else None
    attn_again = 2 if remat == "block" else 1
    want = dict.fromkeys(_kernels.launches, 0)
    want["adam8"] = int(n8 > 0)  # one launch over every 8-bit leaf
    if switches:
        calls = 2 * n_transformers(cfg.unet)
        want["flash_tt"] = accum * (attn_again * calls + encodes)
        want["gn_fused"] = accum * (
            gn_launches(cfg, lat, remat)
            + encodes * vae_gn_launches(cfg, img_hw, "encode"))
    else:
        calls, _ = expected_launches(cfg, lat, micro * cfg.unet.attention_heads)
        # the VAE's single-head mid attention meets the flash rule only
        # where its head is ≤ 256 wide (the tiny VAE, not SD-1.5's)
        low = img_hw >> (len(cfg.vae.block_out_channels) - 1)
        vae = encodes * (low * low >= 256 and cfg.vae.block_out_channels[-1]
                         <= 256)
        want["flash_fwd"] = accum * (attn_again * calls + vae)
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = accum * calls
    return want


# K1 at the hires shape is held to its plain version on every 16th query
HIRES_Q_STRIDE = 16

SWITCHES = {"SDBC_GN_FUSED": "1", "SDBC_ATTN_IMPL": "flash_tt"}
# the path whose run gives each kernel's ``launches`` in the kernels line:
# the sampling kernels' slice, the training kernels' step, the switches'
# train step for the fused GroupNorm and the transposed-layout forward, and
# this slice's gradient-checkpointed step for the int8-QK attention, which
# no path of either package dispatches (each row also lists every path)
MAIN_PATH = {"flash_fixed": "sampling", "geglu_ff": "sampling",
             "flash_fwd": "train", "flash_bwd_dq": "train",
             "flash_bwd_dkv": "train", "adam8": "train",
             "gn_fused": "train switches", "flash_tt": "train switches",
             "flash_fixed_int8": "train grad_ckpt block",
             "flash_fixed_simt": "sampling fp32 (tiny)",
             "geglu_ff_simt": "sampling fp32 (tiny)",
             "flash_fwd_simt": "train fp32 (tiny)",
             "flash_bwd_simt_dq": "train fp32 (tiny)",
             "flash_bwd_simt_dkv": "train fp32 (tiny)"}
# in fp32 every attention and FF call the tensor-core kernels would take
# goes to the CUDA-core kernel of the same function
SIMT_OF = {"flash_fixed": "flash_fixed_simt", "geglu_ff": "geglu_ff_simt",
           "flash_fwd": "flash_fwd_simt", "flash_bwd_dq": "flash_bwd_simt_dq",
           "flash_bwd_dkv": "flash_bwd_simt_dkv"}


def fp32_launches(want: dict) -> dict:
    """The launch counts of the same run in fp32: each count moved from a
    tensor-core kernel to its CUDA-core counterpart (``SIMT_OF``)."""
    out = dict.fromkeys(want, 0)
    for name, n in want.items():
        out[SIMT_OF.get(name, name)] += n
    return out


@contextlib.contextmanager
def environment(**values):
    """Set environment variables for a phase and restore them after it,
    whatever happens inside."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    """Builds the kernels and checks their registers and SASS; returns the
    8-bit AdamW kernel's instruction counts (``adam8_sass``) and the fused
    GroupNorm's build report (``gn_build``)."""
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
    ptxas = sm90_ptxas(lines)
    for name, info in ptxas.items():
        print(f"[build] {name}: {info}", flush=True)
    wide = [n for n in ptxas if n.startswith("flash_bwd_d") and "_wide" in n]
    print(f"[build] the wide backward (csrc/flash_bwd_wide_sm90.cu): "
          f"{len(wide)} instantiations, spilling: "
          f"{[n for n in wide if ' 0 bytes spill stores' not in ptxas[n]]}",
          flush=True)
    simt = simt_ptxas(lines)
    print(f"[build] the CUDA-core kernels (csrc/flash_simt.cu, "
          f"csrc/geglu_ff_simt.cu): {len(simt)} instantiations; {simt}",
          flush=True)
    sass = sass_text(lib)
    return {"adam8": sm90_sass(sass), "gn": gn_build(lines, sass),
            "int8": int8_build(lines, sass)}


def simt_ptxas(lines):
    """ptxas's registers and spills of each CUDA-core kernel instantiation
    (``flash_simt_{fwd,dq,dkv}_kernel<T, ...>``, ``geglu_ff_simt_kernel<T>``,
    by mangled name) from the ``-Xptxas -v`` log."""
    import re

    out, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(r"_Z\w*(?:flash_simt_\w+_kernel|geglu_ff_simt_kernel)"
                          r"\w*", ln)
            cur = m.group(0) if m else None
        elif cur and ("registers" in ln or "spill" in ln):
            out.setdefault(cur, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass_text(lib):
    """``cuobjdump -sass`` of the built library (None without cuobjdump)."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "",
                                                     "bin", "cuobjdump")
    if not os.path.exists(tool):
        print("[build] SASS: cuobjdump not found, not checked", flush=True)
        return None
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


# the fused GroupNorm's instantiations gn_cluster_kernel<T, W, SILU>
GN_KERNEL = r"gn_cluster_kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E"
# K8's shapes: the UNet's GroupNorm inputs of sampling batch 8, one ragged
# case (label, shape, groups, eps, act)
GN_CASES = [("64^2x320 silu", (8, 64, 64, 320), 32, 1e-5, "silu"),
            ("32^2x640 silu", (8, 32, 32, 640), 32, 1e-5, "silu"),
            ("16^2x1280 silu", (8, 16, 16, 1280), 32, 1e-5, "silu"),
            ("8^2x1280 silu", (8, 8, 8, 1280), 32, 1e-5, "silu"),
            ("64^2x320 no act", (8, 64, 64, 320), 32, 1e-6, None),
            ("ragged 200 rows x96", (2, 200, 96), 32, 1e-5, "silu")]


def _gn_name(m) -> str:
    t = "bf16" if m.group(1).startswith("13") else "float"
    return (f"gn_cluster_kernel<{t}, {m.group(2)}, "
            f"{'true' if m.group(3) == '1' else 'false'}>")


def gn_build(lines, sass):
    """The fused GroupNorm's build report: ptxas's registers, spills and
    static shared memory per instantiation; in its SASS the bulk copies
    (UBLKCP) and any reduction or atomic (RED, ATOM*), failing on a float
    one or on a 16-byte instantiation without bulk copies; the card's
    ``cudaOccupancyMaxActiveClusters`` for clusters of 1 to 16 CTAs at the
    full 512 threads and 227 KB; and the plan ``pallas_groupnorm.plan``
    chooses at each of K8's shapes."""
    import re

    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import pallas_groupnorm as pgn

    ptxas, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(GN_KERNEL, ln)
            cur = _gn_name(m) if m else None
        elif cur and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(cur, []).append(ln.split(":", 1)[-1].strip())
    ptxas = {k: "; ".join(v) for k, v in ptxas.items()}
    counts = {}
    for part in (sass or "").split("Function : ")[1:]:
        m = re.match(r"\S*?" + GN_KERNEL, part)
        if m:
            atom = re.findall(r"\b(?:RED|ATOM|ATOMS|ATOMG)\.[\w.]*", part)
            counts[_gn_name(m)] = dict(
                UBLKCP=len(re.findall(r"\bUBLKCP\b", part)),
                RED_ATOM=len(atom),
                float_RED_ATOM=sum(bool(re.search(r"\.F(16|32|64)\b", a))
                                   for a in atom))
    print(f"[build] gn_cluster_kernel ptxas: {ptxas}", flush=True)
    print(f"[build] gn_cluster_kernel SASS (UBLKCP, RED/ATOM, float "
          f"RED/ATOM): {counts or 'not checked'}", flush=True)
    if sass is not None:
        if len(counts) != 8:
            fail(f"gn_cluster_kernel: {len(counts)} of 8 instantiations in "
                 f"the built SASS")
        for name, n in counts.items():
            vec = ", 8," in name or ", 4," in name
            if n["float_RED_ATOM"] or (vec and n["UBLKCP"] == 0):
                fail(f"{name}: SASS counts {n}")
    occ = [_kernels.group_norm_max_clusters(torch.bfloat16, True, True, cs,
                                            pgn.MAX_THREADS, pgn.SMEM_MAX)
           for cs in range(1, 17)]
    plans = {}
    for label, shape, groups, _, act in GN_CASES:
        n, c = shape[0], shape[-1]
        hw = math.prod(shape[1:-1])
        p = pgn._card_plan(n, hw, c, torch.bfloat16, groups, True,
                           act == "silu", torch.cuda.current_device())
        plans[label] = dict(cluster=p.cluster, threads=p.threads, lanes=p.lanes, cv=p.cv,
                            resident=p.resident, rows=p.rows_max,
                            smem=p.smem, waves=p.waves)
    print(f"[build] gn_cluster_kernel max active clusters of 1..16 CTAs "
          f"(bf16, SiLU, {pgn.MAX_THREADS} threads, {pgn.SMEM_MAX} B of "
          f"shared memory): {occ} (16 CTAs: {occ[15]}, 8 CTAs: {occ[7]}); "
          f"plans (bf16) {plans}", flush=True)
    return {"ptxas": ptxas, "sass": counts, "max_clusters": occ,
            "plans": plans}


# K10's instantiations flash_int8_sm90_kernel<DP, KS8, NV>; the main path's
# (head dims 40, 80, 160)
INT8_KERNEL = r"flash_int8_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)E"
INT8_MAIN = ("<64, 2, 48>", "<128, 3, 80>", "<192, 5, 160>")


def int8_build(lines, sass):
    """K10's build report: ptxas's registers and spills of each
    ``flash_int8_sm90_kernel`` instantiation and of ``quantize_k_kernel``;
    in each instantiation's SASS the integer and bf16 wgmma products
    (IGMMA, HGMMA), TMA loads and stores, and any mma.sync (HMMA, IMMA),
    failing unless all seven have IGMMA, HGMMA and UTMALDG and none HMMA or
    IMMA; and at the main path's instantiations the instructions per score
    (each score's code has one MUFU.EX2, so a count over the MUFU.EX2
    count; an upper bound: q's quantization, the epilogue and the
    producer's quantization of k are counted in)."""
    import re

    name = lambda m: (f"flash_int8_sm90_kernel<{m.group(1)}, {m.group(2)}, "
                      f"{m.group(3)}>")
    ptxas, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(INT8_KERNEL, ln)
            cur = name(m) if m else (
                "quantize_k_kernel" if "quantize_k_kernel" in ln else None)
        elif cur and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(cur, []).append(ln.split(":", 1)[-1].strip())
    ptxas = {k: "; ".join(v) for k, v in ptxas.items()}
    kinds = {"fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP"),
             "integer": ("IADD3", "IMAD", "LOP3", "SHF", "ISETP"),
             "I2F": ("I2F", "I2FP"), "F2I": ("F2I", "F2IP"),
             "F2FP": ("F2FP",), "LDS": ("LDS",)}
    counts, per_score = {}, {}
    for part in (sass or "").split("Function : ")[1:]:
        m = re.match(r"\S*?" + INT8_KERNEL, part)
        if not m:
            continue
        ops = [o for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", part)
            if o != "NOP"]
        base = [o.split(".")[0] for o in ops]
        n = {op: base.count(op) for op in ("IGMMA", "HGMMA", "UTMALDG",
                                           "UTMASTG", "HMMA", "IMMA")}
        counts[name(m)] = n
        ex2 = ops.count("MUFU.EX2")
        if name(m).endswith(INT8_MAIN) and ex2:
            per_score[name(m)] = dict(
                MUFU_EX2=ex2, all=round(len(ops) / ex2, 2),
                **{k: round(sum(b in v for b in base) / ex2, 2)
                   for k, v in kinds.items()})
    print(f"[build] flash_int8_sm90_kernel ptxas: {ptxas}", flush=True)
    print(f"[build] flash_int8_sm90_kernel SASS (IGMMA, HGMMA, UTMALDG, "
          f"UTMASTG, HMMA, IMMA): {counts or 'not checked'}", flush=True)
    print(f"[build] flash_int8_sm90_kernel SASS instructions per score "
          f"(over the MUFU.EX2 count; an upper bound): "
          f"{per_score or 'not checked'}", flush=True)
    if sass is not None:
        if len(counts) != 7:
            fail(f"flash_int8_sm90_kernel: {len(counts)} of 7 "
                 f"instantiations in the built SASS")
        for kname, n in counts.items():
            if not (n["IGMMA"] and n["HGMMA"] and n["UTMALDG"]) \
                    or n["HMMA"] or n["IMMA"]:
                fail(f"{kname}: SASS counts {n}")
    return {"ptxas": ptxas, "sass": counts, "per_score": per_score}


# the wgmma kernels (csrc/flash_fwd_sm90.cu, csrc/flash_fwd_wide_sm90.cu,
# csrc/flash_bwd_sm90.cu, csrc/flash_bwd_wide_sm90.cu,
# csrc/geglu_ff_sm90.cu): each instantiation's mangled name and template
# arguments
SM90_KERNELS = (r"(flash_fwd_sm90_kernel|flash_fwd_wide_sm90_kernel|"
                r"flash_bwd_dq_sm90_kernel|flash_bwd_dkv_sm90_kernel|"
                r"flash_bwd_dq_wide_sm90_kernel|"
                r"flash_bwd_dkv_wide_sm90_kernel|"
                r"geglu_ff_sm90_kernel)ILi(\d+)E"
                r"(?:Li(\d+)E)?((?:Lb[01]E)*)")
SM90_KERNEL_NAMES = ("flash_fwd_sm90_kernel", "flash_fwd_wide_sm90_kernel",
                     "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
                     "flash_bwd_dq_wide_sm90_kernel",
                     "flash_bwd_dkv_wide_sm90_kernel",
                     "geglu_ff_sm90_kernel")


def _sm90_name(m) -> str:
    """``kernel<DP, KS, ONLINE, TT>`` (as many arguments as it has) of a
    mangled instantiation name."""
    import re

    args = [a for a in (m.group(2), m.group(3)) if a is not None]
    args += ["true" if b == "1" else "false"
             for b in re.findall(r"Lb([01])E", m.group(4) or "")]
    return f"{m.group(1)}<{', '.join(args)}>"


def sm90_sass(sass):
    """Counts, in the built SASS (``sass_text``) of each wgmma kernel
    instantiation, the wgmma products (HGMMA), TMA loads and stores
    (UTMALDG, UTMASTG) and mma.sync products (HMMA); fails if one has no
    HGMMA or no UTMALDG, or any HMMA, or if a transposed-layout forward
    (K9, ``TT``) was not built, at head dims up to 256 and above.  Returns
    the 8-bit AdamW kernel's instruction counts (``adam8_sass``)."""
    import re

    if sass is None:
        return None
    found = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*?" + SM90_KERNELS, part)
        if m:
            found[_sm90_name(m)] = {
                op: len(re.findall(rf"\b{op}\b", part))
                for op in ("HGMMA", "UTMALDG", "UTMASTG", "HMMA")}
    print(f"[build] SASS of the wgmma kernels (HGMMA, UTMALDG, UTMASTG, "
          f"HMMA): {found or 'no kernel found'}", flush=True)
    names = {n.split("<")[0] for n in found}
    for kernel in SM90_KERNEL_NAMES:
        if kernel not in names:
            fail(f"{kernel}: not in the built SASS")
    for kernel, tt in (("flash_fwd_sm90_kernel", ", true, true>"),
                       ("flash_fwd_wide_sm90_kernel", ", true, false>")):
        if not any(n.startswith(kernel + "<") and n.endswith(tt)
                   for n in found):
            fail(f"{kernel}: no transposed-layout (TT) instantiation in the "
                 f"built SASS")
    for name, n in found.items():
        if n["HGMMA"] == 0 or n["UTMALDG"] == 0 or n["HMMA"]:
            fail(f"{name}: SASS counts {n}")
    return adam8_sass(sass)


def adam8_sass(sass: str) -> dict:
    """Counts the instructions of ``adam8_leaves_kernel`` in the built SASS
    (NOPs of the alignment padding left out): the kernel's body, without
    the out-of-line subroutines it CALLs (the slow paths of the IEEE
    square root and reciprocal), in all, by kind and per element.  One
    thread updates 16 elements of a row, so the body over 16 is an upper
    bound on what a thread issues per element: the body also holds the
    per-row set-up, the scalar path of ragged ends and the IEEE roots
    taken near a rounding tie, which run once per 16 elements or rarely."""
    import re

    part = next((p for p in sass.split("Function : ")[1:]
                 if "adam8_leaves_kernel" in p.split(None, 1)[0]), None)
    if part is None:
        fail("adam8_leaves_kernel: not in the built SASS")
    inst = [(int(m.group(1), 16), m.group(2), m.group(0)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*",
        part)]
    calls = [int(t, 16) for _, op, text in inst if op == "CALL"
             for t in re.findall(r"0x([0-9a-f]+)", text)[:1]]
    end = min(calls) if calls else float("inf")
    body = [op for addr, op, _ in inst if addr < end and op != "NOP"]
    kinds = {"MUFU": ("MUFU",),
             "fp32": ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP",
                      "FRND"),
             "conversions": ("I2F", "F2I", "F2F", "I2FP", "F2IP"),
             "global memory": ("LDG", "STG")}
    counts = dict(
        instructions=len([op for _, op, _ in inst if op != "NOP"]),
        body=len(body), body_per_element=len(body) / 16,
        body_by_kind={k: sum(op in v for op in body)
                      for k, v in kinds.items()})
    print(f"[build] adam8_leaves_kernel SASS: {counts['instructions']} "
          f"instructions, {len(body)} in the body ({len(body) / 16:.1f} per "
          f"element, an upper bound: 16 elements a thread per row); body by "
          f"kind {counts['body_by_kind']}", flush=True)
    return counts


def sm90_ptxas(lines):
    """ptxas's registers and spills of each wgmma kernel instantiation and
    of the 8-bit AdamW kernel from the ``-Xptxas -v`` log, and any warning
    about a register reallocation (setmaxnreg)."""
    import re

    out, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = re.search(SM90_KERNELS, ln)
            cur = _sm90_name(m) if m else (
                "adam8_leaves_kernel" if "adam8_leaves_kernel" in ln else None)
        elif cur and ("registers" in ln or "spill" in ln):
            out.setdefault(cur, []).append(ln.split(":", 1)[-1].strip())
        elif "setmaxnreg" in ln:
            out.setdefault("warning", []).append(ln.strip())
    return {k: "; ".join(v) for k, v in out.items()}


def phase_kernels(gn_build_report=None, int8_build_report=None):
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
    # projection layout at batch 8 and 4, one head-major call, one ragged
    # call
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    flash_cases = [("bshd 64^2 d40", "bshd", (8, 4096, 8, 40), 4096),
                   ("bshd 32^2 d80", "bshd", (8, 1024, 8, 80), 1024),
                   ("bshd 16^2 d160", "bshd", (8, 256, 8, 160), 256),
                   # batch 4: cfg_interval's cond-only evaluations
                   ("bshd 64^2 d40 batch 4", "bshd", (4, 4096, 8, 40), 4096),
                   ("bshd 32^2 d80 batch 4", "bshd", (4, 1024, 8, 80), 1024),
                   ("bshd 16^2 d160 batch 4", "bshd", (4, 256, 8, 160), 256),
                   ("bhsd 32^2 d80", "bhsd", (8, 8, 1024, 80), 1024),
                   ("bshd ragged Sq200 Sk300 d40", "bshd", (2, 200, 8, 40),
                    300),
                   # hires-fix's second stage: 1024², 128² latents, CFG
                   # batch 2; the plain version on every HIRES_Q_STRIDE-th
                   # query (its full fp32 scores would take 17 GB)
                   ("bshd 128^2 d40 hires batch 2", "bshd",
                    (2, 16384, 8, 40), 16384)]
    flash_err, first = 0.0, None
    for label, layout, qshape, sk in flash_cases:
        kshape = list(qshape)
        kshape[1 if layout == "bshd" else 2] = sk
        q, k, v = randn(*qshape), randn(*kshape), randn(*kshape)
        # queries the plain version computes: attention is row-wise, so a
        # strided slice of them is exact
        qs = HIRES_Q_STRIDE if "hires" in label else 1
        if layout == "bshd":
            kern = lambda: fa.flash_attention_fixed_bshd(q, k, v)
            plain = lambda: tr(fa.fixed_cap_attention_ref(
                tr(q[:, ::qs]).float(), tr(k).float(), tr(v).float()))
        else:
            kern = lambda: fa.flash_attention_fixed(q, k, v)
            plain = lambda: fa.fixed_cap_attention_ref(q.float(), k.float(),
                                                       v.float())
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err, tol = attn_err(out[:, ::qs], ref)
        if not torch.isfinite(out).all() or not err <= tol:
            fail(f"flash {label}: max abs err {err} > {tol}")
        pms = median_ms(plain, 5)
        del ref
        qh, kh, vh = (q, k, v) if layout == "bhsd" else (tr(q), tr(k), tr(v))
        ms, lms = paired_ms([kern, lambda: sdpa(qh, kh, vh)])
        b, h, sq, d = qh.shape
        bms, by = attn_bound(b, h, sq, sk, d, 2, (sq, sk, sk), (sq,))
        part = f" (on 1/{qs} of the queries)" if qs > 1 else ""
        print(f"[kernels] flash_fixed {label}: max_abs_err {err:.3e}{part} "
              f"(tol {tol:.3e}) kernel {ms:.4f} ms plain{part} {pms:.4f} ms "
              f"sdpa {lms:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        print(f"[kernels] flash_fixed {label}: kernel {ms:.4f} ms, sdpa "
              f"{lms:.4f} ms (kernel/sdpa {ms / lms:.2f}), bound {bms:.4f} ms, "
              f"{100 * bms / ms:.1f}% of the bound", flush=True)
        flash_err = max(flash_err, err)
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         library_ms=lms)
    rows.append({"name": "flash_fixed", "route": "cuda",
                 "source": "sdbc_tpu_torch/csrc/flash_fwd_sm90.cu",
                 "replaces": "sdbc_tpu/ops/flash_attention.py:348",
                 "max_abs_err": flash_err, **first,
                 "serves": "head dims <= 256 (every main-path call): "
                           "flash_fwd_sm90_kernel<DP, KS, false, false> in "
                           "csrc/flash_fwd_sm90.cu; head dims above 256 (the "
                           "VAE's 512-wide head under SDBC_ATTN_IMPL="
                           "inference): flash_fwd_wide_sm90_kernel<KS1, "
                           "false, true> in csrc/flash_fwd_wide_sm90.cu",
                 "d512": kernel_flash_fixed_wide(g)})

    geglu_err, first, shapes = 0.0, None, []
    # batch 8 (CFG), then batch 4 (cfg_interval's cond-only evaluations)
    for rows_n, c in ((32768, 320), (8192, 640), (16384, 320), (4096, 640)):
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
        pms = median_ms(plain, 10)
        # the kernel and the unfused bf16 feed-forward the model runs where
        # the kernel does not apply (cuBLAS products, hidden through HBM),
        # in alternating rounds
        unfused = lambda: unfused_ff(*args)
        ms, ums = paired_ms([kern, unfused], reps=20)
        # LN → (rows, c)·(c, 8c) → GEGLU → (rows, 4c)·(4c, c) → residual:
        # y read and out written once (bf16), the weights read once
        bms, by = bound(2.0 * (2 * rows_n * c + 12 * c * c + 9 * c)
                        + 8.0 * c, 24.0 * rows_n * c * c)
        print(f"[kernels] geglu_ff ({rows_n}, {c}): max_abs_err {err:.3e} "
              f"kernel {ms:.4f} ms plain {pms:.4f} ms unfused-bf16 "
              f"{ums:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        print(f"[kernels] geglu_ff ({rows_n}, {c}): kernel {ms:.4f} ms, "
              f"unfused-bf16 {ums:.4f} ms (kernel/unfused {ms / ums:.2f}), "
              f"bound {bms:.4f} ms, {100 * bms / ms:.1f}% of the bound",
              flush=True)
        geglu_err = max(geglu_err, err)
        shapes.append(dict(rows=rows_n, c=c, ms=ms, unfused_ms=ums,
                           bound_share=bms / ms))
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         library_ms=None, unfused_ms=ums,
                         bound_share=bms / ms)
    rows.append({"name": "geglu_ff", "route": "cuda",
                 "source": "sdbc_tpu_torch/csrc/geglu_ff_sm90.cu",
                 "replaces": "sdbc_tpu/ops/geglu_ff.py:98",
                 "max_abs_err": geglu_err, **first, "shapes": shapes})
    return rows + [kernel_group_norm(g, gn_build_report),
                   kernel_int8(g, int8_build_report)]


def kernel_group_norm(g, build_report=None):
    """K8 at the UNet's GroupNorm inputs of sampling batch 8, and a ragged
    case, against its plain version (every element within GN_REL_TOL·|ref|
    + GN_ABS_TOL, two calls bit for bit equal).  Scale and bias in bf16, as
    the bf16 UNet hands them.  Timed in alternating rounds against the
    library (F.group_norm then F.silu on the NHWC input as a channels-last
    view, and on a contiguous NCHW copy), back to back (the host's path
    hidden), and the call's host µs; at the largest shape also with the
    plan forced to clusters of 16 and of 8 CTAs, back to back."""
    import torch
    import torch.nn.functional as F

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import pallas_groupnorm as pgn

    dev = torch.device("cuda")
    worst, first, shapes, clusters = 0.0, None, [], {}
    for label, shape, groups, eps, act in GN_CASES:
        c = shape[-1]
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).bfloat16()
        w = (torch.randn(c, generator=g, device=dev) * 0.3 + 1.0).bfloat16()
        b = (torch.randn(c, generator=g, device=dev) * 0.2).bfloat16()
        kern = lambda: pgn.fused_group_norm(x, w, b, groups, eps, act)
        plain = lambda: pgn.group_norm_fused_ref(x.float(), w, b, groups, eps,
                                                 act)
        out = kern()
        torch.cuda.synchronize()
        ref = plain()

        def check(y, what):
            err = (y.float() - ref).abs()
            if not (torch.isfinite(y).all()
                    and (err <= GN_REL_TOL * ref.abs() + GN_ABS_TOL).all()):
                fail(f"gn_fused {label}{what}: max abs err "
                     f"{err.max().item()}")
            return err.max().item()
        err = check(out, "")
        if not torch.equal(out.view(torch.int16), kern().view(torch.int16)):
            fail(f"gn_fused {label}: two calls differ")
        # the library on the same NHWC tensor as an (N, C, H, W) view in
        # channels-last layout (whatever layout work it does is in its
        # time), and on a contiguous NCHW copy, its own layout
        xcl = x.movedim(-1, 1)
        xnchw = xcl.contiguous()

        def library(xv):
            if act == "silu":
                return lambda: F.silu(F.group_norm(xv, groups, w, b, eps))
            return lambda: F.group_norm(xv, groups, w, b, eps)
        pms = median_ms(plain, 10)
        ms, lms, nchw_ms = paired_ms([kern, library(xcl), library(xnchw)],
                                     reps=20)
        b2b, hus = back_to_back_ms(kern), host_us(kern)
        dms = device_ms(kern, "gn_cluster_kernel")
        # x read and y written once (bf16), scale and bias read (bf16)
        bms, by = bound(4.0 * x.numel() + 4.0 * c, fp32_ops=6.0 * x.numel())
        n = shape[0]
        p = pgn._card_plan(n, x.numel() // (n * c), c, x.dtype, groups, True,
                           act == "silu", x.device.index)
        print(f"[kernels] gn_fused {label}: max_abs_err {err:.3e} kernel "
              f"{ms:.4f} ms (back to back {b2b:.4f} ms, host {hus:.1f} us a "
              f"call, on the card {dms:.4f} ms a call) plain {pms:.4f} ms F.group_norm"
              f"{'+F.silu' if act else ''} {lms:.4f} ms (channels-last "
              f"view; on a contiguous NCHW copy {nchw_ms:.4f} ms; kernel/"
              f"library {ms / lms:.2f}) bound {bms:.4f} ms ({by}), "
              f"{100 * bms / ms:.1f}% of the bound ({100 * bms / b2b:.1f}% "
              f"back to back, {100 * bms / dms:.1f}% on the card); plan "
              f"cluster {p.cluster} threads {p.threads} "
              f"resident {p.resident}/{p.rows_max} rows smem {p.smem} B "
              f"waves {p.waves}", flush=True)
        worst = max(worst, err)
        shapes.append(dict(label=label, ms=ms, back_to_back_ms=b2b,
                           host_us=hus, device_ms=dms, library_ms=lms,
                           nchw_ms=nchw_ms,
                           plain_ms=pms, bound_ms=bms,
                           bound_share=bms / ms, b2b_bound_share=bms / b2b,
                           cluster=p.cluster, resident=p.resident, rows=p.rows_max,
                           waves=p.waves))
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         library_ms=lms, back_to_back_ms=b2b, host_us=hus,
                         device_ms=dms)
            # the cluster size the plan weighs: 16 and 8 CTAs a sample
            y3 = torch.empty_like(x)
            occ = pgn.card_occupancy(x.dtype, True, act == "silu",
                                     x.device.index)
            for cs in sorted({16, 9, 8, p.cluster}, reverse=True):
                q = pgn.plan(n, p.hw, c, x.dtype, groups,
                             lambda k, t, m, cs=cs: occ(k, t, m)
                             if k == cs else 0)
                launch = _kernels.group_norm_launch(
                    n, p.hw, c, groups, q, eps, act == "silu", x.dtype,
                    w.dtype, b.dtype)
                run = lambda: _kernels.group_norm(x, w, b, y3, launch)
                run()
                torch.cuda.synchronize()
                check(y3, f" at cluster {cs}")
                held = occ(cs, q.threads, q.smem)
                clusters[cs] = dict(
                    back_to_back_ms=back_to_back_ms(run),
                    device_ms=device_ms(run, "gn_cluster_kernel"),
                    max_clusters=held, resident=q.resident, rows=q.rows_max,
                    smem=q.smem)
            print(f"[kernels] gn_fused {label} by cluster size (card ms a "
                  f"call from the profiler, back to back ms, clusters the "
                  f"card holds at once, resident/rows a CTA): " + "; ".join(
                      f"{cs}: {v['device_ms']:.4f} ms, "
                      f"{v['back_to_back_ms']:.4f} ms, {v['max_clusters']}, "
                      f"{v['resident']}/{v['rows']}"
                      for cs, v in clusters.items()), flush=True)
            del y3
        del x, out, ref, xnchw
    return {"name": "gn_fused", "route": "cuda",
            "source": "sdbc_tpu_torch/csrc/group_norm_sm90.cu",
            "replaces": "sdbc_tpu/ops/pallas_groupnorm.py:79",
            "max_abs_err": worst, **first, "shapes": shapes,
            "clusters": clusters, "build": build_report}


# K10's shapes: the sampling attention levels, head-major (batch 8 with CFG)
INT8_CASES = ((8, 8, 4096, 40), (8, 8, 1024, 80), (8, 8, 256, 160))


def kernels_per_call(fn):
    """The names of the CUDA kernels one call of ``fn`` runs (a profiler
    trace of one warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_int8(g, build_report=None):
    """K10 at the sampling attention shapes against its plain version (and
    two calls bit for bit) and exact attention; timed one call at a time in
    alternating rounds with K1 (the bf16 fixed cap on the same head-major
    tensors) and SDPA (exact, not int8), also 20 back to back and its host
    µs; the CUDA kernels of one call (the pre-pass and the attention
    kernel) from the profiler."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import attention as attn
    from sdbc_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    worst, first, shapes = 0.0, None, []
    want = ["quantize_k_kernel", "flash_int8_sm90_kernel"]
    for b, h, s, d in INT8_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        kern = lambda: fa.flash_attention_fixed_int8(q, k, v)
        plain = lambda: fa.fixed_cap_int8_ref(q, k, v)
        ref = plain()
        exact = attn.plain_attention(q.float(), k.float(), v.float())
        label = f"({b},{h},{s},{d})"
        out = kern()
        torch.cuda.synchronize()
        err, tol = attn_err(out, ref)
        rel = ((out.float() - exact).abs().max() / exact.abs().max()).item()
        same = torch.equal(out.view(torch.int16), kern().view(torch.int16))
        names = kernels_per_call(kern)
        if not torch.isfinite(out).all() or not err <= tol \
                or not rel < INT8_EXACT_TOL or not same:
            fail(f"flash_fixed_int8 {label}: max abs err {err} (tol {tol}), "
                 f"vs exact {rel} (tol {INT8_EXACT_TOL}), two calls equal "
                 f"{same}")
        if len(names) != len(want) or not all(
                w in n for w, n in zip(want, names)):
            fail(f"flash_fixed_int8 {label}: kernels of one call {names}, "
                 f"expected {want}")
        worst = max(worst, err)
        del out, ref, exact
        pms = median_ms(plain, 5)
        k1 = lambda: fa.flash_attention_fixed(q, k, v)
        ms, k1_ms, lms = paired_ms([kern, k1, lambda: sdpa(q, k, v)],
                                   reps=20)
        b2b, hus = back_to_back_ms(kern), host_us(kern)
        # q, k, v read and o written once (bf16); the QKᵀ in int8 (its
        # time at the int8 rate, as bf16-rate FLOPs) and P·V in bf16 on the
        # tensor cores, one exp2 per score
        ops = 2.0 * b * h * s * s * d
        bms, by = bound(8.0 * b * h * s * d,
                        ops + ops * PEAK_BF16_FLOPS / PEAK_INT8_OPS,
                        float(b * h * s * s))
        print(f"[kernels] flash_fixed_int8 {label}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}), vs exact {rel:.3e} (tol {INT8_EXACT_TOL}); "
              f"two calls bit for bit; kernels a call {len(names)}",
              flush=True)
        print(f"[kernels] flash_fixed_int8 {label}: one call at a time, "
              f"alternating rounds: {ms:.4f} ms, K1 (bf16 fixed cap) "
              f"{k1_ms:.4f} ms, sdpa (exact, not int8) {lms:.4f} ms "
              f"({ms / k1_ms:.2f}x K1, {ms / lms:.2f}x sdpa); back to back "
              f"{b2b:.4f} ms, host {hus:.1f} us a call; plain {pms:.4f} ms; "
              f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of it "
              f"({100 * bms / b2b:.1f}% back to back)", flush=True)
        row = dict(ms=ms, k1_ms=k1_ms, library_ms=lms, back_to_back_ms=b2b,
                   host_us=hus, plain_ms=pms, bound_ms=bms,
                   kernels_per_call=len(names))
        shapes.append(dict(shape=[b, h, s, d], bound_share=bms / ms, **row))
        if first is None:
            first = dict(bound_by=by, **row)
        del q, k, v
    return {"name": "flash_fixed_int8", "route": "cuda",
            "source": "sdbc_tpu_torch/csrc/flash_int8_sm90.cu",
            "replaces": "sdbc_tpu/ops/flash_attention.py:457",
            "max_abs_err": worst, **first,
            "shapes": shapes, "build": build_report}


def phase_train_kernels(adam8_sass_counts=None):
    """The training kernels against their plain versions, at the shapes of
    the mode-C step (micro-batch 2, 8 heads; q/k/v as the (B, H, S, D)
    head-split views of the projection layout the UNet hands over)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb
    from sdbc_tpu_torch.train import adam8bit

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    bf = torch.bfloat16

    def bhsd(b, s, h, d):
        return torch.randn((b, s, h, d), generator=g, device=dev).to(
            bf).transpose(1, 2)

    cases = [("64^2 d40", 2, 8, 4096, 4096, 40),
             ("32^2 d80", 2, 8, 1024, 1024, 80),
             ("16^2 d160", 2, 8, 256, 256, 160),
             ("ragged Sq200 Sk300 d40", 2, 8, 200, 300, 40)]
    res = {n: {"err": 0.0, "first": None}
           for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def record(name, err, **kw):
        res[name]["err"] = max(res[name]["err"], err)
        if res[name]["first"] is None:
            res[name]["first"] = kw

    for label, b, h, sq, sk, d in cases:
        q, k, v = bhsd(b, sq, h, d), bhsd(b, sk, h, d), bhsd(b, sk, h, d)
        do = bhsd(b, sq, h, d)
        scale = d ** -0.5
        # forward: kernel vs plain
        out, lse = fa.flash_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_ref(q, k, v, scale)
        err, tol = attn_err(out, ref)
        lerr = (lse - ref_lse).abs().max().item()
        if not (torch.isfinite(out).all() and err <= tol
                and lerr <= LSE_TOL):
            fail(f"flash_fwd {label}: out err {err} (tol {tol}), lse err "
                 f"{lerr}")
        pms = median_ms(lambda: fa.flash_attention_ref(q, k, v, scale), 5)
        lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, scale=scale)
        ms, lms = paired_ms([lambda: fa.flash_fwd(q, k, v, scale), lib])
        bms, by = attn_bound(b, h, sq, sk, d, 2, (sq, sk, sk), (sq,),
                             4.0 * b * h * sq)
        record("flash_fwd", max(err, lerr), ms=ms, plain_ms=pms,
               bound_ms=bms, bound_by=by, library_ms=lms)
        print(f"[train-kernels] flash_fwd {label}: out err {err:.3e} (tol "
              f"{tol:.3e}) lse err {lerr:.3e} kernel {ms:.4f} ms plain {pms:.4f} ms sdpa-flash "
              f"{lms:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        print(f"[train-kernels] flash_fwd {label}: kernel {ms:.4f} ms, "
              f"sdpa-flash {lms:.4f} ms (kernel/sdpa {ms / lms:.2f}), bound "
              f"{bms:.4f} ms, {100 * bms / ms:.1f}% of the bound", flush=True)

        # backward: each kernel vs the plain backward, called directly and
        # through autograd (``_FlashAttention``: the forward kernel's out
        # and LSE saved, then both backward kernels)
        grads = fb.flash_bwd(q, k, v, ref, do, ref_lse, scale)
        torch.cuda.synchronize()
        refs = fb.flash_bwd_ref(q, k, v, ref, do, ref_lse, scale)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        ao = fa.flash_attention(ql, kl, vl, scale=scale)
        if type(ao.grad_fn).__name__ != "_FlashAttentionBackward":
            fail(f"flash_attention {label}: grad_fn {ao.grad_fn}")
        agrads = torch.autograd.grad(ao, (ql, kl, vl), do)
        errs = []
        for name, gr, ag, rf in zip(("dq", "dk", "dv"), grads, agrads, refs):
            e, tol = attn_err(gr, rf)
            ae, _ = attn_err(ag, rf)
            if not (torch.isfinite(gr).all() and torch.isfinite(ag).all()
                    and max(e, ae) <= tol):
                fail(f"flash_bwd {label} {name}: max abs err {e}, through "
                     f"autograd {ae} (tol {tol})")
            errs.append(max(e, ae))
        del ao, agrads
        # the two kernels alone, on the inputs the wrapper prepares for
        # them; then the whole call (folds, lse2/delta, both launches)
        # against SDPA's flash backward (dq, dk and dv together, its own
        # rowsum(dO∘O) included), in alternating rounds
        dq_fn, dkv_fn = bwd_launches(q, k, v, ref, do, ref_lse, scale)
        dq_ms, dkv_ms = median_ms(dq_fn, 20), median_ms(dkv_fn, 20)
        pms = median_ms(lambda: fb.flash_bwd_ref(q, k, v, ref, do, ref_lse,
                                                 scale), 5)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lo = torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, scale=scale)
        call = lambda: fb.flash_bwd(q, k, v, ref, do, ref_lse, scale)
        sdpa_bwd = lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                               retain_graph=True)
        call_ms, lms = paired_ms([call, sdpa_bwd])
        host = [host_us(f) for f in (
            lambda: fb.prepare(q, k, ref, do, ref_lse, scale), call,
            sdpa_bwd)]
        lse_bytes = 8.0 * b * h * sq  # lse2 and delta, fp32
        dq_b = attn_bound(b, h, sq, sk, d, 3, (sq, sk, sk, sq), (sq,),
                          lse_bytes)
        dkv_b = attn_bound(b, h, sq, sk, d, 4, (sq, sk, sk, sq), (sk, sk),
                           lse_bytes)
        # the whole backward as one function: q, k, v, o, dO and the LSE
        # read, dq, dk, dv written; five products (S, dP, dq, dk, dv)
        call_b = attn_bound(b, h, sq, sk, d, 5, (sq, sk, sk, sq, sq),
                            (sq, sk, sk), 4.0 * b * h * sq)
        record("flash_bwd_dq", errs[0], ms=dq_ms, plain_ms=pms,
               bound_ms=dq_b[0], bound_by=dq_b[1], library_ms=lms,
               call_ms=call_ms, call_bound_ms=call_b[0])
        record("flash_bwd_dkv", max(errs[1:]), ms=dkv_ms, plain_ms=pms,
               bound_ms=dkv_b[0], bound_by=dkv_b[1], library_ms=lms,
               call_ms=call_ms, call_bound_ms=call_b[0])
        print(f"[train-kernels] flash_bwd {label}: err (direct and through "
              f"autograd) dq {errs[0]:.3e} dk "
              f"{errs[1]:.3e} dv {errs[2]:.3e}; dq kernel {dq_ms:.4f} ms "
              f"(bound {dq_b[0]:.4f}, {dq_b[1]}, {100 * dq_b[0] / dq_ms:.1f}%"
              f"), dkv kernel {dkv_ms:.4f} ms (bound {dkv_b[0]:.4f}, "
              f"{dkv_b[1]}, {100 * dkv_b[0] / dkv_ms:.1f}%); plain backward "
              f"{pms:.4f} ms", flush=True)
        print(f"[train-kernels] flash_bwd {label}: kernels {dq_ms + dkv_ms:.4f}"
              f" ms, whole call {call_ms:.4f} ms, sdpa-flash backward "
              f"{lms:.4f} ms (call/sdpa {call_ms / lms:.2f}), bound "
              f"{call_b[0]:.4f} ms ({call_b[1]}), {100 * call_b[0] / call_ms:.1f}"
              f"% of the bound; host us per call: prepare {host[0]:.1f}, "
              f"whole call {host[1]:.1f}, sdpa backward {host[2]:.1f}",
              flush=True)
        del q, k, v, do, out, lse, ref, grads, refs, lo, ql, kl, vl
    rows = [kernel_flash_tt(g)]
    wide = kernel_flash_fwd_wide(g)
    bwd_wide = kernel_flash_bwd_wide(g)
    for name, source, replaces in (
            ("flash_fwd", "sdbc_tpu_torch/csrc/flash_fwd_sm90.cu",
             "sdbc_tpu/ops/flash_attention.py:81"),
            ("flash_bwd_dq", "sdbc_tpu_torch/csrc/flash_bwd_sm90.cu",
             "sdbc_tpu/ops/flash_attention_bwd.py:163"),
            ("flash_bwd_dkv", "sdbc_tpu_torch/csrc/flash_bwd_sm90.cu",
             "sdbc_tpu/ops/flash_attention_bwd.py:187")):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": res[name]["err"],
                     **res[name]["first"]})
    fwd_row = next(r for r in rows if r["name"] == "flash_fwd")
    fwd_row["serves"] = (
        "head dims <= 256 (every main-path call): flash_fwd_sm90_kernel in "
        "csrc/flash_fwd_sm90.cu; head dims above 256 (the VAE's 512-wide "
        "head under SDBC_ATTN_IMPL=flash): flash_fwd_wide_sm90_kernel<KS1, "
        "false, false> in csrc/flash_fwd_wide_sm90.cu")
    fwd_row["d512"] = wide
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        row = next(r for r in rows if r["name"] == name)
        row["serves"] = (
            f"head dims <= {fb.SM90_MAX_D} (every main-path call): "
            f"{name}_sm90_kernel<DP, KS> in csrc/flash_bwd_sm90.cu; head "
            f"dims above {fb.SM90_MAX_D} up to 512 (the VAE's 512-wide head; "
            f"no path of SD-1.5): {name}_wide_sm90_kernel<KS> in "
            f"csrc/flash_bwd_wide_sm90.cu, a cluster of two CTAs splitting "
            f"the head dim")
        row["d512"] = bwd_wide[name]

    # the fused 8-bit AdamW on a 3x3 1280-channel conv leaf less 1000
    # elements (a ragged last row), from a mid-training state
    n = 3 * 3 * 1280 * 1280 - 1000
    p0 = torch.randn(n, generator=g, device=dev) * 0.05
    opt = adam8bit.adamw8bit(1e-4, weight_decay=1e-2)
    st_k = opt.leaf_init(p0)
    pk = p0.clone()
    for step in (1, 2):
        gr = torch.randn(n, generator=g, device=dev) * 1e-3
        adam8bit.adam8_update_ref(pk, gr, st_k, 1e-4, step, b1=0.9,
                                  b2=0.999, eps=1e-8, wd=1e-2)
    st_r = adam8bit.Quant8State(*(t.clone() for t in (
        st_k.mq, st_k.ms, st_k.vq, st_k.vs)))
    pr = pk.clone()
    gr = torch.randn(n, generator=g, device=dev) * 1e-3
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    adam8bit.adam8_update(pk, gr, st_k, 1e-4, 3, **kw)
    torch.cuda.synchronize()
    adam8bit.adam8_update_ref(pr, gr, st_r, 1e-4, 3, **kw)
    perr = (pk - pr).abs().max().item()
    qshare = max(((a.int() - b.int()).abs() > 0).float().mean().item()
                 for a, b in ((st_k.mq, st_r.mq), (st_k.vq, st_r.vq)))
    qmax = max((a.int() - b.int()).abs().max().item()
               for a, b in ((st_k.mq, st_r.mq), (st_k.vq, st_r.vq)))
    serr = max(((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
               for a, b in ((st_k.ms, st_r.ms), (st_k.vs, st_r.vs)))
    if not (perr <= ADAM_P_TOL and qmax <= 1 and qshare <= ADAM_Q_SHARE
            and serr <= 1e-5):
        fail(f"adam8: p err {perr}, int8 off-by-one share {qshare} (max "
             f"{qmax}), scale rel err {serr}")
    # the kernel alone (its table built once), and the whole one-leaf call
    ms = median_ms(adam8_launch([([pk], [gr], st_k)], 3), 20)
    call_ms = median_ms(lambda: adam8bit.adam8_update(pk, gr, st_k, 1e-4, 3,
                                                      **kw), 20)
    pms = median_ms(lambda: adam8bit.adam8_update_ref(pr, gr, st_r, 1e-4, 3,
                                                      **kw), 5)
    rows_n = -(-n // adam8bit.BLOCK)
    bms, by = adam8_bound(n, rows_n)
    print(f"[train-kernels] adam8 n={n} (ragged last row): p err {perr:.3e}, "
          f"int8 off-by-one share {qshare:.2e}, scale rel err {serr:.2e}; "
          f"kernel {ms:.4f} ms (the whole call {call_ms:.4f} ms) plain "
          f"{pms:.4f} ms bound {bms:.4f} ms ({by}) ({16.0 * n / ms / 1e6:.1f}"
          f" GB/s, {100 * bms / ms:.1f}% of the bound)", flush=True)
    del p0, pk, pr, st_k, st_r, gr
    step = kernel_adam8_step(g)
    rows.append({"name": "adam8", "route": "cuda",
                 "source": "sdbc_tpu_torch/csrc/adam8bit.cu",
                 "replaces": "sdbc_tpu/train/adam8bit.py:86",
                 "max_abs_err": max(perr, step.pop("p_err")), "ms": ms,
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "library_ms": None, "step": step,
                 "sass": adam8_sass_counts})
    return rows


def adam8_launch(leaves, step: int):
    """A launch of the 8-bit AdamW kernel alone over ``leaves`` (each (p
    parts, g parts, Quant8State)), its table built and copied to the card
    once (lr 1e-4, wd 1e-2, the bias corrections of ``step``); each call
    steps the leaves again."""
    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train import adam8bit

    words, rows = adam8bit.leaf_table(leaves)
    table = torch.from_numpy(words).to(leaves[0][0][0].device)
    bc1, bc2 = adam8bit.bias_corrections(step, 0.9, 0.999)
    return lambda: _kernels.adam8(table, len(leaves), rows, 1e-4, bc1, bc2,
                                  0.9, 0.1, 0.999, 0.001, 1e-8, 1e-2)


def adam8_bound(n: int, rows: int):
    """The 8-bit AdamW's bound over ``n`` elements in ``rows`` rows: p and g
    fp32 read, p written, the int8 moments read and written (16 bytes an
    element), each row's two fp32 scales read and written; ~30 fp32
    operations an element."""
    return bound(16.0 * n + 16.0 * rows, fp32_ops=30.0 * n)


def mode_c_8bit_leaves():
    """The part shapes of every 8-bit leaf of the mode-C step: SD-1.5's UNet
    and text encoder as ``trainer.optimizer_leaves`` groups them (the text
    encoder's layers stacked per name), built on the meta device."""
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.models import clip as clip_mod
    from sdbc_tpu_torch.models import unet as unet_mod
    from sdbc_tpu_torch.train.adam8bit import MIN_8BIT_SIZE
    from sdbc_tpu_torch.train.trainer import optimizer_leaves

    cfg = PipelineConfig.sd15()
    leaves = optimizer_leaves({
        "text_encoder": clip_mod.init(cfg.clip, device="meta"),
        "unet": unet_mod.init(cfg.unet, device="meta")})
    return [[tuple(p.shape) for p in leaf] for leaf in leaves
            if sum(p.numel() for p in leaf) >= MIN_8BIT_SIZE]


def kernel_adam8_step(g):
    """K7 over one mode-C optimizer step: every 8-bit leaf at its real size
    (the stacked ones as their parts, read and written in place), from a
    mid-training state, in one launch; held leaf by leaf against the plain
    version on stacked copies, and timed: the kernel alone on a table built
    once, the whole ``adam8_update_leaves`` call as ``AdamW8bit.update``
    makes it (the table built, checked and copied each call) and, as a
    yardstick of the memory rate the card reaches, a
    device-to-device copy of 2 GiB."""
    import torch

    from sdbc_tpu_torch.train import adam8bit

    dev = torch.device("cuda")
    shapes = mode_c_8bit_leaves()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    opt = adam8bit.adamw8bit(1e-4, weight_decay=1e-2)
    parts = [[torch.randn(sh, generator=g, device=dev) * 0.05 for sh in leaf]
             for leaf in shapes]
    states = [opt.leaf_init(leaf) for leaf in parts]
    n_el = sum(p.numel() for leaf in parts for p in leaf)
    stacked = sum(len(leaf) > 1 for leaf in parts)

    def grads():
        return [[torch.randn(p.shape, generator=g, device=dev) * 1e-3
                 for p in leaf] for leaf in parts]

    stack = lambda ts: ts[0].clone() if len(ts) == 1 else torch.stack(ts)
    for step in (1, 2):  # a mid-training state, through the kernel
        adam8bit.adam8_update_leaves(list(zip(parts, grads(), states)), 1e-4,
                                     step, **kw)
    gr = grads()
    ref = [(stack(leaf), adam8bit.Quant8State(*(t.clone() for t in (
        st.mq, st.ms, st.vq, st.vs)))) for leaf, st in zip(parts, states)]
    adam8bit.adam8_update_leaves(list(zip(parts, gr, states)), 1e-4, 3, **kw)
    torch.cuda.synchronize()
    perr = serr = 0.0
    qmax, qoff, qn = 0, 0, 0
    for leaf, gl, st, (p0, s0) in zip(parts, gr, states, ref):
        adam8bit.adam8_update_ref(p0, stack(gl), s0, 1e-4, 3, **kw)
        perr = max(perr, (stack(leaf) - p0).abs().max().item())
        for a, b in ((st.mq, s0.mq), (st.vq, s0.vq)):
            d = (a.int() - b.int()).abs()
            qmax = max(qmax, d.max().item())
            qoff += int((d > 0).sum())
            qn += d.numel()
        serr = max(serr, *(((a - b).abs() / b.abs().clamp(min=1e-30))
                           .max().item() for a, b in ((st.ms, s0.ms),
                                                      (st.vs, s0.vs))))
    del ref
    qshare = qoff / qn
    if not (len(shapes) == 289 and stacked == 7 and perr <= ADAM_P_TOL
            and qmax <= 1 and qshare <= ADAM_Q_SHARE and serr <= 1e-5):
        fail(f"adam8 step: {len(shapes)} leaves ({stacked} stacked), p err "
             f"{perr}, int8 off-by-one share {qshare} (max {qmax}), scale "
             f"rel err {serr}")
    leaves = list(zip(parts, gr, states))
    rows = adam8bit.leaf_table(leaves)[1]
    ms = median_ms(adam8_launch(leaves, 3), 10)
    call = lambda: adam8bit.adam8_update_leaves(leaves, 1e-4, 3, **kw)
    call_ms, host = median_ms(call, 10), host_us(call, 20)
    del leaves
    src = torch.empty(2 ** 29, device=dev)
    dst = torch.empty_like(src)
    copy_tbs = 2 * src.numel() * 4 / median_ms(lambda: dst.copy_(src),
                                                10) / 1e9
    del src, dst
    bms, by = adam8_bound(n_el, rows)
    print(f"[train-kernels] adam8 mode-C step: {len(shapes)} 8-bit leaves "
          f"({stacked} stacked, in place), {n_el} elements in {rows} rows: "
          f"p err {perr:.3e}, int8 off-by-one share {qshare:.2e} (max "
          f"{qmax}), scale rel err {serr:.2e}; one launch {ms:.4f} ms, the "
          f"whole call {call_ms:.4f} ms "
          f"(host {host:.1f} us a call); step bound {bms:.4f} ms ({by}), "
          f"{100 * bms / ms:.1f}% of it ({16.0 * n_el / ms / 1e6:.1f} GB/s; "
          f"a 2 GiB device-to-device copy moves {copy_tbs:.3f} TB/s)",
          flush=True)
    del parts, states, gr
    return dict(leaves=len(shapes), stacked=stacked, elements=n_el,
                rows=rows, ms=ms, call_ms=call_ms,
                host_us=host, bound_ms=bms, copy_tbs=copy_tbs, p_err=perr,
                int8_share=qshare)


def bwd_launches(q, k, v, o, do, lse, scale: float):
    """(dq launch, dk/dv launch) of ``flash_bwd``'s wgmma kernels at
    head-major (B, H, S, D) inputs (D ≤ ``SM90_MAX_D``), on the inputs the
    wrapper prepares for them, outputs allocated once."""
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb

    dov = fa.kernel_view(do)
    qs, kl, lse2, delta = fb.prepare(q, k, o, dov, lse, scale)
    ins = (fa.kernel_view(qs), fa.kernel_view(kl), fa.kernel_view(v), dov,
           lse2, delta)
    dq = fa.bhsd_empty_like(q)
    dk, dv = fa.bhsd_empty_like(k), fa.bhsd_empty_like(v)
    return (lambda: _kernels.flash_bwd_dq(*ins, dq, scale / fb.LOG2E),
            lambda: _kernels.flash_bwd_dkv(*ins, dk, dv))


def sdpa_backend(q, k, v) -> str:
    """The backend SDPA's default dispatch picks for these inputs."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v)).name


def kernel_flash_tt(g):
    """K9 at K5's cases, the 77-key cross-attention and the VAE's 512-wide
    head: against its plain version (output and LSE) and against K5's
    output on the same inputs (at the 512-wide head bit for bit: one kernel,
    ``csrc/flash_fwd_wide_sm90.cu``, in two layouts).  The call
    (``to_tt``'s three copies included) is timed against SDPA and K5 in
    alternating rounds: SDPA's flash forward up to head dim 256, above it
    SDPA's default dispatch (its flash kernel stops at 256), whose backend
    is printed."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_tt as ftt

    dev = torch.device("cuda")
    cases = [("64^2 d40", 2, 8, 4096, 4096, 40),
             ("32^2 d80", 2, 8, 1024, 1024, 80),
             ("16^2 d160", 2, 8, 256, 256, 160),
             ("ragged Sq200 Sk300 d40", 2, 8, 200, 300, 40),
             ("64^2 cross Sk77 d40", 2, 8, 4096, 77, 40),
             ("8^2 mid d160", 2, 8, 64, 64, 160),
             ("VAE 64^2 d512", 1, 1, 4096, 4096, 512)]
    worst, first, wide = 0.0, None, None
    for label, b, h, sq, sk, d in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev)
                   .bfloat16().transpose(1, 2) for s in (sq, sk, sk))
        scale = d ** -0.5
        kern = lambda: ftt.flash_fwd_tt(q, k, v, scale)
        out, lse = kern()
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_ref(q, k, v, scale)
        k5, _ = fa.flash_fwd(q, k, v, scale)
        err, tol = attn_err(out, ref)
        lerr = (lse - ref_lse).abs().max().item()
        k5err, k5tol = attn_err(out, k5)
        same = torch.equal(out, k5)
        if not (torch.isfinite(out).all() and err <= tol and lerr <= LSE_TOL
                and k5err <= k5tol and (same or d <= 256)):
            fail(f"flash_tt {label}: out err {err} (tol {tol}), lse err "
                 f"{lerr}, vs K5 {k5err} (tol {k5tol}, bit for bit {same})")
        pms = median_ms(lambda: fa.flash_attention_ref(q, k, v, scale), 5)
        bms, by = attn_bound(b, h, sq, sk, d, 2, (sq, sk, sk), (sq,),
                             4.0 * b * h * sq)
        if d <= 256:
            lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, scale=scale)
            lname = "sdpa-flash"
        else:
            lib = lambda: sdpa(q, k, v, scale=scale)
            lname = f"sdpa ({sdpa_backend(q, k, v)})"
        ms, lms, k5ms = paired_ms(
            [kern, lib, lambda: fa.flash_fwd(q, k, v, scale)])
        print(f"[train-kernels] flash_tt {label}: out err {err:.3e} (tol "
              f"{tol:.3e}) lse err {lerr:.3e} vs K5 {k5err:.3e} (bit for bit "
              f"{same}); kernel {ms:.4f} ms, {lname} {lms:.4f} ms "
              f"(kernel/sdpa {ms / lms:.2f}), K5 {k5ms:.4f} ms (kernel/K5 "
              f"{ms / k5ms:.2f}), in alternating rounds; plain {pms:.4f} ms "
              f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of the "
              f"bound", flush=True)
        worst = max(worst, err, lerr)
        if first is None:
            first = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                         library_ms=lms, k5_ms=k5ms)
        if d > 256:
            b2b = back_to_back_ms(kern)
            print(f"[train-kernels] flash_tt {label}: 20 calls back to back "
                  f"{b2b:.4f} ms a call, {100 * bms / b2b:.1f}% of the bound",
                  flush=True)
            wide = dict(ms=ms, library_ms=lms, library=lname, k5_ms=k5ms,
                        back_to_back_ms=b2b, plain_ms=pms, bound_ms=bms,
                        bound_by=by, max_abs_err=max(err, lerr),
                        bit_equal_k5=same)
        del q, k, v, out, ref, k5
    return {"name": "flash_tt", "route": "cuda",
            "source": "sdbc_tpu_torch/csrc/flash_fwd_sm90.cu",
            "replaces": "sdbc_tpu/ops/flash_attention_tt.py:76",
            "serves": "head dims <= 256 (every call of the switches' path "
                      "but the VAE's): flash_fwd_sm90_kernel<DP, KS, true, "
                      "true> in csrc/flash_fwd_sm90.cu; head dims above 256 "
                      "(the VAE encode's 512-wide head): "
                      "flash_fwd_wide_sm90_kernel<KS1, true, false> in "
                      "csrc/flash_fwd_wide_sm90.cu",
            "max_abs_err": worst, **first, "d512": wide}


def kernel_flash_fixed_wide(g):
    """The fixed cap at the VAE's 512-wide head (``SDBC_ATTN_IMPL=
    inference``; the fixed-cap variant of ``csrc/flash_fwd_wide_sm90.cu``'s
    kernel) over the projection layout's strides: against its plain
    version, one launch a call, timed against SDPA's default dispatch (its
    backend named) in alternating rounds, and 20 calls back to back."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn((1, 4096, 1, 512), generator=g, device="cuda")
               .bfloat16().transpose(1, 2) for _ in range(3))
    kern = lambda: fa.flash_attention_fixed(q, k, v)
    before = _kernels.launches["flash_fixed"]
    out = kern()
    torch.cuda.synchronize()
    err, tol = attn_err(out, fa.fixed_cap_attention_ref(q, k, v))
    if not (torch.isfinite(out).all() and err <= tol
            and _kernels.launches["flash_fixed"] == before + 1):
        fail(f"flash_fixed d512: max abs err {err} (tol {tol}), launches "
             f"{_kernels.launches['flash_fixed'] - before}")
    pms = median_ms(lambda: fa.fixed_cap_attention_ref(q, k, v), 5)
    backend = sdpa_backend(q, k, v)
    ms, lms = paired_ms([kern, lambda: sdpa(q, k, v)])
    b2b = back_to_back_ms(kern)
    bms, by = attn_bound(1, 1, 4096, 4096, 512, 2, (4096,) * 3, (4096,))
    print(f"[kernels] flash_fixed VAE 64^2 d512: max abs err {err:.3e} (tol "
          f"{tol:.3e}); kernel {ms:.4f} ms, sdpa ({backend}) {lms:.4f} ms "
          f"(kernel/sdpa {ms / lms:.2f}) in alternating rounds; 20 calls "
          f"back to back {b2b:.4f} ms a call; plain {pms:.4f} ms, bound "
          f"{bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of the bound "
          f"({100 * bms / b2b:.1f}% back to back)", flush=True)
    return dict(ms=ms, library_ms=lms, library=f"sdpa ({backend})",
                back_to_back_ms=b2b, plain_ms=pms, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def kernel_flash_fwd_wide(g):
    """K5's forward at the VAE's 512-wide head (the ``flash`` override; the
    kernel of ``csrc/flash_fwd_wide_sm90.cu``): against its plain version,
    and timed against SDPA's default dispatch (its flash kernel stops at
    head dim 256; the backend is printed) in alternating rounds.  Returns
    the numbers for the kernels line."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn((1, 4096, 1, 512), generator=g, device="cuda")
               .bfloat16().transpose(1, 2) for _ in range(3))
    scale = 512 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_ref(q, k, v, scale)
    err, tol = attn_err(out, ref)
    lerr = (lse - ref_lse).abs().max().item()
    if not (torch.isfinite(out).all() and err <= tol and lerr <= LSE_TOL):
        fail(f"flash_fwd d512: out err {err} (tol {tol}), lse err {lerr}")
    pms = median_ms(lambda: fa.flash_attention_ref(q, k, v, scale), 5)
    backend = sdpa_backend(q, k, v)
    ms, lms = paired_ms([lambda: fa.flash_fwd(q, k, v, scale),
                         lambda: sdpa(q, k, v, scale=scale)])
    b2b = back_to_back_ms(lambda: fa.flash_fwd(q, k, v, scale))
    bms, by = attn_bound(1, 1, 4096, 4096, 512, 2, (4096,) * 3, (4096,),
                         4.0 * 4096)
    print(f"[train-kernels] flash_fwd VAE 64^2 d512: out err {err:.3e} (tol "
          f"{tol:.3e}) lse err {lerr:.3e}; kernel {ms:.4f} ms, sdpa "
          f"({backend}) {lms:.4f} ms (kernel/sdpa {ms / lms:.2f}) in "
          f"alternating rounds; 20 calls back to back {b2b:.4f} ms a call; "
          f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), "
          f"{100 * bms / ms:.1f}% of the bound ({100 * bms / b2b:.1f}% back "
          f"to back)", flush=True)
    return dict(ms=ms, library_ms=lms, library=f"sdpa ({backend})",
                back_to_back_ms=b2b, plain_ms=pms, bound_ms=bms, bound_by=by,
                max_abs_err=max(err, lerr))


# K6 above head dim 192 (csrc/flash_bwd_wide_sm90.cu), at the VAE's 512-wide
# head: the 64² latent's mid-block attention, a 32² one, and a ragged case
# with two heads (label, b, h, sq, sk, d)
BWD_WIDE_CASES = [("VAE 64^2 d512", 1, 1, 4096, 4096, 512),
                  ("32^2 d512", 1, 1, 1024, 1024, 512),
                  ("ragged Sq130 Sk200 d512", 1, 2, 130, 200, 512)]


def kernel_flash_bwd_wide(g):
    """K6 above head dim 192 (the kernels of ``csrc/flash_bwd_wide_sm90.cu``)
    at ``BWD_WIDE_CASES``: the whole ``flash_bwd`` call against the plain
    backward; each kernel's card time in the profiler's trace against its
    own bound (6·D FLOPs a score for dq, 8·D for dk/dv); 20 calls back to
    back; and the call against SDPA's backward (its default backend: the
    flash one stops at head dim 256) in alternating rounds.  Off every path
    of SD-1.5 (both trainers encode without a gradient).  Returns, for
    each kernel, one dict a case."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb

    out = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for label, b, h, sq, sk, d in BWD_WIDE_CASES:
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device="cuda")
                       .bfloat16().transpose(1, 2) for s in (sq, sk, sk, sq))
        scale = d ** -0.5
        o, lse = fa.flash_attention_ref(q, k, v, scale)
        grads = fb.flash_bwd(q, k, v, o, do, lse, scale)
        torch.cuda.synchronize()
        refs = fb.flash_bwd_ref(q, k, v, o, do, lse, scale)
        errs = []
        for name, gr, rf in zip(("dq", "dk", "dv"), grads, refs):
            err, tol = attn_err(gr, rf)
            if not (torch.isfinite(gr).all() and err <= tol):
                fail(f"flash_bwd {label} {name}: max abs err {err} (tol "
                     f"{tol})")
            errs.append(err)
        again = fb.flash_bwd(q, k, v, o, do, lse, scale)
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        if not same:
            fail(f"flash_bwd {label}: two calls differ")
        del grads, refs, again
        pms = median_ms(lambda: fb.flash_bwd_ref(q, k, v, o, do, lse, scale),
                        3)
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        lo = sdpa(ql, kl, vl, scale=scale)
        backend = sdpa_backend(q, k, v)
        call = lambda: fb.flash_bwd(q, k, v, o, do, lse, scale)
        lib = lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                          retain_graph=True)
        ms, lms = paired_ms([call, lib])
        b2b = back_to_back_ms(call)
        dq_dev, dkv_dev = device_ms(call, ("flash_bwd_dq_wide_sm90_kernel",
                                           "flash_bwd_dkv_wide_sm90_kernel"))
        host = [host_us(f) for f in (
            lambda: fb.prepare(q, k, o, do, lse, scale), call)]
        lse_bytes = 8.0 * b * h * sq  # lse2 and delta, fp32
        dq_b = attn_bound(b, h, sq, sk, d, 3, (sq, sk, sk, sq), (sq,),
                          lse_bytes)
        dkv_b = attn_bound(b, h, sq, sk, d, 4, (sq, sk, sk, sq), (sk, sk),
                           lse_bytes)
        # the whole call: five products (S, dP, dq, dk, dv) counted once
        call_b = attn_bound(b, h, sq, sk, d, 5, (sq, sk, sk, sq, sq),
                            (sq, sk, sk), 4.0 * b * h * sq)
        print(f"[train-kernels] flash_bwd {label}: err dq {errs[0]:.3e} dk "
              f"{errs[1]:.3e} dv {errs[2]:.3e}, two calls bit for bit "
              f"{same}; card time (profiler) dq kernel {dq_dev:.4f} ms (bound "
              f"{dq_b[0]:.4f}, {dq_b[1]}, {100 * dq_b[0] / dq_dev:.1f}%), "
              f"dkv kernel {dkv_dev:.4f} ms (bound {dkv_b[0]:.4f}, "
              f"{dkv_b[1]}, {100 * dkv_b[0] / dkv_dev:.1f}%)", flush=True)
        print(f"[train-kernels] flash_bwd {label}: whole call {ms:.4f} ms, "
              f"sdpa backward ({backend}) {lms:.4f} ms (call/sdpa "
              f"{ms / lms:.2f}) in alternating rounds; 20 calls back to back "
              f"{b2b:.4f} ms a call; plain {pms:.4f} ms; bound {call_b[0]:.4f}"
              f" ms ({call_b[1]}), {100 * call_b[0] / ms:.1f}% of it "
              f"({100 * call_b[0] / b2b:.1f}% back to back); host us per "
              f"call: prepare {host[0]:.1f}, whole call {host[1]:.1f}",
              flush=True)
        common = dict(case=label, call_ms=ms, back_to_back_ms=b2b,
                      call_bound_ms=call_b[0], library_ms=lms,
                      library=f"sdpa backward ({backend})", plain_ms=pms,
                      host_us=host[1], bit_equal_two_calls=same)
        out["flash_bwd_dq"].append(dict(
            common, ms=dq_dev, bound_ms=dq_b[0], bound_by=dq_b[1],
            max_abs_err=errs[0]))
        out["flash_bwd_dkv"].append(dict(
            common, ms=dkv_dev, bound_ms=dkv_b[0], bound_by=dkv_b[1],
            max_abs_err=max(errs[1:])))
        del q, k, v, do, o, lse, ql, kl, vl, lo
    return out


def unfused_ff(y, gamma, beta, w1, b1, w2, b2):
    import torch.nn.functional as F

    from sdbc_tpu_torch.ops import nn

    z = nn.linear(nn.layer_norm(y, gamma, beta), w1, b1)
    val, gate = z.chunk(2, dim=-1)
    return y + nn.linear(val * F.gelu(gate), w2, b2)


def _tokenizer(cfg):
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer

    return CLIPTokenizer.fallback(cfg.clip.vocab_size)


# the CUDA-core kernels' shapes, fp32 at SD-1.5's 64² level: the sampling
# self-attention and FF rows at batch 8 (4 images with CFG), the mode-C
# step's attention at micro-batch 2
SIMT_FIXED = (8, 8, 4096, 40)
SIMT_TRAIN = (2, 8, 4096, 40)
SIMT_GEGLU = (32768, 320)


def phase_simt_kernels():
    """The CUDA-core kernels (``csrc/flash_simt.cu``,
    ``csrc/geglu_ff_simt.cu``), each through its wrapper against its plain
    version (``simt_err``), one launch a call, timed against the PyTorch
    call of the same function where there is one (SDPA's default dispatch,
    its backend named; its backward through autograd for the two backward
    kernels) in alternating rounds.  Returns their rows of the kernels
    line."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb
    from sdbc_tpu_torch.ops import geglu_ff as gf

    g = torch.Generator(device="cuda").manual_seed(5678)
    rows = []

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    def check(name, out, ref, calls=1):
        torch.cuda.synchronize()
        err, tol = simt_err(out, ref)
        if _kernels.launches[name] != calls or not (
                torch.isfinite(out).all() and err <= tol):
            fail(f"{name}: max abs err {err} (tol {tol}), launches "
                 f"{_kernels.launches[name]} (expected {calls})")
        return err

    def add(name, source, replaces, label, err, ms, pms, bms, by, lms,
            lib=None, **extra):
        share = 100 * bms / ms
        print(f"[simt-kernels] {name} {label}: max_abs_err {err:.3e}; kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, "
              + (f"{lib} {lms:.4f} ms (kernel/library {ms / lms:.2f}) in "
                 f"alternating rounds, " if lms else "")
              + f"bound {bms:.4f} ms ({by}), {share:.2f}% of it", flush=True)
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=pms, bound_ms=bms, bound_by=by,
                         library_ms=lms, library=lib, shape=label, **extra))

    # the fixed cap, heads read through the projection layout's strides
    b, h, s, d = SIMT_FIXED
    q, k, v = (randn(b, s, h, d).transpose(1, 2) for _ in range(3))
    kern = lambda: fa.flash_attention_fixed(q, k, v)
    _kernels.reset_launch_counts()
    err = check("flash_fixed_simt", kern(), fa.fixed_cap_attention_ref(
        q, k, v))
    pms = median_ms(lambda: fa.fixed_cap_attention_ref(q, k, v), 3)
    ms, lms = paired_ms([kern, lambda: sdpa(q, k, v)])
    n_sc = float(b * h * s * s)
    fp32_bytes = lambda n_in, n_out, extra: 4.0 * b * h * s * d * (
        n_in + n_out) + extra
    bms, by = bound(fp32_bytes(3, 1, 0.0), exps=n_sc,
                    fp32_ops=4.0 * n_sc * d)
    add("flash_fixed_simt", "sdbc_tpu_torch/csrc/flash_simt.cu",
        "sdbc_tpu/ops/flash_attention.py:348", f"fp32 {SIMT_FIXED}", err,
        ms, pms, bms, by, lms, f"sdpa ({sdpa_backend(q, k, v)})")
    del q, k, v

    # the training forward and backward in fp32
    b, h, s, d = SIMT_TRAIN
    scale = d ** -0.5
    q, k, v, do = (randn(b, s, h, d).transpose(1, 2) for _ in range(4))
    _kernels.reset_launch_counts()
    out, lse = fa.flash_fwd(q, k, v, scale)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, scale)
    err = check("flash_fwd_simt", out, ref)
    lerr = (lse - ref_lse).abs().max().item()
    if not lerr <= LSE_TOL:
        fail(f"flash_fwd_simt: lse err {lerr} (tol {LSE_TOL})")
    pms = median_ms(lambda: fa.flash_attention_ref(q, k, v, scale), 5)
    ms, lms = paired_ms([lambda: fa.flash_fwd(q, k, v, scale),
                         lambda: sdpa(q, k, v, scale=scale)])
    n_sc = float(b * h * s * s)
    bms, by = bound(fp32_bytes(3, 1, 4.0 * b * h * s), exps=n_sc,
                    fp32_ops=4.0 * n_sc * d)
    add("flash_fwd_simt", "sdbc_tpu_torch/csrc/flash_simt.cu",
        "sdbc_tpu/ops/flash_attention.py:81", f"fp32 {SIMT_TRAIN}",
        max(err, lerr), ms, pms, bms, by, lms,
        f"sdpa ({sdpa_backend(q, k, v)})")
    del out, lse
    _kernels.reset_launch_counts()
    grads = fb.flash_bwd(q, k, v, ref, do, ref_lse, scale)
    refs = fb.flash_bwd_ref(q, k, v, ref, do, ref_lse, scale)
    errs = [check(n, gr, rf) for n, gr, rf in zip(
        ("flash_bwd_simt_dq", "flash_bwd_simt_dkv", "flash_bwd_simt_dkv"),
        grads, refs)]
    del grads, refs
    qs, kl, lse2, delta = fb.prepare(q, k, ref, do, ref_lse, scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_fn = lambda: _kernels.flash_simt_bwd_dq(qs, kl, v, do, lse2, delta,
                                               dq, scale / fb.LOG2E)
    dkv_fn = lambda: _kernels.flash_simt_bwd_dkv(qs, kl, v, do, lse2, delta,
                                                 dk, dv)
    pms = median_ms(lambda: fb.flash_bwd_ref(q, k, v, ref, do, ref_lse,
                                             scale), 3)
    ql, kl_, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    lo = sdpa(ql, kl_, vl, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(lo, (ql, kl_, vl), do,
                                           retain_graph=True)
    dq_ms, dkv_ms, lms = paired_ms([dq_fn, dkv_fn, sdpa_bwd])
    lib = f"sdpa backward ({sdpa_backend(q, k, v)})"
    lse_bytes = 8.0 * b * h * s
    for name, kms, e, mm, n_out in (("flash_bwd_simt_dq", dq_ms, errs[0], 3,
                                     1),
                                    ("flash_bwd_simt_dkv", dkv_ms,
                                     max(errs[1:]), 4, 2)):
        bms, by = bound(fp32_bytes(4, n_out, lse_bytes), exps=n_sc,
                        fp32_ops=2.0 * mm * n_sc * d)
        add(name, "sdbc_tpu_torch/csrc/flash_simt.cu",
            "sdbc_tpu/ops/flash_attention_bwd.py:"
            + ("163" if name.endswith("dq") else "187"),
            f"fp32 {SIMT_TRAIN}", e, kms, pms, bms, by, lms, lib)
    del q, k, v, do, ref, ref_lse, qs, kl, dq, dk, dv, lo, ql, kl_, vl

    # the fused FF in fp32
    rows_n, c = SIMT_GEGLU
    args = [randn(rows_n, c), 1.0 + randn(c, scale=0.2), randn(c, scale=0.1),
            randn(c, 8 * c, scale=c ** -0.5), randn(8 * c, scale=0.05),
            randn(4 * c, c, scale=(4 * c) ** -0.5), randn(c, scale=0.05)]
    kern = lambda: gf.geglu_ff_rows(*args)
    _kernels.reset_launch_counts()
    err = check("geglu_ff_simt", kern(), gf.geglu_ff_ref(*args))
    pms = median_ms(lambda: gf.geglu_ff_ref(*args), 5)
    ms = median_ms(kern, 10)
    bms, by = bound(4.0 * (2 * rows_n * c + 12 * c * c + 9 * c) + 8.0 * c,
                    fp32_ops=24.0 * rows_n * c * c)
    add("geglu_ff_simt", "sdbc_tpu_torch/csrc/geglu_ff_simt.cu",
        "sdbc_tpu/ops/geglu_ff.py:98", f"fp32 {SIMT_GEGLU}", err, ms, pms,
        bms, by, None)
    return rows


def phase_parity():
    """The tiny sampling slice, bf16 on the card against fp32 on the CPU:
    with the default dispatch, then with ``SDBC_GN_FUSED=1``; then fp32 on
    the card (the same weights), where every attention and FF call goes to
    the CUDA-core kernel of its function (``fp32_launches``).  Returns the
    fp32 run's launch counts."""
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
    flash, geglu = expected_launches(cfg, 16, 4)
    # the tiny VAE's single-head mid attention (16² tokens, 64 wide) meets
    # the training flash rule in the one batched decode; SD-1.5's (512
    # wide) does not
    want = dict.fromkeys(_kernels.launches, 0)
    want.update({"flash_fixed": 4 * flash, "geglu_ff": 4 * geglu,
                 "flash_fwd": int(cfg.vae.block_out_channels[-1] <= 256)})
    gpu32 = {k: copy.deepcopy(m).to("cuda") for k, m in cpu.items()}
    for label, env in (("default", {}), ("SDBC_GN_FUSED=1",
                                         {"SDBC_GN_FUSED": "1"}),
                       ("fp32", {})):
        if env:  # every GroupNorm of the tiny slice is eligible
            want["gn_fused"] = 4 * gn_launches(cfg, 16) \
                + vae_gn_launches(cfg, 16, "decode")
        if label == "fp32":
            want = fp32_launches(dict(want, gn_fused=0))
        models, dt = (gpu32, torch.float32) if label == "fp32" \
            else (gpu, torch.bfloat16)
        with environment(**env):
            _kernels.reset_launch_counts()
            out = SDPipeline(models, cfg, _tokenizer(cfg), "cuda", dt)(
                prompts, **kw)
            counts = dict(_kernels.launches)
        err = float(np.abs(out - ref).max())
        print(f"[parity] tiny 32^2 batch 2 DDIM-4 ({label}): image max abs "
              f"err {err:.3e} (tol {PARITY_TOL}), launches {counts} "
              f"(expected {want})", flush=True)
        if out.shape != (2, 32, 32, 3) or not np.isfinite(out).all():
            fail(f"tiny slice ({label}) output {out.shape} not finite")
        if not err <= PARITY_TOL:
            fail(f"tiny slice ({label}): card vs CPU max abs err {err} > "
                 f"{PARITY_TOL}")
        used = ("flash_fixed_simt", "geglu_ff_simt", "flash_fwd_simt") \
            if label == "fp32" else ("flash_fixed", "geglu_ff")
        if counts != want or min(want[k] for k in used) == 0 \
                or (env and want["gn_fused"] == 0):
            fail(f"tiny slice ({label}) launch counts {counts}, expected "
                 f"{want}")
    return counts


# the tiny sampler-parity runs: (label, scheduler, steps, sample options,
# schedule overrides); every scheduler variant, then each option
TINY_OPTIONS = [
    ("cfg_interval", "ddim", 4, dict(cfg_interval=(0.25, 0.75)), {}),
    ("cfg_interval heun karras", "heun", 4,
     dict(cfg_interval=(0.3, 0.7), use_karras_sigmas=True), {}),
    ("guidance_rescale", "dpm", 4, dict(guidance_rescale=0.7), {}),
    ("clip_skip", "ddim", 4, dict(clip_skip=2), {}),
    ("freeu", "ddim", 4, dict(freeu="FREEU_SD15"), {}),
    ("cache_interval", "ddim", 4, dict(cache_interval=2), {}),
    ("cache_interval dpm tail 1", "dpm", 4,
     dict(cache_interval=2, cache_tail=1), {}),
    ("token weights", "ddim", 4, dict(cond_weights="w", uncond_weights="w"),
     {}),
    ("init_image", "ddim", 4, dict(init_image="img", t_start=1), {}),
    ("init_image euler_a karras", "euler_a", 4,
     dict(init_image="img", t_start=1, use_karras_sigmas=True), {}),
    ("inpaint ddpm", "ddpm", 4, dict(init_image="img", mask="mask",
                                     t_start=2), {}),
    ("init_latents dpm", "dpm", 4, dict(init_latents="lat", t_start=2), {}),
    ("t_end euler_a", "euler_a", 4, dict(t_end=3), {}),
    ("v_prediction zero-SNR trailing ddim", "ddim", 4, {},
     dict(prediction_type="v_prediction", rescale_zero_snr=True,
          timestep_spacing="trailing")),
    ("v_prediction zero-SNR trailing unipc", "unipc", 4, {},
     dict(prediction_type="v_prediction", rescale_zero_snr=True,
          timestep_spacing="trailing")),
]


def scheduler_variants():
    """(label, scheduler, karras) of the 15 scheduler variants of
    ``sample``: every scheduler, and the Karras grid of each σ-space one."""
    from sdbc_tpu_torch.diffusion.graph import KARRAS, SCHEDULERS

    return ([(s, s, False) for s in SCHEDULERS]
            + [(f"{s} karras", s, True) for s in KARRAS])


def evals_of(scheduler: str, n: int, kw: dict):
    """``sampler_evals`` of one call with ``sample`` options ``kw``."""
    return sampler_evals(scheduler, n, t_start=kw.get("t_start", 0),
                         t_end=kw.get("t_end"),
                         cfg_interval=kw.get("cfg_interval"),
                         cache_interval=kw.get("cache_interval", 0))


def tiny_sampler_setup(device: str = "cuda") -> dict:
    """The tiny config's models and inputs of ``phase_sampler_parity``:
    random weights from seed 0 rounded to bf16, on ``device`` in bf16
    ("card") and on the CPU in fp32 ("cpu", the same values); two prompts
    and their negatives; the 16² start latents, the init image, the
    inpainting mask (1 = regenerate: the left half), init latents, token
    weights, FreeU's factors, and the injected draws, all from seed 11."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.models import unet as unet_mod

    cfg = PipelineConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    models = init_models(cfg, device="cpu", generator=gen)
    # a trained CLIP's final LayerNorm has a nonzero bias; at the zero init
    # the hidden states' mean is rounding noise, which the token weights'
    # mean restoration would divide by (in either package)
    with torch.no_grad():
        models["text_encoder"].final_ln.bias.normal_(0.1, 0.1, generator=gen)
    card = {k: copy.deepcopy(m).to(device, torch.bfloat16)
            for k, m in models.items()}
    cpu = {k: copy.deepcopy(m).to("cpu", torch.float32)
           for k, m in card.items()}  # the same bf16-valued weights
    tok = _tokenizer(cfg)
    ids = torch.tensor(tok.batch_encode(["a book cover",
                                         "a mystery novel cover"],
                                        cfg.clip.ctx))
    uids = torch.tensor(tok.batch_encode(["", "blurry"], cfg.clip.ctx))
    g = torch.Generator().manual_seed(11)
    lat_shape = (2, 16, 16, 4)
    lat = torch.randn(lat_shape, generator=g)
    mask = torch.zeros(lat_shape[:3] + (1,))
    mask[:, :, :8] = 1.0
    inputs = {"img": torch.rand((2, 32, 32, 3), generator=g),
              "mask": mask, "lat": torch.randn(lat_shape, generator=g),
              "w": 0.5 + torch.rand((2, cfg.clip.ctx), generator=g),
              "FREEU_SD15": unet_mod.FREEU_SD15}
    draws = {"enc": torch.randn(lat_shape, generator=g),
             "step": [torch.randn(lat_shape, generator=g) for _ in range(5)]}
    return dict(cfg=cfg, cpu=cpu, card=card, ids=ids, uids=uids, lat=lat,
                inputs=inputs, draws=draws)


def phase_sampler_parity():
    """Every scheduler variant and each sampling option of ``sample`` at the
    tiny config (32² image, batch 2 with CFG, 4 steps): bf16 on the card
    against fp32 on the CPU (the same bf16-valued weights, the same
    injected draws), within ``PARITY_TOL``, with exact launch counts (K1
    and K4 per UNet evaluation, ``sampler_launches``; the tiny VAE's mid
    attention on the training flash kernel once per encode and decode).
    Returns the launch counts of the runs by label."""
    import dataclasses

    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion import graph
    from sdbc_tpu_torch.diffusion import schedulers as sched_mod
    from sdbc_tpu_torch.ops import _kernels

    st = tiny_sampler_setup("cuda")
    cfg, cpu, gpu = st["cfg"], st["cpu"], st["card"]
    ids, uids, lat = st["ids"], st["uids"], st["lat"]
    inputs, draws = st["inputs"], st["draws"]
    vae_flash = int(cfg.vae.block_out_channels[-1] <= 256)
    runs = [(label, s, 4, dict(use_karras_sigmas=True) if k else {}, {})
            for label, s, k in scheduler_variants()] + TINY_OPTIONS
    out = {}
    for label, scheduler, n, opts, schedule in runs:
        rcfg = dataclasses.replace(
            cfg, scheduler=scheduler,
            schedule=sched_mod.ScheduleConfig(**schedule))
        kw = {k: inputs.get(v, v) if isinstance(v, str) else v
              for k, v in opts.items()}
        res = {}
        for dev, dt, mods in (("cpu", torch.float32, cpu),
                              ("cuda", torch.bfloat16, gpu)):
            dkw = {k: v.to(dev) if torch.is_tensor(v) else v
                   for k, v in kw.items()}
            _kernels.reset_launch_counts()
            img = graph.sample(mods, ids.to(dev), uids.to(dev), lat.to(dev),
                               7.5, cfg=rcfg, num_inference_steps=n,
                               compute_dtype=dt, draws=draws, **dkw)
            if dev == "cuda":
                torch.cuda.synchronize()
            res[dev] = (img.float().cpu().numpy(), dict(_kernels.launches))
        want = sampler_launches(cfg, 16, 2, evals_of(scheduler, n, opts),
                                opts.get("cache_tail", 0))
        want["flash_fwd"] = vae_flash * (1 + ("init_image" in opts))
        ref, (card, counts) = res["cpu"][0], res["cuda"]
        err = float(np.abs(card - ref).max())
        print(f"[sampler-parity] tiny 32^2 batch 2 {label} ({n} steps): "
              f"image max abs err {err:.3e} (tol {PARITY_TOL}), K1 "
              f"{counts['flash_fixed']} K4 {counts['geglu_ff']} "
              f"(expected {want['flash_fixed']}, {want['geglu_ff']})",
              flush=True)
        if card.shape != (2, 32, 32, 3) or not np.isfinite(card).all():
            fail(f"sampler-parity {label}: output {card.shape} not finite")
        if not err <= PARITY_TOL:
            fail(f"sampler-parity {label}: card vs CPU max abs err {err} > "
                 f"{PARITY_TOL}")
        if counts != want or want["flash_fixed"] == 0 \
                or set(res["cpu"][1].values()) != {0}:
            fail(f"sampler-parity {label}: launch counts {counts}, expected "
                 f"{want}")
        out[label] = counts
    return out


def phase_samplers(cfg, pipe, smi: str):
    """SD-1.5 at full width through ``SDPipeline`` (the slice's random bf16
    weights, 512², batch 4, CFG 7.5): every scheduler variant at 10 steps
    (lcm at 4) and DDIM-10 with each option, one call each with finite
    images of the expected shape and exact K1/K4 launches from its
    evaluation count (a warm-up call first where a run meets new shapes:
    the first run, cfg_interval's batch 4, FreeU's FFT, img2img's encode);
    then DDIM-10 against its cfg_interval, cache_interval and decode=False
    calls in alternating rounds (medians); then the serving profile, dpm
    at 25 steps, warmed up and timed (median of 3).  Returns (launch
    counts by path, dpm-25 s/call)."""
    import dataclasses

    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline, img2img_t_start
    from sdbc_tpu_torch.models import unet as unet_mod
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    lat = per_sample_fixed_latents(4, (4, 64, 64), 42)
    # a smooth synthetic cover to re-diffuse, and a mask of its left half
    yy, xx = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512),
                         indexing="ij")
    image = np.stack([yy, xx, 0.5 * (yy + xx)], -1).astype(np.float32)
    half = np.zeros((512, 512), np.float32)
    half[:, :256] = 1.0
    strength = 0.6
    # (label, scheduler, steps, call options, sampler_evals options, warm)
    runs = [(f"{label}", s, 4 if s == "lcm" else 10,
             dict(use_karras_sigmas=True) if k else {}, {}, i == 0)
            for i, (label, s, k) in enumerate(scheduler_variants())]
    options = {
        "cfg_interval=(0.1, 0.6)": (dict(cfg_interval=(0.1, 0.6)), {}, True),
        "cache_interval=3": (dict(cache_interval=3), {}, False),
        "freeu + guidance_rescale=0.7 + clip_skip=2": (
            dict(freeu=unet_mod.FREEU_SD15, guidance_rescale=0.7,
                 clip_skip=2), {}, True),
        f"img2img strength {strength}": (
            dict(init_image=image, strength=strength),
            dict(t_start=img2img_t_start(10, strength)), True),
        "inpaint half mask": (dict(init_image=image, mask_image=half),
                              dict(t_start=img2img_t_start(10, 0.8)), False),
        "decode=False": (dict(decode=False), {}, False),
    }
    runs += [(f"ddim {k}", "ddim", 10, kw, extra, warm)
             for k, (kw, extra, warm) in options.items()]
    pipes = {s: SDPipeline(pipe.models, dataclasses.replace(
        cfg, scheduler=s), pipe.tokenizer, "cuda", torch.bfloat16)
        for s in {r[1] for r in runs}}

    def caller(scheduler, n, kw):
        return lambda: pipes[scheduler](
            PROMPTS, height=512, width=512, num_inference_steps=n,
            guidance_scale=7.5, latents=lat, **kw)

    paths = {}
    for label, scheduler, n, kw, extra, warm in runs:
        call = caller(scheduler, n, kw)
        if warm:
            call()
            torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_kernels.launches)
        evals = evals_of(scheduler, n, dict(kw, **extra))
        want = sampler_launches(cfg, 64, 4, evals)
        print(f"[samplers] SD-1.5 512^2 batch 4 {label} ({n} steps, "
              f"{len(evals)} UNet evaluations: {evals.count('guided')} "
              f"guided, {evals.count('cond')} cond-only, "
              f"{evals.count('reuse')} on the cached trunk): one call "
              f"{secs:.3f} s, K1 {counts['flash_fixed']} K4 "
              f"{counts['geglu_ff']} (expected {want['flash_fixed']}, "
              f"{want['geglu_ff']})", flush=True)
        shape = (4, 512, 512, 3) if kw.get("decode", True) else (4, 64, 64, 4)
        if out.shape != shape or not np.isfinite(out).all():
            fail(f"samplers {label}: output {out.shape} (expected {shape}) "
                 f"not finite")
        if counts != want or want["flash_fixed"] == 0:
            fail(f"samplers {label}: launch counts {counts}, expected "
                 f"{want}")
        paths[f"samplers {label}"] = counts

    # what each option saves against DDIM-10: host-clock medians over
    # alternating rounds (a, b, c, d, d, c, b, a, ...), every shape warm
    paired = {"ddim": {}, **{k: options[k][0] for k in (
        "cfg_interval=(0.1, 0.6)", "cache_interval=3", "decode=False")}}
    fns = [caller("ddim", 10, kw) for kw in paired.values()]
    got = [[] for _ in fns]
    for r in range(6):
        for i in (range(len(fns)) if r % 2 == 0
                  else reversed(range(len(fns)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[i]()
            torch.cuda.synchronize()
            got[i].append(time.perf_counter() - t0)
    med = [statistics.median(g) for g in got]
    print(f"[samplers] DDIM-10 512^2 batch 4, 6 alternating rounds, median "
          f"(min-max) s/call: " + "; ".join(
              f"{k} {m:.4f} ({min(g):.4f}-{max(g):.4f})"
              for k, m, g in zip(paired, med, got))
          + f"; saved a call: cfg_interval {med[0] - med[1]:.4f} s (5 "
          f"evaluations at batch 4), cache_interval {med[0] - med[2]:.4f} "
          f"s (6 reuse steps), decode {med[0] - med[3]:.4f} s | {smi}",
          flush=True)

    # the CLI's serving profile: dpm at 25 steps
    call = caller("dpm", 25, {})
    t0 = time.perf_counter()
    call()  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for rep in range(3):
        if rep == 0:
            _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            counts = dict(_kernels.launches)
    secs = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    want = sampler_launches(cfg, 64, 4, sampler_evals("dpm", 25))
    print(f"[samplers] SD-1.5 512^2 batch 4 dpm-25 CFG 7.5 bf16: "
          f"{secs:.3f} s/call (median of 3: "
          f"{', '.join(f'{t:.3f}' for t in times)}), {4 / secs:.4f} "
          f"images/s, warm-up {warm:.3f} s, peak {peak / 2 ** 30:.2f} GiB, "
          f"K1 {counts['flash_fixed']} K4 {counts['geglu_ff']} (expected "
          f"{want['flash_fixed']}, {want['geglu_ff']}) | {smi}", flush=True)
    if imgs.shape != (4, 512, 512, 3) or not np.isfinite(imgs).all():
        fail(f"dpm-25 images {imgs.shape} not finite")
    if counts != want:
        fail(f"dpm-25 launch counts {counts}, expected {want}")
    paths["samplers dpm-25"] = counts
    return paths, secs


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
    want = dict.fromkeys(_kernels.launches, 0)
    want.update({"flash_fixed": 50 * flash, "geglu_ff": 50 * geglu})
    print(f"[slice] SD-1.5 512^2 batch 4 DDIM-50 CFG 7.5 bf16: "
          f"{secs:.3f} s/call, {4 / secs:.4f} images/s, warm-up "
          f"{warm:.3f} s, peak {peak / 2 ** 30:.2f} GiB, launches {counts} "
          f"(expected {want}) | {smi}", flush=True)
    if imgs.shape != (4, 512, 512, 3) or not np.isfinite(imgs).all():
        fail(f"slice images {imgs.shape} not all finite")
    if imgs.min() < 0.0 or imgs.max() > 1.0:
        fail("slice images outside [0, 1]")
    if (want["flash_fixed"], want["geglu_ff"]) != (750, 500) \
            or counts != want:
        fail(f"slice launch counts {counts}, expected {want}")
    if "jax" in sys.modules:
        fail("jax was imported")
    return counts, secs


def phase_decode(pipe, impl: str):
    """One VAE decode of a 64² latent under ``SDBC_ATTN_IMPL=impl``, held to
    the default decode (plain attention, fp32 logits) on the same latent.
    The mid block's 512-wide single head (4096 tokens): under "flash" K5's
    wide kernel (one ``flash_fwd`` launch, nothing else); under "inference"
    the fixed cap on the same kernel's fixed-cap variant (one
    ``flash_fixed`` launch, nothing else).  Tolerance: both are bf16
    decodes, each
    about e = max|default - fp32 decode| (the fp32 decode of the same
    weights, measured here) from the exact image, so two such roundings of
    one decode lie within 2e of each other."""
    import torch

    from sdbc_tpu_torch.models import vae as vae_mod
    from sdbc_tpu_torch.ops import _kernels

    vae = pipe.models["vae"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    z = (torch.randn((1, 64, 64, vae.cfg.latent_channels), generator=gen,
                     device="cuda") / vae.cfg.scaling_factor).bfloat16()
    none = dict.fromkeys(_kernels.launches, 0)
    with torch.inference_mode():
        _kernels.reset_launch_counts()
        img = vae_mod.decode(vae, z)
        torch.cuda.synchronize()
        default_counts = dict(_kernels.launches)
        with environment(SDBC_ATTN_IMPL=impl):
            _kernels.reset_launch_counts()
            img_sw = vae_mod.decode(vae, z)
            torch.cuda.synchronize()
            counts = dict(_kernels.launches)
            sw_ms = wall_ms(lambda: vae_mod.decode(vae, z), 3)
        default_ms = wall_ms(lambda: vae_mod.decode(vae, z), 3)
        img32 = vae_mod.decode(copy.deepcopy(vae).float(), z.float())
    err = (img_sw.float() - img.float()).abs().max().item()
    e32 = (img.float() - img32).abs().max().item()
    sw32 = (img_sw.float() - img32).abs().max().item()
    tol = 2 * e32
    want = dict(none, **{"flash_fwd" if impl == "flash"
                         else "flash_fixed": 1})
    print(f"[decode] VAE decode 64^2 latent, SDBC_ATTN_IMPL={impl} vs the "
          f"default decode: max abs diff {err:.3e} (tol {tol:.3e}, twice the "
          f"default bf16 decode's {e32:.3e} from the fp32 decode; the "
          f"{impl} decode's {sw32:.3e}; image range "
          f"{img32.abs().max().item():.3f}); launches {counts} (default "
          f"decode {default_counts}); wall {sw_ms:.3f} ms (default "
          f"{default_ms:.3f} ms)", flush=True)
    if img_sw.shape != (1, 512, 512, 3) \
            or not torch.isfinite(img_sw).all() or not err <= tol:
        fail(f"decode under SDBC_ATTN_IMPL={impl}: shape "
             f"{tuple(img_sw.shape)}, max abs diff {err} (tol {tol})")
    if counts != want or default_counts != none:
        fail(f"decode launch counts {counts} (expected {want}), default "
             f"decode {default_counts} (expected none)")
    return counts


def phase_profile(pipe):
    """Device time by kernel over one UNet evaluation (CFG batch 8, 64²),
    and over one at batch 4 (cfg_interval's cond-only evaluation)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdbc_tpu_torch.models import unet as unet_mod

    dev = torch.device("cuda")
    unet = pipe.models["unet"]
    g = torch.Generator(device=dev).manual_seed(7)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    def profiled(b):
        """(run, kernel µs, top kernels) of one evaluation at batch b."""
        lat = torch.randn((b, 64, 64, 4), generator=g, device=dev).bfloat16()
        ctx = torch.randn((b, 77, 768), generator=g, device=dev).bfloat16()
        tb = torch.full((b,), 500, device=dev)
        run = lambda: unet_mod.apply(unet, lat, tb, ctx,
                                     attn_impl="inference")
        with torch.inference_mode():
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        # kernel-level events only: an operator's own device time repeats
        # the time of the kernels it launched
        events = [e for e in prof.key_averages() if dev_us(e) > 0
                  and getattr(e, "device_type", None) == DeviceType.CUDA]
        top = sorted(events, key=lambda e: -dev_us(e))[:10]
        return (run, sum(dev_us(e) for e in events),
                [(e.key[:60], round(dev_us(e) / 1e3, 3)) for e in top])

    run, total, summary = profiled(8)
    if total == 0:
        print("[profile] UNet eval: device time not measured (profiler saw "
              "no device time)", flush=True)
        return
    run4, total4, summary4 = profiled(4)
    # stage wall times (host clock around synchronized work, medians)
    from sdbc_tpu_torch.diffusion import graph
    from sdbc_tpu_torch.models import vae as vae_mod

    z = torch.randn((4, 64, 64, 4), generator=g, device=dev).bfloat16()
    ids = pipe.tokenize(PROMPTS)
    with torch.inference_mode():
        unet_ms = wall_ms(run, 5)
        unet4_ms = wall_ms(run4, 5)
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
    print(f"[profile] UNet eval (batch 4, 64^2, cfg_interval's cond-only "
          f"evaluation): wall {unet4_ms:.3f} ms, kernels {total4 / 1e3:.3f} "
          f"ms (device idle {100 * (1 - total4 / 1e3 / unet4_ms):.1f}%), "
          f"{unet4_ms / unet_ms:.3f} of batch 8's wall, "
          f"{total4 / total:.3f} of its kernel time; top kernels (ms): "
          f"{summary4}", flush=True)


def _train_cfg(**kw):
    from sdbc_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(train_text_encoder=True, train_unet=True,
                       use_8bit_adam=True, **kw)


def _n8(state) -> int:
    """Optimizer leaves on the 8-bit path (≥ min_8bit_size elements; the
    text encoder's layers stacked into one leaf per name, as in JAX)."""
    from sdbc_tpu_torch.train.adam8bit import MIN_8BIT_SIZE
    from sdbc_tpu_torch.train.trainer import optimizer_leaves

    return sum(sum(p.numel() for p in leaf) >= MIN_8BIT_SIZE
               for leaf in optimizer_leaves(state.trainable))


def phase_train_parity(label: str = "default", env=None,
                       card_dtype=None, **tcfg_kw):
    """One optimizer step of the tiny config, bf16 (or ``card_dtype``) on
    the card against fp32 on the CPU, from the same fp32 masters and the
    same injected draws, under the environment ``env`` on both sides.  In
    fp32 the flash forward and backward run on their CUDA-core kernels
    (``fp32_launches``), the 8-bit AdamW as in bf16."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.diffusion.schedulers import make_schedule
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train.trainer import (diffusion_loss,
                                              init_train_state,
                                              make_train_step, merged_params,
                                              trainable_params)

    cfg = PipelineConfig.tiny()
    tcfg = _train_cfg(grad_accum=2, micro_batch=2, learning_rate=1e-3,
                      num_examples=100, **tcfg_kw)
    base = init_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    f32 = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32))
    batch = {"pixel_values": f32(2, 2, 32, 32, 3) * 0.5,
             "input_ids": torch.from_numpy(rng.integers(
                 0, cfg.clip.vocab_size, (2, 2, cfg.clip.ctx)))}
    draws = [{"eps": f32(2, 16, 16, 4), "noise": f32(2, 16, 16, 4),
              "t": torch.from_numpy(rng.integers(0, 1000, (2,)))}
             for _ in range(2)]
    def micro_grads(state, dev, dt):
        """The held gradients of the first micro-batch's loss."""
        loss = diffusion_loss(merged_params(state),
                              {k: v[0].to(dev) for k, v in batch.items()},
                              cfg, tcfg, make_schedule(cfg.schedule, dev), dt,
                              draws=draws[0])
        loss.backward()
        out = {n: p.grad.float().cpu().clone() for n, p in
               state.trainable["unet"].named_parameters()
               if n.endswith(HELD_GRADS)}
        for p in trainable_params(state.trainable):
            p.grad = None
        return out

    runs = {}
    with environment(**(env or {})):
        for dev, dt in (("cpu", torch.float32),
                        ("cuda", card_dtype or torch.bfloat16)):
            state = init_train_state(copy.deepcopy(base), tcfg,
                                     compute_dtype=dt, device=dev)
            grads = micro_grads(state, dev, dt)
            before = [p.detach().float().cpu().clone()
                      for p in trainable_params(state.trainable)]
            step = make_train_step(cfg, tcfg, compute_dtype=dt, device=dev)
            _kernels.reset_launch_counts()
            state, m = step(state, batch, draws=draws)
            if dev == "cuda":
                torch.cuda.synchronize()
            counts = dict(_kernels.launches)
            after = [p.detach().float().cpu()
                     for p in trainable_params(state.trainable)]
            runs[dev] = (m, [a - b for a, b in zip(after, before)], counts,
                         state, grads)
    (mc, dc, cc, _, gc), (mg, dg, cg, sg, gg) = runs["cpu"], runs["cuda"]
    grad_rel = {n: float((gg[n] - gc[n]).norm() / gc[n].norm()) for n in gc}
    worst_grad = max(grad_rel, key=grad_rel.get)
    lerr = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    cos = float(sum((a * b).sum() for a, b in zip(dg, dc))
                / (sum((a * a).sum() for a in dg).sqrt()
                   * sum((b * b).sum() for b in dc).sqrt()))
    worst = max(float((a - b).abs().max()) for a, b in zip(dg, dc))
    want = expected_train_launches(cfg, tcfg, 32, _n8(sg),
                                   switches=bool(env))
    if card_dtype == torch.float32:
        want = fp32_launches(want)
    print(f"[train-parity] tiny grad_accum 2 micro 2, 8-bit AdamW, one step "
          f"({label}): loss card {mg['loss']:.6f} cpu {mc['loss']:.6f} (rel "
          f"err {lerr:.3e}, tol {TRAIN_LOSS_RTOL}); update cosine {cos:.5f} "
          f"(tol {TRAIN_UPDATE_COS}), max |Δ| difference {worst:.3e} "
          f"(bound {TRAIN_STEP_BOUND * tcfg.learning_rate}); micro-batch "
          f"gradient rel err of {len(grad_rel)} self-attention projections: "
          f"max {grad_rel[worst_grad]:.3e} ({worst_grad}), median "
          f"{statistics.median(grad_rel.values()):.3e} (tol "
          f"{TRAIN_GRAD_RTOL}); launches {cg} (expected {want}; CPU {cc})",
          flush=True)
    if not (mg["finite"] and mc["finite"] and np.isfinite(mg["loss"])):
        fail(f"tiny train step ({label}) not finite")
    if not grad_rel[worst_grad] <= TRAIN_GRAD_RTOL:
        fail(f"tiny train step ({label}): micro-batch gradients card vs CPU "
             f"{grad_rel}")
    if not (lerr <= TRAIN_LOSS_RTOL and cos >= TRAIN_UPDATE_COS
            and worst <= TRAIN_STEP_BOUND * tcfg.learning_rate):
        fail(f"tiny train step ({label}): card vs CPU outside tolerance")
    if cg != want or set(cc.values()) != {0}:
        fail(f"tiny train step ({label}) launch counts {cg}, expected {want}")
    used = (("gn_fused", "flash_tt") if env else ("flash_fwd",)) \
        + ("flash_bwd_dq", "flash_bwd_dkv", "adam8")
    if card_dtype == torch.float32:
        used = tuple(SIMT_OF.get(k, k) for k in used)
    if min(cg[k] for k in used) == 0 or (env and cg["flash_fwd"]):
        fail(f"tiny train step ({label}) skipped a kernel: {cg}")
    return cg


def phase_train(smi: str, steps: int = 3, label: str = "train", env=None,
                profile: bool = True, **tcfg_kw):
    """Bench mode C at full width: warm-up step, ``steps`` timed steps, with
    ``tcfg_kw`` added to the train config and the environment ``env``;
    returns (launches of the timed steps, median s/step, peak bytes)."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train.trainer import (init_train_state,
                                              make_train_step,
                                              trainable_params)

    cfg = PipelineConfig.sd15()
    accum, micro = 4, 2
    tcfg = _train_cfg(grad_accum=accum, micro_batch=micro, num_examples=1000,
                      **tcfg_kw)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # nothing of an earlier phase (a profiler's trace, a model) may hold
    # device memory or leave the allocator's cache to this one
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(init_models(cfg, device="cuda", generator=gen),
                             tcfg)
    step = make_train_step(cfg, tcfg)
    batch = {"pixel_values": torch.rand((accum, micro, 512, 512, 3),
                                        generator=gen, device="cuda") * 2 - 1,
             "input_ids": torch.randint(0, cfg.clip.vocab_size,
                                        (accum, micro, cfg.clip.ctx),
                                        generator=gen, device="cuda")}
    params = trainable_params(state.trainable)
    watch = [params[0], params[len(params) // 2], params[-1]]
    start = [p.detach().clone() for p in watch]
    n_train = sum(p.numel() for p in params)
    with environment(**(env or {})):
        t0 = time.perf_counter()
        state, m = step(state, batch, generator=gen)  # warm-up
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        losses, times = [m["loss"]], []
        _kernels.reset_launch_counts()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, generator=gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            if not m["finite"]:
                fail(f"{label} step skipped (non-finite gradients), loss "
                     f"{m['loss']}")
        counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    n8 = _n8(state)
    want = {k: steps * v for k, v in expected_train_launches(
        cfg, tcfg, 512, n8, switches=bool(env)).items()}
    flash, _ = expected_launches(cfg, 64, micro * 8)
    moved = [float((p.detach() - s0).abs().max()) for p, s0 in
             zip(watch, start)]
    sps = statistics.median(times)
    extra = "".join(f" {k}={v}" for k, v in tcfg_kw.items())
    extra += "".join(f" {k}={v}" for k, v in (env or {}).items())
    print(f"[{label}] mode C SD-1.5 512^2 micro 2 grad_accum 4 8-bit AdamW"
          f"{extra} (UNet + text encoder, {n_train / 1e9:.3f} B trainable, "
          f"{n8} 8-bit leaves): {sps:.4f} s/step (median of {steps}: "
          f"{[round(t, 4) for t in times]}), {8 / sps:.4f} images/s, warm-up "
          f"{warm:.3f} s, peak {peak / 2 ** 30:.2f} GiB, losses "
          f"{[round(x, 6) for x in losses]}, params moved {moved}, launches "
          f"{counts} (expected {want}) | {smi}", flush=True)
    if flash * accum != 60:
        fail(f"mode C implies {flash * accum} flash calls per step, not 60")
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail(f"{label} losses not finite: {losses}")
    if not all(x > 0 for x in moved):
        fail(f"{label}: trainable parameters did not move: {moved}")
    if counts != want:
        fail(f"{label} launch counts {counts}, expected {want}")
    if profile:
        phase_train_profile(step, state, batch, gen, sps, label)
    return counts, sps, peak


def phase_train_ckpt(smi: str, no_remat):
    """Mode C with gradient checkpointing, per remat mode, beside the
    no-remat train phase of the same run (``no_remat``: its s/step and
    peak bytes): 3 timed steps and a device-time profile of one more."""
    out = {}
    for mode in ("block", "selective"):
        counts, sps, peak = phase_train(smi, label=f"train-ckpt {mode}",
                                        grad_ckpt=True, remat_mode=mode)
        out[mode] = counts
        print(f"[train-ckpt] remat_mode={mode}: {sps:.4f} s/step, "
              f"{8 / sps:.4f} images/s, peak {peak / 2 ** 30:.2f} GiB; "
              f"no remat: {no_remat[0]:.4f} s/step, {8 / no_remat[0]:.4f} "
              f"images/s, peak {no_remat[1] / 2 ** 30:.2f} GiB", flush=True)
    if out["block"]["flash_fwd"] != 2 * out["selective"]["flash_fwd"]:
        fail(f"train-ckpt: flash forwards block {out['block']} vs selective "
             f"{out['selective']}")
    return out


def phase_switches_sampling(cfg, pipe, smi: str):
    """One full-width sampling call under ``SDBC_GN_FUSED=1``."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    lat = per_sample_fixed_latents(4, (4, 64, 64), 42)
    flash, geglu = expected_launches(cfg, 64, 8)
    want = dict.fromkeys(_kernels.launches, 0)
    want.update({"flash_fixed": 50 * flash, "geglu_ff": 50 * geglu,
                 "gn_fused": 50 * gn_launches(cfg, 64)
                 + 4 * vae_gn_launches(cfg, 64, "decode")})
    with environment(SDBC_GN_FUSED="1"):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = pipe(PROMPTS, height=512, width=512, num_inference_steps=50,
                    guidance_scale=7.5, latents=lat)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_kernels.launches)
    print(f"[switches] sampling SD-1.5 512^2 batch 4 DDIM-50 SDBC_GN_FUSED=1: "
          f"{secs:.3f} s/call, {4 / secs:.4f} images/s, launches {counts} "
          f"(expected {want}) | {smi}", flush=True)
    if imgs.shape != (4, 512, 512, 3) or not np.isfinite(imgs).all():
        fail(f"switches sampling images {imgs.shape} not all finite")
    if counts != want or want["gn_fused"] == 0:
        fail(f"switches sampling launch counts {counts}, expected {want}")
    return counts


# the Inception extractor on the card (strict fp32) against the same
# model's features on the CPU: both fp32, different summation orders
INCEPTION_TOL = 1e-3  # of the largest CPU feature
# a FID of a set against itself: zero up to rounding, relative to tr Σ
# (float64 eigh of a rank-n 2048² covariance: ~2000 zero eigenvalues at
# ~1e-16 of the largest, each adding its square root, ~1e-8 of it)
FID_SELF_TOL = 1e-4
# two 77-token windows under the hash tokenizer (``_tokenizer``): 112
# content tokens
WEIGHTED_PROMPT = ("a (dark fantasy:1.3) novel cover, ((a lone knight)) "
                   "before a [ruined] castle under a blood red moon, "
                   "ravens circling the towers, ornate gold border")


def phase_generate(smi: str):
    """The evaluation entry points at full width, as the CLIs run them:
    ``cli.common.resolve_params_cfg`` on parsed ``cli.inference``
    arguments with no checkpoint (random SD-1.5 from --seed, bf16 on the
    card), then ``SDPipeline.generate`` with the CLI's serving profile
    (``cli.inference.profile_spec``; dpm-25, CFG 7.5, 512²): 4 template
    prompts (bucket 4), 6 prompts padded to bucket 8 (6 images back), one
    ``prompt_weighting`` call over two CLIP windows, and the README's
    hires profile (1024², hires_scale 2, strength 0.7, latent mode, batch
    1); each warmed up, then one timed call with exact K1/K4 launches.
    Then FID: ``eval.fid.get_activations`` of the generated images (uint8,
    resized to 299² on the card) held to the same model's CPU fp32
    features (``INCEPTION_TOL``), the extractor's ms per batch of 50, the
    statistics and Fréchet distances (a set against itself ≈ 0).  No PIL,
    no pandas.  Returns the launch counts by path."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as cli
    from sdbc_tpu_torch.data import templates
    from sdbc_tpu_torch.data.prompt_weights import encode_weighted
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.eval import fid as fid_mod
    from sdbc_tpu_torch.models import inception as inception_mod
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.image import resize

    t0 = time.perf_counter()
    args = cli.build_parser().parse_args(
        ["--scheduler", "dpm", "--num_inference_steps", "25", "--seed", "0"])
    common.refuse_unported(args)
    common.resolve_img_size(args)
    models, cfg = common.resolve_params_cfg(args)
    dtypes = {p.dtype for m in models.values() for p in m.parameters()}
    devices = {p.device.type for m in models.values()
               for p in m.parameters()}
    if dtypes != {torch.bfloat16} or devices != {"cuda"}:
        fail(f"resolve_params_cfg gave {dtypes} on {devices}")
    pipe = SDPipeline(models, cfg,
                      common.make_tokenizer(args, cfg.clip.vocab_size),
                      device=args.device,
                      compute_dtype=common.compute_dtype(args))
    spec = cli.profile_spec(args, cfg).replace(
        height=args.img_size, width=args.img_size,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, seed=args.seed)
    print(f"[generate] resolve_params_cfg (random SD-1.5, bf16) and the "
          f"pipeline: {time.perf_counter() - t0:.3f} s", flush=True)
    ids, _ = encode_weighted(pipe.tokenizer, WEIGHTED_PROMPT,
                             cfg.clip.ctx, 3)
    if ids.shape[0] != 2 * cfg.clip.ctx:
        fail(f"the weighted prompt spans {ids.shape[0] // cfg.clip.ctx} "
             "CLIP windows, expected 2")
    prompts8 = [templates.TEST_TEMPLATES[i] for i in range(6)]
    runs = [("generate bucket 4", PROMPTS, spec, {}),
            ("generate bucket 8", prompts8, spec, {}),
            ("generate prompt_weighting", [WEIGHTED_PROMPT, PROMPTS[0]],
             spec.replace(prompt_weighting=True), {}),
            ("hires 1024^2", PROMPTS[:1],
             spec.replace(height=1024, width=1024, hires_scale=2.0,
                          hires_strength=0.7, hires_mode="latent"),
             dict(hires_scale=2.0, hires_strength=0.7))]
    paths, images = {}, {}
    for label, prompts, sp, hires in runs:
        want = generate_launches(cfg, len(prompts), sp.num_inference_steps,
                                 sp.height, "dpm", **hires)
        t0 = time.perf_counter()
        pipe.generate(prompts, sp)  # warm-up
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = pipe.generate(prompts, sp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(_kernels.launches)
        print(f"[generate] {label}: {len(prompts)} prompts, {secs:.3f} "
              f"s/call ({len(prompts) / secs:.4f} images/s), warm-up "
              f"{warm:.3f} s, K1 {counts['flash_fixed']} K4 "
              f"{counts['geglu_ff']} (expected {want['flash_fixed']}, "
              f"{want['geglu_ff']}) | {smi}", flush=True)
        shape = (len(prompts), sp.height, sp.width, 3)
        if imgs.shape != shape or not np.isfinite(imgs).all() \
                or imgs.min() < 0.0 or imgs.max() > 1.0:
            fail(f"{label}: images {imgs.shape} (expected {shape}) not "
                 "finite in [0, 1]")
        if counts != want or want["flash_fixed"] == 0:
            fail(f"{label}: launch counts {counts}, expected {want}")
        paths[label] = counts
        images[label] = np.uint8(np.round(imgs * 255.0))
    del pipe, models
    torch.cuda.empty_cache()

    # FID: the extractor of eval.fid.default_params (SDBC_INCEPTION_WEIGHTS
    # unset: random weights, seed 2015) on the card and its copy on the CPU
    icfg = inception_mod.InceptionConfig.fid()
    model = fid_mod.default_params(icfg, device="cuda")
    model_cpu = copy.deepcopy(model).cpu()
    gen512 = np.concatenate([images[k] for k in (
        "generate bucket 4", "generate bucket 8",
        "generate prompt_weighting")])
    n = gen512.shape[0]
    t0 = time.perf_counter()
    card = fid_mod.get_activations(gen512, model, batch_size=n)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = fid_mod.get_activations(gen512, model_cpu, batch_size=n)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card - cpu).max())
    scale = float(np.abs(cpu).max())
    hires_feats = fid_mod.get_activations(images["hires 1024^2"], model,
                                          batch_size=1)
    batch50 = torch.from_numpy(np.resize(gen512, (50,) + gen512.shape[1:]))
    batch50 = batch50.cuda()
    inc_ms = median_ms(lambda: inception_mod.features(model, batch50), 5)
    # the choice features() makes: the same extractor with cuDNN's TF32
    # convolutions (PyTorch's default), its error and time beside
    with torch.inference_mode():
        def tf32(u8):
            x = resize(u8.float(), (u8.shape[0], 299, 299, 3), "bilinear")
            x = ((x - 128.0) / 128.0).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            return model(x)

        old_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_err = float(np.abs(tf32(torch.from_numpy(gen512).cuda())
                                    .cpu().numpy() - cpu).max())
            tf32_ms = median_ms(lambda: tf32(batch50), 5)
        finally:
            torch.backends.cudnn.allow_tf32 = old_tf32
    # one image's 299² pool3 path: 5.72 G multiply-adds (InceptionV3)
    inc_bound, inc_by = bound(50 * 512 * 512 * 3 + 50 * 2048 * 4,
                              fp32_ops=50 * 2 * 5.72e9)
    print(f"[fid] Inception pool3 (random weights, seed 2015) on {n} "
          f"generated 512^2 images, card (strict fp32, TF32 off) vs CPU "
          f"fp32: max abs diff {err:.3e} of largest feature {scale:.3e} "
          f"(rel {err / scale:.3e}, tol {INCEPTION_TOL:.0e}); card "
          f"{card_s:.3f} s, CPU {cpu_s:.3f} s for the {n}; a batch of 50 "
          f"(uint8 512^2 -> 299^2 on the card): {inc_ms:.3f} ms (CUDA "
          f"events, median of 5), fp32 bound {inc_bound:.3f} ms ({inc_by}); "
          f"with cuDNN TF32 instead: max abs diff {tf32_err:.3e} (rel "
          f"{tf32_err / scale:.3e}), {tf32_ms:.3f} ms a batch of 50 | "
          f"{smi}", flush=True)
    if card.shape != (n, 2048) or not np.isfinite(card).all() \
            or not err <= INCEPTION_TOL * scale:
        fail(f"Inception features {card.shape}: card vs CPU {err} > "
             f"{INCEPTION_TOL} x {scale}")
    if hires_feats.shape != (1, 2048) or not np.isfinite(hires_feats).all():
        fail(f"Inception features of the hires image {hires_feats.shape}")
    mu, sigma = fid_mod.calculate_activation_statistics(gen512, model,
                                                        batch_size=50)
    mu_c, sigma_c = np.mean(cpu, 0), np.cov(cpu, rowvar=False)
    self_fid = fid_mod.calculate_frechet_distance(mu, sigma, mu, sigma)
    cross_fid = fid_mod.calculate_frechet_distance(mu, sigma, mu_c, sigma_c)
    split = fid_mod.calculate_frechet_distance(
        np.mean(card[:4], 0), np.cov(card[:4], rowvar=False),
        np.mean(card[4:10], 0), np.cov(card[4:10], rowvar=False))
    tr = float(np.trace(sigma))
    print(f"[fid] statistics of the {n}: tr sigma {tr:.6e}; FID against "
          f"itself {self_fid:.3e}, card vs CPU features {cross_fid:.3e}, "
          f"bucket-4 images vs bucket-8 images {split:.6e}", flush=True)
    if not all(np.isfinite(x) for x in (self_fid, cross_fid, split, tr)) \
            or not abs(self_fid) <= FID_SELF_TOL * tr or not split > 0:
        fail(f"FID: self {self_fid} (tol {FID_SELF_TOL} x {tr}), card vs "
             f"CPU {cross_fid}, split {split}")
    if "jax" in sys.modules or "PIL" in sys.modules \
            or "pandas" in sys.modules:
        fail("jax, PIL or pandas was imported")
    return paths


def phase_train_profile(step, state, batch, gen, sps: float,
                        label: str = "train"):
    """Device time by kernel over one mode-C optimizer step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, generator=gen)
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev_us(e) for e in events) / 1e3
    if total == 0:
        print(f"[train-profile] {label}: device time not measured "
              f"(profiler saw no device time)", flush=True)
        return
    top = sorted(events, key=lambda e: -dev_us(e))[:12]
    summary = [(e.key[:48], round(dev_us(e) / 1e3, 2), e.count) for e in top]
    ours = {n: round(sum(dev_us(e) for e in events if n in e.key) / 1e3, 3)
            for n in ("flash_fwd_sm90_kernel", "flash_fwd_wide_sm90_kernel",
                      "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
                      "flash_bwd_dq_wide_sm90_kernel",
                      "flash_bwd_dkv_wide_sm90_kernel",
                      "adam8_leaves_kernel")}
    # host side: operators by their own CPU time (the profiler's, which
    # inflates it) and the number of device kernels launched
    host = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) != DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    host_summary = [(e.key[:40], round(e.self_cpu_time_total / 1e3, 1),
                     e.count) for e in host]
    n_kernels = sum(e.count for e in events)
    print(f"[train-profile] {label}, one step: kernels {total:.1f} ms of "
          f"{sps * 1e3:.1f} ms unprofiled wall (device idle "
          f"{100 * (1 - total / (sps * 1e3)):.1f}%), {n_kernels} kernel "
          f"launches; ours (ms) {ours}; top kernels (ms, calls): {summary}; "
          f"top host operators (self CPU ms, calls): {host_summary}",
          flush=True)


def main() -> int:
    if not (ROOT / "sdbc_tpu_torch").is_dir():
        fail(f"run from a checkout of the repo: no sdbc_tpu_torch/ beside "
             f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    t0 = time.perf_counter()
    smi = phase_device()
    build = phase_build()
    rows = phase_kernels(build["gn"], build["int8"]) \
        + phase_train_kernels(build["adam8"]) + phase_simt_kernels()
    # launch counts of each full-width path (and of the tiny fp32 ones),
    # from its own run (the counts set to 0 just before it, read just after)
    paths = {"sampling fp32 (tiny)": phase_parity()}
    paths.update({f"sampler-parity {k} (tiny)": v
                  for k, v in phase_sampler_parity().items()})
    cfg, pipe = _slice_setup()
    paths["sampling"], _ = phase_slice(cfg, pipe, smi)
    paths["decode SDBC_ATTN_IMPL=flash"] = phase_decode(pipe, "flash")
    paths["decode SDBC_ATTN_IMPL=inference"] = phase_decode(pipe,
                                                            "inference")
    phase_profile(pipe)
    paths["sampling SDBC_GN_FUSED=1"] = phase_switches_sampling(cfg, pipe,
                                                                smi)
    sampler_paths, _ = phase_samplers(cfg, pipe, smi)
    paths.update(sampler_paths)
    del pipe
    torch.cuda.empty_cache()
    paths.update(phase_generate(smi))
    torch.cuda.empty_cache()
    phase_train_parity()
    phase_train_parity("grad_ckpt block + switches", SWITCHES,
                       grad_ckpt=True, remat_mode="block")
    paths["train fp32 (tiny)"] = phase_train_parity(
        "fp32", card_dtype=torch.float32)
    paths["train"], sps, peak = phase_train(smi)
    ckpt = phase_train_ckpt(smi, (sps, peak))
    paths["train grad_ckpt block"] = ckpt["block"]
    paths["train grad_ckpt selective"] = ckpt["selective"]
    paths["train switches"], _, _ = phase_train(
        smi, steps=1, label="switches", env=SWITCHES, profile=False)
    if "jax" in sys.modules:
        fail("jax was imported")
    for row in rows:
        row["path"] = MAIN_PATH[row["name"]]
        row["launches"] = paths[row["path"]][row["name"]]
        # every path where the kernel launched (0 on the others)
        row["launches_by_path"] = {p: c[row["name"]] for p, c in
                                   paths.items() if c[row["name"]]}
    print(f"[done] all phases in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
