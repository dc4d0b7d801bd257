"""Drive the PyTorch/CUDA port (``sdbc_tpu_torch``) once on one H100.

    python3 chip_smoke.py

Phases, in order; each prints one or more lines, and any failure raises
(exit code non-zero, no result line):

1. device       — a CUDA device of capability 9.0, and its ``nvidia-smi``
                  name and power limit;
2. build        — compile ``sdbc_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
                  (one nvcc per source, all started together);
3. kernels      — each sampling kernel against its plain PyTorch version on
                  the card, at the shapes SD-1.5 512² sampling gives it at
                  4 images and at 1 (CFG batch 8 and 2; 4 in
                  cfg_interval's cond-only evaluations; bf16 inputs; the
                  plain version in fp32 on the same bf16 values), with
                  CUDA-event medians of the kernel, the plain version and
                  the one PyTorch call computing the same function (where
                  there is one): the fixed-cap attention
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
                  32² and a ragged case); the flash forward and both
                  backward kernels also at the families' training shapes,
                  head dim 64 (``FAMILY_TRAIN_CASES``: SDXL 1024² at
                  micro-batch 1, SD-2.1 768² at micro-batch 2);
   simt-kernels — the CUDA-core kernels, for what the tensor-core ones do
                  not take, in fp32 at SD-1.5's 64² level: the fixed cap at
                  sampling batch 8 and the training forward (both through
                  ``flash_simt``'s wrappers, and both at the VAE's 512-wide
                  head), dq and dk/dv at the mode-C step's micro-batch 2,
                  the fused FF at the sampling rows (through its launcher);
                  each against its plain version and timed against SDPA
                  (forward, backward) in alternating rounds;
   tf32-kernels — the fp32 forward on 3xTF32 wgmma (every fp32 call with a
                  head dim that is a multiple of 8 up to 512): the fixed
                  cap at sampling batch 8 and the training forward at
                  micro-batch 2 at the 64², 32² and 16² levels and a ragged
                  pair, each against its plain version (the LSE within
                  1e-5) and timed against SDPA and the CUDA-core kernel in
                  alternating rounds, with its share of the 3xTF32 and the
                  FFMA bound and SDPA's own error; the fp32 backward on its
                  LSE; the fp32 transposed-layout forward on the same
                  kernel; the wide forward (head dims 264-512) the same way
                  at the VAE's head and a ragged pair at 264 (the
                  transposed layout at 512 too); the 3xTF32 fused FF at the
                  64² and 32² sampling rows against its plain version,
                  timed against the CUDA-core FF and the unfused fp32 FF in
                  alternating rounds with both bound shares; then the fp32
                  backward on 3xTF32 wgmma (dq with
                  its split pre-pass, dk/dv) at the same levels and the
                  ragged pair, each against the plain version of what it
                  computes, the same bits twice, timed against its 3xTF32
                  and FFMA bounds, the whole call against SDPA's fp32
                  backward and the CUDA-core kernels in alternating
                  rounds (the training forward and the backward also at
                  SDXL's (1,10,4096,64)); the build phase prints their
                  registers, spills and HGMMA counts;
5. parity       — the sampling slice at the tiny config (32² image, 4 DDIM
                  steps, batch 2 with CFG): bf16 on the card against fp32
                  on the CPU, with both sampling kernels launched; then the
                  same under SDBC_GN_FUSED=1, with exact fused GroupNorm
                  launches; then fp32 on the card, every attention call on
                  the 3xTF32 kernel and every FF call on the 3xTF32 one,
                  with exact launches;
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
   export       — the slice's pipeline exported to a diffusers directory
                  (``pipeline_trees``, ``export_diffusers_checkpoint``:
                  fp32 safetensors by the port's own writer) and read back
                  through ``resolve_params_cfg --diffusers_ckpt``: every
                  weight bit for bit, DDIM-10 batch 1 from both pipelines
                  no further apart than two source calls, exact K1/K4
                  launches, bytes, write and read seconds and GB/s;
   summarize    — ``cli.inference`` in its default mode with --summarize
                  --bart_ckpt (a DistilBART-CNN-12-6-wide dir of random
                  weights in transformers' names, a byte-level vocabulary
                  covering every id, a df_test.csv of 150–300-word
                  descriptions): the (F,F), (T,T), (F,T) grids at DDIM-4
                  with exact K1/K4 launches, the summaries in the (T,T)
                  prompts, ms per description, and one description's
                  summary ids on the card against strict fp32 on the CPU
                  (a mismatch passes only after a near-tie: a candidate gap
                  below the largest score difference), that difference
                  within a bound the same search with TF32 products
                  exceeds;
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
   serve        — the daemon at full width, as ``cli.serve.main`` builds
                  it (random SD-1.5, bf16, dpm-25, --max_batch 4, a
                  --lora_bank adapter written by ``save_lora``), served on
                  an ephemeral port and driven by ``urllib``: a lone
                  request equal to ``SDPipeline.generate`` in uint8
                  pixels, four requests coalesced into one batch of 4, a
                  LoRA request equal to its merged pipeline's call, a
                  per-request DDIM-10, img2img 0.6 from a ``utils/png.py``
                  PNG, each with exact K1/K4 launches and its wall time;
                  the 400, 404 and 503 refusals and /healthz's
                  percentiles; the adapter copy's bytes and peak memory;
   image-checks — ``ClipSafetyChecker`` at ViT-L/14 224² through
                  ``SDPipeline(safety_checker=...)`` on 4 generated images
                  (exactly image 0 flagged and blacked out, the launches
                  of the generate call unchanged) and ``ClipScorer`` at
                  clip-vit-large-patch14's widths, strict fp32 on the card
                  against the CPU (``SAFETY_TOL``, ``CLIPSCORE_TOL``), each
                  timed a batch of 4;
   families     — the SD-2.x and SDXL serving paths: ``--tiny
                  --model_family sd21``, tiny_xl and the tiny_xl →
                  tiny_xl_refiner ensemble at batch 2 (64² for tiny_xl:
                  256 tokens at level 1), bf16 and fp32 on the card
                  against fp32 on the CPU within ``PARITY_TOL`` and
                  ``FP32_PARITY_TOL``, exact
                  launches (``family_launches``); then at full width
                  (random weights from seed 0, bf16, batch 1, CFG 7.5,
                  DDIM-20) SD-2.1 (v-prediction) at 768² and SDXL base at
                  1024² (median of 3 after a warm-up, peak memory, 300 /
                  200 and 1400 / 200 K1 / K4 a call), SDXL at 832×1216
                  once (1400 / 0: the 7904 rows of level 1 miss K4's
                  row block), the base → refiner ensemble at 1024²
                  handing over at 0.8 with both models resident,
                  ``cli.inference.main --model_family sdxl`` at 1024²
                  DDIM-4 writing its PNG, and one lone request to
                  ``cli.serve --model_family sdxl`` equal to ``generate``
                  in every pixel; the phase's seconds; the kernels phase
                  also holds K1 at head dim 64 at every shape the phase
                  runs (``FAMILY_K1_CASES``, against SDPA-flash) and K4 at
                  SD-2.1's rows, and the tf32-kernels phase K1′ at
                  (2,4096,10,64);
   fp32-sampling — the CLIs' --no-bf16 path at full width:
                  ``resolve_params_cfg`` on parsed ``cli.inference``
                  arguments with --no-bf16 (random SD-1.5, fp32), then
                  ``generate`` with DDIM-10, CFG 7.5, 512² on 4 prompts,
                  warmed up and timed (s/call, peak memory) with exact
                  launches (15 3xTF32 fixed-cap and 10 3xTF32 FF launches
                  an evaluation, no CUDA-core one); then one fp32 VAE
                  decode under SDBC_ATTN_IMPL=inference and =flash (the
                  512-wide head on the wide 3xTF32 fixed cap and forward,
                  one launch each, with the decode's wall ms) against the
                  default fp32 decode;
9. train-parity — one optimizer step of the tiny config (grad_accum 2,
                  micro 2, 8-bit AdamW) bf16 on the card against fp32 on the
                  CPU with the same injected draws, all four training
                  kernels launched; then the same with grad_ckpt (block)
                  under SDBC_GN_FUSED=1 and SDBC_ATTN_IMPL=flash_tt; then
                  fp32 on the card (the flash forward and backward on the
                  3xTF32 kernels, the 8-bit AdamW's launch);
   train fp32   — mode C below in fp32 compute at full width (the finetune
                  CLI's --no-bf16, TF32 off): a warm-up step, 3 timed steps
                  with finite losses, moved parameters and exactly 60 / 60 /
                  60 3xTF32 forward / dq / dk-dv launches and one 8-bit
                  AdamW launch, none on the CUDA-core backward, and a
                  profiled step;
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
                  transposed-layout forward, none through the other;
13. finetune-tiny — ``cli.finetune.main`` at the tiny config on an
                  8-cover PNG dataset the phase writes, one optimizer step
                  each: a full fine-tune with EMA and 8-bit AdamW, LoRA,
                  textual inversion, prior preservation with
                  --prior_generate, cached latents; bf16 on the card
                  against fp32 on the CPU from one --ckpt and the same
                  host draws (the loss, the update of each trained tree
                  as train-parity holds them; exact launches a step where
                  the UNet trains); then a --resume on the card whose
                  first step sees the checkpoint's masters, moments, EMA
                  and step bit for bit;
14. finetune    — the CLI at full width, mode C (random SD-1.5 from seed
                  0, bf16, remat "block" by the CLI's default) on 16 PNG
                  covers at 512²: --epochs 1 (2 steps, a checkpoint), then
                  --resume --epochs 2 (2 more): exact 120 / 60 / 60 / 1
                  launches every step, finite losses, s/step beside the
                  train phases', the loader's blocked ms, peak memory,
                  checkpoint bytes and save / load seconds; it checks the
                  temp dir has room for two checkpoints first and removes
                  it after;
   jax-ckpt     — a checkpoint the JAX package's ``save_pipeline`` wrote
                  (``tests/data/jax_ckpt_tiny``: OCDBT, zstd chunks, one a
                  shard of an 8-device mesh; 8-bit AdamW, an EMA shadow)
                  copied into a run directory and read with the port's own
                  OCDBT reader and zstd decoder (built with g++ at first
                  use): ``load_pipeline(device="cuda")`` and ``load_ema``
                  against the JAX tree's digests (SHA-256, dtype, shape of
                  every leaf); ``cli.inference --ckpt`` DDIM-4 at 32² (a
                  finite image, K1/K4 as ``family_launches`` counts them,
                  the decode's one K5 as on the tiny paths);
                  ``cli.finetune --resume`` for one step (the step, the
                  8-bit codes and scales, the text encoder and the EMA
                  its first step sees equal to the digests, a finite loss,
                  the training kernels launched); the loader's read rate
                  on the host (``read_tree`` of the fixture's trees, MB/s
                  decoded, 50 rounds) and the load's seconds, with the
                  card's name and power limit;
15. families-train — training SD-2.x and SDXL: one optimizer step of
                  ``--tiny --model_family sd21``, tiny_xl, the tiny
                  refiner, and LoRA and textual inversion on tiny_xl, bf16
                  and fp32 on the card against fp32 on the CPU (as
                  train-parity holds them; the fp32 loss within
                  ``FP32_PARITY_TOL``) with exact launches; ``cli.finetune
                  --tiny --model_family sdxl`` on the card and its
                  bit-exact --resume; at full width (random weights from
                  seed 0, fp32 masters of the UNet and every text encoder,
                  bf16 compute, 8-bit AdamW, remat "block") SDXL base
                  1024² (micro-batch 1, grad_accum 2: 280 / 140 / 140 / 1
                  K5 / K6a / K6b / K7 a step) and SD-2.1 768² v-prediction
                  (micro 2, grad_accum 4: 120 / 60 / 60 / 1), each a
                  warm-up, 3 timed steps with finite losses and moved
                  parameters, peak memory and a profiled step; K7 over the
                  SDXL step's 8-bit leaves against its bound; then
                  ``cli.finetune --model_family sdxl`` at 1024² on 4 PNG
                  covers: 2 steps, the loader's blocked ms, its checkpoint's
                  bytes and save seconds;
16. controlnet  — ControlNet and the 9-channel inpainting UNet: tiny
                  sampling with two branches (an image and a scale each)
                  and with the inpainting UNet (the masked image's draw
                  injected), and one tiny ControlNet optimizer step (remat
                  "block"), bf16 and fp32 on the card against fp32 on the
                  CPU within ``PARITY_TOL`` / ``FP32_PARITY_TOL`` and the
                  train-parity bounds, exact launches; at full width
                  (random weights from seed 0, bf16, the branch a
                  ``from_unet`` copy off its zero convs) SD-1.5 + ControlNet
                  at 512², batch 4, DDIM-20, CFG 7.5 on one edge map
                  (median of 3 after a warm-up, peak memory, a profiled
                  call's idle share, 420 / 280 K1 / K4 a call), the base
                  call without the image (300 / 200), which the control
                  must change and a zero scale must give back bit for bit;
                  the inpainting UNet through ``SDPipeline.inpaint`` the same
                  way (300 / 200); the branch's training step in mode C's
                  shape (remat "block", 8-bit AdamW, the Sobel hint; 144 /
                  60 / 60 / 1 K5 / K6a / K6b / K7 a step, a profiled step);
                  its profiles record the device's activity alone;
17. parallel    — ``sdbc_tpu_torch.parallel`` (``phase_parallel``): (a)
                  NCCL with a world of 1 on a TCP store: mode C through
                  the data-parallel path (a 1×1 mesh) bit for bit against
                  the bare step on the same batch and draws, 60 / 60 /
                  60 / 1 K5 / K6a / K6b / K7 launches, nothing staged
                  through the host; (b) two ranks of this script
                  (``--parallel-rank``, each with its own timeout)
                  sharing the card over gloo: DP mode C (micro-batch
                  1 + 1) and FSDP (fp32 AdamW, grad_accum 1) against the
                  one-process steps (loss, the update of every trained
                  leaf at a stride against ``PAR_UPDATE_COS``, which a
                  control without the data-group mean must fail, the two
                  ranks' parameters bit for bit, each rank's moments and
                  peak against one process's), TP and DP sampling at
                  512², batch 4, CFG 7.5, DDIM-10 against the fp32 image
                  (``PAR_IMG_C`` × the one-process call's own bf16
                  rounding; K1 150 a rank, K4 0 under TP), and the tiny
                  config's TP and DP
                  calls in fp32 within ``FP32_PARITY_TOL`` of the rank's
                  one-process call; each step's s/step, each call's
                  s/call and each rank's peak GiB and host-staged
                  collectives.  A correctness run: two ranks on one card
                  show no speed-up.

Every phase's seconds are printed as it ends (``[time]``).  Every
environment variable a phase sets is restored after it.

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
# The same tiny runs in fp32 on the card (the 3xTF32 kernels, ~2^-21 of
# each product; the rest fp32) vs fp32 on the CPU: images in [0, 1] agree
# to a few 1e-6; 1e-4 catches a kernel or product that fell to bf16 or
# TF32 (~1e-3).
FP32_PARITY_TOL = 1e-4
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
# The 3xTF32 forward (csrc/flash_fwd_tf32_sm90.cu) is held to the same
# bound: its split products lose ~2^-21 of each score; its LSE to 1e-5
# (natural-log units: the logits' relative error times |s| ≲ 10).
SIMT_FP32_REL_TOL, SIMT_FP32_ABS_TOL = 1e-4, 1e-6
TF32_LSE_TOL = 1e-5
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
# The families' tiny steps in bf16 (tiny_xl's depth-2 transformers, the
# refiner): the q and k projections' gradients flow through dS = P∘(dP −
# rowsum(dO∘O)), a small difference at a near-uniform random-init softmax,
# and the flash backward's δ from the bf16-rounded O moves them by up to
# ~5.5% against fp32 (plain bf16 attention ~2-4%; v and o stay within
# 1%).  They are held to half of what one lost 64-key tile of 256 gives
# (25%); the fp32 runs hold every gradient to TRAIN_GRAD_RTOL.
FAMILY_GRAD_RTOL = 0.125
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
PEAK_TF32 = 495e12  # tf32 tensor FLOP/s


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


def cuda_trace(fn, calls: int, tries: int = 3, whole=None):
    """The CUDA kernel records, by start, of a ``torch.profiler`` trace
    (CUPTI's) of ``calls`` calls of ``fn`` after one warm call.  CUPTI can
    hand back a trace with no device record at all (seen once in a
    one-call trace on an H100), or one that lost some of a kernel's
    records (4 of 22 once): such a trace says nothing of what ran, so it is
    taken again, up to ``tries`` traces in all.  ``whole(events)`` says
    whether a trace holds every record the caller expects; the last trace
    is returned either way, so the caller's own check decides."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events and (whole is None or whole(events)):
            return events
    return events


def device_ms(fn, kernel, n: int = 20, warm: int = 2):
    """Card ms per call of ``fn`` spent in kernels whose name holds
    ``kernel``: their device time over the last ``n`` of ``warm + n`` calls
    in a ``torch.profiler`` trace (CUPTI's kernel records), over ``n``.  The
    ``warm`` calls inside the trace absorb the tracer's start, which can
    lose a record (one of 20 once); a trace with fewer than ``n`` such
    kernels lost records and is taken again (``cuda_trace``); fails unless
    the trace has between ``n`` and ``warm + n`` such kernels (so not two
    a call).  Given a tuple of names, a tuple of times from one trace."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    count = lambda events, name: sum(name in e.name for e in events)
    events = cuda_trace(fn, warm + n, whole=lambda events: all(
        n <= count(events, name) <= warm + n for name in names))
    out = []
    for name in names:
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


def _hw(lat):
    """(h, w) of a latent size given as one side (square) or (h, w)."""
    return (lat, lat) if isinstance(lat, int) else tuple(lat)


def transformer_launches(c: int, hw, rows_batch: int):
    """(flash, geglu) launches of one transformer block at ``c`` channels
    on an ``hw`` map (a side, or (h, w)) of batch ``rows_batch``: the
    fixed-cap flash call from 256 tokens, the fused FF where the GEGLU
    eligibility rule admits its rows."""
    from sdbc_tpu_torch.ops.geglu_ff import _MAX_C, _default_block

    h, w = _hw(hw)
    tokens = h * w
    rows = rows_batch * tokens
    return (int(tokens >= 256),
            int(c <= _MAX_C and rows % min(_default_block(c), rows) == 0))


def transformer_sites(cfg, lat):
    """Every spatial transformer of one UNet evaluation as (channels,
    (h, w) of its level, heads, depth): ``layers_per_block`` down and
    ``layers_per_block`` + 1 up at each level with cross-attention, and
    the mid one at the deepest level with that level's heads and depth
    (as the UNet builds it).  ``lat``: the latent side, or (lat_h,
    lat_w); a stride-2 3×3 conv with padding 1 halves a side rounding
    up."""
    u = cfg.unet
    heads, depths = u.heads_per_level, u.depth_per_level
    sizes, (h, w) = [], _hw(lat)
    for _ in u.block_out_channels:
        sizes.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    sites = []
    for n in (u.layers_per_block, u.layers_per_block + 1):
        for i, c in enumerate(u.block_out_channels):
            if u.cross_attn_blocks[i]:
                sites += [(c, sizes[i], heads[i], depths[i])] * n
    last = len(u.block_out_channels) - 1
    sites.append((u.block_out_channels[-1], sizes[last], heads[last],
                  depths[last]))
    return sites


def expected_launches(cfg, lat, rows_batch: int):
    """(flash, geglu) launches per UNet evaluation: one flash call per
    spatial self-attention with ≥ 256 tokens, one fused FF per transformer
    block the GEGLU eligibility rule admits; each transformer runs
    ``depth`` blocks (``transformer_sites``).  ``lat``: the latent side,
    or (lat_h, lat_w)."""
    flash = geglu = 0
    for c, hw, _, depth in transformer_sites(cfg, lat):
        f, g = transformer_launches(c, hw, rows_batch)
        flash += depth * f
        geglu += depth * g
    return flash, geglu


def shallow_launches(cfg, lat, rows_batch: int, cache_tail: int = 0):
    """(flash, geglu) launches of a DeepCache reuse evaluation: the shallow
    head (conv_in and the first ct−1 ResBlocks of down[0]) and the fresh
    tail (the last ct ResBlocks of up[-1]), each ResBlock with its level-0
    transformer of that level's depth; ct = cache_tail, 0 meaning all of
    up[-1]'s (``unet.apply``)."""
    u = cfg.unet
    total = u.layers_per_block + 1
    ct = cache_tail if 0 < cache_tail <= total else total
    n = (2 * ct - 1) * u.cross_attn_blocks[0] * u.depth_per_level[0]
    f, g = transformer_launches(u.block_out_channels[0], lat, rows_batch)
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


def sampler_launches(cfg, lat_hw, b: int, evals,
                     cache_tail: int = 0) -> dict:
    """Kernel launches of the UNet evaluations ``evals``
    (``sampler_evals``) at batch ``b`` images on a latent of side (or
    (h, w)) ``lat_hw``: K1 (``flash_fixed``) and K4 (``geglu_ff``) per
    evaluation, every other count 0."""
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


def family_launches(cfg, lat, b: int, steps: int, scheduler: str = "ddim",
                    cfg_interval=None, cache_interval: int = 0,
                    cache_tail: int = 0, refiner=None,
                    handoff: float = 0.8) -> dict:
    """K1/K4 launches of one ``SDPipeline`` call of ``b`` images (a batch
    bucket) at latent ``lat`` (side or (h, w)) for any family, or with
    ``refiner`` (its config) of the ``EnsemblePipeline``: the base runs
    the evaluations up to round(steps·handoff), the refiner the rest
    (``sampler_evals``' t_end / t_start)."""
    if refiner is None:
        return sampler_launches(cfg, lat, b, sampler_evals(
            scheduler, steps, cfg_interval=cfg_interval,
            cache_interval=cache_interval), cache_tail)
    cut = int(round(steps * handoff))
    first = sampler_launches(cfg, lat, b,
                             sampler_evals(scheduler, steps, t_end=cut))
    second = sampler_launches(refiner, lat, b,
                              sampler_evals(scheduler, steps, t_start=cut))
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
    (as recorded) run twice; "block" recomputes every attention,
    "selective" that of the depth > 1 transformers (each block
    checkpointed whole)."""
    from sdbc_tpu_torch.models.vae import prefer_chunked_encode
    from sdbc_tpu_torch.ops import _kernels

    if tcfg.train_controlnet:
        return controlnet_train_launches(cfg, tcfg, img_hw, n8)
    lat = img_hw // cfg.vae_scale
    micro, accum = tcfg.micro_batch, tcfg.grad_accum
    encodes = micro if prefer_chunked_encode(micro, img_hw, img_hw) else 1
    remat = tcfg.remat_mode if tcfg.grad_ckpt else None
    attn_again = 2 if remat == "block" else 1
    want = dict.fromkeys(_kernels.launches, 0)
    # the forwards a "selective" backward recomputes: the deep blocks'
    deep = sum(depth * transformer_launches(c, hw, micro)[0]
               for c, hw, _, depth in transformer_sites(cfg, lat)
               if depth > 1) if remat == "selective" else 0
    want["adam8"] = int(n8 > 0)  # one launch over every 8-bit leaf
    if switches:
        calls = 2 * n_transformers(cfg.unet)
        want["flash_tt"] = accum * (attn_again * calls + encodes)
        want["gn_fused"] = accum * (
            gn_launches(cfg, lat, remat)
            + encodes * vae_gn_launches(cfg, img_hw, "encode"))
    else:
        calls, _ = expected_launches(cfg, lat, micro)
        # the VAE's single-head mid attention meets the flash rule only
        # where its head is ≤ 256 wide (the tiny VAE, not SD-1.5's)
        low = img_hw >> (len(cfg.vae.block_out_channels) - 1)
        vae = encodes * (low * low >= 256 and cfg.vae.block_out_channels[-1]
                         <= 256)
        want["flash_fwd"] = accum * (attn_again * calls + deep + vae)
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = accum * calls
    return want


def unet_site_groups(cfg, lat):
    """``transformer_sites`` split into the down path's, the up path's and
    the mid block's (a ControlNet branch runs the first and the last)."""
    u = cfg.unet
    sites = transformer_sites(cfg, lat)
    n_down = sum(u.cross_attn_blocks) * u.layers_per_block
    n_up = sum(u.cross_attn_blocks) * (u.layers_per_block + 1)
    return sites[:n_down], sites[n_down:n_down + n_up], sites[-1:]


def site_launches(sites, rows_batch: int):
    """(flash, geglu) launches of ``sites`` (``transformer_sites``' tuples)
    at batch ``rows_batch``, each transformer ``depth`` blocks."""
    flash = geglu = 0
    for c, hw, _, depth in sites:
        f, g = transformer_launches(c, hw, rows_batch)
        flash += depth * f
        geglu += depth * g
    return flash, geglu


def controlnet_sampling_launches(cfg, lat, b: int, steps: int,
                                 branches: int = 1) -> dict:
    """K1/K4 launches of a DDIM call of ``b`` images with ``branches``
    ControlNet branches: each evaluation runs the base UNet and, on the
    same CFG batch, each branch's down path and mid block."""
    from sdbc_tpu_torch.ops import _kernels

    down, up, mid = unet_site_groups(cfg, lat)
    base = site_launches(down + up + mid, 2 * b)
    branch = site_launches(down + mid, 2 * b)
    want = dict.fromkeys(_kernels.launches, 0)
    want["flash_fixed"] = steps * (base[0] + branches * branch[0])
    want["geglu_ff"] = steps * (base[1] + branches * branch[1])
    return want


def controlnet_train_launches(cfg, tcfg, img_hw: int, n8: int) -> dict:
    """Kernel launches of one ControlNet optimizer step (the base frozen):
    per micro-batch the flash forward of every attention of the base and
    the branch (and of the VAE encode's where its rule admits it); a
    backward (dq, dk/dv) only where the inputs need a gradient — the
    branch's and the base's up path, whose skips and mid output carry the
    residuals; none in the base's down path or mid block; under "block"
    remat those forwards once more in the backward.  One 8-bit AdamW
    launch a step."""
    from sdbc_tpu_torch.models.vae import prefer_chunked_encode
    from sdbc_tpu_torch.ops import _kernels

    lat = img_hw // cfg.vae_scale
    micro, accum = tcfg.micro_batch, tcfg.grad_accum
    down, up, mid = unet_site_groups(cfg, lat)
    fwd = site_launches(down + up + mid, micro)[0] \
        + site_launches(down + mid, micro)[0]
    grad = site_launches(up, micro)[0] + site_launches(down + mid, micro)[0]
    again = grad if tcfg.grad_ckpt and tcfg.remat_mode == "block" else 0
    encodes = micro if prefer_chunked_encode(micro, img_hw, img_hw) else 1
    low = img_hw >> (len(cfg.vae.block_out_channels) - 1)
    vae = encodes * (low * low >= 256
                     and cfg.vae.block_out_channels[-1] <= 256)
    want = dict.fromkeys(_kernels.launches, 0)
    want["flash_fwd"] = accum * (fwd + again + vae)
    want["flash_bwd_dq"] = want["flash_bwd_dkv"] = accum * grad
    want["adam8"] = int(n8 > 0)
    return want


# K1 at the hires shape is held to its plain version on every 16th query
HIRES_Q_STRIDE = 16
# K1 at the SD-2.x / SDXL head dim 64 (CFG batch 2 of one image), every
# shape the families phase runs it at: SDXL 1024²'s 64² and 32² levels,
# SD-2.1 768²'s 96², 48² and 24² levels, the 832×1216 portrait's ragged
# 52×76 and 26×38 levels (no multiple of the key or query tile: the
# zero-filled last tile), the refiner's 12- and 24-head 64² and 32² levels
# and its 16² mid block
FAMILY_K1_CASES = [("bshd SDXL 64^2 d64", "bshd", (2, 4096, 10, 64), 4096),
                   ("bshd SDXL 32^2 d64", "bshd", (2, 1024, 20, 64), 1024),
                   ("bshd SD-2.1 96^2 d64", "bshd", (2, 9216, 5, 64), 9216),
                   ("bshd SD-2.1 48^2 d64", "bshd", (2, 2304, 10, 64), 2304),
                   ("bshd SD-2.1 24^2 d64", "bshd", (2, 576, 20, 64), 576),
                   ("bshd SDXL portrait 52x76 d64", "bshd",
                    (2, 3952, 10, 64), 3952),
                   ("bshd SDXL portrait 26x38 d64", "bshd",
                    (2, 988, 20, 64), 988),
                   ("bshd refiner 64^2 d64", "bshd", (2, 4096, 12, 64), 4096),
                   ("bshd refiner 32^2 d64", "bshd", (2, 1024, 24, 64), 1024),
                   ("bshd refiner 16^2 mid d64", "bshd", (2, 256, 24, 64),
                    256)]

SWITCHES = {"SDBC_GN_FUSED": "1", "SDBC_ATTN_IMPL": "flash_tt"}
# the path whose run gives each kernel's ``launches`` in the kernels line:
# the sampling kernels' slice, the training kernels' step, the switches'
# train step for the fused GroupNorm and the transposed-layout forward,
# this slice's gradient-checkpointed step for the int8-QK attention, which
# no path of either package dispatches, the CLI's --no-bf16 sampling call
# for the fp32 fixed cap and FF, the full-width fp32 train step for the
# fp32 training forward and backward, and the fp32 VAE decodes under
# SDBC_ATTN_IMPL for the CUDA-core forwards (the CUDA-core kernels launch
# 0 on their paths: every fp32 call of SD-1.5 takes a 3xTF32 kernel; a row
# of the wide 3xTF32 forward names its decode path itself) (each row also
# lists every path)
MAIN_PATH = {"flash_fixed": "sampling", "geglu_ff": "sampling",
             "flash_fwd": "train", "flash_bwd_dq": "train",
             "flash_bwd_dkv": "train", "adam8": "train",
             "gn_fused": "train switches", "flash_tt": "train switches",
             "flash_fixed_int8": "train grad_ckpt block",
             "flash_fixed_tf32": "sampling fp32",
             "geglu_ff_simt": "sampling fp32",
             "flash_fwd_tf32": "train fp32",
             "flash_fixed_simt": "decode fp32 SDBC_ATTN_IMPL=inference",
             "flash_fwd_simt": "decode fp32 SDBC_ATTN_IMPL=flash",
             "flash_bwd_simt_dq": "train fp32",
             "flash_bwd_simt_dkv": "train fp32",
             "flash_bwd_dq_tf32": "train fp32",
             "flash_bwd_dkv_tf32": "train fp32",
             "geglu_ff_tf32": "sampling fp32"}
# in fp32 every attention and FF call the bf16 tensor-core kernels would
# take goes to the 3xTF32 kernel of the same function: the forwards (every
# head dim of the tiny and SD-1.5 configs a multiple of 8 up to 512), the
# backward (up to 160) and the FF (every width of both configs a multiple
# of 32)
FP32_OF = {"flash_fixed": "flash_fixed_tf32", "geglu_ff": "geglu_ff_tf32",
           "flash_fwd": "flash_fwd_tf32", "flash_bwd_dq": "flash_bwd_dq_tf32",
           "flash_bwd_dkv": "flash_bwd_dkv_tf32"}


def fp32_launches(want: dict) -> dict:
    """The launch counts of the same run in fp32: each count moved from a
    bf16 tensor-core kernel to its fp32 counterpart (``FP32_OF``)."""
    out = dict.fromkeys(want, 0)
    for name, n in want.items():
        out[FP32_OF.get(name, name)] += n
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
    import importlib.util

    # what the machine offers beside torch: PIL decodes input images,
    # pandas reads and writes the preprocessing CSVs, matplotlib draws the
    # titled grids (without it ``eval.visualize.save_grid`` tiles a PNG)
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("PIL", "pandas", "matplotlib", "regex")}
    print(f"[device] importable: {have}", flush=True)
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
            "int8": int8_build(lines, sass), "tf32": tf32_build(lines, sass)}


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


# the 3xTF32 kernels' instantiations, by family: (mangled-name pattern,
# template arguments → readable name, count).  The forward
# flash_tf32_sm90_kernel<NV, FIXED>: NV output columns (40, 64, 80, 128,
# 160, 192, 256), both variants; the wide forward
# flash_tf32_wide_sm90_kernel<FIXED> (head dims 264-512); the backward
# flash_bwd_{dq,dkv}_tf32_sm90_kernel<NV>, NV 40, 80 and 160; the fused FF
# geglu_ff_tf32_sm90_kernel<CL>, clusters of one and two CTAs
TF32_FAMILIES = {
    "forward": (r"flash_tf32_sm90_kernelILi(\d+)ELb([01])E",
                lambda m: f"flash_tf32_sm90_kernel<{m.group(1)}, "
                          f"{'true' if m.group(2) == '1' else 'false'}>", 14),
    "wide forward": (r"flash_tf32_wide_sm90_kernelILb([01])E",
                     lambda m: f"flash_tf32_wide_sm90_kernel<"
                               f"{'true' if m.group(1) == '1' else 'false'}>",
                     2),
    "backward": (r"flash_bwd_(dq|dkv)_tf32_sm90_kernelILi(\d+)E",
                 lambda m: f"flash_bwd_{m.group(1)}_tf32_sm90_kernel<"
                           f"{m.group(2)}>", 6),
    "FF": (r"geglu_ff_tf32_sm90_kernelILi(\d+)E",
           lambda m: f"geglu_ff_tf32_sm90_kernel<{m.group(1)}>", 2),
}
TF32_PREPASSES = ("split_kv_kernel", "split_bwd_kernel", "split_ff_kernel")


def tf32_build(lines, sass):
    """The 3xTF32 kernels' build report: ptxas's registers and spills of
    each instantiation of ``TF32_FAMILIES`` (the forward, the wide forward,
    the backward, the fused FF) and of their pre-passes
    (``TF32_PREPASSES``); in each instantiation's SASS the tf32 wgmma
    products (HGMMA), TMA loads and any mma.sync (HMMA), failing unless
    every family has all its instantiations, each with HGMMA and UTMALDG
    and no HMMA."""
    import re

    def match(text, at_start=False):
        for family, (pat, name, _) in TF32_FAMILIES.items():
            m = (re.match(r"\S*?" + pat, text) if at_start
                 else re.search(pat, text))
            if m:
                return family, name(m)
        return None

    ptxas, cur = {}, None
    for ln in lines:
        if "Compiling entry function" in ln or "Function properties for" in ln:
            m = match(ln)
            cur = m[1] if m else next(
                (k for k in TF32_PREPASSES if k in ln), None)
        elif cur and ("registers" in ln or "spill" in ln):
            ptxas.setdefault(cur, []).append(ln.split(":", 1)[-1].strip())
    ptxas = {k: "; ".join(v) for k, v in ptxas.items()}
    counts, families = {}, {}
    for part in (sass or "").split("Function : ")[1:]:
        m = match(part, at_start=True)
        if m:
            families[m[1]] = m[0]
            counts[m[1]] = {op: len(re.findall(rf"\b{op}\b", part))
                            for op in ("HGMMA", "UTMALDG", "HMMA")}
    print(f"[build] 3xTF32 kernels ptxas: {ptxas}", flush=True)
    print(f"[build] 3xTF32 kernels SASS (HGMMA, UTMALDG, HMMA): "
          f"{counts or 'not checked'}", flush=True)
    if sass is not None:
        for family, (_, _, want) in TF32_FAMILIES.items():
            n = sum(f == family for f in families.values())
            if n != want:
                fail(f"3xTF32 kernels: {n} of {want} {family} "
                     f"instantiations in the built SASS")
        for kname, n in counts.items():
            if not (n["HGMMA"] and n["UTMALDG"]) or n["HMMA"]:
                fail(f"{kname}: SASS counts {n}")
    return {"ptxas": ptxas, "sass": counts}


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
    # projection layout at batch 8, 4 and 2, one head-major call, one ragged
    # call
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    flash_cases = [("bshd 64^2 d40", "bshd", (8, 4096, 8, 40), 4096),
                   ("bshd 32^2 d80", "bshd", (8, 1024, 8, 80), 1024),
                   ("bshd 16^2 d160", "bshd", (8, 256, 8, 160), 256),
                   # batch 4: cfg_interval's cond-only evaluations
                   ("bshd 64^2 d40 batch 4", "bshd", (4, 4096, 8, 40), 4096),
                   ("bshd 32^2 d80 batch 4", "bshd", (4, 1024, 8, 80), 1024),
                   ("bshd 16^2 d160 batch 4", "bshd", (4, 256, 8, 160), 256),
                   # batch 2: one image with CFG (the export phase's
                   # DDIM-10 and the summarize grids' last call of one
                   # template)
                   ("bshd 64^2 d40 batch 2", "bshd", (2, 4096, 8, 40), 4096),
                   ("bshd 32^2 d80 batch 2", "bshd", (2, 1024, 8, 80), 1024),
                   ("bshd 16^2 d160 batch 2", "bshd", (2, 256, 8, 160), 256),
                   ("bhsd 32^2 d80", "bhsd", (8, 8, 1024, 80), 1024),
                   ("bshd ragged Sq200 Sk300 d40", "bshd", (2, 200, 8, 40),
                    300),
                   # hires-fix's second stage: 1024², 128² latents, CFG
                   # batch 2; the plain version on every HIRES_Q_STRIDE-th
                   # query (its full fp32 scores would take 17 GB)
                   ("bshd 128^2 d40 hires batch 2", "bshd",
                    (2, 16384, 8, 40), 16384)] + FAMILY_K1_CASES
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa_flash(q, k, v):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return sdpa(q, k, v)

    flash_err, first, d64 = 0.0, None, []
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
        family = "d64" in label  # SD-2.x / SDXL: against SDPA's flash
        lib = (lambda: sdpa_flash(qh, kh, vh)) if family \
            else (lambda: sdpa(qh, kh, vh))
        ms, lms = paired_ms([kern, lib])
        b, h, sq, d = qh.shape
        bms, by = attn_bound(b, h, sq, sk, d, 2, (sq, sk, sk), (sq,))
        part = f" (on 1/{qs} of the queries)" if qs > 1 else ""
        sdpa_name = "sdpa-flash" if family else "sdpa"
        print(f"[kernels] flash_fixed {label}: max_abs_err {err:.3e}{part} "
              f"(tol {tol:.3e}) kernel {ms:.4f} ms plain{part} {pms:.4f} ms "
              f"{sdpa_name} {lms:.4f} ms bound {bms:.4f} ms ({by})",
              flush=True)
        print(f"[kernels] flash_fixed {label}: kernel {ms:.4f} ms, "
              f"{sdpa_name} {lms:.4f} ms (kernel/sdpa {ms / lms:.2f}), bound "
              f"{bms:.4f} ms, {100 * bms / ms:.1f}% of the bound", flush=True)
        if family:
            d64.append(dict(shape=label, max_abs_err=err, tol=tol, ms=ms,
                            plain_ms=pms, sdpa_flash_ms=lms, bound_ms=bms,
                            bound_by=by, bound_share=bms / ms))
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
                 "d64": d64, "d512": kernel_flash_fixed_wide(g)})

    geglu_err, first, shapes = 0.0, None, []
    # batch 8 (CFG), then batch 4 (cfg_interval's cond-only evaluations),
    # then SD-2.1 768²'s 96² and 48² levels at CFG batch 2 (SDXL 1024²'s
    # is (8192, 640)), then SD-1.5's at batch 2 (one image with CFG)
    for rows_n, c in ((32768, 320), (8192, 640), (16384, 320), (4096, 640),
                      (18432, 320), (4608, 640), (8192, 320), (2048, 640)):
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


def kernels_per_call(fn, n: int = 5, warm: int = 2):
    """The names of the CUDA kernels one call of ``fn`` runs, in order:
    those of the last call in a profiler trace of ``warm + n`` calls, where
    every kernel of the trace ran between ``n`` and ``warm + n`` times (the
    ``warm`` calls absorb a record lost at the tracer's start); otherwise
    every name of the trace, so that the caller's check shows them."""
    def whole(events):
        names = [e.name for e in events]
        return all(n <= names.count(k) <= warm + n for k in set(names))

    names = [e.name for e in cuda_trace(fn, warm + n, whole=whole)]
    kinds = set(names)
    if all(n <= names.count(k) <= warm + n for k in kinds):
        return names[len(names) - len(kinds):]
    return names


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


# the families' training at head dim 64 (label, b, h, sq, sk, d): SDXL
# 1024² at micro-batch 1 (the 64² and 32² levels), SD-2.1 768² at
# micro-batch 2 (96², 48², 24²; the 12² mid block stays plain)
FAMILY_TRAIN_CASES = [("SDXL 64^2 d64", 1, 10, 4096, 4096, 64),
                      ("SDXL 32^2 d64", 1, 20, 1024, 1024, 64),
                      ("SD-2.1 96^2 d64", 2, 5, 9216, 9216, 64),
                      ("SD-2.1 48^2 d64", 2, 10, 2304, 2304, 64),
                      ("SD-2.1 24^2 d64", 2, 20, 576, 576, 64)]


def phase_train_kernels(adam8_sass_counts=None):
    """The training kernels against their plain versions, at the shapes of
    the mode-C step (micro-batch 2, 8 heads; q/k/v as the (B, H, S, D)
    head-split views of the projection layout the UNet hands over) and of
    the families' steps (``FAMILY_TRAIN_CASES``); each row keeps every
    case."""
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
             ("ragged Sq200 Sk300 d40", 2, 8, 200, 300, 40)] \
        + FAMILY_TRAIN_CASES
    res = {n: {"err": 0.0, "first": None, "cases": []}
           for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    label = None

    def record(name, err, **kw):
        res[name]["err"] = max(res[name]["err"], err)
        if res[name]["first"] is None:
            res[name]["first"] = kw
        res[name]["cases"].append(dict(shape=label, max_abs_err=err, **kw))

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
                     **res[name]["first"], "cases": res[name]["cases"]})
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
# the fp32 VAE decode's mid-block head (one 64² latent, 512 wide) under
# SDBC_ATTN_IMPL=inference / flash, the CUDA-core forwards' path before the
# wide 3xTF32 forward took it
SIMT_VAE = (1, 1, 4096, 512)


def phase_simt_kernels():
    """The CUDA-core kernels (``csrc/flash_simt.cu``,
    ``csrc/geglu_ff_simt.cu``), each through its wrapper against its plain
    version (``simt_err``), one launch a call, timed against the PyTorch
    call of the same function where there is one (SDPA's default dispatch,
    its backend named; its backward through autograd for the two backward
    kernels) in alternating rounds.  The forwards and the backward through
    ``flash_simt``'s wrappers: the entry points send fp32 at these head
    dims to the 3xTF32 kernels (``phase_tf32_kernels``).  The forwards
    also at their main path's shape, the fp32 VAE decode's 512-wide head
    (``SIMT_VAE``), the row's numbers; the 40-wide case beside them.
    Returns their rows of the kernels line."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb
    from sdbc_tpu_torch.ops import flash_simt
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
    o = torch.empty(q.shape, device="cuda")
    kern = lambda: flash_simt.fixed_cap(q, k, v, o, d ** -0.5)
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
    narrow = dict(shape=f"fp32 {SIMT_FIXED}", max_abs_err=err, ms=ms,
                  plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=lms)
    print(f"[simt-kernels] flash_fixed_simt fp32 {SIMT_FIXED}: max_abs_err "
          f"{err:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms, sdpa "
          f"({sdpa_backend(q, k, v)}) {lms:.4f} ms (kernel/library "
          f"{ms / lms:.2f}), bound {bms:.4f} ms ({by}), "
          f"{100 * bms / ms:.2f}% of it", flush=True)
    del q, k, v, o

    # the forwards at the VAE's 512-wide head, head-major
    b, h, s, d = SIMT_VAE
    n_sc = float(b * h * s * s)
    q, k, v = (randn(b, h, s, d) for _ in range(3))
    o = torch.empty(q.shape, device="cuda")
    kern = lambda: flash_simt.fixed_cap(q, k, v, o, d ** -0.5)
    _kernels.reset_launch_counts()
    err = check("flash_fixed_simt", kern(), fa.fixed_cap_attention_ref(
        q, k, v))
    pms = median_ms(lambda: fa.fixed_cap_attention_ref(q, k, v), 3)
    ms, lms = paired_ms([kern, lambda: sdpa(q, k, v)])
    bms, by = bound(fp32_bytes(3, 1, 0.0), exps=n_sc,
                    fp32_ops=4.0 * n_sc * d)
    add("flash_fixed_simt", "sdbc_tpu_torch/csrc/flash_simt.cu",
        "sdbc_tpu/ops/flash_attention.py:348", f"fp32 {SIMT_VAE}", err,
        ms, pms, bms, by, lms, f"sdpa ({sdpa_backend(q, k, v)})",
        cases=[narrow])
    scale = d ** -0.5
    _kernels.reset_launch_counts()
    out, lse = flash_simt.fwd(q, k, v, scale)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, scale)
    err = check("flash_fwd_simt", out, ref)
    lerr = (lse - ref_lse).abs().max().item()
    if not lerr <= LSE_TOL:
        fail(f"flash_fwd_simt {SIMT_VAE}: lse err {lerr} (tol {LSE_TOL})")
    pms = median_ms(lambda: fa.flash_attention_ref(q, k, v, scale), 3)
    ms, lms = paired_ms([lambda: flash_simt.fwd(q, k, v, scale),
                         lambda: sdpa(q, k, v, scale=scale)])
    bms, by = bound(fp32_bytes(3, 1, 4.0 * b * h * s), exps=n_sc,
                    fp32_ops=4.0 * n_sc * d)
    vae_fwd = dict(err=max(err, lerr), ms=ms, pms=pms, bms=bms, by=by,
                   lms=lms, lib=f"sdpa ({sdpa_backend(q, k, v)})")
    del q, k, v, o, out, lse, ref, ref_lse

    # the training forward and backward in fp32
    b, h, s, d = SIMT_TRAIN
    scale = d ** -0.5
    q, k, v, do = (randn(b, s, h, d).transpose(1, 2) for _ in range(4))
    _kernels.reset_launch_counts()
    out, lse = flash_simt.fwd(q, k, v, scale)
    ref, ref_lse = fa.flash_attention_ref(q, k, v, scale)
    err = check("flash_fwd_simt", out, ref)
    lerr = (lse - ref_lse).abs().max().item()
    if not lerr <= LSE_TOL:
        fail(f"flash_fwd_simt: lse err {lerr} (tol {LSE_TOL})")
    pms = median_ms(lambda: fa.flash_attention_ref(q, k, v, scale), 5)
    ms, lms = paired_ms([lambda: flash_simt.fwd(q, k, v, scale),
                         lambda: sdpa(q, k, v, scale=scale)])
    n_sc = float(b * h * s * s)
    bms, by = bound(fp32_bytes(3, 1, 4.0 * b * h * s), exps=n_sc,
                    fp32_ops=4.0 * n_sc * d)
    narrow = dict(shape=f"fp32 {SIMT_TRAIN}", max_abs_err=max(err, lerr),
                  ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                  library_ms=lms)
    print(f"[simt-kernels] flash_fwd_simt fp32 {SIMT_TRAIN}: max_abs_err "
          f"{max(err, lerr):.3e}; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
          f"SDPA {lms:.4f} ms (kernel/library {ms / lms:.2f}), bound "
          f"{bms:.4f} ms ({by}), {100 * bms / ms:.2f}% of it", flush=True)
    add("flash_fwd_simt", "sdbc_tpu_torch/csrc/flash_simt.cu",
        "sdbc_tpu/ops/flash_attention.py:81", f"fp32 {SIMT_VAE}",
        vae_fwd["err"], vae_fwd["ms"], vae_fwd["pms"], vae_fwd["bms"],
        vae_fwd["by"], vae_fwd["lms"], vae_fwd["lib"], cases=[narrow])
    del out, lse
    qs, kl, lse2, delta = fb.prepare(q, k, ref, do, ref_lse, scale)
    _kernels.reset_launch_counts()
    grads = flash_simt.bwd(qs, kl, v, do, lse2, delta, scale)
    refs = fb.flash_bwd_ref(q, k, v, ref, do, ref_lse, scale)
    errs = [check(n, gr, rf) for n, gr, rf in zip(
        ("flash_bwd_simt_dq", "flash_bwd_simt_dkv", "flash_bwd_simt_dkv"),
        grads, refs)]
    del grads, refs
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
    out = torch.empty_like(args[0])
    gf._check_cuda_inputs(*args, kernel="geglu_ff_simt")

    def kern():
        _kernels.geglu_ff_simt(*args, out, 1e-5)
        return out
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


# the 3xTF32 forward's cases: the fixed cap at sampling batch 8 in the
# projection layout (b, s, h, d) and the training forward at the mode-C
# step's micro-batch 2 (b, h, s, d), each at SD-1.5's 64², 32² and 16²
# levels, then a ragged pair (b, h, sq, sk, d), head-major
TF32_FIXED = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160),
              # SDXL 1024²'s 64² level at head dim 64 (batch 2)
              (2, 4096, 10, 64)]
TF32_TRAIN = [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160),
              # SDXL 1024²'s 64² level in training (micro-batch 1, head
              # dim 64)
              (1, 10, 4096, 64)]
TF32_RAGGED = (2, 8, 200, 300, 40)
# the wide 3xTF32 forward (csrc/flash_fwd_tf32_wide_sm90.cu): the fp32 VAE
# decode's 512-wide mid-block head (b, h, sq, sk, d), head-major, and a
# ragged pair at the narrowest head it takes
TF32_WIDE = [(1, 1, 4096, 4096, 512), (1, 2, 200, 300, 264)]
# the 3xTF32 FF (csrc/geglu_ff_tf32_sm90.cu): the sampling rows at SD-1.5's
# 64² and 32² levels, batch 8 (rows, c)
TF32_GEGLU = [(32768, 320), (8192, 640)]


def tf32_bounds(b, h, sq, sk, d, extra_bytes=0.0):
    """((ms, by) of the 3xTF32 bound, (ms, by) of the FFMA bound) of one
    fp32 attention forward: fp32 q, k, v read and o written once (plus
    ``extra_bytes``); three tf32 products of 4·D FLOPs a score at 495
    TFLOP/s, or 4·D fp32 FLOPs at 67 TFLOP/s (``bound``), one exp2 a
    score either way."""
    n_sc = float(b * h * sq * sk)
    nbytes = 4.0 * b * h * d * (2 * sq + 2 * sk) + extra_bytes
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = max(12.0 * n_sc * d / PEAK_TF32, n_sc / PEAK_EX2)
    tf32 = (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")
    return tf32, bound(nbytes, exps=n_sc, fp32_ops=4.0 * n_sc * d)


def tf32_bwd_bounds(b, h, sq, sk, d, dkv: bool):
    """((ms, by) of the 3xTF32 bound, (ms, by) of the FFMA bound) of one
    fp32 backward kernel: q, k, v, dO read once with lse2 and delta, dq
    (or dk and dv) written once; three tf32 products of 6·D (dk/dv: 8·D)
    FLOPs a score at 495 TFLOP/s, or 6·D (8·D) fp32 FLOPs at 67 TFLOP/s,
    one exp2 a score either way."""
    n_sc = float(b * h * sq * sk)
    flops = (8.0 if dkv else 6.0) * n_sc * d
    nbytes = 4.0 * b * h * (d * (2 * sq + 2 * sk) + 2 * sq
                            + d * (2 * sk if dkv else sq))
    t_bytes = nbytes / PEAK_HBM_BYTES
    t_ops = max(3.0 * flops / PEAK_TF32, n_sc / PEAK_EX2)
    tf32 = (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")
    return tf32, bound(nbytes, exps=n_sc, fp32_ops=flops)


def tf32_bwd_case(dims, randn, held, cases, smi: str):
    """The 3xTF32 backward at one (b, h, sq, sk, d) through ``flash_bwd``:
    each kernel's gradients against ``flash_bwd_prepared_ref`` on
    ``prepare``'s inputs (``simt_err``), one launch of each, the same bits
    from a second call; each kernel alone (the dq entry with its split
    pre-pass, the dk/dv entry on the scratch it filled) against its 3xTF32
    and FFMA bounds, and the whole call against SDPA's fp32 backward
    (EFFICIENT_ATTENTION) and the CUDA-core kernels of the same call, all
    in alternating rounds.  Appends each kernel's case to ``cases``."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import _kernels, flash_simt
    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb
    from sdbc_tpu_torch.ops import flash_bwd_tf32 as fbt

    b, h, sq, sk, d = dims
    scale = d ** -0.5
    if sq == sk:  # the UNet's layout: head-major views of (B, S, H, D)
        q, k, v, do = (randn(b, sq, h, d).transpose(1, 2) for _ in range(4))
        label = f"({b},{h},{sq},{d})"
    else:
        q, do = randn(b, h, sq, d), randn(b, h, sq, d)
        k, v = randn(b, h, sk, d), randn(b, h, sk, d)
        label = f"Sq {sq} Sk {sk} ({b},{h},·,{d})"
    o, lse = fa.flash_attention_ref(q, k, v, scale)
    _kernels.reset_launch_counts()
    grads = fb.flash_bwd(q, k, v, o, do, lse, scale)
    counts = {n: c for n, c in _kernels.launches.items() if c}
    qs, kl, lse2, delta = fb.prepare(q, k, o, do, lse, scale)
    refs = fb.flash_bwd_prepared_ref(qs, kl, v, do, lse2, delta, scale)
    want = {"flash_bwd_dq_tf32": 1, "flash_bwd_dkv_tf32": 1}
    errs = [held(f"fp32 backward {label} {n}", gr, rf, counts, want)
            for n, gr, rf in zip("dq dk dv".split(), grads, refs)]
    again = fb.flash_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        fail(f"fp32 backward {label}: two calls gave different bits")
    del again
    scratch = torch.empty(fbt.scratch_floats(b, h, sq, sk, d),
                          device="cuda")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_fn = lambda: _kernels.flash_bwd_dq_tf32(
        q, k, v, do, lse2, delta, dq, scratch, scale, scale / fb.LOG2E)
    dkv_fn = lambda: _kernels.flash_bwd_dkv_tf32(q, k, lse2, delta, dk, dv,
                                                 scratch)
    dq_fn()
    call = lambda: fb.flash_bwd(q, k, v, o, do, lse, scale)
    ql, kl_, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lo = sdpa(ql, kl_, vl, scale=scale)
    sdpa_bwd = lambda: torch.autograd.grad(lo, (ql, kl_, vl), do,
                                           retain_graph=True)
    sdpa_err = max((x - r).abs().max().item() for x, r in zip(
        sdpa_bwd(), fb.flash_bwd_ref(q, k, v, o, do, lse, scale)))
    simt_fn = lambda: flash_simt.bwd(qs, kl, v, do, lse2, delta, scale)
    pms = median_ms(lambda: fb.flash_bwd_prepared_ref(qs, kl, v, do, lse2,
                                                      delta, scale), 3)
    dq_ms, dkv_ms, call_ms, lms, sms = paired_ms(
        [dq_fn, dkv_fn, call, sdpa_bwd, simt_fn])
    print(f"[tf32-kernels] fp32 backward {label}: max_abs_err dq "
          f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (SDPA's "
          f"{sdpa_err:.3e}), one launch each, the same bits twice; the call "
          f"{call_ms:.4f} ms, SDPA backward (EFFICIENT_ATTENTION) {lms:.4f} "
          f"ms (call/SDPA {call_ms / lms:.3f}), CUDA-core kernels "
          f"{sms:.4f} ms ({sms / call_ms:.2f}x slower) in alternating "
          f"rounds, plain {pms:.4f} ms | {smi}", flush=True)
    for name, ms, err, dkv in (("flash_bwd_dq_tf32", dq_ms, errs[0], False),
                               ("flash_bwd_dkv_tf32", dkv_ms,
                                max(errs[1:]), True)):
        (tb, tby), (fbms, fby) = tf32_bwd_bounds(b, h, sq, sk, d, dkv)
        print(f"[tf32-kernels] {name} fp32 {label}: kernel {ms:.4f} ms"
              f"{' (with the split pre-pass)' if not dkv else ''}; 3xTF32 "
              f"bound {tb:.4f} ms ({tby}), {100 * tb / ms:.1f}% of it; FFMA "
              f"bound {fbms:.4f} ms ({fby}), {100 * fbms / ms:.1f}%",
              flush=True)
        cases[name].append(dict(shape=label, max_abs_err=err, ms=ms,
                                plain_ms=pms, library_ms=lms,
                                call_ms=call_ms, simt_call_ms=sms,
                                sdpa_max_abs_err=sdpa_err, bound_ms=tb,
                                bound_by=tby, ffma_bound_ms=fbms))


def phase_tf32_kernels(smi: str):
    """The 3xTF32 fp32 forward (``csrc/flash_fwd_tf32_sm90.cu``) through
    the entry points the UNet and the trainer call (the fixed cap through
    the projection layout's strides, the training forward over head-major
    views of it, the ragged pair head-major), each call against its plain
    version (``simt_err``; the LSE within ``TF32_LSE_TOL``) with exactly
    one launch, timed against SDPA (its default dispatch in fp32, the
    backend named) and the CUDA-core kernel the same call took before
    (``flash_simt``) in alternating rounds, with its share of the 3xTF32
    and the FFMA bound and SDPA's own max error against the plain version.
    The fp32 backward runs on the new forward's output and LSE at the 64²
    and the ragged case (the 3xTF32 backward, one launch of each kernel);
    at 64² the transposed-layout forward in fp32 is held and timed with its
    launch on the same kernel.  Then the 3xTF32 backward
    (``csrc/flash_bwd_tf32_sm90.cu``, ``tf32_bwd_case``) at the same
    levels and the ragged pair.  Returns the four rows of the kernels line
    (fixed cap, forward, dq, dk/dv), each with its 64² case and every
    case."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from sdbc_tpu_torch.ops import _kernels, flash_simt
    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb
    from sdbc_tpu_torch.ops import flash_attention_tt as ttt
    from sdbc_tpu_torch.ops import geglu_ff as gf

    g = torch.Generator(device="cuda").manual_seed(4321)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    tr = lambda t: t.transpose(1, 2)
    cases = {"flash_fixed_tf32": [], "flash_fwd_tf32": [],
             "flash_bwd_dq_tf32": [], "flash_bwd_dkv_tf32": []}

    def held(what, out, ref, counts, want):
        torch.cuda.synchronize()
        err, tol = simt_err(out, ref)
        if counts != want or not (torch.isfinite(out).all() and err <= tol):
            fail(f"{what}: max abs err {err} (tol {tol}), launches {counts} "
                 f"(expected {want})")
        return err

    def measure(name, label, dims, q, k, v, call, err, ref_fn, sdpa_fn,
                simt_fn, extra_bytes=0.0, into=None, **extra):
        b, h, sq, sk, d = dims
        sdpa_err = (sdpa_fn().float() - ref_fn()[0]).abs().max().item()
        pms = median_ms(ref_fn, 3)
        ms, lms, sms = paired_ms([call, sdpa_fn, simt_fn])
        (tb, tby), (fbms, fby) = tf32_bounds(b, h, sq, sk, d, extra_bytes)
        print(f"[tf32-kernels] {name} fp32 {label}: max_abs_err {err:.3e} "
              f"(SDPA's {sdpa_err:.3e}); kernel {ms:.4f} ms, SDPA "
              f"({sdpa_backend(q, k, v)}) {lms:.4f} ms (kernel/SDPA "
              f"{ms / lms:.3f}), CUDA-core kernel {sms:.4f} ms ({sms / ms:.2f}x"
              f" slower) in alternating rounds, plain {pms:.4f} ms; 3xTF32 "
              f"bound {tb:.4f} ms ({tby}), {100 * tb / ms:.1f}% of it; FFMA "
              f"bound {fbms:.4f} ms ({fby}), {100 * fbms / ms:.1f}% | {smi}",
              flush=True)
        (cases if into is None else into)[name].append(dict(
            shape=label, max_abs_err=err, ms=ms, plain_ms=pms, library_ms=lms,
            simt_ms=sms, sdpa_max_abs_err=sdpa_err, bound_ms=tb, bound_by=tby,
            ffma_bound_ms=fbms, **extra))

    # the fixed cap
    for dims in [(b, h, s, s, d) for b, s, h, d in TF32_FIXED] + [
            TF32_RAGGED]:
        b, h, sq, sk, d = dims
        if dims == TF32_RAGGED:
            q, k, v = randn(b, h, sq, d), randn(b, h, sk, d), randn(b, h, sk, d)
            call = lambda: fa.flash_attention_fixed(q, k, v)
            label = f"Sq {sq} Sk {sk} ({b},{h},·,{d})"
        else:
            qb, kb, vb = (randn(b, sq, h, d) for _ in range(3))
            q, k, v = tr(qb), tr(kb), tr(vb)
            call = lambda: tr(fa.flash_attention_fixed_bshd(qb, kb, vb))
            label = f"({b},{sq},{h},{d})"
        ref_fn = lambda: (fa.fixed_cap_attention_ref(q, k, v),)
        _kernels.reset_launch_counts()
        out = call()
        counts = {n: c for n, c in _kernels.launches.items() if c}
        err = held(f"flash_fixed_tf32 {label}", out, ref_fn()[0], counts,
                   {"flash_fixed_tf32": 1})
        o = torch.empty(q.shape, device="cuda")
        measure("flash_fixed_tf32", label, dims, q, k, v, call, err, ref_fn,
                lambda: sdpa(q, k, v),
                lambda: flash_simt.fixed_cap(q, k, v, o, d ** -0.5))
        del q, k, v, o, out

    # the training forward, and the fp32 backward on its LSE
    for dims in [(b, h, s, s, d) for b, h, s, d in TF32_TRAIN] + [
            TF32_RAGGED]:
        b, h, sq, sk, d = dims
        scale = d ** -0.5
        if dims == TF32_RAGGED:
            q, k, v = randn(b, h, sq, d), randn(b, h, sk, d), randn(b, h, sk, d)
            label = f"Sq {sq} Sk {sk} ({b},{h},·,{d})"
        else:
            q, k, v = (tr(randn(b, sq, h, d)) for _ in range(3))
            label = f"({b},{h},{sq},{d})"
        ref_fn = lambda: fa.flash_attention_ref(q, k, v, scale)
        _kernels.reset_launch_counts()
        out, lse = fa.flash_fwd(q, k, v, scale)
        counts = {n: c for n, c in _kernels.launches.items() if c}
        ref, ref_lse = ref_fn()
        err = held(f"flash_fwd_tf32 {label}", out, ref, counts,
                   {"flash_fwd_tf32": 1})
        lerr = (lse - ref_lse).abs().max().item()
        if not lerr <= TF32_LSE_TOL:
            fail(f"flash_fwd_tf32 {label}: lse err {lerr} (tol "
                 f"{TF32_LSE_TOL})")
        extra = dict(lse_max_abs_err=lerr)
        if sq == 4096 or dims == TF32_RAGGED:
            do = randn(*q.shape)
            _kernels.reset_launch_counts()
            grads = fb.flash_bwd(q, k, v, out, do, lse, scale)
            counts = {n: c for n, c in _kernels.launches.items() if c}
            want = {"flash_bwd_dq_tf32": 1, "flash_bwd_dkv_tf32": 1}
            extra["bwd_max_abs_err"] = max(
                held(f"fp32 backward on the tf32 forward's lse {label} {n}",
                     gr, rf, counts, want)
                for n, gr, rf in zip("dq dk dv".split(), grads,
                                     fb.flash_bwd_ref(q, k, v, ref, do,
                                                      ref_lse, scale)))
            del do, grads
        if sq == 4096:
            # the transposed-layout forward in fp32 takes the same kernel
            _kernels.reset_launch_counts()
            tout, tlse = ttt.flash_fwd_tt(q, k, v, scale)
            counts = {n: c for n, c in _kernels.launches.items() if c}
            terr = held(f"flash_tt fp32 {label}", tout, ref, counts,
                        {"flash_fwd_tf32": 1})
            terr = max(terr, (tlse - ref_lse).abs().max().item())
            tt_ms, fwd_ms = paired_ms([lambda: ttt.flash_fwd_tt(q, k, v,
                                                                scale),
                                       lambda: fa.flash_fwd(q, k, v, scale)])
            print(f"[tf32-kernels] flash_tt fp32 {label}: one launch of "
                  f"flash_fwd_tf32, max_abs_err {terr:.3e} (LSE included); "
                  f"{tt_ms:.4f} ms a call, the natural-layout forward "
                  f"{fwd_ms:.4f} ms in alternating rounds | {smi}",
                  flush=True)
            extra["flash_tt"] = dict(ms=tt_ms, fwd_ms=fwd_ms,
                                     max_abs_err=terr)
            del tout, tlse
        measure("flash_fwd_tf32", label, dims, q, k, v,
                lambda: fa.flash_fwd(q, k, v, scale), max(err, lerr),
                ref_fn, lambda: sdpa(q, k, v, scale=scale),
                lambda: flash_simt.fwd(q, k, v, scale),
                extra_bytes=4.0 * b * h * sq, **extra)
        del q, k, v, out, lse, ref, ref_lse

    # the wide forward (head dims 264-512): the fixed cap and the training
    # forward, head-major, each call held and timed as above; at the VAE's
    # head also the fp32 transposed-layout forward, which takes it
    wide = {"flash_fixed_tf32": [], "flash_fwd_tf32": []}
    for dims in TF32_WIDE:
        b, h, sq, sk, d = dims
        scale = d ** -0.5
        q, k, v = randn(b, h, sq, d), randn(b, h, sk, d), randn(b, h, sk, d)
        label = (f"({b},{h},{sq},{d})" if sq == sk
                 else f"Sq {sq} Sk {sk} ({b},{h},·,{d})")
        o = torch.empty(q.shape, device="cuda")
        ref_fn = lambda: (fa.fixed_cap_attention_ref(q, k, v),)
        _kernels.reset_launch_counts()
        out = fa.flash_attention_fixed(q, k, v)
        counts = {n: c for n, c in _kernels.launches.items() if c}
        err = held(f"flash_fixed_tf32 wide {label}", out, ref_fn()[0],
                   counts, {"flash_fixed_tf32": 1})
        measure("flash_fixed_tf32", label, dims, q, k, v,
                lambda: fa.flash_attention_fixed(q, k, v), err, ref_fn,
                lambda: sdpa(q, k, v),
                lambda: flash_simt.fixed_cap(q, k, v, o, scale),
                into=wide)
        ref_fn = lambda: fa.flash_attention_ref(q, k, v, scale)
        _kernels.reset_launch_counts()
        out, lse = fa.flash_fwd(q, k, v, scale)
        counts = {n: c for n, c in _kernels.launches.items() if c}
        ref, ref_lse = ref_fn()
        err = held(f"flash_fwd_tf32 wide {label}", out, ref, counts,
                   {"flash_fwd_tf32": 1})
        lerr = (lse - ref_lse).abs().max().item()
        if not lerr <= TF32_LSE_TOL:
            fail(f"flash_fwd_tf32 wide {label}: lse err {lerr} (tol "
                 f"{TF32_LSE_TOL})")
        extra = dict(lse_max_abs_err=lerr)
        if sq == 4096:
            _kernels.reset_launch_counts()
            tout, tlse = ttt.flash_fwd_tt(q, k, v, scale)
            counts = {n: c for n, c in _kernels.launches.items() if c}
            terr = held(f"flash_tt fp32 {label}", tout, ref, counts,
                        {"flash_fwd_tf32": 1})
            terr = max(terr, (tlse - ref_lse).abs().max().item())
            tt_ms, fwd_ms = paired_ms([lambda: ttt.flash_fwd_tt(q, k, v,
                                                                scale),
                                       lambda: fa.flash_fwd(q, k, v, scale)])
            print(f"[tf32-kernels] flash_tt fp32 {label}: one launch of "
                  f"flash_fwd_tf32 (the wide kernel), max_abs_err "
                  f"{terr:.3e} (LSE included); {tt_ms:.4f} ms a call, the "
                  f"natural-layout forward {fwd_ms:.4f} ms in alternating "
                  f"rounds | {smi}", flush=True)
            extra["flash_tt"] = dict(ms=tt_ms, fwd_ms=fwd_ms,
                                     max_abs_err=terr)
            del tout, tlse
        measure("flash_fwd_tf32", label, dims, q, k, v,
                lambda: fa.flash_fwd(q, k, v, scale), max(err, lerr), ref_fn,
                lambda: sdpa(q, k, v, scale=scale),
                lambda: flash_simt.fwd(q, k, v, scale),
                extra_bytes=4.0 * b * h * sq, into=wide, **extra)
        del q, k, v, o, out, lse, ref, ref_lse

    # the fused FF (csrc/geglu_ff_tf32_sm90.cu) against its plain version,
    # timed against the CUDA-core kernel and the unfused fp32 FF
    ff_cases = []
    for rows_n, c in TF32_GEGLU:
        args = [randn(rows_n, c), 1.0 + 0.2 * randn(c), 0.1 * randn(c),
                randn(c, 8 * c) * c ** -0.5, 0.05 * randn(8 * c),
                randn(4 * c, c) * (4 * c) ** -0.5, 0.05 * randn(c)]
        label = f"({rows_n},{c})"
        _kernels.reset_launch_counts()
        out = gf.geglu_ff_rows(*args)
        counts = {n: c_ for n, c_ in _kernels.launches.items() if c_}
        err = held(f"geglu_ff_tf32 {label}", out, gf.geglu_ff_ref(*args),
                   counts, {"geglu_ff_tf32": 1})
        o2 = torch.empty_like(args[0])
        pms = median_ms(lambda: gf.geglu_ff_ref(*args), 3)
        ms, ums, sms = paired_ms(
            [lambda: gf.geglu_ff_rows(*args), lambda: unfused_ff(*args),
             lambda: _kernels.geglu_ff_simt(*args, o2, 1e-5)])
        (tb, tby), (fbms, fby) = geglu_tf32_bounds(rows_n, c)
        print(f"[tf32-kernels] geglu_ff_tf32 fp32 {label}: max_abs_err "
              f"{err:.3e}; kernel {ms:.4f} ms (the split pre-pass in), the "
              f"unfused fp32 FF {ums:.4f} ms (kernel/unfused {ms / ums:.3f}),"
              f" CUDA-core kernel {sms:.4f} ms ({sms / ms:.2f}x slower) in "
              f"alternating rounds, plain {pms:.4f} ms; 3xTF32 bound "
              f"{tb:.4f} ms ({tby}), {100 * tb / ms:.1f}% of it; FFMA bound "
              f"{fbms:.4f} ms ({fby}), {100 * fbms / ms:.1f}% | {smi}",
              flush=True)
        ff_cases.append(dict(shape=label, max_abs_err=err, ms=ms,
                             plain_ms=pms, unfused_ms=ums, simt_ms=sms,
                             bound_ms=tb, bound_by=tby, ffma_bound_ms=fbms))
        del args, out, o2

    # the fp32 backward on 3xTF32 (csrc/flash_bwd_tf32_sm90.cu)
    for dims in [(b, h, s, s, d) for b, h, s, d in TF32_TRAIN] + [
            TF32_RAGGED]:
        tf32_bwd_case(dims, randn, held, cases, smi)

    rows = []
    for name, replaces, source in (
            ("flash_fixed_tf32", "sdbc_tpu/ops/flash_attention.py:348",
             "flash_fwd_tf32_sm90.cu"),
            ("flash_fwd_tf32", "sdbc_tpu/ops/flash_attention.py:81",
             "flash_fwd_tf32_sm90.cu"),
            ("flash_bwd_dq_tf32", "sdbc_tpu/ops/flash_attention_bwd.py:163",
             "flash_bwd_tf32_sm90.cu"),
            ("flash_bwd_dkv_tf32", "sdbc_tpu/ops/flash_attention_bwd.py:187",
             "flash_bwd_tf32_sm90.cu")):
        main = cases[name][0]
        rows.append(dict(
            name=name, route="cuda", source=f"sdbc_tpu_torch/csrc/{source}",
            replaces=replaces, max_abs_err=max(c["max_abs_err"]
                                               for c in cases[name]),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"],
            library=("sdpa backward (EFFICIENT_ATTENTION)"
                     if "_bwd_" in name else "sdpa"),
            shape=f"fp32 {main['shape']}", cases=cases[name]))
    # the wide forward's rows: its launches from the fp32 VAE decodes
    for name, impl in (("flash_fixed_tf32", "inference"),
                       ("flash_fwd_tf32", "flash")):
        main = wide[name][0]
        rows.append(dict(
            name=name, route="cuda",
            source="sdbc_tpu_torch/csrc/flash_fwd_tf32_wide_sm90.cu",
            replaces=("sdbc_tpu/ops/flash_attention.py:348" if "fixed" in name
                      else "sdbc_tpu/ops/flash_attention.py:81"),
            max_abs_err=max(c["max_abs_err"] for c in wide[name]),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], library="sdpa",
            shape=f"fp32 {main['shape']}", cases=wide[name],
            path=f"decode fp32 SDBC_ATTN_IMPL={impl}"))
    main = ff_cases[0]
    rows.append(dict(
        name="geglu_ff_tf32", route="cuda",
        source="sdbc_tpu_torch/csrc/geglu_ff_tf32_sm90.cu",
        replaces="sdbc_tpu/ops/geglu_ff.py:98",
        max_abs_err=max(c["max_abs_err"] for c in ff_cases), ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        shape=f"fp32 {main['shape']}", cases=ff_cases))
    return rows


def geglu_tf32_bounds(rows, c):
    """((ms, by) of the 3xTF32 bound, (ms, by) of the FFMA bound) of one
    fp32 fused FF over (rows, c): y read and the output written once with
    the weights, biases and LayerNorm parameters (fp32); three tf32
    products of 24·rows·c² FLOPs at 495 TFLOP/s, or 24·rows·c² fp32 FLOPs
    at 67 TFLOP/s (``bound``)."""
    nbytes = 4.0 * (2 * rows * c + 12 * c * c + 9 * c) + 8.0 * c
    flops = 24.0 * rows * c * c
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, 3.0 * flops / PEAK_TF32
    tf32 = (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")
    return tf32, bound(nbytes, fp32_ops=flops)


def phase_parity():
    """The tiny sampling slice, bf16 on the card against fp32 on the CPU:
    with the default dispatch, then with ``SDBC_GN_FUSED=1``; then fp32 on
    the card (the same weights), where every attention call goes to the
    3xTF32 kernel and every FF call to the 3xTF32 FF (``fp32_launches``),
    within ``FP32_PARITY_TOL``.  Returns the fp32 run's launch counts."""
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
        tol = FP32_PARITY_TOL if label == "fp32" else PARITY_TOL
        print(f"[parity] tiny 32^2 batch 2 DDIM-4 ({label}): image max abs "
              f"err {err:.3e} (tol {tol}), launches {counts} "
              f"(expected {want})", flush=True)
        if out.shape != (2, 32, 32, 3) or not np.isfinite(out).all():
            fail(f"tiny slice ({label}) output {out.shape} not finite")
        if not err <= tol:
            fail(f"tiny slice ({label}): card vs CPU max abs err {err} > "
                 f"{tol}")
        used = ("flash_fixed_tf32", "geglu_ff_tf32", "flash_fwd_tf32") \
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


# The fp32 VAE decodes under SDBC_ATTN_IMPL against the default fp32
# decode (plain attention, the same weights and latent): fp32 on both
# sides, the mid block's attention summed in another order (1e-4 of its
# largest entry at most, as the kernels are held), which the decoder's
# remaining layers carry to the image; 1e-4 of the image's largest entry.
FP32_DECODE_REL_TOL = 1e-4


def phase_fp32_sampling(smi: str):
    """The CLIs' --no-bf16 sampling path at full width:
    ``cli.common.resolve_params_cfg`` on parsed ``cli.inference`` arguments
    with ``--no-bf16`` (random SD-1.5 from --seed, fp32 on the card), then
    ``SDPipeline.generate`` with the profile's DDIM-10, CFG 7.5, 512² on 4
    prompts: a warm-up call, then a timed call with finite images, its
    wall seconds and peak memory, every self-attention call on the 3xTF32
    kernel (15 an evaluation) and every fused FF on the 3xTF32 one (10 an
    evaluation), no other launch (``fp32_launches`` of
    ``generate_launches``).  Then one fp32 VAE decode of a 64² latent under
    SDBC_ATTN_IMPL=inference and =flash: the mid block's 512-wide head on
    the wide 3xTF32 fixed cap and forward (one launch each, none on the
    CUDA-core kernels), held to the default fp32 decode, each with its wall
    ms.  Returns the launch counts by path."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as cli
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.models import vae as vae_mod
    from sdbc_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    args = cli.build_parser().parse_args(
        ["--no-bf16", "--scheduler", "ddim", "--num_inference_steps", "10",
         "--guidance_scale", "7.5", "--seed", "0"])
    common.refuse_unported(args)
    common.resolve_img_size(args)
    models, cfg = common.resolve_params_cfg(args)
    dtypes = {p.dtype for m in models.values() for p in m.parameters()}
    devices = {p.device.type for m in models.values()
               for p in m.parameters()}
    if dtypes != {torch.float32} or devices != {"cuda"} \
            or common.compute_dtype(args) != torch.float32:
        fail(f"resolve_params_cfg (--no-bf16) gave {dtypes} on {devices}")
    pipe = SDPipeline(models, cfg,
                      common.make_tokenizer(args, cfg.clip.vocab_size),
                      device=args.device,
                      compute_dtype=common.compute_dtype(args))
    spec = cli.profile_spec(args, cfg).replace(
        height=args.img_size, width=args.img_size,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, seed=args.seed)
    setup = time.perf_counter() - t0
    want = fp32_launches(generate_launches(
        cfg, len(PROMPTS), spec.num_inference_steps, spec.height, "ddim"))
    t0 = time.perf_counter()
    pipe.generate(PROMPTS, spec)  # warm-up
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    imgs = pipe.generate(PROMPTS, spec)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"[fp32-sampling] --no-bf16: SD-1.5 512^2 batch 4 DDIM-10 CFG 7.5 "
          f"fp32 (resolve_params_cfg and the pipeline {setup:.3f} s): "
          f"{secs:.3f} s/call, {4 / secs:.4f} images/s, warm-up {warm:.3f} "
          f"s, peak {peak / 2 ** 30:.2f} GiB, flash_fixed_tf32 "
          f"{counts['flash_fixed_tf32']} geglu_ff_tf32 "
          f"{counts['geglu_ff_tf32']} flash_fixed_simt "
          f"{counts['flash_fixed_simt']} geglu_ff_simt "
          f"{counts['geglu_ff_simt']} (expected "
          f"{want['flash_fixed_tf32']}, {want['geglu_ff_tf32']}, 0, 0) | "
          f"{smi}", flush=True)
    if imgs.shape != (4, 512, 512, 3) or not np.isfinite(imgs).all():
        fail(f"fp32 sampling images {imgs.shape} not all finite")
    if want["flash_fixed_tf32"] != 150 or want["geglu_ff_tf32"] != 100 \
            or counts != want:
        fail(f"fp32 sampling launch counts {counts}, expected {want}")
    paths = {"sampling fp32": counts}

    vae = pipe.models["vae"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    z = torch.randn((1, 64, 64, vae.cfg.latent_channels), generator=gen,
                    device="cuda") / vae.cfg.scaling_factor
    none = dict.fromkeys(_kernels.launches, 0)
    with torch.inference_mode():
        _kernels.reset_launch_counts()
        img = vae_mod.decode(vae, z)
        torch.cuda.synchronize()
        default_counts = dict(_kernels.launches)
        default_ms = wall_ms(lambda: vae_mod.decode(vae, z), 3)
        for impl, name in (("inference", "flash_fixed_tf32"),
                           ("flash", "flash_fwd_tf32")):
            with environment(SDBC_ATTN_IMPL=impl):
                _kernels.reset_launch_counts()
                img_sw = vae_mod.decode(vae, z)
                torch.cuda.synchronize()
                c = dict(_kernels.launches)
                sw_ms = wall_ms(lambda: vae_mod.decode(vae, z), 3)
            err = (img_sw - img).abs().max().item()
            tol = FP32_DECODE_REL_TOL * img.abs().max().item()
            print(f"[fp32-sampling] fp32 VAE decode 64^2 latent, "
                  f"SDBC_ATTN_IMPL={impl} vs the default fp32 decode: max "
                  f"abs diff {err:.3e} (tol {tol:.3e}); launches "
                  f"{ {k: v for k, v in c.items() if v} } (default decode "
                  f"{ {k: v for k, v in default_counts.items() if v} }); "
                  f"wall {sw_ms:.3f} ms (the default decode "
                  f"{default_ms:.3f} ms)", flush=True)
            if img_sw.shape != (1, 512, 512, 3) \
                    or not torch.isfinite(img_sw).all() or not err <= tol:
                fail(f"fp32 decode under SDBC_ATTN_IMPL={impl}: max abs "
                     f"diff {err} (tol {tol})")
            if c != dict(none, **{name: 1}) or default_counts != none:
                fail(f"fp32 decode launch counts {c}, default "
                     f"{default_counts}")
            paths[f"decode fp32 SDBC_ATTN_IMPL={impl}"] = c
    del pipe, models, vae
    return paths


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

    return TrainConfig(**{**dict(train_text_encoder=True, train_unet=True,
                                 use_8bit_adam=True), **kw})


def _family_tcfg(cfg, **kw):
    """``_train_cfg`` with the family flags of ``cfg`` (SDXL: both
    encoders; the refiner)."""
    return _train_cfg(dual_text_encoder=cfg.is_sdxl, refiner=cfg.refiner,
                      **kw)


def _train_batch(cfg, accum: int, micro: int, img: int, rng, extra_ids=0):
    """A random (accum, micro) batch of ``img``² pixels and token ids
    (SDXL: the second ids too) below the vocab, as numpy; with
    ``extra_ids`` (textual inversion's placeholder ids) every prompt holds
    them after its first token."""
    import numpy as np

    def ids():
        out = rng.integers(0, cfg.clip.vocab_size,
                           (accum, micro, cfg.clip.ctx))
        out[..., 1:1 + extra_ids] = cfg.clip.vocab_size + np.arange(
            extra_ids)
        return out
    out = {"pixel_values": (rng.standard_normal(
               (accum, micro, img, img, 3)) * 0.5).astype(np.float32),
           "input_ids": ids()}
    if cfg.is_sdxl:
        out["input_ids_2"] = ids()
    return out


def _n8(state) -> int:
    """Optimizer leaves on the 8-bit path (≥ min_8bit_size elements; the
    text encoder's layers stacked into one leaf per name, as in JAX)."""
    from sdbc_tpu_torch.train.adam8bit import MIN_8BIT_SIZE
    from sdbc_tpu_torch.train.trainer import optimizer_leaves

    return sum(sum(p.numel() for p in leaf) >= MIN_8BIT_SIZE
               for leaf in optimizer_leaves(state.trainable))


def jitter_controlnet(cn, seed: int, scale: float = 0.05):
    """A branch's zero output convs (and the embedder's zero conv_out)
    moved off zero, as a trained branch is, so its residuals, and the
    gradients through it, are not 0."""
    import torch

    g = torch.Generator(device=cn.zero_mid.weight.device).manual_seed(seed)
    with torch.no_grad():
        for p in (*cn.zero_down.parameters(), *cn.zero_mid.parameters(),
                  *cn.cond_embedding.conv_out.parameters()):
            p.add_(scale * torch.randn(p.shape, generator=g, device=p.device,
                                       dtype=torch.float32).to(p.dtype))
    return cn


def phase_train_parity(label: str = "default", env=None, card_dtypes=None,
                       cfg=None, img: int = 32,
                       grad_rtol: float = TRAIN_GRAD_RTOL, **tcfg_kw):
    """One optimizer step of the tiny config (or ``cfg``, at ``img``²) on
    the card in each of ``card_dtypes`` (default bf16) against fp32 on the
    CPU (run once), from the same fp32 masters and the same injected
    draws, under the environment ``env`` on both sides.  In fp32 the flash
    forward and the backward, on the forward's LSE, run on the 3xTF32
    kernels (``fp32_launches``), the 8-bit AdamW as in bf16, and the loss
    is held to ``FP32_PARITY_TOL``.  The held gradients are the UNet's
    self-attention projections where the UNet trains (a ControlNet
    branch's where it trains: ``train_controlnet``, a ``from_unet`` branch
    off its zero convs), else every nonzero gradient of the adapter, each
    within ``grad_rtol`` in bf16 and ``TRAIN_GRAD_RTOL`` in fp32.  Returns
    {dtype: launch counts}."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.diffusion.schedulers import make_schedule
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train.trainer import (diffusion_loss,
                                              init_train_state,
                                              make_train_step, merged,
                                              optimizer_leaf_keys,
                                              optimizer_leaves,
                                              trainable_params)

    cfg = cfg or PipelineConfig.tiny()
    tcfg = _family_tcfg(cfg, grad_accum=2, micro_batch=2,
                        learning_rate=1e-3, num_examples=100, **tcfg_kw)
    base = init_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    if tcfg.train_controlnet:
        from sdbc_tpu_torch.models import controlnet as cn_mod

        base["controlnet"] = jitter_controlnet(cn_mod.from_unet(
            base["unet"], torch.Generator().manual_seed(1),
            cfg.controlnet), 2)
    rng = np.random.default_rng(11)
    f32 = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32))
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(
        cfg, 2, 2, img, rng, extra_ids=tcfg.ti_vectors * bool(
            tcfg.ti_token)).items()}
    lat = img // cfg.vae_scale
    draws = [{"eps": f32(2, lat, lat, 4), "noise": f32(2, lat, lat, 4),
              "t": torch.from_numpy(rng.integers(0, 1000, (2,)))}
             for _ in range(2)]

    def micro_grads(state, dev, dt):
        """The held gradients of the first micro-batch's loss."""
        with merged(state.trainable, state.frozen, tcfg) as models:
            loss = diffusion_loss(
                models, {k: v[0].to(dev) for k, v in batch.items()}, cfg,
                tcfg, make_schedule(cfg.schedule, dev), dt, draws=draws[0])
            loss.backward()
        held = next((k for k in ("unet", "controlnet")
                     if k in state.trainable), None)
        if held is not None:
            # the self-attention projections (the branch's too)
            out = {n: p.grad.float().cpu().clone() for n, p in
                   state.trainable[held].named_parameters()
                   if n.endswith(HELD_GRADS)}
        else:
            out = {".".join(k for k, _ in key): t.grad.float().cpu().clone()
                   for key, (t,) in zip(optimizer_leaf_keys(state.trainable),
                                        optimizer_leaves(state.trainable))
                   if t.grad is not None and bool(t.grad.any())}
        for p in trainable_params(state.trainable):
            p.grad = None
        return out

    def run(dev, dt):
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
        return (m, [a - b for a, b in zip(after, before)], counts, state,
                grads)

    out = {}
    with environment(**(env or {})):
        mc, dc, cc, _, gc = run("cpu", torch.float32)
        for card_dtype in card_dtypes or (torch.bfloat16,):
            fp32 = card_dtype == torch.float32
            mg, dg, cg, sg, gg = run("cuda", card_dtype)
            grad_rel = {n: float((gg[n] - gc[n]).norm() / gc[n].norm())
                        for n in gc}
            worst_grad = max(grad_rel, key=grad_rel.get)
            g_tol = TRAIN_GRAD_RTOL if fp32 else grad_rtol
            lerr = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
            loss_tol = FP32_PARITY_TOL if fp32 else TRAIN_LOSS_RTOL
            cos = float(sum((a * b).sum() for a, b in zip(dg, dc))
                        / (sum((a * a).sum() for a in dg).sqrt()
                           * sum((b * b).sum() for b in dc).sqrt()))
            worst = max(float((a - b).abs().max()) for a, b in zip(dg, dc))
            want = expected_train_launches(cfg, tcfg, img, _n8(sg),
                                           switches=bool(env))
            if fp32:
                want = fp32_launches(want)
            what = f"{label}{', card fp32' if fp32 else ''}"
            print(f"[train-parity] tiny grad_accum 2 micro 2, "
                  f"{'8-bit' if tcfg.use_8bit_adam else 'fp32'} AdamW, one "
                  f"step ({what}): loss card {mg['loss']:.6f} cpu "
                  f"{mc['loss']:.6f} (rel err {lerr:.3e}, tol {loss_tol}); "
                  f"update cosine {cos:.5f} (tol {TRAIN_UPDATE_COS}), max "
                  f"|Δ| difference {worst:.3e} (bound "
                  f"{TRAIN_STEP_BOUND * tcfg.learning_rate}); micro-batch "
                  f"gradient rel err of {len(grad_rel)} held tensors: max "
                  f"{grad_rel[worst_grad]:.3e} ({worst_grad}), median "
                  f"{statistics.median(grad_rel.values()):.3e} (tol "
                  f"{g_tol}); launches {nonzero(cg)} (expected "
                  f"{nonzero(want)}; CPU {nonzero(cc)})", flush=True)
            if not (mg["finite"] and mc["finite"]
                    and np.isfinite(mg["loss"])):
                fail(f"tiny train step ({what}) not finite")
            if not grad_rel[worst_grad] <= g_tol:
                fail(f"tiny train step ({what}): micro-batch gradients card "
                     f"vs CPU {grad_rel}")
            if not (lerr <= loss_tol and cos >= TRAIN_UPDATE_COS
                    and worst <= TRAIN_STEP_BOUND * tcfg.learning_rate):
                fail(f"tiny train step ({what}): card vs CPU outside "
                     "tolerance")
            if cg != want or set(cc.values()) != {0}:
                fail(f"tiny train step ({what}) launch counts {cg}, "
                     f"expected {want}")
            used = (("gn_fused", "flash_tt") if env else ("flash_fwd",)) \
                + ("flash_bwd_dq", "flash_bwd_dkv") \
                + ("adam8",) * (want["adam8"] > 0)
            if fp32:
                used = tuple(FP32_OF.get(k, k) for k in used)
            if min(cg[k] for k in used) == 0 or (env and cg["flash_fwd"]):
                fail(f"tiny train step ({what}) skipped a kernel: {cg}")
            out[card_dtype] = cg
            del sg
    return out


def phase_train(smi: str, steps: int = 3, label: str = "train", env=None,
                profile: bool = True, compute_dtype=None, **tcfg_kw):
    """Bench mode C at full width: warm-up step, ``steps`` timed steps, with
    ``tcfg_kw`` added to the train config and the environment ``env``, in
    bf16 compute or ``compute_dtype`` (fp32: the finetune CLI's --no-bf16,
    TF32 off as ``phase_device`` set it; every attention forward and
    backward on the 3xTF32 kernels, ``fp32_launches``); returns (launches
    of the timed steps, median s/step, peak bytes)."""
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
    dt = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    state = init_train_state(init_models(cfg, device="cuda", generator=gen),
                             tcfg, **dt)
    step = make_train_step(cfg, tcfg, **dt)
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
    want = expected_train_launches(cfg, tcfg, 512, n8, switches=bool(env))
    if compute_dtype == torch.float32:
        want = fp32_launches(want)
    want = {k: steps * v for k, v in want.items()}
    flash, _ = expected_launches(cfg, 64, micro * 8)
    moved = [float((p.detach() - s0).abs().max()) for p, s0 in
             zip(watch, start)]
    sps = statistics.median(times)
    extra = "".join(f" {k}={v}" for k, v in tcfg_kw.items())
    extra += "".join(f" {k}={v}" for k, v in (env or {}).items())
    if compute_dtype is not None:
        extra += (f" compute {compute_dtype} (TF32 matmul "
                  f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
                  f"{torch.backends.cudnn.allow_tf32})")
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
        phase_train_profile(step, state, batch, gen, sps, label,
                            host=label == "train")
    return counts, sps, peak


def phase_train_ckpt(smi: str, no_remat):
    """Mode C with gradient checkpointing, per remat mode, beside the
    no-remat train phase of the same run (``no_remat``: its s/step and
    peak bytes): 3 timed steps and a device-time profile of one more.
    Returns (launches, s/step) by mode."""
    out, sps_of = {}, {}
    for mode in ("block", "selective"):
        counts, sps, peak = phase_train(smi, label=f"train-ckpt {mode}",
                                        grad_ckpt=True, remat_mode=mode)
        out[mode], sps_of[mode] = counts, sps
        print(f"[train-ckpt] remat_mode={mode}: {sps:.4f} s/step, "
              f"{8 / sps:.4f} images/s, peak {peak / 2 ** 30:.2f} GiB; "
              f"no remat: {no_remat[0]:.4f} s/step, {8 / no_remat[0]:.4f} "
              f"images/s, peak {no_remat[1] / 2 ** 30:.2f} GiB", flush=True)
    if out["block"]["flash_fwd"] != 2 * out["selective"]["flash_fwd"]:
        fail(f"train-ckpt: flash forwards block {out['block']} vs selective "
             f"{out['selective']}")
    return out, sps_of


# ---------------------------------------------------------------------------
# finetune: the training CLI (cli/finetune.py) as a user runs it

# the tiny card-vs-CPU runs: phase_train_parity's learning rate and
# tolerances, one optimizer step each (4 examples, micro 2, grad_accum 2)
FT_LR = 1e-3
FT_TINY = {
    "full": ["--train_unet", "--use_8bit_adam", "--ema_decay", "0.9"],
    "lora": ["--lora_rank", "2", "--train_unet"],
    "ti": ["--ti_token", "<sty>"],
    "prior": ["--prior_class_prompt", "a book cover", "--prior_generate",
              "2", "--prior_gen_steps", "2"],
    "cache": ["--cache_latents"],
}
# the trained trees of each tiny run (the text encoder trains by default)
FT_TRAINED = {"full": ("unet", "text_encoder"), "lora": ("adapter",),
              "ti": ("adapter",), "prior": ("text_encoder",),
              "cache": ("text_encoder",)}
# full width: the mode-C flags; 16 examples make 2 steps an epoch
FT_FULL = ["--train_unet", "--train_text_encoder", "--use_8bit_adam",
           "--batch_size", "2", "--grad_acc_steps", "4", "--img_size", "512",
           "--num_examples", "16", "--ckpts_per_epoch", "1", "--seed", "0"]


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def ft_dataset(root: str, n: int, size: int, seed: int = 0) -> str:
    """A Goodreads-layout dataset of ``n`` random ``size``² covers written
    as PNG bytes under the CSV's ``<id>.jpg`` names (``decode_and_prepare``
    reads them without PIL; PIL reads them for the JAX package)."""
    import csv

    import numpy as np

    from sdbc_tpu_torch.utils import png

    img_dir = os.path.join(root, "images", "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "df_train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "book_authors", "book_desc", "book_title"])
        for i in range(n):
            w.writerow([i, f"Author {i}", f"A cover, number {i}.",
                        f"Title {i}"])
            with open(os.path.join(img_dir, f"{i}.jpg"), "wb") as g:
                g.write(png.encode(rng.integers(0, 256, (size, size, 3),
                                                dtype=np.uint8)))
    return root


def ft_trees(state, trees=True) -> dict:
    """{name: {key: tensor (a CPU copy)}} of a train state: the optimizer
    state in the JAX layout, the trained components or the adapter, the
    EMA shadow."""
    from sdbc_tpu_torch.train import trainer
    from sdbc_tpu_torch.utils import checkpoint as ckpt

    plain = lambda key: tuple(k for k, _ in key)
    host = lambda t: t.detach().cpu().clone()
    out = {"opt_state": {plain(k): host(t) for k, t in ckpt.opt_state_tree(
        state.opt_state, state.trainable, 0.0) if not isinstance(t, str)}}
    if "lora" in state.trainable or "ti" in state.trainable:
        out["adapter"] = {plain(k): host(ts[0]) for k, ts in zip(
            trainer.optimizer_leaf_keys(state.trainable),
            trainer.optimizer_leaves(state.trainable))}
    else:
        for comp, m in state.trainable.items():
            out[comp] = {plain(k): host(t) for k, t in ckpt.module_tree(m)
                         if not isinstance(t, str)}
    if state.ema is not None and "adapter" not in out:
        out["ema"] = {(comp,) + plain(k): host(t)
                      for comp, m in state.ema.items()
                      for k, t in ckpt.module_tree(m)
                      if not isinstance(t, str)}
    return out


def ft_disk(path: str, name: str) -> dict:
    """A tree of a saved checkpoint as ``ft_trees`` names it: a component,
    the optimizer state, the EMA shadow, or the adapter of lora.npz /
    ti.npz."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.utils import checkpoint as ckpt

    if name != "adapter":
        return {tuple(k for k, _ in key): t for key, t in
                ckpt.read_tree(os.path.join(path, name)).items()}
    if os.path.exists(os.path.join(path, "ti.npz")):
        with np.load(os.path.join(path, "ti.npz")) as z:
            return {("ti", r): torch.from_numpy(z[r])
                    for r in ("rows", "rows2") if r in z.files}
    with np.load(os.path.join(path, "lora.npz")) as z:
        return {("lora",) + tuple(k.rsplit(".", 1)): torch.from_numpy(z[k])
                for k in z.files if k != "__meta__"}


@contextlib.contextmanager
def ft_capture(trees: bool = True):
    """Wrap ``trainer.make_train_step`` for the CLI's run: the trees of the
    state its first step sees (``ft_trees``), its step and optimizer count,
    each step's kernel launches (the counts' difference around the step)
    and the last state."""
    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train import trainer

    seen = {"launches": []}
    real = trainer.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def wrapped(state, *args, **kwargs):
            if "first_step" not in seen:
                seen["first_step"] = state.step
                seen["first_count"] = state.opt_state.inner.count
                if trees:
                    seen["first_trees"] = ft_trees(state)
            torch.cuda.synchronize()
            before = dict(_kernels.launches)
            out = step(state, *args, **kwargs)
            torch.cuda.synchronize()
            seen["launches"].append({k: v - before[k] for k, v in
                                     _kernels.launches.items()})
            seen["last"] = out[0]
            return out

        return wrapped

    trainer.make_train_step = make
    try:
        yield seen
    finally:
        trainer.make_train_step = real


def ft_bits(a: dict, b: dict, what: str) -> None:
    import torch

    if set(a) != set(b):
        fail(f"{what}: trees of other leaves ({sorted(set(a) ^ set(b))[:4]})")
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            fail(f"{what}: {'.'.join(k)} differs")


def ft_update_err(init: dict, final: dict, init_ref: dict, final_ref: dict):
    """(update cosine, max |Δ − Δref|) of the trained tensors."""
    import torch

    d = [(final[k].float() - init[k].float()).flatten() for k in final]
    r = [(final_ref[k].float() - init_ref[k].float()).flatten()
         for k in final]
    d, r = torch.cat(d), torch.cat(r)
    cos = float(d @ r / (d.norm() * r.norm()))
    return cos, float((d - r).abs().max())


def phase_finetune_tiny():
    """The finetune CLI at the tiny config, one optimizer step per run,
    each configuration (``FT_TINY``) bf16 on the card against fp32 on the
    CPU from the same --ckpt, data and host draws: the loss, and each
    trained tree's update (final checkpoint − the first step's state) held
    as ``phase_train_parity`` holds them; exact K5/K6a/K6b/K7 launches a
    step where the UNet trains (full, LoRA), each training kernel launched
    otherwise, K1/K4 under --prior_generate.  Then a --resume of the full
    run on the card: the state its first step sees equals the saved
    checkpoint and the first run's last state bit for bit.  Returns each
    card run's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import finetune
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils import checkpoint as ckpt

    cfg = PipelineConfig.tiny()
    root = tempfile.mkdtemp(prefix="sdbc_ft_tiny_")
    paths = {}
    try:
        data = ft_dataset(os.path.join(root, "ds"), 8, 32)
        init = os.path.join(root, "init")
        ckpt.save_pipeline(init, init_models(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
            cfg)
        base = ["--tiny", "--ckpt", init, "--data_root", data,
                "--num_examples", "4", "--batch_size", "2",
                "--grad_acc_steps", "2", "--ckpts_per_epoch", "1",
                "--epochs", "1", "--num_workers", "2", "--learning_rate",
                str(FT_LR)]
        for mode, flags in FT_TINY.items():
            runs = {}
            for dev in ("cuda", "cpu"):
                out = os.path.join(root, f"{mode}-{dev}")
                extra = ["--device", dev] + (["--no-bf16"] if dev == "cpu"
                                             else [])
                if mode == "prior" and dev == "cpu":
                    # the card's class images: both runs train on them
                    extra += ["--prior_images_dir",
                              os.path.join(root, "prior-cuda",
                                           "prior_class")]
                _kernels.reset_launch_counts()
                with ft_capture() as seen:
                    stats = finetune.main(base + flags + extra
                                          + ["--output_dir", out])
                if dev == "cuda":
                    torch.cuda.synchronize()
                runs[dev] = (stats, seen, dict(_kernels.launches))
            (sg, seen_g, cg), (sc, seen_c, cc) = runs["cuda"], runs["cpu"]
            lerr = abs(sg["losses"][0] - sc["losses"][0]) / abs(sc["losses"][0])
            errs = {}
            for name in FT_TRAINED[mode]:
                errs[name] = ft_update_err(
                    seen_g["first_trees"][name], ft_disk(sg["final"], name),
                    seen_c["first_trees"][name], ft_disk(sc["final"], name))
            step = seen_g["launches"][0]
            want = None
            if mode in ("full", "lora"):
                tcfg = _train_cfg(grad_accum=2, micro_batch=2, grad_ckpt=True,
                                  remat_mode="block")
                want = expected_train_launches(
                    cfg, tcfg, 32, _n8(seen_g["last"]) if mode == "full"
                    else 0)
            print(f"[finetune-tiny] {mode} ({' '.join(flags)}): loss card "
                  f"{sg['losses'][0]:.6f} cpu {sc['losses'][0]:.6f} (rel err "
                  f"{lerr:.3e}, tol {TRAIN_LOSS_RTOL}); update (cosine, max "
                  f"|Δ difference|) {errs} (tol {TRAIN_UPDATE_COS}, "
                  f"{TRAIN_STEP_BOUND * FT_LR}); step launches "
                  f"{nonzero(step)} (expected "
                  f"{nonzero(want) if want else 'each > 0'}); run launches "
                  f"{nonzero(cg)} (CPU {nonzero(cc)})", flush=True)
            if not all(np.isfinite(x) for x in sg["losses"] + sc["losses"]):
                fail(f"finetune tiny {mode}: losses not finite")
            if not (lerr <= TRAIN_LOSS_RTOL and all(
                    cos >= TRAIN_UPDATE_COS
                    and worst <= TRAIN_STEP_BOUND * FT_LR
                    for cos, worst in errs.values())):
                fail(f"finetune tiny {mode}: card vs CPU outside tolerance")
            if set(cc.values()) != {0}:
                fail(f"finetune tiny {mode}: CPU launches {cc}")
            if want is not None and step != want:
                fail(f"finetune tiny {mode} step launches {step}, expected "
                     f"{want}")
            if min(step[k] for k in ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv")) == 0 \
                    or (mode == "full" and step["adam8"] != 1) \
                    or (mode == "prior" and min(cg["flash_fixed"],
                                                cg["geglu_ff"]) == 0):
                fail(f"finetune tiny {mode} skipped a kernel: step {step}, "
                     f"run {cg}")
            paths[f"finetune tiny {mode}"] = cg
            if mode == "full":
                last = ft_trees(seen_g["last"])
                out = os.path.join(root, "full-cuda")
                with ft_capture() as again:
                    finetune.main(base + flags + [
                        "--device", "cuda", "--output_dir", out, "--epochs",
                        "2", "--resume"])
                if (again["first_step"], again["first_count"]) != (1, 1):
                    fail(f"finetune resume: step {again['first_step']} "
                         f"count {again['first_count']}, expected 1, 1")
                for name, tree in again["first_trees"].items():
                    ft_bits(tree, last[name], f"resume {name} vs the run")
                    ft_bits(tree, {k: t.cpu() for k, t in
                                   ft_disk(sg["final"], name).items()},
                            f"resume {name} vs the checkpoint")
                print(f"[finetune-tiny] --resume on the card: step 1, "
                      f"optimizer count 1, {sum(map(len, last.values()))} "
                      f"tensors of {sorted(last)} bit for bit equal to the "
                      "checkpoint and to the saving run's last state",
                      flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


def ckpt_bytes_estimate(cfg) -> int:
    """Bytes of one checkpoint training the UNet and every text encoder:
    their fp32 masters, the bf16 VAE, the 8-bit moments (two bytes an
    element plus two (rows, 128) fp32 scales per 2048 elements)."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import init_models

    m = init_models(cfg, device="meta", generator=None)
    n = {k: sum(p.numel() for p in v.parameters()) for k, v in m.items()}
    trained = sum(v for k, v in n.items() if k != "vae")
    return 4 * trained + 2 * n["vae"] + 2 * trained \
        + 2 * 128 * 4 * math.ceil(trained / 2048)


JAX_CKPT = ROOT / "tests" / "data" / "jax_ckpt_tiny"
JAX_CKPT_PROMPT = "a gothic novel cover"
JAX_CKPT_ROUNDS = 50


def _digest_check(flat: dict, want: dict, what: str) -> None:
    """Leaves ({dotted path: tensor}, any device) against a tree of the
    fixture's ``digests.json``: SHA-256 of the bytes, dtype and shape."""
    import hashlib

    import torch

    if set(flat) != set(want):
        fail(f"jax-ckpt {what}: leaves differ from the digests "
             f"({sorted(set(flat) ^ set(want))[:4]})")
    for k, w in want.items():
        t = flat[k].detach().contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        digest = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
        dtype = str(t.dtype).replace("torch.", "")
        if (digest, dtype, list(t.shape)) != (w["sha256"], w["dtype"],
                                              w["shape"]):
            fail(f"jax-ckpt {what} {k}: {dtype} {list(t.shape)} sha256 "
                 f"{digest[:12]}, expected {w['dtype']} {w['shape']} "
                 f"{w['sha256'][:12]}")


def phase_jax_ckpt(smi: str) -> dict:
    """A checkpoint the JAX package wrote (``tests/data/jax_ckpt_tiny``:
    ``experiments/make_jax_ckpt_fixture.py``, 8-bit AdamW, an EMA shadow,
    leaves sharded over an 8-device mesh one chunk a shard), read with the
    port's own OCDBT reader and zstd decoder, copied into a run directory:
    ``load_pipeline(device="cuda")`` and ``load_ema`` held to the digests
    the JAX tree gave before the save; a DDIM-4 call through the inference
    CLI's ``--ckpt`` (a finite image, K1/K4 as ``family_launches`` counts
    them, the decode's K5 as the tiny paths count it); one step resumed
    through the finetune CLI's ``--resume`` (the step continues from
    ``metadata.json``, the optimizer state, the trained text encoder and
    the EMA the step sees equal the digests, the loss finite).  Times the
    loader's read of the fixture's trees on the host (``read_tree``, the
    chunks decoded by ``zstd.decompress_many``; ``JAX_CKPT_ROUNDS`` rounds,
    MB/s of decoded bytes) and the load.  Returns the two runs' launch
    counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import finetune
    from sdbc_tpu_torch.cli import inference as cli
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils import checkpoint as ckpt
    from sdbc_tpu_torch.utils import png, zarr, zstd
    from sdbc_tpu_torch.utils.ocdbt import OcdbtStore

    with open(JAX_CKPT / "digests.json") as f:
        digests = json.load(f)
    with open(JAX_CKPT / "metadata.json") as f:
        step = json.load(f)["step"]
    with open(JAX_CKPT / "fixture.json") as f:
        train = json.load(f)["train"]
    plain = lambda key: ".".join(k for k, _ in key)
    root = tempfile.mkdtemp(prefix="sdbc_jax_ckpt_")
    paths = {}
    try:
        run = os.path.join(root, "out", "runs", "jax", f"ckpt-{step}")
        shutil.copytree(JAX_CKPT, run)
        t0 = time.perf_counter()
        zstd.load()
        build_s = time.perf_counter() - t0

        # the loader's own read on the host: read_tree of every tree (its
        # OCDBT store, chunk reads, zstd.decompress_many, crops)
        trees = [os.path.join(run, comp) for comp in digests]
        nbytes = sum(t.numel() * t.element_size() for tree in trees
                     for t in ckpt.read_tree(tree).values())
        frames = 0
        for tree in trees:
            store = OcdbtStore(tree)
            for name in {k.rsplit("/", 1)[0] for k in store.keys()
                         if k.endswith("/.zarray")}:
                arr = zarr.parse_zarray(name, store.read(f"{name}/.zarray"))
                frames += arr.zstd * sum(arr.chunk_key(i) in store
                                         for i in arr.grid())
        t0 = time.perf_counter()
        for _ in range(JAX_CKPT_ROUNDS):
            for tree in trees:
                ckpt.read_tree(tree)
        dec_s = (time.perf_counter() - t0) / JAX_CKPT_ROUNDS
        mbs = nbytes / dec_s / 1e6

        # load_pipeline / load_ema on the card against the digests
        loads = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models, cfg = ckpt.load_pipeline(run, device="cuda",
                                             use_ema=False)
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t0)
        for comp, module in models.items():
            if next(module.parameters()).device.type != "cuda":
                fail(f"jax-ckpt: {comp} not on the card")
            _digest_check({plain(k): t for k, t in ckpt.module_tree(module)
                           if not isinstance(t, str)}, digests[comp], comp)
        ema = ckpt.load_ema(run, device="cuda", cfg=cfg)
        _digest_check({plain(((c, False),) + k): t for c, m in ema.items()
                       for k, t in ckpt.module_tree(m)
                       if not isinstance(t, str)}, digests["ema"], "ema")
        del models, ema
        print(f"[jax-ckpt] {smi}: read_tree of {len(trees)} trees, "
              f"{frames} zstd chunks, {nbytes} bytes decoded in "
              f"{dec_s * 1e3:.3f} ms a round "
              f"({mbs:.1f} MB/s, {JAX_CKPT_ROUNDS} rounds, "
              f"{os.cpu_count()} host cores); load_pipeline(device=cuda) "
              f"{' '.join(f'{x:.4f}' for x in loads)} s (first, repeats; "
              f"decoder build {build_s:.2f} s); every leaf of "
              f"{sorted(digests)} equal to the JAX tree's digests",
              flush=True)

        # cli.inference --ckpt: DDIM-4 from the JAX checkpoint
        images = []
        real = SDPipeline.generate

        def generate(self, *a, **kw):
            out = real(self, *a, **kw)
            images.append(np.asarray(out))
            return out

        img = 32
        argv = ["--ckpt", run, "--mode", "enter_prompt", "--prompt",
                JAX_CKPT_PROMPT, "--img_size", str(img),
                "--num_inference_steps", "4", "--scheduler", "ddim",
                "--seed", "0", "--save_dir", os.path.join(root, "images")]
        SDPipeline.generate = generate
        try:
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = dict(_kernels.launches)
        finally:
            SDPipeline.generate = real
        want = dict.fromkeys(_kernels.launches, 0)
        want.update(family_launches(
            cfg, img // 2 ** (len(cfg.vae.block_out_channels) - 1), 1, 4))
        # the one decode: the VAE's single-head mid attention (16 wide,
        # 16² tokens) takes the training flash kernel, as on the tiny paths
        want["flash_fwd"] = int(cfg.vae.block_out_channels[-1] <= 256)
        pngs = [os.path.join(d, f) for d, _, fs in os.walk(
            os.path.join(root, "images")) for f in fs if f.endswith(".png")]
        with open(pngs[0], "rb") as f:
            shape = png.decode(f.read()).shape
        finite = bool(images) and all(np.isfinite(x).all() for x in images)
        print(f"[jax-ckpt] cli.inference --ckpt (the JAX run's checkpoint) "
              f"{img}^2 DDIM-4: {secs:.3f} s, image {shape} finite "
              f"{finite}, launches {nonzero(counts)} (expected "
              f"{nonzero(want)})", flush=True)
        if not finite or shape != (img, img, 3) or counts != want \
                or min(want["flash_fixed"], want["geglu_ff"]) == 0:
            fail(f"jax-ckpt cli.inference: launches {counts} (expected "
                 f"{want}), image {shape}, finite {finite}")
        paths["jax-ckpt cli.inference"] = counts

        # cli.finetune --resume: one step from the JAX run
        data = ft_dataset(os.path.join(root, "ds"), 2, img)
        flags = ["--data_root", data, "--output_dir",
                 os.path.join(root, "out"), "--run_id", "jax", "--resume",
                 "--device", "cuda", "--img_size", str(img),
                 "--num_examples", "2", "--batch_size",
                 "2", "--grad_acc_steps", "1", "--epochs", str(step + 1),
                 "--ckpts_per_epoch", "1", "--num_workers", "1",
                 "--learning_rate", str(train["learning_rate"]),
                 "--ema_decay", str(train["ema_decay"]), "--use_8bit_adam",
                 "--no-train_unet", "--train_text_encoder"]
        _kernels.reset_launch_counts()
        with ft_capture() as seen:
            stats = finetune.main(flags)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        first = seen["first_trees"]
        for name in ("opt_state", "text_encoder", "ema"):
            _digest_check({".".join(k): t for k, t in first[name].items()},
                          digests[name], f"resumed {name}")
        losses = stats["losses"]
        print(f"[jax-ckpt] cli.finetune --resume from the JAX run: the first "
              f"step sees step {seen['first_step']} (metadata {step}), "
              f"optimizer count {seen['first_count']}, the 8-bit codes and "
              f"scales, fp32 moments, text encoder and EMA equal to the "
              f"digests; loss {losses}, load {stats['load_s']:.3f} s, "
              f"launches {nonzero(counts)}", flush=True)
        if seen["first_step"] != step or len(losses) != 1 \
                or not np.isfinite(losses[0]) or counts["adam8"] != 1 \
                or min(counts["flash_fwd"], counts["flash_bwd_dq"],
                       counts["flash_bwd_dkv"]) == 0:
            fail(f"jax-ckpt resume: step {seen['first_step']} (expected "
                 f"{step}), losses {losses}, launches {nonzero(counts)}")
        paths["jax-ckpt cli.finetune --resume"] = counts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


def phase_finetune(smi: str, train_sps: dict):
    """The finetune CLI at full width, mode C (random SD-1.5 from seed 0,
    bf16, UNet + text encoder, 8-bit AdamW, micro 2, grad_accum 4, remat
    "block" by the CLI's default) on 16 PNG covers at 512²: --epochs 1
    (2 steps and a checkpoint), then --resume --epochs 2 (2 more).  Exact
    K5/K6a/K6b/K7 launches every step, finite losses, the resumed step;
    s/step (median after each run's warm-up step) beside the train
    phases', the loader's blocked ms a step, peak memory, checkpoint bytes
    and save / load seconds.  Returns the launches of the 4 steps."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import finetune
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig

    cfg = PipelineConfig.sd15()
    root = tempfile.mkdtemp(prefix="sdbc_ft_")
    try:
        need = 2 * ckpt_bytes_estimate(cfg) + (1 << 30)
        free = shutil.disk_usage(root).free
        if free < need:
            fail(f"finetune: {root} has {free / 1e9:.2f} GB free, the phase "
                 f"writes two checkpoints and a dataset of "
                 f"{need / 1e9:.2f} GB: {(need - free) / 1e9:.2f} GB short")
        data = ft_dataset(os.path.join(root, "ds"), 16, 512)
        out = os.path.join(root, "out")
        argv = FT_FULL + ["--device", "cuda", "--data_root", data,
                          "--output_dir", out]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with ft_capture(trees=False) as seen1:
            s1 = finetune.main(argv + ["--epochs", "1"])
        peaks = [torch.cuda.max_memory_allocated()]
        del seen1["last"]  # the first run's state, before the second's
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with ft_capture(trees=False) as seen2:
            s2 = finetune.main(argv + ["--epochs", "2", "--resume"])
        wall = time.perf_counter() - t0
        peaks.append(torch.cuda.max_memory_allocated())
        peak = max(peaks)
        n8 = _n8(seen2["last"])
        tcfg = _train_cfg(grad_accum=4, micro_batch=2, grad_ckpt=True,
                          remat_mode="block")
        want = expected_train_launches(cfg, tcfg, 512, n8)
        steps = seen1["launches"] + seen2["launches"]
        losses = s1["losses"] + s2["losses"]
        times = s1["step_s"][1:] + s2["step_s"][1:]
        sps = statistics.median(times)
        waits = [1e3 * w for w in s1["loader_wait_s"][1:]
                 + s2["loader_wait_s"][1:]]
        saves = s1["saves"] + s2["saves"]
        total = dict.fromkeys(steps[0], 0)
        for c in steps:
            for k, v in c.items():
                total[k] += v
        print(f"[finetune] cli.finetune mode C SD-1.5 512^2 micro 2 grad_accum "
              f"4 8-bit AdamW remat block (CLI default), 16 PNG covers: "
              f"{len(steps)} steps in two runs (--resume), {sps:.4f} s/step "
              f"(median of {times}; run warm-up steps {s1['step_s'][0]:.3f}, "
              f"{s2['step_s'][0]:.3f}); train phase {train_sps['none']:.4f}, "
              f"train-ckpt block {train_sps['block']:.4f} s/step; loader "
              f"blocked {statistics.mean(waits):.3f} ms a step (max "
              f"{max(waits):.3f}; first batch {1e3 * s1['loader_wait_s'][0]:.1f}"
              f" ms); peak {peak / 2 ** 30:.2f} GiB (runs "
              f"{[round(p / 2 ** 30, 2) for p in peaks]}); losses "
              f"{[round(x, 6) for x in losses]}; {wall:.1f} s for both runs"
              f" | {smi}", flush=True)
        print(f"[finetune] checkpoints: "
              + "; ".join(f"{os.path.basename(v['path'])} {v['bytes'] / 1e9:.3f}"
                          f" GB in {v['seconds']:.2f} s ({v['bytes'] / 1e9 / v['seconds']:.2f}"
                          f" GB/s)" if v["bytes"] else
                          f"{os.path.basename(v['path'])} final: metadata only"
                          f" ({v['seconds']:.3f} s)" for v in saves)
              + f"; resume load {s2['load_s']:.2f} s "
              f"({saves[0]['bytes'] / 1e9 / s2['load_s']:.2f} GB/s of the "
              f"trees); launches a step {[nonzero(c) for c in steps]} "
              f"(expected {nonzero(want)}, {n8} 8-bit leaves) | {smi}",
              flush=True)
        if not all(np.isfinite(x) for x in losses) or len(losses) != 4:
            fail(f"finetune: losses {losses}")
        if (seen2["first_step"], seen2["first_count"]) != (2, 2):
            fail(f"finetune --resume started at step {seen2['first_step']}, "
                 f"optimizer count {seen2['first_count']}")
        if any(c != want for c in steps):
            fail(f"finetune launches {steps}, expected {want} a step")
        if want["flash_fwd"] != 120 or want["adam8"] != 1:
            fail(f"mode C with remat block implies {want}, not 120 / 60 / 60 "
                 f"/ 1")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"finetune": total}


# ---------------------------------------------------------------------------
# families-train: training the SD-2.x and SDXL families

# the tiny card-vs-CPU steps (``phase_train_parity``): (label, config,
# image side, train config overrides); the SDXL configs at 64² (256
# tokens at their first attention level)
FAMILY_TRAIN_TINY = [
    ("sd21", "sd21", 32, {}),
    ("sdxl", "tiny_xl", 64, {}),
    ("refiner", "tiny_xl_refiner", 64, {}),
    ("sdxl lora", "tiny_xl", 64, dict(lora_rank=2, lora_alpha=4.0)),
    ("sdxl ti", "tiny_xl", 64, dict(ti_token="<sty>", ti_vectors=2,
                                    train_unet=False,
                                    train_text_encoder=False))]
# the full-width steps: (label, family, image side, micro-batch,
# grad_accum); fp32 masters of the UNet and every text encoder, bf16
# compute, 8-bit AdamW, remat "block"
FAMILY_TRAIN_FULL = [("sdxl 1024^2", "sdxl", 1024, 1, 2),
                     ("sd21 768^2", "sd21", 768, 2, 4)]
# the finetune CLI on SDXL: 1024² covers, micro-batch 1, grad_accum 2, 4
# examples make 2 steps and a checkpoint
FT_SDXL = ["--model_family", "sdxl", "--train_unet", "--train_text_encoder",
           "--use_8bit_adam", "--batch_size", "1", "--grad_acc_steps", "2",
           "--img_size", "1024", "--num_examples", "4", "--ckpts_per_epoch",
           "1", "--epochs", "1", "--seed", "0"]


def family_cfg(name: str):
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig

    if name in ("sd21", "sdxl"):
        return PipelineConfig.family(name, tiny=False)
    if name == "sd21 tiny":
        return PipelineConfig.family("sd21", tiny=True)
    return getattr(PipelineConfig, name)()


def family_train_full(label: str, cfg, img: int, micro: int, accum: int,
                      smi: str, steps: int = 3):
    """One family's training at full width (random init from seed 0 on the
    card): a warm-up step, ``steps`` timed ones with finite losses, moved
    parameters and exact launches, then a profiled step.  Returns
    (launches of the timed steps, median s/step, peak bytes, state)."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train.trainer import (init_train_state,
                                              make_train_step,
                                              trainable_params)

    tcfg = _family_tcfg(cfg, grad_accum=accum, micro_batch=micro,
                        num_examples=1000, grad_ckpt=True,
                        remat_mode="block")
    gen = torch.Generator(device="cuda").manual_seed(0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(init_models(cfg, device="cuda", generator=gen),
                             tcfg)
    step = make_train_step(cfg, tcfg)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in _train_batch(
        cfg, accum, micro, img, np.random.default_rng(5)).items()}
    params = trainable_params(state.trainable)
    watch = [params[0], params[len(params) // 2], params[-1]]
    start = [p.detach().clone() for p in watch]
    n_train = sum(p.numel() for p in params)
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
            fail(f"families-train {label}: step skipped (non-finite "
                 f"gradients), loss {m['loss']}")
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    n8 = _n8(state)
    want = {k: steps * v for k, v in expected_train_launches(
        cfg, tcfg, img, n8).items()}
    moved = [float((p.detach() - s0).abs().max())
             for p, s0 in zip(watch, start)]
    del start
    sps = statistics.median(times)
    print(f"[families-train] {label} ({'v-prediction' if cfg.schedule.prediction_type == 'v_prediction' else 'eps'}) micro {micro} grad_accum {accum}, "
          f"{', '.join(tcfg.trainable_keys())} trained ({n_train / 1e9:.3f} B "
          f"fp32 masters), bf16 compute, 8-bit AdamW ({n8} 8-bit leaves), "
          f"remat block: {sps:.4f} s/step (median of {steps}: "
          f"{[round(t, 4) for t in times]}), {micro * accum / sps:.4f} "
          f"images/s, warm-up {warm:.3f} s, peak {peak / 2 ** 30:.2f} GiB, "
          f"losses {[round(x, 6) for x in losses]}, params moved {moved}, "
          f"launches {nonzero(counts)} (expected {nonzero(want)}) | {smi}",
          flush=True)
    if not all(np.isfinite(x) for x in losses):
        fail(f"families-train {label}: losses not finite: {losses}")
    if not all(x > 0 for x in moved):
        fail(f"families-train {label}: parameters did not move: {moved}")
    if counts != want:
        fail(f"families-train {label}: launch counts {counts}, expected "
             f"{want}")
    phase_train_profile(step, state, batch, gen, sps,
                        f"families-train {label}")
    return counts, sps, peak, state


def kernel_adam8_family(state, label: str):
    """K7 over a trained state's 8-bit leaves at their real sizes (the
    stacked ones as their parts) with random gradients, in one launch:
    the kernel alone on a table built once, against the step's bytes
    bound; held against the plain version on the largest leaf and every
    16th other one (copies taken before the launch)."""
    import torch

    from sdbc_tpu_torch.train import adam8bit
    from sdbc_tpu_torch.train.trainer import optimizer_leaves

    g = torch.Generator(device="cuda").manual_seed(9)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    leaves = [(leaf, st) for leaf, st in zip(
        optimizer_leaves(state.trainable), state.opt_state.inner.per_leaf)
        if isinstance(st, adam8bit.Quant8State)]
    with torch.no_grad():
        grads = [[torch.randn(p.shape, generator=g, device="cuda") * 1e-3
                  for p in leaf] for leaf, _ in leaves]
    sizes = [sum(p.numel() for p in leaf) for leaf, _ in leaves]
    big = max(range(len(leaves)), key=sizes.__getitem__)
    held = sorted({big} | set(range(0, len(leaves), 16)))
    stack = lambda ts: ts[0].clone() if len(ts) == 1 else torch.stack(ts)
    step = state.opt_state.inner.count + 1
    ref = {i: (stack(leaves[i][0]), adam8bit.Quant8State(*(
        t.clone() for t in (leaves[i][1].mq, leaves[i][1].ms,
                            leaves[i][1].vq, leaves[i][1].vs))))
           for i in held}
    table = [(leaf, gr, st) for (leaf, st), gr in zip(leaves, grads)]
    with torch.no_grad():
        adam8bit.adam8_update_leaves(table, 1e-4, step, **kw)
        torch.cuda.synchronize()
        perr = serr = 0.0
        qmax = qoff = qn = 0
        for i, (p0, s0) in ref.items():
            leaf, st = leaves[i]
            adam8bit.adam8_update_ref(p0, stack(grads[i]), s0, 1e-4, step,
                                      **kw)
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
        rows = adam8bit.leaf_table(table)[1]
        ms = median_ms(adam8_launch(table, step + 1), 10)
    n_el = sum(sizes)
    bms, by = adam8_bound(n_el, rows)
    qshare = qoff / qn
    stacked = sum(len(leaf) > 1 for leaf, _ in leaves)
    print(f"[families-train] adam8 over the {label} step's {len(leaves)} "
          f"8-bit leaves ({stacked} stacked; the largest "
          f"{sizes[big]} elements), {n_el} elements in {rows} rows: held "
          f"{len(held)} leaves, p err {perr:.3e}, int8 off-by-one share "
          f"{qshare:.2e} (max {qmax}), scale rel err {serr:.2e}; one launch "
          f"{ms:.4f} ms, bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of "
          f"it ({16.0 * n_el / ms / 1e6:.1f} GB/s)", flush=True)
    if not (perr <= ADAM_P_TOL and qmax <= 1 and qshare <= ADAM_Q_SHARE
            and serr <= 1e-5):
        fail(f"adam8 {label}: p err {perr}, int8 off-by-one share {qshare} "
             f"(max {qmax}), scale rel err {serr}")
    del table, grads, leaves
    return dict(leaves=len(sizes), stacked=stacked, elements=n_el,
                rows=rows, largest=sizes[big], ms=ms, bound_ms=bms,
                bound_by=by, p_err=perr, int8_share=qshare)


def family_cli_tiny():
    """``cli.finetune --tiny --model_family sdxl`` on the card (UNet and
    both encoders, 8-bit AdamW, EMA, remat "block" by default) at 64²:
    one epoch of 2 steps with exact launches, then --resume for a second
    whose first step sees the checkpoint and the first run's last state
    bit for bit.  Returns the run's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import finetune
    from sdbc_tpu_torch.ops import _kernels

    cfg = family_cfg("tiny_xl")
    root = tempfile.mkdtemp(prefix="sdbc_ft_xl_tiny_")
    try:
        data = ft_dataset(os.path.join(root, "ds"), 8, 64)
        out = os.path.join(root, "out")
        argv = ["--tiny", "--model_family", "sdxl", "--device", "cuda",
                "--data_root", data, "--output_dir", out, "--img_size", "64",
                "--num_examples", "8", "--batch_size", "2",
                "--grad_acc_steps", "2", "--ckpts_per_epoch", "1",
                "--num_workers", "2", "--learning_rate", str(FT_LR),
                "--train_unet", "--use_8bit_adam", "--ema_decay", "0.9"]
        _kernels.reset_launch_counts()
        with ft_capture() as seen:
            stats = finetune.main(argv + ["--epochs", "1"])
        counts = dict(_kernels.launches)
        want = expected_train_launches(
            cfg, _family_tcfg(cfg, grad_accum=2, micro_batch=2,
                              grad_ckpt=True, remat_mode="block"),
            64, _n8(seen["last"]))
        last = ft_trees(seen["last"])
        with ft_capture() as again:
            finetune.main(argv + ["--epochs", "2", "--resume"])
        print(f"[families-train] cli.finetune --tiny --model_family sdxl 64^2 "
              f"on the card: losses {[round(x, 6) for x in stats['losses']]}"
              f", launches a step {[nonzero(c) for c in seen['launches']]} "
              f"(expected {nonzero(want)}); --resume: step "
              f"{again['first_step']}, optimizer count "
              f"{again['first_count']}, {sum(map(len, last.values()))} "
              f"tensors of {sorted(last)} compared", flush=True)
        if not all(np.isfinite(x) for x in stats["losses"]):
            fail(f"families-train tiny CLI: losses {stats['losses']}")
        if any(c != want for c in seen["launches"]):
            fail(f"families-train tiny CLI: launches {seen['launches']}, "
                 f"expected {want} a step")
        if (again["first_step"], again["first_count"]) != (2, 2):
            fail(f"families-train tiny CLI --resume: step "
                 f"{again['first_step']}, count {again['first_count']}")
        for name, tree in again["first_trees"].items():
            ft_bits(tree, last[name], f"sdxl resume {name} vs the run")
            ft_bits(tree, {k: t.cpu() for k, t in
                           ft_disk(stats["final"], name).items()},
                    f"sdxl resume {name} vs the checkpoint")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


def family_cli_full(smi: str):
    """``cli.finetune --model_family sdxl`` at full width (random weights
    from seed 0, bf16 compute, UNet and both encoders, 8-bit AdamW, remat
    "block" by the CLI's default) on 4 PNG covers at 1024²: 2 steps with
    exact launches and a checkpoint; s/step, the loader's blocked ms, peak
    memory, checkpoint bytes and save seconds.  Returns the launches of
    the 2 steps."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import finetune

    cfg = family_cfg("sdxl")
    root = tempfile.mkdtemp(prefix="sdbc_ft_xl_")
    try:
        need = ckpt_bytes_estimate(cfg) + (1 << 30)
        free = shutil.disk_usage(root).free
        if free < need:
            fail(f"families-train: {root} has {free / 1e9:.2f} GB free, the "
                 f"SDXL checkpoint and covers take {need / 1e9:.2f} GB")
        t0 = time.perf_counter()
        data = ft_dataset(os.path.join(root, "ds"), 4, 1024)
        data_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with ft_capture(trees=False) as seen:
            stats = finetune.main(FT_SDXL + [
                "--device", "cuda", "--data_root", data, "--output_dir",
                os.path.join(root, "out")])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        tcfg = _family_tcfg(cfg, grad_accum=2, micro_batch=1,
                            grad_ckpt=True, remat_mode="block")
        want = expected_train_launches(cfg, tcfg, 1024, _n8(seen["last"]))
        del seen["last"]
        steps = seen["launches"]
        losses = stats["losses"]
        waits = [1e3 * w for w in stats["loader_wait_s"]]
        saves = stats["saves"]
        total = dict.fromkeys(steps[0], 0)
        for c in steps:
            for k, v in c.items():
                total[k] += v
        print(f"[families-train] cli.finetune --model_family sdxl 1024^2 "
              f"micro 1 grad_accum 2, UNet + both encoders, 8-bit AdamW, "
              f"remat block (CLI default), 4 PNG covers (written in "
              f"{data_s:.1f} s): steps {[round(t, 4) for t in stats['step_s']]}"
              f" s (the first with the warm-up), loader blocked "
              f"{[round(w, 3) for w in waits]} ms a step, peak "
              f"{peak / 2 ** 30:.2f} GiB, losses "
              f"{[round(x, 6) for x in losses]}, {wall:.1f} s in all; "
              f"checkpoints: "
              + "; ".join(f"{os.path.basename(v['path'])} "
                          f"{v['bytes'] / 1e9:.3f} GB in {v['seconds']:.2f} "
                          f"s ({v['bytes'] / 1e9 / v['seconds']:.2f} GB/s)"
                          if v["bytes"] else
                          f"{os.path.basename(v['path'])} final: metadata "
                          f"only ({v['seconds']:.3f} s)" for v in saves)
              + f"; launches a step {[nonzero(c) for c in steps]} (expected "
              f"{nonzero(want)}) | {smi}", flush=True)
        if len(losses) != 2 or not all(np.isfinite(x) for x in losses):
            fail(f"families-train CLI: losses {losses}")
        if any(c != want for c in steps):
            fail(f"families-train CLI: launches {steps}, expected {want}")
        if not saves or not saves[0]["bytes"] or not os.path.exists(
                os.path.join(stats["final"], "text_encoder_2")):
            fail(f"families-train CLI: no checkpoint saved ({saves})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


def phase_families_train(smi: str) -> dict:
    """Training the SD-2.x and SDXL families on the card: the tiny steps
    (``FAMILY_TRAIN_TINY``) bf16 and fp32 on the card against fp32 on the
    CPU; SDXL base 1024² and SD-2.1 768² (v-prediction) at full width
    (``FAMILY_TRAIN_FULL``), with K7 over the SDXL step's 8-bit leaves;
    the finetune CLI on tiny SDXL with a --resume, and on SDXL at 1024²
    with its checkpoint.  Returns the launch counts by path and K7's
    reading."""
    import torch

    t_phase = time.perf_counter()
    paths = {}
    for label, name, img, kw in FAMILY_TRAIN_TINY:
        cfg = family_cfg("sd21 tiny" if name == "sd21" else name)
        counts = phase_train_parity(
            f"families {label}", card_dtypes=(torch.bfloat16, torch.float32),
            cfg=cfg, img=img, grad_rtol=FAMILY_GRAD_RTOL, **kw)
        paths[f"families-train {label} (tiny)"] = counts[torch.bfloat16]
        paths[f"families-train {label} fp32 (tiny)"] = counts[torch.float32]
    paths["families-train cli sdxl (tiny)"] = family_cli_tiny()
    adam8 = None
    for label, name, img, micro, accum in FAMILY_TRAIN_FULL:
        counts, _, _, state = family_train_full(
            label, family_cfg(name), img, micro, accum, smi)
        paths[f"families-train {label}"] = counts
        if name == "sdxl":
            adam8 = kernel_adam8_family(state, label)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    paths["families-train cli sdxl 1024^2"] = family_cli_full(smi)
    torch.cuda.empty_cache()
    print(f"[families-train] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, adam8


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


# the serve phase: the daemon's requests, then the image checks.  Card fp32
# (TF32 off) against CPU fp32 on the same images and weights, ViT-L/14 at
# 224² (24 layers) and CLIP-L's text tower (12 layers): both sides sum in
# other orders, ~1e-6 of a unit vector per layer; the safety checker's
# concept and special-care scores (cosines minus thresholds) within 1e-4,
# the CLIPScore cosines within 1e-4 (TF32 would move them by ~1e-3).  Set
# before the phase's first chip reading.
SAFETY_TOL = 1e-4
CLIPSCORE_TOL = 1e-4
SERVE_WINDOW_MS = 250
SERVE_MAX_PENDING = 5


def _serve_adapter(cfg, path: str) -> None:
    """A rank-4 LoRA adapter on the UNet and the text encoder of ``cfg``
    (shapes from a meta-device model), with a nonzero b, written by the
    port's ``save_lora`` (scale α/r = 1)."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import init_models
    from sdbc_tpu_torch.train import lora as lora_mod

    shapes = init_models(cfg, device="meta", generator=None)
    gen = torch.Generator().manual_seed(1)
    lora = lora_mod.init_lora(gen, shapes, 4,
                              components=("unet", "text_encoder"))
    for v in lora.values():
        v["b"] = torch.randn(v["b"].shape, generator=gen) * 0.1
    lora_mod.save_lora(path, lora, 4, 4.0)


def phase_serve(smi: str):
    """``cli.serve`` at full width, as its ``main`` builds it: parsed
    arguments (random SD-1.5 from --seed, bf16, 512², the CLI's serving
    profile dpm-25, --max_batch 4, --lora_bank with one adapter written by
    ``save_lora``), ``load_pipelines``, ``warmup``, ``make_app`` on a
    ``ThreadingHTTPServer`` at an ephemeral port, and a ``urllib`` client:
    /healthz; a lone request equal to ``SDPipeline.generate`` in uint8
    pixels; four requests inside the batch window in one batch of 4; a
    LoRA request (unlike the base, equal to the merged pipeline's direct
    call); a per-request DDIM-10; img2img at strength 0.6 from a PNG of
    ``utils/png.py``; 400, 404 and 503 refusals; /healthz with its
    percentiles.  Each generating request with exact K1/K4 launches.
    Returns (launch counts by path, the lone request's generate call's
    images for the image checks: 4 prompts at bucket 4)."""
    import base64
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import common, serve
    from sdbc_tpu_torch.diffusion.pipeline import img2img_t_start
    from sdbc_tpu_torch.diffusion.spec import SampleSpec
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils import png

    tmp = tempfile.TemporaryDirectory()
    adapter = os.path.join(tmp.name, "style.npz")
    argv = ["--scheduler", "dpm", "--num_inference_steps", "25", "--seed",
            "0", "--max_batch", "4", "--lora_bank", f"style={adapter}",
            "--batch_window_ms", str(SERVE_WINDOW_MS), "--max_pending",
            str(SERVE_MAX_PENDING)]
    args = serve.build_parser().parse_args(argv)
    common.refuse_unported(args)
    common.resolve_img_size(args)
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig

    _serve_adapter(PipelineConfig.sd15("dpm"), adapter)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe, lora_pipes = serve.load_pipelines(args)
    setup = time.perf_counter() - t0
    serve.warmup(pipe, args)
    cfg = pipe.cfg
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    copy_bytes = serve.model_bytes(lora_pipes["style"].models,
                                   ["unet", "text_encoder"])
    print(f"[serve] load_pipelines (random SD-1.5 bf16 + one LoRA copy) "
          f"{setup:.3f} s; device memory held {held / 2 ** 30:.2f} GiB "
          f"(the adapter's copy {copy_bytes / 2 ** 30:.2f} GiB), peak "
          f"{peak / 2 ** 30:.2f} GiB | {smi}", flush=True)
    handler, state = serve.make_app(pipe, args, lora_pipes=lora_pipes)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(payload):
        req = urllib.request.Request(url + "/generate",
                                     data=json.dumps(payload).encode())
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                body, code = r.read(), r.status
        except urllib.error.HTTPError as e:
            body, code = e.read(), e.code
        return code, body, time.perf_counter() - t

    def image(payload):
        code, body, secs = post(payload)
        if code != 200 or body[:8] != png.SIGNATURE:
            fail(f"serve {payload.get('prompt')!r}: HTTP {code} "
                 f"{body[:300]!r}")
        return png.decode(body), secs

    def healthz():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    def u8(x):
        return np.uint8(np.round(x * 255.0))

    spec = SampleSpec(height=512, width=512, num_inference_steps=25,
                      guidance_scale=7.5)
    paths = {}

    def counted(label, want, fn):
        """fn() with the launch counts set to 0 just before and read just
        after; they must be ``want``."""
        _kernels.reset_launch_counts()
        out = fn()
        counts = dict(_kernels.launches)
        if counts != want or want["flash_fixed"] == 0:
            fail(f"serve {label}: launch counts {counts}, expected {want}")
        paths[f"serve {label}"] = counts
        return out

    try:
        h0 = healthz()
        if not h0["ok"] or h0["lora_adapters"] != ["style"]:
            fail(f"serve /healthz {h0}")
        one = generate_launches(cfg, 1, 25, 512)
        lone, lone_s = counted("lone", one, lambda: image(
            {"prompt": PROMPTS[0], "seed": 11}))
        direct = u8(pipe.generate([PROMPTS[0]], spec.replace(seed=11)))[0]
        lone_diff = int(np.abs(lone.astype(np.int16) - direct).max())

        b0, i0 = state["batches"], state["batched_images"]
        four = {}

        def hit(i):
            four[i] = image({"prompt": PROMPTS[i], "seed": 100 + i})

        def together():
            threads = [threading.Thread(target=hit, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return [four[i] for i in range(4)]

        got4 = counted("coalesced 4", generate_launches(cfg, 4, 25, 512),
                       together)
        batches = (state["batches"] - b0, state["batched_images"] - i0)
        distinct = len({bytes(img) for img, _ in got4})

        (styled, lora_s) = counted("lora", one, lambda: image(
            {"prompt": PROMPTS[0], "seed": 11, "lora": "style"}))
        styled_direct = u8(lora_pipes["style"].generate(
            [PROMPTS[0]], spec.replace(seed=11)))[0]
        lora_diff = int(np.abs(styled.astype(np.int16)
                               - styled_direct).max())
        lora_vs_base = float(np.abs(styled.astype(np.int16)
                                    - lone).mean())

        ddim, ddim_s = counted(
            "scheduler ddim-10", generate_launches(cfg, 1, 10, 512, "ddim"),
            lambda: image({"prompt": PROMPTS[1], "seed": 12,
                           "scheduler": "ddim", "num_inference_steps": 10}))

        yy, xx = np.meshgrid(np.linspace(0, 1, 512), np.linspace(0, 1, 512),
                             indexing="ij")
        init = u8(np.stack([yy, xx, 0.5 * (yy + xx)], -1))
        t_start = img2img_t_start(25, 0.6, cfg.schedule.steps_offset)
        i2i, i2i_s = counted(
            "img2img 0.6", sampler_launches(cfg, 64, 1, sampler_evals(
                "dpm", 25, t_start=t_start)),
            lambda: image({"prompt": PROMPTS[2], "seed": 13,
                           "strength": 0.6, "init_image": base64.b64encode(
                               png.encode(init)).decode()}))

        bad = post({"prompt": "x", "size": 500})[0]
        try:
            urllib.request.urlopen(url + "/nope", timeout=60)
            missing = 200
        except urllib.error.HTTPError as e:
            missing = e.code
        codes = {}

        def flood(i):
            codes[i] = post({"prompt": "load", "seed": i,
                             "num_inference_steps": 2})[0]

        threads = [threading.Thread(target=flood, args=(i,))
                   for i in range(SERVE_MAX_PENDING + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        h1 = healthz()
    finally:
        srv.shutdown()
        srv.server_close()
        handler.close()
        thread.join(timeout=30)
    walls = {"lone": lone_s, "coalesced 4 (each)":
             [round(s, 3) for _, s in got4], "lora": lora_s,
             "ddim-10": ddim_s, "img2img 0.6": i2i_s}
    print(f"[serve] requests' wall time (s, each with the "
          f"{SERVE_WINDOW_MS} ms batch window): "
          f"{json.dumps(walls, default=lambda v: round(v, 3))}; the four "
          f"in {batches[0]} batch(es) of {batches[1]} images, {distinct} "
          f"distinct; lone vs SDPipeline.generate max |diff| {lone_diff} "
          f"(uint8); lora vs its merged pipeline {lora_diff}, vs base mean "
          f"|diff| {lora_vs_base:.2f}; refusals: size {bad}, path "
          f"{missing}, flood {sorted(codes.values())}; /healthz p50 "
          f"{h1['latency_p50_s']} s p95 {h1['latency_p95_s']} s over "
          f"{h1['requests']} requests, {h1['errors']} errors, "
          f"rejected_overload {h1['rejected_overload']}; launches "
          f"{ {k: (v['flash_fixed'], v['geglu_ff']) for k, v in paths.items()} } "
          f"| {smi}", flush=True)
    if lone_diff or lora_diff:
        fail(f"serve: a lone request differs from SDPipeline.generate by "
             f"{lone_diff}, the lora one from its merged pipeline by "
             f"{lora_diff} (uint8)")
    if batches != (1, 4) or distinct != 4:
        fail(f"serve: four requests made {batches} (batches, images), "
             f"{distinct} distinct images")
    if not lora_vs_base > 0.5:
        fail(f"serve: the adapter moved the image by {lora_vs_base}")
    for label, img in (("ddim", ddim), ("img2img", i2i)):
        if img.shape != (512, 512, 3):
            fail(f"serve {label}: image {img.shape}")
    flood_codes = sorted(codes.values())
    if (bad, missing) != (400, 404) or flood_codes != \
            [200] * SERVE_MAX_PENDING + [503] or \
            h1["rejected_overload"] != 1 or h1["pending_jobs"] != 0 or \
            h1["latency_p50_s"] is None or \
            not h1["latency_p95_s"] >= h1["latency_p50_s"]:
        fail(f"serve refusals: size {bad}, path {missing}, flood "
             f"{flood_codes}; /healthz {h1}")
    del pipe, lora_pipes, handler
    tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _safety_embeddings(model, images):
    """The checker's unit image embeddings (``ClipSafetyChecker.scores``'s
    ``emb``) of ``images`` on ``model``'s device."""
    import torch

    from sdbc_tpu_torch.models import clip as clip_mod
    from sdbc_tpu_torch.models.safety import clip_preprocess
    from sdbc_tpu_torch.utils.dtypes import fp32_exact

    dev = model.concept_embeds.device
    with torch.inference_mode(), fp32_exact():
        x = clip_preprocess(images, model.vision.cfg.image_size, dev)
        _, pooled = clip_mod.vision_apply(model.vision, x)
        e = model.visual_projection(pooled)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def phase_image_checks(smi: str):
    """The image checks at full width in fp32 (TF32 off): the safety
    checker (``CLIPVisionConfig.sd_safety``: ViT-L/14 at 224², 17 concepts,
    3 special-care ones; random weights from seed 3, except concept 0 =
    image 0's own projected embedding, its threshold halfway between 1 and
    the next image's cosine to it, the other thresholds 1.5) through
    ``SDPipeline(safety_checker=...)`` on 4 generated images (dpm-25,
    512²): card scores against the CPU's (``SAFETY_TOL``), exactly image 0
    flagged and blacked out, the others as the checker got them, the
    generate call's K1/K4 launches unchanged; then ``ClipScorer`` at
    clip-vit-large-patch14's widths (text 768 with a 768 projection,
    ViT-L/14) on 2 of them, cosines card vs CPU (``CLIPSCORE_TOL``); each
    tower's ms per batch of 4.  Returns the launch counts by path."""
    import dataclasses

    import numpy as np
    import torch

    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig,
                                                   SDPipeline, init_models)
    from sdbc_tpu_torch.diffusion.spec import SampleSpec
    from sdbc_tpu_torch.eval.clip_score import ClipModel, ClipScorer
    from sdbc_tpu_torch.models import clip as clip_mod
    from sdbc_tpu_torch.models.safety import ClipSafetyChecker, SafetyModel
    from sdbc_tpu_torch.ops import _kernels

    cfg = PipelineConfig.sd15("dpm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = init_models(cfg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
    spec = SampleSpec(height=512, width=512, num_inference_steps=25,
                      seed=21)
    vcfg = clip_mod.CLIPVisionConfig.sd_safety()
    cpu = SafetyModel(vcfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    # the images the checker will see: an unchecked call of the same spec
    plain = SDPipeline(models, cfg, _tokenizer(cfg), "cuda",
                       torch.bfloat16).generate(PROMPTS, spec)
    emb = _safety_embeddings(cpu, plain)
    cos0 = (emb @ emb[0]).tolist()
    gap = 1.0 - max(cos0[1:])
    with torch.no_grad():
        cpu.concept_embeds[0] = emb[0]
        cpu.concept_weights.fill_(1.5)
        cpu.concept_weights[0] = 1.0 - gap / 2
        cpu.special_care_weights.fill_(1.5)
    card_model = copy.deepcopy(cpu).cuda()
    checker = ClipSafetyChecker(card_model, vcfg)
    cpu_checker = ClipSafetyChecker(cpu, vcfg, device="cpu")
    seen = []

    def recording(images, prompts):
        seen.append(np.array(images, copy=True))
        return checker(images, prompts)

    pipe = SDPipeline(models, cfg, _tokenizer(cfg), "cuda", torch.bfloat16,
                      safety_checker=recording)
    want = generate_launches(cfg, 4, 25, 512)
    _kernels.reset_launch_counts()
    out = pipe.generate(PROMPTS, spec)
    counts = dict(_kernels.launches)
    flags = pipe.last_nsfw_flags
    got = seen[-1]
    card_c, card_s = checker.scores(got)
    cpu_c, cpu_s = cpu_checker.scores(got)
    err = max(float(np.abs(card_c - cpu_c).max()),
              float(np.abs(card_s - cpu_s).max()))
    x4 = torch.from_numpy(got).cuda()
    safety_ms = median_ms(lambda: checker.scores(x4), 5)
    decided = np.abs(cpu_c) > SAFETY_TOL
    cpu_flags = (cpu_c > 0).any(axis=1).tolist()
    print(f"[safety] ClipSafetyChecker ViT-L/14 224^2 (random weights, "
          f"concept 0 = image 0's embedding; cosines to it {cos0}, "
          f"threshold {1.0 - gap / 2:.6f}) through SDPipeline.generate on "
          f"4 dpm-25 512^2 images: flags {flags} (CPU {cpu_flags}); card "
          f"(strict fp32) vs CPU scores max abs diff {err:.3e} (tol "
          f"{SAFETY_TOL:.0e}); launches K1 {counts['flash_fixed']} K4 "
          f"{counts['geglu_ff']} (expected {want['flash_fixed']}, "
          f"{want['geglu_ff']}); {safety_ms:.3f} ms a batch of 4 "
          f"(uint8-range floats 512^2 -> 224^2 on the card, CUDA events, "
          f"median of 5) | {smi}", flush=True)
    if not err <= SAFETY_TOL:
        fail(f"safety scores card vs CPU {err} > {SAFETY_TOL}")
    if not gap > 2 * SAFETY_TOL:
        fail(f"safety: image 0's embedding is within {gap} of another's: "
             "no threshold separates it")
    if flags != [True, False, False, False] or not np.array_equal(
            (card_c > 0) & decided, (cpu_c > 0) & decided):
        fail(f"safety flags {flags}, card scores {card_c[:, 0]}, CPU "
             f"{cpu_c[:, 0]}")
    if out.shape != (4, 512, 512, 3) or out[0].any() or \
            not np.array_equal(out[1:], got[1:]) or not got[0].any():
        fail("safety: image 0 not blacked out or the others changed")
    if counts != want:
        fail(f"safety: generate's launch counts {counts}, expected {want}")
    paths = {"generate bucket 4 + safety checker": counts}
    del pipe, models, card_model, checker
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(clip_mod.CLIPTextConfig.sd15(),
                               projection_dim=768)
    cpu_clip = ClipModel(tcfg, vcfg, device="cpu",
                         generator=torch.Generator().manual_seed(4))
    tok = CLIPTokenizer.fallback(tcfg.vocab_size)
    card_scorer = ClipScorer(copy.deepcopy(cpu_clip).cuda(), tcfg, vcfg, tok)
    cpu_scorer = ClipScorer(cpu_clip, tcfg, vcfg, tok)
    card_cos = card_scorer.cosines(got, PROMPTS)
    cpu_cos = cpu_scorer.cosines(got[:2], PROMPTS[:2])
    cerr = float(np.abs(card_cos[:2] - cpu_cos).max())
    score_ms = median_ms(lambda: card_scorer.cosines(got, PROMPTS), 5)
    print(f"[clip_score] ClipScorer at clip-vit-large-patch14 widths "
          f"(random weights): cosines card {card_cos.tolist()}, CPU "
          f"{cpu_cos.tolist()} (first 2): max abs diff {cerr:.3e} (tol "
          f"{CLIPSCORE_TOL:.0e}); {score_ms:.3f} ms a batch of 4 (both "
          f"towers, host images in, CUDA events, median of 5) | {smi}",
          flush=True)
    if card_cos.shape != (4,) or not np.isfinite(card_cos).all() \
            or not cerr <= CLIPSCORE_TOL:
        fail(f"CLIPScore cosines card {card_cos} vs CPU {cpu_cos}")
    if "jax" in sys.modules or "PIL" in sys.modules \
            or "pandas" in sys.modules:
        fail("jax, PIL or pandas was imported")
    return paths


# the families phase: the SD-2.x and SDXL serving paths.  Full width: DDIM
# at FAMILY_STEPS, CFG 7.5, batch 1, random weights from seed 0 (bf16);
# the ensemble hands over at FAMILY_FRAC.  The tiny runs (card against the
# CPU): (label, config factory name, refiner factory name or None, image
# side); the tiny VAE downsamples 2×, so at 64² tiny_xl's level 1 holds
# 256 tokens and both sampling kernels launch.
FAMILY_STEPS = 20
FAMILY_FRAC = 0.8
# (label, --model_family at --tiny, with the tiny refiner, image side)
FAMILY_TINY = [("sd21", "sd21", False, 32), ("sdxl", "sdxl", False, 64),
               ("ensemble", "sdxl", True, 64)]
FAMILY_PROMPT = ("an epic fantasy novel cover, a dragon over a castle at "
                 "dusk")


def _family_pipe(cfg, models, device, dtype, refiner=None):
    """``SDPipeline`` of ``models``, or with ``refiner`` ((cfg, models))
    the ``EnsemblePipeline`` handing over at ``FAMILY_FRAC``."""
    from sdbc_tpu_torch.diffusion.ensemble import EnsemblePipeline
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline

    pipe = SDPipeline(models, cfg, _tokenizer(cfg), device, dtype)
    if refiner is None:
        return pipe
    rcfg, rmodels = refiner
    return EnsemblePipeline(pipe, SDPipeline(rmodels, rcfg, _tokenizer(rcfg),
                                             device, dtype),
                            handoff=FAMILY_FRAC)


def phase_families_tiny() -> dict:
    """``--tiny --model_family sd21``, tiny_xl and the tiny_xl →
    tiny_xl_refiner ensemble at batch 2, DDIM-4, CFG 7.5: bf16 on the card
    against fp32 on the CPU (the same bf16-valued weights and latents)
    within ``PARITY_TOL``, then fp32 on the card (every attention and FF
    call on the 3xTF32 kernels) within ``FP32_PARITY_TOL``, each with exact
    launches (``family_launches``).  Returns each run's counts."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    paths = {}
    for label, family, ensemble, img in FAMILY_TINY:
        cfg = PipelineConfig.family(family, tiny=True)
        rcfg = PipelineConfig.tiny_xl_refiner() if ensemble else None
        sets = {}
        for seed, role, c in ((0, "base", cfg), (1, "refiner", rcfg)):
            if c is None:
                continue
            models = init_models(c, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
            bf = {k: copy.deepcopy(m).to("cuda", torch.bfloat16)
                  for k, m in models.items()}
            cpu = {k: copy.deepcopy(m).to("cpu", torch.float32)
                   for k, m in bf.items()}
            sets[role] = {"cuda bf16": bf, "cpu": cpu,
                       "cuda fp32": {k: copy.deepcopy(m).to("cuda")
                                     for k, m in cpu.items()}}
        lat = per_sample_fixed_latents(2, (4, img // 2, img // 2), 42)
        kw = dict(height=img, width=img, num_inference_steps=4, latents=lat)
        prompts = ["a book cover", "a mystery novel cover"]

        def run(where, dtype):
            dev = "cpu" if where == "cpu" else "cuda"
            rf = (rcfg, sets["refiner"][where]) if rcfg else None
            return _family_pipe(cfg, sets["base"][where], dev, dtype, rf)(
                prompts, **kw)

        ref = run("cpu", torch.float32)
        want = dict.fromkeys(_kernels.launches, 0)
        want.update(family_launches(cfg, img // 2, 2, 4, refiner=rcfg,
                                    handoff=FAMILY_FRAC))
        # the one batched decode: the tiny VAE's 64-wide single-head mid
        # attention takes the training flash kernel (phase_parity's rule)
        want["flash_fwd"] = int((rcfg or cfg).vae.block_out_channels[-1]
                                <= 256)
        for where, dtype in (("cuda bf16", torch.bfloat16),
                             ("cuda fp32", torch.float32)):
            expect = fp32_launches(want) if dtype == torch.float32 else want
            _kernels.reset_launch_counts()
            out = run(where, dtype)
            counts = dict(_kernels.launches)
            err = float(np.abs(out - ref).max())
            tol = FP32_PARITY_TOL if dtype == torch.float32 else PARITY_TOL
            print(f"[families] tiny {label} {img}^2 batch 2 DDIM-4 "
                  f"({where} vs cpu fp32): image max abs err {err:.3e} (tol "
                  f"{tol}), launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
            if out.shape != (2, img, img, 3) or not np.isfinite(out).all():
                fail(f"families tiny {label} ({where}) output {out.shape} "
                     "not finite")
            if not err <= tol:
                fail(f"families tiny {label} ({where}): card vs CPU max abs "
                     f"err {err} > {tol}")
            used = [FP32_OF[k] if dtype == torch.float32 else k
                    for k in ("flash_fixed", "geglu_ff")]
            if counts != expect or min(expect[k] for k in used) == 0:
                fail(f"families tiny {label} ({where}) launch counts "
                     f"{counts}, expected {expect}")
            fp32 = "fp32 " if dtype == torch.float32 else ""
            paths[f"families {label} {fp32}(tiny)"] = counts
        del sets
    return paths


def _family_timed(label: str, pipe, kw: dict, want: dict, smi: str,
                  calls: int = 3, shape=None):
    """A warm-up call (skipped for ``calls`` = 1), then ``calls`` timed
    calls of ``pipe`` on ``FAMILY_PROMPT``, each with exactly ``want``
    launches and finite images in [0, 1].  Returns (counts of the last,
    median s/call, peak GiB over the timed calls)."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.ops import _kernels

    if calls > 1:
        pipe([FAMILY_PROMPT], **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(calls):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = pipe([FAMILY_PROMPT], **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = dict(_kernels.launches)
        if counts != want:
            fail(f"families {label}: launch counts {counts}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shape = shape or (1, kw["height"], kw["width"], 3)
    if imgs.shape != shape or not np.isfinite(imgs).all() \
            or imgs.min() < 0.0 or imgs.max() > 1.0:
        fail(f"families {label}: images {imgs.shape} not finite in [0, 1]")
    med = statistics.median(secs)
    print(f"[families] {label}: {med:.3f} s/call (median of "
          f"{calls}: {', '.join(f'{s:.3f}' for s in secs)}), peak "
          f"{peak:.2f} GiB, launches K1 {counts['flash_fixed']} K4 "
          f"{counts['geglu_ff']} a call | {smi}", flush=True)
    return counts, med, peak


def family_profile(label: str, pipe, lat_hw: int) -> None:
    """Where a family's sampling call goes: one UNet evaluation at the CFG
    batch 2 of one image as ``sample`` makes it (the hoisted time
    projections, per sample with SDXL's text-time conditioning), its
    device time by kernel (``torch.profiler``) against its wall time (the
    device's idle share), and the wall times of the text encode and the
    VAE decode of one image."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdbc_tpu_torch.diffusion import graph
    from sdbc_tpu_torch.models import unet as unet_mod
    from sdbc_tpu_torch.models import vae as vae_mod

    cfg, models = pipe.cfg, pipe.models
    g = torch.Generator(device="cuda").manual_seed(7)
    bf = torch.bfloat16
    lat = torch.randn((2, lat_hw, lat_hw, 4), generator=g,
                      device="cuda").to(bf)
    ctx = torch.randn((2, 77, cfg.unet.cross_attention_dim), generator=g,
                      device="cuda").to(bf)
    ids = pipe.tokenize([FAMILY_PROMPT])
    added = None
    if cfg.is_sdxl:
        added = torch.randn((2, cfg.unet.addition_embed_dim), generator=g,
                            device="cuda")
    with torch.inference_mode():
        tp = unet_mod.index_temb(unet_mod.precompute_temb(
            models["unet"], torch.tensor([500], device="cuda"), bf,
            added_cond=added), 0)
        run = lambda: unet_mod.apply(models["unet"], lat, None, ctx,
                                     attn_impl="inference", temb_proj=tp)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        unet_ms = wall_ms(run, 5)
        z = torch.randn((1, lat_hw, lat_hw, 4), generator=g,
                        device="cuda").to(bf)
        vae_ms = wall_ms(lambda: vae_mod.decode(models["vae"], z), 3)
        if cfg.is_sdxl:
            text = lambda: graph.encode_text_xl(models, ids, pipe.tokenize2(
                [FAMILY_PROMPT]), cfg, bf)
        else:
            text = lambda: graph.encode_text(models["text_encoder"], ids,
                                             cfg, bf)
        text_ms = wall_ms(text, 5)
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev_us(e) for e in events) / 1e3
    top = [(e.key[:60], round(dev_us(e) / 1e3, 3))
           for e in sorted(events, key=lambda e: -dev_us(e))[:8]]
    kernels = (f"kernels {total:.3f} ms (device idle "
               f"{100 * (1 - total / unet_ms):.1f}%), top kernels (ms): {top}"
               if total else "kernels not measured (the profiler saw no "
               "device time)")
    print(f"[families] profile {label}: UNet eval (batch 2, {lat_hw}^2 "
          f"latents) wall {unet_ms:.3f} ms, {kernels}; text encode "
          f"{text_ms:.3f} ms; VAE decode (one image) {vae_ms:.3f} ms",
          flush=True)


def phase_families(smi: str) -> dict:
    """The SD-2.x and SDXL serving paths on the card: the tiny runs
    (``phase_families_tiny``); then at full width, random weights from
    seed 0 in bf16, DDIM, CFG 7.5, batch 1: SD-2.1 (v-prediction) at 768²
    and SDXL base at 1024², ``FAMILY_STEPS`` steps, timed (median of 3
    after a warm-up) with exact launches (300 / 200 and 1400 / 200 K1 / K4
    a call); SDXL at 832×1216 (a portrait cover: ragged 3952- and
    988-token attention, K4 off) once; the base → refiner ensemble at
    1024² handing over at ``FAMILY_FRAC`` with both models resident; then
    the entry points: ``cli.inference.main --model_family sdxl`` at 1024²,
    DDIM-4, writing its PNG, and one lone request to ``cli.serve
    --model_family sdxl`` (DDIM-4) equal to the direct ``generate`` call in
    every pixel.  Each pipeline is freed before the next.  Returns the
    launch counts by path."""
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import common, serve
    from sdbc_tpu_torch.cli import inference as cli_inference
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.diffusion.spec import SampleSpec
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils import png
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    t_phase = time.perf_counter()
    paths = phase_families_tiny()
    n = FAMILY_STEPS

    def models_of(cfg, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return init_models(cfg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)

    def want_of(cfg, lat, steps=n, refiner=None):
        want = dict.fromkeys(_kernels.launches, 0)
        want.update(family_launches(cfg, lat, 1, steps, refiner=refiner,
                                    handoff=FAMILY_FRAC))
        return want

    def kw_of(h, w, steps=n):
        f = 8
        return dict(height=h, width=w, num_inference_steps=steps,
                    guidance_scale=7.5, latents=per_sample_fixed_latents(
                        1, (4, h // f, w // f), 42))

    stats = {}
    # SD-2.1 768²
    cfg = PipelineConfig.family("sd21")
    pipe = _family_pipe(cfg, models_of(cfg, 0), "cuda", torch.bfloat16)
    want = want_of(cfg, 96)
    if (want["flash_fixed"], want["geglu_ff"]) != (300, 200):
        fail(f"families SD-2.1 expected launches {want}")
    paths["families sd21 768^2"], *stats["sd21"] = _family_timed(
        f"SD-2.1 (v-prediction) 768^2 batch 1 DDIM-{n} CFG 7.5 bf16", pipe,
        kw_of(768, 768), want, smi)
    family_profile("SD-2.1 768^2", pipe, 96)
    del pipe
    torch.cuda.empty_cache()

    # SDXL base 1024², the portrait, then the ensemble
    cfg = PipelineConfig.family("sdxl")
    base = models_of(cfg, 0)
    pipe = _family_pipe(cfg, base, "cuda", torch.bfloat16)
    want = want_of(cfg, 128)
    if (want["flash_fixed"], want["geglu_ff"]) != (1400, 200):
        fail(f"families SDXL expected launches {want}")
    paths["families sdxl 1024^2"], *stats["sdxl"] = _family_timed(
        f"SDXL base 1024^2 batch 1 DDIM-{n} CFG 7.5 bf16", pipe,
        kw_of(1024, 1024), want, smi)
    family_profile("SDXL base 1024^2", pipe, 128)
    want = want_of(cfg, (152, 104))
    if (want["flash_fixed"], want["geglu_ff"]) != (1400, 0):
        fail(f"families SDXL portrait expected launches {want}")
    paths["families sdxl 832x1216"], *stats["portrait"] = _family_timed(
        f"SDXL base 832x1216 (portrait) batch 1 DDIM-{n} CFG 7.5 bf16 "
        "(one call)", pipe, kw_of(1216, 832), want, smi, calls=1)
    rcfg = PipelineConfig.sdxl_refiner()
    ens = _family_pipe(cfg, base, "cuda", torch.bfloat16,
                       refiner=(rcfg, models_of(rcfg, 1)))
    want = want_of(cfg, 128, refiner=rcfg)
    paths["families ensemble 1024^2"], *stats["ensemble"] = _family_timed(
        f"SDXL base -> refiner 1024^2 batch 1 DDIM-{n} handoff "
        f"{FAMILY_FRAC} ({int(round(n * FAMILY_FRAC))} base + "
        f"{n - int(round(n * FAMILY_FRAC))} refiner evaluations), both "
        "resident", ens, kw_of(1024, 1024), want, smi)
    family_profile("SDXL refiner 1024^2", ens.refiner, 128)
    del pipe, ens, base
    torch.cuda.empty_cache()

    # cli.inference --model_family sdxl
    tmp = tempfile.TemporaryDirectory()
    argv = ["--model_family", "sdxl", "--mode", "enter_prompt", "--prompt",
            FAMILY_PROMPT, "--img_size", "1024", "--num_inference_steps",
            "4", "--seed", "0", "--save_dir", tmp.name]
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cli_inference.main(argv)
    secs = time.perf_counter() - t0
    counts = dict(_kernels.launches)
    want = want_of(cfg, 128, steps=4)
    path = os.path.join(tmp.name, "dev inference", f"{FAMILY_PROMPT}.png")
    with open(path, "rb") as f:
        img = png.decode(f.read())
    print(f"[families] cli.inference --model_family sdxl 1024^2 DDIM-4: "
          f"{secs:.3f} s (with the random init), wrote {img.shape} PNG, "
          f"launches K1 {counts['flash_fixed']} K4 {counts['geglu_ff']}",
          flush=True)
    if counts != want or img.shape != (1024, 1024, 3):
        fail(f"families cli.inference: launches {counts} (expected {want}),"
             f" image {img.shape}")
    paths["families cli.inference sdxl"] = counts
    tmp.cleanup()
    torch.cuda.empty_cache()

    # cli.serve --model_family sdxl: one lone request
    args = serve.build_parser().parse_args(
        ["--model_family", "sdxl", "--img_size", "1024",
         "--num_inference_steps", "4", "--scheduler", "ddim", "--seed", "0",
         "--no-warmup"])
    common.refuse_unported(args)
    common.resolve_img_size(args)
    pipe, _ = serve.load_pipelines(args)
    handler, _ = serve.make_app(pipe, args)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/generate",
            data=json.dumps({"prompt": FAMILY_PROMPT, "seed": 7}).encode())
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            body = r.read()
        secs = time.perf_counter() - t0
        counts = dict(_kernels.launches)
        served = png.decode(body)
        direct = pipe.generate([FAMILY_PROMPT], SampleSpec(
            height=1024, width=1024, num_inference_steps=4,
            guidance_scale=7.5, seed=7))
        direct = np.uint8(np.round(direct * 255.0))[0]
    finally:
        srv.shutdown()
        handler.close()
        srv.server_close()
    diff = int(np.abs(served.astype(np.int16) - direct).max())
    print(f"[families] cli.serve --model_family sdxl: a lone 1024^2 DDIM-4 "
          f"request in {secs:.3f} s of wall, max pixel diff against "
          f"generate {diff}, launches K1 {counts['flash_fixed']} K4 "
          f"{counts['geglu_ff']}", flush=True)
    if diff != 0 or counts != want:
        fail(f"families serve: pixel diff {diff}, launches {counts} "
             f"(expected {want})")
    paths["families serve sdxl"] = counts
    del pipe, handler
    torch.cuda.empty_cache()
    print(f"[families] phase in {time.perf_counter() - t_phase:.1f} s: "
          + "; ".join(f"{k} {s:.3f} s/call peak {p:.2f} GiB"
                      for k, (s, p) in stats.items()), flush=True)
    return paths


# ---------------------------------------------------------------------------
# ControlNet and the dedicated inpainting UNet

CN_STEPS = 20


def cover_edges(size: int):
    """One edge map (``controlnet.edge_hint``) of a synthetic cover layout:
    a shaded background, a title band, a frame and a disc; (1, size, size,
    3) in [0, 1] on the host."""
    import torch

    from sdbc_tpu_torch.models.controlnet import edge_hint

    y, x = torch.meshgrid(torch.linspace(-1, 1, size),
                          torch.linspace(-1, 1, size), indexing="ij")
    img = 0.3 * y
    img = torch.where((y > -0.85) & (y < -0.55), torch.full_like(y, 0.8),
                      img)
    img = torch.where(((x.abs() - 0.8).abs() < 0.02) & (y > -0.4),
                      torch.full_like(y, -0.9), img)
    img = torch.where(x ** 2 + (y - 0.3) ** 2 < 0.12, torch.full_like(y, 0.5),
                      img)
    px = img[None, :, :, None].expand(1, size, size, 3)
    return edge_hint(px).numpy()


# the port's kernels whose device ms ``profiled_idle`` sums by name
OUR_KERNELS = ("flash_fwd_sm90_kernel", "geglu_ff_sm90_kernel",
               "flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel",
               "adam8_leaves_kernel")


def profiled_idle(label: str, fn, wall_s: float) -> None:
    """Device time of one ``fn()`` by kernel (``torch.profiler``, device
    activity only: a whole sampling call or step holds ~50k kernels, and
    the host's operator records would cost the phase tens of seconds)
    against the unprofiled wall ``wall_s``: the device's idle share, and
    the port's kernels' ms (``OUR_KERNELS``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages() if dev_us(e) > 0
              and getattr(e, "device_type", None) == DeviceType.CUDA]
    total = sum(dev_us(e) for e in events) / 1e3
    if not total:
        print(f"[controlnet] profile {label}: device time not measured "
              "(the profiler saw no device time)", flush=True)
        return
    top = [(e.key[:48], round(dev_us(e) / 1e3, 2), e.count)
           for e in sorted(events, key=lambda e: -dev_us(e))[:8]]
    ours = {n: round(sum(dev_us(e) for e in events if n in e.key) / 1e3, 3)
            for n in OUR_KERNELS}
    print(f"[controlnet] profile {label}: kernels {total:.1f} ms of "
          f"{wall_s * 1e3:.1f} ms unprofiled wall (device idle "
          f"{100 * (1 - total / (wall_s * 1e3)):.1f}%), "
          f"{sum(e.count for e in events)} kernel launches; ours (ms) "
          f"{ {n: t for n, t in ours.items() if t} }; top kernels (ms, "
          f"calls): {top}", flush=True)


def controlnet_models(cfg, device, dtype, seed: int = 0, branches: int = 1):
    """Random base models of ``cfg`` from ``seed`` and ``branches``
    ``from_unet`` ControlNet branches moved off their zero convs
    (``jitter_controlnet``), in ``dtype`` on ``device``."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import init_models
    from sdbc_tpu_torch.models import controlnet as cn_mod

    gen = torch.Generator(device=device).manual_seed(seed)
    models = init_models(cfg, device=device, generator=gen, dtype=dtype)
    if branches:
        cns = [jitter_controlnet(cn_mod.from_unet(
            models["unet"], torch.Generator(device=device).manual_seed(
                seed + 1 + i), cfg.controlnet, dtype=dtype), seed + 11 + i)
            for i in range(branches)]
        models["controlnet"] = cns[0] if branches == 1 else cns
    return models


def inpaint_config(cfg):
    """``cfg`` with the dedicated inpainting UNet's 9-channel conv_in."""
    import dataclasses

    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, in_channels=2 * cfg.vae.latent_channels + 1))


def controlnet_tiny() -> dict:
    """Tiny ControlNet sampling (two branches, one control image each, a
    scale per branch) and tiny inpainting-UNet sampling (a rectangular
    mask, the masked image's draw injected) at batch 2, DDIM-4: bf16 on
    the card against fp32 on the CPU within ``PARITY_TOL``, fp32 within
    ``FP32_PARITY_TOL``, exact launches; then one ControlNet optimizer
    step (remat "block", the Sobel hint) as ``phase_train_parity`` holds
    it, in bf16 and fp32.  Returns each run's counts."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, SDPipeline
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    paths = {}
    base_cfg = PipelineConfig.tiny()
    rng = np.random.default_rng(21)
    img = rng.random((2, 32, 32, 3), dtype=np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[6:26, 4:20] = 1.0
    g = torch.Generator().manual_seed(22)
    masked_draw = torch.randn((2, 16, 16, 4), generator=g)
    lat = per_sample_fixed_latents(2, (4, 16, 16), 42)
    prompts = ["a book cover", "a mystery novel cover"]
    runs = [("controlnet", base_cfg.with_controlnet(), 2,
             dict(control_image=[img, img[::-1].copy()],
                  controlnet_scale=[0.8, 1.2])),
            ("inpaint unet", inpaint_config(base_cfg), 0,
             dict(init_image=img, mask_image=mask,
                  draws={"masked": masked_draw}))]
    for label, cfg, branches, kw in runs:
        models = controlnet_models(cfg, "cpu", torch.float32,
                                   branches=branches)

        def moved(device, dtype, source):
            return {k: ([copy.deepcopy(m).to(device, dtype) for m in v]
                        if isinstance(v, list)
                        else copy.deepcopy(v).to(device, dtype))
                    for k, v in source.items()}

        bf = moved("cuda", torch.bfloat16, models)
        cpu = moved("cpu", torch.float32, bf)  # the bf16-valued weights
        sets = {"cuda bf16": bf, "cpu": cpu,
                "cuda fp32": moved("cuda", torch.float32, cpu)}

        def run(where, dtype):
            dev = "cpu" if where == "cpu" else "cuda"
            pipe = SDPipeline(sets[where], cfg, _tokenizer(cfg), dev, dtype)
            return pipe(prompts, height=32, width=32, num_inference_steps=4,
                        latents=lat, **kw)

        ref = run("cpu", torch.float32)
        want = controlnet_sampling_launches(cfg, 16, 2, 4, branches)
        # the tiny VAE's mid attention on the training flash kernel: the
        # decode, and the masked image's encode
        want["flash_fwd"] = 1 + (label == "inpaint unet")
        for where, dtype in (("cuda bf16", torch.bfloat16),
                             ("cuda fp32", torch.float32)):
            expect = fp32_launches(want) if dtype == torch.float32 else want
            _kernels.reset_launch_counts()
            out = run(where, dtype)
            counts = dict(_kernels.launches)
            err = float(np.abs(out - ref).max())
            tol = FP32_PARITY_TOL if dtype == torch.float32 else PARITY_TOL
            print(f"[controlnet] tiny {label} 32^2 batch 2 DDIM-4 ({where} "
                  f"vs cpu fp32): image max abs err {err:.3e} (tol {tol}), "
                  f"launches {nonzero(counts)}", flush=True)
            if out.shape != (2, 32, 32, 3) or not np.isfinite(out).all():
                fail(f"controlnet tiny {label} ({where}) output {out.shape} "
                     "not finite")
            if not err <= tol:
                fail(f"controlnet tiny {label} ({where}): card vs CPU max "
                     f"abs err {err} > {tol}")
            used = [FP32_OF[k] if dtype == torch.float32 else k
                    for k in ("flash_fixed", "geglu_ff")]
            if counts != expect or min(expect[k] for k in used) == 0:
                fail(f"controlnet tiny {label} ({where}) launch counts "
                     f"{counts}, expected {expect}")
            fp32 = "fp32 " if dtype == torch.float32 else ""
            paths[f"{label} {fp32}(tiny)"] = counts
        del sets
    train = phase_train_parity(
        "controlnet", card_dtypes=(torch.bfloat16, torch.float32),
        cfg=base_cfg.with_controlnet(), train_controlnet=True,
        train_text_encoder=False, train_unet=False, grad_ckpt=True,
        remat_mode="block")
    paths["controlnet train (tiny)"] = train[torch.bfloat16]
    paths["controlnet train fp32 (tiny)"] = train[torch.float32]
    return paths


def _cn_timed(label: str, call, want: dict, smi: str, calls: int = 3,
              shape=(4, 512, 512, 3)):
    """A warm-up call, then ``calls`` timed calls, each with exactly
    ``want`` launches and finite images in [0, 1].  Returns (images of
    the last, counts, median s/call, peak GiB)."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.ops import _kernels

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(calls):
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = dict(_kernels.launches)
        if counts != want:
            fail(f"controlnet {label}: launch counts {counts}, expected "
                 f"{want}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if imgs.shape != shape or not np.isfinite(imgs).all() \
            or imgs.min() < 0.0 or imgs.max() > 1.0:
        fail(f"controlnet {label}: images {imgs.shape} not finite in [0, 1]")
    med = statistics.median(secs)
    print(f"[controlnet] {label}: {med:.4f} s/call (median of {calls}: "
          f"{', '.join(f'{x:.4f}' for x in secs)}), {shape[0] / med:.4f} "
          f"images/s, peak {peak:.2f} GiB, launches K1 "
          f"{counts['flash_fixed']} K4 {counts['geglu_ff']} a call | {smi}",
          flush=True)
    return imgs, counts, med, peak


def controlnet_sampling_full(smi: str) -> dict:
    """SD-1.5 + ControlNet at 512² (random weights from seed 0 in bf16, a
    ``from_unet`` branch off its zero convs), batch 4, DDIM-20, CFG 7.5,
    one ``cover_edges`` map: timed (median of 3 after a warm-up), 420 /
    280 K1 / K4 a call exactly, a profiled call; the base without the
    image (300 / 200), whose image the control must change and a zero
    ``controlnet_scale`` must give back.  Then the 9-channel inpainting
    UNet (SD-1.5 layout, seed 0) through ``SDPipeline.inpaint`` with a
    rectangular mask: timed the same way, 300 / 200 a call."""
    import numpy as np
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, SDPipeline
    from sdbc_tpu_torch.ops import _kernels

    bf = torch.bfloat16
    paths = {}
    cfg = PipelineConfig.sd15().with_controlnet()
    pipe = SDPipeline(controlnet_models(cfg, "cuda", bf), cfg,
                      _tokenizer(cfg), "cuda", bf)
    edges = cover_edges(512)
    kw = dict(height=512, width=512, num_inference_steps=CN_STEPS,
              guidance_scale=7.5)
    want = controlnet_sampling_launches(cfg, 64, 4, CN_STEPS)
    base_want = controlnet_sampling_launches(cfg, 64, 4, CN_STEPS, 0)
    if (want["flash_fixed"], want["geglu_ff"]) != (420, 280) or \
            (base_want["flash_fixed"], base_want["geglu_ff"]) != (300, 200):
        fail(f"controlnet: the launch rule gives {want} and {base_want}")
    ctrl = lambda **extra: pipe(PROMPTS, control_image=edges, **kw, **extra)
    imgs, counts, med, peak = _cn_timed("SD-1.5 + ControlNet 512^2 batch 4 "
                                        "DDIM-20", ctrl, want, smi)
    paths["controlnet sampling"] = counts
    profiled_idle("SD-1.5 + ControlNet DDIM-20 call", ctrl, med)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    base = pipe(PROMPTS, **kw)
    torch.cuda.synchronize()
    base_s = time.perf_counter() - t0
    if dict(_kernels.launches) != base_want:
        fail(f"controlnet base call: launches {dict(_kernels.launches)}, "
             f"expected {base_want}")
    _kernels.reset_launch_counts()
    zero = ctrl(controlnet_scale=0.0)
    if dict(_kernels.launches) != want:
        fail(f"controlnet zero scale: launches {dict(_kernels.launches)}")
    moved = float(np.abs(imgs - base).max())
    # zero residuals leave every skip as it was: the base's bits (the
    # card's kernels repeat a call bit for bit)
    zero_err = float(np.abs(zero - base).max())
    print(f"[controlnet] base (no control image) {base_s:.4f} s/call, the "
          f"branch {med / base_s:.3f}x of it; control vs base max abs "
          f"{moved:.4e}; zero scale vs base {zero_err:.3e} | {smi}",
          flush=True)
    if not moved > 1e-2:
        fail(f"controlnet: the control image moved the images by {moved}")
    if zero_err != 0.0:
        fail(f"controlnet: a zero scale is {zero_err} from the base's "
             "images")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    icfg = inpaint_config(PipelineConfig.sd15())
    ipipe = SDPipeline(controlnet_models(icfg, "cuda", bf, branches=0), icfg,
                       _tokenizer(icfg), "cuda", bf)
    image = np.clip(cover_edges(512)[0] * 0.8 + 0.1, 0.0, 1.0)
    mask = np.zeros((512, 512), np.float32)
    mask[96:352, 64:448] = 1.0
    inp = lambda: ipipe.inpaint(PROMPTS, image, mask, **kw)
    iwant = controlnet_sampling_launches(icfg, 64, 4, CN_STEPS, 0)
    _, counts, imed, _ = _cn_timed("inpainting UNet (9 channels) 512^2 "
                                   "batch 4 DDIM-20", inp, iwant, smi)
    paths["inpaint unet sampling"] = counts
    profiled_idle("inpainting UNet DDIM-20 call", inp, imed)
    del ipipe
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def controlnet_train_full(smi: str, steps: int = 3) -> dict:
    """ControlNet training at SD-1.5 512² in mode C's shape (the branch's
    fp32 masters from ``from_unet`` off its zero convs, the base frozen in
    bf16, micro-batch 2, grad_accum 4, 8-bit AdamW, remat "block", the
    Sobel hint): a warm-up step, ``steps`` timed steps with finite losses,
    a moved branch and exact launches (144 / 60 / 60 / 1 K5 / K6a / K6b /
    K7 a step), peak memory and a profiled step."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                              make_train_step,
                                              trainable_params)

    cfg = PipelineConfig.sd15().with_controlnet()
    accum, micro = 4, 2
    tcfg = TrainConfig(train_controlnet=True, train_text_encoder=False,
                       use_8bit_adam=True, grad_ckpt=True,
                       remat_mode="block", control_hint="edges",
                       grad_accum=accum, micro_batch=micro,
                       num_examples=1000)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(controlnet_models(cfg, "cuda", torch.float32),
                             tcfg)
    step = make_train_step(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"pixel_values": torch.rand((accum, micro, 512, 512, 3),
                                        generator=gen, device="cuda") * 2 - 1,
             "input_ids": torch.randint(0, cfg.clip.vocab_size,
                                        (accum, micro, cfg.clip.ctx),
                                        generator=gen, device="cuda")}
    params = trainable_params(state.trainable)
    watch = [params[0], params[len(params) // 2], params[-1]]
    start = [p.detach().clone() for p in watch]
    t0 = time.perf_counter()
    state, m = step(state, batch, generator=gen)
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
            fail(f"controlnet train step skipped, loss {m['loss']}")
    counts = dict(_kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    n8 = _n8(state)
    one = controlnet_train_launches(cfg, tcfg, 512, n8)
    if [one[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "adam8")] != [144, 60, 60, 1]:
        fail(f"controlnet train: the launch rule gives {one}")
    want = {k: steps * v for k, v in one.items()}
    moved = [float((p.detach() - s0).abs().max())
             for p, s0 in zip(watch, start)]
    sps = statistics.median(times)
    n_train = sum(p.numel() for p in params)
    print(f"[controlnet] train SD-1.5 512^2 micro 2 grad_accum 4 8-bit AdamW "
          f"remat block, hint edges (the branch, {n_train / 1e9:.3f} B "
          f"trainable, {n8} 8-bit leaves): {sps:.4f} s/step (median of "
          f"{steps}: {[round(t, 4) for t in times]}), {8 / sps:.4f} "
          f"images/s, warm-up {warm:.3f} s, peak {peak / 2 ** 30:.2f} GiB, "
          f"losses {[round(x, 6) for x in losses]}, params moved {moved}, "
          f"launches {nonzero(counts)} (expected {nonzero(want)}) | {smi}",
          flush=True)
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail(f"controlnet train losses not finite: {losses}")
    if not all(x > 0 for x in moved):
        fail(f"controlnet train: the branch did not move: {moved}")
    if counts != want:
        fail(f"controlnet train launch counts {counts}, expected {want}")
    profiled_idle("ControlNet training step",
                  lambda: step(state, batch, generator=gen), sps)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"controlnet train": counts}


def phase_controlnet(smi: str) -> dict:
    """ControlNet and the 9-channel inpainting UNet: the tiny runs on the
    card against the CPU (``controlnet_tiny``), then at full width the
    sampling calls (``controlnet_sampling_full``) and the training step
    (``controlnet_train_full``).  Returns the launch counts by path."""
    t0 = time.perf_counter()
    paths = controlnet_tiny()
    t1 = time.perf_counter()
    paths.update(controlnet_sampling_full(smi))
    t2 = time.perf_counter()
    paths.update(controlnet_train_full(smi))
    t3 = time.perf_counter()
    print(f"[controlnet] phase {t3 - t0:.1f} s (tiny {t1 - t0:.1f}, "
          f"sampling {t2 - t1:.1f}, training {t3 - t2:.1f})", flush=True)
    return paths


def phase_train_profile(step, state, batch, gen, sps: float,
                        label: str = "train", host: bool = False):
    """Device time by kernel over one mode-C optimizer step; with
    ``host``, also the host's operators by their own CPU time (their
    records cost ~45 s of the card's host for one step, so only the SD-1.5
    step takes them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        step(state, batch, generator=gen)
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    averages = prof.key_averages()
    events = [e for e in averages if dev_us(e) > 0
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
                      "flash_tf32_sm90_kernel", "split_kv_kernel",
                      "flash_bwd_dq_tf32_sm90_kernel",
                      "flash_bwd_dkv_tf32_sm90_kernel", "split_bwd_kernel",
                      "flash_simt", "adam8_leaves_kernel")}
    ours = {n: t for n, t in ours.items() if t}
    n_kernels = sum(e.count for e in events)
    line = (f"[train-profile] {label}, one step: kernels {total:.1f} ms of "
            f"{sps * 1e3:.1f} ms unprofiled wall (device idle "
            f"{100 * (1 - total / (sps * 1e3)):.1f}%), {n_kernels} kernel "
            f"launches; ours (ms) {ours}; top kernels (ms, calls): "
            f"{summary}")
    if host:
        # operators by their own CPU time (the profiler's, which inflates
        # it)
        ops = sorted((e for e in averages
                      if getattr(e, "device_type", None) != DeviceType.CUDA),
                     key=lambda e: -e.self_cpu_time_total)[:8]
        ops = [(e.key[:40], round(e.self_cpu_time_total / 1e3, 1), e.count)
               for e in ops]
        line += f"; top host operators (self CPU ms, calls): {ops}"
    print(line, flush=True)


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, names in os.walk(root) for f in names)


EXPORT_STEPS = 10


def phase_export(cfg, pipe, smi: str) -> dict:
    """The slice's SD-1.5 pipeline (random bf16 weights from seed 0)
    exported to a diffusers directory and read back, as a user would:
    ``models.port.pipeline_trees`` and ``export_diffusers_checkpoint``
    (fp32 safetensors by ``write_safetensors``) into a temporary
    directory, then ``cli.common.resolve_params_cfg`` of ``cli.inference
    --diffusers_ckpt`` (``port_diffusers_checkpoint``,
    ``pipeline_config_from_diffusers``, bf16 on the card).  Every weight
    must come back bit for bit (bf16 → fp32 → bf16 is exact) and the
    config equal; DDIM-10, batch 1, CFG 7.5, 512² from injected latents
    through both pipelines: the re-imported image may differ from the
    source's by no more than two source calls differ from each other, and
    both calls launch K1/K4 150 / 100 times.  Prints the bytes written,
    the write and read seconds and GB/s; the directory is removed after.
    Returns the re-imported call's launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as cli
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.models import port
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    root = tempfile.mkdtemp(prefix="sdbc_export_")
    try:
        need = 4 * sum(p.numel() for m in pipe.models.values()
                       for p in m.parameters()) + (1 << 30)
        free = shutil.disk_usage(root).free
        if free < need:
            fail(f"export: {root} has {free / 1e9:.2f} GB free, the fp32 "
                 f"export needs {need / 1e9:.2f} GB")
        out = os.path.join(root, "sd15")
        t0 = time.perf_counter()
        trees = port.pipeline_trees(pipe)
        t1 = time.perf_counter()
        port.export_diffusers_checkpoint(trees, cfg, out)
        t2 = time.perf_counter()
        del trees
        nbytes = dir_bytes(out)
        args = cli.build_parser().parse_args(["--diffusers_ckpt", out])
        models, cfg2 = common.resolve_params_cfg(args)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, names in os.walk(out) for f in names)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[export] SD-1.5 (random bf16 from seed 0) → diffusers dir: "
          f"{nbytes} bytes in {len(files)} files {files}; trees off the "
          f"card {t1 - t0:.3f} s, export + write {t2 - t1:.3f} s "
          f"({nbytes / (t2 - t1) / 1e9:.3f} GB/s), read back to bf16 on "
          f"the card {t3 - t2:.3f} s ({nbytes / (t3 - t2) / 1e9:.3f} GB/s) "
          f"| {smi}", flush=True)
    for name in ("unet", "vae", "text_encoder"):
        if getattr(cfg2, {"text_encoder": "clip"}.get(name, name)) != \
                getattr(cfg, {"text_encoder": "clip"}.get(name, name)):
            fail(f"export: the {name} config read back differs")
        src, back = pipe.models[name].state_dict(), models[name].state_dict()
        if list(src) != list(back):
            fail(f"export: {name}'s parameters read back differ in name")
        bad = [k for k in src if src[k].dtype != back[k].dtype
               or not torch.equal(src[k], back[k])]
        if bad:
            fail(f"export: {len(bad)} {name} weights are not bit-equal "
                 f"after the round trip: {bad[:4]}")
    if cfg2.schedule != cfg.schedule or cfg2.scheduler != cfg.scheduler:
        fail(f"export: schedule {cfg2.schedule}/{cfg2.scheduler} read back")
    back = SDPipeline(models, cfg2, pipe.tokenizer, "cuda", torch.bfloat16)
    kw = dict(height=512, width=512, num_inference_steps=EXPORT_STEPS,
              guidance_scale=7.5,
              latents=per_sample_fixed_latents(1, (4, 64, 64), 7))
    want = generate_launches(cfg, 1, EXPORT_STEPS, 512, "ddim")
    runs = {}
    for label, p in (("source", pipe), ("source again", pipe),
                     ("re-imported", back)):
        _kernels.reset_launch_counts()
        runs[label] = p(PROMPTS[:1], **kw)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        if counts != want:
            fail(f"export: {label} call launched {nonzero(counts)}, "
                 f"expected {nonzero(want)}")
    a = runs["source"]
    if a.shape != (1, 512, 512, 3) or not np.isfinite(a).all():
        fail(f"export: images {a.shape} not all finite")
    self_diff = float(np.abs(a - runs["source again"]).max())
    diff = float(np.abs(a - runs["re-imported"]).max())
    print(f"[export] DDIM-{EXPORT_STEPS} batch 1 CFG 7.5 512^2: the "
          f"re-imported pipeline's image differs by {diff:.3e} from the "
          f"source's (two source calls: {self_diff:.3e}); K1/K4 "
          f"{want['flash_fixed']}/{want['geglu_ff']} each call | {smi}",
          flush=True)
    if diff > self_diff:
        fail(f"export: re-imported image off by {diff:.3e} > the source's "
             f"own {self_diff:.3e}")
    del back, models
    return counts


# DistilBART-CNN-12-6's config.json: the shapes of BartConfig.distilbart_cnn
BART_CONFIG = {"architectures": ["BartForConditionalGeneration"],
               "model_type": "bart", "vocab_size": 50264, "d_model": 1024,
               "encoder_layers": 12, "decoder_layers": 6,
               "encoder_attention_heads": 16, "decoder_attention_heads": 16,
               "encoder_ffn_dim": 4096, "decoder_ffn_dim": 4096,
               "max_position_embeddings": 1024, "activation_function": "gelu",
               "scale_embedding": False, "pad_token_id": 1,
               "bos_token_id": 0, "eos_token_id": 2,
               "decoder_start_token_id": 2, "forced_bos_token_id": 0,
               "forced_eos_token_id": 2}


def bart_transformers_sd(model) -> dict:
    """A ``models.bart`` module's weights under transformers'
    ``BartForConditionalGeneration`` names, linear weights (out, in) as
    transposed views (``write_safetensors`` writes their logical order)."""
    import torch

    sd = {"model.shared.weight": model.shared_embedding.weight,
          "final_logits_bias": torch.zeros(1, model.cfg.vocab_size)}
    for side in ("encoder", "decoder"):
        sd[f"model.{side}.embed_positions.weight"] = getattr(
            model, side[:3] + "_pos").weight
        ln = getattr(model, side[:3] + "_ln_emb")
        sd[f"model.{side}.layernorm_embedding.weight"] = ln.weight
        sd[f"model.{side}.layernorm_embedding.bias"] = ln.bias
        for i, layer in enumerate(getattr(model, side)):
            pfx = f"model.{side}.layers.{i}"
            attns = [("self_attn", "self_attn", "self_ln")]
            if side == "decoder":
                attns.append(("encoder_attn", "cross_attn", "cross_ln"))
            parts = [(f"{pfx}.fc1", layer.fc1), (f"{pfx}.fc2", layer.fc2),
                     (f"{pfx}.final_layer_norm", layer.final_ln)]
            for theirs, ours, ln_name in attns:
                a = getattr(layer, ours)
                parts += [(f"{pfx}.{theirs}.{q}_proj", getattr(a, q))
                          for q in "qkv"]
                parts += [(f"{pfx}.{theirs}.out_proj", a.o),
                          (f"{pfx}.{theirs}_layer_norm",
                           getattr(layer, ln_name))]
            for name, m in parts:
                w = m.weight.detach().cpu()
                sd[f"{name}.weight"] = w.T if w.ndim == 2 else w
                sd[f"{name}.bias"] = m.bias.detach().cpu()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def write_byte_bpe(root: str, vocab_size: int) -> None:
    """A byte-level BPE vocabulary of ``vocab_size`` ids: the four specials,
    the 256 byte characters, then merges of printable ASCII (the space as
    its marker "Ġ"): every pair, then pairs extended by one character,
    until every id a model of that vocabulary can emit decodes to text
    (all but the 128 lone high bytes to ASCII); merges.txt in rank
    order."""
    from sdbc_tpu_torch.data.tokenizer import _bytes_to_unicode

    to_char = _bytes_to_unicode()
    ascii_ = [to_char[b] for b in range(32, 127)]
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for c in to_char.values():
        vocab[c] = len(vocab)
    merges = []
    for firsts in (ascii_, [a + b for a in ascii_ for b in ascii_]):
        for a in firsts:
            for b in ascii_:
                if len(vocab) == vocab_size:
                    break
                vocab[a + b] = len(vocab)
                merges.append(f"{a} {b}")
    with open(os.path.join(root, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(root, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


DESC_WORDS = ("the a of and to in her his their young old city sea war "
              "secret family love night dark house journey kingdom stolen "
              "letter detective murder village winter summer island queen "
              "soldier painter café fiancée naïve “quiet” 'last' river storm "
              "ship mountain forest child mother father brother sister "
              "friend enemy truth lies memory promise betrayal escape "
              "return dream crown sword magic ancient forgotten hidden "
              "dangerous beautiful broken lost found must before after "
              "when while until because finds learns discovers hides "
              "fights loves leaves").split()


def goodreads_rows(n: int, seed: int = 0):
    """``n`` df_test rows whose descriptions are 150–300 words of
    Goodreads-like text (commas, quotes, a newline, accented words)."""
    import random

    rng = random.Random(seed)
    rows = []
    for i in range(n):
        words = [rng.choice(DESC_WORDS)
                 for _ in range(150 + (150 * i) // max(1, n - 1))]
        for j in range(9, len(words), 11):
            words[j] += rng.choice([",", ".", ";", ":"])
        words[len(words) // 2] += "\n"
        desc = " ".join(words).replace("\n ", "\n")
        rows.append((1000 + i, f"Author {i}, Jr.", desc[0].upper()
                     + desc[1:] + ".", f'The "{words[3]}" of {words[5]}'))
    return rows


SUMMARIZE_STEPS = 4
SUMMARIZE_ROWS = 3
# the largest candidate-score difference of the card's strict fp32 beam
# search from the CPU's over the steps the beams agree: between the strict
# readings and the same search with TF32 products, the control (on an H100
# 80GB HBM3 at 700 W: strict 8.6e-06 and 1.5e-05, TF32 2.0e-02)
SUMMARY_SCORE_TOL = 1e-4


def phase_summarize(smi: str) -> dict:
    """``cli.inference`` in its default mode with ``--summarize
    --bart_ckpt``, as the CLI runs it (random SD-1.5 from --seed, bf16 on
    the card): (summarize, include_desc) = (F,F), (T,T), (F,T) over the 13
    test templates, one sample a template (--samples_per_prompt 1, the
    CLI's batch 4), DDIM-4 (``SUMMARIZE_STEPS``, to keep the phase within
    its budget), on a df_test.csv of ``SUMMARIZE_ROWS`` rows with 150–300
    word descriptions.  The --bart_ckpt dir: DistilBART-CNN-12-6 at full
    width (d 1024, 12 + 6 layers, 16 heads, FFN 4096, vocab 50264), random
    weights from seed 0 written in transformers' names by
    ``write_safetensors``, its config.json and a byte-level vocabulary
    covering every id (``write_byte_bpe``).  Exact K1/K4 launches of the
    grids; the (T,T) prompts hold the card summarizer's summaries; the
    card's summary ids of one description equal those of the same weights
    in strict fp32 on the CPU, or differ only after a step whose smallest
    candidate gap is below the largest score difference (a near-tie); that
    difference stays within ``SUMMARY_SCORE_TOL``, which the same search
    with TF32 products on the card (the control) exceeds; ms per
    description (encode + beam) on the card.  Returns the CLI run's launch
    counts."""
    import csv
    import shutil
    import tempfile

    import numpy as np
    import torch

    from sdbc_tpu_torch.cli import inference as cli
    from sdbc_tpu_torch.data import templates
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.eval import visualize
    from sdbc_tpu_torch.models import bart
    from sdbc_tpu_torch.models.port import write_safetensors
    from sdbc_tpu_torch.ops import _kernels

    root = tempfile.mkdtemp(prefix="sdbc_summarize_")
    real = visualize.visualize_prompts
    try:
        t0 = time.perf_counter()
        bcfg = bart.BartConfig.distilbart_cnn()
        model = bart.init(bcfg, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
        ckpt = os.path.join(root, "distilbart")
        os.makedirs(ckpt)
        nbytes = write_safetensors(bart_transformers_sd(model),
                                   os.path.join(ckpt, "model.safetensors"))
        del model
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(BART_CONFIG, f)
        write_byte_bpe(ckpt, bcfg.vocab_size)
        data = os.path.join(root, "data")
        os.makedirs(data)
        rows = goodreads_rows(SUMMARIZE_ROWS)
        with open(os.path.join(data, "df_test.csv"), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["", "book_authors", "book_desc", "book_title"])
            w.writerows([(i, a, d, t) for i, a, d, t in rows])
        t1 = time.perf_counter()
        seen = []

        def spy(*a, **kw):
            out = real(*a, **kw)
            seen.append((kw["summarize"], kw["include_desc"], out[1],
                         kw["summarizer"]))
            return out

        visualize.visualize_prompts = spy
        argv = ["--mode", "default", "--summarize", "--bart_ckpt", ckpt,
                "--data_root", data, "--device", "cuda", "--seed", "0",
                "--samples_per_prompt", "1", "--num_inference_steps",
                str(SUMMARIZE_STEPS), "--save_dir", os.path.join(root, "out")]
        _kernels.reset_launch_counts()
        cli.main(argv)
        torch.cuda.synchronize()
        counts = dict(_kernels.launches)
        t2 = time.perf_counter()
        visualize.visualize_prompts = real
        grids = sorted(f for f in os.listdir(
            os.path.join(root, "out", "dev inference")) if f.endswith(".png"))
        if [s[:2] for s in seen] != [(False, False), (True, True),
                                     (False, True)]:
            fail(f"summarize: grid configs {[s[:2] for s in seen]}")
        summ = seen[1][3]  # the CLI's summarizer
        descs = [d for _, _, d, _ in rows]
        summ.ids(descs[0])  # warm-up
        ms, summaries = [], []
        for d in descs:
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            ids = summ.ids(d)
            ms.append((time.perf_counter() - s0) * 1e3)
            summaries.append(summ.tok.decode(ids.tolist()))
        card_trace, tf32_trace = [], []
        card_ids = summ.ids(descs[0], trace=card_trace)
        strict = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:  # the control: the same search with TF32 products
            bart.beam_search(summ.model, np.asarray(summ.tok.encode(
                descs[0], summ.input_max), np.int64)[None],
                num_beams=summ.num_beams, trace=tf32_trace)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = strict
        t3 = time.perf_counter()
        cpu_model = bart.init(bcfg, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   summ.model.state_dict().items()})
        cpu = bart.Summarizer(cpu_model, summ.tok)
        cpu_trace = []
        cpu_ids = cpu.ids(descs[0], trace=cpu_trace)
        t4 = time.perf_counter()
    finally:
        visualize.visualize_prompts = real
        shutil.rmtree(root, ignore_errors=True)
    n_tok = [sum(i != bcfg.pad_id for i in summ.tok.encode(d))
             for d in descs]
    print(f"[summarize] the --bart_ckpt dir (DistilBART-CNN-12-6 widths, "
          f"random from seed 0; {nbytes} bytes of fp32 weights), df_test "
          f"({SUMMARIZE_ROWS} rows, {[len(d.split()) for d in descs]} words, "
          f"{n_tok} tokens) written in {t1 - t0:.3f} s; cli.inference "
          f"--mode default --summarize DDIM-{SUMMARIZE_STEPS}: "
          f"{t2 - t1:.3f} s, grids {grids} | {smi}", flush=True)
    cfg = PipelineConfig.sd15()
    n = len(templates.TEST_TEMPLATES)
    want = dict.fromkeys(_kernels.launches, 0)
    for _ in range(3):
        for lo in range(0, n, 4):
            got = generate_launches(cfg, min(4, n - lo), SUMMARIZE_STEPS,
                                    512, "ddim")
            want = {k: want[k] + got[k] for k in want}
    print(f"[summarize] launches {nonzero(counts)} (expected "
          f"{nonzero(want)}) | {smi}", flush=True)
    if counts != want:
        fail(f"summarize: the grids launched {nonzero(counts)}, expected "
             f"{nonzero(want)}")
    tt = seen[1][2]
    missing = [i for i, p in enumerate(tt)
               if summaries[min(i, len(descs) - 1)] not in p]
    if len(tt) != n or missing or not all(summaries):
        fail(f"summarize: (T,T) prompts {missing} lack their summary "
             f"({summaries})")
    print(f"[summarize] card summaries {summaries}; (T,T) prompt 0 "
          f"{tt[0]!r}; ms per description (encode + {summ.num_beams} beams "
          f"× ≤ 15 steps) {[round(m, 1) for m in ms]}, median "
          f"{statistics.median(ms):.1f} | {smi}", flush=True)
    diff, gaps, first = beam_divergence(card_trace, cpu_trace,
                                        summ.num_beams)
    ctl, ctl_gaps, _ = beam_divergence(tf32_trace, cpu_trace,
                                       summ.num_beams)
    same = np.array_equal(card_ids, cpu_ids)
    print(f"[summarize] card ids {card_ids.tolist()} vs CPU strict fp32 "
          f"{cpu_ids.tolist()} ({t4 - t3:.1f} s on the CPU): "
          f"{'equal' if same else 'DIFFER'}; largest score difference "
          f"{diff:.3e} over the {len(gaps)} steps the beams agree (tol "
          f"{SUMMARY_SCORE_TOL:.1e}; with TF32 products {ctl:.3e} over "
          f"{len(ctl_gaps)}), smallest candidate gap {min(gaps):.3e} (per "
          f"step {[f'{g:.2e}' for g in gaps]}), first diverging step "
          f"{first} | {smi}", flush=True)
    if not diff <= SUMMARY_SCORE_TOL:
        fail(f"summarize: the card's strict fp32 scores differ from the "
             f"CPU's by {diff:.3e} > {SUMMARY_SCORE_TOL:.1e}")
    if not ctl > SUMMARY_SCORE_TOL:
        fail(f"summarize: TF32 products differ from the CPU's scores by "
             f"only {ctl:.3e}: {SUMMARY_SCORE_TOL:.1e} cannot tell them "
             f"from strict fp32")
    if not same:
        at = gaps[first - 1] if first else min(gaps)
        if not at < diff:
            fail(f"summarize: card ids differ from the CPU's with a gap "
                 f"{at:.3e} ≥ the score difference {diff:.3e}")
    return counts


def beam_divergence(trace_a, trace_b, beams: int):
    """Two ``beam_search`` traces of one input: (the largest difference of
    the candidate scores over the steps whose beams agree, each such
    step's smallest gap between adjacent candidates among trace_b's top
    2·beams + 1, the first step whose beams differ or None)."""
    import numpy as np

    diff, gaps = 0.0, []
    for step, ((beams_a, flat_a), (beams_b, flat_b)) in enumerate(
            zip(trace_a, trace_b)):
        if not np.array_equal(beams_a, beams_b):
            return diff, gaps, step
        live = flat_b > -1e8
        diff = max(diff, float(np.abs(flat_a - flat_b)[live].max()))
        top = np.sort(flat_b[live])[::-1][: 2 * beams + 1]
        # a step with one live candidate (the forced <s>) chooses nothing
        gaps.append(float(np.min(top[:-1] - top[1:])) if top.size > 1
                    else math.inf)
    first = None if len(trace_a) == len(trace_b) else len(gaps)
    return diff, gaps, first


# ---------------------------------------------------------------------------
# parallel: the port's data, FSDP and tensor parallelism on the one card

# (b)'s two ranks against the one-process result.  The DP and FSDP steps
# compute each micro-batch's rows in two halves (batch 1 instead of 2), so
# cuBLAS and the flash kernels run other shapes and the gradient mean sums
# in another order: bf16 rounding of every activation.  The loss is held
# to train-parity's TRAIN_LOSS_RTOL; the update (compared on every trained
# leaf at a fixed stride, PAR_SAMPLE elements a leaf at most) by its
# cosine with the one-process update, whose limit PAR_UPDATE_COS lies
# between the sound runs' readings and a control's: the DP step with the
# data-group mean left out (each rank's update from its own rows), which
# must read below it.  Read on the card (H100, 700 W): DP 0.99671, FSDP
# 0.99614, the control 0.55552 / 0.60516; the limit leaves 1 − cos at
# 0.05, ~13× the sound runs' and ~8× below the control's.  Both ranks must
# hold the same parameters, bit for bit.
PAR_SAMPLE = 65536
PAR_UPDATE_COS = 0.95
# TP and DP sampling against the exact (fp32) image of the one-process
# call on the same (bf16-valued) weights.  TP sums bf16 partial products
# over the model group (each rank's half of a contraction rounded to bf16,
# then the sum rounded again), DP runs batch 2 instead of 4 (other cuBLAS
# tiles): either call is another bf16 evaluation of the same function,
# with the one-process call's own distance from fp32 as its yardstick,
# g = max |bf16 − fp32| and its mean ḡ, measured in the run.  Each call is
# held to PAR_IMG_C·g in the max and PAR_IMG_C·ḡ in the mean, c taken from
# the readings (H100, 700 W): TP 0.945·g and 1.029·ḡ, DP 0.867·g and
# 0.995·ḡ (g = 2.103e-02, ḡ = 2.188e-03); the max, one pixel of 3.1M, is
# the noisier.  That the partitioned function is exact is held in fp32
# at the tiny config on the card: TP and DP against the rank's own
# one-process call within FP32_PARITY_TOL.
PAR_IMG_C = 1.25
PAR_TIMEOUT = 420   # seconds a rank may take for all its tasks


def _par_mode_c(**kw):
    """Mode C's config, one batch and the host draws (seeded: the same in
    every process)."""
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig
    from sdbc_tpu_torch.train.trainer import host_draws

    cfg = PipelineConfig.sd15()
    accum, micro = kw.pop("accum", 4), 2
    tcfg = _train_cfg(grad_accum=accum, micro_batch=micro,
                      num_examples=1000, **kw)
    g = torch.Generator().manual_seed(23)
    batch = {"pixel_values": torch.rand((accum, micro, 512, 512, 3),
                                        generator=g) * 2 - 1,
             "input_ids": torch.randint(0, cfg.clip.vocab_size,
                                        (accum, micro, cfg.clip.ctx),
                                        generator=g)}
    return cfg, tcfg, batch, host_draws(g, cfg, tcfg, batch)


def _par_state(cfg, tcfg):
    import torch

    from sdbc_tpu_torch.diffusion.pipeline import init_models
    from sdbc_tpu_torch.train.trainer import init_train_state

    gen = torch.Generator(device="cuda").manual_seed(0)
    return init_train_state(init_models(cfg, device="cuda", generator=gen),
                            tcfg)


def _par_samples(state, full=None) -> dict:
    """{parameter name: every PAR_SAMPLE-th-ish element, fp32 on the
    host} of the trained components; ``full`` gathers a shard first."""
    out = {}
    for comp in sorted(state.trainable):
        for n, p in state.trainable[comp].named_parameters():
            t = p.detach() if full is None else full(p)
            if t is None:
                continue
            flat = t.float().flatten()
            out[f"{comp}.{n}"] = flat[::max(1, flat.numel() // PAR_SAMPLE)
                                      ].cpu()
    return out


def _par_update_err(init: dict, final: dict, ref_final: dict):
    """(update cosine, max |Δ − Δref|) over the sampled elements."""
    import torch

    d = torch.cat([final[k] - init[k] for k in init]).double()
    r = torch.cat([ref_final[k] - init[k] for k in init]).double()
    return (float(d @ r / (d.norm() * r.norm())),
            float((d - r).abs().max()))


def _par_step(step, state, batch, draws, steps: int = 2):
    """``steps`` steps (the first a warm-up), their seconds and losses."""
    import torch

    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, draws=draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        if not m["finite"]:
            fail(f"parallel step skipped (non-finite), loss {m['loss']}")
    return times, losses


def _par_sample_kw(cfg):
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    return dict(height=512, width=512, num_inference_steps=10,
                guidance_scale=7.5,
                latents=per_sample_fixed_latents(4, (4, 64, 64), 42))


def parallel_rank(task_dir: str) -> int:
    """One rank of (b): two processes share the one card over gloo
    (``torch.distributed`` with its TCP rendezvous; NCCL refuses two
    ranks on one device).  Runs DP mode C, the FSDP step, TP sampling and
    DP sampling; writes what the parent compares to ``task_dir``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline, init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.parallel import comm
    from sdbc_tpu_torch.parallel.mesh import (MeshConfig,
                                              host_local_batch_indices,
                                              make_mesh)
    from sdbc_tpu_torch.parallel.shard import full_tensor
    from sdbc_tpu_torch.train.trainer import (make_train_step,
                                              shard_train_state)

    from sdbc_tpu_torch.utils.dtypes import set_fp32_matmul_exact

    rank = int(os.environ["SDBC_PROCESS_ID"])
    torch.cuda.set_device(0)
    set_fp32_matmul_exact()   # as phase_device sets the parent
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['COORDINATOR_ADDRESS']}",
        rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=PAR_TIMEOUT))
    dp = make_mesh(MeshConfig(data=2), device="cuda")
    tp = make_mesh(MeshConfig(model=2), device="cuda")
    out = {}

    def rows(batch, mesh):
        return {k: v[:, torch.from_numpy(host_local_batch_indices(
            v.shape[1], mesh))] for k, v in batch.items()}

    from sdbc_tpu_torch.train import trainer

    mean_over_data = trainer._mean_over_data
    for name, kw, shard in (("dp", {}, None),
                            ("dp_control", {}, None),
                            ("fsdp", dict(use_8bit_adam=False, accum=1),
                             dict(fsdp=True))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        comm.reset_staged()
        cfg, tcfg, batch, draws = _par_mode_c(**kw)
        state = _par_state(cfg, tcfg)
        if shard:
            shard_train_state(state, dp, **shard)
        step = make_train_step(cfg, tcfg, mesh=dp, dp_size=2)
        local = rows(batch, dp)
        # the control: each rank steps on its own rows' gradient, the
        # data-group mean left out, to show what the bounds tell apart
        trainer._mean_over_data = (mean_over_data if name != "dp_control"
                                   else lambda grads, params, mesh: None)
        try:
            times, losses = _par_step(step, state, local, draws, steps=1)
        finally:
            trainer._mean_over_data = mean_over_data
        # every rank gathers the full values: the ranks' replicas compared
        full = None if not shard else (
            lambda p: full_tensor(p, dst=None))
        samples = _par_samples(state, full)
        if name == "dp_control":
            out[name] = {"loss": losses[0], "samples": samples}
            del state, step
            continue
        mom = (sum(t.numel() for t in state.opt_state.inner.mu
                   + state.opt_state.inner.nu) * 4 if shard else 0)
        # a second step, timed (launch counts of that step)
        _kernels.reset_launch_counts()
        t2, l2 = _par_step(step, state, local, draws, steps=1)
        out[name] = {"loss": losses[0], "samples": samples,
                     "s_step": t2[0], "first_s": times[0],
                     "peak": torch.cuda.max_memory_allocated(),
                     "launches": dict(_kernels.launches),
                     "staged": dict(comm.STAGED), "moment_bytes": mom}
        del state, step
    for name, mesh in (("tp_sample", tp), ("dp_sample", dp)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        comm.reset_staged()
        cfg, _, _, _ = _par_mode_c()
        gen = torch.Generator(device="cuda").manual_seed(0)
        models = init_models(cfg, device="cuda", generator=gen,
                             dtype=torch.bfloat16)
        pipe = SDPipeline(models, cfg, _tokenizer(cfg), "cuda",
                          torch.bfloat16, mesh=mesh)
        # one call, no warm-up: the kernels are built and the gloo
        # all-reduces of the activations dominate the call
        _kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs = pipe(PROMPTS, **_par_sample_kw(cfg))
        torch.cuda.synchronize()
        out[name] = {"imgs": imgs, "s_call": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated(),
                     "launches": dict(_kernels.launches),
                     "staged": dict(comm.STAGED)}
        del pipe, models
    # the partitioned functions exact in fp32: the tiny config (64², batch
    # 4, DDIM-4, CFG 7.5) against this rank's own one-process call
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig

    tiny = PipelineConfig.tiny()
    models = init_models(tiny, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    tkw = dict(height=64, width=64, num_inference_steps=4,
               guidance_scale=7.5, seed=5)
    one = SDPipeline(models, tiny, _tokenizer(tiny), "cuda",
                     torch.float32)(PROMPTS, **tkw)
    for name, mesh in (("tp_tiny_fp32", tp), ("dp_tiny_fp32", dp)):
        import copy as _copy

        got = SDPipeline({k: _copy.deepcopy(m) for k, m in models.items()},
                         tiny, _tokenizer(tiny), "cuda", torch.float32,
                         mesh=mesh)(PROMPTS, **tkw)
        out[name] = float(abs(got - one).max())
    if "jax" in sys.modules:
        fail("jax was imported")
    torch.save(out, os.path.join(task_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _spawn_ranks(task_dir: str, n: int = 2):
    """``n`` rank processes of this script, each with its own timeout;
    past it every one of them is killed and the phase fails."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for i in range(n):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   SDBC_NUM_PROCESSES=str(n), SDBC_PROCESS_ID=str(i),
                   LOCAL_RANK="0")
        # each rank's output to a file: a pipe left unread while waiting
        # for the other rank could block it inside a collective
        logs.append(os.path.join(task_dir, f"rank{i}.log"))
        with open(logs[-1], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--parallel-rank", task_dir], env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
    t0 = time.perf_counter()
    for p in procs:
        left = PAR_TIMEOUT - (time.perf_counter() - t0)
        try:
            p.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(q.pid, signal.SIGKILL)
            for q in procs:
                q.wait()
            fail(f"parallel ranks timed out after {PAR_TIMEOUT} s")
    for i, (p, log) in enumerate(zip(procs, logs)):
        with open(log, errors="replace") as f:
            text = f.read()
        if p.returncode != 0:
            fail(f"parallel rank {i} exited {p.returncode}:\n{text[-6000:]}")


def phase_parallel(smi: str) -> dict:
    """(a) NCCL, world of 1 (a TCP store on a free port): mode C through
    the DP path (a 1×1 mesh) bit for bit against the bare step on the
    same batch and draws, 60 / 60 / 60 / 1 K5 / K6a / K6b / K7 launches,
    nothing staged through the host.  (b) Two ranks on the card over gloo
    (``parallel_rank``): DP mode C (micro-batch 1 + 1) and FSDP (fp32
    AdamW) against the one-process steps, TP and DP sampling (512², batch
    4, CFG 7.5, DDIM-10) against the one-process image, with their
    launches, s/step or s/call and each rank's peak GiB."""
    import datetime
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline, init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.parallel import comm
    from sdbc_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from sdbc_tpu_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    paths = {}
    # (a) -----------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    store = dist.TCPStore("127.0.0.1", port, 1, True,
                          timeout=datetime.timedelta(seconds=120))
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    old_det = torch.backends.cudnn.deterministic
    # bit for bit needs the same convolution algorithms in both steps
    torch.backends.cudnn.deterministic = True
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        cfg, tcfg, batch, draws = _par_mode_c()
        bare = _par_state(cfg, tcfg)
        init = _par_samples(bare)
        tb, lb = _par_step(make_train_step(cfg, tcfg), bare, batch, draws,
                           steps=1)
        ref8 = _par_samples(bare)
        ref8_params = [p.detach().clone() for p in
                       bare.trainable["unet"].parameters()] + [
            p.detach().clone() for p in
            bare.trainable["text_encoder"].parameters()]
        del bare
        gc.collect()
        torch.cuda.empty_cache()
        comm.reset_staged()
        state = _par_state(cfg, tcfg)
        step = make_train_step(cfg, tcfg, mesh=mesh)
        _kernels.reset_launch_counts()
        td, ld = _par_step(step, state, batch, draws, steps=1)
        counts_a = dict(_kernels.launches)
        got = [p.detach() for p in state.trainable["unet"].parameters()] \
            + [p.detach() for p in
               state.trainable["text_encoder"].parameters()]
        same = sum(bool(torch.equal(a, b)) for a, b in zip(got, ref8_params))
        t2, _ = _par_step(step, state, batch, draws, steps=1)
        staged_a = dict(comm.STAGED)
        del state, step, got, ref8_params
    finally:
        torch.backends.cudnn.deterministic = old_det
        dist.destroy_process_group()
    want = dict.fromkeys(_kernels.launches, 0)
    want.update(flash_fwd=60, flash_bwd_dq=60, flash_bwd_dkv=60, adam8=1)
    print(f"[parallel] (a) NCCL world 1, mode C through the DP path (1x1 "
          f"mesh) vs the bare step: loss {ld[0]!r} vs {lb[0]!r}, "
          f"{same}/{len(ref8)} trained tensors bit-equal, first step "
          f"{td[0]:.4f} s (bare {tb[0]:.4f} s), next {t2[0]:.4f} s/step, "
          f"launches {nonzero(counts_a)}, host-staged {staged_a} | {smi}",
          flush=True)
    if ld[0] != lb[0] or same != len(ref8):
        fail(f"parallel (a): the world-1 DP step differs from the bare "
             f"step (loss {ld[0]!r} vs {lb[0]!r}, {same}/{len(ref8)} "
             "tensors equal)")
    if counts_a != want:
        fail(f"parallel (a) launches {counts_a}, expected {want}")
    if any(staged_a.values()):
        fail(f"parallel (a): NCCL staged through the host: {staged_a}")
    paths["parallel dp world-1"] = counts_a
    # the one-process references of (b) ------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg32, tcfg32, batch32, draws32 = _par_mode_c(use_8bit_adam=False,
                                                  accum=1)
    one32 = _par_state(cfg32, tcfg32)
    init32 = _par_samples(one32)
    t32, l32 = _par_step(make_train_step(cfg32, tcfg32), one32, batch32,
                         draws32, steps=1)
    ref32 = _par_samples(one32)
    peak32 = torch.cuda.max_memory_allocated()
    mom32 = sum(t.numel() for t in one32.opt_state.inner.mu
                + one32.opt_state.inner.nu) * 4
    del one32
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = init_models(cfg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
    kw = _par_sample_kw(cfg)
    pipe = SDPipeline(models, cfg, _tokenizer(cfg), "cuda", torch.bfloat16)
    pipe(PROMPTS, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img1 = pipe(PROMPTS, **kw)
    torch.cuda.synchronize()
    s_one = time.perf_counter() - t0
    pipe32 = SDPipeline({k: m.float() for k, m in models.items()}, cfg,
                        _tokenizer(cfg), "cuda", torch.float32)
    img32 = pipe32(PROMPTS, **kw)
    del pipe, pipe32, models
    gc.collect()
    torch.cuda.empty_cache()
    bf16_gap = float(np.abs(img1 - img32).max())
    bf16_mean = float(np.abs(img1 - img32).mean())
    # (b) ------------------------------------------------------------------
    with tempfile.TemporaryDirectory() as task_dir:
        _spawn_ranks(task_dir)
        ranks = [torch.load(os.path.join(task_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    flash_dp, geglu_dp = expected_launches(cfg, 64, 4)
    flash_tp, _ = expected_launches(cfg, 64, 8)
    dp0, fs0 = ranks[0]["dp"], ranks[0]["fsdp"]
    cos, worst = _par_update_err(init, dp0["samples"], ref8)
    cos32, worst32 = _par_update_err(init32, fs0["samples"], ref32)
    cos_ctl = [_par_update_err(init, res["dp_control"]["samples"], ref8)[0]
               for res in ranks]
    lr = tcfg.learning_rate
    bad = []
    for r, res in enumerate(ranks):
        for name in ("dp", "fsdp"):
            x = res[name]
            print(f"[parallel] (b) rank {r} {name} mode C (micro 1 a rank, "
                  f"{'8-bit' if name == 'dp' else 'fp32'} AdamW, grad_accum "
                  f"{4 if name == 'dp' else 1}): {x['s_step']:.4f} s/step "
                  f"(first {x['first_s']:.4f} s), peak "
                  f"{x['peak'] / 2 ** 30:.2f} GiB, moments "
                  f"{x['moment_bytes'] / 2 ** 30:.3f} GiB, loss "
                  f"{x['loss']!r}, launches {nonzero(x['launches'])}, "
                  f"host-staged {x['staged']} | {smi}", flush=True)
        for name in ("tp_sample", "dp_sample"):
            x = res[name]
            if x["imgs"].shape != img1.shape:
                bad.append(f"{name} rank {r}: shape {x['imgs'].shape}")
                continue
            d32 = np.abs(x["imgs"] - img32)
            err, mean = float(d32.max()), float(d32.mean())
            d1 = np.abs(x["imgs"] - img1)
            print(f"[parallel] (b) rank {r} {name} SD-1.5 512^2 batch 4 "
                  f"DDIM-10 CFG 7.5 bf16: {x['s_call']:.4f} s/call (one "
                  f"call; one process {s_one:.4f}), peak "
                  f"{x['peak'] / 2 ** 30:.2f} GiB, |img - fp32| max "
                  f"{err:.3e} = {err / bf16_gap:.3f}·g, mean {mean:.3e} = "
                  f"{mean / bf16_mean:.3f}·ḡ (bound {PAR_IMG_C}·g, "
                  f"{PAR_IMG_C}·ḡ; the one-process call's g = {bf16_gap:.3e},"
                  f" ḡ = {bf16_mean:.3e}), |img - one-process bf16| max "
                  f"{float(d1.max()):.3e} mean {float(d1.mean()):.3e}, "
                  f"launches {nonzero(x['launches'])}, host-staged "
                  f"{x['staged']} | {smi}", flush=True)
            if err > PAR_IMG_C * bf16_gap or mean > PAR_IMG_C * bf16_mean:
                bad.append(f"{name} rank {r}: |img - fp32| max {err:.3e} "
                           f"mean {mean:.3e} (bounds "
                           f"{PAR_IMG_C * bf16_gap:.3e}, "
                           f"{PAR_IMG_C * bf16_mean:.3e})")
        print(f"[parallel] (b) rank {r} tiny fp32 64^2 batch 4 DDIM-4 CFG "
              f"7.5 against the rank's one-process call: TP max |d| "
              f"{res['tp_tiny_fp32']:.3e}, DP {res['dp_tiny_fp32']:.3e} "
              f"(tol {FP32_PARITY_TOL})", flush=True)
        for name in ("tp_tiny_fp32", "dp_tiny_fp32"):
            if res[name] > FP32_PARITY_TOL:
                bad.append(f"{name} rank {r}: {res[name]:.3e}")
    print(f"[parallel] (b) DP vs one process: loss {dp0['loss']!r} vs "
          f"{lb[0]!r} (rtol {TRAIN_LOSS_RTOL}), update cosine {cos:.5f} "
          f"(bound {PAR_UPDATE_COS}; the control without the data-group "
          f"mean: rank 0 {cos_ctl[0]:.5f}, rank 1 {cos_ctl[1]:.5f}), max "
          f"|dDelta| {worst:.3e} ({worst / lr:.3f}·lr); FSDP vs one process "
          f"(fp32 AdamW, {t32[0]:.4f} s/step, peak {peak32 / 2 ** 30:.2f} "
          f"GiB, moments {mom32 / 2 ** 30:.3f} GiB): loss {fs0['loss']!r} "
          f"vs {l32[0]!r}, cosine {cos32:.5f}, max |dDelta| {worst32:.3e} "
          f"({worst32 / lr:.3f}·lr) | {smi}", flush=True)
    if abs(dp0["loss"] - lb[0]) > TRAIN_LOSS_RTOL * abs(lb[0]) \
            or cos < PAR_UPDATE_COS:
        bad.append("DP mode C outside its bounds")
    if abs(fs0["loss"] - l32[0]) > TRAIN_LOSS_RTOL * abs(l32[0]) \
            or cos32 < PAR_UPDATE_COS:
        bad.append("FSDP step outside its bounds")
    if max(cos_ctl) >= PAR_UPDATE_COS:
        bad.append(f"the control without the data-group mean reads cosine "
                   f"{max(cos_ctl):.5f}, within the bound {PAR_UPDATE_COS}:"
                   " the bound cannot tell it apart")
    for name in ("dp", "fsdp"):
        a, b = (res[name]["samples"] for res in ranks)
        same = sum(bool(torch.equal(a[k], b[k])) for k in a)
        print(f"[parallel] (b) {name}: the two ranks' parameters bit-equal "
              f"in {same}/{len(a)} trained tensors (sampled)", flush=True)
        if a.keys() != b.keys() or same != len(a):
            bad.append(f"{name}: the ranks hold different parameters "
                       f"({same}/{len(a)} tensors equal)")
    for r, res in enumerate(ranks):
        if res["dp"]["loss"] != dp0["loss"]:
            bad.append(f"DP: rank {r}'s loss differs from rank 0's")
        f = res["fsdp"]
        # sharded leaves (≥ 4096 elements) hold all but ~0.1% of the
        # elements: each rank's moments are about half of one process's
        if f["moment_bytes"] > 0.55 * mom32 or f["peak"] >= peak32:
            bad.append(f"FSDP rank {r}: moments {f['moment_bytes']} B "
                       f"(one process {mom32}), peak {f['peak']} (one "
                       f"process {peak32}): not sharded")
        want_dp = dict.fromkeys(_kernels.launches, 0)
        want_dp.update(flash_fwd=60, flash_bwd_dq=60, flash_bwd_dkv=60,
                       adam8=1)
        want_fs = dict(want_dp, flash_fwd=15, flash_bwd_dq=15,
                       flash_bwd_dkv=15, adam8=0)
        want_tp = dict.fromkeys(_kernels.launches, 0)
        want_tp["flash_fixed"] = 10 * flash_tp
        want_dps = dict(want_tp, flash_fixed=10 * flash_dp,
                        geglu_ff=10 * geglu_dp)
        for name, w in (("dp", want_dp), ("fsdp", want_fs),
                        ("tp_sample", want_tp), ("dp_sample", want_dps)):
            if res[name]["launches"] != w:
                bad.append(f"{name} rank {r} launches "
                           f"{res[name]['launches']}, expected {w}")
            if not any(res[name]["staged"].values()) \
                    and name in ("fsdp", "dp_sample"):
                bad.append(f"{name} rank {r}: gloo on CUDA tensors staged "
                           "nothing")
    if bad:
        fail("parallel: " + "; ".join(bad))
    for name in ("dp", "fsdp", "tp_sample", "dp_sample"):
        paths[f"parallel {name} (rank 0)"] = ranks[0][name]["launches"]
    print(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s | {smi}",
          flush=True)
    return paths


def main() -> int:
    if not (ROOT / "sdbc_tpu_torch").is_dir():
        fail(f"run from a checkout of the repo: no sdbc_tpu_torch/ beside "
             f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    t0 = time.perf_counter()
    marks = [t0]

    def lap(label: str) -> None:
        """Print the seconds since the last mark (the phase budget)."""
        now = time.perf_counter()
        print(f"[time] {label} {now - marks[-1]:.1f} s (total "
              f"{now - t0:.1f} s)", flush=True)
        marks.append(now)

    smi = phase_device()
    build = phase_build()
    lap("device + build")
    rows = phase_kernels(build["gn"], build["int8"]) \
        + phase_train_kernels(build["adam8"]) + phase_simt_kernels() \
        + phase_tf32_kernels(smi)
    lap("kernel phases")
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
    lap("parity .. samplers")
    paths["export"] = phase_export(cfg, pipe, smi)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    lap("export")
    paths["summarize"] = phase_summarize(smi)
    torch.cuda.empty_cache()
    lap("summarize")
    paths.update(phase_generate(smi))
    torch.cuda.empty_cache()
    paths.update(phase_serve(smi))
    paths.update(phase_image_checks(smi))
    torch.cuda.empty_cache()
    lap("generate, serve, image-checks")
    paths.update(phase_families(smi))
    torch.cuda.empty_cache()
    lap("families")
    paths.update(phase_fp32_sampling(smi))
    torch.cuda.empty_cache()
    lap("fp32-sampling")
    phase_train_parity()
    phase_train_parity("grad_ckpt block + switches", SWITCHES,
                       grad_ckpt=True, remat_mode="block")
    paths["train fp32 (tiny)"] = phase_train_parity(
        "fp32", card_dtypes=(torch.float32,))[torch.float32]
    paths["train fp32"], _, _ = phase_train(smi, label="train fp32",
                                            compute_dtype=torch.float32)
    torch.cuda.empty_cache()
    paths["train"], sps, peak = phase_train(smi)
    ckpt, ckpt_sps = phase_train_ckpt(smi, (sps, peak))
    paths["train grad_ckpt block"] = ckpt["block"]
    paths["train grad_ckpt selective"] = ckpt["selective"]
    paths["train switches"], _, _ = phase_train(
        smi, steps=1, label="switches", env=SWITCHES, profile=False)
    torch.cuda.empty_cache()
    lap("train-parity .. switches")
    paths.update(phase_finetune_tiny())
    paths.update(phase_finetune(smi, {"none": sps, **ckpt_sps}))
    torch.cuda.empty_cache()
    lap("finetune")
    paths.update(phase_jax_ckpt(smi))
    torch.cuda.empty_cache()
    lap("jax-ckpt")
    family_paths, adam8_family = phase_families_train(smi)
    paths.update(family_paths)
    torch.cuda.empty_cache()
    lap("families-train")
    paths.update(phase_controlnet(smi))
    lap("controlnet")
    paths.update(phase_parallel(smi))
    torch.cuda.empty_cache()
    lap("parallel")
    next(r for r in rows if r["name"] == "adam8")["sdxl_step"] = \
        adam8_family
    if "jax" in sys.modules:
        fail("jax was imported")
    for row in rows:
        row.setdefault("path", MAIN_PATH[row["name"]])
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
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(sys.argv[2]))
    sys.exit(main())
