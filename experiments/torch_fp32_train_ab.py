"""Time the fp32 mode-C fine-tuning step of one checkout of the port on the
card, for an A/B of two checkouts in one machine.

    python3 experiments/torch_fp32_train_ab.py [--root DIR] [--steps N]

Imports ``sdbc_tpu_torch`` from ``--root`` (default: this checkout; its
kernels build under ``DIR/build``), builds SD-1.5 at full width (random
weights from seed 0) and the JAX bench's mode C through
``init_train_state`` / ``make_train_step`` in fp32 compute (the finetune
CLI's --no-bf16; TF32 off as ``chip_smoke.py`` sets it): UNet and text
encoder trained, 8-bit AdamW, 512², micro-batch 2, 4 micro-batches a step,
a synthetic batch from seed 0.  A warm-up step, ``--steps`` timed steps
(host clock around synchronized steps), then one step under
``torch.profiler`` for the card time of the attention backward kernels
(those whose name holds ``flash_bwd``, ``split_bwd`` or ``flash_simt_d``)
and of every attention kernel (``flash`` or ``split_``).  Prints one JSON
line with the root, the card's name and power limit, each step's seconds,
the kernels' ms and counts in the profiled step, its launch counts and the
peak memory.  Run the two checkouts in turns (A, B, B, A) in one command:
two calls may land on two cards.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=2)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.train.trainer import (TrainConfig, init_train_state,
                                              make_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    _kernels.build()
    build_s = time.perf_counter() - t0
    cfg = PipelineConfig.sd15()
    accum, micro = 4, 2
    tcfg = TrainConfig(train_text_encoder=True, train_unet=True,
                       use_8bit_adam=True, grad_accum=accum,
                       micro_batch=micro, num_examples=1000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(init_models(cfg, device="cuda", generator=gen),
                             tcfg, compute_dtype=torch.float32)
    step = make_train_step(cfg, tcfg, compute_dtype=torch.float32)
    batch = {"pixel_values": torch.rand((accum, micro, 512, 512, 3),
                                        generator=gen, device="cuda") * 2 - 1,
             "input_ids": torch.randint(0, cfg.clip.vocab_size,
                                        (accum, micro, cfg.clip.ctx),
                                        generator=gen, device="cuda")}
    state, m = step(state, batch, generator=gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], [m["loss"]]
    for _ in range(opts.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    _kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch, generator=gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    bwd = [e for e in kernels if any(n in e.name for n in (
        "flash_bwd", "split_bwd", "flash_simt_d"))]
    attn = [e for e in kernels if "flash" in e.name or "split_" in e.name]
    ms = lambda evs: sum(e.time_range.elapsed_us() for e in evs) / 1e3
    print(json.dumps({
        "root": opts.root, "device": smi, "build_s": build_s,
        "s_per_step": secs, "median_s": statistics.median(secs),
        "losses": losses, "backward_kernel_ms": ms(bwd),
        "backward_kernels": len(bwd), "attention_kernel_ms": ms(attn),
        "attention_kernels": len(attn), "all_kernel_ms": ms(kernels),
        "launches": {k: v for k, v in _kernels.launches.items() if v},
        "peak_gib": peak / 2 ** 30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
