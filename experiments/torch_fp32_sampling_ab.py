"""Time the CLIs' --no-bf16 sampling call of one checkout of the port on
the card, for an A/B of two checkouts in one machine.

    python3 experiments/torch_fp32_sampling_ab.py [--root DIR] [--calls N]

Imports ``sdbc_tpu_torch`` from ``--root`` (default: this checkout; its
kernels build under ``DIR/build``), builds SD-1.5 at full width through
``cli.common.resolve_params_cfg`` on parsed ``cli.inference`` arguments
with ``--no-bf16`` (random weights from seed 0, fp32, TF32 off as
``chip_smoke.py`` sets it), and runs ``SDPipeline.generate`` with DDIM-10,
CFG 7.5, 512² on 4 prompts: a warm-up call, ``--calls`` timed calls (host
clock around synchronized calls), then one call under ``torch.profiler``
for the card time of the attention kernels (those whose name holds
``flash`` or ``split_kv``), of the fused FF's (``geglu`` or ``split_ff``)
and of all kernels, with the ten longest kernels by name.  Prints one JSON
line with the root, the card's name and power limit, each call's seconds,
those card times and counts in the profiled call, its launch counts and
the peak memory; ``--save F`` writes the profiled call's images to the
.npy file F, and ``--compare A B`` (no card) prints the largest
difference of two such files against the images' range.  Run the two
checkouts in turns (A, B, B, A) in one command: two calls may land on two
cards.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PROMPTS = ["a fantasy novel cover with a dragon over a castle",
           "a minimalist thriller book cover, red and black",
           "a romance novel cover at sunset on a beach",
           "a science fiction cover with a starship and a ringed planet"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    opts = ap.parse_args()
    if opts.compare:
        import numpy as np

        a, b = (np.load(f).astype(np.float64) for f in opts.compare)
        print(json.dumps({"compare": opts.compare,
                          "max_abs_diff": float(np.abs(a - b).max()),
                          "range": float(np.abs(a).max()),
                          "shape": list(a.shape)}), flush=True)
        return 0
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from sdbc_tpu_torch.cli import common
    from sdbc_tpu_torch.cli import inference as cli
    from sdbc_tpu_torch.diffusion.pipeline import SDPipeline
    from sdbc_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    t0 = time.perf_counter()
    _kernels.build()
    build_s = time.perf_counter() - t0
    args = cli.build_parser().parse_args(
        ["--no-bf16", "--scheduler", "ddim", "--num_inference_steps", "10",
         "--guidance_scale", "7.5", "--seed", "0"])
    common.resolve_img_size(args)
    models, cfg = common.resolve_params_cfg(args)
    pipe = SDPipeline(models, cfg,
                      common.make_tokenizer(args, cfg.clip.vocab_size),
                      device=args.device,
                      compute_dtype=common.compute_dtype(args))
    spec = cli.profile_spec(args, cfg).replace(
        height=args.img_size, width=args.img_size,
        num_inference_steps=args.num_inference_steps,
        guidance_scale=args.guidance_scale, seed=args.seed)
    pipe.generate(PROMPTS, spec)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(opts.calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.generate(PROMPTS, spec)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    _kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        imgs = pipe.generate(PROMPTS, spec)
        torch.cuda.synchronize()
    if opts.save:
        import numpy as np

        np.save(opts.save, np.asarray(imgs))
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    attn = [e for e in kern if "flash" in e.name or "split_kv" in e.name]
    ff = [e for e in kern if "geglu" in e.name or "split_ff" in e.name]
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    ms = lambda es: sum(e.time_range.elapsed_us() for e in es) / 1e3
    print(json.dumps({
        "root": opts.root, "device": smi, "build_s": build_s,
        "s_per_call": secs, "median_s": statistics.median(secs),
        "attention_kernel_ms": ms(attn), "attention_kernels": len(attn),
        "ff_kernel_ms": ms(ff), "ff_kernels": len(ff),
        "all_kernel_ms": ms(kern), "kernels": len(kern),
        "top_kernels_ms": dict(sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:10]),
        "launches": {k: v for k, v in _kernels.launches.items() if v},
        "peak_gib": peak / 2 ** 30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
