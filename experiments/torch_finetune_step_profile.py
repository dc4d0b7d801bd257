"""Where the fine-tuning CLI's step time goes, against the bare train step,
on the card.

    python3 experiments/torch_finetune_step_profile.py [--rounds N]

Builds the kernels (``chip_smoke.phase_build``), then in turns (bare, CLI,
CLI, bare, ... ``--rounds`` pairs): the bare mode-C step with remat
"block" (``init_train_state`` / ``make_train_step`` on a batch already on
the card, random SD-1.5 from seed 0, bf16: ``chip_smoke.phase_train``'s
setup) and ``sdbc_tpu_torch.cli.finetune.main`` with mode C's flags on 32
random PNG covers at 512² (4 steps, one checkpoint).  For the CLI it
splits each step's wall time (the loop's clock, as the CLI reports it)
into the train-step call and the rest of the loop (the loader's wait,
the batch's conversion, the host draws, the log), and profiles its
second step with ``torch.profiler``: card time of the kernels, kernel
launches, the host operators with the most self time (the profiled
step's wall is the profiler's, not the step's).  The bare step takes a
warm-up step, two timed steps and a profiled one.  Prints one JSON line
per round, then one with the medians of the unprofiled steps after the
warm-up, the card's name and power limit.
"""
import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled(fn):
    """(result, {kernel ms, launches, top host ops}) of one call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    avgs = prof.key_averages()
    kern = [e for e in avgs if dev(e) > 0
            and getattr(e, "device_type", None) == DeviceType.CUDA]
    host = sorted((e for e in avgs
                   if getattr(e, "device_type", None) != DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    return out, {"kernel_ms": round(sum(dev(e) for e in kern) / 1e3, 1),
                 "launches": sum(e.count for e in kern),
                 "host_ops": [(e.key[:32], round(e.self_cpu_time_total / 1e3,
                                                 1), e.count)
                              for e in host]}


@contextlib.contextmanager
def split_steps(profile_index: int = 1):
    """Wrap ``trainer.make_train_step``: each step call's wall seconds,
    and a profile of call ``profile_index``."""
    import torch

    from sdbc_tpu_torch.train import trainer

    seen = {"step_s": [], "profile": None}
    real = trainer.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(seen["step_s"]) == profile_index:
                out, seen["profile"] = profiled(lambda: step(*args,
                                                             **kwargs))
            else:
                out = step(*args, **kwargs)
                torch.cuda.synchronize()
            seen["step_s"].append(time.perf_counter() - t0)
            return out

        return wrapped

    trainer.make_train_step = make
    try:
        yield seen
    finally:
        trainer.make_train_step = real


def bare_round():
    """The bare mode-C step with remat "block": a warm-up step, two timed
    steps, a profiled one."""
    import torch

    import chip_smoke as c
    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.train.trainer import init_train_state, make_train_step

    cfg = PipelineConfig.sd15()
    tcfg = c._train_cfg(grad_accum=4, micro_batch=2, num_examples=1000,
                        grad_ckpt=True, remat_mode="block")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(init_models(cfg, device="cuda", generator=gen),
                             tcfg)
    step = make_train_step(cfg, tcfg)
    batch = {"pixel_values": torch.rand((4, 2, 512, 512, 3), generator=gen,
                                        device="cuda") * 2 - 1,
             "input_ids": torch.randint(0, cfg.clip.vocab_size, (4, 2, 77),
                                        generator=gen, device="cuda")}
    times = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 3:
            _, prof = profiled(lambda: step(state, batch, generator=gen))
        else:
            step(state, batch, generator=gen)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"step_s": [round(t, 4) for t in times], "profile": prof}


def cli_round(data: str, out: str):
    from sdbc_tpu_torch.cli import finetune

    shutil.rmtree(out, ignore_errors=True)
    argv = ["--device", "cuda", "--data_root", data, "--output_dir", out,
            "--train_unet", "--train_text_encoder", "--use_8bit_adam",
            "--batch_size", "2", "--grad_acc_steps", "4", "--img_size",
            "512", "--num_examples", "32", "--ckpts_per_epoch", "1",
            "--epochs", "1", "--seed", "0"]
    with split_steps() as seen:
        stats = finetune.main(argv)
    loop = stats["step_s"]
    return {"loop_s": [round(t, 4) for t in loop],
            "step_call_s": [round(t, 4) for t in seen["step_s"]],
            "outside_step_ms": [round(1e3 * (a - b), 1) for a, b in
                                zip(loop, seen["step_s"])],
            "loader_wait_ms": [round(1e3 * w, 2)
                               for w in stats["loader_wait_s"]],
            "profile": seen["profile"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    sys.path.insert(0, ROOT)
    import gc

    import torch

    import chip_smoke as c

    smi = c.phase_device()
    c.phase_build()
    root = tempfile.mkdtemp(prefix="sdbc_ft_prof_")
    rounds = []
    try:
        data = c.ft_dataset(os.path.join(root, "ds"), 32, 512)
        for r in range(opts.rounds):
            order = ("bare", "cli") if r % 2 == 0 else ("cli", "bare")
            res = {}
            for kind in order:
                gc.collect()
                torch.cuda.empty_cache()
                res[kind] = (bare_round() if kind == "bare" else
                             cli_round(data, os.path.join(root, "out")))
            rounds.append(res)
            print(json.dumps({"round": r, **res}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = lambda xs: round(statistics.median(xs), 4)
    print(json.dumps({
        "smi": smi,
        "bare_step_s": med([t for x in rounds
                            for t in x["bare"]["step_s"][1:3]]),
        "cli_loop_s": med([t for x in rounds for t in x["cli"]["loop_s"][2:]]),
        "cli_step_call_s": med([t for x in rounds
                                for t in x["cli"]["step_call_s"][2:]]),
        "cli_outside_step_ms": med([t for x in rounds
                                    for t in x["cli"]["outside_step_ms"][2:]])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
