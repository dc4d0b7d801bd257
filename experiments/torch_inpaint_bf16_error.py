"""How far bf16 sampling lies from fp32 on the tiny inpainting runs, and
where the difference comes from.

    python3 experiments/torch_inpaint_bf16_error.py [--device cuda] [--seeds 8]

Uses ``chip_smoke.py``'s tiny sampler-parity set-up (``tiny_sampler_setup``:
the same bf16-valued weights, prompts, start latents, init image and mask)
and runs a few of its cases, bf16 on ``--device`` (on the card through the
kernels; on the CPU through their plain versions) against fp32 on the CPU,
over ``--seeds`` sets of injected draws (set 0 is ``chip_smoke.py``'s, the
others fresh from seeds 101, 102, ...).  Per case it prints the image's max
abs error over the sets, on set 0 by half of the image (the mask's
regenerated half and the kept half) and the image column where the
largest error lies in each set, the final latents' error by half and
their largest magnitude, the share of fp32 image values strictly inside
(0, 1) (the rest are clamped), and how much of the image error the decode
adds: the bf16 latents through the fp32 decoder, and the fp32 latents
through the bf16 decoder.  For the two inpainting cases it then runs the
UNet alone in bf16 on ``--device`` inside an fp32 loop (text encoder,
scheduler, blend and VAE in fp32 on the CPU), at guidance 7.5 and 1.0,
against the same loop all in fp32, over the same sets.  On the card it
also repeats set 0 of the first case three times and says whether the
images agree bit for bit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (label, scheduler, sample options): chip_smoke.py's "inpaint ddpm" and
# "init_image" runs, and their neighbours
CASES = [("inpaint ddpm", "ddpm", dict(init_image="img", mask="mask",
                                       t_start=2)),
         ("inpaint ddim", "ddim", dict(init_image="img", mask="mask",
                                       t_start=2)),
         ("init_image ddpm", "ddpm", dict(init_image="img", t_start=2)),
         ("init_image ddim", "ddim", dict(init_image="img", t_start=1)),
         ("ddpm", "ddpm", {})]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from sdbc_tpu_torch.diffusion import graph
    from sdbc_tpu_torch.models import unet as unet_mod
    from sdbc_tpu_torch.models import vae as vae_mod

    dev = args.device
    st = cs.tiny_sampler_setup(dev)
    cfg, inputs = st["cfg"], st["inputs"]
    shape = st["lat"].shape
    draw_sets = [st["draws"]]
    for s in range(1, args.seeds):
        g = torch.Generator().manual_seed(100 + s)
        draw_sets.append({"enc": torch.randn(shape, generator=g),
                          "step": [torch.randn(shape, generator=g)
                                   for _ in range(5)]})
    half = shape[2] // 2  # latent columns < half: mask = 1 (regenerate)

    def run(where, scheduler, kw, draws, gs=7.5, **extra):
        on, dt, mods = ((dev, torch.bfloat16, st["card"]) if where == "card"
                        else ("cpu", torch.float32, st["cpu"]))
        kw = {k: (inputs[v] if isinstance(v, str) else v) for k, v in
              kw.items()}
        kw = {k: v.to(on) if torch.is_tensor(v) else v for k, v in
              kw.items()}
        rcfg = dataclasses.replace(cfg, scheduler=scheduler)
        out = graph.sample(mods, st["ids"].to(on), st["uids"].to(on),
                           st["lat"].to(on), gs, cfg=rcfg,
                           num_inference_steps=4, compute_dtype=dt,
                           draws=draws, **kw, **extra)
        return out.float().cpu()

    def decode(where, z):
        mods = st["card"] if where == "card" else st["cpu"]
        on = dev if where == "card" else "cpu"
        dt = torch.bfloat16 if where == "card" else torch.float32
        with torch.no_grad():
            img = vae_mod.decode(mods["vae"], (z / cfg.vae.scaling_factor)
                                 .to(on, dt)).float().cpu()
        return ((img + 1.0) / 2.0).clamp(0.0, 1.0)

    print(f"bf16 on {dev} against fp32 on the CPU, tiny config, 4 steps, "
          f"{args.seeds} draw sets", flush=True)
    for label, scheduler, kw in CASES:
        errs = []
        for draws in draw_sets:
            d = (run("card", scheduler, kw, draws)
                 - run("cpu", scheduler, kw, draws)).abs()
            errs.append((d.max().item(), d[:, :, :2 * half].max().item(),
                         d[:, :, 2 * half:].max().item(),
                         d.amax(dim=(0, 1, 3)).argmax().item()))
        e = np.array(errs)
        z = {w: run(w, scheduler, kw, draw_sets[0], decode=False)
             for w in ("card", "cpu")}
        dz = (z["card"] - z["cpu"]).abs()
        ref = run("cpu", scheduler, kw, draw_sets[0])
        inside = ((ref > 0) & (ref < 1)).float().mean().item()
        through32 = (decode("cpu", z["card"]) - decode("cpu", z["cpu"])
                     ).abs().max().item()
        bf_dec = (decode("card", z["cpu"]) - decode("cpu", z["cpu"])
                  ).abs().max().item()
        print(f"{label}: image max abs err over the sets max {e[:, 0].max():.3e}"
              f" median {np.median(e[:, 0]):.3e} min {e[:, 0].min():.3e}; "
              f"set 0 {e[0, 0]:.3e} (regenerated half {e[0, 1]:.3e}, kept "
              f"half {e[0, 2]:.3e}); largest error in image column "
              f"{sorted(int(c) for c in e[:, 3])} of {2 * shape[2]} "
              f"(regenerated below {2 * half}); final latents err regenerated "
              f"{dz[:, :, :half].max().item():.3e} kept "
              f"{dz[:, :, half:].max().item():.3e}, |z| max "
              f"{z['cpu'].abs().max().item():.2f}; fp32 image values inside "
              f"(0, 1) {100 * inside:.1f}%; bf16 latents through the fp32 "
              f"decode {through32:.3e}; bf16 decode of the fp32 latents "
              f"{bf_dec:.3e}", flush=True)
    fp32_apply = unet_mod.apply

    def move(x):
        """``x`` (tensors, and dicts, lists and tuples of them) on ``dev``,
        floating tensors in bf16."""
        if torch.is_tensor(x):
            return x.to(dev, torch.bfloat16 if x.is_floating_point()
                        else x.dtype)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        return x

    def bf16_unet(unet, *args, **kw):
        """The bf16 UNet on ``dev`` in place of the fp32 one."""
        out = fp32_apply(st["card"]["unet"], *map(move, args),
                         **{k: move(v) for k, v in kw.items()})
        return out.float().cpu()

    for label, scheduler, kw in CASES[:2]:
        for gs in (7.5, 1.0):
            errs = []
            for draws in draw_sets:
                ref = run("cpu", scheduler, kw, draws, gs)
                unet_mod.apply = bf16_unet
                try:
                    got = run("cpu", scheduler, kw, draws, gs)
                finally:
                    unet_mod.apply = fp32_apply
                errs.append((got - ref).abs().max().item())
            print(f"{label}, guidance {gs}: the UNet alone in bf16 on {dev} "
                  f"in an fp32 loop: image max abs err over the sets max "
                  f"{max(errs):.3e} median {np.median(errs):.3e}", flush=True)
    if dev != "cpu":
        label, scheduler, kw = CASES[0]
        imgs = [run("card", scheduler, kw, draw_sets[0]) for _ in range(3)]
        same = all(torch.equal(imgs[0], x) for x in imgs[1:])
        print(f"{label}, set 0, three runs on the card: bit-identical "
              f"{same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
