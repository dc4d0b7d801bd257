"""Where the fused GroupNorm's time goes on the card, phase by phase.

    python3 experiments/torch_gn_phases.py

Builds a copy of ``sdbc_tpu_torch/csrc/group_norm_sm90.cu`` with
``%globaltimer`` stamps at its phase boundaries (thread 0 of the first CTA
of the first sample, and of the last CTA of the last sample) into
``build/gn_phases/`` with nvcc, then runs it at K8's shapes (those of
``chip_smoke.py``'s kernels phase) with the layout ``pallas_groupnorm``
plans for them.  Per shape it prints the kernel's span (the first CTA's
start to the last CTA's end, median of 5 launches) and the first CTA's
times since its start: mbarrier set up, bulk copy issued, bulk copy
landed, its partial sums written, the group sums done, the cluster
barrier passed, the sums exchanged, the statistics final, the resident
rows and then the re-read rows normalised.  Needs one H100; imports
nothing of JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPES = [("64^2x320 silu", (8, 4096, 320), True),
          ("32^2x640 silu", (8, 1024, 640), True),
          ("16^2x1280 silu", (8, 256, 1280), True),
          ("8^2x1280 silu", (8, 64, 1280), True),
          ("64^2x320 no act", (8, 4096, 320), False),
          ("ragged 200 rows x96", (2, 200, 96), True)]
PHASES = ["set up", "bulk issued", "landed", "partials", "group sums",
          "cluster wait", "exchanged", "final stats", "resident applied",
          "re-read applied"]
# (anchor in the source, stamp slot placed after it)
STAMPS = [
    ("  const int lane = tid / p.cv;\n", 0),
    ("  for (int i = tid; i < 2 * G; i += nthr) grp[i] = 0.f;\n"
     "  __syncthreads();\n", 1),
    ("  sm90::cluster_arrive_relaxed();\n", 2),
    ("        if (cb == 0 && res > 0) sm90::mbar_wait(bar, 0);\n", 3),
    ("        r2[k] = s2[k];\n      }\n", 4),
    ("      if (task < tasks && k == 0) grp[st * G + g] += acc;\n"
     "    }\n    __syncthreads();\n", 5),
    ("  sm90::cluster_wait();\n", 6),
    ("  sm90::cluster_sync();\n", 7),
    ("    grp[G + g] = rsqrtf(var + p.eps);\n  }\n  __syncthreads();\n", 8),
    ("      apply_rows<T, W, SILU>(slab, y, C, col, lane, res, p.lanes, a, "
     "b);\n", 9),
    ("      apply_rows<T, W, SILU>(x, y, C, col, res + lane, rows, p.lanes, "
     "a, b);\n", 10),
]
NSLOT = 16


def stamp(k: int) -> str:
    first = "blockIdx.y == 0 && rank == 0"
    last = "blockIdx.y == gridDim.y - 1 && rank == p.cs - 1"
    return (f"  if (tid == 0) {{ unsigned long long t_; asm volatile("
            f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"if ({first}) gn_ts[{k}] = t_; "
            f"if ({last}) gn_ts[{NSLOT} + {k}] = t_; "
            f"{'atomicMin(&gn_span[0], t_);' if k == 0 else ''} }}\n")


def instrument(src: str) -> str:
    src = src.replace("namespace {\n", "__device__ unsigned long long "
                      f"gn_ts[{2 * NSLOT}], gn_span[2];\nnamespace {{\n", 1)
    for anchor, k in STAMPS:
        if anchor not in src:
            raise SystemExit(f"torch_gn_phases: anchor of stamp {k} not in "
                             f"the source: {anchor!r}")
        src = src.replace(anchor, anchor + stamp(k), 1)
    # the kernel's end: every thread done, the last end kept
    end = src.index("using Kernel = void (*)(Params);")
    brace = src.rindex("}\n", 0, end)
    src = (src[:brace] + "  __syncthreads();\n  if (tid == 0) { unsigned "
           "long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
           "\"=l\"(t_)); atomicMax(&gn_span[1], t_); }\n" + src[brace:])
    return src + r'''
extern "C" int gn_phases_read(unsigned long long* ts,
                              unsigned long long* span) {
  cudaMemcpyFromSymbol(ts, gn_ts, sizeof(gn_ts));
  return (int)cudaMemcpyFromSymbol(span, gn_span, sizeof(gn_span));
}
extern "C" int gn_phases_reset() {
  unsigned long long s[2] = {~0ull, 0ull};
  return (int)cudaMemcpyToSymbol(gn_span, s, sizeof(s));
}
'''


def build():
    from sdbc_tpu_torch.ops import _kernels

    out = ROOT / "build" / "gn_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "sm90.cuh").write_text((_kernels.CSRC / "sm90.cuh").read_text())
    (out / "gn_phases.cu").write_text(
        instrument((_kernels.CSRC / "group_norm_sm90.cu").read_text()))
    cmd = ([_kernels._nvcc()] + _kernels.NVCC_FLAGS
           + ["-shared", "-o", str(out / "libgn_phases.so"),
              str(out / "gn_phases.cu")])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"torch_gn_phases: nvcc failed:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "libgn_phases.so"))
    lib.sdbc_group_norm.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.POINTER(_kernels.GroupNormLaunch), ctypes.c_void_p]
    return lib


def main() -> int:
    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import pallas_groupnorm as pgn

    if not torch.cuda.is_available():
        raise SystemExit("torch_gn_phases: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[phases] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    lib = build()
    _kernels.load()
    g = torch.Generator(device="cuda").manual_seed(1234)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (n, hw, c), silu in SHAPES:
        x = (torch.randn((n, hw, c), generator=g, device="cuda") * 2
             + 0.5).bfloat16()
        w = (torch.randn(c, generator=g, device="cuda") * 0.3
             + 1.0).bfloat16()
        b = (torch.randn(c, generator=g, device="cuda") * 0.2).bfloat16()
        p = pgn._card_plan(n, hw, c, x.dtype, 32, True, silu, 0)
        launch = _kernels.group_norm_launch(n, hw, c, 32, p, 1e-5, silu,
                                            x.dtype, w.dtype, b.dtype)
        y = torch.empty_like(x)
        runs = []
        for _ in range(6):
            lib.gn_phases_reset()
            torch.cuda.synchronize()
            rc = lib.sdbc_group_norm(x.data_ptr(), w.data_ptr(),
                                     b.data_ptr(), y.data_ptr(), launch,
                                     stream)
            torch.cuda.synchronize()
            if rc:
                raise SystemExit(f"torch_gn_phases: launch failed ({rc})")
            ts = (ctypes.c_ulonglong * (2 * NSLOT))()
            span = (ctypes.c_ulonglong * 2)()
            lib.gn_phases_read(ts, span)
            runs.append(((span[1] - span[0]) / 1e3,
                         [(ts[k] - ts[0]) / 1e3 for k in range(1, 11)]))
        ref = pgn.group_norm_fused_ref(x.float(), w, b, 32, 1e-5,
                                       "silu" if silu else None)
        err = (y.float() - ref).abs().max().item()
        runs = sorted(runs[1:])  # the first launch warms up
        span, phases = runs[len(runs) // 2]
        print(f"[phases] {label}: cluster {p.cluster}, resident "
              f"{p.resident}/{p.rows_max} rows, max abs err {err:.3e}; span "
              f"{span:.2f} us (of 5: "
              f"{', '.join(f'{s:.2f}' for s, _ in runs)}); first CTA, us "
              f"since its start: " + ", ".join(
                  f"{name} {t:.2f}" for name, t in zip(PHASES, phases)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
