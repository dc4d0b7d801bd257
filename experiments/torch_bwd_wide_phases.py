"""Where the wide flash backward's time goes on the card, phase by phase.

    python3 experiments/torch_bwd_wide_phases.py [probe ...]

Builds a copy of ``sdbc_tpu_torch/csrc/`` whose
``flash_bwd_wide_sm90.cu`` stamps ``clock64()`` at the phase boundaries of
every streamed tile (thread 0 of each consumer warpgroup of the first
cluster's two CTAs, stores only) into ``build/bwd_wide_phases/``, runs
``flash_bwd`` at the VAE's 512-wide head, (1, 1, 4096, 512), and prints,
for each kernel, CTA and consumer, the median over the tiles of the clocks
spent per tile in each phase: waiting for the next tile's loads and
issuing its score partial, refilling a column block of a ring stage (lane
0 of each warp), waiting for this tile's partials to land, reading them
and taking the exp2s, issuing the product over the sequence, waiting for
the tensor cores, the cluster barrier that frees the partials' slots, and
posting the next partial.
Each named probe builds its own copy with one change that breaks the
results, or moves a step, to show what a phase costs (``PROBES``); a
phase a probe moved reads 0 clocks.  Needs one H100;
imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import shutil
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ["next tile's partial issued", "refill", "exchange wait",
          "exp2, ds0", "product issued", "tensor wait", "cluster wait",
          "post"]
NT = 160  # tiles stamped per consumer
# the loop head, then one anchor per phase end (dk/dv, dq)
HEADS = ["  post_part(part);\n  for (int i = 0; i < x.n; ++i) {\n",
         "  post_part(part);\n  for (int j = 0; j < x.n; ++j) {\n"]
ENDS = [[a.replace("@", v) for a in (
    "    if (next) partial(nxt, @ + 1);\n",
    "    refill<L>(x, @ + STAGES - 1, W, t);  // into the stage of tile @ - 1\n",
    "    sm90::mbar_wait_cluster(x.xfull, @ & 1);  // tile @'s partials "
    "landed\n",
    "    sm90::cluster_arrive_relaxed();  // this thread is done with the "
    "slots\n",
    "    sm90::wgmma_commit();\n",
    "    sm90::wgmma_wait<0>();  // tile @ + 1's partial and tile @'s "
    "product\n",
    "    sm90::cluster_wait();  // every thread of the pair is done with the "
    "slots\n",
    "      for (int k = 0; k < BT / 2; ++k) part[k] = nxt[k];\n    }\n")]
    for v in "ij"]


# probe builds: (anchor, replacement) pairs; the results are wrong
PROBES = {
    # the refill without waiting for the stage's release (racy)
    "no-empty-wait": [("    sm90::mbar_wait(x.empty + j % STAGES, "
                       "((j - STAGES) / STAGES) & 1);", "    ;")],
    # the refill two tiles ahead, into the stage released a tile earlier
    # (its empty barrier long complete), with one stage fewer in flight
    "two-ahead": [(f"    refill<L>(x, {v} + STAGES - 1, W, t);",
                   f"    refill<L>(x, {v} + STAGES - 2, W, t);")
                  for v in "ij"]
                 + [("    for (int j = 0; j < STAGES - 1 && j < x.n; ++j)",
                     "    for (int j = 0; j < STAGES - 2 && j < x.n; ++j)")],
    # no ring refills after the first stages (tiles read stale data)
    "no-refill": [("  if (t % 32 != 0 || t / 32 >= x.ncb || j >= x.n) return;",
                   "  return;"),
                  ("    sm90::mbar_wait(x.full + st, (i / STAGES) & 1);",
                   "    if (i < STAGES - 1) sm90::mbar_wait(x.full + st, 0);"),
                  ("    sm90::mbar_wait(x.full + st, (j / STAGES) & 1);",
                   "    if (j < STAGES - 1) sm90::mbar_wait(x.full + st, 0);")],
}


def probe(src: str, name: str) -> str:
    for anchor, repl in PROBES[name]:
        if anchor not in src:
            raise SystemExit(f"torch_bwd_wide_phases: probe {name}: anchor "
                             f"{anchor!r} not in the source")
        src = src.replace(anchor, repl)
    return src


def instrument(src: str) -> str:
    # stamps[kernel][rank][consumer][tile][phase end], the loop head first
    src = src.replace("namespace {\n", "__device__ long long bw_ts[2][2][2]"
                      f"[{NT}][{len(PHASES) + 1}];\nnamespace {{\n", 1)
    for kern, var in ((0, "i"), (1, "j")):
        def stamp(k):
            return (f"    if (stamp_) bw_ts[{kern}][x.rank][W][{var} < {NT} "
                    f"? {var} : {NT - 1}][{k}] = clock64();\n")
        head = HEADS[kern]
        pos = src.index(head)
        decl = ("  const bool stamp_ = t == 0 && blockIdx.x < 2 && "
                "blockIdx.y == 0 && blockIdx.z == 0;\n")
        src = (src[:pos] + decl + head + stamp(0)
               + src[pos + len(head):])
        for k, anchor in enumerate(ENDS[kern], 1):
            at = src.find(anchor, pos)  # a probe may have moved it: 0 clocks
            pos = pos if at < 0 else at + len(anchor)
            src = src[:pos] + stamp(k) + src[pos:]
            pos += len(stamp(k))
    return src + ("\nextern \"C\" int bw_read(void* dst) {\n  return "
                  "(int)cudaMemcpyFromSymbol(dst, bw_ts, sizeof(bw_ts));\n}\n")


def run(name: str) -> None:
    import numpy as np
    import torch

    from sdbc_tpu_torch.ops import _kernels
    from sdbc_tpu_torch.ops import flash_attention as fa
    from sdbc_tpu_torch.ops import flash_attention_bwd as fb

    out = ROOT / "build" / "bwd_wide_phases" / name
    shutil.rmtree(out / "csrc", ignore_errors=True)
    shutil.copytree(ROOT / "sdbc_tpu_torch" / "csrc", out / "csrc")
    wide = out / "csrc" / "flash_bwd_wide_sm90.cu"
    src = wide.read_text()
    if name != "committed":
        src = probe(src, name)
    wide.write_text(instrument(src))
    _kernels.CSRC, _kernels.BUILD_DIR = out / "csrc", out
    _kernels._lib = None
    lib = _kernels.load()
    lib.bw_read.argtypes = [ctypes.c_void_p]

    b, h, s, d = 1, 1, 4096, 512
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device="cuda")
                   .bfloat16().transpose(1, 2) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_ref(q, k, v, scale)
    for _ in range(3):
        fb.flash_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    ts = np.zeros((2, 2, 2, NT, len(PHASES) + 1), dtype=np.int64)
    rc = lib.bw_read(ts.ctypes.data)
    if rc:
        raise SystemExit(f"torch_bwd_wide_phases: cudaMemcpyFromSymbol {rc}")
    ntile = s // 32
    for kern, kname in ((0, "dk/dv"), (1, "dq")):
        for rank in range(2):
            for w in range(2):
                t = ts[kern, rank, w, :ntile]
                per = [statistics.median(int(x) for x in t[:, p + 1] - t[:, p])
                       for p in range(len(PHASES))]
                tile = statistics.median(int(x) for x in
                                         t[1:, 0] - t[:-1, 0])
                print(f"[phases {name}] {kname} CTA {rank} consumer {w}: "
                      f"{tile} clocks a tile (median); by phase "
                      + ", ".join(f"{n} {c}" for n, c in zip(PHASES, per)),
                      flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bwd_wide_phases: needs a CUDA device")
    for name in ["committed"] + sys.argv[1:]:
        run(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
