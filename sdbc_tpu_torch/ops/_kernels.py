"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` for ``sm_90a``, one
``nvcc -c`` per source file, all started together, then linked into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v -c -o <obj>/<name>.o csrc/<name>.cu        # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/sdbc_tpu_torch/libsdbc_kernels-<hash>.so <obj>/*.o

The library's name carries a hash of the sources and the commands, so an
edit rebuilds it and an unchanged tree reuses it; a file lock keeps
concurrent processes from building twice.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library.

Every launch adds one to ``launches[<kernel>]`` right after the kernel was
enqueued without error, and nowhere else — a run reads the counts to show
that its path went through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sdbc_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v"]
LINK_FLAGS = ARCH + ["-shared"]

launches = {"flash_fixed": 0, "geglu_ff": 0, "flash_fwd": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "adam8": 0, "gn_fused": 0,
            "flash_tt": 0, "flash_fixed_int8": 0, "flash_fixed_simt": 0,
            "flash_fwd_simt": 0, "flash_bwd_simt_dq": 0,
            "flash_bwd_simt_dkv": 0, "geglu_ff_simt": 0,
            "flash_fixed_tf32": 0, "flash_fwd_tf32": 0,
            "flash_bwd_dq_tf32": 0, "flash_bwd_dkv_tf32": 0,
            "geglu_ff_tf32": 0}

_lib = None
build_seconds = None  # wall time of the last build (None: reused or unbuilt)


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = shutil.which("nvcc")
    if path is None and CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ["|"] + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsdbc_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same sources exists."""
    global build_seconds
    lib = library_path()
    if lib.exists():
        return lib
    with build_lock():
        if lib.exists():  # another process built it while we waited
            return lib
        t0 = time.perf_counter()
        _compile_and_link(_nvcc(), lib)
        build_seconds = time.perf_counter() - t0
    return lib


@contextlib.contextmanager
def build_lock():
    """Holds ``BUILD_DIR/build.lock``, so that concurrent processes (test
    workers, ranks) build a library once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile_and_link(nvcc: str, lib: Path) -> None:
    objdir = BUILD_DIR / f"obj-{os.getpid()}"
    shutil.rmtree(objdir, ignore_errors=True)
    objdir.mkdir()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = ([nvcc] + NVCC_FLAGS
               + ["-c", "-o", str(objdir / f"{src.stem}.o"), str(src)])
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (rc {proc.returncode}):\n{err[-3000:]}")
    if not failed:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = ([nvcc] + LINK_FLAGS + ["-o", str(tmp)]
               + [c[c.index("-o") + 1] for c, _ in jobs])
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link (rc {res.returncode}):\n{res.stderr[-3000:]}")
    (BUILD_DIR / "nvcc.log").write_text("\n".join(log))
    shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.sdbc_flash_fixed.argtypes = ([p] * 4 + [i] * 5 + [ll] * 12
                                     + [f, p])
    lib.sdbc_flash_fixed.restype = i
    lib.sdbc_geglu_ff.argtypes = [p] * 8 + [i, i, f, p]
    lib.sdbc_geglu_ff.restype = i
    llp = ctypes.POINTER(ll)
    lib.sdbc_flash_fwd_sm90.argtypes = [p] * 5 + [i] * 5 + [llp, f, p]
    lib.sdbc_flash_fwd_sm90.restype = i
    lib.sdbc_flash_fwd_wide_sm90.argtypes = [p] * 5 + [i] * 5 + [llp, f, p]
    lib.sdbc_flash_fwd_wide_sm90.restype = i
    lib.sdbc_flash_fixed_wide_sm90.argtypes = [p] * 4 + [i] * 5 + [llp, f, p]
    lib.sdbc_flash_fixed_wide_sm90.restype = i
    lib.sdbc_flash_bwd_dq_sm90.argtypes = [p] * 7 + [i] * 6 + [llp, f, p]
    lib.sdbc_flash_bwd_dq_sm90.restype = i
    lib.sdbc_flash_bwd_dkv_sm90.argtypes = [p] * 8 + [i] * 6 + [llp, p]
    lib.sdbc_flash_bwd_dkv_sm90.restype = i
    lib.sdbc_flash_bwd_dq_wide_sm90.argtypes = [p] * 7 + [i] * 6 + [llp, f, p]
    lib.sdbc_flash_bwd_dq_wide_sm90.restype = i
    lib.sdbc_flash_bwd_dkv_wide_sm90.argtypes = [p] * 8 + [i] * 6 + [llp, p]
    lib.sdbc_flash_bwd_dkv_wide_sm90.restype = i
    lib.sdbc_adam8_leaves.argtypes = [p, i, ll] + [f] * 9 + [p]
    lib.sdbc_adam8_leaves.restype = i
    lib.sdbc_flash_fwd_tt_wide_sm90.argtypes = ([p] * 5 + [i] * 5
                                                + [llp, f, p])
    lib.sdbc_flash_fwd_tt_wide_sm90.restype = i
    lib.sdbc_flash_fwd_tt_sm90.argtypes = [p] * 5 + [i] * 5 + [llp, f, p]
    lib.sdbc_flash_fwd_tt_sm90.restype = i
    lib.sdbc_group_norm.argtypes = [p] * 4 + [
        ctypes.POINTER(GroupNormLaunch), p]
    lib.sdbc_group_norm.restype = i
    lib.sdbc_group_norm_max_clusters.argtypes = [i] * 6 + [
        ctypes.POINTER(i)]
    lib.sdbc_group_norm_max_clusters.restype = i
    lib.sdbc_flash_int8_sm90.argtypes = [p] * 6 + [i] * 5 + [llp, f, p]
    lib.sdbc_flash_int8_sm90.restype = i
    lib.sdbc_flash_simt_fwd.argtypes = [p] * 5 + [i] * 7 + [llp, f, p]
    lib.sdbc_flash_simt_fwd.restype = i
    lib.sdbc_flash_simt_bwd.argtypes = [p] * 8 + [i] * 8 + [llp, f, p]
    lib.sdbc_flash_simt_bwd.restype = i
    lib.sdbc_geglu_ff_simt.argtypes = [p] * 8 + [i] * 3 + [f, p]
    lib.sdbc_geglu_ff_simt.restype = i
    lib.sdbc_flash_tf32_sm90.argtypes = [p] * 6 + [i] * 6 + [llp, f, p]
    lib.sdbc_flash_tf32_sm90.restype = i
    lib.sdbc_flash_tf32_wide_sm90.argtypes = ([p] * 6 + [i] * 6
                                              + [llp, f, p])
    lib.sdbc_flash_tf32_wide_sm90.restype = i
    lib.sdbc_geglu_ff_tf32.argtypes = [p] * 9 + [i, i, f, p]
    lib.sdbc_geglu_ff_tf32.restype = i
    lib.sdbc_flash_bwd_dq_tf32_sm90.argtypes = ([p] * 8 + [i] * 6
                                                + [llp, llp, f, f, p])
    lib.sdbc_flash_bwd_dq_tf32_sm90.restype = i
    lib.sdbc_flash_bwd_dkv_tf32_sm90.argtypes = [p] * 5 + [i] * 6 + [llp, p]
    lib.sdbc_flash_bwd_dkv_tf32_sm90.restype = i
    lib.sdbc_error_string.argtypes = [i]
    lib.sdbc_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sdbc_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _stream(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _device(t):
    """The device context for a launch on ``t``'s card: none when that card
    is already the current one (entering ``torch.cuda.device`` costs host
    time on every launch)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def flash_fixed(q, k, v, o, qscale: float) -> None:
    """Launch the fixed-cap attention kernel on (B, S, H, D) logical views
    (any batch/seq/head strides, contiguous head dim).  The caller checks
    shapes and dtypes (``ops.flash_attention``)."""
    lib = load()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    with _device(q):
        rc = lib.sdbc_flash_fixed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), b, h, sq, sk, d, *strides,
                                  float(qscale), _stream(q))
    _check(lib, rc, "flash_fixed")
    launches["flash_fixed"] += 1


def flash_fixed_wide(q, k, v, o, qscale: float) -> None:
    """The fixed cap for head dims in (256, 512] (the VAE's 512-wide head):
    the fixed-cap variant of ``csrc/flash_fwd_wide_sm90.cu``'s kernel on
    (B, H, S, D) logical views (any batch/head/seq strides that are
    multiples of 8, contiguous head dim).  Counted as a launch of
    ``flash_fixed``: the same function.  The caller checks shapes and
    dtypes (``ops.flash_attention``)."""
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = lib.sdbc_flash_fixed_wide_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, sq,
            k.shape[2], d, _bhs_strides(q, k, v, o), float(qscale),
            _stream(q))
    _check(lib, rc, "flash_fixed")
    launches["flash_fixed"] += 1


def geglu_ff(y, gamma, beta, w1, b1, w2, b2, out, eps: float) -> None:
    """Launch the fused GEGLU kernel over (rows, c).  The caller checks
    shapes and dtypes (``ops.geglu_ff``)."""
    lib = load()
    rows, c = y.shape
    with _device(y):
        rc = lib.sdbc_geglu_ff(y.data_ptr(), gamma.data_ptr(),
                               beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                               rows, c, float(eps), _stream(y))
    _check(lib, rc, "geglu_ff")
    launches["geglu_ff"] += 1


def _bhs_strides(*tensors):
    """(batch, head, seq) strides of (B, H, S, D) logical views, as the C
    array the training kernels take."""
    out = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(out))(*out)


def flash_fwd(q, k, v, o, lse, qscale: float) -> None:
    """Launch the training forward for head dims up to 256 (the wgmma
    kernel of ``csrc/flash_fwd_sm90.cu``) on (B, H, S, D) logical views (any
    batch/head/seq strides that are multiples of 8, contiguous head dim);
    ``lse`` is a contiguous (B, H, Sq) fp32 output.  The caller checks
    shapes and dtypes (``ops.flash_attention``)."""
    _launch_fwd("sdbc_flash_fwd_sm90", q, k, v, o, lse, qscale)


def flash_fwd_wide(q, k, v, o, lse, qscale: float) -> None:
    """``flash_fwd`` for head dims in (256, 512] (the VAE's 512-wide head):
    the TMA-fed wgmma kernel of ``csrc/flash_fwd_wide_sm90.cu``, a cluster
    of two CTAs per 64-row q tile.  Counted as a launch of ``flash_fwd``:
    the same function."""
    _launch_fwd("sdbc_flash_fwd_wide_sm90", q, k, v, o, lse, qscale)


def _launch_fwd(entry: str, q, k, v, o, lse, qscale: float) -> None:
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b, h, sq,
                                 k.shape[2], d, _bhs_strides(q, k, v, o),
                                 float(qscale), _stream(q))
    _check(lib, rc, "flash_fwd")
    launches["flash_fwd"] += 1


def flash_bwd_dq(qs, kl, v, do, lse2, delta, dq, dq_mul: float) -> None:
    """Launch the dq kernel for head dims up to 192 (the wgmma kernel of
    ``csrc/flash_bwd_sm90.cu``) on the folded operands qs = scale·q and
    kl = log2e·k (layouts as ``flash_fwd``); ``lse2`` and ``delta`` are
    contiguous (B, H, Sq_pad) fp32, zero past Sq, Sq_pad a multiple of 128.
    The caller prepares and checks them (``ops.flash_attention_bwd``)."""
    _launch_bwd_dq("sdbc_flash_bwd_dq_sm90", qs, kl, v, do, lse2, delta, dq,
                   dq_mul)


def flash_bwd_dq_wide(qs, kl, v, do, lse2, delta, dq, dq_mul: float) -> None:
    """``flash_bwd_dq`` for head dims in (192, 512] (the VAE's 512-wide
    head): the TMA-fed wgmma kernel of ``csrc/flash_bwd_wide_sm90.cu``, a
    cluster of two CTAs splitting the head dim of each 64-row q tile.  Same
    inputs; counted as a launch of ``flash_bwd_dq``: the same function."""
    _launch_bwd_dq("sdbc_flash_bwd_dq_wide_sm90", qs, kl, v, do, lse2, delta,
                   dq, dq_mul)


def _launch_bwd_dq(entry: str, qs, kl, v, do, lse2, delta, dq,
                   dq_mul: float) -> None:
    lib = load()
    b, h, sq, d = qs.shape
    with _device(qs):
        rc = getattr(lib, entry)(
            qs.data_ptr(), kl.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
            kl.shape[2], d, lse2.shape[-1], _bhs_strides(qs, kl, v, do, dq),
            float(dq_mul), _stream(qs))
    _check(lib, rc, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1


def flash_bwd_dkv(qs, kl, v, do, lse2, delta, dk, dv) -> None:
    """Launch the dk/dv kernel for head dims up to 192 (inputs as
    ``flash_bwd_dq``)."""
    _launch_bwd_dkv("sdbc_flash_bwd_dkv_sm90", qs, kl, v, do, lse2, delta, dk,
                    dv)


def flash_bwd_dkv_wide(qs, kl, v, do, lse2, delta, dk, dv) -> None:
    """``flash_bwd_dkv`` for head dims in (192, 512]: the kernel of
    ``csrc/flash_bwd_wide_sm90.cu``, a cluster of two CTAs splitting the
    head dim of each 64-key tile; counted as a launch of
    ``flash_bwd_dkv``."""
    _launch_bwd_dkv("sdbc_flash_bwd_dkv_wide_sm90", qs, kl, v, do, lse2,
                    delta, dk, dv)


def _launch_bwd_dkv(entry: str, qs, kl, v, do, lse2, delta, dk, dv) -> None:
    lib = load()
    b, h, sq, d = qs.shape
    with _device(qs):
        rc = getattr(lib, entry)(
            qs.data_ptr(), kl.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, kl.shape[2], d, lse2.shape[-1],
            _bhs_strides(qs, kl, v, do, dk, dv), _stream(qs))
    _check(lib, rc, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1


def adam8(table, nleaves: int, rows: int, lr: float, bc1: float, bc2: float,
          b1: float, omb1: float, b2: float, omb2: float, eps: float,
          wd: float) -> None:
    """Launch the fused 8-bit AdamW step over every leaf of ``table`` (an
    int64 tensor on the card, ``train.adam8bit.leaf_table``'s words),
    ``rows`` global rows, in place.  The caller checks the leaves
    (``train.adam8bit``)."""
    lib = load()
    with _device(table):
        rc = lib.sdbc_adam8_leaves(table.data_ptr(), int(nleaves), int(rows),
                                   float(lr), float(bc1), float(bc2),
                                   float(b1), float(omb1), float(b2),
                                   float(omb2), float(eps), float(wd),
                                   _stream(table))
    _check(lib, rc, "adam8")
    launches["adam8"] += 1


def flash_fwd_tt(q, k, v, o, lse, sk: int, qscale: float) -> None:
    """Launch the transposed-layout forward for head dims up to 256 (the
    TMA-fed wgmma kernel of ``csrc/flash_fwd_sm90.cu``, its head-dim-major
    variant) on (B, H, D, S) q/k/v/o (contiguous sequence; every row
    16-byte aligned with a stride that is a multiple of 8, so q, k, v and o
    are padded past Sq / ``sk`` in memory); ``o`` is the (B, H, D, Sq) view
    and ``lse`` a contiguous (B, H, Sq) fp32 output.  The caller checks
    shapes and dtypes (``ops.flash_attention_tt``)."""
    _launch_tt("sdbc_flash_fwd_tt_sm90", q, k, v, o, lse, sk, qscale)


def flash_fwd_tt_wide(q, k, v, o, lse, sk: int, qscale: float) -> None:
    """``flash_fwd_tt`` for head dims in (256, 512] (the VAE's 512-wide
    head): the head-dim-major variant of ``csrc/flash_fwd_wide_sm90.cu``'s
    kernel.  Counted as a launch of ``flash_tt``: the same function."""
    _launch_tt("sdbc_flash_fwd_tt_wide_sm90", q, k, v, o, lse, sk, qscale)


def _launch_tt(entry: str, q, k, v, o, lse, sk: int, qscale: float) -> None:
    lib = load()
    b, h, d, sq = o.shape
    with _device(q):
        rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), b, h, sq,
                                 int(sk), d, _bhs_strides(q, k, v, o),
                                 float(qscale), _stream(q))
    _check(lib, rc, "flash_tt")
    launches["flash_tt"] += 1


_GN_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


class GroupNormLaunch(ctypes.Structure):
    """One fused-GroupNorm call's layout as ``sdbc_group_norm`` reads it
    (``struct GnLaunch`` of ``csrc/group_norm_sm90.cu``): built once per
    shape by ``group_norm_launch`` and kept by the caller."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "hw", "c", "groups", "cluster", "threads", "lanes", "cv",
        "resident", "vec", "silu", "dtype", "sdtype", "bdtype")] \
        + [("eps", ctypes.c_float)]


def group_norm_launch(n: int, hw: int, c: int, groups: int, plan,
                      eps: float, silu: bool, dtype, sdtype,
                      bdtype) -> GroupNormLaunch:
    """The layout of a call over (n, hw, c) in ``dtype`` with scale and
    bias in ``sdtype`` / ``bdtype``, as ``plan`` (``ops.pallas_groupnorm.
    plan``) lays it out."""
    return GroupNormLaunch(
        n, hw, c, groups, plan.cluster, plan.threads, plan.lanes, plan.cv,
        plan.resident, int(plan.vec > 1), int(silu),
        _GN_DTYPES[dtype], _GN_DTYPES[sdtype], _GN_DTYPES[bdtype], eps)


def group_norm(x, scale, bias, y, launch: GroupNormLaunch) -> None:
    """Launch the fused GroupNorm(+SiLU) (``csrc/group_norm_sm90.cu``) over
    contiguous ``x`` and ``y`` (bf16 or fp32, (n, ..., c)), ``scale`` and
    ``bias`` (c,) in bf16 or fp32, laid out as ``launch`` says: one launch,
    one thread-block cluster per sample.  The caller checks shapes and
    dtypes (``ops.pallas_groupnorm``)."""
    lib = _lib or load()
    dev = x.get_device()
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        rc = lib.sdbc_group_norm(x.data_ptr(), scale.data_ptr(),
                                 bias.data_ptr(), y.data_ptr(), launch,
                                 torch._C._cuda_getCurrentRawStream(dev))
    _check(lib, rc, "gn_fused")
    launches["gn_fused"] += 1


def group_norm_max_clusters(dtype, vec: bool, silu: bool, cluster: int,
                            threads: int, smem: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the GroupNorm kernel's
    instantiation for (x ``dtype``, 16-byte path, SiLU) on the current card:
    how many clusters of ``cluster`` CTAs of ``threads`` threads and
    ``smem`` bytes of dynamic shared memory it holds at once."""
    lib = load()
    out = ctypes.c_int(0)
    rc = lib.sdbc_group_norm_max_clusters(_GN_DTYPES[dtype], int(vec),
                                          int(silu), cluster, threads, smem,
                                          ctypes.byref(out))
    _check(lib, rc, "gn_fused occupancy")
    return out.value


def flash_fixed_int8(q, k, v, o, k8, ks, qscale: float) -> None:
    """Launch the int8-QK fixed-cap attention (``csrc/flash_int8_sm90.cu``)
    on bf16 (B, H, S, D) views ``q``, ``k``, ``v`` and ``o`` (any
    batch/head/seq strides that are multiples of 8, contiguous head dim),
    quantizing q and k inside the call: a pre-pass quantizes k into ``k8``
    (int8, B·H·Sk·D8 elements, D8 = D rounded up to 16) and ``ks`` (fp32,
    B·H·Skp, Skp = Sk rounded up to 128), then the attention kernel runs.
    Two launches, each counted.  The caller checks shapes and dtypes
    (``ops.flash_attention``)."""
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = lib.sdbc_flash_int8_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            k8.data_ptr(), ks.data_ptr(), b, h, sq, k.shape[2], d,
            _bhs_strides(q, k, v, o), float(qscale), _stream(q))
    _check(lib, rc, "flash_fixed_int8")
    launches["flash_fixed_int8"] += 2


# the CUDA-core kernels (csrc/flash_simt.cu, csrc/geglu_ff_simt.cu): bf16
# or fp32, any strides
_SIMT_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _bhsd_strides(*tensors):
    """All four strides of (B, H, S, D) views, as the C array the CUDA-core
    kernels take."""
    out = [st for t in tensors for st in t.stride()]
    return (ctypes.c_longlong * len(out))(*out)


def flash_simt_fwd(q, k, v, o, lse, qscale: float, *, fixed: bool) -> None:
    """Launch the CUDA-core attention forward (``csrc/flash_simt.cu``) on
    (B, H, S, D) views of any strides, bf16 or fp32, D ≤ 512: the fixed cap
    (``fixed``; counted as ``flash_fixed_simt``) or the training forward,
    writing the natural-log LSE into the contiguous (B, H, Sq) fp32 ``lse``
    (``flash_fwd_simt``).  The caller checks shapes and dtypes
    (``ops.flash_simt``)."""
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = lib.sdbc_flash_simt_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if fixed else lse.data_ptr(), _SIMT_DTYPES[q.dtype],
            int(fixed), b, h, sq, k.shape[2], d, _bhsd_strides(q, k, v, o),
            float(qscale), _stream(q))
    name = "flash_fixed_simt" if fixed else "flash_fwd_simt"
    _check(lib, rc, name)
    launches[name] += 1


def _launch_simt_bwd(name, qs, kl, v, do, lse2, delta, outs,
                     dq_mul: float) -> None:
    lib = load()
    b, h, sq, d = qs.shape
    with _device(qs):
        rc = lib.sdbc_flash_simt_bwd(
            qs.data_ptr(), kl.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None,
            _SIMT_DTYPES[qs.dtype], int(len(outs) == 1), b, h, sq,
            kl.shape[2], d, lse2.shape[-1],
            _bhsd_strides(qs, kl, v, do, *outs), float(dq_mul), _stream(qs))
    _check(lib, rc, name)
    launches[name] += 1


def flash_simt_bwd_dq(qs, kl, v, do, lse2, delta, dq, dq_mul: float) -> None:
    """Launch the CUDA-core dq kernel on ``flash_attention_bwd.prepare``'s
    inputs ((B, H, S, D) views of any strides, bf16 or fp32; ``lse2`` and
    ``delta`` contiguous (B, H, Sq_pad) fp32, zero past Sq).  The caller
    checks them (``ops.flash_simt``)."""
    _launch_simt_bwd("flash_bwd_simt_dq", qs, kl, v, do, lse2, delta, (dq,),
                     dq_mul)


def flash_simt_bwd_dkv(qs, kl, v, do, lse2, delta, dk, dv) -> None:
    """Launch the CUDA-core dk/dv kernel (inputs as
    ``flash_simt_bwd_dq``)."""
    _launch_simt_bwd("flash_bwd_simt_dkv", qs, kl, v, do, lse2, delta,
                     (dk, dv), 0.0)


def geglu_ff_simt(y, gamma, beta, w1, b1, w2, b2, out, eps: float) -> None:
    """Launch the CUDA-core fused GEGLU (``csrc/geglu_ff_simt.cu``) over
    contiguous (rows, c) bf16 or fp32 rows, c ≤ 640, the weights in y's
    dtype and the LayerNorm's in fp32.  The caller checks shapes and dtypes
    (``ops.geglu_ff``)."""
    lib = load()
    rows, c = y.shape
    with _device(y):
        rc = lib.sdbc_geglu_ff_simt(
            y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            _SIMT_DTYPES[y.dtype], rows, c, float(eps), _stream(y))
    _check(lib, rc, "geglu_ff_simt")
    launches["geglu_ff_simt"] += 1


def flash_tf32(q, k, v, o, lse, scratch, qscale: float, *,
               fixed: bool) -> None:
    """Launch the fp32 attention forward on 3xTF32 ``wgmma``
    (``csrc/flash_fwd_tf32_sm90.cu``) on fp32 (B, H, S, D) views, D a
    multiple of 8 up to 256: q with a contiguous head dim, its other
    strides multiples of 4 and 16-byte aligned, k and v of any strides, o
    with a contiguous head dim and even strides; ``scratch`` a contiguous
    fp32 buffer of ``4·B·H·Skp·D`` floats (Skp = Sk rounded up to 8) that
    the call's split pre-pass fills before the attention kernel runs.  The
    fixed cap (``fixed``; counted as ``flash_fixed_tf32``) or the training
    forward, writing the natural-log LSE into the contiguous (B, H, Sq)
    fp32 ``lse`` (``flash_fwd_tf32``); one count a call, the pre-pass
    included.  The caller checks shapes and dtypes (``ops.flash_tf32``)."""
    _launch_tf32("sdbc_flash_tf32_sm90", q, k, v, o, lse, scratch, qscale,
                 fixed)


def flash_tf32_wide(q, k, v, o, lse, scratch, qscale: float, *,
                    fixed: bool) -> None:
    """``flash_tf32`` for head dims in (256, 512] (the VAE's 512-wide
    head): the same pre-pass, then the kernel of
    ``csrc/flash_fwd_tf32_wide_sm90.cu`` (a cluster of two CTAs splitting
    the head dim of each 64-row q tile).  Same arguments; counted as
    ``flash_fixed_tf32`` / ``flash_fwd_tf32``: the same function."""
    _launch_tf32("sdbc_flash_tf32_wide_sm90", q, k, v, o, lse, scratch,
                 qscale, fixed)


def _launch_tf32(entry: str, q, k, v, o, lse, scratch, qscale: float,
                 fixed: bool) -> None:
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if fixed else lse.data_ptr(), scratch.data_ptr(),
            int(fixed), b, h, sq, k.shape[2], d, _bhsd_strides(q, k, v, o),
            float(qscale), _stream(q))
    name = "flash_fixed_tf32" if fixed else "flash_fwd_tf32"
    _check(lib, rc, name)
    launches[name] += 1


def geglu_ff_tf32(y, gamma, beta, w1, b1, w2, b2, out, scratch,
                  eps: float) -> None:
    """Launch the fp32 fused GEGLU on 3xTF32 ``wgmma``
    (``csrc/geglu_ff_tf32_sm90.cu``) over contiguous fp32 (rows, c) rows, c
    a multiple of 32 up to 320 or of 64 up to 640, every tensor fp32,
    contiguous and 16-byte aligned; ``scratch`` a contiguous fp32 buffer of
    ``24·c²`` floats that the call's split pre-pass fills (W1ᵀ and W2ᵀ as hi
    and lo parts) before the FF kernel runs.  Counted once as
    ``geglu_ff_tf32``, the pre-pass included.  The caller checks shapes and
    dtypes (``ops.geglu_ff``)."""
    lib = load()
    rows, c = y.shape
    with _device(y):
        rc = lib.sdbc_geglu_ff_tf32(
            y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), rows, c, float(eps), _stream(y))
    _check(lib, rc, "geglu_ff_tf32")
    launches["geglu_ff_tf32"] += 1


def flash_bwd_dq_tf32(q, k, v, do, lse2, delta, dq, scratch, scale: float,
                      dq_mul: float) -> None:
    """Launch the split pre-pass and the dq kernel of the fp32 backward on
    3xTF32 ``wgmma`` (``csrc/flash_bwd_tf32_sm90.cu``) on fp32 (B, H, S, D)
    views of any strides, D a multiple of 8 up to 160: the pre-pass folds
    qs = scale·q and kl = log2e·k and writes every operand as hi and lo tf32
    parts (q-side and key-side rows, and qsᵀ, dOᵀ, klᵀ) into ``scratch``, a
    contiguous fp32 buffer of ``flash_bwd_tf32.scratch_floats`` floats;
    then the dq kernel writes dq (a contiguous head dim, even strides).
    ``lse2`` and ``delta`` are contiguous (B, H, Sq_pad) fp32, zero past
    Sq, Sq_pad a multiple of 128.  Counted once as ``flash_bwd_dq_tf32``,
    the pre-pass included.  The caller checks shapes and dtypes
    (``ops.flash_bwd_tf32``)."""
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = lib.sdbc_flash_bwd_dq_tf32_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            scratch.data_ptr(), b, h, sq, k.shape[2], d, lse2.shape[-1],
            _bhsd_strides(q, k, v, do), _bhs_strides(dq), float(scale),
            float(dq_mul), _stream(q))
    _check(lib, rc, "flash_bwd_dq_tf32")
    launches["flash_bwd_dq_tf32"] += 1


def flash_bwd_dkv_tf32(q, k, lse2, delta, dk, dv, scratch) -> None:
    """Launch the dk/dv kernel of the fp32 backward on 3xTF32 ``wgmma``
    (``csrc/flash_bwd_tf32_sm90.cu``) on the ``scratch`` that
    ``flash_bwd_dq_tf32`` filled for the same q, k (their shapes name the
    call), into dk and dv (contiguous head dims, even strides).  Counted as
    ``flash_bwd_dkv_tf32``.  The caller checks shapes and dtypes
    (``ops.flash_bwd_tf32``)."""
    lib = load()
    b, h, sq, d = q.shape
    with _device(q):
        rc = lib.sdbc_flash_bwd_dkv_tf32_sm90(
            lse2.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), b, h, sq, k.shape[2], d, lse2.shape[-1],
            _bhs_strides(dk, dv), _stream(q))
    _check(lib, rc, "flash_bwd_dkv_tf32")
    launches["flash_bwd_dkv_tf32"] += 1
