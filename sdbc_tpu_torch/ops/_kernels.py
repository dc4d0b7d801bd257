"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled on first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/sdbc_tpu_torch/libsdbc_kernels-<hash>.so csrc/*.cu

The library's name carries a hash of the sources and the command, so an
edit rebuilds it and an unchanged tree reuses it; a file lock keeps
concurrent processes from building twice.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside the library.

Every launch adds one to ``launches[<kernel>]`` right after the kernel was
enqueued without error, and nowhere else — a run reads the counts to show
that the sampling path went through the kernels.
"""
from __future__ import annotations

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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"flash_fixed": 0, "geglu_ff": 0}

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process built it while we waited
                return lib
            t0 = time.perf_counter()
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = ([_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)]
                   + [str(s) for s in sorted(CSRC.glob("*.cu"))])
            res = subprocess.run(cmd, capture_output=True, text=True)
            (BUILD_DIR / "nvcc.log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed (rc {res.returncode}):\n"
                                   f"{res.stderr[-4000:]}")
            os.replace(tmp, lib)
            build_seconds = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


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
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fixed(q, k, v, o, qscale: float) -> None:
    """Launch the fixed-cap attention kernel on (B, S, H, D) logical views
    (any batch/seq/head strides, contiguous head dim).  The caller checks
    shapes and dtypes (``ops.flash_attention``)."""
    lib = load()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    strides = []
    for t in (q, k, v, o):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        rc = lib.sdbc_flash_fixed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), b, h, sq, sk, d, *strides,
                                  float(qscale), _stream(q))
    _check(lib, rc, "flash_fixed")
    launches["flash_fixed"] += 1


def geglu_ff(y, gamma, beta, w1, b1, w2, b2, out, eps: float) -> None:
    """Launch the fused GEGLU kernel over (rows, c).  The caller checks
    shapes and dtypes (``ops.geglu_ff``)."""
    lib = load()
    rows, c = y.shape
    with torch.cuda.device(y.device):
        rc = lib.sdbc_geglu_ff(y.data_ptr(), gamma.data_ptr(),
                               beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                               rows, c, float(eps), _stream(y))
    _check(lib, rc, "geglu_ff")
    launches["geglu_ff"] += 1
