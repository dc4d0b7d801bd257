"""Zstandard decoding (RFC 8878) and CRC-32C through the port's own decoder,
``csrc/host/zstd_decode.cc``: the frames orbax / tensorstore write around
zarr chunks and OCDBT nodes, on a machine without a zstd module.

The source is compiled with ``g++`` (``$CXX`` if set) on first use:

    g++ -O3 -std=c++17 -shared -fPIC \\
        -o build/sdbc_tpu_torch/libsdbc_zstd-<hash>.so \\
        sdbc_tpu_torch/csrc/host/zstd_decode.cc

The name carries a hash of the source and the command, so an edit rebuilds
it; the build runs under the kernels' file lock (``ops/_kernels.py``
``build_lock``), so concurrent processes build it once.  A failed build
raises with the compiler's log: there is no other decoder to fall back on.
``decompress_many`` decodes many frames in one foreign call a batch, on a
thread pool or in the calling thread; a ctypes call releases the
interpreter lock, so threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = (Path(__file__).resolve().parent.parent / "csrc" / "host"
          / "zstd_decode.cc")
CXXFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


class ZstdError(ValueError):
    """A frame the decoder refuses: malformed, truncated, a dictionary, a
    checksum that differs or an output of another size."""


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    from sdbc_tpu_torch.ops import _kernels

    h = hashlib.sha256(" ".join([_cxx()] + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return _kernels.BUILD_DIR / f"libsdbc_zstd-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the decoder unless a library of the same source exists."""
    from sdbc_tpu_torch.ops import _kernels

    lib = library_path()
    if lib.exists():
        return lib
    with _kernels.build_lock():
        if lib.exists():  # another process built it while we waited
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_cxx()] + CXXFLAGS + ["-o", str(tmp), str(SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (rc "
                               f"{res.returncode}):\n{res.stdout}"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded decoder (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, n, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
            lib.zstd_decompress.argtypes = [p, n, p, n]
            lib.zstd_decompress.restype = i64
            lib.zstd_content_size.argtypes = [p, n]
            lib.zstd_content_size.restype = i64
            lib.zstd_error_name.argtypes = [i64]
            lib.zstd_error_name.restype = ctypes.c_char_p
            lib.zstd_decompress_batch.argtypes = [n, p, p, p, p, p]
            lib.zstd_decompress_batch.restype = i64
            lib.crc32c.argtypes = [p, n]
            lib.crc32c.restype = ctypes.c_uint32
            _lib = lib
    return _lib


def _u8(data) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def _error(lib, code: int) -> ZstdError:
    return ZstdError(lib.zstd_error_name(code).decode())


def content_size(frame) -> Optional[int]:
    """The decoded size the frames state, None when one does not."""
    lib = load()
    src = _u8(frame)
    got = lib.zstd_content_size(src.ctypes.data, src.size)
    if got == -1:
        return None
    if got < 0:
        raise _error(lib, got)
    return int(got)


def _decode(frame, out: np.ndarray) -> int:
    lib = load()
    src = _u8(frame)
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("the output must be C-contiguous and writable")
    got = lib.zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                              out.nbytes)
    if got < 0:
        raise _error(lib, got)
    return int(got)


def decompress_into(frame, out: np.ndarray) -> None:
    """Decode ``frame`` into ``out`` (a C-contiguous, writable array), which
    it must fill exactly."""
    got = _decode(frame, out)
    if got != out.nbytes:
        raise ZstdError(f"decoded {got} bytes, expected {out.nbytes}")


def decompress(frame, size: Optional[int] = None,
               limit: Optional[int] = None) -> bytes:
    """The decoded bytes of ``frame``: exactly ``size`` of them, or the
    size the frame states; a frame that states none is decoded into at
    most ``limit`` bytes."""
    if size is None:
        size = content_size(frame)
    if size is not None:
        out = np.empty(size, np.uint8)
        decompress_into(frame, out)
        return out.tobytes()
    if limit is None:
        raise ZstdError("the frame does not state its decoded size: pass "
                        "size or limit")
    out = np.empty(limit, np.uint8)
    return out[:_decode(frame, out)].tobytes()


def _decode_batch(frames: list, dst: list) -> None:
    """One foreign call decoding ``frames`` into ``dst`` in turn, each to
    exactly its size."""
    lib = load()
    n = len(frames)
    # bytes as they are (ctypes points at their buffer), else copied
    srcs = [f if isinstance(f, bytes) else bytes(f) for f in frames]
    res = (ctypes.c_int64 * n)()
    lib.zstd_decompress_batch(
        n, (ctypes.c_char_p * n)(*srcs),
        (ctypes.c_size_t * n)(*map(len, srcs)),
        (ctypes.c_void_p * n)(*[d.ctypes.data for d in dst]),
        (ctypes.c_size_t * n)(*[d.nbytes for d in dst]), res)
    for got, d in zip(res, dst):
        if got < 0:
            raise _error(lib, got)
        if got != d.nbytes:
            raise ZstdError(f"decoded {got} bytes, expected {d.nbytes}")


def decompress_many(frames: Sequence, sizes: Sequence[int],
                    out: Optional[Sequence[np.ndarray]] = None,
                    workers: Optional[int] = None) -> List[np.ndarray]:
    """Decode each frame to exactly its size, on a pool of ``workers``
    threads (the host's cores by default): uint8 arrays, or ``out``'s
    arrays filled in place.  The frames go to the threads in batches of
    similar total size, one foreign call a batch; one worker decodes them
    all in the calling thread, in one call (``zarr.read_arrays``' threads
    each do so for theirs)."""
    if len(frames) != len(sizes) or (out is not None
                                     and len(out) != len(frames)):
        raise ValueError("frames, sizes and out differ in length")
    dst = (list(out) if out is not None
           else [np.empty(n, np.uint8) for n in sizes])
    for d, n in zip(dst, sizes):
        if not (d.flags.c_contiguous and d.flags.writeable) or d.nbytes != n:
            raise ValueError(f"an output of {d.nbytes} bytes for {n}, or "
                             "not C-contiguous and writable")
    if not frames:
        return dst
    workers = workers or min(len(frames), os.cpu_count() or 1)
    if workers == 1:
        _decode_batch(list(frames), dst)
        return dst
    # the largest frames first, dealt out in turn: batches of like size
    order = sorted(range(len(frames)), key=lambda i: -sizes[i])
    batches = [order[k::4 * workers] for k in range(4 * workers)]
    with ThreadPoolExecutor(workers) as ex:
        for fut in [ex.submit(_decode_batch, [frames[i] for i in b],
                              [dst[i] for i in b]) for b in batches if b]:
            fut.result()
    return dst


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    src = _u8(data)
    return int(load().crc32c(src.ctypes.data, src.size))
