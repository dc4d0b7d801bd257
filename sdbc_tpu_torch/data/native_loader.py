"""ctypes bindings for the native C++ decode/resize core
(``native/loader.cc``), the port's own copy of
``sdbc_tpu/data/native_loader.py``.

The library is compiled from the unchanged ``native/loader.cc`` (with the
flags of ``native/Makefile``) into ``build/sdbc_tpu_torch/`` on first use,
never into ``native/``; ``SDBC_NATIVE_LIB`` names a prebuilt one instead.
When it cannot be built (no compiler, no libjpeg headers) the callers
decode through ``utils/image.py::decode_and_prepare`` (PIL), as the JAX
package does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "loader.cc")
_LIB_PATH = os.path.join(_REPO, "build", "sdbc_tpu_torch",
                         "libsdbc_loader.so")
# native/Makefile's flags
_CXXFLAGS = ["-O3", "-march=native", "-ffast-math", "-funroll-loops",
             "-fPIC", "-shared", "-std=c++17"]

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the library (into a private name, then renamed into place,
    so a concurrent process never loads a half-written file)."""
    global _build_error
    if not os.path.exists(_SOURCE):
        _build_error = f"no {_SOURCE}"
        return None
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp, _SOURCE,
           "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"") or b""
        _build_error = f"{' '.join(cmd)}: {e} {err.decode()[-500:]}"
        return None
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _find_lib() -> Optional[str]:
    env = os.environ.get("SDBC_NATIVE_LIB")
    if env:
        if not os.path.exists(env):
            import warnings

            warnings.warn(f"SDBC_NATIVE_LIB={env} does not exist — native "
                          "decode disabled", stacklevel=3)
            return None
        return env
    if os.path.exists(_LIB_PATH):
        return _LIB_PATH
    return _build()


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _find_lib()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.sdbc_decode_batch.restype = ctypes.c_int
        lib.sdbc_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.sdbc_decode_probe.restype = ctypes.c_int
        lib.sdbc_decode_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    return _build_error or "the library did not load"


def decode_batch(paths: Sequence[str], size: int,
                 threads: int = 4) -> np.ndarray:
    """Decode+resize+normalize a batch of JPEGs → (N, size, size, 3)
    float32 with the library (``available()`` first); failed decodes come
    back as zero images, with a warning.  ``threads`` is clamped to the
    host's core count."""
    import warnings

    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native loader did not build: "
                           f"{unavailable_reason()}")
    threads = max(1, min(threads, os.cpu_count() or 1))
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.sdbc_decode_batch(
        arr, n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        threads)
    if failures:
        warnings.warn(f"{failures}/{n} images failed to decode and were "
                      "zero-filled (run the preprocess integrity check)",
                      stacklevel=2)
    return out


def probe_size(path: str):
    """(W, H) if the image decodes cleanly (a full decode, not a header
    read), else None: a PNG through ``utils/png.py``, else the native
    library or PIL."""
    from sdbc_tpu_torch.utils import png
    from sdbc_tpu_torch.utils.image import is_png

    try:
        if is_png(path):
            with open(path, "rb") as f:
                img = png.decode(f.read())
            return (img.shape[1], img.shape[0])
    except png.PNGUnsupported:
        pass
    except (OSError, ValueError):
        return None
    lib = _load()
    if lib is None:
        from PIL import Image

        try:
            with Image.open(path) as im:
                im.convert("RGB")  # forces the full decode
                return im.size
        except Exception:
            return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.sdbc_decode_probe(path.encode(), ctypes.byref(w),
                             ctypes.byref(h)) == 0:
        return (w.value, h.value)
    return None

