"""zarr v2 arrays: the leaves of a checkpoint tree orbax writes with
``"use_zarr3": false``, in an OCDBT store (``utils/ocdbt.py``, the JAX
package's saves) or as files under a directory (``DirStore``: orbax without
OCDBT, and the port's own saves).

Each array ``<name>`` is a key ``<name>/.zarray`` (JSON: shape, chunk
shape, dtype, compressor, fill value, order, separator) and one key a
chunk, ``<name>/<i>.<j>…`` (``0`` for a 0-d array).  orbax writes one chunk
a shard, so a leaf saved under a mesh spans several; a chunk is stored
whole, also at the ragged edge, and cropped when read; a missing chunk
holds the fill value.  Chunks are zstd frames (``utils/zstd.py``) or raw
bytes, read and decoded (``zstd.decompress_many``) in batches on a thread
pool, straight into the array's memory where a chunk is a run of its
rows.
"""
from __future__ import annotations

import itertools
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sdbc_tpu_torch.utils import zstd
from sdbc_tpu_torch.utils.ocdbt import Ref

# zarr dtype → (torch dtype, numpy dtype of the same bytes)
DTYPES = {"bfloat16": (torch.bfloat16, np.int16),
          "<f2": (torch.float16, np.float16),
          "<f4": (torch.float32, np.float32),
          "<f8": (torch.float64, np.float64),
          "<i4": (torch.int32, np.int32),
          "<i8": (torch.int64, np.int64),
          "|i1": (torch.int8, np.int8),
          "|u1": (torch.uint8, np.uint8),
          "|b1": (torch.bool, np.bool_)}
_FIELDS = {"zarr_format", "shape", "chunks", "dtype", "compressor",
           "fill_value", "order", "filters", "dimension_separator"}
_SPECIAL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
# the most stored bytes a thread reads before it decodes them: bounds what
# a load holds beyond the arrays themselves
BATCH_BYTES = 1 << 26


class ZarrError(ValueError):
    """An array the reader cannot read, with the field at fault."""


@dataclass(frozen=True)
class Array:
    """One ``.zarray``, checked."""
    name: str
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: str
    zstd: bool
    fill_value: object
    separator: str

    @property
    def itemsize(self) -> int:
        return np.dtype(DTYPES[self.dtype][1]).itemsize

    def chunk_bytes(self) -> int:
        return math.prod(self.chunks) * self.itemsize

    def grid(self) -> List[Tuple[int, ...]]:
        """Every chunk's index, in C order."""
        return list(itertools.product(*(range(-(-s // c)) for s, c in
                                         zip(self.shape, self.chunks))))

    def chunk_key(self, idx: Tuple[int, ...]) -> str:
        return f"{self.name}/" + (self.separator.join(map(str, idx)) or "0")


def parse_zarray(name: str, raw: bytes) -> Array:
    what = f"{name}/.zarray"
    try:
        za = json.loads(raw)
    except ValueError as e:
        raise ZarrError(f"{what}: not JSON ({e})") from None
    if not isinstance(za, dict):
        raise ZarrError(f"{what}: not a JSON object")
    extra = set(za) - _FIELDS
    if extra:
        raise ZarrError(f"{what}: unknown fields {sorted(extra)}")

    def bad(field, why):
        return ZarrError(f"{what}: {field} {za.get(field)!r}: {why}")

    if za.get("zarr_format") != 2:
        raise bad("zarr_format", "only 2 is read")
    shape, chunks = za.get("shape"), za.get("chunks")
    for field, v in (("shape", shape), ("chunks", chunks)):
        if not (isinstance(v, list) and all(isinstance(x, int) and x >= 0
                                            for x in v)):
            raise bad(field, "not a list of sizes")
    if len(chunks) != len(shape) or 0 in chunks:
        raise bad("chunks", f"against the shape {shape}")
    if za.get("dtype") not in DTYPES:
        raise bad("dtype", f"not one of {sorted(DTYPES)}")
    comp = za.get("compressor")
    if comp is not None and not (
            isinstance(comp, dict) and comp.get("id") == "zstd"
            and set(comp) <= {"id", "level", "checksum"}):
        raise bad("compressor", "only null or zstd")
    if za.get("order", "C") != "C":
        raise bad("order", "only C")
    if za.get("filters") not in (None, []):
        raise bad("filters", "only null")
    sep = za.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise bad("dimension_separator", "only '.' or '/'")
    fill = za.get("fill_value")
    fill = _SPECIAL.get(fill, fill)
    if fill is not None and not isinstance(fill, (int, float)):
        raise bad("fill_value", "not a number")
    return Array(name, tuple(shape), tuple(chunks), za["dtype"],
                 comp is not None, fill, sep)


class DirStore:
    """The keys of a tree kept as files under a directory: a chunk key
    ``<name>/0.0`` is the file ``<dir>/<name>/0.0`` (orbax without OCDBT,
    and the port's own ``utils/checkpoint.py::write_tree``)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def _file(self, key: str) -> str:
        parts = key.split("/")
        if key.startswith("/") or ".." in parts:
            raise ZarrError(f"{self.path}: key {key!r} leaves the tree")
        return os.path.join(self.path, *parts)

    def __contains__(self, key: str) -> bool:
        return os.path.isfile(self._file(key))

    def ref(self, key: str) -> Ref:
        path = self._file(key)
        if not os.path.isfile(path):
            raise KeyError(f"{self.path}: no key {key!r}")
        return Ref(path, 0, os.path.getsize(path))

    def read_many(self, keys: Sequence[str]) -> List[bytes]:
        out = []
        for key in keys:
            with open(self.ref(key).path, "rb") as f:
                out.append(f.read())
        return out


def _fill(arr: Array):
    """The fill value in the stored dtype's bytes (bf16 as its bits)."""
    if arr.fill_value is None:
        return 0
    if arr.dtype == "bfloat16":
        return torch.tensor(arr.fill_value, dtype=torch.bfloat16).view(
            torch.int16).item()
    return arr.fill_value


@dataclass
class _Chunk:
    """One stored chunk: where its value lies, its place ``sl`` in the
    array ``typed``, and ``buf``, the bytes it decodes into: a slice of the
    array's own memory when the chunk is a whole run of its rows, else a
    buffer of the whole chunk, cropped into place once decoded."""
    arr: Array
    value: Union[bytes, Ref]
    sl: Tuple[slice, ...]
    typed: np.ndarray
    buf: Optional[np.ndarray]
    direct: bool

    @property
    def stored(self) -> int:
        return (len(self.value) if isinstance(self.value, bytes)
                else self.value.length)


def _chunks(store, arr: Array, raw: np.ndarray,
            typed: np.ndarray) -> List[_Chunk]:
    """The stored chunks of ``arr``; a missing chunk's place is filled."""
    out = []
    rows = arr.chunk_bytes()
    runs = arr.chunks[1:] == arr.shape[1:]
    for idx in arr.grid():
        lo = [i * c for i, c in zip(idx, arr.chunks)]
        sl = tuple(slice(a, min(a + c, s)) for a, c, s in zip(
            lo, arr.chunks, arr.shape))
        key = arr.chunk_key(idx)
        if key not in store:
            typed[sl] = _fill(arr)
            continue
        direct = not arr.shape or (runs and lo[0] + arr.chunks[0]
                                   <= arr.shape[0])
        buf = None
        if direct:
            buf = raw[idx[0] * rows:(idx[0] + 1) * rows] if arr.shape \
                else raw
        out.append(_Chunk(arr, store.ref(key), sl, typed, buf, direct))
    return out


def _read_into(fd: int, ref: Ref, buf: np.ndarray) -> None:
    """The bytes of ``ref`` straight into ``buf``, which they must fill."""
    if ref.length != buf.nbytes:
        raise ZarrError(f"{ref.path}: a chunk of {ref.length} bytes, the "
                        f"array's chunk holds {buf.nbytes}")
    done, view = 0, memoryview(buf).cast("B")
    while done < ref.length:
        n = os.preadv(fd, [view[done:]], ref.offset + done)
        if n <= 0:
            raise ZarrError(f"{ref.path}: ends {ref.length - done} bytes "
                            "short")
        done += n


def _read(chunks: Sequence[_Chunk]) -> List[Tuple[bytes, np.ndarray]]:
    """[(zstd frame, its buffer)] of ``chunks``; an uncompressed chunk is
    read straight into its buffer.  Each data file is opened once."""
    frames, fds = [], {}
    try:
        for c in chunks:
            v = c.value
            if isinstance(v, bytes):
                if c.arr.zstd:
                    frames.append((v, c.buf))
                elif len(v) != c.buf.nbytes:
                    raise ZarrError(f"{c.arr.name}: a chunk of {len(v)} "
                                    f"bytes, a chunk holds {c.buf.nbytes}")
                else:
                    c.buf[...] = np.frombuffer(v, np.uint8)
                continue
            fd = fds.get(v.path)
            if fd is None:
                fd = fds[v.path] = os.open(v.path, os.O_RDONLY)
            if c.arr.zstd:
                data = os.pread(fd, v.length, v.offset)
                if len(data) != v.length:
                    raise ZarrError(f"{v.path}: {len(data)} bytes at "
                                    f"{v.offset}, expected {v.length}")
                frames.append((data, c.buf))
            else:
                _read_into(fd, v, c.buf)
    finally:
        for fd in fds.values():
            os.close(fd)
    return frames


def _crop(chunks: Sequence[_Chunk]) -> None:
    for c in chunks:
        chunk = c.buf.view(DTYPES[c.arr.dtype][1]).reshape(c.arr.chunks)
        c.typed[c.sl] = chunk[tuple(slice(0, s.stop - s.start)
                                    for s in c.sl)]


def _load(chunks: Sequence[_Chunk]) -> None:
    """Read ``chunks``, decode their zstd frames in this thread (one
    ``decompress_many`` call, one foreign call), crop the cropped ones."""
    for c in chunks:
        if not c.direct:
            c.buf = np.empty(c.arr.chunk_bytes(), np.uint8)
    frames = _read(chunks)
    if frames:
        zstd.decompress_many([f for f, _ in frames],
                             [b.nbytes for _, b in frames],
                             out=[b for _, b in frames], workers=1)
    _crop([c for c in chunks if not c.direct])
    for c in chunks:
        if not c.direct:
            c.buf = None


def _batches(chunks: List[_Chunk], n: int) -> List[List[_Chunk]]:
    """``chunks``, the largest first, in runs of about a ``4 n``-th of
    their stored bytes and at most ``BATCH_BYTES``."""
    chunks = sorted(chunks, key=lambda c: -c.stored)
    cap = min(BATCH_BYTES,
              max(1, sum(c.stored for c in chunks) // (4 * n)))
    out, size = [[]], 0
    for c in chunks:
        if out[-1] and size + c.stored > cap:
            out.append([])
            size = 0
        out[-1].append(c)
        size += c.stored
    return out


def read_arrays(store, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    """{name: tensor} of the arrays ``names`` of ``store`` (an ``OcdbtStore``
    or a ``DirStore``), in their dtypes on the host.  The chunks go in
    batches to a pool of threads, one a host core: each thread reads its
    batch, decodes its zstd frames by ``zstd.decompress_many`` and crops
    the chunks that are not a run of their array's rows into place."""
    specs = [parse_zarray(n, raw) for n, raw in zip(
        names, store.read_many([f"{n}/.zarray" for n in names]))]
    out, chunks = {}, []
    for arr in specs:
        raw = np.empty(math.prod(arr.shape) * arr.itemsize, np.uint8)
        typed = raw.view(DTYPES[arr.dtype][1]).reshape(arr.shape)
        chunks += _chunks(store, arr, raw, typed)
        t = torch.from_numpy(typed)
        out[arr.name] = (t.view(torch.bfloat16) if arr.dtype == "bfloat16"
                         else t)
    if not chunks:
        return out
    workers = min(len(chunks), os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as ex:
        for fut in [ex.submit(_load, b) for b in _batches(chunks, workers)]:
            fut.result()
    return out
