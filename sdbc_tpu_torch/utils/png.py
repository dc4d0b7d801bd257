"""A stdlib PNG codec (``zlib``, ``struct``): the serving daemon's image
format, so its answers and its init images need no PIL.

- ``encode``: 8-bit RGB, one IDAT, filter type 0 on every row.
- ``decode``: 8-bit, non-interlaced PNGs of colour type L (0), RGB (2) or
  RGBA (6), every row filter (None, Sub, Up, Average, Paeth), CRCs checked.
  Other PNGs (palette, 16-bit, interlaced, grey + alpha) raise
  ``PNGUnsupported``: the daemon hands those to PIL.
- ``convert``: PIL's ``Image.convert`` from L, RGB or RGBA uint8 arrays
  to L or RGB (to L with PIL's integer ITU-R 601-2 luma; alpha dropped).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}


class PNGUnsupported(ValueError):
    """A valid PNG of a kind this decoder does not take."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode takes (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    if len(data) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(data)} bytes, expected "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        off = y * (stride + 1)
        ftype = data[off]
        row = np.frombuffer(data, np.uint8, stride, off + 1)
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:  # Sub: a running sum along each channel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint32).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = row + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            buf = bytearray(row.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(
                buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 (H, W) for L, (H, W, 3) for RGB, (H, W, 4) for
    RGBA.  Raises ``PNGUnsupported`` for other kinds of PNG and
    ``ValueError`` for data that is no valid PNG."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise PNGUnsupported(f"PNG of bit depth {depth}, colour type "
                             f"{color}, interlace {interlace}")
    ch = _CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}")
    img = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def convert(img: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``Image.convert(mode)`` of an L, RGB or RGBA uint8 array
    (``decode``'s) to mode "L" or "RGB"."""
    if mode == "L":
        if img.ndim == 2:
            return img
        rgb = img[..., :3].astype(np.uint32)
        # PIL's L24: (R·19595 + G·38470 + B·7471 + 0x8000) >> 16
        return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
                 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
    if mode == "RGB":
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=2)
        return np.ascontiguousarray(img[..., :3])
    raise ValueError(f"convert to mode {mode!r}: only L and RGB")
