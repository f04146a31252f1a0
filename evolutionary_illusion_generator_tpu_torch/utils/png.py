"""PNG reading and writing with zlib and numpy only.

The port's stand-in for what Pillow does for the JAX package, which the
card's machine does not have.  The reader decodes 8-bit, non-interlaced
greyscale (L), greyscale + alpha (LA), RGB and RGBA files, spread over any
number of ``IDAT`` chunks, with all five row filters, and checks every
chunk's CRC.  It refuses palette, interlaced and 16-bit (or 1/2/4-bit)
files.  The writer writes the same four modes with filter None.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["read_png", "write_png", "convert"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (mode, channels)
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 4: ("LA", 2), 6: ("RGBA", 4)}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked, up to ``IEND``."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, channels: int) -> np.ndarray:
    """Undo the per-row filters of (height, 1 + width * channels) bytes.

    A byte depends on the one left of it, the one above and the one above
    left (filters Sub, Up, Average, Paeth), so the image is reconstructed one
    anti-diagonal of pixels at a time, each pixel's channels together."""
    kinds = raw[:, 0].astype(np.int64)
    if (kinds > 4).any():
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    filt = raw[:, 1:].reshape(height, width, channels).astype(np.int64)
    if not kinds.any():
        return filt.astype(np.uint8)
    # one zero row above and one zero column left of the image
    out = np.zeros((height + 1, width + 1, channels), np.int64)
    for d in range(height + width - 1):
        ys = np.arange(max(0, d - width + 1), min(height - 1, d) + 1)
        xs = d - ys
        a = out[ys + 1, xs]  # left
        b = out[ys, xs + 1]  # up
        c = out[ys, xs]  # up left
        k = kinds[ys][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> Tuple[np.ndarray, str]:
    """Decode a PNG file: ((H, W) uint8 for L, else (H, W, C)), mode."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind[:1].isupper() and kind not in (b"PLTE", b"IEND"):
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color_type, _, _, interlace = header
    if color_type not in _COLOR_TYPES:
        what = "palette" if color_type == 3 else "unknown"
        raise ValueError(f"unsupported PNG colour type {color_type} ({what})")
    if depth != 8:
        raise ValueError(f"unsupported PNG bit depth {depth} (only 8 is read)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced (Adam7)")
    mode, channels = _COLOR_TYPES[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * channels):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{height * (1 + width * channels)}")
    img = _unfilter(raw.reshape(height, 1 + width * channels), height, width, channels)
    return (img[..., 0] if channels == 1 else img), mode


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def write_png(path: str, array: np.ndarray) -> None:
    """Write a uint8 (H, W) array as L, or (H, W, C) with C = 1, 2, 3 or 4
    as L, LA, RGB or RGBA."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"cannot write an array of shape {array.shape} as PNG")
    height, width, channels = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = np.zeros((height, 1 + width * channels), np.uint8)  # filter 0: None
    rows[:, 1:] = arr.reshape(height, width * channels)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def convert(img: np.ndarray, mode: str, target: str) -> np.ndarray:
    """Pillow's ``Image.convert`` between the read modes and "L" or "RGB":
    alpha is dropped, greyscale is repeated into RGB, and RGB becomes L by
    Pillow's integer luma ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    if target not in ("L", "RGB"):
        raise ValueError(f"cannot convert to {target!r}")
    arr = img[..., None] if img.ndim == 2 else img
    color = arr[..., :3] if mode in ("RGB", "RGBA") else np.repeat(arr[..., :1], 3, axis=-1)
    if target == "RGB":
        return np.ascontiguousarray(color)
    if mode in ("L", "LA"):
        return np.ascontiguousarray(arr[..., 0])
    r, g, b = (color[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)
