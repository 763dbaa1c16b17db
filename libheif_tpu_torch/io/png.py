"""Minimal, dependency-free PNG codec (zlib from the stdlib).

Counterpart of libheif_tpu/io/png.py (reference: heifio/decoder_png.cc,
heifio/encoder_png.cc — those wrap libpng; this is the subset HEIF tools
need: gray / gray+alpha / RGB / RGBA at 8 or 16 bits, all five scanline
filters).  A byte codec over numpy arrays: a tensor given to
``write_png`` is copied to the host once.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from .host import host_array

_SIG = b"\x89PNG\r\n\x1a\n"

# color type → channel count
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload +
            struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(arr, bit_depth: int = 8) -> bytes:
    """arr: (H,W) gray or (H,W,C) with C in {1,2,3,4}, a numpy array or a
    tensor; dtype uint8/uint16 matching bit_depth."""
    arr = host_array(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if bit_depth == 8:
        raw = arr.astype(np.uint8)
    else:
        raw = arr.astype(">u2").view(np.uint8).reshape(h, w, c * 2)
    # filter 0 (None) per scanline — simple and deterministic
    lines = np.concatenate(
        [np.zeros((h, 1), np.uint8),
         raw.reshape(h, -1)], axis=1)
    idat = zlib.compress(lines.tobytes(), 6)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) +
            _chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft = data[pos]
        line = data[pos + 1: pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 2:              # Up
            cur = (line + prev) & 0xFF
        else:                      # Sub/Average/Paeth need a scan
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) >> 1
                elif ft == 4:
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else cc)
                else:
                    raise ValueError(f"bad PNG filter {ft}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(data: bytes) -> Tuple[np.ndarray, int]:
    """Returns ((H,W,C) array, bit_depth). Palette images are expanded
    to RGB; interlaced images are rejected."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    w = h = bit_depth = color_type = 0
    interlace = 0
    idat = bytearray()
    plte: Optional[np.ndarray] = None
    trns: Optional[np.ndarray] = None
    while pos + 8 <= len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _comp, _filt, interlace = \
                struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat.extend(payload)
        elif tag == b"IEND":
            break
    if interlace:
        raise ValueError("interlaced PNG not supported")
    if bit_depth not in (8, 16) and color_type != 3:
        raise ValueError(f"PNG bit depth {bit_depth} not supported")
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    nch = _CHANNELS[color_type]
    if color_type == 3:
        if bit_depth == 8:
            stride, bpp = w, 1
        else:
            raise ValueError("palette bit depth <8 not supported")
    else:
        bpp = nch * (bit_depth // 8)
        stride = w * bpp
    img = _unfilter(raw, h, stride, max(1, bpp))
    if color_type == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idxs = img.reshape(h, w)
        rgb = plte[idxs]
        if trns is not None:
            n = min(len(trns), plte.shape[0])
            amap = np.full(plte.shape[0], 255, np.uint8)
            amap[:n] = trns[:n]
            alpha = amap[idxs]
            return np.dstack([rgb, alpha]), 8
        return rgb, 8
    if bit_depth == 16:
        arr = img.reshape(h, w, nch, 2)
        out = (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
        return out, 16
    return img.reshape(h, w, nch), 8
