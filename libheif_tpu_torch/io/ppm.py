"""PPM/PGM netpbm reader/writer (binary P5/P6) — the simplest
interchange path for tools; counterpart of libheif_tpu/io/ppm.py (the
reference's heifio has no ppm module).  A byte codec over numpy arrays:
a tensor given to ``write_ppm`` is copied to the host once."""

from __future__ import annotations

import numpy as np

from .host import host_array


def write_ppm(rgb) -> bytes:
    rgb = host_array(rgb)
    h, w = rgb.shape[:2]
    if rgb.ndim == 2:
        return b"P5\n%d %d\n255\n" % (w, h) + \
            np.ascontiguousarray(rgb, np.uint8).tobytes()
    return b"P6\n%d %d\n255\n" % (w, h) + \
        np.ascontiguousarray(rgb[:, :, :3], np.uint8).tobytes()


def read_ppm(data: bytes) -> np.ndarray:
    toks = []
    pos = 0
    while len(toks) < 4:
        while pos < len(data) and data[pos:pos+1].isspace():
            pos += 1
        if data[pos:pos+1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end+1].isspace():
            end += 1
        toks.append(data[pos:end])
        pos = end
    pos += 1
    magic, w, h, maxv = toks[0], int(toks[1]), int(toks[2]), int(toks[3])
    if maxv > 255:
        raise ValueError("16-bit netpbm not supported")
    if magic == b"P6":
        return np.frombuffer(data[pos:pos + w*h*3],
                             np.uint8).reshape(h, w, 3)
    if magic == b"P5":
        return np.frombuffer(data[pos:pos + w*h], np.uint8).reshape(h, w)
    raise ValueError(f"unsupported netpbm magic {magic!r}")
