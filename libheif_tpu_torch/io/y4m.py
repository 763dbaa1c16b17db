"""YUV4MPEG2 reader/writer (reference: heifio/decoder_y4m.cc,
encoder_y4m.cc); counterpart of libheif_tpu/io/y4m.py.  Planar YCbCr
4:2:0 / 4:2:2 / 4:4:4, 8-bit.  A byte codec over numpy arrays: each
tensor plane given to ``write_y4m`` is copied to the host once."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .host import host_array

_CHROMA_DIV = {"420": (2, 2), "420jpeg": (2, 2), "420mpeg2": (2, 2),
               "420paldv": (2, 2), "422": (2, 1), "444": (1, 1)}


def write_y4m(frames: List[Tuple[object, object, object]],
              fps: Tuple[int, int] = (30, 1), chroma: str = "420") -> bytes:
    h, w = frames[0][0].shape
    hdr = f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip A1:1 C{chroma}\n"
    out = bytearray(hdr.encode())
    for frame in frames:
        out.extend(b"FRAME\n")
        for plane in frame:
            out.extend(np.ascontiguousarray(host_array(plane),
                                            np.uint8).tobytes())
    return bytes(out)


def read_y4m(data: bytes):
    """The stream's header fields and its frames as (Y, U, V) uint8
    numpy planes: {"width", "height", "chroma", "fps", "frames"}."""
    nl = data.index(b"\n")
    fields = data[:nl].decode().split()
    if fields[0] != "YUV4MPEG2":
        raise ValueError("not a Y4M stream")
    w = h = 0
    chroma = "420"
    fps = (30, 1)
    for f in fields[1:]:
        if f[0] == "W":
            w = int(f[1:])
        elif f[0] == "H":
            h = int(f[1:])
        elif f[0] == "C":
            chroma = f[1:]
        elif f[0] == "F":
            a, b = f[1:].split(":")
            fps = (int(a), int(b))
    dx, dy = _CHROMA_DIV.get(chroma, (2, 2))
    cw, ch_ = (w + dx - 1) // dx, (h + dy - 1) // dy
    frames = []
    pos = nl + 1
    fsize = w * h + 2 * cw * ch_
    while pos < len(data):
        fnl = data.index(b"\n", pos)
        if not data[pos:fnl].startswith(b"FRAME"):
            raise ValueError("bad Y4M frame marker")
        pos = fnl + 1
        if pos + fsize > len(data):
            break
        y = np.frombuffer(data[pos:pos + w * h], np.uint8).reshape(h, w)
        pos += w * h
        u = np.frombuffer(data[pos:pos + cw * ch_],
                          np.uint8).reshape(ch_, cw)
        pos += cw * ch_
        v = np.frombuffer(data[pos:pos + cw * ch_],
                          np.uint8).reshape(ch_, cw)
        pos += cw * ch_
        frames.append((y, u, v))
    return {"width": w, "height": h, "chroma": chroma, "fps": fps,
            "frames": frames}
