"""Encode intra HEVC pictures with libx265 (x265 3.5, ``libx265.so.199``)
through ctypes, for the streams the JAX package's IntraEncoder cannot
write: SAO in pictures of several slices, and lossless
(cu_transquant_bypass) CUs beside lossy ones.

Options go through ``x265_param_parse`` by name, so only two structures
are read by layout: ``x265_picture`` (planes at byte 24, strides at 48,
bitDepth at 60, colorSpace at 72; x265.h of X265_BUILD 199, checked
against the values x265_picture_init writes) and ``x265_nal`` (type,
sizeBytes, payload).  8-bit 4:2:0 only.

    encode(y, cb, cr, qp=30, slices=4, sao=True) -> [VPS, SPS, PPS,
    slice NALs ...]  (NAL units without start codes; SEI dropped)
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np

_lib = None


class _Nal(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("size", ctypes.c_uint32),
                ("payload", ctypes.POINTER(ctypes.c_uint8))]


def _load():
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL("libx265.so.199")
        except OSError:
            return None
        vp = ctypes.c_void_p
        for name, res, args in (
                ("x265_param_alloc", vp, []),
                ("x265_param_free", None, [vp]),
                ("x265_param_default_preset", ctypes.c_int,
                 [vp, ctypes.c_char_p, ctypes.c_char_p]),
                ("x265_param_parse", ctypes.c_int,
                 [vp, ctypes.c_char_p, ctypes.c_char_p]),
                ("x265_picture_alloc", vp, []),
                ("x265_picture_free", None, [vp]),
                ("x265_picture_init", None, [vp, vp]),
                ("x265_encoder_open_199", vp, [vp]),
                ("x265_encoder_encode", ctypes.c_int,
                 [vp, ctypes.POINTER(ctypes.POINTER(_Nal)),
                  ctypes.POINTER(ctypes.c_uint32), vp, vp]),
                ("x265_encoder_close", None, [vp])):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _split_annexb(buf: bytes) -> List[bytes]:
    out, i, n = [], 0, len(buf)
    starts = []
    while i + 3 <= n:
        if buf[i:i + 3] == b"\x00\x00\x01":
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        nal = buf[s:e]
        while nal.endswith(b"\x00"):       # the next 4-byte start code
            nal = nal[:-1]
        out.append(nal)
    return out


def encode(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, qp: int = 30,
           **opts) -> List[bytes]:
    """One 8-bit 4:2:0 picture → its NAL units (VPS, SPS, PPS, slices).
    ``opts`` are x265 options by name (``slices=4``, ``sao=True``,
    ``cu_lossless=True``; underscores become dashes, booleans
    "1"/"0")."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libx265.so.199 not available")
    h, w = y.shape
    p = lib.x265_param_alloc()
    try:
        if lib.x265_param_default_preset(p, b"medium", None) != 0:
            raise RuntimeError("x265_param_default_preset failed")
        base: Dict[str, object] = {
            "input-res": f"{w}x{h}", "fps": "25", "input-csp": "i420",
            "keyint": "1", "qp": str(qp), "aq-mode": "0",
            "cutree": False, "frame-threads": "1",
            "pools": "1", "repeat-headers": True, "info": False,
            "hash": "0", "log-level": "none", "signhide": True,
            "psy-rd": "0", "psy-rdoq": "0"}
        for k, v in opts.items():
            base[k.replace("_", "-")] = v
        for k, v in base.items():
            if isinstance(v, bool):
                v = "1" if v else "0"
            if lib.x265_param_parse(p, k.encode(), str(v).encode()) != 0:
                raise RuntimeError(f"x265_param_parse({k}={v}) failed")
        enc = lib.x265_encoder_open_199(p)
        if not enc:
            raise RuntimeError("x265_encoder_open failed")
        pic = lib.x265_picture_alloc()
        try:
            lib.x265_picture_init(p, pic)
            raw = (ctypes.c_int32 * 20).from_address(pic)
            if raw[15] != 8 or raw[18] != 1:     # bitDepth, colorSpace
                raise RuntimeError("unexpected x265_picture layout")
            planes = [np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr)]
            ptrs = (ctypes.c_void_p * 3).from_address(pic + 24)
            strides = (ctypes.c_int32 * 3).from_address(pic + 48)
            for i, a in enumerate(planes):
                ptrs[i] = a.ctypes.data
                strides[i] = a.strides[0]
            stream = b""
            nals = ctypes.POINTER(_Nal)()
            n = ctypes.c_uint32(0)
            src: Optional[int] = pic
            for _ in range(64):
                rc = lib.x265_encoder_encode(enc, ctypes.byref(nals),
                                             ctypes.byref(n), src, None)
                if rc < 0:
                    raise RuntimeError("x265_encoder_encode failed")
                for i in range(n.value):
                    stream += ctypes.string_at(nals[i].payload,
                                               nals[i].size)
                if src is None and rc == 0:
                    break
                src = None
        finally:
            lib.x265_picture_free(pic)
            lib.x265_encoder_close(enc)
    finally:
        lib.x265_param_free(p)
    return [nal for nal in _split_annexb(stream)
            if ((nal[0] >> 1) & 0x3F) not in (39, 40)]
