"""libaom's encoder on 4:2:2 input (AV1 profile 2), for the tests.

``tests/av1_oracle.py`` encodes I420 frames only; this helper drives the
same system libaom through its layout constants with an
``AOM_IMG_FMT_I422`` image and ``g_profile`` 2 (the professional profile,
which carries 4:2:2 at 8, 10 and 12 bits).  Its streams decode with
``av1_oracle.decode``, which reads each plane's subsampling from the
decoded image.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np

from tests import av1_oracle as O

_AOM_IMG_FMT_I422 = 0x105       # AOM_IMG_FMT_PLANAR | 5
_PROFILE_PROFESSIONAL = 2


def encode(planes: Dict[str, np.ndarray], options: Dict[str, str],
           bit_depth: int = 8) -> Optional[bytes]:
    """Encode one 4:2:2 frame ("Y" (h, w), "U"/"V" (h, (w + 1) // 2))
    with libaom as a key frame → OBU temporal unit bytes; options as for
    ``av1_oracle.encode`` ("_min_q"/"_max_q" set the quantiser range).
    None where libaom is missing or refuses."""
    lib = O._load()
    if lib is None:
        return None
    hbd = bit_depth > 8
    h, w = planes["Y"].shape
    cfg = (ctypes.c_uint8 * 8192)()
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    if lib.aom_codec_enc_config_default(iface, cfg, 0) != 0:
        return None
    u32 = ctypes.cast(cfg, ctypes.POINTER(ctypes.c_uint32))
    assert u32[O._CFG_W] == 320 and u32[O._CFG_H] == 240, \
        "enc cfg layout drift"
    u32[O._CFG_W] = w
    u32[O._CFG_H] = h
    u32[O._CFG_LIMIT] = 1
    u32[O._CFG_LAG] = 0
    u32[O._CFG_END_USAGE] = O._AOM_Q
    u32[O._CFG_THREADS] = 1
    u32[O._CFG_PROFILE] = _PROFILE_PROFESSIONAL
    if hbd:
        u32[O._CFG_BIT_DEPTH] = bit_depth
        u32[O._CFG_INPUT_BIT_DEPTH] = bit_depth
    options = dict(options)
    if "_min_q" in options:
        u32[O._CFG_MIN_Q] = int(options.pop("_min_q"))
    if "_max_q" in options:
        u32[O._CFG_MAX_Q] = int(options.pop("_max_q"))
    ctx = (ctypes.c_uint8 * 256)()
    flags = O._AOM_CODEC_USE_HIGHBITDEPTH if hbd else 0
    for abi in range(9, 48):
        if lib.aom_codec_enc_init_ver(ctx, iface, cfg, flags, abi) == 0:
            break
    else:
        return None
    try:
        for k, v in options.items():
            if lib.aom_codec_set_option(ctx, k.encode(),
                                        str(v).encode()) != 0:
                return None
        fmt = _AOM_IMG_FMT_I422 | (O._AOM_IMG_FMT_HIGHBITDEPTH if hbd
                                   else 0)
        img = ctypes.c_void_p(lib.aom_img_alloc(None, fmt, w, h, 16))
        if not img:
            return None
        try:
            dt = np.uint16 if hbd else np.uint8
            for i, name in enumerate(["Y", "U", "V"]):
                p = np.ascontiguousarray(planes[name], dt)
                stride = O._i32(img.value, O._IMG_STRIDE + 4 * i)
                dst = O._ptr(img.value, O._IMG_PLANES + 8 * i)
                for row in range(p.shape[0]):
                    ctypes.memmove(dst + row * stride, p[row].ctypes.data,
                                   p.shape[1] * p.itemsize)
            if lib.aom_codec_encode(ctx, img, 0, 1, 0) != 0:
                return None
            out = b""
            it = ctypes.c_void_p(None)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if O._u32(pkt, 0) == 0:       # AOM_CODEC_CX_FRAME_PKT
                    buf = O._ptr(pkt, 8)
                    sz = ctypes.cast(pkt + 16, ctypes.POINTER(
                        ctypes.c_size_t)).contents.value
                    out += ctypes.string_at(buf, sz)
            return out or None
        finally:
            lib.aom_img_free(img)
    finally:
        lib.aom_codec_destroy(ctx)
