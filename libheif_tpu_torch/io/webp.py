"""WebP import/export (heifio equivalent); counterpart of
libheif_tpu/io/webp.py.

Re-designed equivalent of the reference's heifio WebP converters
(reference: heifio/decoder_webp.cc, heifio/encoder_webp.cc).  Like the
reference, this wraps the system libwebp — here via ctypes rather than
a compile-time link, gated at runtime: if libwebp is absent the
functions raise Unsupported_codec (mirroring the reference's
`--with webp` build gate, heifio/CMakeLists.txt).  libwebp works on host
buffers: the image's planes lie on its device, with one copy each way
(``read_webp``'s ``device=None`` means CUDA).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

from .._build import resolve_device
from ..core.error import HeifError, SubError
from .host import interleaved_host, planes_on_device

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    for name in ("libwebp.so.7", "libwebp.so", "libwebp.dylib",
                 ctypes.util.find_library("webp")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.WebPGetInfo.restype = ctypes.c_int
        lib.WebPGetInfo.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.WebPDecodeRGBA.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.WebPDecodeRGBA.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        for fn in ("WebPEncodeRGB", "WebPEncodeRGBA"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_size_t
            f.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float,
                          ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        for fn in ("WebPEncodeLosslessRGB", "WebPEncodeLosslessRGBA"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_size_t
            f.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int,
                          ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.WebPFree.restype = None
        lib.WebPFree.argtypes = [ctypes.c_void_p]
        return lib
    return None


def _webp() -> ctypes.CDLL:
    global _lib, _lib_tried
    with _lib_lock:
        if not _lib_tried:
            _lib_tried = True
            _lib = _load()
    if _lib is None:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "libwebp not available")
    return _lib


def read_webp(data: bytes, device=None):
    """WebP bytes → PixelImage (RGB, alpha preserved when present) on
    ``device``."""
    from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
    dev = resolve_device(device)
    lib = _webp()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if not lib.WebPGetInfo(data, len(data), ctypes.byref(w),
                           ctypes.byref(h)):
        raise HeifError.invalid_input(msg="not a WebP file")
    buf = lib.WebPDecodeRGBA(data, len(data), ctypes.byref(w),
                             ctypes.byref(h))
    if not buf:
        raise HeifError.invalid_input(msg="WebP decode failed")
    try:
        n = w.value * h.value * 4
        arr = np.ctypeslib.as_array(buf, shape=(n,)).reshape(
            h.value, w.value, 4).copy()
    finally:
        lib.WebPFree(buf)
    names = [Channel.R, Channel.G, Channel.B]
    if not np.all(arr[:, :, 3] == 255):
        names.append(Channel.Alpha)
    img = PixelImage(w.value, h.value, Colorspace.RGB, Chroma.C444,
                     device=dev)
    for ch, p in zip(names, planes_on_device(arr[:, :, :len(names)], dev)):
        img.set_plane(ch, p, 8)
    return img


def write_webp(img, quality: int = 90, lossless: bool = False) -> bytes:
    """PixelImage → WebP bytes (RGB(A) 8-bit; convert first if needed).

    quality 0..100; lossless=True uses the VP8L path (quality ignored),
    matching the reference encoder's -L handling (encoder_webp.cc).
    """
    from ..image.pixel_image import Channel, Colorspace, Chroma
    from ..color import convert_image
    if not img.has_channel(Channel.R):
        img = convert_image(img, Colorspace.RGB, Chroma.C444,
                            device=next(iter(img.planes.values())).device)
    has_alpha = img.has_channel(Channel.Alpha)
    names = [Channel.R, Channel.G, Channel.B] + \
        ([Channel.Alpha] if has_alpha else [])
    inter = interleaved_host([img.plane(c) for c in names])
    depths = [img.bit_depth(c) for c in names]
    if depths[0] > 8:
        inter[:, :, :3] >>= depths[0] - 8
    if has_alpha and depths[3] > 8:
        inter[:, :, 3] >>= depths[3] - 8
    inter = inter.astype(np.uint8)
    h, w = inter.shape[:2]
    stride = w * len(names)
    raw = inter.tobytes()

    lib = _webp()
    out = ctypes.POINTER(ctypes.c_uint8)()
    if lossless:
        fn = lib.WebPEncodeLosslessRGBA if has_alpha else \
            lib.WebPEncodeLosslessRGB
        size = fn(raw, w, h, stride, ctypes.byref(out))
    else:
        fn = lib.WebPEncodeRGBA if has_alpha else lib.WebPEncodeRGB
        size = fn(raw, w, h, stride, ctypes.c_float(quality),
                  ctypes.byref(out))
    if size == 0 or not out:
        raise HeifError.usage(msg="WebP encode failed")
    try:
        data = ctypes.string_at(out, size)
    finally:
        lib.WebPFree(out)
    return data


def read_webp_file(path: str, device=None):
    with open(path, "rb") as f:
        return read_webp(f.read(), device)


def write_webp_file(img, path: str, quality: int = 90,
                    lossless: bool = False) -> None:
    with open(path, "wb") as f:
        f.write(write_webp(img, quality, lossless))
