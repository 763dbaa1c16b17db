"""Native (.so) plugin loading over the heif_tpu_plugin.h ABI.

The dlopen half of the plugin system: heif_load_plugin() routes shared
objects here; the exported heif_tpu_get_decoder_plugin() /
heif_tpu_get_encoder_plugin() function tables are wrapped in registry
Decoder/Encoder adapters, so a compiled C codec participates in format
dispatch exactly like the built-in cores (ref: init.cc:349 dlopen
loading, plugins_unix.cc, plugin_registry.cc:115-128 priority sets;
ABI model heif_plugin.h:85,192); counterpart of
libheif_tpu/api/native_plugin.py.

The C codec works on host memory: the decoder's plane becomes a CPU
tensor over a copy of the returned buffer (``registry.decoder_for``
moves it to the context's device in one copy), and the encoder reads
the image's Y plane with one ``.cpu()`` copy.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.error import HeifError, SubError
from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..codecs import registry

PLUGIN_API_VERSION = 1


class _DecoderTable(ctypes.Structure):
    _fields_ = [
        ("plugin_api_version", ctypes.c_int),
        ("id", ctypes.c_char_p),
        ("format", ctypes.c_char_p),
        ("priority", ctypes.c_int),
        ("decode", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))),
        ("free_plane", ctypes.CFUNCTYPE(
            None, ctypes.POINTER(ctypes.c_uint8))),
    ]


class _EncoderTable(ctypes.Structure):
    _fields_ = [
        ("plugin_api_version", ctypes.c_int),
        ("id", ctypes.c_char_p),
        ("format", ctypes.c_char_p),
        ("priority", ctypes.c_int),
        ("encode", ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t))),
        ("free_data", ctypes.CFUNCTYPE(
            None, ctypes.POINTER(ctypes.c_uint8))),
    ]


class NativePluginDecoder(registry.Decoder):
    """Registry adapter over a native decoder function table."""

    def __init__(self, lib, table: _DecoderTable):
        self._lib = lib               # keep the dlopen handle alive
        self._table = table
        self.id = (table.id or b"native").decode()
        self.format = (table.format or b"unknown").decode()
        self.priority = int(table.priority)

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        plane = ctypes.POINTER(ctypes.c_uint8)()
        w = ctypes.c_int(0)
        h = ctypes.c_int(0)
        rc = self._table.decode(buf, len(data), ctypes.byref(plane),
                                ctypes.byref(w), ctypes.byref(h))
        if rc != 0 or not plane:
            raise HeifError.invalid_input(
                msg=f"native plugin '{self.id}' decode failed (rc={rc})")
        try:
            if limits is not None:
                limits.check_image_size(w.value, h.value)
            arr = np.ctypeslib.as_array(plane,
                                        shape=(h.value, w.value)).copy()
        finally:
            self._table.free_plane(plane)
        img = PixelImage(w.value, h.value, Colorspace.Monochrome,
                         Chroma.Monochrome, limits, device="cpu")
        img.set_plane(Channel.Y, torch.from_numpy(arr), 8)
        return img


class NativePluginEncoder(registry.Encoder):
    """Registry adapter over a native encoder function table."""

    lossless_supported = True

    def __init__(self, lib, table: _EncoderTable):
        self._lib = lib
        self._table = table
        self.id = (table.id or b"native").decode()
        self.format = (table.format or b"unknown").decode()
        self.priority = int(table.priority)

    def encode_single_image(self, img: PixelImage, options=None):
        if img.has_channel(Channel.Y):
            plane = np.ascontiguousarray(
                img.plane(Channel.Y).cpu().numpy().astype(np.uint8,
                                                          copy=False))
        else:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "native plugin encoders take monochrome input (ABI v1)")
        src = plane.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        out = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_size_t(0)
        rc = self._table.encode(src, plane.shape[1], plane.shape[0],
                                ctypes.byref(out), ctypes.byref(size))
        if rc != 0 or not out:
            raise HeifError.invalid_input(
                msg=f"native plugin '{self.id}' encode failed (rc={rc})")
        try:
            data = ctypes.string_at(out, size.value)
        finally:
            self._table.free_data(out)
        return data, None, []


def is_native_plugin_path(path: str) -> bool:
    return path.endswith((".so", ".dylib", ".dll")) or ".so." in path


def load_native_plugin(path: str
                       ) -> Tuple[object, List[registry.Decoder],
                                  List[registry.Encoder]]:
    """dlopen `path`, read its plugin tables, register them.
    Returns (dl handle, registered decoders, registered encoders)."""
    try:
        lib = ctypes.CDLL(path)
    except OSError as exc:
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"cannot dlopen plugin: {path}: {exc}") from exc

    decoders: List[registry.Decoder] = []
    encoders: List[registry.Encoder] = []

    get_dec = getattr(lib, "heif_tpu_get_decoder_plugin", None)
    if get_dec is not None:
        get_dec.restype = ctypes.POINTER(_DecoderTable)
        tbl = get_dec()
        if tbl:
            table = tbl.contents
            if table.plugin_api_version != PLUGIN_API_VERSION:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec,
                    f"plugin ABI v{table.plugin_api_version} != "
                    f"v{PLUGIN_API_VERSION}: {path}")
            dec = NativePluginDecoder(lib, table)
            registry.register_decoder(dec)
            decoders.append(dec)

    get_enc = getattr(lib, "heif_tpu_get_encoder_plugin", None)
    if get_enc is not None:
        get_enc.restype = ctypes.POINTER(_EncoderTable)
        tbl = get_enc()
        if tbl:
            table = tbl.contents
            if table.plugin_api_version != PLUGIN_API_VERSION:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec,
                    f"plugin ABI v{table.plugin_api_version} != "
                    f"v{PLUGIN_API_VERSION}: {path}")
            enc = NativePluginEncoder(lib, table)
            registry.register_encoder(enc)
            encoders.append(enc)

    if not decoders and not encoders:
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"shared object exports no heif_tpu plugin tables: {path}")
    return lib, decoders, encoders
