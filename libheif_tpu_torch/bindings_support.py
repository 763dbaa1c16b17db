"""Support layer for the C ABI shim (bindings/c/heif_shim.c) over the
port; counterpart of libheif_tpu/bindings_support.py.

The embedded interpreter calls only these flat functions, keeping the C
side free of in-Python object navigation.  Enum integers use the
upstream libheif ABI values (reference:
libheif/api/libheif/heif_image.h:55-127, heif_error.h) so the shim's
header stays drop-in compatible.

The C side passes no device: contexts and images are made on the device
that the environment variable ``LIBHEIF_TPU_TORCH_DEVICE`` names, read
at each call.  Unset means CUDA, which raises without a card; set it to
``cpu`` for the CPU.  ``plane`` hands the C side a host array, one
device-to-host copy a plane.  The shim imports the module by name: a
build over the port replaces ``libheif_tpu.bindings_support`` in
``heif_shim.c`` with ``libheif_tpu_torch.bindings_support``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import resolve_device
from .context import HeifContext
from .core.error import HeifError
from .image.pixel_image import Channel, Chroma, Colorspace, PixelImage

DEVICE_VARIABLE = "LIBHEIF_TPU_TORCH_DEVICE"


def device() -> torch.device:
    """The device the shim's contexts and images are made on: the one
    ``LIBHEIF_TPU_TORCH_DEVICE`` names, else CUDA (raises without one)."""
    return resolve_device(os.environ.get(DEVICE_VARIABLE) or None)


_COLORSPACE_FROM_C = {
    99: Colorspace.Undefined,
    0: Colorspace.YCbCr,
    1: Colorspace.RGB,
    2: Colorspace.Monochrome,
}
_COLORSPACE_TO_C = {
    Colorspace.Undefined: 99,
    Colorspace.YCbCr: 0,
    Colorspace.RGB: 1,
    Colorspace.Monochrome: 2,
}
_CHROMA_FROM_C = {
    99: Chroma.Undefined,
    0: Chroma.Monochrome,
    1: Chroma.C420,
    2: Chroma.C422,
    3: Chroma.C444,
    10: Chroma.InterleavedRGB,
    11: Chroma.InterleavedRGBA,
}
_CHROMA_TO_C = {v: k for k, v in _CHROMA_FROM_C.items()}
_CHANNEL_FROM_C = {
    0: Channel.Y,
    1: Channel.Cb,
    2: Channel.Cr,
    3: Channel.R,
    4: Channel.G,
    5: Channel.B,
    6: Channel.Alpha,
    10: Channel.Interleaved,
}


def version() -> str:
    from . import __version__
    return "libheif_tpu_torch " + __version__


def context_new() -> HeifContext:
    return HeifContext(device=device())


def read_from_file(path: str) -> HeifContext:
    return HeifContext.read_from_file(path, device=device())


def read_from_memory(data: bytes) -> HeifContext:
    return HeifContext.read_from_bytes(data, device=device())


def top_level_count(ctx: HeifContext) -> int:
    return len(ctx.top_level_image_ids())


def primary_id(ctx: HeifContext) -> int:
    return ctx.primary_item_id


def handle_info(ctx: HeifContext, item_id: int) -> Tuple[int, int, int, int]:
    """(width, height, is_primary, has_alpha) for an image item."""
    item = ctx.get_item(item_id)
    try:
        w, h = item.width_height()
    except Exception:   # noqa: BLE001 — metadata-only items
        w = h = 0
    primary = 1 if item_id == ctx.primary_item_id else 0
    alpha = 1 if getattr(item, "has_alpha", lambda: False)() else 0
    return int(w), int(h), primary, alpha


def decode(ctx: HeifContext, item_id: int, colorspace_c: int,
           chroma_c: int) -> PixelImage:
    return ctx.decode_image(
        item_id,
        colorspace=_COLORSPACE_FROM_C.get(colorspace_c,
                                          Colorspace.Undefined),
        chroma=_CHROMA_FROM_C.get(chroma_c, Chroma.Undefined))


def image_info(img: PixelImage) -> Tuple[int, int, int, int]:
    """(colorspace_c, chroma_c, width, height)."""
    return (_COLORSPACE_TO_C.get(img.colorspace, 99),
            _CHROMA_TO_C.get(img.chroma, 99), img.width, img.height)


def has_channel(img: PixelImage, channel_c: int) -> int:
    ch = _CHANNEL_FROM_C.get(channel_c)
    return 1 if (ch is not None and ch in img.channels()) else 0


def channel_size(img: PixelImage, channel_c: int) -> Tuple[int, int, int]:
    """(width, height, bit_depth) of one channel; (0,0,0) if absent."""
    ch = _CHANNEL_FROM_C.get(channel_c)
    if ch is None or ch not in img.channels():
        return 0, 0, 0
    w, h = img.plane_size(ch)
    return int(w), int(h), int(img.bit_depth(ch))


def plane(img: PixelImage, channel_c: int) -> Optional[np.ndarray]:
    """C-contiguous host array for the channel (rows x row-bytes; one
    device-to-host copy), kept alive by the shim's Py_buffer until
    heif_image_release."""
    ch = _CHANNEL_FROM_C.get(channel_c)
    if ch is None or ch not in img.channels():
        return None
    arr = np.ascontiguousarray(img.np_plane(ch))
    if arr.dtype == np.uint16 and img.bit_depth(ch) <= 8:
        arr = arr.astype(np.uint8)
    return arr


def image_create(width: int, height: int, colorspace_c: int,
                 chroma_c: int) -> PixelImage:
    return PixelImage(width, height,
                      _COLORSPACE_FROM_C.get(colorspace_c,
                                             Colorspace.Undefined),
                      _CHROMA_FROM_C.get(chroma_c, Chroma.Undefined),
                      device=device())


def image_set_plane(img: PixelImage, channel_c: int, data: bytes,
                    width: int, height: int, stride: int,
                    bit_depth: int) -> None:
    ch = _CHANNEL_FROM_C.get(channel_c)
    if ch is None:
        raise HeifError.usage(msg="unknown channel")
    dtype = np.uint16 if bit_depth > 8 else np.uint8
    itemsize = np.dtype(dtype).itemsize
    rows = np.frombuffer(data, np.uint8).reshape(height, stride)
    arr = rows[:, :width * itemsize].view(dtype).reshape(height, width)
    dev = img.device if img.device is not None else device()
    img.set_plane(ch, torch.from_numpy(arr.copy()).to(dev), bit_depth)


def encode(ctx: HeifContext, img: PixelImage, codec: str,
           quality: int) -> int:
    from .api.encoding import EncodingOptions
    opts = EncodingOptions()
    if quality >= 0:
        opts.quality = min(quality, 100)
        if quality == 100:
            opts.lossless = True
    item = ctx.encode_image(img, codec or "hevc", opts)
    ctx.set_primary_item(item)
    return int(item)


def write_to_file(ctx: HeifContext, path: str) -> None:
    ctx.write_to_file(path)


def error_info(exc: BaseException) -> Tuple[int, int, str]:
    """(code, subcode, message) using upstream heif_error_code values."""
    if isinstance(exc, HeifError):
        return int(exc.code), int(exc.subcode), str(exc)
    if isinstance(exc, FileNotFoundError):
        return 1, 0, str(exc)
    return 2, 0, f"{type(exc).__name__}: {exc}"


# ------------------------------------------------------------------ #
# generic router: the widened C shim marshals by API NAME into the
# libheif_tpu_torch.api package (whose functions mirror the upstream C API
# 1:1, see api/*.py).  The C side only builds positional arg tuples.

_API_MODULE_NAMES = (
    "context", "image_handle", "items", "metadata", "regions", "text",
    "tiling", "sequences", "security", "color", "encoding", "decoding",
    "image", "aux_images", "brands", "entity_groups", "properties",
    "library", "components", "uncompressed", "tai_timestamps", "omaf",
    "experimental", "plugin",
)

_api_fns: dict = {}


# upstream heif_compression_format enum (heif_library.h) -> codec name
_COMPRESSION_FROM_C = {
    0: "undefined", 1: "hevc", 2: "avc", 3: "jpeg", 4: "av1", 5: "vvc",
    6: "evc", 7: "j2k", 8: "unci", 9: "mask", 10: "htj2k",
}
_COMPRESSION_TO_C = {v: k for k, v in _COMPRESSION_FROM_C.items()}


def _shim_adapters() -> dict:
    """Signature adapters where the flat C marshaling differs from the
    Python api layer (object construction, enum translation)."""
    from .api.image_handle import heif_image_handle

    def handle_new(ctx, item_id):
        return heif_image_handle(ctx, int(item_id))

    def compression_name(fmt_c):
        return _COMPRESSION_FROM_C.get(int(fmt_c), "undefined")

    def compression_code(name):
        return _COMPRESSION_TO_C.get(str(name), 0)

    def obj_getattr(obj, name):
        return getattr(obj, name)

    def obj_setattr(obj, name, value):
        setattr(obj, name, value)

    def seq_item(seq, idx):
        return seq[int(idx)]

    def seq_len(seq):
        return len(seq)

    def to_bytes(v):
        if v is None:
            return b""
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            return v.encode()
        return bytes(v)

    def security_get(limits, field):
        return int(getattr(limits, field, 0) or 0)

    def security_set(limits, field, value):
        if hasattr(limits, field):
            setattr(limits, field, int(value))

    def handle_decode(handle, colorspace_c, chroma_c):
        return decode(handle.ctx, handle.item_id, colorspace_c, chroma_c)

    def flatten_ints(v):
        """Flatten ints / tuples / lists of tuples into an int list
        (points, sizes ... marshaled into caller-provided C arrays)."""
        out = []

        def rec(x):
            if isinstance(x, (list, tuple)):
                for e in x:
                    rec(e)
            elif x is None:
                out.append(0)
            elif isinstance(x, bool):
                out.append(1 if x else 0)
            elif isinstance(x, float):
                out.append(int(x))
            else:
                out.append(int(x))
        rec(v)
        return out

    def ctx_set_primary_id(ctx, item_id):
        ctx.set_primary_item(int(item_id))

    def ctx_set_major_brand(ctx, brand):
        # recorded for write(); _finalize_brands consults it
        ctx.forced_major_brand = str(brand)

    def ctx_get_max_threads(ctx):
        return int(getattr(ctx, "max_decoding_threads", 0) or 0)

    def ctx_debug_dump(ctx):
        return ctx.debug_dump_boxes()

    def img_extend_zero(img, w, h):
        from .api.image import heif_image_extend_padding_to_size
        heif_image_extend_padding_to_size(img, int(w), int(h))

    def img_extract_area(img, x0, y0, w, h):
        return img.crop(int(x0), int(y0), int(w), int(h))

    def img_remove_color_profile(img):
        img.color_profile_icc = None
        img.color_profile_nclx = None

    def img_set_nclx_values(img, cp, tc, mc, fr):
        from .api.color import (heif_nclx_color_profile_alloc)
        p = heif_nclx_color_profile_alloc()
        p.color_primaries = int(cp)
        p.transfer_characteristics = int(tc)
        p.matrix_coefficients = int(mc)
        p.full_range_flag = bool(fr)
        img.color_profile_nclx = p

    def img_set_clli_values(img, max_cll, max_pall):
        from .boxes.meta import Box_clli
        b = Box_clli()
        b.max_content_light_level = int(max_cll)
        b.max_pic_average_light_level = int(max_pall)
        from .api.image import heif_image_set_content_light_level
        heif_image_set_content_light_level(img, b)

    def ctx_add_image_tile_id(ctx, tili_id, tx, ty, img, codec):
        ctx.add_image_tile_to_tiled(int(tili_id), int(tx), int(ty), img)

    def ctx_assign_thumbnail_ids(ctx, master_id, thumb_id):
        from .api.encoding import heif_context_assign_thumbnail
        from .api.image_handle import heif_image_handle
        heif_context_assign_thumbnail(
            ctx, heif_image_handle(ctx, int(master_id)),
            heif_image_handle(ctx, int(thumb_id)))

    def add_grid_image(ctx, w, h, cols, rows, tile_ids):
        gid = ctx.add_grid_image([int(t) for t in tile_ids], int(w),
                                 int(h), rows=int(rows),
                                 columns=int(cols))
        return int(gid)

    return {
        "heif_context_set_primary_image_id": ctx_set_primary_id,
        "heif_context_set_major_brand": ctx_set_major_brand,
        "heif_context_get_max_decoding_threads": ctx_get_max_threads,
        "heif_context_debug_dump_boxes": ctx_debug_dump,
        "heif_image_extend_to_size_fill_with_zero": img_extend_zero,
        "heif_image_extract_area": img_extract_area,
        "heif_image_remove_color_profile": img_remove_color_profile,
        "heif_image_set_nclx_color_profile_values": img_set_nclx_values,
        "heif_image_set_content_light_level_values": img_set_clli_values,
        "heif_context_add_image_tile_id": ctx_add_image_tile_id,
        "heif_context_assign_thumbnail_ids": ctx_assign_thumbnail_ids,
        "shim_add_grid_image": add_grid_image,
        "shim_handle_new": handle_new,
        "shim_compression_name": compression_name,
        "shim_compression_code": compression_code,
        "shim_obj_getattr": obj_getattr,
        "shim_obj_setattr": obj_setattr,
        "shim_seq_item": seq_item,
        "shim_seq_len": seq_len,
        "shim_to_bytes": to_bytes,
        "shim_security_get": security_get,
        "shim_security_set": security_set,
        "shim_handle_decode": handle_decode,
        "shim_flatten_ints": flatten_ints,
    }


def _resolve(name: str):
    if not _api_fns:
        import importlib
        for mname in _API_MODULE_NAMES:
            try:
                mod = importlib.import_module(
                    f"libheif_tpu_torch.api.{mname}")
            except Exception:   # noqa: BLE001 — optional module
                continue
            for k, v in vars(mod).items():
                if callable(v) and (k.startswith("heif_")):
                    _api_fns.setdefault(k, v)
        _api_fns.update(_shim_adapters())
    fn = _api_fns.get(name)
    if fn is None:
        from .core.error import SubError
        raise HeifError.unsupported(
            SubError.Unsupported_parameter,
            msg=f"API function not available: {name}")
    return fn


def api_call(name: str, args: tuple):
    """Entry point for the C shim's generic dispatcher."""
    return _resolve(name)(*args)
