"""Baseline TIFF import/export (heifio equivalent); counterpart of
libheif_tpu/io/tiff.py.

Re-designed equivalent of the reference's heifio TIFF converters
(reference: heifio/decoder_tiff.cc, heifio/encoder_tiff.cc) without
libtiff: baseline TIFF 6.0, uncompressed, 8/16-bit greyscale, RGB and
RGBA, strip-based, both endiannesses on read, little-endian on write.
The file is parsed and built on the host; the image's planes lie on its
device, with one copy each way (``read_tiff``'s ``device=None`` means
CUDA).
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from .._build import resolve_device
from ..core.error import HeifError, SubError
from .host import interleaved_host, planes_on_device

# TIFF tags
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_EXTRA_SAMPLES = 338
_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8}


def _read_ifd_value(data: bytes, endian: str, vtype: int, count: int,
                    value_field: bytes) -> List[int]:
    size = _TYPE_SIZES.get(vtype)
    if size is None:
        return []
    total = size * count
    if total <= 4:
        raw = value_field[:total]
    else:
        off = struct.unpack(endian + "I", value_field)[0]
        if off + total > len(data):
            raise HeifError.invalid_input(msg="TIFF value beyond file end")
        raw = data[off:off + total]
    fmt = {1: "B", 3: "H", 4: "I"}.get(vtype)
    if fmt is None:
        if vtype == 5:  # RATIONAL
            vals = struct.unpack(endian + "I" * (2 * count), raw)
            return [vals[i] // max(1, vals[i + 1])
                    for i in range(0, len(vals), 2)]
        return list(raw)
    return list(struct.unpack(endian + fmt * count, raw))


def read_tiff(data: bytes, device=None):
    """Baseline TIFF bytes → PixelImage (RGB/RGBA/monochrome) on
    ``device``."""
    from ..image.pixel_image import (PixelImage, Channel, Colorspace,
                                     Chroma)
    if len(data) < 8:
        raise HeifError.invalid_input(msg="TIFF too small")
    if data[:2] == b"II":
        endian = "<"
    elif data[:2] == b"MM":
        endian = ">"
    else:
        raise HeifError.invalid_input(msg="not a TIFF file")
    magic, ifd_off = struct.unpack(endian + "HI", data[2:8])
    if magic != 42:
        raise HeifError.invalid_input(msg="bad TIFF magic")

    if ifd_off + 2 > len(data):
        raise HeifError.eof("TIFF IFD beyond file end")
    n = struct.unpack(endian + "H", data[ifd_off:ifd_off + 2])[0]
    tags: Dict[int, List[int]] = {}
    pos = ifd_off + 2
    for _ in range(n):
        if pos + 12 > len(data):
            raise HeifError.eof("TIFF IFD entry beyond file end")
        tag, vtype, count = struct.unpack(endian + "HHI", data[pos:pos + 8])
        tags[tag] = _read_ifd_value(data, endian, vtype, count,
                                    data[pos + 8:pos + 12])
        pos += 12

    width = tags.get(_IMAGE_WIDTH, [0])[0]
    height = tags.get(_IMAGE_LENGTH, [0])[0]
    if not width or not height:
        raise HeifError.invalid_input(msg="TIFF without dimensions")
    compression = tags.get(_COMPRESSION, [1])[0]
    if compression != 1:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    f"TIFF compression {compression}")
    spp = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    bps_list = tags.get(_BITS_PER_SAMPLE, [8] * spp)
    bps = bps_list[0]
    if bps not in (8, 16) or any(b != bps for b in bps_list):
        raise HeifError.unsupported(SubError.Unsupported_bit_depth,
                                    f"TIFF bits per sample {bps_list}")
    planar = tags.get(_PLANAR_CONFIG, [1])[0]
    if planar != 1:
        raise HeifError.unsupported(SubError.Unsupported_data_version,
                                    "planar TIFF not supported")

    offsets = tags.get(_STRIP_OFFSETS, [])
    counts = tags.get(_STRIP_BYTE_COUNTS, [])
    if not offsets:
        raise HeifError.invalid_input(msg="TIFF without strips")
    if not counts:
        counts = [len(data) - offsets[0]]
    raw = bytearray()
    for off, cnt in zip(offsets, counts):
        if off + cnt > len(data):
            raise HeifError.eof("TIFF strip beyond file end")
        raw += data[off:off + cnt]

    dtype = np.dtype(endian + ("u2" if bps == 16 else "u1"))
    need = width * height * spp
    arr = np.frombuffer(bytes(raw), dtype=dtype, count=need)
    arr = arr.reshape(height, width, spp).astype(
        np.uint16 if bps == 16 else np.uint8)

    dev = resolve_device(device)
    if spp == 1:
        img = PixelImage(width, height, Colorspace.Monochrome,
                         Chroma.Monochrome, device=dev)
        img.set_plane(Channel.Y, planes_on_device(arr, dev)[0], bps)
        return img
    img = PixelImage(width, height, Colorspace.RGB, Chroma.C444, device=dev)
    names = (Channel.R, Channel.G, Channel.B, Channel.Alpha)
    planes = planes_on_device(arr[:, :, :min(spp, 4)], dev)
    for ch, p in zip(names, planes):
        img.set_plane(ch, p, bps)
    return img


def write_tiff(img) -> bytes:
    """PixelImage (RGB/RGBA/monochrome) → little-endian baseline TIFF."""
    from ..image.pixel_image import Channel, Colorspace

    if img.colorspace == Colorspace.Monochrome or \
            (img.has_channel(Channel.Y) and not img.has_channel(Channel.R)):
        channels = [Channel.Y]
        photometric = 1
    elif img.has_channel(Channel.R):
        channels = [Channel.R, Channel.G, Channel.B]
        photometric = 2
        if img.has_channel(Channel.Alpha):
            channels.append(Channel.Alpha)
    else:
        raise HeifError.usage(msg="write_tiff needs RGB or monochrome "
                                  "input; convert first")
    bps = img.bit_depth(channels[0])
    store = 16 if bps > 8 else 8
    inter = interleaved_host([img.plane(c) for c in channels]).astype(
        "<u2" if store == 16 else "u1")
    h, w, spp = inter.shape
    pixel_data = inter.tobytes()

    entries = []

    def entry(tag, vtype, count, value):
        entries.append((tag, vtype, count, value))

    header_size = 8
    # IFD follows pixel data
    strip_offset = header_size
    ifd_offset = header_size + len(pixel_data)

    bps_count = spp
    extra_after_ifd = []
    # values too large for the 4-byte field go after the IFD
    n_entries = 10 + (1 if spp in (2, 4) else 0)
    ifd_size = 2 + n_entries * 12 + 4
    tail_offset = ifd_offset + ifd_size

    if bps_count * 2 > 4:
        bps_value = tail_offset
        extra_after_ifd.append(struct.pack("<" + "H" * spp,
                                           *([store] * spp)))
        tail_offset += 2 * spp
    else:
        packed = list([store] * spp) + [0] * (2 - spp)
        bps_value = packed[0] | (packed[1] << 16)

    entry(_IMAGE_WIDTH, 4, 1, w)
    entry(_IMAGE_LENGTH, 4, 1, h)
    entry(_BITS_PER_SAMPLE, 3, spp, bps_value)
    entry(_COMPRESSION, 3, 1, 1)
    entry(_PHOTOMETRIC, 3, 1, photometric)
    entry(_STRIP_OFFSETS, 4, 1, strip_offset)
    entry(_SAMPLES_PER_PIXEL, 3, 1, spp)
    entry(_ROWS_PER_STRIP, 4, 1, h)
    entry(_STRIP_BYTE_COUNTS, 4, 1, len(pixel_data))
    entry(_SAMPLE_FORMAT, 3, 1, 1)
    if spp in (2, 4):
        entry(_EXTRA_SAMPLES, 3, 1, 2)   # unassociated alpha

    out = bytearray()
    out += b"II" + struct.pack("<HI", 42, ifd_offset)
    out += pixel_data
    out += struct.pack("<H", len(entries))
    for tag, vtype, count, value in sorted(entries):
        out += struct.pack("<HHII", tag, vtype, count, value)
    out += struct.pack("<I", 0)   # next IFD
    for blob in extra_after_ifd:
        out += blob
    return bytes(out)


def read_tiff_file(path: str, device=None):
    with open(path, "rb") as f:
        return read_tiff(f.read(), device)


def write_tiff_file(img, path: str) -> None:
    with open(path, "wb") as f:
        f.write(write_tiff(img))
