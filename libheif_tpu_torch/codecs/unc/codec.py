"""ISO 23001-17 uncompressed codec: decode orchestration on torch.

Counterpart of libheif_tpu/codecs/unc/codec.py (reference:
libheif/codecs/uncompressed/unc_codec.{h,cc} — decode_uncompressed_image
unc_codec.h:52, decode_uncompressed_image_tile unc_codec.h:56) plus the
generic-compression handling (cmpC/icef, unc_decoder.cc:200-282).

Host side: layout computation, zlib/deflate decompression, tile buffer
assembly (skipped on CUDA for the byte-aligned layouts, whose strided
kernel reads the payload in place).  Device side: the extraction in
kernels.py.  Encoding stays with the JAX package for now.
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional

import numpy as np
import torch

from ..._build import resolve_device
from ...core.error import HeifError, SubError
from ...core.limits import SecurityLimits
from ...boxes.unc import (
    Box_uncC, Box_cmpd, Box_cmpC, Box_icef, CmpdComponent, CompressedUnitType,
)
from ...image.pixel_image import PixelImage, subsampled_size
from .layout import compute_layout, UncLayout
from . import cuda_fast, kernels


def _decompress(method: str, data: bytes) -> bytes:
    """(ref: compression.h:59-114 — zlib/deflate; brotli is not part of
    this package yet)."""
    if method not in ("zlib", "defl"):
        raise HeifError.unsupported(
            SubError.Unsupported_generic_compression_method,
            f"generic compression method {method!r}")
    try:
        return zlib.decompress(data) if method == "zlib" \
            else zlib.decompress(data, -15)
    except zlib.error as e:
        raise HeifError.invalid_input(
            SubError.Decompression_invalid_data,
            f"corrupt {method} stream: {e}") from e


class UnciDecoder:
    """Decoder for one unci item; its planes land on ``device``
    (``None`` means CUDA; pass ``device="cpu"`` for the CPU)."""

    def __init__(self, uncC: Box_uncC, cmpd: Optional[Box_cmpd],
                 width: int, height: int,
                 cmpC: Optional[Box_cmpC] = None,
                 icef: Optional[Box_icef] = None,
                 limits: Optional[SecurityLimits] = None,
                 device=None):
        self.device = resolve_device(device)
        if uncC is None:
            raise HeifError.invalid_input(msg="missing uncC box")
        if cmpd is None and uncC.version == 0:
            raise HeifError.invalid_input(msg="missing cmpd box")
        if cmpd is None:
            # v1 profiles imply a standard cmpd (ref: unc_boxes.cc v1 expansion)
            cmpd = _implied_cmpd_for_profile(uncC)
        self.uncC = uncC
        self.cmpd = cmpd
        self.cmpC = cmpC
        self.icef = icef
        self.limits = limits or SecurityLimits()
        self.limits.check_image_size(width, height)
        self.layout = compute_layout(uncC, cmpd, width, height)
        self.limits.check_tile_count(self.layout.tile_cols, self.layout.tile_rows)

    # ------------------------------------------------------------- decompress

    def _uncompressed_payload(self, data: memoryview):
        """Resolve generic compression to the raw sample buffer."""
        if self.cmpC is None:
            return data
        method = self.cmpC.compression_type
        if self.icef is not None and self.icef.unit_infos:
            parts = []
            for u in self.icef.unit_infos:
                if u.unit_offset + u.unit_size > len(data):
                    raise HeifError.eof("icef unit beyond compressed data")
                parts.append(_decompress(
                    method, data[u.unit_offset:u.unit_offset + u.unit_size]))
            return b"".join(parts)
        return _decompress(method, data)

    # ----------------------------------------------------------------- decode

    def decode(self, data) -> PixelImage:
        """Decode the full image (all tiles batched on the device).
        ``data`` is bytes-like (bytes, or a memoryview of the file
        buffer) and is read in place, not copied on the host."""
        payload = self._uncompressed_payload(memoryview(data))
        if self.device.type == "cuda" and \
                cuda_fast._strided_gate(self.layout):
            # the strided kernel reads the payload in place, at pitch S
            planes = cuda_fast.fused_strided_decode(
                self.layout,
                kernels.payload_tiles(self.layout, payload, self.device))
        else:
            tiles = kernels.assemble_tile_buffers(self.layout, payload)
            planes = kernels.decode_tiles(self.layout, tiles, self.device)
        return self._to_image(planes, self.layout.width, self.layout.height)

    def decode_tile(self, data, tile_x: int, tile_y: int) -> PixelImage:
        """Random-access decode of a single tile
        (ref: decode_uncompressed_image_tile unc_codec.h:56 +
        tile stride computation unc_decoder_component_interleave.cc:28)."""
        lay = self.layout
        if tile_x >= lay.tile_cols or tile_y >= lay.tile_rows:
            raise HeifError.usage(SubError.Invalid_parameter_value,
                                  f"tile ({tile_x},{tile_y}) out of range")
        idx = tile_y * lay.tile_cols + tile_x
        buf = self._fetch_tile_payload(data, idx)
        tiles = np.zeros((1, buf.shape[0] + kernels._GATHER_PAD), dtype=np.uint8)
        tiles[0, :buf.shape[0]] = buf
        single = UncLayout(
            width=lay.tile_width, height=lay.tile_height,
            tile_cols=1, tile_rows=1,
            tile_width=lay.tile_width, tile_height=lay.tile_height,
            views=lay.views, tile_size_bytes=lay.tile_size_bytes,
            comp_tile_sizes=lay.comp_tile_sizes,
            colorspace=lay.colorspace, chroma=lay.chroma,
            interleave=lay.interleave)
        planes = kernels.decode_tiles(single, tiles, self.device)
        return self._to_image(planes, lay.tile_width, lay.tile_height)

    def _fetch_tile_payload(self, data, idx: int) -> np.ndarray:
        """``data``: bytes-like, or a lazy view (file/heif_file.py
        ItemDataView) that reads each slice from the file; only this
        tile's byte ranges are read (ref: tile stride computation
        unc_decoder_component_interleave.cc:28)."""
        lay = self.layout
        if self.cmpC is not None:
            unit_type = self.cmpC.compressed_unit_type
            if unit_type == CompressedUnitType.tile and self.icef is not None:
                u = self.icef.unit_infos[idx]
                part = _decompress(self.cmpC.compression_type,
                                   data[u.unit_offset:u.unit_offset + u.unit_size])
                return np.frombuffer(part, dtype=np.uint8)
            # otherwise decompress everything, then slice
            data = self._uncompressed_payload(data[:])

        if lay.comp_tile_sizes is not None:
            parts = []
            comp_base = 0
            for sz in lay.comp_tile_sizes:
                start = comp_base + sz * idx
                parts.append(np.frombuffer(data[start:start + sz], np.uint8))
                comp_base += sz * lay.num_tiles
            return np.concatenate(parts)
        S = lay.tile_size_bytes
        if (idx + 1) * S > len(data):
            raise HeifError.eof("unci tile data out of range")
        return np.frombuffer(data[idx * S:(idx + 1) * S], np.uint8)

    def _to_image(self, planes: Dict[str, torch.Tensor], width: int,
                  height: int) -> PixelImage:
        img = PixelImage(width, height, self.layout.colorspace,
                         self.layout.chroma, self.limits)
        for ch, arr in planes.items():
            depth = max(v.depth for v in self.layout.views
                        if v.channel == ch)
            # clip plane to the subsampled image size (tile grids can
            # overhang for non-divisible chroma at image edges)
            pw, ph = subsampled_size(width, height, ch, self.layout.chroma)
            img.set_plane(ch, arr[:ph, :pw], depth)
        return img


def _implied_cmpd_for_profile(uncC: Box_uncC) -> Box_cmpd:
    from ...core.fourcc import fourcc_to_str
    prof = fourcc_to_str(uncC.profile)
    if prof in ("rgb3",):
        types = [4, 5, 6]
    elif prof in ("rgba",):
        types = [4, 5, 6, 7]
    elif prof in ("abgr",):
        types = [7, 6, 5, 4]
    else:
        types = [1, 2, 3]  # YCbCr family
    return Box_cmpd([CmpdComponent(t) for t in types])
