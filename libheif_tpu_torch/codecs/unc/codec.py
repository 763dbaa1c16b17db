"""ISO 23001-17 uncompressed codec: decode and encode orchestration on
torch.

Counterpart of libheif_tpu/codecs/unc/codec.py (reference:
libheif/codecs/uncompressed/unc_codec.{h,cc} — decode_uncompressed_image
unc_codec.h:52, decode_uncompressed_image_tile unc_codec.h:56) plus the
generic-compression handling (cmpC/icef, unc_decoder.cc:200-282), and its
encoder (``_compress`` :67, ``UnciEncoder`` :242-348).

Host side: layout computation, zlib/deflate/brotli (de)compression, tile buffer
assembly (skipped on CUDA for the byte-aligned layouts, whose strided
kernel reads the payload in place).  Device side: the extraction in
kernels.py, and on the encode side the packing of each tile's samples
(``pack_samples``), which the host receives in one copy a tile.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..._build import resolve_device
from ...core.error import HeifError, SubError
from ...core.limits import SecurityLimits
from ...boxes.unc import (
    Box_uncC, Box_cmpd, Box_cmpC, Box_icef, CmpdComponent, CompressedUnitInfo,
    CompressedUnitType, InterleaveMode, SamplingMode, UncCComponent,
)
from ...image.pixel_image import (
    PixelImage, Channel, Colorspace, Chroma, subsampled_size,
)
from .layout import compute_layout, UncLayout
from . import cuda_fast, kernels


def _brotli():
    """The brotli module, looked up at each call: ``brotli``, else
    ``brotlicffi``, else None (JAX codec.py:31-40).  The unci codec and
    the XMP compression of api/metadata.py both ask here."""
    try:
        import brotli  # type: ignore
    except ImportError:
        try:
            import brotlicffi as brotli  # type: ignore
        except ImportError:
            brotli = None
    return brotli


def _no_brotli() -> HeifError:
    return HeifError.unsupported(
        SubError.Unsupported_generic_compression_method,
        "brotli not available in this build")


def _decompress(method: str, data: bytes) -> bytes:
    """(ref: compression.h:59-114 — zlib/deflate/brotli)."""
    try:
        if method == "zlib":
            return zlib.decompress(data)
        if method == "defl":
            return zlib.decompress(data, -15)
        if method == "brot":
            brotli = _brotli()
            if brotli is None:
                raise _no_brotli()
            return brotli.decompress(data)
    except HeifError:
        raise
    except Exception as e:
        raise HeifError.invalid_input(
            SubError.Decompression_invalid_data,
            f"corrupt {method} stream: {e}") from e
    raise HeifError.unsupported(
        SubError.Unsupported_generic_compression_method,
        f"generic compression method {method!r}")


def _compress(method: str, data: bytes) -> bytes:
    """(ref: compression.h — zlib/deflate/brotli)."""
    if method == "zlib":
        return zlib.compress(data)
    if method == "defl":
        co = zlib.compressobj(wbits=-15)
        return co.compress(data) + co.flush()
    if method == "brot":
        brotli = _brotli()
        if brotli is None:
            raise _no_brotli()
        return brotli.compress(data)
    raise HeifError.unsupported(
        SubError.Unsupported_generic_compression_method,
        f"generic compression method {method!r}")


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



# --------------------------------------------------------------------------
# Encoder
# --------------------------------------------------------------------------

_CHANNEL_TO_COMPONENT_TYPE = {
    Channel.Y: 1, Channel.Cb: 2, Channel.Cr: 3,
    Channel.R: 4, Channel.G: 5, Channel.B: 6,
    Channel.Alpha: 7, Channel.Depth: 8, Channel.Disparity: 9,
    Channel.FilterArray: 11,
}
_MONO_COMPONENT_TYPE = 0


def pack_samples(plane: torch.Tensor, depth: int) -> torch.Tensor:
    """A plane's samples as a flat uint8 tensor on its device, row after
    row: one byte a sample (the low byte) to 8 bits, else a big-endian
    16-bit word (the low 16 bits), as the JAX package's ``astype(np.uint8)``
    and ``astype(">u2")`` write them."""
    if depth <= 8 and plane.dtype == torch.uint8:
        return plane.reshape(-1)
    v = plane.to(torch.int32)
    if depth <= 8:
        return (v & 0xFF).to(torch.uint8).reshape(-1)
    return torch.stack(((v >> 8) & 0xFF, v & 0xFF), dim=-1) \
        .to(torch.uint8).reshape(-1)


class UnciEncoder:
    """unci encoder: component-interleave output
    (ref: unc_encoder_component_interleave.cc; encode path
    unc_image.cc:312 tile-wise append).

    Produces cmpd/uncC property boxes plus the raw sample stream.
    Supports 8/16-bit planes, mono/RGB(A)/YCbCr 444/422/420, tiling,
    and optional generic compression.  Each tile's samples are packed on
    the device its planes lie on and copied to the host once.  A plane of
    10 to 14 bits is written as 16-bit words under a ``uncC`` that declares
    its bit depth, as the JAX package writes it (a reader of the standard
    expects packed samples there; ROADMAP §3 D), so that the two packages'
    files stay equal byte for byte.
    """

    def __init__(self, tile_cols: int = 1, tile_rows: int = 1,
                 compression: Optional[str] = None,
                 compress_per_tile: bool = False):
        self.tile_cols = tile_cols
        self.tile_rows = tile_rows
        self.compression = compression
        self.compress_per_tile = compress_per_tile

    def _channel_order(self, img: PixelImage) -> List[str]:
        if img.colorspace == Colorspace.RGB:
            order = [Channel.R, Channel.G, Channel.B]
        elif img.colorspace == Colorspace.YCbCr:
            order = [Channel.Y, Channel.Cb, Channel.Cr]
        elif img.colorspace == Colorspace.Monochrome:
            order = [Channel.Y]
        else:
            order = [c for c in img.channels() if c != Channel.Alpha]
        if img.has_channel(Channel.Alpha):
            order.append(Channel.Alpha)
        return [c for c in order if img.has_channel(c)]

    def make_boxes(self, img: PixelImage):
        """Build (cmpd, uncC) for the image."""
        order = self._channel_order(img)
        cmpd = Box_cmpd()
        uncC = Box_uncC()
        for ch in order:
            if img.colorspace == Colorspace.Monochrome and ch == Channel.Y:
                ctype = _MONO_COMPONENT_TYPE
            else:
                ctype = _CHANNEL_TO_COMPONENT_TYPE[ch]
            cmpd.components.append(CmpdComponent(ctype))
            depth = img.bit_depth(ch)
            uncC.components.append(
                UncCComponent(len(cmpd.components) - 1, depth, 0, 0))
        if img.chroma == Chroma.C422:
            uncC.sampling_type = SamplingMode.s422
        elif img.chroma == Chroma.C420:
            uncC.sampling_type = SamplingMode.s420
        uncC.interleave_type = InterleaveMode.component
        uncC.num_tile_cols = self.tile_cols
        uncC.num_tile_rows = self.tile_rows
        return cmpd, uncC

    def encode_tile(self, img: PixelImage) -> bytes:
        """Serialize one tile's planes in component-interleave order,
        big-endian samples, rows byte-aligned: packed on the planes'
        device, then one copy to the host."""
        return torch.cat([pack_samples(img.plane(ch), img.bit_depth(ch))
                          for ch in self._channel_order(img)]) \
            .cpu().numpy().tobytes()

    def encode(self, img: PixelImage):
        """Encode a full (possibly tiled) image.

        Returns (data, cmpd, uncC, cmpC, icef) — compression boxes are
        None when no generic compression is requested.
        """
        cmpd, uncC = self.make_boxes(img)
        tw = img.width // self.tile_cols
        th = img.height // self.tile_rows
        if tw * self.tile_cols != img.width or th * self.tile_rows != img.height:
            raise HeifError.usage(SubError.Invalid_parameter_value,
                                  "image size not divisible by tile grid")
        tiles = []
        for ty in range(self.tile_rows):
            for tx in range(self.tile_cols):
                tile_img = img.crop(tx * tw, ty * th, tw, th)
                tiles.append(self.encode_tile(tile_img))

        cmpC = icef = None
        if self.compression:
            cmpC = Box_cmpC()
            cmpC.compression_type = self.compression
            if self.compress_per_tile and len(tiles) > 1:
                cmpC.compressed_unit_type = CompressedUnitType.tile
                icef = Box_icef()
                comp_tiles = [_compress(self.compression, t) for t in tiles]
                off = 0
                for c in comp_tiles:
                    icef.unit_infos.append(CompressedUnitInfo(off, len(c)))
                    off += len(c)
                data = b"".join(comp_tiles)
            else:
                cmpC.compressed_unit_type = CompressedUnitType.whole_image
                data = _compress(self.compression, b"".join(tiles))
        else:
            data = b"".join(tiles)
        return data, cmpd, uncC, cmpC, icef
