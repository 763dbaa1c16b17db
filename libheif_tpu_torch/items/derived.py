"""Derived image items: grid, overlay, identity.

Counterpart of libheif_tpu/items/derived.py (reference:
libheif/image-items/grid.{h,cc} — ImageGrid grid.h:31, ImageItem_Grid
grid.h:77, parallel tile decode grid.cc:285-453; overlay.{h,cc} —
ImageOverlay overlay.cc:76; iden.{h,cc} iden.h:31).

A grid of hvc1 tiles, of av01 tiles or of jpeg tiles decodes as one
batch (parallel/coded_grid: one plan and one pass of the reconstruction
for every tile), as the JAX package's device grid path does for the
first two, on every device; an hvc1 or av01 grid takes its batch unless
``LIBHEIF_TPU_HEVC_ENGINE`` / ``LIBHEIF_TPU_AV1_ENGINE`` names a host
engine and ``DecodingOptions.prefer_device_grid`` is false (the port's
default engine is the device's; JAX derived.py:134-151 batches only
where asked).  Any other grid, and a grid the batch does not take,
decodes its tiles on a pool of ``max_decoding_threads`` threads on every
device, as the JAX package does (:152-179), and pastes them in grid
order with ``PixelImage.copy_into`` into zeroed planes on the context's
device.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

import torch

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, ErrorCode, SubError
from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..codecs.unc import cuda_fast
from ..color import convert_image
from ..codecs.engines import av1_engine, hevc_engine
from ..parallel.coded_grid import (try_batched_av1_grid,
                                  try_batched_hevc_grid,
                                  try_batched_jpeg_grid)
from .item import ImageItem, ImageTiling, register_item, DecodingOptions


@dataclass
class ImageGrid:
    """Grid payload (ref: ImageGrid::parse grid.cc:30)."""

    rows: int = 1
    columns: int = 1
    output_width: int = 0
    output_height: int = 0

    @staticmethod
    def parse(data: bytes) -> "ImageGrid":
        if len(data) < 8:
            raise HeifError.invalid_input(SubError.Invalid_grid_data,
                                          "less than 8 bytes of grid data")
        version = data[0]
        if version != 0:
            raise HeifError.unsupported(SubError.Unsupported_data_version,
                                        f"grid version {version}")
        flags = data[1]
        g = ImageGrid(rows=data[2] + 1, columns=data[3] + 1)
        r = ByteReader(data, 4)
        if flags & 1:
            if len(data) < 12:
                raise HeifError.invalid_input(SubError.Invalid_grid_data,
                                              "grid data incomplete")
            g.output_width = r.read32()
            g.output_height = r.read32()
        else:
            g.output_width = r.read16()
            g.output_height = r.read16()
        return g

    def write(self) -> bytes:
        w = ByteWriter()
        long_fields = self.output_width > 0xFFFF or self.output_height > 0xFFFF
        w.write8(0)
        w.write8(1 if long_fields else 0)
        w.write8(self.rows - 1)
        w.write8(self.columns - 1)
        if long_fields:
            w.write32(self.output_width)
            w.write32(self.output_height)
        else:
            w.write16(self.output_width)
            w.write16(self.output_height)
        return w.data()


@register_item("grid")
class ImageItem_Grid(ImageItem):
    """(ref: ImageItem_Grid grid.h:77)."""

    def grid_spec(self) -> ImageGrid:
        return ImageGrid.parse(self.file.get_item_data(self.item_id))

    def tile_item_ids(self) -> List[int]:
        refs = self.file.get_references_from(self.item_id, "dimg")
        if not refs:
            raise HeifError.invalid_input(SubError.Missing_grid_images,
                                          "grid has no dimg references")
        return refs[0].to_item_ids

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        """(ref: decode_full_grid_image grid.cc:285)."""
        grid = self.grid_spec()
        tile_ids = self.tile_item_ids()
        if len(tile_ids) != grid.rows * grid.columns:
            raise HeifError.invalid_input(
                SubError.Invalid_grid_data,
                f"grid needs {grid.rows * grid.columns} tiles, has "
                f"{len(tile_ids)}")
        self.ctx.limits.check_image_size(grid.output_width, grid.output_height)
        self.ctx.limits.check_tile_count(grid.columns, grid.rows)

        batched = None
        device_grid = options.prefer_device_grid
        if device_grid or hevc_engine() == "device":
            batched = try_batched_hevc_grid(self, grid, tile_ids, options)
        if batched is None and (device_grid or av1_engine() == "device"):
            batched = try_batched_av1_grid(self, grid, tile_ids, options)
        if batched is None:
            batched = try_batched_jpeg_grid(self, grid, tile_ids, options)
        if batched is not None:
            return batched

        n_total = len(tile_ids)
        items = []
        for tid in tile_ids:
            try:
                items.append(self.ctx.get_item(tid))
            except HeifError as e:
                if options.strict_decoding:
                    raise
                items.append(e)

        def _decode_one(it):
            if isinstance(it, HeifError):
                return it
            if options.cancel is not None and options.cancel():
                return HeifError(ErrorCode.Canceled)
            try:
                return it.decode_image(options, processed_ids)
            except HeifError as e:
                return e

        n_threads = options.max_decoding_threads
        if n_threads is None:
            n_threads = self.ctx.max_decoding_threads or 1
        n_threads = max(1, min(n_threads, os.cpu_count() or 1, n_total))
        if n_threads > 1:
            with ThreadPoolExecutor(max_workers=n_threads) as ex:
                results = list(ex.map(_decode_one, items))
        else:
            results = [_decode_one(it) for it in items]
        if options.cancel is not None and options.cancel():
            raise HeifError(ErrorCode.Canceled)

        out: Optional[PixelImage] = None
        tile_w = tile_h = 0
        for idx, tile_img in enumerate(results):
            ty, tx = divmod(idx, grid.columns)
            if isinstance(tile_img, HeifError):
                # non-strict mode: skip missing tiles with a warning
                # (ref: grid.cc:323-348)
                if options.strict_decoding or out is None:
                    raise tile_img
                out.add_warning(tile_img)
                continue
            if out is None:
                tile_w, tile_h = tile_img.width, tile_img.height
                out = PixelImage(grid.output_width, grid.output_height,
                                 tile_img.colorspace, tile_img.chroma,
                                 self.ctx.limits)
                for ch in tile_img.channels():
                    out.add_plane(ch, bit_depth=tile_img.bit_depth(ch),
                                  device=self.ctx.device)
            out.copy_into(tile_img, tx * tile_w, ty * tile_h)
            if options.on_progress is not None:
                options.on_progress(idx + 1, n_total)
        if out is None:
            raise HeifError.invalid_input(SubError.Missing_grid_images,
                                          "no grid tile could be decoded")
        return out

    def get_tiling(self) -> ImageTiling:
        grid = self.grid_spec()
        tile_ids = self.tile_item_ids()
        tw = th = 0
        if tile_ids:
            sz = self.ctx.get_item(tile_ids[0]).ispe_size
            if sz:
                tw, th = sz
        return ImageTiling(num_columns=grid.columns, num_rows=grid.rows,
                           tile_width=tw, tile_height=th,
                           image_width=grid.output_width,
                           image_height=grid.output_height)

    def decode_tile(self, tile_x: int, tile_y: int,
                    options: Optional[DecodingOptions] = None) -> PixelImage:
        """Single referenced tile decode (ref: context.cc:1425
        decode_only_tile path)."""
        grid = self.grid_spec()
        tile_ids = self.tile_item_ids()
        if tile_x >= grid.columns or tile_y >= grid.rows:
            raise HeifError.usage(SubError.Invalid_parameter_value,
                                  "tile coordinates out of range")
        tid = tile_ids[tile_y * grid.columns + tile_x]
        return self.ctx.get_item(tid).decode_image(options)


@dataclass
class ImageOverlay:
    """Overlay payload (ref: ImageOverlay::parse overlay.cc:76)."""

    version: int = 0
    background_rgba: Tuple[int, int, int, int] = (0, 0, 0, 0)  # 16-bit each
    width: int = 0
    height: int = 0
    offsets: List[Tuple[int, int]] = field(default_factory=list)

    @staticmethod
    def parse(num_images: int, data: bytes) -> "ImageOverlay":
        if len(data) < 2 + 4 * 2:
            raise HeifError.invalid_input(SubError.Invalid_overlay_data,
                                          "overlay data incomplete")
        version = data[0]
        if version != 0:
            raise HeifError.unsupported(SubError.Unsupported_data_version,
                                        f"overlay version {version}")
        flags = data[1]
        field_len = 4 if (flags & 1) else 2
        need = 2 + 4 * 2 + 2 * field_len + num_images * 2 * field_len
        if len(data) < need:
            raise HeifError.invalid_input(SubError.Invalid_overlay_data,
                                          "overlay data incomplete")
        r = ByteReader(data, 2)
        bg = tuple(r.read16() for _ in range(4))
        if field_len == 4:
            w, h = r.read32(), r.read32()
        else:
            w, h = r.read16(), r.read16()
        if w == 0 or h == 0:
            raise HeifError.invalid_input(SubError.Invalid_overlay_data,
                                          "overlay with zero size")
        ov = ImageOverlay(version, bg, w, h)
        for _ in range(num_images):
            if field_len == 4:
                ov.offsets.append((r.read32s(), r.read32s()))
            else:
                ov.offsets.append((r.read16s(), r.read16s()))
        return ov

    def write(self) -> bytes:
        long_fields = (self.width > 0xFFFF or self.height > 0xFFFF or
                       any(not (-32768 <= v <= 0x7FFF)
                           for off in self.offsets for v in off))
        w = ByteWriter()
        w.write8(0)
        w.write8(1 if long_fields else 0)
        for c in self.background_rgba:
            w.write16(c)
        if long_fields:
            w.write32(self.width)
            w.write32(self.height)
        else:
            w.write16(self.width)
            w.write16(self.height)
        for x, y in self.offsets:
            if long_fields:
                w.write32s(x)
                w.write32s(y)
            else:
                w.write16s(x)
                w.write16s(y)
        return w.data()


@register_item("iovl")
class ImageItem_Overlay(ImageItem):
    """(ref: ImageItem_Overlay overlay.h:87)."""

    def overlay_spec(self):
        refs = self.file.get_references_from(self.item_id, "dimg")
        if not refs:
            raise HeifError.invalid_input(SubError.Invalid_overlay_data,
                                          "overlay has no dimg references")
        ids = refs[0].to_item_ids
        ov = ImageOverlay.parse(len(ids), self.file.get_item_data(self.item_id))
        return ov, ids

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        """Overlay composition with background color and alpha blending
        (ref: ImageItem_Overlay::render_overlay, overlay.cc), on the
        context's device.  The blend is the JAX package's numpy f32
        arithmetic op by op (two products and a sum, never fused into a
        multiply-add; an IEEE division; round half to even)."""
        ov, ids = self.overlay_spec()
        self.ctx.limits.check_image_size(ov.width, ov.height)
        dev = self.ctx.device

        # background canvas in RGB(16-bit colors scaled to 8)
        bg = [c >> 8 for c in ov.background_rgba]
        out = PixelImage(ov.width, ov.height, Colorspace.RGB, Chroma.C444,
                         self.ctx.limits)
        canvas = {
            ch: torch.full((ov.height, ov.width), v, dtype=torch.uint8,
                           device=dev)
            for ch, v in zip((Channel.R, Channel.G, Channel.B), bg)}

        for (dx, dy), tid in zip(ov.offsets, ids):
            img = self.ctx.get_item(tid).decode_image(options, processed_ids)
            img = convert_image(img, Colorspace.RGB, Chroma.C444, device=dev)
            iw, ih = img.width, img.height
            # clip to canvas (ref: overlay clipping; images may extend
            # outside the canvas)
            x0, y0 = max(dx, 0), max(dy, 0)
            x1, y1 = min(dx + iw, ov.width), min(dy + ih, ov.height)
            if x0 >= x1 or y0 >= y1:
                continue
            sx0, sy0 = x0 - dx, y0 - dy
            rows = slice(sy0, sy0 + (y1 - y0))
            cols = slice(sx0, sx0 + (x1 - x0))
            alpha = None
            if img.has_channel(Channel.Alpha):
                a = img.plane(Channel.Alpha).to(torch.float32)
                alpha = cuda_fast.true_div(
                    a, float((1 << img.bit_depth(Channel.Alpha)) - 1)
                )[rows, cols]
            for ch in (Channel.R, Channel.G, Channel.B):
                src = img.plane(ch)[rows, cols]
                dst = canvas[ch][y0:y1, x0:x1]
                if alpha is None:
                    dst.copy_(src)
                else:
                    blended = src.to(torch.float32) * alpha + \
                        dst.to(torch.float32) * (1 - alpha)
                    dst.copy_(torch.clamp(torch.round(blended), 0, 255)
                              .to(torch.uint8))
        for ch, arr in canvas.items():
            out.set_plane(ch, arr, 8)
        return out


@register_item("iden")
class ImageItem_iden(ImageItem):
    """Identity derivation (ref: iden.{h,cc} iden.h:31): decodes the
    referenced item; own transform properties then apply on top."""

    def decode_compressed_image(self, options: DecodingOptions,
                                processed_ids: Set[int]) -> PixelImage:
        refs = self.file.get_references_from(self.item_id, "dimg")
        if not refs or len(refs[0].to_item_ids) != 1:
            raise HeifError.invalid_input(
                msg="'iden' item must reference exactly one image")
        src = self.ctx.get_item(refs[0].to_item_ids[0])
        # decode referenced image including its own transforms, then this
        # item's transforms apply in decode_image()
        return src.decode_image(options, processed_ids)
