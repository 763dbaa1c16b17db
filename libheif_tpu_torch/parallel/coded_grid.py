"""Batched decode of HEVC grid tiles.

Counterpart of libheif_tpu/parallel/coded_grid.py:34-61, 202-276, the
replacement for the reference's per-tile thread pool (reference:
libheif/image-items/grid.cc:285-453 std::async fan-out):

  1. the entropy decode of every tile runs on the host in a thread pool
     (the C++ parser releases the GIL), giving flat TU arrays;
  2. the tiles reconstruct on the device in batches, one batch for each
     group of tiles that agree on ``device_recon.batch_key`` (the tiles of
     a camera's grid all do): one plan, one launch of stage A and one of
     stage B for the whole batch;
  3. each tile's cropped planes are pasted into the output planes on
     the device.

The JAX package's mesh sharding of the tile batch (decode_tiles_device)
is not ported yet.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..boxes.meta import Box_clap, Box_imir, Box_irot, Box_ispe
from ..codecs.hevc.decoder import (check_size, extract_stream,
                                   parse_picture, planes_to_image)
from ..codecs.hevc.device_recon import (BatchMismatch, batch_key,
                                        decode_pictures_device)
from ..core.error import HeifError
from ..image.pixel_image import PixelImage, Colorspace, Chroma
from ..items.codec_items import ImageItem_HEVC


def parse_tile(config_box, data: bytes, declared_size=None, limits=None):
    """Host entropy decode of one hvc1 tile → (sps, syntax, raw TUs)."""
    sps, pps, slices = extract_stream(config_box, data)
    check_size(sps, declared_size, limits)
    syn, raw = parse_picture(sps, pps, slices)
    return sps, syn, raw


def parse_tiles(jobs: Sequence[Tuple], max_workers: Optional[int] = None):
    """parse_tile over many tiles on a thread pool."""
    n = len(jobs)
    workers = max_workers or min(8, os.cpu_count() or 1, max(1, n))
    if workers <= 1 or n <= 1:
        return [parse_tile(*j) for j in jobs]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda j: parse_tile(*j), jobs))


def try_batched_hevc_grid(grid_item, grid, tile_ids,
                          options) -> Optional[PixelImage]:
    """Batched decode of an all-hvc1 grid, composed on the context's
    device.  Returns None where the batch does not apply (other item
    types, per-tile transforms or alpha, streams the port refuses, tiles
    of different size or depth): the caller then decodes tile by tile.
    Tiles that differ in another field a plan takes batch-wide (CTB size,
    strong smoothing) decode as separate batches."""
    ctx = grid_item.ctx
    try:
        tiles = [ctx.get_item(tid) for tid in tile_ids]
        if not all(isinstance(t, ImageItem_HEVC) for t in tiles):
            return None
        for t in tiles:
            if t.init_error is not None or t.alpha_item is not None:
                return None
            if any(isinstance(p, (Box_irot, Box_imir, Box_clap))
                   for p in t.properties()):
                return None
        if options.cancel is not None and options.cancel():
            return None
        jobs = []
        for t in tiles:
            ispe = t.get_property(Box_ispe)
            jobs.append((t.config_box(), t.coded_data(),
                         (ispe.width, ispe.height) if ispe else None,
                         ctx.limits))
        parsed = parse_tiles(jobs)
    except HeifError:
        return None

    sps0 = parsed[0][0]
    if any((p[0].cropped_size, p[0].bit_depth_luma) !=
           (sps0.cropped_size, sps0.bit_depth_luma) for p in parsed):
        return None
    # one batch per group of tiles that agree on what a plan takes
    # batch-wide (a phone photo's tiles make one group)
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(parsed):
        groups.setdefault(batch_key(p[0]), []).append(i)
    planes: List = [None] * len(parsed)
    for idx in groups.values():
        try:
            out = decode_pictures_device([parsed[i][1] for i in idx],
                                         [parsed[i][2] for i in idx],
                                         ctx.device)
        except BatchMismatch:
            return None
        for i, pl in zip(idx, out):
            planes[i] = pl
    return compose(grid, [p[0] for p in parsed], planes, ctx, options)


def compose(grid, spss, planes, ctx, options) -> PixelImage:
    """Paste each tile's cropped planes into the grid's output planes on
    the context's device, in grid order."""
    tw, th = spss[0].cropped_size
    out = PixelImage(grid.output_width, grid.output_height,
                     Colorspace.YCbCr, Chroma.C420, ctx.limits)
    n_total = len(spss)
    for idx, (sps, pl) in enumerate(zip(spss, planes)):
        tile = planes_to_image(sps, *pl)
        if not out.planes:
            for ch in tile.channels():
                out.add_plane(ch, tile.bit_depth(ch), device=ctx.device)
        ty, tx = divmod(idx, grid.columns)
        out.copy_into(tile, tx * tw, ty * th)
        if options.on_progress is not None:
            options.on_progress(idx + 1, n_total)
    return out
