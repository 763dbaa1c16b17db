"""Batched decode of HEVC, AV1 and JPEG grid tiles.

Counterpart of libheif_tpu/parallel/coded_grid.py:34-61, 202-360, the
replacement for the reference's per-tile thread pool (reference:
libheif/image-items/grid.cc:285-453 std::async fan-out):

  1. the entropy decode of every tile runs on the host: HEVC and JPEG in
     a thread pool (the C++ parser and scan release the GIL), giving flat
     TU arrays and coefficient blocks; AV1 tile after tile (the Python
     parse holds the GIL), giving each tile's deferred reconstruction
     jobs;
  2. the tiles reconstruct on the device in batches, one batch for each
     group of tiles that agree on their codec's ``device_recon.batch_key``
     (the tiles of a camera's grid all do): one plan, one launch of stage
     A and one of stage B for the whole batch; AV1's in-loop filters then
     run tile by tile on the device; JPEG tiles reconstruct in one launch
     of jpeg_dequant_idct, straight into the output planes;
  3. each HEVC or AV1 tile's cropped planes are pasted into the output
     planes on the device, keeping the tiles' bit depth and chroma.

The JAX package's batched AV1 path writes 8-bit 4:2:0 output whatever
the tiles are (coded_grid.py:331-356); this one is held to the JAX
tile-by-tile decode instead.

With ``DecodingOptions.mesh`` an HEVC grid's tiles split over the mesh's
members in contiguous chunks (decode_tiles_device, JAX :145-199): each
member plans and reconstructs its chunk on its own device, and the
composed planes are gathered on the context's device.  JAX pads the
batch and unifies the chunks' plans so that one shard_map program
serves every device; here each member launches its own plan, so
neither is needed.  AV1 and JPEG grids keep their single batch, as in
the JAX package.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from ..boxes.meta import Box_clap, Box_imir, Box_irot, Box_ispe
from ..codecs import registry
from ..codecs.av1 import decoder as av1_decoder
from ..codecs.av1 import device_recon as av1_recon
from ..codecs.jpeg import decoder as jpeg_decoder
from ..codecs.hevc.decoder import (check_size, extract_stream,
                                   parse_picture, planes_to_image)
from ..codecs.hevc.device_recon import (BatchMismatch, batch_key,
                                        decode_pictures_device)
from ..core.error import HeifError
from ..core.trace import span
from ..image.pixel_image import PixelImage
from ..items.codec_items import ImageItem_AVIF, ImageItem_HEVC, \
    ImageItem_JPEG
from .mesh import DeviceMesh, chunk_bounds


def parse_tile(config_box, data: bytes, declared_size=None, limits=None):
    """Host entropy decode of one hvc1 tile → (sps, syntax, raw TUs)."""
    sps, pps, slices = extract_stream(config_box, data)
    check_size(sps, declared_size, limits)
    syn, raw = parse_picture(sps, pps, slices)
    return sps, syn, raw


def parse_tiles(jobs: Sequence[Tuple], max_workers: Optional[int] = None,
                parse=parse_tile):
    """``parse`` (parse_tile by default) over many tiles on a thread
    pool."""
    n = len(jobs)
    workers = max_workers or min(8, os.cpu_count() or 1, max(1, n))
    if workers <= 1 or n <= 1:
        return [parse(*j) for j in jobs]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda j: parse(*j), jobs))


def decode_tiles_device(syntaxes, raw_tus, mesh: Optional[DeviceMesh] = None,
                        device=None) -> List[Tuple]:
    """Device reconstruction of parsed hvc1 tiles: the uncropped (Y, Cb,
    Cr) int32 planes of each tile, in order.  Without a mesh the tiles
    decode on ``device`` (None means CUDA); with one, member k of the
    ``mesh.size`` members takes the k-th contiguous chunk of ceil(T /
    size) tiles (fewer or none at the end) and decodes it on its device,
    where its tiles' planes stay.  Each device decodes its tiles as one
    batch per group that agrees on ``batch_key``; a plan that still
    mixes keys raises BatchMismatch."""
    t = len(syntaxes)
    if mesh is None:
        work = [(device, (0, t))]
    else:
        work = list(zip(mesh.members(), chunk_bounds(t, mesh.size)))
    planes: List = [None] * t
    for dev, (lo, hi) in work:
        groups: Dict[tuple, List[int]] = {}
        for i in range(lo, hi):
            groups.setdefault(batch_key(syntaxes[i].sps), []).append(i)
        for idx in groups.values():
            out = decode_pictures_device([syntaxes[i] for i in idx],
                                         [raw_tus[i] for i in idx], dev)
            for i, pl in zip(idx, out):
                planes[i] = pl
    return planes


def try_batched_hevc_grid(grid_item, grid, tile_ids,
                          options) -> Optional[PixelImage]:
    """Batched decode of an all-hvc1 grid, composed on the context's
    device.  Returns None where the batch does not apply (other item
    types, a ``decoder_id`` that does not select the built-in decoder,
    per-tile transforms or alpha, streams the port refuses, tiles
    of different size or depth): the caller then decodes tile by tile.
    Tiles that differ in another field a plan takes batch-wide (CTB size,
    strong smoothing) decode as separate batches.  ``options.mesh``
    shards the tiles over a mesh (decode_tiles_device)."""
    ctx = grid_item.ctx
    try:
        tiles = [ctx.get_item(tid) for tid in tile_ids]
        if not all(isinstance(t, ImageItem_HEVC) for t in tiles) or \
                not registry.selects_builtin("hevc", options.decoder_id):
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
    # batch-wide (a phone photo's tiles make one group), on each member
    try:
        planes = decode_tiles_device([p[1] for p in parsed],
                                     [p[2] for p in parsed], options.mesh,
                                     ctx.device)
    except BatchMismatch:
        return None
    planes = [tuple(x.to(ctx.device) for x in pl) for pl in planes]
    return compose(grid, [p[0] for p in parsed], planes, ctx, options)


def compose(grid, spss, planes, ctx, options) -> PixelImage:
    """Paste each HEVC tile's cropped planes into the grid's output planes
    on the context's device, in grid order."""
    return paste_tiles(grid, [planes_to_image(sps, *pl)
                              for sps, pl in zip(spss, planes)], ctx, options)


def paste_tiles(grid, tiles: Sequence[PixelImage], ctx, options
                ) -> PixelImage:
    """Paste decoded tiles into the grid's output planes on the context's
    device, in grid order (the output takes the first tile's colourspace,
    chroma and depths)."""
    tw, th = tiles[0].width, tiles[0].height
    out = PixelImage(grid.output_width, grid.output_height,
                     tiles[0].colorspace, tiles[0].chroma, ctx.limits)
    n_total = len(tiles)
    with span("grid.compose"):
        for idx, tile in enumerate(tiles):
            if not out.planes:
                for ch in tile.channels():
                    out.add_plane(ch, bit_depth=tile.bit_depth(ch),
                                  device=ctx.device)
            ty, tx = divmod(idx, grid.columns)
            out.copy_into(tile, tx * tw, ty * th)
            if options.on_progress is not None:
                options.on_progress(idx + 1, n_total)
    return out


def parse_av1_tile(item, limits):
    """Host entropy decode of one av01 tile → (seq, fh, TileDecoder)."""
    return av1_decoder.parse_frame(
        av1_decoder.config_stream(item.config_box(), item.coded_data()),
        limits)


def try_batched_av1_grid(grid_item, grid, tile_ids,
                         options) -> Optional[PixelImage]:
    """Batched decode of an all-av01 grid, composed on the context's
    device.  Returns None where the batch does not apply (other item
    types, a ``decoder_id`` that does not select the built-in decoder,
    per-tile transforms or alpha, streams the port refuses, tiles
    of different size, depth or chroma): the caller then decodes tile by
    tile.  Tiles that differ in another field a plan takes batch-wide
    (the intra edge filter flag) decode as separate batches."""
    ctx = grid_item.ctx
    try:
        tiles = [ctx.get_item(tid) for tid in tile_ids]
        if not all(isinstance(t, ImageItem_AVIF) for t in tiles) or \
                not registry.selects_builtin("av1", options.decoder_id):
            return None
        for t in tiles:
            if t.init_error is not None or t.alpha_item is not None:
                return None
            if any(isinstance(p, (Box_irot, Box_imir, Box_clap))
                   for p in t.properties()):
                return None
        if options.cancel is not None and options.cancel():
            return None
        parsed = [parse_av1_tile(t, ctx.limits) for t in tiles]
    except HeifError:
        return None

    def shape(p):
        seq, fh, _ = p
        return (fh.frame_width, fh.frame_height, seq.bit_depth,
                seq.monochrome, seq.subsampling_x, seq.subsampling_y)
    if any(shape(p) != shape(parsed[0]) for p in parsed):
        return None
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(parsed):
        groups.setdefault(av1_recon.batch_key(p[2]), []).append(i)
    images: List = [None] * len(parsed)
    for idx in groups.values():
        try:
            out = av1_recon.decode_frames_device([parsed[i][2] for i in idx],
                                                 ctx.device)
        except av1_recon.BatchMismatch:
            return None
        for i, pl in zip(idx, out):
            seq, fh, dec = parsed[i]
            # each tile's own film grain (its parameters, size and seed)
            planes = av1_decoder.maybe_grain(
                av1_decoder.finish_frame(seq, fh, dec, pl), seq, fh)
            images[i] = av1_decoder.planes_to_image(planes, seq.bit_depth,
                                                    ctx.limits)
    return paste_tiles(grid, images, ctx, options)


def try_batched_jpeg_grid(grid_item, grid, tile_ids,
                          options) -> Optional[PixelImage]:
    """Batched decode of an all-jpeg grid on the context's device: the
    tiles scan on a thread pool, then one launch of jpeg_dequant_idct
    writes every tile's planes at its place in the composed planes.
    Returns None where the batch does not apply (other item types, a
    ``decoder_id`` that does not select the built-in decoder, per-tile
    transforms or alpha, streams the port refuses, tiles that
    differ in size, sampling or component count, which raise BatchMismatch
    inside): the caller then decodes tile by tile."""
    ctx = grid_item.ctx
    try:
        tiles = [ctx.get_item(tid) for tid in tile_ids]
        if not all(isinstance(t, ImageItem_JPEG) for t in tiles) or \
                not registry.selects_builtin("jpeg", options.decoder_id):
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
        frames = parse_tiles(jobs, parse=jpeg_decoder.parse_item)
        out = jpeg_decoder.compose(frames, grid.columns, grid.output_width,
                                   grid.output_height, ctx.device,
                                   ctx.limits)
    except (HeifError, jpeg_decoder.BatchMismatch):
        return None
    if options.on_progress is not None:
        for i in range(len(frames)):
            options.on_progress(i + 1, len(frames))
    return out
