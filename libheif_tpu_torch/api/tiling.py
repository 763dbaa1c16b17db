"""Tiling API (ref: api/libheif/heif_tiling.h, 6 fns +
heif_image_tiling heif_tiling.h:37).

Tile-streaming decode and streamed grid/unci/tili encode; counterpart
of libheif_tpu/api/tiling.py.  heif_image_handle_decode_image_tile
decodes one tile through HeifContext.decode_tile on the context's
device.  heif_context_encode_grid takes its format from
``encoder.format``: pass a registry encoder (``heif_encoder.impl``); a
``heif_encoder`` has no ``format`` and gets "hevc", as in JAX.  Where it
is given no tiles or a wrong count it raises a usage HeifError (the JAX
module names HeifError there without importing it).
"""

from __future__ import annotations

from typing import List, Optional

from ..core.error import HeifError
from .types import ImageTiling, EncodingOptions
from .image_handle import heif_image_handle

heif_image_tiling = ImageTiling


def heif_image_handle_get_image_tiling(handle: heif_image_handle,
                                       process_image_transformations:
                                       bool = True) -> ImageTiling:
    """(ref: heif_tiling.h:67)."""
    return handle.ctx.get_image_tiling(handle.item_id)


def heif_image_handle_get_grid_image_tile_id(handle: heif_image_handle,
                                             process_transformations:
                                             bool, tile_x: int,
                                             tile_y: int) -> int:
    """(ref: heif_tiling.h:79)."""
    item = handle.item
    get_ids = getattr(item, "tile_item_ids", None)
    if get_ids is None:
        raise HeifError.usage(msg="item is not a grid image")
    tile_ids = get_ids()
    t = handle.ctx.get_image_tiling(handle.item_id)
    return tile_ids[tile_y * t.num_columns + tile_x]


def heif_image_handle_decode_image_tile(handle: heif_image_handle,
                                        colorspace: str = "undefined",
                                        chroma: str = "undefined",
                                        options=None, tile_x: int = 0,
                                        tile_y: int = 0):
    """(ref: heif_tiling.h:86 → decode_only_tile path
    context.cc:1425)."""
    from ..image.pixel_image import Colorspace, Chroma
    cs = colorspace if colorspace != "undefined" else Colorspace.Undefined
    ch = chroma if chroma != "undefined" else Chroma.Undefined
    return handle.ctx.decode_tile(handle.item_id, tile_x, tile_y, cs, ch)


def heif_context_add_grid_image(ctx, image_width: int, image_height: int,
                                tile_columns: int, tile_rows: int,
                                tile_handles: Optional[List] = None,
                                encoding_options=None
                                ) -> heif_image_handle:
    """(ref: heif_tiling.cc:270 heif_context_add_grid_image). With
    tile_handles given, wires existing encoded tiles into a grid."""
    tile_ids = [h.item_id for h in (tile_handles or [])]
    gid = ctx.add_grid_image(tile_ids, image_width, image_height,
                             rows=tile_rows, columns=tile_columns)
    return heif_image_handle(ctx, gid)


def heif_context_add_image_tile(ctx, tiled_image_handle, tile_x: int,
                                tile_y: int, image, encoder) -> None:
    """(ref: heif_tiling.cc:291 heif_context_add_image_tile)."""
    ctx.add_image_tile_to_tiled(tiled_image_handle.item_id, tile_x,
                                tile_y, image)


def heif_context_add_tiled_image(ctx, parameters,
                                 encoding_options=None, encoder=None
                                 ) -> heif_image_handle:
    """(ref: heif_experimental.h:146 heif_context_add_tiled_image;
    parameters: heif_tiled_image_parameters-like dict or object)."""
    get = (parameters.get if isinstance(parameters, dict)
           else lambda k, d=None: getattr(parameters, k, d))
    iid = ctx.add_tiled_image(
        get("image_width"), get("image_height"),
        get("tile_width"), get("tile_height"),
        fmt=(encoder.impl.format if encoder is not None else "unci"),
        offset_field_length=get("offset_field_length", 40) or 40,
        size_field_length=get("size_field_length", 24) or 24)
    return heif_image_handle(ctx, iid)


def heif_context_encode_grid(ctx, tiles, rows: int, columns: int,
                             encoder=None, input_options=None):
    """Encode a list of tile images and assemble them into a grid item
    (ref: heif_tiling.h:109 heif_context_encode_grid)."""
    from .image_handle import heif_image_handle
    if not tiles or rows == 0 or columns == 0:
        raise HeifError.usage(msg="encode_grid needs tiles and a shape")
    if len(tiles) != rows * columns:
        raise HeifError.usage(msg="tile count != rows*columns")
    fmt = getattr(encoder, "format", None) or "hevc"
    from ..option_types import EncodingOptions
    options = input_options or EncodingOptions()
    tile_ids = [ctx.encode_image(t, fmt=fmt, options=options)
                for t in tiles]
    tw, th = tiles[0].width, tiles[0].height
    grid_id = ctx.add_grid_image(tile_ids, tw * columns, th * rows,
                                 rows, columns)
    return heif_image_handle(ctx, grid_id)
