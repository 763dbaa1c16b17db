"""ISO 23001-17 uncompressed API (ref: api/libheif/heif_uncompressed.h,
4 fns: add_empty_unci_image + unci encoding options); counterpart of
libheif_tpu/api/uncompressed.py.  The tiles that
heif_context_add_image_tile appends are packed on the image's device,
one host copy a tile (codecs/unc/codec.UnciEncoder).
"""

from __future__ import annotations

from dataclasses import dataclass

from .types import EncodingOptions
from .image_handle import heif_image_handle


@dataclass
class heif_unci_image_parameters:
    """(ref: heif_unci_image_parameters struct)."""

    image_width: int = 0
    image_height: int = 0
    tile_width: int = 0
    tile_height: int = 0
    compression: str = "none"   # none | deflate | zlib | brotli


def heif_unci_image_parameters_alloc() -> heif_unci_image_parameters:
    return heif_unci_image_parameters()


def heif_unci_image_parameters_release(params) -> None:
    pass


def heif_context_add_empty_unci_image(ctx,
                                      parameters:
                                      heif_unci_image_parameters,
                                      encoding_options=None,
                                      prototype=None
                                      ) -> heif_image_handle:
    """Creates a tili-tiled unci image to fill with
    heif_context_add_image_tile (ref: heif_uncompressed.h →
    unc_image.cc append-tile encode)."""
    iid = ctx.add_tiled_image(parameters.image_width,
                              parameters.image_height,
                              parameters.tile_width,
                              parameters.tile_height, fmt="unci")
    return heif_image_handle(ctx, iid)


def heif_unci_image_parameters_copy(params):
    """(ref: heif_uncompressed.h heif_unci_image_parameters_copy)."""
    import copy
    return copy.deepcopy(params)
