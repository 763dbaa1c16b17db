"""Decoding API (ref: api/libheif/heif_decoding.h, 10 fns +
heif_decoding_options v10, heif_decoding.h:63-158); counterpart of
libheif_tpu/api/decoding.py.

``heif_decode_image`` decodes through the handle's HeifContext, so the
planes it returns lie on the context's device; ``decoder_id`` pins the
codec registry's decoder of the item's format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..codecs import registry
from ..image.pixel_image import PixelImage, Colorspace, Chroma
from ..items.item import DecodingOptions as _ItemOptions
from .image_handle import heif_image_handle


@dataclass
class heif_decoding_options:
    """(ref: heif_decoding_options v10, heif_decoding.h:63-158)."""

    ignore_transformations: bool = False
    # progress callbacks (ref: heif_decoding.h:56-80); invoked per tile
    start_progress: Optional[Callable[[int, int], None]] = None
    on_progress: Optional[Callable[[int, int], None]] = None
    end_progress: Optional[Callable[[int], None]] = None
    cancel_decoding: Optional[Callable[[], bool]] = None
    convert_hdr_to_8bit: bool = False
    strict_decoding: bool = False
    decoder_id: Optional[str] = None
    color_conversion_options: Optional[object] = None
    ignore_aux_alpha: bool = False
    num_codec_threads: int = 0
    # v10: keep NCLX passthrough
    color_conversion_options_ext: Optional[object] = None


def heif_decoding_options_alloc() -> heif_decoding_options:
    return heif_decoding_options()


def heif_decoding_options_free(options) -> None:
    pass


def heif_decoding_options_copy(dst: heif_decoding_options,
                               src: heif_decoding_options) -> None:
    dst.__dict__.update(src.__dict__)


def _to_item_options(options: Optional[heif_decoding_options]
                     ) -> _ItemOptions:
    o = _ItemOptions()
    if options is not None:
        o.ignore_transformations = options.ignore_transformations
        o.strict_decoding = options.strict_decoding
        o.decoder_id = options.decoder_id
        o.ignore_aux_alpha = options.ignore_aux_alpha
        o.on_progress = options.on_progress
        o.cancel = options.cancel_decoding
        o.convert_hdr_to_8bit = options.convert_hdr_to_8bit
    return o


def heif_decode_image(handle: heif_image_handle,
                      colorspace: str = Colorspace.Undefined,
                      chroma: str = Chroma.Undefined,
                      options: Optional[heif_decoding_options] = None
                      ) -> PixelImage:
    """(ref: heif_decoding.cc:241 → HeifContext::decode_image): planes
    on the context's device."""
    return handle.ctx.decode_image(handle.item_id,
                                   colorspace=colorspace, chroma=chroma,
                                   options=_to_item_options(options))


def heif_have_decoder_for_format(compression_format: str) -> bool:
    return registry.have_decoder(compression_format)


def heif_get_decoder_descriptors(format_filter: Optional[str] = None
                                 ) -> List[Tuple[str, str]]:
    out = registry.list_decoders()
    if format_filter is not None:
        out = [d for d in out if d[0] == format_filter]
    return out


def heif_decoder_descriptor_get_name(descriptor: Tuple[str, str]) -> str:
    fmt, dec_id = descriptor
    return f"{dec_id} ({fmt})"


def heif_decoder_descriptor_get_id_name(descriptor) -> str:
    return descriptor[1]
