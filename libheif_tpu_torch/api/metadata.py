"""Metadata API (ref: api/libheif/heif_metadata.h, 13 fns); counterpart
of libheif_tpu/api/metadata.py.

Exif / XMP / generic metadata blocks linked to images via 'cdsc'
references (ref: heif_metadata.h over context metadata access).
Brotli compression of XMP needs a ``brotli`` (or ``brotlicffi``) module,
as in the JAX package (codecs/unc/codec.py:31-39 there), whose absence
makes it unsupported; the port's unci codec has no brotli, so the
lookup lives here (``_brotli``).
"""

from __future__ import annotations

import zlib as _z
from typing import List, Optional

from ..core.error import HeifError, SubError
from .image_handle import heif_image_handle


def _brotli():
    """The brotli module, or None where neither brotli nor brotlicffi is
    installed."""
    try:
        import brotli  # type: ignore
    except ImportError:
        try:
            import brotlicffi as brotli  # type: ignore
        except ImportError:
            brotli = None
    return brotli


def _blocks(handle: heif_image_handle, type_filter: Optional[str] = None):
    return handle.ctx.get_metadata_blocks(handle.item_id, type_filter)


def heif_image_handle_get_number_of_metadata_blocks(
        handle: heif_image_handle, type_filter: Optional[str] = None
        ) -> int:
    return len(_blocks(handle, type_filter))


def heif_image_handle_get_list_of_metadata_block_IDs(
        handle: heif_image_handle, type_filter: Optional[str] = None
        ) -> List[int]:
    return [b["item_id"] for b in _blocks(handle, type_filter)]


def _block_by_id(handle, metadata_id: int) -> dict:
    for b in _blocks(handle):
        if b["item_id"] == metadata_id:
            return b
    raise HeifError.usage(msg=f"no metadata block {metadata_id}")


def heif_image_handle_get_metadata_type(handle, metadata_id: int) -> str:
    return _block_by_id(handle, metadata_id)["item_type"]


def heif_image_handle_get_metadata_content_type(handle,
                                                metadata_id: int) -> str:
    return _block_by_id(handle, metadata_id).get("content_type", "")


def heif_image_handle_get_metadata_item_uri_type(handle,
                                                 metadata_id: int) -> str:
    return _block_by_id(handle, metadata_id).get("uri_type", "")


def heif_image_handle_get_metadata_size(handle, metadata_id: int) -> int:
    return len(_block_by_id(handle, metadata_id)["data"])


def heif_image_handle_get_metadata(handle, metadata_id: int) -> bytes:
    """Raw metadata payload; for Exif this includes the 4-byte TIFF
    header offset prefix, as in the reference."""
    return _block_by_id(handle, metadata_id)["data"]


def heif_image_handle_get_exif(handle) -> Optional[bytes]:
    """Convenience: Exif payload without the offset prefix."""
    return handle.ctx.get_exif(handle.item_id)


def heif_image_handle_get_xmp(handle) -> Optional[bytes]:
    return handle.ctx.get_xmp(handle.item_id)


def heif_context_add_exif_metadata(ctx, handle: heif_image_handle,
                                   data: bytes) -> int:
    """(ref: heif_context_add_exif_metadata)."""
    return ctx.add_exif(handle.item_id, bytes(data))


def heif_context_add_XMP_metadata(ctx, handle: heif_image_handle,
                                  data: bytes,
                                  compression: Optional[str] = None
                                  ) -> int:
    """(ref: heif_context_add_XMP_metadata(2); compression maps to the
    mime content_encoding deflate path)."""
    return ctx.add_xmp(handle.item_id, bytes(data))


def heif_context_add_generic_metadata(ctx, handle: heif_image_handle,
                                      data: bytes, item_type: str,
                                      content_type: Optional[str] = None
                                      ) -> int:
    """(ref: heif_context_add_generic_metadata)."""
    if ctx.file is None or not ctx.file.created_for_writing:
        ctx.new_file()
    infe = ctx.file.add_new_item(item_type)
    if content_type and item_type == "mime":
        infe.content_type = content_type
    ctx.file.append_item_data(infe.item_id, bytes(data))
    ctx.file.add_reference("cdsc", infe.item_id, [handle.item_id])
    infe.hidden = True
    return infe.item_id


def heif_context_add_generic_uri_metadata(ctx, handle: heif_image_handle,
                                          data: bytes,
                                          item_uri_type: str) -> int:
    if ctx.file is None or not ctx.file.created_for_writing:
        ctx.new_file()
    infe = ctx.file.add_new_item("uri ")
    infe.item_uri_type = item_uri_type
    ctx.file.append_item_data(infe.item_id, bytes(data))
    ctx.file.add_reference("cdsc", infe.item_id, [handle.item_id])
    infe.hidden = True
    return infe.item_id


def heif_metadata_compression_method_supported(method: str) -> bool:
    """(ref: heif_metadata.h:42)."""
    if method in ("off", "undefined", None, "deflate", "zlib"):
        return True
    if method == "brotli":
        return _brotli() is not None
    return False


def heif_context_add_XMP_metadata2(ctx, handle, data: bytes,
                                   compression: str = "off") -> int:
    """XMP with optional generic compression: the payload is stored
    compressed with the matching mime content_encoding
    (ref: heif_metadata.h:108, compression.h:59-114)."""
    if compression in (None, "off", "undefined"):
        return heif_context_add_XMP_metadata(ctx, handle, data)
    if compression == "deflate":
        co = _z.compressobj(wbits=-15)
        comp = co.compress(bytes(data)) + co.flush()
        encoding = "deflate"
    elif compression == "zlib":
        comp = _z.compress(bytes(data))
        encoding = "compress_zlib"
    elif compression == "brotli":
        brotli = _brotli()
        if brotli is None:
            raise HeifError.unsupported(
                SubError.Unsupported_header_compression_method,
                "brotli not available in this build")
        comp = brotli.compress(bytes(data))
        encoding = "compress_brotli"
    else:
        raise HeifError.unsupported(
            SubError.Unsupported_header_compression_method,
            f"metadata compression {compression}")
    item_id = ctx.add_xmp(handle.item_id, comp)
    ctx.file.get_infe(item_id).content_encoding = encoding
    return item_id
