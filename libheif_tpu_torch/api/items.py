"""Raw item API (ref: api/libheif/heif_items.h, 21 fns); counterpart
of libheif_tpu/api/items.py.

Direct access to the item table: ids, types, payload data, references,
names — below the image-item semantic layer (ref: heif_items.h over
HeifFile, file.h:60).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..boxes.meta import Box_elng
from ..core.error import HeifError
from ..core.fourcc import fourcc_to_str  # noqa: F401  (re-export)


def heif_context_get_number_of_items(ctx) -> int:
    return len(ctx.file.item_ids)


def heif_context_get_list_of_item_IDs(ctx) -> List[int]:
    return list(ctx.file.item_ids)


def heif_item_get_item_type(ctx, item_id: int) -> str:
    return ctx.file.get_item_type(item_id)


def heif_item_is_item_hidden(ctx, item_id: int) -> bool:
    return bool(getattr(ctx.file.get_infe(item_id), "hidden", False))


def heif_item_get_mime_item_content_type(ctx, item_id: int
                                         ) -> Optional[str]:
    infe = ctx.file.get_infe(item_id)
    if infe.item_type != "mime":
        return None
    return getattr(infe, "content_type", None)


def heif_item_get_mime_item_content_encoding(ctx, item_id: int
                                             ) -> Optional[str]:
    infe = ctx.file.get_infe(item_id)
    return getattr(infe, "content_encoding", None) or None


def heif_item_get_uri_item_uri_type(ctx, item_id: int) -> Optional[str]:
    infe = ctx.file.get_infe(item_id)
    if infe.item_type != "uri ":
        return None
    return getattr(infe, "item_uri_type", None)


def heif_item_get_item_name(ctx, item_id: int) -> str:
    return getattr(ctx.file.get_infe(item_id), "item_name", "")


def heif_item_set_item_name(ctx, item_id: int, name: str) -> None:
    ctx.file.get_infe(item_id).item_name = name


def heif_item_get_item_data(ctx, item_id: int) -> bytes:
    """(ref: heif_items.h heif_item_get_item_data): the bytes, also
    where the file hands out a view of its buffer."""
    return bytes(ctx.file.get_item_data(item_id))


def heif_release_item_data(ctx, data) -> None:
    pass


# --------------------------------------------------------------- creation

def heif_context_add_item(ctx, item_type: str, data: bytes) -> int:
    if ctx.file is None or not ctx.file.created_for_writing:
        ctx.new_file()
    infe = ctx.file.add_new_item(item_type)
    if data:
        ctx.file.append_item_data(infe.item_id, bytes(data))
    return infe.item_id


def heif_context_add_mime_item(ctx, content_type: str, data: bytes,
                               content_encoding: Optional[str] = None
                               ) -> int:
    if ctx.file is None or not ctx.file.created_for_writing:
        ctx.new_file()
    infe = ctx.file.add_new_item("mime")
    infe.content_type = content_type
    if content_encoding:
        infe.content_encoding = content_encoding
    ctx.file.append_item_data(infe.item_id, bytes(data))
    return infe.item_id


def heif_context_add_precompressed_mime_item(ctx, content_type: str,
                                             data: bytes,
                                             content_encoding: str) -> int:
    return heif_context_add_mime_item(ctx, content_type, data,
                                      content_encoding)


def heif_context_add_uri_item(ctx, item_uri_type: str, data: bytes) -> int:
    if ctx.file is None or not ctx.file.created_for_writing:
        ctx.new_file()
    infe = ctx.file.add_new_item("uri ")
    infe.item_uri_type = item_uri_type
    if data:
        ctx.file.append_item_data(infe.item_id, bytes(data))
    return infe.item_id


def heif_item_add_raw_data(ctx, item_id: int, data: bytes) -> None:
    ctx.file.append_item_data(item_id, bytes(data))


# ------------------------------------------------------------- references

def heif_context_add_item_reference(ctx, reference_type: str,
                                    from_item: int, to_item: int) -> None:
    ctx.file.add_reference(reference_type, from_item, [to_item])


def heif_context_add_item_references(ctx, reference_type: str,
                                     from_item: int,
                                     to_items: List[int]) -> None:
    ctx.file.add_reference(reference_type, from_item, list(to_items))


def heif_context_get_item_references(ctx, item_id: int
                                     ) -> List[Tuple[str, List[int]]]:
    """All outgoing (type, to_ids) reference groups of an item."""
    return [(r.ref_type, list(r.to_item_ids))
            for r in ctx.file.get_references_from(item_id)]


def heif_item_get_property_extended_language(ctx, item_id: int):
    """elng property value or None (ref: heif_properties.h elng API;
    Box_elng box.h:2000)."""
    p = ctx.file.get_property(item_id, Box_elng)
    return p.extended_language if p is not None else None


def heif_item_set_property_extended_language(ctx, item_id: int,
                                             lang: str) -> int:
    return ctx.file.add_property(item_id, Box_elng(lang), False)


def heif_release_item_references(refs) -> None:
    """C array lifetime no-op in Python (ref: heif_items.h)."""
