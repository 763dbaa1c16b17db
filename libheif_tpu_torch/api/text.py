"""Text-item API (ref: api/libheif/heif_text.h, 9 fns).

txti text annotations linked via 'cdsc' (ref: text.h:31 TextItem);
counterpart of libheif_tpu/api/text.py.
"""

from __future__ import annotations

from typing import List

from ..items.text_item import TextItem
from .image_handle import heif_image_handle

heif_text_item = TextItem


def heif_image_handle_get_number_of_text_items(handle) -> int:
    return len(handle.ctx.get_text_items(handle.item_id))


def heif_image_handle_get_list_of_text_item_ids(handle) -> List[int]:
    return [t.item_id for t in handle.ctx.get_text_items(handle.item_id)]


def heif_context_get_text_item(ctx, text_item_id: int) -> TextItem:
    return TextItem.parse(text_item_id,
                          ctx.file.get_item_data(text_item_id))


def heif_text_item_get_id(item: TextItem) -> int:
    return item.item_id


def heif_text_item_get_content(item: TextItem) -> str:
    return item.text


def heif_text_item_get_content_type(ctx, text_item_id: int) -> str:
    return getattr(ctx.file.get_infe(text_item_id), "content_type",
                   "text/plain")


def heif_text_item_release(item) -> None:
    pass


def heif_image_handle_add_text_item(handle, content_type: str,
                                    text: str) -> int:
    """(ref: heif_image_handle_add_text_item)."""
    return handle.ctx.add_text_item(handle.item_id, text, content_type)


def heif_text_item_get_parent_image_id(ctx, text_item_id: int) -> int:
    refs = ctx.file.get_references_from(text_item_id, "cdsc")
    for r in refs:
        if r.to_item_ids:
            return r.to_item_ids[0]
    return 0


def heif_text_item_get_property_extended_language(text_item):
    """(ref: heif_text.h elng on text items)."""
    from ..boxes.meta import Box_elng
    ctx = text_item.ctx if hasattr(text_item, "ctx") else None
    item_id = getattr(text_item, "item_id", None)
    if ctx is None or item_id is None:
        return getattr(text_item, "extended_language", None)
    p = ctx.file.get_property(item_id, Box_elng)
    return p.extended_language if p is not None else None


def heif_text_item_set_extended_language(text_item, lang: str) -> None:
    from ..boxes.meta import Box_elng
    ctx = getattr(text_item, "ctx", None)
    item_id = getattr(text_item, "item_id", None)
    if ctx is not None and item_id is not None:
        ctx.file.add_property(item_id, Box_elng(lang), False)
    else:
        text_item.extended_language = lang
