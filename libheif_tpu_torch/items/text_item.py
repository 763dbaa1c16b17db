"""Text annotation items (txti).

Counterpart of libheif_tpu/items/text_item.py (reference:
libheif/text.{h,cc} TextItem text.h:31).  The item payload is UTF-8
text; it attaches to images via a 'cdsc' reference."""

from __future__ import annotations


class TextItem:
    def __init__(self, item_id: int = 0, text: str = ""):
        self.item_id = item_id
        self.text = text

    @staticmethod
    def parse(item_id: int, data: bytes) -> "TextItem":
        return TextItem(item_id, bytes(data).decode("utf-8", "replace"))

    def serialize(self) -> bytes:
        return self.text.encode("utf-8")
