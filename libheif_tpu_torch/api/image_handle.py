"""Image-handle API (ref: api/libheif/heif_image_handle.h, 22 fns);
counterpart of libheif_tpu/api/image_handle.py.

A `heif_image_handle` is a lightweight (context, item_id) pair over the
interpreted item graph — the analog of the reference's opaque handle
wrapping an ImageItem (api_structs.h:44).
"""

from __future__ import annotations

from typing import List, Optional

from ..boxes.meta import Box_gimi_content_id, Box_pasp
from ..core.error import HeifError
from ..image.pixel_image import Chroma, Colorspace


class heif_image_handle:
    __slots__ = ("ctx", "item_id")

    def __init__(self, ctx, item_id: int):
        self.ctx = ctx
        self.item_id = item_id

    @property
    def item(self):
        return self.ctx.get_item(self.item_id)

    def __repr__(self):
        return f"heif_image_handle(item {self.item_id})"


def heif_image_handle_release(handle) -> None:
    pass  # GC-managed


def heif_image_handle_get_item_id(handle: heif_image_handle) -> int:
    return handle.item_id


def heif_image_handle_get_context(handle: heif_image_handle):
    return handle.ctx


def heif_image_handle_is_primary_image(handle: heif_image_handle) -> bool:
    return handle.ctx.primary_item_id == handle.item_id


def heif_image_handle_get_width(handle: heif_image_handle) -> int:
    return handle.item.width_height()[0]


def heif_image_handle_get_height(handle: heif_image_handle) -> int:
    return handle.item.width_height()[1]


def heif_image_handle_get_ispe_width(handle: heif_image_handle) -> int:
    """Pre-transform coded size (ref: heif_image_handle.h ispe API)."""
    sz = handle.item.ispe_size
    if sz is None:
        raise HeifError.invalid_input(msg="item has no ispe property")
    return sz[0]


def heif_image_handle_get_ispe_height(handle: heif_image_handle) -> int:
    sz = handle.item.ispe_size
    if sz is None:
        raise HeifError.invalid_input(msg="item has no ispe property")
    return sz[1]


def heif_image_handle_has_alpha_channel(handle: heif_image_handle) -> bool:
    item = handle.item
    if item.alpha_item is not None:
        return True
    # unci/mask items can carry interleaved alpha; report from pixi
    return False


def heif_image_handle_is_premultiplied_alpha(handle) -> bool:
    return bool(handle.item.premultiplied_alpha)


def heif_image_handle_get_luma_bits_per_pixel(handle) -> int:
    return handle.item.luma_bits_per_pixel()


def heif_image_handle_get_chroma_bits_per_pixel(handle) -> int:
    item = handle.item
    f = getattr(item, "chroma_bits_per_pixel", None)
    return f() if f else item.luma_bits_per_pixel()


def heif_image_handle_get_preferred_decoding_colorspace(handle):
    """Returns (colorspace, chroma) the decoder natively produces."""
    item = handle.item
    f = getattr(item, "preferred_decoding_colorspace", None)
    if f is not None:
        return f()
    return (Colorspace.YCbCr, Chroma.C420)


# ------------------------------------------------------------ thumbnails

def heif_image_handle_get_number_of_thumbnails(handle) -> int:
    return len(handle.item.thumbnails)


def heif_image_handle_get_list_of_thumbnail_IDs(handle) -> List[int]:
    return [t.item_id for t in handle.item.thumbnails]


def heif_image_handle_get_thumbnail(handle, thumbnail_id: int
                                    ) -> heif_image_handle:
    for t in handle.item.thumbnails:
        if t.item_id == thumbnail_id:
            return heif_image_handle(handle.ctx, thumbnail_id)
    raise HeifError.usage(msg=f"no thumbnail item {thumbnail_id}")


# ------------------------------------------------------------ depth

def heif_image_handle_has_depth_image(handle) -> bool:
    return handle.item.depth_item is not None


def heif_image_handle_get_number_of_depth_images(handle) -> int:
    return 1 if handle.item.depth_item is not None else 0


def heif_image_handle_get_list_of_depth_image_IDs(handle) -> List[int]:
    d = handle.item.depth_item
    return [d.item_id] if d is not None else []


def heif_image_handle_get_depth_image_handle(handle, depth_id: int
                                             ) -> heif_image_handle:
    d = handle.item.depth_item
    if d is None or d.item_id != depth_id:
        raise HeifError.usage(msg=f"no depth image {depth_id}")
    return heif_image_handle(handle.ctx, depth_id)


def heif_image_handle_get_depth_image_representation_info(handle,
                                                          depth_id: int):
    """(ref: heif_depth_representation_info; parsed from the depth
    item's SEI when present). Returns None when unavailable."""
    d = handle.item.depth_item
    if d is None:
        return None
    return getattr(d, "depth_representation_info", None)


def heif_depth_representation_info_free(info) -> None:
    pass


def heif_image_handle_get_pixel_aspect_ratio(handle: heif_image_handle):
    """(has_pasp, aspect_h, aspect_v); 1:1 default
    (ref: heif_image_handle.h:117)."""
    p = handle.ctx.file.get_property(handle.item_id, Box_pasp)
    if p is None:
        return False, 1, 1
    return True, p.h_spacing, p.v_spacing


def heif_image_handle_set_pixel_aspect_ratio(handle: heif_image_handle,
                                             aspect_h: int,
                                             aspect_v: int) -> None:
    p = Box_pasp()
    p.h_spacing = aspect_h
    p.v_spacing = aspect_v
    handle.ctx.file.add_property(handle.item_id, p, False)


def heif_image_handle_get_gimi_content_id(handle: heif_image_handle
                                          ) -> Optional[str]:
    """(ref: heif_image_handle.h:132; Box_gimi_content_id box.h:1957)."""
    p = handle.ctx.file.get_property(handle.item_id,
                                     Box_gimi_content_id)
    return p.content_id if p is not None else None


def heif_image_handle_set_gimi_content_id(handle: heif_image_handle,
                                          content_id: str) -> None:
    p = Box_gimi_content_id()
    p.content_id = content_id
    handle.ctx.file.add_property(handle.item_id, p, False)


def _component_descriptions(handle):
    item = handle.item
    get = getattr(item, "component_descriptions", None)
    comps = get() if callable(get) else []
    return comps or []


def heif_image_handle_get_number_of_cmpd_components(
        handle: heif_image_handle) -> int:
    """(ref: heif_image_handle.h cmpd introspection;
    image_item.h:104-134)."""
    return len(_component_descriptions(handle))


def heif_image_handle_get_cmpd_component_type(
        handle: heif_image_handle, idx: int) -> int:
    comps = _component_descriptions(handle)
    if idx >= len(comps):
        raise HeifError.usage(msg=f"component index {idx}")
    c = comps[idx]
    return getattr(c, "component_type", c[0] if isinstance(c, tuple)
                   else 0)


def heif_image_handle_get_cmpd_component_type_uri(
        handle: heif_image_handle, idx: int) -> Optional[str]:
    comps = _component_descriptions(handle)
    if idx >= len(comps):
        raise HeifError.usage(msg=f"component index {idx}")
    c = comps[idx]
    return getattr(c, "component_type_uri", None)


def heif_image_handle_has_gimi_component_content_ids(
        handle: heif_image_handle) -> bool:
    """(ref: heif_image_handle.h:160; per-component content IDs ride
    the item's component description list)."""
    ids = getattr(handle.item, "gimi_component_content_ids", None)
    return bool(ids)


def heif_image_handle_get_gimi_component_content_id(
        handle: heif_image_handle, component_idx: int) -> Optional[str]:
    ids = getattr(handle.item, "gimi_component_content_ids", None) or {}
    return ids.get(component_idx)


def heif_image_handle_set_gimi_component_content_id(
        handle: heif_image_handle, component_idx: int,
        content_id: str) -> None:
    item = handle.item
    if not hasattr(item, "gimi_component_content_ids") or \
            item.gimi_component_content_ids is None:
        item.gimi_component_content_ids = {}
    item.gimi_component_content_ids[component_idx] = content_id
