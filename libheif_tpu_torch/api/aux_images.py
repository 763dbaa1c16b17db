"""Auxiliary-image API (ref: api/libheif/heif_aux_images.h, 17 fns);
counterpart of libheif_tpu/api/aux_images.py.

Alpha/depth/generic aux channel enumeration and access (ref:
heif_aux_images.h over the ImageItem aux linkage, context.cc:800+).
"""

from __future__ import annotations

from typing import List, Optional

from ..boxes.meta import Box_auxC
from ..core.error import HeifError
from .image_handle import heif_image_handle

# filtering flags (ref: heif_aux_images.h LIBHEIF_AUX_IMAGE_FILTER_*)
LIBHEIF_AUX_IMAGE_FILTER_OMIT_ALPHA = 1
LIBHEIF_AUX_IMAGE_FILTER_OMIT_DEPTH = 2


def _aux_list(handle: heif_image_handle, aux_filter: int = 0):
    item = handle.item
    out = []
    if not (aux_filter & LIBHEIF_AUX_IMAGE_FILTER_OMIT_ALPHA) and \
            item.alpha_item is not None:
        out.append(item.alpha_item)
    if not (aux_filter & LIBHEIF_AUX_IMAGE_FILTER_OMIT_DEPTH) and \
            item.depth_item is not None:
        out.append(item.depth_item)
    out.extend(item.aux_items)
    return out


def heif_image_handle_get_number_of_auxiliary_images(
        handle, aux_filter: int = 0) -> int:
    return len(_aux_list(handle, aux_filter))


def heif_image_handle_get_list_of_auxiliary_image_IDs(
        handle, aux_filter: int = 0) -> List[int]:
    return [a.item_id for a in _aux_list(handle, aux_filter)]


def heif_image_handle_get_auxiliary_image_handle(handle, aux_id: int
                                                 ) -> heif_image_handle:
    for a in _aux_list(handle):
        if a.item_id == aux_id:
            return heif_image_handle(handle.ctx, aux_id)
    raise HeifError.usage(msg=f"no auxiliary image {aux_id}")


def heif_image_handle_get_auxiliary_type(handle) -> Optional[str]:
    """The auxC aux_type URN of THIS item when it is an aux image."""
    p = handle.ctx.file.get_property(handle.item_id, Box_auxC)
    return p.aux_type if p is not None else None


def heif_image_handle_release_auxiliary_type(handle, aux_type) -> None:
    pass


def heif_image_handle_free_auxiliary_types(handle, types) -> None:
    pass


# ------------------------------------------------------------ alpha/depth

def heif_image_handle_has_alpha_channel(handle) -> bool:
    return handle.item.alpha_item is not None


def heif_image_handle_get_alpha_image_handle(handle
                                             ) -> Optional[
                                                 heif_image_handle]:
    a = handle.item.alpha_item
    return heif_image_handle(handle.ctx, a.item_id) if a else None


def heif_image_handle_has_depth_image(handle) -> bool:
    return handle.item.depth_item is not None


def heif_image_handle_get_depth_image_handle(handle
                                             ) -> Optional[
                                                 heif_image_handle]:
    d = handle.item.depth_item
    return heif_image_handle(handle.ctx, d.item_id) if d else None
