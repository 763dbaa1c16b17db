"""OMAF 360° API (ref: api/libheif/heif_omaf.h, 4 fns); counterpart of
libheif_tpu/api/omaf.py."""

from __future__ import annotations

from typing import Optional

from ..boxes.omaf import (Box_prfr, PROJECTION_EQUIRECTANGULAR,
                          PROJECTION_CUBEMAP)
from .image_handle import heif_image_handle

heif_projection_format_equirectangular = PROJECTION_EQUIRECTANGULAR
heif_projection_format_cubemap = PROJECTION_CUBEMAP


def heif_image_handle_has_projection(handle: heif_image_handle) -> bool:
    return handle.ctx.file.get_property(handle.item_id,
                                        Box_prfr) is not None


def heif_image_handle_get_projection_format(handle: heif_image_handle
                                            ) -> Optional[int]:
    p = handle.ctx.file.get_property(handle.item_id, Box_prfr)
    return p.projection_type if p is not None else None


def heif_item_add_projection_format(ctx, item_id: int,
                                    projection_type: int) -> int:
    return ctx.file.add_property(item_id, Box_prfr(projection_type),
                                 False)


def heif_image_handle_release_projection(handle, proj) -> None:
    pass


def heif_image_handle_get_omaf_image_projection(handle):
    """Projection format of the item, or None
    (ref: heif_omaf.h; Box_prfr omaf_boxes.h:33)."""
    from ..boxes.omaf import Box_prfr
    p = handle.ctx.file.get_property(handle.item_id, Box_prfr)
    return p.projection_type if p is not None else None


def heif_image_handle_set_omaf_image_projection(handle,
                                                projection_type: int
                                                ) -> int:
    from ..boxes.omaf import Box_prfr
    return handle.ctx.file.add_property(handle.item_id,
                                        Box_prfr(projection_type), True)


def heif_image_get_omaf_image_projection(img):
    """Projection carried on a decoded image (attached at decode from
    the item property)."""
    return getattr(img, "omaf_projection", None)


def heif_image_set_omaf_image_projection(img, projection_type) -> None:
    img.omaf_projection = projection_type
