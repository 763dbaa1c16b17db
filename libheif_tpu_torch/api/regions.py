"""Region API (ref: api/libheif/heif_regions.h, 36 fns).

rgan region annotations: enumeration, geometry accessors (point, rect,
ellipse, polygon, polyline, masks), reference-to-image coordinate
transforms, and creation (ref: heif_regions.h → region.{h,cc});
counterpart of libheif_tpu/api/regions.py.  An inline mask is packed
from a mask image's plane on that plane's device (one host copy of the
packed bytes) and unpacked onto a device: the region's context's where
it carries one (``region.ctx``, which the caller sets, as in JAX), else
``device``, else the card.  A referenced mask decodes its ``mski`` item
through that context.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .._build import resolve_device
from ..core.error import HeifError
from ..image.pixel_image import _SIGNED_VIEW
from ..items.region_item import RegionItem, RegionGeometry
from .image_handle import heif_image_handle

heif_region_item = RegionItem
heif_region = RegionGeometry

# geometry type names used by RegionGeometry.kind
heif_region_type_point = "point"
heif_region_type_rectangle = "rect"
heif_region_type_ellipse = "ellipse"
heif_region_type_polygon = "polygon"
heif_region_type_polyline = "polyline"
heif_region_type_referenced_mask = "referenced_mask"
heif_region_type_inline_mask = "inline_mask"


# ------------------------------------------------------------ enumeration

def heif_image_handle_get_number_of_region_items(handle) -> int:
    return len(handle.ctx.get_region_items(handle.item_id))


def heif_image_handle_get_list_of_region_item_ids(handle) -> List[int]:
    return [ri.item_id for ri in
            handle.ctx.get_region_items(handle.item_id)]


def heif_context_get_region_item(ctx, region_item_id: int) -> RegionItem:
    data = ctx.file.get_item_data(region_item_id)
    return RegionItem.parse(region_item_id, data)


def heif_region_item_get_id(region_item: RegionItem) -> int:
    return region_item.item_id


def heif_region_item_release(region_item) -> None:
    pass


def heif_region_item_get_reference_size(region_item: RegionItem
                                        ) -> Tuple[int, int]:
    return region_item.reference_width, region_item.reference_height


def heif_region_item_get_number_of_regions(region_item: RegionItem) -> int:
    return len(region_item.regions)


def heif_region_item_get_list_of_regions(region_item: RegionItem
                                         ) -> List[RegionGeometry]:
    return list(region_item.regions)


def heif_region_release(region) -> None:
    pass


def heif_region_release_many(regions) -> None:
    pass


def heif_region_get_type(region: RegionGeometry) -> str:
    return region.kind


# ------------------------------------------------------------- accessors

def _require(region, kind):
    if region.kind != kind:
        raise HeifError.usage(msg=f"region is {region.kind}, not {kind}")


def heif_region_get_point(region) -> Tuple[int, int]:
    _require(region, "point")
    return region.x, region.y


def heif_region_get_rectangle(region) -> Tuple[int, int, int, int]:
    _require(region, "rect")
    return region.x, region.y, region.width, region.height


def heif_region_get_ellipse(region) -> Tuple[int, int, int, int]:
    _require(region, "ellipse")
    return region.x, region.y, region.radius_x, region.radius_y


def heif_region_get_polygon_num_points(region) -> int:
    _require(region, "polygon")
    return len(region.points)


def heif_region_get_polygon_points(region) -> List[Tuple[int, int]]:
    _require(region, "polygon")
    return list(region.points)


def heif_region_get_polyline_num_points(region) -> int:
    _require(region, "polyline")
    return len(region.points)


def heif_region_get_polyline_points(region) -> List[Tuple[int, int]]:
    _require(region, "polyline")
    return list(region.points)


def heif_region_get_referenced_mask_ID(region) -> Tuple[int, int, int,
                                                        int, int]:
    _require(region, "referenced_mask")
    return (region.x, region.y, region.width, region.height,
            getattr(region, "mask_item_id", 0))


def heif_region_get_inline_mask_data_len(region) -> int:
    _require(region, "inline_mask")
    return len(region.mask_data)


def heif_region_get_inline_mask_data(region) -> bytes:
    _require(region, "inline_mask")
    return region.mask_data


def heif_region_get_inline_mask(region) -> Tuple[int, int, int, int,
                                                 bytes]:
    _require(region, "inline_mask")
    return (region.x, region.y, region.width, region.height,
            region.mask_data)


# --------------------------------------- transformed (image-space) access

def _xform(region_item: RegionItem, region, handle) -> RegionGeometry:
    w, h = handle.item.width_height()
    return region_item.transform_to_image(region, w, h)


def heif_region_get_point_transformed(region, region_item, handle
                                      ) -> Tuple[int, int]:
    g = _xform(region_item, region, handle)
    return g.x, g.y


def heif_region_get_rectangle_transformed(region, region_item, handle
                                          ) -> Tuple[int, int, int, int]:
    g = _xform(region_item, region, handle)
    return g.x, g.y, g.width, g.height


def heif_region_get_ellipse_transformed(region, region_item, handle
                                        ) -> Tuple[int, int, int, int]:
    g = _xform(region_item, region, handle)
    return g.x, g.y, g.radius_x, g.radius_y


def heif_region_get_polygon_points_transformed(region, region_item,
                                               handle
                                               ) -> List[Tuple[int, int]]:
    g = _xform(region_item, region, handle)
    return list(g.points)


def heif_region_get_polyline_points_transformed(region, region_item,
                                                handle
                                                ) -> List[Tuple[int,
                                                                int]]:
    g = _xform(region_item, region, handle)
    return list(g.points)


# --------------------------------------------------------------- creation

def heif_image_handle_add_region_item(handle, reference_width: int,
                                      reference_height: int) -> RegionItem:
    """(ref: heif_image_handle_add_region_item)."""
    return handle.ctx.add_region_item(handle.item_id, reference_width,
                                      reference_height)


def _add(region_item: RegionItem, kind: str, **kw) -> RegionGeometry:
    g = RegionGeometry(kind=kind, **kw)
    region_item.regions.append(g)
    return g


def heif_region_item_add_region_point(region_item, x: int, y: int):
    return _add(region_item, "point", x=x, y=y)


def heif_region_item_add_region_rectangle(region_item, x: int, y: int,
                                          width: int, height: int):
    return _add(region_item, "rect", x=x, y=y, width=width,
                height=height)


def heif_region_item_add_region_ellipse(region_item, cx: int, cy: int,
                                        radius_x: int, radius_y: int):
    return _add(region_item, "ellipse", x=cx, y=cy, radius_x=radius_x,
                radius_y=radius_y)


def heif_region_item_add_region_polygon(region_item,
                                        points: List[Tuple[int, int]]):
    return _add(region_item, "polygon", points=list(points))


def heif_region_item_add_region_polyline(region_item,
                                         points: List[Tuple[int, int]]):
    return _add(region_item, "polyline", points=list(points))


def heif_region_item_add_region_inline_mask_data(region_item, x: int,
                                                 y: int, width: int,
                                                 height: int,
                                                 mask_data: bytes):
    g = _add(region_item, "inline_mask", x=x, y=y, width=width,
             height=height)
    g.mask_data = bytes(mask_data)
    return g


def heif_region_item_add_region_referenced_mask(region_item, x: int,
                                                y: int, width: int,
                                                height: int,
                                                mask_item_id: int):
    g = _add(region_item, "referenced_mask", x=x, y=y, width=width,
             height=height)
    g.mask_item_id = mask_item_id
    return g


def heif_region_item_add_region_inline_mask(region_item, x: int, y: int,
                                            width: int, height: int,
                                            mask_image):
    """Pack a Y-plane image into a 1-bpp inline mask region: the high
    bit of each sample is the mask bit (ref: heif_regions.cc:695),
    packed MSB first as np.packbits does, on the plane's device; the
    packed bytes come to the host in one copy."""
    from ..image.pixel_image import Channel
    pl = mask_image.plane(Channel.Y)
    mh, mw = pl.shape
    cw, ch = min(width, mw), min(height, mh)
    n = width * height
    bits = torch.zeros(-(-n // 8) * 8, dtype=torch.uint8, device=pl.device)
    src = pl[:ch, :cw]
    if src.dtype in _SIGNED_VIEW:
        # CUDA builds of torch lack the wide unsigned types' bit operations
        src = src.view(_SIGNED_VIEW[src.dtype])
    bits[:n].view(height, width)[:ch, :cw] = ((src & 0x80) >> 7).to(
        torch.uint8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=pl.device)
    packed = (bits.view(-1, 8) * weights).sum(1, dtype=torch.uint8)
    data = packed.cpu().numpy().tobytes()
    return heif_region_item_add_region_inline_mask_data(
        region_item, x, y, width, height, data)


def heif_region_get_mask_image(region, device=None):
    """Mask region → monochrome image: inline masks unpack the 1-bpp
    payload (0 → 0, 1 → 255) on the device of the region's context
    (``region.ctx``), else ``device``, else the card; referenced masks
    decode the mski item (ref: heif_regions.cc:476).  Returns (x, y,
    width, height, image).
    """
    from ..image.pixel_image import (PixelImage, Channel, Colorspace,
                                     Chroma)
    t = heif_region_get_type(region)
    if t == "inline_mask":
        x, y, w, h, data = heif_region_get_inline_mask(region)
        ctx = getattr(region, "ctx", None)
        dev = resolve_device(ctx.device if ctx is not None else device)
        packed = torch.from_numpy(np.frombuffer(data, np.uint8).copy()) \
            .to(dev)
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
        bits = ((packed[:, None] >> shifts) & 1).reshape(-1)
        if bits.numel() < w * h:        # np.unpackbits pads with zeros
            bits = torch.nn.functional.pad(bits, (0, w * h - bits.numel()))
        img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome,
                         device=dev)
        img.set_plane(Channel.Y, (bits[:w * h] * 255).view(h, w), 8)
        return x, y, w, h, img
    if t == "referenced_mask":
        x, y, w, h, item_id = heif_region_get_referenced_mask_ID(region)
        ctx = getattr(region, "ctx", None) or \
            getattr(region_item_context(region), "ctx", None)
        img = ctx.decode_image(item_id)
        return x, y, w, h, img
    raise HeifError.usage(msg="region is not a mask region")


def region_item_context(region):
    return getattr(region, "item", None)
