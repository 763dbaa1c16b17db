"""Item-property API (ref: api/libheif/heif_properties.h, 41 fns).

Raw/typed property query and creation over the ipco/ipma tables
(ref: heif_properties.h over HeifFile property storage, file.h:168-216),
and the sensor descriptions a decoded image carries (Bayer pattern,
chroma location, polarization, bad pixels, NUC: host values beside its
planes, on the port's PixelImage as on the JAX one); counterpart of
libheif_tpu/api/properties.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..boxes.box import Box
from ..boxes.meta import (Box_irot, Box_imir, Box_clap, Box_udes,
                          Box_clli, Box_mdcv, Box_pasp)
from ..core.error import HeifError
from ..core.fraction import Fraction

# property "types" follow the box fourcc, as in the reference
heif_item_property_type_invalid = ""
heif_item_property_type_user_description = "udes"
heif_item_property_type_transform_mirror = "imir"
heif_item_property_type_transform_rotation = "irot"
heif_item_property_type_clean_aperture = "clap"
heif_item_property_type_pixel_aspect_ratio = "pasp"
heif_item_property_type_content_light_level = "clli"
heif_item_property_type_mastering_display = "mdcv"


def _props(ctx, item_id: int) -> List[Box]:
    return ctx.file.get_properties(item_id)


def heif_item_get_properties_of_type(ctx, item_id: int,
                                     prop_type: Optional[str] = None
                                     ) -> List[int]:
    """Returns 1-based property indices (the C API's property ids)."""
    out = []
    for i, p in enumerate(_props(ctx, item_id)):
        if prop_type is None or p.box_type == prop_type:
            out.append(i + 1)
    return out


def heif_item_get_transformation_properties(ctx, item_id: int
                                            ) -> List[int]:
    return [i + 1 for i, p in enumerate(_props(ctx, item_id))
            if p.box_type in ("irot", "imir", "clap")]


def heif_item_get_property_type(ctx, item_id: int,
                                property_id: int) -> str:
    props = _props(ctx, item_id)
    if not 1 <= property_id <= len(props):
        raise HeifError.usage(msg=f"bad property id {property_id}")
    return props[property_id - 1].box_type


def _prop_by_id(ctx, item_id: int, property_id: int) -> Box:
    props = _props(ctx, item_id)
    if not 1 <= property_id <= len(props):
        raise HeifError.usage(msg=f"bad property id {property_id}")
    return props[property_id - 1]


def heif_item_get_property_raw_size(ctx, item_id: int,
                                    property_id: int) -> int:
    return len(heif_item_get_property_raw_data(ctx, item_id, property_id))


def heif_item_get_property_raw_data(ctx, item_id: int,
                                    property_id: int) -> bytes:
    """Payload bytes of the property box, without the box header."""
    from ..core.bitstream import ByteWriter
    p = _prop_by_id(ctx, item_id, property_id)
    w = ByteWriter()
    p.write(w)
    blob = w.data()
    # strip the box header (size32 + type; + 16 more for uuid)
    hdr = 8 if p.box_type != "uuid" else 24
    if len(blob) >= 4 and int.from_bytes(blob[:4], "big") == 1:
        hdr += 8
    return blob[hdr:]


def heif_item_get_property_uuid_type(ctx, item_id: int,
                                     property_id: int) -> Optional[bytes]:
    p = _prop_by_id(ctx, item_id, property_id)
    return getattr(p, "uuid_type", None)


def heif_item_add_raw_property(ctx, item_id: int, fourcc: str,
                               uuid_type: Optional[bytes], data: bytes,
                               is_essential: bool) -> int:
    from ..boxes.box import Box_other
    b = Box_other(fourcc)
    b.payload = bytes(data)
    if uuid_type is not None:
        b.uuid_type = uuid_type
    return ctx.file.add_property(item_id, b, is_essential)


# ------------------------------------------------------- transformations

def heif_item_get_property_transform_rotation_ccw(ctx, item_id: int,
                                                  property_id: int) -> int:
    p = _prop_by_id(ctx, item_id, property_id)
    if not isinstance(p, Box_irot):
        raise HeifError.usage(msg="property is not irot")
    return p.angle


def heif_item_get_property_transform_mirror(ctx, item_id: int,
                                            property_id: int) -> str:
    p = _prop_by_id(ctx, item_id, property_id)
    if not isinstance(p, Box_imir):
        raise HeifError.usage(msg="property is not imir")
    return p.direction


def heif_item_get_property_transform_crop_borders(
        ctx, item_id: int, property_id: int, image_width: int,
        image_height: int) -> Tuple[int, int, int, int]:
    """Returns (left, top, right, bottom) crop amounts (ref:
    heif_properties.h transform_crop_borders)."""
    p = _prop_by_id(ctx, item_id, property_id)
    if not isinstance(p, Box_clap):
        raise HeifError.usage(msg="property is not clap")
    left = p.left(image_width)
    top = p.top(image_height)
    w = p.width_rounded()
    h = p.height_rounded()
    return left, top, image_width - left - w, image_height - top - h


# ------------------------------------------------------ user description

class heif_property_user_description:
    """(ref: heif_property_user_description struct)."""

    def __init__(self, lang="", name="", description="", tags=""):
        self.lang = lang
        self.name = name
        self.description = description
        self.tags = tags


def heif_item_get_property_user_description(ctx, item_id: int,
                                            property_id: int
                                            ) -> heif_property_user_description:
    p = _prop_by_id(ctx, item_id, property_id)
    if not isinstance(p, Box_udes):
        raise HeifError.usage(msg="property is not udes")
    return heif_property_user_description(
        lang=p.lang, name=p.name, description=p.description,
        tags=getattr(p, "tags", ""))


def heif_item_add_property_user_description(ctx, item_id: int,
                                            description) -> int:
    b = Box_udes(lang=description.lang, name=description.name,
                 description=description.description)
    b.tags = getattr(description, "tags", "")
    return ctx.file.add_property(item_id, b, False)


def heif_property_user_description_release(desc) -> None:
    pass


# ------------------------------------------------------ typed additions

def heif_item_add_transform_property_rotation(ctx, item_id: int,
                                              ccw_angle: int) -> int:
    return ctx.file.add_property(item_id, Box_irot(ccw_angle), True)


def heif_item_add_transform_property_mirror(ctx, item_id: int,
                                            axis: str) -> int:
    return ctx.file.add_property(item_id, Box_imir(axis), True)


def heif_item_add_transform_property_crop(ctx, item_id: int,
                                          left: int, top: int,
                                          right: int, bottom: int,
                                          image_width: int,
                                          image_height: int) -> int:
    w = image_width - left - right
    h = image_height - top - bottom
    clap = Box_clap(Fraction(w, 1), Fraction(h, 1),
                    Fraction(2 * left + w - image_width, 2),
                    Fraction(2 * top + h - image_height, 2))
    return ctx.file.add_property(item_id, clap, True)


def heif_item_add_property_content_light_level(ctx, item_id: int,
                                               max_cll: int,
                                               max_pall: int) -> int:
    return ctx.file.add_property(item_id, Box_clli(max_cll, max_pall),
                                 False)


def heif_item_get_property_content_light_level(ctx, item_id: int):
    p = ctx.file.get_property(item_id, Box_clli)
    return p


def heif_item_add_property_mastering_display(ctx, item_id: int,
                                             mdcv: Box_mdcv) -> int:
    return ctx.file.add_property(item_id, mdcv, False)


def heif_item_get_property_mastering_display(ctx, item_id: int):
    return ctx.file.get_property(item_id, Box_mdcv)


def heif_item_add_property_pixel_aspect_ratio(ctx, item_id: int,
                                              h_spacing: int,
                                              v_spacing: int) -> int:
    return ctx.file.add_property(item_id,
                                 Box_pasp(h_spacing, v_spacing), False)


def heif_item_get_property_pixel_aspect_ratio(ctx, item_id: int
                                              ) -> Optional[Tuple[int,
                                                                  int]]:
    p = ctx.file.get_property(item_id, Box_pasp)
    return (p.h_spacing, p.v_spacing) if p else None


# ---------------------------------------------------------------------------
# Camera intrinsic/extrinsic matrices on image handles (ref:
# heif_properties.h heif_image_handle_*_camera_* over Box_cmin/Box_cmex)
# ---------------------------------------------------------------------------

from ..boxes.meta import Box_cmin, Box_cmex


def _handle_prop(handle, box_cls):
    for p in handle.ctx.file.get_properties(handle.item_id):
        if isinstance(p, box_cls):
            return p
    return None


def heif_image_handle_has_camera_intrinsic_matrix(handle) -> bool:
    return _handle_prop(handle, Box_cmin) is not None


def heif_image_handle_get_camera_intrinsic_matrix(handle):
    from .experimental import _decode_cmin
    box = _handle_prop(handle, Box_cmin)
    if box is None:
        raise HeifError.usage(msg="no camera intrinsic matrix")
    return _decode_cmin(box)


def heif_image_handle_has_camera_extrinsic_matrix(handle) -> bool:
    return _handle_prop(handle, Box_cmex) is not None


def heif_image_handle_get_camera_extrinsic_matrix(handle):
    from .experimental import _decode_cmex
    box = _handle_prop(handle, Box_cmex)
    if box is None:
        raise HeifError.usage(msg="no camera extrinsic matrix")
    return _decode_cmex(box)


def heif_camera_extrinsic_matrix_get_rotation_matrix(matrix):
    """3x3 rotation from the extrinsic orientation (ref:
    heif_properties.cc rotation-matrix derivation from the unit
    quaternion)."""
    import math
    qx, qy, qz = matrix.quaternion_xyz
    sq = qx * qx + qy * qy + qz * qz
    qw = math.sqrt(max(0.0, 1.0 - sq))
    return [
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
        2 * (qx * qz + qy * qw),
        2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - qx * qw),
        2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
        1 - 2 * (qx * qx + qy * qy),
    ]


def heif_camera_extrinsic_matrix_release(matrix) -> None:
    pass


# ---------------------------------------------------------------------------
# Sensor/image description properties on decoded images (ref:
# heif_properties.h bayer/chroma-location/polarization/bad-pixels/NUC
# families over the unci description boxes cpat/cloc/splz/sbpm/snuc)
# ---------------------------------------------------------------------------

def _img_desc(img):
    from ..image.image_description import ImageDescription
    if not hasattr(img, "_sensor_desc"):
        img._sensor_desc = ImageDescription()
    d = img._sensor_desc
    for attr, init in (("bayer_pattern", None),
                       ("polarization_patterns", []),
                       ("sensor_bad_pixels_maps", []),
                       ("sensor_nucs", []),
                       ("chroma_location", None)):
        if not hasattr(d, attr):
            setattr(d, attr, list(init) if isinstance(init, list) else init)
    return d


def heif_image_set_bayer_pattern(img, pattern) -> None:
    """pattern: Box_cpat or anything with pattern_width/height +
    components (+ gains)."""
    _img_desc(img).bayer_pattern = pattern


def heif_image_get_bayer_pattern(img):
    return _img_desc(img).bayer_pattern


def heif_image_get_bayer_pattern_size(img):
    p = _img_desc(img).bayer_pattern
    return (p.pattern_width, p.pattern_height) if p else (0, 0)


def heif_image_has_chroma_location(img) -> bool:
    return _img_desc(img).chroma_location is not None


def heif_image_get_chroma_location(img) -> int:
    loc = _img_desc(img).chroma_location
    return 0 if loc is None else loc


def heif_image_set_chroma_location(img, loc: int) -> None:
    if not 0 <= loc <= 6:
        raise HeifError.usage(msg="chroma location must be 0..6")
    _img_desc(img).chroma_location = loc


def heif_polarization_angle_no_filter() -> float:
    import struct
    return struct.unpack(">f", b"\xff\xff\xff\xff")[0]


def heif_polarization_angle_is_no_filter(angle: float) -> bool:
    import math
    return math.isnan(angle)


def heif_image_add_polarization_pattern(img, pattern) -> None:
    """pattern: Box_splz or object with component_ids,
    pattern_width/height, polarization_angles."""
    _img_desc(img).polarization_patterns.append(pattern)


def heif_image_get_number_of_polarization_patterns(img) -> int:
    return len(_img_desc(img).polarization_patterns)


def heif_image_get_polarization_pattern_info(img, idx: int):
    return _img_desc(img).polarization_patterns[idx]


def heif_image_get_polarization_pattern_data(img, idx: int):
    return list(_img_desc(img).polarization_patterns[idx]
                .polarization_angles)


def heif_image_get_polarization_pattern_index_for_component(
        img, component_id: int) -> int:
    for i, p in enumerate(_img_desc(img).polarization_patterns):
        if not p.component_ids or component_id in p.component_ids:
            return i
    return -1


def heif_image_add_sensor_bad_pixels_map(img, bpm) -> None:
    _img_desc(img).sensor_bad_pixels_maps.append(bpm)


def heif_image_get_number_of_sensor_bad_pixels_maps(img) -> int:
    return len(_img_desc(img).sensor_bad_pixels_maps)


def heif_image_get_sensor_bad_pixels_map_info(img, idx: int):
    return _img_desc(img).sensor_bad_pixels_maps[idx]


def heif_image_get_sensor_bad_pixels_map_data(img, idx: int):
    m = _img_desc(img).sensor_bad_pixels_maps[idx]
    return (list(m.bad_rows), list(m.bad_columns),
            [(p.row, p.column) for p in m.bad_pixels])


def heif_image_add_sensor_nuc(img, nuc) -> None:
    _img_desc(img).sensor_nucs.append(nuc)


def heif_image_get_number_of_sensor_nucs(img) -> int:
    return len(_img_desc(img).sensor_nucs)


def heif_image_get_sensor_nuc_info(img, idx: int):
    return _img_desc(img).sensor_nucs[idx]


def heif_image_get_sensor_nuc_data(img, idx: int):
    n = _img_desc(img).sensor_nucs[idx]
    return (list(n.nuc_gains), list(n.nuc_offsets))


def heif_image_add_bayer_component(img, component_type: str) -> int:
    """Mint a filter-array component of the given cmpd type (ref:
    heif_properties.h:239); returns the new component id."""
    from .components import _components, _Component
    comps = _components(img)
    cid = max(comps, default=-1) + 1
    comps[cid] = _Component(cid, component_type)
    return cid
