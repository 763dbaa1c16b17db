"""Experimental API (ref: api/libheif/heif_experimental.h, 18 fns).

Dynamically-tiled (tili) images and multi-resolution pyramid groups
(ref: heif_experimental.h:120-146 tiled params, :153+ pyramids →
tiled.cc, Box_pymd box.h:1217) and the camera intrinsic/extrinsic
matrix properties (Box_cmin, Box_cmex); counterpart of
libheif_tpu/api/experimental.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..boxes.meta import Box_pymd, PymdLayerInfo
from .image_handle import heif_image_handle
from .tiling import heif_context_add_tiled_image  # noqa: F401 re-export


@dataclass
class heif_tiled_image_parameters:
    """(ref: heif_tiled_image_parameters heif_experimental.h:120)."""

    version: int = 1
    image_width: int = 0
    image_height: int = 0
    tile_width: int = 0
    tile_height: int = 0
    compression_format_fourcc: str = "unci"
    offset_field_length: int = 40
    size_field_length: int = 24
    number_of_extra_dimensions: int = 0
    extra_dimensions: List[int] = field(default_factory=list)
    tiles_are_sequential: bool = False


def heif_tiled_image_parameters_alloc() -> heif_tiled_image_parameters:
    return heif_tiled_image_parameters()


def heif_tiled_image_parameters_release(params) -> None:
    pass


@dataclass
class heif_pyramid_layer_info:
    """(ref: heif_pyramid_layer_info heif_experimental.h:155)."""

    layer_image_id: int = 0
    layer_binning: int = 1
    tile_rows_in_layer: int = 0
    tile_columns_in_layer: int = 0


def heif_context_add_pyramid_entity_group(ctx,
                                          layer_item_ids: List[int]
                                          ) -> int:
    """Group multi-resolution layers into a 'pymd' entity group
    (ref: heif_context_add_pyramid_entity_group, context.h:179).
    Layers must be ordered from smallest to largest resolution."""
    f = ctx.file
    if f.grpl is None:
        from ..boxes.meta import Box_grpl
        f.grpl = Box_grpl()
        f.meta.children.append(f.grpl)
    pymd = Box_pymd()
    pymd.group_id = f.next_group_id() if hasattr(f, "next_group_id") \
        else max([getattr(g, "group_id", 0)
                  for g in f.grpl.children] + [max(f.item_ids or [0])]) + 1
    pymd.entity_ids = list(layer_item_ids)
    largest = ctx.get_item(layer_item_ids[-1])
    lw, lh = largest.width_height()
    tiling = None
    try:
        tiling = ctx.get_image_tiling(layer_item_ids[-1])
    except Exception:  # noqa: BLE001  non-tiled layers are allowed
        pass
    pymd.tile_size_x = tiling.tile_width if tiling else lw
    pymd.tile_size_y = tiling.tile_height if tiling else lh
    for iid in layer_item_ids:
        item = ctx.get_item(iid)
        w, h = item.width_height()
        info = PymdLayerInfo()
        info.layer_binning = max(1, lw // max(w, 1))
        try:
            t = ctx.get_image_tiling(iid)
            info.tiles_in_layer_row_minus1 = max(0, t.num_rows - 1)
            info.tiles_in_layer_column_minus1 = max(0, t.num_columns - 1)
        except Exception:  # noqa: BLE001
            info.tiles_in_layer_row_minus1 = 0
            info.tiles_in_layer_column_minus1 = 0
        pymd.layer_infos.append(info)
    f.grpl.children.append(pymd)
    return pymd.group_id


def heif_context_get_pyramid_entity_group_info(ctx, group_id: int
                                               ) -> List[
                                                   heif_pyramid_layer_info]:
    """(ref: heif_context_get_pyramid_entity_group_info)."""
    f = ctx.file
    if f.grpl is None:
        return []
    for g in f.grpl.children:
        if getattr(g, "group_id", None) == group_id and \
                g.box_type == "pymd":
            out = []
            for iid, info in zip(g.entity_ids, g.layer_infos):
                out.append(heif_pyramid_layer_info(
                    layer_image_id=iid,
                    layer_binning=info.layer_binning,
                    tile_rows_in_layer=info.tiles_in_layer_row_minus1 + 1,
                    tile_columns_in_layer=(
                        info.tiles_in_layer_column_minus1 + 1)))
            return out
    return []


def heif_pyramid_layer_info_release(infos) -> None:
    pass


# ---------------------------------------------------------------------------
# Camera intrinsic/extrinsic matrix properties (ref: heif_experimental.h
# heif_property_camera_* over Box_cmin / Box_cmex)
# ---------------------------------------------------------------------------

from ..boxes.meta import Box_cmin, Box_cmex
from ..core.error import HeifError


class heif_camera_intrinsic_matrix:
    """Decoded intrinsic matrix (floats; ref: heif_experimental.h:214)."""

    def __init__(self):
        self.focal_length_x = 0.0
        self.focal_length_y = 0.0
        self.principal_point_x = 0.0
        self.principal_point_y = 0.0
        self.skew = 0.0


class heif_camera_extrinsic_matrix:
    """Decoded extrinsic matrix (ref: heif_experimental.h:260)."""

    def __init__(self):
        self.position = (0.0, 0.0, 0.0)        # micrometers
        self.quaternion_xyz = (0.0, 0.0, 0.0)  # unit quaternion x,y,z
        self.world_coordinate_system_id = 0


def _decode_cmin(box: Box_cmin) -> heif_camera_intrinsic_matrix:
    m = heif_camera_intrinsic_matrix()
    den = 1 << box.denominator_shift
    sden = 1 << box.skew_denominator_shift
    m.focal_length_x = box.focal_length_x / den
    m.principal_point_x = box.principal_point_x / den
    m.principal_point_y = box.principal_point_y / den
    if box.flags & 1:
        m.focal_length_y = box.focal_length_y / den
        m.skew = box.skew / sden
    else:
        m.focal_length_y = m.focal_length_x
        m.skew = 0.0
    return m


def _decode_cmex(box: Box_cmex) -> heif_camera_extrinsic_matrix:
    m = heif_camera_extrinsic_matrix()
    m.position = (box.pos_x, box.pos_y, box.pos_z)
    if box.version == 0:
        scale = 1 << (31 if box.flags & Box_cmex.FLAG_ROT_32BIT else 14)
        m.quaternion_xyz = tuple(q / scale for q in box.quat)
    else:
        import math
        # v1 yaw/pitch/roll in 16.16 degrees -> quaternion
        yaw, pitch, roll = (v / 65536.0 * math.pi / 180.0
                            for v in box.rotation)
        cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
        cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
        cr, sr = math.cos(roll / 2), math.sin(roll / 2)
        m.quaternion_xyz = (sr * cp * cy - cr * sp * sy,
                            cr * sp * cy + sr * cp * sy,
                            cr * cp * sy - sr * sp * cy)
    m.world_coordinate_system_id = box.world_coordinate_system_id
    return m


def heif_property_camera_intrinsic_matrix_alloc():
    return heif_camera_intrinsic_matrix()


def heif_property_camera_intrinsic_matrix_release(matrix) -> None:
    pass


def heif_property_camera_intrinsic_matrix_set_simple(
        matrix, image_width: int, image_height: int,
        focal_length: float, principal_point_x: float,
        principal_point_y: float) -> None:
    matrix.focal_length_x = matrix.focal_length_y = focal_length
    matrix.principal_point_x = principal_point_x
    matrix.principal_point_y = principal_point_y
    matrix.skew = 0.0


def heif_property_camera_intrinsic_matrix_set_full(
        matrix, focal_length_x: float, focal_length_y: float,
        principal_point_x: float, principal_point_y: float,
        skew: float) -> None:
    matrix.focal_length_x = focal_length_x
    matrix.focal_length_y = focal_length_y
    matrix.principal_point_x = principal_point_x
    matrix.principal_point_y = principal_point_y
    matrix.skew = skew


def heif_property_camera_intrinsic_matrix_get_focal_length(
        matrix, image_width: int = 0):
    return (matrix.focal_length_x, matrix.focal_length_y)


def heif_property_camera_intrinsic_matrix_get_principal_point(
        matrix, image_width: int = 0, image_height: int = 0):
    return (matrix.principal_point_x, matrix.principal_point_y)


def heif_property_camera_intrinsic_matrix_get_skew(matrix) -> float:
    return matrix.skew


def heif_item_add_property_camera_intrinsic_matrix(ctx, item_id: int,
                                                   matrix) -> int:
    box = Box_cmin()
    shift = 16
    box.flags = 1 | (shift << 8) | (shift << 16)
    den = 1 << shift
    box.focal_length_x = int(round(matrix.focal_length_x * den))
    box.focal_length_y = int(round(matrix.focal_length_y * den))
    box.principal_point_x = int(round(matrix.principal_point_x * den))
    box.principal_point_y = int(round(matrix.principal_point_y * den))
    box.skew = int(round(matrix.skew * den))
    return ctx.file.add_property(item_id, box, essential=False)


def heif_item_get_property_camera_intrinsic_matrix(ctx, item_id: int,
                                                   property_id: int = 0):
    for p in ctx.file.get_properties(item_id):
        if isinstance(p, Box_cmin):
            return _decode_cmin(p)
    raise HeifError.usage(msg="no camera intrinsic matrix property")


def heif_item_get_property_camera_extrinsic_matrix(ctx, item_id: int,
                                                   property_id: int = 0):
    for p in ctx.file.get_properties(item_id):
        if isinstance(p, Box_cmex):
            return _decode_cmex(p)
    raise HeifError.usage(msg="no camera extrinsic matrix property")


def heif_property_camera_extrinsic_matrix_get_position_vector(matrix):
    return matrix.position


def heif_property_camera_extrinsic_matrix_get_rotation_matrix(matrix):
    from .properties import heif_camera_extrinsic_matrix_get_rotation_matrix
    return heif_camera_extrinsic_matrix_get_rotation_matrix(matrix)


def heif_property_camera_extrinsic_matrix_get_world_coordinate_system_id(
        matrix) -> int:
    return matrix.world_coordinate_system_id


def heif_property_camera_extrinsic_matrix_release(matrix) -> None:
    pass
