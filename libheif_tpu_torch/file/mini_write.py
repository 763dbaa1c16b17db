"""Meta→mini conversion for the write path.

Counterpart of libheif_tpu/file/mini_write.py (reference:
libheif/mini.cc:1695 can_convert_to_mini, :1808 create_from_heif_file;
libheif/file.cc:257-285 mini write + ftyp adjustment).  When enabled and
the content fits the compact profile (a single av01/hvc1 primary, an
optional alpha aux item and Exif/XMP), the file is written as
``ftyp('mif3') + mini`` with no meta/mdat; other content is written in
the normal format.  The primary item's ``clli`` and ``mdcv`` go into the
mini box's HDR fields, as in the JAX writer.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..boxes.mini import Box_mini
from ..core.bitstream import ByteWriter
from ..core.error import HeifError

# EXIF orientation from (ccw rotation degrees, mirror axis or None)
# (ref: mini.cc orientation mapping; heif_orientation values)
_ORIENTATION = {
    (0, None): 1, (0, "vertical"): 2, (180, None): 3, (0, "horizontal"): 4,
    (270, "vertical"): 5, (270, None): 6, (90, "vertical"): 7, (90, None): 8,
}


def can_convert_to_mini(file) -> Tuple[bool, str]:
    """(ref: Box_mini::can_convert_to_mini mini.cc:1695)."""
    if file.meta is None:
        return False, "no meta box"
    try:
        primary_id = file.primary_item_id
    except HeifError:
        return False, "no primary item"
    item_type = file.get_item_type(primary_id)
    if item_type not in ("av01", "hvc1"):
        return False, "primary item type not supported for mini " \
                      "(need av01 or hvc1)"
    for prop in file.get_properties(primary_id):
        if prop.box_type == "ispe" and \
                (prop.width > 32768 or prop.height > 32768):
            return False, "dimensions exceed mini box limits"

    alpha_id = exif_id = xmp_id = 0
    for iid in file.item_ids:
        if iid == primary_id:
            continue
        it = file.get_item_type(iid)
        if it in ("grid", "iovl", "iden"):
            return False, "derived image items not supported in mini"
        refs = file.get_references_from(iid)
        ref_map = {r.ref_type: r.to_item_ids for r in refs}
        if "auxl" in ref_map and primary_id in ref_map["auxl"]:
            if alpha_id:
                return False, "multiple alpha items not supported in mini"
            alpha_id = iid
            continue
        if "cdsc" in ref_map and primary_id in ref_map["cdsc"]:
            if it == "Exif":
                if exif_id:
                    return False, "multiple EXIF items not supported"
                exif_id = iid
                continue
            if it == "mime":
                infe = file.get_infe(iid)
                if infe.content_type == "application/rdf+xml":
                    if xmp_id:
                        return False, "multiple XMP items not supported"
                    xmp_id = iid
                    continue
                return False, f"unsupported mime item for mini: " \
                              f"{infe.content_type}"
        infe = file.get_infe(iid)
        hidden = bool(getattr(infe, "flags", 0) & 1)
        if not hidden and it != item_type:
            return False, f"unsupported additional item type for mini: {it}"
    return True, ""


def build_mini_box(file) -> Optional[Box_mini]:
    """(ref: Box_mini::create_from_heif_file mini.cc:1808)."""
    ok, _reason = can_convert_to_mini(file)
    if not ok:
        return None
    primary_id = file.primary_item_id
    item_type = file.get_item_type(primary_id)

    mini = Box_mini()
    mini.explicit_codec_types_flag = False

    # --- properties of the primary item
    rotation_ccw = 0
    mirror = None
    config_box = None
    nclx = None
    icc = None
    pixi_depth = None
    for prop in file.get_properties(primary_id):
        bt = prop.box_type
        if bt == "ispe":
            mini.width, mini.height = prop.width, prop.height
        elif bt == "irot":
            rotation_ccw = (rotation_ccw + prop.angle) % 360
        elif bt == "imir":
            mirror = prop.direction
        elif bt in ("hvcC", "av1C"):
            config_box = prop
        elif bt == "pixi":
            if prop.bits_per_channel:
                pixi_depth = prop.bits_per_channel[0]
        elif bt == "colr":
            if prop.colour_type == "nclx":
                nclx = prop
            elif prop.colour_type in ("prof", "rICC"):
                icc = prop
        elif bt == "clli":
            mini.clli = {"max_cll": prop.max_content_light_level,
                         "max_pall": prop.max_pic_average_light_level}
        elif bt == "mdcv":
            mini.mdcv = {
                "primaries": list(prop.display_primaries),
                "white_point": prop.white_point,
                "max_lum": prop.max_display_mastering_luminance,
                "min_lum": prop.min_display_mastering_luminance}

    if mini.width == 0 or mini.height == 0 or config_box is None:
        return None

    mini.orientation = _ORIENTATION.get((rotation_ccw, mirror), 1)

    # --- chroma / depth from the codec config
    if item_type == "av01":
        if config_box.monochrome:
            mini.chroma_subsampling = 0
        elif config_box.chroma_subsampling_x and \
                config_box.chroma_subsampling_y:
            mini.chroma_subsampling = 1
        elif config_box.chroma_subsampling_x:
            mini.chroma_subsampling = 2
        else:
            mini.chroma_subsampling = 3
        mini.bit_depth = 12 if config_box.twelve_bit else \
            (10 if config_box.high_bitdepth else 8)
    else:
        mini.chroma_subsampling = {0: 0, 1: 1, 2: 2, 3: 3}.get(
            config_box.chroma_format, 1)
        mini.bit_depth = getattr(config_box, "bit_depth_luma", 8)
    if pixi_depth:
        mini.bit_depth = pixi_depth

    # --- color description
    if nclx is not None:
        mini.explicit_cicp_flag = True
        mini.colour_primaries = nclx.colour_primaries
        mini.transfer_characteristics = nclx.transfer_characteristics
        mini.matrix_coefficients = nclx.matrix_coefficients
        mini.full_range_flag = bool(nclx.full_range_flag)
    else:
        mini.full_range_flag = True
    if icc is not None:
        mini.icc_flag = True
        mini.icc_data = icc.icc_profile

    # --- codec config + item data
    w = ByteWriter()
    config_box.write_payload(w)
    mini.main_item_codec_config = w.data()
    mini.main_item_data = bytes(file.get_item_data(primary_id))

    # --- alpha / metadata companions
    for iid in file.item_ids:
        if iid == primary_id:
            continue
        refs = file.get_references_from(iid)
        ref_map = {r.ref_type: r.to_item_ids for r in refs}
        it = file.get_item_type(iid)
        if "auxl" in ref_map and primary_id in ref_map["auxl"]:
            mini.alpha_flag = True
            mini.alpha_item_data = bytes(file.get_item_data(iid))
            acfg = None
            for prop in file.get_properties(iid):
                if prop.box_type in ("hvcC", "av1C"):
                    acfg = prop
            if acfg is not None:
                aw = ByteWriter()
                acfg.write_payload(aw)
                mini.alpha_item_codec_config = aw.data()
            else:
                mini.alpha_item_codec_config = mini.main_item_codec_config
            for prop in file.get_properties(primary_id):
                if prop.box_type == "prem":
                    mini.alpha_is_premultiplied = True
        elif "cdsc" in ref_map and primary_id in ref_map["cdsc"]:
            if it == "Exif":
                mini.exif_flag = True
                mini.exif_data = bytes(file.get_item_data(iid))
            elif it == "mime":
                mini.xmp_flag = True
                mini.xmp_data = bytes(file.get_item_data(iid))

    mini.build_payload()
    return mini
