"""Color API (ref: api/libheif/heif_color.h, 45 fns); counterpart of
libheif_tpu/api/color.py.

nclx (CICP) profile construction/inspection, raw ICC passthrough, and
handle-level profile access (ref: heif_color.h → nclx.cc, Box_colr).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

from ..boxes.meta import Box_amve, Box_clli, Box_colr, Box_mdcv, Box_ndwt
from ..color.nclx import NclxProfile, get_kr_kb
from ..color.ops import ColorConversionOptions
from ..core.error import HeifError
from .image_handle import heif_image_handle

heif_color_profile_nclx = NclxProfile

# CICP enums (H.273); values are the standard code points the reference
# exposes as heif_color_primaries / transfer / matrix enums.
heif_color_primaries_ITU_R_BT_709_5 = 1
heif_color_primaries_unspecified = 2
heif_color_primaries_ITU_R_BT_470_6_System_M = 4
heif_color_primaries_ITU_R_BT_470_6_System_B_G = 5
heif_color_primaries_ITU_R_BT_601_6 = 6
heif_color_primaries_SMPTE_240M = 7
heif_color_primaries_generic_film = 8
heif_color_primaries_ITU_R_BT_2020_2_and_2100_0 = 9
heif_color_primaries_SMPTE_ST_428_1 = 10
heif_color_primaries_SMPTE_RP_431_2 = 11
heif_color_primaries_SMPTE_EG_432_1 = 12
heif_color_primaries_EBU_Tech_3213_E = 22

heif_transfer_characteristic_ITU_R_BT_709_5 = 1
heif_transfer_characteristic_unspecified = 2
heif_transfer_characteristic_ITU_R_BT_601_6 = 6
heif_transfer_characteristic_SMPTE_ST_2084 = 16
heif_transfer_characteristic_ITU_R_BT_2100_0_HLG = 18
heif_transfer_characteristic_linear = 8

heif_matrix_coefficients_RGB_GBR = 0
heif_matrix_coefficients_ITU_R_BT_709_5 = 1
heif_matrix_coefficients_unspecified = 2
heif_matrix_coefficients_ITU_R_BT_601_6 = 6
heif_matrix_coefficients_SMPTE_240M = 7
heif_matrix_coefficients_ITU_R_BT_2020_2_non_constant_luminance = 9
heif_matrix_coefficients_ITU_R_BT_2020_2_constant_luminance = 10
heif_matrix_coefficients_ICtCp = 14


def heif_nclx_color_profile_alloc() -> NclxProfile:
    """(ref: heif_nclx_color_profile_alloc — defaults sRGB-ish)."""
    return NclxProfile()


def heif_nclx_color_profile_free(profile) -> None:
    pass


def heif_nclx_color_profile_set_color_primaries(profile: NclxProfile,
                                                cp: int) -> None:
    profile.color_primaries = int(cp)


def heif_nclx_color_profile_set_transfer_characteristics(
        profile: NclxProfile, tc: int) -> None:
    profile.transfer_characteristics = int(tc)


def heif_nclx_color_profile_set_matrix_coefficients(profile: NclxProfile,
                                                    mc: int) -> None:
    profile.matrix_coefficients = int(mc)


def heif_nclx_color_profile_get_kr_kb(profile: NclxProfile
                                      ) -> Tuple[float, float]:
    """Kr/Kb derivation incl. from primaries (ref: nclx.cc:45,84)."""
    return get_kr_kb(profile.matrix_coefficients,
                     profile.color_primaries)


# ---------------------------------------------------- handle-level access

def _colr(handle: heif_image_handle, want: str) -> Optional[Box_colr]:
    for p in handle.ctx.file.get_properties(handle.item_id):
        if isinstance(p, Box_colr):
            if want == "nclx" and p.colour_type == "nclx":
                return p
            if want == "icc" and p.colour_type in ("prof", "rICC"):
                return p
    return None


def heif_image_handle_get_color_profile_type(handle) -> Optional[str]:
    """Returns 'nclx', 'prof', 'rICC' or None (ref: heif_color.h)."""
    icc = _colr(handle, "icc")
    if icc is not None:
        return icc.colour_type
    if _colr(handle, "nclx") is not None:
        return "nclx"
    return None


def heif_image_handle_get_raw_color_profile_size(handle) -> int:
    p = _colr(handle, "icc")
    return len(p.icc_profile) if p is not None else 0


def heif_image_handle_get_raw_color_profile(handle) -> Optional[bytes]:
    p = _colr(handle, "icc")
    return p.icc_profile if p is not None else None


def heif_image_handle_get_nclx_color_profile(handle
                                             ) -> Optional[NclxProfile]:
    p = _colr(handle, "nclx")
    return NclxProfile.from_colr_box(p) if p is not None else None


def heif_image_handle_get_number_of_color_profiles(handle) -> int:
    n = 0
    if _colr(handle, "icc") is not None:
        n += 1
    if _colr(handle, "nclx") is not None:
        n += 1
    return n


# ---------------------------------------------------------------------------
# HDR metadata on images and handles (ref: heif_color.h clli/mdcv/amve/
# ndwt accessor families) and color-conversion options
# ---------------------------------------------------------------------------

def _hdr_prop(handle, box_cls):
    for p in handle.ctx.file.get_properties(handle.item_id):
        if isinstance(p, box_cls):
            return p
    return None


def heif_image_handle_has_content_light_level(handle) -> bool:
    return _hdr_prop(handle, Box_clli) is not None


def heif_image_handle_get_content_light_level(handle):
    return _hdr_prop(handle, Box_clli)


def heif_image_handle_set_content_light_level(handle, clli) -> None:
    handle.ctx.file.add_property(handle.item_id, clli, essential=False)


def heif_image_handle_has_mastering_display_colour_volume(handle) -> bool:
    return _hdr_prop(handle, Box_mdcv) is not None


def heif_image_handle_get_mastering_display_colour_volume(handle):
    return _hdr_prop(handle, Box_mdcv)


def heif_image_handle_set_mastering_display_colour_volume(handle,
                                                          mdcv) -> None:
    handle.ctx.file.add_property(handle.item_id, mdcv, essential=False)


def heif_image_handle_has_ambient_viewing_environment(handle) -> bool:
    return _hdr_prop(handle, Box_amve) is not None


def heif_image_handle_get_ambient_viewing_environment(handle):
    return _hdr_prop(handle, Box_amve)


def heif_image_handle_set_ambient_viewing_environment(handle,
                                                      amve) -> None:
    handle.ctx.file.add_property(handle.item_id, amve, essential=False)


def heif_image_handle_has_nominal_diffuse_white_luminance(handle) -> bool:
    return _hdr_prop(handle, Box_ndwt) is not None


def heif_image_handle_get_nominal_diffuse_white_luminance(handle) -> int:
    p = _hdr_prop(handle, Box_ndwt)
    return p.diffuse_white_luminance if p else 0


def heif_image_handle_set_nominal_diffuse_white_luminance(
        handle, luminance: int) -> None:
    handle.ctx.file.add_property(handle.item_id, Box_ndwt(luminance),
                                 essential=False)


def heif_image_has_ambient_viewing_environment(img) -> bool:
    return getattr(img, "amve", None) is not None


def heif_image_get_ambient_viewing_environment(img):
    return getattr(img, "amve", None)


def heif_image_set_ambient_viewing_environment(img, amve) -> None:
    img.amve = amve


def heif_image_has_nominal_diffuse_white_luminance(img) -> bool:
    return getattr(img, "ndwt", None) is not None


def heif_image_get_nominal_diffuse_white_luminance(img) -> int:
    return getattr(img, "ndwt", 0) or 0


def heif_image_set_nominal_diffuse_white_luminance(img,
                                                   luminance: int) -> None:
    img.ndwt = int(luminance)


def heif_mastering_display_colour_volume_decode(mdcv):
    """Raw fixed-point mdcv -> floats in the units of CTA-861.3
    (chromaticities x0.00002, luminances cd/m²; ref: heif_color.h
    heif_decoded_mastering_display_colour_volume)."""
    class decoded:
        pass
    d = decoded()
    d.display_primaries_x = [px * 0.00002
                             for (px, py) in mdcv.display_primaries]
    d.display_primaries_y = [py * 0.00002
                             for (px, py) in mdcv.display_primaries]
    d.white_point_x = mdcv.white_point[0] * 0.00002
    d.white_point_y = mdcv.white_point[1] * 0.00002
    d.max_display_mastering_luminance = \
        mdcv.max_display_mastering_luminance * 0.0001
    d.min_display_mastering_luminance = \
        mdcv.min_display_mastering_luminance * 0.0001
    return d


# color-conversion options (ref: heif_color.h
# heif_color_conversion_options / _ext; the _ext alloc/copy/free trio is
# C memory management — kept for API parity as plain object helpers)

def heif_color_conversion_options_set_defaults(options) -> None:
    options.preferred_chroma_downsampling_algorithm = "average"
    options.preferred_chroma_upsampling_algorithm = "bilinear"
    options.only_use_preferred_chroma_algorithm = False


def heif_color_conversion_options_ext_alloc():
    return ColorConversionOptions()


def heif_color_conversion_options_ext_copy(options):
    return copy.copy(options) if options is not None else None


def heif_color_conversion_options_ext_free(options) -> None:
    pass
