"""CICP (H.273) color profile handling.

Re-designed equivalent of the reference's nclx layer (reference:
libheif/nclx.{h,cc} — color_profile_nclx nclx.h:172, primaries table
nclx.cc:45, Kr/Kb derivation nclx.cc:84).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class NclxProfile:
    """CICP colour description (ref: heif_color_profile_nclx)."""

    color_primaries: int = 2          # unspecified
    transfer_characteristics: int = 2
    matrix_coefficients: int = 6      # BT.601
    full_range_flag: bool = True

    @staticmethod
    def from_colr_box(colr) -> "NclxProfile":
        return NclxProfile(colr.colour_primaries,
                           colr.transfer_characteristics,
                           colr.matrix_coefficients,
                           colr.full_range_flag)


# H.273 Table 2 colour primaries: (rx, ry, gx, gy, bx, by, wx, wy)
# (ref: nclx.cc get_colour_primaries table)
_PRIMARIES = {
    1: (0.640, 0.330, 0.300, 0.600, 0.150, 0.060, 0.3127, 0.3290),   # BT.709
    4: (0.670, 0.330, 0.210, 0.710, 0.140, 0.080, 0.3100, 0.3160),   # BT.470M
    5: (0.640, 0.330, 0.290, 0.600, 0.150, 0.060, 0.3127, 0.3290),   # BT.470BG
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),   # SMPTE170M
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),   # SMPTE240M
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.3100, 0.3160),   # film
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),   # BT.2020
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1 / 3, 1 / 3),                # XYZ
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3140, 0.3510),  # DCI-P3
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),  # P3-D65
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),  # EBU3213
}


def get_kr_kb(matrix_coefficients: int,
              color_primaries: int = 2) -> Tuple[float, float]:
    """Kr/Kb for the YCbCr matrix (ref: nclx.cc get_Kr_Kb).

    Matrix 12/13 derive the coefficients from the primaries; the named
    matrices use the H.273 constants; anything else falls back to
    BT.601.
    """
    if matrix_coefficients in (12, 13):
        p = _PRIMARIES.get(color_primaries)
        if p is not None:
            rx, ry, gx, gy, bx, by, wx, wy = p
            zr, zg, zb, zw = 1 - rx - ry, 1 - gx - gy, 1 - bx - by, 1 - wx - wy
            denom = wy * (rx * (gy * zb - by * zg) + gx * (by * zr - ry * zb)
                          + bx * (ry * zg - gy * zr))
            if denom != 0.0:
                kr = (ry * (wx * (gy * zb - by * zg) + wy * (bx * zg - gx * zb)
                            + zw * (gx * by - bx * gy))) / denom
                kb = (by * (wx * (ry * zg - gy * zr) + wy * (gx * zr - rx * zg)
                            + zw * (rx * gy - gx * ry))) / denom
                return kr, kb
        return 0.299, 0.114
    return {
        1: (0.2126, 0.0722),
        4: (0.30, 0.11),
        5: (0.299, 0.114),
        6: (0.299, 0.114),
        7: (0.212, 0.087),
        9: (0.2627, 0.0593),
        10: (0.2627, 0.0593),
    }.get(matrix_coefficients, (0.299, 0.114))
