"""Parsed intra picture: the per-4x4 maps and SAO parameters.

Counterpart of libheif_tpu/codecs/hevc/ctu.py:26-160, trimmed to the
intra maps that the C++ parser (host/hevc_parse.cc) fills and the
reconstruction reads.  The port has no Python slice parser and no inter
state; the TUs stay in the flat column form of native_parse.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .headers import SPS, PPS, SliceHeader

INTRA_PLANAR = 0
INTRA_DC = 1


@dataclass
class SaoParam:
    """One CTB's SAO parameters: per component a type (0 off, 1 band,
    2 edge), four offsets and a band position; an edge class for luma
    and one for chroma."""

    type_idx: List[int] = field(default_factory=lambda: [0, 0, 0])
    offsets: List[List[int]] = field(
        default_factory=lambda: [[0] * 4 for _ in range(3)])
    band_pos: List[int] = field(default_factory=lambda: [0, 0, 0])
    eo_class: List[int] = field(default_factory=lambda: [0, 0])


class SliceSyntax:
    """Parsed output for one picture.  ``sao_table`` is the parser's
    (pic_height_in_ctbs, pic_width_in_ctbs, 20) int16 SAO record per CTB
    (types, 3x4 offsets, band positions, luma and chroma edge class; zero,
    type 0, in a CTB whose slice carries no SAO), or None when no slice
    carries SAO.  ``slice_map4`` holds the slice index per 4x4 (JAX
    ctu.py:157, :296) and ``slice_headers`` each slice's header, so that
    the filters read the offsets and flags of the slice that holds a
    sample; ``sh`` is the first slice's."""

    def __init__(self, sps: SPS, pps: PPS, sh: SliceHeader):
        self.sps = sps
        self.pps = pps
        self.sh = sh
        w4 = (sps.pic_width + 63) // 4 + 16
        h4 = (sps.pic_height + 63) // 4 + 16
        self.w4, self.h4 = w4, h4
        self.intra_mode_y = np.full((h4, w4), INTRA_DC, np.uint8)
        self.intra_mode_c = np.full((h4, w4), INTRA_DC, np.uint8)
        self.ct_depth = np.zeros((h4, w4), np.uint8)
        self.cu_log2 = np.zeros((h4, w4), np.uint8)      # CU size per 4x4
        self.tu_log2 = np.zeros((h4, w4), np.uint8)      # TU size per 4x4
        self.qp_y = np.zeros((h4, w4), np.int16)
        self.tqb_map = np.zeros((h4, w4), np.uint8)
        self.nonzero_y = np.zeros((h4, w4), np.uint8)    # cbf_luma per 4x4
        self.avail = np.zeros((h4, w4), np.uint8)        # decoded yet
        self.slice_map4 = np.zeros((h4, w4), np.int16)
        self.slice_headers: List[SliceHeader] = [sh]
        n_ctbs = sps.pic_width_in_ctbs * sps.pic_height_in_ctbs
        self.sao_buf = np.zeros((n_ctbs, 20), np.int16)  # the parser's
        self.sao_table: Optional[np.ndarray] = None

    def slice_field(self, name: str, dtype=np.int32) -> np.ndarray:
        """A slice header field per 4x4: ``name`` of the slice holding
        each position, (h4, w4)."""
        vals = np.asarray([getattr(h, name) for h in self.slice_headers],
                          dtype)
        return vals[self.slice_map4]

    def sao_param(self, cx: int, cy: int) -> SaoParam:
        """The CTB's parameters in the JAX package's SaoParam form."""
        e = self.sao_table[cy, cx]
        sp = SaoParam()
        sp.type_idx = [int(e[0]), int(e[1]), int(e[2])]
        sp.offsets = [[int(e[3 + c * 4 + i]) for i in range(4)]
                      for c in range(3)]
        sp.band_pos = [int(e[15]), int(e[16]), int(e[17])]
        sp.eo_class = [int(e[18]), int(e[19])]
        return sp
