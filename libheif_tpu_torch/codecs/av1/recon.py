"""AV1 intra prediction tables and the edge decisions the plan needs.

Counterpart of libheif_tpu/codecs/av1/recon.py, trimmed to what the
device plan uses (spec §7.11.2): the smooth weights and directional
derivatives (``_pred_tables``), the intra edge filter strength and its
kernels, and the upsampling decision.  The prediction itself runs on
the device (cuda_fast).
"""

from __future__ import annotations

import numpy as np

from .cdf import _load

__all__ = ["_pred_tables", "_edge_filter_strength", "_use_upsample",
           "_EDGE_KERNELS", "_load"]

_SM_WEIGHTS = None
_DR_DERIV = None


def _pred_tables():
    global _SM_WEIGHTS, _DR_DERIV
    if _SM_WEIGHTS is None:
        d = _load()
        raw = d["sm_weights"].astype(np.int64)
        _SM_WEIGHTS = {4: raw[0:4], 8: raw[4:12], 16: raw[12:28],
                       32: raw[28:60], 64: raw[60:124]}
        _DR_DERIV = d["dr_intra_derivative"].astype(np.int64)
    return _SM_WEIGHTS, _DR_DERIV


def _edge_filter_strength(w: int, h: int, delta: int, filter_type: int
                          ) -> int:
    """(spec 7.11.2.7 Intra_Edge_Filter_Strength)."""
    d = abs(delta)
    blk_wh = w + h
    strength = 0
    if filter_type == 0:
        if blk_wh <= 8:
            if d >= 56:
                strength = 1
        elif blk_wh <= 12:
            if d >= 40:
                strength = 1
        elif blk_wh <= 16:
            if d >= 40:
                strength = 1
        elif blk_wh <= 24:
            if d >= 8:
                strength = 1
            if d >= 16:
                strength = 2
            if d >= 32:
                strength = 3
        elif blk_wh <= 32:
            if d >= 1:
                strength = 1
            if d >= 4:
                strength = 2
            if d >= 32:
                strength = 3
        else:
            if d >= 1:
                strength = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                strength = 1
            if d >= 64:
                strength = 2
        elif blk_wh <= 16:
            if d >= 20:
                strength = 1
            if d >= 48:
                strength = 2
        elif blk_wh <= 24:
            if d >= 4:
                strength = 3
        else:
            if d >= 1:
                strength = 3
    return strength


_EDGE_KERNELS = [
    [0, 4, 8, 4, 0],
    [0, 5, 6, 5, 0],
    [2, 4, 4, 4, 2],
]


def _use_upsample(w: int, h: int, delta: int, filter_type: int) -> int:
    """(spec 7.11.2.10 Use_Intra_Edge_Upsample)."""
    d = abs(delta)
    blk_wh = w + h
    if d <= 0 or d >= 40:
        return 0
    return 1 if (blk_wh <= 16 if filter_type == 0 else blk_wh <= 8) else 0
