"""AV1 default CDF tables and per-tile adaptive context.

Tables are extracted from the system libaom by tools/extract_av1_cdfs.py
(default_cdfs.npz; values equal the spec's "Default CDF Tables"
appendix — several verified verbatim against libdav1d as well).
Rows use the inverse convention: icdf[i] = 32768 − cdf[i], trailing
adaptation counter slot. Stored per-context as mutable Python lists so
symbol adaptation (msac.py) is cheap.

Counterpart of libheif_tpu/codecs/av1/cdf.py, copied.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "default_cdfs.npz")
_defaults: Dict[str, np.ndarray] = {}


def _load():
    global _defaults
    if not _defaults:
        with np.load(_NPZ) as z:
            _defaults = {k: z[k].astype(np.int64) for k in z.files}
    return _defaults


def _to_lists(arr) -> list:
    if arr.ndim == 1:
        return arr.tolist()
    return [_to_lists(a) for a in arr]


def _icdf(*cdf):
    """AOM_CDFn(...) to the inverse row convention used here."""
    return [32768 - v for v in cdf] + [0, 0]


# palette mode/size defaults (spec Default CDF Tables /
# aom entropymode.c; validated empirically against libaom decodes —
# the rodata extractor cannot pin these short rows reliably)
_PALETTE_UV_MODE = [_icdf(32461), _icdf(21488)]

_PALETTE_Y_SIZE = [
    _icdf(7952, 13000, 18149, 21478, 25527, 29347),
    _icdf(7139, 11421, 16195, 19544, 23666, 28073),
    _icdf(7788, 12741, 17325, 20500, 24315, 28530),
    _icdf(8271, 14064, 18246, 21564, 25071, 28533),
    _icdf(12725, 19180, 21863, 24839, 27535, 30120),
    _icdf(9711, 14888, 16923, 21052, 25661, 27875),
    _icdf(14940, 20797, 21678, 24186, 27033, 28999),
]

_PALETTE_UV_SIZE = [
    _icdf(8713, 21979, 27615, 29749, 31708, 32148),
    _icdf(17371, 27808, 30701, 31852, 32313, 32578),
    _icdf(19813, 28911, 31243, 32145, 32532, 32648),
    _icdf(17604, 27852, 31593, 32130, 32550, 32700),
    _icdf(26097, 31845, 32489, 32654, 32716, 32735),
    _icdf(25644, 30607, 31238, 32038, 32606, 32702),
    _icdf(26110, 30969, 31286, 32009, 32639, 32700),
]


class CdfContext:
    """One tile's adaptive CDF state (re-initialised from defaults)."""

    def __init__(self, base_q_idx: int):
        d = _load()
        # quantizer-dependent coefficient table set (spec §8.2.2):
        if base_q_idx <= 20:
            q = 0
        elif base_q_idx <= 60:
            q = 1
        elif base_q_idx <= 120:
            q = 2
        else:
            q = 3
        self.txb_skip = _to_lists(d["txb_skip"][q])          # [5][13]
        self.eob_extra = _to_lists(d["eob_extra"][q])        # [5][2][9]
        self.dc_sign = _to_lists(d["dc_sign"][q])            # [2][3]
        self.eob_pt = {
            16: _to_lists(d["eob_pt_16"][q]),                # [2][2]
            32: _to_lists(d["eob_pt_32"][q]),
            64: _to_lists(d["eob_pt_64"][q]),
            128: _to_lists(d["eob_pt_128"][q]),
            256: _to_lists(d["eob_pt_256"][q]),
            512: _to_lists(d["eob_pt_512"][q]),
            1024: _to_lists(d["eob_pt_1024"][q]),
        }
        self.coeff_base_eob = _to_lists(d["coeff_base_eob"][q])  # [5][2][4]
        self.coeff_base = _to_lists(d["coeff_base"][q])      # [5][2][42]
        self.coeff_br = _to_lists(d["coeff_br"][q])          # [5][2][21]
        self.kf_y_mode = _to_lists(d["kf_y_mode"])           # [5][5]
        self.y_mode = _to_lists(d["y_mode"])                 # [4]
        self.uv_mode = _to_lists(d["uv_mode"])               # [2][13]
        self.partition = _to_lists(d["partition"])           # [20]
        self.intra_ext_tx = _to_lists(d["intra_ext_tx"])     # [3][4][13]
        self.cfl_alpha = _to_lists(d["cfl_alpha"])           # [6]
        # default_cfl_sign_cdf = AOM_CDF8(1418, 2123, 13340, 18405,
        # 26972, 28343, 32294): the npz extractor had misattributed a
        # different 8-symbol table to this name (caught by the lossless
        # CfL oracle difftest; the true row sits immediately before
        # cfl_alpha in libaom rodata)
        self.cfl_sign = [31350, 30645, 19428, 14363, 5796, 4425, 474,
                         0, 0]
        self.filter_intra_use = _to_lists(d["filter_intra_use"])  # [22]
        # default_filter_intra_mode_cdf = AOM_CDF5(8949, 12776, 17211,
        # 29558) — located in the libaom binary (the npz extractor does
        # not carry this single row); the earlier fitted guess was wrong
        # and desynced lossless filter-intra streams
        self.filter_intra_mode = list(d["filter_intra_mode"]) \
            if "filter_intra_mode" in d else [23819, 19992, 15557, 3210,
                                              0, 0]
        self.tx_size = _to_lists(d["tx_size"])               # [4][3]
        self.angle_delta = _to_lists(d["angle_delta"])       # [8]
        self.skip = _to_lists(d["skip"])                     # [3]
        self.delta_q = _to_lists(d["delta_q"])
        self.palette_y_size = _to_lists(d["palette_y_size"])
        self.palette_uv_size = _to_lists(d["palette_uv_size"])
        self.palette_y_mode = _to_lists(d["palette_y_mode"])
        self.palette_uv_mode = [r[:] for r in _PALETTE_UV_MODE]
        self.palette_y_size = _to_lists(d["palette_y_size"])
        self.palette_uv_size = _to_lists(d["palette_uv_size"])
        self.palette_y_color = _to_lists(d["palette_y_color"])    # [7][5][9]
        self.palette_uv_color = _to_lists(d["palette_uv_color"])  # [7][5][9]
        # loop-restoration CDFs (spec Default CDF Tables:
        # default_switchable_restore_cdf = CDF3(9413, 22581),
        # default_wiener_restore_cdf = CDF2(11570),
        # default_sgrproj_restore_cdf = CDF2(16855); icdf convention)
        self.restore_switchable = [32768 - 9413, 32768 - 22581, 0, 0]
        self.restore_wiener = [32768 - 11570, 0, 0]
        self.restore_sgrproj = [32768 - 16855, 0, 0]
        # --- intrabc / inter-tx tables (see extract_av1_cdfs LITERAL
        # provenance notes).  default_intrabc_cdf could not be located
        # in rodata; its value was pinned empirically against libaom
        # intrabc streams (tests/test_av1_intrabc.py).
        self.intrabc = [32768 - 30531, 0, 0]
        self.txfm_partition = _to_lists(d["txfm_partition"]) \
            if "txfm_partition" in d else None
        self.dv_joints = list(d["dv_joints"]) if "dv_joints" in d else None
        self.dv_classes = [list(d["dv_classes"]), list(d["dv_classes"])]
        self.dv_class0 = [list(d["dv_class0"]), list(d["dv_class0"])]
        self.dv_bits = [_to_lists(d["dv_bits"]), _to_lists(d["dv_bits"])]
        self.dv_sign = [list(d["dv_sign"]), list(d["dv_sign"])]
        self.inter_ext_tx = _to_lists(d["inter_ext_tx"]) \
            if "inter_ext_tx" in d else None
