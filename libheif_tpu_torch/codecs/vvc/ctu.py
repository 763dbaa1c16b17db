"""VVC slice syntax: coding tree, intra CU, residual coding (H.266
§7.3.11, §7.3.11.5 coding_unit, §7.3.11.11 residual_coding).

Single implementation for BOTH directions: every syntax element goes
through a `SyntaxIO` adapter that either decodes from a CabacDecoder
or encodes a supplied value into a CabacEncoder.  Conditions, context
derivations, scan order, and the pass-1 bin budget are therefore
shared verbatim — encoder output is decodable by construction, which
is the conformance story for this oracle-less codec (tables.py
docstring).

Toolset: I-slice, single tree, QT-only (CTU 32, min CB 8), TU == CU,
all optional tools disabled; per-TB regular residual coding with the
remBinsPass1 budget, no dependent quantization, no sign hiding.

The port's copy of libheif_tpu/codecs/vvc/ctu.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core.error import HeifError, SubError
from .tables import (DIAG_4x4, SB_SCANS, sig_ctx, gtx_par_ctx,
                     last_prefix_ctx, rice_param,
                     INTRA_PLANAR, INTRA_DC, INTRA_HOR, INTRA_VER)
from .cabac import ContextModels, CabacDecoder
from .cabac_enc import CabacEncoder


# --------------------------------------------------------------------------
# Dual-mode syntax adapter
# --------------------------------------------------------------------------

class SyntaxIO:
    """Reads (decode) or writes (encode) each syntax element."""

    def __init__(self, ctx: ContextModels,
                 dec: Optional[CabacDecoder] = None,
                 enc: Optional[CabacEncoder] = None):
        assert (dec is None) != (enc is None)
        self.ctx = ctx
        self.dec = dec
        self.enc = enc

    @property
    def encoding(self) -> bool:
        return self.enc is not None

    def bin(self, name: str, inc: int, value: Optional[int] = None) -> int:
        idx = self.ctx.idx(name, inc)
        if self.dec is not None:
            return self.dec.decode_bin(idx)
        self.enc.encode_bin(idx, value)
        return value

    def bypass(self, value: Optional[int] = None) -> int:
        if self.dec is not None:
            return self.dec.decode_bypass()
        self.enc.encode_bypass(value)
        return value

    def bypass_bits(self, n: int, value: Optional[int] = None) -> int:
        if self.dec is not None:
            return self.dec.decode_bypass_bits(n)
        self.enc.encode_bypass_bits(value, n)
        return value

    def tu_bypass(self, c_max: int, value: Optional[int] = None) -> int:
        if self.dec is not None:
            return self.dec.decode_tu_bypass(c_max)
        self.enc.encode_tu_bypass(c_max, value)
        return value

    def eg(self, k: int, value: Optional[int] = None) -> int:
        if self.dec is not None:
            return self.dec.decode_eg_bypass(k)
        self.enc.encode_eg_bypass(k, value)
        return value

    def tb(self, c_max: int, value: Optional[int] = None) -> int:
        if self.dec is not None:
            return self.dec.decode_truncated_binary(c_max)
        self.enc.encode_truncated_binary(c_max, value)
        return value

    def terminate(self, value: Optional[int] = None) -> int:
        if self.dec is not None:
            return self.dec.decode_terminate()
        self.enc.encode_terminate(value)
        return value


def _level(value) -> int:
    """A decoded absolute level, which the int32 coefficient arrays must
    hold; a corrupt abs_remainder or dec_abs_level raises."""
    if value > 0x7FFFFFFF:
        raise HeifError.invalid_input(msg="VVC coefficient level out of "
                                          "range")
    return value


# --------------------------------------------------------------------------
# CU model
# --------------------------------------------------------------------------

@dataclass
class CuData:
    x: int = 0
    y: int = 0
    log2w: int = 3
    log2h: int = 3
    luma_mode: int = INTRA_PLANAR
    chroma_coded: int = 4                # 0..3 list index, 4 = DM
    chroma_mode: int = INTRA_PLANAR     # resolved prediction mode
    coeffs_y: Optional[np.ndarray] = None
    coeffs_cb: Optional[np.ndarray] = None
    coeffs_cr: Optional[np.ndarray] = None
    # optional intra tools
    mip_flag: int = 0
    mip_transposed: int = 0
    mip_mode: int = 0
    isp_split: int = 0                   # 0 none, 1 horizontal, 2 vertical
    isp_coeffs: Optional[List[Optional[np.ndarray]]] = None
    lfnst_idx: int = 0


# split kinds recorded in an EncodePlan
SPLIT_NONE = "none"
SPLIT_QT = "qt"
SPLIT_BT_H = "bth"
SPLIT_BT_V = "btv"
SPLIT_TT_H = "tth"
SPLIT_TT_V = "ttv"


class EncodePlan:
    """Encoder-side source of decisions for SliceCoder (built by the
    encoder's planning pass): split map + CU list in coding order."""

    def __init__(self):
        self.splits: Dict[Tuple[int, int, int, int], str] = {}
        self.cus: Dict[Tuple[int, int], CuData] = {}

    def add_cu(self, cu: CuData) -> None:
        self.cus[(cu.x, cu.y)] = cu

    def set_split(self, x: int, y: int, log2w: int, log2h: int,
                  kind: str) -> None:
        self.splits[(x, y, log2w, log2h)] = kind


# --------------------------------------------------------------------------
# Mode-list construction (§8.4.2 / §8.4.3)
# --------------------------------------------------------------------------

def build_mpm_list(cand_l: int, cand_a: int) -> List[int]:
    """6-entry MPM list; entry 0 is always Planar."""
    mpm = [INTRA_PLANAR, INTRA_DC, INTRA_VER, INTRA_HOR,
           INTRA_VER - 4, INTRA_VER + 4]
    if cand_l == cand_a and cand_l > INTRA_DC:
        m = cand_l
        mpm = [INTRA_PLANAR, m, 2 + ((m + 61) % 64), 2 + ((m - 1) % 64),
               2 + ((m + 60) % 64), 2 + (m % 64)]
    elif cand_l != cand_a and cand_l > INTRA_DC and cand_a > INTRA_DC:
        mx, mn = max(cand_l, cand_a), min(cand_l, cand_a)
        mpm = [INTRA_PLANAR, cand_l, cand_a, 0, 0, 0]
        diff = mx - mn
        if diff == 1:
            mpm[3] = 2 + ((mn + 61) % 64)
            mpm[4] = 2 + ((mx - 1) % 64)
            mpm[5] = 2 + ((mn + 60) % 64)
        elif diff >= 62:
            mpm[3] = 2 + ((mn - 1) % 64)
            mpm[4] = 2 + ((mx + 61) % 64)
            mpm[5] = 2 + (mn % 64)
        elif diff == 2:
            mpm[3] = 2 + ((mn - 1) % 64)
            mpm[4] = 2 + ((mn + 61) % 64)
            mpm[5] = 2 + ((mx - 1) % 64)
        else:
            mpm[3] = 2 + ((mn + 61) % 64)
            mpm[4] = 2 + ((mn - 1) % 64)
            mpm[5] = 2 + ((mx + 61) % 64)
    elif cand_l > INTRA_DC or cand_a > INTRA_DC:
        m = max(cand_l, cand_a)
        mpm = [INTRA_PLANAR, m, 2 + ((m + 61) % 64), 2 + ((m - 1) % 64),
               2 + ((m + 60) % 64), 2 + (m % 64)]
    # safety: deduplicate (keeps remainder mapping well-defined even if
    # a construction corner produces a repeat)
    seen = set()
    out = []
    for m in mpm:
        if m not in seen:
            seen.add(m)
            out.append(m)
    fill = 2
    while len(out) < 6:
        if fill not in seen:
            out.append(fill)
            seen.add(fill)
        fill += 1
    return out


def chroma_mode_list(luma_mode: int) -> List[int]:
    """4-entry chroma candidate list; DM collisions replaced by 66
    (§8.4.3 Table 21)."""
    modes = [INTRA_PLANAR, INTRA_VER, INTRA_HOR, INTRA_DC]
    for i, m in enumerate(modes):
        if m == luma_mode:
            modes[i] = 66
    return modes


# --------------------------------------------------------------------------
# Slice coder (both directions)
# --------------------------------------------------------------------------

class SliceCoder:
    def __init__(self, sps, pps, sh, io: SyntaxIO,
                 plan: Optional[EncodePlan] = None):
        self.sps = sps
        self.pps = pps
        self.sh = sh
        self.io = io
        self.plan = plan
        self.w = sps.pic_width
        self.h = sps.pic_height
        self.min_qt_log2 = sps.min_qt_log2
        self.ctu_log2 = sps.log2_ctu_size
        # neighbor maps at 4x4 granularity
        w4 = (self.w + 3) // 4
        h4 = (self.h + 3) // 4
        self.depth_map = np.zeros((h4, w4), np.int8)
        self.mode_map = np.full((h4, w4), INTRA_PLANAR, np.int16)
        self.mip_map = np.zeros((h4, w4), bool)
        self.coded_map = np.zeros((h4, w4), bool)
        self.cus: List[CuData] = []
        self._luma_last: List[Tuple[int, int]] = []
        self.max_cus = None               # optional security cap

    # ------------------------------------------------------------- run

    def run(self) -> List[CuData]:
        ctu = 1 << self.ctu_log2
        n_ctu_x = (self.w + ctu - 1) >> self.ctu_log2
        n_ctu_y = (self.h + ctu - 1) >> self.ctu_log2
        for cy in range(n_ctu_y):
            for cx in range(n_ctu_x):
                self._coding_tree(cx << self.ctu_log2, cy << self.ctu_log2,
                                  self.ctu_log2, self.ctu_log2, 0, 0)
        # end_of_slice_one_bit after the last CTU
        if self.io.terminate(1) != 1:
            raise HeifError.invalid_input(msg="missing end_of_slice bit")
        return self.cus

    # ----------------------------------------------------------- tree

    def _split_ctx(self, x0: int, y0: int, depth: int) -> int:
        inc = 0
        if x0 > 0:
            if self.coded_map[y0 >> 2, (x0 - 1) >> 2] and \
                    self.depth_map[y0 >> 2, (x0 - 1) >> 2] > depth:
                inc += 1
        if y0 > 0:
            if self.coded_map[(y0 - 1) >> 2, x0 >> 2] and \
                    self.depth_map[(y0 - 1) >> 2, x0 >> 2] > depth:
                inc += 1
        return inc + 3 * min(2, depth)

    def _allowed_splits(self, lw: int, lh: int, md: int):
        """(allow_qt, bt_v, bt_h, tt_v, tt_h) under this package's MTT
        toolset: MTT leaves >= 8 in each dimension, TT only from 32."""
        sps = self.sps
        max_mtt = getattr(sps, "max_mtt_depth_intra", 0)
        max_bt = sps.max_bt_log2 if max_mtt else 0
        max_tt = sps.max_tt_log2 if max_mtt else 0
        allow_qt = lw == lh and lw > self.min_qt_log2 and md == 0
        mtt_ok = md < max_mtt
        bt_v = mtt_ok and lw >= 4 and lw <= max_bt and lh <= max_bt
        bt_h = mtt_ok and lh >= 4 and lw <= max_bt and lh <= max_bt
        tt_v = mtt_ok and lw >= 5 and lw <= max_tt and lh <= max_tt
        tt_h = mtt_ok and lh >= 5 and lw <= max_tt and lh <= max_tt
        return allow_qt, bt_v, bt_h, tt_v, tt_h

    def _coding_tree(self, x0: int, y0: int, lw: int, lh: int,
                     qd: int, md: int) -> None:
        """coding_tree (§7.3.11.4): QT + multi-type (BT/TT) splits."""
        if x0 >= self.w or y0 >= self.h:
            return
        w = 1 << lw
        h = 1 << lh
        io = self.io
        depth = qd + md
        crosses = (x0 + w > self.w) or (y0 + h > self.h)
        allow_qt, bt_v, bt_h, tt_v, tt_h = self._allowed_splits(lw, lh, md)
        kind = SPLIT_NONE
        if crosses:
            # implicit boundary split: QT when square above minQT,
            # else binary toward the crossing dimension
            if allow_qt or (lw == lh and lw > self.min_qt_log2):
                kind = SPLIT_QT
            elif x0 + w > self.w and lw > 3:
                kind = SPLIT_BT_V
            elif y0 + h > self.h and lh > 3:
                kind = SPLIT_BT_H
            else:
                raise HeifError.invalid_input(
                    SubError.Invalid_parameter_value,
                    "picture size not a multiple of the minimum CU")
        elif allow_qt or bt_v or bt_h or tt_v or tt_h:
            want = None
            if self.plan is not None:
                want_kind = self.plan.splits.get((x0, y0, lw, lh),
                                                 SPLIT_NONE)
                want = 0 if want_kind == SPLIT_NONE else 1
            split = io.bin("split_cu_flag", self._split_ctx(x0, y0, depth),
                           want)
            if split:
                mtt_any = bt_v or bt_h or tt_v or tt_h
                if allow_qt and mtt_any:
                    want_qt = None
                    if self.plan is not None:
                        want_qt = 1 if want_kind == SPLIT_QT else 0
                    qt = io.bin("split_qt_flag", min(5, depth), want_qt)
                elif allow_qt:
                    qt = 1
                else:
                    qt = 0
                if qt:
                    kind = SPLIT_QT
                else:
                    ver_ok = bt_v or tt_v
                    hor_ok = bt_h or tt_h
                    if ver_ok and hor_ok:
                        want_v = None
                        if self.plan is not None:
                            want_v = 1 if want_kind in (SPLIT_BT_V,
                                                        SPLIT_TT_V) else 0
                        inc = 0 if lw > lh else (1 if lw == lh else 2)
                        ver = io.bin("mtt_split_cu_vertical_flag", inc,
                                     want_v)
                    else:
                        ver = 1 if ver_ok else 0
                    bt_ok = bt_v if ver else bt_h
                    tt_ok = tt_v if ver else tt_h
                    if bt_ok and tt_ok:
                        want_b = None
                        if self.plan is not None:
                            want_b = 1 if want_kind in (SPLIT_BT_V,
                                                        SPLIT_BT_H) else 0
                        binary = io.bin("mtt_split_cu_binary_flag",
                                        min(3, md), want_b)
                    else:
                        binary = 1 if bt_ok else 0
                    if ver:
                        kind = SPLIT_BT_V if binary else SPLIT_TT_V
                    else:
                        kind = SPLIT_BT_H if binary else SPLIT_TT_H

        if kind == SPLIT_QT:
            half_w, half_h = w >> 1, h >> 1
            self._coding_tree(x0, y0, lw - 1, lh - 1, qd + 1, 0)
            self._coding_tree(x0 + half_w, y0, lw - 1, lh - 1, qd + 1, 0)
            self._coding_tree(x0, y0 + half_h, lw - 1, lh - 1, qd + 1, 0)
            self._coding_tree(x0 + half_w, y0 + half_h, lw - 1, lh - 1,
                              qd + 1, 0)
        elif kind == SPLIT_BT_V:
            self._coding_tree(x0, y0, lw - 1, lh, qd, md + 1)
            self._coding_tree(x0 + (w >> 1), y0, lw - 1, lh, qd, md + 1)
        elif kind == SPLIT_BT_H:
            self._coding_tree(x0, y0, lw, lh - 1, qd, md + 1)
            self._coding_tree(x0, y0 + (h >> 1), lw, lh - 1, qd, md + 1)
        elif kind == SPLIT_TT_V:
            q = w >> 2
            self._coding_tree(x0, y0, lw - 2, lh, qd, md + 1)
            self._coding_tree(x0 + q, y0, lw - 1, lh, qd, md + 1)
            self._coding_tree(x0 + 3 * q, y0, lw - 2, lh, qd, md + 1)
        elif kind == SPLIT_TT_H:
            q = h >> 2
            self._coding_tree(x0, y0, lw, lh - 2, qd, md + 1)
            self._coding_tree(x0, y0 + q, lw, lh - 1, qd, md + 1)
            self._coding_tree(x0, y0 + 3 * q, lw, lh - 2, qd, md + 1)
        else:
            self._coding_unit(x0, y0, lw, lh, depth)

    # ------------------------------------------------------------- CU

    def _neighbor_mode(self, x: int, y: int, require_same_ctu_row: bool,
                       y0: int) -> int:
        if x < 0 or y < 0 or x >= self.w or y >= self.h:
            return INTRA_PLANAR
        if require_same_ctu_row and (y >> self.ctu_log2) != \
                (y0 >> self.ctu_log2):
            return INTRA_PLANAR
        if not self.coded_map[y >> 2, x >> 2]:
            return INTRA_PLANAR
        return int(self.mode_map[y >> 2, x >> 2])

    def _coding_unit(self, x0: int, y0: int, log2w: int, log2h: int,
                     depth: int) -> None:
        io = self.io
        w = 1 << log2w
        h = 1 << log2h
        if self.max_cus is not None and len(self.cus) >= self.max_cus:
            raise HeifError.security("VVC CU count exceeds limit")

        src: Optional[CuData] = None
        if self.plan is not None:
            src = self.plan.cus.get((x0, y0))
            if src is None:
                raise HeifError.usage(msg=f"encode plan missing CU "
                                      f"({x0},{y0})")

        # ---- MIP (H.266 7.3.11.5 intra_mip_flag first)
        sps = self.sps
        mip_flag = mip_transposed = mip_mode = 0
        isp_split = 0
        if getattr(sps, "mip_enabled", False):
            if abs(log2w - log2h) > 1:
                inc = 3
            else:
                inc = 0
                if x0 > 0 and self.mip_map[y0 >> 2, (x0 - 1) >> 2]:
                    inc += 1
                if y0 > 0 and self.mip_map[(y0 - 1) >> 2, x0 >> 2]:
                    inc += 1
            mip_flag = io.bin("intra_mip_flag", inc,
                              None if src is None else src.mip_flag)
        if mip_flag:
            from .tables import mip_size_id, MIP_NUM_MODES
            mip_transposed = io.bypass(
                None if src is None else src.mip_transposed)
            n_modes = MIP_NUM_MODES[mip_size_id(log2w, log2h)]
            mip_mode = io.tb(n_modes - 1,
                             None if src is None else src.mip_mode)
            luma_mode = INTRA_PLANAR     # neighbor/DM view of a MIP CU
        else:
            # ---- ISP (subpartitions bounded at >= 4 samples: 4-way
            # splits of the 16..32 dimension only — see tables.py)
            isp_on = getattr(sps, "isp_enabled", False)
            isp_ok_h = isp_on and h >= 16 and w <= 32 and h <= 32
            isp_ok_v = isp_on and w >= 16 and w <= 32 and h <= 32
            if isp_ok_h or isp_ok_v:
                want = None if src is None else (1 if src.isp_split
                                                 else 0)
                if io.bin("intra_subpartitions_mode_flag", 0, want):
                    if isp_ok_h and isp_ok_v:
                        want_s = None if src is None else                             (1 if src.isp_split == 2 else 0)
                        split_v = io.bin(
                            "intra_subpartitions_split_flag", 0, want_s)
                    else:
                        split_v = 1 if isp_ok_v else 0
                    isp_split = 2 if split_v else 1

            # ---- luma intra mode
            cand_l = self._neighbor_mode(x0 - 1, y0 + h - 1, False, y0)
            cand_a = self._neighbor_mode(x0 + w - 1, y0 - 1, True, y0)
            mpm = build_mpm_list(cand_l, cand_a)

            if src is not None:
                luma_mode = src.luma_mode
                in_mpm = luma_mode in mpm
                mpm_flag = io.bin("intra_luma_mpm_flag", 0,
                                  1 if in_mpm else 0)
            else:
                mpm_flag = io.bin("intra_luma_mpm_flag", 0)
            np_inc = 0 if isp_split else 1
            if mpm_flag:
                if src is not None:
                    not_planar = 0 if src.luma_mode == INTRA_PLANAR else 1
                    not_planar = io.bin("intra_luma_not_planar_flag",
                                        np_inc, not_planar)
                else:
                    not_planar = io.bin("intra_luma_not_planar_flag",
                                        np_inc)
                if not_planar:
                    if src is not None:
                        idx = mpm.index(src.luma_mode) - 1
                        io.tu_bypass(4, idx)
                    else:
                        idx = io.tu_bypass(4)
                    luma_mode = mpm[1 + idx]
                else:
                    luma_mode = INTRA_PLANAR
            else:
                non_mpm = sorted(m for m in range(67) if m not in mpm)
                if src is not None:
                    rem = non_mpm.index(src.luma_mode)
                    io.tb(60, rem)
                else:
                    rem = io.tb(60)
                luma_mode = non_mpm[rem]

        # ---- chroma intra mode
        clist = chroma_mode_list(luma_mode)
        if src is not None:
            cm = src.chroma_coded
            io.bin("intra_chroma_pred_mode", 0, 1 if cm == 4 else 0)
            if cm != 4:
                io.bypass_bits(2, cm)
        else:
            if io.bin("intra_chroma_pred_mode", 0):
                cm = 4
            else:
                cm = io.bypass_bits(2)
        chroma_mode = luma_mode if cm == 4 else clist[cm]

        # ---- transform unit(s)
        cu = CuData(x=x0, y=y0, log2w=log2w, log2h=log2h,
                    luma_mode=luma_mode,
                    chroma_coded=cm, chroma_mode=chroma_mode,
                    mip_flag=mip_flag, mip_transposed=mip_transposed,
                    mip_mode=mip_mode, isp_split=isp_split)
        self._luma_last = []
        if src is not None:
            cbf_cb = 0 if src.coeffs_cb is None else 1
            cbf_cr = 0 if src.coeffs_cr is None else 1
            io.bin("tu_cbf_cb", 0, cbf_cb)
            io.bin("tu_cbf_cr", cbf_cb, cbf_cr)
        else:
            cbf_cb = io.bin("tu_cbf_cb", 0)
            cbf_cr = io.bin("tu_cbf_cr", cbf_cb)

        if isp_split:
            # 4 subpartitions; per-part cbf with the ISP contexts
            # (inc 2 + prev), last part inferred coded when all
            # previous were zero (H.266 tu_cbf_luma semantics)
            sl2w = log2w if isp_split == 1 else log2w - 2
            sl2h = log2h - 2 if isp_split == 1 else log2h
            cu.isp_coeffs = []
            prev_cbf = 0
            any_cbf = 0
            for pi in range(4):
                enc_part = None
                if src is not None:
                    enc_part = src.isp_coeffs[pi]
                if pi == 3 and not any_cbf:
                    cbf = 1
                else:
                    if src is not None:
                        cbf = io.bin("tu_cbf_luma", 2 + prev_cbf,
                                     0 if enc_part is None else 1)
                    else:
                        cbf = io.bin("tu_cbf_luma", 2 + prev_cbf)
                if cbf:
                    cu.isp_coeffs.append(
                        self._residual(sl2w, sl2h, 0, enc_part))
                else:
                    cu.isp_coeffs.append(None)
                prev_cbf = cbf
                any_cbf |= cbf
        else:
            if src is not None:
                cbf_y = 0 if src.coeffs_y is None else 1
                io.bin("tu_cbf_luma", 0, cbf_y)
            else:
                cbf_y = io.bin("tu_cbf_luma", 0)
            if cbf_y:
                cu.coeffs_y = self._residual(log2w, log2h, 0,
                                             None if src is None
                                             else src.coeffs_y)
        if cbf_cb:
            cu.coeffs_cb = self._residual(log2w - 1, log2h - 1, 1,
                                          None if src is None
                                          else src.coeffs_cb)
        if cbf_cr:
            cu.coeffs_cr = self._residual(log2w - 1, log2h - 1, 2,
                                          None if src is None
                                          else src.coeffs_cr)

        # ---- lfnst_idx (end of coding_unit; luma-only, single tree)
        if self._lfnst_allowed(cu, log2w, log2h):
            want0 = None if src is None else (1 if src.lfnst_idx else 0)
            if io.bin("lfnst_idx", 0, want0):
                want1 = None if src is None else                     (1 if src.lfnst_idx == 2 else 0)
                cu.lfnst_idx = 2 if io.bin("lfnst_idx", 2, want1) else 1
        self.cus.append(cu)

        # update neighbor maps
        self.depth_map[y0 >> 2:(y0 + h) >> 2,
                       x0 >> 2:(x0 + w) >> 2] = depth
        self.mode_map[y0 >> 2:(y0 + h) >> 2,
                      x0 >> 2:(x0 + w) >> 2] = luma_mode
        self.mip_map[y0 >> 2:(y0 + h) >> 2,
                     x0 >> 2:(x0 + w) >> 2] = bool(mip_flag)
        self.coded_map[y0 >> 2:(y0 + h) >> 2,
                       x0 >> 2:(x0 + w) >> 2] = True

    def _lfnst_allowed(self, cu: CuData, log2w: int, log2h: int) -> bool:
        """lfnst_idx presence conditions (H.266 7.3.11.5): sps flag,
        4..32 dims, non-MIP (the min-16 MIP case is not emitted),
        coded luma coefficients confined to the low-frequency region
        and not DC-only."""
        if not getattr(self.sps, "lfnst_enabled", False):
            return False
        if cu.mip_flag:
            return False
        w, h = 1 << log2w, 1 << log2h
        if min(w, h) < 4 or max(w, h) > 32:
            return False
        if cu.isp_split:
            sl2w = log2w if cu.isp_split == 1 else log2w - 2
            sl2h = log2h - 2 if cu.isp_split == 1 else log2h
        else:
            sl2w, sl2h = log2w, log2h
        if min(sl2w, sl2h) < 2:
            return False
        # region bound by TB shape (spec: 8 coeffs for 4x4/8x8)
        small = (sl2w == 2 and sl2h == 2) or (sl2w == 3 and sl2h == 3)
        max_pos = 7 if small else 15
        infos = self._luma_last
        if not infos:
            return False            # no coded luma TB
        dc_only = True
        for (last, last_sb) in infos:
            if last_sb > 0 or last > max_pos:
                return False        # energy outside the LFNST region
            if last > 0:
                dc_only = False
        return not dc_only

    # -------------------------------------------------------- residual

    def _residual(self, log2w: int, log2h: int, c_idx: int,
                  enc_coeffs: Optional[np.ndarray]) -> np.ndarray:
        """residual_coding (§7.3.11.11), regular path, 4x4 subblocks
        (TB dims >= 4 in this toolset)."""
        io = self.io
        if log2w < 2 or log2h < 2:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "TB narrower than 4 samples")
        w = 1 << log2w
        h = 1 << log2h
        w_sb = w >> 2
        h_sb = h >> 2
        sb_scan = SB_SCANS[(w_sb, h_sb)]
        # forward full scan (DC first)
        order: List[Tuple[int, int]] = []
        for sbx, sby in sb_scan:
            for dx, dy in DIAG_4x4:
                order.append((sbx * 4 + dx, sby * 4 + dy))
        pos_of = {p: i for i, p in enumerate(order)}

        if enc_coeffs is not None:
            nz = [i for i, (x, y) in enumerate(order)
                  if enc_coeffs[y, x] != 0]
            if not nz:
                raise HeifError.usage(msg="residual coding of a zero TB")
            last = nz[-1]
            last_x, last_y = order[last]
        else:
            last_x = last_y = 0  # filled below

        chroma = c_idx > 0

        # ---- last significant position
        def code_last(val: Optional[int], log2: int) -> int:
            c_max = (log2 << 1) - 1
            if val is not None:
                # value → prefix/suffix
                if val <= 3:
                    prefix = val
                else:
                    prefix = 0
                    for p in range(4, c_max + 1):
                        grp_base = (2 + (p & 1)) << ((p >> 1) - 1)
                        grp_size = 1 << ((p >> 1) - 1)
                        if grp_base <= val < grp_base + grp_size:
                            prefix = p
                            break
                    else:
                        raise HeifError.usage(msg="bad last position")
                for i in range(prefix):
                    io.bin(self._last_name, last_prefix_ctx(chroma, log2, i),
                           1)
                if prefix < c_max:
                    io.bin(self._last_name,
                           last_prefix_ctx(chroma, log2, prefix), 0)
                if prefix > 3:
                    bits = (prefix >> 1) - 1
                    base = (2 + (prefix & 1)) << bits
                    io.bypass_bits(bits, val - base)
                return val
            prefix = 0
            while prefix < c_max and io.bin(
                    self._last_name, last_prefix_ctx(chroma, log2, prefix)):
                prefix += 1
            if prefix <= 3:
                return prefix
            bits = (prefix >> 1) - 1
            suffix = io.bypass_bits(bits)
            return ((2 + (prefix & 1)) << bits) + suffix

        self._last_name = "last_sig_coeff_x_prefix"
        lx = code_last(last_x if enc_coeffs is not None else None, log2w)
        self._last_name = "last_sig_coeff_y_prefix"
        ly = code_last(last_y if enc_coeffs is not None else None, log2h)
        if enc_coeffs is None:
            if lx >= w or ly >= h:
                raise HeifError.invalid_input(
                    msg="last significant coefficient out of range")
            last = pos_of[(lx, ly)]

        last_sb = last >> 4
        if c_idx == 0:
            # geometry for the CU-level lfnst_idx gating
            self._luma_last.append((last & 15 if last_sb == 0 else 15,
                                    last_sb))
        coeffs = np.zeros((h, w), np.int32)
        abs1 = np.zeros((h, w), np.int32)      # AbsLevelPass1
        absf = np.zeros((h, w), np.int32)      # final AbsLevel
        csbf = np.zeros((h_sb, w_sb), bool)
        rem_bins = ((w * h) * 7) >> 2          # MaxCcbs pass-1 budget

        def tmpl_sum(arr: np.ndarray, x: int, y: int) -> int:
            s = 0
            if x + 1 < w:
                s += arr[y, x + 1]
                if x + 2 < w:
                    s += arr[y, x + 2]
                if y + 1 < h:
                    s += arr[y + 1, x + 1]
            if y + 1 < h:
                s += arr[y + 1, x]
                if y + 2 < h:
                    s += arr[y + 2, x]
            return int(s)

        def tmpl_count(x: int, y: int) -> int:
            s = 0
            for (tx, ty) in ((x + 1, y), (x + 2, y), (x, y + 1),
                             (x, y + 2), (x + 1, y + 1)):
                if tx < w and ty < h and abs1[ty, tx] != 0:
                    s += 1
            return s

        for sb in range(last_sb, -1, -1):
            sbx, sby = sb_scan[sb]
            if sb == last_sb or sb == 0:
                sb_flag = 1
                explicit_sb = False
            else:
                right = csbf[sby, sbx + 1] if sbx + 1 < w_sb else False
                below = csbf[sby + 1, sbx] if sby + 1 < h_sb else False
                inc = (2 if chroma else 0) + (1 if (right or below) else 0)
                if enc_coeffs is not None:
                    has = any(enc_coeffs[sby * 4 + dy, sbx * 4 + dx] != 0
                              for dx, dy in DIAG_4x4)
                    sb_flag = io.bin("sb_coded_flag", inc, 1 if has else 0)
                else:
                    sb_flag = io.bin("sb_coded_flag", inc)
                explicit_sb = True
            csbf[sby, sbx] = bool(sb_flag)
            if not sb_flag:
                continue

            start = (last & 15) if sb == last_sb else 15
            sig_found = False
            pass3_positions: List[int] = []
            gt3_positions: List[int] = []

            # ---- pass 1: sig / gt1 / par / gt3 under the bin budget
            for k in range(start, -1, -1):
                gx = sbx * 4 + DIAG_4x4[k][0]
                gy = sby * 4 + DIAG_4x4[k][1]
                gpos = sb * 16 + k
                if rem_bins < 4:
                    pass3_positions.append(k)
                    continue
                # significance
                if gpos == last:
                    sig = 1
                elif k == 0 and explicit_sb and not sig_found:
                    sig = 1                     # inferred DC significance
                else:
                    diag = (gx + gy)
                    inc = sig_ctx(c_idx, diag, tmpl_sum(abs1, gx, gy))
                    if enc_coeffs is not None:
                        sig = io.bin("sig_coeff_flag", inc,
                                     1 if enc_coeffs[gy, gx] != 0 else 0)
                    else:
                        sig = io.bin("sig_coeff_flag", inc)
                    rem_bins -= 1
                if not sig:
                    continue
                sig_found = True
                diag = gx + gy
                t = tmpl_sum(abs1, gx, gy) - tmpl_count(gx, gy)
                inc = gtx_par_ctx(c_idx, diag, t)
                level = abs(int(enc_coeffs[gy, gx])) \
                    if enc_coeffs is not None else 0
                gt1 = io.bin("abs_level_gt1_flag", inc,
                             (1 if level > 1 else 0)
                             if enc_coeffs is not None else None)
                rem_bins -= 1
                if gt1:
                    par = io.bin("par_level_flag", inc,
                                 ((level - 2) & 1)
                                 if enc_coeffs is not None else None)
                    rem_bins -= 1
                    gt3 = io.bin("abs_level_gt3_flag", inc,
                                 (1 if level > 3 else 0)
                                 if enc_coeffs is not None else None)
                    rem_bins -= 1
                    a1 = 2 + par + 2 * gt3
                    if gt3:
                        gt3_positions.append(k)
                else:
                    a1 = 1
                abs1[gy, gx] = a1
                absf[gy, gx] = a1

            # ---- pass 2: abs_remainder for gt3 coefficients
            for k in gt3_positions:
                gx = sbx * 4 + DIAG_4x4[k][0]
                gy = sby * 4 + DIAG_4x4[k][1]
                loc = tmpl_sum(absf, gx, gy)
                rice = rice_param(max(0, min(31, loc - 20)))
                if enc_coeffs is not None:
                    level = abs(int(enc_coeffs[gy, gx]))
                    rem = (level - abs1[gy, gx]) >> 1
                    io.eg(rice, rem)
                else:
                    rem = io.eg(rice)
                absf[gy, gx] = _level(int(abs1[gy, gx]) + 2 * rem)

            # ---- pass 3: dec_abs_level for budget-exhausted positions
            for k in pass3_positions:
                gx = sbx * 4 + DIAG_4x4[k][0]
                gy = sby * 4 + DIAG_4x4[k][1]
                loc = tmpl_sum(absf, gx, gy)
                rice = rice_param(max(0, min(31, loc)))
                zero_pos = 1 << rice
                if enc_coeffs is not None:
                    level = abs(int(enc_coeffs[gy, gx]))
                    if level == 0:
                        v = zero_pos
                    elif level <= zero_pos:
                        v = level - 1
                    else:
                        v = level
                    io.eg(rice, v)
                else:
                    v = io.eg(rice)
                if v == zero_pos:
                    level = 0
                elif v < zero_pos:
                    level = v + 1
                else:
                    level = v
                absf[gy, gx] = _level(level)

            # ---- pass 4: signs (no sign hiding in this toolset)
            for k in range(start, -1, -1):
                gx = sbx * 4 + DIAG_4x4[k][0]
                gy = sby * 4 + DIAG_4x4[k][1]
                if absf[gy, gx] == 0:
                    continue
                if enc_coeffs is not None:
                    sign = 1 if enc_coeffs[gy, gx] < 0 else 0
                    io.bypass(sign)
                else:
                    sign = io.bypass()
                coeffs[gy, gx] = -absf[gy, gx] if sign else absf[gy, gx]

        if enc_coeffs is not None:
            return enc_coeffs
        return coeffs
