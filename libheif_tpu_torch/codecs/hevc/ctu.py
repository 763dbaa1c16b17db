"""HEVC slice syntax: the parsed picture's maps, and the Python slice
parser of P and B pictures.

Counterpart of libheif_tpu/codecs/hevc/ctu.py.  Intra pictures parse in
the C++ parser (host/hevc_parse.cc, native_parse.py), which fills the
per-4x4 maps of ``SliceSyntax`` and flat TU columns; a P or B picture
parses in ``SliceParser``, a copy of the JAX package's (skip and merge
:628-715, TMVP :716-800, AMVP :802-893, mvd, ref_idx, the PU geometry
with AMP :1014-1062, ``_coding_unit_inter`` :1064, and the residual
syntax it shares with intra), which also fills the inter maps (motion,
PU edges, CU records) and a TU list; ``raw_tus`` turns that list into
the C++ parser's columns, the input of device_recon.

Spec references: coding_quadtree §7.3.8.4, coding_unit §7.3.8.5,
prediction_unit §7.3.8.6, transform_tree §7.3.8.8, transform_unit
§7.3.8.10, residual_coding §7.3.8.11, sao §7.3.8.3, WPP §9.3.1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...core.error import HeifError, SubError
from .headers import SPS, PPS, SliceHeader
from .cabac import CabacDecoder, ContextModels
from .tables import diag_scan, horiz_scan, vert_scan, chroma_qp

INTRA_PLANAR = 0
INTRA_DC = 1
INTRA_ANGULAR26 = 26

# 4x4 sig ctx map (spec 9.3.4.2.5)
_CTX_IDX_MAP_4x4 = [0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8]

_SCANS = {0: diag_scan(4), 1: horiz_scan(4), 2: vert_scan(4)}
# subblock scans per TU size (in units of subblocks)
_SB_SCANS = {(0, n): diag_scan(n) for n in (1, 2, 4, 8)}
for n in (1, 2, 4, 8):
    _SB_SCANS[(1, n)] = horiz_scan(n)
    _SB_SCANS[(2, n)] = vert_scan(n)


@dataclass
class TU:
    x: int
    y: int
    log2: int
    c_idx: int
    pred_mode: int
    qp: int = 0                 # filled in QP finalize pass
    qg_serial: int = 0
    transform_skip: bool = False
    tqb: bool = False
    coeffs: Optional[np.ndarray] = None   # (n, n) int32, raster order


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


@dataclass
class PU:
    """One inter prediction unit.  List 0 in (mv, ref_idx); list 1 in
    (mv1, ref_idx1).  ref_idx == -1 means the list is unused (B slices
    can be uni-L0, uni-L1 or bi-predicted, spec 7.4.9.5)."""
    x: int
    y: int
    w: int
    h: int
    mv: Tuple[int, int]      # quarter-pel (mvx, mvy), list 0
    ref_idx: int
    mv1: Tuple[int, int] = (0, 0)   # list 1
    ref_idx1: int = -1


@dataclass
class CURec:
    """Per-CU record in parse (z) order, for reconstruction."""
    x: int
    y: int
    log2: int
    inter: bool
    pus: List[PU] = field(default_factory=list)
    tu_start: int = 0
    tu_end: int = 0


_NO_POC = -(1 << 30)


class ColMotion:
    """Motion field of a decoded picture for temporal MV prediction
    (spec 8.5.3.2.8/2.9): per-4x4 mv + reference POC per list (refIdx
    resolved to POCs at store time, so scaling needs no list lookup)."""

    __slots__ = ("poc", "pred_inter", "mv_l0", "poc_l0", "mv_l1",
                 "poc_l1")

    @classmethod
    def from_syntax(cls, syn: "SliceSyntax", poc: int) -> "ColMotion":
        m = cls()
        m.poc = poc
        m.pred_inter = syn.pred_inter.copy()
        m.mv_l0 = syn.mv_l0.copy()
        m.mv_l1 = syn.mv_l1.copy()

        def poc_map(ref_map, pocs):
            out = np.full(ref_map.shape, _NO_POC, np.int64)
            for i, p in enumerate(pocs):
                out[ref_map == i] = p
            return out

        m.poc_l0 = poc_map(syn.ref_l0, syn.ref_pocs_l0)
        m.poc_l1 = poc_map(syn.ref_l1, syn.ref_pocs_l1)
        return m


class SliceSyntax:
    """Parsed output for one picture.

    The per-4x4 maps: intra modes, depths, CU and TU sizes, QP, bypass,
    cbf_luma, decoded-yet (``avail``), the slice index (``slice_map4``,
    JAX ctu.py:157, :296) and, for P and B pictures, the motion maps
    (``pred_inter``, ``skip_map``, ``mv_l0``/``ref_l0``,
    ``mv_l1``/``ref_l1``, the PU edges ``pu_vedge``/``pu_hedge``), with
    the CU records ``cus`` in decode order and the reference POCs of each
    list.  ``slice_headers`` holds each slice's header, so that the
    filters read the offsets and flags of the slice that holds a sample;
    ``sh`` is the first slice's.

    The C++ parser writes its per-CTB SAO records into ``sao_buf``;
    ``sao_table`` is then their (pic_height_in_ctbs, pic_width_in_ctbs,
    20) int16 view (types, 3x4 offsets, band positions, luma and chroma
    edge class; type 0 in a CTB whose slice carries no SAO), or None when
    no slice carries SAO.  The Python parser fills ``sao`` (per CTB a
    SaoParam) and ``tus`` (TU objects); ``raw_tus`` turns both into the
    C++ parser's form."""

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
        self.sao_buf = np.zeros((n_ctbs, 20), np.int16)  # the C++ parser's
        self.sao_table: Optional[np.ndarray] = None
        # the Python parser's outputs
        self.tus: List[TU] = []
        self.sao: Dict[Tuple[int, int], SaoParam] = {}
        # inter state (P/B slices): per-4x4 motion maps + CU records
        self.pred_inter = np.zeros((h4, w4), np.uint8)   # 1 = inter
        self.skip_map = np.zeros((h4, w4), np.uint8)     # cu_skip per 4x4
        self.mv_l0 = np.zeros((h4, w4, 2), np.int32)     # quarter-pel
        self.ref_l0 = np.full((h4, w4), -1, np.int16)    # -1 unused list
        self.mv_l1 = np.zeros((h4, w4, 2), np.int32)     # list 1 (B)
        self.ref_l1 = np.full((h4, w4), -1, np.int16)
        self.pu_vedge = np.zeros((h4, w4), np.uint8)     # PU left edges
        self.pu_hedge = np.zeros((h4, w4), np.uint8)     # PU top edges
        self.cus: List[CURec] = []
        self.ref_pocs_l0: List[int] = []                 # filled by decoder
        self.ref_pocs_l1: List[int] = []

    @property
    def has_inter(self) -> bool:
        """A CU of the picture is inter coded (the Python parser's)."""
        return any(cu.inter for cu in self.cus)

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

    def sao_from_table(self) -> None:
        """``sao`` (per CTB a SaoParam) from the C++ parser's
        ``sao_table``, every CTB's, for the numpy filters (JAX
        native_parse.py ``_unpack_sao`` :185)."""
        self.sao = {} if self.sao_table is None else {
            (cx, cy): self.sao_param(cx, cy)
            for cy in range(self.sao_table.shape[0])
            for cx in range(self.sao_table.shape[1])}

    def sao_from_params(self) -> None:
        """``sao_table`` from the Python parser's ``sao`` (None when no
        CTB has SAO parameters), in the C++ parser's record layout."""
        if not self.sao:
            self.sao_table = None
            return
        sps = self.sps
        tab = np.zeros((sps.pic_height_in_ctbs, sps.pic_width_in_ctbs, 20),
                       np.int16)
        for (cx, cy), sp in self.sao.items():
            e = tab[cy, cx]
            e[0:3] = sp.type_idx
            e[3:15] = [o for c in range(3) for o in sp.offsets[c]]
            e[15:18] = sp.band_pos
            e[18:20] = sp.eo_class
        self.sao_table = tab


# the C++ parser's TU columns (native_parse.parse_slice_raw)
RAW_COLUMNS = ("x", "y", "log2", "c_idx", "mode", "qp", "ts", "tqb")


def raw_tus(tus: Sequence[TU]):
    """A TU list (the Python parser's) in the C++ parser's flat form:
    (cols (N, 8) int32 [x y log2 c mode qp ts tqb], coeff_buf int32,
    offs (N,) int64 into coeff_buf, -1 = no residual).  An inter TU keeps
    its pred_mode -1 in the mode column."""
    cols = np.asarray([(t.x, t.y, t.log2, t.c_idx, t.pred_mode, t.qp,
                        int(t.transform_skip), int(t.tqb)) for t in tus],
                      np.int32).reshape(-1, len(RAW_COLUMNS))
    offs = np.full(len(tus), -1, np.int64)
    parts = []
    pos = 0
    for i, t in enumerate(tus):
        if t.coeffs is not None:
            offs[i] = pos
            parts.append(np.ascontiguousarray(t.coeffs, np.int32).ravel())
            pos += parts[-1].size
    coeff = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return cols, coeff, offs

def tus_from_raw(cols: np.ndarray, coeff: np.ndarray,
                 offs: np.ndarray) -> List[TU]:
    """The inverse of ``raw_tus``: the C++ parser's columns as TU objects
    (JAX native_parse.py:209-217), each with its (n, n) coefficients or
    None."""
    tus = []
    for (x, y, log2, c, mode, qp, ts, tqb), off in zip(cols.tolist(),
                                                       offs.tolist()):
        coeffs = None
        if off >= 0:
            n = 1 << log2
            coeffs = coeff[off:off + n * n].reshape(n, n).copy()
        tus.append(TU(x=x, y=y, log2=log2, c_idx=c, pred_mode=mode, qp=qp,
                      transform_skip=bool(ts), tqb=bool(tqb),
                      coeffs=coeffs))
    return tus


class SliceParser:
    def __init__(self, sps: SPS, pps: PPS, sh: SliceHeader,
                 rbsp: bytes, substreams: List[Tuple[int, int]],
                 ref_pocs_l0: Optional[List[int]] = None,
                 cur_poc: int = 0,
                 ref_pocs_l1: Optional[List[int]] = None,
                 col_motion=None, out: Optional["SliceSyntax"] = None,
                 slice_idx: int = 0, start_ctb: int = 0):
        """substreams: [(byte_start, byte_end)] per WPP row (or one).
        ref_pocs_l0/l1: POC of each reference per list (P/B slices;
        used for AMVP motion vector scaling).
        col_motion: ColMotion of the collocated reference picture when
        slice_temporal_mvp is enabled (spec 8.5.3.2.8)."""
        self.sps = sps
        self.pps = pps
        self.sh = sh
        self.rbsp = rbsp
        self.substreams = substreams
        self.slice_idx = slice_idx
        self.start_ctb = start_ctb
        self.out = out if out is not None else SliceSyntax(sps, pps, sh)
        self.out.ref_pocs_l0 = list(ref_pocs_l0 or [])
        self.out.ref_pocs_l1 = list(ref_pocs_l1 or [])
        self.cur_poc = cur_poc
        self.col_motion = col_motion
        # initType (spec 9.3.2.2): I=0; P: 2 if cabac_init_flag else 1;
        # B: 1 if cabac_init_flag else 2
        if sh.slice_type == 2:
            self.init_type = 0
        elif sh.slice_type == 1:
            self.init_type = 2 if sh.cabac_init_flag else 1
        else:
            self.init_type = 1 if sh.cabac_init_flag else 2
        self.ctx = ContextModels(self.init_type, sh.qp)
        self.dec: Optional[CabacDecoder] = None
        # QP bookkeeping
        self.qp_prev = sh.qp
        self.qg_pred = sh.qp
        self._pending_qp_reset = False
        self.qg_serial = -1
        self.qg_origin = (-1, -1)
        self.cu_qp_delta = 0
        self.qp_delta_coded = False
        self.log2_min_qg = sps.log2_ctb_size - pps.diff_cu_qp_delta_depth
        # per-CU state
        self.cur_tqb = False
        self._wpp_saved = None

    # ------------------------------------------------------------ utilities

    def _inside_pic(self, x: int, y: int) -> bool:
        return 0 <= x < self.sps.pic_width and 0 <= y < self.sps.pic_height

    def _available(self, x: int, y: int) -> bool:
        if not self._inside_pic(x, y):
            return False
        return bool(self.out.avail[y >> 2, x >> 2]) and \
            int(self.out.slice_map4[y >> 2, x >> 2]) == self.slice_idx

    # ---------------------------------------------------------------- parse

    def parse(self) -> SliceSyntax:
        sps = self.sps
        ctb = sps.ctb_size
        n_cols = sps.pic_width_in_ctbs
        n_rows = sps.pic_height_in_ctbs
        wpp = self.pps.entropy_coding_sync_enabled

        sub_idx = 0
        self.dec = CabacDecoder(self.rbsp, self.substreams[0][0] * 8,
                                self.substreams[0][1], self.ctx)

        if self.start_ctb:
            # non-first slice segment (spec 7.3.6.1 segment_address):
            # decode CTBs from the address to end_of_slice_segment_flag
            if wpp:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec,
                    "WPP combined with multi-slice pictures")
            return self._parse_from(self.start_ctb)

        for row in range(n_rows):
            if wpp and row > 0:
                # next substream; restore contexts saved after CTU 1 of
                # the row above (spec 9.3.1); QP predictor resets
                sub_idx += 1
                if sub_idx >= len(self.substreams):
                    raise HeifError.invalid_input(
                        msg="missing WPP entry point")
                if self._wpp_saved is not None and n_cols > 1:
                    self.ctx.restore(self._wpp_saved)
                else:
                    # above-right CTB unavailable: fresh context init
                    # (spec 9.3.1)
                    self.ctx = ContextModels(self.init_type, self.sh.qp)
                self.dec = CabacDecoder(
                    self.rbsp, self.substreams[sub_idx][0] * 8,
                    self.substreams[sub_idx][1], self.ctx)
                # qPY_PREV resets to SliceQpY at the row start — applied
                # after the previous row's last QG closes
                self._pending_qp_reset = True

            for col in range(n_cols):
                x0, y0 = col * ctb, row * ctb
                self._claim_ctb(col, row)
                if self.sps.sample_adaptive_offset_enabled and \
                        (self.sh.sao_luma or self.sh.sao_chroma):
                    self._parse_sao(col, row)
                self._coding_quadtree(x0, y0, sps.log2_ctb_size, 0)
                if wpp and col == 1:
                    self._wpp_saved = self.ctx.snapshot()
                end = self.dec.decode_terminate()
                is_last_ctu = (row == n_rows - 1 and col == n_cols - 1)
                if end and not is_last_ctu:
                    if wpp:
                        raise HeifError.invalid_input(
                            msg=f"premature end_of_slice at ({col},{row})")
                    # first segment of a multi-slice picture ends here;
                    # the caller continues with the next slice NAL
                    self.out.last_ctb = row * n_cols + col
                    self._finalize_qgs()
                    return self.out
        self.out.last_ctb = n_rows * n_cols - 1
            # WPP: end_of_subset_one_bit consumed implicitly by moving to
            # the next substream

        self._finalize_qgs()
        return self.out

    def _claim_ctb(self, col: int, row: int) -> None:
        sps = self.sps
        c4 = sps.ctb_size >> 2
        self.out.slice_map4[row * c4:(row + 1) * c4,
                            col * c4:(col + 1) * c4] = self.slice_idx

    def _parse_from(self, start_ctb: int) -> SliceSyntax:
        sps = self.sps
        ctb = sps.ctb_size
        n_cols = sps.pic_width_in_ctbs
        n_rows = sps.pic_height_in_ctbs
        n = n_cols * n_rows
        for idx in range(start_ctb, n):
            col, row = idx % n_cols, idx // n_cols
            self._claim_ctb(col, row)
            if self.sps.sample_adaptive_offset_enabled and \
                    (self.sh.sao_luma or self.sh.sao_chroma):
                self._parse_sao(col, row)
            self._coding_quadtree(col * ctb, row * ctb,
                                  sps.log2_ctb_size, 0)
            end = self.dec.decode_terminate()
            if end or idx == n - 1:
                self.out.last_ctb = idx
                break
        self._finalize_qgs()
        return self.out

    # ------------------------------------------------------------------ SAO

    def _parse_sao(self, cx: int, cy: int) -> None:
        """(spec §7.3.8.3)."""
        d = self.dec
        sao = SaoParam()
        merge = False
        c4 = self.sps.ctb_size >> 2
        same = self.out.slice_map4

        def ctb_same_slice(nx, ny):
            return int(same[ny * c4, nx * c4]) == self.slice_idx
        if cx > 0 and ctb_same_slice(cx - 1, cy):
            if d.decode_bin(self.ctx.idx("sao_merge_flag")):
                sao = self.out.sao[(cx - 1, cy)]
                self.out.sao[(cx, cy)] = sao
                merge = True
        if not merge and cy > 0 and ctb_same_slice(cx, cy - 1):
            if d.decode_bin(self.ctx.idx("sao_merge_flag")):
                sao = self.out.sao[(cx, cy - 1)]
                self.out.sao[(cx, cy)] = sao
                merge = True
        if merge:
            return

        for c_idx in range(3 if self.sh.sao_chroma else 1):
            if c_idx == 0 and not self.sh.sao_luma:
                continue
            # offset cMax/scale follow the component bit depth (spec
            # 7.4.9.3): cMax = (1 << (min(bd,10)-5)) - 1, shift = bd-10
            bd = (self.sps.bit_depth_luma if c_idx == 0
                  else self.sps.bit_depth_chroma)
            bd_shift = max(bd, 10) - 10
            off_max = (1 << (min(bd, 10) - 5)) - 1
            if c_idx == 2:
                sao.type_idx[2] = sao.type_idx[1]
            elif not d.decode_bin(self.ctx.idx("sao_type_idx")):
                sao.type_idx[c_idx] = 0
            else:
                sao.type_idx[c_idx] = 2 if d.decode_bypass() else 1
            if sao.type_idx[c_idx] == 0:
                continue
            offs = [d.decode_tu_bypass(off_max) for _ in range(4)]
            if sao.type_idx[c_idx] == 1:  # band
                for i in range(4):
                    if offs[i] and d.decode_bypass():
                        offs[i] = -offs[i]
                sao.band_pos[c_idx] = d.decode_bypass_bits(5)
            else:  # edge: offsets 0,1 positive; 2,3 negative
                offs = [offs[0], offs[1], -offs[2], -offs[3]]
                if c_idx == 0:
                    sao.eo_class[0] = d.decode_bypass_bits(2)
                elif c_idx == 1:
                    sao.eo_class[1] = d.decode_bypass_bits(2)
            sao.offsets[c_idx] = [o << bd_shift for o in offs]
        self.out.sao[(cx, cy)] = sao

    # -------------------------------------------------------- coding tree

    def _coding_quadtree(self, x0: int, y0: int, log2: int, depth: int) -> None:
        sps, pps, d = self.sps, self.pps, self.dec
        size = 1 << log2

        if pps.cu_qp_delta_enabled and log2 >= self.log2_min_qg:
            self._start_qg(x0, y0)

        inside = (x0 + size <= sps.pic_width and y0 + size <= sps.pic_height)
        if inside and log2 > sps.log2_min_cb_size:
            ctx_inc = 0
            if self._available(x0 - 1, y0) and \
                    self.out.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx_inc += 1
            if self._available(x0, y0 - 1) and \
                    self.out.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx_inc += 1
            split = d.decode_bin(self.ctx.idx("split_cu_flag", ctx_inc))
        else:
            split = 1 if log2 > sps.log2_min_cb_size else 0

        if split:
            half = size >> 1
            for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                x1, y1 = x0 + dx * half, y0 + dy * half
                if x1 < sps.pic_width and y1 < sps.pic_height:
                    self._coding_quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self._coding_unit(x0, y0, log2, depth)

    def _start_qg(self, x0: int, y0: int) -> None:
        if (x0, y0) == self.qg_origin:
            return
        if self._pending_qp_reset:
            self.qp_prev = self.sh.qp
            self._pending_qp_reset = False
        self.qg_origin = (x0, y0)
        self.qg_serial += 1
        self.cu_qp_delta = 0
        self.qp_delta_coded = False
        # qPY_PRED is derived at the START of the quantization group
        # (spec 8.6.1) from the left/above CUs in the same CTB, falling
        # back to the QpY of the last CU of the previous QG
        self.qg_pred = self._qp_pred(x0, y0)

    def _qp_pred(self, xq: int, yq: int) -> int:
        ctb_mask = ~(self.sps.ctb_size - 1)
        qp_a = qp_b = None
        if xq - 1 >= 0 and (xq - 1) & ctb_mask == xq & ctb_mask and \
                self.out.avail[yq >> 2, (xq - 1) >> 2]:
            qp_a = int(self.out.qp_y[yq >> 2, (xq - 1) >> 2])
        if qp_a is None:
            qp_a = self.qp_prev
        if yq - 1 >= 0 and (yq - 1) & ctb_mask == yq & ctb_mask and \
                self.out.avail[(yq - 1) >> 2, xq >> 2]:
            qp_b = int(self.out.qp_y[(yq - 1) >> 2, xq >> 2])
        if qp_b is None:
            qp_b = self.qp_prev
        return (qp_a + qp_b + 1) >> 1

    def _assign_tu_qp(self, tu: TU, qp_y: int) -> None:
        # tu.qp carries the dequant qP' incl. the bit-depth offset
        # (spec 8.6.1: qP = Qp + QpBdOffset); qp_y stays QpY
        if tu.c_idx == 0:
            tu.qp = qp_y + 6 * (self.sps.bit_depth_luma - 8)
        else:
            off = (self.pps.cb_qp_offset + self.sh.cb_qp_offset
                   if tu.c_idx == 1
                   else self.pps.cr_qp_offset + self.sh.cr_qp_offset)
            bd_off_c = 6 * (self.sps.bit_depth_chroma - 8)
            qpi = min(max(qp_y + off, -bd_off_c), 57)
            tu.qp = chroma_qp(qpi) + bd_off_c

    def _finalize_qgs(self) -> None:
        if not self.pps.cu_qp_delta_enabled:
            # uniform QP
            self.out.qp_y[:] = self.sh.qp
            for tu in self.out.tus:
                self._assign_tu_qp(tu, self.sh.qp)

    # ------------------------------------------------------------ coding unit

    def _coding_unit(self, x0: int, y0: int, log2: int, depth: int) -> None:
        sps, pps, d = self.sps, self.pps, self.dec
        size = 1 << log2
        bx0, by0 = x0 >> 2, y0 >> 2
        nb = size >> 2

        self.cur_tqb = False
        if pps.transquant_bypass_enabled:
            self.cur_tqb = bool(d.decode_bin(
                self.ctx.idx("cu_transquant_bypass_flag")))

        if self.sh.slice_type != 2:          # P slice: skip / pred mode
            ctx_inc = 0
            if self._available(x0 - 1, y0) and \
                    self.out.skip_map[by0, (x0 - 1) >> 2]:
                ctx_inc += 1
            if self._available(x0, y0 - 1) and \
                    self.out.skip_map[(y0 - 1) >> 2, bx0]:
                ctx_inc += 1
            skip = d.decode_bin(self.ctx.idx("cu_skip_flag", ctx_inc))
            if skip:
                self._coding_unit_skip(x0, y0, log2, depth)
                return
            pred_intra = bool(d.decode_bin(self.ctx.idx("pred_mode_flag")))
            if not pred_intra:
                self._coding_unit_inter(x0, y0, log2, depth)
                return

        # intra CU: part_mode only at min CB size
        part_nxn = False
        if log2 == sps.log2_min_cb_size:
            part_nxn = not d.decode_bin(self.ctx.idx("part_mode"))

        if sps.pcm_enabled and not part_nxn and \
                sps.log2_min_pcm_cb_size <= log2 <= sps.log2_max_pcm_cb_size:
            if d.decode_terminate():
                raise HeifError.unsupported(SubError.Unsupported_codec,
                                            "PCM coding units")

        # ---- intra luma modes ----
        n_parts = 4 if part_nxn else 1
        half = size >> 1
        part_pos = [(x0, y0)]
        if part_nxn:
            part_pos = [(x0, y0), (x0 + half, y0),
                        (x0, y0 + half), (x0 + half, y0 + half)]

        prev_flags = [d.decode_bin(self.ctx.idx("prev_intra_luma_pred_flag"))
                      for _ in range(n_parts)]
        mpm_or_rem = []
        for i in range(n_parts):
            if prev_flags[i]:
                mpm_or_rem.append(d.decode_tu_bypass(2))
            else:
                mpm_or_rem.append(d.decode_bypass_bits(5))

        luma_modes = []
        for i, (px, py) in enumerate(part_pos):
            mode = self._derive_intra_mode(px, py, prev_flags[i],
                                           mpm_or_rem[i])
            luma_modes.append(mode)
            pb = max(1, (1 << (log2 - (1 if part_nxn else 0))) >> 2)
            self.out.intra_mode_y[py >> 2:(py >> 2) + pb,
                                  px >> 2:(px >> 2) + pb] = mode
            # z-order availability inside the CU (later partitions see
            # earlier partitions as decoded neighbors, spec §6.4.1)
            self.out.avail[py >> 2:(py >> 2) + pb,
                           px >> 2:(px >> 2) + pb] = 1

        # ---- intra chroma mode (single for 4:2:0 CU) ----
        if d.decode_bin(self.ctx.idx("intra_chroma_pred_mode")):
            idx = d.decode_bypass_bits(2)
            cand = [INTRA_PLANAR, 26, 10, INTRA_DC]
            chroma_mode = cand[idx]
            if chroma_mode == luma_modes[0]:
                chroma_mode = 34
        else:
            chroma_mode = luma_modes[0]
        self.out.intra_mode_c[by0:by0 + nb, bx0:bx0 + nb] = chroma_mode

        # bookkeeping maps
        self.out.ct_depth[by0:by0 + nb, bx0:bx0 + nb] = depth
        self.out.cu_log2[by0:by0 + nb, bx0:bx0 + nb] = log2
        self.out.tqb_map[by0:by0 + nb, bx0:bx0 + nb] = int(self.cur_tqb)

        # ---- transform tree ----
        max_depth = sps.max_transform_hierarchy_depth_intra + (
            1 if part_nxn else 0)
        self._cu_luma_modes = luma_modes
        self._cu_chroma_mode = chroma_mode
        self._cu_part_nxn = part_nxn
        self._cu_x0, self._cu_y0, self._cu_log2 = x0, y0, log2
        self._max_trafo_depth = max_depth
        cu_tu_start = len(self.out.tus)
        self._cu_inter = False
        self._transform_tree(x0, y0, x0, y0, log2, 0, 0, True, True)
        self.out.cus.append(CURec(x=x0, y=y0, log2=log2, inter=False,
                                  tu_start=cu_tu_start,
                                  tu_end=len(self.out.tus)))

        if self.pps.cu_qp_delta_enabled:
            # per-CU QpY (spec 8.6.1): the CU takes qPY_PRED plus the
            # CuQpDeltaVal state as of this CU — CUs of the QG parsed
            # before the delta keep delta 0 (observable via later QP
            # prediction and deblocking; validated against libde265)
            qp_bd = 6 * (self.sps.bit_depth_luma - 8)
            qp_cu = ((self.qg_pred + self.cu_qp_delta + 52 + 2 * qp_bd)
                     % (52 + qp_bd)) - qp_bd
            self.out.qp_y[by0:by0 + nb, bx0:bx0 + nb] = qp_cu
            for tu in self.out.tus[cu_tu_start:]:
                self._assign_tu_qp(tu, qp_cu)
            self.qp_prev = qp_cu

        # availability after full CU decode
        self.out.avail[by0:by0 + nb, bx0:bx0 + nb] = 1

    # ------------------------------------------------------------- inter

    def _cu_common_maps(self, x0, y0, log2, depth, skip):
        nb = (1 << log2) >> 2
        bx0, by0 = x0 >> 2, y0 >> 2
        self.out.ct_depth[by0:by0 + nb, bx0:bx0 + nb] = depth
        self.out.cu_log2[by0:by0 + nb, bx0:bx0 + nb] = log2
        self.out.tqb_map[by0:by0 + nb, bx0:bx0 + nb] = int(self.cur_tqb)
        self.out.skip_map[by0:by0 + nb, bx0:bx0 + nb] = int(skip)
        if self.pps.cu_qp_delta_enabled:
            qp_bd = 6 * (self.sps.bit_depth_luma - 8)
            qp_cu = ((self.qg_pred + self.cu_qp_delta + 52 + 2 * qp_bd)
                     % (52 + qp_bd)) - qp_bd
            self.out.qp_y[by0:by0 + nb, bx0:bx0 + nb] = qp_cu
            self.qp_prev = qp_cu
            return qp_cu
        return None

    def _set_pu(self, pu: PU) -> None:
        """Write one PU's motion into the 4x4 maps + mark decoded."""
        bx, by = pu.x >> 2, pu.y >> 2
        nw, nh = max(pu.w >> 2, 1), max(pu.h >> 2, 1)
        o = self.out
        o.pred_inter[by:by + nh, bx:bx + nw] = 1
        o.mv_l0[by:by + nh, bx:bx + nw, 0] = pu.mv[0]
        o.mv_l0[by:by + nh, bx:bx + nw, 1] = pu.mv[1]
        o.ref_l0[by:by + nh, bx:bx + nw] = pu.ref_idx
        o.mv_l1[by:by + nh, bx:bx + nw, 0] = pu.mv1[0]
        o.mv_l1[by:by + nh, bx:bx + nw, 1] = pu.mv1[1]
        o.ref_l1[by:by + nh, bx:bx + nw] = pu.ref_idx1
        o.avail[by:by + nh, bx:bx + nw] = 1
        o.pu_vedge[by:by + nh, bx] = 1      # PU boundaries are deblock
        o.pu_hedge[by, bx:bx + nw] = 1      # edges (spec 8.7.2.2/2.3)

    def _neigh_motion(self, x: int, y: int):
        """Full motion (mv0, ref0, mv1, ref1) of the 4x4 block covering
        sample (x, y), or None when unavailable / intra-coded.  Unused
        lists carry ref -1 and mv (0, 0)."""
        if not self._available(x, y):
            return None
        bx, by = x >> 2, y >> 2
        o = self.out
        if not o.pred_inter[by, bx]:
            return None
        return ((int(o.mv_l0[by, bx, 0]), int(o.mv_l0[by, bx, 1])),
                int(o.ref_l0[by, bx]),
                (int(o.mv_l1[by, bx, 0]), int(o.mv_l1[by, bx, 1])),
                int(o.ref_l1[by, bx]))

    # combined bi-predictive candidate index pairs (spec table 8-10)
    _COMB_L0 = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
    _COMB_L1 = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)

    def _merge_candidates(self, xp, yp, w, h, part_mode, part_idx,
                          cu_x, cu_y, cu_size):
        """Spatial, temporal (with slice_temporal_mvp_enabled_flag),
        combined-bi and zero merge candidates (spec 8.5.3.2.2-2.5).  Each
        candidate is (mv0, ref0, mv1, ref1)."""
        plevel = self.pps.log2_parallel_merge_level
        is_b = self.sh.slice_type == 0

        def same_region(xn, yn):
            return (xn >> plevel) == (xp >> plevel) and \
                   (yn >> plevel) == (yp >> plevel)

        def get(xn, yn):
            if plevel > 2 and same_region(xn, yn):
                return None
            return self._neigh_motion(xn, yn)

        # A1 unavailable for the 2nd PU of vertical splits; B1 for the
        # 2nd PU of horizontal splits (spec 8.5.3.2.3)
        a1 = get(xp - 1, yp + h - 1) \
            if not (part_idx == 1 and part_mode in (2, 6, 7)) else None
        b1 = get(xp + w - 1, yp - 1) \
            if not (part_idx == 1 and part_mode in (1, 4, 5)) else None
        b0 = get(xp + w, yp - 1)
        a0 = get(xp - 1, yp + h)
        cands = []
        if a1 is not None:
            cands.append(a1)
        if b1 is not None and b1 != a1:
            cands.append(b1)
        if b0 is not None and b0 != b1:
            cands.append(b0)
        if a0 is not None and a0 != a1:
            cands.append(a0)
        if len(cands) < 4:
            b2 = get(xp - 1, yp - 1)
            if b2 is not None and b2 != a1 and b2 != b1:
                cands.append(b2)

        maxm = self.sh.max_num_merge_cand
        if self.sh.temporal_mvp and self.col_motion is not None and \
                len(cands) < maxm:
            # temporal merge candidate with refIdx 0 per used list
            # (spec 8.5.3.2.1 step after B2)
            pocs0, pocs1 = self.out.ref_pocs_l0, self.out.ref_pocs_l1
            mv0 = self._temporal_mv(xp, yp, w, h, 0, pocs0[0]) \
                if pocs0 else None
            mv1 = self._temporal_mv(xp, yp, w, h, 1, pocs1[0]) \
                if (is_b and pocs1) else None
            if mv0 is not None or mv1 is not None:
                cands.append((mv0 if mv0 is not None else (0, 0),
                              0 if mv0 is not None else -1,
                              mv1 if mv1 is not None else (0, 0),
                              0 if mv1 is not None else -1))
        if is_b and len(cands) > 1:
            # combined bi-predictive candidates (spec 8.5.3.2.4)
            n_orig = len(cands)
            pocs0, pocs1 = self.out.ref_pocs_l0, self.out.ref_pocs_l1
            for ci in range(n_orig * (n_orig - 1)):
                if len(cands) >= maxm or ci >= len(self._COMB_L0):
                    break
                c0 = cands[self._COMB_L0[ci]]
                c1 = cands[self._COMB_L1[ci]]
                if c0[1] < 0 or c1[3] < 0:
                    continue
                poc0 = pocs0[c0[1]] if c0[1] < len(pocs0) else -1
                poc1 = pocs1[c1[3]] if c1[3] < len(pocs1) else -1
                if poc0 != poc1 or c0[0] != c1[2]:
                    cands.append((c0[0], c0[1], c1[2], c1[3]))

        # zero candidates
        if is_b:
            num_ref = max(1, min(self.sh.num_ref_idx_l0,
                                 self.sh.num_ref_idx_l1))
        else:
            num_ref = max(1, self.sh.num_ref_idx_l0)
        zero_i = 0
        while len(cands) < maxm:
            ref = zero_i if zero_i < num_ref else 0
            if is_b:
                cands.append(((0, 0), ref, (0, 0), ref))
            else:
                cands.append(((0, 0), ref, (0, 0), -1))
            zero_i += 1
        return cands

    # ---------------------------------------------------------- temporal

    def _no_backward(self) -> bool:
        """NoBackwardPredFlag (spec 8.5.3.2.9): every reference in both
        lists precedes the current picture in output order."""
        return all(p <= self.cur_poc for p in
                   self.out.ref_pocs_l0 + self.out.ref_pocs_l1)

    def _col_mv_at(self, x_col: int, y_col: int, list_x: int,
                   target_poc: int):
        """Collocated MV derivation at one rounded position
        (spec 8.5.3.2.9) → scaled mv or None."""
        cm = self.col_motion
        bx, by = x_col >> 2, y_col >> 2
        if by >= cm.pred_inter.shape[0] or bx >= cm.pred_inter.shape[1] \
                or not cm.pred_inter[by, bx]:
            return None
        p0 = int(cm.poc_l0[by, bx])
        p1 = int(cm.poc_l1[by, bx])
        has0, has1 = p0 != _NO_POC, p1 != _NO_POC
        if not has0 and not has1:
            return None
        if not has0:
            use = 1
        elif not has1:
            use = 0
        elif self._no_backward():
            use = list_x
        else:
            # spec 8.5.3.2.9: mvLNCol with N = collocated_from_l0_flag
            use = 1 if self.sh.collocated_from_l0 else 0
        if use == 0:
            mv = (int(cm.mv_l0[by, bx, 0]), int(cm.mv_l0[by, bx, 1]))
            ref_poc = p0
        else:
            mv = (int(cm.mv_l1[by, bx, 0]), int(cm.mv_l1[by, bx, 1]))
            ref_poc = p1
        col_diff = cm.poc - ref_poc
        curr_diff = self.cur_poc - target_poc
        if col_diff == curr_diff:
            return mv
        return self._scale_mv_diff(mv, col_diff, curr_diff)

    def _temporal_mv(self, xp: int, yp: int, w: int, h: int,
                     list_x: int, target_poc: int):
        """Temporal luma MV prediction (spec 8.5.3.2.8): bottom-right
        collocated position first (same-CTB-row + in-picture rule),
        then the center; positions rounded to the 16x16 motion grid."""
        if not self.sh.temporal_mvp or self.col_motion is None:
            return None
        sps = self.sps
        x_br, y_br = xp + w, yp + h
        ctb = sps.log2_ctb_size
        if (yp >> ctb) == (y_br >> ctb) and y_br < sps.pic_height and \
                x_br < sps.pic_width:
            mv = self._col_mv_at((x_br >> 4) << 4, (y_br >> 4) << 4,
                                 list_x, target_poc)
            if mv is not None:
                return mv
        xc, yc = xp + (w >> 1), yp + (h >> 1)
        return self._col_mv_at((xc >> 4) << 4, (yc >> 4) << 4,
                               list_x, target_poc)

    @staticmethod
    def _div_trunc(a: int, b: int) -> int:
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q

    def _scale_mv_diff(self, mv, td: int, tb: int):
        """MV scaling from POC distances (spec 8.5.3.2.8 eq. 8-175..)."""
        td = max(-128, min(127, td))
        tb = max(-128, min(127, tb))
        if td == tb or td == 0:
            return mv
        tx = self._div_trunc(16384 + (abs(td) >> 1), td)
        dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
        out = []
        for c in mv:
            v = dsf * c
            s = -1 if v < 0 else 1
            out.append(max(-32768, min(32767, s * ((abs(v) + 127) >> 8))))
        return (out[0], out[1])

    def _scale_mv(self, mv, ref_poc_n, ref_poc_t):
        """Spatial MVP scaling (spec 8.5.3.2.8 distScaleFactor)."""
        return self._scale_mv_diff(mv, self.cur_poc - ref_poc_n,
                                   self.cur_poc - ref_poc_t)

    def _amvp(self, xp, yp, w, h, ref_idx, list_x: int = 0):
        """Spatial AMVP candidate list for one reference list
        (spec 8.5.3.2.6/2.7).  A neighbor contributes from the target
        list LX first, then from the other list LY when that reference
        is the same picture; the scaled fallback follows the same
        LX-then-LY order."""
        pocs_x = self.out.ref_pocs_l1 if list_x else self.out.ref_pocs_l0
        pocs_y = self.out.ref_pocs_l0 if list_x else self.out.ref_pocs_l1
        tpoc = pocs_x[ref_idx] if ref_idx < len(pocs_x) else 0

        def parts(n):
            """((mvLX, pocLX or None), (mvLY, pocLY or None))."""
            mv0, r0, mv1, r1 = n
            lx = ((mv1, pocs_x[r1] if 0 <= r1 < len(pocs_x) else None)
                  if list_x else
                  (mv0, pocs_x[r0] if 0 <= r0 < len(pocs_x) else None))
            ly = ((mv0, pocs_y[r0] if 0 <= r0 < len(pocs_y) else None)
                  if list_x else
                  (mv1, pocs_y[r1] if 0 <= r1 < len(pocs_y) else None))
            if (r1 if list_x else r0) < 0:
                lx = (lx[0], None)
            if (r0 if list_x else r1) < 0:
                ly = (ly[0], None)
            return lx, ly

        def match(n):
            """Same-picture candidate without scaling, or None."""
            lx, ly = parts(n)
            if lx[1] is not None and lx[1] == tpoc:
                return lx[0]
            if ly[1] is not None and ly[1] == tpoc:
                return ly[0]
            return None

        def scaled(n):
            """First used list, scaled to the target reference."""
            lx, ly = parts(n)
            if lx[1] is not None:
                return self._scale_mv(lx[0], lx[1], tpoc)
            if ly[1] is not None:
                return self._scale_mv(ly[0], ly[1], tpoc)
            return None

        a0 = self._neigh_motion(xp - 1, yp + h)
        a1 = self._neigh_motion(xp - 1, yp + h - 1)
        is_scaled = a0 is not None or a1 is not None
        mv_a = None
        for n in (a0, a1):
            if n is not None:
                mv_a = match(n)
                if mv_a is not None:
                    break
        if mv_a is None:
            for n in (a0, a1):
                if n is not None:
                    mv_a = scaled(n)
                    if mv_a is not None:
                        break
        b0 = self._neigh_motion(xp + w, yp - 1)
        b1 = self._neigh_motion(xp + w - 1, yp - 1)
        b2 = self._neigh_motion(xp - 1, yp - 1)
        mv_b = None
        for n in (b0, b1, b2):
            if n is not None:
                mv_b = match(n)
                if mv_b is not None:
                    break
        if not is_scaled:
            # no left neighbors: B fills the A slot, then B re-derives
            # with scaling allowed (spec 8.5.3.2.7 step 7)
            mv_a = mv_b
            mv_b = None
            for n in (b0, b1, b2):
                if n is not None:
                    mv_b = scaled(n)
                    if mv_b is not None:
                        break
        lst = []
        if mv_a is not None:
            lst.append(mv_a)
        if mv_b is not None and mv_b != mv_a:
            lst.append(mv_b)
        if len(lst) < 2 and self.sh.temporal_mvp and \
                self.col_motion is not None:
            # temporal AMVP candidate (spec 8.5.3.2.6 step 4)
            mv_t = self._temporal_mv(xp, yp, w, h, list_x, tpoc)
            if mv_t is not None:     # no dedup vs spatial (8.5.3.2.6)
                lst.append(mv_t)
        while len(lst) < 2:
            lst.append((0, 0))
        return lst

    def _parse_merge_idx(self) -> int:
        d = self.dec
        maxm = self.sh.max_num_merge_cand
        idx = 0
        if maxm > 1 and d.decode_bin(self.ctx.idx("merge_idx")):
            idx = 1
            while idx < maxm - 1 and d.decode_bypass():
                idx += 1
        return idx

    def _parse_ref_idx(self, num_ref: Optional[int] = None) -> int:
        d = self.dec
        if num_ref is None:
            num_ref = self.sh.num_ref_idx_l0
        v = 0
        while v < num_ref - 1:
            if v == 0:
                b = d.decode_bin(self.ctx.idx("ref_idx", 0))
            elif v == 1:
                b = d.decode_bin(self.ctx.idx("ref_idx", 1))
            else:
                b = d.decode_bypass()
            if not b:
                break
            v += 1
        return v

    def _parse_mvd(self):
        d = self.dec
        g0x = d.decode_bin(self.ctx.idx("abs_mvd_greater0_flag"))
        g0y = d.decode_bin(self.ctx.idx("abs_mvd_greater0_flag"))
        g1x = d.decode_bin(self.ctx.idx("abs_mvd_greater1_flag")) \
            if g0x else 0
        g1y = d.decode_bin(self.ctx.idx("abs_mvd_greater1_flag")) \
            if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            v = 0
            if g0:
                v = 1
                if g1:
                    v = 2 + d.decode_eg_bypass(1)
                if d.decode_bypass():
                    v = -v
            out.append(v)
        return out[0], out[1]

    @staticmethod
    def _wrap_mv(mvp, mvd):
        return (((mvp[0] + mvd[0] + 0x8000) & 0xFFFF) - 0x8000,
                ((mvp[1] + mvd[1] + 0x8000) & 0xFFFF) - 0x8000)

    def _prediction_unit(self, xp, yp, w, h, part_mode, part_idx,
                         cu_x, cu_y, cu_size, merge_all=False,
                         cu_depth=0):
        """Parse one PU; returns (PU, merge_flag)."""
        d = self.dec
        sh = self.sh
        merge = True if merge_all else \
            bool(d.decode_bin(self.ctx.idx("merge_flag")))
        if merge:
            idx = self._parse_merge_idx()
            cands = self._merge_candidates(xp, yp, w, h, part_mode,
                                           part_idx, cu_x, cu_y, cu_size)
            if idx >= len(cands):
                # a corrupt five_minus_max_num_merge_cand or merge_idx
                raise HeifError.invalid_input(msg="merge_idx out of range")
            mv0, ref0, mv1, ref1 = cands[idx]
            # 8x4/4x8 PUs may not be bi-predicted: a bi merge candidate
            # degrades to uni-L0 (spec 8.5.3.2.3)
            if w + h == 12 and ref0 >= 0 and ref1 >= 0:
                mv1, ref1 = (0, 0), -1
        elif sh.slice_type == 0:
            # B slice: inter_pred_idc (spec 9.3.3.8: first bin ctx =
            # CtDepth, second bin ctx 4; 8x4/4x8 PUs never code BI)
            if w + h != 12:
                if d.decode_bin(self.ctx.idx("inter_pred_idc", cu_depth)):
                    idc = 2                       # PRED_BI
                else:
                    idc = 1 if d.decode_bin(
                        self.ctx.idx("inter_pred_idc", 4)) else 0
            else:
                idc = 1 if d.decode_bin(
                    self.ctx.idx("inter_pred_idc", 4)) else 0
            mv0, ref0, mv1, ref1 = (0, 0), -1, (0, 0), -1
            if idc != 1:                          # uses list 0
                ref0 = self._parse_ref_idx(sh.num_ref_idx_l0)
                mvd0 = self._parse_mvd()
                mvp_flag = d.decode_bin(self.ctx.idx("mvp_flag"))
                mvp = self._amvp(xp, yp, w, h, ref0, 0)[mvp_flag]
                mv0 = self._wrap_mv(mvp, mvd0)
            if idc != 0:                          # uses list 1
                ref1 = self._parse_ref_idx(sh.num_ref_idx_l1)
                if sh.mvd_l1_zero and idc == 2:
                    mvd1 = (0, 0)
                else:
                    mvd1 = self._parse_mvd()
                mvp_flag = d.decode_bin(self.ctx.idx("mvp_flag"))
                mvp = self._amvp(xp, yp, w, h, ref1, 1)[mvp_flag]
                mv1 = self._wrap_mv(mvp, mvd1)
        else:
            # P slice: inter_pred_idc not coded (PRED_L0)
            ref0 = self._parse_ref_idx()
            mvd = self._parse_mvd()
            mvp_flag = d.decode_bin(self.ctx.idx("mvp_flag"))
            mvp = self._amvp(xp, yp, w, h, ref0, 0)[mvp_flag]
            mv0 = self._wrap_mv(mvp, mvd)
            mv1, ref1 = (0, 0), -1
        pu = PU(x=xp, y=yp, w=w, h=h, mv=mv0, ref_idx=ref0,
                mv1=mv1, ref_idx1=ref1)
        self._set_pu(pu)
        return pu, merge

    def _coding_unit_skip(self, x0, y0, log2, depth) -> None:
        size = 1 << log2
        self._cu_common_maps(x0, y0, log2, depth, skip=True)
        pu, _ = self._prediction_unit(x0, y0, size, size, 0, 0,
                                      x0, y0, size, merge_all=True,
                                      cu_depth=depth)
        self.out.cus.append(CURec(x=x0, y=y0, log2=log2, inter=True,
                                  pus=[pu], tu_start=len(self.out.tus),
                                  tu_end=len(self.out.tus)))

    def _parse_part_mode_inter(self, log2: int) -> int:
        """part_mode for inter CUs (spec 9.3.3.7 binarization).
        Returns 0 2Nx2N, 1 2NxN, 2 Nx2N, 3 NxN, 4 2NxnU, 5 2NxnD,
        6 nLx2N, 7 nRx2N."""
        d, sps = self.dec, self.sps
        if d.decode_bin(self.ctx.idx("part_mode", 0)):
            return 0                        # 2Nx2N
        at_min = log2 == sps.log2_min_cb_size
        b1 = d.decode_bin(self.ctx.idx("part_mode", 1))
        if at_min:
            if log2 == 3:
                return 1 if b1 else 2       # 2NxN / Nx2N (no NxN at 8x8)
            if b1:
                return 1                    # 2NxN
            if d.decode_bin(self.ctx.idx("part_mode", 2)):
                return 2                    # Nx2N
            return 3                        # NxN
        if not sps.amp_enabled:
            return 1 if b1 else 2
        b2 = d.decode_bin(self.ctx.idx("part_mode", 3))
        if b1:
            if b2:
                return 1                    # 2NxN
            return 4 if not d.decode_bypass() else 5   # 2NxnU / 2NxnD
        if b2:
            return 2                        # Nx2N
        return 6 if not d.decode_bypass() else 7       # nLx2N / nRx2N

    @staticmethod
    def _pu_geometry(part_mode, x0, y0, size):
        """PU rectangles for an inter part mode."""
        s, q = size, size >> 2
        h2, w2 = size >> 1, size >> 1
        if part_mode == 0:
            return [(x0, y0, s, s)]
        if part_mode == 1:
            return [(x0, y0, s, h2), (x0, y0 + h2, s, h2)]
        if part_mode == 2:
            return [(x0, y0, w2, s), (x0 + w2, y0, w2, s)]
        if part_mode == 3:
            return [(x0, y0, w2, h2), (x0 + w2, y0, w2, h2),
                    (x0, y0 + h2, w2, h2), (x0 + w2, y0 + h2, w2, h2)]
        if part_mode == 4:       # 2NxnU
            return [(x0, y0, s, q), (x0, y0 + q, s, s - q)]
        if part_mode == 5:       # 2NxnD
            return [(x0, y0, s, s - q), (x0, y0 + s - q, s, q)]
        if part_mode == 6:       # nLx2N
            return [(x0, y0, q, s), (x0 + q, y0, s - q, s)]
        return [(x0, y0, s - q, s), (x0 + s - q, y0, q, s)]  # nRx2N

    def _coding_unit_inter(self, x0, y0, log2, depth) -> None:
        sps, d = self.sps, self.dec
        size = 1 << log2
        # part_mode is always coded for inter CUs (spec 7.3.8.5)
        part_mode = self._parse_part_mode_inter(log2)
        self._cu_common_maps(x0, y0, log2, depth, skip=False)

        pus = []
        merge_flags = []
        geoms = self._pu_geometry(part_mode, x0, y0, size)
        for pi, (px, py, pw, ph) in enumerate(geoms):
            pu, mf = self._prediction_unit(px, py, pw, ph, part_mode, pi,
                                           x0, y0, size, cu_depth=depth)
            pus.append(pu)
            merge_flags.append(mf)

        # rqt_root_cbf (spec 7.3.8.5): skipped for 2Nx2N merge
        root_cbf = True
        if not (part_mode == 0 and merge_flags[0]):
            root_cbf = bool(d.decode_bin(self.ctx.idx("rqt_root_cbf")))

        cu_tu_start = len(self.out.tus)
        if root_cbf:
            self._cu_luma_modes = [INTRA_DC]
            self._cu_chroma_mode = INTRA_DC
            self._cu_part_nxn = False
            self._cu_x0, self._cu_y0, self._cu_log2 = x0, y0, log2
            self._cu_inter = True
            self._cu_inter_split = (
                sps.max_transform_hierarchy_depth_inter == 0 and
                part_mode != 0)
            self._max_trafo_depth = sps.max_transform_hierarchy_depth_inter
            self._transform_tree(x0, y0, x0, y0, log2, 0, 0, True, True)
            self._cu_inter = False
            self._cu_inter_split = False

        if self.pps.cu_qp_delta_enabled:
            qp_cu = (self.qg_pred + self.cu_qp_delta + 52) % 52
            nb = size >> 2
            self.out.qp_y[y0 >> 2:(y0 >> 2) + nb,
                          x0 >> 2:(x0 >> 2) + nb] = qp_cu
            for tu in self.out.tus[cu_tu_start:]:
                self._assign_tu_qp(tu, qp_cu)
            self.qp_prev = qp_cu

        self.out.cus.append(CURec(x=x0, y=y0, log2=log2, inter=True,
                                  pus=pus, tu_start=cu_tu_start,
                                  tu_end=len(self.out.tus)))
        nb = size >> 2
        self.out.avail[y0 >> 2:(y0 >> 2) + nb, x0 >> 2:(x0 >> 2) + nb] = 1

    def _derive_intra_mode(self, px: int, py: int, prev_flag: int,
                           value: int) -> int:
        """MPM derivation (spec §8.4.2)."""
        out = self.out
        # left neighbor
        if self._available(px - 1, py):
            cand_a = int(out.intra_mode_y[py >> 2, (px - 1) >> 2])
        else:
            cand_a = INTRA_DC
        # above neighbor: forced DC if outside current CTB row
        if self._available(px, py - 1) and \
                (py - 1) >> self.sps.log2_ctb_size == py >> self.sps.log2_ctb_size:
            cand_b = int(out.intra_mode_y[(py - 1) >> 2, px >> 2])
        else:
            cand_b = INTRA_DC

        if cand_a == cand_b:
            if cand_a < 2:
                mpm = [INTRA_PLANAR, INTRA_DC, INTRA_ANGULAR26]
            else:
                mpm = [cand_a,
                       2 + ((cand_a + 29) % 32),
                       2 + ((cand_a - 2 + 1) % 32)]
        else:
            mpm = [cand_a, cand_b, 0]
            if cand_a != INTRA_PLANAR and cand_b != INTRA_PLANAR:
                mpm[2] = INTRA_PLANAR
            elif cand_a != INTRA_DC and cand_b != INTRA_DC:
                mpm[2] = INTRA_DC
            else:
                mpm[2] = INTRA_ANGULAR26

        if prev_flag:
            return mpm[value]
        smpm = sorted(mpm)
        mode = value
        for m in smpm:
            if mode >= m:
                mode += 1
        return mode

    # -------------------------------------------------------- transform tree

    # inter-CU state defaults (set by _coding_unit_inter around the
    # transform tree; I slices never touch them)
    _cu_inter = False
    _cu_inter_split = False

    def _transform_tree(self, x0, y0, x_base, y_base, log2, depth, blk_idx,
                        parent_cbf_cb, parent_cbf_cr) -> None:
        sps, pps, d = self.sps, self.pps, self.dec
        intra_split = self._cu_part_nxn and not self._cu_inter

        if log2 > sps.log2_max_tb_size:
            split = 1
        elif intra_split and depth == 0:
            split = 1
        elif self._cu_inter and self._cu_inter_split and depth == 0:
            split = 1       # interSplitFlag (spec 7.4.9.8)
        elif log2 == sps.log2_min_tb_size or depth >= self._max_trafo_depth:
            split = 0
        else:
            split = d.decode_bin(
                self.ctx.idx("split_transform_flag", 5 - log2))

        cbf_cb = parent_cbf_cb
        cbf_cr = parent_cbf_cr
        if log2 > 2:
            if depth == 0 or parent_cbf_cb:
                cbf_cb = bool(d.decode_bin(self.ctx.idx("cbf_chroma", depth)))
            else:
                cbf_cb = False
            if depth == 0 or parent_cbf_cr:
                cbf_cr = bool(d.decode_bin(self.ctx.idx("cbf_chroma", depth)))
            else:
                cbf_cr = False

        if split:
            half = 1 << (log2 - 1)
            self._transform_tree(x0, y0, x0, y0, log2 - 1, depth + 1, 0,
                                 cbf_cb, cbf_cr)
            self._transform_tree(x0 + half, y0, x0, y0, log2 - 1, depth + 1,
                                 1, cbf_cb, cbf_cr)
            self._transform_tree(x0, y0 + half, x0, y0, log2 - 1, depth + 1,
                                 2, cbf_cb, cbf_cr)
            self._transform_tree(x0 + half, y0 + half, x0, y0, log2 - 1,
                                 depth + 1, 3, cbf_cb, cbf_cr)
            return

        # leaf: cbf_luma (inferred 1 for an inter CU's unsplit root with
        # no chroma cbf — spec 7.3.8.8)
        if self._cu_inter and depth == 0 and not cbf_cb and not cbf_cr:
            cbf_luma = True
        else:
            cbf_luma = bool(d.decode_bin(
                self.ctx.idx("cbf_luma", 1 if depth == 0 else 0)))

        nb = max(1, (1 << log2) >> 2)
        self.out.tu_log2[y0 >> 2:(y0 >> 2) + nb,
                         x0 >> 2:(x0 >> 2) + nb] = log2
        if cbf_luma:
            self.out.nonzero_y[y0 >> 2:(y0 >> 2) + nb,
                               x0 >> 2:(x0 >> 2) + nb] = 1

        self._transform_unit(x0, y0, x_base, y_base, log2, depth, blk_idx,
                             cbf_luma, cbf_cb, cbf_cr)

        if self._cu_inter:
            # inter: prediction runs at the PU level; only coded
            # residual TUs matter
            return

        # prediction-only blocks (no residual) still need recon entries,
        # in decode order (intra prediction runs per TB, spec §8.4.4.1)
        if not cbf_luma:
            self._record_pred_only(x0, y0, log2, 0,
                                   self._luma_mode_at(x0, y0))
        chroma_here = (log2 > 2) or blk_idx == 3
        if chroma_here:
            cx, cy, clog2 = (x0, y0, log2 - 1) if log2 > 2 else \
                (x_base, y_base, 2)
            if not (cbf_cb and chroma_here):
                self._record_pred_only(cx, cy, clog2, 1, self._cu_chroma_mode)
            if not (cbf_cr and chroma_here):
                self._record_pred_only(cx, cy, clog2, 2, self._cu_chroma_mode)

    def _luma_mode_at(self, x: int, y: int) -> int:
        if not self._cu_part_nxn:
            return self._cu_luma_modes[0]
        half = 1 << (self._cu_log2 - 1)
        idx = (1 if (x - self._cu_x0) >= half else 0) + \
              (2 if (y - self._cu_y0) >= half else 0)
        return self._cu_luma_modes[idx]

    def _record_pred_only(self, x, y, log2, c_idx, mode) -> None:
        tu = TU(x=x, y=y, log2=log2, c_idx=c_idx, pred_mode=mode,
                qg_serial=self.qg_serial, tqb=self.cur_tqb, coeffs=None)
        self.out.tus.append(tu)

    def _transform_unit(self, x0, y0, x_base, y_base, log2, depth, blk_idx,
                        cbf_luma, cbf_cb, cbf_cr) -> None:
        pps, d = self.pps, self.dec
        chroma_here = (log2 > 2) or blk_idx == 3
        cb = cbf_cb and chroma_here
        cr = cbf_cr and chroma_here

        # spec 7.3.8.10: cbfChroma references the PARENT node's flags for
        # all four 4x4 children (xC = xBase when log2TrafoSize == 2), so
        # the delta-QP gate fires at child 0 even though the chroma
        # residual itself is only coded with child 3
        if cbf_luma or cbf_cb or cbf_cr:
            if pps.cu_qp_delta_enabled and not self.qp_delta_coded:
                prefix = 0
                if d.decode_bin(self.ctx.idx("cu_qp_delta_abs", 0)):
                    prefix = 1
                    while prefix < 5 and d.decode_bin(
                            self.ctx.idx("cu_qp_delta_abs", 1)):
                        prefix += 1
                val = prefix
                if prefix == 5:
                    val = 5 + d.decode_eg_bypass(0)
                if val and d.decode_bypass():
                    val = -val
                self.cu_qp_delta = val
                self.qp_delta_coded = True

            if cbf_luma:
                self._residual(x0, y0, log2, 0,
                               self._luma_mode_at(x0, y0))
            if log2 > 2:
                if cb:
                    self._residual(x0, y0, log2 - 1, 1, self._cu_chroma_mode)
                if cr:
                    self._residual(x0, y0, log2 - 1, 2, self._cu_chroma_mode)
            elif blk_idx == 3:
                if cb:
                    self._residual(x_base, y_base, 2, 1, self._cu_chroma_mode)
                if cr:
                    self._residual(x_base, y_base, 2, 2, self._cu_chroma_mode)

    # ----------------------------------------------------------- residual

    def _residual(self, x0, y0, log2, c_idx, pred_mode) -> None:
        """residual_coding (spec §7.3.8.11)."""
        pps, d, ctx = self.pps, self.dec, self.ctx
        size = 1 << log2

        transform_skip = False
        if pps.transform_skip_enabled and not self.cur_tqb and log2 == 2:
            transform_skip = bool(d.decode_bin(
                ctx.idx("transform_skip_flag", 0 if c_idx == 0 else 1)))

        # scan selection (spec 7.4.9.11)
        scan_idx = 0
        if (c_idx == 0 and log2 in (2, 3)) or (c_idx > 0 and log2 == 2):
            if 6 <= pred_mode <= 14:
                scan_idx = 2
            elif 22 <= pred_mode <= 30:
                scan_idx = 1

        # ---- last significant coefficient position ----
        def last_prefix(which: str) -> int:
            c_max = (log2 << 1) - 1
            if c_idx == 0:
                offset = 3 * (log2 - 2) + ((log2 - 1) >> 2)
                shift = (log2 + 1) >> 2
            else:
                offset = 15
                shift = log2 - 2
            v = 0
            while v < c_max and d.decode_bin(
                    ctx.idx(which, offset + (v >> shift))):
                v += 1
            return v

        px = last_prefix("last_sig_x_prefix")
        py = last_prefix("last_sig_y_prefix")

        def last_val(prefix: int) -> int:
            if prefix > 3:
                nbits = (prefix >> 1) - 1
                return (((2 + (prefix & 1)) << nbits) +
                        d.decode_bypass_bits(nbits))
            return prefix

        last_x = last_val(px)
        last_y = last_val(py)
        if scan_idx == 2:
            last_x, last_y = last_y, last_x

        n_sb = size >> 2
        sb_scan = _SB_SCANS[(scan_idx, n_sb)]
        pos_scan = _SCANS[scan_idx]

        # map (x,y) → (subblock scan index, in-subblock scan index)
        sb_of = {(int(sx), int(sy)): i for i, (sx, sy) in enumerate(sb_scan)}
        pos_of = {(int(qx), int(qy)): i for i, (qx, qy) in enumerate(pos_scan)}
        last_sb = sb_of[(last_x >> 2, last_y >> 2)]
        last_pos = pos_of[(last_x & 3, last_y & 3)]

        coeffs = np.zeros((size, size), np.int32)
        csbf = np.zeros((n_sb, n_sb), np.uint8)
        csbf[last_y >> 2, last_x >> 2] = 1
        csbf[0, 0] = 1

        prev_sb_gt1 = False
        for i in range(last_sb, -1, -1):
            sx, sy = int(sb_scan[i][0]), int(sb_scan[i][1])
            explicit_csbf = False
            if i == last_sb or i == 0:
                sb_coded = True
            else:
                right = csbf[sy, sx + 1] if sx + 1 < n_sb else 0
                below = csbf[sy + 1, sx] if sy + 1 < n_sb else 0
                ctx_inc = min(int(right) | int(below), 1) + \
                    (2 if c_idx else 0)
                sb_coded = bool(d.decode_bin(
                    ctx.idx("coded_sub_block_flag", ctx_inc)))
                csbf[sy, sx] = sb_coded
                explicit_csbf = True
            if not sb_coded:
                continue

            infer_dc = explicit_csbf
            start_n = last_pos - 1 if i == last_sb else 15
            sig_pos = []
            if i == last_sb:
                sig_pos.append(last_pos)
            for n in range(start_n, -1, -1):
                qx, qy = int(pos_scan[n][0]), int(pos_scan[n][1])
                xc, yc = (sx << 2) + qx, (sy << 2) + qy
                if n == 0 and infer_dc and not sig_pos:
                    # all higher positions zero → DC inferred significant
                    sig = 1
                elif n == 0 and infer_dc and sig_pos:
                    sig = d.decode_bin(ctx.idx(
                        "sig_coeff_flag",
                        self._sig_ctx(xc, yc, log2, c_idx, scan_idx,
                                      sx, sy, csbf, n_sb)))
                else:
                    sig = d.decode_bin(ctx.idx(
                        "sig_coeff_flag",
                        self._sig_ctx(xc, yc, log2, c_idx, scan_idx,
                                      sx, sy, csbf, n_sb)))
                if sig:
                    sig_pos.append(n)

            if not sig_pos:
                continue

            # ---- levels ----
            ctx_set = (0 if (i == 0 or c_idx > 0) else 2)
            if prev_sb_gt1:
                ctx_set += 1
            greater1_ctx = 1
            gt1_flags = {}
            first_gt1_n = None
            for k, n in enumerate(sig_pos):
                if k < 8:
                    inc = ctx_set * 4 + min(3, greater1_ctx) + \
                        (16 if c_idx else 0)
                    g1 = d.decode_bin(
                        ctx.idx("coeff_abs_level_greater1_flag", inc))
                    gt1_flags[n] = g1
                    if g1:
                        if first_gt1_n is None:
                            first_gt1_n = n
                        greater1_ctx = 0
                    elif greater1_ctx > 0:
                        greater1_ctx += 1
            gt2 = 0
            if first_gt1_n is not None:
                gt2 = d.decode_bin(ctx.idx(
                    "coeff_abs_level_greater2_flag",
                    ctx_set + (4 if c_idx else 0)))
            prev_sb_gt1 = first_gt1_n is not None

            # sign data hiding
            sign_hidden = (pps.sign_data_hiding_enabled and
                           not self.cur_tqb and
                           (sig_pos[0] - sig_pos[-1]) > 3)
            signs = {}
            for n in sig_pos:
                if sign_hidden and n == sig_pos[-1]:
                    continue
                signs[n] = d.decode_bypass()

            rice = 0
            levels = {}
            sum_abs = 0
            for k, n in enumerate(sig_pos):
                if n in gt1_flags:
                    base = 1 + gt1_flags[n] + (gt2 if n == first_gt1_n else 0)
                    max_base = 3 if n == first_gt1_n else 2
                else:
                    base = 1
                    max_base = 1
                level = base
                if base == max_base:
                    prefix = 0
                    while d.decode_bypass():
                        prefix += 1
                        if prefix > 31:
                            raise HeifError.invalid_input(
                                msg="coeff remaining runaway")
                    if prefix <= 3:
                        rem = (prefix << rice) + d.decode_bypass_bits(rice)
                    else:
                        rem = (((1 << (prefix - 3)) + 3 - 1) << rice) + \
                            d.decode_bypass_bits(prefix - 3 + rice)
                    level = base + rem
                if level > (3 << rice):
                    rice = min(rice + 1, 4)
                levels[n] = level
                sum_abs += level

            for n in sig_pos:
                qx, qy = int(pos_scan[n][0]), int(pos_scan[n][1])
                xc, yc = (sx << 2) + qx, (sy << 2) + qy
                level = levels[n]
                if sign_hidden and n == sig_pos[-1]:
                    neg = (sum_abs & 1) == 1
                else:
                    neg = bool(signs.get(n, 0))
                coeffs[yc, xc] = -level if neg else level

        tu = TU(x=x0, y=y0, log2=log2, c_idx=c_idx,
                pred_mode=-1 if self._cu_inter else pred_mode,
                qg_serial=self.qg_serial, transform_skip=transform_skip,
                tqb=self.cur_tqb, coeffs=coeffs)
        self.out.tus.append(tu)

    def _sig_ctx(self, xc, yc, log2, c_idx, scan_idx, sx, sy, csbf, n_sb):
        """sig_coeff_flag context (spec §9.3.4.2.5)."""
        if log2 == 2:
            sig_ctx = _CTX_IDX_MAP_4x4[((yc & 3) << 2) + (xc & 3)]
        elif xc + yc == 0:
            sig_ctx = 0
        else:
            right = int(csbf[sy, sx + 1]) if sx + 1 < n_sb else 0
            below = int(csbf[sy + 1, sx]) if sy + 1 < n_sb else 0
            prev = right + 2 * below
            xp, yp = xc & 3, yc & 3
            if prev == 0:
                sig_ctx = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
            elif prev == 1:
                sig_ctx = 2 if yp == 0 else (1 if yp == 1 else 0)
            elif prev == 2:
                sig_ctx = 2 if xp == 0 else (1 if xp == 1 else 0)
            else:
                sig_ctx = 2
            if c_idx == 0:
                if (sx, sy) != (0, 0):
                    sig_ctx += 3
                sig_ctx += (9 if scan_idx == 0 else 15) if log2 == 3 else 21
            else:
                sig_ctx += 9 if log2 == 3 else 12
        return sig_ctx + (27 if c_idx else 0)
