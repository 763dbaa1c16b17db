"""AV1 intra tile decoding: partition tree, mode info, coefficients.

Counterpart of libheif_tpu/codecs/av1/tile.py without its host replay
(run_jobs, _run_job, _ibc_copy).  Spec §5.11 (tile group syntax) + §8.3
(symbol contexts).  The parse emits one deferred TxbJob per transform
block; device_recon reconstructs them.  Inter tools are rejected
upstream (obu.py accepts only intra frames).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ...core.error import HeifError, SubError
from . import tables as T
from .cdf import CdfContext
from .msac import Msac
from .obu import SequenceHeader, FrameHeader
from .deblock import EdgeMaps

_SKIP_CONTEXTS_TAB = [
    [1, 2, 2, 2, 3],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 6],
]

# EOB class bases: eob_pt (1-based) → eob group start / extra offset bits
# (spec eob classes: 1, 2, 3-4, 5-8, 9-16, …)
_EOB_GROUP_START = [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513]
_EOB_OFFSET_BITS = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]

# tx type → (vertical, horizontal) 1-D transform kinds
_TX1D = {
    T.DCT_DCT: ("dct", "dct"), T.ADST_DCT: ("adst", "dct"),
    T.DCT_ADST: ("dct", "adst"), T.ADST_ADST: ("adst", "adst"),
    T.FLIPADST_DCT: ("fadst", "dct"), T.DCT_FLIPADST: ("dct", "fadst"),
    T.FLIPADST_FLIPADST: ("fadst", "fadst"),
    T.ADST_FLIPADST: ("adst", "fadst"), T.FLIPADST_ADST: ("fadst", "adst"),
    T.IDTX: ("idtx", "idtx"), T.V_DCT: ("dct", "idtx"),
    T.H_DCT: ("idtx", "dct"), T.V_ADST: ("adst", "idtx"),
    T.H_ADST: ("idtx", "adst"), T.V_FLIPADST: ("fadst", "idtx"),
    T.H_FLIPADST: ("idtx", "fadst"),
}


def _round2(x: int, n: int) -> int:
    """(spec Round2)."""
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


from dataclasses import dataclass  # noqa: E402


@dataclass
class TxbJob:
    """One transform block's reconstruction work order.

    Everything the pixel plane needs, captured at parse time — the AV1
    analog of the HEVC TU table (codecs/hevc/ctu.py TU): entropy decode
    stays serial, reconstruction replays these in order (host) or as
    wavefront batches (device_recon)."""

    plane: int
    px: int
    py: int
    tw: int
    th: int
    tx: int
    mode: int
    angle: int
    have_above: bool
    have_left: bool
    n_tr: int
    n_bl: int
    filt_type: int
    fi_mode: Optional[int]
    pal_pred: Optional[np.ndarray]
    cfl_alpha: int
    is_cfl: bool
    eob: int
    coeffs: Optional[np.ndarray]
    tx_type: int
    qindex: int
    hh: int
    ww: int
    # intrabc: block-copy prediction (ibc_mv set, eob 0) or add-only
    # residual on top of an earlier copy job (ibc_add)
    ibc_mv: Optional[Tuple[int, int]] = None
    ibc_add: bool = False


def _tx_class(tx_type: int) -> str:
    if tx_type in (T.V_DCT, T.V_ADST, T.V_FLIPADST):
        return 'v'
    if tx_type in (T.H_DCT, T.H_ADST, T.H_FLIPADST):
        return 'h'
    return '2d'


# intra ext tx sets (spec §5.11.47): set per sqr-up tx size
_EXT_TX_SET_INTRA_1 = [T.IDTX, T.DCT_DCT, T.V_DCT, T.H_DCT,
                       T.ADST_ADST, T.ADST_DCT, T.DCT_ADST]
_EXT_TX_SET_INTRA_2 = [T.IDTX, T.DCT_DCT, T.ADST_ADST,
                       T.ADST_DCT, T.DCT_ADST]
# inter tx-type sets (spec Tx type lists, symbol order; used by the
# intrabc path — dav1d tables.c dav1d_tx_types_per_set lineage)
_EXT_TX_SET_INTER_1 = [T.IDTX, T.V_DCT, T.H_DCT, T.V_ADST, T.H_ADST,
                       T.V_FLIPADST, T.H_FLIPADST, T.DCT_DCT,
                       T.ADST_DCT, T.DCT_ADST, T.FLIPADST_DCT,
                       T.DCT_FLIPADST, T.ADST_ADST,
                       T.FLIPADST_FLIPADST, T.ADST_FLIPADST,
                       T.FLIPADST_ADST]
_EXT_TX_SET_INTER_2 = [T.IDTX, T.V_DCT, T.H_DCT, T.DCT_DCT, T.ADST_DCT,
                       T.DCT_ADST, T.FLIPADST_DCT, T.DCT_FLIPADST,
                       T.ADST_ADST, T.FLIPADST_FLIPADST,
                       T.ADST_FLIPADST, T.FLIPADST_ADST]
_EXT_TX_SET_INTER_3 = [T.IDTX, T.DCT_DCT]


def base_eob_ctx(c, n_coeffs) -> int:
    if c == 0:
        return 0
    if c <= n_coeffs // 8:
        return 1
    if c <= n_coeffs // 4:
        return 2
    return 3


def base_ctx(levels, row, col, pos, bwl, tcls, tw=4, th=4,
             full_w=4, full_h=4) -> int:
    """coeff_base context (aom get_nz_map_ctx / get_nz_mag).

    Region offsets follow the av1_nz_map_ctx_offset generation rule
    (cross-validated against dav1d's lo_ctx_offsets 5x5 tables in
    libdav1d rodata): tall tx → rows 0-1 get +11; wide tx → cols 0-1
    get +16; otherwise diag<2 → +1, diag<4 → +6, else +21. The
    wide/tall test uses the FULL tx dims; coords live in the adjusted
    (≤32x32) block. 1-D classes: +26 base, +5/+10 by position along
    the transform axis.
    """
    if tcls == '2d':
        if pos == 0:
            return 0
        mag = (min(int(levels[row, col + 1]), 3) +
               min(int(levels[row + 1, col]), 3) +
               min(int(levels[row + 1, col + 1]), 3) +
               min(int(levels[row, col + 2]), 3) +
               min(int(levels[row + 2, col]), 3))
        mag = min((mag + 1) >> 1, 4)
        if full_w < full_h and row < 2:
            return mag + 11
        if full_w > full_h and col < 2:
            return mag + 16
        d = row + col
        if d < 2:
            return mag + 1
        if d < 4:
            return mag + 6
        return mag + 21
    mag = (min(int(levels[row + 1, col]), 3) +
           min(int(levels[row, col + 1]), 3))
    if tcls == 'v':
        mag += (min(int(levels[row + 2, col]), 3) +
                min(int(levels[row + 3, col]), 3) +
                min(int(levels[row + 4, col]), 3))
        coord = row
    else:
        mag += (min(int(levels[row, col + 2]), 3) +
                min(int(levels[row, col + 3]), 3) +
                min(int(levels[row, col + 4]), 3))
        coord = col
    mag = min((mag + 1) >> 1, 4)
    return mag + 26 + (0 if coord == 0 else (5 if coord == 1 else 10))


def br_ctx(levels, row, col, pos, bwl, tcls) -> int:
    """coeff_br context (aom get_br_ctx)."""
    mag = int(levels[row, col + 1]) + int(levels[row + 1, col])
    if tcls == '2d':
        mag += int(levels[row + 1, col + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        return mag + (7 if row < 2 and col < 2 else 14)
    if tcls == 'h':
        mag += int(levels[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        return mag + (7 if col == 0 else 14)
    mag += int(levels[row + 2, col])
    mag = min((mag + 1) >> 1, 6)
    if pos == 0:
        return mag
    return mag + (7 if row == 0 else 14)


class TileDecoder:
    _filt_type_y = 0
    _filt_type_uv = 0
    _fi_mode = None
    def __init__(self, seq: SequenceHeader, fh: FrameHeader,
                 planes: List[np.ndarray]):
        if seq.bit_depth not in (8, 10, 12):
            raise HeifError.unsupported(
                SubError.Unsupported_bit_depth,
                "AV1 bit depth %d not supported" % seq.bit_depth)
        self.ssx = seq.subsampling_x
        self.ssy = seq.subsampling_y
        self.num_planes = 1 if seq.monochrome else 3
        self.seq = seq
        self.fh = fh
        self.planes = planes            # [Y, U, V] int32 padded frames
        self.bd = seq.bit_depth
        self.mi_cols = (fh.frame_width + 7) // 8 * 2
        self.mi_rows = (fh.frame_height + 7) // 8 * 2
        self.sb_mi = 32 if seq.use_128x128_superblock else 16
        # frame-lifetime mode/size maps (4x4 granularity)
        self.y_modes = np.full((self.mi_rows, self.mi_cols), T.DC_PRED,
                               np.int32)
        self.uv_modes = np.full((self.mi_rows, self.mi_cols), T.DC_PRED,
                                np.int32)
        self.skip_map = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self.pal_y = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        # per-mi palette color lists for the prediction cache
        self.pal_y_colors = [[None] * self.mi_cols
                             for _ in range(self.mi_rows)]
        self.pal_u_colors = [[None] * self.mi_cols
                             for _ in range(self.mi_rows)]
        self.tx_wide = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self.tx_high = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        # intrabc state: per-4x4 DV map (row, col in 1/8 pel) + luma tx
        # type map (inter chroma derives its type from colocated luma)
        self.ibc_on = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.bsize_map = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self.ibc_mv = np.zeros((self.mi_rows, self.mi_cols, 2), np.int32)
        self.txtype_map = np.zeros((self.mi_rows, self.mi_cols), np.int32)
        self._use_intrabc = False
        self.block_decoded = [
            np.zeros((self.mi_rows + 2, self.mi_cols + 2), np.uint8)
            for _ in range(3)]
        self._cur_qindex = fh.quant.base_q_idx
        self._cur_tx_type = T.DCT_DCT
        self.edges = EdgeMaps([p.shape for p in planes])
        self.jobs: List[TxbJob] = []   # deferred pixel work, run by
        #                                device_recon

        # CDEF filter index per 64x64 unit, stored at its top-left mi
        # (-1 = every block skipped; spec read_cdef 5.11.56)
        self.cdef_idx = np.full((self.mi_rows, self.mi_cols), -1, np.int32)

        # loop-restoration per-unit state (spec read_lr 5.11.57):
        # resolved type (0 none / 2 wiener / 3 sgrproj), wiener taps
        # [pass][tap], sgr set index + projection coefficients
        self.lr_unit_dims = []
        self.lr_unit_type = []
        self.lr_wiener = []
        self.lr_sgr_set = []
        self.lr_sgr_xqd = []
        for plane in range(self.num_planes):
            sub_x = 0 if plane == 0 else self.ssx
            sub_y = 0 if plane == 0 else self.ssy
            usize = fh.lr_unit_size[plane]
            fw = _round2(fh.frame_width, sub_x)
            fhh = _round2(fh.frame_height, sub_y)
            ur = max((fhh + (usize >> 1)) // usize, 1)
            uc = max((fw + (usize >> 1)) // usize, 1)
            self.lr_unit_dims.append((ur, uc))
            self.lr_unit_type.append(np.zeros((ur, uc), np.int32))
            self.lr_wiener.append(np.zeros((ur, uc, 2, 3), np.int32))
            self.lr_sgr_set.append(np.zeros((ur, uc), np.int32))
            self.lr_sgr_xqd.append(np.zeros((ur, uc, 2), np.int32))

    # ---------------------------------------------------------- tile loop

    def decode_tile(self, data: bytes, mi_col0: int, mi_col1: int,
                    mi_row0: int, mi_row1: int) -> None:
        fh = self.fh
        self.r = Msac(data, not fh.disable_cdf_update)
        self.cdf = CdfContext(fh.quant.base_q_idx)
        self.mc0, self.mc1 = mi_col0, mi_col1
        self.mr0, self.mr1 = mi_row0, mi_row1
        # per-tile contexts
        n_mi_c = mi_col1 - mi_col0
        n_mi_r = mi_row1 - mi_row0
        self.above_part = np.zeros(self.mi_cols + 32, np.int32)
        self.left_part = np.zeros(self.sb_mi, np.int32)
        self.above_skip = np.zeros(self.mi_cols + 32, np.int32)
        self.left_skip = np.zeros(self.sb_mi, np.int32)
        # coefficient contexts per plane: level byte + dc sign category
        self.above_lvl = [np.zeros(self.mi_cols + 32, np.int32)
                          for _ in range(3)]
        self.left_lvl = [np.zeros(self.sb_mi, np.int32) for _ in range(3)]
        self.above_sign = [np.zeros(self.mi_cols + 32, np.int32)
                           for _ in range(3)]
        self.left_sign = [np.zeros(self.sb_mi, np.int32) for _ in range(3)]

        sb_log2 = 5 if self.seq.use_128x128_superblock else 4
        sb_sz = T.BLOCK_128X128 if self.seq.use_128x128_superblock \
            else T.BLOCK_64X64
        # tiles decode independently: neighbor-sample availability must
        # not cross tile boundaries (spec 5.11.2)
        for m in self.block_decoded:
            m[:] = 0

        # loop-restoration coefficient predictors reset per tile
        # (spec 5.11.2)
        self._ref_lr_wiener = [[[3, -7, 15], [3, -7, 15]]
                               for _ in range(self.num_planes)]
        self._ref_sgr_xqd = [[-32, 31] for _ in range(self.num_planes)]

        for mr in range(mi_row0, mi_row1, self.sb_mi):
            # left contexts reset each SB row
            self.left_part[:] = 0
            self.left_skip[:] = 0
            for p in range(3):
                self.left_lvl[p][:] = 0
                self.left_sign[p][:] = 0
            self.sb_mi_row = mr
            for mc in range(mi_col0, mi_col1, self.sb_mi):
                self.sb_mi_col = mc
                self._read_lr(mr, mc)
                self._decode_partition(mr, mc, sb_sz)

    # ----------------------------------------------------- loop restoration

    # spec constants (5.11.58): wiener tap bounds/subexp k/midpoints,
    # sgrproj projection bounds
    _WIENER_MIN = (-5, -23, -17)
    _WIENER_MAX = (10, 8, 46)
    _WIENER_K = (1, 2, 3)
    _XQD_MIN = (-96, -32)
    _XQD_MAX = (31, 95)

    def _decode_subexp_bool(self, num_syms: int, k: int) -> int:
        """(spec 9.2.x decode_subexp_bool): literal bools via msac."""
        r = self.r
        i = 0
        mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num_syms <= mk + 3 * a:
                # decode_uniform(num_syms - mk) (aom
                # read_primitive_quniform: w = FloorLog2(n) + 1,
                # m = (1 << w) - n)
                n = num_syms - mk
                w = n.bit_length()
                m = (1 << w) - n
                v = r.read_literal(w - 1) if w > 1 else 0
                if v < m:
                    return v + mk
                return ((v << 1) - m + r.read_literal(1)) + mk
            if r.read_literal(1):
                i += 1
                mk += a
            else:
                return r.read_literal(b2) + mk

    def _decode_signed_subexp_with_ref(self, low: int, high: int, k: int,
                                       ref: int) -> int:
        mx = high - low
        rr = ref - low
        v = self._decode_subexp_bool(mx, k)

        def inverse_recenter(r0, v0):
            # aom inv_recenter_nonneg: EVEN v lands above the ref,
            # ODD below — the swapped convention decoded mirrored
            # Wiener/sgrproj coefficients (caught by the LR oracle
            # difftest)
            if v0 > 2 * r0:
                return v0
            if v0 & 1:
                return r0 - ((v0 + 1) >> 1)
            return r0 + (v0 >> 1)

        if (rr << 1) <= mx:
            return inverse_recenter(rr, v) + low
        return mx - 1 - inverse_recenter(mx - 1 - rr, v) + low

    def _read_lr(self, mr: int, mc: int) -> None:
        """Per-superblock restoration-unit syntax (spec 5.11.57)."""
        fh = self.fh
        if fh.allow_intrabc:
            return
        for plane in range(self.num_planes):
            if fh.lr_type[plane] == 0:
                continue
            sub_x = 0 if plane == 0 else self.ssx
            sub_y = 0 if plane == 0 else self.ssy
            usize = fh.lr_unit_size[plane]
            ur_total, uc_total = self.lr_unit_dims[plane]
            row_start = ((mr * 4 >> sub_y) + usize - 1) // usize
            row_end = min(ur_total,
                          (((mr + self.sb_mi) * 4 >> sub_y) + usize - 1)
                          // usize)
            numer = 4 >> sub_x
            denom = usize
            col_start = (mc * numer + denom - 1) // denom
            col_end = min(uc_total,
                          ((mc + self.sb_mi) * numer + denom - 1) // denom)
            for ur in range(row_start, row_end):
                for uc in range(col_start, col_end):
                    self._read_lr_unit(plane, ur, uc)

    def _read_lr_unit(self, plane: int, ur: int, uc: int) -> None:
        """(spec 5.11.58)."""
        fh, r = self.fh, self.r
        frame_type = fh.lr_type[plane]
        if frame_type == 1:        # switchable: 0 none / 1 wiener / 2 sgr
            sym = r.read_symbol_n(self.cdf.restore_switchable, 3)
            unit_type = (0, 2, 3)[sym]
        elif frame_type == 2:      # wiener
            unit_type = 2 if r.read_symbol_n(self.cdf.restore_wiener, 2) \
                else 0
        else:                      # sgrproj
            unit_type = 3 if r.read_symbol_n(self.cdf.restore_sgrproj, 2) \
                else 0
        self.lr_unit_type[plane][ur, uc] = unit_type

        if unit_type == 2:         # wiener taps
            for p in range(2):
                first = 1 if plane else 0
                if plane:
                    self.lr_wiener[plane][ur, uc, p, 0] = 0
                for j in range(first, 3):
                    v = self._decode_signed_subexp_with_ref(
                        self._WIENER_MIN[j], self._WIENER_MAX[j] + 1,
                        self._WIENER_K[j], self._ref_lr_wiener[plane][p][j])
                    self.lr_wiener[plane][ur, uc, p, j] = v
                    self._ref_lr_wiener[plane][p][j] = v
        elif unit_type == 3:       # sgrproj set + projection coeffs
            lr_sgr_set = r.read_literal(4)
            self.lr_sgr_set[plane][ur, uc] = lr_sgr_set
            from .lr import SGR_PARAMS
            for i in range(2):
                radius = SGR_PARAMS[lr_sgr_set][i * 2]
                mn, mx = self._XQD_MIN[i], self._XQD_MAX[i]
                if radius:
                    v = self._decode_signed_subexp_with_ref(
                        mn, mx + 1, 4, self._ref_sgr_xqd[plane][i])
                else:
                    v = 0
                    if i == 1:
                        v = max(mn, min(mx, (1 << 7) - int(
                            self.lr_sgr_xqd[plane][ur, uc, 0])))
                self.lr_sgr_xqd[plane][ur, uc, i] = v
                self._ref_sgr_xqd[plane][i] = v

    # ---------------------------------------------------------- partition

    def _decode_partition(self, mr: int, mc: int, bsize: int) -> None:
        if mr >= self.mr1 or mc >= self.mc1:
            return
        w, h = T.BLOCK_SIZES[bsize]
        mi_w, mi_h = w // 4, h // 4
        has_rows = mr + mi_h // 2 < self.mr1
        has_cols = mc + mi_w // 2 < self.mc1
        r = self.r
        bsl = mi_w.bit_length() - 1  # log2 of mi width (4x4→0)

        if bsize == T.BLOCK_4X4:
            part = T.PARTITION_NONE
        else:
            above = (int(self.above_part[mc]) >> bsl) & 1
            left = (int(self.left_part[mr - self.sb_mi_row]) >> bsl) & 1
            ctx = left * 2 + above
            cdf_row = self.cdf.partition[(bsl - 1) * 4 + ctx]
            n_parts = 4 if bsize == T.BLOCK_8X8 else \
                8 if bsize == T.BLOCK_128X128 else 10
            if has_rows and has_cols:
                part = r.read_symbol_n(cdf_row, n_parts)
            elif has_cols:
                split = self._read_split_bool(cdf_row, n_parts, vert=True)
                part = T.PARTITION_SPLIT if split else T.PARTITION_HORZ
            elif has_rows:
                split = self._read_split_bool(cdf_row, n_parts, vert=False)
                part = T.PARTITION_SPLIT if split else T.PARTITION_VERT
            else:
                part = T.PARTITION_SPLIT

        sub = int(T.PARTITION_SUBSIZE[part][bsize])
        half_w, half_h = mi_w // 2, mi_h // 2
        quarter_w, quarter_h = mi_w // 4, mi_h // 4

        self._cur_partition = part
        if part == T.PARTITION_NONE:
            self._decode_block(mr, mc, bsize)
        elif part == T.PARTITION_HORZ:
            self._decode_block(mr, mc, sub)
            if has_rows:
                self._decode_block(mr + half_h, mc, sub)
        elif part == T.PARTITION_VERT:
            self._decode_block(mr, mc, sub)
            if has_cols:
                self._decode_block(mr, mc + half_w, sub)
        elif part == T.PARTITION_SPLIT:
            self._decode_partition(mr, mc, sub)
            self._decode_partition(mr, mc + half_w, sub)
            self._decode_partition(mr + half_h, mc, sub)
            self._decode_partition(mr + half_w if False else mr + half_h,
                                   mc + half_w, sub)
        elif part == T.PARTITION_HORZ_A:
            qtr = int(T.PARTITION_SUBSIZE[T.PARTITION_SPLIT][bsize])
            self._decode_block(mr, mc, qtr)
            self._decode_block(mr, mc + half_w, qtr)
            self._decode_block(mr + half_h, mc, sub)
        elif part == T.PARTITION_HORZ_B:
            qtr = int(T.PARTITION_SUBSIZE[T.PARTITION_SPLIT][bsize])
            self._decode_block(mr, mc, sub)
            self._decode_block(mr + half_h, mc, qtr)
            self._decode_block(mr + half_h, mc + half_w, qtr)
        elif part == T.PARTITION_VERT_A:
            qtr = int(T.PARTITION_SUBSIZE[T.PARTITION_SPLIT][bsize])
            self._decode_block(mr, mc, qtr)
            self._decode_block(mr + half_h, mc, qtr)
            self._decode_block(mr, mc + half_w, sub)
        elif part == T.PARTITION_VERT_B:
            qtr = int(T.PARTITION_SUBSIZE[T.PARTITION_SPLIT][bsize])
            self._decode_block(mr, mc, sub)
            self._decode_block(mr, mc + half_w, qtr)
            self._decode_block(mr + half_h, mc + half_w, qtr)
        elif part == T.PARTITION_HORZ_4:
            for i in range(4):
                row = mr + quarter_h * i
                if row >= self.mr1:
                    break
                self._decode_block(row, mc, sub)
        elif part == T.PARTITION_VERT_4:
            for i in range(4):
                col = mc + quarter_w * i
                if col >= self.mc1:
                    break
                self._decode_block(mr, col, sub)

        # context updates (aom update_ext_partition_context): A/B types
        # mark their quarter rows/cols with the split subsize lookup
        bsize2 = int(T.PARTITION_SUBSIZE[T.PARTITION_SPLIT][bsize])
        if part == T.PARTITION_SPLIT and bsize != T.BLOCK_8X8:
            pass    # children updated their own contexts
        elif part == T.PARTITION_HORZ_A:
            self._update_partition_ctx(mr, mc, sub, bsize2)
            self._update_partition_ctx(mr + half_h, mc, sub, sub)
        elif part == T.PARTITION_HORZ_B:
            self._update_partition_ctx(mr, mc, sub, sub)
            self._update_partition_ctx(mr + half_h, mc, sub, bsize2)
        elif part == T.PARTITION_VERT_A:
            self._update_partition_ctx(mr, mc, sub, bsize2)
            self._update_partition_ctx(mr, mc + half_w, sub, sub)
        elif part == T.PARTITION_VERT_B:
            self._update_partition_ctx(mr, mc, sub, sub)
            self._update_partition_ctx(mr, mc + half_w, sub, bsize2)
        else:
            self._update_partition_ctx(mr, mc, bsize, sub)

    def _prob(self, cdf_row, k: int) -> int:
        hi = 32768 if k == 0 else int(cdf_row[k - 1])
        return hi - int(cdf_row[k])

    def _read_split_bool(self, cdf_row, n_parts: int, vert: bool) -> int:
        """Edge partition bool (aom partition_gather_*_alike)."""
        if vert:
            # bottom rows missing → SPLIT vs HORZ: gather partitions
            # whose top half is split vertically (aom
            # partition_gather_vert_alike)
            subtract = [T.PARTITION_VERT, T.PARTITION_SPLIT,
                        T.PARTITION_HORZ_A, T.PARTITION_VERT_A,
                        T.PARTITION_VERT_B]
            if n_parts > 8:
                subtract.append(T.PARTITION_VERT_4)
        else:
            # right cols missing → SPLIT vs VERT: partitions whose left
            # half is split horizontally (partition_gather_horz_alike)
            subtract = [T.PARTITION_HORZ, T.PARTITION_SPLIT,
                        T.PARTITION_HORZ_A, T.PARTITION_HORZ_B,
                        T.PARTITION_VERT_A]
            if n_parts > 8:
                subtract.append(T.PARTITION_HORZ_4)
        s = sum(self._prob(cdf_row, k) for k in subtract if k < n_parts)
        # icdf row [s, 0]: P(symbol1) = s/32768 → symbol 1 = SPLIT-like
        return self.r.read_symbol_n([s, 0, 0], 2) if False else \
            self.r.read_bool([s, 0, 0])

    def _update_partition_ctx(self, mr, mc, bsize, subsize) -> None:
        """Store the neighbor-context byte: bit b set ⇔ a size-b query
        sees this block as split finer (so an equal-size neighbor gives
        ctx bit 0).  The value must keep 6 bits — bit 5 answers
        128-level queries in sb128 streams; masking to 5 bits made that
        query read 0 and desynced multi-SB 128-superblock streams
        (caught by the example.avif oracle difftest)."""
        w, h = T.BLOCK_SIZES[bsize]
        sw, sh = T.BLOCK_SIZES[subsize]
        mi_w, mi_h = w // 4, h // 4
        above_val = (64 - (2 << ((sw // 4).bit_length() - 1))) & 63
        left_val = (64 - (2 << ((sh // 4).bit_length() - 1))) & 63
        self.above_part[mc:mc + mi_w] = above_val
        lr = mr - self.sb_mi_row
        self.left_part[lr:lr + mi_h] = left_val

    # -------------------------------------------------------------- block

    def _decode_block(self, mr: int, mc: int, bsize: int) -> None:
        if mr >= self.mr1 or mc >= self.mc1:
            return
        seq, fh, r = self.seq, self.fh, self.r
        w, h = T.BLOCK_SIZES[bsize]
        mi_w, mi_h = max(w // 4, 1), max(h // 4, 1)

        have_above = mr > self.mr0
        have_left = mc > self.mc0

        # ---- skip ----
        a_skip = int(self.above_skip[mc]) if have_above else 0
        l_skip = int(self.left_skip[mr - self.sb_mi_row]) if have_left else 0
        skip = r.read_symbol_n(self.cdf.skip[a_skip + l_skip], 2)

        # ---- cdef index (spec read_cdef 5.11.56): one literal per
        # 64x64 unit, read at the first non-skip block ----
        if not skip and not fh.coded_lossless and seq.enable_cdef and \
                not fh.allow_intrabc:
            r1, c1 = mr & ~15, mc & ~15
            if self.cdef_idx[r1, c1] == -1:
                idx = r.read_literal(fh.cdef.bits)
                # blocks >64x64 cover several cdef units (spec loop)
                for i in range(r1, r1 + max(mi_h, 1), 16):
                    for j in range(c1, c1 + max(mi_w, 1), 16):
                        if i < self.mi_rows and j < self.mi_cols:
                            self.cdef_idx[i, j] = idx

        # delta q / delta lf (disabled by construction for our streams)
        if fh.delta_q_present:
            raise HeifError.unsupported(SubError.Unsupported_codec,
                                        "delta_q in tiles")

        # ---- intra block copy (spec 5.11.17 intra_frame_mode_info) ----
        if fh.allow_intrabc and r.read_symbol_n(self.cdf.intrabc, 2):
            self._block_intrabc(mr, mc, bsize, skip)
            return

        # ---- y mode (kf contexts from above/left modes) ----
        above_mode = int(self.y_modes[mr - 1, mc]) if have_above \
            else T.DC_PRED
        left_mode = int(self.y_modes[mr, mc - 1]) if have_left \
            else T.DC_PRED
        ctx_a = T.INTRA_MODE_CONTEXT[above_mode]
        ctx_l = T.INTRA_MODE_CONTEXT[left_mode]
        y_mode = r.read_symbol(self.cdf.kf_y_mode[ctx_a][ctx_l])
        angle_y = 0
        if y_mode in T.MODE_TO_ANGLE and self._use_angle_delta(bsize):
            sym = r.read_symbol(self.cdf.angle_delta[y_mode - T.V_PRED])
            angle_y = sym - 3

        # ---- chroma ----
        has_chroma = self._has_chroma(mr, mc, bsize)
        uv_mode = T.DC_PRED
        angle_uv = 0
        cfl_alpha_u = cfl_alpha_v = 0
        if has_chroma:
            cfl_allowed = self._cfl_allowed(w, h, bsize)
            uv_mode = r.read_symbol_n(
                self.cdf.uv_mode[1 if cfl_allowed else 0][y_mode],
                14 if cfl_allowed else 13)
            if uv_mode == T.UV_CFL_PRED:
                # read_cfl_alphas (spec §5.11.45)
                js = r.read_symbol_n(self.cdf.cfl_sign, 8)
                sign_u, sign_v = (js + 1) // 3, (js + 1) % 3
                alpha_u = alpha_v = 0
                if sign_u != 0:
                    idx = r.read_symbol_n(self.cdf.cfl_alpha[js - 2], 16)
                    alpha_u = (idx + 1) * (1 if sign_u == 2 else -1)
                if sign_v != 0:
                    ctx_v = sign_v * 3 + sign_u - 3
                    idx = r.read_symbol_n(self.cdf.cfl_alpha[ctx_v], 16)
                    alpha_v = (idx + 1) * (1 if sign_v == 2 else -1)
                self._cfl_alphas = (alpha_u, alpha_v)
            if uv_mode in T.MODE_TO_ANGLE and self._use_angle_delta(bsize):
                sym = r.read_symbol(
                    self.cdf.angle_delta[uv_mode - T.V_PRED])
                angle_uv = sym - 3

        # palette (spec palette_mode_info 5.11.46)
        self._pal = {"y": None, "u": None, "v": None,
                     "y_map": None, "uv_map": None}
        has_pal_y = 0
        # (aom av1_allow_palette: enum-based gate — the extended
        # rectangular sizes 4X16/16X4/8X32/... sort above BLOCK_8X8 and
        # DO signal palette flags)
        if fh.allow_screen_content_tools and bsize >= T.BLOCK_8X8 and \
                w <= 64 and h <= 64:
            from . import palette as P
            if y_mode == T.DC_PRED:
                bctx = (w * h).bit_length() - 1 - 6   # log2 pels - log2 64
                pal_ctx = (int(self.pal_y[mr - 1, mc]) if have_above
                           else 0) + \
                    (int(self.pal_y[mr, mc - 1]) if have_left else 0)
                has_pal_y = r.read_symbol_n(
                    self.cdf.palette_y_mode[bctx][pal_ctx], 2)
                if has_pal_y:
                    n_y = r.read_symbol_n(
                        self.cdf.palette_y_size[bctx], 7) + 2
                    cache = P.get_palette_cache(
                        self.pal_y_colors, mr, mc, self.mr0, self.mc0)
                    self._pal["y"] = P.read_colors_y(r, cache, n_y, self.bd)
            if has_chroma and uv_mode == T.DC_PRED:
                bctx = (w * h).bit_length() - 1 - 6
                has_pal_uv = r.read_symbol_n(
                    self.cdf.palette_uv_mode[1 if has_pal_y else 0], 2)
                if has_pal_uv:
                    n_uv = r.read_symbol_n(
                        self.cdf.palette_uv_size[bctx], 7) + 2
                    cache = P.get_palette_cache(
                        self.pal_u_colors, mr, mc, self.mr0, self.mc0)
                    cu, cv = P.read_colors_uv(r, cache, n_uv, self.bd)
                    self._pal["u"], self._pal["v"] = cu, cv
        self._fi_mode = None
        if seq.enable_filter_intra and y_mode == T.DC_PRED and \
                self._pal["y"] is None and \
                w <= 32 and h <= 32:
            use_fi = r.read_symbol_n(
                self._filter_intra_cdf(bsize), 2)
            if use_fi:
                self._fi_mode = r.read_symbol_n(
                    self.cdf.filter_intra_mode, 5)

        # palette color-index maps: parsed before the tx-size symbol
        # (empirically pinned against libaom decode order)
        if self._pal["y"] is not None or self._pal["u"] is not None:
            from . import palette as P
            vis_h = min(h, (self.mi_rows - mr) * 4)
            vis_w = min(w, (self.mi_cols - mc) * 4)
            if self._pal["y"] is not None:
                self._pal["y_map"] = P.read_color_map(
                    r, self.cdf.palette_y_color, len(self._pal["y"]),
                    vis_h, vis_w, h, w)
                self._pal["y_org"] = (mc * 4, mr * 4)
            if self._pal["u"] is not None:
                # spec 5.11.50 palette_tokens: sub-8 chroma dims (<4
                # after subsampling) are extended by +2 columns/rows —
                # the ONSCREEN dims too, so those extra indices are
                # parsed, not replicated (a 16x4 block at an odd mi row
                # covers the snapped 8x4 chroma pair; parsing only 2
                # rows desynced the coder on screen-content streams)
                cbw = w >> self.ssx
                cbh = h >> self.ssy
                ovw = vis_w >> self.ssx
                ovh = vis_h >> self.ssy
                if cbw < 4:
                    cbw += 2
                    ovw += 2
                if cbh < 4:
                    cbh += 2
                    ovh += 2
                self._pal["uv_map"] = P.read_color_map(
                    r, self.cdf.palette_uv_color, len(self._pal["u"]),
                    ovh, ovw, cbh, cbw)

        # ---- tx size ----
        if fh.coded_lossless:
            tx = T.TX_4X4
        elif not fh.tx_mode_select or skip:
            tx = T.MAX_TX_SIZE_RECT[bsize]
        else:
            tx = self._read_tx_size(mr, mc, bsize, have_above, have_left)

        # record maps
        self.bsize_map[mr:mr + mi_h, mc:mc + mi_w] = bsize
        self.y_modes[mr:mr + mi_h, mc:mc + mi_w] = y_mode
        self.uv_modes[mr:mr + mi_h, mc:mc + mi_w] = uv_mode
        self.skip_map[mr:mr + mi_h, mc:mc + mi_w] = skip
        self.pal_y[mr:mr + mi_h, mc:mc + mi_w] = \
            1 if self._pal["y"] is not None else 0
        for rr in range(mr, min(mr + mi_h, self.mi_rows)):
            for cc2 in range(mc, min(mc + mi_w, self.mi_cols)):
                self.pal_y_colors[rr][cc2] = self._pal["y"]
                self.pal_u_colors[rr][cc2] = self._pal["u"]
        self.above_skip[mc:mc + mi_w] = skip
        self.left_skip[mr - self.sb_mi_row:
                       mr - self.sb_mi_row + mi_h] = skip
        self.tx_wide[mr:mr + mi_h, mc:mc + mi_w] = T.tx_w(tx)
        self.tx_high[mr:mr + mi_h, mc:mc + mi_w] = T.tx_h(tx)

        # intra-edge filter type (aom get_filt_type): 1 when the above
        # or left neighbor block used a smooth mode
        def smooth(m):
            return m in (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED)
        ab_y = int(self.y_modes[mr - 1, mc]) if have_above else -1
        le_y = int(self.y_modes[mr, mc - 1]) if have_left else -1
        self._filt_type_y = 1 if (smooth(ab_y) or smooth(le_y)) else 0
        cr_ = mr & ~1 if (h // 4) == 1 else mr
        cc_ = mc & ~1 if (w // 4) == 1 else mc
        # chroma neighbor mbmi: the bottom-right-most mi of the above /
        # left chroma reference block — row -1 col +ssx above, row +ssy
        # col -1 left of the chroma-group origin (aom set_mi_row_col
        # chroma_above/left_mbmi; caught by the lossless 4x4 oracle
        # difftest)
        ac_ = min(cc_ + self.ssx, self.mi_cols - 1)
        lr_ = min(cr_ + self.ssy, self.mi_rows - 1)
        ab_uv = int(self.uv_modes[cr_ - 1, ac_]) if cr_ > self.mr0 else -1
        le_uv = int(self.uv_modes[lr_, cc_ - 1]) if cc_ > self.mc0 else -1
        self._filt_type_uv = 1 if (smooth(ab_uv) or smooth(le_uv)) else 0

        # ---- residual + recon ----
        self._residual(mr, mc, bsize, y_mode, uv_mode, angle_y, angle_uv,
                       tx, skip, has_chroma)

    # ------------------------------------------------------------ intrabc

    _IBC_DELAY_PX = 256          # INTRABC_DELAY_PIXELS

    def _ref_dv(self, mr: int, mc: int, bsize: int):
        """DV predictor: faithful port of aom setup_ref_mv_list for
        the intrabc case (mvref_common.c; spatial scans only, weights
        with REF_CAT_LEVEL boost, stable weight sort), then
        av1_find_best_ref_mvs (integer precision, clamp) and the
        av1_find_ref_dv fallback."""
        w, h = T.BLOCK_SIZES[bsize]
        bw4, bh4 = max(w // 4, 1), max(h // 4, 1)
        stack = []                    # [mv]
        weight = []
        state = {"row_match": 0, "col_match": 0, "processed_rows": 0,
                 "processed_cols": 0}

        def cand_at(rr, cc):
            """(mv, cand_w4, cand_h4) or None; only intrabc blocks
            carry motion in intra frames."""
            if rr < self.mr0 or cc < self.mc0 or rr >= self.mr1 or \
                    cc >= self.mc1:
                return None
            if not self.ibc_on[rr, cc]:
                bs = int(self.bsize_map[rr, cc])
                cw, chh = T.BLOCK_SIZES[bs]
                return (None, max(cw // 4, 1), max(chh // 4, 1))
            bs = int(self.bsize_map[rr, cc])
            cw, chh = T.BLOCK_SIZES[bs]
            return ((int(self.ibc_mv[rr, cc, 0]),
                     int(self.ibc_mv[rr, cc, 1])),
                    max(cw // 4, 1), max(chh // 4, 1))

        def add(mv, wt, match_key=None):
            for i, m in enumerate(stack):
                if m == mv:
                    weight[i] += wt
                    return
            if len(stack) < 8:
                stack.append(mv)
                weight.append(wt)

        def scan_row(row_offset, max_row_offset):
            end_mi = min(bw4, self.mi_cols - mc, 16)
            col_off = 0
            if abs(row_offset) > 1:
                col_off = 1
                if (mc & 1) and bw4 < 2:
                    col_off -= 1
            use_step_16 = bw4 >= 16
            i = 0
            while i < end_mi:
                c = cand_at(mr + row_offset, mc + col_off + i)
                if c is None:
                    break
                mv, cw4, ch4 = c
                ln = min(bw4, cw4)
                if use_step_16:
                    ln = max(4, ln)
                elif abs(row_offset) > 1:
                    ln = max(ln, 2)
                wt = 2
                if bw4 >= 2 and bw4 <= cw4:
                    inc = min(-max_row_offset + row_offset + 1, ch4)
                    wt = max(wt, inc)
                    state["processed_rows"] = inc - row_offset - 1
                if mv is not None:
                    add(mv, ln * wt)
                    state["row_match"] = 1
                i += ln

        def scan_col(col_offset, max_col_offset):
            end_mi = min(bh4, self.mi_rows - mr, 16)
            row_off = 0
            if abs(col_offset) > 1:
                row_off = 1
                if (mr & 1) and bh4 < 2:
                    row_off -= 1
            use_step_16 = bh4 >= 16
            i = 0
            while i < end_mi:
                c = cand_at(mr + row_off + i, mc + col_offset)
                if c is None:
                    break
                mv, cw4, ch4 = c
                ln = min(bh4, ch4)
                if use_step_16:
                    ln = max(4, ln)
                elif abs(col_offset) > 1:
                    ln = max(ln, 2)
                wt = 2
                if bh4 >= 2 and bh4 <= ch4:
                    inc = min(-max_col_offset + col_offset + 1, cw4)
                    wt = max(wt, inc)
                    state["processed_cols"] = inc - col_offset - 1
                if mv is not None:
                    add(mv, ln * wt)
                    state["col_match"] = 1
                i += ln

        def scan_point(row_offset, col_offset):
            c = cand_at(mr + row_offset, mc + col_offset)
            if c is not None and c[0] is not None:
                add(c[0], 4)
                if row_offset == -1 and col_offset == bw4:
                    state["row_match"] = 1

        up_avail = mr > self.mr0
        left_avail = mc > self.mc0
        row_adj = 1 if (bh4 < 2 and (mr & 1)) else 0
        col_adj = 1 if (bw4 < 2 and (mc & 1)) else 0
        max_row_offset = 0
        if up_avail:
            max_row_offset = -(3 << 1) + row_adj
            if bh4 < 2:
                max_row_offset = -(2 << 1) + row_adj
            max_row_offset = max(max_row_offset, self.mr0 - mr)
        max_col_offset = 0
        if left_avail:
            max_col_offset = -(3 << 1) + col_adj
            if bw4 < 2:
                max_col_offset = -(2 << 1) + col_adj
            max_col_offset = max(max_col_offset, self.mc0 - mc)

        if up_avail:
            scan_row(-1, max_row_offset)
        if left_avail:
            scan_col(-1, max_col_offset)
        if up_avail and self._has_top_right(mr, mc, bw4, bh4):
            scan_point(-1, bw4)

        nearest_count = len(stack)
        for i in range(nearest_count):
            weight[i] += 640                    # REF_CAT_LEVEL
        if up_avail and left_avail:
            scan_point(-1, -1)
        for idx in range(2, 4):                 # MVREF_ROW_COLS = 3
            row_offset = -(idx << 1) + 1 + row_adj
            col_offset = -(idx << 1) + 1 + col_adj
            if up_avail and abs(row_offset) <= abs(max_row_offset) and \
                    abs(row_offset) > state["processed_rows"]:
                scan_row(row_offset, max_row_offset)
            if left_avail and abs(col_offset) <= abs(max_col_offset) and \
                    abs(col_offset) > state["processed_cols"]:
                scan_col(col_offset, max_col_offset)

        # stable weight sort: nearest group, then the rest (aom bubble)
        def bubble(lo, hi):
            ln = hi
            while ln > lo:
                nr = lo
                for i in range(lo + 1, ln):
                    if weight[i - 1] < weight[i]:
                        stack[i - 1], stack[i] = stack[i], stack[i - 1]
                        weight[i - 1], weight[i] = weight[i], weight[i - 1]
                        nr = i
                ln = nr
        bubble(0, nearest_count)
        bubble(nearest_count, len(stack))

        # mv_ref_list: clamp + integer precision (find_best_ref_mvs)
        def clamp_ref(mv):
            # aom clamp_mv_ref: bounds are the block edges widened by
            # the block dims and MV_BORDER = (16 << 3) = 128 eighth-pel
            # (16 full pels — NOT 128 pels; the wider bound almost
            # never binds and let far-out-of-range candidates through,
            # desyncing the lossless intrabc sweep)
            bw_px, bh_px = bw4 * 4, bh4 * 4
            lo_c = -(mc * 4) * 8 - bw_px * 8 - 128
            hi_c = (self.mi_cols * 4 - mc * 4 - bw_px) * 8 + bw_px * 8 \
                + 128
            lo_r = -(mr * 4) * 8 - bh_px * 8 - 128
            hi_r = (self.mi_rows * 4 - mr * 4 - bh_px) * 8 + bh_px * 8 \
                + 128
            return (min(max(mv[0], lo_r), hi_r),
                    min(max(mv[1], lo_c), hi_c))

        def to_integer(v):
            m = v % 8 if v >= 0 else -((-v) % 8)
            v -= m
            if abs(m) > 4:
                v += 8 if m > 0 else -8
            return v

        lst = []
        for i in range(min(2, len(stack))):
            mv = clamp_ref(stack[i])
            lst.append((to_integer(mv[0]), to_integer(mv[1])))
        while len(lst) < 2:
            lst.append((0, 0))
        dv = lst[0] if lst[0] != (0, 0) else lst[1]
        if dv == (0, 0):
            sb_mi = self.sb_mi
            if mr - sb_mi < self.mr0:       # first superblock row
                dv = (0, -(4 * sb_mi + self._IBC_DELAY_PX) * 8)
            else:
                dv = (-4 * sb_mi * 8, 0)
        # ref DV is full-pel by construction here
        return ((dv[0] >> 3) * 8, (dv[1] >> 3) * 8)

    def _has_top_right(self, mr, mc, bw4, bh4) -> bool:
        """(aom has_top_right), without the PARTITION_VERT_A special
        case refinement beyond the stored partition."""
        sb_mi = self.sb_mi
        bs = max(bw4, bh4)
        if bs > 16:
            return False
        mask_row = mr & (sb_mi - 1)
        mask_col = mc & (sb_mi - 1)
        has_tr = not ((mask_row & bs) and (mask_col & bs))
        b = bs
        while b < sb_mi:
            if mask_col & b:
                if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                    has_tr = False
                    break
            else:
                break
            b <<= 1
        # rectangular refinements (aom is_sec_rect)
        if bw4 < bh4:
            is_sec_rect = ((mc + bw4) & (bh4 - 1)) == 0
            if not is_sec_rect:
                has_tr = True
        if bw4 > bh4:
            is_sec_rect = (mr & (bw4 - 1)) != 0
            if is_sec_rect:
                has_tr = False
        if getattr(self, "_cur_partition", 0) == T.PARTITION_VERT_A:
            if bw4 == bh4 and (mask_row & bs):
                has_tr = False
        return has_tr

    def _read_dv_component(self, comp: int) -> int:
        r = self.r
        sign = r.read_symbol_n(self.cdf.dv_sign[comp], 2)
        cls = r.read_symbol(self.cdf.dv_classes[comp])
        if cls == 0:
            d = r.read_symbol_n(self.cdf.dv_class0[comp], 2)
            mag0 = 0
        else:
            d = 0
            for i in range(cls):
                d |= r.read_symbol_n(self.cdf.dv_bits[comp][i], 2) << i
            mag0 = 2 << (cls + 2)
        # integer precision: fr = 3, hp = 1 implied (MV_SUBPEL_NONE)
        mag = mag0 + ((d << 3) | (3 << 1) | 1) + 1
        return -mag if sign else mag

    def _read_dv(self, ref):
        r = self.r
        j = r.read_symbol_n(self.cdf.dv_joints, 4)
        drow = self._read_dv_component(0) if j in (2, 3) else 0
        dcol = self._read_dv_component(1) if j in (1, 3) else 0
        return (ref[0] + drow, ref[1] + dcol)

    def _txfm_partition_ctx(self, px: int, py: int, bsize: int,
                            tx: int) -> int:
        """(aom txfm_partition_context); the tx_wide/tx_high maps stand
        in for the running above/left TXFM context arrays (leaves write
        their dims as they are read, tile edges read 64)."""
        txw, txh = T.tx_w(tx), T.tx_h(tx)
        bx, by = px >> 2, py >> 2
        above_v = 64
        if by - 1 >= self.mr0:
            v = int(self.tx_wide[by - 1, bx])
            above_v = v if v else 64
        left_v = 64
        if bx - 1 >= self.mc0:
            v = int(self.tx_high[by, bx - 1])
            left_v = v if v else 64
        above = 1 if above_v < txw else 0
        left = 1 if left_v < txh else 0
        w, h = T.BLOCK_SIZES[bsize]
        max_dim = max(w, h)
        sizes = [4, 8, 16, 32, 64]
        max_tx_sq = sizes.index(min(max_dim, 64))     # square tx index
        category = (1 if (T.TX_SIZES[T.TX_SIZE_SQR_UP[tx]][0] !=
                          min(max_dim, 64) and max_tx_sq > 1) else 0) + \
            (len(sizes) - 1 - max_tx_sq) * 2
        return category * 3 + above + left

    def _vartx_node(self, bsize, tx, depth, px, py, tus) -> None:
        r = self.r
        tw, th = T.tx_w(tx), T.tx_h(tx)
        if depth == 2 or tx == T.TX_4X4:
            split = 0
        else:
            ctx = self._txfm_partition_ctx(px, py, bsize, tx)
            split = r.read_symbol_n(self.cdf.txfm_partition[ctx], 2)
        if split:
            sub = T.SPLIT_TX_SIZE[tx]
            if sub == T.TX_4X4:
                # whole node becomes 4x4 leaves, no further symbols
                for yy in range(py, py + th, 4):
                    for xx in range(px, px + tw, 4):
                        tus.append((xx, yy, T.TX_4X4))
                self._mark_tx_dims(px, py, tw, th, 4, 4)
                return
            sw, sh = T.tx_w(sub), T.tx_h(sub)
            for yy in range(py, py + th, sh):
                for xx in range(px, px + tw, sw):
                    self._vartx_node(bsize, sub, depth + 1, xx, yy, tus)
        else:
            tus.append((px, py, tx))
            self._mark_tx_dims(px, py, tw, th, tw, th)

    def _mark_tx_dims(self, px, py, tw, th, vw, vh) -> None:
        bx, by = px >> 2, py >> 2
        nw, nh = max(tw // 4, 1), max(th // 4, 1)
        self.tx_wide[by:by + nh, bx:bx + nw] = vw
        self.tx_high[by:by + nh, bx:bx + nw] = vh

    def _block_intrabc(self, mr: int, mc: int, bsize: int,
                       skip: int) -> None:
        seq, fh, r = self.seq, self.fh, self.r
        w, h = T.BLOCK_SIZES[bsize]
        mi_w, mi_h = max(w // 4, 1), max(h // 4, 1)

        dv_ref = self._ref_dv(mr, mc, bsize)
        mv = self._read_dv(dv_ref)

        self._use_intrabc = True
        self._fi_mode = None
        self._pal = {"y": None, "u": None, "v": None,
                     "y_map": None, "uv_map": None}
        has_chroma = self._has_chroma(mr, mc, bsize)

        # maps: modes stay DC (neighbor mode contexts see DC), record DV
        self.bsize_map[mr:mr + mi_h, mc:mc + mi_w] = bsize
        self.skip_map[mr:mr + mi_h, mc:mc + mi_w] = skip
        self.above_skip[mc:mc + mi_w] = skip
        self.left_skip[mr - self.sb_mi_row:
                       mr - self.sb_mi_row + mi_h] = skip
        self.pal_y[mr:mr + mi_h, mc:mc + mi_w] = 0
        self.ibc_on[mr:mr + mi_h, mc:mc + mi_w] = 1
        self.ibc_mv[mr:mr + mi_h, mc:mc + mi_w, 0] = mv[0]
        self.ibc_mv[mr:mr + mi_h, mc:mc + mi_w, 1] = mv[1]

        # ---- tx sizes ----
        luma_tus = []
        x0, y0 = mc * 4, mr * 4
        if fh.coded_lossless:
            tx = T.TX_4X4
            for yy in range(y0, y0 + h, 4):
                for xx in range(x0, x0 + w, 4):
                    luma_tus.append((xx, yy, tx))
            self._mark_tx_dims(x0, y0, w, h, 4, 4)
        elif skip or not fh.tx_mode_select:
            tx = T.MAX_TX_SIZE_RECT[bsize]
            tw, th = T.tx_w(tx), T.tx_h(tx)
            for yy in range(y0, y0 + h, th):
                for xx in range(x0, x0 + w, tw):
                    luma_tus.append((xx, yy, tx))
            if skip:
                # aom set_txfm_ctxs: skipped inter blocks record BLOCK
                # dims in the txfm context
                self._mark_tx_dims(x0, y0, w, h, w, h)
            else:
                self._mark_tx_dims(x0, y0, w, h, tw, th)
        else:
            max_tx = T.MAX_TX_SIZE_RECT[bsize]
            tw, th = T.tx_w(max_tx), T.tx_h(max_tx)
            for yy in range(y0, y0 + h, th):
                for xx in range(x0, x0 + w, tw):
                    self._vartx_node(bsize, max_tx, 0, xx, yy, luma_tus)

        # ---- prediction jobs: block copy per plane (before residual
        # TUs so the deferred replay applies copy then adds) ----
        self.jobs.append(TxbJob(
            plane=0, px=x0, py=y0, tw=w, th=h, tx=0, mode=0, angle=0,
            have_above=False, have_left=False, n_tr=0, n_bl=0,
            filt_type=0, fi_mode=None, pal_pred=None, cfl_alpha=0,
            is_cfl=False, eob=0, coeffs=None, tx_type=T.DCT_DCT,
            qindex=self._cur_qindex,
            hh=min(h, self.mi_rows * 4 - y0),
            ww=min(w, self.mi_cols * 4 - x0), ibc_mv=mv))
        if has_chroma and self.num_planes > 1:
            cw = max(w >> self.ssx, 4)
            chh = max(h >> self.ssy, 4)
            cx = (x0 >> self.ssx) & ~(0 if not self.ssx else 0)
            # chroma origin snaps to the chroma-pair origin
            cr_ = mr & ~1 if mi_h == 1 and self.ssy else mr
            cc_ = mc & ~1 if mi_w == 1 and self.ssx else mc
            cx = (cc_ * 4) >> self.ssx
            cy = (cr_ * 4) >> self.ssy
            for plane in (1, 2):
                pw = (self.mi_cols * 4) >> self.ssx
                ph = (self.mi_rows * 4) >> self.ssy
                self.jobs.append(TxbJob(
                    plane=plane, px=cx, py=cy, tw=cw, th=chh, tx=0,
                    mode=0, angle=0, have_above=False, have_left=False,
                    n_tr=0, n_bl=0, filt_type=0, fi_mode=None,
                    pal_pred=None, cfl_alpha=0, is_cfl=False, eob=0,
                    coeffs=None, tx_type=T.DCT_DCT,
                    qindex=self._cur_qindex,
                    hh=min(chh, ph - cy), ww=min(cw, pw - cx),
                    ibc_mv=mv))

        # ---- residual ----
        if not skip:
            self._residual_intrabc(mr, mc, bsize, luma_tus, has_chroma)
        else:
            # aom av1_reset_entropy_context: a skipped block zeroes the
            # above/left level + dc-sign context buffers over its
            # extent (the intra path does this through its cul=0 TU
            # writes; without it the next residual block reads stale
            # dc-sign / txb-skip contexts and desyncs)
            u_c = x0 // 4
            lrow = (mr - self.sb_mi_row)
            self.above_lvl[0][u_c:u_c + mi_w] = 0
            self.left_lvl[0][lrow:lrow + mi_h] = 0
            self.above_sign[0][u_c:u_c + mi_w] = 0
            self.left_sign[0][lrow:lrow + mi_h] = 0
            if has_chroma and self.num_planes > 1:
                cr_ = mr & ~1 if mi_h == 1 and self.ssy else mr
                cc_ = mc & ~1 if mi_w == 1 and self.ssx else mc
                cu_c = ((cc_ * 4) >> self.ssx) // 4
                clrow = (((cr_ - self.sb_mi_row) * 4) >> self.ssy) // 4
                cw_c = max((max(w, 8 if self.ssx else 4) >> self.ssx)
                           // 4, 1)
                ch_c = max((max(h, 8 if self.ssy else 4) >> self.ssy)
                           // 4, 1)
                for plane in (1, 2):
                    self.above_lvl[plane][cu_c:cu_c + cw_c] = 0
                    self.left_lvl[plane][clrow:clrow + ch_c] = 0
                    self.above_sign[plane][cu_c:cu_c + cw_c] = 0
                    self.left_sign[plane][clrow:clrow + ch_c] = 0

        self._use_intrabc = False
        self.block_decoded[0][mr + 1:mr + 1 + mi_h,
                              mc + 1:mc + 1 + mi_w] = 1
        if has_chroma and self.num_planes > 1:
            cr_ = mr & ~1 if mi_h == 1 and self.ssy else mr
            cc_ = mc & ~1 if mi_w == 1 and self.ssx else mc
            ch4 = max(mi_h >> self.ssy, 1)
            cw4 = max(mi_w >> self.ssx, 1)
            for plane in (1, 2):
                self.block_decoded[plane][
                    (cr_ >> self.ssy) + 1:(cr_ >> self.ssy) + 1 + ch4,
                    (cc_ >> self.ssx) + 1:(cc_ >> self.ssx) + 1 + cw4] = 1

    def _residual_intrabc(self, mr, mc, bsize, luma_tus,
                          has_chroma) -> None:
        """Residual for an intrabc block: luma at the var-tx leaves,
        chroma at the plane max tx (spec residual())."""
        fh = self.fh
        w, h = T.BLOCK_SIZES[bsize]
        for (px, py, tx) in luma_tus:
            self._ibc_txb(0, px, py, tx, w, h)
        if has_chroma and self.num_planes > 1:
            cr_ = mr & ~1 if (h // 4) == 1 and self.ssy else mr
            cc_ = mc & ~1 if (w // 4) == 1 and self.ssx else mc
            cw = max(w, 8 if self.ssx else 4) >> self.ssx
            ch_ = max(h, 8 if self.ssy else 4) >> self.ssy
            uv_tx = T.TX_4X4 if fh.coded_lossless \
                else self._uv_tx_size(bsize)
            utw, uth = T.tx_w(uv_tx), T.tx_h(uv_tx)
            cx0, cy0 = (cc_ * 4) >> self.ssx, (cr_ * 4) >> self.ssy
            for plane in range(1, self.num_planes):
                for ty in range(0, ch_, uth):
                    for tx_x in range(0, cw, utw):
                        self._ibc_txb(plane, cx0 + tx_x, cy0 + ty, uv_tx,
                                      cw, ch_)

    def _ibc_txb(self, plane, px, py, tx, blk_w, blk_h) -> None:
        """One intrabc residual tx block: coefficients + an add-only
        job (prediction was written by the block-copy job)."""
        sx = self.ssx if plane else 0
        sy = self.ssy if plane else 0
        pw = (self.mi_cols * 4) >> sx
        ph = (self.mi_rows * 4) >> sy
        if px >= pw or py >= ph:
            return
        tw, th = T.tx_w(tx), T.tx_h(tx)
        self.edges.mark(plane, px, py, tw, th)
        eob, coeffs, cul, dcsign = self._read_coeffs(
            plane, px, py, tx, T.DC_PRED, blk_w, blk_h)
        job = TxbJob(
            plane=plane, px=px, py=py, tw=tw, th=th, tx=tx,
            mode=T.DC_PRED, angle=0, have_above=False, have_left=False,
            n_tr=0, n_bl=0, filt_type=0, fi_mode=None, pal_pred=None,
            cfl_alpha=0, is_cfl=False, eob=eob, coeffs=coeffs,
            tx_type=self._cur_tx_type, qindex=self._cur_qindex,
            hh=min(th, ph - py), ww=min(tw, pw - px), ibc_add=True)
        self.jobs.append(job)
        # context updates (same cells as _transform_block)
        u_c = px // 4
        sb_py = (self.sb_mi_row * 4) >> sy
        lrow = (py - sb_py) // 4
        n_w, n_h = max(tw // 4, 1), max(th // 4, 1)
        w_cells = min(n_w, max((pw - px) // 4, 0))
        h_cells = min(n_h, max((ph - py) // 4, 0))
        self.above_lvl[plane][u_c:u_c + w_cells] = min(int(cul), 63)
        self.left_lvl[plane][lrow:lrow + h_cells] = min(int(cul), 63)
        self.above_sign[plane][u_c:u_c + w_cells] = dcsign
        self.left_sign[plane][lrow:lrow + h_cells] = dcsign

    @staticmethod
    def _use_angle_delta(bsize: int) -> bool:
        # aom av1_use_angle_delta gates on the block-size ENUM
        # (bsize >= BLOCK_8X8): the extended rectangular sizes
        # 16X4/4X16/32X8/... sort above BLOCK_8X8 and DO read angle
        # deltas (caught by the 1:4-partition oracle difftest)
        return bsize >= T.BLOCK_8X8

    def _cfl_allowed(self, w: int, h: int, bsize: int) -> bool:
        # aom is_cfl_allowed; in lossless CfL needs a 4x4 chroma block
        # (validated by the lossless CfL oracle difftest: with the
        # correct cfl_sign defaults, 8x8@420 streams decode bit-exactly
        # under this gate)
        if self.fh.coded_lossless:
            return (w >> self.seq.subsampling_x) <= 4 and \
                (h >> self.seq.subsampling_y) <= 4
        return w <= 32 and h <= 32

    def _filter_intra_cdf(self, bsize):
        return self.cdf.filter_intra_use[bsize]

    def _has_chroma(self, mr: int, mc: int, bsize: int) -> bool:
        if self.num_planes == 1:
            return False
        w, h = T.BLOCK_SIZES[bsize]
        mi_w, mi_h = w // 4, h // 4
        need_c = not (self.ssx and mi_w == 1) or bool(mc & 1)
        need_r = not (self.ssy and mi_h == 1) or bool(mr & 1)
        return need_c and need_r

    def _read_tx_size(self, mr, mc, bsize, have_above, have_left) -> int:
        max_tx = T.MAX_TX_SIZE_RECT[bsize]
        w, h = T.BLOCK_SIZES[bsize]
        if w <= 4 and h <= 4:
            return T.TX_4X4
        sqr_up = T.TX_SIZE_SQR_UP[max_tx]
        cat = [0, 0, 1, 2, 3][
            [4, 8, 16, 32, 64].index(T.tx_w(sqr_up))]
        # context: neighbors having tx at least as large
        # aom get_tx_size_context: sum only over available neighbors;
        # an inter (intrabc) neighbor contributes its BLOCK dims, not
        # its per-leaf tx dims (the var-tx leaves it wrote to the txfm
        # context maps would under-report; caught by the screen-content
        # intrabc oracle sweep)
        def above_ge():
            if self.ibc_on[mr - 1, mc]:
                return int(T.BLOCK_SIZES[int(self.bsize_map[mr - 1, mc])
                                         ][0] >= T.tx_w(max_tx))
            return int(int(self.tx_wide[mr - 1, mc]) >= T.tx_w(max_tx))

        def left_ge():
            if self.ibc_on[mr, mc - 1]:
                return int(T.BLOCK_SIZES[int(self.bsize_map[mr, mc - 1])
                                         ][1] >= T.tx_h(max_tx))
            return int(int(self.tx_high[mr, mc - 1]) >= T.tx_h(max_tx))

        if have_above and have_left:
            ctx = above_ge() + left_ge()
        elif have_above:
            ctx = above_ge()
        elif have_left:
            ctx = left_ge()
        else:
            ctx = 0
        max_depth = self._max_tx_depth(bsize)
        n = min(max_depth + 1, 3)
        depth = self.r.read_symbol_n(self.cdf.tx_size[cat][ctx], n)
        tx = max_tx
        for _ in range(depth):
            tx = T.SPLIT_TX_SIZE[tx]
        return tx

    @staticmethod
    def _max_tx_depth(bsize: int) -> int:
        w, h = T.BLOCK_SIZES[bsize]
        if w == 4 and h == 4:
            return 0
        if max(w, h) == 8:
            return 1
        return 2

    # ----------------------------------------------------------- residual

    def _residual(self, mr, mc, bsize, y_mode, uv_mode, angle_y, angle_uv,
                  tx, skip, has_chroma) -> None:
        """Residual coding in 64x64 chunks (spec residual(): blocks
        larger than 64 interleave luma and chroma per 64x64 region)."""
        w, h = T.BLOCK_SIZES[bsize]
        fh = self.fh
        tw, th = T.tx_w(tx), T.tx_h(tx)
        x0, y0 = mc * 4, mr * 4
        # chroma geometry (shared by all chunks)
        cr, cc = mr, mc
        if self.ssy and (h // 4) == 1:
            cr = mr & ~1
        if self.ssx and (w // 4) == 1:
            cc = mc & ~1
        cw = max(w, 8 if self.ssx else 4) >> self.ssx
        ch = max(h, 8 if self.ssy else 4) >> self.ssy
        uv_tx = T.TX_4X4 if fh.coded_lossless else self._uv_tx_size(bsize)
        utw, uth = T.tx_w(uv_tx), T.tx_h(uv_tx)
        cx0, cy0 = (cc * 4) >> self.ssx, (cr * 4) >> self.ssy
        self._pal["uv_org"] = (cx0, cy0)
        for cy in range(0, h, 64):
            for cx in range(0, w, 64):
                # luma txbs of this chunk
                for ty in range(cy, min(cy + 64, h), th):
                    for tx_x in range(cx, min(cx + 64, w), tw):
                        self._transform_block(0, x0 + tx_x, y0 + ty, tx,
                                              y_mode, angle_y, skip,
                                              mr, mc, bsize)
                if has_chroma:
                    ccy0, ccx0 = cy >> self.ssy, cx >> self.ssx
                    ccy1 = min(ccy0 + (64 >> self.ssy), ch)
                    ccx1 = min(ccx0 + (64 >> self.ssx), cw)
                    for plane in range(1, self.num_planes):
                        for ty in range(ccy0, ccy1, uth):
                            for tx_x in range(ccx0, ccx1, utw):
                                self._transform_block(
                                    plane, cx0 + tx_x, cy0 + ty, uv_tx,
                                    uv_mode, angle_uv, skip, mr, mc,
                                    bsize)

    def _uv_tx_size(self, bsize: int) -> int:
        """aom av1_get_max_uv_txsize: the largest rect tx of the chroma
        plane block, then av1_get_adjusted_tx_size (only 64-px dims
        clamp — 4:1 shapes like TX_4X16 are kept; a 2:1 aspect clamp
        here desynced every 1:4-shaped chroma block, caught by the
        8x32 filter-intra oracle difftest)."""
        w, h = T.BLOCK_SIZES[bsize]
        cw, ch = max(w >> self.ssx, 4), max(h >> self.ssy, 4)
        cw, ch = min(cw, 64), min(ch, 64)
        if cw == 64:
            cw = 32
            ch = min(ch, 32)
        elif ch == 64:
            ch = 32
            cw = min(cw, 32)
        return T.TX_SIZES.index((cw, ch))

    # ------------------------------------------------------- transform blk

    def _transform_block(self, plane, px, py, tx, mode, angle, skip,
                         mr, mc, bsize) -> None:
        """Predict, parse coefficients, reconstruct one tx block.

        px/py are plane-pixel coordinates; context/availability units
        are 4 plane pixels throughout.
        """
        fh, seq, r = self.fh, self.seq, self.r
        sx = self.ssx if plane else 0
        sy = self.ssy if plane else 0
        pw = (self.mi_cols * 4) >> sx
        ph = (self.mi_rows * 4) >> sy
        if px >= pw or py >= ph:
            return
        tw, th = T.tx_w(tx), T.tx_h(tx)
        self.edges.mark(plane, px, py, tw, th)

        dec = self.block_decoded[plane]
        u_r, u_c = py // 4, px // 4
        n_w, n_h = max(tw // 4, 1), max(th // 4, 1)
        have_above = py > 0 and bool(dec[u_r - 1 + 1, u_c + 1])
        have_left = px > 0 and bool(dec[u_r + 1, u_c - 1 + 1])
        n_tr = 0
        if py > 0 and px + tw < pw:
            steps = 0
            cc = u_c + n_w
            while steps < th and (cc * 4) < pw and dec[u_r, cc + 1]:
                steps += 4
                cc += 1
            n_tr = steps
        n_bl = 0
        if px > 0 and py + th < ph:
            steps = 0
            rr = u_r + n_h
            while steps < tw and (rr * 4) < ph and dec[rr + 1, u_c]:
                steps += 4
                rr += 1
            n_bl = steps

        pred_mode = T.DC_PRED if (plane and mode == T.UV_CFL_PRED) else mode
        pal_colors = None
        if plane == 0 and self._pal["y"] is not None:
            pal_colors, pal_map = self._pal["y"], self._pal["y_map"]
            pal_org = self._pal["y_org"]
        elif plane == 1 and self._pal["u"] is not None:
            pal_colors, pal_map = self._pal["u"], self._pal["uv_map"]
            pal_org = self._pal["uv_org"]
        elif plane == 2 and self._pal["v"] is not None:
            pal_colors, pal_map = self._pal["v"], self._pal["uv_map"]
            pal_org = self._pal["uv_org"]
        pal_pred = None
        if pal_colors is not None:
            # palette prediction (spec 7.11.4) depends only on parsed
            # indices — computed here, carried on the job
            rx, ry = px - pal_org[0], py - pal_org[1]
            idxs = pal_map[ry:ry + th, rx:rx + tw]
            pal_pred = np.asarray(pal_colors, np.int64)[idxs]

        w_b, h_b = T.BLOCK_SIZES[bsize]
        blk_w = max(w_b >> sx, 4)
        blk_h = max(h_b >> sy, 4)
        eob, coeffs, cul, dcsign = (0, None, 0, 0)
        if not skip:
            eob, coeffs, cul, dcsign = self._read_coeffs(
                plane, px, py, tx, mode, blk_w, blk_h)

        hh = min(th, ph - py)
        ww = min(tw, pw - px)

        # defer all pixel work (prediction + transform + recon) to the
        # job executor — the parse/recon split that lets entropy decode
        # stay serial while reconstruction batches on device
        # (mirrors codecs/hevc: parse → flat arrays → recon)
        is_cfl = bool(plane) and mode == T.UV_CFL_PRED
        job = TxbJob(
            plane=plane, px=px, py=py, tw=tw, th=th, tx=tx,
            mode=pred_mode, angle=angle,
            have_above=have_above, have_left=have_left,
            n_tr=n_tr, n_bl=n_bl,
            filt_type=(self._filt_type_y if plane == 0
                       else self._filt_type_uv),
            fi_mode=(self._fi_mode if plane == 0 else None),
            pal_pred=pal_pred,
            cfl_alpha=(self._cfl_alphas[plane - 1] if is_cfl else 0),
            is_cfl=is_cfl,
            eob=eob, coeffs=coeffs,
            tx_type=self._cur_tx_type, qindex=self._cur_qindex,
            hh=hh, ww=ww)
        self.jobs.append(job)

        # context updates (plane-4px units); spans clip at the mi-area
        # edges like aom av1_set_entropy_contexts — cells beyond the
        # frame keep their previous (zero) values, which matters for
        # the summed dc_sign context
        sb_py = (self.sb_mi_row * 4) >> sy
        lrow = (py - sb_py) // 4
        w_cells = min(n_w, max((pw - px) // 4, 0))
        h_cells = min(n_h, max((ph - py) // 4, 0))
        self.above_lvl[plane][u_c:u_c + w_cells] = min(int(cul), 63)
        self.left_lvl[plane][lrow:lrow + h_cells] = min(int(cul), 63)
        self.above_sign[plane][u_c:u_c + w_cells] = dcsign
        self.left_sign[plane][lrow:lrow + h_cells] = dcsign
        dec[u_r + 1:u_r + 1 + n_h, u_c + 1:u_c + 1 + n_w] = 1

    # -------------------------------------------------------- coefficients

    def _read_coeffs(self, plane, px, py, tx, mode, blk_w, blk_h):
        """(spec §5.11.39 coeffs): returns (eob, coeff array, cul, dcsign)."""
        r, cdf = self.r, self.cdf
        tw, th = min(T.tx_w(tx), 32), min(T.tx_h(tx), 32)
        pt = 0 if plane == 0 else 1
        # aom get_txsize_entropy_ctx: rounded-up mean of the sqr and
        # sqr-up size indices (equal for squares; rect sizes round up)
        sizes = [4, 8, 16, 32, 64]
        txs_ctx = min((sizes.index(T.TX_SIZES[T.TX_SIZE_SQR[tx]][0]) +
                       sizes.index(T.TX_SIZES[T.TX_SIZE_SQR_UP[tx]][0]) +
                       1) >> 1, 4)

        # txb skip
        skip_ctx = self._txb_skip_ctx(plane, px, py, tx, blk_w, blk_h)
        all_zero = r.read_symbol_n(cdf.txb_skip[txs_ctx][skip_ctx], 2)
        if all_zero:
            return 0, None, 0, 0

        tx_type = self._read_tx_type(plane, px, py, tx, mode)
        self._cur_tx_type = tx_type
        tcls = _tx_class(tx_type)
        scan = T.get_scan(tx, tcls)
        n_coeffs = tw * th

        # eob pt
        eob_multi_ctx = 0 if tcls == '2d' else 1
        size_key = 1 << (n_coeffs.bit_length() - 1)
        size_key = n_coeffs if n_coeffs in cdf.eob_pt else size_key
        eob_cdf = cdf.eob_pt[min(max(size_key, 16), 1024)][pt][eob_multi_ctx]
        eob_pt = r.read_symbol(eob_cdf) + 1
        eob = _EOB_GROUP_START[eob_pt]
        extra_bits = _EOB_OFFSET_BITS[eob_pt]
        if extra_bits > 0:
            ctx_idx = eob_pt - 3
            bit = r.read_symbol_n(
                cdf.eob_extra[txs_ctx][pt][ctx_idx], 2)
            if bit:
                eob += 1 << (extra_bits - 1)
            for k in range(1, extra_bits):
                if r.read_bit():
                    eob += 1 << (extra_bits - 1 - k)

        levels = np.zeros((th + 4, tw + 4), np.int64)
        coeffs = np.zeros(th * tw, np.int64)
        bwl = tw.bit_length() - 1

        for c in range(eob - 1, -1, -1):
            pos = int(scan[c])
            row, col = pos >> bwl, pos & (tw - 1)
            if c == eob - 1:
                ctx = base_eob_ctx(c, n_coeffs)
                sym = r.read_symbol(
                    cdf.coeff_base_eob[txs_ctx][pt][ctx])
                level = sym + 1
            else:
                ctx = base_ctx(levels, row, col, pos, bwl, tcls, tw, th,
                               T.tx_w(tx), T.tx_h(tx))
                level = r.read_symbol(
                    cdf.coeff_base[txs_ctx][pt][ctx])
            if level > 2:
                bctx = br_ctx(levels, row, col, pos, bwl, tcls)
                for _ in range(4):
                    k = r.read_symbol(
                        cdf.coeff_br[min(txs_ctx, 3)][pt][bctx])
                    level += k
                    if k < 3:
                        break
            levels[row, col] = min(level, 63)
            coeffs[pos] = level

        # signs + golomb tails (forward scan)
        cul = 0
        dc_sign_val = 0
        for c in range(eob):
            pos = int(scan[c])
            level = int(coeffs[pos])
            if level == 0:
                continue
            if c == 0:
                ctx = self._dc_sign_ctx(plane, px, py, tx)
                sign = r.read_symbol_n(cdf.dc_sign[pt][ctx], 2)
            else:
                sign = r.read_bit()
            if level > 14:
                level += r.read_golomb()
            cul += level
            if c == 0:
                dc_sign_val = 1 if sign else 2    # 1: negative, 2: positive
            coeffs[pos] = -level if sign else level
        return eob, coeffs.reshape(th, tw), min(cul, 63), dc_sign_val

    def _txb_skip_ctx(self, plane, px, py, tx, blk_w, blk_h) -> int:
        """(aom get_txb_skip_ctx): blk_w/h = plane block dimensions."""
        tw, th = T.tx_w(tx), T.tx_h(tx)
        sy = self.ssy if plane else 0
        au = px // 4
        lrow = (py - ((self.sb_mi_row * 4) >> sy)) // 4
        n_w, n_h = max(tw // 4, 1), max(th // 4, 1)
        top = int(np.bitwise_or.reduce(
            self.above_lvl[plane][au:au + n_w])) if n_w else 0
        left = int(np.bitwise_or.reduce(
            self.left_lvl[plane][lrow:lrow + n_h])) if n_h else 0
        if plane == 0:
            if blk_w == tw and blk_h == th:
                return 0
            top &= 63
            left &= 63
            # aom get_txb_skip_ctx: max is the BITWISE OR of the two
            mx = min(top | left, 4)
            mn = min(min(top, left), 4)
            return _SKIP_CONTEXTS_TAB[mn][mx]
        ctx_base = int(top != 0) + int(left != 0)
        ctx_offset = 10 if blk_w * blk_h > tw * th else 7
        return ctx_base + ctx_offset

    def _dc_sign_ctx(self, plane, px, py, tx) -> int:
        tw, th = T.tx_w(tx), T.tx_h(tx)
        sy = self.ssy if plane else 0
        au = px // 4
        lrow = (py - ((self.sb_mi_row * 4) >> sy)) // 4
        n_w, n_h = max(tw // 4, 1), max(th // 4, 1)
        s = 0
        for v in self.above_sign[plane][au:au + n_w]:
            s += 1 if v == 2 else (-1 if v == 1 else 0)
        for v in self.left_sign[plane][lrow:lrow + n_h]:
            s += 1 if v == 2 else (-1 if v == 1 else 0)
        if s < 0:
            return 1
        if s > 0:
            return 2
        return 0

    _tx_covers_block = True
    _uv_tx_matches = True

    # aom fimode_to_intradir: filter-intra blocks take their tx-type
    # context (and implied chroma type) from the equivalent directional
    # mode, not DC (caught by the cpu-used=3 oracle difftest)
    _FIMODE_TO_INTRADIR = (T.DC_PRED, T.V_PRED, T.H_PRED, T.D157_PRED,
                           T.DC_PRED)

    _EXT_TX_SET_INTER_1 = _EXT_TX_SET_INTER_1
    _EXT_TX_SET_INTER_2 = _EXT_TX_SET_INTER_2
    _EXT_TX_SET_INTER_3 = _EXT_TX_SET_INTER_3

    def _read_tx_type_inter(self, plane, px, py, tx) -> int:
        """Tx type for intrabc (inter) blocks: luma coded from the
        inter sets, chroma copies the colocated luma type gated by its
        own set (aom av1_get_tx_type)."""
        fh = self.fh
        sup = T.TX_SIZES[T.TX_SIZE_SQR_UP[tx]][0]
        sq = T.TX_SIZES[T.TX_SIZE_SQR[tx]][0]
        if plane != 0:
            ly = (py << self.ssy) >> 2
            lx = (px << self.ssx) >> 2
            tt = int(self.txtype_map[min(ly, self.mi_rows - 1),
                                     min(lx, self.mi_cols - 1)])
            if sup >= 64:
                return T.DCT_DCT
            if sup == 32:
                allowed = self._EXT_TX_SET_INTER_3
            elif fh.reduced_tx_set:
                allowed = self._EXT_TX_SET_INTER_3
            elif sq == 16:
                allowed = self._EXT_TX_SET_INTER_2
            else:
                allowed = self._EXT_TX_SET_INTER_1
            return tt if tt in allowed else T.DCT_DCT
        if sup >= 64:
            tt = T.DCT_DCT
        else:
            if sup == 32 or fh.reduced_tx_set:
                tx_set, set_idx = self._EXT_TX_SET_INTER_3, 3
            elif sq == 16:
                tx_set, set_idx = self._EXT_TX_SET_INTER_2, 2
            else:
                tx_set, set_idx = self._EXT_TX_SET_INTER_1, 1
            sq_idx = [4, 8, 16, 32].index(min(sq, 32))
            sym = self.r.read_symbol_n(
                self.cdf.inter_ext_tx[set_idx - 1][sq_idx], len(tx_set))
            tt = tx_set[sym]
        nw = max(T.tx_w(tx) // 4, 1)
        nh = max(T.tx_h(tx) // 4, 1)
        self.txtype_map[py >> 2:(py >> 2) + nh,
                        px >> 2:(px >> 2) + nw] = tt
        return tt

    def _read_tx_type(self, plane, px, py, tx, mode) -> int:
        fh, seq = self.fh, self.seq
        if fh.coded_lossless:
            return T.WHT_WHT
        if self._use_intrabc:
            return self._read_tx_type_inter(plane, px, py, tx)
        if plane == 0 and self._fi_mode is not None:
            mode = self._FIMODE_TO_INTRADIR[self._fi_mode]
        sup = T.TX_SIZES[T.TX_SIZE_SQR_UP[tx]][0]
        if plane != 0:
            # intra chroma: tx type implied by the uv prediction mode,
            # gated by set membership (spec compute_tx_type)
            if sup >= 32:
                return T.DCT_DCT
            tt = T.INTRA_MODE_TO_TX_TYPE[mode]
            sq = T.TX_SIZES[T.TX_SIZE_SQR[tx]][0]
            tx_set = _EXT_TX_SET_INTRA_2 if (fh.reduced_tx_set or
                                             sq == 16) \
                else _EXT_TX_SET_INTRA_1
            return tt if tt in tx_set else T.DCT_DCT
        # set selection (aom get_ext_tx_set_type, intra branch):
        # sqr-up ≥ 32 → DCT only; reduced set OR sqr == 16 → 5-symbol
        # DTT4_IDTX (cdf set 2); sqr 4/8 → 7-symbol DTT4_IDTX_1DDCT
        if sup >= 32:
            tt = T.DCT_DCT
        else:
            sq = T.TX_SIZES[T.TX_SIZE_SQR[tx]][0]
            if fh.reduced_tx_set or sq == 16:
                tx_set, set_idx = _EXT_TX_SET_INTRA_2, 2
            else:
                tx_set, set_idx = _EXT_TX_SET_INTRA_1, 1
            sq_idx = [4, 8, 16, 32].index(min(sq, 32))
            sym = self.r.read_symbol_n(
                self.cdf.intra_ext_tx[set_idx][sq_idx][mode], len(tx_set))
            tt = tx_set[sym]
        self._luma_tx_type = tt
        return tt

    _luma_tx_type = T.DCT_DCT

