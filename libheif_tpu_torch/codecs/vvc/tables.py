"""VVC (H.266) codec tables — intra-only toolset.

Scope: the coding-tool subset this package's encoder emits (and its
decoder therefore must handle): 4:2:0 8-bit, CTU 32, QT+MTT
partitioning, single coding tree, DCT-II transforms 4..32, plus the
optional intra tools MIP, ISP (4-way splits with subpartitions >= 4
samples) and LFNST (luma, single tree).  Still disabled: MRL, CCLM,
MTS, transform-skip, BDPCM, dependent quantization, sign-data hiding,
SAO, ALF, LMCS.

Provenance note: this environment has no VVC reference decoder or the
JVET-S2001 table annexes, so the exact per-context CABAC
initialization values of the standard are NOT reproduced here; the
entropy-coding *structure* (two-state probability model, window-rate
adaptation, binarizations, context derivations) follows H.266 §9.3,
while initValue/shiftIdx constants below are this codec pair's own.
Streams are validated by encoder↔decoder round-trip (bit-exact
reconstruction) — see tests/test_torch_vvc_codec.py.  The reference obtains
VVC from vvdec/vvenc plugins (ref: libheif/plugins/decoder_vvdec.cc,
encoder_vvenc.cc); this package replaces that external boundary.

The port's copy of libheif_tpu/codecs/vvc/tables.py: the same values,
so that the two packages' streams are equal byte for byte
(tests/test_torch_vvc_tools.py holds every table equal).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# DCT-II integer bases 4..32 are shared with HEVC (H.266 §8.7.4.3
# reuses the same nested integer matrices for these sizes).
from ..hevc.tables import DCT  # noqa: F401  (re-exported)

# --------------------------------------------------------------------------
# Intra prediction (H.266 §8.4.5.2)
# --------------------------------------------------------------------------

INTRA_PLANAR = 0
INTRA_DC = 1
INTRA_HOR = 18
INTRA_DIA = 34
INTRA_VER = 50
INTRA_VDIA = 66
INTRA_DM = 67          # chroma "derived mode" sentinel (not a coded mode)

# intraPredAngle for predModeIntra 2..66 (H.266 Table 27, square-block
# range; wide-angle extension is unreachable with QT-only square CUs).
_ANGLES_HALF = [32, 29, 26, 23, 20, 18, 16, 14, 12, 10, 8, 6, 4, 3, 2, 1, 0]
ANGLE_TABLE: Dict[int, int] = {}
for _i in range(2, 19):                 # 2..18: +32 down to 0
    ANGLE_TABLE[_i] = _ANGLES_HALF[_i - 2]
for _i in range(19, 35):                # 19..34: -1 down to -32
    ANGLE_TABLE[_i] = -_ANGLES_HALF[34 - _i]
for _i in range(35, 51):                # 35..50: -29 up to 0
    ANGLE_TABLE[_i] = -_ANGLES_HALF[_i - 34]
for _i in range(51, 67):                # 51..66: +1 up to +32
    ANGLE_TABLE[_i] = _ANGLES_HALF[66 - _i]

# wide-angle extension (H.266 Table 27 full range, modes -14..-1 and
# 67..80, reached through the §8.4.5.2.6 remapping for non-square TBs)
_WIDE = [35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512]
for _i, _a in enumerate(_WIDE):
    ANGLE_TABLE[67 + _i] = _a          # beyond vertical-diagonal
    ANGLE_TABLE[-1 - _i] = _a          # beyond horizontal-diagonal

assert ANGLE_TABLE[2] == 32 and ANGLE_TABLE[18] == 0
assert ANGLE_TABLE[34] == -32 and ANGLE_TABLE[50] == 0
assert ANGLE_TABLE[66] == 32 and ANGLE_TABLE[19] == -1
assert ANGLE_TABLE[67] == 35 and ANGLE_TABLE[80] == 512
assert ANGLE_TABLE[-1] == 35 and ANGLE_TABLE[-12] == 256


def map_wide_angle(mode: int, log2w: int, log2h: int) -> int:
    """Wide-angle intra mode remapping for non-square blocks
    (H.266 §8.4.5.2.6)."""
    if mode in (INTRA_PLANAR, INTRA_DC) or log2w == log2h:
        return mode
    ratio = abs(log2w - log2h)
    if log2w > log2h:
        thresh = (8 + 2 * ratio) if ratio > 1 else 8
        if 2 <= mode < thresh:
            return mode + 65
    else:
        thresh = (60 - 2 * ratio) if ratio > 1 else 60
        if thresh < mode <= 66:
            return mode - 67
    return mode


def inv_angle(angle: int) -> int:
    """invAngle = Round(512*32 / intraPredAngle) (H.266 §8.4.5.2.12)."""
    if angle == 0:
        return 0
    return int(round(512 * 32 / angle))


# minDistVerHor threshold for reference-sample smoothing
# (H.266 Table 24, indexed by nTbS = (log2W + log2H) >> 1).
INTRA_HOR_VER_DIST_THRES = {2: 24, 3: 14, 4: 2, 5: 0, 6: 0}


def _gauss_filter(p: int) -> List[int]:
    """4-tap smoothing interpolation filter fG, phase p/32.

    Constructed as [1 2 1]/4 ⊛ 2-tap linear, normalized to sum 64
    (the construction underlying H.266 Table 25's fG column).
    """
    a = (32 - p) // 2
    d = p // 2
    b = (64 - p) // 2
    c = 64 - a - b - d
    return [a, b, c, d]


def _cubic_filter(p: int) -> List[int]:
    """4-tap DCT-IF/cubic interpolation filter fC, phase p/32,
    normalized to sum 64 (construction behind H.266 Table 25 fC)."""
    t = p / 32.0
    w = [(-0.5 * t ** 3 + t ** 2 - 0.5 * t),
         (1.5 * t ** 3 - 2.5 * t ** 2 + 1.0),
         (-1.5 * t ** 3 + 2.0 * t ** 2 + 0.5 * t),
         (0.5 * t ** 3 - 0.5 * t ** 2)]
    q = [int(round(64 * x)) for x in w]
    q[1] += 64 - sum(q)        # exact DC gain
    return q


FILTER_G = np.array([_gauss_filter(p) for p in range(32)], np.int32)
FILTER_C = np.array([_cubic_filter(p) for p in range(32)], np.int32)


# --------------------------------------------------------------------------
# Quantization (H.266 §8.7.3) — square TBs only in this toolset
# --------------------------------------------------------------------------

LEVEL_SCALE = [40, 45, 51, 57, 64, 72]
# rectangular TBs with odd log2(W*H) carry the extra 1/sqrt2 in the
# scaling stage (H.266 §8.7.3 levelScale[rectNonTsFlag][..])
LEVEL_SCALE_RECT = [57, 64, 72, 80, 90, 102]
# forward scale such that fwd*inv ≈ 2^(14+6)=2^20 per qp%6 step
QUANT_SCALE = [26214, 23302, 20560, 18396, 16384, 14564]
QUANT_SCALE_RECT = [36792, 32768, 29127, 26214, 23302, 20560]


def build_chroma_qp_table(start_minus26: int = 0,
                          delta_in: Tuple[int, ...] = (),
                          delta_diff: Tuple[int, ...] = ()) -> List[int]:
    """ChromaQpTable from the SPS piecewise-linear signalling
    (H.266 §7.4.3.4 sps chroma QP table semantics).

    With no interior points the mapping extends linearly with slope 1
    in both directions — i.e. identity, which is what this encoder
    signals (sps_same_qp_table_for_chroma_flag=1, zero points).
    """
    # table domain: qpY in [-QpBdOffset, 63]; 8-bit → [0, 63]
    qp_in = [start_minus26 + 26]
    qp_out = [start_minus26 + 26]
    for i, d in enumerate(delta_in):
        qp_in.append(qp_in[-1] + d + 1)
        qp_out.append(qp_out[-1] + (d + 1 if i >= len(delta_diff)
                                    else (d + 1) ^ delta_diff[i]))
    table = [0] * 64
    # anchor point
    k0 = qp_in[0]
    for q in range(64):
        if q <= k0:
            table[q] = qp_out[0] - (k0 - q)
        else:
            # piecewise segments, then slope-1 extension
            v = qp_out[0]
            prev = k0
            rem = q - k0
            seg = 0
            while seg + 1 < len(qp_in) and rem > 0:
                span = qp_in[seg + 1] - prev
                step = min(span, rem)
                out_span = qp_out[seg + 1] - qp_out[seg]
                v += (out_span * step + span // 2) // span
                rem -= step
                prev += step
                seg += 1
            v += rem
            table[q] = v
    return [max(0, min(63, t)) for t in table]


CHROMA_QP_TABLE = build_chroma_qp_table()


# --------------------------------------------------------------------------
# Scan orders — 4x4 coefficient groups, up-right diagonal (§6.5.2);
# both the in-group scan and the group scan are diagonal in VVC.
# --------------------------------------------------------------------------

def _diag_scan(w: int, h: int) -> List[Tuple[int, int]]:
    """Up-right diagonal scan order (x, y), DC first."""
    out = []
    for s in range(w + h - 1):
        for y in range(min(s, h - 1), -1, -1):
            x = s - y
            if x < w:
                out.append((x, y))
    return out


DIAG_4x4 = _diag_scan(4, 4)                   # in-subblock scan
SB_SCANS = {(w, h): _diag_scan(w, h)          # subblock grid scans
            for w in (1, 2, 4, 8) for h in (1, 2, 4, 8)}


# --------------------------------------------------------------------------
# CABAC context model layout (intra-only subset)
# --------------------------------------------------------------------------
# Each entry: name -> (count, initValue, shiftIdx).  initValue is the
# 6-bit H.266 init (slopeIdx<<3 | offsetIdx); shiftIdx the 4-bit
# adaptation-window index (shift0=(s>>4? ) see cabac.py).  Values are
# this codec pair's own (see module docstring).

def _iv(slope: int, offset: int) -> int:
    return (slope << 3) | offset


CONTEXTS: Dict[str, Tuple[int, int, int]] = {
    # partitioning
    "split_cu_flag":             (9,  _iv(4, 3), 4),
    "split_qt_flag":             (6,  _iv(4, 3), 4),
    "mtt_split_cu_vertical_flag": (3, _iv(4, 4), 4),
    "mtt_split_cu_binary_flag":  (4,  _iv(4, 4), 4),
    # intra luma
    "intra_luma_mpm_flag":       (1,  _iv(4, 4), 4),
    "intra_luma_not_planar_flag": (2, _iv(4, 3), 4),
    # intra chroma
    "intra_chroma_pred_mode":    (1,  _iv(4, 2), 4),
    # transform unit
    "tu_cbf_luma":               (4,  _iv(4, 4), 4),
    "tu_cbf_cb":                 (2,  _iv(4, 2), 4),
    "tu_cbf_cr":                 (2,  _iv(4, 2), 4),
    # residual coding
    "last_sig_coeff_x_prefix":   (18, _iv(4, 3), 4),
    "last_sig_coeff_y_prefix":   (18, _iv(4, 3), 4),
    "sb_coded_flag":             (4,  _iv(4, 4), 4),
    "sig_coeff_flag":            (20, _iv(4, 3), 4),   # luma 12 + chroma 8
    "abs_level_gt1_flag":        (30, _iv(4, 3), 4),   # luma 20 + chroma 10
    "par_level_flag":            (30, _iv(4, 3), 4),
    "abs_level_gt3_flag":        (30, _iv(4, 3), 4),
    # optional intra tools (MIP / ISP / LFNST)
    "intra_mip_flag":            (4,  _iv(4, 3), 4),
    "intra_subpartitions_mode_flag": (1, _iv(4, 3), 4),
    "intra_subpartitions_split_flag": (1, _iv(4, 4), 4),
    "lfnst_idx":                 (3,  _iv(4, 2), 4),
}

_LAYOUT: Dict[str, Tuple[int, int]] = {}
_off = 0
for _name, (_count, _ivv, _sh) in CONTEXTS.items():
    _LAYOUT[_name] = (_off, _count)
    _off += _count
TOTAL_CONTEXTS = _off


def ctx_layout() -> Dict[str, Tuple[int, int]]:
    return _LAYOUT


# ---- residual context derivations (VTM-style templates) -----------------

def sig_ctx(c_idx: int, diag: int, loc_sum_abs1: int) -> int:
    """sig_coeff_flag ctxInc (H.266 §9.3.4.2.8 structure):
    min((locSumAbsPass1+1)>>1, 3) + diagonal-position offset."""
    base = min((loc_sum_abs1 + 1) >> 1, 3)
    if c_idx == 0:
        off = 8 if diag < 2 else (4 if diag < 5 else 0)
        return base + off                       # 0..11
    off = 4 if diag < 2 else 0
    return 12 + base + off                      # 12..19


def gtx_par_ctx(c_idx: int, diag: int, tmpl: int) -> int:
    """Shared ctxInc for abs_level_gt1/par_level/abs_level_gt3:
    min(templateSum, 4) + diagonal offset."""
    base = min(tmpl, 4)
    if c_idx == 0:
        off = 15 if diag == 0 else (10 if diag < 3 else (5 if diag < 10 else 0))
        return base + off                       # 0..19
    off = 5 if diag == 0 else 0
    return 20 + base + off                      # 20..29


def last_prefix_ctx(which_chroma: bool, log2_size: int, bin_idx: int) -> int:
    """last_sig_coeff_{x,y}_prefix ctxInc (HEVC-style size mapping;
    max TB 32 in this toolset → luma ctx 0..14, chroma 15..17)."""
    if not which_chroma:
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        shift = (log2_size + 1) >> 2
        return min(offset + (bin_idx >> shift), 14)
    return 15 + min(bin_idx >> (log2_size - 2), 2)


def rice_param(loc_sum_abs: int) -> int:
    """abs_remainder Rice parameter from the local template sum
    (H.266 §9.3.3.2 structure)."""
    s = max(0, min(31, loc_sum_abs))
    if s < 4:
        return 0
    if s < 12:
        return 1
    if s < 24:
        return 2
    return 3


# --------------------------------------------------------------------------
# MIP — matrix-based intra prediction (H.266 §8.4.5.2.2)
# --------------------------------------------------------------------------
# Size classes (spec MipSizeId): 0 → 4x4 CUs (boundary 2+2, pred 4x4,
# 16 modes), 1 → 4x8/8x4/8x8 (boundary 4+4, pred 4x4, 8 modes),
# 2 → everything else (boundary 4+4, pred 8x8, 6 modes).
#
# Provenance: the JVET-S2001 weight-table annex is not available in
# this environment (same situation as the CABAC init values, module
# docstring).  The matrices below are synthesized deterministically
# with the spec's shapes/precision (7-bit weights, sW=6): each mode is
# a smooth separable ramp over the reduced boundary with a
# mode-dependent direction/frequency, DC-normalized so each output row
# sums to 64.  Streams round-trip bit-exactly (shared tables); the
# prediction quality is what the encoder's SSE search measures.

def mip_size_id(log2w: int, log2h: int) -> int:
    if log2w == 2 and log2h == 2:
        return 0
    if log2w <= 3 and log2h <= 3:
        return 1
    return 2


MIP_NUM_MODES = {0: 16, 1: 8, 2: 6}
MIP_BOUNDARY = {0: 2, 1: 4, 2: 4}      # reduced samples per edge
MIP_PRED = {0: 4, 1: 4, 2: 8}          # reduced prediction square


def _mip_matrix(size_id: int, mode: int) -> np.ndarray:
    bdry = MIP_BOUNDARY[size_id]
    pred = MIP_PRED[size_id]
    n_in = 2 * bdry
    n_out = pred * pred
    # direction angle + frequency per mode (deterministic)
    ang = (mode * np.pi) / MIP_NUM_MODES[size_id]
    freq = 1 + (mode % 3)
    w = np.zeros((n_out, n_in), np.float64)
    for j in range(n_out):
        ox, oy = j % pred, j // pred
        # projected position along the mode direction in [0, 1]
        t = (ox * np.cos(ang) + oy * np.sin(ang)) / max(pred - 1, 1)
        for i in range(n_in):
            edge_top = i < bdry
            pos = (i if edge_top else i - bdry) / max(bdry - 1, 1)
            d = t - pos if edge_top else t - (1.0 - pos)
            w[j, i] = np.cos(np.pi * freq * d) + 1.25
    # DC-normalize each row to 64, quantize to 7-bit weights
    w = 64.0 * w / w.sum(axis=1, keepdims=True)
    return np.clip(np.round(w), -127, 127).astype(np.int32)


MIP_WEIGHTS = {(s, m): _mip_matrix(s, m)
               for s in (0, 1, 2) for m in range(MIP_NUM_MODES[s])}


# --------------------------------------------------------------------------
# LFNST — low-frequency non-separable transform (H.266 §8.7.4.2)
# --------------------------------------------------------------------------
# Four transform sets (selected by intra mode), two kernels per set.
# Kernel shapes follow the spec: 16x16 for 4-sample-min TBs and 16x48
# for >=8x8 TBs (top-left 4x4 + top-right 4x4 + bottom-left 4x4
# region).  Values are synthesized orthonormal int8-range matrices
# (seeded Gram-Schmidt, x128) — same provenance note as MIP above.

def _ortho(rows: int, cols: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((cols, cols))
    q, _ = np.linalg.qr(a)
    m = np.round(q[:rows] * 128.0)
    return np.clip(m, -127, 127).astype(np.int64)


LFNST_16 = {(s, k): _ortho(16, 16, 1000 + 10 * s + k)
            for s in range(4) for k in (1, 2)}
LFNST_48 = {(s, k): _ortho(16, 48, 2000 + 10 * s + k)
            for s in range(4) for k in (1, 2)}


def lfnst_set_of_mode(mode: int) -> Tuple[int, bool]:
    """(transform set, transpose) from the intra prediction mode
    (spec lfnstTrSetIdx mapping + the >34 transpose rule)."""
    transpose = mode > 34
    m = 68 - mode if transpose else mode
    if m <= 1:
        s = 0
    elif m <= 12:
        s = 1
    elif m <= 23:
        s = 2
    else:
        s = 3
    return s, transpose


# scan covering the LFNST output region of a >=8x8 TB: the 48 samples
# of the top-left 8x8 minus its bottom-right 4x4, in diagonal order
LFNST_48_SCAN = [(x, y) for (x, y) in _diag_scan(8, 8)
                 if not (x >= 4 and y >= 4)]
assert len(LFNST_48_SCAN) == 48
