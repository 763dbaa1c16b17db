"""HEVC tables.

Counterpart of libheif_tpu/codecs/hevc/tables.py, whole: the CABAC engine
tables (spec §9.3.4.3, Tables 9-46/9-47/9-48), the context-variable
initialization values of the intra and inter syntax (spec §9.3.2.2,
initType 0/1/2 rows), the intra prediction angles (Table 8-5) and inverse
angles, the transform matrices (§8.6.4), the chroma QP mapping (Table
8-10), the scans (§6.5.3) and the default scaling lists.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# CABAC state machine (spec Table 9-46, 9-47)
# --------------------------------------------------------------------------

RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9],
    [2, 2, 2, 2]], dtype=np.uint8)

TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63], dtype=np.uint8)

TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.uint8)
TRANS_IDX_MPS[62] = 62
TRANS_IDX_MPS[63] = 63

# --------------------------------------------------------------------------
# Context initialization values [initType 0 (I), 1 (P), 2 (B)]
# (spec §9.3.2.2; context counts per syntax element)
# --------------------------------------------------------------------------

INIT_VALUES = {
    # name: [[initType0...], [initType1...], [initType2...]]
    "sao_merge_flag": [[153], [153], [153]],
    "sao_type_idx": [[200], [185], [160]],
    "split_cu_flag": [[139, 141, 157], [107, 139, 126], [107, 139, 126]],
    "cu_transquant_bypass_flag": [[154], [154], [154]],
    "cu_skip_flag": [None, [197, 185, 201], [197, 185, 201]],
    "pred_mode_flag": [None, [149], [134]],
    "part_mode": [[184], [154, 139, 154, 154], [154, 139, 154, 154]],
    "prev_intra_luma_pred_flag": [[184], [154], [183]],
    "intra_chroma_pred_mode": [[63], [152], [152]],
    # initValue 79 for BOTH initTypes 1 and 2 (H.265 Table 9-19;
    # validated bit-exact vs libde265 on B-slice AMVP streams)
    "rqt_root_cbf": [None, [79], [79]],
    "merge_flag": [None, [110], [154]],
    "merge_idx": [None, [122], [137]],
    "inter_pred_idc": [None, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]],
    "ref_idx": [None, [153, 153], [153, 153]],
    "mvp_flag": [None, [168], [168]],
    "abs_mvd_greater0_flag": [None, [140], [169]],
    "abs_mvd_greater1_flag": [None, [198], [198]],
    "split_transform_flag": [[153, 138, 138], [124, 138, 94], [224, 167, 122]],
    "cbf_luma": [[111, 141], [153, 111], [153, 111]],
    "cbf_chroma": [[94, 138, 182, 154], [149, 107, 167, 154],
                   [149, 92, 167, 154]],
    "cu_qp_delta_abs": [[154, 154], [154, 154], [154, 154]],
    "transform_skip_flag": [[139, 139], [139, 139], [139, 139]],  # [luma, chroma]
    "last_sig_coeff_prefix": [  # shared between x and y (18 ctx each)
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
         127, 111, 79, 108, 123, 63],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111,
         111, 95, 94, 108, 123, 108],
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126,
         111, 111, 79, 108, 123, 93]],
    "coded_sub_block_flag": [[91, 171, 134, 141], [121, 140, 61, 154],
                             [121, 140, 61, 154]],
    "sig_coeff_flag": [  # 27 luma + 15 chroma = 42 ctx
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141,
         179, 153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141,
         179, 153, 125, 140, 139, 182, 182, 152, 136, 152, 136, 153,
         136, 139, 111, 136, 139, 111],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140,
         136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140,
         136, 153, 154, 170, 153, 123, 123, 107, 121, 107, 121, 167,
         151, 183, 140, 151, 183, 140],
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140,
         136, 153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140,
         136, 153, 154, 170, 153, 138, 138, 122, 121, 122, 121, 167,
         151, 183, 140, 151, 183, 140]],
    "coeff_abs_level_greater1_flag": [  # 16 luma + 8 chroma = 24 ctx
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92,
         139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136,
         153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136,
         153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182]],
    "coeff_abs_level_greater2_flag": [  # 4 luma + 2 chroma = 6 ctx
        [138, 153, 136, 167, 152, 152],
        [107, 167, 91, 122, 107, 167],
        [107, 167, 91, 107, 107, 167]],
}


def init_context_state(init_value: int, qp: int):
    """(pStateIdx, valMps) from an init value (spec §9.3.2.2)."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    pre = min(max(1, ((slope * min(max(qp, 0), 51)) >> 4) + offset), 126)
    val_mps = 1 if pre > 63 else 0
    p_state = (pre - 64) if val_mps else (63 - pre)
    return p_state, val_mps


# --------------------------------------------------------------------------
# Intra prediction (spec §8.4.4.2.6, Table 8-5)
# --------------------------------------------------------------------------

# intraPredAngle for modes 2..34
INTRA_PRED_ANGLE = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}

# invAngle for negative angles (spec Table 8-6): keyed by angle value
INTRA_INV_ANGLE = {-2: -4096, -5: -1638, -9: -910, -13: -630,
                   -17: -482, -21: -390, -26: -315, -32: -256}

# --------------------------------------------------------------------------
# Transforms (spec §8.6.4)
# --------------------------------------------------------------------------

# 4x4 DST-VII (intra luma 4x4)
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29]], dtype=np.int64)


def _dct_matrix(n: int) -> np.ndarray:
    """H.265 integer DCT-II basis of size n (n in 4,8,16,32), built from
    the 32-point coefficients (spec §8.6.4 transform matrix)."""
    c32 = [64, 83, 36, 89, 75, 50, 18, 90, 87, 80, 70, 57, 43, 25, 9,
           90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]
    # Construct the canonical 32x32 matrix rows from the odd/even
    # decomposition: entry m[k][j] = transMatrix per spec.  We build
    # the 32x32 directly with the standard generation: m32[k][j] =
    # round(64 * sqrt(2/32)*k? ) — instead use the spec's recursive
    # butterfly property: the even rows of DCT-2N are DCT-N.
    # Even rows of DCT-2N are symmetric extensions of DCT-N rows
    # (cos(2πk − x) = cos x), odd rows are antisymmetric.
    m4 = np.array([[64, 64, 64, 64],
                   [83, 36, -36, -83],
                   [64, -64, -64, 64],
                   [36, -83, 83, -36]], dtype=np.int64)
    if n == 4:
        return m4
    odd4 = np.array([[89, 75, 50, 18],
                     [75, -18, -89, -50],
                     [50, -89, 18, 75],
                     [18, -50, 75, -89]], dtype=np.int64)
    m8 = np.zeros((8, 8), np.int64)
    for k in range(4):
        m8[2 * k, :4] = m4[k]
        m8[2 * k, 4:] = m4[k][::-1]
        m8[2 * k + 1, :4] = odd4[k]
        m8[2 * k + 1, 4:] = -odd4[k][::-1]
    if n == 8:
        return m8
    odd8 = np.array([[90, 87, 80, 70, 57, 43, 25, 9],
                     [87, 57, 9, -43, -80, -90, -70, -25],
                     [80, 9, -70, -87, -25, 57, 90, 43],
                     [70, -43, -87, 9, 90, 25, -80, -57],
                     [57, -80, -25, 90, -9, -87, 43, 70],
                     [43, -90, 57, 25, -87, 70, 9, -80],
                     [25, -70, 90, -80, 43, 9, -57, 87],
                     [9, -25, 43, -57, 70, -80, 87, -90]], dtype=np.int64)
    m16 = np.zeros((16, 16), np.int64)
    for k in range(8):
        m16[2 * k, :8] = m8[k]
        m16[2 * k, 8:] = m8[k][::-1]
        m16[2 * k + 1, :8] = odd8[k]
        m16[2 * k + 1, 8:] = -odd8[k][::-1]
    if n == 16:
        return m16
    # odd rows of the 32-point matrix from cosine-index folding of the
    # canonical coefficient list (values of round-scaled cos(πm/64),
    # m odd in 1..31)
    o32 = [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]
    odd16 = np.zeros((16, 16), np.int64)
    for k in range(16):
        for j in range(16):
            idx = ((2 * j + 1) * (2 * k + 1)) % 128
            sign = 1
            if idx > 64:
                idx = 128 - idx          # cos(2π − x) = cos x
            if idx > 32:
                idx = 64 - idx           # cos(π − x) = −cos x
                sign = -sign
            odd16[k, j] = sign * o32[(idx - 1) // 2]
    m32 = np.zeros((32, 32), np.int64)
    for k in range(16):
        m32[2 * k, :16] = m16[k]
        m32[2 * k, 16:] = m16[k][::-1]
        m32[2 * k + 1, :16] = odd16[k]
        m32[2 * k + 1, 16:] = -odd16[k][::-1]
    return m32


DCT = {n: _dct_matrix(n) for n in (4, 8, 16, 32)}

# --------------------------------------------------------------------------
# Chroma QP mapping (spec Table 8-10, 4:2:0)
# --------------------------------------------------------------------------

_CHROMA_QP_MAP = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
                  37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp_i: int) -> int:
    if qp_i < 30:
        return qp_i
    if qp_i > 43:
        return qp_i - 6
    return _CHROMA_QP_MAP[qp_i]


# --------------------------------------------------------------------------
# Scan orders (spec §6.5.3): 4x4 sub-block scans
# --------------------------------------------------------------------------

def diag_scan(size: int) -> np.ndarray:
    """Up-right diagonal scan positions [(x, y), ...] (spec §6.5.3,
    eq 6-11): each diagonal starts at (0, d) and walks up-right."""
    out = []
    for d in range(2 * size - 1):
        x, y = max(0, d - size + 1), min(d, size - 1)
        while x < size and y >= 0:
            if x < size and y < size:
                out.append((x, y))
            x += 1
            y -= 1
    return np.array(out, dtype=np.int32)


# Default scaling matrices (spec tables 7-5/7-6, raster order; values
# verified against libavcodec's hevc defaults and pinned by the
# libde265 difftests).  The spec codes lists in diagonal-scan order.
_DEF_SCALING_INTRA_RASTER = np.array([
    16, 16, 16, 16, 17, 18, 21, 24, 16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29, 16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47, 18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88, 24, 25, 29, 36, 47, 65, 88, 115,
], np.int32)
_DEF_SCALING_INTER_RASTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24, 16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28, 16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41, 18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71, 24, 25, 28, 33, 41, 54, 71, 91,
], np.int32)


def _to_diag(raster8):
    return [int(raster8[y * 8 + x]) for (x, y) in diag_scan(8)]


DEFAULT_SCALING_INTRA_DIAG = None   # filled below (diag_scan defined)
DEFAULT_SCALING_INTER_DIAG = None


def horiz_scan(size: int) -> np.ndarray:
    return np.array([(x, y) for y in range(size) for x in range(size)],
                    dtype=np.int32)


def vert_scan(size: int) -> np.ndarray:
    return np.array([(x, y) for x in range(size) for y in range(size)],
                    dtype=np.int32)


SCAN_DIAG4 = diag_scan(4)
SCAN_HORIZ4 = horiz_scan(4)
SCAN_VERT4 = vert_scan(4)

DEFAULT_SCALING_INTRA_DIAG = _to_diag(_DEF_SCALING_INTRA_RASTER)
DEFAULT_SCALING_INTER_DIAG = _to_diag(_DEF_SCALING_INTER_RASTER)
