"""H.264/AVC static tables (Rec. ITU-T H.264).

A copy of libheif_tpu/codecs/avc/tables.py, unchanged but for this line.

The framework-internal AVC codec core replaces the reference's
openh264/x264 plugin boundary (reference: libheif/plugins/
decoder_openh264.cc, encoder_x264.cc). Large spec tables (CABAC I-slice
context initialization, deblock clipping, 8x8 significance maps) are
extracted from the system libavcodec by tools/extract_avc_tables.py and
shipped as avc_tables.npz; everything here that is small or formulaic
is written out directly from the spec.
"""

from __future__ import annotations

import os

import numpy as np

_NPZ = np.load(os.path.join(os.path.dirname(__file__), "avc_tables.npz"))

CABAC_INIT_I = _NPZ["cabac_init_i"].astype(np.int32)      # (1024, 2) m,n
# three cabac_init_idc P/B tables (Tables 9-13..9-33 right columns)
CABAC_INIT_PB = _NPZ["cabac_init_pb"].astype(np.int32)    # (3, 1024, 2)
DEBLOCK_ALPHA = _NPZ["deblock_alpha"]                     # (52,)
DEBLOCK_BETA = _NPZ["deblock_beta"]                       # (52,)
DEBLOCK_TC0 = _NPZ["deblock_tc0"]                         # (52, 3)
SIG_CTX_8X8 = _NPZ["sig_ctx_8x8"]                         # (63,) Table 9-43
LAST_CTX_8X8 = _NPZ["last_ctx_8x8"]                       # (63,)

# ---------------------------------------------------------------- scans

# 4x4 zigzag (Table 8-13, frame)
ZIGZAG_4X4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      np.int32)

# 8x8 zigzag (Table 8-14, frame)
ZIGZAG_8X8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int32)

# ------------------------------------------------------------- dequant

# LevelScale 4x4 normalization (spec 8.5.9, Table: v matrix)
_V4 = np.array([[10, 16, 13], [11, 18, 14], [13, 20, 16],
                [14, 23, 18], [16, 25, 20], [18, 29, 23]], np.int32)

# 8x8 weights (spec 8.5.9 m matrix)
_V8 = np.array([[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26],
                [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
                [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]],
               np.int32)


def _class4(i: int, j: int) -> int:
    if i % 2 == 0 and j % 2 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    return 2


def _class8(i: int, j: int) -> int:
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


# LevelScale4x4[qp%6][4][4] = weightScale(i,j) * normAdjust4x4(m,i,j)
# with the default flat scaling list weightScale = 16 (spec 8.5.9);
# likewise LevelScale8x8. Non-flat SPS/PPS scaling lists scale these.
LEVEL_SCALE_4 = np.zeros((6, 4, 4), np.int32)
LEVEL_SCALE_8 = np.zeros((6, 8, 8), np.int32)
for _m in range(6):
    for _i in range(4):
        for _j in range(4):
            LEVEL_SCALE_4[_m, _i, _j] = 16 * _V4[_m, _class4(_i, _j)]
    for _i in range(8):
        for _j in range(8):
            LEVEL_SCALE_8[_m, _i, _j] = 16 * _V8[_m, _class8(_i, _j)]

# chroma QP mapping (Table 8-15): index = clip(qp + offset, 0, 51)
CHROMA_QP = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37,
              37, 38, 38, 38, 39, 39, 39, 39], np.int64)]).astype(np.int32)

# ------------------------------------------------- CABAC ctx layout

# ctxIdxOffset per syntax element (Table 9-34, frame-coded I slices)
CTX_MB_TYPE_I = 3              # 3..10
# P-slice elements (Table 9-34)
CTX_MB_SKIP_P = 11             # 11..13
CTX_MB_TYPE_P = 14             # prefix 14..16(+17); intra suffix 17..20
CTX_SUB_MB_TYPE_P = 21         # 21..23
CTX_MVD_X = 40                 # 40..46
CTX_MVD_Y = 47                 # 47..53
CTX_REF_IDX = 54               # 54..59
CTX_MB_QP_DELTA = 60           # 60..63
CTX_CHROMA_PRED = 64           # 64..67
CTX_PREV_I4X4 = 68
CTX_REM_I4X4 = 69
CTX_CBP_LUMA = 73              # 73..76
CTX_CBP_CHROMA = 77            # 77..84 (bin0: 77..80, bin1: 81..84)
CTX_CBF = 85                   # + 4*cat + inc, cats 0..4
CTX_SIG = 105                  # + cat offset + inc (frame)
CTX_LAST = 166
CTX_ABS = 227
CTX_END_OF_SLICE = 276         # decoded with the terminate routine
CTX_TRANSFORM_8X8 = 399        # 399..401
CTX_SIG_8X8 = 402              # frame
CTX_LAST_8X8 = 417
CTX_ABS_8X8 = 426

# per-category offsets within sig/last (Table 9-40)
SIG_CAT_OFF = [0, 15, 29, 44, 47]
ABS_CAT_OFF = [0, 10, 20, 30, 39]
# block categories
CAT_LUMA_DC = 0     # Intra16x16DCLevel (16)
CAT_LUMA_AC = 1     # Intra16x16ACLevel (15)
CAT_LUMA_4X4 = 2    # LumaLevel4x4 (16)
CAT_CHROMA_DC = 3   # ChromaDCLevel (4 for 4:2:0)
CAT_CHROMA_AC = 4   # ChromaACLevel (15)
CAT_LUMA_8X8 = 5    # LumaLevel8x8 (64)

# ----------------------------------------------------- intra mode enums

I4_VERT, I4_HOR, I4_DC, I4_DDL, I4_DDR, I4_VR, I4_HD, I4_VL, I4_HU = range(9)
I16_VERT, I16_HOR, I16_DC, I16_PLANE = range(4)
C_DC, C_HOR, C_VERT, C_PLANE = range(4)

# raster order of the 16 4x4 luma blocks in decode order (spec 6.4.3:
# 8x8 quadrants, 4x4 z-order inside)
BLK4_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3], np.int32)
BLK4_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3], np.int32)
# map (by, bx) -> decode index
BLK4_IDX = np.zeros((4, 4), np.int32)
for _k in range(16):
    BLK4_IDX[BLK4_Y[_k], BLK4_X[_k]] = _k


def init_cabac_states(qp: int, is_p: bool = False,
                      cabac_init_idc: int = 0) -> tuple:
    """Initialize all 1024 context states (spec 9.3.1.1):
    preCtxState = Clip3(1, 126, ((m * Clip3(0, 51, qp)) >> 4) + n).
    I slices use Table 9-12's column; P slices one of the three
    cabac_init_idc variants."""
    tab = CABAC_INIT_PB[cabac_init_idc] if is_p else CABAC_INIT_I
    m = tab[:, 0].astype(np.int64)
    n = tab[:, 1].astype(np.int64)
    pre = np.clip(((m * int(np.clip(qp, 0, 51))) >> 4) + n, 1, 126)
    mps = (pre > 63).astype(np.int32)
    state = np.where(pre > 63, pre - 64, 63 - pre).astype(np.int32)
    return state.tolist(), mps.tolist()
