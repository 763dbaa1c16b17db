"""AV1 static tables: block geometry, transform sizes, scan orders.

Derived programmatically from the spec's definitions (block size enum
§6.10.4, transform sizes §6.10.24, zig-zag scans §9.24).

Counterpart of libheif_tpu/codecs/av1/tables.py, copied.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# block sizes (w, h) in pixels, spec enum order
BLOCK_SIZES: List[Tuple[int, int]] = [
    (4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32),
    (32, 16), (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64),
    (128, 128), (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16),
]
BLOCK_INVALID = 255

def _bs(w, h):
    return BLOCK_SIZES.index((w, h))

BLOCK_4X4 = _bs(4, 4)
BLOCK_8X8 = _bs(8, 8)
BLOCK_16X16 = _bs(16, 16)
BLOCK_64X64 = _bs(64, 64)
BLOCK_128X128 = _bs(128, 128)

# partitions
PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3
PARTITION_HORZ_A = 4   # top split, bottom whole
PARTITION_HORZ_B = 5   # top whole, bottom split
PARTITION_VERT_A = 6
PARTITION_VERT_B = 7
PARTITION_HORZ_4 = 8
PARTITION_VERT_4 = 9


def _subsize(w, h):
    try:
        return _bs(w, h)
    except ValueError:
        return BLOCK_INVALID


# Partition_Subsize[partition][bsize] (spec §9.3)
PARTITION_SUBSIZE = np.full((10, 22), BLOCK_INVALID, np.int32)
for b, (w, h) in enumerate(BLOCK_SIZES):
    PARTITION_SUBSIZE[PARTITION_NONE][b] = b
    PARTITION_SUBSIZE[PARTITION_HORZ][b] = _subsize(w, h // 2)
    PARTITION_SUBSIZE[PARTITION_VERT][b] = _subsize(w // 2, h)
    PARTITION_SUBSIZE[PARTITION_SPLIT][b] = _subsize(w // 2, h // 2)
    PARTITION_SUBSIZE[PARTITION_HORZ_A][b] = _subsize(w, h // 2)
    PARTITION_SUBSIZE[PARTITION_HORZ_B][b] = _subsize(w, h // 2)
    PARTITION_SUBSIZE[PARTITION_VERT_A][b] = _subsize(w // 2, h)
    PARTITION_SUBSIZE[PARTITION_VERT_B][b] = _subsize(w // 2, h)
    PARTITION_SUBSIZE[PARTITION_HORZ_4][b] = _subsize(w, h // 4)
    PARTITION_SUBSIZE[PARTITION_VERT_4][b] = _subsize(w // 4, h)

# intra modes
DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D135_PRED = 4
D113_PRED = 5
D157_PRED = 6
D203_PRED = 7
D67_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12
UV_CFL_PRED = 13
INTRA_MODES = 13

# intra mode → implied transform type for chroma blocks (aom
# intra_mode_to_tx_type; spec compute_tx_type intra-UV branch),
# indexed DC..PAETH then UV_CFL
INTRA_MODE_TO_TX_TYPE = [0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0]

MODE_TO_ANGLE = {V_PRED: 90, H_PRED: 180, D45_PRED: 45, D135_PRED: 135,
                 D113_PRED: 113, D157_PRED: 157, D203_PRED: 203,
                 D67_PRED: 67}

# Intra_Mode_Context (spec §8.3, for kf y mode ctx)
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

# transform sizes: (w, h)
TX_SIZES: List[Tuple[int, int]] = [
    (4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4), (8, 16),
    (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16), (16, 4),
    (8, 32), (32, 8), (16, 64), (64, 16),
]

def _tx(w, h):
    return TX_SIZES.index((w, h))

TX_4X4 = 0

# Max_Tx_Size_Rect[bsize] (spec §9.3): largest tx fitting the block.
# AV1's transform family includes 4:1 aspect sizes (16x4, 4x16, 32x8,
# ...), so a 16x4 block starts at TX_16X4 — the earlier 2:1 clamp
# desynced streams using 1:4 partitions (caught by the oracle
# difftest).
MAX_TX_SIZE_RECT = []
for (w, h) in BLOCK_SIZES:
    tw, th = min(w, 64), min(h, 64)
    while tw > 4 * th:
        tw //= 2
    while th > 4 * tw:
        th //= 2
    MAX_TX_SIZE_RECT.append(_tx(tw, th))

# split a tx size in two (spec Split_Tx_Size)
SPLIT_TX_SIZE = {}
for i, (w, h) in enumerate(TX_SIZES):
    if (w, h) == (4, 4):
        SPLIT_TX_SIZE[i] = i
    else:
        nw = w // 2 if w >= h and w > 4 else w
        nh = h // 2 if h >= w and h > 4 else h
        if w == h:
            nw, nh = w // 2, h // 2
        SPLIT_TX_SIZE[i] = _tx(nw, nh)

# tx size squared-up (for depth categories): Tx_Size_Sqr / Sqr_Up
TX_SIZE_SQR = []
TX_SIZE_SQR_UP = []
for (w, h) in TX_SIZES:
    s = min(w, h)
    u = min(max(w, h), 64)
    TX_SIZE_SQR.append(_tx(s, s))
    TX_SIZE_SQR_UP.append(_tx(u, u))

# tx types
DCT_DCT = 0
ADST_DCT = 1
DCT_ADST = 2
ADST_ADST = 3
FLIPADST_DCT = 4
DCT_FLIPADST = 5
FLIPADST_FLIPADST = 6
ADST_FLIPADST = 7
FLIPADST_ADST = 8
IDTX = 9
V_DCT = 10
H_DCT = 11
V_ADST = 12
H_ADST = 13
V_FLIPADST = 14
H_FLIPADST = 15
WHT_WHT = 16


def tx_w(tx: int) -> int:
    return TX_SIZES[tx][0]


def tx_h(tx: int) -> int:
    return TX_SIZES[tx][1]


# ------------------------------------------------------------------- scans

def _zigzag(w: int, h: int) -> np.ndarray:
    """Up-right diagonal zig-zag scan, alternating direction per
    anti-diagonal (spec Default_Scan tables)."""
    order = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        # even diagonals bottom-left→top-right, odd top-right→bottom-left
        cells.sort(key=lambda rc: rc[0], reverse=(d % 2 == 0))
        order.extend(cells)
    return np.array([r * w + c for (r, c) in order], np.int32)


_SCAN_CACHE: Dict[Tuple[int, int, str], np.ndarray] = {}


def get_scan(tx: int, tx_class: str) -> np.ndarray:
    """Scan order as flat indices into the (h, w) coefficient block.

    tx_class: '2d' (zigzag), 'h' (1-D horizontal class → column scan),
    'v' (1-D vertical class → row scan). Coefficients beyond 32x32 are
    never coded; callers clamp dimensions first.
    """
    w, h = min(tx_w(tx), 32), min(tx_h(tx), 32)
    key = (w, h, tx_class)
    if key not in _SCAN_CACHE:
        if tx_class == '2d':
            if w == h:
                s = _zigzag(w, h)
            else:
                # rect default scans are UNIDIRECTIONAL diagonals
                # (libaom rodata 0x483490-0x485450): tall → each
                # anti-diagonal top-right→bottom-left, wide → reversed
                out = []
                for d in range(w + h - 1):
                    cells = [(r, d - r)
                             for r in range(max(0, d - w + 1),
                                            min(h, d + 1))]
                    if w > h:
                        cells = cells[::-1]
                    out += [r * w + c for (r, c) in cells]
                s = np.array(out, np.int32)
        elif tx_class == 'h':
            # horizontal tx class: scan advances column-by-column
            s = np.array([r * w + c for c in range(w) for r in range(h)],
                         np.int32)
        else:
            s = np.array([r * w + c for r in range(h) for c in range(w)],
                         np.int32)
        _SCAN_CACHE[key] = s
    return _SCAN_CACHE[key]


# --------------------------------------------------------------- quantizer

# dc/ac quantizer lookup for 8-bit (spec §7.12.2 Dc_Qlookup/Ac_Qlookup).
# Extracted from libaom .rodata by tools/extract_av1_cdfs.py would be an
# option, but the spec values are well-known VP9-heritage tables.
DC_QLOOKUP = np.array([
    4, 8, 8, 9, 10, 11, 12, 12, 13, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22,
    23, 24, 25, 26, 26, 27, 28, 29, 30, 31, 32, 32, 33, 34, 35, 36, 37, 38,
    38, 39, 40, 41, 42, 43, 43, 44, 45, 46, 47, 48, 48, 49, 50, 51, 52, 53,
    53, 54, 55, 56, 57, 57, 58, 59, 60, 61, 62, 62, 63, 64, 65, 66, 66, 67,
    68, 69, 70, 70, 71, 72, 73, 74, 74, 75, 76, 77, 78, 78, 79, 80, 81, 81,
    82, 83, 84, 85, 85, 87, 88, 90, 92, 93, 95, 96, 98, 99, 101, 102, 104,
    105, 107, 108, 110, 111, 113, 114, 116, 117, 118, 120, 121, 123, 125,
    127, 129, 131, 134, 136, 138, 140, 142, 144, 146, 148, 150, 152, 154,
    156, 158, 161, 164, 166, 169, 172, 174, 177, 180, 182, 185, 187, 190,
    192, 195, 199, 202, 205, 208, 211, 214, 217, 220, 223, 226, 230, 233,
    237, 240, 243, 247, 250, 253, 257, 261, 265, 269, 272, 276, 280, 284,
    288, 292, 296, 300, 304, 309, 313, 317, 322, 326, 330, 335, 340, 344,
    349, 354, 359, 364, 369, 374, 379, 384, 389, 395, 400, 406, 411, 417,
    423, 429, 435, 441, 447, 454, 461, 467, 475, 482, 489, 497, 505, 513,
    522, 530, 539, 549, 559, 569, 579, 590, 602, 614, 626, 640, 654, 668,
    684, 700, 717, 736, 755, 775, 796, 819, 843, 869, 896, 925, 955, 988,
    1022, 1058, 1098, 1139, 1184, 1232, 1282, 1336,
], np.int32)

AC_QLOOKUP = np.array([
    4, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97,
    98, 99, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 120, 122,
    124, 126, 128, 130, 132, 134, 136, 138, 140, 142, 144, 146, 148, 150,
    152, 155, 158, 161, 164, 167, 170, 173, 176, 179, 182, 185, 188, 191,
    194, 197, 200, 203, 207, 211, 215, 219, 223, 227, 231, 235, 239, 243,
    247, 251, 255, 260, 265, 270, 275, 280, 285, 290, 295, 300, 305, 311,
    317, 323, 329, 335, 341, 347, 353, 359, 366, 373, 380, 387, 394, 401,
    408, 416, 424, 432, 440, 448, 456, 465, 474, 483, 492, 501, 510, 520,
    530, 540, 550, 560, 571, 582, 593, 604, 615, 627, 639, 651, 663, 676,
    689, 702, 715, 729, 743, 757, 771, 786, 801, 816, 832, 848, 864, 881,
    898, 915, 933, 951, 969, 988, 1007, 1026, 1046, 1066, 1087, 1108, 1129,
    1151, 1173, 1196, 1219, 1243, 1267, 1292, 1317, 1343, 1369, 1396, 1423,
    1451, 1479, 1508, 1537, 1567, 1597, 1628, 1660, 1692, 1725, 1759, 1793,
    1828,
], np.int32)

# 10/12-bit dequant lookups (spec §7.12.2 Dc_Qlookup[1..2]/Ac_Qlookup):
# spec-mandated constants extracted from system libaom .rodata by
# tools/extract_av1_qlookup.py; pinned by the 10-bit oracle difftests.
_QL_HBD = None


def _qlookup_hbd():
    global _QL_HBD
    if _QL_HBD is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "qlookup_hbd.npz")
        z = np.load(path)
        _QL_HBD = {k: z[k].astype(np.int32) for k in z.files}
    return _QL_HBD


def dc_qlookup(bit_depth: int) -> np.ndarray:
    if bit_depth == 8:
        return DC_QLOOKUP
    return _qlookup_hbd()[f"dc_qlookup_{bit_depth}"]


def ac_qlookup(bit_depth: int) -> np.ndarray:
    if bit_depth == 8:
        return AC_QLOOKUP
    return _qlookup_hbd()[f"ac_qlookup_{bit_depth}"]
