"""H.264 I-slice macroblock decode + reconstruction (Rec. H.264 §7-§8).

A copy of libheif_tpu/codecs/avc/mb.py, unchanged but for the docstring.

Covers the intra toolset the reference reaches through its
openh264/x264 plugins (reference: libheif/plugins/decoder_openh264.cc):
CABAC entropy decode, Intra_4x4 / Intra_8x8 / Intra_16x16 / chroma
prediction, 4x4/8x8 integer inverse transforms with the Hadamard DC
chains, I_PCM, 4:2:0 and monochrome, 8-bit.

Entropy decode is inherently serial per slice; reconstruction is plain
int32 numpy here (host path). The decoder (decoder.py) brings the
finished planes to the context's device in one copy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...core.error import HeifError, SubError
from . import tables as T
from .cabac import AvcCabacDecoder
from .headers import SPS, PPS, SliceHeader

I_NXN = 0
I_PCM = 25


def clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


def _check_intra_mode(mode: int, ht: bool, hl: bool, htl: bool) -> None:
    """Conformant streams only signal intra modes whose reference
    samples exist (spec 8.3.1.2 constraint); corrupt CABAC state can
    produce any mode, so validate before predicting (4x4/8x8 common
    numbering: VERT/DDL/VL need top, HOR/HU need left, DC none,
    DDR/VR/HD need all three)."""
    if mode in (T.I4_VERT, T.I4_DDL, T.I4_VL):
        ok = ht
    elif mode in (T.I4_HOR, T.I4_HU):
        ok = hl
    elif mode == T.I4_DC:
        ok = True
    else:
        ok = ht and hl and htl
    if not ok:
        raise HeifError.invalid_input(
            msg="intra mode requires unavailable neighbor samples")


# --------------------------------------------------------------------------
# inverse transforms (spec 8.5.12 / 8.5.13 / 8.5.10 / 8.5.11)
# --------------------------------------------------------------------------

def itrans4(d: np.ndarray) -> np.ndarray:
    """4x4 core inverse transform, output residual (spec 8.5.12.2)."""
    d = d.astype(np.int64)
    # horizontal (rows)
    e0 = d[:, 0] + d[:, 2]
    e1 = d[:, 0] - d[:, 2]
    e2 = (d[:, 1] >> 1) - d[:, 3]
    e3 = d[:, 1] + (d[:, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)
    # vertical (columns)
    e0 = f[0] + f[2]
    e1 = f[0] - f[2]
    e2 = (f[1] >> 1) - f[3]
    e3 = f[1] + (f[3] >> 1)
    g = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=0)
    return ((g + 32) >> 6).astype(np.int32)


def ihadamard4(c: np.ndarray) -> np.ndarray:
    """4x4 inverse Hadamard for Intra16x16 luma DC (spec 8.5.10)."""
    c = c.astype(np.int64)
    e0 = c[:, 0] + c[:, 2]
    e1 = c[:, 0] - c[:, 2]
    e2 = c[:, 1] - c[:, 3]
    e3 = c[:, 1] + c[:, 3]
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)
    e0 = f[0] + f[2]
    e1 = f[0] - f[2]
    e2 = f[1] - f[3]
    e3 = f[1] + f[3]
    return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=0)


def _itrans8_1d(d):
    d0, d1, d2, d3, d4, d5, d6, d7 = [d[..., i] for i in range(8)]
    e0 = d0 + d4
    e1 = -d3 + d5 - d7 - (d7 >> 1)
    e2 = d0 - d4
    e3 = d1 + d7 - d3 - (d3 >> 1)
    e4 = (d2 >> 1) - d6
    e5 = -d1 + d7 + d5 + (d5 >> 1)
    e6 = d2 + (d6 >> 1)
    e7 = d3 + d5 + d1 + (d1 >> 1)
    f0 = e0 + e6
    f1 = e1 + (e7 >> 2)
    f2 = e2 + e4
    f3 = e3 + (e5 >> 2)
    f4 = e2 - e4
    f5 = (e3 >> 2) - e5
    f6 = e0 - e6
    f7 = e7 - (e1 >> 2)
    return np.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                     f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)


def itrans8(d: np.ndarray) -> np.ndarray:
    """8x8 inverse transform (spec 8.5.13.2)."""
    d = d.astype(np.int64)
    f = _itrans8_1d(d)                       # rows
    g = _itrans8_1d(f.T).T                   # columns
    return ((g + 32) >> 6).astype(np.int32)


def dequant4(c: np.ndarray, qp: int) -> np.ndarray:
    """4x4 AC/residual dequant (spec 8.5.12.1)."""
    ls = T.LEVEL_SCALE_4[qp % 6].astype(np.int64)
    c = c.astype(np.int64)
    if qp >= 24:
        return (c * ls) << (qp // 6 - 4)
    return (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)


def dequant8(c: np.ndarray, qp: int) -> np.ndarray:
    """8x8 dequant (spec 8.5.13.1)."""
    ls = T.LEVEL_SCALE_8[qp % 6].astype(np.int64)
    c = c.astype(np.int64)
    if qp >= 36:
        return (c * ls) << (qp // 6 - 6)
    return (c * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


# --------------------------------------------------------------------------
# intra prediction (spec 8.3)
# --------------------------------------------------------------------------

def pred_4x4(mode: int, top: Optional[np.ndarray], left: Optional[np.ndarray],
             topleft: Optional[int], topright: Optional[np.ndarray]):
    """4x4 intra prediction (spec 8.3.1.2). top: 4 samples, topright: 4
    samples (already substituted with top[3] if unavailable), left: 4,
    topleft scalar. None = unavailable."""
    p = np.zeros((4, 4), np.int32)
    if mode == T.I4_DC:
        if top is not None and left is not None:
            v = (int(top.sum()) + int(left.sum()) + 4) >> 3
        elif top is not None:
            v = (int(top.sum()) + 2) >> 2
        elif left is not None:
            v = (int(left.sum()) + 2) >> 2
        else:
            v = 128
        p[:, :] = v
        return p
    if mode == T.I4_VERT:
        p[:, :] = top[None, :]
        return p
    if mode == T.I4_HOR:
        p[:, :] = left[:, None]
        return p
    # build the extended arrays used by the directional modes
    t = None
    if top is not None:
        t = np.zeros(8, np.int64)
        t[:4] = top
        t[4:] = topright
    l = left.astype(np.int64) if left is not None else None
    m = topleft
    if mode == T.I4_DDL:
        for y in range(4):
            for x in range(4):
                i = x + y
                if i == 6:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return p
    if mode == T.I4_DDR:
        for y in range(4):
            for x in range(4):
                if x > y:
                    i = x - y
                    p[y, x] = (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2 \
                        if i >= 2 else (m + 2 * t[0] + t[1] + 2) >> 2
                elif x < y:
                    i = y - x
                    p[y, x] = (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2 \
                        if i >= 2 else (m + 2 * l[0] + l[1] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
        return p
    if mode == T.I4_VR:
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    i = x - (y >> 1)
                    p[y, x] = (t[i - 1] + t[i] + 1) >> 1 if i >= 1 \
                        else (m + t[0] + 1) >> 1
                elif z >= 0:
                    i = x - (y >> 1)
                    if i >= 2:
                        p[y, x] = (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2
                    else:
                        p[y, x] = (m + 2 * t[0] + t[1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * m + t[0] + 2) >> 2
                else:
                    i = y - 2 * x
                    p[y, x] = (l[i - 1] + 2 * l[i - 2] + l[i - 3] + 2) >> 2 \
                        if i >= 3 else (l[y - 1] + 2 * l[y - 2 - 0] +
                                        (m if y - 3 < 0 else l[y - 3]) + 2) >> 2
        # the else-branch above only occurs for (x,y) with zVR in {-2,-3}
        # i.e. x=0,y in {2,3}: p = (l[y-1] + 2*l[y-2] + l[y-3 or m]+2)>>2
        return p
    if mode == T.I4_HD:
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    i = y - (x >> 1)
                    p[y, x] = (l[i - 1] + l[i] + 1) >> 1 if i >= 1 \
                        else (m + l[0] + 1) >> 1
                elif z >= 0:
                    i = y - (x >> 1)
                    if i >= 2:
                        p[y, x] = (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2
                    else:
                        p[y, x] = (m + 2 * l[0] + l[1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
                else:
                    i = x - 2 * y
                    p[y, x] = (t[i - 1] + 2 * t[i - 2] +
                               (t[i - 3] if i >= 3 else m) + 2) >> 2
        return p
    if mode == T.I4_VL:
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return p
    if mode == T.I4_HU:
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z > 5:
                    p[y, x] = l[3]
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                elif z % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                else:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
        return p
    raise HeifError.invalid_input(msg=f"bad intra4x4 mode {mode}")


def pred_8x8(mode: int, top: Optional[np.ndarray], left: Optional[np.ndarray],
             topleft: Optional[int], have_tl: bool):
    """8x8 intra prediction with reference filtering (spec 8.3.2.2).
    top: 16 samples (top-right already substituted), left: 8, topleft
    scalar or None."""
    # reference sample filtering (8.3.2.2.1)
    ft = None
    fl = None
    fm = None
    if top is not None:
        t = top.astype(np.int64)
        ft = np.empty(16, np.int64)
        if have_tl:
            ft[0] = (topleft + 2 * t[0] + t[1] + 2) >> 2
        else:
            ft[0] = (3 * t[0] + t[1] + 2) >> 2
        for x in range(1, 15):
            ft[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2
    if have_tl:
        m = int(topleft)
        if top is not None and left is not None:
            fm = (left[0] + 2 * m + top[0] + 2) >> 2
        elif top is not None:
            fm = (3 * m + top[0] + 2) >> 2    # left unavailable
        elif left is not None:
            fm = (3 * m + left[0] + 2) >> 2   # hmm: spec symmetric case
        else:
            fm = m
    if left is not None:
        l = left.astype(np.int64)
        fl = np.empty(8, np.int64)
        if have_tl:
            fl[0] = (topleft + 2 * l[0] + l[1] + 2) >> 2
        else:
            fl[0] = (3 * l[0] + l[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2

    p = np.zeros((8, 8), np.int32)
    t, l, m = ft, fl, fm
    if mode == T.I4_DC:
        if t is not None and l is not None:
            v = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif t is not None:
            v = (int(t[:8].sum()) + 4) >> 3
        elif l is not None:
            v = (int(l.sum()) + 4) >> 3
        else:
            v = 128
        p[:, :] = v
        return p
    if mode == T.I4_VERT:
        p[:, :] = t[None, :8]
        return p
    if mode == T.I4_HOR:
        p[:, :] = l[:, None]
        return p
    if mode == T.I4_DDL:
        for y in range(8):
            for x in range(8):
                i = x + y
                if i == 14:
                    p[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return p
    if mode == T.I4_DDR:
        for y in range(8):
            for x in range(8):
                if x > y:
                    i = x - y
                    p[y, x] = (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2 \
                        if i >= 2 else (m + 2 * t[0] + t[1] + 2) >> 2
                elif x < y:
                    i = y - x
                    p[y, x] = (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2 \
                        if i >= 2 else (m + 2 * l[0] + l[1] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
        return p
    if mode == T.I4_VR:
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                i = x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (t[i - 1] + t[i] + 1) >> 1 if i >= 1 \
                        else (m + t[0] + 1) >> 1
                elif z >= 0:
                    if i >= 2:
                        p[y, x] = (t[i - 2] + 2 * t[i - 1] + t[i] + 2) >> 2
                    else:
                        p[y, x] = (m + 2 * t[0] + t[1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * m + t[0] + 2) >> 2
                else:
                    i = y - 2 * x - 1
                    p[y, x] = (l[i] + 2 * l[i - 1] +
                               (l[i - 2] if i >= 2 else m) + 2) >> 2
        return p
    if mode == T.I4_HD:
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                i = y - (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (l[i - 1] + l[i] + 1) >> 1 if i >= 1 \
                        else (m + l[0] + 1) >> 1
                elif z >= 0:
                    if i >= 2:
                        p[y, x] = (l[i - 2] + 2 * l[i - 1] + l[i] + 2) >> 2
                    else:
                        p[y, x] = (m + 2 * l[0] + l[1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (t[0] + 2 * m + l[0] + 2) >> 2
                else:
                    i = x - 2 * y - 1
                    p[y, x] = (t[i] + 2 * t[i - 1] +
                               (t[i - 2] if i >= 2 else m) + 2) >> 2
        return p
    if mode == T.I4_VL:
        for y in range(8):
            for x in range(8):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return p
    if mode == T.I4_HU:
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z > 13:
                    p[y, x] = l[7]
                elif z == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                elif z % 2 == 0:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + l[i + 1] + 1) >> 1
                else:
                    i = y + (x >> 1)
                    p[y, x] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
        return p
    raise HeifError.invalid_input(msg=f"bad intra8x8 mode {mode}")


def pred_16x16(mode: int, top: Optional[np.ndarray],
               left: Optional[np.ndarray], topleft: Optional[int]):
    """16x16 luma prediction (spec 8.3.3)."""
    p = np.zeros((16, 16), np.int32)
    if mode == T.I16_DC:
        if top is not None and left is not None:
            v = (int(top.sum()) + int(left.sum()) + 16) >> 5
        elif top is not None:
            v = (int(top.sum()) + 8) >> 4
        elif left is not None:
            v = (int(left.sum()) + 8) >> 4
        else:
            v = 128
        p[:, :] = v
    elif mode == T.I16_VERT:
        p[:, :] = top[None, :]
    elif mode == T.I16_HOR:
        p[:, :] = left[:, None]
    else:  # plane
        t = top.astype(np.int64)
        l = left.astype(np.int64)
        m = int(topleft)
        h = sum((x + 1) * (t[8 + x] - (t[6 - x] if x < 7 else m))
                for x in range(8))
        v = sum((y + 1) * (l[8 + y] - (l[6 - y] if y < 7 else m))
                for y in range(8))
        a = 16 * (int(t[15]) + int(l[15]))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        ys, xs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        p = np.clip((a + b * (xs - 7) + c * (ys - 7) + 16) >> 5,
                    0, 255).astype(np.int32)
    return p


def pred_chroma(mode: int, top: Optional[np.ndarray],
                left: Optional[np.ndarray], topleft: Optional[int]):
    """8x8 chroma prediction, 4:2:0 (spec 8.3.4)."""
    p = np.zeros((8, 8), np.int32)
    if mode == T.C_DC:
        # per-4x4 DC with positional neighbor sets
        for by in (0, 4):
            for bx in (0, 4):
                t = top[bx:bx + 4] if top is not None else None
                l = left[by:by + 4] if left is not None else None
                if bx == 0 and by == 0 or (bx == 4 and by == 4):
                    if t is not None and l is not None:
                        v = (int(t.sum()) + int(l.sum()) + 4) >> 3
                    elif t is not None:
                        v = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        v = (int(l.sum()) + 2) >> 2
                    else:
                        v = 128
                elif bx == 4 and by == 0:
                    if t is not None:
                        v = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        v = (int(l.sum()) + 2) >> 2
                    else:
                        v = 128
                else:  # bx == 0, by == 4
                    if l is not None:
                        v = (int(l.sum()) + 2) >> 2
                    elif t is not None:
                        v = (int(t.sum()) + 2) >> 2
                    else:
                        v = 128
                p[by:by + 4, bx:bx + 4] = v
        return p
    if mode == T.C_HOR:
        p[:, :] = left[:, None]
        return p
    if mode == T.C_VERT:
        p[:, :] = top[None, :]
        return p
    # plane
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    m = int(topleft)
    h = sum((x + 1) * (t[4 + x] - (t[2 - x] if x < 3 else m))
            for x in range(4))
    v = sum((y + 1) * (l[4 + y] - (l[2 - y] if y < 3 else m))
            for y in range(4))
    a = 16 * (int(t[7]) + int(l[7]))
    b = (17 * h + 16) >> 5
    c = (17 * v + 16) >> 5
    ys, xs = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    return np.clip((a + b * (xs - 3) + c * (ys - 3) + 16) >> 5,
                   0, 255).astype(np.int32)


# --------------------------------------------------------------------------
# slice decoder
# --------------------------------------------------------------------------

class MBInfo:
    __slots__ = ("mb_type", "is_i16", "is_pcm", "is_nxn", "tx8",
                 "cbp_luma", "cbp_chroma", "chroma_mode", "qp",
                 "qp_delta", "i16_mode", "is_inter", "skipped")

    def __init__(self):
        self.mb_type = -1
        self.is_i16 = False
        self.is_pcm = False
        self.is_nxn = False
        self.tx8 = False
        self.cbp_luma = 0
        self.cbp_chroma = 0
        self.chroma_mode = 0
        self.qp = 26
        self.qp_delta = 0
        self.i16_mode = 0
        self.is_inter = False
        self.skipped = False


# ------------------------------------------------------------ inter MC

def _mc_luma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
             mvx: int, mvy: int) -> np.ndarray:
    """Quarter-pel luma MC (spec 8.4.2.2.1): 6-tap half-pel + averaged
    quarter positions, edge-clamped reference."""
    xi, yi = x0 + (mvx >> 2), y0 + (mvy >> 2)
    fx, fy = mvx & 3, mvy & 3
    rh, rw = ref.shape
    # padded gather: rows yi-2 .. yi+h+2, cols xi-2 .. xi+w+2
    ys = np.clip(np.arange(yi - 2, yi + h + 3), 0, rh - 1)
    xs = np.clip(np.arange(xi - 2, xi + w + 3), 0, rw - 1)
    g = ref[np.ix_(ys, xs)].astype(np.int64)   # (h+5, w+5)

    def tap6(a, axis):
        if axis == 1:
            return (a[:, 0:-5] - 5 * a[:, 1:-4] + 20 * a[:, 2:-3] +
                    20 * a[:, 3:-2] - 5 * a[:, 4:-1] + a[:, 5:])
        return (a[0:-5] - 5 * a[1:-4] + 20 * a[2:-3] +
                20 * a[3:-2] - 5 * a[4:-1] + a[5:])

    G = g[2:2 + h + 1, 2:2 + w + 1]            # (h+1, w+1) integer grid
    if fx == 0 and fy == 0:
        return G[:h, :w]
    b1 = tap6(g, 1)                            # (h+5, w)  b at cols
    h1 = tap6(g, 0)                            # (h, w+5)
    b = np.clip((b1[2:2 + h + 1, :] + 16) >> 5, 0, 255)   # (h+1, w)
    hh = np.clip((h1[:, 2:2 + w + 1] + 16) >> 5, 0, 255)  # (h, w+1)
    if fy == 0:                                # a, b, c row
        if fx == 1:
            return (G[:h, :w] + b[:h, :w] + 1) >> 1
        if fx == 2:
            return b[:h, :w]
        return (b[:h, :w] + G[:h, 1:w + 1] + 1) >> 1
    if fx == 0:                                # d, h, n column
        if fy == 1:
            return (G[:h, :w] + hh[:h, :w] + 1) >> 1
        if fy == 2:
            return hh[:h, :w]
        return (hh[:h, :w] + G[1:h + 1, :w] + 1) >> 1
    # j from the un-normalized horizontal intermediates
    j1 = tap6(b1, 0)                           # (h, w)
    j = np.clip((j1 + 512) >> 10, 0, 255)
    if fx == 2 and fy == 2:
        return j
    if fy == 1:
        if fx == 1:                            # e = (b + h)/2
            return (b[:h, :w] + hh[:h, :w] + 1) >> 1
        if fx == 2:                            # f = (b + j)/2
            return (b[:h, :w] + j + 1) >> 1
        return (b[:h, :w] + hh[:h, 1:w + 1] + 1) >> 1   # g
    if fy == 2:
        if fx == 1:                            # i = (h + j)/2
            return (hh[:h, :w] + j + 1) >> 1
        return (j + hh[:h, 1:w + 1] + 1) >> 1           # k
    # fy == 3
    if fx == 1:                                # p = (h + s)/2
        return (hh[:h, :w] + b[1:h + 1, :w] + 1) >> 1
    if fx == 2:                                # q = (j + s)/2
        return (j + b[1:h + 1, :w] + 1) >> 1
    return (hh[:h, 1:w + 1] + b[1:h + 1, :w] + 1) >> 1  # r


def _mc_chroma(ref: np.ndarray, xc: int, yc: int, w: int, h: int,
               mvx: int, mvy: int) -> np.ndarray:
    """Eighth-pel bilinear chroma MC (spec 8.4.2.2.2); coords in
    chroma samples, mv in quarter-luma (= eighth-chroma) units."""
    xi, yi = xc + (mvx >> 3), yc + (mvy >> 3)
    xf, yf = mvx & 7, mvy & 7
    rh, rw = ref.shape
    ys = np.clip(np.arange(yi, yi + h + 1), 0, rh - 1)
    xs = np.clip(np.arange(xi, xi + w + 1), 0, rw - 1)
    g = ref[np.ix_(ys, xs)].astype(np.int64)
    a = g[:h, :w]
    b = g[:h, 1:w + 1]
    c = g[1:h + 1, :w]
    d = g[1:h + 1, 1:w + 1]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b +
            (8 - xf) * yf * c + xf * yf * d + 32) >> 6


class SliceDecoder:
    """Decodes one I or P slice into the shared frame planes."""

    def __init__(self, sps: SPS, pps: PPS, planes: List[np.ndarray],
                 ref_planes: Optional[List[List[np.ndarray]]] = None):
        self.sps = sps
        self.pps = pps
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.pic_height_in_map_units
        self.planes = planes       # [Y (16-aligned), U, V] int32
        self.ref_planes = ref_planes or []   # list-0 refs [[Y, U, V]]
        self.mono = sps.chroma_format_idc == 0
        n = self.mb_w * self.mb_h
        self.mb: List[Optional[MBInfo]] = [None] * n
        # per-4x4-block luma intra modes (-1 = not I_NxN), frame-wide
        self.i4_modes = np.full((self.mb_h * 4, self.mb_w * 4), -1,
                                np.int32)
        # cbf storage for CABAC ctx: luma 4x4 grid, luma DC per MB,
        # chroma DC per MB/plane, chroma AC per 4x4
        self.cbf_luma = np.zeros((self.mb_h * 4, self.mb_w * 4), np.int8)
        self.cbf_luma_dc = np.zeros((self.mb_h, self.mb_w), np.int8)
        self.cbf_chroma_dc = np.zeros((2, self.mb_h, self.mb_w), np.int8)
        self.cbf_chroma = np.zeros((2, self.mb_h * 2, self.mb_w * 2),
                                   np.int8)
        # per-4x4 motion state (P slices): mv quarter-pel, ref -1=intra
        self.mv = np.zeros((self.mb_h * 4, self.mb_w * 4, 2), np.int32)
        self.ref = np.full((self.mb_h * 4, self.mb_w * 4), -1, np.int16)
        self.mvd = np.zeros((self.mb_h * 4, self.mb_w * 4, 2), np.int32)
        # sub-MB decode progress (C-neighbor availability, spec 6.4.11)
        self.blk_done = np.ones((self.mb_h * 4, self.mb_w * 4), np.int8)
        self.first_mb = 0

    # ----------------------------------------------------------- helpers

    def mb_at(self, mbx: int, mby: int) -> Optional[MBInfo]:
        if mbx < 0 or mby < 0 or mbx >= self.mb_w or mby >= self.mb_h:
            return None
        idx = mby * self.mb_w + mbx
        if idx < self.first_mb:
            return None
        return self.mb[idx]

    # ------------------------------------------------------ slice decode

    def decode_slice(self, hdr: SliceHeader, rbsp: bytes) -> None:
        self.first_mb = hdr.first_mb
        is_p = hdr.is_p
        if is_p and not self.ref_planes:
            raise HeifError.invalid_input(
                msg="P slice without reference pictures")
        start_byte = (hdr.header_bits + 7) // 8  # cabac_alignment_one_bit
        d = AvcCabacDecoder(rbsp, start_byte, hdr.qp, is_p=is_p,
                            cabac_init_idc=hdr.cabac_init_idc)
        self.d = d
        self.qp = hdr.qp
        self.prev_qp_delta = 0
        addr = hdr.first_mb
        n = self.mb_w * self.mb_h
        while addr < n:
            self.mbx = addr % self.mb_w
            self.mby = addr // self.mb_w
            self.cur = MBInfo()
            self.mb[addr] = self.cur
            if is_p:
                self._decode_mb_p()
            else:
                self._decode_mb()
            addr += 1
            if d.decode_terminate():
                break
        self.last_hdr = hdr

    # ------------------------------------------------------ P slice mbs

    def _mb_skip_inc(self) -> int:
        """ctxIdxInc for mb_skip_flag (spec 9.3.3.1.1.1)."""
        a = self.mb_at(self.mbx - 1, self.mby)
        b = self.mb_at(self.mbx, self.mby - 1)
        return (1 if (a is not None and not a.skipped) else 0) + \
               (1 if (b is not None and not b.skipped) else 0)

    def _decode_mb_p(self) -> None:
        d = self.d
        cur = self.cur
        if d.decode_bin(T.CTX_MB_SKIP_P + self._mb_skip_inc()):
            # P_Skip
            cur.is_inter = True
            cur.skipped = True
            cur.qp = self.qp
            self.prev_qp_delta = 0
            mv = self._pskip_mv()
            self._recon_inter(mv, (0, 0, 0))
            self._set_motion(mv, mvd=(0, 0))
            return
        # mb_type, P prefix (spec 9.3.2.5 Table 9-37 + ffmpeg ctx model)
        if d.decode_bin(T.CTX_MB_TYPE_P):
            # intra suffix, ctx base 17 (bins: 0 I_NxN, terminate PCM,
            # +1 luma cbp, +2 chroma both bins, +3 both mode bins)
            base = T.CTX_MB_TYPE_P + 3
            if d.decode_bin(base) == 0:
                cur.mb_type = I_NXN
                cur.is_nxn = True
                self._decode_i_nxn()
            elif d.decode_terminate():
                cur.mb_type = I_PCM
                cur.is_pcm = True
                self._decode_pcm()
            else:
                luma_flag = d.decode_bin(base + 1)
                chroma = 0
                if d.decode_bin(base + 2):
                    chroma = 1 + d.decode_bin(base + 2)
                mode = 2 * d.decode_bin(base + 3)
                mode += d.decode_bin(base + 3)
                cur.mb_type = 1 + mode + 4 * chroma + 12 * luma_flag
                cur.is_i16 = True
                cur.i16_mode = mode
                cur.cbp_luma = 15 if luma_flag else 0
                cur.cbp_chroma = chroma
                self._decode_i16()
            return
        b1 = d.decode_bin(T.CTX_MB_TYPE_P + 1)
        b2 = d.decode_bin(T.CTX_MB_TYPE_P + (3 if b1 else 2))
        # bins (Table 9-37): 000 P_L0_16x16, 011 16x8, 010 8x16, 001 P_8x8
        if b1 == 0 and b2 == 0:
            ptype = 0           # P_L0_16x16
        elif b1 == 0:
            ptype = 3           # P_8x8
        elif b2:
            ptype = 1           # P_L0_L0_16x8
        else:
            ptype = 2           # P_L0_L0_8x16
        cur.is_inter = True
        cur.mb_type = -2 - ptype
        num_ref = getattr(self, "num_ref_idx_l0", 1)
        gx0, gy0 = self.mbx * 4, self.mby * 4
        # mark current MB's blocks undecoded for C-neighbor availability
        self.blk_done[gy0:gy0 + 4, gx0:gx0 + 4] = 0

        # ---- partition geometry ----
        if ptype == 0:
            ref_parts = [(0, 0, 16, 16)]
            mv_parts = [[(0, 0, 16, 16)]]
        elif ptype == 1:
            ref_parts = [(0, 0, 16, 8), (0, 8, 16, 8)]
            mv_parts = [[p] for p in ref_parts]
        elif ptype == 2:
            ref_parts = [(0, 0, 8, 16), (8, 0, 8, 16)]
            mv_parts = [[p] for p in ref_parts]
        else:
            # P_8x8: sub_mb_type per 8x8 (Table 9-38: '1' 8x8,
            # '00' 8x4, '011' 4x8, '010' 4x4; ctx 21/22/23)
            ref_parts = [(0, 0, 8, 8), (8, 0, 8, 8),
                         (0, 8, 8, 8), (8, 8, 8, 8)]
            mv_parts = []
            for (sx, sy, _, _) in ref_parts:
                if d.decode_bin(T.CTX_SUB_MB_TYPE_P):
                    subs = [(sx, sy, 8, 8)]
                elif d.decode_bin(T.CTX_SUB_MB_TYPE_P + 1) == 0:
                    subs = [(sx, sy, 8, 4), (sx, sy + 4, 8, 4)]
                elif d.decode_bin(T.CTX_SUB_MB_TYPE_P + 2):
                    subs = [(sx, sy, 4, 8), (sx + 4, sy, 4, 8)]
                else:
                    subs = [(sx, sy, 4, 4), (sx + 4, sy, 4, 4),
                            (sx, sy + 4, 4, 4), (sx + 4, sy + 4, 4, 4)]
                mv_parts.append(subs)

        self._inter_mb_body(ptype, ref_parts, mv_parts, num_ref)

    def _inter_mb_body(self, ptype, ref_parts, mv_parts,
                       num_ref: int, ref0_forced: bool = False) -> None:
        """ref_idx + mvd parse, MV derivation, MC and residual for one
        inter MB (shared by the CABAC and CAVLC front ends)."""
        gx0, gy0 = self.mbx * 4, self.mby * 4
        sub8x8_only = all(subs[0][2:] == (8, 8) for subs in mv_parts)
        # ---- ref_idx per ref partition, then mvd per mv partition ----
        refs = []
        for (px, py, pw, ph) in ref_parts:
            r = 0
            if num_ref > 1 and not ref0_forced:
                r = self._decode_ref_idx(gx0 + px // 4, gy0 + py // 4)
            if r >= len(self.ref_planes):
                raise HeifError.invalid_input(msg="ref_idx out of range")
            refs.append(r)
            # refs are ctx for later ref_idx bins within the MB
            self.ref[gy0 + py // 4:gy0 + (py + ph) // 4,
                     gx0 + px // 4:gx0 + (px + pw) // 4] = r
        mvds = []
        for subs in mv_parts:
            row = []
            for (px, py, pw, ph) in subs:
                bx, by = gx0 + px // 4, gy0 + py // 4
                mvd = (self._decode_mvd(0, bx, by),
                       self._decode_mvd(1, bx, by))
                self.mvd[by:by + max(ph // 4, 1),
                         bx:bx + max(pw // 4, 1)] = mvd
                row.append(mvd)
            mvds.append(row)

        # ---- derive MVs + MC, partition by partition (8.4.1.3) ----
        pred_y = np.zeros((16, 16), np.int64)
        pred_cb = pred_cr = None
        if not self.mono:
            pred_cb = np.zeros((8, 8), np.int64)
            pred_cr = np.zeros((8, 8), np.int64)
        ref = None
        for pi, subs in enumerate(mv_parts):
            r = refs[pi]
            ref = self.ref_planes[r]
            for si, (px, py, pw, ph) in enumerate(subs):
                mvd = mvds[pi][si]
                mvp = self._mvp(px, py, pw, ph, r, ptype)
                mv = (mvp[0] + mvd[0], mvp[1] + mvd[1])
                bx, by = gx0 + px // 4, gy0 + py // 4
                nw, nh = max(pw // 4, 1), max(ph // 4, 1)
                self.mv[by:by + nh, bx:bx + nw] = mv
                self.ref[by:by + nh, bx:bx + nw] = r
                self.blk_done[by:by + nh, bx:bx + nw] = 1
                x0, y0 = self.mbx * 16 + px, self.mby * 16 + py
                pred_y[py:py + ph, px:px + pw] = _mc_luma(
                    ref[0], x0, y0, pw, ph, mv[0], mv[1])
                if not self.mono:
                    cw, chh = pw // 2, ph // 2
                    cx, cy = px // 2, py // 2
                    pred_cb[cy:cy + chh, cx:cx + cw] = _mc_chroma(
                        ref[1], x0 // 2, y0 // 2, cw, chh, mv[0], mv[1])
                    pred_cr[cy:cy + chh, cx:cx + cw] = _mc_chroma(
                        ref[2], x0 // 2, y0 // 2, cw, chh, mv[0], mv[1])
        tx8_allowed = ptype != 3 or sub8x8_only
        self._decode_inter_residual_pred(pred_y, pred_cb, pred_cr,
                                         tx8_allowed)
        self.blk_done[gy0:gy0 + 4, gx0:gx0 + 4] = 1

    def _decode_ref_idx(self, bx: int, by: int) -> int:
        d = self.d

        def gt0(x, y):
            if x < 0 or y < 0:
                return 0
            nb = self.mb_at(x // 4, y // 4)
            if nb is None or (nb is not self.cur and not nb.is_inter):
                return 0
            # current-MB partitions preceding in parse order have their
            # ref written already (unparsed blocks hold -1 → 0)
            return 1 if self.ref[y, x] > 0 else 0
        inc = gt0(bx - 1, by) + 2 * gt0(bx, by - 1)
        v = 0
        if d.decode_bin(T.CTX_REF_IDX + inc):
            v = 1
            while d.decode_bin(T.CTX_REF_IDX +
                               (4 if v == 1 else 5)):
                v += 1
                if v > 31:
                    raise HeifError.invalid_input(msg="ref_idx runaway")
        return v

    def _decode_mvd(self, comp: int, bx: int, by: int) -> int:
        """mvd_l0 component (spec 9.3.3.1.1.7 ctx + UEG3 binarization);
        (bx, by) is the partition's top-left in 4x4 units."""
        d = self.d
        base = T.CTX_MVD_X if comp == 0 else T.CTX_MVD_Y

        def amvd(x, y):
            if x < 0 or y < 0 or x >= self.mb_w * 4 or y >= self.mb_h * 4:
                return 0
            nb = self.mb_at(x // 4, y // 4)
            if nb is None or (nb is not self.cur and not nb.is_inter):
                return 0
            return abs(int(self.mvd[y, x, comp]))
        s = amvd(bx - 1, by) + amvd(bx, by - 1)
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        if d.decode_bin(base + inc) == 0:
            return 0
        # TU prefix up to 9 with ctx incs 3,4,5,6,6,...
        v = 1
        while v < 9 and d.decode_bin(base + min(v + 2, 6)):
            v += 1
        if v == 9:
            v += d.decode_eg_bypass(3)
        return -v if d.decode_bypass() else v

    # ---------------------------------------------- motion prediction

    def _mv_neighbor(self, gx: int, gy: int):
        """(available, ref, mv) of the 4x4 block at (gx, gy); blocks of
        the current MB count only once their partition is decoded."""
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4 or gy >= self.mb_h * 4:
            return False, -1, (0, 0)
        nb = self.mb_at(gx // 4, gy // 4)
        if nb is None:
            return False, -1, (0, 0)
        if nb is self.cur:
            if not self.blk_done[gy, gx]:
                return False, -1, (0, 0)
        elif not nb.is_inter:
            return True, -1, (0, 0)      # intra: available, ref -1, mv 0
        return True, int(self.ref[gy, gx]), \
            (int(self.mv[gy, gx, 0]), int(self.mv[gy, gx, 1]))

    def _mvp(self, px: int, py: int, pw: int, ph: int, ref_idx: int,
             ptype: int):
        """MV predictor for one partition (spec 8.4.1.3): median of
        A/B/C with the directional 16x8 / 8x16 shortcuts and the
        above-left substitution for C."""
        gx = self.mbx * 4 + px // 4
        gy = self.mby * 4 + py // 4
        a = self._mv_neighbor(gx - 1, gy)
        b = self._mv_neighbor(gx, gy - 1)
        c = self._mv_neighbor(gx + pw // 4, gy - 1)
        if not c[0]:
            c = self._mv_neighbor(gx - 1, gy - 1)
        if ptype == 1:                    # 16x8 rows
            if py == 0 and b[0] and b[1] == ref_idx:
                return b[2]
            if py == 8 and a[0] and a[1] == ref_idx:
                return a[2]
        elif ptype == 2:                  # 8x16 columns
            if px == 0 and a[0] and a[1] == ref_idx:
                return a[2]
            if px == 8 and c[0] and c[1] == ref_idx:
                return c[2]
        if not (b[0] or c[0]) and a[0]:
            return a[2]
        matches = [mv for avail, ref, mv in (a, b, c) if ref == ref_idx]
        if len(matches) == 1:
            return matches[0]
        xs = sorted((a[2][0], b[2][0], c[2][0]))
        ys = sorted((a[2][1], b[2][1], c[2][1]))
        return xs[1], ys[1]

    def _pskip_mv(self):
        """P_Skip motion (spec 8.4.1.1)."""
        gx, gy = self.mbx * 4, self.mby * 4
        avail_a, ref_a, mv_a = self._mv_neighbor(gx - 1, gy)
        avail_b, ref_b, mv_b = self._mv_neighbor(gx, gy - 1)
        if not avail_a or not avail_b or \
                (ref_a == 0 and mv_a == (0, 0)) or \
                (ref_b == 0 and mv_b == (0, 0)):
            return (0, 0)
        return self._mvp(0, 0, 16, 16, 0, 0)

    def _set_motion(self, mv, mvd=(0, 0), ref_idx: int = 0) -> None:
        gx, gy = self.mbx * 4, self.mby * 4
        self.mv[gy:gy + 4, gx:gx + 4] = mv
        self.ref[gy:gy + 4, gx:gx + 4] = ref_idx
        self.mvd[gy:gy + 4, gx:gx + 4] = mvd

    # ------------------------------------------------- inter residual

    def _recon_inter(self, mv, levels_none, ref_idx: int = 0) -> None:
        """MC-only reconstruction (P_Skip)."""
        pred_y, pred_cb, pred_cr = self._inter_pred(mv, ref_idx)
        x0, y0 = self.mbx * 16, self.mby * 16
        self.planes[0][y0:y0 + 16, x0:x0 + 16] = pred_y
        if not self.mono:
            self.planes[1][y0 // 2:y0 // 2 + 8,
                           x0 // 2:x0 // 2 + 8] = pred_cb
            self.planes[2][y0 // 2:y0 // 2 + 8,
                           x0 // 2:x0 // 2 + 8] = pred_cr

    def _inter_pred(self, mv, ref_idx: int = 0):
        ref = self.ref_planes[ref_idx]
        x0, y0 = self.mbx * 16, self.mby * 16
        pred_y = _mc_luma(ref[0], x0, y0, 16, 16, mv[0], mv[1])
        if self.mono:
            return pred_y, None, None
        pred_cb = _mc_chroma(ref[1], x0 // 2, y0 // 2, 8, 8, mv[0], mv[1])
        pred_cr = _mc_chroma(ref[2], x0 // 2, y0 // 2, 8, 8, mv[0], mv[1])
        return pred_y, pred_cb, pred_cr

    def _decode_inter_residual(self, mv, ref_idx: int) -> None:
        """CBP + transform residual over a whole-MB MC prediction."""
        pred_y, pred_cb, pred_cr = self._inter_pred(mv, ref_idx)
        self._decode_inter_residual_pred(pred_y, pred_cb, pred_cr, True)

    def _decode_inter_residual_pred(self, pred_y, pred_cb, pred_cr,
                                    tx8_allowed: bool) -> None:
        """CBP + transform residual over the assembled MC prediction
        (spec 7.3.5: cbp, transform_size_8x8_flag, qp_delta, residual)."""
        d = self.d
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        cur.cbp_luma, cur.cbp_chroma = self._decode_cbp()
        if self.pps.transform_8x8_mode and cur.cbp_luma and tx8_allowed:
            cur.tx8 = self._read_tx8_flag()
        if cur.cbp_luma or cur.cbp_chroma:
            self._decode_qp_delta()
        else:
            cur.qp = self.qp
            self.prev_qp_delta = 0
        qp = cur.qp
        Y = self.planes[0]
        x0, y0 = mbx * 16, mby * 16
        if cur.tx8:
            for k in range(4):
                bx, by = (k & 1) * 2, (k >> 1) * 2
                nz = 0
                res = 0
                if (cur.cbp_luma >> k) & 1:
                    self._blk8_pos = (bx, by)
                    coeffs = self._residual_block(T.CAT_LUMA_8X8, 64)
                    blk = np.zeros(64, np.int32)
                    blk[T.ZIGZAG_8X8] = coeffs
                    res = itrans8(dequant8(blk.reshape(8, 8), qp))
                    nz = 1 if coeffs.any() else 0
                self.cbf_luma[mby * 4 + by:mby * 4 + by + 2,
                              mbx * 4 + bx:mbx * 4 + bx + 2] = nz
                px, py = x0 + bx * 4, y0 + by * 4
                Y[py:py + 8, px:px + 8] = np.clip(
                    pred_y[by * 4:by * 4 + 8, bx * 4:bx * 4 + 8] + res,
                    0, 255)
        else:
            for k in range(16):
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                blk8 = (by // 2) * 2 + (bx // 2)
                nz = 0
                res = 0
                if (cur.cbp_luma >> blk8) & 1:
                    if self._cbf(T.CAT_LUMA_4X4, bx, by, 0):
                        coeffs = self._residual_block(T.CAT_LUMA_4X4, 16)
                        blk = np.zeros(16, np.int32)
                        blk[T.ZIGZAG_4X4] = coeffs
                        res = itrans4(dequant4(blk.reshape(4, 4), qp))
                        nz = 1 if coeffs.any() else 0
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = nz
                px, py = x0 + bx * 4, y0 + by * 4
                Y[py:py + 4, px:px + 4] = np.clip(
                    pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res,
                    0, 255)
        if not self.mono:
            self._recon_chroma(inter_pred=(pred_cb, pred_cr))

    # ------------------------------------------------------- mb syntax

    def _mb_type_inc(self) -> int:
        """ctxIdxInc for mb_type bin 0 (spec 9.3.3.1.1.3)."""
        a = self.mb_at(self.mbx - 1, self.mby)
        b = self.mb_at(self.mbx, self.mby - 1)
        return (1 if (a is not None and not a.is_nxn) else 0) + \
               (1 if (b is not None and not b.is_nxn) else 0)

    def _read_tx8_flag(self) -> bool:
        """transform_size_8x8_flag (entropy-coder specific; the CAVLC
        subclass overrides with a plain bit)."""
        return bool(self.d.decode_bin(T.CTX_TRANSFORM_8X8 +
                                      self._tx8_inc()))

    def _tx8_inc(self) -> int:
        """ctxIdxInc for transform_size_8x8_flag (spec 9.3.3.1.1.10)."""
        a = self.mb_at(self.mbx - 1, self.mby)
        b = self.mb_at(self.mbx, self.mby - 1)
        return (1 if (a is not None and a.tx8) else 0) + \
               (1 if (b is not None and b.tx8) else 0)

    def _chroma_mode_inc(self) -> int:
        a = self.mb_at(self.mbx - 1, self.mby)
        b = self.mb_at(self.mbx, self.mby - 1)
        return (1 if (a is not None and not a.is_pcm and
                      a.chroma_mode != 0) else 0) + \
               (1 if (b is not None and not b.is_pcm and
                      b.chroma_mode != 0) else 0)

    def _decode_mb(self) -> None:
        d = self.d
        cur = self.cur
        # mb_type (ctx 3 + inc; spec 9.3.3.1.1.3)
        inc = self._mb_type_inc()
        if d.decode_bin(T.CTX_MB_TYPE_I + inc) == 0:
            cur.mb_type = I_NXN
            cur.is_nxn = True
            self._decode_i_nxn()
        elif d.decode_terminate():
            cur.mb_type = I_PCM
            cur.is_pcm = True
            self._decode_pcm()
        else:
            # I_16x16 suffix
            luma_flag = d.decode_bin(T.CTX_MB_TYPE_I + 3)
            chroma = 0
            if d.decode_bin(T.CTX_MB_TYPE_I + 4):
                chroma = 1 + d.decode_bin(T.CTX_MB_TYPE_I + 5)
            mode = 2 * d.decode_bin(T.CTX_MB_TYPE_I + 6)
            mode += d.decode_bin(T.CTX_MB_TYPE_I + 7)
            cur.mb_type = 1 + mode + 4 * chroma + 12 * luma_flag
            cur.is_i16 = True
            cur.i16_mode = mode
            cur.cbp_luma = 15 if luma_flag else 0
            cur.cbp_chroma = chroma
            self._decode_i16()

    # ------------------------------------------------------------- PCM

    def _decode_pcm(self) -> None:
        d = self.d
        cur = self.cur
        # PCM samples start at the first byte the arithmetic engine has
        # not touched: every byte any consumed bit fell in — including
        # the 9-bit codIOffset lookahead — counts as used, mirroring
        # libavcodec's whole-byte window rollback (validated empirically
        # against x264 PCM streams: 53/53 macroblocks across stream
        # geometries fit byte = ceil(pos / 8); the pre-rollback formulas
        # all misplace it).
        byte = (d.pos + 7) // 8
        y0, x0 = self.mby * 16, self.mbx * 16
        n_luma = 256
        raw = d.data[byte:byte + n_luma]
        self.planes[0][y0:y0 + 16, x0:x0 + 16] = \
            np.frombuffer(raw, np.uint8).reshape(16, 16)
        byte += n_luma
        if not self.mono:
            for pl in (1, 2):
                raw = d.data[byte:byte + 64]
                self.planes[pl][y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = \
                    np.frombuffer(raw, np.uint8).reshape(8, 8)
                byte += 64
        # reinitialize the engine at the following byte (spec 9.3.1.2)
        d.pos = byte * 8
        d.range = 510
        d.offset = 0
        for _ in range(9):
            d.offset = (d.offset << 1) | d._read_bit()
        cur.qp = self.qp
        # PCM blocks count as fully coded for ctx derivation
        self.cbf_luma[self.mby * 4:self.mby * 4 + 4,
                      self.mbx * 4:self.mbx * 4 + 4] = 1
        self.cbf_luma_dc[self.mby, self.mbx] = 1
        self.cbf_chroma_dc[:, self.mby, self.mbx] = 1
        self.cbf_chroma[:, self.mby * 2:self.mby * 2 + 2,
                        self.mbx * 2:self.mbx * 2 + 2] = 1
        self.i4_modes[self.mby * 4:self.mby * 4 + 4,
                      self.mbx * 4:self.mbx * 4 + 4] = T.I4_DC

    # --------------------------------------------------------- I_NxN

    def _decode_i_nxn(self) -> None:
        d = self.d
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        if self.pps.transform_8x8_mode:
            cur.tx8 = self._read_tx8_flag()
        # intra pred modes
        n_blocks = 4 if cur.tx8 else 16
        modes = []
        for k in range(n_blocks):
            if cur.tx8:
                bx, by = (k & 1) * 2, (k >> 1) * 2
            else:
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            gx, gy = mbx * 4 + bx, mby * 4 + by
            pred = self._predict_i4_mode(gx, gy)
            if d.decode_bin(T.CTX_PREV_I4X4):
                mode = pred
            else:
                rem = d.decode_bin(T.CTX_REM_I4X4)
                rem += 2 * d.decode_bin(T.CTX_REM_I4X4)
                rem += 4 * d.decode_bin(T.CTX_REM_I4X4)
                mode = rem if rem < pred else rem + 1
            modes.append(mode)
            if cur.tx8:
                self.i4_modes[gy:gy + 2, gx:gx + 2] = mode
            else:
                self.i4_modes[gy, gx] = mode
        cur.chroma_mode = 0 if self.mono else self._decode_chroma_mode()
        # coded_block_pattern (9.3.3.1.1.4)
        cur.cbp_luma, cur.cbp_chroma = self._decode_cbp()
        if cur.cbp_luma or cur.cbp_chroma:
            self._decode_qp_delta()
        else:
            cur.qp = self.qp
            self.prev_qp_delta = 0
        self._recon_i_nxn(modes)

    def _predict_i4_mode(self, gx: int, gy: int) -> int:
        """predIntra4x4PredMode (spec 8.3.1.1): min of neighbors, DC if
        a neighbor is unavailable or not intra-NxN."""
        ma = self._i4_mode_at(gx - 1, gy)
        mb = self._i4_mode_at(gx, gy - 1)
        if ma < 0 or mb < 0:
            return T.I4_DC
        return min(ma, mb)

    def _i4_mode_at(self, gx: int, gy: int) -> int:
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4 or gy >= self.mb_h * 4:
            return -1
        nb = self.mb_at(gx // 4, gy // 4)
        if nb is None:
            return -1
        if not nb.is_nxn:
            return T.I4_DC if not nb.is_pcm else T.I4_DC
        return int(self.i4_modes[gy, gx])

    def _decode_chroma_mode(self) -> int:
        d = self.d
        if d.decode_bin(T.CTX_CHROMA_PRED + self._chroma_mode_inc()) == 0:
            return 0
        if d.decode_bin(T.CTX_CHROMA_PRED + 3) == 0:
            return 1
        return 2 + d.decode_bin(T.CTX_CHROMA_PRED + 3)

    @staticmethod
    def _cbp_luma_nb_bit(nb: Optional[MBInfo], bit: int) -> int:
        # condTermFlag = 0 if nb unavailable/PCM or bit set, else 1
        if nb is None:
            return 0
        if nb.is_pcm:
            return 0
        return 0 if (nb.cbp_luma >> bit) & 1 else 1

    def _cbp_luma_inc(self, cbp_so_far: int, bit: int) -> int:
        """ctxIdxInc for coded_block_pattern luma bin `bit` given the
        bits decoded so far (spec 9.3.3.1.1.4).
        8x8 block order: 0 TL, 1 TR, 2 BL, 3 BR."""
        a = self.mb_at(self.mbx - 1, self.mby)
        b = self.mb_at(self.mbx, self.mby - 1)
        if bit == 0:
            return self._cbp_luma_nb_bit(a, 1) + \
                2 * self._cbp_luma_nb_bit(b, 2)
        if bit == 1:
            return (0 if cbp_so_far & 1 else 1) + \
                2 * self._cbp_luma_nb_bit(b, 3)
        if bit == 2:
            return self._cbp_luma_nb_bit(a, 3) + \
                2 * (0 if cbp_so_far & 1 else 1)
        return (0 if cbp_so_far & 4 else 1) + \
            2 * (0 if cbp_so_far & 2 else 1)

    def _cbp_chroma_inc(self, stage: int) -> int:
        """ctxIdxInc for cbp chroma bin 0 (stage 0: !=0) or bin 1
        (stage 1: ==2)."""
        a = self.mb_at(self.mbx - 1, self.mby)
        b = self.mb_at(self.mbx, self.mby - 1)

        def cond(nb):
            if nb is None:
                return 0
            if nb.is_pcm:
                return 1
            if stage == 0:
                return 1 if nb.cbp_chroma != 0 else 0
            return 1 if nb.cbp_chroma == 2 else 0
        return cond(a) + 2 * cond(b)

    def _decode_cbp(self):
        d = self.d
        cbp = 0
        for bit in range(4):
            cbp |= d.decode_bin(
                T.CTX_CBP_LUMA + self._cbp_luma_inc(cbp, bit)) << bit
        chroma = 0
        if not self.mono:
            if d.decode_bin(T.CTX_CBP_CHROMA + self._cbp_chroma_inc(0)):
                chroma = 1 + d.decode_bin(
                    T.CTX_CBP_CHROMA + 4 + self._cbp_chroma_inc(1))
        return cbp, chroma

    def _decode_qp_delta(self) -> None:
        d = self.d
        inc = 1 if self.prev_qp_delta != 0 else 0
        if d.decode_bin(T.CTX_MB_QP_DELTA + inc) == 0:
            val = 0
        else:
            k = 1
            if d.decode_bin(T.CTX_MB_QP_DELTA + 2):
                k = 2
                while d.decode_bin(T.CTX_MB_QP_DELTA + 3):
                    k += 1
                    if k > 87:
                        raise HeifError.invalid_input(msg="qp_delta runaway")
            val = k
        # unsigned → signed (spec 9.3.2.7): k=2|δ| for δ<0, 2δ−1 for δ>0
        delta = (val + 1) // 2 if val % 2 else -(val // 2)
        self.prev_qp_delta = delta
        self.qp = (self.qp + delta + 52) % 52
        self.cur.qp_delta = delta
        self.cur.qp = self.qp

    # ----------------------------------------------------- residual read

    def _cbf_inc(self, cat: int, blk_x: int, blk_y: int, plane: int) -> int:
        """ctxIdxInc for coded_block_flag (spec 9.3.3.1.1.9).

        condTermFlag for an unavailable neighbor is 0 when the CURRENT
        macroblock is inter-coded and 1 when it is intra-coded."""
        mbx, mby = self.mbx, self.mby
        un = 0 if self.cur.is_inter else 1
        if cat == T.CAT_LUMA_DC:
            a = self.mb_at(mbx - 1, mby)
            b = self.mb_at(mbx, mby - 1)

            def dc_cond(nb, x, y):
                if nb is None:
                    return un
                if nb.is_pcm:
                    return 1
                if not nb.is_i16:
                    return 0  # block absent in an available MB
                return int(self.cbf_luma_dc[y, x])
            inc = dc_cond(a, mbx - 1, mby) + 2 * dc_cond(b, mbx, mby - 1)
        elif cat in (T.CAT_LUMA_AC, T.CAT_LUMA_4X4):
            gx, gy = mbx * 4 + blk_x, mby * 4 + blk_y

            def l_cond(x, y):
                if x < 0 or y < 0 or x >= self.mb_w * 4 or \
                        y >= self.mb_h * 4:
                    return un
                nb = self.mb_at(x // 4, y // 4)
                if nb is None:
                    return un
                if nb.is_pcm:
                    return 1
                return int(self.cbf_luma[y, x])
            inc = l_cond(gx - 1, gy) + 2 * l_cond(gx, gy - 1)
        elif cat == T.CAT_CHROMA_DC:
            a = self.mb_at(mbx - 1, mby)
            b = self.mb_at(mbx, mby - 1)

            def cdc_cond(nb, x, y):
                if nb is None:
                    return un
                if nb.is_pcm:
                    return 1
                return int(self.cbf_chroma_dc[plane - 1, y, x])
            inc = cdc_cond(a, mbx - 1, mby) + 2 * cdc_cond(b, mbx, mby - 1)
        else:  # CAT_CHROMA_AC
            gx, gy = mbx * 2 + blk_x, mby * 2 + blk_y

            def ca_cond(x, y):
                if x < 0 or y < 0 or x >= self.mb_w * 2 or \
                        y >= self.mb_h * 2:
                    return un
                nb = self.mb_at(x // 2, y // 2)
                if nb is None:
                    return un
                if nb.is_pcm:
                    return 1
                return int(self.cbf_chroma[plane - 1, y, x])
            inc = ca_cond(gx - 1, gy) + 2 * ca_cond(gx, gy - 1)
        return inc

    def _cbf(self, cat: int, blk_x: int, blk_y: int, plane: int) -> int:
        """Decode coded_block_flag with neighbor ctx (9.3.3.1.1.9)."""
        inc = self._cbf_inc(cat, blk_x, blk_y, plane)
        return self.d.decode_bin(T.CTX_CBF + 4 * cat + inc)

    def _residual_block(self, cat: int, max_coeff: int) -> np.ndarray:
        """residual_block_cabac (spec 7.3.5.3.3) → coefficient levels in
        scan order."""
        d = self.d
        coeffs = np.zeros(max_coeff, np.int32)
        if cat == T.CAT_LUMA_8X8:
            sig_base = T.CTX_SIG_8X8
            last_base = T.CTX_LAST_8X8
            abs_base = T.CTX_ABS_8X8
        else:
            sig_base = T.CTX_SIG + T.SIG_CAT_OFF[cat]
            last_base = T.CTX_LAST + T.SIG_CAT_OFF[cat]
            abs_base = T.CTX_ABS + T.ABS_CAT_OFF[cat]
        sig = []
        i = 0
        while i < max_coeff - 1:
            if cat == T.CAT_LUMA_8X8:
                s_inc = int(T.SIG_CTX_8X8[i])
                l_inc = int(T.LAST_CTX_8X8[i])
            elif cat == T.CAT_CHROMA_DC:
                s_inc = min(i, 2)
                l_inc = min(i, 2)
            else:
                s_inc = i
                l_inc = i
            if d.decode_bin(sig_base + s_inc):
                sig.append(i)
                if d.decode_bin(last_base + l_inc):
                    break
            i += 1
        else:
            sig.append(max_coeff - 1)
        # levels, reverse scan order
        n_eq1 = 0
        n_gt1 = 0
        for pos in reversed(sig):
            if n_gt1 != 0:
                inc0 = 0
            else:
                inc0 = min(4, 1 + n_eq1)
            if d.decode_bin(abs_base + inc0) == 0:
                level = 1
                n_eq1 += 1
            else:
                cap = 4 - (1 if cat == T.CAT_CHROMA_DC else 0)
                inc = 5 + min(cap, n_gt1)
                v = 1
                while v < 14 and d.decode_bin(abs_base + inc):
                    v += 1
                if v == 14:
                    v += d.decode_eg_bypass(0)
                level = 1 + v
                n_gt1 += 1
            if d.decode_bypass():
                level = -level
            coeffs[pos] = level
        return coeffs

    # -------------------------------------------------- reconstruction

    def _luma_border(self, x0: int, y0: int, w: int):
        """(top[w], left[h=w], topleft, have flags) from recon plane;
        None when unavailable. Availability by decode order within the
        slice (frame-raster MBs, z-order 4x4 blocks)."""
        Y = self.planes[0]
        fw, fh = self.mb_w * 16, self.mb_h * 16
        have_top = y0 > 0 and self._sample_decoded(x0, y0 - 1)
        have_left = x0 > 0 and self._sample_decoded(x0 - 1, y0)
        have_tl = x0 > 0 and y0 > 0 and self._sample_decoded(x0 - 1, y0 - 1)
        top = Y[y0 - 1, x0:x0 + w].astype(np.int64) if have_top else None
        left = Y[y0:y0 + w, x0 - 1].astype(np.int64) if have_left else None
        tl = int(Y[y0 - 1, x0 - 1]) if have_tl else None
        # top-right, w extra samples
        tr = None
        if have_top:
            tr = np.empty(w, np.int64)
            for i in range(w):
                x = x0 + w + i
                if x < fw and self._sample_decoded(x, y0 - 1):
                    tr[i] = Y[y0 - 1, x]
                else:
                    tr[i] = tr[i - 1] if i > 0 else Y[y0 - 1, x0 + w - 1]
        return top, left, tl, tr, have_tl

    def _sample_decoded(self, x: int, y: int) -> bool:
        mbx, mby = x // 16, y // 16
        cur_idx = self.mby * self.mb_w + self.mbx
        idx = mby * self.mb_w + mbx
        if idx < self.first_mb:
            return False
        if idx < cur_idx:
            return True
        if idx > cur_idx:
            return False
        # same MB: compare 4x4 z-order decode index
        bx, by = (x % 16) // 4, (y % 16) // 4
        # caller only asks for samples strictly above/left of the block
        # being predicted; current block index is tracked in self._blk
        return int(T.BLK4_IDX[by, bx]) < self._blk

    def _recon_i_nxn(self, modes: List[int]) -> None:
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        Y = self.planes[0]
        qp = cur.qp if (cur.cbp_luma or cur.cbp_chroma) else self.qp
        cur.qp = qp
        if cur.tx8:
            for k in range(4):
                bx, by = (k & 1) * 2, (k >> 1) * 2
                self._blk = int(T.BLK4_IDX[by, bx])
                x0, y0 = mbx * 16 + bx * 4, mby * 16 + by * 4
                top, left, tl, tr, have_tl = self._luma_border(x0, y0, 8)
                _check_intra_mode(modes[k], top is not None,
                                  left is not None, have_tl)
                if top is not None:
                    top16 = np.concatenate([top, tr])
                else:
                    top16 = None
                p = pred_8x8(modes[k], top16, left,
                             tl if have_tl else None, have_tl)
                if (cur.cbp_luma >> k) & 1:
                    self._blk8_pos = (bx, by)
                    coeffs = self._residual_block(T.CAT_LUMA_8X8, 64)
                    blk = np.zeros(64, np.int32)
                    blk[T.ZIGZAG_8X8] = coeffs
                    res = itrans8(dequant8(blk.reshape(8, 8), qp))
                    nz = 1 if coeffs.any() else 0
                else:
                    res = 0
                    nz = 0
                self.cbf_luma[mby * 4 + by:mby * 4 + by + 2,
                              mbx * 4 + bx:mbx * 4 + bx + 2] = nz
                Y[y0:y0 + 8, x0:x0 + 8] = np.clip(p + res, 0, 255)
        else:
            for k in range(16):
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                self._blk = k
                x0, y0 = mbx * 16 + bx * 4, mby * 16 + by * 4
                top, left, tl, tr, have_tl = self._luma_border(x0, y0, 4)
                _check_intra_mode(modes[k], top is not None,
                                  left is not None, have_tl)
                p = pred_4x4(modes[k], top, left,
                             tl if have_tl else None, tr)
                blk8 = (by // 2) * 2 + (bx // 2)
                nz = 0
                if (cur.cbp_luma >> blk8) & 1:
                    if self._cbf(T.CAT_LUMA_4X4, bx, by, 0):
                        coeffs = self._residual_block(T.CAT_LUMA_4X4, 16)
                        blk = np.zeros(16, np.int32)
                        blk[T.ZIGZAG_4X4] = coeffs
                        res = itrans4(dequant4(blk.reshape(4, 4), qp))
                        nz = 1 if coeffs.any() else 0
                    else:
                        res = 0
                else:
                    res = 0
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = nz
                Y[y0:y0 + 4, x0:x0 + 4] = np.clip(p + res, 0, 255)
        if not self.mono:
            self._recon_chroma()

    def _recon_i16(self) -> None:
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        Y = self.planes[0]
        x0, y0 = mbx * 16, mby * 16
        self._blk = 0
        top, left, tl, _, have_tl = self._luma_border(x0, y0, 16)
        # i16: VERT needs top, HOR left, PLANE all (DC degrades)
        if (cur.i16_mode == T.I16_VERT and top is None) or \
                (cur.i16_mode == T.I16_HOR and left is None) or \
                (cur.i16_mode == T.I16_PLANE and
                 (top is None or left is None or not have_tl)):
            raise HeifError.invalid_input(
                msg="intra mode requires unavailable neighbor samples")
        p = pred_16x16(cur.i16_mode, top, left, tl if have_tl else None)
        qp = cur.qp
        # DC block
        dc_sig = self._cbf(T.CAT_LUMA_DC, 0, 0, 0)
        self.cbf_luma_dc[mby, mbx] = dc_sig
        dc = np.zeros(16, np.int32)
        if dc_sig:
            dc[T.ZIGZAG_4X4] = self._residual_block(T.CAT_LUMA_DC, 16)
        f = ihadamard4(dc.reshape(4, 4))
        if qp >= 36:
            dcs = (f * int(T.LEVEL_SCALE_4[qp % 6, 0, 0])) << (qp // 6 - 6)
        else:
            dcs = (f * int(T.LEVEL_SCALE_4[qp % 6, 0, 0]) +
                   (1 << (5 - qp // 6))) >> (6 - qp // 6)
        res = np.zeros((16, 16), np.int64)
        for k in range(16):
            bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            blk = np.zeros(16, np.int32)
            nz = 0
            if cur.cbp_luma:
                if self._cbf(T.CAT_LUMA_AC, bx, by, 0):
                    ac = self._residual_block(T.CAT_LUMA_AC, 15)
                    blk[T.ZIGZAG_4X4[1:]] = ac
                    nz = 1 if ac.any() else 0
            self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = nz
            d4 = dequant4(blk.reshape(4, 4), qp)
            d4[0, 0] = dcs[by, bx]
            res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = itrans4(d4)
        Y[y0:y0 + 16, x0:x0 + 16] = np.clip(p + res, 0, 255)
        if not self.mono:
            self._recon_chroma()

    def _decode_i16(self) -> None:
        cur = self.cur
        cur.chroma_mode = 0 if self.mono else self._decode_chroma_mode()
        self._decode_qp_delta()
        self._recon_i16()

    def _chroma_border(self, pl: int, x0: int, y0: int):
        C = self.planes[pl]
        have_top = y0 > 0 and self._mb_nb_decoded(0, -1)
        have_left = x0 > 0 and self._mb_nb_decoded(-1, 0)
        have_tl = x0 > 0 and y0 > 0 and self._mb_nb_decoded(-1, -1)
        top = C[y0 - 1, x0:x0 + 8].astype(np.int64) if have_top else None
        left = C[y0:y0 + 8, x0 - 1].astype(np.int64) if have_left else None
        tl = int(C[y0 - 1, x0 - 1]) if have_tl else None
        return top, left, tl

    def _mb_nb_decoded(self, dx: int, dy: int) -> bool:
        mbx, mby = self.mbx + dx, self.mby + dy
        if mbx < 0 or mby < 0 or mbx >= self.mb_w or mby >= self.mb_h:
            return False
        idx = mby * self.mb_w + mbx
        return self.first_mb <= idx < self.mby * self.mb_w + self.mbx

    def _recon_chroma(self, inter_pred=None) -> None:
        """Chroma residual + recon. Bitstream order (spec 7.3.5.3):
        ChromaDC for Cb then Cr, then ChromaAC Cb blocks, then Cr.
        inter_pred: (pred_cb, pred_cr) MC planes for inter MBs (skips
        the intra chroma prediction)."""
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        qp_y = cur.qp
        qpc = []
        dcs_per_plane = []
        for pl in (1, 2):
            off = self.pps.chroma_qp_offset(pl - 1)
            q = int(T.CHROMA_QP[clip3(0, 51, qp_y + off)])
            qpc.append(q)
            dc = np.zeros(4, np.int32)
            dc_nz = 0
            if cur.cbp_chroma:
                if self._cbf(T.CAT_CHROMA_DC, 0, 0, pl):
                    dc = self._residual_block(T.CAT_CHROMA_DC, 4)
                    dc_nz = 1 if dc.any() else 0
            self.cbf_chroma_dc[pl - 1, mby, mbx] = dc_nz
            c = dc.reshape(2, 2).astype(np.int64)
            f = np.array([[c[0, 0] + c[0, 1] + c[1, 0] + c[1, 1],
                           c[0, 0] - c[0, 1] + c[1, 0] - c[1, 1]],
                          [c[0, 0] + c[0, 1] - c[1, 0] - c[1, 1],
                           c[0, 0] - c[0, 1] - c[1, 0] + c[1, 1]]],
                         np.int64)
            dcs_per_plane.append(
                ((f * int(T.LEVEL_SCALE_4[q % 6, 0, 0])) << (q // 6)) >> 5)
        for pl in (1, 2):
            q = qpc[pl - 1]
            dcs = dcs_per_plane[pl - 1]
            x0, y0 = mbx * 8, mby * 8
            if inter_pred is not None:
                p = inter_pred[pl - 1]
            else:
                top, left, tl = self._chroma_border(pl, x0, y0)
                # chroma: HOR needs left, VERT top, PLANE all
                if (cur.chroma_mode == T.C_HOR and left is None) or \
                        (cur.chroma_mode == T.C_VERT and top is None) or \
                        (cur.chroma_mode == T.C_PLANE and
                         (top is None or left is None or tl is None)):
                    raise HeifError.invalid_input(
                        msg="intra mode requires unavailable neighbors")
                p = pred_chroma(cur.chroma_mode, top, left, tl)
            res = np.zeros((8, 8), np.int64)
            for k in range(4):
                bx, by = k & 1, k >> 1
                blk = np.zeros(16, np.int32)
                nz = 0
                if cur.cbp_chroma == 2:
                    if self._cbf(T.CAT_CHROMA_AC, bx, by, pl):
                        ac = self._residual_block(T.CAT_CHROMA_AC, 15)
                        blk[T.ZIGZAG_4X4[1:]] = ac
                        nz = 1 if ac.any() else 0
                self.cbf_chroma[pl - 1, mby * 2 + by, mbx * 2 + bx] = nz
                d4 = dequant4(blk.reshape(4, 4), q)
                d4[0, 0] = dcs[by, bx]
                res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = itrans4(d4)
            self.planes[pl][y0:y0 + 8, x0:x0 + 8] = np.clip(p + res, 0, 255)
