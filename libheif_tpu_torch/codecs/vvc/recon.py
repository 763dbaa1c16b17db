"""VVC intra reconstruction: dequant, inverse DCT-II, prediction + PDPC.

Spec anchors: scaling H.266 §8.7.3 (incl. the rectangular
1/sqrt2 levelScale), transforms §8.7.4, intra prediction §8.4.5.2
(reference samples §8.4.5.2.5/.7, wide-angle remapping §8.4.5.2.6,
planar/DC §8.4.5.2.10-11, angular §8.4.5.2.12, PDPC §8.4.5.2.15).
Rectangular TBs from MTT partitioning are supported; refIdx 0, 4:2:0.

Reference-correct numpy implementation; prediction for angular modes
is vectorized per row so the decoder's hot loop stays matrix-shaped.
The same functions run inside the encoder's planning pass, which is
what guarantees encoder-recon == decoder-output bit-exactness.

The port's copy of libheif_tpu/codecs/vvc/recon.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .tables import (DCT, ANGLE_TABLE, inv_angle, map_wide_angle,
                     FILTER_C, FILTER_G,
                     INTRA_HOR_VER_DIST_THRES, CHROMA_QP_TABLE,
                     INTRA_PLANAR, INTRA_DC, INTRA_HOR, INTRA_VER,
                     LEVEL_SCALE, LEVEL_SCALE_RECT)

_FC = FILTER_C.astype(np.int64)
_FG = FILTER_G.astype(np.int64)


def chroma_qp_from_luma(qp_y: int) -> int:
    """ChromaQp via the signalled (identity) table (§8.7.1)."""
    return CHROMA_QP_TABLE[max(0, min(63, qp_y))]


def dequant(coeffs: np.ndarray, log2w: int, log2h: int, qp: int,
            bit_depth: int) -> np.ndarray:
    """Scaling process (§8.7.3, flat scaling list m=16).  Rectangular
    TBs with odd log2(W*H) use the sqrt2-scaled levelScale row and one
    extra shift."""
    rect = (log2w + log2h) & 1
    bd_shift = bit_depth + ((log2w + log2h) >> 1) - 5 + rect
    ls = LEVEL_SCALE_RECT if rect else LEVEL_SCALE
    scale = ls[qp % 6] << (qp // 6)
    c = coeffs.astype(np.int64)
    d = (c * 16 * scale + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767)


def inverse_transform(d: np.ndarray, log2w: int, log2h: int,
                      bit_depth: int) -> np.ndarray:
    """Inverse DCT-II, two stages with intermediate clip (§8.7.4);
    column transform of size H then row transform of size W."""
    mh = DCT[1 << log2h]
    mw = DCT[1 << log2w]
    e = (mh.T @ d.astype(np.int64) + 64) >> 7
    e = np.clip(e, -32768, 32767)
    shift2 = 20 - bit_depth
    r = (e @ mw + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def forward_transform(block: np.ndarray, log2w: int, log2h: int,
                      bit_depth: int) -> np.ndarray:
    """Forward DCT-II matching inverse_transform's scaling (encoder)."""
    mh = DCT[1 << log2h]
    mw = DCT[1 << log2w]
    shift1 = log2h + bit_depth - 9
    if shift1 > 0:
        tmp = (mh @ block.astype(np.int64) + (1 << (shift1 - 1))) >> shift1
    else:
        tmp = (mh @ block.astype(np.int64)) << (-shift1)
    shift2 = log2w + 6
    out = (tmp @ mw.T + (1 << (shift2 - 1))) >> shift2
    return out


# --------------------------------------------------------------------------
# Intra prediction
# --------------------------------------------------------------------------

def _filter_flag(mode: int, log2w: int, log2h: int,
                 c_idx: int) -> Tuple[bool, bool]:
    """(smooth_refs, use_gauss): reference [1 2 1] smoothing for
    integer-slope modes / planar, Gaussian interpolation filter for
    fractional-slope modes beyond the distance threshold (§8.4.5.2.5).
    `mode` is the wide-angle-mapped mode."""
    if c_idx != 0:
        return False, False
    if (1 << (log2w + log2h)) <= 32:
        return False, False
    if mode == INTRA_PLANAR:
        return True, False
    if mode == INTRA_DC:
        return False, False
    if mode < 2 or mode > 66:
        # wide-angle: always beyond the distance threshold
        angle = ANGLE_TABLE[mode]
        return (True, False) if angle % 32 == 0 else (False, True)
    min_dist = min(abs(mode - INTRA_VER), abs(mode - INTRA_HOR))
    ntbs = (log2w + log2h) >> 1
    if min_dist <= INTRA_HOR_VER_DIST_THRES.get(ntbs, 0):
        return False, False
    angle = ANGLE_TABLE[mode]
    if angle % 32 == 0:
        return True, False          # integer slope: smooth refs directly
    return False, True              # fractional: smoothing via fG


def predict_intra(ref: np.ndarray, mode: int, log2w: int, log2h: int,
                  c_idx: int, bit_depth: int) -> np.ndarray:
    """Predict a (h x w) block from the 2(w+h)+1 reference array
    (ordered bottom-left -> corner -> top-right)."""
    w = 1 << log2w
    h = 1 << log2h
    corner = w + h                    # index of the (x0-1, y0-1) sample
    maxv = (1 << bit_depth) - 1

    mode = map_wide_angle(mode, log2w, log2h)
    smooth, use_gauss = _filter_flag(mode, log2w, log2h, c_idx)
    if smooth:
        out = ref.copy()
        out[1:-1] = (ref[:-2].astype(np.int64) + 2 * ref[1:-1].astype(np.int64)
                     + ref[2:] + 2) >> 2
        ref = out

    left = ref[corner - 1::-1].astype(np.int64)   # left[0] = (x0-1, y0)
    top = ref[corner + 1:].astype(np.int64)       # top[0] = (x0, y0-1)
    cval = int(ref[corner])

    if mode == INTRA_PLANAR:
        x = np.arange(w)
        y = np.arange(h)[:, None]
        tr = int(top[w])
        bl = int(left[h])
        pred_v = ((h - 1 - y) * top[:w][None, :] + (y + 1) * bl) << log2w
        pred_h = ((w - 1 - x) * left[:h][y] + (x + 1) * tr) << log2h
        pred = (pred_v + pred_h + (w * h)) >> (log2w + log2h + 1)
        return _pdpc(pred.astype(np.int64), mode, log2w, log2h, left, top,
                     maxv).astype(np.int32)

    if mode == INTRA_DC:
        if log2w == log2h:
            dc = (int(top[:w].sum()) + int(left[:h].sum()) + w) >> \
                (log2w + 1)
        elif log2w > log2h:
            dc = (int(top[:w].sum()) + (w >> 1)) >> log2w
        else:
            dc = (int(left[:h].sum()) + (h >> 1)) >> log2h
        pred = np.full((h, w), dc, np.int64)
        return _pdpc(pred, mode, log2w, log2h, left, top,
                     maxv).astype(np.int32)

    angle = ANGLE_TABLE[mode]
    vertical = mode >= 34
    main_src = top if vertical else left
    side_src = left if vertical else top
    # main-direction block extents
    mn = w if vertical else h         # samples per predicted line
    lines = h if vertical else w      # number of predicted lines
    log2mn = log2w if vertical else log2h

    # extended main reference, indices lo..(len) (0 = corner)
    lo = (lines * angle) >> 5 if angle < 0 else 0
    off = -lo
    ext = np.zeros(off + len(main_src) + 1, np.int64)
    ext[off] = cval
    ext[off + 1:] = main_src
    if angle < 0:
        inv = inv_angle(angle)               # negative for negative angles
        smax = len(side_src) - 1
        for x in range(-1, lo - 1, -1):
            idx = (x * inv + 256) >> 9       # distance along the side edge
            ext[off + x] = cval if idx <= 0 else \
                side_src[min(idx - 1, smax)]

    k = np.arange(1, lines + 1)
    i_idx = (k * angle) >> 5
    i_fact = (k * angle) & 31
    pos = np.arange(mn)
    hi = len(ext) - 1
    predT = np.zeros((lines, mn), np.int64)
    filt = _FG if use_gauss else _FC
    for d_i in range(lines):
        base = off + int(i_idx[d_i]) + 1
        f = int(i_fact[d_i])
        if c_idx == 0:
            # 4-tap interpolation over taps at base-1 .. base+2 (§8.4.5.2.12)
            taps = filt[f]
            acc = np.zeros(mn, np.int64)
            for t in range(4):
                idx = np.clip(pos + base - 1 + t, 0, hi)
                acc += taps[t] * ext[idx]
            row = np.clip((acc + 32) >> 6, 0, maxv)
        else:
            idx0 = np.clip(pos + base, 0, hi)
            if f == 0:
                row = ext[idx0]
            else:
                idx1 = np.clip(pos + base + 1, 0, hi)
                row = ((32 - f) * ext[idx0] + f * ext[idx1] + 16) >> 5
        predT[d_i] = row

    pred = predT if vertical else predT.T
    if mode in (INTRA_HOR, INTRA_VER):
        pred = _pdpc(pred, mode, log2w, log2h, left, top, maxv)
    return np.clip(pred, 0, maxv).astype(np.int32)


def _pdpc(pred: np.ndarray, mode: int, log2w: int, log2h: int,
          left: np.ndarray, top: np.ndarray, maxv: int) -> np.ndarray:
    """Position-dependent prediction combination (§8.4.5.2.15) for
    planar/DC/horizontal/vertical modes (refIdx 0)."""
    w = 1 << log2w
    h = 1 << log2h
    scale = (log2w + log2h - 2) >> 2
    x = np.arange(w)
    y = np.arange(h)[:, None]
    if mode in (INTRA_PLANAR, INTRA_DC):
        w_t = 32 >> np.minimum(31, (2 * y) >> scale)
        w_l = 32 >> np.minimum(31, (2 * x) >> scale)
        out = (w_l * left[:h][y] + w_t * top[:w][None, :] +
               (64 - w_l - w_t) * pred + 32) >> 6
    elif mode == INTRA_VER:
        w_l = 16 >> np.minimum(31, (2 * x) >> scale)
        out = (w_l * left[:h][y] + (64 - w_l) * pred + 32) >> 6
    else:  # INTRA_HOR
        w_t = 16 >> np.minimum(31, (2 * y) >> scale)
        out = (w_t * top[:w][None, :] + (64 - w_t) * pred + 32) >> 6
    return np.clip(out, 0, maxv)


# --------------------------------------------------------------------------
# Picture reconstruction
# --------------------------------------------------------------------------

class PictureRecon:
    """Incremental reconstruction surface shared by decoder and the
    encoder planning pass: planes + z-order availability."""

    def __init__(self, width: int, height: int, bit_depth: int = 8):
        self.w = width
        self.h = height
        self.bd = bit_depth
        self.cw = width >> 1
        self.ch = height >> 1
        self.planes = [np.zeros((self.h, self.w), np.int32),
                       np.zeros((self.ch, self.cw), np.int32),
                       np.zeros((self.ch, self.cw), np.int32)]
        h4 = (self.h + 3) // 4 + 1
        w4 = (self.w + 3) // 4 + 1
        self.avail = np.zeros((h4, w4), bool)

    def _sample_available(self, lx: int, ly: int) -> bool:
        if lx < 0 or ly < 0 or lx >= self.w or ly >= self.h:
            return False
        return bool(self.avail[ly >> 2, lx >> 2])

    def gather_refs(self, x: int, y: int, log2w: int, log2h: int,
                    c_idx: int) -> np.ndarray:
        """2(w+h)+1 reference array with unavailable-sample substitution
        (§8.4.5.2.7).  (x, y) are luma coords of the block."""
        w = 1 << log2w
        h = 1 << log2h
        span = w + h
        shift = 1 if c_idx else 0
        px, py = x >> shift, y >> shift
        plane = self.planes[c_idx]
        ph, pw = plane.shape

        coords = []
        for i in range(span):
            coords.append((px - 1, py + span - 1 - i))
        coords.append((px - 1, py - 1))
        for i in range(span):
            coords.append((px + i, py - 1))

        n_ref = 2 * span + 1
        vals = np.zeros(n_ref, np.int32)
        avail = np.zeros(n_ref, bool)
        for i, (sx, sy) in enumerate(coords):
            if 0 <= sx < pw and 0 <= sy < ph and \
                    self._sample_available(sx << shift, sy << shift):
                vals[i] = plane[sy, sx]
                avail[i] = True

        if not avail.any():
            vals[:] = 1 << (self.bd - 1)
            return vals
        if not avail.all():
            if not avail[0]:
                idx = int(np.argmax(avail))
                vals[0] = vals[idx]
                avail[0] = True
            for i in range(1, n_ref):
                if not avail[i]:
                    vals[i] = vals[i - 1]
        return vals

    def reconstruct_tb(self, x: int, y: int, log2w: int, log2h: int,
                       c_idx: int, mode: int,
                       coeffs: Optional[np.ndarray], qp: int,
                       mip=None, lfnst_idx: int = 0) -> None:
        """Predict + add residual + store; marks luma availability.
        mip: (mip_mode, transposed) for matrix intra prediction;
        lfnst_idx: inverse secondary transform applied before the
        inverse DCT."""
        w = 1 << log2w
        h = 1 << log2h
        ref = self.gather_refs(x, y, log2w, log2h, c_idx)
        if mip is not None:
            pred = predict_mip(ref, mip[0], bool(mip[1]), log2w, log2h,
                               self.bd)
        else:
            pred = predict_intra(ref, mode, log2w, log2h, c_idx,
                                 self.bd)
        if coeffs is not None:
            d = dequant(coeffs, log2w, log2h, qp, self.bd)
            if lfnst_idx:
                d = inverse_lfnst(d, lfnst_idx, mode, log2w, log2h)
            res = inverse_transform(d, log2w, log2h, self.bd)
            pred = pred + res
        shift = 1 if c_idx else 0
        px, py = x >> shift, y >> shift
        plane = self.planes[c_idx]
        ph, pw = plane.shape
        hh = min(h, ph - py)
        ww = min(w, pw - px)
        maxv = (1 << self.bd) - 1
        plane[py:py + hh, px:px + ww] = np.clip(pred[:hh, :ww], 0, maxv)
        if c_idx == 0:
            self.avail[y >> 2:(y + h) >> 2, x >> 2:(x + w) >> 2] = True


# --------------------------------------------------------------------------
# MIP prediction (H.266 §8.4.5.2.2 structure; tables.py provenance)
# --------------------------------------------------------------------------

def predict_mip(ref: np.ndarray, mip_mode: int, transposed: bool,
                log2w: int, log2h: int, bit_depth: int) -> np.ndarray:
    """Matrix-based intra prediction: boundary downsample, reduced
    matrix multiply, linear upsample."""
    from .tables import (mip_size_id, MIP_BOUNDARY, MIP_PRED,
                         MIP_WEIGHTS)
    w = 1 << log2w
    h = 1 << log2h
    corner = w + h
    maxv = (1 << bit_depth) - 1
    left = ref[corner - 1::-1].astype(np.int64)[:h]
    top = ref[corner + 1:].astype(np.int64)[:w]

    sid = mip_size_id(log2w, log2h)
    bdry = MIP_BOUNDARY[sid]
    pred = MIP_PRED[sid]

    def downsample(edge: np.ndarray, n: int) -> np.ndarray:
        f = len(edge) // n
        if f <= 1:
            return edge[:n].copy()
        e = edge[:n * f].reshape(n, f)
        return (e.sum(axis=1) + (f >> 1)) >> int(np.log2(f))

    red_t = downsample(top, bdry)
    red_l = downsample(left, bdry)
    b = np.concatenate([red_t, red_l])
    if transposed:
        b = np.concatenate([red_l, red_t])
    # input preparation: offsets against the first reduced sample
    p = b - b[0]
    W = MIP_WEIGHTS[(sid, mip_mode)]
    out = ((W @ p) + 32) >> 6
    out = np.clip(out + b[0], 0, maxv).reshape(pred, pred)
    if transposed:
        out = out.T

    # linear upsample to (h, w) using the original boundary as the
    # -1 row/column (spec upsampling order: horizontal then vertical)
    if pred != w or pred != h:
        up = out.astype(np.int64)
        if w != pred:
            f = w // pred
            cols = np.zeros((pred, w), np.int64)
            lcol = downsample(left, pred).astype(np.int64)
            prev = lcol[:, None]
            for i in range(pred):
                nxt = up[:, i:i + 1]
                for k in range(f):
                    wgt = k + 1
                    cols[:, i * f + k:i * f + k + 1] = \
                        ((f - wgt) * prev + wgt * nxt + (f >> 1)) // f
                prev = nxt
            up = cols
        if h != pred:
            f = h // pred
            rows = np.zeros((h, w), np.int64)
            prev = top[None, :w].astype(np.int64)
            for i in range(pred):
                nxt = up[i:i + 1, :]
                for k in range(f):
                    wgt = k + 1
                    rows[i * f + k:i * f + k + 1, :] = \
                        ((f - wgt) * prev + wgt * nxt + (f >> 1)) // f
                prev = nxt
            up = rows
        out = up
    return np.clip(out, 0, maxv).astype(np.int32)


# --------------------------------------------------------------------------
# LFNST (H.266 §8.7.4.2 structure; tables.py provenance)
# --------------------------------------------------------------------------

def _lfnst_geometry(log2w: int, log2h: int):
    """(region scan, kernel table key size) for a TB."""
    from .tables import DIAG_4x4, LFNST_48_SCAN
    small = (log2w == 2 or log2h == 2)
    if small:
        return [(x, y) for (x, y) in DIAG_4x4], 16
    return list(LFNST_48_SCAN), 48


def _lfnst_nonzero_in(log2w: int, log2h: int) -> int:
    """Number of coded input coefficients (spec nonZeroSize)."""
    if (log2w == 2 and log2h == 2) or (log2w == 3 and log2h == 3):
        return 8
    return 16


def inverse_lfnst(d: np.ndarray, lfnst_idx: int, mode: int,
                  log2w: int, log2h: int) -> np.ndarray:
    """Replace the low-frequency region of the dequantized TB with the
    inverse secondary transform of its first coefficients."""
    from .tables import LFNST_16, LFNST_48, lfnst_set_of_mode
    s, transpose = lfnst_set_of_mode(mode)
    scan, region = _lfnst_geometry(log2w, log2h)
    nz = _lfnst_nonzero_in(log2w, log2h)
    kern = (LFNST_16 if region == 16 else LFNST_48)[(s, lfnst_idx)]
    u = np.zeros(16, np.int64)
    # input: first nz coefficients along the 4x4 diagonal scan
    from .tables import DIAG_4x4
    for i in range(nz):
        x, y = DIAG_4x4[i]
        u[i] = d[y, x]
    v = (kern.T @ u + 64) >> 7          # region coefficients
    v = np.clip(v, -32768, 32767)
    out = d.astype(np.int64).copy()
    # clear the input positions then write the region
    for i in range(nz):
        x, y = DIAG_4x4[i]
        out[y, x] = 0
    if transpose:
        for i, (x, y) in enumerate(scan):
            out[x, y] = v[i] if (x < out.shape[0] and
                                 y < out.shape[1]) else 0
    else:
        for i, (x, y) in enumerate(scan):
            out[y, x] = v[i]
    return np.clip(out, -32768, 32767)


def forward_lfnst(c: np.ndarray, lfnst_idx: int, mode: int,
                  log2w: int, log2h: int) -> np.ndarray:
    """Encoder side: project the low-frequency region onto the kernel,
    zeroing everything outside the coded input positions."""
    from .tables import LFNST_16, LFNST_48, lfnst_set_of_mode, DIAG_4x4
    s, transpose = lfnst_set_of_mode(mode)
    scan, region = _lfnst_geometry(log2w, log2h)
    nz = _lfnst_nonzero_in(log2w, log2h)
    kern = (LFNST_16 if region == 16 else LFNST_48)[(s, lfnst_idx)]
    v = np.zeros(region, np.int64)
    if transpose:
        for i, (x, y) in enumerate(scan):
            v[i] = c[x, y] if (x < c.shape[0] and y < c.shape[1]) else 0
    else:
        for i, (x, y) in enumerate(scan):
            v[i] = c[y, x]
    u = (kern @ v + 64) >> 7
    out = np.zeros_like(c)
    for i in range(nz):
        x, y = DIAG_4x4[i]
        out[y, x] = np.clip(u[i], -32768, 32767)
    return out


def _reconstruct_cu_luma(self, cu, qp: int) -> None:
    """Luma reconstruction of one CU with its tools (MIP, ISP
    subpartition sequencing, LFNST)."""
    lg2w, lg2h = cu.log2w, cu.log2h
    if cu.isp_split:
        sl2w = lg2w if cu.isp_split == 1 else lg2w - 2
        sl2h = lg2h - 2 if cu.isp_split == 1 else lg2h
        for pi in range(4):
            px = cu.x + (0 if cu.isp_split == 1 else pi << sl2w)
            py = cu.y + ((pi << sl2h) if cu.isp_split == 1 else 0)
            self.reconstruct_tb(px, py, sl2w, sl2h, 0, cu.luma_mode,
                                cu.isp_coeffs[pi], qp,
                                lfnst_idx=cu.lfnst_idx)
        return
    if cu.mip_flag:
        self.reconstruct_tb(cu.x, cu.y, lg2w, lg2h, 0, cu.luma_mode,
                            cu.coeffs_y, qp,
                            mip=(cu.mip_mode, cu.mip_transposed))
        return
    self.reconstruct_tb(cu.x, cu.y, lg2w, lg2h, 0, cu.luma_mode,
                        cu.coeffs_y, qp, lfnst_idx=cu.lfnst_idx)


PictureRecon.reconstruct_cu_luma = _reconstruct_cu_luma
