"""HEVC reconstruction on the host for the encoders: dequant, inverse
transforms, intra prediction, and the motion compensation of the inter
encoder's search, and the numpy engine's intra decode.

Counterpart of libheif_tpu/codecs/hevc/recon.py without its inter
decode (``dequant`` :21, ``inverse_transform`` :39, the MC helpers
``_gather`` :78, ``mc_luma_14`` :86, ``mc_chroma_14`` :113,
``weight_uni`` :140, ``weight_bi`` :148, ``mc_luma`` :156, ``mc_chroma``
:162, and ``IntraReconstructor`` :168 with ``_gather_refs``,
``_filter_refs``, ``_predict``, ``_recon_tu`` and ``run`` over the TUs of
an intra picture).  Spec: scaling §8.6.3, transforms
§8.6.4, intra prediction §8.4.4.2, fractional sample interpolation
§8.5.3.3.3, weighted sample prediction §8.5.3.3.4.  The intra part is
the still encoder's closed-loop reconstruction (encoder.py): it predicts
each block from the samples a decoder will hold.  The MC helpers price
each candidate vector of the sequence encoder's motion search
(inter_enc.py), one small block at a time, so they stay numpy: a launch
a candidate would be a sync a candidate.  The decoders' device engine
reconstructs on the device (``hevc_inter_pred`` for MC); the "python"
engine of ``decoder.decode_intra_picture`` runs ``IntraReconstructor``,
then filters.py.
"""

from __future__ import annotations

import numpy as np

from .tables import DCT, DST4, INTRA_PRED_ANGLE, INTRA_INV_ANGLE
from .ctu import SliceSyntax, TU, INTRA_PLANAR, INTRA_DC
from .headers import effective_scaling_factors

_LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], np.int64)


def dequant(tu: TU, bit_depth: int, factors=None) -> np.ndarray:
    """(spec §8.6.3); factors = ScalingFactor matrices from
    headers.effective_scaling_factors, None → flat m=16."""
    log2 = tu.log2
    bd_shift = bit_depth + log2 - 5
    qp = tu.qp
    scale = int(_LEVEL_SCALE[qp % 6]) << (qp // 6)
    c = tu.coeffs.astype(np.int64)
    if factors is None:
        m = 16
    else:
        size_id = log2 - 2
        mid = tu.c_idx + (3 if tu.pred_mode < 0 else 0)
        m = factors[size_id][mid].astype(np.int64)
    d = (c * m * scale + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767)


def inverse_transform(tu: TU, d: np.ndarray, bit_depth: int) -> np.ndarray:
    """(spec §8.6.4): two-stage integer inverse transform with
    intermediate clipping; 4x4 intra luma uses DST-VII."""
    n = 1 << tu.log2
    if tu.tqb:
        return tu.coeffs.astype(np.int32)
    if tu.transform_skip:
        # §8.6.4.2: bdShift for transform skip (8-bit): r = (d*16 + 16) >> 5?
        # v1: rotation off; tsShift = 5 + log2 (=7 for 4x4);
        # r[x][y] = (d[x][y] << tsShift + offset) >> bdShift2
        ts_shift = 5 + tu.log2
        bd_shift2 = 20 - bit_depth
        r = (d.astype(np.int64) << ts_shift)
        return ((r + (1 << (bd_shift2 - 1))) >> bd_shift2).astype(np.int32)

    use_dst = (tu.c_idx == 0 and n == 4)
    m = DST4 if use_dst else DCT[n]
    # stage 1 (columns): e = Clip(-2^15, 2^15-1, (M^T @ d + 64) >> 7)
    e = (m.T @ d.astype(np.int64) + 64) >> 7
    e = np.clip(e, -32768, 32767)
    # stage 2 (rows): r = (e @ M + 2^(shift-1)) >> shift, shift = 20 - bd
    shift2 = 20 - bit_depth
    r = (e @ m + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


# HEVC inter interpolation filters (spec 8.5.4.2.2.1/2.2.2)
_QFILT = {
    1: (-1, 4, -10, 58, 17, -5, 1, 0),
    2: (-1, 4, -11, 40, 40, -11, 4, -1),
    3: (0, 1, -5, 17, 58, -10, 4, -1),
}
_CFILT = {
    1: (-2, 58, 10, -2), 2: (-4, 54, 16, -2), 3: (-6, 46, 28, -4),
    4: (-4, 36, 36, -4), 5: (-4, 28, 46, -6), 6: (-2, 16, 54, -4),
    7: (-2, 10, 58, -2),
}


def _gather(ref: np.ndarray, y0: int, x0: int, h: int, w: int) -> np.ndarray:
    """Edge-replicated block fetch (HEVC conceptual infinite padding)."""
    rh, rw = ref.shape
    ys = np.clip(np.arange(y0, y0 + h), 0, rh - 1)
    xs = np.clip(np.arange(x0, x0 + w), 0, rw - 1)
    return ref[np.ix_(ys, xs)].astype(np.int64)


def mc_luma_14(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
               mvx: int, mvy: int, bd: int) -> np.ndarray:
    """Luma fractional-sample interpolation (spec 8.5.4.2.2.1) at the
    14-bit intermediate precision, before weighted sample prediction."""
    xi, yi = x0 + (mvx >> 2), y0 + (mvy >> 2)
    fx, fy = mvx & 3, mvy & 3
    shift1 = bd - 8
    shift3 = 14 - bd
    if fx == 0 and fy == 0:
        val = _gather(ref, yi, xi, h, w) << shift3
    elif fy == 0:
        b = _gather(ref, yi, xi - 3, h, w + 7)
        t = _QFILT[fx]
        val = sum(t[i] * b[:, i:i + w] for i in range(8)) >> shift1
    elif fx == 0:
        b = _gather(ref, yi - 3, xi, h + 7, w)
        t = _QFILT[fy]
        val = sum(t[i] * b[i:i + h, :] for i in range(8)) >> shift1
    else:
        b = _gather(ref, yi - 3, xi - 3, h + 7, w + 7)
        t = _QFILT[fx]
        tmp = sum(t[i] * b[:, i:i + w] for i in range(8)) >> shift1
        t = _QFILT[fy]
        val = sum(t[i] * tmp[i:i + h, :] for i in range(8)) >> 6
    return val


def mc_chroma_14(ref: np.ndarray, xc: int, yc: int, w: int, h: int,
                 mvx: int, mvy: int, bd: int) -> np.ndarray:
    """Chroma eighth-pel interpolation (spec 8.5.4.2.2.2) at the 14-bit
    intermediate precision; coords/dims in chroma samples."""
    xi, yi = xc + (mvx >> 3), yc + (mvy >> 3)
    fx, fy = mvx & 7, mvy & 7
    shift1 = bd - 8
    shift3 = 14 - bd
    if fx == 0 and fy == 0:
        val = _gather(ref, yi, xi, h, w) << shift3
    elif fy == 0:
        b = _gather(ref, yi, xi - 1, h, w + 3)
        t = _CFILT[fx]
        val = sum(t[i] * b[:, i:i + w] for i in range(4)) >> shift1
    elif fx == 0:
        b = _gather(ref, yi - 1, xi, h + 3, w)
        t = _CFILT[fy]
        val = sum(t[i] * b[i:i + h, :] for i in range(4)) >> shift1
    else:
        b = _gather(ref, yi - 1, xi - 1, h + 3, w + 3)
        t = _CFILT[fx]
        tmp = sum(t[i] * b[:, i:i + w] for i in range(4)) >> shift1
        t = _CFILT[fy]
        val = sum(t[i] * tmp[i:i + h, :] for i in range(4)) >> 6
    return val


def weight_uni(val: np.ndarray, bd: int) -> np.ndarray:
    """Default uni-directional weighted sample prediction
    (spec 8.5.4.3.2, predFlag one list)."""
    sh = 14 - bd
    return np.clip((val + (1 << (sh - 1))) >> sh, 0,
                   (1 << bd) - 1).astype(np.int32)


def weight_bi(a: np.ndarray, b: np.ndarray, bd: int) -> np.ndarray:
    """Default bi-directional weighted sample prediction
    (spec 8.5.4.3.2: (predL0 + predL1 + offset2) >> shift2)."""
    sh = 15 - bd
    return np.clip((a + b + (1 << (sh - 1))) >> sh, 0,
                   (1 << bd) - 1).astype(np.int32)


def mc_luma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
            mvx: int, mvy: int, bd: int) -> np.ndarray:
    """Uni-directional luma MC incl. default weighting; clipped int32."""
    return weight_uni(mc_luma_14(ref, x0, y0, w, h, mvx, mvy, bd), bd)


def mc_chroma(ref: np.ndarray, xc: int, yc: int, w: int, h: int,
              mvx: int, mvy: int, bd: int) -> np.ndarray:
    """Uni-directional chroma MC incl. default weighting."""
    return weight_uni(mc_chroma_14(ref, xc, yc, w, h, mvx, mvy, bd), bd)


class IntraReconstructor:
    """TU-order intra reconstruction of one picture into ``planes``, with
    z-order availability (``avail``, 4x4 luma granularity)."""

    def __init__(self, syntax: SliceSyntax):
        self.syn = syntax
        sps = syntax.sps
        self.scaling = effective_scaling_factors(sps, syntax.pps)
        self.bd = sps.bit_depth_luma
        self.w = sps.pic_width
        self.h = sps.pic_height
        self.cw = self.w >> 1
        self.ch = self.h >> 1
        self.planes = [
            np.zeros((self.h, self.w), np.int32),
            np.zeros((self.ch, self.cw), np.int32),
            np.zeros((self.ch, self.cw), np.int32),
        ]
        # progressive z-order availability, 4x4 luma granularity
        h4 = (self.h + 3) // 4 + 1
        w4 = (self.w + 3) // 4 + 1
        self.avail = np.zeros((h4, w4), bool)

    # ---------------------------------------------------------------- refs

    def _sample_available(self, lx: int, ly: int,
                          cur_slice: int = 0) -> bool:
        if lx < 0 or ly < 0 or lx >= self.w or ly >= self.h:
            return False
        if not self.avail[ly >> 2, lx >> 2]:
            return False
        # multi-slice: neighbors in another slice are unavailable for
        # intra prediction (spec 6.4.1)
        return int(self.syn.slice_map4[ly >> 2, lx >> 2]) == cur_slice

    def _gather_refs(self, tu: TU) -> np.ndarray:
        """Reference sample array of length 4n+1 ordered bottom-left →
        corner → top-right (spec §8.4.4.2.2 incl. substitution)."""
        n = 1 << tu.log2
        c = tu.c_idx
        shift = 1 if c else 0  # luma coords per chroma sample
        px = tu.x >> shift if c else tu.x
        py = tu.y >> shift if c else tu.y
        plane = self.planes[c]
        ph, pw = plane.shape

        coords = []
        # left column bottom→top: (px-1, py+2n-1) .. (px-1, py)
        for i in range(2 * n):
            coords.append((px - 1, py + 2 * n - 1 - i))
        coords.append((px - 1, py - 1))  # corner
        # top row left→right: (px, py-1) .. (px+2n-1, py-1)
        for i in range(2 * n):
            coords.append((px + i, py - 1))

        cur_slice = int(self.syn.slice_map4[tu.y >> 2, tu.x >> 2])
        vals = np.zeros(4 * n + 1, np.int32)
        avail = np.zeros(4 * n + 1, bool)
        for i, (sx, sy) in enumerate(coords):
            lx, ly = (sx << shift, sy << shift) if c else (sx, sy)
            if 0 <= sx < pw and 0 <= sy < ph and \
                    self._sample_available(lx, ly, cur_slice):
                vals[i] = plane[sy, sx]
                avail[i] = True

        if not avail.any():
            vals[:] = 1 << (self.bd - 1)
            return vals
        if not avail.all():
            # substitution: first sample takes the nearest following
            # available; then propagate previous values forward
            if not avail[0]:
                idx = np.argmax(avail)  # first available
                vals[0] = vals[idx]
                avail[0] = True
            for i in range(1, 4 * n + 1):
                if not avail[i]:
                    vals[i] = vals[i - 1]
        return vals

    def _filter_refs(self, tu: TU, ref: np.ndarray) -> np.ndarray:
        """(spec §8.4.4.2.3) luma reference smoothing."""
        n = 1 << tu.log2
        mode = tu.pred_mode
        if tu.c_idx != 0 or n == 4 or mode == INTRA_DC:
            return ref
        # min distance to horizontal/vertical modes
        dist = min(abs(mode - 26), abs(mode - 10))
        thresh = {8: 7, 16: 1, 32: 0}[n]
        if mode != INTRA_PLANAR and dist <= thresh:
            return ref
        bd = self.bd
        corner = 2 * n
        if n == 32 and self.syn.sps.strong_intra_smoothing:
            flat_top = abs(int(ref[corner]) + int(ref[4 * n]) -
                           2 * int(ref[corner + n])) < (1 << (bd - 5))
            flat_left = abs(int(ref[corner]) + int(ref[0]) -
                            2 * int(ref[n])) < (1 << (bd - 5))
            if flat_top and flat_left:
                out = ref.copy()
                # bilinear interpolation along each edge
                for i in range(1, 2 * n):
                    out[corner + i] = ((2 * n - i) * int(ref[corner]) +
                                       i * int(ref[4 * n]) + n) >> (tu.log2 + 1)
                    out[corner - i] = ((2 * n - i) * int(ref[corner]) +
                                      i * int(ref[0]) + n) >> (tu.log2 + 1)
                return out
        # [1 2 1] smoothing
        out = ref.copy()
        out[1:-1] = (ref[:-2].astype(np.int32) + 2 * ref[1:-1] +
                     ref[2:] + 2) >> 2
        out[0] = ref[0]
        out[-1] = ref[-1]
        return out

    # ------------------------------------------------------------ predict

    def _predict(self, tu: TU) -> np.ndarray:
        n = 1 << tu.log2
        ref = self._gather_refs(tu)
        ref = self._filter_refs(tu, ref)
        corner = 2 * n
        left = ref[corner - 1::-1]      # left[0] = (x0-1, y0) … length 2n
        top = ref[corner + 1:]          # top[0] = (x0, y0-1) … length 2n
        cval = int(ref[corner])
        mode = tu.pred_mode

        if mode == INTRA_PLANAR:
            x = np.arange(n)
            y = np.arange(n)[:, None]
            tr = int(top[n])
            bl = int(left[n])
            pred = ((n - 1 - x) * left[:n][y] + (x + 1) * tr +
                    (n - 1 - y) * top[:n][None, :] + (y + 1) * bl + n) \
                >> (tu.log2 + 1)
            return pred.astype(np.int32)

        if mode == INTRA_DC:
            dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (tu.log2 + 1)
            pred = np.full((n, n), dc, np.int32)
            if tu.c_idx == 0 and n < 32:
                pred[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
                pred[0, 1:] = (top[1:n].astype(np.int32) + 3 * dc + 2) >> 2
                pred[1:, 0] = (left[1:n].astype(np.int32) + 3 * dc + 2) >> 2
            return pred

        angle = INTRA_PRED_ANGLE[mode]
        maxv = (1 << self.bd) - 1
        vertical = mode >= 18
        # main reference = top for vertical modes, left for horizontal;
        # the other edge supplies the negative-index extension
        main_src = top if vertical else left
        side_src = left if vertical else top

        # build ref[] indexed lo..2n with offset (spec 8.4.4.2.6)
        lo = min(0, (n * angle) >> 5) if angle < 0 else 0
        off = -lo
        ref = np.zeros(off + 2 * n + 1, np.int32)
        ref[off] = cval
        ref[off + 1:] = main_src
        if angle < 0:
            inv = INTRA_INV_ANGLE[angle]
            for x in range(-1, lo - 1, -1):
                idx = (x * inv + 128) >> 8  # ≥ 0
                ref[off + x] = cval if idx == 0 else \
                    side_src[min(idx - 1, 2 * n - 1)]

        k = np.arange(1, n + 1)          # distance from the edge
        i_idx = (k * angle) >> 5
        i_fact = (k * angle) & 31
        pos = np.arange(n)
        predT = np.zeros((n, n), np.int32)   # rows = distance, cols = pos
        hi = len(ref) - 1
        for d_i in range(n):
            base = off + int(i_idx[d_i]) + 1
            f = int(i_fact[d_i])
            idx0 = np.minimum(pos + base, hi)
            if f == 0:
                predT[d_i] = ref[idx0]
            else:
                idx1 = np.minimum(pos + base + 1, hi)
                predT[d_i] = ((32 - f) * ref[idx0] + f * ref[idx1] + 16) >> 5

        pred = predT if vertical else predT.T
        if angle == 0 and tu.c_idx == 0 and n < 32:
            # pure vertical/horizontal edge filter (spec 8.4.4.2.6)
            if vertical:  # mode 26
                col = top[0] + ((left[:n].astype(np.int32) - cval) >> 1)
                pred[:, 0] = np.clip(col, 0, maxv)
            else:         # mode 10
                row = left[0] + ((top[:n].astype(np.int32) - cval) >> 1)
                pred[0, :] = np.clip(row, 0, maxv)
        return pred

    # ------------------------------------------------------------- recon

    def _recon_tu(self, tu: TU, maxv: int) -> None:
        """One intra TU: predict, add the residual, clip."""
        n = 1 << tu.log2
        c = tu.c_idx
        shift = 1 if c else 0
        px, py = (tu.x >> shift, tu.y >> shift) if c else (tu.x, tu.y)
        plane = self.planes[c]
        ph, pw = plane.shape
        h = min(n, ph - py)
        w = min(n, pw - px)
        pred = self._predict(tu)
        if tu.coeffs is not None:
            if tu.tqb:
                res = tu.coeffs.astype(np.int32)
            else:
                d = dequant(tu, self.bd, self.scaling)
                res = inverse_transform(tu, d, self.bd)
            pred = pred + res
        plane[py:py + h, px:px + w] = np.clip(pred[:h, :w], 0, maxv)
        if c == 0:
            # luma TU marks z-order availability
            self.avail[tu.y >> 2:(tu.y + n) >> 2,
                       tu.x >> 2:(tu.x + n) >> 2] = True

    def run(self):
        """Every TU of the picture in decode order → the (Y, Cb, Cr)
        int32 planes before the in-loop filters."""
        maxv = (1 << self.bd) - 1
        for tu in self.syn.tus:
            self._recon_tu(tu, maxv)
        return tuple(self.planes)
