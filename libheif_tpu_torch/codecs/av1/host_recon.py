"""AV1 host reconstruction: the encoder's closed loop and the decoder's
"host" engine.

The AV1 encoder (encoder.py) walks the decoder's tile parse with a
scripted entropy coder, and plans each block's symbols from the samples a
decoder will hold, so each transform block is reconstructed on the host
as soon as it is parsed.  The decoder's "host" engine replays a parsed
frame's jobs here in order (``TileDecoder.run_jobs``).  The port's
device engine reconstructs on the device, and these functions are kept
apart from its recon.py, itx.py and tile.py; here they are, copied from
the JAX package:

* ``predict_filter_intra`` (libheif_tpu/codecs/av1/recon.py:54),
  ``predict_intra`` (:110), the edge helpers ``_filter_edge`` and
  ``_upsample_edge`` (:384, :407) and ``iwht4`` (:509), spec §7.11.2,
  §7.13.3;
* ``inv_txfm2d`` (itx.py:503), over the port's 1-D transforms (itx.py);
* ``inv_transform``, ``ibc_copy`` and ``run_job`` (tile.py:1798,
  :1826, :1871, the methods ``_inv_transform``, ``_ibc_copy`` and
  ``_run_job`` of its ``TileDecoder``, which the JAX encoder calls
  through ``eager_recon``).
"""

from __future__ import annotations

import math

import numpy as np

from . import tables as T
from .cdf import _load
from .itx import _INV_SQRT2, _SHIFTS, _TX1D, _round2, _txfm1d
from .recon import (_EDGE_KERNELS, _edge_filter_strength, _pred_tables,
                    _use_upsample)

_FI_TAPS = None


def predict_filter_intra(plane: np.ndarray, x: int, y: int, w: int,
                         h: int, fi_mode: int, have_above: bool,
                         have_left: bool, bit_depth: int) -> np.ndarray:
    """Recursive filter-intra prediction (spec §7.11.2.3, aom
    filter_intra_predictor): 4-wide × 2-tall patches, 7-tap int8
    filters over (above-left, 4×above, 2×left) neighbors."""
    global _FI_TAPS
    if _FI_TAPS is None:
        _FI_TAPS = _load()["filter_intra_taps"].astype(np.int64)
    taps = _FI_TAPS[fi_mode]
    base = 1 << (bit_depth - 1)
    maxv = (1 << bit_depth) - 1
    buf = np.zeros((h + 1, w + 1), np.int64)
    # top row incl. corner, left column — standard edge rules
    if have_above:
        src = plane[y - 1, x:x + w].astype(np.int64)
        if len(src) < w:
            src = np.concatenate([src, np.full(w - len(src), src[-1],
                                               np.int64)])
        buf[0, 1:] = src
    else:
        buf[0, 1:] = (int(plane[y, x - 1]) if have_left else base - 1)
    if have_left:
        src = plane[y:y + h, x - 1].astype(np.int64)
        if len(src) < h:
            src = np.concatenate([src, np.full(h - len(src), src[-1],
                                               np.int64)])
        buf[1:, 0] = src
    else:
        buf[1:, 0] = int(buf[0, 1]) if have_above else base + 1
    if have_above and have_left:
        buf[0, 0] = int(plane[y - 1, x - 1])
    elif have_above:
        buf[0, 0] = int(buf[0, 1])
    elif have_left:
        buf[0, 0] = int(buf[1, 0])
    else:
        buf[0, 0] = base

    for r in range(1, h + 1, 2):
        for c in range(1, w + 1, 4):
            p = np.array([buf[r - 1, c - 1], buf[r - 1, c],
                          buf[r - 1, c + 1], buf[r - 1, c + 2],
                          buf[r - 1, c + 3], buf[r, c - 1],
                          buf[r + 1, c - 1], 0], np.int64)
            for k in range(8):
                ro, co = k >> 2, k & 3
                v = int(np.dot(taps[k], p))
                # ROUND_POWER_OF_TWO_SIGNED(v, 4)
                v = (v + 8) >> 4 if v >= 0 else -((-v + 8) >> 4)
                buf[r + ro, c + co] = min(max(v, 0), maxv)
    return buf[1:, 1:].copy()


def predict_intra(plane: np.ndarray, x: int, y: int, w: int, h: int,
                  mode: int, angle_delta: int, have_above: bool,
                  have_left: bool, n_top_right: int, n_bottom_left: int,
                  bit_depth: int = 8,
                  enable_edge_filter: bool = True,
                  filter_type: int = 0) -> np.ndarray:
    """Predict a (h, w) block at (x, y) from `plane` recon samples.

    n_top_right / n_bottom_left: number of valid extension samples
    beyond the block corner (0 if unavailable). Spec §7.11.2.
    """
    maxv = (1 << bit_depth) - 1
    base = 1 << (bit_depth - 1)
    sm_w, dr = _pred_tables()

    is_dir = mode in T.MODE_TO_ANGLE
    p_angle = (T.MODE_TO_ANGLE[mode] + angle_delta * 3) if is_dir else 0

    need_left = mode != T.V_PRED and (not is_dir or p_angle > 90)
    need_above = mode != T.H_PRED and (not is_dir or p_angle < 180)
    need_above_left = is_dir and 90 < p_angle < 180 or \
        mode in (T.PAETH_PRED,)

    # ---- gather reference arrays (aboveRow[-1..w+h], leftCol[-1..w+h])
    above = np.zeros(w + h + 16, np.int64)
    left = np.zeros(w + h + 16, np.int64)
    if have_above:
        src = plane[y - 1, x:x + w].astype(np.int64)
        if len(src) < w:           # tx crosses the padded right edge:
            src = np.concatenate(  # replicate last available sample
                [src, np.full(w - len(src), src[-1], np.int64)])
        above[:w] = src
        # copied top-right extension caps at the tx width (aom
        # build_intra_predictors: AOMMIN(txwpx, xr)); rest replicates
        ntr = min(n_top_right, w)
        if ntr > 0:
            ext = plane[y - 1, x + w:x + w + ntr].astype(np.int64)
            above[w:w + len(ext)] = ext
            above[w + len(ext):] = ext[-1] if len(ext) else src[-1]
        else:
            above[w:] = src[-1]
    else:
        fill = plane[y:y + h, x - 1][0] if have_left else base + 1
        above[:] = int(fill) if have_left else base - 1
    if have_left:
        src = plane[y:y + h, x - 1].astype(np.int64)
        if len(src) < h:           # tx crosses the padded bottom edge
            src = np.concatenate(
                [src, np.full(h - len(src), src[-1], np.int64)])
        left[:h] = src
        # copied bottom-left extension caps at the tx height (aom:
        # AOMMIN(txhpx, yd)); rest replicates
        nbl = min(n_bottom_left, h)
        if nbl > 0:
            ext = plane[y + h:y + h + nbl, x - 1].astype(np.int64)
            left[h:h + len(ext)] = ext
            left[h + len(ext):] = ext[-1] if len(ext) else src[-1]
        else:
            left[h:] = src[-1]
    else:
        left[:] = int(above[0]) if have_above else base + 1
    if have_above and have_left:
        corner = int(plane[y - 1, x - 1])
    elif have_above:
        corner = int(above[0])
    elif have_left:
        corner = int(left[0])
    else:
        corner = base

    # ---- non-directional modes
    if mode == T.DC_PRED:
        if have_above and have_left:
            s = int(above[:w].sum() + left[:h].sum())
            dc = (s + ((w + h) >> 1)) // (w + h)
        elif have_above:
            dc = _round2(int(above[:w].sum()), int(math.log2(w)))
        elif have_left:
            dc = _round2(int(left[:h].sum()), int(math.log2(h)))
        else:
            dc = base
        return np.full((h, w), dc, np.int64)
    if mode == T.PAETH_PRED:
        t = above[:w][None, :]
        l = left[:h][:, None]
        tl = corner
        pbase = t + l - tl
        pl = np.abs(pbase - l)
        pt = np.abs(pbase - t)
        ptl = np.abs(pbase - tl)
        out = np.where((pl <= pt) & (pl <= ptl), np.broadcast_to(l, (h, w)),
                       np.where(pt <= ptl, np.broadcast_to(t, (h, w)), tl))
        return out.astype(np.int64)
    if mode in (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED):
        wv = sm_w[h]
        wh = sm_w[w]
        below = int(left[h - 1])
        right = int(above[w - 1])
        t = above[:w][None, :]
        l = left[:h][:, None]
        if mode == T.SMOOTH_PRED:
            sv = wv[:, None] * t + (256 - wv[:, None]) * below
            sh = wh[None, :] * l + (256 - wh[None, :]) * right
            return _round2(sv + sh, 9).astype(np.int64)
        if mode == T.SMOOTH_V_PRED:
            sv = wv[:, None] * t + (256 - wv[:, None]) * below
            return _round2(sv, 8).astype(np.int64)
        sh = wh[None, :] * l + (256 - wh[None, :]) * right
        return _round2(sh, 8).astype(np.int64)

    # ---- directional (spec §7.11.2.4 + edge filter §7.11.2.7-9)
    # assemble edge buffers with index 0 = corner
    above_row = np.zeros(1 + w + h + 8, np.int64)
    left_col = np.zeros(1 + w + h + 8, np.int64)
    above_row[0] = corner
    above_row[1:1 + w + h + 7] = above[:w + h + 7]
    left_col[0] = corner
    left_col[1:1 + w + h + 7] = left[:h + w + 7]
    upsample_above = upsample_left = 0
    if enable_edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and (w + h) >= 24:
                # corner filter (spec 7.11.2.9 step: filter corner)
                s = _round2(5 * int(above_row[1]) + 6 * corner +
                            5 * int(left_col[1]), 4)
                above_row[0] = left_col[0] = s
            filt = filter_type
            if have_above:
                strength = _edge_filter_strength(
                    w, h, p_angle - 90, filt)
                num = w + (h if p_angle < 90 else 0) + 1
                _filter_edge(above_row, num, strength)
            if have_left:
                strength = _edge_filter_strength(
                    w, h, p_angle - 180, filt)
                num = h + (w if p_angle > 180 else 0) + 1
                _filter_edge(left_col, num, strength)
        upsample_above = _use_upsample(w, h, p_angle - 90, filter_type) \
            if have_above else 0
        upsample_left = _use_upsample(w, h, p_angle - 180, filter_type) \
            if have_left else 0
        if upsample_above:
            above_row = _upsample_edge(above_row,
                                       w + (h if p_angle < 90 else 0),
                                       bit_depth)
        if upsample_left:
            left_col = _upsample_edge(left_col,
                                      h + (w if p_angle > 180 else 0),
                                      bit_depth)

    dx = int(dr[p_angle]) if 0 < p_angle < 90 else \
        int(dr[180 - p_angle]) if 90 < p_angle < 180 else 0
    dy = int(dr[p_angle - 90]) if 90 < p_angle < 180 else \
        int(dr[270 - p_angle]) if 180 < p_angle < 270 else 0

    # sample accessors: after upsampling the buffer index offset is 2
    # (spec AboveRow[-2..]) instead of 1 (AboveRow[-1..])
    a_off = 2 if upsample_above else 1
    l_off = 2 if upsample_left else 1

    out = np.zeros((h, w), np.int64)
    if p_angle < 90:
        upa = upsample_above
        maxbase = (w + h - 1) << upa
        for i in range(h):
            idx = (i + 1) * dx
            for j in range(w):
                b = ((idx >> (6 - upa)) + (j << upa))
                shift = ((idx << upa) >> 1) & 0x1F
                if b < maxbase:
                    v = above_row[a_off + b] * (32 - shift) + \
                        above_row[a_off + b + 1] * shift
                    out[i, j] = _round2(int(v), 5)
                else:
                    out[i, j] = above_row[a_off + maxbase]
    elif p_angle == 90:
        out[:] = above_row[a_off:a_off + w][None, :]
    elif p_angle < 180:
        upa, upl = upsample_above, upsample_left
        for i in range(h):
            for j in range(w):
                idx = (j << 6) - (i + 1) * dx
                b = idx >> (6 - upa)
                if b >= -(1 << upa):
                    shift = ((idx << upa) >> 1) & 0x1F
                    v = above_row[a_off + b] * (32 - shift) + \
                        above_row[a_off + b + 1] * shift
                    out[i, j] = _round2(int(v), 5)
                else:
                    idx2 = (i << 6) - (j + 1) * dy
                    b2 = idx2 >> (6 - upl)
                    shift2 = ((idx2 << upl) >> 1) & 0x1F
                    v = left_col[l_off + b2] * (32 - shift2) + \
                        left_col[l_off + b2 + 1] * shift2
                    out[i, j] = _round2(int(v), 5)
    elif p_angle == 180:
        out[:] = left_col[l_off:l_off + h][:, None]
    else:
        upl = upsample_left
        maxbase = (w + h - 1) << upl
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                b = ((idx >> (6 - upl)) + (i << upl))
                shift = ((idx << upl) >> 1) & 0x1F
                if b < maxbase:
                    v = left_col[l_off + b] * (32 - shift) + \
                        left_col[l_off + b + 1] * shift
                    out[i, j] = _round2(int(v), 5)
                else:
                    out[i, j] = left_col[l_off + maxbase]
    return np.clip(out, 0, maxv)


def _filter_edge(buf: np.ndarray, n: int, strength: int) -> None:
    """(spec 7.11.2.8 intra_edge_filter) in place over buf[0:n]."""
    if strength == 0:
        return
    k = _EDGE_KERNELS[strength - 1]
    src = buf[:n].copy()
    for i in range(1, n):
        s = 0
        for j in range(5):
            idx = min(max(i - 2 + j, 0), n - 1)
            s += k[j] * int(src[idx])
        buf[i] = (s + 8) >> 4


def _upsample_edge(buf: np.ndarray, n: int, bit_depth: int) -> np.ndarray:
    """(spec 7.11.2.11 intra_edge_upsample): input buf[0]=corner,
    buf[1..n]=edge samples. Returns a NEW buffer whose index offset is
    2: out[2 + k] = upsampled edge position k, k ∈ [-2, 2n-2]."""
    maxv = (1 << bit_depth) - 1
    # s[k] for k = -1..n-1 (corner + n edge samples), clamp-padded
    s = np.zeros(n + 4, np.int64)          # s_arr[k + 2] = s[k]
    s[1] = buf[0]                          # corner  (k = -1)
    s[2:n + 2] = buf[1:n + 1]              # edge 0..n-1
    s[0] = s[1]                            # k = -2 pad
    s[n + 2] = s[n + 1]                    # k = n pad
    s[n + 3] = s[n + 1]
    out = np.zeros(2 + 2 * n + 8, np.int64)
    # new[2k] = s[k] (k = -1..n-1); new[2k+1] = 4-tap interp(k, k+1)
    for k in range(-1, n):
        out[2 + 2 * k] = int(s[k + 2])
        if k < n - 1:
            v = (-int(s[k + 1]) + 9 * int(s[k + 2]) +
                 9 * int(s[k + 3]) - int(s[k + 4]))
            out[2 + 2 * k + 1] = min(max(_round2(v, 4), 0), maxv)
    out[2 + 2 * (n - 1) + 1:] = out[2 + 2 * (n - 1)]
    return out


def _wht1(v: np.ndarray) -> np.ndarray:
    """1-D inverse Walsh-Hadamard butterfly over the last axis
    (element order a, c, d, b per the spec/vp9 heritage)."""
    a, c, d, b = (v[..., 0].copy(), v[..., 1].copy(),
                  v[..., 2].copy(), v[..., 3].copy())
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return np.stack([a, b, c, d], axis=-1)


def iwht4(block: np.ndarray) -> np.ndarray:
    """Inverse 4x4 Walsh-Hadamard for lossless (spec 7.13.3):
    input scaled down by 4, rows pass then columns pass."""
    x = block.astype(np.int64) >> 2
    x = _wht1(x)            # rows
    x = _wht1(x.T).T        # columns
    return x


def _round_shift_list(vals, shift):
    # shift stored negative (right-shift amount)
    n = -shift
    return [_round2(v, n) for v in vals]


def inv_txfm2d(coeffs: np.ndarray, tx_w: int, tx_h: int,
               tx_type: int) -> np.ndarray:
    """Full 2-D inverse transform of a dequantized coefficient block.

    coeffs: (min(tx_h,32), min(tx_w,32)) int array (AV1 codes at most
    32x32 coefficients). Returns the (tx_h, tx_w) residual. Matches
    aom inv_txfm2d_add semantics: rect ×1/√2 pre-scale for 2:1 aspect,
    row pass, round-shift, column pass, round-shift, flips on output.
    """
    vk, hk, ud_flip, lr_flip = _TX1D[tx_type]
    sh_row, sh_col = _SHIFTS[(tx_w, tx_h)]
    cw, ch = coeffs.shape[1], coeffs.shape[0]
    buf = np.zeros((tx_h, tx_w), np.int64)
    buf[:ch, :cw] = coeffs

    rect2 = abs(tx_w.bit_length() - tx_h.bit_length()) == 1
    if rect2:
        buf = _round2(buf * _INV_SQRT2, 12)

    # row pass: horizontal transform over each row, batched over rows
    cols = [buf[:, i] for i in range(tx_w)]           # each (tx_h,)
    rows_out = _txfm1d(hk, tx_w)(cols)
    rows_out = _round_shift_list(rows_out, sh_row)
    mid = np.stack(rows_out, axis=1)                  # (tx_h, tx_w)
    if lr_flip:
        mid = mid[:, ::-1]

    # column pass: vertical transform over each column, batched
    rows = [mid[i, :] for i in range(tx_h)]           # each (tx_w,)
    cols_out = _txfm1d(vk, tx_h)(rows)
    cols_out = _round_shift_list(cols_out, sh_col)
    out = np.stack(cols_out, axis=0)                  # (tx_h, tx_w)
    if ud_flip:
        out = out[::-1, :]
    return out


def inv_transform(td, plane, tx, coeffs, eob, qindex,
                  tx_type) -> np.ndarray:
    """The residual of one transform block: dequantise, then the
    inverse WHT (lossless) or the 2-D inverse transform."""
    fh = td.fh
    q = fh.quant
    if plane == 0:
        dc_d, ac_d = q.delta_q_y_dc, 0
    elif plane == 1:
        dc_d, ac_d = q.delta_q_u_dc, q.delta_q_u_ac
    else:
        dc_d, ac_d = q.delta_q_v_dc, q.delta_q_v_ac
    dc_q = int(T.dc_qlookup(td.bd)[np.clip(qindex + dc_d, 0, 255)])
    ac_q = int(T.ac_qlookup(td.bd)[np.clip(qindex + ac_d, 0, 255)])
    if fh.coded_lossless:
        d = coeffs * ac_q
        d.flat[0] = coeffs.flat[0] * dc_q
        return iwht4(d)
    # aom decodetxb dequant: |c|*q masked to 24 bits, then the
    # tx-size downscale (av1_get_tx_scale: by pixel count)
    pels = T.tx_w(tx) * T.tx_h(tx)
    shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
    qm = np.full(coeffs.shape, ac_q, np.int64)
    qm.flat[0] = dc_q
    mag = ((np.abs(coeffs) * qm) & 0xFFFFFF) >> shift
    d = np.where(coeffs < 0, -mag, mag)
    return inv_txfm2d(d, T.tx_w(tx), T.tx_h(tx), tx_type)


def ibc_copy(td, job) -> None:
    """An intrabc block's copy from the current reconstruction (spec
    7.11.4 via the BILINEAR inter filter): luma DVs are full-pel, chroma
    may land on half-sample positions."""
    plane = job.plane
    frame = td.planes[plane]
    sx = td.ssx if plane else 0
    sy = td.ssy if plane else 0
    mvr, mvc = job.ibc_mv
    # full-pel luma offsets; chroma gets the same DV at its scale
    offy, offx = mvr >> 3, mvc >> 3
    py, px = job.py, job.px
    hh, ww = job.hh, job.ww
    if plane == 0:
        frame[py:py + hh, px:px + ww] = \
            frame[py + offy:py + offy + hh, px + offx:px + offx + ww]
        return
    cy_off, cx_off = offy >> sy, offx >> sx
    fy, fx = (offy & sy), (offx & sx)      # half-sample flags
    src_y, src_x = py + cy_off, px + cx_off
    if not fy and not fx:
        frame[py:py + hh, px:px + ww] = \
            frame[src_y:src_y + hh, src_x:src_x + ww]
        return
    # BILINEAR convolve (spec 7.11.3.4, InterRound0=3, Round1=11):
    # taps 128 (full) / 64,64 (half) on the 8-bit source
    a = frame[src_y:src_y + hh + fy, src_x:src_x + ww + fx
              ].astype(np.int64)
    if fx:
        hrow = (64 * a[:, :ww] + 64 * a[:, 1:ww + 1]) >> 3
    else:
        hrow = (128 * a[:, :ww]) >> 3
    if fy:
        v = 64 * hrow[:hh, :] + 64 * hrow[1:hh + 1, :]
    else:
        v = 128 * hrow[:hh, :]
    out = (v + (1 << 10)) >> 11
    frame[py:py + hh, px:px + ww] = np.clip(out, 0, (1 << td.bd) - 1)


def run_job(td, job) -> None:
    """One TxbJob of the tile parse (tile.TileDecoder ``td``): predict,
    add the residual, write the block into ``td.planes``; an intrabc
    block's copy job copies, its residual job adds to the copy."""
    seq = td.seq
    frame = td.planes[job.plane]
    px, py, tw, th = job.px, job.py, job.tw, job.th

    if job.ibc_mv is not None:
        ibc_copy(td, job)
        return
    if job.ibc_add:
        hh, ww = job.hh, job.ww
        if job.eob > 0:
            res = inv_transform(td, job.plane, job.tx, job.coeffs,
                                job.eob, job.qindex, job.tx_type)
            region = frame[py:py + hh, px:px + ww]
            frame[py:py + hh, px:px + ww] = np.clip(
                region + res[:hh, :ww], 0, (1 << td.bd) - 1)
        return

    if job.pal_pred is not None:
        pred = job.pal_pred
    elif job.plane == 0 and job.fi_mode is not None:
        pred = predict_filter_intra(
            frame, px, py, tw, th, job.fi_mode, job.have_above,
            job.have_left, td.bd)
    else:
        pred = predict_intra(
            frame, px, py, tw, th, job.mode, job.angle,
            job.have_above, job.have_left, job.n_tr, job.n_bl,
            td.bd,
            enable_edge_filter=seq.enable_intra_edge_filter,
            filter_type=job.filt_type)
    if job.is_cfl:
        # CfL (spec §7.11.5): Q3 box-subsampled co-located luma
        # minus the txb average, scaled by the signed alpha
        alpha = job.cfl_alpha
        luma = td.planes[0]
        ly, lx = py << td.ssy, px << td.ssx
        if td.ssx and td.ssy:          # 420: 2x2 box, Q3 = sum<<1
            box = luma[ly:ly + 2 * th:2, lx:lx + 2 * tw:2] + \
                luma[ly:ly + 2 * th:2, lx + 1:lx + 2 * tw:2] + \
                luma[ly + 1:ly + 2 * th:2, lx:lx + 2 * tw:2] + \
                luma[ly + 1:ly + 2 * th:2, lx + 1:lx + 2 * tw:2]
            q3 = box.astype(np.int64) << 1
        elif td.ssx:                     # 422: 1x2 box, Q3 = sum<<2
            box = luma[ly:ly + th, lx:lx + 2 * tw:2] + \
                luma[ly:ly + th, lx + 1:lx + 2 * tw:2]
            q3 = box.astype(np.int64) << 2
        else:                              # 444: Q3 = sample<<3
            q3 = luma[ly:ly + th, lx:lx + tw].astype(np.int64) << 3
        if q3.shape != (th, tw):
            # tx extends past the decode plane: replicate the last
            # available row/col (aom cfl_pad)
            full = np.empty((th, tw), np.int64)
            bh, bw = q3.shape
            full[:bh, :bw] = q3
            if bw < tw:
                full[:bh, bw:] = full[:bh, bw - 1:bw]
            if bh < th:
                full[bh:, :] = full[bh - 1:bh, :]
            q3 = full
        # rounded average (aom subtract_average: +half before shift)
        npel_log2 = tw.bit_length() - 1 + th.bit_length() - 1
        avg = (int(q3.sum()) + (1 << (npel_log2 - 1))) >> npel_log2
        ac = q3 - avg
        scaled = alpha * ac
        adj = np.where(scaled >= 0, (scaled + 32) >> 6,
                       -((-scaled + 32) >> 6))
        pred = np.clip(pred + adj, 0, (1 << td.bd) - 1)

    hh, ww = job.hh, job.ww
    if job.eob > 0:
        res = inv_transform(td, job.plane, job.tx, job.coeffs,
                                  job.eob, job.qindex, job.tx_type)
        out = pred[:hh, :ww] + res[:hh, :ww]
        frame[py:py + hh, px:px + ww] = np.clip(out, 0,
                                                (1 << td.bd) - 1)
    else:
        frame[py:py + hh, px:px + ww] = pred[:hh, :ww]
