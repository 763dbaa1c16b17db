"""HEVC in-loop filters of the numpy engine: deblocking (§8.7.2) and SAO
(§8.7.3), and the deblocking tables (§8.7.2.5.3, Table 8-12).

Counterpart of libheif_tpu/codecs/hevc/filters.py: ``Deblocker`` :27 and
``apply_sao`` :305 operate on the reconstructed int32 planes of an intra
picture (every CU/TU boundary on the 8x8 grid has boundary strength 2;
the port's numpy engine decodes intra stills only, so the motion rule of
``_bs`` is left out).  Where the JAX functions read the first slice's
header for the whole picture, these follow the port's device engine
(device_recon ``_build_deblock_params``, ``_build_sao_params``) and the
spec:

* an edge takes the beta/tc offsets and slice_deblocking_filter_disabled
  flag of the slice that holds q0, and an edge on a slice boundary is
  off where that slice's slice_loop_filter_across_slices_enabled_flag is
  0;
* an SAO edge-offset neighbour in another slice leaves the sample as it
  is where the later of the two slices has that flag 0;
* the samples of a transquant-bypass CU keep their values through the
  deblocking (nDp = 0, nDq = 0, §8.7.2.5.7), as through SAO.

The JAX functions filter across every slice boundary with the first
slice's offsets and deblock bypass CUs (ROADMAP §3 D); there the port is
held to libde265.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .ctu import SliceSyntax
from .tables import chroma_qp

BETA_TABLE = np.array(
    [0] * 16 + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18] +
    list(range(20, 66, 2)), np.int32)
TC_TABLE = np.array(
    [0] * 18 + [1] * 9 + [2] * 4 + [3] * 4 + [4] * 3 + [5, 5, 6, 6, 7, 8,
                                                        9, 10, 11, 13, 14,
                                                        16, 18, 20, 22, 24],
    np.int32)


def _clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


class Deblocker:
    """The deblocking filter of one intra picture, in place on its
    planes (Y, Cb, Cr)."""

    def __init__(self, syn: SliceSyntax, planes):
        self.syn = syn
        self.y, self.cb, self.cr = planes
        self.h, self.w = self.y.shape
        self.bd = syn.sps.bit_depth_luma
        heads = syn.slice_headers
        self.off = [not h.deblocking_filter_disabled for h in heads]
        self.across = [h.loop_filter_across_slices for h in heads]
        self.beta_off = [h.beta_offset_div2 * 2 for h in heads]
        self.tc_off = [h.tc_offset_div2 * 2 for h in heads]

    def _is_block_edge(self, x: int, y: int, vertical: bool) -> bool:
        """TU or CU boundary at sample (x, y) (8-grid aligned)."""
        syn = self.syn
        bx, by = x >> 2, y >> 2
        tu_l2 = int(syn.tu_log2[by, bx])
        cu_l2 = int(syn.cu_log2[by, bx])
        if tu_l2 == 0:
            tu_l2 = cu_l2 if cu_l2 else 3
        pos = x if vertical else y
        return pos % (1 << tu_l2) == 0 or \
            bool(cu_l2 and pos % (1 << cu_l2) == 0)

    def _sides(self, x: int, y: int, vertical: bool):
        """The 4x4 blocks of p0 and q0 at the edge sample (x, y)."""
        bq = (y >> 2, x >> 2)
        bp = (y >> 2, (x - 1) >> 2) if vertical else ((y - 1) >> 2, x >> 2)
        return bp, bq

    def _slice_of_q(self, x: int, y: int, vertical: bool) -> int:
        """The slice holding q0, where the edge is filtered at all (an
        edge of a CU of a slice that deblocks, not on a boundary to
        another slice closed by q0's slice), else -1."""
        if not self._is_block_edge(x, y, vertical):
            return -1
        bp, bq = self._sides(x, y, vertical)
        s = int(self.syn.slice_map4[bq])
        if not self.off[s]:
            return -1
        if int(self.syn.slice_map4[bp]) != s and not self.across[s]:
            return -1
        return s

    def _keep(self, x: int, y: int, vertical: bool):
        """(p side, q side) lie in a transquant-bypass CU."""
        bp, bq = self._sides(x, y, vertical)
        return bool(self.syn.tqb_map[bp]), bool(self.syn.tqb_map[bq])

    def _avg_qp(self, x: int, y: int, vertical: bool) -> int:
        bp, bq = self._sides(x, y, vertical)
        return (int(self.syn.qp_y[bp]) + int(self.syn.qp_y[bq]) + 1) >> 1

    def run(self) -> None:
        if not any(self.off):
            return
        self._luma_pass(vertical=True)
        self._chroma_pass(vertical=True)
        self._luma_pass(vertical=False)
        self._chroma_pass(vertical=False)

    # ---------------------------------------------------------------- luma

    def _luma_pass(self, vertical: bool) -> None:
        maxv = (1 << self.bd) - 1
        for pos in range(8, self.w if vertical else self.h, 8):
            for seg in range(0, self.h if vertical else self.w, 4):
                x, y = (pos, seg) if vertical else (seg, pos)
                s = self._slice_of_q(x, y, vertical)
                if s >= 0:
                    self._filter_luma_segment(x, y, vertical, maxv, s)

    def _get_lines(self, x, y, vertical, count=4):
        """(count, 8) array: each row is [p3 p2 p1 p0 q0 q1 q2 q3]."""
        if vertical:
            return self.y[y:y + count, x - 4:x + 4].astype(np.int32)
        return self.y[y - 4:y + 4, x:x + count].T.astype(np.int32)

    def _put_lines(self, x, y, vertical, lines):
        if vertical:
            self.y[y:y + lines.shape[0], x - 4:x + 4] = lines
        else:
            self.y[y - 4:y + 4, x:x + lines.shape[0]] = lines.T

    def _filter_luma_segment(self, x, y, vertical, maxv, s) -> None:
        n_lines = min(4, (self.h - y) if vertical else (self.w - x))
        if n_lines < 4:
            return      # partial bottom edge segments (pic multiple of 8)
        if (vertical and (x < 4 or x > self.w - 4)) or \
                (not vertical and (y < 4 or y > self.h - 4)):
            return
        bs = 2
        lines = self._get_lines(x, y, vertical, n_lines)
        qp = self._avg_qp(x, y, vertical)
        b_idx = int(_clip3(0, 51, qp + self.beta_off[s]))
        # β/tc scale with bit depth (spec 8.7.2.5.3)
        beta = int(BETA_TABLE[b_idx]) << (self.bd - 8)
        tc_idx = int(_clip3(0, 53, qp + 2 * (bs - 1) + self.tc_off[s]))
        tc = int(TC_TABLE[tc_idx]) << (self.bd - 8)
        if beta == 0 and tc == 0:
            return
        p = lines[:, 3::-1]     # p0..p3
        q = lines[:, 4:]        # q0..q3

        dp0 = abs(int(p[0, 2]) - 2 * int(p[0, 1]) + int(p[0, 0]))
        dp3 = abs(int(p[3, 2]) - 2 * int(p[3, 1]) + int(p[3, 0]))
        dq0 = abs(int(q[0, 2]) - 2 * int(q[0, 1]) + int(q[0, 0]))
        dq3 = abs(int(q[3, 2]) - 2 * int(q[3, 1]) + int(q[3, 0]))
        dpq0, dpq3 = dp0 + dq0, dp3 + dq3
        d = dpq0 + dpq3
        if d >= beta:
            return

        def strong_line(i):
            return (2 * (dpq0 if i == 0 else dpq3) < (beta >> 2) and
                    abs(int(p[i, 3]) - int(p[i, 0])) +
                    abs(int(q[i, 0]) - int(q[i, 3])) < (beta >> 3) and
                    abs(int(p[i, 0]) - int(q[i, 0])) < ((5 * tc + 1) >> 1))

        strong = strong_line(0) and strong_line(3)
        out = lines.copy()
        if strong:
            for i in range(4):
                p0, p1, p2, p3 = (int(p[i, 0]), int(p[i, 1]),
                                  int(p[i, 2]), int(p[i, 3]))
                q0, q1, q2, q3 = (int(q[i, 0]), int(q[i, 1]),
                                  int(q[i, 2]), int(q[i, 3]))
                c2 = 2 * tc
                np0 = _clip3(p0 - c2, p0 + c2,
                             (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
                np1 = _clip3(p1 - c2, p1 + c2, (p2 + p1 + p0 + q0 + 2) >> 2)
                np2 = _clip3(p2 - c2, p2 + c2,
                             (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
                nq0 = _clip3(q0 - c2, q0 + c2,
                             (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
                nq1 = _clip3(q1 - c2, q1 + c2, (p0 + q0 + q1 + q2 + 2) >> 2)
                nq2 = _clip3(q2 - c2, q2 + c2,
                             (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)
                out[i, 1:4] = [np2, np1, np0]
                out[i, 4:7] = [nq0, nq1, nq2]
        else:
            d_ep = 1 if dp0 + dp3 < ((beta + (beta >> 1)) >> 3) else 0
            d_eq = 1 if dq0 + dq3 < ((beta + (beta >> 1)) >> 3) else 0
            for i in range(4):
                p0, p1, p2 = int(p[i, 0]), int(p[i, 1]), int(p[i, 2])
                q0, q1, q2 = int(q[i, 0]), int(q[i, 1]), int(q[i, 2])
                delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
                if abs(delta) >= tc * 10:
                    continue
                delta = int(_clip3(-tc, tc, delta))
                out[i, 3] = _clip3(0, maxv, p0 + delta)
                out[i, 4] = _clip3(0, maxv, q0 - delta)
                if d_ep:
                    dp = int(_clip3(-(tc >> 1), tc >> 1,
                                    (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1))
                    out[i, 2] = _clip3(0, maxv, p1 + dp)
                if d_eq:
                    dq = int(_clip3(-(tc >> 1), tc >> 1,
                                    (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1))
                    out[i, 5] = _clip3(0, maxv, q1 + dq)
        out = np.clip(out, 0, maxv)
        keep_p, keep_q = self._keep(x, y, vertical)
        if keep_p:
            out[:, :4] = lines[:, :4]
        if keep_q:
            out[:, 4:] = lines[:, 4:]
        self._put_lines(x, y, vertical, out)

    # --------------------------------------------------------------- chroma

    def _chroma_pass(self, vertical: bool) -> None:
        for c_idx, plane in ((1, self.cb), (2, self.cr)):
            ch, cw = plane.shape
            maxv = (1 << self.syn.sps.bit_depth_chroma) - 1
            off = (self.syn.pps.cb_qp_offset if c_idx == 1
                   else self.syn.pps.cr_qp_offset)
            # chroma edges: every 8 chroma samples (16 luma)
            for pos in range(8, cw if vertical else ch, 8):
                for seg in range(0, ch if vertical else cw, 4):
                    x, y = (pos, seg) if vertical else (seg, pos)
                    lx, ly = x << 1, y << 1
                    s = self._slice_of_q(lx, ly, vertical)
                    if s < 0:
                        continue
                    n = min(4, (ch - y) if vertical else (cw - x))
                    if n <= 0:
                        continue
                    qp_l = self._avg_qp(lx, ly, vertical)
                    qpc = chroma_qp(int(_clip3(0, 57, qp_l + off)))
                    tc_idx = int(_clip3(0, 53, qpc + 2 + self.tc_off[s]))
                    tc = int(TC_TABLE[tc_idx]) << \
                        (self.syn.sps.bit_depth_chroma - 8)
                    if tc == 0:
                        continue
                    if vertical:
                        seg_arr = plane[y:y + n, x - 2:x + 2].astype(np.int32)
                    else:
                        seg_arr = plane[y - 2:y + 2, x:x + n].T.astype(
                            np.int32)
                    p1, p0 = seg_arr[:, 0], seg_arr[:, 1]
                    q0, q1 = seg_arr[:, 2], seg_arr[:, 3]
                    delta = _clip3(-tc, tc,
                                   (((q0 - p0) * 4) + p1 - q1 + 4) >> 3)
                    keep_p, keep_q = self._keep(lx, ly, vertical)
                    if not keep_p:
                        seg_arr[:, 1] = np.clip(p0 + delta, 0, maxv)
                    if not keep_q:
                        seg_arr[:, 2] = np.clip(q0 - delta, 0, maxv)
                    if vertical:
                        plane[y:y + n, x - 2:x + 2] = seg_arr
                    else:
                        plane[y - 2:y + 2, x:x + n] = seg_arr.T


def _closed(syn: SliceSyntax, shift: int, ys, xs, dy: int, dx: int):
    """Per sample of the (ys, xs) index grids of a plane subsampled by
    ``shift``: its neighbour at (dy, dx) lies in another slice and the
    later of the two slices does not filter across its boundaries."""
    sl4 = syn.slice_map4
    across = np.asarray([h.loop_filter_across_slices
                         for h in syn.slice_headers], bool)
    s = 2 - shift
    cur = sl4[ys >> s, xs >> s].astype(np.int64)
    nb = sl4[(ys + dy) >> s, (xs + dx) >> s].astype(np.int64)
    return (cur != nb) & ~across[np.maximum(cur, nb)]


def apply_sao(syn: SliceSyntax, planes) -> Tuple[np.ndarray, ...]:
    """(spec §8.7.3) — input is the deblocked picture; output computed
    from the unmodified input."""
    if not syn.sao:
        return planes
    sps = syn.sps
    bd = sps.bit_depth_luma
    maxv = (1 << bd) - 1
    ctb = sps.ctb_size
    multi = any(not h.loop_filter_across_slices
                for h in syn.slice_headers[1:])
    outs = []
    # edge-offset neighbor vectors per eo_class
    eo_d = {0: ((-1, 0), (1, 0)), 1: ((0, -1), (0, 1)),
            2: ((-1, -1), (1, 1)), 3: ((1, -1), (-1, 1))}

    for c_idx, plane in enumerate(planes):
        src = plane
        out = src.copy()
        shift = 0 if c_idx == 0 else 1
        ph, pw = src.shape
        for (cx, cy), sao in syn.sao.items():
            t = sao.type_idx[c_idx]
            if t == 0:
                continue
            x0 = (cx * ctb) >> shift
            y0 = (cy * ctb) >> shift
            x1 = min(x0 + (ctb >> shift), pw)
            y1 = min(y0 + (ctb >> shift), ph)
            if x0 >= x1 or y0 >= y1:
                continue
            region = src[y0:y1, x0:x1].astype(np.int32)
            if t == 1:  # band offset
                bands = region >> (bd - 5)
                res = region.copy()
                for k in range(4):
                    band = (sao.band_pos[c_idx] + k) & 31
                    res = np.where(bands == band,
                                   region + sao.offsets[c_idx][k], res)
                out[y0:y1, x0:x1] = np.clip(res, 0, maxv)
            else:       # edge offset
                eo = sao.eo_class[0 if c_idx == 0 else 1]
                (dx0, dy0), (dx1, dy1) = eo_d[eo]
                res = region.copy()
                # valid interior where both neighbors exist in the pic
                ys0, ys1 = max(y0, 0 - min(dy0, dy1)), min(
                    y1, ph - max(dy0, dy1, 0))
                gx0 = max(x0, -min(dx0, dx1))
                gx1 = min(x1, pw - max(dx0, dx1, 0))
                if gx0 >= gx1 or ys0 >= ys1:
                    continue
                cur = src[ys0:ys1, gx0:gx1].astype(np.int32)
                n1 = src[ys0 + dy0:ys1 + dy0,
                         gx0 + dx0:gx1 + dx0].astype(np.int32)
                n2 = src[ys0 + dy1:ys1 + dy1,
                         gx0 + dx1:gx1 + dx1].astype(np.int32)
                edge_idx = 2 + np.sign(cur - n1) + np.sign(cur - n2)
                sub = cur.copy()
                offs = sao.offsets[c_idx]
                for ei, k in ((0, 0), (1, 1), (3, 2), (4, 3)):
                    sub = np.where(edge_idx == ei, cur + offs[k], sub)
                if multi:
                    ys, xs = np.mgrid[ys0:ys1, gx0:gx1]
                    cut = _closed(syn, shift, ys, xs, dy0, dx0) | \
                        _closed(syn, shift, ys, xs, dy1, dx1)
                    sub = np.where(cut, cur, sub)
                res[ys0 - y0:ys1 - y0, gx0 - x0:gx1 - x0] = sub
                out[y0:y1, x0:x1] = np.clip(res, 0, maxv)
        # transquant-bypass samples pass through (spec 8.7.3)
        if syn.tqb_map.any():
            ys, xs = np.nonzero(syn.tqb_map)
            for by, bx in zip(ys, xs):
                yy0 = (by * 4) >> shift
                xx0 = (bx * 4) >> shift
                step = 4 >> shift
                out[yy0:yy0 + step, xx0:xx0 + step] = \
                    src[yy0:yy0 + step, xx0:xx0 + step]
        outs.append(out)
    return tuple(outs)
