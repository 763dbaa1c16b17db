"""AV1 deblocking loop filter (spec §7.14), intra frames, in PyTorch.

Counterpart of libheif_tpu/codecs/av1/deblock.py.  The parse records the
transform-block edges (``EdgeMaps``); the filter decisions that depend
only on those maps (which edges, which filter length) are made on the
host, the pixel work runs on the planes' device as dense passes:
vertical edges of a whole plane, then horizontal ones on the result.

The JAX function filters the edge columns one after another.  An edge's
filter length is the smaller transform size beside it (at most 14 taps
for 16-wide transforms, 8 for 8, 4 for 4), so the samples one edge
reads never include samples another edge of the same pass writes: all
edges of a pass filter at once from the same source, which gives the
column-serial result.  Integer order as in the JAX function.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _adjust_level(base: int, delta_enabled: bool, intra_delta: int) -> int:
    """aom av1_loop_filter_frame_init intra level: no base==0 early-out."""
    if not delta_enabled:
        return base
    scale = 1 << (base >> 5)
    return int(np.clip(base + intra_delta * scale, 0, 63))


def _thresholds(lvl: int, sharpness: int):
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = int(np.clip(lvl >> shift, 1, 9 - sharpness))
    else:
        limit = max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    return blimit, limit, thresh


class EdgeMaps:
    """Per-plane tx-tile edge/size maps at 4-px plane granularity,
    filled by TileDecoder during the parse."""

    def __init__(self, planes_shapes):
        self.vert = []
        self.horz = []
        self.tw = []
        self.th = []
        for (h, w) in planes_shapes:
            gh, gw = (h + 3) // 4, (w + 3) // 4
            self.vert.append(np.zeros((gh, gw), np.uint8))
            self.horz.append(np.zeros((gh, gw), np.uint8))
            self.tw.append(np.full((gh, gw), 4, np.int32))
            self.th.append(np.full((gh, gw), 4, np.int32))

    def mark(self, plane, px, py, tw, th):
        gy, gx = py // 4, px // 4
        nh, nw = max(th // 4, 1), max(tw // 4, 1)
        self.vert[plane][gy:gy + nh, gx] = 1
        self.horz[plane][gy, gx:gx + nw] = 1
        self.tw[plane][gy:gy + nh, gx:gx + nw] = tw
        self.th[plane][gy:gy + nh, gx:gx + nw] = th


def filter_segments(seg: torch.Tensor, length: int, blimit: int, limit: int,
                    thresh: int, bd: int) -> torch.Tensor:
    """The JAX ``_filter_segment`` over (M, 14) lines with the edge between
    columns 6 and 7: returns (M, 14) with the filtered samples in place
    (the unfiltered lanes keep their values)."""
    g = lambda i: seg[:, 7 + i]     # noqa: E731
    p6, p5, p4 = g(-7), g(-6), g(-5)
    p3, p2, p1, p0 = g(-4), g(-3), g(-2), g(-1)
    q0, q1, q2, q3 = g(0), g(1), g(2), g(3)
    q4, q5, q6 = g(4), g(5), g(6)
    ab = torch.abs
    fm = (ab(p1 - p0) <= limit) & (ab(q1 - q0) <= limit) & \
        (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit)
    if length >= 6:
        fm &= (ab(p2 - p1) <= limit) & (ab(q2 - q1) <= limit)
    if length >= 8:
        fm &= (ab(p3 - p2) <= limit) & (ab(q3 - q2) <= limit)

    sh = bd - 8
    F = 1 << sh
    maxv = (1 << bd) - 1
    flat = None
    if length >= 6:
        flat = (ab(p1 - p0) <= F) & (ab(q1 - q0) <= F) & \
            (ab(p2 - p0) <= F) & (ab(q2 - q0) <= F)
        if length >= 8:
            flat &= (ab(p3 - p0) <= F) & (ab(q3 - q0) <= F)
    mid = 128 << sh
    hev = (ab(p1 - p0) > thresh) | (ab(q1 - q0) > thresh)

    def c(x):
        return torch.clamp(x, -mid, mid - 1)
    ps1, ps0 = p1 - mid, p0 - mid
    qs0, qs1 = q0 - mid, q1 - mid
    f = torch.where(hev, c(ps1 - qs1), 0)
    f = c(f + 3 * (qs0 - ps0))
    f1 = c(f + 4) >> 3
    f2 = c(f + 3) >> 3
    n_q0 = torch.clamp(c(qs0 - f1) + mid, 0, maxv)
    n_p0 = torch.clamp(c(ps0 + f2) + mid, 0, maxv)
    f3 = (f1 + 1) >> 1
    n_q1 = torch.where(hev, q1, torch.clamp(c(qs1 - f3) + mid, 0, maxv))
    n_p1 = torch.where(hev, p1, torch.clamp(c(ps1 + f3) + mid, 0, maxv))

    def r2(x):
        return (x + 4) >> 3

    def r4(x):
        return (x + 8) >> 4
    W = torch.where
    if length == 4:
        out = {-2: W(fm, n_p1, p1), -1: W(fm, n_p0, p0),
               0: W(fm, n_q0, q0), 1: W(fm, n_q1, q1)}
    elif length == 6:
        w = fm & flat
        out = {-2: W(w, r2(p2 * 3 + p1 * 2 + p0 * 2 + q0), W(fm, n_p1, p1)),
               -1: W(w, r2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1),
                     W(fm, n_p0, p0)),
               0: W(w, r2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2),
                    W(fm, n_q0, q0)),
               1: W(w, r2(q2 * 3 + q1 * 2 + q0 * 2 + p0), W(fm, n_q1, q1))}
    else:
        w8 = fm & flat
        out = {
            -3: W(w8, r2(p3 * 3 + p2 * 2 + p1 + p0 + q0), p2),
            -2: W(w8, r2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1),
                  W(fm, n_p1, p1)),
            -1: W(w8, r2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2),
                  W(fm, n_p0, p0)),
            0: W(w8, r2(q3 + q2 + q1 + q0 * 2 + p0 + p1 + p2),
                 W(fm, n_q0, q0)),
            1: W(w8, r2(q3 * 2 + q2 + q1 * 2 + q0 + p0 + p1),
                 W(fm, n_q1, q1)),
            2: W(w8, r2(q3 * 3 + q2 * 2 + q1 + q0 + p0), q2),
        }
        if length >= 14:
            flat2 = (ab(p6 - p0) <= F) & (ab(q6 - q0) <= F) & \
                (ab(p5 - p0) <= F) & (ab(q5 - q0) <= F) & \
                (ab(p4 - p0) <= F) & (ab(q4 - q0) <= F)
            w14 = w8 & flat2
            wide = {
                -6: r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0),
                -5: r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 +
                       q0 + q1),
                -4: r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 +
                       q0 + q1 + q2),
                -3: r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 +
                       q0 + q1 + q2 + q3),
                -2: r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 +
                       q0 + q1 + q2 + q3 + q4),
                -1: r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 +
                       q1 + q2 + q3 + q4 + q5),
                0: r4(q6 + q5 + q4 + q3 + q2 + q1 * 2 + q0 * 2 + p0 * 2 +
                      p1 + p2 + p3 + p4 + p5),
                1: r4(q6 * 2 + q5 + q4 + q3 + q2 * 2 + q1 * 2 + q0 * 2 +
                      p0 + p1 + p2 + p3 + p4),
                2: r4(q6 * 3 + q5 + q4 + q3 * 2 + q2 * 2 + q1 * 2 + q0 +
                      p0 + p1 + p2 + p3),
                3: r4(q6 * 4 + q5 + q4 * 2 + q3 * 2 + q2 * 2 + q1 + q0 +
                      p0 + p1 + p2),
                4: r4(q6 * 5 + q5 * 2 + q4 * 2 + q3 * 2 + q2 + q1 + q0 +
                      p0 + p1),
                5: r4(q6 * 7 + q5 * 2 + q4 * 2 + q3 + q2 + q1 + q0 + p0),
            }
            out = {k: W(w14, wide[k], out.get(k, g(k)))
                   for k in range(-6, 6)}
    res = seg.clone()
    for k, v in out.items():
        res[:, 7 + k] = v
    return res


def edge_lengths(edge: np.ndarray, tdim: np.ndarray, plane_w: int,
                 plane_h: int, edge_lim: int, row_lim: int,
                 luma: bool) -> np.ndarray:
    """(gh, gw) filter length of each 4-row segment of each edge column
    of one pass (0: not filtered), as the JAX pass decides it: columns
    gx >= 1 below the visible frame width, segments above its height."""
    gh, gw = edge.shape
    out = np.zeros((gh, gw), np.int64)
    n_gx = min((plane_w + 3) // 4, gw)
    n_gy = min(gh, (plane_h + 3) // 4)
    if n_gx <= 1 or n_gy <= 0:
        return out
    gx = np.arange(1, n_gx)
    gx = gx[gx * 4 < edge_lim]
    gy = np.arange(n_gy)
    gy = gy[gy * 4 < row_lim]
    if len(gx) == 0 or len(gy) == 0:
        return out
    sub = np.ix_(gy, gx)
    on = edge[sub] != 0
    ln_raw = np.minimum(np.minimum(tdim[sub], tdim[np.ix_(gy, gx - 1)]),
                        14 if luma else 6)
    if luma:
        ln = np.where(ln_raw >= 14, 14, np.where(
            ln_raw >= 8, 8, np.where(ln_raw >= 6, 6, 4)))
    else:
        ln = np.where(ln_raw >= 6, 6, 4)
    out[sub] = np.where(on, ln, 0)
    return out


def deblock_pass(work: torch.Tensor, lengths: np.ndarray, blimit: int,
                 limit: int, thresh: int, bd: int) -> torch.Tensor:
    """Filter every vertical edge of the (h, w) int32 plane ``work`` at
    once; ``lengths`` (gh, gw) from edge_lengths.  Returns a new plane."""
    h, w = work.shape
    dev = work.device
    out = work.reshape(-1).clone()
    src = work.reshape(-1)
    off = torch.arange(-7, 7, device=dev)
    for ln in (4, 6, 8, 14):
        gy, gx = np.nonzero(lengths == ln)
        if len(gy) == 0:
            continue
        rows = (gy[:, None] * 4 + np.arange(4)[None, :]).ravel()
        xs = np.repeat(gx * 4, 4)
        keep = rows < h
        rows_d = torch.from_numpy(rows[keep]).to(dev)
        xs_d = torch.from_numpy(xs[keep]).to(dev)
        cols = torch.clamp(xs_d[:, None] + off[None, :], 0, w - 1)
        seg = src[rows_d[:, None] * w + cols]
        res = filter_segments(seg, ln, blimit, limit, thresh, bd)
        half = {4: 2, 6: 2, 8: 3, 14: 6}[ln]
        k = torch.arange(-half, half, device=dev)
        out[rows_d[:, None] * w + xs_d[:, None] + k[None, :]] = \
            res[:, 7 + k]
    return out.view(h, w)


def apply_deblock(planes: List[torch.Tensor], maps: EdgeMaps, fh,
                  frame_w: int, frame_h: int, bd: int = 8
                  ) -> List[torch.Tensor]:
    """Deblock [Y, U, V] int32 planes (padded mi area): new planes."""
    intra_delta = fh.loop_filter_ref_deltas[0]
    delta_en = fh.loop_filter_delta_enabled
    sharp = fh.loop_filter_sharpness
    lvls = [_adjust_level(v, delta_en, intra_delta)
            for v in fh.loop_filter_levels]
    raw = fh.loop_filter_levels
    planes = list(planes)
    if raw[0] == 0 and raw[1] == 0:
        return planes       # luma both-zero: no filtering at all
    for plane in range(min(3, len(planes))):
        if plane > 0 and raw[plane + 1] == 0:
            continue        # chroma plane gated on its raw level
        buf = planes[plane]
        ph, pw = buf.shape
        ssx = 1 if pw < planes[0].shape[1] else 0
        ssy = 1 if ph < planes[0].shape[0] else 0
        fw_p = (frame_w + ssx) >> ssx
        fh_p = (frame_h + ssy) >> ssy
        for direction in (0, 1):
            lvl = lvls[direction] if plane == 0 else lvls[plane + 1]
            if lvl == 0:
                continue
            blimit, limit, thresh = _thresholds(lvl, sharp)
            blimit <<= bd - 8
            limit <<= bd - 8
            thresh <<= bd - 8
            if direction == 0:
                ln = edge_lengths(maps.vert[plane], maps.tw[plane], pw, ph,
                                  fw_p, fh_p, plane == 0)
                buf = deblock_pass(buf, ln, blimit, limit, thresh, bd)
            else:
                ln = edge_lengths(maps.horz[plane].T, maps.th[plane].T, ph,
                                  pw, fh_p, fw_p, plane == 0)
                buf = deblock_pass(buf.T.contiguous(), ln, blimit, limit,
                                   thresh, bd).T.contiguous()
        planes[plane] = buf
    return planes
