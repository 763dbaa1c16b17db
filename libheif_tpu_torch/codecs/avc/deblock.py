"""H.264 in-loop deblocking filter (Rec. H.264 §8.7).

A copy of libheif_tpu/codecs/avc/deblock.py, unchanged but for this line.

Host reference implementation in vectorized numpy: per-MB edge
processing in spec order (all vertical edges left→right, then all
horizontal edges top→bottom, MBs in raster order), 16 luma / 8 chroma
lines filtered at once per edge with a per-4-sample-segment boundary
strength:

  bS 4 — macroblock edge with an intra MB on either side
  bS 3 — internal edge of an intra MB
  bS 2 — either adjacent 4x4 block has residual coefficients
  bS 1 — different reference pictures or an MV component differing by
          >= 4 quarter-pel units (inter P)
  bS 0 — no filtering

Replaces the deblocking the reference obtains inside its codec plugins
(reference: libheif/plugins/decoder_openh264.cc boundary).
"""

from __future__ import annotations

import numpy as np

from . import tables as T
from .mb import clip3


def _filter_luma_edge(P, Q, qp_avg, bs, alpha_off, beta_off):
    """Filter one luma edge. P: (n,4) samples p3..p0, Q: (n,4) q0..q3,
    bs: (n,) per-row boundary strength (spec 8.7.2.3/8.7.2.4)."""
    idx_a = clip3(0, 51, qp_avg + alpha_off)
    idx_b = clip3(0, 51, qp_avg + beta_off)
    alpha = int(T.DEBLOCK_ALPHA[idx_a])
    beta = int(T.DEBLOCK_BETA[idx_b])
    if alpha == 0 or beta == 0 or not bs.any():
        return P, Q
    p3, p2, p1, p0 = (P[:, i].astype(np.int64) for i in range(4))
    q0, q1, q2, q3 = (Q[:, i].astype(np.int64) for i in range(4))
    fs = (bs > 0) & (np.abs(p0 - q0) < alpha) & \
         (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta
    # strong path (bS 4)
    s_rows = fs & (bs == 4)
    strong = s_rows & (np.abs(p0 - q0) < ((alpha >> 2) + 2))
    sp = strong & ap
    sq = strong & aq
    p0s = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                   np.where(s_rows, (2 * p1 + p0 + q1 + 2) >> 2, p0))
    p1s = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2s = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0s = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                   np.where(s_rows, (2 * q1 + q0 + p1 + 2) >> 2, q0))
    q1s = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2s = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    # normal path (bS 1..3)
    n_rows = fs & (bs < 4)
    tc0 = T.DEBLOCK_TC0[idx_a, np.clip(bs, 1, 3) - 1].astype(np.int64)
    tc = tc0 + ap.astype(np.int64) + aq.astype(np.int64)
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = np.where(n_rows, np.clip(p0 + delta, 0, 255), p0)
    q0n = np.where(n_rows, np.clip(q0 - delta, 0, 255), q0)
    dp1 = np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1, -tc0, tc0)
    dq1 = np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1, -tc0, tc0)
    p1n = np.where(n_rows & ap, p1 + dp1, p1)
    q1n = np.where(n_rows & aq, q1 + dq1, q1)
    # merge paths
    p0f = np.where(bs == 4, p0s, p0n)
    p1f = np.where(bs == 4, p1s, p1n)
    p2f = np.where(bs == 4, p2s, p2)
    q0f = np.where(bs == 4, q0s, q0n)
    q1f = np.where(bs == 4, q1s, q1n)
    q2f = np.where(bs == 4, q2s, q2)
    Pn = np.stack([p3, p2f, p1f, p0f], axis=1)
    Qn = np.stack([q0f, q1f, q2f, q3], axis=1)
    return Pn, Qn


def _filter_chroma_edge(P, Q, qp_avg, bs, alpha_off, beta_off):
    """Filter one chroma edge. P: (n,2) p1,p0; Q: (n,2) q0,q1;
    bs: (n,) per-row strengths from the co-located luma edge."""
    idx_a = clip3(0, 51, qp_avg + alpha_off)
    idx_b = clip3(0, 51, qp_avg + beta_off)
    alpha = int(T.DEBLOCK_ALPHA[idx_a])
    beta = int(T.DEBLOCK_BETA[idx_b])
    if alpha == 0 or beta == 0 or not bs.any():
        return P, Q
    p1, p0 = P[:, 0].astype(np.int64), P[:, 1].astype(np.int64)
    q0, q1 = Q[:, 0].astype(np.int64), Q[:, 1].astype(np.int64)
    fs = (bs > 0) & (np.abs(p0 - q0) < alpha) & \
         (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    s_rows = fs & (bs == 4)
    p0s = np.where(s_rows, (2 * p1 + p0 + q1 + 2) >> 2, p0)
    q0s = np.where(s_rows, (2 * q1 + q0 + p1 + 2) >> 2, q0)
    n_rows = fs & (bs < 4)
    tc = T.DEBLOCK_TC0[idx_a, np.clip(bs, 1, 3) - 1].astype(np.int64) + 1
    delta = np.clip(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = np.where(n_rows, np.clip(p0 + delta, 0, 255), p0)
    q0n = np.where(n_rows, np.clip(q0 - delta, 0, 255), q0)
    p0f = np.where(bs == 4, p0s, p0n)
    q0f = np.where(bs == 4, q0s, q0n)
    return np.stack([p1, p0f], axis=1), np.stack([q0f, q0 * 0 + q1], axis=1)


def _chroma_qp(pps, qp, plane):
    return int(T.CHROMA_QP[clip3(0, 51, qp + pps.chroma_qp_offset(plane))])


def _block_bs(dec, cur, nb, px, py, qx, qy, mb_edge: bool) -> int:
    """bS between the 4x4 luma blocks at p(px,py) / q(qx,qy)
    (4x4-grid coordinates; spec 8.7.2.1)."""
    p_intra = nb is not None and not nb.is_inter
    q_intra = not cur.is_inter
    if p_intra or q_intra:
        return 4 if mb_edge else 3
    if dec.cbf_luma[py, px] or dec.cbf_luma[qy, qx]:
        return 2
    if dec.ref[py, px] != dec.ref[qy, qx]:
        return 1
    if abs(int(dec.mv[py, px, 0]) - int(dec.mv[qy, qx, 0])) >= 4 or \
            abs(int(dec.mv[py, px, 1]) - int(dec.mv[qy, qx, 1])) >= 4:
        return 1
    return 0


def _edge_bs(dec, cur, nb, x: int, y0: int, vertical: bool) -> np.ndarray:
    """Per-row (16,) luma bs array for one edge."""
    bs = np.zeros(16, np.int64)
    for g in range(4):
        if vertical:
            qx, qy = x // 4, (y0 + 4 * g) // 4
            px, py = (x - 1) // 4, qy
        else:
            qx, qy = (x + 4 * g) // 4, y0 // 4
            px, py = qx, (y0 - 1) // 4
        mb_edge = (x % 16 == 0) if vertical else (y0 % 16 == 0)
        bs[4 * g:4 * g + 4] = _block_bs(dec, cur, nb, px, py, qx, qy,
                                        mb_edge)
    return bs


def deblock_frame(dec) -> None:
    """Apply the deblocking filter in place over dec.planes using the
    per-MB state in dec.mb (spec 8.7 process order)."""
    hdr = getattr(dec, "last_hdr", None)
    a_off = hdr.slice_alpha_c0_offset if hdr else 0
    b_off = hdr.slice_beta_offset if hdr else 0
    Y = dec.planes[0]
    mono = len(dec.planes) == 1
    mb_w, mb_h = dec.mb_w, dec.mb_h
    for mby in range(mb_h):
        for mbx in range(mb_w):
            cur = dec.mb[mby * mb_w + mbx]
            if cur is None:
                continue
            x0, y0 = mbx * 16, mby * 16
            # ---- vertical edges (filter columns), left to right
            v_edges = [0] if mbx > 0 else []
            v_edges += [8] if cur.tx8 else [4, 8, 12]
            for dx in v_edges:
                if dx == 0:
                    nb = dec.mb[mby * mb_w + mbx - 1]
                    if nb is None:
                        continue
                    qp_avg = (nb.qp + cur.qp + 1) >> 1
                else:
                    nb = cur
                    qp_avg = cur.qp
                x = x0 + dx
                bs = _edge_bs(dec, cur, nb, x, y0, True)
                if not bs.any():
                    continue
                P = Y[y0:y0 + 16, x - 4:x]
                Q = Y[y0:y0 + 16, x:x + 4]
                Pn, Qn = _filter_luma_edge(P, Q, qp_avg, bs, a_off, b_off)
                Y[y0:y0 + 16, x - 4:x] = Pn
                Y[y0:y0 + 16, x:x + 4] = Qn
            if not mono:
                cx0, cy0 = mbx * 8, mby * 8
                for dx in ([0] if mbx > 0 else []) + [4]:
                    if dx == 0:
                        nb = dec.mb[mby * mb_w + mbx - 1]
                        if nb is None:
                            continue
                    else:
                        nb = cur
                    bs_l = _edge_bs(dec, cur, nb, x0 + 2 * dx, y0, True)
                    bs_c = bs_l[0::2]
                    if not bs_c.any():
                        continue
                    for pl in (1, 2):
                        C = dec.planes[pl]
                        qp_avg = (_chroma_qp(dec.pps, nb.qp, pl - 1) +
                                  _chroma_qp(dec.pps, cur.qp, pl - 1) +
                                  1) >> 1
                        x = cx0 + dx
                        P = C[cy0:cy0 + 8, x - 2:x]
                        Q = C[cy0:cy0 + 8, x:x + 2]
                        Pn, Qn = _filter_chroma_edge(P, Q, qp_avg, bs_c,
                                                     a_off, b_off)
                        C[cy0:cy0 + 8, x - 2:x] = Pn
                        C[cy0:cy0 + 8, x:x + 2] = Qn
            # ---- horizontal edges (filter rows), top to bottom
            h_edges = [0] if mby > 0 else []
            h_edges += [8] if cur.tx8 else [4, 8, 12]
            for dy in h_edges:
                if dy == 0:
                    nb = dec.mb[(mby - 1) * mb_w + mbx]
                    if nb is None:
                        continue
                    qp_avg = (nb.qp + cur.qp + 1) >> 1
                else:
                    nb = cur
                    qp_avg = cur.qp
                y = y0 + dy
                bs = _edge_bs(dec, cur, nb, x0, y, False)
                if not bs.any():
                    continue
                P = Y[y - 4:y, x0:x0 + 16].T
                Q = Y[y:y + 4, x0:x0 + 16].T
                Pn, Qn = _filter_luma_edge(P, Q, qp_avg, bs, a_off, b_off)
                Y[y - 4:y, x0:x0 + 16] = Pn.T
                Y[y:y + 4, x0:x0 + 16] = Qn.T
            if not mono:
                cx0, cy0 = mbx * 8, mby * 8
                for dy in ([0] if mby > 0 else []) + [4]:
                    if dy == 0:
                        nb = dec.mb[(mby - 1) * mb_w + mbx]
                        if nb is None:
                            continue
                    else:
                        nb = cur
                    bs_l = _edge_bs(dec, cur, nb, x0, y0 + 2 * dy, False)
                    bs_c = bs_l[0::2]
                    if not bs_c.any():
                        continue
                    for pl in (1, 2):
                        C = dec.planes[pl]
                        qp_avg = (_chroma_qp(dec.pps, nb.qp, pl - 1) +
                                  _chroma_qp(dec.pps, cur.qp, pl - 1) +
                                  1) >> 1
                        y = cy0 + dy
                        P = C[y - 2:y, cx0:cx0 + 8].T
                        Q = C[y:y + 2, cx0:cx0 + 8].T
                        Pn, Qn = _filter_chroma_edge(P, Q, qp_avg, bs_c,
                                                     a_off, b_off)
                        C[y - 2:y, cx0:cx0 + 8] = Pn.T
                        C[y:y + 2, cx0:cx0 + 8] = Qn.T
