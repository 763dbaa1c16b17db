"""AV1 loop restoration: Wiener and self-guided filters (spec §7.17), in
PyTorch.

Counterpart of libheif_tpu/codecs/av1/lr.py (``apply_lr`` :232).  The
JAX function filters each restoration unit, stripe piece by stripe
piece.  Here every plane is filtered at once, one slab per 64-row
stripe: the source of a sample depends only on its stripe (rows outside
it come from the deblocked frame, clamped to the stripe ±2, spec
7.17.1) and the unit boundaries fall on stripe boundaries, so each
output sample takes its unit's coefficients and its stripe's source.
The self-guided filter evaluates its A/B grid at a sample's neighbours
with that sample's own unit parameters, as the per-unit JAX function
does at unit borders.  Integer order as in the JAX function (int64).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# Sgr_Params[set] = (r0, e0, r1, e1)
SGR_PARAMS = (
    (2, 12, 1, 4), (2, 15, 1, 6), (2, 18, 1, 8), (2, 21, 1, 9),
    (2, 24, 1, 10), (2, 29, 1, 11), (2, 36, 1, 12), (2, 45, 1, 13),
    (2, 56, 1, 14), (2, 68, 1, 15), (0, 0, 1, 5), (0, 0, 1, 8),
    (0, 0, 1, 11), (0, 0, 1, 14), (2, 30, 0, 0), (2, 76, 0, 0),
)

SGRPROJ_RST_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_SGR_BITS = 8
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12


def _round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def stripe_source(cdef_p: torch.Tensor, deblk_p: torch.Tensor,
                  plane_w: int, plane_h: int, stripe: int, voffset: int,
                  margin: int = 3) -> torch.Tensor:
    """(S, stripe + 2·margin, plane_w + 2·margin) int64 source of every
    stripe (the JAX ``_gather_piece`` rule for every row a stripe's
    outputs read): slab row i of stripe s is plane row s·stripe −
    voffset − margin + i, clamped to the plane, read from the CDEF output
    inside the stripe and from the deblocked frame outside it."""
    dev = cdef_p.device
    S = (plane_h + voffset + stripe - 1) // stripe
    s = torch.arange(S, device=dev)[:, None]
    ss_start = s * stripe - voffset
    ss_end = ss_start + stripe - 1
    y = ss_start - margin + torch.arange(stripe + 2 * margin,
                                         device=dev)[None, :]
    y = torch.clamp(y, 0, plane_h - 1)
    below = y < ss_start
    above = y > ss_end
    row = torch.where(below, torch.maximum(ss_start - 2, y),
                      torch.where(above, torch.minimum(ss_end + 2, y), y))
    from_deblk = below | above
    xs = torch.clamp(torch.arange(-margin, plane_w + margin, device=dev), 0,
                     plane_w - 1)
    both = torch.stack([cdef_p, deblk_p]).to(torch.int64)
    pw_full = cdef_p.shape[1]
    flat = both.reshape(-1)
    base = from_deblk.to(torch.int64) * cdef_p.numel() + row * pw_full
    return flat[base[:, :, None] + xs[None, None, :]]


def _box_sums(src: torch.Tensor, r: int):
    """(sum of squares, sum) over the (2r+1)^2 window centred on every
    output position and its one-sample border: (S, R-4, W-4) for the
    margin-3 slab (S, R, W), index 0 the border before the first output
    row and column."""
    n = 2 * r + 1
    o = 2 - r               # the window's first slab row/column at index 0
    out = []
    for v in (src * src, src):
        c = torch.zeros((v.shape[0], v.shape[1] + 1, v.shape[2] + 1),
                        dtype=torch.int64, device=v.device)
        c[:, 1:, 1:] = v.cumsum(1).cumsum(2)
        R, W = v.shape[1] - 4, v.shape[2] - 4
        out.append(c[:, o + n:o + n + R, o + n:o + n + W] -
                   c[:, o:o + R, o + n:o + n + W] -
                   c[:, o + n:o + n + R, o:o + W] + c[:, o:o + R, o:o + W])
    return out


def _ab(a_sum, b_sum, n, s_val, bd):
    """The box filter's A (a2) and B (b2) from its window sums."""
    shift = 2 * (bd - 8)
    a_r = _round2(a_sum, shift) if shift else a_sum
    d_r = _round2(b_sum, bd - 8) if bd > 8 else b_sum
    p = torch.clamp(a_r * n - d_r * d_r, min=0)
    z = (p * s_val + (1 << (SGRPROJ_MTABLE_BITS - 1))) >> \
        SGRPROJ_MTABLE_BITS
    a2 = torch.where(z >= 255, 256,
                     torch.where(z == 0, 1,
                                 torch.div((z << SGRPROJ_SGR_BITS) + z // 2,
                                           z + 1, rounding_mode="floor")))
    one_over_n = ((1 << SGRPROJ_RECIP_BITS) + (n >> 1)) // n
    b2 = (((1 << SGRPROJ_SGR_BITS) - a2) * b_sum * one_over_n +
          (1 << (SGRPROJ_RECIP_BITS - 1))) >> SGRPROJ_RECIP_BITS
    return a2, b2


def _flt(v, nb):
    shift = SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS
    return (v + (1 << (shift - 1))) >> shift


def _box_filter(src, r, s_val, even_rows, bd):
    """One self-guided pass for every slab output (S, stripe, W): radius
    2 (pass 0: even plane rows weigh the rows above and below, odd rows
    their own) or 1 (pass 1, the 3x3 neighbourhood).  A and B are taken at
    each output's neighbours with the output's own s_val."""
    n = (2 * r + 1) ** 2
    a_sum, b_sum = _box_sums(src, r)        # (S, stripe + 2, W + 2)
    R, W = a_sum.shape[1] - 2, a_sum.shape[2] - 2
    center = src[:, 3:3 + R, 3:3 + W]
    A, B = {}, {}
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            sl = (slice(None), slice(1 + di, 1 + di + R),
                  slice(1 + dj, 1 + dj + W))
            A[di, dj], B[di, dj] = _ab(a_sum[sl], b_sum[sl], n, s_val, bd)

    def weigh(T, w6, w5):
        return 6 * sum(T[k] for k in w6) + 5 * sum(T[k] for k in w5)
    if r == 2:
        vert, diag = [(-1, 0), (1, 0)], [(-1, -1), (-1, 1), (1, -1), (1, 1)]
        mid, side = [(0, 0)], [(0, -1), (0, 1)]
        fe = _flt(weigh(A, vert, diag) * center + weigh(B, vert, diag), 5)
        fo = _flt(weigh(A, mid, side) * center + weigh(B, mid, side), 4)
        return torch.where(even_rows, fe, fo)
    cross = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    corners = [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    a = 4 * sum(A[k] for k in cross) + 3 * sum(A[k] for k in corners)
    b = 4 * sum(B[k] for k in cross) + 3 * sum(B[k] for k in corners)
    return _flt(a * center + b, 5)


def _wiener(src, hf, vf, bd):
    """Horizontal pass into the clipped intermediate, then the vertical
    pass, with per-sample 7-tap filters hf/vf (S, 1, W, 7)."""
    inter_round0 = 5 if bd == 12 else 3
    inter_round1 = 9 if bd == 12 else 11
    offset = 1 << (bd + 7 - inter_round0 - 1)
    limit = (1 << (bd + 1 + 7 - inter_round0)) - 1
    S, R, Wp = src.shape
    W = Wp - 6
    h = R - 6
    inter = torch.zeros((S, R, W), dtype=torch.int64, device=src.device)
    for t in range(7):
        inter = inter + hf[..., t] * src[:, :, t:t + W]
    inter = (inter + (1 << (inter_round0 - 1))) >> inter_round0
    inter = torch.clamp(inter, -offset, limit - offset)
    out = torch.zeros((S, h, W), dtype=torch.int64, device=src.device)
    for t in range(7):
        out = out + vf[..., t] * inter[:, t:t + h]
    out = (out + (1 << (inter_round1 - 1))) >> inter_round1
    return torch.clamp(out, 0, (1 << bd) - 1)


def apply_lr(cdef_planes: List[torch.Tensor],
             deblk_planes: List[torch.Tensor], dec, seq, fh, frame_w: int,
             frame_h: int) -> List[torch.Tensor]:
    """Frame loop restoration (spec §7.17.1): new planes."""
    bd = seq.bit_depth
    num_planes = 1 if seq.monochrome else 3
    outs = [p.clone() for p in cdef_planes]
    for plane in range(num_planes):
        if fh.lr_type[plane] == 0:
            continue
        types = np.asarray(dec.lr_unit_type[plane])
        if not types.any():
            continue
        dev = cdef_planes[plane].device
        sub_x = 0 if plane == 0 else seq.subsampling_x
        sub_y = 0 if plane == 0 else seq.subsampling_y
        plane_w = _round2(frame_w, sub_x)
        plane_h = _round2(frame_h, sub_y)
        usize = fh.lr_unit_size[plane]
        ur_total, uc_total = dec.lr_unit_dims[plane]
        stripe = 64 >> sub_y
        voffset = 8 >> sub_y
        src = stripe_source(cdef_planes[plane], deblk_planes[plane],
                            plane_w, plane_h, stripe, voffset)
        S = src.shape[0]

        # each output sample's unit: its stripe's unit row, its column's
        # unit column (host tables, gathered per (stripe, column))
        ur = np.minimum(np.arange(S) * stripe // usize, ur_total - 1)
        uc = np.minimum(np.arange(plane_w) // usize, uc_total - 1)
        uidx = ur[:, None] * uc_total + uc[None, :]          # (S, W)

        def per_sample(table, cols):
            t = np.asarray(table, np.int64).reshape(ur_total * uc_total,
                                                    cols)
            return torch.from_numpy(t[uidx]).to(dev)[:, None]   # (S,1,W,c)
        utype = per_sample(types, 1)[..., 0]
        res = src[:, 3:3 + stripe, 3:3 + plane_w]
        if (types == 2).any():
            wt = np.asarray(dec.lr_wiener[plane], np.int64)
            taps = np.concatenate([wt, (128 - 2 * wt.sum(-1))[..., None],
                                   wt[..., ::-1]], -1)       # (ur, uc, 2, 7)
            vf = per_sample(taps[:, :, 0], 7)
            hf = per_sample(taps[:, :, 1], 7)
            res = torch.where(utype == 2, _wiener(src, hf, vf, bd), res)
        if (types == 3).any():
            sets = np.asarray(dec.lr_sgr_set[plane], np.int64)
            prm = np.asarray(SGR_PARAMS, np.int64)[sets]        # (ur,uc,4)
            xqd = np.asarray(dec.lr_sgr_xqd[plane], np.int64)
            r0, r1 = prm[..., 0], prm[..., 2]
            x0, x1 = xqd[..., 0], xqd[..., 1]
            one = 1 << SGRPROJ_PRJ_BITS
            xq0 = np.where(r0 == 0, 0, x0)
            xq1 = np.where(r0 == 0, one - x1,
                           np.where(r1 == 0, 0, one - x0 - x1))

            def s_val(n, eps):
                n2e = n * n * eps
                return np.where(n2e > 0, ((1 << SGRPROJ_MTABLE_BITS) +
                                          n2e // 2) // np.maximum(n2e, 1), 0)
            tab = np.stack([r0, r1, xq0, xq1, s_val(25, prm[..., 1]),
                            s_val(9, prm[..., 3])], -1)
            t = per_sample(tab, 6)[:, 0]                        # (S,W,6)
            center = src[:, 3:3 + stripe, 3:3 + plane_w]
            u = center << SGRPROJ_RST_BITS
            yrow = (torch.arange(S, device=dev)[:, None] * stripe - voffset +
                    torch.arange(stripe, device=dev)[None, :])
            even = ((yrow & 1) == 0)[:, :, None]
            flt0 = torch.where(t[:, None, :, 0] > 0,
                               _box_filter(src, 2, t[:, None, :, 4], even,
                                           bd), u)
            flt1 = torch.where(t[:, None, :, 1] > 0,
                               _box_filter(src, 1, t[:, None, :, 5], even,
                                           bd), u)
            w0, w2 = t[:, None, :, 2], t[:, None, :, 3]
            w1 = one - w0 - w2
            v = w0 * flt0 + w1 * u + w2 * flt1
            sg = (v + (1 << (SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS - 1))) >> \
                (SGRPROJ_RST_BITS + SGRPROJ_PRJ_BITS)
            res = torch.where(utype == 3, torch.clamp(sg, 0, (1 << bd) - 1),
                              res)
        # stripe slabs back into the plane: rows 0 .. plane_h - 1
        rows = res.reshape(S * stripe, plane_w)[voffset:voffset + plane_h]
        outs[plane][:plane_h, :plane_w] = rows.to(outs[plane].dtype)
    return outs
