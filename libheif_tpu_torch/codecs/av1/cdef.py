"""AV1 CDEF (constrained directional enhancement filter, spec §7.15), in
PyTorch.

Counterpart of libheif_tpu/codecs/av1/cdef.py (``apply_cdef`` :235).
Which 8x8 blocks filter, and with which strengths, follows from the
parse maps (skip flags, the per-64x64 CDEF index) and is decided on the
host; the direction search and the filter run on the planes' device
over all blocks at once, in the JAX function's integer order.  Samples
beyond the 8-aligned frame read CDEF_VERY_LARGE, as in the JAX
function (which keeps its own behaviour at non-8-aligned frame sizes).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

CDEF_VERY_LARGE = 30000

# Cdef_Directions[dir][k] = (dy, dx) (spec §7.15.3)
CDEF_DIRECTIONS = (
    ((-1, 1), (-2, 2)),
    ((0, 1), (-1, 2)),
    ((0, 1), (0, 2)),
    ((0, 1), (1, 2)),
    ((1, 1), (2, 2)),
    ((1, 0), (2, 1)),
    ((1, 0), (2, 0)),
    ((1, 0), (2, -1)),
)

_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
_VALID_ALIGN = 8
_SEC_TAPS = (2, 1)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """Per-element int.bit_length() of non-negative int64 values."""
    return torch.where(v > 0, torch.frexp(v.double()).exponent.to(torch.int64),
                       0)


def find_directions(blocks: torch.Tensor, coeff_shift: int):
    """8x8 direction search over (N, 8, 8) blocks (spec §7.15.2, the
    JAX ``_find_directions_vec``): (dirs (N,), vars (N,)) int64."""
    n = blocks.shape[0]
    dev = blocks.device
    x = ((blocks.to(torch.int64) >> coeff_shift) - 128).reshape(n, 64)
    i = np.arange(8)[:, None]
    j = np.arange(8)[None, :]
    maps = [i + j, i + j // 2, i + 0 * j, 3 + i - j // 2, 7 + i - j,
            3 - i // 2 + j, 0 * i + j, i // 2 + j]
    partial = torch.zeros((n, 8, 15), dtype=torch.int64, device=dev)
    for d, m in enumerate(maps):
        idx = torch.from_numpy(np.broadcast_to(m, (8, 8)).ravel()
                               .astype(np.int64)).to(dev)
        partial[:, d].index_add_(1, idx, x)
    div = torch.tensor(_DIV_TABLE, dtype=torch.int64, device=dev)
    cost = torch.zeros((n, 8), dtype=torch.int64, device=dev)
    sq = partial * partial
    cost[:, 2] = sq[:, 2, :8].sum(1) * 105
    cost[:, 6] = sq[:, 6, :8].sum(1) * 105
    rev = torch.arange(14, 7, -1, device=dev)
    for d in (0, 4):
        cost[:, d] = ((sq[:, d, :7] + sq[:, d, rev]) * div[1:8]).sum(1) + \
            sq[:, d, 7] * div[8]
    rev3 = torch.arange(10, 7, -1, device=dev)
    for d in (1, 3, 5, 7):
        cost[:, d] = sq[:, d, 3:8].sum(1) * 105 + \
            ((sq[:, d, :3] + sq[:, d, rev3]) * div[2:7:2]).sum(1)
    best = torch.argmax(cost, dim=1)        # first max, like the scalar
    ar = torch.arange(n, device=dev)
    var = (cost[ar, best] - cost[ar, (best + 4) & 7]) >> 10
    return best, var


def filter_blocks(out: torch.Tensor, pad: torch.Tensor, ys: torch.Tensor,
                  xs: torch.Tensor, pri: torch.Tensor, sec: torch.Tensor,
                  damping: int, dirs: torch.Tensor, coeff_shift: int,
                  bh: int, bw: int) -> None:
    """The JAX ``_filter_blocks_vec`` over N (bh, bw) blocks at (ys, xs):
    each tap position one gathered read of the padded source, written
    into ``out`` in place."""
    n = ys.shape[0]
    if n == 0:
        return
    dev = pad.device
    pw = pad.shape[1]
    flat = pad.reshape(-1).to(torch.int64)
    yy = ys[:, None, None] + torch.arange(bh, device=dev)[None, :, None] + 2
    xx = xs[:, None, None] + torch.arange(bw, device=dev)[None, None, :] + 2
    x = flat[yy * pw + xx]
    s = torch.zeros_like(x)
    mx = x.clone()
    mn = x.clone()
    pri_c = pri[:, None, None]
    sec_c = sec[:, None, None]
    dmp_pri = torch.clamp(damping - (_bit_length(pri) - 1), min=0)[:, None,
                                                                   None]
    dmp_sec = torch.clamp(damping - (_bit_length(sec) - 1), min=0)[:, None,
                                                                   None]
    tap_sel = (pri >> coeff_shift) & 1
    pri_tap = torch.stack([torch.where(tap_sel > 0, 3, 4),
                           torch.where(tap_sel > 0, 3, 2)], 1)
    dir_off = torch.tensor(CDEF_DIRECTIONS, dtype=torch.int64, device=dev)

    def constrain(diff, thr, damp):
        a = torch.abs(diff)
        v = torch.minimum(a, torch.clamp(thr - (a >> damp), min=0))
        return torch.where(diff < 0, -v, v)

    def accumulate(p, taps, thr, damp, active):
        nonlocal s, mx, mn
        s = s + torch.where(active, taps * constrain(p - x, thr, damp), 0)
        valid = active & (p != CDEF_VERY_LARGE)
        mx = torch.where(valid, torch.maximum(mx, p), mx)
        mn = torch.where(valid, torch.minimum(mn, p), mn)

    pri_on = pri_c > 0
    sec_on = sec_c > 0
    for k in range(2):
        oy = dir_off[dirs, k, 0][:, None, None]
        ox = dir_off[dirs, k, 1][:, None, None]
        taps = pri_tap[:, k][:, None, None]
        for sgn in (1, -1):
            p = flat[(yy + sgn * oy) * pw + xx + sgn * ox]
            accumulate(p, taps, pri_c, dmp_pri, pri_on)
    for k in range(2):
        for dd in (2, 6):
            d2 = (dirs + dd) & 7
            oy = dir_off[d2, k, 0][:, None, None]
            ox = dir_off[d2, k, 1][:, None, None]
            for sgn in (1, -1):
                p = flat[(yy + sgn * oy) * pw + xx + sgn * ox]
                accumulate(p, _SEC_TAPS[k], sec_c, dmp_sec, sec_on)
    v = x + ((8 + s - (s < 0).to(torch.int64)) >> 4)
    res = torch.maximum(mn, torch.minimum(mx, v))
    out.reshape(-1)[(yy - 2) * out.shape[1] + (xx - 2)] = res.to(out.dtype)


def apply_cdef(planes: List[torch.Tensor], dec, seq, fh, frame_w: int,
               frame_h: int) -> List[torch.Tensor]:
    """Filter the frame in 64x64 units (spec §7.15.1); returns new planes
    (the source stays the deblocked frame)."""
    c = fh.cdef
    coeff_shift = seq.bit_depth - 8
    ssx, ssy = seq.subsampling_x, seq.subsampling_y
    num_planes = 1 if seq.monochrome else 3
    dev = planes[0].device

    a = _VALID_ALIGN - 1
    vw = (frame_w + a) & ~a
    vh = (frame_h + a) & ~a
    pads = []
    outs = []
    for p_idx in range(num_planes):
        pw = vw if p_idx == 0 else vw >> ssx
        ph = vh if p_idx == 0 else vh >> ssy
        fph, fpw = planes[p_idx].shape
        pad = torch.full((fph + 4, fpw + 4), CDEF_VERY_LARGE,
                         dtype=torch.int32, device=dev)
        pad[2:2 + ph, 2:2 + pw] = planes[p_idx][:ph, :pw]
        pads.append(pad)
        outs.append(planes[p_idx].clone())

    # which blocks filter, with which strengths: host, from the parse maps
    mi_rows, mi_cols = dec.mi_rows, dec.mi_cols
    skips = np.asarray(dec.skip_map, bool)
    y_damp = c.damping + coeff_shift
    uv_damp = y_damp - 1
    nby, nbx = (mi_rows + 1) >> 1, (mi_cols + 1) >> 1
    if nby == 0 or nbx == 0:
        return outs
    r0 = np.arange(nby) * 2
    r1 = np.minimum(r0 + 1, mi_rows - 1)
    c0 = np.arange(nbx) * 2
    c1 = np.minimum(c0 + 1, mi_cols - 1)
    blk_skip = (skips[np.ix_(r0, c0)] & skips[np.ix_(r0, c1)] &
                skips[np.ix_(r1, c0)] & skips[np.ix_(r1, c1)])
    cdef_map = np.asarray(dec.cdef_idx)
    unit_r = np.minimum(np.arange(nby) * 2 // 16 * 16, mi_rows - 1)
    unit_c = np.minimum(np.arange(nbx) * 2 // 16 * 16, mi_cols - 1)
    blk_idx = cdef_map[unit_r[:, None], unit_c[None, :]].astype(np.int64)
    active = (blk_idx >= 0) & ~blk_skip
    if not active.any():
        return outs
    by, bx = np.nonzero(active)
    idxs = blk_idx[by, bx]

    def put(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(dev)
    ys, xs = put(by * 8), put(bx * 8)
    y_pri = put((np.asarray(c.y_pri, np.int64) << coeff_shift)[idxs])
    y_sec = put((np.asarray(c.y_sec, np.int64) << coeff_shift)[idxs])
    uv_pri = put((np.asarray(c.uv_pri, np.int64) << coeff_shift)[idxs])
    uv_sec = put((np.asarray(c.uv_sec, np.int64) << coeff_shift)[idxs])

    # direction search where the luma or chroma primary strength is on
    need = (y_pri > 0) | (uv_pri > 0)
    dirs = torch.zeros_like(ys)
    var = torch.zeros_like(ys)
    if bool(need.any()):
        sel = torch.nonzero(need)[:, 0]
        ar8 = torch.arange(8, device=dev)
        yy = ys[sel][:, None, None] + ar8[None, :, None] + 2
        xx = xs[sel][:, None, None] + ar8[None, None, :] + 2
        blocks = pads[0].reshape(-1)[yy * pads[0].shape[1] + xx]
        d, v = find_directions(blocks, coeff_shift)
        dirs[sel] = d
        var[sel] = v

    # luma primary strength adjusted by the local variance
    v6 = var >> 6
    i_log = torch.where(v6 > 0, torch.clamp(_bit_length(v6) - 1, max=12), 0)
    pri_adj = torch.where(var != 0, (y_pri * (4 + i_log) + 8) >> 4, 0)
    pri_adj = torch.where(y_pri > 0, pri_adj, 0)
    luma_dirs = torch.where(y_pri > 0, dirs, 0)
    lsel = torch.nonzero((pri_adj > 0) | (y_sec > 0) | (y_pri > 0))[:, 0]
    filter_blocks(outs[0], pads[0], ys[lsel], xs[lsel], pri_adj[lsel],
                  y_sec[lsel], y_damp, luma_dirs[lsel], coeff_shift, 8, 8)
    if num_planes > 1:
        csel = torch.nonzero((uv_pri > 0) | (uv_sec > 0))[:, 0]
        if len(csel):
            cdirs = torch.where(uv_pri[csel] > 0, dirs[csel], 0)
            for p_idx in (1, 2):
                filter_blocks(outs[p_idx], pads[p_idx], ys[csel] >> ssy,
                              xs[csel] >> ssx, uv_pri[csel], uv_sec[csel],
                              uv_damp, cdirs, coeff_shift, 8 >> ssy,
                              8 >> ssx)
    return outs
