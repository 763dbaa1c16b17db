"""AV1 film grain synthesis (spec §7.18.3), an output stage after the
in-loop filters.

Counterpart of libheif_tpu/codecs/av1/grain.py.  The parts that depend
on the film grain parameters only run on the host in numpy, copied: the
grain templates (the 16-bit LFSR, the Gaussian sequence and the
autoregressive filter: ``generate_luma_grain``, ``generate_chroma_grain``),
the scaling lookup tables (``scaling_lut``) and the per-block template
offsets (``block_offsets``, the LFSR draws of one stripe of 32 luma rows
after the other).  ``apply_film_grain`` builds the noise planes on the
planes' device as gathers from the uploaded templates, at indices computed
from each sample's block, its offsets and its place in the block; then the
overlap blends of the block edges, as masked rows and columns in the
reference's order (left blend of the block, top-left into top, top into
the block); then the scaling lookups, the rounding shift and the clip.
No loop runs over blocks.

At 4:2:2 the reference takes the chroma block's height, template offset
and vertical overlap from the horizontal subsampling too; here they come
from the vertical one, as spec §7.18.3.5 has them (a chroma block 16
samples wide and 32 tall, its row offset 9 + 2·offsetY, a 2-sample
vertical overlap).  Elsewhere the result is the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...core.trace import span
from . import tables as T

GRAIN_W = 82
GRAIN_H = 73

W2 = ((27, 17), (17, 27))     # 2-sample overlap weights (old, new)
W1 = ((23, 22),)              # 1-sample (subsampled) overlap


def _gauss():
    return T._qlookup_hbd()["gaussian_sequence"].astype(np.int32)


class _Rand:
    __slots__ = ("reg",)

    def __init__(self, seed: int):
        self.reg = seed & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.reg
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.reg = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _ar_positions(lag: int) -> List[Tuple[int, int]]:
    pos = []
    for dy in range(-lag, 1):
        for dx in range(-lag, lag + 1):
            if dy == 0 and dx == 0:
                break
            pos.append((dy, dx))
    return pos


def generate_luma_grain(g, bd: int) -> np.ndarray:
    gauss = _gauss()
    shift = 12 - bd + g.grain_scale_shift
    grain = np.zeros((GRAIN_H, GRAIN_W), np.int32)
    rnd = _Rand(g.grain_seed)
    if g.num_y_points:
        for y in range(GRAIN_H):
            for x in range(GRAIN_W):
                grain[y, x] = _round2(int(gauss[rnd.bits(11)]), shift)
    gmax = (128 << (bd - 8)) - 1
    gmin = -(128 << (bd - 8))
    lag = g.ar_coeff_lag
    pos = _ar_positions(lag)
    coeffs = g.ar_coeffs_y
    sh = g.ar_coeff_shift
    if g.num_y_points and coeffs:
        for y in range(3, GRAIN_H):
            for x in range(3, GRAIN_W - 3):
                s = 0
                for (dy, dx), c in zip(pos, coeffs):
                    s += c * int(grain[y + dy, x + dx])
                v = int(grain[y, x]) + _round2(s, sh)
                grain[y, x] = min(max(v, gmin), gmax)
    return grain


def generate_chroma_grain(g, luma: np.ndarray, bd: int, ssx: int, ssy: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    gauss = _gauss()
    shift = 12 - bd + g.grain_scale_shift
    cw = 44 if ssx else GRAIN_W
    ch = 38 if ssy else GRAIN_H
    gmax = (128 << (bd - 8)) - 1
    gmin = -(128 << (bd - 8))
    lag = g.ar_coeff_lag
    pos = _ar_positions(lag)
    sh = g.ar_coeff_shift
    out = []
    for c_idx, (coeffs, xor) in enumerate(((g.ar_coeffs_cb, 0xb524),
                                           (g.ar_coeffs_cr, 0x49d8))):
        grain = np.zeros((ch, cw), np.int32)
        have_pts = (g.num_cb_points if c_idx == 0 else g.num_cr_points) \
            or g.chroma_scaling_from_luma
        rnd = _Rand(g.grain_seed ^ xor)
        if have_pts:
            for y in range(ch):
                for x in range(cw):
                    grain[y, x] = _round2(int(gauss[rnd.bits(11)]), shift)
        if have_pts and coeffs:
            n_spatial = len(pos)
            for y in range(3, ch):
                for x in range(3, cw - 3):
                    s = 0
                    for (dy, dx), c in zip(pos, coeffs[:n_spatial]):
                        s += c * int(grain[y + dy, x + dx])
                    if g.num_y_points:
                        # collocated (averaged) luma grain, final coeff
                        lx = ((x - 3) << ssx) + 3
                        ly = ((y - 3) << ssy) + 3
                        lsum = 0
                        for i in range(1 + ssy):
                            for j in range(1 + ssx):
                                lsum += int(luma[ly + i, lx + j])
                        lval = _round2(lsum, ssx + ssy)
                        s += coeffs[n_spatial] * lval
                    v = int(grain[y, x]) + _round2(s, sh)
                    grain[y, x] = min(max(v, gmin), gmax)
        out.append(grain)
    return out[0], out[1]


def scaling_lut(points: List[Tuple[int, int]], bd: int) -> np.ndarray:
    """Expanded scaling LUT of size (1 << bd) (spec 7.18.3.3 + the
    7.18.3.5 high-bit-depth interpolation folded in, like dav1d's
    generate_scaling)."""
    size = 1 << bd
    lut = np.zeros(size, np.int32)
    if not points:
        return lut
    shift = bd - 8
    base = np.zeros(257, np.int32)
    base[:points[0][0] + 1] = points[0][1]
    for (x0, y0), (x1, y1) in zip(points[:-1], points[1:]):
        dx = x1 - x0
        dy = y1 - y0
        if dx <= 0:
            base[x0] = y0
            continue
        delta = dy * ((0x10000 + (dx >> 1)) // dx)
        xs = np.arange(dx)
        base[x0:x1] = y0 + ((xs * delta + 0x8000) >> 16)
    base[points[-1][0]:] = points[-1][1]
    if shift == 0:
        return base[:256].copy()
    # linear interpolation between the 8-bit grid points
    pad = 1 << shift
    rnd = pad >> 1
    idx = np.arange(size) >> shift
    rem = np.arange(size) & (pad - 1)
    lo = base[idx]
    hi = base[np.minimum(idx + 1, 255)]
    lut = lo + ((hi - lo) * rem + rnd) // pad
    return lut.astype(np.int32)


def block_offsets(g, h: int, w: int) -> np.ndarray:
    """(n_sby, n_sbx, 2) int32: each 32x32-luma block's template offsets
    (offsetX, offsetY), one 8-bit draw a block, the LFSR seeded anew for
    each stripe of 32 luma rows (spec 7.18.3.5; the reference's
    ``apply_film_grain`` :196-206)."""
    n_sby = (((h + 1) >> 1) + 15) // 16
    n_sbx = (((w + 1) >> 1) + 15) // 16
    offs = np.zeros((n_sby, n_sbx, 2), np.int32)
    for s in range(n_sby):
        rnd = _Rand(g.grain_seed
                    ^ (((s * 37 + 178) & 0xFF) << 8)
                    ^ ((s * 173 + 105) & 0xFF))
        for j in range(n_sbx):
            rv = rnd.bits(8)
            offs[s, j] = (rv >> 4, rv & 15)
    return offs


@functools.lru_cache(maxsize=16)
def _templates(params: tuple, bd: int, ssx: int, ssy: int, mono: bool):
    g = SimpleNamespace(**dict(params))
    luma = generate_luma_grain(g, bd)
    if mono:
        return luma, None, None
    return (luma,) + generate_chroma_grain(g, luma, bd, ssx, ssy)


def templates(g, bd: int, ssx: int, ssy: int, mono: bool = False):
    """(luma, cb, cr) grain templates of the parameters (cb, cr None for
    monochrome), numpy int32 that callers copy and do not write; the last
    few parameter sets' are kept, since the tiles of a grid usually share
    them."""
    params = tuple((k, tuple(v) if isinstance(v, list) else v)
                   for k, v in dataclasses.asdict(g).items())
    return _templates(params, bd, ssx, ssy, mono)


def _noise_plane(tmpl: torch.Tensor, offs: torch.Tensor, th: int, tw: int,
                 span_y: int, span_x: int, sub_y: int, sub_x: int,
                 overlap: bool, gmin: int, gmax: int) -> torch.Tensor:
    """The (th, tw) int32 noise of one plane: each sample gathered from
    the template at its block's offsets, then the overlap blends."""
    dev = offs.device
    ox, oy = offs[..., 0].long(), offs[..., 1].long()

    def base_x(o):
        return 6 + o if sub_x else 9 + 2 * o

    def base_y(o):
        return 6 + o if sub_y else 9 + 2 * o
    wx, wy = (W1 if sub_x else W2), (W1 if sub_y else W2)
    ys = torch.arange(th, device=dev)
    xs = torch.arange(tw, device=dev)
    s, ry = ys // span_y, ys % span_y
    j, rx = xs // span_x, xs % span_x
    flat, pitch = tmpl.reshape(-1), tmpl.shape[1]

    def take(r, c):
        return flat[r * pitch + c]

    def blend(old, new, w):
        # w: (2, ...) weights (old, new) broadcast against the samples
        return torch.clamp((old * w[0] + new * w[1] + 16) >> 5, gmin, gmax)
    cur = take(base_y(oy[s[:, None], j[None, :]]) + ry[:, None],
               base_x(ox[s[:, None], j[None, :]]) + rx[None, :])
    if not overlap:
        return cur
    wxt = torch.tensor(wx, dtype=torch.int32, device=dev).T     # (2, n)
    wyt = torch.tensor(wy, dtype=torch.int32, device=dev).T
    # 1. the left blend: the first columns of blocks j > 0 with the left
    # block's template past its span
    cols = torch.nonzero((j > 0) & (rx < len(wx)))[:, 0]
    if len(cols):
        jl, rl = j[cols] - 1, rx[cols]
        left = take(base_y(oy[s[:, None], jl[None, :]]) + ry[:, None],
                    base_x(ox[s[:, None], jl[None, :]]) + span_x +
                    rl[None, :])
        cur[:, cols] = blend(left, cur[:, cols], wxt[:, rl][:, None, :])
    rows = torch.nonzero((s > 0) & (ry < len(wy)))[:, 0]
    if len(rows):
        st, rt = s[rows] - 1, ry[rows]
        # the block above's template past its span
        top = take(base_y(oy[st[:, None], j[None, :]]) + span_y +
                   rt[:, None],
                   base_x(ox[st[:, None], j[None, :]]) + rx[None, :])
        # 2. top-left into top, on the first columns of blocks j > 0
        if len(cols):
            tl = take(base_y(oy[st[:, None], jl[None, :]]) + span_y +
                      rt[:, None],
                      base_x(ox[st[:, None], jl[None, :]]) + span_x +
                      rl[None, :])
            top[:, cols] = blend(tl, top[:, cols], wxt[:, rl][:, None, :])
        # 3. top into the block's first rows
        cur[rows] = blend(top, cur[rows], wyt[:, rt][:, :, None])
    return cur


def apply_film_grain(planes: Dict[str, torch.Tensor], g, bd: int,
                     ssx: int = 1, ssy: int = 1) -> Dict[str, torch.Tensor]:
    """Add synthesised grain to cropped output planes ({"Y"}, and "U",
    "V" unless monochrome; integer tensors), on their device (spec
    7.18.3.4/5).  Returns a new dict of int32 planes; a plane without
    scaling points is returned as it was."""
    with span("av1.grain"):
        return _apply(planes, g, bd, ssx, ssy)


def _apply(planes, g, bd, ssx, ssy):
    y = planes["Y"].to(torch.int32)
    dev = y.device
    h, w = y.shape
    mono = "U" not in planes
    luma_t, cb_t, cr_t = templates(g, bd, ssx, ssy, mono)
    offs = torch.from_numpy(block_offsets(g, h, w)).to(dev)
    gmax = (128 << (bd - 8)) - 1
    gmin = -(128 << (bd - 8))
    maxv = (1 << bd) - 1
    sc_shift = g.grain_scaling
    if g.clip_to_restricted_range:
        y_min, y_max = 16 << (bd - 8), 235 << (bd - 8)
        c_min, c_max = 16 << (bd - 8), 240 << (bd - 8)
    else:
        y_min = c_min = 0
        y_max = c_max = maxv

    def up(a):
        return torch.tensor(a, device=dev)

    def scaled(lut_np, idx, noise):
        lut = up(lut_np)
        sc = lut[torch.clamp(idx, 0, maxv).long()]
        return (sc * noise + (1 << (sc_shift - 1))) >> sc_shift

    out = {}
    if g.num_y_points:
        noise = _noise_plane(up(luma_t), offs, h, w, 32, 32, 0, 0,
                             g.overlap_flag, gmin, gmax)
        out["Y"] = torch.clamp(y + scaled(scaling_lut(g.point_y, bd), y,
                                          noise), y_min, y_max)
    else:
        out["Y"] = planes["Y"]
    if mono:
        return out
    u = planes["U"].to(torch.int32)
    v = planes["V"].to(torch.int32)
    ch, cw = u.shape
    # averaged collocated luma for the scaling index (the reference's
    # right-edge rule: an odd width pairs its last column with the one
    # before)
    if ssx:
        even, odd = y[:, 0::2], y[:, 1::2]
        if odd.shape[1] < even.shape[1]:
            odd = torch.cat([odd, odd[:, -1:]], 1)
        avg = (even + odd + 1) >> 1
    else:
        avg = y
    if ssy:
        avg = avg[0::2, :]
    # the edge repeated where the chroma plane is larger
    avg = avg[torch.clamp(torch.arange(ch, device=dev), max=avg.shape[0] - 1)]
    avg = avg[:, torch.clamp(torch.arange(cw, device=dev),
                             max=avg.shape[1] - 1)]
    for name, pl, tmpl, pts, mult, lmult, off in (
            ("U", u, cb_t, g.point_cb, g.cb_mult, g.cb_luma_mult,
             g.cb_offset),
            ("V", v, cr_t, g.point_cr, g.cr_mult, g.cr_luma_mult,
             g.cr_offset)):
        if g.chroma_scaling_from_luma:
            lut, idx = scaling_lut(g.point_y, bd), avg
        elif pts:
            lut = scaling_lut(pts, bd)
            idx = ((avg * lmult + pl * mult) >> 6) + (off << (bd - 8))
        else:
            out[name] = planes[name]
            continue
        # chroma blocks: 32 luma samples along each axis, the spec's
        # geometry at every subsampling
        noise = _noise_plane(up(tmpl), offs, ch, cw, 32 >> ssy, 32 >> ssx,
                             ssy, ssx, g.overlap_flag, gmin, gmax)
        out[name] = torch.clamp(pl + scaled(lut, idx, noise), c_min, c_max)
    return out
