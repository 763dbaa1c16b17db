"""Synthetic stage-B inputs: waves whose jobs are chosen by size and kind.

A decoded stream gives whatever waves its encoder made.  To hold
av1_intra_wave against its plain versions on waves it seldom meets (a
64x64 luma job among many 4x4 jobs, many 32x32 filter-intra or CfL jobs in
one wave, waves that overflow the kernel's shared memory), ``synthetic``
builds the tables of ``cuda_fast.intra_waves`` from a seed: random
reference samples in a region that no job writes (also the luma plane
that CfL reads), each job's output in a block of its own, random modes,
angles, edge-filter and upsampling choices as ``device_recon`` derives
them, random residuals and visible sizes.  Since no job reads what another
writes, every order of the jobs gives the same samples.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import tables as T
from .cuda_fast import PARAM_COLS, WaveGroup
from .recon import _edge_filter_strength, _pred_tables, _use_upsample
from ..hevc.device_recon import wave_rows

KINDS = ("n", "cfl", "fi")    # a normal job, a CfL job, a filter-intra job
_MODES = list(range(13))      # DC .. PAETH (tables.py)


class Synthetic(NamedTuple):
    """``cuda_fast.intra_waves(buf, groups, rows, **kw)``'s arguments."""
    buf: torch.Tensor
    groups: List[WaveGroup]
    rows: torch.Tensor
    kw: dict


def _normal_params(rng, tw, th, edge_filter, cfl, dr):
    ha, hl = int(rng.integers(0, 2)), int(rng.integers(0, 2))
    mode = T.DC_PRED if cfl else int(rng.choice(_MODES))
    p = dict(mode=mode, wv=tw, hv=th, have_above=ha, have_left=hl)
    if mode in T.MODE_TO_ANGLE:
        pa = T.MODE_TO_ANGLE[mode] + 3 * int(rng.integers(-3, 4))
        filt = int(rng.integers(0, 2))
        p["p_angle"] = pa
        if edge_filter and pa not in (90, 180):
            if 90 < pa < 180 and tw + th >= 24:
                p["cornerf"] = 1
            if ha:
                p["str_a"] = _edge_filter_strength(tw, th, pa - 90, filt)
                p["na_f"] = tw + (th if pa < 90 else 0) + 1
            if hl:
                p["str_l"] = _edge_filter_strength(tw, th, pa - 180, filt)
                p["nl_f"] = th + (tw if pa > 180 else 0) + 1
        if edge_filter:
            p["ups_a"] = _use_upsample(tw, th, pa - 90, filt) if ha else 0
            p["ups_l"] = _use_upsample(tw, th, pa - 180, filt) if hl else 0
        p["dx"] = int(dr[pa]) if 0 < pa < 90 else \
            int(dr[180 - pa]) if 90 < pa < 180 else 0
        p["dy"] = int(dr[pa - 90]) if 90 < pa < 180 else \
            int(dr[270 - pa]) if 180 < pa < 270 else 0
    if cfl:
        p.update(is_cfl=1, cfl_alpha=int(rng.integers(-16, 17)))
    return p


def synthetic(pictures: Sequence[Sequence[Sequence[Tuple[str, int, int]]]],
              *, seed: int, bd: int = 8, ssx: int = 1, ssy: int = 1,
              edge_filter: bool = True, luma: Tuple[int, int] = (96, 96),
              device="cpu") -> Synthetic:
    """``pictures[t][w]``: the jobs of wave w of picture t, each (kind,
    tw, th) with kind in KINDS (filter intra and CfL at most 32x32)."""
    rng = np.random.default_rng(seed)
    _sm, dr = _pred_tables()
    lh, lw = luma
    ref = lh * lw
    maxv = (1 << bd) - 1
    n_waves = max(len(p) for p in pictures)
    jobs = []                    # (group key, wave, picture, params)
    out = ref
    for t, waves in enumerate(pictures):
        for w, wave in enumerate(waves):
            for kind, tw, th in wave:
                if kind not in KINDS:
                    raise ValueError(f"job kind {kind!r} not in {KINDS}")
                sq = max(tw, th)
                if kind == "fi":
                    p = dict(fi_mode=int(rng.integers(0, 5)), wv=tw, hv=th)
                else:
                    p = _normal_params(rng, tw, th, edge_filter,
                                       kind == "cfl", dr)
                ly, lx = int(rng.integers(0, lh)), int(rng.integers(0, lw))
                sy_, sx_ = (2 if ssy else 1), (2 if ssx else 1)
                # the visible part: the whole box, or cut by the frame
                hh, ww = (v if rng.random() < 0.7 else
                          int(rng.integers(1, v + 1)) for v in (th, tw))
                p.update(
                    dst=out, pw=sq, hh=hh, ww=ww, ly=ly, lx=lx, lbase=0,
                    bh=min(th, (lh - ly + sy_ - 1) // sy_),
                    bw=min(tw, (lw - lx + sx_ - 1) // sx_))
                out += sq * sq
                jobs.append(((kind == "fi", sq), w, t, p))
    buf = np.zeros(out + 1, np.int64)
    buf[:ref] = rng.integers(0, maxv + 1, ref)
    keys = sorted({k for k, *_ in jobs}, key=lambda k: (not k[0], -k[1]))
    groups, rows = [], []
    for fi, sq in keys:
        sel = [j for j in jobs if j[0] == (fi, sq)]
        sel.sort(key=lambda j: (j[1], j[2]))       # by wave, then picture
        n = len(sel)
        la = sq if fi else 2 * sq + 7

        def indices(shape):
            idx = rng.integers(0, ref, shape)
            sent = rng.random(shape) < 0.1
            return np.where(sent, rng.integers(-3, 0, shape), idx)
        params = np.array([[j[3].get(c, 0) for c in PARAM_COLS]
                           for j in sel], np.int64).reshape(n, len(PARAM_COLS))
        res = rng.integers(-300, 301, (n, sq, sq))

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int32)).to(device)
        groups.append(WaveGroup(fi, sq, dev(indices((n, la))),
                                dev(indices((n, la))), dev(indices((n,))),
                                dev(params), dev(res)))
        rows.append(wave_rows(np.array([j[1] for j in sel]),
                              np.array([j[2] for j in sel]), n_waves,
                              len(pictures)))
    kw = dict(bd=bd, edge_filter=edge_filter, ssx=ssx, ssy=ssy,
              luma_shape=(lh, lw))
    return Synthetic(torch.from_numpy(buf.astype(np.int32)).to(device),
                     groups, torch.from_numpy(np.stack(rows)).to(device), kw)


def mixed_wave(big: int = 1, small: int = 60) -> List[Tuple[str, int, int]]:
    """A wave of ``big`` 64x64 luma jobs among ``small`` 4x4 jobs."""
    return [("n", 64, 64)] * big + [("n", 4, 4)] * small


def wave_heavy(seed: int, device="cpu") -> Synthetic:
    """Two pictures whose waves mix 64x64 jobs with filter-intra jobs up
    to 32x32, CfL jobs and many 4x4 jobs; some waves take more shared
    memory than av1_intra_wave holds at once, so it splits them."""
    w0 = mixed_wave(2, 40) + [("fi", 32, 32)] * 6 + [("fi", 8, 4)] * 10
    w1 = [("fi", 32, 32)] * 20 + [("cfl", 32, 32)] * 20 + \
        [("n", 64, 64)] * 4 + [("n", 32, 16), ("n", 16, 64)] * 8
    w2 = [("n", 4, 4)] * 150 + [("fi", 16, 16)] * 12 + [("cfl", 8, 8)] * 12
    return synthetic([[w0, w1, w2], [w1, w0]], seed=seed, device=device)
