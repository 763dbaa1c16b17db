"""HEVC reconstruction on the device, for a batch of intra pictures or
one P or B picture.

Counterpart of libheif_tpu/codecs/hevc/device_recon.py (intra) and of
the host reconstruction of P and B pictures (recon.py
IntraReconstructor.run with references, filters.py Deblocker).  Entropy
decoding stays on the host (native_parse, or ctu.SliceParser for P and
B pictures); everything after it runs on the plan's device in the JAX
program's four stages:

  stage A  dequant + inverse transforms   kernel hevc_dequant_itx, one
                                          launch for every TU group
                                          (size and plane); scaling
                                          lists through per-TU slots of
                                          one factor table
  stage B  intra prediction + recon       kernel hevc_intra_wave, one
                                          launch: each picture walks its
                                          dependency waves (every TU
                                          whose reference samples are
                                          reconstructed) on its own
  stage C  deblocking                     plain PyTorch, dense passes
                                          over the 8-sample edge lattice
  stage D  SAO                            plain PyTorch, per-CTB
                                          parameters broadcast to pixels

Bit-exact against the JAX package's device engine: int32 arithmetic
with HEVC's arithmetic shifts.  The picture axis is a batch axis, so the
tiles of a grid decode as one batch; the JAX program walks their waves in
lockstep, the kernel each picture's on its own (a TU reads samples of its
own picture only), and the plain version in lockstep.

A P or B picture adds three steps before stage B (``InterPlan``): kernel
hevc_inter_pred predicts every PU from the DPB's reference slots into the
picture's buffers (span hevc.mc), stage A's second launch gives the inter
TUs' residuals (the DCT at 4x4 luma too), and a plain scatter adds them
and clips (span hevc.residual).  Stage B then runs the intra TUs only: the
planner counts every 4x4 of an inter CU as reconstructed before wave 0,
as the JAX reconstructor's CU-order walk (recon.py:438-454) has an intra
TU read its inter neighbours after their residual.  Stage C takes the
motion rule of the boundary strength and the prediction-block edges
(filters.py ``_bs`` :82-115, ``_is_block_edge`` :40).

The plan differs from the JAX one in what jit forced on it: its tables
carry no padding (rows ``[:n]`` and waves ``[:n_waves]`` equal the JAX
tables), and each group's rows of a (wave, picture) come from a
(n_waves, T+1) table of starts built on the host from the planner's
waves and copied once.  The per-row tables (reference and scatter
indices, coefficients, the wave sort) are built on the plan's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._build import HOST_LIBRARY, resolve_device
from ...core.trace import span
from .ctu import SliceSyntax
from .cuda_fast import (MTAB_SIDE, ItxGroup, WaveGroup, dequant_itx,
                        inter_jobs, inter_pred, intra_waves)
from .filters import BETA_TABLE, TC_TABLE
from .headers import effective_scaling_factors
from .tables import chroma_qp

# group keys: (is_luma, log2). DST-VII applies to the (True, 2) group.
GROUP_KEYS = [(True, 2), (True, 3), (True, 4), (True, 5),
              (False, 2), (False, 3), (False, 4)]

AVAIL_STRIDE = 4 * 32 + 1        # ref array length of the largest TU

# in-order ref coordinate offsets per TU size: left column bottom→top,
# corner, top row (recon.py:_gather_refs)
_REF_DX: Dict[int, np.ndarray] = {}
_REF_DY: Dict[int, np.ndarray] = {}
for _n in (4, 8, 16, 32):
    _i = np.arange(2 * _n)
    _REF_DX[_n] = np.concatenate(
        [np.full(2 * _n, -1), [-1], _i]).astype(np.int32)
    _REF_DY[_n] = np.concatenate(
        [2 * _n - 1 - _i, [-1], np.full(2 * _n, -1)]).astype(np.int32)


@dataclass
class GroupPlan:
    """One TU group (plane and size), rows sorted by wave (stable, so
    ties keep picture then decode order).  Tensors on the plan's device;
    ``wave_rows`` (n_waves, T+1) on the host: the rows of wave w and
    picture t are wave_rows[w, t] .. wave_rows[w, t+1]."""
    key: Tuple[bool, int]
    n: int
    coeffs: torch.Tensor     # (n, s, s) int32
    qp: torch.Tensor         # (n,) int32
    ts: torch.Tensor         # (n,) bool   transform skip
    tqb: torch.Tensor        # (n,) bool   transquant bypass
    mslot: torch.Tensor      # (n,) int32  scaling-factor slot, 0 = flat
    mode: torch.Tensor       # (n,) int32
    ref_idx: torch.Tensor    # (n, 4s+1) int32 flat gather indices
    ref_avail: torch.Tensor  # (n, 4s+1) bool
    scat_idx: torch.Tensor   # (n, s*s) int32 flat scatter indices
    wave_rows: np.ndarray    # (n_waves, T+1) int32

    @property
    def starts(self) -> np.ndarray:
        """(n_waves,) the first row of each wave."""
        return self.wave_rows[:, 0]

    @property
    def counts(self) -> np.ndarray:
        """(n_waves,) the rows of each wave, all pictures."""
        return self.wave_rows[:, -1] - self.wave_rows[:, 0]


@dataclass
class InterPlan:
    """The inter part of a P or B picture's plan: ``jobs`` (n, 10) int32
    hevc_inter_pred's jobs on the plan's device, the inter TUs' stage-A
    groups (``inter`` set) with each group's flat scatter indices ``scat``
    (n, s*s) into the luma or chroma buffer, and their scaling-factor
    table ``mtab`` (the inter matrices), or None."""
    jobs: torch.Tensor
    groups: List[ItxGroup]
    scat: List[torch.Tensor]
    mtab: Optional[torch.Tensor]


@dataclass
class ReconPlan:
    t: int                          # batch (picture) count
    width: int
    height: int
    bd: int
    strong_smoothing: bool
    n_waves: int
    groups: List[GroupPlan]
    wave_rows: torch.Tensor    # (G, n_waves, T+1) int32, the groups' tables
    mtab: Optional[torch.Tensor]   # (slots, 32, 32) uint8; None: all flat
    deblock: Optional[Dict[str, torch.Tensor]]   # None: off everywhere
    # None: no CTB uses SAO; the maps on the device, "ctb" an int
    sao: Optional[Dict[str, object]]
    tqb_mask: Optional[torch.Tensor]             # (t, h4, w4) bool
    device: torch.device
    inter: Optional[InterPlan] = None    # a P or B picture's (batch of 1)


def plan_waves(cols: np.ndarray, W: int, H: int,
               slice_map: Optional[np.ndarray] = None):
    """Wave index and reference availability (N, AVAIL_STRIDE) of every
    TU, by host/hevc_plan.cc; ``slice_map`` (the picture's slice index
    per 4x4, SliceSyntax.slice_map4) makes a sample of another slice
    unavailable, None means one slice."""
    import ctypes
    fn = HOST_LIBRARY.load().tpuheif_hevc_plan
    fn.restype = ctypes.c_int
    N = len(cols)
    waves = np.zeros(N, np.int32)
    avail = np.zeros((N, AVAIL_STRIDE), np.uint8)
    cols_c = np.ascontiguousarray(cols, np.int32)
    sm = None if slice_map is None else \
        np.ascontiguousarray(slice_map, np.int16)
    if sm is not None and (sm.shape[0] * 4 < H or sm.shape[1] * 4 < W):
        raise ValueError(f"slice map {sm.shape} smaller than {W}x{H}")
    rc = fn(ctypes.c_void_p(cols_c.ctypes.data), ctypes.c_int64(N),
            ctypes.c_int32(cols_c.shape[1]), ctypes.c_int32(W),
            ctypes.c_int32(H), ctypes.c_void_p(waves.ctypes.data),
            ctypes.c_void_p(avail.ctypes.data), ctypes.c_int32(AVAIL_STRIDE),
            ctypes.c_void_p(None if sm is None else sm.ctypes.data),
            ctypes.c_int32(0 if sm is None else sm.shape[1]))
    if rc != 0:
        raise RuntimeError(f"tpuheif_hevc_plan failed ({rc})")
    return waves, avail


def plan_inputs(raw_tus: Sequence[tuple], W: int, H: int,
                slice_maps: Optional[Sequence] = None
                ) -> Dict[str, np.ndarray]:
    """The host part of a plan: the wave planner over each picture (with
    its slice map, if any: ``slice_maps[t]``, None for one slice), and
    the batch's TU columns, picture index, waves, availability (packed to
    bits) and coefficients concatenated into flat arrays, the coefficient
    offsets moved to the joined buffer (which ends with a zero).  The
    rows of inter CUs (mode -1, ``inter_split``) take part in the
    planning and are then dropped."""
    cols_l, tile_l, waves_l, avail_l, offs_l, coeff_l = [], [], [], [], [], []
    pos = 0
    for t_idx, (cols, coeff, offs) in enumerate(raw_tus):
        waves, avail = plan_waves(
            cols, W, H, None if slice_maps is None else slice_maps[t_idx])
        keep = cols[:, 4] >= 0          # inter CU rows (mode -1) go
        if not keep.all():
            cols, offs = cols[keep], offs[keep]
            waves, avail = waves[keep], avail[keep]
        cols_l.append(cols)
        tile_l.append(np.full(len(cols), t_idx, np.int32))
        waves_l.append(waves)
        avail_l.append(np.packbits(avail, axis=1))
        offs_l.append(np.where(offs >= 0, offs + pos, -1))
        coeff_l.append(coeff)
        pos += len(coeff)
    return dict(cols=np.concatenate(cols_l), tile=np.concatenate(tile_l),
                waves=np.concatenate(waves_l),
                avail_bits=np.concatenate(avail_l),
                offs=np.concatenate(offs_l),
                coeff=np.concatenate(coeff_l + [np.zeros(1, np.int32)]))


class BatchMismatch(ValueError):
    """The pictures of a batch differ in a field the plan takes batch-wide
    (``batch_key``)."""


def batch_key(sps) -> tuple:
    """The SPS fields a plan takes from its first picture for the whole
    batch: the picture size and bit depth (buffers, clips, filter
    strengths), the CTB size (the SAO parameter maps) and strong intra
    smoothing (stage B).  Pictures batch together only where these agree;
    every other field is read per picture.  (The port decodes 4:2:0 with
    equal luma and chroma depths only, so those need no key.)"""
    return (sps.pic_width, sps.pic_height, sps.bit_depth_luma, sps.ctb_size,
            bool(sps.strong_intra_smoothing))


def wave_rows(waves: np.ndarray, tiles: np.ndarray, n_waves: int,
              T: int) -> np.ndarray:
    """(n_waves, T+1) int32 row ranges of one group whose rows are sorted
    by wave, stable: its rows in picture order (tile ascending), so those
    of wave w and picture t are rows [r[w, t], r[w, t+1]), and r[w, T] is
    r[w+1, 0]."""
    cnt = np.bincount(waves.astype(np.int64) * T + tiles,
                      minlength=n_waves * T).reshape(n_waves, T)
    out = np.zeros((n_waves, T + 1), np.int64)
    out[:, 1:] = np.cumsum(cnt.ravel()).reshape(n_waves, T)
    out[1:, 0] = out[:-1, T]
    return out.astype(np.int32)


# a picture's ten factor-table slots with scaling lists: matrixId = c_idx
# 0-2 at 4x4 to 16x16, then luma 32x32 (of an inter TU: matrixId c_idx + 3)
_SLOT_KEYS = [(lg, c) for lg in (2, 3, 4) for c in (0, 1, 2)] + [(5, 0)]


def scaling_slots(syntaxes: Sequence[SliceSyntax], inter: bool = False):
    """The plan's scaling-factor table and each picture's first slot:
    (mtab (slots, 32, 32) uint8 or None, base (T,) int64).  Slot 0 is the
    flat 16; each distinct set of ScalingFactor matrices in the batch
    (effective_scaling_factors) adds ten slots, in _SLOT_KEYS order, each
    matrix m[y][x] in the top left of its slot: the intra matrices, or
    with ``inter`` the inter ones (matrixId + 3).  A picture without lists
    has base 0; a TU's slot is base + its key's index, or 0."""
    base = np.zeros(len(syntaxes), np.int64)
    sets: Dict[bytes, int] = {}
    tabs = [np.full((1, MTAB_SIDE, MTAB_SIDE), 16, np.uint8)]
    for t, syn in enumerate(syntaxes):
        f = effective_scaling_factors(syn.sps, syn.pps)
        if f is None:
            continue
        slots = np.zeros((len(_SLOT_KEYS), MTAB_SIDE, MTAB_SIDE), np.uint8)
        for i, (lg, c) in enumerate(_SLOT_KEYS):
            m = np.asarray(f[lg - 2][c + 3 * inter])
            slots[i, :m.shape[0], :m.shape[1]] = m
        key = slots.tobytes()
        if key not in sets:
            sets[key] = 1 + len(_SLOT_KEYS) * (len(tabs) - 1)
            tabs.append(slots)
        base[t] = sets[key]
    if not sets:
        return None, base
    return np.concatenate(tabs), base


def tu_slots(cols: np.ndarray, tiles: np.ndarray, base: np.ndarray
             ) -> np.ndarray:
    """(N,) int32 factor-table slot of each TU row (log2 in column 2,
    c_idx in column 3) of the pictures ``tiles``, from scaling_slots'
    ``base``."""
    key = np.full((6, 3), -1, np.int64)
    for i, (lg, c) in enumerate(_SLOT_KEYS):
        key[lg, c] = i
    k = key[cols[:, 2], cols[:, 3]]
    b = base[tiles]
    if ((b > 0) & (k < 0)).any():
        raise ValueError("a TU size and plane without a scaling list")
    return np.where(b > 0, b + k, 0).astype(np.int32)


def inter_split(syn: SliceSyntax, raw: tuple):
    """A P or B picture's TUs (raw, the Python parser's in the C++
    parser's columns, ctu.raw_tus) in two parts: the planner's rows in
    decode order, each intra CU's TUs and, in place of each inter CU's,
    one row for the CU (x, y, its log2, luma, mode -1, no residual); and
    the inter CUs' TUs (their residuals, added before stage B)."""
    cols, coeff, offs = raw
    rows, marks, inter = [], [], []
    for cu in syn.cus:
        if cu.inter:
            rows.append(-1 - len(marks))
            marks.append((cu.x, cu.y, cu.log2, 0, -1, 0, 0, 0))
            inter.extend(range(cu.tu_start, cu.tu_end))
        else:
            rows.extend(range(cu.tu_start, cu.tu_end))
    rows = np.asarray(rows, np.int64)
    marks = np.asarray(marks, np.int32).reshape(-1, cols.shape[1])
    src = np.concatenate([cols, marks])
    pick = np.where(rows >= 0, rows, len(cols) - 1 - rows)
    o = np.concatenate([offs, np.full(len(marks), -1, np.int64)])
    inter = np.asarray(inter, np.int64)
    return ((np.ascontiguousarray(src[pick], np.int32), coeff, o[pick]),
            (np.ascontiguousarray(cols[inter], np.int32), coeff,
             offs[inter]))


def pu_table(syn: SliceSyntax, slots_l0: Sequence[int],
             slots_l1: Sequence[int]) -> np.ndarray:
    """Every PU of a P or B picture as a row (n, 10) int32 [x y w h slot0
    mv0x mv0y slot1 mv1x mv1y]: the DPB slot of each list's reference
    (``slots_l0[ref_idx]``), -1 for an unused list."""
    rows = [(pu.x, pu.y, pu.w, pu.h,
             slots_l0[pu.ref_idx] if pu.ref_idx >= 0 else -1, *pu.mv,
             slots_l1[pu.ref_idx1] if pu.ref_idx1 >= 0 else -1, *pu.mv1)
            for cu in syn.cus if cu.inter for pu in cu.pus]
    return np.asarray(rows, np.int32).reshape(-1, 10)


def build_plan(syntaxes: Sequence[SliceSyntax], raw_tus: Sequence[tuple],
               device=None, ref_slots=None) -> ReconPlan:
    """Wavefront schedule and TU tables for a batch of pictures that agree
    on ``batch_key`` (else BatchMismatch).  raw_tus: per picture (cols,
    coeff_buf, offs) from decoder.parse_picture, or for a P or B picture
    (a batch of one) from ctu.raw_tus, with ``ref_slots`` (the DPB slot of
    each entry of list 0, of list 1).  Spans: hevc.plan, split into
    hevc.plan.host (planner, slots, filter maps), hevc.plan.copies (host
    to device) and hevc.plan.tables (the groups' tables, built on the
    device)."""
    with span("hevc.plan"):
        return _build_plan(syntaxes, raw_tus, device, ref_slots)


def _build_plan(syntaxes, raw_tus, device, ref_slots=None) -> ReconPlan:
    dev = resolve_device(device)
    sps0 = syntaxes[0].sps
    W, H = sps0.pic_width, sps0.pic_height
    bd = sps0.bit_depth_luma
    T = len(syntaxes)
    key = batch_key(sps0)
    for syn in syntaxes:
        if batch_key(syn.sps) != key:
            raise BatchMismatch(
                f"batch pictures must agree on (width, height, bit depth, "
                f"CTB size, strong smoothing): {batch_key(syn.sps)} vs {key}")
    inter = None
    if any(syn.has_inter for syn in syntaxes):
        if T != 1 or ref_slots is None:
            raise ValueError("a P or B picture plans alone, with the DPB "
                             "slots of its references")
        with span("hevc.plan.host"):
            raw0, raw_inter = inter_split(syntaxes[0], raw_tus[0])
            raw_tus = [raw0]
            jobs = inter_jobs(pu_table(syntaxes[0], *ref_slots))
        inter = _inter_plan(syntaxes[0], raw_inter, jobs, W, H, dev)
    with span("hevc.plan.host"):
        inp = plan_inputs(raw_tus, W, H, [
            syn.slice_map4 if len(syn.slice_headers) > 1 else None
            for syn in syntaxes])
        mtab, base = scaling_slots(syntaxes)
        inp["mslot"] = tu_slots(inp["cols"], inp["tile"], base)
        deblock = _build_deblock_params(syntaxes, W, H, bd)
        sao, tqb_mask = _build_sao_params(syntaxes, W, H)
    cols, waves, tiles = inp["cols"], inp["waves"], inp["tile"]
    n_waves = int(waves.max()) + 1 if len(waves) else 1
    c_idx, log2c = cols[:, 3], cols[:, 2]

    # device: the columns, coefficients, slots and packed availability,
    # once
    with span("hevc.plan.copies"):
        d = {k: torch.from_numpy(v).to(dev) for k, v in inp.items()}
    cols_d, tile_d, waves_d = d["cols"], d["tile"], d["waves"]
    avail_bits, offs_d, coeff_d = d["avail_bits"], d["offs"], d["coeff"]
    with span("hevc.plan.tables"):
        groups = _group_tables(
            W, H, T, n_waves, c_idx, log2c, waves, tiles, cols_d, tile_d,
            waves_d, avail_bits, offs_d, coeff_d, d["mslot"], dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    with span("hevc.plan.copies"):
        return ReconPlan(
            t=T, width=W, height=H, bd=bd,
            strong_smoothing=bool(sps0.strong_intra_smoothing),
            n_waves=n_waves, groups=groups,
            wave_rows=put(np.stack([g.wave_rows for g in groups])
                          if groups else
                          np.zeros((0, n_waves, T + 1), np.int32)),
            mtab=None if mtab is None else put(mtab),
            deblock=None if deblock is None else
            {k: put(v) for k, v in deblock.items()},
            # the CTB size stays on the host: stage D reads it, and a
            # read from the device would wait for the plan's launches
            sao=None if sao is None else
            {k: int(v) if k == "ctb" else put(v) for k, v in sao.items()},
            tqb_mask=None if tqb_mask is None else put(tqb_mask).bool(),
            device=dev, inter=inter)


def _inter_plan(syn, raw, jobs, W, H, dev) -> InterPlan:
    """The inter TUs' stage-A groups (by plane and size, in decode order)
    and scatter indices, and the PU jobs, on ``dev``."""
    cols, coeff, offs = raw
    with span("hevc.plan.host"):
        mtab, base = scaling_slots([syn], inter=True)
        mslot = tu_slots(cols, np.zeros(len(cols), np.int64), base)
    with span("hevc.plan.copies"):
        jobs_d = torch.from_numpy(jobs).to(dev)
        coeff_d = torch.from_numpy(
            np.concatenate([coeff, np.zeros(1, np.int32)])).to(dev)
        mtab_d = None if mtab is None else torch.from_numpy(mtab).to(dev)
    cw, ch = W >> 1, H >> 1
    groups, scat = [], []
    with span("hevc.plan.tables"):
        for luma, lg in GROUP_KEYS:
            sel = np.nonzero(((cols[:, 3] == 0) == luma) &
                             (cols[:, 2] == lg))[0]
            if len(sel) == 0:
                continue
            s = 1 << lg
            c = torch.from_numpy(cols[sel].astype(np.int64)).to(dev)
            off = torch.from_numpy(offs[sel]).to(dev)
            ii = torch.arange(s * s, device=dev)
            cf = coeff_d[torch.where(off >= 0, off, 0)[:, None] + ii[None]]
            cf = torch.where((off >= 0)[:, None], cf, 0).reshape(-1, s, s)
            if luma:
                px, py, pw, ph, base = c[:, 0], c[:, 1], W, H, 0
            else:
                px, py, pw, ph = c[:, 0] >> 1, c[:, 1] >> 1, cw, ch
                base = (c[:, 3] - 1) * ch * cw
            sx = px[:, None] + (ii % s)[None]
            sy = py[:, None] + (ii // s)[None]
            trash = H * W if luma else 2 * ch * cw
            idx = torch.where((sx < pw) & (sy < ph),
                              (base if luma else base[:, None]) + sy * pw
                              + sx, trash)
            groups.append(ItxGroup(
                luma, lg, cf.to(torch.int32).contiguous(),
                c[:, 5].to(torch.int32), c[:, 6] != 0, c[:, 7] != 0,
                torch.from_numpy(mslot[sel]).to(dev), inter=True))
            scat.append(idx.reshape(-1))
    return InterPlan(jobs=jobs_d, groups=groups, scat=scat, mtab=mtab_d)


def _group_tables(W, H, T, n_waves, c_idx, log2c, waves, tiles, cols_d,
                  tile_d, waves_d, avail_bits, offs_d, coeff_d, mslot_d,
                  dev) -> List[GroupPlan]:
    """Each TU group's tables (GroupPlan), built on the plan's device from
    the copied columns."""
    cw, ch = W >> 1, H >> 1
    y_plane_sz = H * W
    c_plane_sz = ch * cw
    trash_y = T * y_plane_sz          # one extra slot at the end
    trash_c = T * 2 * c_plane_sz

    groups: List[GroupPlan] = []
    for key in GROUP_KEYS:
        luma, lg = key
        sel = np.nonzero(((c_idx == 0) == luma) & (log2c == lg))[0]
        if len(sel) == 0:
            continue
        s = 1 << lg
        L = 4 * s + 1
        rows = wave_rows(waves[sel], tiles[sel], n_waves, T)

        sel_d = torch.from_numpy(sel).to(dev)
        order = torch.sort(waves_d[sel_d], stable=True).indices
        idx = sel_d[order]
        c = cols_d[idx].to(torch.int64)
        tile = tile_d[idx].to(torch.int64)
        if luma:
            px, py, pw, ph = c[:, 0], c[:, 1], W, H
            base = tile * y_plane_sz
            trash = trash_y
        else:
            px, py, pw, ph = c[:, 0] >> 1, c[:, 1] >> 1, cw, ch
            base = tile * 2 * c_plane_sz + (c[:, 3] - 1) * c_plane_sz
            trash = trash_c

        xs = px[:, None] + torch.from_numpy(_REF_DX[s]).to(dev)[None, :]
        ys = py[:, None] + torch.from_numpy(_REF_DY[s]).to(dev)[None, :]
        cxs = torch.clamp(xs, 0, pw - 1)
        cys = torch.clamp(ys, 0, ph - 1)
        bit = torch.arange(L, device=dev)
        av = ((avail_bits[idx][:, bit >> 3] >> (7 - (bit & 7))) & 1).bool()
        ridx = torch.where(av, base[:, None] + cys * pw + cxs, 0)

        ii = torch.arange(s * s, device=dev)
        sx = px[:, None] + (ii % s)[None, :]
        sy = py[:, None] + (ii // s)[None, :]
        s_in = (sx < pw) & (sy < ph)
        scat = torch.where(s_in, base[:, None] + sy * pw + sx, trash)

        off = offs_d[idx]
        has = off >= 0
        gidx = torch.where(has, off, 0)[:, None] + ii[None, :]
        cf = coeff_d[torch.clamp(gidx, max=coeff_d.numel() - 1)]
        cf = torch.where(has[:, None], cf, 0).reshape(-1, s, s)

        groups.append(GroupPlan(
            key=key, n=len(sel), coeffs=cf.to(torch.int32),
            qp=c[:, 5].to(torch.int32), ts=c[:, 6] != 0, tqb=c[:, 7] != 0,
            mslot=mslot_d[idx], mode=c[:, 4].to(torch.int32),
            ref_idx=ridx.to(torch.int32), ref_avail=av,
            scat_idx=scat.to(torch.int32), wave_rows=rows))
    return groups


# ---------------------------------------------------------------- deblock

_CHROMA_QP_TABLE = np.array([chroma_qp(i) for i in range(58)], np.int32)


def _build_deblock_params(syntaxes, W, H, bd):
    """Per-edge-segment beta/tc/enabled arrays (the filter decisions that
    depend only on the parse maps, not on pixels), vectorised over the
    (segment, edge) lattice; beta and tc scale with the bit depth (spec
    8.7.2.5.3).  Counterpart of device_recon.py:346-446, per slice: each
    segment takes the offsets and slice_deblocking_filter_disabled_flag of
    the slice that holds q0, and an edge on a slice boundary is off where
    that slice's slice_loop_filter_across_slices_enabled_flag is 0 (q0's
    slice is the later of the two: a slice's left and upper neighbours
    come before it).  Where a picture has transquant-bypass CUs the maps
    also carry ``bp_*``/``bq_*``: the segment's p0 or q0 lies in a bypass
    CU, whose samples the filter leaves as they are (nDp = 0, nDq = 0,
    spec 8.7.2.5.7).  In a P or B picture the prediction-block edges are
    edges too, and a segment's boundary strength follows the motion rule
    (``boundary_strength``): tc comes from qp + 2(bS - 1), bS 0 leaves
    the segment alone, and chroma filters bS 2 only."""
    if all(h.deblocking_filter_disabled
           for syn in syntaxes for h in syn.slice_headers):
        return None
    T = len(syntaxes)
    cw, ch = W >> 1, H >> 1

    # luma vertical:  edges x=8,16,..,≤W-4  segments y=0,4,..
    # (pic luma dims are multiples of 8; chroma dims only of 4, so the
    # chroma edge count is len(range(8, d, 8)) = (d-1)//8)
    ev = max(0, (W - 4) // 8)
    sv = H // 4
    eh = max(0, (H - 4) // 8)
    sh_ = W // 4
    cev = max(0, (cw - 1) // 8)
    csv = ch // 4
    ceh = max(0, (ch - 1) // 8)
    csh = cw // 4

    out = dict(
        beta_v=np.zeros((T, sv, ev), np.int32),
        tc_v=np.zeros((T, sv, ev), np.int32),
        en_v=np.zeros((T, sv, ev), bool),
        beta_h=np.zeros((T, sh_, eh), np.int32),
        tc_h=np.zeros((T, sh_, eh), np.int32),
        en_h=np.zeros((T, sh_, eh), bool),
        ctc_v=np.zeros((T, 2, csv, cev), np.int32),
        cen_v=np.zeros((T, 2, csv, cev), bool),
        ctc_h=np.zeros((T, 2, csh, ceh), np.int32),
        cen_h=np.zeros((T, 2, csh, ceh), bool),
    )
    bypass = any(syn.tqb_map.any() for syn in syntaxes)
    if bypass:
        for k, shape in (("v", (T, sv, ev)), ("h", (T, sh_, eh)),
                         ("cv", (T, csv, cev)), ("ch", (T, csh, ceh))):
            out["bp_" + k] = np.zeros(shape, bool)
            out["bq_" + k] = np.zeros(shape, bool)

    for t, syn in enumerate(syntaxes):
        multi = len(syn.slice_headers) > 1
        if not multi and syn.sh.deblocking_filter_disabled:
            continue
        qp_y = np.asarray(syn.qp_y, np.int32)
        tu4 = np.asarray(syn.tu_log2, np.int32)
        cu4 = np.asarray(syn.cu_log2, np.int32)
        tqb4 = np.asarray(syn.tqb_map) != 0
        if multi:       # the fields of the slice holding each 4x4
            sl4 = np.asarray(syn.slice_map4)
            off4 = ~syn.slice_field("deblocking_filter_disabled", bool)
            across4 = syn.slice_field("loop_filter_across_slices", bool)
            beta_off4 = syn.slice_field("beta_offset_div2") * 2
            tc_off4 = syn.slice_field("tc_offset_div2") * 2

        def offsets(x, y):
            """(beta, tc) offsets of q0's slice."""
            if multi:
                return beta_off4[y >> 2, x >> 2], tc_off4[y >> 2, x >> 2]
            return syn.sh.beta_offset_div2 * 2, syn.sh.tc_offset_div2 * 2

        inter = syn.has_inter

        def tu_edge(x, y, vertical):
            """filters.py:_is_tu_edge over coordinate arrays: a TU or CU
            boundary."""
            bx, by = x >> 2, y >> 2
            tl = tu4[by, bx]
            cl = cu4[by, bx]
            tl = np.where(tl == 0, np.where(cl != 0, cl, 3), tl)
            pos = x if vertical else y
            is_tu = (pos & ((1 << tl) - 1)) == 0
            is_cu = (cl != 0) & ((pos & ((1 << cl) - 1)) == 0)
            return is_tu | is_cu

        def bs_of(x, y, vertical):
            """Boundary strength of each segment: 2 in an intra picture."""
            if not inter:
                return np.full(x.shape, 2, np.int32)
            return boundary_strength(syn, x, y, vertical,
                                     tu_edge(x, y, vertical))

        def edge_mask(x, y, vertical):
            """filters.py:_is_block_edge over coordinate arrays (with the
            prediction-block edges of a P or B picture), and the slice
            rules of q0's slice."""
            bx, by = x >> 2, y >> 2
            edge = tu_edge(x, y, vertical)
            if inter:
                pu = syn.pu_vedge if vertical else syn.pu_hedge
                edge = edge | (pu[by, bx] != 0)
            if not multi:
                return edge
            px, py = (bx - 1, by) if vertical else (bx, by - 1)
            same = sl4[by, bx] == sl4[py, px]
            return edge & off4[by, bx] & (same | across4[by, bx])

        def sides(x, y, vertical):
            """(p0 in a bypass CU, q0 in a bypass CU)."""
            bx, by = x >> 2, y >> 2
            px, py = (bx - 1, by) if vertical else (bx, by - 1)
            return tqb4[py, px], tqb4[by, bx]

        def avg_qp(x, y, vertical):
            if vertical:
                return (qp_y[y >> 2, (x - 1) >> 2] +
                        qp_y[y >> 2, x >> 2] + 1) >> 1
            return (qp_y[(y - 1) >> 2, x >> 2] +
                    qp_y[y >> 2, x >> 2] + 1) >> 1

        for vertical, ne, ns, bkey, tkey, ekey, side in (
                (True, ev, sv, "beta_v", "tc_v", "en_v", "v"),
                (False, eh, sh_, "beta_h", "tc_h", "en_h", "h")):
            if ne == 0:
                continue
            pos = 8 * (np.arange(ne) + 1)[None, :]       # (1, E)
            seg = 4 * np.arange(ns)[:, None]             # (S, 1)
            x, y = (pos, seg) if vertical else (seg, pos)
            x = np.broadcast_to(x, (ns, ne))
            y = np.broadcast_to(y, (ns, ne))
            bs = bs_of(x, y, vertical)
            en = edge_mask(x, y, vertical) & (bs > 0)
            qp = avg_qp(x, y, vertical)
            boff, toff = offsets(x, y)
            beta = BETA_TABLE[np.clip(qp + boff, 0, 51)] << (bd - 8)
            tc = TC_TABLE[np.clip(qp + 2 * (bs - 1) + toff, 0, 53)] \
                << (bd - 8)
            out[bkey][t] = np.where(en, beta, 0)
            out[tkey][t] = np.where(en, tc, 0)
            out[ekey][t] = en
            if bypass:
                out["bp_" + side][t], out["bq_" + side][t] = \
                    sides(x, y, vertical)

        for vertical, ne, ns, tkey, ekey, side in (
                (True, cev, csv, "ctc_v", "cen_v", "cv"),
                (False, ceh, csh, "ctc_h", "cen_h", "ch")):
            if ne == 0:
                continue
            pos = 8 * (np.arange(ne) + 1)[None, :]
            seg = 4 * np.arange(ns)[:, None]
            cx, cy = (pos, seg) if vertical else (seg, pos)
            lx = np.broadcast_to(cx, (ns, ne)) << 1
            ly = np.broadcast_to(cy, (ns, ne)) << 1
            en = edge_mask(lx, ly, vertical) & (bs_of(lx, ly, vertical) == 2)
            qp_l = avg_qp(lx, ly, vertical)
            toff = offsets(lx, ly)[1]
            for ci, off in ((0, syn.pps.cb_qp_offset),
                            (1, syn.pps.cr_qp_offset)):
                qpc = _CHROMA_QP_TABLE[np.clip(qp_l + off, 0, 57)]
                tc = TC_TABLE[np.clip(qpc + 2 + toff, 0, 53)] << (bd - 8)
                en_c = en & (tc != 0)
                out[tkey][t, ci] = np.where(en_c, tc, 0)
                out[ekey][t, ci] = en_c
            if bypass:
                out["bp_" + side][t], out["bq_" + side][t] = \
                    sides(lx, ly, vertical)
    return out


def boundary_strength(syn: SliceSyntax, x, y, vertical: bool,
                      tu_edge) -> np.ndarray:
    """Boundary strength (spec 8.7.2.4; filters.py ``_bs`` :82-115) of
    the edge segments at luma (x, y) of a P or B picture, vectorised:
    2 where p0 or q0 is intra; else 1 on a TU edge (``tu_edge``) where
    either side has coded luma coefficients; else the motion rule
    (``_block_motion`` :66, ``_mv_far`` :79): 1 for a different number of
    motion vectors or other reference pictures, or a pair of vectors
    |dmv| >= 4 quarter samples apart (both pairings tried where both
    vectors point into one picture), else 0."""
    bx, by = x >> 2, y >> 2
    px, py = (bx - 1, by) if vertical else (bx, by - 1)

    def motion(yy, xx):
        """(count, first used (poc, mv), second (poc, mv)) per block; the
        first is list 0's where used, else list 1's."""
        out = []
        for refs, pocs, mvs in ((syn.ref_l0, syn.ref_pocs_l0, syn.mv_l0),
                                (syn.ref_l1, syn.ref_pocs_l1, syn.mv_l1)):
            r = refs[yy, xx].astype(np.int64)
            tab = np.asarray(list(pocs) + [-1], np.int64)
            poc = tab[np.where((r >= 0) & (r < len(pocs)), r, len(pocs))]
            out.append((r >= 0, poc, mvs[yy, xx]))
        (u0, p0, m0), (u1, p1, m1) = out
        first_p = np.where(u0, p0, p1)
        first_m = np.where(u0[..., None], m0, m1)
        return u0.astype(np.int32) + u1, (first_p, first_m), (p1, m1)

    def far(a, b):
        return (np.abs(a - b) >= 4).any(-1)

    np_, (pa, ma), (pb, mb) = motion(py, px)
    nq, (qa, na), (qb, nb) = motion(by, bx)
    one = np.where(pa != qa, 1, far(ma, na))
    same_set = (np.minimum(pa, pb) == np.minimum(qa, qb)) & \
        (np.maximum(pa, pb) == np.maximum(qa, qb))
    paired = np.where(qa == pa, far(ma, na) | far(mb, nb),
                      far(ma, nb) | far(mb, na))
    straight = ~(far(ma, na) | far(mb, nb))
    crossed = ~(far(ma, nb) | far(mb, na))
    two = np.where(~same_set, 1, np.where(
        pa != pb, paired, ~(straight | crossed)))
    mot = np.where(np_ != nq, 1, np.where(np_ == 1, one, two))
    intra = (syn.pred_inter[py, px] == 0) | (syn.pred_inter[by, bx] == 0)
    coded = tu_edge & ((syn.nonzero_y[py, px] != 0) |
                       (syn.nonzero_y[by, bx] != 0))
    return np.where(intra, 2, np.where(coded, 1, mot)).astype(np.int32)


# -------------------------------------------------------------------- sao

def _build_sao_params(syntaxes, W, H):
    """Per-CTB SAO parameter maps (T, 3, rows, cols) (offsets (T, 3, 4,
    rows, cols)) from the parser's per-CTB records, and the transquant
    bypass mask (T, h4, w4); counterpart of device_recon.py:451-481.
    Where a picture of several slices has a slice after the first with
    slice_loop_filter_across_slices_enabled_flag 0, the maps also carry
    ``slice`` (T, h4, w4), the slice index per 4x4, and ``across`` (T,
    slices) the slices' flags: an edge-offset neighbour in another slice
    leaves the sample alone when the later slice's flag is 0 (8.7.3)."""
    if not any(syn.sao_table is not None for syn in syntaxes):
        return None, None
    T = len(syntaxes)
    sps0 = syntaxes[0].sps
    ctb = sps0.ctb_size
    ncx = (W + ctb - 1) // ctb
    ncy = (H + ctb - 1) // ctb
    tab = np.zeros((T, ncy, ncx, 20), np.int32)
    for t, syn in enumerate(syntaxes):
        if syn.sao_table is not None:
            tab[t] = syn.sao_table
    tab = tab.transpose(0, 3, 1, 2)                     # (T, 20, ncy, ncx)
    sao = dict(typ=tab[:, 0:3], bpos=tab[:, 15:18],
               eoc=tab[:, [18, 19, 19]],
               offs=tab[:, 3:15].reshape(T, 3, 4, ncy, ncx),
               ctb=np.int32(ctb))
    if any(not h.loop_filter_across_slices
           for syn in syntaxes for h in syn.slice_headers[1:]):
        h4, w4 = (H + 3) // 4, (W + 3) // 4
        n = max(len(syn.slice_headers) for syn in syntaxes)
        sao["slice"] = np.stack([syn.slice_map4[:h4, :w4]
                                 for syn in syntaxes]).astype(np.int64)
        sao["across"] = np.ones((T, n), bool)
        for t, syn in enumerate(syntaxes):
            sao["across"][t, :len(syn.slice_headers)] = [
                h.loop_filter_across_slices for h in syn.slice_headers]
    tqb = None
    if any(syn.tqb_map.any() for syn in syntaxes):
        h4 = (H + 3) // 4
        w4 = (W + 3) // 4
        tqb = np.stack([syn.tqb_map[:h4, :w4] for syn in syntaxes])
    return sao, tqb


# ============================================================== the program

def deblock_luma_pass(plane, beta, tc, en, maxv, bp=None, bq=None):
    """Vertical-edge luma pass over a (T, H', W') int32 plane
    (device_recon.py:702-793); the horizontal pass is the same on the
    transposed plane.  beta/tc/en: (T, S, E) with S = H'//4 segments, E
    edges at x = 8(e+1); bp/bq (T, S, E) bool, or None: the p or q side
    of the segment is a transquant-bypass CU and keeps its samples."""
    t_, hh, ww = plane.shape
    E = en.shape[2]
    if E == 0:
        return plane
    S = hh // 4
    lines = plane[:, :, 4:4 + 8 * E].reshape(t_, S, 4, E, 8)
    # columns: [p3 p2 p1 p0 q0 q1 q2 q3]
    p = lines[..., [3, 2, 1, 0]]    # (..., 4) p0..p3
    q = lines[..., 4:]

    def dgrad(r):
        return (torch.abs(p[:, :, r, :, 2] - 2 * p[:, :, r, :, 1]
                          + p[:, :, r, :, 0]),
                torch.abs(q[:, :, r, :, 2] - 2 * q[:, :, r, :, 1]
                          + q[:, :, r, :, 0]))
    dp0, dq0 = dgrad(0)
    dp3, dq3 = dgrad(3)
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    d = dpq0 + dpq3                                       # (T, S, E)
    act = en & ~((beta == 0) & (tc == 0)) & (d < beta)

    def strong_cond(dpq, r):
        return ((2 * dpq < (beta >> 2)) &
                (torch.abs(p[:, :, r, :, 3] - p[:, :, r, :, 0]) +
                 torch.abs(q[:, :, r, :, 0] - q[:, :, r, :, 3])
                 < (beta >> 3)) &
                (torch.abs(p[:, :, r, :, 0] - q[:, :, r, :, 0])
                 < ((5 * tc + 1) >> 1)))
    strong = strong_cond(dpq0, 0) & strong_cond(dpq3, 3)

    tc4 = tc[:, :, None, :]                               # per line
    p0, p1, p2, p3 = (p[..., 0], p[..., 1], p[..., 2], p[..., 3])
    q0, q1, q2, q3 = (q[..., 0], q[..., 1], q[..., 2], q[..., 3])
    c2 = 2 * tc4

    def cl(base, v):
        return torch.clamp(v, base - c2, base + c2)
    sp0 = cl(p0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
    sp1 = cl(p1, (p2 + p1 + p0 + q0 + 2) >> 2)
    sp2 = cl(p2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
    sq0 = cl(q0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
    sq1 = cl(q1, (p0 + q0 + q1 + q2 + 2) >> 2)
    sq2 = cl(q2, (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)

    d_ep = (dp0 + dp3 < ((beta + (beta >> 1)) >> 3))
    d_eq = (dq0 + dq3 < ((beta + (beta >> 1)) >> 3))
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    line_on = torch.abs(delta) < tc4 * 10
    delta = torch.clamp(delta, -tc4, tc4)
    np0 = torch.clamp(p0 + delta, 0, maxv)
    nq0 = torch.clamp(q0 - delta, 0, maxv)
    tch = tc4 >> 1
    dp = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tch, tch)
    dq = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tch, tch)
    np1 = torch.clamp(p1 + dp, 0, maxv)
    nq1 = torch.clamp(q1 + dq, 0, maxv)

    ep4 = d_ep[:, :, None, :]
    eq4 = d_eq[:, :, None, :]
    n_p0 = torch.where(line_on, np0, p0)
    n_q0 = torch.where(line_on, nq0, q0)
    n_p1 = torch.where(line_on & ep4, np1, p1)
    n_q1 = torch.where(line_on & eq4, nq1, q1)

    st4 = strong[:, :, None, :]
    a4 = act[:, :, None, :]
    ap4 = a4 if bp is None else a4 & ~bp[:, :, None, :]
    aq4 = a4 if bq is None else a4 & ~bq[:, :, None, :]
    out = lines.clone()
    for col, v, on in ((1, torch.where(st4, sp2, p2), ap4),
                       (2, torch.where(st4, sp1, n_p1), ap4),
                       (3, torch.where(st4, sp0, n_p0), ap4),
                       (4, torch.where(st4, sq0, n_q0), aq4),
                       (5, torch.where(st4, sq1, n_q1), aq4),
                       (6, torch.where(st4, sq2, q2), aq4)):
        out[..., col] = torch.where(on, torch.clamp(v, 0, maxv),
                                    lines[..., col])
    res = plane.clone()
    res[:, :, 4:4 + 8 * E] = out.reshape(t_, hh, 8 * E)
    return res


def deblock_chroma_pass(plane, tc, en, maxv, bp=None, bq=None):
    """Vertical-edge chroma pass (device_recon.py:795-821); tc/en:
    (T, S, E); bp/bq as for deblock_luma_pass."""
    t_, hh, ww = plane.shape
    E = en.shape[2]
    if E == 0:
        return plane
    S = hh // 4
    need = 6 + 8 * E
    padw = max(0, need - ww)
    src = torch.nn.functional.pad(plane, (0, padw)) if padw else plane
    blocks = src[:, :, 6:need].reshape(t_, S, 4, E, 8)
    p1, p0, q0, q1 = (blocks[..., 0], blocks[..., 1], blocks[..., 2],
                      blocks[..., 3])
    tc4 = tc[:, :, None, :]
    delta = torch.clamp((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc4, tc4)
    a4 = en[:, :, None, :]
    ap4 = a4 if bp is None else a4 & ~bp[:, :, None, :]
    aq4 = a4 if bq is None else a4 & ~bq[:, :, None, :]
    out = blocks.clone()
    out[..., 1] = torch.where(ap4, torch.clamp(p0 + delta, 0, maxv), p0)
    out[..., 2] = torch.where(aq4, torch.clamp(q0 - delta, 0, maxv), q0)
    res = src.clone()
    res[:, :, 6:need] = out.reshape(t_, hh, 8 * E)
    return res[:, :, :ww] if padw else res


def sao_apply(src, typ, bpos, eoc, offs, ctb_sz, bd, slc=None, across=None):
    """SAO of one component (device_recon.py:825-866): src (T, h, w)
    int32; typ/bpos/eoc (T, ncy, ncx); offs (T, 4, ncy, ncx).  ``slc``
    (T, h, w) int64 slice index per sample and ``across`` (T, slices)
    bool, or None: an edge-offset neighbour in another slice whose later
    slice has slice_loop_filter_across_slices_enabled_flag 0 leaves the
    sample as it is (spec 8.7.3)."""
    t_, hh, ww = src.shape
    dev = src.device
    maxv = (1 << bd) - 1

    def rep(a):
        return a.repeat_interleave(ctb_sz, dim=-2) \
            .repeat_interleave(ctb_sz, dim=-1)[..., :hh, :ww]
    typ_p, bpos_p, eoc_p, offs_p = rep(typ), rep(bpos), rep(eoc), rep(offs)

    # band offset
    band = src >> (bd - 5)
    res_b = src
    for kq in range(4):
        match = band == ((bpos_p + kq) & 31)
        res_b = torch.where(match, src + offs_p[:, kq], res_b)

    # edge offset: 4 classes; neighbours through clamped (edge) indices
    yy = torch.arange(hh, device=dev)
    xx = torch.arange(ww, device=dev)

    def shifted(dy, dx, a=src):
        return a[:, torch.clamp(yy + dy, 0, hh - 1)][
            :, :, torch.clamp(xx + dx, 0, ww - 1)]

    def cut(dy, dx):
        """The neighbour at (dy, dx) is across a closed slice boundary."""
        ns = shifted(dy, dx, slc)
        later = torch.maximum(ns, slc).reshape(t_, -1)
        return (ns != slc) & ~torch.gather(across, 1, later).reshape(
            t_, hh, ww)
    eo_d = {0: ((0, -1), (0, 1)), 1: ((-1, 0), (1, 0)),
            2: ((-1, -1), (1, 1)), 3: ((-1, 1), (1, -1))}
    y2, x2 = yy[:, None], xx[None, :]
    res_e = src
    for cls, ((dy0, dx0), (dy1, dx1)) in eo_d.items():
        n1 = shifted(dy0, dx0)
        n2 = shifted(dy1, dx1)
        valid = ((y2 + dy0 >= 0) & (y2 + dy0 < hh) &
                 (y2 + dy1 >= 0) & (y2 + dy1 < hh) &
                 (x2 + dx0 >= 0) & (x2 + dx0 < ww) &
                 (x2 + dx1 >= 0) & (x2 + dx1 < ww))[None]
        if slc is not None:
            valid = valid & ~cut(dy0, dx0) & ~cut(dy1, dx1)
        eidx = 2 + torch.sign(src - n1) + torch.sign(src - n2)
        v = src
        for ei, kq in ((0, 0), (1, 1), (3, 2), (4, 3)):
            v = torch.where(eidx == ei, src + offs_p[:, kq], v)
        v = torch.where(valid, v, src)
        res_e = torch.where(eoc_p == cls, v, res_e)

    return torch.where(typ_p == 1, torch.clamp(res_b, 0, maxv),
                       torch.where(typ_p == 2, torch.clamp(res_e, 0, maxv),
                                   src))


def residuals(plan: ReconPlan) -> List[WaveGroup]:
    """Stage A: every group's residuals (one hevc_dequant_itx launch for
    the plan), with the tables stage B reads."""
    with span("hevc.stage_a"):
        res = dequant_itx([ItxGroup(g.key[0], g.key[1], g.coeffs, g.qp, g.ts,
                                    g.tqb, g.mslot) for g in plan.groups],
                          bd=plan.bd, mtab=plan.mtab)
    return [WaveGroup(g.key[0], g.key[1], g.ref_idx, g.ref_avail, g.mode,
                      g.scat_idx, r) for g, r in zip(plan.groups, res)]


def buffers(plan: ReconPlan):
    """The plan's flat sample buffers, zeroed: T·H·W + 1 luma and
    T·2·ch·cw + 1 chroma samples, the last one a trash slot that takes
    the writes of samples outside the picture (the JAX program's
    layout)."""
    T, W, H = plan.t, plan.width, plan.height
    return (torch.zeros(T * H * W + 1, dtype=torch.int32, device=plan.device),
            torch.zeros(T * 2 * (H >> 1) * (W >> 1) + 1, dtype=torch.int32,
                        device=plan.device))


def inter_predict(plan: ReconPlan, ydpb: torch.Tensor, cdpb: torch.Tensor,
                  bufs) -> None:
    """A P or B picture's steps before stage B, into ``bufs`` (buffers):
    hevc_inter_pred over every PU from the DPB tensors (span hevc.mc),
    the inter TUs' residuals (stage A's second hevc_dequant_itx launch),
    added and clipped in place (span hevc.residual)."""
    ip = plan.inter
    ybuf, cbuf = bufs
    with span("hevc.mc"):
        inter_pred(ip.jobs, ydpb, cdpb, ybuf, cbuf, bd=plan.bd)
    with span("hevc.stage_a"):
        res = dequant_itx(ip.groups, bd=plan.bd, mtab=ip.mtab)
    maxv = (1 << plan.bd) - 1
    with span("hevc.residual"):
        for g, idx, r in zip(ip.groups, ip.scat, res):
            buf = ybuf if g.luma else cbuf
            buf[idx] = torch.clamp(buf[idx] + r.reshape(-1), 0, maxv)


def predict_waves(plan: ReconPlan, waves: Sequence[WaveGroup], bufs=None):
    """Stage B: one hevc_intra_wave launch for the plan → (Y (T, H, W),
    Cb, Cr (T, H/2, W/2)) int32, views of the flat buffers (``bufs``, or
    new ones from ``buffers``), which the waves update in place, each
    picture's one after the other."""
    T, W, H = plan.t, plan.width, plan.height
    cw, ch = W >> 1, H >> 1
    ybuf, cbuf = buffers(plan) if bufs is None else bufs
    with span("hevc.stage_b"):
        intra_waves(ybuf, cbuf, waves, plan.wave_rows, bd=plan.bd,
                    strong=plan.strong_smoothing)
    cpl = cbuf[:-1].view(T, 2, ch, cw)
    return ybuf[:-1].view(T, H, W), cpl[:, 0], cpl[:, 1]


def reconstruct(plan: ReconPlan, dpb=None):
    """Stages A-D for the plan's batch: (Y (T, H, W), Cb, Cr
    (T, H/2, W/2)) int32 on the plan's device.  A P or B picture's plan
    reads its references from ``dpb`` = (ydpb, cdpb), the DPB's slot
    tensors."""
    bufs = buffers(plan)
    if plan.inter is not None:
        inter_predict(plan, *dpb, bufs)
    y, cb, cr = predict_waves(plan, residuals(plan), bufs)
    if plan.deblock is not None:
        with span("hevc.deblock"):
            y, cb, cr = deblock(plan.deblock, y, cb, cr, (1 << plan.bd) - 1)
    if plan.sao is not None:
        with span("hevc.sao"):
            y, cb, cr = sao(plan, y, cb, cr)
    return y, cb, cr


def deblock(db, y, cb, cr, maxv):
    """Stage C: vertical edges, then horizontal ones on the transposed
    planes (device_recon.py:933-952); bypass CUs keep their samples where
    the maps carry ``bp_*``/``bq_*``."""
    def sides(k):
        return db.get("bp_" + k), db.get("bq_" + k)
    y = deblock_luma_pass(y, db["beta_v"], db["tc_v"], db["en_v"], maxv,
                          *sides("v"))
    cb = deblock_chroma_pass(cb, db["ctc_v"][:, 0], db["cen_v"][:, 0], maxv,
                             *sides("cv"))
    cr = deblock_chroma_pass(cr, db["ctc_v"][:, 1], db["cen_v"][:, 1], maxv,
                             *sides("cv"))
    y = deblock_luma_pass(y.transpose(1, 2), db["beta_h"], db["tc_h"],
                          db["en_h"], maxv, *sides("h")).transpose(1, 2)
    cb = deblock_chroma_pass(cb.transpose(1, 2), db["ctc_h"][:, 0],
                             db["cen_h"][:, 0], maxv,
                             *sides("ch")).transpose(1, 2)
    cr = deblock_chroma_pass(cr.transpose(1, 2), db["ctc_h"][:, 1],
                             db["cen_h"][:, 1], maxv,
                             *sides("ch")).transpose(1, 2)
    return y.contiguous(), cb.contiguous(), cr.contiguous()


def sao(plan, y, cb, cr):
    """Stage D (device_recon.py:954-977), keeping transquant-bypass
    samples as they were."""
    s = plan.sao
    ctb = int(s["ctb"])
    slc = [None, None]
    if "slice" in s:
        sl = s["slice"].repeat_interleave(4, dim=1) \
            .repeat_interleave(4, dim=2)[:, :plan.height, :plan.width]
        slc = [sl, sl[:, ::2, ::2].contiguous()]
    out = [sao_apply(p, s["typ"][:, c], s["bpos"][:, c], s["eoc"][:, c],
                     s["offs"][:, c], ctb if c == 0 else ctb >> 1, plan.bd,
                     slc[min(c, 1)], s.get("across"))
           for c, p in enumerate((y, cb, cr))]
    if plan.tqb_mask is not None:
        my = plan.tqb_mask.repeat_interleave(4, dim=1) \
            .repeat_interleave(4, dim=2)[:, :plan.height, :plan.width]
        mc = my[:, ::2, ::2]
        out = [torch.where(m, p, o)
               for m, p, o in ((my, y, out[0]), (mc, cb, out[1]),
                               (mc, cr, out[2]))]
    return tuple(out)


def decode_pictures_device(syntaxes: Sequence[SliceSyntax],
                           raw_tus: Sequence[tuple], device=None
                           ) -> List[Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]]:
    """Reconstruct a batch of parsed intra pictures on ``device`` (None
    means CUDA): per picture the uncropped (Y, Cb, Cr) int32 planes."""
    plan = build_plan(syntaxes, raw_tus, device)
    y, cb, cr = reconstruct(plan)
    return [(y[i], cb[i], cr[i]) for i in range(plan.t)]
