"""AV1 intra reconstruction on the device, for a batch of pictures.

Counterpart of libheif_tpu/codecs/av1/device_recon.py.  Entropy decoding
stays on the host (tile.py emits one ``TxbJob`` per transform block);
everything after it runs on the plan's device in the JAX program's two
stages:

  stage A  dequant + inverse transforms   kernel av1_dequant_itx, one
                                          launch for every job group
  stage B  intra prediction + recon       kernel av1_intra_wave, one
                                          launch: each picture walks its
                                          dependency waves on its own

Palette jobs read no neighbour, so they are a plain scatter before stage
B, as in the JAX program.  The in-loop filters (deblock.py, cdef.py,
lr.py) follow on the same device.

The plan keeps the JAX plan's schedule and gather indices bit for bit:
the same groups (kind, square bucket) in the same order, rows sorted by
wave (stable), the sentinel-coded reference indices of ``_ref_indices``
and ``_fi_edge_indices``.  It differs in what jit forced on the JAX one:
no padded rows or waves, and per-job scalars where the JAX plan stores
whole index planes (the scatter and the CfL luma indices are computed
from a job's origin and clamps, ``scatter_indices``/``cfl_indices``).
The per-job scalars are gathered on the host while the waves are
scheduled; the index tables are built from them on the plan's device.

The dequantiser tables follow the stream's bit depth, as the JAX host
engine does (``tile.py`` ``_inv_transform``).  The JAX device plan reads
the 8-bit tables at every depth.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..._build import resolve_device
from ...core.trace import span
from . import itx as ITX
from . import tables as T
from .cuda_fast import (ItxGroup, WaveGroup, PARAM_COLS, dequant_itx,
                        intra_waves, job_order, scatter_indices)
from ..hevc.device_recon import wave_rows
from .recon import _edge_filter_strength, _pred_tables, _use_upsample
from .tile import TileDecoder

SENT_BASE_M1 = -1    # base - 1
SENT_BASE_P1 = -2    # base + 1
SENT_BASE = -3       # base

KIND_FI, KIND_N, KIND_PAL = 0, 1, 2     # JAX group order "fi" < "n" < "pal"
KIND_NAMES = {KIND_FI: "fi", KIND_N: "n", KIND_PAL: "pal"}

# tx_type -> (vertical kind, horizontal kind, ud flip, lr flip) as codes
KIND_CODE = {"D": 0, "A": 1, "I": 2}

# per-job host columns
_JC = ["t", "plane", "px", "py", "tw", "th", "hh", "ww", "ha", "hl",
       "n_tr", "n_bl", "kind", "sq", "wave", "coff", "ch", "cw", "poff",
       "dc_q", "ac_q", "tx_type", "eob", "is_cfl"] + \
    [c for c in PARAM_COLS if c not in ("hh", "ww", "is_cfl")]
_JI = {c: i for i, c in enumerate(_JC)}


class BatchMismatch(ValueError):
    """The pictures of a batch differ in a field the plan takes batch-wide
    (``batch_key``)."""


def batch_key(dec: TileDecoder) -> tuple:
    """What a plan takes for the whole batch: the padded luma shape, bit
    depth, plane count, chroma subsampling and the sequence's intra edge
    filter flag.  Pictures batch together only where these agree."""
    return (tuple(dec.planes[0].shape), dec.bd, len(dec.planes),
            (dec.ssx, dec.ssy), bool(dec.seq.enable_intra_edge_filter))


@dataclass
class GroupPlan:
    """One (kind, sq) job group, rows sorted by wave (stable: picture,
    then decode order).  Tensors on the plan's device."""
    kind: int
    sq: int
    n: int
    coeffs: torch.Tensor     # (n, cs, cs) int32, cs = min(sq, 32)
    txp: torch.Tensor        # (n, 8) int32 stage-A scalars (cuda_fast)
    order: torch.Tensor      # (n,) int32 stage A's visiting order
    above: torch.Tensor      # (n, 2sq+7) int32 (fi: the top row, (n, sq))
    left: torch.Tensor       # (n, 2sq+7) int32 (fi: (n, sq))
    corner: torch.Tensor     # (n,) int32 sentinel-coded gather indices
    params: torch.Tensor     # (n, len(PARAM_COLS)) int32
    pal: torch.Tensor        # (n, sq, sq) int32 palette prediction or empty
    wave_rows: np.ndarray    # (n_waves, T+1) int32


@dataclass
class Av1Plan:
    t: int
    bd: int
    luma_shape: Tuple[int, int]
    chroma_shape: Tuple[int, int]
    num_planes: int
    ssx: int
    ssy: int
    edge_filter: bool
    n_waves: int
    groups: List[GroupPlan]
    wave_rows: torch.Tensor  # (G, n_waves, T+1) int32 of the scan groups
    device: torch.device

    @property
    def stride(self) -> int:
        lh, lw = self.luma_shape
        ch, cw = self.chroma_shape
        return lh * lw + 2 * ch * cw

    @property
    def trash(self) -> int:
        return self.t * self.stride


def _reads_max(w2d: List[np.ndarray], job, ssx: int, ssy: int) -> int:
    """1 + the latest wave among the samples a job reads (JAX
    build_plan :279-290, over the same positions), else 0."""
    plane = job.plane
    wr = w2d[plane]
    ph, pw = wr.shape
    x, y, w, h = job.px, job.py, job.tw, job.th
    best = -1
    if job.pal_pred is not None:
        pass                    # palette jobs read no neighbour
    elif plane == 0 and job.fi_mode is not None:
        if job.have_above:
            best = max(best, int(wr[y - 1, x:min(x + w, pw)].max()))
        elif job.have_left:
            best = max(best, int(wr[y, x - 1]))
        if job.have_left:
            best = max(best, int(wr[y:min(y + h, ph), x - 1].max()))
        if job.have_above and job.have_left:
            best = max(best, int(wr[y - 1, x - 1]))
    else:
        if job.have_above:
            ntr = min(job.n_tr, w)
            ext = max(0, min(ntr, pw - (x + w)))
            end = x + w + ext if ext else min(x + w, pw)
            best = max(best, int(wr[y - 1, x:end].max()))
        elif job.have_left:
            best = max(best, int(wr[y, x - 1]))
        if job.have_left:
            nbl = min(job.n_bl, h)
            ext = max(0, min(nbl, ph - (y + h)))
            end = y + h + ext if ext else min(y + h, ph)
            best = max(best, int(wr[y:end, x - 1].max()))
        if job.have_above and job.have_left:
            best = max(best, int(wr[y - 1, x - 1]))
    if job.is_cfl:
        lw_ = w2d[0]
        lph, lpw = lw_.shape
        ly, lx = y << ssy, x << ssx
        sy_, sx_ = (2 if ssy else 1), (2 if ssx else 1)
        bh = min(h, max(0, (lph - ly + sy_ - 1) // sy_))
        bw = min(w, max(0, (lpw - lx + sx_ - 1) // sx_))
        r1 = min(ly + max(bh, 1) * sy_, lph)
        c1 = min(lx + max(bw, 1) * sx_, lpw)
        best = max(best, int(lw_[min(ly, lph - 1):r1,
                                 min(lx, lpw - 1):c1].max()))
    return best + 1


def _job_columns(decs: Sequence[TileDecoder], ssx: int, ssy: int,
                 edge_filter: bool):
    """Host pass over every job of the batch, in picture then decode
    order: its wave and the scalars the device tables are built from.
    Returns (cols (N, len(_JC)) int64, flat coefficients, flat palette
    predictions)."""
    _sm, dr = _pred_tables()
    rows: List[list] = []
    coeff_parts: List[np.ndarray] = []
    pal_parts: List[np.ndarray] = []
    coff = poff = 0
    for t, dec in enumerate(decs):
        q = dec.fh.quant
        lossless = bool(dec.fh.coded_lossless)
        dcq_t = T.dc_qlookup(dec.bd)
        acq_t = T.ac_qlookup(dec.bd)
        deltas = ((q.delta_q_y_dc, 0), (q.delta_q_u_dc, q.delta_q_u_ac),
                  (q.delta_q_v_dc, q.delta_q_v_ac))
        writer = [np.zeros(p.shape, np.int32) for p in dec.planes]
        for job in dec.jobs:
            if job.ibc_mv is not None or job.ibc_add:
                raise ValueError("intra block copy jobs have no device "
                                 "plan")
            plane = job.plane
            tw, th = job.tw, job.th
            if job.pal_pred is not None:
                kind = KIND_PAL
            elif plane == 0 and job.fi_mode is not None:
                kind = KIND_FI
            else:
                kind = KIND_N
            wave = _reads_max(writer, job, ssx, ssy)
            writer[plane][job.py:job.py + job.hh,
                          job.px:job.px + job.ww] = wave
            dc_d, ac_d = deltas[plane]
            dc_q = int(dcq_t[np.clip(job.qindex + dc_d, 0, 255)])
            ac_q = int(acq_t[np.clip(job.qindex + ac_d, 0, 255)])
            c_off, c_h, c_w = -1, 0, 0
            if job.coeffs is not None:
                c2 = np.asarray(job.coeffs, np.int32)
                c_off, (c_h, c_w) = coff, c2.shape
                coeff_parts.append(c2.ravel())
                coff += c2.size
            p_off = -1
            if kind == KIND_PAL:
                pp = np.asarray(job.pal_pred, np.int32)
                p_off = poff
                pal_parts.append(pp.ravel())
                poff += pp.size
            mode = job.mode
            p_angle = dxv = dyv = 0
            ups_a = ups_l = str_a = str_l = na_f = nl_f = cornerf = 0
            if kind == KIND_N and mode in T.MODE_TO_ANGLE:
                p_angle = T.MODE_TO_ANGLE[mode] + job.angle * 3
                if edge_filter and p_angle not in (90, 180):
                    if 90 < p_angle < 180 and (tw + th) >= 24:
                        cornerf = 1
                    if job.have_above:
                        str_a = _edge_filter_strength(
                            tw, th, p_angle - 90, job.filt_type)
                        na_f = tw + (th if p_angle < 90 else 0) + 1
                    if job.have_left:
                        str_l = _edge_filter_strength(
                            tw, th, p_angle - 180, job.filt_type)
                        nl_f = th + (tw if p_angle > 180 else 0) + 1
                if edge_filter:
                    ups_a = _use_upsample(tw, th, p_angle - 90,
                                          job.filt_type) \
                        if job.have_above else 0
                    ups_l = _use_upsample(tw, th, p_angle - 180,
                                          job.filt_type) \
                        if job.have_left else 0
                dxv = int(dr[p_angle]) if 0 < p_angle < 90 else \
                    int(dr[180 - p_angle]) if 90 < p_angle < 180 else 0
                dyv = int(dr[p_angle - 90]) if 90 < p_angle < 180 else \
                    int(dr[270 - p_angle]) if 180 < p_angle < 270 else 0
            # stage A flags: bit 0 residual present, bit 1 lossless (WHT)
            flags = int(job.eob > 0) | (int(lossless) << 1)
            vals = dict(
                t=t, plane=plane, px=job.px, py=job.py, tw=tw, th=th,
                hh=job.hh, ww=job.ww, ha=int(job.have_above),
                hl=int(job.have_left), n_tr=job.n_tr, n_bl=job.n_bl,
                kind=kind, sq=max(tw, th), wave=wave, coff=c_off, ch=c_h,
                cw=c_w, poff=p_off, dc_q=dc_q, ac_q=ac_q,
                tx_type=job.tx_type, eob=flags, is_cfl=int(job.is_cfl),
                mode=mode, wv=tw, hv=th, p_angle=p_angle, dx=dxv, dy=dyv,
                ups_a=ups_a, ups_l=ups_l, str_a=str_a, str_l=str_l,
                na_f=na_f, nl_f=nl_f, cornerf=cornerf,
                have_above=int(job.have_above),
                have_left=int(job.have_left),
                cfl_alpha=job.cfl_alpha if job.is_cfl else 0,
                fi_mode=job.fi_mode if kind == KIND_FI else 0)
            rows.append([vals.get(c, 0) for c in _JC])
    cols = np.asarray(rows, np.int64).reshape(-1, len(_JC))
    coeffs = np.concatenate(coeff_parts + [np.zeros(1, np.int32)])
    pals = np.concatenate(pal_parts + [np.zeros(1, np.int32)])
    return cols, coeffs, pals


def _tx_codes(tx_types: torch.Tensor) -> torch.Tensor:
    """(n,) tx_type -> (n,) vk | hk << 2 | ud << 4 | lr << 5."""
    lut = torch.zeros(32, dtype=torch.int64)   # WHT_WHT (16) unused: 0
    for tt, (vk, hk, ud, lr) in ITX._TX1D.items():
        lut[tt] = KIND_CODE[vk] | (KIND_CODE[hk] << 2) | (ud << 4) | \
            (lr << 5)
    return lut.to(tx_types.device)[tx_types]


def build_plan(decs: Sequence[TileDecoder], device=None) -> Av1Plan:
    """Wavefront schedule and job tables for a batch of parsed pictures
    that agree on ``batch_key`` (else BatchMismatch)."""
    dev = resolve_device(device)
    d0 = decs[0]
    key = batch_key(d0)
    for d in decs:
        if batch_key(d) != key:
            raise BatchMismatch(
                "batch pictures must agree on (luma shape, bit depth, "
                "planes, subsampling, intra edge filter): "
                f"{batch_key(d)} vs {key}")
    (lh, lw), bd, num_planes, (ssx, ssy), edge = key
    ch_, cw_ = d0.planes[1].shape if num_planes > 1 else (0, 0)
    T_ = len(decs)
    luma_sz, chroma_sz = lh * lw, ch_ * cw_
    stride = luma_sz + 2 * chroma_sz
    trash = T_ * stride

    with span("av1.plan_host"):
        cols, coeffs, pals = _job_columns(decs, ssx, ssy, edge)
    n_waves = int(cols[:, _JI["wave"]].max()) + 1 if len(cols) else 1
    with span("av1.plan_copies"):
        cols_d = torch.from_numpy(cols).to(dev)
        coeff_d = torch.from_numpy(coeffs).to(dev)
        pal_d = torch.from_numpy(pals).to(dev)
    C = {c: cols_d[:, i] for c, i in _JI.items()}

    # flat buffer geometry of each job's plane
    plane = C["plane"]
    pic_base = C["t"] * stride
    pbase = pic_base + torch.where(plane == 0, 0,
                                   luma_sz + (plane - 1) * chroma_sz)
    pw = torch.where(plane == 0, lw, cw_)
    ph = torch.where(plane == 0, lh, ch_)
    C.update(dst=pbase + C["py"] * pw + C["px"], pw=pw, ph_=ph,
             pbase=pbase, lbase=pic_base,
             ly=C["py"] << ssy, lx=C["px"] << ssx)
    sy_, sx_ = (2 if ssy else 1), (2 if ssx else 1)
    C["bh"] = torch.minimum(C["th"], torch.clamp(
        (lh - C["ly"] + sy_ - 1) // sy_, min=0))
    C["bw"] = torch.minimum(C["tw"], torch.clamp(
        (lw - C["lx"] + sx_ - 1) // sx_, min=0))

    kinds, sqs = cols[:, _JI["kind"]], cols[:, _JI["sq"]]
    waves_h, tiles_h = cols[:, _JI["wave"]], cols[:, _JI["t"]]
    keys = sorted({(int(k), int(s)) for k, s in zip(kinds, sqs)},
                  key=lambda k: (k[0], -k[1]))
    groups: List[GroupPlan] = []
    for kind, sq in keys:
        sel = np.nonzero((kinds == kind) & (sqs == sq))[0]
        order = np.argsort(waves_h[sel], kind="stable")
        sel = sel[order]
        idx = torch.from_numpy(sel).to(dev)
        g = {c: v[idx] for c, v in C.items()}
        n = len(sel)
        cs = min(sq, 32)
        # coefficients, zero-padded into (cs, cs)
        r = torch.arange(cs, device=dev)
        inside = (r[None, :, None] < g["ch"][:, None, None]) & \
            (r[None, None, :] < g["cw"][:, None, None]) & \
            (g["coff"] >= 0)[:, None, None]
        src = g["coff"][:, None, None] + r[None, :, None] * \
            g["cw"][:, None, None] + r[None, None, :]
        cf = torch.where(inside, coeff_d[torch.where(inside, src, 0)], 0)
        txp = torch.stack([g["dc_q"], g["ac_q"], g["tw"], g["th"],
                           _tx_codes(g["tx_type"]), g["eob"],
                           torch.zeros_like(g["tw"]),
                           torch.zeros_like(g["tw"])], 1)
        if kind == KIND_FI:
            above, left, corner = _fi_edge_indices(g, sq, dev)
        elif kind == KIND_N:
            above, left, corner = _ref_indices(g, sq, dev)
        else:
            above = left = torch.zeros((n, 0), dtype=torch.int64,
                                       device=dev)
            corner = torch.zeros(n, dtype=torch.int64, device=dev)
        params = torch.stack([g[c] for c in PARAM_COLS], 1)
        if kind == KIND_PAL:
            r = torch.arange(sq, device=dev)
            inside = (r[None, :, None] < g["th"][:, None, None]) & \
                (r[None, None, :] < g["tw"][:, None, None])
            src = g["poff"][:, None, None] + r[None, :, None] * \
                g["tw"][:, None, None] + r[None, None, :]
            pal = torch.where(inside, pal_d[torch.where(inside, src, 0)], 0)
        else:
            pal = torch.zeros((0, sq, sq), dtype=torch.int32, device=dev)
        groups.append(GroupPlan(
            kind=kind, sq=sq, n=n, coeffs=cf.to(torch.int32),
            txp=txp.to(torch.int32), order=job_order(txp),
            above=above.to(torch.int32),
            left=left.to(torch.int32), corner=corner.to(torch.int32),
            params=params.to(torch.int32), pal=pal.to(torch.int32),
            wave_rows=wave_rows(waves_h[sel], tiles_h[sel], n_waves, T_)))

    scan = [g for g in groups if g.kind != KIND_PAL]
    wr = np.stack([g.wave_rows for g in scan]) if scan else \
        np.zeros((0, n_waves, T_ + 1), np.int32)
    return Av1Plan(t=T_, bd=bd, luma_shape=(lh, lw),
                   chroma_shape=(ch_, cw_), num_planes=num_planes, ssx=ssx,
                   ssy=ssy, edge_filter=edge, n_waves=n_waves,
                   groups=groups,
                   wave_rows=torch.from_numpy(wr).to(dev), device=dev)


def _ipl(g, r, c):
    """Flat buffer index of (row, col) in each job's plane."""
    return g["pbase"][:, None] + r * g["pw"][:, None] + c


def _ref_indices(g, sq: int, dev):
    """JAX ``_ref_indices`` for every row at once, padded to 2sq+7 with
    the last entry (JAX build_plan :361-365)."""
    x, y = g["px"][:, None], g["py"][:, None]
    w, h = g["tw"][:, None], g["th"][:, None]
    pw, ph = g["pw"][:, None], g["ph_"][:, None]
    ha, hl = g["ha"][:, None] > 0, g["hl"][:, None] > 0
    L2 = 2 * sq + 7
    i = torch.arange(L2, device=dev)[None, :]
    j = torch.minimum(i, w + h + 6)
    ext_a = torch.clamp(torch.minimum(torch.minimum(g["n_tr"][:, None], w),
                                      pw - (x + w)), min=0)
    col = torch.where(
        j < w, torch.minimum(x + j, pw - 1),
        torch.where(ext_a > 0, x + torch.minimum(j, w + ext_a - 1),
                    torch.minimum(x + w - 1, pw - 1)))
    left_of = _ipl(g, y, x - 1)
    above = torch.where(ha, _ipl(g, y - 1, col),
                        torch.where(hl, left_of, SENT_BASE_M1))
    ext_l = torch.clamp(torch.minimum(torch.minimum(g["n_bl"][:, None], h),
                                      ph - (y + h)), min=0)
    row = torch.where(
        j < h, torch.minimum(y + j, ph - 1),
        torch.where(ext_l > 0, y + torch.minimum(j, h + ext_l - 1),
                    torch.minimum(y + h - 1, ph - 1)))
    left = torch.where(hl, _ipl(g, row, x - 1),
                       torch.where(ha, above[:, :1], SENT_BASE_P1))
    corner = torch.where(
        ha & hl, _ipl(g, y - 1, x - 1),
        torch.where(ha, above[:, :1],
                    torch.where(hl, left[:, :1], SENT_BASE)))[:, 0]
    return above, left, corner


def _fi_edge_indices(g, sq: int, dev):
    """JAX ``_fi_edge_indices`` for every row: the top row (sq+1, the
    corner first) and left column (sq), padded with their last entries
    (JAX build_plan :396-399).  Returned as (top[1:], left, top[0])."""
    x, y = g["px"][:, None], g["py"][:, None]
    w, h = g["tw"][:, None], g["th"][:, None]
    pw, ph = g["pw"][:, None], g["ph_"][:, None]
    ha, hl = g["ha"][:, None] > 0, g["hl"][:, None] > 0
    i = torch.arange(sq, device=dev)[None, :]
    top = torch.where(
        ha, _ipl(g, y - 1, torch.minimum(x + torch.minimum(i, w - 1),
                                         pw - 1)),
        torch.where(hl, _ipl(g, y, x - 1), SENT_BASE_M1))
    left = torch.where(
        hl, _ipl(g, torch.minimum(y + torch.minimum(i, h - 1), ph - 1),
                 x - 1),
        torch.where(ha, top[:, :1], SENT_BASE_P1))
    corner = torch.where(
        ha & hl, _ipl(g, y - 1, x - 1),
        torch.where(ha, top[:, :1],
                    torch.where(hl, left[:, :1], SENT_BASE)))[:, 0]
    return top, left, corner


# ------------------------------------------------------------------ stages

def residuals(plan: Av1Plan) -> List[torch.Tensor]:
    """Stage A: every group's (n, sq, sq) int32 residuals, one
    av1_dequant_itx launch for the plan."""
    with span("av1.stage_a"):
        return dequant_itx([ItxGroup(g.sq, g.coeffs, g.txp, g.order)
                            for g in plan.groups])


def palette_and_waves(plan: Av1Plan, res: Sequence[torch.Tensor]):
    """The flat int32 buffer of every plane of every picture (then the
    trash slot) with the palette jobs reconstructed in it, as the JAX
    program does before its scan (palette jobs read nothing), and the
    stage-B tables of the other groups."""
    buf = torch.zeros(plan.trash + 1, dtype=torch.int32, device=plan.device)
    maxv = (1 << plan.bd) - 1
    waves = []
    for g, r in zip(plan.groups, res):
        if g.kind == KIND_PAL:
            if g.n:
                rec = torch.clamp(g.pal + r, 0, maxv)
                buf[scatter_indices(g.params, g.sq, plan.trash)
                    .reshape(-1)] = rec.reshape(-1)
            continue
        waves.append(WaveGroup(g.kind == KIND_FI, g.sq, g.above, g.left,
                               g.corner, g.params, r))
    return buf, waves


def predict_waves(plan: Av1Plan, res: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """Palette jobs, then stage B (one av1_intra_wave launch): the flat
    int32 buffer of every plane of every picture, plus the trash slot."""
    with span("av1.stage_b"):
        buf, waves = palette_and_waves(plan, res)
        intra_waves(buf, waves, plan.wave_rows, **wave_args(plan))
    return buf


def wave_args(plan: Av1Plan) -> dict:
    """intra_waves' keyword arguments for a plan."""
    return dict(bd=plan.bd, edge_filter=plan.edge_filter, ssx=plan.ssx,
                ssy=plan.ssy, luma_shape=plan.luma_shape)


def reconstruct(plan: Av1Plan) -> List[List[torch.Tensor]]:
    """Stages A and B for the plan's batch: per picture its int32 planes
    (Y, and U, V unless monochrome), views of the flat buffer."""
    buf = predict_waves(plan, residuals(plan))
    lh, lw = plan.luma_shape
    ch_, cw_ = plan.chroma_shape
    pics = buf[:-1].view(plan.t, plan.stride)
    out = []
    for i in range(plan.t):
        pl = [pics[i, :lh * lw].view(lh, lw)]
        if plan.num_planes > 1:
            c0 = lh * lw
            pl += [pics[i, c0:c0 + ch_ * cw_].view(ch_, cw_),
                   pics[i, c0 + ch_ * cw_:].view(ch_, cw_)]
        out.append(pl)
    return out


def decode_frames_device(decs: Sequence[TileDecoder], device=None
                         ) -> List[List[torch.Tensor]]:
    """Reconstruct a batch of parsed pictures on ``device`` (None means
    CUDA): per picture its padded int32 planes, before the in-loop
    filters."""
    if not any(d.jobs for d in decs):
        dev = resolve_device(device)
        return [[torch.as_tensor(p, device=dev) for p in d.planes]
                for d in decs]
    with span("av1.plan"):
        plan = build_plan(decs, device)
    return reconstruct(plan)

