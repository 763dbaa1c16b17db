"""Hand-written CUDA kernels of the AV1 intra reconstruction, and their
plain PyTorch versions.

Two stages of the JAX package's jnp device program
(libheif_tpu/codecs/av1/device_recon.py ``_build_program``) are kernels
in ``csrc/av1_kernels.cu``, each one launch for a whole plan:

===============  ============================================  ===========
kernel           replaces                                      wrapper
===============  ============================================  ===========
av1_dequant_itx  stage A, ``residuals`` (:548-604), every      dequant_itx
                 job group and residual sub-batch
av1_intra_wave   stage B, the ``lax.scan`` over waves          intra_waves
                 (:885-950) with ``predict_normal`` (:606),
                 ``apply_cfl`` (:826) and ``predict_fi``
                 (:850), every picture; and intra block
                 copy, which the jnp program lacks (the
                 host engine's ``TileDecoder._ibc_copy``,
                 tile.py:1826)
av1_wave_probe   none: a probe of stage B's chain bound, off   wave_probe
                 the decode path
===============  ============================================  ===========

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version beside it, which repeats the jnp
program's int32 arithmetic operation by operation (products wrap as
XLA's do).  Every kernel carries a launch count
(``KERNELS[name].launches``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..._build import CudaKernel
from ..unc.cuda_fast import _on_cpu
from . import itx as ITX
from .itx import _round2
from .cdf import _load
from .recon import _EDGE_KERNELS, _pred_tables
from .tables import DC_PRED, PAETH_PRED, SMOOTH_H_PRED, SMOOTH_PRED, \
    SMOOTH_V_PRED

_P, _I = ctypes.c_void_p, ctypes.c_int

AV1_DEQUANT_ITX = CudaKernel(
    "av1_dequant_itx", "launch_av1_dequant_itx", [_P, _I, _I])
AV1_INTRA_WAVE = CudaKernel(
    "av1_intra_wave", "launch_av1_intra_wave",
    [_P, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I])
AV1_WAVE_PROBE = CudaKernel(
    "av1_wave_probe", "launch_av1_wave_probe", [_P, _P, _I, _I])

KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (AV1_DEQUANT_ITX, AV1_INTRA_WAVE)}

# the job groups a launch takes (kMaxGroups, kMaxItxGroups in
# csrc/av1_kernels.cu): stage B scans at most 4 filter-intra (4..32), 5
# normal and 5 intrabc groups (4..64), 14; stage A also takes the 5
# palette groups, 19
MAX_GROUPS = 16
MAX_ITX_GROUPS = 20

# stage B's job kinds (kWave* in csrc/av1_kernels.cu)
WAVE_N, WAVE_FI, WAVE_IBC = 0, 1, 2

# the per-job scalars of a stage-B row, in the column order the kernel
# reads them (kP* in csrc/av1_kernels.cu); an intrabc job's source: the
# flat index of its rectangle's origin and its half-sample flags fy << 1 |
# fx
PARAM_COLS = ("mode", "wv", "hv", "p_angle", "dx", "dy", "ups_a", "ups_l",
              "str_a", "str_l", "na_f", "nl_f", "cornerf", "have_above",
              "have_left", "is_cfl", "cfl_alpha", "fi_mode", "dst", "pw",
              "hh", "ww", "ly", "lx", "bh", "bw", "lbase", "ibc_src",
              "ibc_half")
P = {c: i for i, c in enumerate(PARAM_COLS)}

# stage-A scalars per row (txp): dc_q, ac_q, tw, th, transform code
# (vk | hk << 2 | ud << 4 | lr << 5, kinds 0 DCT, 1 ADST, 2 identity),
# flags (bit 0 residual present, bit 1 lossless), two unused
TXP_DCQ, TXP_ACQ, TXP_TW, TXP_TH, TXP_CODE, TXP_FLAGS = range(6)
_KINDS = "DAI"

_SM_OFF = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}


class ItxGroup(NamedTuple):
    """One job group's stage-A inputs: ``coeffs`` (n, cs, cs) int32
    quantised levels (cs = min(sq, 32)), ``txp`` (n, 8) int32 scalars and
    ``order`` (n,) int32, the order the kernel visits the jobs in
    (``job_order``; any permutation gives the same residuals, each at its
    job's slot)."""
    sq: int
    coeffs: torch.Tensor
    txp: torch.Tensor
    order: torch.Tensor


class WaveGroup(NamedTuple):
    """One job group's stage-B tables, rows sorted by wave: its ``kind``
    (WAVE_N, WAVE_FI or WAVE_IBC), the sentinel-coded gather indices
    ``above``/``left`` ((n, 2sq+7) for normal jobs; filter-intra: top row
    and left column, (n, sq); intrabc: (n, 0)), ``corner`` (n,),
    ``params`` (n, len(PARAM_COLS)) int32 and the residuals ``res`` (n,
    sq, sq) int32."""
    kind: int
    sq: int
    above: torch.Tensor
    left: torch.Tensor
    corner: torch.Tensor
    params: torch.Tensor
    res: torch.Tensor


# ------------------------------------------------------------ av1_dequant_itx

def dequant_itx(groups: Sequence[ItxGroup]) -> List[torch.Tensor]:
    """Stage A for every job group of a plan, one launch: each group's
    (n, sq, sq) int32 residuals, zero outside a job's (th, tw) and for
    jobs without coefficients.  Dequantise (``|c|·q`` masked to 24 bits,
    shifted by the size), the 2:1 prescale, the row transform, its
    rounding and flip, the column transform, its rounding and flip; the
    Walsh-Hadamard path for lossless frames."""
    if len(groups) > MAX_ITX_GROUPS:
        raise ValueError(f"at most {MAX_ITX_GROUPS} groups, got "
                         f"{len(groups)}")
    for g in groups:
        cs = min(g.sq, 32)
        n = g.coeffs.shape[0]
        if g.coeffs.dtype != torch.int32 or \
                tuple(g.coeffs.shape[1:]) != (cs, cs):
            raise ValueError(f"coeffs: expected (N, {cs}, {cs}) int32, got "
                             f"{tuple(g.coeffs.shape)} {g.coeffs.dtype}")
        if g.txp.dtype != torch.int32 or tuple(g.txp.shape) != (n, 8):
            raise ValueError(f"txp: expected ({n}, 8) int32, got "
                             f"{tuple(g.txp.shape)} {g.txp.dtype}")
        if g.order.dtype != torch.int32 or tuple(g.order.shape) != (n,):
            raise ValueError(f"order: expected ({n},) int32, got "
                             f"{tuple(g.order.shape)} {g.order.dtype}")
    if not groups:
        return []
    if _on_cpu(*(t for g in groups for t in g[1:])):
        return [dequant_itx_plain(g.sq, g.coeffs, g.txp) for g in groups]
    outs = [torch.empty((g.coeffs.shape[0], g.sq, g.sq), dtype=torch.int32,
                        device=g.coeffs.device) for g in groups]
    keep = [(g.coeffs.contiguous(), g.txp.contiguous(), g.order.contiguous())
            for g in groups]
    table = (ctypes.c_longlong * (6 * len(groups)))(*(
        v for g, (c, t, od), o in zip(groups, keep, outs)
        for v in (c.data_ptr(), t.data_ptr(), od.data_ptr(), o.data_ptr(),
                  g.coeffs.shape[0], g.sq)))
    AV1_DEQUANT_ITX.launch(max(outs, key=torch.Tensor.numel),
                           ctypes.addressof(table), len(groups),
                           sum(g.coeffs.shape[0] for g in groups))
    return outs


def job_order(txp: torch.Tensor) -> torch.Tensor:
    """(n,) int32: a group's jobs ordered by flags, transform width,
    height and code (stable), so that the threads of a warp of
    av1_dequant_itx take the same branches."""
    t = txp.to(torch.int64)
    key = ((t[:, TXP_FLAGS] & 3) << 24) | (t[:, TXP_TW] << 16) | \
        (t[:, TXP_TH] << 8) | (t[:, TXP_CODE] & 0xFF)
    return torch.argsort(key, stable=True).to(torch.int32)


def _wht1(v0, v1, v2, v3):
    a, c, d, b = v0, v1, v2, v3
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    a = a - b
    d = d + c
    return a, b, c, d


def dequant_itx_plain(sq: int, coeffs: torch.Tensor, txp: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of av1_dequant_itx for one group: the jnp
    ``residuals`` (device_recon.py:548-604), one residual sub-batch
    (size, transform, flags) after the other, with itx.py's staged 1-D
    transforms on int32 tensors."""
    n = coeffs.shape[0]
    dev = coeffs.device
    res = torch.zeros((n, sq, sq), dtype=torch.int32, device=dev)
    if n == 0:
        return res
    keys = txp[:, TXP_TW:TXP_FLAGS + 1]
    for key in torch.unique(keys, dim=0).tolist():
        w_t, h_t, code, flags = key
        if not flags & 1:
            continue
        rows = torch.nonzero((keys == torch.tensor(key, device=dev))
                             .all(1))[:, 0]
        dq = txp[rows, TXP_ACQ][:, None, None]
        dcq = txp[rows, TXP_DCQ]
        if flags & 2:
            c = coeffs[rows][:, :h_t, :w_t]
            d = c * dq
            d[:, 0, 0] = c[:, 0, 0] * dcq
            x = d >> 2
            x = torch.stack(_wht1(*x.unbind(2)), 2)           # rows
            out = torch.stack(_wht1(*x.unbind(1)), 1)         # columns
        else:
            vk, hk = _KINDS[code & 3], _KINDS[(code >> 2) & 3]
            ud, lr = (code >> 4) & 1, (code >> 5) & 1
            ch2, cw2 = min(h_t, 32), min(w_t, 32)
            c = coeffs[rows][:, :ch2, :cw2]
            qm = dq.expand(c.shape).clone()
            qm[:, 0, 0] = dcq
            pels = w_t * h_t
            shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
            mag = ((torch.abs(c) * qm) & 0xFFFFFF) >> shift
            d = torch.where(c < 0, -mag, mag)
            buf = torch.zeros((len(rows), h_t, w_t), dtype=torch.int32,
                              device=dev)
            buf[:, :ch2, :cw2] = d
            sh_row, sh_col = ITX._SHIFTS[(w_t, h_t)]
            if abs(w_t.bit_length() - h_t.bit_length()) == 1:
                buf = _round2(buf * ITX._INV_SQRT2, 12)
            rows_out = ITX._txfm1d(hk, w_t)(list(buf.unbind(2)))
            mid = torch.stack([_round2(v, -sh_row) for v in rows_out], 2)
            if lr:
                mid = torch.flip(mid, (2,))
            cols_out = ITX._txfm1d(vk, h_t)(list(mid.unbind(1)))
            out = torch.stack([_round2(v, -sh_col) for v in cols_out], 1)
            if ud:
                out = torch.flip(out, (1,))
        res[rows, :h_t, :w_t] = out.to(torch.int32)
    return res


# ------------------------------------------------------------- av1_intra_wave

def intra_waves(buf: torch.Tensor, groups: Sequence[WaveGroup],
                rows: torch.Tensor, *, bd: int, edge_filter: bool, ssx: int,
                ssy: int, luma_shape: Tuple[int, int]) -> None:
    """Stage B for a whole plan, in place, one launch: every wave of every
    picture; each job predicts from the samples of the flat int32
    ``buf`` (every plane of every picture, then a trash slot), adds its
    residual, clips to [0, 2^bd - 1] and scatters its samples into
    ``buf``.  ``rows`` (G, n_waves, T+1) int32: the rows of group g, wave
    w and picture t are rows[g, w, t] .. rows[g, w, t+1].  A job reads
    samples of its own picture written by earlier waves only, so the
    kernel walks each picture's waves on its own, one block a picture;
    the plain version walks the waves in lockstep, as the jnp scan does.
    """
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} groups, got {len(groups)}")
    if buf.dtype != torch.int32 or buf.dim() != 1:
        raise ValueError("buf: expected a flat int32 tensor")
    if rows.dtype != torch.int32 or rows.dim() != 3 or \
            rows.shape[0] != len(groups) or rows.shape[2] < 2:
        raise ValueError(f"rows: expected ({len(groups)}, n_waves, T+1) "
                         f"int32, got {tuple(rows.shape)} {rows.dtype}")
    for g in groups:
        n = g.params.shape[0]
        if g.kind not in (WAVE_N, WAVE_FI, WAVE_IBC) or \
                (g.kind == WAVE_FI and g.sq > 32):
            raise ValueError(f"group kind {g.kind} of size {g.sq}")
        la = {WAVE_N: 2 * g.sq + 7, WAVE_FI: g.sq, WAVE_IBC: 0}[g.kind]
        for t, name, shape in ((g.above, "above", (n, la)),
                               (g.left, "left", (n, la)),
                               (g.corner, "corner", (n,)),
                               (g.params, "params", (n, len(PARAM_COLS))),
                               (g.res, "res", (n, g.sq, g.sq))):
            if t.dtype != torch.int32 or tuple(t.shape) != shape:
                raise ValueError(f"{name}: expected {shape} int32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    if _on_cpu(buf, rows, *(t for g in groups for t in g[2:])):
        starts = rows[:, :, 0].T.tolist()
        counts = (rows[:, :, -1] - rows[:, :, 0]).T.tolist()
        for st, cn in zip(starts, counts):
            intra_wave_plain(buf, groups, st, cn, bd=bd,
                             edge_filter=edge_filter, ssx=ssx, ssy=ssy,
                             luma_shape=luma_shape)
        return
    if not groups:
        return
    gs = [[t.contiguous() for t in g[2:]] for g in groups]
    for t in gs:                # residuals are read as 16-byte vectors
        if t[4].data_ptr() % 16:
            t[4] = t[4].clone()
    table = (ctypes.c_longlong * (7 * len(groups)))(*(
        v for g, t in zip(groups, gs)
        for v in (t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(),
                  t[3].data_ptr(), t[4].data_ptr(), g.sq, int(g.kind))))
    AV1_INTRA_WAVE.launch(buf, ctypes.addressof(table), len(groups),
                          rows.data_ptr(), rows.shape[1], rows.shape[2] - 1,
                          buf.data_ptr(), buf.numel() - 1, bd,
                          int(edge_filter), ssx, ssy, luma_shape[0],
                          luma_shape[1])


def wave_probe(pictures: int, steps: int, device) -> None:
    """av1_wave_probe: ``steps`` dependent steps (a table load, a gather
    at the loaded index, a store, a barrier) in each of ``pictures``
    blocks of av1_intra_wave's shape; n_waves of its steps are stage B's
    in-kernel chain bound.  A measurement of the card only: it raises on
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("av1_wave_probe runs on the card only")
    tab = torch.arange(0, 2 * pictures, 2, dtype=torch.int32, device=dev)
    buf = torch.zeros(2 * pictures, dtype=torch.int32, device=dev)
    AV1_WAVE_PROBE.launch(buf, tab.data_ptr(), buf.data_ptr(), pictures,
                          steps)


def intra_wave_plain(buf, groups, starts, counts, *, bd, edge_filter, ssx,
                     ssy, luma_shape):
    """Plain PyTorch version of one wave of av1_intra_wave: the body of
    the jnp wave scan (device_recon.py:909-938), one group after the
    other, on rows starts[g] .. starts[g] + counts[g] of each group; an
    intrabc group's prediction is ``ibc_pred_plain``."""
    maxv = (1 << bd) - 1
    trash = buf.numel() - 1
    for g, st, cn in zip(groups, starts, counts):
        if cn == 0:
            continue
        sl = slice(st, st + cn)
        prm = g.params[sl]
        if g.kind == WAVE_IBC:
            pred = ibc_pred_plain(buf, prm, g.sq, bd=bd)
        elif g.kind == WAVE_FI:
            pred = predict_fi_plain(g.sq, refvals(buf, g.above[sl], bd),
                                    refvals(buf, g.left[sl], bd),
                                    refvals(buf, g.corner[sl], bd),
                                    prm[:, P["fi_mode"]], bd=bd)
        else:
            pred = predict_normal_plain(
                g.sq, refvals(buf, g.above[sl], bd),
                refvals(buf, g.left[sl], bd),
                refvals(buf, g.corner[sl], bd), prm, bd=bd,
                edge_filter=edge_filter)
            pred = apply_cfl_plain(buf, g.sq, prm, pred, bd=bd, ssx=ssx,
                                   ssy=ssy, luma_shape=luma_shape)
        rec = torch.clamp(pred + g.res[sl], 0, maxv)
        buf[scatter_indices(prm, g.sq, trash).reshape(-1)] = \
            rec.reshape(-1).to(torch.int32)


def ibc_pred_plain(buf: torch.Tensor, prm: torch.Tensor, sq: int, *,
                   bd: int) -> torch.Tensor:
    """Intra block copy prediction of k jobs (JAX ``TileDecoder._ibc_copy``,
    tile.py:1826-1864): each sample of the (hh, ww) rectangle gathered from
    the source at ``ibc_src`` (row pitch ``pw``) and, with half-sample
    flags, its right and lower neighbours; the BILINEAR taps (64, 64 at a
    half sample, else 128) of each pass shifted by 3, then (v + 1024) >> 11
    and the clip.  Returns (k, sq, sq) int32, 0 outside the rectangle."""
    p = prm.to(torch.int64)
    ii = torch.arange(sq * sq, device=prm.device)
    yy, xx = (ii // sq)[None, :], (ii % sq)[None, :]
    inside = (yy < p[:, P["hh"], None]) & (xx < p[:, P["ww"], None])
    pw = p[:, P["pw"], None]
    fy = (p[:, P["ibc_half"], None] >> 1) & 1
    fx = p[:, P["ibc_half"], None] & 1
    src = torch.where(inside, p[:, P["ibc_src"], None] + yy * pw + xx, 0)

    def row(off):
        a = buf[src + off]
        b = buf[src + off + fx]
        return torch.where(fx > 0, (64 * a + 64 * b) >> 3, (128 * a) >> 3)
    h0, h1 = row(0), row(fy * pw)
    v = torch.where(fy > 0, 64 * h0 + 64 * h1, 128 * h0)
    out = torch.clamp((v + (1 << 10)) >> 11, 0, (1 << bd) - 1)
    return torch.where(inside, out, 0).reshape(-1, sq, sq).to(torch.int32)


def scatter_indices(params: torch.Tensor, sq: int, trash: int
                    ) -> torch.Tensor:
    """(n, sq*sq) flat scatter indices: the job's hh x ww samples from its
    origin ``dst`` (row pitch ``pw``), every other lane the trash slot
    (JAX build_plan :294-300)."""
    p = params.to(torch.int64)
    ii = torch.arange(sq * sq, device=params.device)
    yy, xx = (ii // sq)[None, :], (ii % sq)[None, :]
    inside = (yy < p[:, P["hh"], None]) & (xx < p[:, P["ww"], None])
    return torch.where(inside, p[:, P["dst"], None] +
                       yy * p[:, P["pw"], None] + xx, trash)


def intra_waves_by_picture_plain(buf, groups, rows, **kw):
    """Stage B in the order av1_intra_wave walks it: picture after
    picture, each picture's waves in order, every group of a wave; rows
    as for intra_waves.  The tests hold it equal to the lockstep order."""
    r = rows.tolist()
    for t in range(rows.shape[2] - 1):
        for w in range(rows.shape[1]):
            intra_wave_plain(buf, groups, [g[w][t] for g in r],
                             [g[w][t + 1] - g[w][t] for g in r], **kw)


def refvals(buf: torch.Tensor, idx: torch.Tensor, bd: int) -> torch.Tensor:
    """Resolve sentinel-coded gather indices (device_recon.py:520-526):
    -1 reads 2^(bd-1) - 1, -2 reads 2^(bd-1) + 1, -3 reads 2^(bd-1)."""
    base = 1 << (bd - 1)
    v = buf[torch.clamp(idx, 0, buf.numel() - 1).to(torch.int64)]
    v = torch.where(idx == -1, base - 1, v)
    v = torch.where(idx == -2, base + 1, v)
    return torch.where(idx == -3, base, v)


def _sm_flat(dev) -> torch.Tensor:
    sm, _dr = _pred_tables()
    return torch.cat([torch.as_tensor(sm[n]) for n in (4, 8, 16, 32, 64)]) \
        .to(torch.int32).to(dev)


def predict_normal_plain(sq: int, refs_a: torch.Tensor, refs_l: torch.Tensor,
                         corner: torch.Tensor, prm: torch.Tensor, *, bd: int,
                         edge_filter: bool) -> torch.Tensor:
    """Batched intra prediction of k jobs padded into an (sq, sq) bucket
    (device_recon.py:606-824): DC, PAETH, SMOOTH/V/H and directional with
    the edge filter and upsampling.  refs_a/refs_l (k, 2sq+7), corner
    (k,) resolved samples; returns (k, sq, sq) int32."""
    dev = refs_a.device
    k = refs_a.shape[0]
    L = 2 * sq + 7
    maxv = (1 << bd) - 1
    base = 1 << (bd - 1)
    col = lambda name: prm[:, P[name]]      # noqa: E731
    mode, wv, hv = col("mode"), col("wv"), col("hv")
    lgw = torch.log2(wv.float()).to(torch.int32)
    lgh = torch.log2(hv.float()).to(torch.int32)
    smo_lut = torch.zeros(65, dtype=torch.int32, device=dev)
    for s_, o in _SM_OFF.items():
        smo_lut[s_] = o
    smo_w, smo_h = smo_lut[wv.long()], smo_lut[hv.long()]
    p_angle, dxv, dyv = col("p_angle"), col("dx"), col("dy")
    ups_a, ups_l = col("ups_a"), col("ups_l")
    str_a, str_l = col("str_a"), col("str_l")
    na_f, nl_f, cornerf = col("na_f"), col("nl_f"), col("cornerf")
    ha, hl = col("have_above") > 0, col("have_left") > 0
    sm_flat = _sm_flat(dev)

    ar = torch.arange(sq, dtype=torch.int32, device=dev)
    x1 = ar[None, None, :].expand(1, sq, sq)
    y1 = ar[None, :, None].expand(1, sq, sq)
    iL = torch.arange(L, dtype=torch.int32, device=dev)[None, :]

    def take(a, idx):
        return torch.gather(a, 1, idx.to(torch.int64))

    # DC
    sum_a = torch.where(iL < wv[:, None], refs_a, 0).sum(1, dtype=torch.int32)
    sum_l = torch.where(iL < hv[:, None], refs_l, 0).sum(1, dtype=torch.int32)
    dc_b = torch.div(sum_a + sum_l + ((wv + hv) >> 1), wv + hv,
                     rounding_mode="floor")
    dc_a = (sum_a + (1 << torch.clamp(lgw - 1, min=0))) >> lgw
    dc_l = (sum_l + (1 << torch.clamp(lgh - 1, min=0))) >> lgh
    dc = torch.where(ha & hl, dc_b,
                     torch.where(ha, dc_a,
                                 torch.where(hl, dc_l,
                                             torch.full_like(dc_a, base))))
    dcp = dc[:, None, None].expand(k, sq, sq)

    # PAETH
    t_ = refs_a[:, :sq][:, None, :]
    l_ = refs_l[:, :sq][:, :, None]
    tl = corner[:, None, None]
    pbase = t_ + l_ - tl
    pl = torch.abs(pbase - l_)
    pt = torch.abs(pbase - t_)
    ptl = torch.abs(pbase - tl)
    paeth = torch.where((pl <= pt) & (pl <= ptl), l_.expand(k, sq, sq),
                        torch.where(pt <= ptl, t_.expand(k, sq, sq),
                                    tl.expand(k, sq, sq)))

    # SMOOTH / SMOOTH_V / SMOOTH_H
    nsm = sm_flat.shape[0]
    wvert = sm_flat[torch.clamp(
        smo_h[:, None] + torch.minimum(ar[None, :], hv[:, None] - 1), 0,
        nsm - 1).long()][:, :, None]
    whorz = sm_flat[torch.clamp(
        smo_w[:, None] + torch.minimum(ar[None, :], wv[:, None] - 1), 0,
        nsm - 1).long()][:, None, :]
    below = take(refs_l, hv[:, None] - 1)[:, :, None]
    right = take(refs_a, wv[:, None] - 1)[:, :, None]
    sv = wvert * t_ + (256 - wvert) * below
    sh2 = whorz * l_ + (256 - whorz) * right
    smooth = _round2(sv + sh2, 9)
    smooth_v = _round2(sv, 8)
    smooth_h = _round2(sh2, 8)

    # directional
    arow = torch.cat([corner[:, None], refs_a], 1)
    lcol = torch.cat([corner[:, None], refs_l], 1)
    EL = 1 + L
    if edge_filter:
        sC = _round2(5 * arow[:, 1] + 6 * corner + 5 * lcol[:, 1], 4)
        use_cf = cornerf > 0
        arow = arow.clone()
        lcol = lcol.clone()
        arow[:, 0] = torch.where(use_cf, sC, arow[:, 0])
        lcol[:, 0] = torch.where(use_cf, sC, lcol[:, 0])
        kernels = torch.tensor([[0, 16, 0, 0, 0]] + _EDGE_KERNELS,
                               dtype=torch.int32, device=dev)

        def edge_filter_(ebuf, nf, strength):
            kern = kernels[torch.clamp(strength, 0, 3).long()]
            i = torch.arange(EL, dtype=torch.int32, device=dev)[None, :]
            acc = torch.zeros_like(ebuf)
            for jj in range(5):
                idx = torch.minimum(torch.clamp(i - 2 + jj, min=0),
                                    torch.clamp(nf[:, None] - 1, min=0))
                acc = acc + kern[:, jj][:, None] * take(ebuf, idx)
            filt = (acc + 8) >> 4
            on = (strength > 0)[:, None] & (i >= 1) & (i < nf[:, None])
            return torch.where(on, filt, ebuf)

        arow = edge_filter_(arow, na_f, str_a)
        lcol = edge_filter_(lcol, nl_f, str_l)

    UL = 2 + 4 * sq + 8

    def upsample(ebuf, n_up):
        kk = torch.arange(-2, 2 * sq + 2, dtype=torch.int32,
                          device=dev)[None, :]
        n1 = torch.clamp(n_up[:, None] - 1, min=0)
        e_idx = torch.clamp(torch.minimum(kk, n1), 0, EL - 2) + 1
        sv_ = torch.where(kk < 0, ebuf[:, :1], take(ebuf, e_idx))
        ns = sv_.shape[1]
        pos = torch.arange(UL, dtype=torch.int32, device=dev)[None, :]
        kq = (pos - 2) >> 1
        is_even = (pos & 1) == 0
        keff = torch.minimum(kq, n1)
        even_v = take(sv_, torch.clamp(keff + 2, 0, ns - 1))
        km = torch.minimum(kq, n1 - 1)

        def g(off):
            return take(sv_, torch.clamp(km + 2 + off, 0, ns - 1))
        odd_raw = -g(-1) + 9 * g(0) + 9 * g(1) - g(2)
        odd_v = torch.clamp(_round2(odd_raw, 4), 0, maxv)
        last = take(sv_, torch.clamp(n1 + 2, 0, ns - 1))
        beyond = pos > (2 + 2 * n1)
        out = torch.where(is_even, even_v, odd_v)
        return torch.where(beyond, last, out)

    n_up_a = torch.where(p_angle < 90, wv + hv, wv)
    n_up_l = torch.where(p_angle > 180, wv + hv, hv)
    up_a = upsample(arow, n_up_a)
    up_l = upsample(lcol, n_up_l)
    pad_a = torch.cat([arow, arow[:, -1:].expand(k, UL - EL)], 1)
    pad_l = torch.cat([lcol, lcol[:, -1:].expand(k, UL - EL)], 1)
    ubuf_a = torch.where((ups_a > 0)[:, None], up_a, pad_a)
    ubuf_l = torch.where((ups_l > 0)[:, None], up_l, pad_l)
    aoff = torch.where(ups_a > 0, 2, 1)[:, None, None]
    loff = torch.where(ups_l > 0, 2, 1)[:, None, None]
    upa = ups_a[:, None, None]
    upl = ups_l[:, None, None]

    def interp(ub, idx):
        i0 = torch.clamp(idx, 0, UL - 1).reshape(k, -1)
        i1 = torch.clamp(idx + 1, 0, UL - 1).reshape(k, -1)
        return (take(ub, i0).reshape(k, sq, sq),
                take(ub, i1).reshape(k, sq, sq))

    dxb = dxv[:, None, None]
    dyb = dyv[:, None, None]
    wb = wv[:, None, None]
    hb = hv[:, None, None]
    # zone 1 (0 < angle < 90): from above
    idx1 = (y1 + 1) * dxb
    b1 = (idx1 >> (6 - upa)) + (x1 << upa)
    sh1 = ((idx1 << upa) >> 1) & 0x1F
    maxb_a = (wb + hb - 1) << upa
    v0, v1 = interp(ubuf_a, aoff + b1)
    z1 = _round2(v0 * (32 - sh1) + v1 * sh1, 5)
    vmaxa = take(ubuf_a, torch.clamp((aoff + maxb_a)[:, 0], 0, UL - 1))
    z1 = torch.where(b1 < maxb_a, z1, vmaxa[:, :, None])
    # zone 2 (90 < angle < 180): above or left
    idx2 = (x1 << 6) - (y1 + 1) * dxb
    b2 = idx2 >> (6 - upa)
    sh2a = ((idx2 << upa) >> 1) & 0x1F
    v0, v1 = interp(ubuf_a, aoff + b2)
    z2a = _round2(v0 * (32 - sh2a) + v1 * sh2a, 5)
    idx2l = (y1 << 6) - (x1 + 1) * dyb
    b2l = idx2l >> (6 - upl)
    sh2l = ((idx2l << upl) >> 1) & 0x1F
    v0, v1 = interp(ubuf_l, loff + b2l)
    z2l = _round2(v0 * (32 - sh2l) + v1 * sh2l, 5)
    z2 = torch.where(b2 >= -(1 << upa), z2a, z2l)
    # zone 3 (180 < angle < 270): from left
    idx3 = (x1 + 1) * dyb
    b3 = (idx3 >> (6 - upl)) + (y1 << upl)
    sh3 = ((idx3 << upl) >> 1) & 0x1F
    maxb_l = (wb + hb - 1) << upl
    v0, v1 = interp(ubuf_l, loff + b3)
    z3 = _round2(v0 * (32 - sh3) + v1 * sh3, 5)
    vmaxl = take(ubuf_l, torch.clamp((loff + maxb_l)[:, 0], 0, UL - 1))
    z3 = torch.where(b3 < maxb_l, z3, vmaxl[:, :, None])

    pa = p_angle[:, None, None]
    v90 = take(ubuf_a, aoff[:, :, 0] + ar[None, :]).reshape(k, 1, sq) \
        .expand(k, sq, sq)
    v180 = take(ubuf_l, loff[:, :, 0] + ar[None, :]).reshape(k, sq, 1) \
        .expand(k, sq, sq)
    dirp = torch.where(pa < 90, z1,
                       torch.where(pa == 90, v90,
                                   torch.where(pa < 180, z2,
                                               torch.where(pa == 180, v180,
                                                           z3))))
    dirp = torch.clamp(dirp, 0, maxv)

    m = mode[:, None, None]
    pred = dirp
    for md, p in ((SMOOTH_H_PRED, smooth_h), (SMOOTH_V_PRED, smooth_v),
                  (SMOOTH_PRED, smooth), (PAETH_PRED, paeth), (DC_PRED, dcp)):
        pred = torch.where(m == md, p, pred)
    return pred.to(torch.int32)


def cfl_indices(prm: torch.Tensor, sq: int, ssx: int, ssy: int,
                luma_shape: Tuple[int, int]) -> torch.Tensor:
    """(k, M, sq, sq) flat luma indices of each job's CfL box members,
    with aom's cfl_pad clamps (JAX ``_cfl_indices``); M is 4, 2 or 1 for
    4:2:0, 4:2:2, 4:4:4.  Lanes beyond (th, tw) repeat the clamped edge
    (the JAX plan fills them with 0; both are summed nowhere)."""
    lh, lw = luma_shape
    dev = prm.device
    p = prm.to(torch.int64)
    if ssx and ssy:
        members, sy_, sx_ = [(0, 0), (0, 1), (1, 0), (1, 1)], 2, 2
    elif ssx:
        members, sy_, sx_ = [(0, 0), (0, 1)], 1, 2
    else:
        members, sy_, sx_ = [(0, 0)], 1, 1
    ar = torch.arange(sq, device=dev)
    r = torch.minimum(ar[None, :], torch.clamp(p[:, P["bh"], None] - 1,
                                               min=0))[:, :, None]
    c = torch.minimum(ar[None, :], torch.clamp(p[:, P["bw"], None] - 1,
                                               min=0))[:, None, :]
    ly = p[:, P["ly"], None, None]
    lx = p[:, P["lx"], None, None]
    grids = []
    for dy, dx in members:
        gy = torch.clamp(ly + r * sy_ + dy, max=lh - 1)
        gx = torch.clamp(lx + c * sx_ + dx, max=lw - 1)
        grids.append(p[:, P["lbase"], None, None] + gy * lw + gx)
    return torch.stack(grids, 1)


def apply_cfl_plain(buf, sq, prm, pred, *, bd, ssx, ssy, luma_shape):
    """Chroma from luma (device_recon.py:826-848): the Q3 luma box sums,
    less their rounded average over the job, scaled by alpha, added to
    the DC prediction of CfL jobs."""
    maxv = (1 << bd) - 1
    k = prm.shape[0]
    is_cfl = prm[:, P["is_cfl"]] > 0
    if not bool(is_cfl.any()):
        return pred
    q3s = 1 if (ssx and ssy) else (2 if ssx else 3)
    alpha = prm[:, P["cfl_alpha"]]
    wv, hv = prm[:, P["wv"]], prm[:, P["hv"]]
    lg = (torch.log2(wv.float()) + torch.log2(hv.float())).to(torch.int32)
    vals = buf[cfl_indices(prm, sq, ssx, ssy, luma_shape)]
    q3 = vals.sum(1, dtype=torch.int32) << q3s
    ar = torch.arange(sq, device=buf.device)
    valid = (ar[None, None, :] < wv[:, None, None]) & \
        (ar[None, :, None] < hv[:, None, None])
    tot = torch.where(valid, q3, 0).reshape(k, -1).sum(1, dtype=torch.int32)
    avg = (tot + (1 << (lg - 1))) >> lg
    ac = q3 - avg[:, None, None]
    scaled = alpha[:, None, None] * ac
    adj = torch.where(scaled >= 0, (scaled + 32) >> 6,
                      -((-scaled + 32) >> 6))
    cflp = torch.clamp(pred + adj, 0, maxv)
    return torch.where(is_cfl[:, None, None], cflp, pred)


def predict_fi_plain(sq: int, top: torch.Tensor, lft: torch.Tensor,
                     corner: torch.Tensor, fi_mode: torch.Tensor, *,
                     bd: int) -> torch.Tensor:
    """Filter-intra prediction of k jobs (device_recon.py:850-881): the
    4x2 patches in raster order, each a 7-tap filter of the row above
    and the two samples to its left."""
    maxv = (1 << bd) - 1
    k = top.shape[0]
    dev = top.device
    taps_all = torch.as_tensor(_load()["filter_intra_taps"]) \
        .to(torch.int32).to(dev)
    taps = taps_all[torch.clamp(fi_mode, 0, 4).long()]      # (k, 8, 8)
    pb = torch.zeros((k, sq + 1, sq + 1), dtype=torch.int32, device=dev)
    pb[:, 0, 0] = corner
    pb[:, 0, 1:] = top
    pb[:, 1:, 0] = lft
    n_pc = sq // 4
    zero = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    for p in range((sq // 2) * n_pc):
        r = 1 + 2 * (p // n_pc)
        c = 1 + 4 * (p % n_pc)
        p7 = torch.cat([pb[:, r - 1, c - 1:c + 4], pb[:, r, c - 1:c],
                        pb[:, r + 1, c - 1:c], zero], 1)
        v = (taps * p7[:, None, :]).sum(2, dtype=torch.int32)
        v = torch.where(v >= 0, (v + 8) >> 4, -((-v + 8) >> 4))
        pb[:, r:r + 2, c:c + 4] = torch.clamp(v, 0, maxv).reshape(k, 2, 4)
    return pb[:, 1:, 1:]


def predict_fi_diagonal_plain(sq: int, top: torch.Tensor, lft: torch.Tensor,
                              corner: torch.Tensor, fi_mode: torch.Tensor,
                              *, bd: int) -> torch.Tensor:
    """predict_fi_plain in the order av1_intra_wave computes it: the 4x2
    patches along anti-diagonals, every patch (i, j) with i + j = d at
    step d (a patch reads patches (i-1, j-1), (i-1, j) and (i, j-1)
    only), 3sq/4 - 1 steps."""
    maxv = (1 << bd) - 1
    k = top.shape[0]
    dev = top.device
    taps_all = torch.as_tensor(_load()["filter_intra_taps"]) \
        .to(torch.int32).to(dev)
    taps = taps_all[torch.clamp(fi_mode, 0, 4).long()]      # (k, 8, 8)
    pb = torch.zeros((k, sq + 1, sq + 1), dtype=torch.int32, device=dev)
    pb[:, 0, 0] = corner
    pb[:, 0, 1:] = top
    pb[:, 1:, 0] = lft
    pr, pc = sq // 2, sq // 4
    zero = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    for d in range(pr + pc - 1):
        cells = [(1 + 2 * (d - j), 1 + 4 * j)
                 for j in range(max(0, d - pr + 1), min(d, pc - 1) + 1)]
        outs = []
        for r, c in cells:             # every patch of the step reads first
            p7 = torch.cat([pb[:, r - 1, c - 1:c + 4], pb[:, r, c - 1:c],
                            pb[:, r + 1, c - 1:c], zero], 1)
            v = (taps * p7[:, None, :]).sum(2, dtype=torch.int32)
            v = torch.where(v >= 0, (v + 8) >> 4, -((-v + 8) >> 4))
            outs.append(torch.clamp(v, 0, maxv).reshape(k, 2, 4))
        for (r, c), v in zip(cells, outs):
            pb[:, r:r + 2, c:c + 4] = v
    return pb[:, 1:, 1:]
