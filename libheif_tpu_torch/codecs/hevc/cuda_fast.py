"""Hand-written CUDA kernels of the HEVC reconstruction, and their plain
PyTorch versions.

Two stages of the JAX package's jnp device program
(libheif_tpu/codecs/hevc/device_recon.py ``_build_program``) are kernels
in ``csrc/hevc_kernels.cu``, each one launch for a whole plan, and so is
the motion compensation of P and B pictures, which the JAX package runs
in numpy on the host (recon.py):

=================  ==========================================  ===========
kernel             replaces                                    wrapper
=================  ==========================================  ===========
hevc_dequant_itx   stage A, ``residuals`` (:540-567), every    dequant_itx
                   TU group
hevc_intra_wave    stage B, ``predict`` + scatter, the whole   intra_waves
                   ``lax.scan`` over waves (:571-698,
                   :890-927), every picture
hevc_inter_pred    recon.py ``_gather`` :78, ``mc_luma_14``    inter_pred
                   :86, ``mc_chroma_14`` :113, ``weight_uni``
                   :140, ``weight_bi`` :148, ``_mc_pu``
                   :405-436: every PU of a picture
hevc_mode_search   the encoder's intra mode search,            mode_search
                   device_modes.py ``_jitted_search``
                   :161-180: every block of one size
=================  ==========================================  ===========

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version beside it, which repeats the jnp
program's int32 arithmetic operation by operation (the mode search's, its
float32 products, with TF32 off).  Every kernel carries a launch count
(``KERNELS[name].launches``).
"""

from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..._build import CudaKernel
from ..unc.cuda_fast import _on_cpu
from .ctu import INTRA_DC, INTRA_PLANAR
from .tables import DCT, DST4, INTRA_INV_ANGLE, INTRA_PRED_ANGLE

_P, _I = ctypes.c_void_p, ctypes.c_int

HEVC_DEQUANT_ITX = CudaKernel(
    "hevc_dequant_itx", "launch_hevc_dequant_itx", [_P, _I, _I, _P])
HEVC_INTRA_WAVE = CudaKernel(
    "hevc_intra_wave", "launch_hevc_intra_wave",
    [_P, _I, _P, _I, _I, _P, _P, _I, _I])
# hevc_intra_wave's chain-bound probe (off the decode path, no plain
# version): `steps` steps of one store, the wave barrier and one dependent
# load, with the wave kernel's launch shape
HEVC_WAVE_PROBE = CudaKernel(
    "hevc_wave_probe", "launch_hevc_wave_probe", [_P, _I, _I])

HEVC_INTER_PRED = CudaKernel(
    "hevc_inter_pred", "launch_hevc_inter_pred",
    [_P, _I, _P, _P, _I, _I, _I, _P, _P])

HEVC_MODE_SEARCH = CudaKernel(
    "hevc_mode_search", "launch_hevc_mode_search",
    [_P, _P, _I, _I, _P, _P])

KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (HEVC_DEQUANT_ITX, HEVC_INTRA_WAVE, HEVC_INTER_PRED,
                        HEVC_MODE_SEARCH)}

LEVEL_SCALE = (40, 45, 51, 57, 64, 72)
MAX_GROUPS = 7          # kMaxGroups in csrc/hevc_kernels.cu
MTAB_SIDE = 32          # a factor-table slot: (32, 32), the TU's top left

# prediction angles as dense tables indexed by mode 0..34
ANGLE = np.zeros(35, np.int32)
INV_ANGLE = np.zeros(35, np.int32)
for _m in range(2, 35):
    ANGLE[_m] = INTRA_PRED_ANGLE[_m]
    if INTRA_PRED_ANGLE[_m] < 0:
        INV_ANGLE[_m] = INTRA_INV_ANGLE[INTRA_PRED_ANGLE[_m]]


def transform_matrix(luma: bool, log2: int, device,
                     inter: bool = False) -> torch.Tensor:
    """The (s, s) int32 inverse-transform matrix of a TU group: DST-VII
    for intra luma 4x4, else the DCT of its size (an ``inter`` luma 4x4
    too); the plain version's operand, the kernel has the coefficients as
    constants."""
    m = DST4 if (luma and log2 == 2 and not inter) else DCT[1 << log2]
    return torch.as_tensor(np.asarray(m, np.int32), device=device)


# --------------------------------------------------------- hevc_dequant_itx

class ItxGroup(NamedTuple):
    """One TU group's stage-A inputs: ``coeffs`` (n, s, s) int32 levels,
    ``qp`` (n,) int32, ``ts``/``tqb`` (n,) bool (transform skip,
    transquant bypass), ``mslot`` (n,) int32: each TU's slot in the plan's
    scaling-factor table (0: the flat factor 16).  ``inter``: the TUs of
    inter CUs, whose 4x4 luma transform is the DCT, not the DST-VII
    (H.265 §8.6.4.2)."""
    luma: bool
    log2: int
    coeffs: torch.Tensor
    qp: torch.Tensor
    ts: torch.Tensor
    tqb: torch.Tensor
    mslot: torch.Tensor
    inter: bool = False

    @property
    def dst(self) -> bool:
        """The group's transform is the DST-VII."""
        return self.luma and self.log2 == 2 and not self.inter


def dequant_itx(groups: Sequence[ItxGroup], *, bd: int,
                mtab: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Stage A for every TU group of a plan, one launch: each group's
    (n, s, s) int32 residuals.  Dequantise, clip, the column then the row
    pass of the inverse DST-VII (luma 4x4) or DCT with HEVC's shifts and
    clips, transform skip (4x4) and transquant bypass.  ``mtab`` (slots,
    32, 32) uint8 holds the scaling factors m[y][x] (a TU of side s reads
    the top left s x s of its slot; slot 0 is the flat 16), or is None
    when no picture of the plan has scaling lists (every slot then 0)."""
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} groups, got {len(groups)}")
    if mtab is not None and (mtab.dtype != torch.uint8 or mtab.dim() != 3
                             or tuple(mtab.shape[1:]) != (MTAB_SIDE,
                                                          MTAB_SIDE)):
        raise ValueError(f"mtab: expected (slots, {MTAB_SIDE}, {MTAB_SIDE})"
                         f" uint8, got {tuple(mtab.shape)} {mtab.dtype}")
    for g in groups:
        s = 1 << g.log2
        n = g.coeffs.shape[0]
        if g.coeffs.dtype != torch.int32 or \
                tuple(g.coeffs.shape[1:]) != (s, s):
            raise ValueError(f"coeffs: expected (N, {s}, {s}) int32, got "
                             f"{tuple(g.coeffs.shape)} {g.coeffs.dtype}")
        for t, name, dt in ((g.qp, "qp", torch.int32),
                            (g.ts, "ts", torch.bool),
                            (g.tqb, "tqb", torch.bool),
                            (g.mslot, "mslot", torch.int32)):
            if t.dtype != dt or tuple(t.shape) != (n,):
                raise ValueError(f"{name}: expected ({n},) {dt}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    if not groups:
        return []
    extra = () if mtab is None else (mtab,)
    if _on_cpu(*(t for g in groups
                 for t in (g.coeffs, g.qp, g.ts, g.tqb, g.mslot)), *extra):
        return [dequant_itx_plain(
            g.coeffs, g.qp, g.ts, g.tqb,
            transform_matrix(g.luma, g.log2, g.coeffs.device, g.inter),
            log2=g.log2,
            bd=bd, mslot=g.mslot, mtab=mtab) for g in groups]
    outs = [torch.empty_like(g.coeffs) for g in groups]
    for t in [g.coeffs for g in groups] + outs:
        if t.data_ptr() % 16:
            raise ValueError("hevc_dequant_itx: coefficients and residuals "
                             "must be 16-byte aligned")
    table = (ctypes.c_longlong * (9 * len(groups)))(*(
        v for g, o in zip(groups, outs)
        for v in (g.coeffs.data_ptr(), g.qp.data_ptr(), g.ts.data_ptr(),
                  g.tqb.data_ptr(), g.mslot.data_ptr(), o.data_ptr(),
                  g.coeffs.shape[0], g.log2, int(g.dst))))
    HEVC_DEQUANT_ITX.launch(max(outs, key=torch.Tensor.numel),
                            ctypes.addressof(table), len(groups), bd,
                            0 if mtab is None else mtab.data_ptr())
    return outs


def dequant_itx_plain(coeffs, qp, ts, tqb, mat, *, log2, bd, mslot=None,
                      mtab=None, chunk=4096):
    """Plain PyTorch version of hevc_dequant_itx: device_recon.py:540-567
    with each int32 matrix product as an int64 broadcast product and sum
    (CUDA has no integer matmul); every sum is below 2^31, so the int32
    result is exact.  A TU of slot 0 dequantises with the flat factor in
    the jnp program's wrapping int32; any other slot (``mslot``, into
    ``mtab`` as for dequant_itx) as JAX ``recon.dequant`` does, in int64:
    (c*m*levelScale<<(qp/6) + 2^(bs-1)) >> bs.  Done ``chunk`` TUs at a
    time to bound the (N, s, s, s) temporaries."""
    s = 1 << log2
    bs = bd + log2 - 5
    dev = coeffs.device
    lvl = torch.tensor(LEVEL_SCALE, dtype=torch.int32, device=dev)
    m = mat.to(torch.int64)
    shift2 = 20 - bd
    out = torch.empty_like(coeffs)
    for lo in range(0, coeffs.shape[0], chunk):
        c = coeffs[lo:lo + chunk]
        q = qp[lo:lo + chunk]
        scale = lvl[q % 6] << (q // 6)
        # (c*16*scale + 2^(bs-1)) >> bs  ==  (c*scale + 2^(bs-5)) >> (bs-4)
        d = (c * scale[:, None, None] + (1 << (bs - 5))) >> (bs - 4)
        d = torch.clamp(d, -32768, 32767)
        if mtab is not None:
            ms = mslot[lo:lo + chunk]
            lists = ms != 0
            if bool(lists.any()):
                m_f = mtab[ms.to(torch.int64), :s, :s].to(torch.int64)
                dl = (c.to(torch.int64) * m_f
                      * scale.to(torch.int64)[:, None, None]
                      + (1 << (bs - 1))) >> bs
                dl = torch.clamp(dl, -32768, 32767).to(torch.int32)
                d = torch.where(lists[:, None, None], dl, d)
        # e[n, j, k] = sum_i m[i, j] d[n, i, k]
        e = (d.to(torch.int64)[:, :, None, :] * m[None, :, :, None]).sum(1)
        e = torch.clamp((e + 64) >> 7, -32768, 32767)
        # r[n, i, k] = sum_j e[n, i, j] m[j, k]
        r = (e[:, :, :, None] * m[None, None, :, :]).sum(2)
        r = torch.clamp((r + (1 << (shift2 - 1))) >> shift2, -32768, 32767)
        r = r.to(torch.int32)
        if s == 4:      # transform skip only exists at 4x4
            tsr = ((d << (5 + log2)) + (1 << (shift2 - 1))) >> shift2
            r = torch.where(ts[lo:lo + chunk, None, None], tsr, r)
        out[lo:lo + chunk] = torch.where(tqb[lo:lo + chunk, None, None], c, r)
    return out


# --------------------------------------------------------- hevc_intra_wave

class WaveGroup(NamedTuple):
    """One TU group's tables as hevc_intra_wave reads them: rows sorted by
    wave; ``ref_idx``/``ref_avail`` (n, 4s+1) int32/bool, ``mode`` (n,)
    int32, ``scat_idx`` (n, s*s) int32 flat indices into the luma or
    chroma buffer, ``res`` (n, s, s) int32 residuals."""
    luma: bool
    log2: int
    ref_idx: torch.Tensor
    ref_avail: torch.Tensor
    mode: torch.Tensor
    scat_idx: torch.Tensor
    res: torch.Tensor


def intra_waves(ybuf: torch.Tensor, cbuf: torch.Tensor,
                groups: Sequence[WaveGroup], rows: torch.Tensor, *, bd: int,
                strong: bool) -> None:
    """Stage B for a whole plan, in place, one launch: every wave of every
    picture; for each TU predict from the reference samples in the flat
    int32 buffers, add the residual, clip to [0, 2^bd - 1] and scatter it
    into its buffer.  ``rows`` (G, n_waves, T+1) int32: the rows of group
    g, wave w and picture t are rows[g, w, t] .. rows[g, w, t+1] (the
    plan's ``wave_rows``).  A TU reads samples of its own picture written
    by earlier waves only (the planner's schedule), so the kernel walks
    each picture's waves on its own, one block a picture; the plain
    version walks the waves in lockstep."""
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"at most {MAX_GROUPS} groups, got {len(groups)}")
    for buf, name in ((ybuf, "ybuf"), (cbuf, "cbuf")):
        if buf.dtype != torch.int32 or buf.dim() != 1:
            raise ValueError(f"{name}: expected a flat int32 tensor")
    if rows.dtype != torch.int32 or rows.dim() != 3 or \
            rows.shape[0] != len(groups) or rows.shape[2] < 2:
        raise ValueError(f"rows: expected ({len(groups)}, n_waves, T+1) "
                         f"int32, got {tuple(rows.shape)} {rows.dtype}")
    if _on_cpu(ybuf, cbuf, rows, *(t for g in groups for t in g[2:])):
        starts = rows[:, :, 0].T.tolist()
        counts = (rows[:, :, -1] - rows[:, :, 0]).T.tolist()
        for st, cn in zip(starts, counts):
            intra_wave_plain(ybuf, cbuf, groups, st, cn, bd=bd,
                             strong=strong)
        return
    if not groups:
        return
    table = (ctypes.c_longlong * (7 * len(groups)))(*(
        v for g in groups
        for v in (g.ref_idx.data_ptr(), g.ref_avail.data_ptr(),
                  g.mode.data_ptr(), g.scat_idx.data_ptr(),
                  g.res.data_ptr(), g.log2, int(g.luma))))
    HEVC_INTRA_WAVE.launch(ybuf, ctypes.addressof(table), len(groups),
                           rows.data_ptr(), rows.shape[1], rows.shape[2] - 1,
                           ybuf.data_ptr(), cbuf.data_ptr(), bd, int(strong))


def wave_probe(buf: torch.Tensor, steps: int) -> None:
    """hevc_intra_wave's chain-bound probe on the card: one block per
    element of the int32 ``buf``, ``steps`` dependent steps."""
    if buf.dtype != torch.int32 or buf.dim() != 1 or buf.device.type != \
            "cuda":
        raise ValueError("wave_probe: a flat int32 CUDA tensor")
    HEVC_WAVE_PROBE.launch(buf, buf.data_ptr(), buf.numel(), steps)


def intra_wave_plain(ybuf, cbuf, groups, starts, counts, *, bd, strong):
    """Plain PyTorch version of one wave of hevc_intra_wave: the body of
    the jnp program's wave scan (device_recon.py:893-924), one group after
    the other, on rows starts[g] .. starts[g] + counts[g] of each group."""
    maxv = (1 << bd) - 1
    for g, st, cn in zip(groups, starts, counts):
        if cn == 0:
            continue
        buf = ybuf if g.luma else cbuf
        rows = slice(st, st + cn)
        refs = buf[g.ref_idx[rows]]
        pred = predict_plain(g.luma, g.log2, refs, g.ref_avail[rows],
                             g.mode[rows], bd=bd, strong=strong)
        n = 1 << g.log2
        rec = torch.clamp(pred + g.res[rows], 0, maxv).reshape(cn, n * n)
        buf[g.scat_idx[rows].reshape(-1)] = rec.reshape(-1)


def intra_waves_by_picture_plain(ybuf, cbuf, groups, rows, *, bd, strong):
    """Stage B in the order hevc_intra_wave walks it: picture after
    picture, each picture's waves in order, every group of a wave; rows as
    for intra_waves.  The tests hold it equal to the lockstep order."""
    r = rows.tolist()
    for t in range(rows.shape[2] - 1):
        for w in range(rows.shape[1]):
            intra_wave_plain(ybuf, cbuf, groups, [g[w][t] for g in r],
                             [g[w][t + 1] - g[w][t] for g in r], bd=bd,
                             strong=strong)


def predict_plain(luma: bool, log2: int, refs: torch.Tensor,
                  av: torch.Tensor, mode: torch.Tensor, *, bd: int,
                  strong: bool) -> torch.Tensor:
    """Intra prediction of k TUs of one size (device_recon.py:571-698):
    refs/av (k, 4n+1) in the order left column bottom→top, corner, top
    row; returns (k, n, n) int32."""
    n = 1 << log2
    L = 4 * n + 1
    ci = 2 * n
    k = refs.shape[0]
    dev = refs.device
    half = 1 << (bd - 1)
    maxv = (1 << bd) - 1

    # substitution (recon.py:_gather_refs): each missing sample takes the
    # nearest available one before it, else the first available one
    j = torch.arange(L, dtype=torch.int32, device=dev).expand(k, L)
    vidx = torch.where(av, j, torch.full_like(j, -1))
    ff = torch.cummax(vidx, dim=1).values
    first = av.to(torch.int32).argmax(dim=1).to(torch.int32)
    fidx = torch.where(ff >= 0, ff, first[:, None])
    vals = torch.gather(refs, 1, fidx.to(torch.int64))
    vals = torch.where(av.any(dim=1)[:, None], vals,
                       torch.full_like(vals, half))

    # reference filtering (recon.py:_filter_refs)
    if luma and n > 4:
        sm = torch.cat([
            vals[:, :1],
            (vals[:, :-2] + 2 * vals[:, 1:-1] + vals[:, 2:] + 2) >> 2,
            vals[:, -1:]], dim=1)
        if n == 32 and strong:
            cv = vals[:, ci]
            v0 = vals[:, 0]
            v4n = vals[:, 4 * n]
            flat_top = torch.abs(cv + v4n - 2 * vals[:, ci + n]) \
                < (1 << (bd - 5))
            flat_left = torch.abs(cv + v0 - 2 * vals[:, n]) < (1 << (bd - 5))
            i_rel = j - ci                               # -2n..2n
            a = torch.abs(i_rel)
            endv = torch.where(i_rel > 0, v4n[:, None], v0[:, None])
            bil = ((2 * n - a) * cv[:, None] + a * endv + n) >> (log2 + 1)
            bil = torch.where((a >= 1) & (a <= 2 * n - 1), bil, vals)
            sm = torch.where((flat_top & flat_left)[:, None], bil, sm)
        dist = torch.minimum(torch.abs(mode - 26), torch.abs(mode - 10))
        thresh = {8: 7, 16: 1, 32: 0}[n]
        use = (mode != INTRA_DC) & ((mode == INTRA_PLANAR) | (dist > thresh))
        vals = torch.where(use[:, None], sm, vals)

    corner = vals[:, ci]                                 # (k,)
    left = torch.flip(vals[:, :ci], dims=(1,))           # (k, 2n), y = i
    top = vals[:, ci + 1:]                               # (k, 2n), x = i

    ar = torch.arange(n, dtype=torch.int32, device=dev)
    x1 = ar[None, :].expand(n, n)                        # column index
    y1 = ar[:, None].expand(n, n)                        # row index

    # planar
    tr = top[:, n][:, None, None]
    bl = left[:, n][:, None, None]
    planar = ((n - 1 - x1)[None] * left[:, :n][:, :, None] + (x1 + 1)[None]
              * tr + (n - 1 - y1)[None] * top[:, :n][:, None, :]
              + (y1 + 1)[None] * bl + n) >> (log2 + 1)

    # DC, with its edge filter for luma below 32x32
    dc = (top[:, :n].sum(dim=1, dtype=torch.int32)
          + left[:, :n].sum(dim=1, dtype=torch.int32) + n) >> (log2 + 1)
    dcp = dc[:, None, None].expand(k, n, n)
    if luma and n < 32:
        row0 = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        col0 = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        c00 = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dcp = torch.where((y1 == 0)[None], row0[:, None, :], dcp)
        dcp = torch.where((x1 == 0)[None], col0[:, :, None], dcp).clone()
        dcp[:, 0, 0] = c00

    # angular: ext[e] = ref[e - n] along the main direction, e in [0, 3n]
    mc = torch.clamp(mode, 0, 34).to(torch.int64)
    angle = torch.as_tensor(ANGLE, device=dev)[mc]
    inv = torch.as_tensor(INV_ANGLE, device=dev)[mc]
    vertical = mode >= 18
    main = torch.where(vertical[:, None], top, left)
    side = torch.where(vertical[:, None], left, top)
    ext_len = 3 * n + 1
    xneg = torch.arange(-n, 0, dtype=torch.int32, device=dev)
    nidx = (xneg[None, :] * inv[:, None] + 128) >> 8     # (k, n) >= 0
    nval = torch.where(
        nidx == 0, corner[:, None],
        torch.gather(side, 1,
                     torch.clamp(nidx - 1, 0, 2 * n - 1).to(torch.int64)))
    ext = torch.cat([nval, corner[:, None], main], dim=1)
    kk = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    prod = kk[None, :] * angle[:, None]                  # (k, n)
    i_fact = prod & 31
    base = n + (prod >> 5) + 1
    idx0 = torch.clamp(base[:, :, None] + ar[None, None, :], max=ext_len - 1)
    idx1 = torch.clamp(idx0 + 1, max=ext_len - 1)
    e0 = torch.gather(ext, 1, idx0.reshape(k, -1).to(torch.int64)) \
        .reshape(k, n, n)
    e1 = torch.gather(ext, 1, idx1.reshape(k, -1).to(torch.int64)) \
        .reshape(k, n, n)
    f = i_fact[:, :, None]
    ang = ((32 - f) * e0 + f * e1 + 16) >> 5             # rows = distance
    ang = torch.where(vertical[:, None, None], ang, ang.transpose(1, 2))
    if luma and n < 32:
        # pure vertical (26) / horizontal (10) edge filter
        col = torch.clamp(top[:, 0][:, None]
                          + ((left[:, :n] - corner[:, None]) >> 1), 0, maxv)
        row = torch.clamp(left[:, 0][:, None]
                          + ((top[:, :n] - corner[:, None]) >> 1), 0, maxv)
        is26 = (mode == 26)[:, None, None]
        is10 = (mode == 10)[:, None, None]
        ang = torch.where(is26 & (x1 == 0)[None], col[:, :, None], ang)
        ang = torch.where(is10 & (y1 == 0)[None], row[:, None, :], ang)

    return torch.where((mode == INTRA_PLANAR)[:, None, None], planar,
                       torch.where((mode == INTRA_DC)[:, None, None], dcp,
                                   ang)).to(torch.int32)


# ---------------------------------------------------------- hevc_inter_pred

INTER_SIDE = 16          # kInterSide: a job's luma side at most
INTER_JOB_COLS = 10      # x y w h slot0 mv0x mv0y slot1 mv1x mv1y

# HEVC's interpolation filters (spec 8.5.4.2.2.1/2.2.2, recon.py _QFILT,
# _CFILT); phase 0 copies
LUMA_TAPS = np.array([[0, 0, 0, 64, 0, 0, 0, 0],
                      [-1, 4, -10, 58, 17, -5, 1, 0],
                      [-1, 4, -11, 40, 40, -11, 4, -1],
                      [0, 1, -5, 17, 58, -10, 4, -1]], np.int64)
CHROMA_TAPS = np.array([[0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2],
                        [-6, 46, 28, -4], [-4, 36, 36, -4], [-4, 28, 46, -6],
                        [-2, 16, 54, -4], [-2, 10, 58, -2]], np.int64)


def inter_jobs(pus: np.ndarray) -> np.ndarray:
    """PU rows (n, 10) int32 [x y w h slot0 mv0x mv0y slot1 mv1x mv1y]
    → hevc_inter_pred's jobs: each PU cut into sub-blocks of at most
    INTER_SIDE x INTER_SIDE luma samples (the same columns; each output
    sample depends only on its position and its PU's motion)."""
    pus = np.asarray(pus, np.int32).reshape(-1, INTER_JOB_COLS)
    if not len(pus):
        return pus
    nx = -(-pus[:, 2] // INTER_SIDE)
    ny = -(-pus[:, 3] // INTER_SIDE)
    cnt = nx * ny
    rep = np.repeat(np.arange(len(pus)), cnt)
    k = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    jx = (k % nx[rep]) * INTER_SIDE
    jy = (k // nx[rep]) * INTER_SIDE
    jobs = pus[rep].copy()
    jobs[:, 0] += jx
    jobs[:, 1] += jy
    jobs[:, 2] = np.minimum(pus[rep, 2] - jx, INTER_SIDE)
    jobs[:, 3] = np.minimum(pus[rep, 3] - jy, INTER_SIDE)
    return np.ascontiguousarray(jobs, np.int32)


def inter_pred(jobs: torch.Tensor, ydpb: torch.Tensor, cdpb: torch.Tensor,
               ybuf: torch.Tensor, cbuf: torch.Tensor, *, bd: int) -> None:
    """Motion-compensated prediction of one picture, in place, one launch:
    for every job (a row of ``jobs`` (n, 10) int32 from inter_jobs) the
    luma prediction with the 8-tap quarter-sample filter and the chroma
    prediction (4:2:0, at x>>1, y>>1, size max(w>>1, 1)) with the 4-tap
    eighth-sample filter, at HEVC's 14-bit intermediate precision, then
    default weighting (uni or bi), written into the picture's flat int32
    buffers ``ybuf`` (at least H*W) and ``cbuf`` (at least 2*(H/2)*(W/2),
    Cb then Cr).  References are DPB slots: ``ydpb`` (slots, H, W) and
    ``cdpb`` (slots, 2, H/2, W/2) int32, read with every coordinate
    clamped to the uncropped picture; slot -1 leaves a list unused."""
    if jobs.dtype != torch.int32 or jobs.dim() != 2 or \
            jobs.shape[1] != INTER_JOB_COLS:
        raise ValueError(f"jobs: expected (N, {INTER_JOB_COLS}) int32, got "
                         f"{tuple(jobs.shape)} {jobs.dtype}")
    if ydpb.dim() != 3 or cdpb.dim() != 4 or cdpb.shape[1] != 2:
        raise ValueError("ydpb (slots, H, W), cdpb (slots, 2, H/2, W/2)")
    S, H, W = ydpb.shape
    if tuple(cdpb.shape) != (S, 2, H >> 1, W >> 1):
        raise ValueError(f"cdpb {tuple(cdpb.shape)} does not match ydpb "
                         f"{tuple(ydpb.shape)}")
    for t, name in ((ydpb, "ydpb"), (cdpb, "cdpb"), (ybuf, "ybuf"),
                    (cbuf, "cbuf")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor")
    if ybuf.numel() < H * W or cbuf.numel() < 2 * (H >> 1) * (W >> 1):
        raise ValueError("ybuf/cbuf smaller than the picture")
    if not 8 <= bd <= 12:
        raise ValueError(f"bit depth {bd} outside 8..12")
    if _on_cpu(jobs, ydpb, cdpb, ybuf, cbuf):
        inter_pred_plain(jobs, ydpb, cdpb, ybuf, cbuf, bd=bd)
        return
    jobs = jobs.contiguous()
    HEVC_INTER_PRED.launch(jobs, jobs.data_ptr(), jobs.shape[0],
                           ydpb.data_ptr(), cdpb.data_ptr(), W, H, bd,
                           ybuf.data_ptr(), cbuf.data_ptr())


def predict14_plain(ref: torch.Tensor, slot, bx, by, mvx, mvy, *,
                    taps: np.ndarray, frac_bits: int, side: int,
                    bd: int) -> torch.Tensor:
    """The 14-bit prediction (n, side, side) int64 of n blocks of one
    plane (recon.py mc_luma_14 / mc_chroma_14): ``ref`` (slots, h, w), the
    block at (bx, by), motion (mvx, mvy) in units of 2^-frac_bits sample;
    every reference coordinate clamped to the plane (recon.py _gather)."""
    dev = ref.device
    K = taps.shape[1]
    P = K // 2 - 1
    S = side + K - 1
    _, ph, pw = ref.shape
    xi, yi = bx + (mvx >> frac_bits), by + (mvy >> frac_bits)
    fx, fy = mvx & ((1 << frac_bits) - 1), mvy & ((1 << frac_bits) - 1)
    off = torch.arange(S, device=dev) - P
    rows = torch.clamp(yi[:, None] + off[None], 0, ph - 1)
    cols = torch.clamp(xi[:, None] + off[None], 0, pw - 1)
    win = ref[slot[:, None, None], rows[:, :, None], cols[:, None, :]] \
        .to(torch.int64)                                   # (n, S, S)
    t = torch.as_tensor(taps, device=dev)
    tx, ty = t[fx], t[fy]                                  # (n, K)
    shift1, shift3 = bd - 8, 14 - bd
    hp = sum(tx[:, k, None, None] * win[:, :, k:k + side]
             for k in range(K)) >> shift1                  # (n, S, side)
    full = win[:, P:P + side, P:P + side] << shift3
    h_only = hp[:, P:P + side]
    v_only = sum(ty[:, k, None, None] * win[:, k:k + side, P:P + side]
                 for k in range(K)) >> shift1
    hv = sum(ty[:, k, None, None] * hp[:, k:k + side]
             for k in range(K)) >> 6
    fx0 = (fx == 0)[:, None, None]
    fy0 = (fy == 0)[:, None, None]
    return torch.where(fx0 & fy0, full, torch.where(
        fy0, h_only, torch.where(fx0, v_only, hv)))


def weight_plain(v0: torch.Tensor, v1: torch.Tensor, use0: torch.Tensor,
                 use1: torch.Tensor, bd: int) -> torch.Tensor:
    """Default weighted sample prediction (recon.py weight_uni, weight_bi)
    of two lists' 14-bit predictions; ``use0``/``use1`` (n,) bool."""
    maxv = (1 << bd) - 1
    su, sb = 14 - bd, 15 - bd
    uni = torch.where(use0[:, None, None], v0, v1)
    wu = torch.clamp((uni + (1 << (su - 1))) >> su, 0, maxv)
    wb = torch.clamp((v0 + v1 + (1 << (sb - 1))) >> sb, 0, maxv)
    return torch.where((use0 & use1)[:, None, None], wb, wu)


def inter_pred_plain(jobs, ydpb, cdpb, ybuf, cbuf, *, bd: int,
                     chunk: int = 4096) -> None:
    """Plain PyTorch version of hevc_inter_pred (recon.py _mc_pu over the
    jobs), ``chunk`` jobs at a time; arguments as for inter_pred."""
    S, H, W = ydpb.shape
    cw, ch = W >> 1, H >> 1
    dev = ydpb.device
    for lo in range(0, jobs.shape[0], chunk):
        j = jobs[lo:lo + chunk].to(dev, torch.int64)
        x, y, w, h = j[:, 0], j[:, 1], j[:, 2], j[:, 3]
        s0, s1 = j[:, 4], j[:, 7]
        use0, use1 = s0 >= 0, s1 >= 0
        for plane in range(3):
            luma = plane == 0
            side = INTER_SIDE if luma else INTER_SIDE // 2
            ref = ydpb if luma else cdpb[:, plane - 1]
            bx, by = (x, y) if luma else (x >> 1, y >> 1)
            bw = w if luma else torch.clamp(w >> 1, min=1)
            bh = h if luma else torch.clamp(h >> 1, min=1)
            kw = dict(taps=LUMA_TAPS if luma else CHROMA_TAPS,
                      frac_bits=2 if luma else 3, side=side, bd=bd)
            v = [predict14_plain(ref, torch.clamp(s, min=0), bx, by,
                                 j[:, 5 + 3 * l], j[:, 6 + 3 * l], **kw)
                 for l, s in ((0, s0), (1, s1))]
            pred = weight_plain(v[0], v[1], use0, use1, bd)
            pw, ph = (W, H) if luma else (cw, ch)
            r = torch.arange(side, device=dev)
            yy = by[:, None, None] + r[None, :, None]
            xx = bx[:, None, None] + r[None, None, :]
            ok = (r[None, :, None] < bh[:, None, None]) & \
                (r[None, None, :] < bw[:, None, None]) & (yy < ph) & (xx < pw)
            base = 0 if luma else (plane - 1) * ch * cw
            buf = ybuf if luma else cbuf
            buf[(base + yy * pw + xx)[ok]] = pred[ok].to(torch.int32)


# ------------------------------------------------------------ mode search

MODE_TAPS = 4           # the most taps a predicted sample has
# the plain search's (chunk, 35, n^2) float32 intermediates: 2^28 bytes each
PLAIN_CHUNK_BYTES = 1 << 28


@lru_cache(maxsize=None)
def mode_taps(log2: int):
    """The non-zero taps of every predicted sample of every mode but DC,
    from ``device_modes.weight_matrix``: (35, n^2, 4) int32 reference
    indices and float32 weights, in ascending index order, padded with
    weight 0.  DC's rows are left empty: its weight matrix is the mean of
    2n references (checked here).  hevc_mode_search computes these taps
    from the mode and the sample's place; this table checks that no
    sample has more than four and counts the function's multiply-adds."""
    from .device_modes import MODES, weight_matrix
    n = 1 << log2
    idx = np.zeros((len(MODES), n * n, MODE_TAPS), np.int32)
    w = np.zeros((len(MODES), n * n, MODE_TAPS), np.float32)
    for m in MODES:
        W = weight_matrix(m, log2)
        if m == 1:
            corner = 2 * n
            want = np.zeros(4 * n + 1, np.float32)
            want[corner - n:corner] = want[corner + 1:corner + n + 1] = \
                1.0 / (2 * n)
            assert (W == want[None, :]).all(), "DC is not the mean"
            continue
        for j in range(n * n):
            nz = np.nonzero(W[j])[0]
            assert len(nz) <= MODE_TAPS, (m, log2, j)
            idx[m, j, :len(nz)] = nz
            w[m, j, :len(nz)] = W[j, nz]
    return idx, w


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check_search(blocks: torch.Tensor, refs: torch.Tensor, log2: int):
    n = 1 << log2
    if log2 not in (3, 4, 5):
        raise ValueError(f"log2 {log2}: the search takes 8, 16 and 32")
    if blocks.dtype != torch.float32 or blocks.dim() != 2 or \
            blocks.shape[1] != n * n:
        raise ValueError(f"blocks: expected (N, {n * n}) float32, got "
                         f"{tuple(blocks.shape)} {blocks.dtype}")
    if refs.dtype != torch.float32 or \
            tuple(refs.shape) != (blocks.shape[0], 4 * n + 1):
        raise ValueError(f"refs: expected ({blocks.shape[0]}, {4 * n + 1}) "
                         f"float32, got {tuple(refs.shape)} {refs.dtype}")


def mode_search_plain(blocks: torch.Tensor, refs: torch.Tensor, log2: int):
    """``_jitted_search`` in torch float32 with TF32 off, in chunks of
    blocks: every mode's prediction as the dense weight product, the
    residual, H/sqrt(n) R H/sqrt(n), the sum of absolute values, the first
    least.  Returns (modes (N,) int32, least costs (N,) float32)."""
    from .device_modes import all_weights, hadamard
    _check_search(blocks, refs, log2)
    n = 1 << log2
    dev = blocks.device
    W = torch.from_numpy(all_weights(log2)).to(dev)
    H = torch.from_numpy(hadamard(n) / np.sqrt(n)).to(torch.float32).to(dev)
    chunk = max(1, PLAIN_CHUNK_BYTES // (4 * W.shape[0] * n * n))
    modes, costs = [], []
    with _no_tf32():
        for i in range(0, blocks.shape[0], chunk):
            b, r = blocks[i:i + chunk], refs[i:i + chunk]
            preds = torch.einsum("nk,mjk->nmj", r, W)
            res = (preds - b[:, None, :]).reshape(b.shape[0], -1, n, n)
            t = torch.einsum("ij,nmjk,kl->nmil", H, res, H)
            cost = t.abs().sum(dim=(2, 3))
            best = torch.argmin(cost, dim=1)
            modes.append(best.to(torch.int32))
            costs.append(cost.gather(1, best[:, None])[:, 0])
    if not modes:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.float32, device=dev))
    return torch.cat(modes), torch.cat(costs)


def mode_search(blocks: torch.Tensor, refs: torch.Tensor, log2: int):
    """The first mode of least SATD of every n x n block (n = 2^log2) from
    its samples and 4n+1 references (``device_modes.extract_blocks``), one
    launch: (modes (N,) int32, least costs (N,) float32)."""
    _check_search(blocks, refs, log2)
    if _on_cpu(blocks.contiguous(), refs.contiguous()):
        return mode_search_plain(blocks, refs, log2)
    blocks, refs = blocks.contiguous(), refs.contiguous()
    n_blocks = blocks.shape[0]
    if n_blocks >= 1 << 31:
        raise ValueError("more than 2^31 - 1 blocks")
    modes = torch.empty(n_blocks, dtype=torch.int32, device=blocks.device)
    costs = torch.empty(n_blocks, dtype=torch.float32, device=blocks.device)
    HEVC_MODE_SEARCH.launch(modes, blocks.data_ptr(), refs.data_ptr(),
                            n_blocks, log2, modes.data_ptr(),
                            costs.data_ptr())
    return modes, costs
