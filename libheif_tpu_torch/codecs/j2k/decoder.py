"""JPEG 2000 decoder: codestream → component planes.

Pipeline: marker parse (host) → tier-2 packet decode (host) →
EBCOT tier-1 per code-block (host, serial like CABAC) → dequantize +
inverse DWT + inverse MCT (vectorized numpy).  Reference analog:
libheif's OpenJPEG decoder plugin (plugins/decoder_openjpeg.cc).

Counterpart of libheif_tpu/codecs/j2k/decoder.py: all of it runs on the
host, the code-blocks on a pool of up to 8 threads through the C++
block coders (t1.py, htj2k.py).  Its parts are the spans
``j2k.decode.parse`` (markers and packets), ``.t1`` and ``.dwt``
(dequantisation, synthesis, inverse MCT, level shift; core/trace.py).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core import trace
from ...core.error import HeifError
from . import codestream as csm
from . import dwt
from .codestream import Codestream, ceil_div
from .htj2k import decode_cleanup, decode_refinement
from .t1 import T1Decoder
from .t2 import HeaderBitReader, TagTree, read_numpasses


@dataclass
class _CblkState:
    x0: int
    y0: int
    x1: int
    y1: int
    data: bytearray = field(default_factory=bytearray)
    num_passes: int = 0
    included: bool = False
    zero_planes: int = 0
    lblock: int = 3


class _Precinct:
    def __init__(self, blocks, ncw, nch):
        self.cblks = [_CblkState(*b) for b in blocks]
        self.ncw, self.nch = ncw, nch
        self.incl_tree = TagTree(ncw, nch)
        self.imsb_tree = TagTree(ncw, nch)


def decode_codestream(data: bytes, max_layers: Optional[int] = None,
                      reduce_levels: int = 0) -> Tuple[List[np.ndarray], Codestream]:
    """Decode a raw J2K codestream.  Returns (planes, parsed codestream);
    planes are int32 (or float32 for irreversible) arrays, one per
    component, at full resolution, already level-shifted to unsigned
    range when the component is unsigned."""
    try:
        with trace.span("j2k.decode.parse"):
            cs = csm.parse_codestream(data)
        return J2KDecoder(cs).decode(max_layers=max_layers), cs
    except (IndexError, ValueError, EOFError, KeyError) as e:
        # truncated/corrupt codestreams must surface as decode errors,
        # not raw container exceptions (ref: error propagation in
        # jpeg2000_dec.cc)
        raise HeifError.invalid_input(
            msg=f"corrupt JPEG 2000 codestream: {type(e).__name__}")


class J2KDecoder:
    def __init__(self, cs: Codestream):
        self.cs = cs
        if cs.cod.cbstyle not in (0, 0x40):
            # selective bypass / reset / termall / causal / segsym / mixed HT
            raise HeifError.invalid_input(
                msg="unsupported code-block style 0x%x" % cs.cod.cbstyle)

    def decode(self, max_layers: Optional[int] = None) -> List[np.ndarray]:
        siz = self.cs.siz
        ncomp = len(siz.comps)
        planes = [
            np.zeros((ceil_div(siz.ysiz, c.yr) - ceil_div(siz.yosiz, c.yr),
                      ceil_div(siz.xsiz, c.xr) - ceil_div(siz.xosiz, c.xr)),
                     dtype=np.float64 if self._any_irreversible()
                     else np.int32)
            for c in siz.comps
        ]
        for q in range(siz.num_tiles_y):
            for p in range(siz.num_tiles_x):
                tidx = q * siz.num_tiles_x + p
                tdata = self.cs.tile_data.get(tidx, b"")
                self._decode_tile(tidx, p, q, tdata, planes, max_layers)
        with trace.span("j2k.decode.dwt"):
            # final level shift / clamp
            out = []
            for ci, c in enumerate(siz.comps):
                a = planes[ci]
                if not c.signed:
                    a = a + (1 << (c.depth - 1))
                if np.issubdtype(a.dtype, np.floating):
                    a = np.round(a)
                lo, hi = ((0, (1 << c.depth) - 1) if not c.signed else
                          (-(1 << (c.depth - 1)), (1 << (c.depth - 1)) - 1))
                out.append(np.clip(a, lo, hi).astype(np.int32))
        return out

    def _any_irreversible(self) -> bool:
        if self.cs.cod.transform == 0:
            return True
        return any(c.transform == 0 for c in self.cs.coc.values())

    # ------------------------------------------------------------ tiles
    def _decode_tile(self, tidx, p, q, tdata, planes, max_layers):
        cs = self.cs
        siz = cs.siz
        tb = csm.tile_bounds(siz, p, q)
        ncomp = len(siz.comps)
        # per-component geometry
        geo = []
        for c in range(ncomp):
            cod = cs.comp_cod(c)
            tcb = csm.tile_comp_bounds(siz, c, tb)
            res = csm.build_resolutions(*tcb, cod)
            precincts: Dict[Tuple[int, int, int], _Precinct] = {}
            geo.append((cod, tcb, res, precincts))
        with trace.span("j2k.decode.parse"):
            self._decode_packets(tdata, geo, max_layers)
        # tier-1 + reconstruction per component
        recon = []
        for c in range(ncomp):
            cod, tcb, res, precincts = geo[c]
            qs = cs.comp_qcd(c)
            comp = siz.comps[c]
            reversible = cod.transform == 1
            recon.append(self._reconstruct_component(
                c, cod, qs, comp, res, precincts, reversible))
        with trace.span("j2k.decode.dwt"):
            # inverse multi-component transform on components 0..2 (G.2/G.3)
            if cs.cod.mct and ncomp >= 3 and \
                    recon[0].shape == recon[1].shape == recon[2].shape:
                y0_, y1_, y2_ = recon[0], recon[1], recon[2]
                if cs.cod.transform == 1:   # RCT (reversible)
                    g = y0_ - ((y1_ + y2_) >> 2)
                    r_ = y2_ + g
                    b_ = y1_ + g
                else:                       # ICT (irreversible)
                    r_ = y0_ + 1.402 * y2_
                    g = y0_ - 0.344136 * y1_ - 0.714136 * y2_
                    b_ = y0_ + 1.772 * y1_
                recon[0], recon[1], recon[2] = r_, g, b_
        for c in range(ncomp):
            cod, tcb, res, precincts = geo[c]
            comp = siz.comps[c]
            ll = recon[c]
            x0 = tcb[0] - ceil_div(siz.xosiz, comp.xr)
            y0 = tcb[1] - ceil_div(siz.yosiz, comp.yr)
            h, w = ll.shape
            planes[c][y0:y0 + h, x0:x0 + w] = ll

    # ---------------------------------------------------------- packets
    def _prec(self, precincts, res, band, cod, pix, piy) -> _Precinct:
        key = (res.r, band.orient, piy * max(res.num_prec_x, 1) + pix)
        pr = precincts.get(key)
        if pr is None:
            blocks, ncw, nch = csm.cblk_span(band, res, cod, pix, piy)
            pr = _Precinct(blocks, ncw, nch)
            precincts[key] = pr
        return pr

    def _decode_packets(self, tdata, geo, max_layers):
        cs = self.cs
        cod0 = cs.cod
        nlayers = cod0.nlayers if max_layers is None else \
            min(cod0.nlayers, max_layers)
        pos = 0
        # iteration order
        maxres = max(len(g[2]) for g in geo)
        order = cod0.prog_order
        if order == 0:    # LRCP
            seq = [(l, r, c) for l in range(cod0.nlayers)
                   for r in range(maxres) for c in range(len(geo))]
        elif order == 1:  # RLCP
            seq = [(l, r, c) for r in range(maxres)
                   for l in range(cod0.nlayers) for c in range(len(geo))]
        elif order in (2, 4):  # RPCL / CPRL with single-precinct layout
            for g in geo:
                _, _, res, _ = g
                if any(r.num_prec_x * r.num_prec_y > 1 for r in res):
                    raise HeifError.invalid_input(
                        msg="multi-precinct RPCL/CPRL not supported")
            if order == 2:
                seq = [(l, r, c) for r in range(maxres)
                       for c in range(len(geo)) for l in range(cod0.nlayers)]
            else:
                seq = [(l, r, c) for c in range(len(geo))
                       for r in range(maxres) for l in range(cod0.nlayers)]
        else:
            raise HeifError.invalid_input(
                msg="progression order %d not supported" % order)
        for (l, r, c) in seq:
            cod, tcb, res_list, precincts = geo[c]
            if r >= len(res_list):
                continue
            res = res_list[r]
            np_x, np_y = res.num_prec_x, res.num_prec_y
            for piy in range(max(np_y, 0)):
                for pix in range(max(np_x, 0)):
                    pos = self._decode_one_packet(
                        tdata, pos, l, cod, res, precincts, pix, piy,
                        skip=(l >= nlayers))

    def _decode_one_packet(self, tdata, pos, layer, cod, res, precincts,
                           pix, piy, skip=False):
        if pos >= len(tdata):
            return pos
        # SOP marker
        if cod.has_sop and tdata[pos:pos + 2] == b"\xff\x91":
            pos += 6
        rd = HeaderBitReader(tdata, pos)
        contributions = []
        try:
            if not rd.bit():
                pos = rd.align()
                if cod.has_eph and tdata[pos:pos + 2] == b"\xff\x92":
                    pos += 2
                return pos
            for band in res.bands:
                if band.w <= 0 or band.h <= 0:
                    continue
                pr = self._prec(precincts, res, band, cod, pix, piy)
                for ci, cb in enumerate(pr.cblks):
                    cx, cy = ci % pr.ncw, ci // pr.ncw
                    if not cb.included:
                        incl = pr.incl_tree.decode(rd, cx, cy, layer + 1)
                    else:
                        incl = rd.bit()
                    if not incl:
                        continue
                    if not cb.included:
                        cb.zero_planes = pr.imsb_tree.decode_value(rd, cx, cy)
                        cb.included = True
                    npasses = read_numpasses(rd)
                    while rd.bit():
                        cb.lblock += 1
                    if (cod.cbstyle & 0x40) and npasses > 1:
                        # HT blocks terminate after the cleanup pass:
                        # one length per segment (cleanup; then
                        # SigProp+MagRef), T.814 segmentation
                        l1 = rd.bits(cb.lblock)
                        l2 = rd.bits(cb.lblock +
                                     _floorlog2(npasses - 1))
                        contributions.append((cb, npasses, [l1, l2]))
                    else:
                        nbits = cb.lblock + _floorlog2(npasses)
                        seg_len = rd.bits(nbits)
                        contributions.append((cb, npasses, seg_len))
            pos = rd.align()
        except (EOFError, IndexError):
            return len(tdata)
        if cod.has_eph and tdata[pos:pos + 2] == b"\xff\x92":
            pos += 2
        for (cb, npasses, seg_len) in contributions:
            if isinstance(seg_len, list):
                if not skip:
                    cb.ht_seg1 = seg_len[0]
                    cb.data += tdata[pos:pos + sum(seg_len)]
                    cb.num_passes += npasses
                pos += sum(seg_len)
            else:
                if not skip:
                    cb.data += tdata[pos:pos + seg_len]
                    cb.num_passes += npasses
                pos += seg_len
        return pos

    # ----------------------------------------------------- reconstruction
    def _reconstruct_component(self, c, cod, qs, comp, res_list, precincts,
                               reversible):
        guard = qs.guard
        n = cod.levels
        band_arrays = {}
        jobs = []          # (cb, bw, bh, mb, orient, delta, arr)
        for res in res_list:
            for band in res.bands:
                w, h = band.w, band.h
                arr = (np.zeros((h, w), dtype=np.int32) if reversible
                       else np.zeros((h, w), dtype=np.float64))
                eb, mb_ = qs.band_step(band.band_index, n)
                mb = guard + eb - 1
                if not reversible:
                    rb = comp.depth + band.gain
                    delta = (2.0 ** (rb - eb)) * (1.0 + mb_ / 2048.0)
                else:
                    delta = 1
                for piy in range(max(res.num_prec_y, 1)):
                    for pix in range(max(res.num_prec_x, 1)):
                        key = (res.r, band.orient,
                               piy * max(res.num_prec_x, 1) + pix)
                        pr = precincts.get(key)
                        if pr is None:
                            continue
                        for cb in pr.cblks:
                            if cb.num_passes == 0:
                                continue
                            jobs.append((cb, cb.x1 - cb.x0,
                                         cb.y1 - cb.y0, mb, band.orient,
                                         delta, arr, band.x0, band.y0))
                band_arrays[(res.r, band.orient)] = arr

        def _decode_cb(job):
            cb, bw, bh, mb, orient, delta, arr, bx0, by0 = job
            if cod.cbstyle & 0x40:
                # Mb - zp signals the pass-plane count p (T.814):
                # cleanup codes units of 2^(p-1); SigProp/MagRef
                # (passes 2-3) refine plane p-2.  Foreign encoders may
                # use any p: accept their conventions.
                p = max(mb - cb.zero_planes, 1)
                if cb.num_passes >= 2 and p >= 2:
                    s1 = getattr(cb, "ht_seg1", len(cb.data))
                    high = decode_cleanup(bytes(cb.data[:s1]), bw, bh,
                                          mb - (p - 1))
                    coef = decode_refinement(bytes(cb.data[s1:]), high,
                                             bw, bh,
                                             magref=cb.num_passes >= 3)
                    coef = coef.astype(np.int64) << (p - 2)
                elif cb.num_passes == 1:
                    coef = decode_cleanup(bytes(cb.data), bw, bh,
                                          mb - (p - 1)).astype(np.int64)
                    coef = coef << (p - 1)
                    if p >= 2:
                        # midpoint reconstruction of the untransmitted
                        # planes (matches the OpenJPEG HT decoder)
                        coef += np.sign(coef) * (1 << (p - 2))
                else:
                    raise HeifError.invalid_input(
                        msg="unsupported HT pass structure")
                return coef.astype(np.int32)
            t1 = T1Decoder(bw, bh, orient)
            return t1.decode(bytes(cb.data), cb.num_passes, mb,
                             cb.zero_planes)

        # the C++ T1 engine releases the GIL, so code-blocks decode
        # in parallel on a small pool (the OpenJPEG T1 thread pool
        # analog, opj_thread_pool in opj_t1.c)
        with trace.span("j2k.decode.t1"):
            if len(jobs) > 3 and (os.cpu_count() or 1) > 1:
                with ThreadPoolExecutor(max_workers=min(
                        os.cpu_count() or 1, 8)) as ex:
                    coefs = list(ex.map(_decode_cb, jobs))
            else:
                coefs = [_decode_cb(j) for j in jobs]

        with trace.span("j2k.decode.dwt"):
            for (cb, bw, bh, mb, orient, delta, arr, bx0,
                 by0), coef in zip(jobs, coefs):
                sub = coef.astype(arr.dtype)
                if not reversible:
                    # midpoint reconstruction: (m + 1/2) * delta
                    sub = np.where(sub > 0, (sub + 0.5) * delta,
                                   np.where(sub < 0, (sub - 0.5) * delta,
                                            0.0))
                arr[cb.y0 - by0:cb.y1 - by0, cb.x0 - bx0:cb.x1 - bx0] = sub

            # multi-level synthesis
            ll = band_arrays[(0, 0)]
            for r in range(1, n + 1):
                res = res_list[r]
                hl = band_arrays[(r, 1)]
                lh = band_arrays[(r, 2)]
                hh = band_arrays[(r, 3)]
                ll = dwt.sr_2d(ll, hl, lh, hh, res.x0, res.y0, reversible)
        return ll


def _floorlog2(v: int) -> int:
    return v.bit_length() - 1
