"""JPEG 2000 encoder: component planes → codestream.

Forward path: level shift → RCT/ICT → forward DWT (5/3 reversible or
9/7 irreversible) → (quantize) → EBCOT tier-1 all-passes encode →
tier-2 single-layer LRCP packets → marker segments.  Lossy rate
control is coarse (bit-plane truncation via `quality`); the reference
delegates all of this to OpenJPEG/OpenJPH plugins.

Counterpart of libheif_tpu/codecs/j2k/encoder.py, on the host: the
code-blocks go through the C++ block coders (t1.py, htj2k.py), and the
codestream is the JAX encoder's byte for byte.  Its parts are the spans
``j2k.encode.dwt`` (level shift, MCT, forward DWT), ``.t1`` and
``.write`` (packets and markers; core/trace.py).
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional, Tuple

import numpy as np

from ...core import trace
from ...core.error import HeifError
from . import codestream as csm
from . import dwt
from .codestream import (CodStyle, Codestream, ComponentSiz, QuantStyle,
                         SizSeg, ceil_div)
from .t1 import T1Encoder
from .t2 import HeaderBitWriter, TagTree, write_numpasses


def encode_codestream(planes: List[np.ndarray], depth: int = 8,
                      signed: bool = False, levels: int = 5,
                      reversible: bool = True, mct: Optional[bool] = None,
                      quality: int = 100,
                      cb_exp: Tuple[int, int] = (6, 6),
                      htj2k: bool = False,
                      ht_passes: int = 1,
                      ht_drop_planes: int = 0) -> bytes:
    enc = J2KEncoder(depth=depth, signed=signed, levels=levels,
                     reversible=reversible, mct=mct, quality=quality,
                     cb_exp=cb_exp, htj2k=htj2k, ht_passes=ht_passes,
                     ht_drop_planes=ht_drop_planes)
    return enc.encode(planes)


class J2KEncoder:
    def __init__(self, depth=8, signed=False, levels=5, reversible=True,
                 mct=None, quality=100, cb_exp=(6, 6), htj2k=False,
                 ht_passes=1, ht_drop_planes=0):
        self.ht_passes = ht_passes
        # lossy cleanup-only mode: code floor(|v| / 2^k), signal
        # p = k+1 (T.814 coarse pass-planes; foreign-convention check)
        self.ht_drop_planes = ht_drop_planes
        self.depth = depth
        self.signed = signed
        self.levels = levels
        self.reversible = reversible
        self.quality = quality
        self.mct = mct
        self.xcb, self.ycb = cb_exp
        self.htj2k = htj2k

    def _encode_ht_block(self, sub):
        """One HT code-block: cleanup only, or cleanup + SigProp +
        MagRef (T.814 7.4/7.5) when `ht_passes == 3` and the split is
        lossless-representable (every |v|==1 sample is reachable by
        significance propagation)."""
        from .htj2k import (encode_cleanup, encode_refinement,
                            decode_refinement)
        sub = np.ascontiguousarray(sub)
        if self.ht_drop_planes:
            k = self.ht_drop_planes
            coarse = (np.sign(sub) * (np.abs(sub) >> k)).astype(sub.dtype)
            if not coarse.any():
                return b"", 0, 0
            data, _b = encode_cleanup(coarse)
            return data, 1, k + 1
        if self.ht_passes == 3:
            a = np.abs(sub)
            high = (np.sign(sub) * (a >> 1)).astype(sub.dtype)
            if high.any():
                h, w = sub.shape
                seg2 = encode_refinement(sub, high)
                if np.array_equal(
                        decode_refinement(seg2, high, w, h), sub):
                    seg1, _b = encode_cleanup(high)
                    # Mb - zp signals the pass-plane count p = 2
                    return [seg1, seg2], 3, 2
        data, _b = encode_cleanup(sub)
        # for HT blocks Mb - zp signals the pass-plane count p, not
        # the magnitude depth: cleanup-only full precision means p = 1
        return data, 1, 1

    def encode(self, planes: List[np.ndarray]) -> bytes:
        ncomp = len(planes)
        h, w = planes[0].shape
        do_mct = (self.mct if self.mct is not None
                  else (ncomp >= 3 and all(p.shape == (h, w)
                                           for p in planes[:3])))
        levels = self.levels
        while levels > 0 and (1 << levels) > max(w, h):
            levels -= 1

        siz = SizSeg(0x4000 if self.htj2k else 0, w, h, 0, 0, w, h, 0, 0,
                     [ComponentSiz(self.depth, self.signed, 1, 1)
                      for _ in range(ncomp)])
        cod = CodStyle(scod=0, prog_order=0, nlayers=1,
                       mct=1 if do_mct else 0, levels=levels,
                       xcb=self.xcb, ycb=self.ycb,
                       cbstyle=0x40 if self.htj2k else 0,
                       transform=1 if self.reversible else 0)
        qs = self._quant_style(levels)

        with trace.span("j2k.encode.dwt"):
            # ---- pixel plane math ----
            comps = [p.astype(np.int32 if self.reversible else np.float64)
                     for p in planes]
            if not self.signed:
                off = 1 << (self.depth - 1)
                comps = [c - off for c in comps]
            if do_mct:
                r_, g_, b_ = comps[0], comps[1], comps[2]
                if self.reversible:       # RCT
                    y0 = (r_ + 2 * g_ + b_) >> 2
                    y1 = b_ - g_
                    y2 = r_ - g_
                else:                     # ICT
                    y0 = 0.299 * r_ + 0.587 * g_ + 0.114 * b_
                    y1 = -0.16875 * r_ - 0.331260 * g_ + 0.5 * b_
                    y2 = 0.5 * r_ - 0.41869 * g_ - 0.08131 * b_
                comps[0], comps[1], comps[2] = y0, y1, y2

        tile_bodies = []
        body = self._encode_tile(comps, cod, qs, siz)
        tile_bodies.append(body)

        with trace.span("j2k.encode.write"):
            # ---- marker assembly ----
            out = bytearray()
            out += struct.pack(">H", csm.SOC)
            segs = [(csm.SIZ, csm.write_siz(siz))]
            if self.htj2k:
                # CAP with Ccap15: HT code-blocks only.  Bits 0-4 carry
                # MAGB with the T.814 offset scheme (B<=8 -> 0,
                # 8<B<28 -> B-8, 28<=B<48 -> 13+(B>>2), else 31), not the
                # raw max M_b value.
                max_mb = max(qs.guard + e - 1 for (e, _m) in qs.steps)
                if max_mb <= 8:
                    magb = 0
                elif max_mb < 28:
                    magb = max_mb - 8
                elif max_mb < 48:
                    magb = 13 + (max_mb >> 2)
                else:
                    magb = 31
                cap = csm.CapSeg(0x00020000, [magb & 0x1F])
                segs.append((csm.CAP, csm.write_cap(cap)))
            segs += [(csm.COD, csm.write_cod(cod)),
                     (csm.QCD, csm.write_qcd(qs))]
            for marker, seg in segs:
                out += struct.pack(">HH", marker, len(seg) + 2) + seg
            for t, body in enumerate(tile_bodies):
                psot = 12 + 2 + len(body)
                out += struct.pack(">HHHIBB", csm.SOT, 10, t, psot, 0, 1)
                out += struct.pack(">H", csm.SOD)
                out += body
            out += struct.pack(">H", csm.EOC)
        return bytes(out)

    def _quant_style(self, levels: int) -> QuantStyle:
        qs = QuantStyle()
        qs.guard = 2
        nb = 3 * levels + 1
        if self.reversible:
            qs.style = 0
            qs.steps = []
            for bi in range(nb):
                gain = 0 if bi == 0 else (0, 1, 1, 2)[(bi - 1) % 3 + 1]
                qs.steps.append((self.depth + gain, 0))
        else:
            qs.style = 2
            qs.steps = []
            # quality 100 → step ⅛ (near lossless), 70 → 1.0, 50 → 4, 30 → 16
            base = (2.0 ** ((100 - self.quality) / 10.0)) / 8.0
            for bi in range(nb):
                gain = 0 if bi == 0 else (0, 1, 1, 2)[(bi - 1) % 3 + 1]
                delta = base * math.sqrt(2.0 ** gain)
                # express Δb = 2^(Rb-εb)·(1+μ/2048) with Rb = depth+gain
                rb = self.depth + gain
                eps = rb - int(math.floor(math.log2(delta)))
                eps = min(max(eps, 0), 31)
                mant = int(round((delta / (2.0 ** (rb - eps)) - 1.0) * 2048))
                mant = min(max(mant, 0), 2047)
                qs.steps.append((eps, mant))
        return qs

    def _encode_tile(self, comps, cod: CodStyle, qs: QuantStyle,
                     siz: SizSeg) -> bytes:
        n = cod.levels
        ncomp = len(comps)
        with trace.span("j2k.encode.dwt"):
            # forward DWT per component → band arrays
            all_bands = []   # [comp][ (r, orient) → array ]
            all_res = []
            for c in range(ncomp):
                tcb = (0, 0, comps[c].shape[1], comps[c].shape[0])
                res_list = csm.build_resolutions(*tcb, cod)
                all_res.append(res_list)
                bands = {}
                cur = comps[c]
                for r in range(n, 0, -1):
                    res = res_list[r]
                    ll, hl, lh, hh = dwt.sd_2d(cur, res.x0, res.y0,
                                               self.reversible)
                    bands[(r, 1)], bands[(r, 2)], bands[(r, 3)] = hl, lh, hh
                    cur = ll
                bands[(0, 0)] = cur
                all_bands.append(bands)

        with trace.span("j2k.encode.t1"):
            # tier-1 encode every code-block
            enc_state = []   # [comp][(r,orient,prec)] → list of cblk dicts
            for c in range(ncomp):
                res_list = all_res[c]
                state = {}
                for res in res_list:
                    for band in res.bands:
                        if band.w <= 0 or band.h <= 0:
                            continue
                        arr = all_bands[c][(res.r, band.orient)]
                        eb, mant = qs.band_step(band.band_index, n)
                        mb = qs.guard + eb - 1
                        if not self.reversible:
                            rb = self.depth + band.gain
                            delta = (2.0 ** (rb - eb)) * (1.0 + mant / 2048.0)
                            qarr = np.trunc(arr / delta).astype(np.int64)
                        else:
                            qarr = arr.astype(np.int64)
                        for piy in range(max(res.num_prec_y, 1)):
                            for pix in range(max(res.num_prec_x, 1)):
                                blocks, ncw, nch = csm.cblk_span(
                                    band, res, cod, pix, piy)
                                cbs = []
                                for (x0, y0, x1, y1) in blocks:
                                    sub = qarr[y0 - band.y0:y1 - band.y0,
                                               x0 - band.x0:x1 - band.x0]
                                    if self.htj2k:
                                        if not sub.any():
                                            data, npasses, nplanes = b"", 0, 0
                                        else:
                                            data, npasses, nplanes = \
                                                self._encode_ht_block(sub)
                                    else:
                                        t1 = T1Encoder(x1 - x0, y1 - y0,
                                                       band.orient)
                                        data, npasses, nplanes = t1.encode(
                                            np.ascontiguousarray(sub))
                                    zp = max(mb - nplanes, 0)
                                    cbs.append(dict(data=data, npasses=npasses,
                                                    nplanes=nplanes, zp=zp))
                                state[(res.r, band.orient, pix, piy)] = \
                                    (cbs, ncw, nch)
                enc_state.append(state)

        with trace.span("j2k.encode.write"):
            # tier-2: single layer, LRCP
            body = bytearray()
            maxres = max(len(r) for r in all_res)
            for r in range(maxres):
                for c in range(ncomp):
                    res_list = all_res[c]
                    if r >= len(res_list):
                        continue
                    res = res_list[r]
                    for piy in range(max(res.num_prec_y, 1)):
                        for pix in range(max(res.num_prec_x, 1)):
                            body += self._encode_packet(
                                res, enc_state[c], pix, piy)
        return bytes(body)

    def _encode_packet(self, res, state, pix, piy) -> bytes:
        wr = HeaderBitWriter()
        included_any = False
        segs = []
        entries = []
        for band in res.bands:
            if band.w <= 0 or band.h <= 0:
                continue
            key = (res.r, band.orient, pix, piy)
            if key not in state:
                continue
            cbs, ncw, nch = state[key]
            if not cbs:
                continue
            entries.append((cbs, ncw, nch))
            if any(cb["npasses"] > 0 for cb in cbs):
                included_any = True
        if not included_any:
            wr.bit(0)
            return wr.flush()
        wr.bit(1)
        for (cbs, ncw, nch) in entries:
            incl = TagTree(ncw, nch)
            imsb = TagTree(ncw, nch)
            for i, cb in enumerate(cbs):
                x, y = i % ncw, i // ncw
                incl.set_leaf(x, y, 0 if cb["npasses"] > 0 else 1)
                imsb.set_leaf(x, y, cb["zp"])
            incl.finalize_values()
            imsb.finalize_values()
            for i, cb in enumerate(cbs):
                x, y = i % ncw, i // ncw
                incl.encode(wr, x, y, 1)
                if cb["npasses"] == 0:
                    continue
                # zero bit-planes: encode until known
                t = 1
                while True:
                    imsb.encode(wr, x, y, t)
                    if imsb.leaf_known(x, y):
                        break
                    t += 1
                write_numpasses(wr, cb["npasses"])
                lblock = 3
                if isinstance(cb["data"], list):
                    # HT multi-segment contribution (cleanup; then
                    # SigProp+MagRef): one comma code, then one length
                    # per segment with lblock + floor(log2(seg passes))
                    # bits (seg passes: 1, then 2)
                    seg_passes = [1, cb["npasses"] - 1]
                    lens = [len(d) for d in cb["data"]]
                    need = 0
                    for ln, np_ in zip(lens, seg_passes):
                        need = max(need,
                                   max(ln.bit_length(), 1) -
                                   _floorlog2(np_))
                    while lblock < need:
                        wr.bit(1)
                        lblock += 1
                    wr.bit(0)
                    for ln, np_ in zip(lens, seg_passes):
                        wr.bits(ln, lblock + _floorlog2(np_))
                    segs.extend(cb["data"])
                else:
                    length = len(cb["data"])
                    bits_needed = max(length.bit_length(), 1)
                    avail = lblock + _floorlog2(cb["npasses"])
                    while avail < bits_needed:
                        wr.bit(1)
                        lblock += 1
                        avail += 1
                    wr.bit(0)
                    wr.bits(length, avail)
                    segs.append(cb["data"])
        out = wr.flush()
        return out + b"".join(segs)


def _floorlog2(v: int) -> int:
    return v.bit_length() - 1
