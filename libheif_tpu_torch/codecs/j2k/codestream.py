"""JPEG 2000 codestream syntax (ISO/IEC 15444-1 Annex A).

Marker-segment parsing/writing (SIZ/COD/QCD/COC/QCC/SOT…) and the
canonical grid geometry: tiles, tile-components, resolutions,
subbands, precincts, code-blocks (Annex B).  Host-side, byte
oriented — the container plane of the codec.

A copy of libheif_tpu/codecs/j2k/codestream.py.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...core.error import HeifError

# Marker codes
SOC = 0xFF4F
CAP = 0xFF50
SIZ = 0xFF51
COD = 0xFF52
COC = 0xFF53
TLM = 0xFF55
PLM = 0xFF57
PLT = 0xFF58
QCD = 0xFF5C
QCC = 0xFF5D
RGN = 0xFF5E
POC = 0xFF5F
PPM = 0xFF60
PPT = 0xFF61
CRG = 0xFF63
COM = 0xFF64
SOT = 0xFF90
SOP = 0xFF91
EPH = 0xFF92
SOD = 0xFF93
EOC = 0xFFD9


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class ComponentSiz:
    depth: int
    signed: bool
    xr: int
    yr: int


@dataclass
class SizSeg:
    rsiz: int = 0
    xsiz: int = 0
    ysiz: int = 0
    xosiz: int = 0
    yosiz: int = 0
    xtsiz: int = 0
    ytsiz: int = 0
    xtosiz: int = 0
    ytosiz: int = 0
    comps: List[ComponentSiz] = field(default_factory=list)

    @property
    def num_tiles_x(self) -> int:
        return ceil_div(self.xsiz - self.xtosiz, self.xtsiz)

    @property
    def num_tiles_y(self) -> int:
        return ceil_div(self.ysiz - self.ytosiz, self.ytsiz)


@dataclass
class CodStyle:
    """COD/COC coding style (B.12.1.1)."""
    scod: int = 0
    prog_order: int = 0       # 0 LRCP 1 RLCP 2 RPCL 3 PCRL 4 CPRL
    nlayers: int = 1
    mct: int = 0
    levels: int = 5
    xcb: int = 6              # code-block width exponent
    ycb: int = 6
    cbstyle: int = 0
    transform: int = 1        # 0 = 9/7 irreversible, 1 = 5/3 reversible
    precincts: List[Tuple[int, int]] = field(default_factory=list)

    def precinct_exp(self, r: int) -> Tuple[int, int]:
        if not self.precincts:
            return (15, 15)
        return self.precincts[min(r, len(self.precincts) - 1)]

    @property
    def has_sop(self) -> bool:
        return bool(self.scod & 2)

    @property
    def has_eph(self) -> bool:
        return bool(self.scod & 4)


@dataclass
class QuantStyle:
    """QCD/QCC (B.12.1.4): style 0 none, 1 derived, 2 expounded."""
    style: int = 0
    guard: int = 2
    # per-subband (exponent, mantissa) in order LL, then HL,LH,HH per level
    steps: List[Tuple[int, int]] = field(default_factory=list)

    def band_step(self, band_index: int, levels: int) -> Tuple[int, int]:
        if self.style == 1:  # derived from LL
            e0, m0 = self.steps[0]
            if band_index == 0:
                return e0, m0
            lev_from_top = (band_index - 1) // 3  # 0 = level closest to LL
            nb = levels - lev_from_top
            return e0 - levels + nb, m0
        return self.steps[band_index]


@dataclass
class TilePart:
    isot: int
    tpsot: int
    tnsot: int
    data: bytes


@dataclass
class CapSeg:
    """CAP extended-capabilities marker (A.5.2).  Pcap flags which
    Ccap^i fields follow; bit 15 (counted from the MSB of the 32-bit
    word) marks Part 15 / HT-J2K with its Ccap15 word."""
    pcap: int = 0
    ccap: List[int] = field(default_factory=list)

    @property
    def has_htj2k(self) -> bool:
        return bool(self.pcap & 0x00020000)


def parse_cap(body: bytes) -> CapSeg:
    if len(body) < 4:
        raise _err("CAP too short")
    pcap = _unpack(">I", body[:4])[0]
    n = (len(body) - 4) // 2
    ccap = list(_unpack(">%dH" % n, body[4:4 + 2 * n]))
    return CapSeg(pcap, ccap)


def write_cap(cap: CapSeg) -> bytes:
    return struct.pack(">I", cap.pcap) + b"".join(
        struct.pack(">H", c) for c in cap.ccap)


@dataclass
class Codestream:
    siz: SizSeg = None
    cod: CodStyle = None
    qcd: QuantStyle = None
    cap: Optional["CapSeg"] = None
    coc: Dict[int, CodStyle] = field(default_factory=dict)
    qcc: Dict[int, QuantStyle] = field(default_factory=dict)
    comments: List[bytes] = field(default_factory=list)
    # tile index → concatenated bitstream (packets) in tile-part order
    tile_data: Dict[int, bytes] = field(default_factory=dict)

    def comp_cod(self, c: int) -> CodStyle:
        return self.coc.get(c, self.cod)

    def comp_qcd(self, c: int) -> QuantStyle:
        return self.qcc.get(c, self.qcd)


def _err(msg: str) -> HeifError:
    return HeifError.invalid_input(msg=msg)


def _unpack(fmt: str, buf: bytes) -> tuple:
    """``struct.unpack`` of a marker field; a field cut short by the end
    of the codestream raises a HeifError (struct.error in the JAX copy)."""
    if len(buf) != struct.calcsize(fmt):
        raise _err("truncated JPEG 2000 codestream")
    return struct.unpack(fmt, buf)


def parse_siz(body: bytes) -> SizSeg:
    if len(body) < 36:
        raise _err("SIZ too short")
    (rsiz, xs, ys, xo, yo, xt, yt, xto, yto, csiz) = _unpack(
        ">HIIIIIIIIH", body[:36])
    s = SizSeg(rsiz, xs, ys, xo, yo, xt, yt, xto, yto)
    p = 36
    for _ in range(csiz):
        ssiz, xr, yr = body[p], body[p + 1], body[p + 2]
        p += 3
        s.comps.append(ComponentSiz((ssiz & 0x7F) + 1, bool(ssiz & 0x80),
                                    xr, yr))
    if s.xtsiz == 0 or s.ytsiz == 0 or not s.comps:
        raise _err("invalid SIZ")
    return s


def write_siz(s: SizSeg) -> bytes:
    body = struct.pack(">HIIIIIIIIH", s.rsiz, s.xsiz, s.ysiz, s.xosiz,
                       s.yosiz, s.xtsiz, s.ytsiz, s.xtosiz, s.ytosiz,
                       len(s.comps))
    for c in s.comps:
        body += bytes([(c.depth - 1) | (0x80 if c.signed else 0),
                       c.xr, c.yr])
    return body


def parse_cod(body: bytes) -> CodStyle:
    c = CodStyle()
    c.scod = body[0]
    c.prog_order = body[1]
    c.nlayers = _unpack(">H", body[2:4])[0]
    c.mct = body[4]
    c.levels = body[5]
    c.xcb = (body[6] & 0x0F) + 2
    c.ycb = (body[7] & 0x0F) + 2
    c.cbstyle = body[8]
    c.transform = body[9]
    if c.scod & 1:
        c.precincts = [(b & 0x0F, b >> 4) for b in body[10:10 + c.levels + 1]]
    return c


def write_cod(c: CodStyle) -> bytes:
    body = bytes([c.scod, c.prog_order]) + struct.pack(">H", c.nlayers)
    body += bytes([c.mct, c.levels, c.xcb - 2, c.ycb - 2, c.cbstyle,
                   c.transform])
    if c.scod & 1:
        body += bytes([(px & 0x0F) | (py << 4) for (px, py) in c.precincts])
    return body


def parse_coc(body: bytes, base: CodStyle, ncomps: int) -> Tuple[int, CodStyle]:
    if ncomps < 257:
        comp, p = body[0], 1
    else:
        comp, p = _unpack(">H", body[:2])[0], 2
    c = CodStyle(scod=base.scod, prog_order=base.prog_order,
                 nlayers=base.nlayers, mct=base.mct)
    scoc = body[p]
    p += 1
    c.levels = body[p]
    c.xcb = (body[p + 1] & 0x0F) + 2
    c.ycb = (body[p + 2] & 0x0F) + 2
    c.cbstyle = body[p + 3]
    c.transform = body[p + 4]
    p += 5
    if scoc & 1:
        c.precincts = [(b & 0x0F, b >> 4) for b in body[p:p + c.levels + 1]]
    return comp, c


def parse_qcd(body: bytes) -> QuantStyle:
    q = QuantStyle()
    sqcd = body[0]
    q.style = sqcd & 0x1F
    q.guard = sqcd >> 5
    p = 1
    if q.style == 0:
        q.steps = [(b >> 3, 0) for b in body[p:]]
    elif q.style == 1:
        v = _unpack(">H", body[p:p + 2])[0]
        q.steps = [(v >> 11, v & 0x7FF)]
    elif q.style == 2:
        n = (len(body) - 1) // 2
        q.steps = []
        for i in range(n):
            v = _unpack(">H", body[p + 2 * i:p + 2 * i + 2])[0]
            q.steps.append((v >> 11, v & 0x7FF))
    else:
        raise _err("bad quantization style %d" % q.style)
    return q


def write_qcd(q: QuantStyle) -> bytes:
    body = bytes([(q.guard << 5) | q.style])
    if q.style == 0:
        body += bytes([(e << 3) for (e, _m) in q.steps])
    else:
        for (e, m) in q.steps:
            body += struct.pack(">H", (e << 11) | m)
    return body


def parse_qcc(body: bytes, ncomps: int) -> Tuple[int, QuantStyle]:
    if ncomps < 257:
        comp, p = body[0], 1
    else:
        comp, p = _unpack(">H", body[:2])[0], 2
    return comp, parse_qcd(body[p:])


def _unwrap_jp2(data: bytes) -> bytes:
    """Extract the contiguous codestream (jp2c) from a JP2 file."""
    pos = 0
    while pos + 8 <= len(data):
        size = _unpack(">I", data[pos:pos + 4])[0]
        btype = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = _unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = len(data) - pos
        if btype == b"jp2c":
            return data[pos + hdr:pos + size]
        pos += max(size, hdr)
    raise _err("no jp2c box in JP2 file")


def parse_codestream(data: bytes) -> Codestream:
    """Top-level marker scan into a Codestream model.  Accepts a raw
    codestream (SOC first) or a JP2 wrapper (unwraps the jp2c box)."""
    if data[:4] == b"\x00\x00\x00\x0c" and data[4:8] == b"jP  ":
        data = _unwrap_jp2(data)
    cs = Codestream()
    if len(data) < 4 or _unpack(">H", data[:2])[0] != SOC:
        raise _err("missing SOC")
    pos = 2
    main_done = False
    while pos + 2 <= len(data):
        marker = _unpack(">H", data[pos:pos + 2])[0]
        pos += 2
        if marker == EOC:
            break
        if marker == SOT:
            lseg = _unpack(">H", data[pos:pos + 2])[0]
            body = data[pos + 2:pos + lseg]
            isot, psot, tpsot, tnsot = _unpack(">HIBB", body[:8])
            sot_start = pos - 2
            if psot == 0:
                psot = len(data) - sot_start
                # may still have EOC at the very end
                if data[-2:] == b"\xff\xd9":
                    psot -= 2
            tp_end = sot_start + psot
            # find SOD
            q = pos + lseg
            m2 = _unpack(">H", data[q:q + 2])[0]
            # skip any tile-part header markers (COD/QCD/COM/PLT...) until SOD
            while m2 != SOD:
                l2 = _unpack(">H", data[q + 2:q + 4])[0]
                q += 2 + l2
                m2 = _unpack(">H", data[q:q + 2])[0]
            body_data = data[q + 2:tp_end]
            cs.tile_data[isot] = cs.tile_data.get(isot, b"") + body_data
            pos = tp_end
            continue
        if pos + 2 > len(data):
            break
        lseg = _unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + lseg]
        if marker == SIZ:
            cs.siz = parse_siz(body)
        elif marker == CAP:
            cs.cap = parse_cap(body)
        elif marker == COD:
            cs.cod = parse_cod(body)
        elif marker == QCD:
            cs.qcd = parse_qcd(body)
        elif marker == COC:
            comp, c = parse_coc(body, cs.cod or CodStyle(),
                                len(cs.siz.comps) if cs.siz else 1)
            cs.coc[comp] = c
        elif marker == QCC:
            comp, q = parse_qcc(body, len(cs.siz.comps) if cs.siz else 1)
            cs.qcc[comp] = q
        elif marker == COM:
            cs.comments.append(body[2:])
        elif marker == POC:
            raise _err("POC progression changes not supported")
        # TLM/PLM/PLT/PPM/PPT/RGN/CRG: skipped
        pos += lseg
    if cs.siz is None or cs.cod is None or cs.qcd is None:
        raise _err("incomplete main header")
    return cs


# ---------------------------------------------------------------- geometry

@dataclass
class Band:
    orient: int          # 0 LL, 1 HL, 2 LH, 3 HH
    r: int               # resolution this band belongs to
    x0: int
    y0: int
    x1: int
    y1: int
    band_index: int      # index into quantization step list

    @property
    def w(self):
        return self.x1 - self.x0

    @property
    def h(self):
        return self.y1 - self.y0

    @property
    def gain(self):
        return (0, 1, 1, 2)[self.orient]


@dataclass
class Resolution:
    r: int
    x0: int
    y0: int
    x1: int
    y1: int
    bands: List[Band]
    ppx: int
    ppy: int

    @property
    def num_prec_x(self) -> int:
        if self.x1 <= self.x0:
            return 0
        return ceil_div(self.x1, 1 << self.ppx) - (self.x0 >> self.ppx)

    @property
    def num_prec_y(self) -> int:
        if self.y1 <= self.y0:
            return 0
        return ceil_div(self.y1, 1 << self.ppy) - (self.y0 >> self.ppy)


def tile_bounds(siz: SizSeg, p: int, q: int) -> Tuple[int, int, int, int]:
    tx0 = max(siz.xtosiz + p * siz.xtsiz, siz.xosiz)
    ty0 = max(siz.ytosiz + q * siz.ytsiz, siz.yosiz)
    tx1 = min(siz.xtosiz + (p + 1) * siz.xtsiz, siz.xsiz)
    ty1 = min(siz.ytosiz + (q + 1) * siz.ytsiz, siz.ysiz)
    return tx0, ty0, tx1, ty1


def tile_comp_bounds(siz: SizSeg, c: int, tb) -> Tuple[int, int, int, int]:
    comp = siz.comps[c]
    return (ceil_div(tb[0], comp.xr), ceil_div(tb[1], comp.yr),
            ceil_div(tb[2], comp.xr), ceil_div(tb[3], comp.yr))


def build_resolutions(tcx0, tcy0, tcx1, tcy1, cod: CodStyle) -> List[Resolution]:
    n = cod.levels
    out = []
    for r in range(n + 1):
        d = n - r
        trx0, try0 = ceil_div(tcx0, 1 << d), ceil_div(tcy0, 1 << d)
        trx1, try1 = ceil_div(tcx1, 1 << d), ceil_div(tcy1, 1 << d)
        bands = []
        if r == 0:
            bands.append(Band(0, 0, trx0, try0, trx1, try1, 0))
        else:
            lev = n - r + 1          # decomposition level of these bands
            for bi, (orient, xob, yob) in enumerate(
                    ((1, 1, 0), (2, 0, 1), (3, 1, 1))):
                sh = 1 << lev
                hf = 1 << (lev - 1)
                bx0 = ceil_div(tcx0 - hf * xob, sh)
                by0 = ceil_div(tcy0 - hf * yob, sh)
                bx1 = ceil_div(tcx1 - hf * xob, sh)
                by1 = ceil_div(tcy1 - hf * yob, sh)
                bands.append(Band(orient, r, bx0, by0, bx1, by1,
                                  1 + 3 * (r - 1) + bi))
        ppx, ppy = cod.precinct_exp(r)
        out.append(Resolution(r, trx0, try0, trx1, try1, bands, ppx, ppy))
    return out


def cblk_span(band: Band, res: Resolution, cod: CodStyle,
              prec_ix: int, prec_iy: int):
    """Code-block grid covering the intersection of `band` with
    precinct (prec_ix, prec_iy) of `res`.  Yields code-block
    rectangles in band coordinates, raster order, plus grid dims."""
    # precinct bounds in resolution coords
    px0 = ((res.x0 >> res.ppx) + prec_ix) << res.ppx
    py0 = ((res.y0 >> res.ppy) + prec_iy) << res.ppy
    px1 = min(px0 + (1 << res.ppx), res.x1)
    py1 = min(py0 + (1 << res.ppy), res.y1)
    px0 = max(px0, res.x0)
    py0 = max(py0, res.y0)
    # map to band coords: for r>0 halve (bands live at half resolution)
    if band.r == 0:
        bpx0, bpy0, bpx1, bpy1 = px0, py0, px1, py1
    else:
        bpx0, bpy0 = ceil_div(px0, 2), ceil_div(py0, 2)
        bpx1, bpy1 = ceil_div(px1, 2), ceil_div(py1, 2)
    bpx0, bpy0 = max(bpx0, band.x0), max(bpy0, band.y0)
    bpx1, bpy1 = min(bpx1, band.x1), min(bpy1, band.y1)
    # code-block nominal size (clamped by precinct)
    xcb = min(cod.xcb, res.ppx if band.r == 0 else res.ppx - 1)
    ycb = min(cod.ycb, res.ppy if band.r == 0 else res.ppy - 1)
    cw, ch = 1 << xcb, 1 << ycb
    if bpx1 <= bpx0 or bpy1 <= bpy0:
        return [], 0, 0
    gx0, gx1 = bpx0 // cw, ceil_div(bpx1, cw)
    gy0, gy1 = bpy0 // ch, ceil_div(bpy1, ch)
    blocks = []
    for gy in range(gy0, gy1):
        for gx in range(gx0, gx1):
            cx0 = max(gx * cw, bpx0)
            cy0 = max(gy * ch, bpy0)
            cx1 = min((gx + 1) * cw, bpx1)
            cy1 = min((gy + 1) * ch, bpy1)
            blocks.append((cx0, cy0, cx1, cy1))
    return blocks, gx1 - gx0, gy1 - gy0
