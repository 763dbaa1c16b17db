"""HT-J2K block coder: the ISO/IEC 15444-15 (ITU-T T.814) cleanup pass.

High-throughput JPEG 2000 replaces EBCOT tier-1's bit-plane MQ coding
with a single cleanup pass over 2x2 sample quads, split across three
byte streams inside one codeword segment:

  [ MagSgn (forward) | MEL (forward) ... VLC (backward) ]
                      `----------- Scup suffix ---------'

* MagSgn codes each significant sample's value v = 2*(mu-1) + sign in
  m = U_q - e_k bits, LSB-first, with a 7-bit byte after any 0xFF.
* MEL is an adaptive run coder for "all-zero-context quad is
  significant" events ('1' = full run of 2^E(k) zeros, '0' + E(k)
  MSB-first bits = partial run then a one; 7-bit byte after 0xFF).
* VLC grows backwards from the end of the segment and interleaves
  context-VLC codewords for quad significance patterns with u_q
  residual codes; the final two bytes carry Scup, and a byte following
  (in read order) a byte value > 0x8F carries only 7 bits.

The reference obtains HT-J2K encoding from OpenJPH
(libheif/plugins/encoder_openjph.cc,
libheif/codecs/jpeg2000_enc.h:84 Encoder_HTJ2K); this
module implements the block coder natively — both directions — and is
difftested against the system OpenJPEG 2.5 HT decoder.

Entropy coding is inherently serial/byte-oriented: host-side by
design, like the CABAC/MSAC engines (SURVEY.md section 7).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ...core.error import HeifError
from . import native
from .native import encoding_error
from .ht_tables import (ENC_TBL_INIT, ENC_TBL_NONINIT, MEL_E, VLC_TBL_INIT,
                        VLC_TBL_NONINIT)


# --------------------------------------------------------------- streams

class MagSgnWriter:
    """Forward byte stream, bits packed LSB-first; a byte following an
    emitted 0xFF holds only 7 data bits (bit 7 stays 0)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0
        self.cap = 8

    def bits(self, v: int, n: int) -> None:
        while n > 0:
            take = min(n, self.cap - self.nbits)
            self.acc |= (v & ((1 << take) - 1)) << self.nbits
            v >>= take
            n -= take
            self.nbits += take
            if self.nbits == self.cap:
                self.out.append(self.acc)
                self.cap = 7 if self.acc == 0xFF else 8
                self.acc = 0
                self.nbits = 0

    def flush(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc)
            self.acc = 0
            self.nbits = 0
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)      # keep the next segment byte unstuffed
        return bytes(self.out)


class MagSgnReader:
    """Forward LSB-first bit reader with the 0xFF/7-bit rule; reads
    past the end return 1-bits (0xFF padding), as the reference
    decoder does."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False

    def bits(self, n: int) -> int:
        while self.nbits < n:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            take = 7 if self.prev_ff else 8
            self.acc |= (b & ((1 << take) - 1)) << self.nbits
            self.nbits += take
            self.prev_ff = b == 0xFF
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return v


class MELEncoder:
    """MEL adaptive run coder (T.814 clause 7.2), MSB-first bytes."""

    def __init__(self):
        self.k = 0
        self.run = 0
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0
        self.cap = 8

    def _bit(self, b: int) -> None:
        self.acc = (self.acc << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == self.cap:
            self.out.append(self.acc)
            self.cap = 7 if self.acc == 0xFF else 8
            self.acc = 0
            self.nbits = 0

    def event(self, e: int) -> None:
        if not e:
            self.run += 1
            if self.run == 1 << MEL_E[self.k]:
                self._bit(1)
                self.run = 0
                self.k = min(self.k + 1, 12)
        else:
            self._bit(0)
            for i in range(MEL_E[self.k] - 1, -1, -1):
                self._bit((self.run >> i) & 1)
            self.run = 0
            self.k = max(self.k - 1, 0)

    def flush(self) -> bytes:
        if self.run:
            self._bit(1)            # complete-run bit covers pending zeros
        if self.nbits:
            self.acc <<= self.cap - self.nbits
            self.out.append(self.acc)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


class MELDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.k = 0
        self.acc = 0
        self.nbits = 0
        self.prev_ff = False
        self._zeros = 0          # pending zero events from the current run
        self._one = 0            # pending one event terminating the run

    def _bit(self) -> int:
        if self.nbits == 0:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0xFF
            self.nbits = 7 if self.prev_ff else 8
            self.acc = b & ((1 << self.nbits) - 1)
            self.prev_ff = b == 0xFF
        self.nbits -= 1
        return (self.acc >> self.nbits) & 1

    def event(self) -> int:
        while True:
            if self._zeros:
                self._zeros -= 1
                return 0
            if self._one:
                self._one = 0
                return 1
            if self._bit():
                self._zeros = 1 << MEL_E[self.k]
                self.k = min(self.k + 1, 12)
            else:
                run = 0
                for _ in range(MEL_E[self.k]):
                    run = (run << 1) | self._bit()
                self.k = max(self.k - 1, 0)
                self._zeros = run
                self._one = 1


class VLCWriter:
    """Backward-growing VLC stream.  Bits are collected forward and
    packed at flush time: the first up-to-4 bits land in the high
    nibble of the byte at Lcup-2 (with at most 3 bits if they are all
    ones), later bits fill bytes at decreasing addresses LSB-first,
    with a 7-bit byte whenever the previously packed byte (higher
    address) exceeds 0x8F."""

    def __init__(self):
        self.bits: List[int] = []

    def codeword(self, v: int, n: int) -> None:
        for i in range(n):
            self.bits.append((v >> i) & 1)

    def pack(self) -> Tuple[int, List[int]]:
        """Returns (nibble, tail_bytes) where tail_bytes[0] is the byte
        at Lcup-3 and so on toward lower addresses."""
        b = self.bits
        i = 0
        if len(b) >= 3 and b[0] == b[1] == b[2] == 1:
            nib = 0b0111
            i = 3
        else:
            nib = 0
            while i < min(4, len(b)):
                nib |= b[i] << i
                i += 1
        tail: List[int] = []
        prev_gt = nib >= 9
        while i < len(b):
            val = 0
            take = min(7, len(b) - i)
            for j in range(take):
                val |= b[i + j] << j
            i += take
            # after a byte > 0x8F the next byte holds 7 bits only when
            # its low seven bits are all ones (bit 7 is then a stuffed 0)
            if (not prev_gt or val != 0x7F) and i < len(b):
                val |= b[i] << 7
                i += 1
            tail.append(val)
            prev_gt = val > 0x8F
        return nib, tail


class VLCReader:
    """Backward VLC bit reader over a cleanup segment suffix."""

    def __init__(self, seg: bytes, lcup: int, scup: int):
        self.seg = seg
        self.pos = lcup - 2          # next byte to read (moving down)
        self.lo = lcup - scup        # lowest valid address
        first = seg[lcup - 2]
        nib = first >> 4
        self.acc = nib
        self.nbits = 3 if (nib & 7) == 7 else 4
        self.prev_gt = (first | 0x0F) > 0x8F
        self.pos -= 1

    def _fill(self) -> None:
        if self.pos >= self.lo:
            b = self.seg[self.pos]
            self.pos -= 1
        else:
            b = 0xFF
        take = 8
        if self.prev_gt and (b & 0x7F) == 0x7F:
            take = 7
        self.acc |= (b & ((1 << take) - 1)) << self.nbits
        self.nbits += take
        self.prev_gt = b > 0x8F

    def peek(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        return self.acc & ((1 << n) - 1)

    def skip(self, n: int) -> None:
        while self.nbits < n:
            self._fill()
        self.acc >>= n
        self.nbits -= n


# --------------------------------------------------------------- u-VLC

def _u_codeword(u: int) -> Tuple[List[int], int, int]:
    """(prefix bits, suffix value, suffix length) for u in 1..36."""
    if u == 1:
        return [1], 0, 0
    if u == 2:
        return [0, 1], 0, 0
    if u <= 4:
        return [0, 0, 1], u - 3, 1
    if u <= 36:
        return [0, 0, 0], u - 5, 5
    raise encoding_error("HT u_q %d out of range" % u)


def _write_u_pair(vlc: VLCWriter, u0: Optional[int], u1: Optional[int]):
    """Interleaved pair coding: pfx0 pfx1 sfx0 sfx1."""
    p0 = _u_codeword(u0) if u0 else None
    p1 = _u_codeword(u1) if u1 else None
    for p in (p0, p1):
        if p:
            for bit in p[0]:
                vlc.bits.append(bit)
    for p in (p0, p1):
        if p and p[2]:
            vlc.codeword(p[1], p[2])


def _write_u_pair_initial(vlc: VLCWriter, u0: int, u1: int):
    """Initial-row both-u_off pair with MEL event 0 (not both > 2):
    when u0 > 2 the other quad's u is necessarily 1 or 2 and is coded
    as a single bit between pfx0 and sfx0."""
    if u0 > 2:
        pfx, sfx, sfxlen = _u_codeword(u0)
        for bit in pfx:
            vlc.bits.append(bit)
        vlc.bits.append(u1 - 1)
        if sfxlen:
            vlc.codeword(sfx, sfxlen)
    else:
        _write_u_pair(vlc, u0, u1)


_U_PFX = None


def _read_u(vlc: VLCReader) -> Tuple[int, int]:
    """Decode one u prefix; returns (base value, suffix length)."""
    p = vlc.peek(3)
    if p & 1:
        vlc.skip(1)
        return 1, 0
    if p & 2:
        vlc.skip(2)
        return 2, 0
    if p & 4:
        vlc.skip(3)
        return 3, 1
    vlc.skip(3)
    return 5, 5


def _read_u_pair(vlc: VLCReader, want0: bool, want1: bool) -> Tuple[int, int]:
    b0 = s0 = b1 = s1 = 0
    if want0:
        b0, s0 = _read_u(vlc)
    if want1:
        b1, s1 = _read_u(vlc)
    u0 = u1 = 0
    if want0:
        u0 = b0 + (vlc.peek(s0) if s0 else 0)
        vlc.skip(s0)
    if want1:
        u1 = b1 + (vlc.peek(s1) if s1 else 0)
        vlc.skip(s1)
    return u0, u1


def _read_u_pair_initial(vlc: VLCReader) -> Tuple[int, int]:
    """Inverse of _write_u_pair_initial."""
    b0, s0 = _read_u(vlc)
    if b0 >= 3:                       # 3-bit prefix: u0 > 2, u1 in {1, 2}
        u1 = vlc.peek(1) + 1
        vlc.skip(1)
        u0 = b0 + (vlc.peek(s0) if s0 else 0)
        vlc.skip(s0)
        return u0, u1
    b1, s1 = _read_u(vlc)
    u0 = b0 + (vlc.peek(s0) if s0 else 0)
    vlc.skip(s0)
    u1 = b1 + (vlc.peek(s1) if s1 else 0)
    vlc.skip(s1)
    return u0, u1


# ------------------------------------------------------------ block coder

def _bitlen(v: int) -> int:
    return int(v).bit_length()


def encode_cleanup(coef: np.ndarray) -> Tuple[bytes, int]:
    """Encode one code-block's coefficients (int array, full precision,
    bit-plane p=0) as an HT cleanup-pass codeword segment.

    Returns (segment bytes, B) where B is the number of magnitude
    bit-planes spanned (for the packet header's zero-bit-planes field:
    zp = Mb - B)."""
    coef = np.asarray(coef, dtype=np.int64)
    h, w = coef.shape
    sig = coef != 0
    if not sig.any():
        raise encoding_error("HT cleanup on all-zero block")
    if not native.fits(w, h):
        return encode_cleanup_python(coef)
    c32 = np.ascontiguousarray(coef, np.int32)
    cap = 16 * w * h + 4096
    buf = np.empty(cap, np.uint8)
    out_len = np.zeros(1, np.int64)
    b_out = np.zeros(1, np.int32)
    rc = native.lib().tpuheif_ht_encode_cleanup(
        c32.ctypes.data, w, h, buf.ctypes.data, cap, out_len.ctypes.data,
        b_out.ctypes.data)
    if rc == 2:
        raise encoding_error("HT cleanup Scup overflow")
    native.check(rc, "HT cleanup encode", decode=False)
    return buf[:int(out_len[0])].tobytes(), int(b_out[0])


def encode_cleanup_python(coef: np.ndarray) -> Tuple[bytes, int]:
    """``encode_cleanup`` in Python."""
    coef = np.asarray(coef, dtype=np.int64)
    h, w = coef.shape
    sig = coef != 0
    if not sig.any():
        raise encoding_error("HT cleanup on all-zero block")
    mu = np.abs(coef)
    v = np.where(sig, 2 * (mu - 1) + (coef < 0), 0)
    B = _bitlen(int(mu.max()))
    qw = (w + 1) // 2
    qh = (h + 1) // 2

    def sample(qx, qy, n):
        x = 2 * qx + (n >> 1)
        y = 2 * qy + (n & 1)
        if x >= w or y >= h:
            return False, 0
        return bool(sig[y, x]), int(v[y, x])

    mel = MELEncoder()
    vlc = VLCWriter()
    ms = MagSgnWriter()
    prev_s = np.zeros(qw + 2, dtype=bool)
    prev_e = np.zeros(qw + 2, dtype=np.int64)

    for qy in range(qh):
        initial = qy == 0
        cur_s = np.zeros(qw + 2, dtype=bool)
        cur_e = np.zeros(qw + 2, dtype=np.int64)
        carry = 0                   # next-quad context contribution
        qx = 0
        while qx < qw:
            npair = min(2, qw - qx)
            uoffs = [0, 0]
            uvals = [0, 0]
            for j in range(npair):
                q = qx + j
                svals = [sample(q, qy, n) for n in range(4)]
                rho = sum(1 << n for n in range(4) if svals[n][0])
                if initial:
                    ctx = carry
                else:
                    ctx = (int(prev_s[q]) | (carry << 1)
                           | (int(prev_s[q + 1]) << 2))
                if ctx == 0:
                    mel.event(1 if rho else 0)
                if rho or ctx != 0:
                    es = [_bitlen(svals[n][1] | 1) if svals[n][0] else 0
                          for n in range(4)]
                    emax = max(es) if rho else 0
                    if rho:
                        gamma = (rho & (rho - 1)) != 0
                        if initial or not gamma:
                            kappa = 1
                        else:
                            kappa = max(
                                1, int(max(prev_e[q], prev_e[q + 1])) - 1)
                        u = max(0, emax - kappa)
                        bigu = kappa + u
                    else:
                        u = 0
                        bigu = 0
                    u_off = 1 if u > 0 else 0
                    uoffs[j] = u_off
                    uvals[j] = u
                    tbl = ENC_TBL_INIT if initial else ENC_TBL_NONINIT
                    alpha = sum(1 << n for n in range(4)
                                if svals[n][0] and es[n] == bigu)
                    cw = None
                    for (ln, cwd, e_k, e_1) in tbl[(ctx, rho, u_off)]:
                        if e_k & ~rho:
                            continue
                        if (e_1 & e_k) != (alpha & e_k):
                            continue
                        cw = (ln, cwd, e_k, e_1)
                        break
                    if cw is None:      # tables are complete; cannot happen
                        raise HeifError.encoding_error(
                            msg="no consistent HT VLC codeword")
                    ln, cwd, e_k, e_1 = cw
                    vlc.codeword(cwd, ln)
                    for n in range(4):
                        if svals[n][0]:
                            m = bigu - ((e_k >> n) & 1)
                            ms.bits(svals[n][1] & ((1 << m) - 1), m)
                # state updates
                if initial:
                    carry = ((rho | (rho >> 1)) & 1) | ((rho >> 1) & 2) \
                        | ((rho >> 1) & 4)
                else:
                    carry = ((rho >> 2) | (rho >> 3)) & 1
                sb, vb = svals[1]        # bottom-left
                if sb:
                    cur_s[q] = True
                    cur_e[q] = max(cur_e[q], _bitlen(vb | 1))
                sb, vb = svals[3]        # bottom-right
                if sb:
                    cur_s[q + 1] = True
                    cur_e[q + 1] = max(cur_e[q + 1], _bitlen(vb | 1))
            # u residual coding for the pair
            if npair == 2 and uoffs[0] and uoffs[1]:
                if initial:
                    both_big = uvals[0] > 2 and uvals[1] > 2
                    mel.event(1 if both_big else 0)
                    if both_big:
                        _write_u_pair(vlc, uvals[0] - 2, uvals[1] - 2)
                    else:
                        _write_u_pair_initial(vlc, uvals[0], uvals[1])
                else:
                    _write_u_pair(vlc, uvals[0], uvals[1])
            elif uoffs[0] or (npair == 2 and uoffs[1]):
                _write_u_pair(vlc, uvals[0] if uoffs[0] else None,
                              uvals[1] if uoffs[1] else None)
            qx += npair
        prev_s, prev_e = cur_s, cur_e

    mel_bytes = bytearray(mel.flush())
    nib, tail = vlc.pack()
    ms_bytes = ms.flush()
    # avoid 0xFF >0x8F marker emulation at the MEL/VLC seam
    vlc_first = tail[-1] if tail else (nib << 4)
    if mel_bytes and mel_bytes[-1] == 0xFF and vlc_first > 0x8F:
        mel_bytes.append(0)
    scup = len(mel_bytes) + len(tail) + 2
    if scup > 4079:
        raise encoding_error("HT cleanup Scup overflow")
    seg = bytearray(ms_bytes)
    seg += mel_bytes
    seg += bytes(reversed(tail))
    seg.append((nib << 4) | (scup & 0xF))
    seg.append(scup >> 4)
    return bytes(seg), B


def decode_cleanup(seg: bytes, w: int, h: int, B: int) -> np.ndarray:
    """Decode an HT cleanup segment into full-precision coefficients
    (int32, bit-plane p=0).  B bounds the quad exponents (U_q <= B+1);
    pass the band's Mb."""
    lcup = len(seg)
    if lcup < 2:
        raise HeifError.invalid_input(msg="HT segment too short")
    scup = (seg[lcup - 1] << 4) | (seg[lcup - 2] & 0xF)
    if scup < 2 or scup > min(lcup, 4079):
        raise HeifError.invalid_input(msg="invalid HT Scup")
    if not native.fits(w, h):
        return decode_cleanup_python(seg, w, h, B)
    buf = native.data_buffer(seg)
    out = np.empty((h, w), np.int32)
    rc = native.lib().tpuheif_ht_decode_cleanup(
        buf.ctypes.data, lcup, w, h, B, out.ctypes.data)
    if rc == 2:
        raise HeifError.invalid_input(msg="invalid HT cleanup segment")
    native.check(rc, "HT cleanup decode", decode=True)
    return out


def decode_cleanup_python(seg: bytes, w: int, h: int, B: int) -> np.ndarray:
    """``decode_cleanup`` in Python."""
    lcup = len(seg)
    if lcup < 2:
        raise HeifError.invalid_input(msg="HT segment too short")
    scup = (seg[lcup - 1] << 4) | (seg[lcup - 2] & 0xF)
    if scup < 2 or scup > min(lcup, 4079):
        raise HeifError.invalid_input(msg="invalid HT Scup")
    mel = MELDecoder(seg[lcup - scup:lcup])
    vlc = VLCReader(seg, lcup, scup)
    ms = MagSgnReader(seg[:lcup - scup])
    out = np.zeros((h, w), dtype=np.int64)
    qw = (w + 1) // 2
    qh = (h + 1) // 2
    prev_s = np.zeros(qw + 2, dtype=bool)
    prev_e = np.zeros(qw + 2, dtype=np.int64)
    for qy in range(qh):
        initial = qy == 0
        tbl = VLC_TBL_INIT if initial else VLC_TBL_NONINIT
        cur_s = np.zeros(qw + 2, dtype=bool)
        cur_e = np.zeros(qw + 2, dtype=np.int64)
        carry = 0
        qx = 0
        while qx < qw:
            npair = min(2, qw - qx)
            qinfo = []
            for j in range(npair):
                q = qx + j
                if initial:
                    ctx = carry
                else:
                    ctx = (int(prev_s[q]) | (carry << 1)
                           | (int(prev_s[q + 1]) << 2))
                rho = u_off = e_k = e_1 = 0
                if ctx == 0 and not mel.event():
                    pass
                else:
                    ent = tbl[(ctx << 7) | vlc.peek(7)]
                    vlc.skip(ent & 7)
                    rho = (ent >> 4) & 0xF
                    u_off = (ent >> 3) & 1
                    e_1 = (ent >> 8) & 0xF
                    e_k = (ent >> 12) & 0xF
                if initial:
                    carry = ((rho | (rho >> 1)) & 1) | ((rho >> 1) & 2) \
                        | ((rho >> 1) & 4)
                else:
                    carry = ((rho >> 2) | (rho >> 3)) & 1
                qinfo.append((q, rho, u_off, e_k, e_1))
            # u values
            us = [0] * npair
            if npair == 2 and qinfo[0][2] and qinfo[1][2]:
                if initial:
                    if mel.event():
                        u0, u1 = _read_u_pair(vlc, True, True)
                        us = [u0 + 2, u1 + 2]
                    else:
                        us = list(_read_u_pair_initial(vlc))
                else:
                    us = list(_read_u_pair(vlc, True, True))
            elif qinfo[0][2] or (npair == 2 and qinfo[1][2]):
                u0, u1 = _read_u_pair(vlc, bool(qinfo[0][2]),
                                      bool(npair == 2 and qinfo[1][2]))
                us = [u0, u1][:npair]
            # magnitudes
            for j in range(npair):
                q, rho, u_off, e_k, e_1 = qinfo[j]
                if not rho:
                    continue
                gamma = (rho & (rho - 1)) != 0
                if initial or not gamma:
                    kappa = 1
                else:
                    kappa = max(1, int(max(prev_e[q], prev_e[q + 1])) - 1)
                bigu = kappa + us[j]
                if bigu > B + 1:
                    raise HeifError.invalid_input(
                        msg="HT U_q exceeds bit-plane count")
                for n in range(4):
                    if not (rho >> n) & 1:
                        continue
                    x = 2 * q + (n >> 1)
                    y = 2 * qy + (n & 1)
                    if x >= w or y >= h:
                        raise HeifError.invalid_input(
                            msg="HT significance outside block")
                    m = bigu - ((e_k >> n) & 1)
                    val = ms.bits(m) | (((e_1 >> n) & 1) << m)
                    mu = (val >> 1) + 1
                    out[y, x] = -mu if val & 1 else mu
                    if n in (1, 3):
                        col = q + (n >> 1)
                        cur_s[col] = True
                        cur_e[col] = max(cur_e[col], _bitlen(val | 1))
            qx += npair
        prev_s, prev_e = cur_s, cur_e
    return out.astype(np.int32)


# ------------------------------------------------- SigProp / MagRef

class SigPropReader(MagSgnReader):
    """Forward LSB-first reader for the SigProp raw stream: same
    0xFF/7-bit unstuffing as MagSgn but zero padding past the end
    (ht_dec.c frwd_init<0>)."""

    def bits(self, n: int) -> int:
        while self.nbits < n:
            if self.pos < len(self.data):
                b = self.data[self.pos]
                self.pos += 1
            else:
                b = 0x00
            take = 7 if self.prev_ff else 8
            self.acc |= (b & ((1 << take) - 1)) << self.nbits
            self.nbits += take
            self.prev_ff = b == 0xFF
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return v


class MagRefWriter:
    """Backward-growing MagRef raw stream: bytes pack LSB-first at
    decreasing addresses from the segment end.  Stuffing rule (pinned
    against the OpenJPEG 2.5 HT decoder, ht_dec.c rev_*_mrp): when the
    previously read byte's LOW SEVEN bits are all ones, the next byte
    (toward the segment start) holds only 7 data bits in bits 1..7 and
    bit 0 is a stuffed zero."""

    def __init__(self):
        self.bits: List[int] = []

    def bit(self, b: int) -> None:
        self.bits.append(b & 1)

    def pack(self) -> bytes:
        b = self.bits
        out: List[int] = []       # out[0] = byte at the segment end
        i = 0
        skip_next = False         # this byte's bit 0 is stuffed
        unstuff = True            # previous byte (read order) > 0x8F
        while i < len(b):
            if skip_next:
                # data at bits 1..7; stuffed bit 0 = 0 keeps the low-7
                # pattern away from 0x7F so no special form triggers
                take = min(7, len(b) - i)
                val = 0
                for j in range(take):
                    val |= b[i + j] << (j + 1)
                i += take
            elif unstuff and len(b) - i >= 7 and \
                    all(b[i + j] for j in range(7)):
                # seven ones in the low bits would decode as a special
                # byte: bit 7 carries the 8th data bit if it is a one
                # (0xFF, stuffed bit deferred to the next byte's bit 0),
                # else bit 7 is the stuffed zero (0x7F, 7 bits)
                if len(b) - i >= 8 and b[i + 7]:
                    val = 0xFF
                    i += 8
                else:
                    val = 0x7F
                    i += 7
            else:
                take = min(8, len(b) - i)
                val = 0
                for j in range(take):
                    val |= b[i + j] << j
                i += take
            skip_next = unstuff and (val & 0x7F) == 0x7F and val > 0x7F
            unstuff = val > 0x8F
            out.append(val)
        return bytes(reversed(out))


class MagRefReader:
    """Backward LSB-first reader mirroring MagRefWriter; reads past
    the available bytes return zero bits."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = len(data) - 1
        self.acc = 0
        self.nbits = 0
        self.skip_next = False
        self.unstuff = True

    def bit(self) -> int:
        if self.nbits == 0:
            if self.pos >= 0:
                b = self.data[self.pos]
                self.pos -= 1
            else:
                b = 0
            start = 1 if self.skip_next else 0
            special = self.unstuff and (b & 0x7F) == 0x7F
            if special and b > 0x7F:          # 0xFF-form: 8th bit data
                end = 8
                self.skip_next = True
            elif special:                      # 0x7F-form: bit 7 stuffed
                end = 7
                self.skip_next = False
            else:
                end = 8
                self.skip_next = False
            self.acc = (b >> start) & ((1 << (end - start)) - 1)
            self.nbits = end - start
            self.unstuff = b > 0x8F
        v = self.acc & 1
        self.acc >>= 1
        self.nbits -= 1
        return v


def _sigprop_scan(w: int, h: int):
    """(x, y) scan order of the SigProp/MagRef passes: stripes of 4
    rows, columns left to right, top to bottom within a column."""
    for ys in range(0, h, 4):
        sh = min(4, h - ys)
        for x in range(w):
            for dy in range(sh):
                yield x, ys + dy


def _sigprop_groups(w: int, h: int):
    """SigProp sample groups: four stripe columns per group, samples
    column-major within the group."""
    for ys in range(0, h, 4):
        sh = min(4, h - ys)
        for xb in range(0, w, 4):
            group = []
            for x in range(xb, min(xb + 4, w)):
                for dy in range(sh):
                    group.append((x, ys + dy))
            yield group


def encode_refinement(coef: np.ndarray, high: np.ndarray) -> bytes:
    """Encode the SigProp + MagRef passes refining the cleanup-coded
    `high` halves (T.814 clauses 7.4/7.5) to full precision `coef`
    (pass planes p = 2: the refinement plane is bit 0)."""
    coef = np.asarray(coef, np.int64)
    high = np.asarray(high, np.int64)
    h, w = coef.shape
    if not native.fits(w, h):
        return encode_refinement_python(coef, high)
    c32 = np.ascontiguousarray(coef, np.int32)
    h32 = np.ascontiguousarray(high, np.int32)
    cap = 4 * w * h + 4096
    buf = np.empty(cap, np.uint8)
    out_len = np.zeros(1, np.int64)
    native.check(native.lib().tpuheif_ht_encode_refinement(
        c32.ctypes.data, h32.ctypes.data, w, h, buf.ctypes.data, cap,
        out_len.ctypes.data), "HT refinement encode", decode=False)
    return buf[:int(out_len[0])].tobytes()


def encode_refinement_python(coef: np.ndarray, high: np.ndarray) -> bytes:
    """``encode_refinement`` in Python."""
    coef = np.asarray(coef, np.int64)
    high = np.asarray(high, np.int64)
    h, w = coef.shape
    sig0 = high != 0                       # significant after cleanup
    low = (np.abs(coef) & 1).astype(np.int64)

    sp = MagSgnWriter()                    # same forward packing rules
    new_sig = np.zeros((h, w), bool)

    def neighbor_sig(x, y):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                nx, ny = x + dx, y + dy
                if 0 <= nx < w and 0 <= ny < h and \
                        (sig0[ny, nx] or new_sig[ny, nx]):
                    return True
        return False

    # groups span FOUR stripe columns (pinned against the OpenJPEG 2.5
    # HT decoder): each group codes its candidates' significance bits in
    # column-major order (causal within the group), then the sign bits
    # of the samples that just became significant
    for group in _sigprop_groups(w, h):
        grp_new = []
        for (x, y) in group:
            if sig0[y, x] or new_sig[y, x]:
                continue
            if not neighbor_sig(x, y):
                continue
            bit = int(low[y, x])
            sp.bits(bit, 1)
            if bit:
                new_sig[y, x] = True
                grp_new.append((x, y))
        for (sx, sy) in grp_new:
            sp.bits(1 if coef[sy, sx] < 0 else 0, 1)

    mr = MagRefWriter()
    for x, y in _sigprop_scan(w, h):
        if sig0[y, x]:
            mr.bit(int(low[y, x]))

    return bytes(sp.flush()) + mr.pack()


def decode_refinement(seg: bytes, high: np.ndarray, w: int,
                      h: int, magref: bool = True) -> np.ndarray:
    """Decode a SigProp + MagRef refinement segment against the
    cleanup-decoded halves `high`; returns full-precision int32."""
    high = np.asarray(high, np.int64)
    if not native.fits(w, h):
        return decode_refinement_python(seg, high, w, h, magref)
    h32 = np.ascontiguousarray(high, np.int32)
    buf = native.data_buffer(seg)
    out = np.empty((h, w), np.int32)
    native.check(native.lib().tpuheif_ht_decode_refinement(
        buf.ctypes.data, len(seg), h32.ctypes.data, w, h,
        1 if magref else 0, out.ctypes.data),
        "HT refinement decode", decode=True)
    return out


def decode_refinement_python(seg: bytes, high: np.ndarray, w: int,
                             h: int, magref: bool = True) -> np.ndarray:
    """``decode_refinement`` in Python."""
    high = np.asarray(high, np.int64)
    sig0 = high != 0
    sp = SigPropReader(seg)
    out = 2 * np.abs(high)
    sign = np.where(high < 0, -1, 1)
    new_sig = np.zeros((h, w), bool)

    def neighbor_sig(x, y):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                nx, ny = x + dx, y + dy
                if 0 <= nx < w and 0 <= ny < h and \
                        (sig0[ny, nx] or new_sig[ny, nx]):
                    return True
        return False

    for group in _sigprop_groups(w, h):
        grp_new = []
        for (x, y) in group:
            if sig0[y, x] or new_sig[y, x]:
                continue
            if not neighbor_sig(x, y):
                continue
            if sp.bits(1):
                new_sig[y, x] = True
                grp_new.append((x, y))
        for (sx, sy) in grp_new:
            out[sy, sx] = 1
            sign[sy, sx] = -1 if sp.bits(1) else 1

    if magref:                   # absent when only 2 passes were coded
        mr = MagRefReader(seg)
        for x, y in _sigprop_scan(w, h):
            if sig0[y, x]:
                out[y, x] |= mr.bit()

    return (sign * out).astype(np.int32)
