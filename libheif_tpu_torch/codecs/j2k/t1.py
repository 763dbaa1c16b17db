"""EBCOT tier-1 block coding (ISO/IEC 15444-1 Annex D).

Context-adaptive bit-plane coding of code-blocks with the MQ coder:
three passes per bit-plane (significance propagation, magnitude
refinement, cleanup) over 4-row stripes, run-length mode, sign
coding.  Host-side serial work, mirroring how CABAC/MSAC live on the
host in the HEVC/AV1 cores; the reference gets this from OpenJPEG
(opj_t1.c).

Counterpart of libheif_tpu/codecs/j2k/t1.py.  A block goes to the C++
coder (host/j2k_t1.cc through native.py) whenever it fits
(``native.fits``), and a failed call raises; the Python passes
(``decode_python``, ``encode_python``) are the coder's references in the
tests and take only the blocks the C++ refuses by shape.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import native
from .mq import MQDecoder, MQEncoder, CTX_RL, CTX_UNI, initial_states

# Subband orientations
LL, HL, LH, HH = 0, 1, 2, 3

# --- zero-coding context tables (Table D.1), indexed [h][v][d] clamped ---


def _zc_table(orient: int) -> np.ndarray:
    t = np.zeros((3, 3, 5), dtype=np.int8)
    for h in range(3):
        for v in range(3):
            for d in range(5):
                if orient == HH:
                    hv = min(h + v, 2)
                    if d >= 3:
                        c = 8
                    elif d == 2:
                        c = 7 if hv >= 1 else 6
                    elif d == 1:
                        c = (3, 4, 5)[hv]
                    else:
                        c = (0, 1, 2)[hv]
                else:
                    hh, vv = (h, v) if orient in (LL, LH) else (v, h)
                    hh, vv = min(hh, 2), min(vv, 2)
                    if hh == 2:
                        c = 8
                    elif hh == 1:
                        c = 7 if vv >= 1 else (6 if d >= 1 else 5)
                    else:
                        if vv == 2:
                            c = 4
                        elif vv == 1:
                            c = 3
                        else:
                            c = 2 if d >= 2 else (1 if d == 1 else 0)
                t[h, v, d] = c
    return t


_ZC_TABLES = {o: _zc_table(o) for o in (LL, HL, LH, HH)}

# sign-coding (Table D.3): (h+1, v+1) → (context, xor-bit)
_SC_TABLE = {
    (1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
    (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
    (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1),
}


class _BlockState:
    """Shared per-block geometry + coding state for decode and encode."""

    def __init__(self, w: int, h: int, orient: int):
        self.w, self.h = w, h
        self.orient = orient
        self.zc = _ZC_TABLES[orient]
        # padded state planes: index [y+1][x+1]
        self.sig = np.zeros((h + 2, w + 2), dtype=np.uint8)
        self.sgn = np.zeros((h + 2, w + 2), dtype=np.int8)   # -1/0/+1
        self.visited = np.zeros((h + 2, w + 2), dtype=np.uint8)
        self.refined = np.zeros((h + 2, w + 2), dtype=np.uint8)
        self.mag = np.zeros((h, w), dtype=np.int64)
        # lowest bit-plane at which each coefficient received a bit;
        # >0 after a truncated decode → midpoint reconstruction adds ½ LSB
        self.last_plane = np.zeros((h, w), dtype=np.int8)

    def zc_ctx(self, x: int, y: int) -> int:
        sig = self.sig
        xx, yy = x + 1, y + 1
        hsum = sig[yy, xx - 1] + sig[yy, xx + 1]
        vsum = sig[yy - 1, xx] + sig[yy + 1, xx]
        dsum = (sig[yy - 1, xx - 1] + sig[yy - 1, xx + 1]
                + sig[yy + 1, xx - 1] + sig[yy + 1, xx + 1])
        return int(self.zc[hsum, vsum, dsum])

    def sc_ctx(self, x: int, y: int) -> Tuple[int, int]:
        sgn = self.sgn
        xx, yy = x + 1, y + 1
        hc = max(-1, min(1, int(sgn[yy, xx - 1]) + int(sgn[yy, xx + 1])))
        vc = max(-1, min(1, int(sgn[yy - 1, xx]) + int(sgn[yy + 1, xx])))
        return _SC_TABLE[(hc, vc)]

    def mr_ctx(self, x: int, y: int) -> int:
        if self.refined[y + 1, x + 1]:
            return 16
        sig = self.sig
        xx, yy = x + 1, y + 1
        s = (int(sig[yy, xx - 1]) + int(sig[yy, xx + 1])
             + int(sig[yy - 1, xx]) + int(sig[yy + 1, xx])
             + int(sig[yy - 1, xx - 1]) + int(sig[yy - 1, xx + 1])
             + int(sig[yy + 1, xx - 1]) + int(sig[yy + 1, xx + 1]))
        return 15 if s else 14


def _stripe_iter(w: int, h: int):
    """Yield (k0, x) stripe-column starts in scan order."""
    for k0 in range(0, h, 4):
        for x in range(w):
            yield k0, x


class T1Decoder(_BlockState):
    """Decode one code-block's coding passes → signed magnitudes.

    The C++ MQ/T1 engine (host/j2k_t1.cc) decodes every block that fits
    it; this Python path is the conformance anchor the engine is
    difftested against."""

    def decode(self, data: bytes, num_passes: int, mb: int,
               zero_planes: int) -> np.ndarray:
        """mb = max bit-planes (guard + exponent - 1); returns int32
        (h, w) array of sign*magnitude in fixed point (integer)."""
        if not native.fits(self.w, self.h):
            return self.decode_python(data, num_passes, mb, zero_planes)
        buf = native.data_buffer(data)
        out = np.empty((self.h, self.w), np.int32)
        native.check(native.lib().tpuheif_j2k_t1_decode(
            buf.ctypes.data, len(data), num_passes, mb, zero_planes,
            self.w, self.h, self.orient, out.ctypes.data),
            "T1 decode", decode=True)
        return out

    def decode_python(self, data: bytes, num_passes: int, mb: int,
                      zero_planes: int) -> np.ndarray:
        """``decode`` in Python."""
        nplanes = mb - zero_planes
        if nplanes <= 0 or num_passes <= 0:
            return self.mag.astype(np.int32)
        dec = MQDecoder(data)
        p = 0  # pass counter
        plane = nplanes - 1
        while p < num_passes and plane >= 0:
            if p == 0:
                self._cleanup(dec, plane)
                p += 1
            else:
                self._sigprop(dec, plane)
                p += 1
                if p >= num_passes:
                    break
                self._magref(dec, plane)
                p += 1
                if p >= num_passes:
                    break
                self._cleanup(dec, plane)
                p += 1
            self.visited[:] = 0
            plane -= 1
        out = self.mag.astype(np.int64)
        # midpoint reconstruction for coefficients whose lowest decoded
        # bit-plane is above 0 (truncated codestream): + ½ LSB
        adj = (out > 0) & (self.last_plane > 0)
        out = np.where(adj, out + (1 << np.maximum(
            self.last_plane.astype(np.int64) - 1, 0)), out)
        sgn = self.sgn[1:-1, 1:-1].astype(np.int64)
        return (out * np.where(sgn < 0, -1, 1)).astype(np.int32)

    # -- passes ------------------------------------------------------
    def _become_sig(self, dec, x, y, plane):
        ctx, xbit = self.sc_ctx(x, y)
        s = dec.decode(ctx) ^ xbit
        self.sig[y + 1, x + 1] = 1
        self.sgn[y + 1, x + 1] = -1 if s else 1
        self.mag[y, x] |= 1 << plane
        self.last_plane[y, x] = plane

    def _sigprop(self, dec, plane):
        h, w = self.h, self.w
        sig, vis = self.sig, self.visited
        for k0, x in _stripe_iter(w, h):
            for y in range(k0, min(k0 + 4, h)):
                if sig[y + 1, x + 1]:
                    continue
                ctx = self.zc_ctx(x, y)
                if ctx == 0:
                    continue
                vis[y + 1, x + 1] = 1
                if dec.decode(ctx):
                    self._become_sig(dec, x, y, plane)

    def _magref(self, dec, plane):
        h, w = self.h, self.w
        sig, vis = self.sig, self.visited
        for k0, x in _stripe_iter(w, h):
            for y in range(k0, min(k0 + 4, h)):
                if not sig[y + 1, x + 1] or vis[y + 1, x + 1]:
                    continue
                bit = dec.decode(self.mr_ctx(x, y))
                self.refined[y + 1, x + 1] = 1
                if bit:
                    self.mag[y, x] |= 1 << plane
                self.last_plane[y, x] = plane
                vis[y + 1, x + 1] = 1

    def _cleanup(self, dec, plane):
        h, w = self.h, self.w
        sig, vis = self.sig, self.visited
        for k0, x in _stripe_iter(w, h):
            y = k0
            if (k0 + 3 < h
                    and not vis[k0 + 1:k0 + 5, x + 1].any()
                    and not sig[k0 + 1:k0 + 5, x + 1].any()
                    and self.zc_ctx(x, k0) == 0
                    and self.zc_ctx(x, k0 + 1) == 0
                    and self.zc_ctx(x, k0 + 2) == 0
                    and self.zc_ctx(x, k0 + 3) == 0):
                # run-length mode
                if not dec.decode(CTX_RL):
                    continue
                r = (dec.decode(CTX_UNI) << 1) | dec.decode(CTX_UNI)
                y = k0 + r
                self._become_sig(dec, x, y, plane)
                y += 1
            for yy in range(y, min(k0 + 4, h)):
                if sig[yy + 1, x + 1] or vis[yy + 1, x + 1]:
                    continue
                if dec.decode(self.zc_ctx(x, yy)):
                    self._become_sig(dec, x, yy, plane)


class T1Encoder(_BlockState):
    """Encode a code-block: all passes, single MQ segment.

    Returns (data, num_passes, nplanes_coded) where nplanes_coded is
    the number of non-zero bit-planes (max_bit+1); zero_planes =
    mb - nplanes_coded goes into the packet header tag tree.
    """

    def encode(self, coeffs: np.ndarray) -> Tuple[bytes, int, int]:
        h, w = coeffs.shape
        assert (h, w) == (self.h, self.w)
        if not native.fits(w, h):
            return self.encode_python(coeffs)
        src = np.ascontiguousarray(coeffs, np.int32)
        # the MQ coder writes fewer bytes than 4 a sample and its flush
        cap = 4 * w * h + 1024
        out = np.empty(cap, np.uint8)
        out_len = np.zeros(1, np.int64)
        np_ = np.zeros(1, np.int32)
        npl = np.zeros(1, np.int32)
        native.check(native.lib().tpuheif_j2k_t1_encode(
            src.ctypes.data, w, h, self.orient, out.ctypes.data, cap,
            out_len.ctypes.data, np_.ctypes.data, npl.ctypes.data),
            "T1 encode", decode=False)
        return out[:int(out_len[0])].tobytes(), int(np_[0]), int(npl[0])

    def encode_python(self, coeffs: np.ndarray) -> Tuple[bytes, int, int]:
        """``encode`` in Python."""
        h, w = coeffs.shape
        assert (h, w) == (self.h, self.w)
        mags = np.abs(coeffs.astype(np.int64))
        self._src_sign = np.where(coeffs < 0, -1, 1).astype(np.int8)
        self._src_mag = mags
        mx = int(mags.max()) if mags.size else 0
        nplanes = mx.bit_length()
        if nplanes == 0:
            return b"", 0, 0
        enc = MQEncoder()
        plane = nplanes - 1
        npasses = 0
        while plane >= 0:
            if npasses == 0:
                self._cleanup(enc, plane)
                npasses += 1
            else:
                self._sigprop(enc, plane)
                self._magref(enc, plane)
                self._cleanup(enc, plane)
                npasses += 3
            self.visited[:] = 0
            plane -= 1
        return enc.flush(), npasses, nplanes

    def _bit(self, x, y, plane) -> int:
        return int((self._src_mag[y, x] >> plane) & 1)

    def _become_sig(self, enc, x, y, plane):
        ctx, xbit = self.sc_ctx(x, y)
        s = 1 if self._src_sign[y, x] < 0 else 0
        enc.encode(ctx, s ^ xbit)
        self.sig[y + 1, x + 1] = 1
        self.sgn[y + 1, x + 1] = self._src_sign[y, x]

    def _sigprop(self, enc, plane):
        h, w = self.h, self.w
        sig, vis = self.sig, self.visited
        for k0, x in _stripe_iter(w, h):
            for y in range(k0, min(k0 + 4, h)):
                if sig[y + 1, x + 1]:
                    continue
                ctx = self.zc_ctx(x, y)
                if ctx == 0:
                    continue
                vis[y + 1, x + 1] = 1
                bit = self._bit(x, y, plane)
                enc.encode(ctx, bit)
                if bit:
                    self._become_sig(enc, x, y, plane)

    def _magref(self, enc, plane):
        h, w = self.h, self.w
        sig, vis = self.sig, self.visited
        for k0, x in _stripe_iter(w, h):
            for y in range(k0, min(k0 + 4, h)):
                if not sig[y + 1, x + 1] or vis[y + 1, x + 1]:
                    continue
                enc.encode(self.mr_ctx(x, y), self._bit(x, y, plane))
                self.refined[y + 1, x + 1] = 1
                vis[y + 1, x + 1] = 1

    def _cleanup(self, enc, plane):
        h, w = self.h, self.w
        sig, vis = self.sig, self.visited
        for k0, x in _stripe_iter(w, h):
            y = k0
            if (k0 + 3 < h
                    and not vis[k0 + 1:k0 + 5, x + 1].any()
                    and not sig[k0 + 1:k0 + 5, x + 1].any()
                    and self.zc_ctx(x, k0) == 0
                    and self.zc_ctx(x, k0 + 1) == 0
                    and self.zc_ctx(x, k0 + 2) == 0
                    and self.zc_ctx(x, k0 + 3) == 0):
                bits = [self._bit(x, k0 + i, plane) for i in range(4)]
                if not any(bits):
                    enc.encode(CTX_RL, 0)
                    continue
                r = bits.index(1)
                enc.encode(CTX_RL, 1)
                enc.encode(CTX_UNI, (r >> 1) & 1)
                enc.encode(CTX_UNI, r & 1)
                self._become_sig(enc, x, k0 + r, plane)
                y = k0 + r + 1
            for yy in range(y, min(k0 + 4, h)):
                if sig[yy + 1, x + 1] or vis[yy + 1, x + 1]:
                    continue
                bit = self._bit(x, yy, plane)
                enc.encode(self.zc_ctx(x, yy), bit)
                if bit:
                    self._become_sig(enc, x, yy, plane)
