"""H.264/AVC intra encoder: planes → CABAC IDR slice → annex-B/avcC.

Replaces the reference's x264/openh264 encoder plugin boundary
(reference: libheif/plugins/encoder_x264.cc). Scope: all-intra IDR
frames, CABAC entropy coding, Intra_4x4 / Intra_8x8 / Intra_16x16
mode decision (SSE-based), 8-bit 4:2:0 and monochrome.

The slice encoder subclasses the decoder's SliceDecoder so that every
context-index derivation (neighbor availability, cbf/cbp/tx8/mode
increments) and every reconstruction routine (pred_*, dequant, inverse
transforms) is byte-for-byte the same code the decoder runs — the
encoder's reconstruction loop is therefore bit-exact with any
conformant decoder by construction.

Counterpart of libheif_tpu/codecs/avc/encoder.py, without its switch:
``encode_frame`` always sends the picture to the C++ engine
(``_NativeSliceEncoder``, ``tpuheif_avc_encode_slice`` in
host/avc_native.cc through ``_build.AVC_HOST_LIBRARY``), and a failed
build, load or call raises; ``python_engine=True`` runs the Python
``SliceEncoder`` instead, the engine's reference in the tests.  A
sequence keeps the JAX choices byte for byte: its IDR goes through the
Python ``SliceEncoder`` with ``tx8_policy="never"``, its P pictures
through ``PSliceEncoder``, each reconstruction deblocked on the host
(the closed loop).  The registry encoder converts an image to YCbCr
4:2:0 on the image's device, as the HEVC encoder does, and brings the
three planes to the host in one copy (host_copy.host_planes).  The
parts are the spans ``avc.encode`` with ``.copy``, ``.native`` or
``.python``, ``.deblock`` and ``.write`` (core/trace.py).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ...boxes.codec_cfg import Box_avcC
from ...boxes.meta import Box_ispe
from ...color import convert_image
from ...core import trace
from ...core.bitstream import BitWriter
from ...core.error import HeifError, SubError
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..host_copy import host_planes
from ..registry import Encoder as RegistryEncoder, register_encoder
from . import native_decode as ND
from . import tables as T
from .deblock import deblock_frame
from .headers import SPS, PPS, SliceHeader
from .mb import (SliceDecoder, MBInfo, pred_4x4, pred_8x8, pred_16x16,
                 pred_chroma, itrans4, itrans8, ihadamard4, dequant4,
                 dequant8, clip3, I_NXN)
from ..hevc.tables import RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS
from .headers import parse_sps, parse_pps
from .tables import init_cabac_states

_RANGE = RANGE_TAB_LPS.tolist()
_LPS = TRANS_IDX_LPS.tolist()
_MPS = TRANS_IDX_MPS.tolist()


# --------------------------------------------------------------------------
# CABAC arithmetic encoder (spec 9.3.4; engine shared with HEVC M-coder)
# --------------------------------------------------------------------------

class AvcCabacEncoder:
    """Binary arithmetic encoder, contexts addressed by absolute ctxIdx."""

    def __init__(self, qp: int, is_p: bool = False,
                 cabac_init_idc: int = 0):
        self.p_state, self.val_mps = init_cabac_states(qp, is_p,
                                                       cabac_init_idc)
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self._bits: List[int] = []

    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self._bits.append(b)
        while self.bits_outstanding > 0:
            self._bits.append(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put_bit(0)
            elif self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            else:
                self.bits_outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        p_state = self.p_state[ctx_idx]
        lps = _RANGE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if binval != self.val_mps[ctx_idx]:
            self.low += self.range
            self.range = lps
            if p_state == 0:
                self.val_mps[ctx_idx] = 1 - self.val_mps[ctx_idx]
            self.p_state[ctx_idx] = _LPS[p_state]
        else:
            self.p_state[ctx_idx] = _MPS[p_state]
        self._renorm()

    def encode_bypass(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.bits_outstanding += 1
            self.low -= 512

    def encode_bypass_bits(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
        else:
            self._renorm()

    def encode_eg_bypass(self, k: int, value: int) -> None:
        """Exp-Golomb order-k suffix (spec 9.3.2.3 UEGk suffix part)."""
        leading = 0
        while value >= ((1 << leading) << k):
            value -= (1 << leading) << k
            leading += 1
        for _ in range(leading):
            self.encode_bypass(1)
        self.encode_bypass(0)
        self.encode_bypass_bits(value, leading + k)

    def flush(self) -> None:
        """EncodeFlush after the final terminate(1) (spec 9.3.4.1.2)."""
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        self._bits.append((self.low >> 8) & 1)
        self._bits.append(1)  # rbsp_stop_one_bit

    def data(self) -> bytes:
        out = bytearray()
        acc = n = 0
        for b in self._bits:
            acc = (acc << 1) | b
            n += 1
            if n == 8:
                out.append(acc)
                acc = n = 0
        if n:
            out.append(acc << (8 - n))
        return bytes(out)


# --------------------------------------------------------------------------
# forward transforms + quantization (JM / spec 8.5 inverse-mirrors)
# --------------------------------------------------------------------------

def ftrans4(b: np.ndarray) -> np.ndarray:
    """4x4 forward core transform (x264 dct4x4: [1 1 1 1; 2 1 -1 -2;
    1 -1 -1 1; 1 -2 2 -1] both directions)."""
    b = b.astype(np.int64)

    def one(d):
        s03 = d[..., 0] + d[..., 3]
        s12 = d[..., 1] + d[..., 2]
        d03 = d[..., 0] - d[..., 3]
        d12 = d[..., 1] - d[..., 2]
        return np.stack([s03 + s12, 2 * d03 + d12,
                         s03 - s12, d03 - 2 * d12], axis=-1)
    return one(one(b).swapaxes(-1, -2)).swapaxes(-1, -2)


def fhadamard4(b: np.ndarray) -> np.ndarray:
    """4x4 forward Hadamard for I16 luma DC, with >>1 (spec 8.6.1 ref)."""
    b = b.astype(np.int64)

    def one(d):
        s03 = d[..., 0] + d[..., 3]
        s12 = d[..., 1] + d[..., 2]
        d03 = d[..., 0] - d[..., 3]
        d12 = d[..., 1] - d[..., 2]
        return np.stack([s03 + s12, d03 + d12,
                         s03 - s12, d03 - d12], axis=-1)
    return one(one(b).swapaxes(-1, -2)).swapaxes(-1, -2) >> 1


def _ftrans8_1d(s):
    a = [s[..., i] for i in range(8)]
    s07 = a[0] + a[7]
    s16 = a[1] + a[6]
    s25 = a[2] + a[5]
    s34 = a[3] + a[4]
    b0 = s07 + s34
    b1 = s16 + s25
    b2 = s07 - s34
    b3 = s16 - s25
    d07 = a[0] - a[7]
    d16 = a[1] - a[6]
    d25 = a[2] - a[5]
    d34 = a[3] - a[4]
    b4 = d16 + d25 + (d07 + (d07 >> 1))
    b5 = d07 - d34 - (d25 + (d25 >> 1))
    b6 = d07 + d34 - (d16 + (d16 >> 1))
    b7 = d16 - d25 + (d34 + (d34 >> 1))
    return np.stack([b0 + b1,
                     b4 + (b7 >> 2),
                     b2 + (b3 >> 1),
                     b5 + (b6 >> 2),
                     b0 - b1,
                     b6 - (b5 >> 2),
                     (b2 >> 1) - b3,
                     (b4 >> 2) - b7], axis=-1)


def ftrans8(b: np.ndarray) -> np.ndarray:
    """8x8 forward transform (x264 dct8x8)."""
    b = b.astype(np.int64)
    f = _ftrans8_1d(b)
    return _ftrans8_1d(f.swapaxes(-1, -2)).swapaxes(-1, -2)


# quant multipliers (JM quant4_scale / quant8_scale; inverse of the
# dequant V matrices in tables.py)
_MF4 = np.array([[13107, 5243, 8066], [11916, 4660, 7490],
                 [10082, 4194, 6554], [9362, 3647, 5825],
                 [8192, 3355, 5243], [7282, 2893, 4559]], np.int64)
_MF8 = np.array([[13107, 11428, 20972, 12222, 16777, 15481],
                 [11916, 10826, 19174, 11058, 14980, 14290],
                 [10082, 8943, 15978, 9675, 12710, 11985],
                 [9362, 8228, 14913, 8931, 11984, 11259],
                 [8192, 7346, 13159, 7740, 10486, 9777],
                 [7282, 6428, 11570, 6830, 9118, 8640]], np.int64)


def _class4(i, j):
    if i % 2 == 0 and j % 2 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    return 2


def _class8(i, j):
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


MF4 = np.zeros((6, 4, 4), np.int64)
MF8 = np.zeros((6, 8, 8), np.int64)
for _m in range(6):
    for _i in range(4):
        for _j in range(4):
            MF4[_m, _i, _j] = _MF4[_m, _class4(_i, _j)]
    for _i in range(8):
        for _j in range(8):
            MF8[_m, _i, _j] = _MF8[_m, _class8(_i, _j)]


def quant4(c: np.ndarray, qp: int) -> np.ndarray:
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3  # intra rounding
    mf = MF4[qp % 6]
    lvl = (np.abs(c.astype(np.int64)) * mf + f) >> qbits
    return np.where(c < 0, -lvl, lvl).astype(np.int32)


def quant8(c: np.ndarray, qp: int) -> np.ndarray:
    qbits = 16 + qp // 6
    f = (1 << qbits) // 3
    mf = MF8[qp % 6]
    lvl = (np.abs(c.astype(np.int64)) * mf + f) >> qbits
    return np.where(c < 0, -lvl, lvl).astype(np.int32)


def quant_dc4(c: np.ndarray, qp: int) -> np.ndarray:
    """I16 luma DC quant: MF[0,0], doubled rounding, qbits+1."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf = int(MF4[qp % 6, 0, 0])
    lvl = (np.abs(c.astype(np.int64)) * mf + 2 * f) >> (qbits + 1)
    return np.where(c < 0, -lvl, lvl).astype(np.int32)


def quant_dc2(c: np.ndarray, qp: int) -> np.ndarray:
    """Chroma 2x2 DC quant."""
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf = int(MF4[qp % 6, 0, 0])
    lvl = (np.abs(c.astype(np.int64)) * mf + 2 * f) >> (qbits + 1)
    return np.where(c < 0, -lvl, lvl).astype(np.int32)


# --------------------------------------------------------------------------
# slice encoder
# --------------------------------------------------------------------------

class SliceEncoder(SliceDecoder):
    """Intra slice encoder.

    Subclasses SliceDecoder to inherit the state arrays and all context
    increment / prediction / reconstruction helpers, replacing decode
    with mode search + bin emission. self.planes is the reconstruction;
    self.src holds the source planes."""

    def __init__(self, sps: SPS, pps: PPS, src: List[np.ndarray],
                 qp: int, tx8_policy: str = "auto"):
        mbw = sps.pic_width_in_mbs
        mbh = sps.pic_height_in_map_units
        planes = [np.zeros((mbh * 16, mbw * 16), np.int32)]
        if len(src) > 1:
            planes += [np.zeros((mbh * 8, mbw * 8), np.int32),
                       np.zeros((mbh * 8, mbw * 8), np.int32)]
        super().__init__(sps, pps, planes)
        self.src = src
        self.base_qp = qp
        self.tx8_policy = tx8_policy

    # ----------------------------------------------------------- top level

    def encode_slice(self, hdr: SliceHeader) -> bytes:
        with trace.span("avc.encode.python"):
            return self._encode_slice(hdr)

    def _encode_slice(self, hdr: SliceHeader) -> bytes:
        self.first_mb = hdr.first_mb
        e = AvcCabacEncoder(hdr.qp)
        self.e = e
        self.qp = hdr.qp
        self.prev_qp_delta = 0
        n = self.mb_w * self.mb_h
        for addr in range(hdr.first_mb, n):
            self.mbx = addr % self.mb_w
            self.mby = addr // self.mb_w
            self.cur = MBInfo()
            self.mb[addr] = self.cur
            self._encode_mb()
            e.encode_terminate(1 if addr == n - 1 else 0)
        e.flush()
        return e.data()

    # ------------------------------------------------------- mode search

    def _avail_luma(self, x0: int, y0: int, blk: int) -> Tuple[bool, bool]:
        self._blk = blk
        have_top = y0 > 0 and self._sample_decoded(x0, y0 - 1)
        have_left = x0 > 0 and self._sample_decoded(x0 - 1, y0)
        return have_top, have_left

    @staticmethod
    def _modes_for(have_top: bool, have_left: bool,
                   have_tl: bool) -> List[int]:
        m = [T.I4_DC]
        if have_top:
            m += [T.I4_VERT, T.I4_DDL, T.I4_VL]
        if have_left:
            m += [T.I4_HOR, T.I4_HU]
        if have_top and have_left and have_tl:
            m += [T.I4_DDR, T.I4_VR, T.I4_HD]
        return m

    def _encode_mb(self) -> None:
        # Trial-encode candidate MB types on copies of the recon state,
        # then commit the best. State copied: recon pixels of this MB,
        # cbf/i4 arrays for this MB — cheapest is to run the search
        # without residuals (pred SSE on source) and commit one choice.
        mbx, mby = self.mbx, self.mby
        x0, y0 = mbx * 16, mby * 16
        src = self.src[0][y0:y0 + 16, x0:x0 + 16].astype(np.int64)

        # I16 candidate: best mode by pred SSE
        self._blk = 0
        top, left, tl, _, have_tl = self._luma_border(x0, y0, 16)
        best16, sse16 = None, None
        cands = [T.I16_DC]
        if top is not None:
            cands.append(T.I16_VERT)
        if left is not None:
            cands.append(T.I16_HOR)
        if top is not None and left is not None and have_tl:
            cands.append(T.I16_PLANE)
        for m in cands:
            p = pred_16x16(m, top, left, tl if have_tl else None)
            s = int(((src - p) ** 2).sum())
            if sse16 is None or s < sse16:
                best16, sse16 = m, s

        # NxN candidate SSE estimate: per-4x4 best pred vs source
        # (approximate: neighbors are recon-so-far, unreconstructed
        # in-MB neighbors fall back to source pixels for the estimate)
        sse4 = 0
        for k in range(16):
            bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            bxp, byp = x0 + bx * 4, y0 + by * 4
            sblk = self.src[0][byp:byp + 4, bxp:bxp + 4].astype(np.int64)
            ht, hl = self._avail_luma(bxp, byp, k)
            best = None
            srcpl = self.src[0]
            t = srcpl[byp - 1, bxp:bxp + 4].astype(np.int64) if ht else None
            l = srcpl[byp:byp + 4, bxp - 1].astype(np.int64) if hl else None
            for m in (T.I4_DC, T.I4_VERT, T.I4_HOR):
                if m == T.I4_VERT and t is None:
                    continue
                if m == T.I4_HOR and l is None:
                    continue
                if m == T.I4_DC:
                    if t is not None and l is not None:
                        v = (int(t.sum()) + int(l.sum()) + 4) >> 3
                    elif t is not None:
                        v = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        v = (int(l.sum()) + 2) >> 2
                    else:
                        v = 128
                    p = np.full((4, 4), v, np.int64)
                elif m == T.I4_VERT:
                    p = np.broadcast_to(t, (4, 4))
                else:
                    p = np.broadcast_to(l[:, None], (4, 4))
                s = int(((sblk - p) ** 2).sum())
                if best is None or s < best:
                    best = s
            sse4 += best
        # lambda-ish penalty: I16 costs fewer bits
        use_i16 = sse16 is not None and sse16 <= sse4 + 2048

        if use_i16:
            self._encode_i16_mb(best16)
        else:
            self._encode_nxn_mb()

    # --------------------------------------------------------------- I16

    def _encode_i16_mb(self, mode: int) -> None:
        e = self.e
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        x0, y0 = mbx * 16, mby * 16
        qp = self.qp
        src = self.src[0][y0:y0 + 16, x0:x0 + 16].astype(np.int64)
        self._blk = 0
        top, left, tl, _, have_tl = self._luma_border(x0, y0, 16)
        p = pred_16x16(mode, top, left, tl if have_tl else None)
        resid = src - p

        # forward transform all 16 4x4 blocks
        blocks = resid.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
        coef = ftrans4(blocks)                       # (4by,4bx,4,4)
        dc = coef[:, :, 0, 0]
        dcq = quant_dc4(fhadamard4(dc), qp)          # (4,4) quantized DC
        acq = quant4(coef, qp)
        acq[:, :, 0, 0] = 0

        cbp_luma = 15 if acq.any() else 0
        cur.mb_type = 0  # filled below via bin emission; semantic fields:
        cur.is_i16 = True
        cur.i16_mode = mode
        cur.cbp_luma = cbp_luma

        # chroma: decide levels first (cbp needed before mb_type bins)
        ch = self._chroma_levels() if not self.mono else None
        cur.cbp_chroma = ch[0] if ch else 0
        cur.chroma_mode = ch[1] if ch else 0
        cur.mb_type = 1 + mode + 4 * cur.cbp_chroma + \
            12 * (1 if cbp_luma else 0)

        # ---- emit mb_type: prefix 1, terminate 0, suffix
        e.encode_bin(T.CTX_MB_TYPE_I + self._mb_type_inc(), 1)
        e.encode_terminate(0)
        e.encode_bin(T.CTX_MB_TYPE_I + 3, 1 if cbp_luma else 0)
        if cur.cbp_chroma == 0:
            e.encode_bin(T.CTX_MB_TYPE_I + 4, 0)
        else:
            e.encode_bin(T.CTX_MB_TYPE_I + 4, 1)
            e.encode_bin(T.CTX_MB_TYPE_I + 5, cur.cbp_chroma - 1)
        e.encode_bin(T.CTX_MB_TYPE_I + 6, mode >> 1)
        e.encode_bin(T.CTX_MB_TYPE_I + 7, mode & 1)

        # chroma pred mode, qp_delta
        if not self.mono:
            self._emit_chroma_mode(cur.chroma_mode)
        self._emit_qp_delta(0)
        cur.qp = self.qp

        # ---- luma DC (scan order: zigzag over the 4x4 DC array)
        dc_scan = dcq.reshape(16)[T.ZIGZAG_4X4]
        dc_sig = 1 if dc_scan.any() else 0
        inc = self._cbf_inc(T.CAT_LUMA_DC, 0, 0, 0)
        e.encode_bin(T.CTX_CBF + 4 * T.CAT_LUMA_DC + inc, dc_sig)
        self.cbf_luma_dc[mby, mbx] = dc_sig
        if dc_sig:
            self._emit_residual(T.CAT_LUMA_DC, dc_scan)

        # recon DC exactly as the decoder does
        dcd = np.zeros(16, np.int32)
        dcd[T.ZIGZAG_4X4] = dc_scan
        f = ihadamard4(dcd.reshape(4, 4))
        if qp >= 36:
            dcs = (f * int(T.LEVEL_SCALE_4[qp % 6, 0, 0])) << (qp // 6 - 6)
        else:
            dcs = (f * int(T.LEVEL_SCALE_4[qp % 6, 0, 0]) +
                   (1 << (5 - qp // 6))) >> (6 - qp // 6)

        # ---- luma AC blocks
        res = np.zeros((16, 16), np.int64)
        for k in range(16):
            bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            ac_scan = acq[by, bx].reshape(16)[T.ZIGZAG_4X4][1:]
            nz = 0
            if cbp_luma:
                nz = 1 if ac_scan.any() else 0
                inc = self._cbf_inc(T.CAT_LUMA_AC, bx, by, 0)
                e.encode_bin(T.CTX_CBF + 4 * T.CAT_LUMA_AC + inc, nz)
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = nz
                if nz:
                    self._emit_residual(T.CAT_LUMA_AC, ac_scan)
            else:
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = 0
            blk = np.zeros(16, np.int32)
            if nz:
                blk[T.ZIGZAG_4X4[1:]] = ac_scan
            d4 = dequant4(blk.reshape(4, 4), qp)
            d4[0, 0] = dcs[by, bx]
            res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = itrans4(d4)
        self.planes[0][y0:y0 + 16, x0:x0 + 16] = np.clip(p + res, 0, 255)

        if not self.mono:
            self._emit_and_recon_chroma(ch)

    # --------------------------------------------------------------- NxN

    def _choose_tx8(self) -> bool:
        if not self.pps.transform_8x8_mode:
            return False
        pol = self.tx8_policy
        if pol == "never":
            return False
        if pol == "always":
            return True
        if pol == "alternate":
            return (self.mbx + self.mby) % 2 == 0
        # auto: smooth MBs (low high-frequency energy) → 8x8
        x0, y0 = self.mbx * 16, self.mby * 16
        s = self.src[0][y0:y0 + 16, x0:x0 + 16].astype(np.int64)
        gx = np.abs(np.diff(s, axis=1)).mean()
        gy = np.abs(np.diff(s, axis=0)).mean()
        return (gx + gy) < 12.0

    def _encode_nxn_mb(self) -> None:
        e = self.e
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        cur.mb_type = I_NXN
        cur.is_nxn = True
        cur.tx8 = self._choose_tx8()

        # ---- emit mb_type bin 0 + tx8 flag
        e.encode_bin(T.CTX_MB_TYPE_I + self._mb_type_inc(), 0)
        if self.pps.transform_8x8_mode:
            e.encode_bin(T.CTX_TRANSFORM_8X8 + self._tx8_inc(),
                         1 if cur.tx8 else 0)

        # ---- sequential per-block: choose mode (vs recon state), emit
        # mode bins; residuals must wait until cbp is known, so first
        # pass records (mode, coeffs, recon) per block with residual
        # quantization, then cbp is derived, then bins are ordered as
        # mode bins → chroma mode → cbp → qp_delta → residuals.
        # Bitstream order requires modes before cbp, so we do a full
        # trial reconstruction pass (writing recon + i4_modes state),
        # collecting everything, then emit.
        n_blocks = 4 if cur.tx8 else 16
        modes: List[int] = []
        coeffs_scan: List[np.ndarray] = []
        qp = self.qp
        Y = self.planes[0]
        src = self.src[0]

        for k in range(n_blocks):
            if cur.tx8:
                bx, by = (k & 1) * 2, (k >> 1) * 2
                bw = 8
            else:
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                bw = 4
            self._blk = int(T.BLK4_IDX[by, bx])
            x0 = mbx * 16 + bx * 4
            y0 = mby * 16 + by * 4
            gx, gy = mbx * 4 + bx, mby * 4 + by
            top, left, tl, tr, have_tl = self._luma_border(x0, y0, bw)
            sblk = src[y0:y0 + bw, x0:x0 + bw].astype(np.int64)
            cand = self._modes_for(top is not None, left is not None,
                                   have_tl)
            best_m, best_cost, best_p = None, None, None
            pred_mode = self._predict_i4_mode(gx, gy)
            for m in cand:
                if cur.tx8:
                    t16 = np.concatenate([top, tr]) if top is not None \
                        else None
                    p = pred_8x8(m, t16, left, tl if have_tl else None,
                                 have_tl)
                else:
                    p = pred_4x4(m, top, left, tl if have_tl else None, tr)
                cost = int(((sblk - p) ** 2).sum()) + \
                    (0 if m == pred_mode else 256)
                if best_cost is None or cost < best_cost:
                    best_m, best_cost, best_p = m, cost, p
            m = best_m
            modes.append(m)
            if cur.tx8:
                self.i4_modes[gy:gy + 2, gx:gx + 2] = m
            else:
                self.i4_modes[gy, gx] = m

            resid = sblk - best_p
            if cur.tx8:
                q = quant8(ftrans8(resid), qp)
                scan = q.reshape(64)[T.ZIGZAG_8X8]
                blk = np.zeros(64, np.int32)
                blk[T.ZIGZAG_8X8] = scan
                rec = itrans8(dequant8(blk.reshape(8, 8), qp)) \
                    if scan.any() else 0
            else:
                q = quant4(ftrans4(resid), qp)
                scan = q.reshape(16)[T.ZIGZAG_4X4]
                blk = np.zeros(16, np.int32)
                blk[T.ZIGZAG_4X4] = scan
                rec = itrans4(dequant4(blk.reshape(4, 4), qp)) \
                    if scan.any() else 0
            coeffs_scan.append(scan)
            Y[y0:y0 + bw, x0:x0 + bw] = np.clip(best_p + rec, 0, 255)

        # cbp luma
        cbp = 0
        if cur.tx8:
            for k in range(4):
                if coeffs_scan[k].any():
                    cbp |= 1 << k
        else:
            for k in range(16):
                if coeffs_scan[k].any():
                    bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                    cbp |= 1 << ((by // 2) * 2 + (bx // 2))
        cur.cbp_luma = cbp

        # cbf bookkeeping (decoder sets this during residual recon)
        for k in range(n_blocks):
            nz = 1 if coeffs_scan[k].any() else 0
            if cur.tx8:
                bx, by = (k & 1) * 2, (k >> 1) * 2
                self.cbf_luma[mby * 4 + by:mby * 4 + by + 2,
                              mbx * 4 + bx:mbx * 4 + bx + 2] = nz
            else:
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = nz

        ch = self._chroma_levels() if not self.mono else None
        cur.cbp_chroma = ch[0] if ch else 0
        cur.chroma_mode = ch[1] if ch else 0

        # ---- emit intra pred modes
        for k in range(n_blocks):
            if cur.tx8:
                bx, by = (k & 1) * 2, (k >> 1) * 2
            else:
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            gx, gy = mbx * 4 + bx, mby * 4 + by
            # NB: i4_modes already holds this MB's modes; prediction
            # must only see neighbors decoded BEFORE block k, which is
            # guaranteed by raster/z decode order (left/top blocks of k
            # are decoded before k).
            pred = self._predict_i4_mode(gx, gy)
            m = modes[k]
            if m == pred:
                e.encode_bin(T.CTX_PREV_I4X4, 1)
            else:
                e.encode_bin(T.CTX_PREV_I4X4, 0)
                rem = m if m < pred else m - 1
                e.encode_bin(T.CTX_REM_I4X4, rem & 1)
                e.encode_bin(T.CTX_REM_I4X4, (rem >> 1) & 1)
                e.encode_bin(T.CTX_REM_I4X4, (rem >> 2) & 1)

        # ---- chroma mode, cbp, qp_delta
        if not self.mono:
            self._emit_chroma_mode(cur.chroma_mode)
        emitted = 0
        for bit in range(4):
            v = (cbp >> bit) & 1
            e.encode_bin(T.CTX_CBP_LUMA + self._cbp_luma_inc(emitted, bit),
                         v)
            emitted |= v << bit
        if not self.mono:
            c = cur.cbp_chroma
            e.encode_bin(T.CTX_CBP_CHROMA + self._cbp_chroma_inc(0),
                         1 if c else 0)
            if c:
                e.encode_bin(T.CTX_CBP_CHROMA + 4 + self._cbp_chroma_inc(1),
                             c - 1)
        if cur.cbp_luma or cur.cbp_chroma:
            self._emit_qp_delta(0)
        else:
            self.prev_qp_delta = 0
        cur.qp = self.qp

        # ---- luma residuals
        for k in range(n_blocks):
            scan = coeffs_scan[k]
            if cur.tx8:
                if (cbp >> k) & 1:
                    self._emit_residual(T.CAT_LUMA_8X8, scan)
            else:
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                blk8 = (by // 2) * 2 + (bx // 2)
                if (cbp >> blk8) & 1:
                    nz = 1 if scan.any() else 0
                    inc = self._cbf_inc(T.CAT_LUMA_4X4, bx, by, 0)
                    e.encode_bin(T.CTX_CBF + 4 * T.CAT_LUMA_4X4 + inc, nz)
                    if nz:
                        self._emit_residual(T.CAT_LUMA_4X4, scan)

        if not self.mono:
            self._emit_and_recon_chroma(ch)

    # ------------------------------------------------------------ chroma

    def _chroma_levels(self):
        """Choose chroma mode + quantize. Returns (cbp_chroma, mode,
        per-plane (pred, dc_scan, ac_scans, q))."""
        mbx, mby = self.mbx, self.mby
        x0, y0 = mbx * 8, mby * 8
        # mode decision: joint SSE over both planes
        tU, lU, tlU = self._chroma_border(1, x0, y0)
        cands = [T.C_DC]
        if lU is not None:
            cands.append(T.C_HOR)
        if tU is not None:
            cands.append(T.C_VERT)
        if tU is not None and lU is not None and tlU is not None:
            cands.append(T.C_PLANE)
        best_m, best_sse = T.C_DC, None
        srcs = [self.src[pl][y0:y0 + 8, x0:x0 + 8].astype(np.int64)
                for pl in (1, 2)]
        for m in cands:
            sse = 0
            for pl in (1, 2):
                t, l, tl = self._chroma_border(pl, x0, y0)
                p = pred_chroma(m, t, l, tl)
                sse += int(((srcs[pl - 1] - p) ** 2).sum())
            if best_sse is None or sse < best_sse:
                best_m, best_sse = m, sse

        qp_y = self.qp
        per_plane = []
        any_dc = any_ac = False
        for pl in (1, 2):
            off = self.pps.chroma_qp_offset(pl - 1)
            q = int(T.CHROMA_QP[clip3(0, 51, qp_y + off)])
            t, l, tl = self._chroma_border(pl, x0, y0)
            p = pred_chroma(best_m, t, l, tl)
            resid = srcs[pl - 1] - p
            blocks = resid.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
            coef = ftrans4(blocks)                   # (2,2,4,4)
            dc = coef[:, :, 0, 0]
            # 2x2 forward hadamard
            fdc = np.array([[dc[0, 0] + dc[0, 1] + dc[1, 0] + dc[1, 1],
                             dc[0, 0] - dc[0, 1] + dc[1, 0] - dc[1, 1]],
                            [dc[0, 0] + dc[0, 1] - dc[1, 0] - dc[1, 1],
                             dc[0, 0] - dc[0, 1] - dc[1, 0] + dc[1, 1]]],
                           np.int64)
            dcq = quant_dc2(fdc, q)
            acq = quant4(coef, q)
            acq[:, :, 0, 0] = 0
            dc_scan = np.array([dcq[0, 0], dcq[0, 1], dcq[1, 0],
                                dcq[1, 1]], np.int32)
            ac_scans = [acq[k >> 1, k & 1].reshape(16)[T.ZIGZAG_4X4][1:]
                        for k in range(4)]
            if dc_scan.any():
                any_dc = True
            if any(s.any() for s in ac_scans):
                any_ac = True
            per_plane.append((p, dc_scan, ac_scans, q))
        cbp = 2 if any_ac else (1 if any_dc else 0)
        if cbp < 2:
            # AC dropped: recon uses zero AC
            per_plane = [(p, dc, [np.zeros(15, np.int32)] * 4, q)
                         for (p, dc, _, q) in per_plane]
        if cbp == 0:
            per_plane = [(p, np.zeros(4, np.int32), ac, q)
                         for (p, _, ac, q) in per_plane]
        return cbp, best_m, per_plane

    def _emit_and_recon_chroma(self, ch) -> None:
        """Emit chroma residual bins + reconstruct (mirrors decoder's
        _recon_chroma ordering: DC Cb, DC Cr, AC Cb x4, AC Cr x4)."""
        e = self.e
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        cbp, _, per_plane = ch
        x0, y0 = mbx * 8, mby * 8
        dcs_per_plane = []
        for pl in (1, 2):
            p, dc_scan, ac_scans, q = per_plane[pl - 1]
            dc_nz = 1 if dc_scan.any() else 0
            if cbp:
                inc = self._cbf_inc(T.CAT_CHROMA_DC, 0, 0, pl)
                e.encode_bin(T.CTX_CBF + 4 * T.CAT_CHROMA_DC + inc, dc_nz)
                self.cbf_chroma_dc[pl - 1, mby, mbx] = dc_nz
                if dc_nz:
                    self._emit_residual(T.CAT_CHROMA_DC, dc_scan)
            else:
                self.cbf_chroma_dc[pl - 1, mby, mbx] = 0
            c = dc_scan.reshape(2, 2).astype(np.int64)
            f = np.array([[c[0, 0] + c[0, 1] + c[1, 0] + c[1, 1],
                           c[0, 0] - c[0, 1] + c[1, 0] - c[1, 1]],
                          [c[0, 0] + c[0, 1] - c[1, 0] - c[1, 1],
                           c[0, 0] - c[0, 1] - c[1, 0] + c[1, 1]]],
                         np.int64)
            dcs_per_plane.append(
                ((f * int(T.LEVEL_SCALE_4[q % 6, 0, 0])) << (q // 6)) >> 5)
        for pl in (1, 2):
            p, dc_scan, ac_scans, q = per_plane[pl - 1]
            dcs = dcs_per_plane[pl - 1]
            res = np.zeros((8, 8), np.int64)
            for k in range(4):
                bx, by = k & 1, k >> 1
                nz = 0
                if cbp == 2:
                    nz = 1 if ac_scans[k].any() else 0
                    inc = self._cbf_inc(T.CAT_CHROMA_AC, bx, by, pl)
                    e.encode_bin(T.CTX_CBF + 4 * T.CAT_CHROMA_AC + inc, nz)
                    self.cbf_chroma[pl - 1, mby * 2 + by,
                                    mbx * 2 + bx] = nz
                    if nz:
                        self._emit_residual(T.CAT_CHROMA_AC, ac_scans[k])
                else:
                    self.cbf_chroma[pl - 1, mby * 2 + by, mbx * 2 + bx] = 0
                blk = np.zeros(16, np.int32)
                if nz:
                    blk[T.ZIGZAG_4X4[1:]] = ac_scans[k]
                d4 = dequant4(blk.reshape(4, 4), q)
                d4[0, 0] = dcs[by, bx]
                res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = itrans4(d4)
            self.planes[pl][y0:y0 + 8, x0:x0 + 8] = \
                np.clip(p + res, 0, 255)

    # ----------------------------------------------------- small emitters

    def _emit_chroma_mode(self, mode: int) -> None:
        e = self.e
        e.encode_bin(T.CTX_CHROMA_PRED + self._chroma_mode_inc(),
                     0 if mode == 0 else 1)
        if mode > 0:
            e.encode_bin(T.CTX_CHROMA_PRED + 3, 0 if mode == 1 else 1)
            if mode > 1:
                e.encode_bin(T.CTX_CHROMA_PRED + 3, mode - 2)

    def _emit_qp_delta(self, delta: int) -> None:
        e = self.e
        inc = 1 if self.prev_qp_delta != 0 else 0
        # mapped unsigned value (spec 9.3.2.7)
        val = 2 * delta - 1 if delta > 0 else -2 * delta
        if val == 0:
            e.encode_bin(T.CTX_MB_QP_DELTA + inc, 0)
        else:
            e.encode_bin(T.CTX_MB_QP_DELTA + inc, 1)
            if val == 1:
                e.encode_bin(T.CTX_MB_QP_DELTA + 2, 0)
            else:
                e.encode_bin(T.CTX_MB_QP_DELTA + 2, 1)
                for _ in range(val - 2):
                    e.encode_bin(T.CTX_MB_QP_DELTA + 3, 1)
                e.encode_bin(T.CTX_MB_QP_DELTA + 3, 0)
        self.prev_qp_delta = delta
        self.qp = (self.qp + delta + 52) % 52
        self.cur.qp_delta = delta
        self.cur.qp = self.qp

    def _emit_residual(self, cat: int, scan: np.ndarray) -> None:
        """residual_block_cabac emission (mirror of decoder
        _residual_block). scan: coefficient levels in scan order, at
        least one nonzero."""
        e = self.e
        max_coeff = len(scan)
        if cat == T.CAT_LUMA_8X8:
            sig_base = T.CTX_SIG_8X8
            last_base = T.CTX_LAST_8X8
            abs_base = T.CTX_ABS_8X8
        else:
            sig_base = T.CTX_SIG + T.SIG_CAT_OFF[cat]
            last_base = T.CTX_LAST + T.SIG_CAT_OFF[cat]
            abs_base = T.CTX_ABS + T.ABS_CAT_OFF[cat]
        sig = [i for i in range(max_coeff) if scan[i]]
        last_pos = sig[-1]
        for i in range(min(last_pos + 1, max_coeff - 1)):
            if cat == T.CAT_LUMA_8X8:
                s_inc = int(T.SIG_CTX_8X8[i])
                l_inc = int(T.LAST_CTX_8X8[i])
            elif cat == T.CAT_CHROMA_DC:
                s_inc = min(i, 2)
                l_inc = min(i, 2)
            else:
                s_inc = i
                l_inc = i
            if scan[i]:
                e.encode_bin(sig_base + s_inc, 1)
                e.encode_bin(last_base + l_inc, 1 if i == last_pos else 0)
            else:
                e.encode_bin(sig_base + s_inc, 0)
        n_eq1 = 0
        n_gt1 = 0
        for pos in reversed(sig):
            level = int(scan[pos])
            mag = abs(level)
            if n_gt1 != 0:
                inc0 = 0
            else:
                inc0 = min(4, 1 + n_eq1)
            if mag == 1:
                e.encode_bin(abs_base + inc0, 0)
                n_eq1 += 1
            else:
                e.encode_bin(abs_base + inc0, 1)
                cap = 4 - (1 if cat == T.CAT_CHROMA_DC else 0)
                inc = 5 + min(cap, n_gt1)
                v = mag - 1
                # decoder: v starts at 1, reads 1-bins while v < 14;
                # v<14 → (v-1) ones + a zero; v>=14 → 13 ones + EG0
                if v < 14:
                    for _ in range(v - 1):
                        e.encode_bin(abs_base + inc, 1)
                    e.encode_bin(abs_base + inc, 0)
                else:
                    for _ in range(13):
                        e.encode_bin(abs_base + inc, 1)
                    e.encode_eg_bypass(0, v - 14)
                n_gt1 += 1
            e.encode_bypass(1 if level < 0 else 0)




# --------------------------------------------------------------------------
# native (C) fast path — byte-identical to SliceEncoder
# --------------------------------------------------------------------------

_TX8_POLICY_ID = {"never": 0, "always": 1, "alternate": 2, "auto": 3}


class _NativeSliceEncoder:
    """Drives host/avc_native.cc tpuheif_avc_encode_slice — the
    byte-exact C++ port of SliceEncoder (same mode decisions, same bins,
    same reconstruction).  Exposes encode_slice(hdr) + .planes with the
    SliceEncoder interface that write_idr_slice/encode_frame use."""

    def __init__(self, sps: SPS, pps: PPS, src, qp: int,
                 tx8_policy: str = "auto"):
        self.sps = sps
        self.pps = pps
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.pic_height_in_map_units
        self.mono = len(src) == 1
        self.base_qp = qp
        self.tx8_policy = tx8_policy
        self.src = [np.ascontiguousarray(pl.astype(np.uint8))
                    for pl in src]
        n_mb = self.mb_w * self.mb_h
        self.mb_state = np.zeros(n_mb * 8, np.int32)
        self.mb_qp = np.zeros(n_mb, np.int32)
        self.i4_modes = np.zeros((self.mb_h * 4) * (self.mb_w * 4),
                                 np.int32)
        self.cbf_luma = np.zeros((self.mb_h * 4) * (self.mb_w * 4),
                                 np.uint8)
        self.cbf_luma_dc = np.zeros(n_mb, np.uint8)
        self.cbf_cdc = np.zeros(2 * n_mb, np.uint8)
        self.cbf_cac = np.zeros(2 * (self.mb_h * 2) * (self.mb_w * 2),
                                np.uint8)
        self.ry = np.zeros((self.mb_h * 16, self.mb_w * 16), np.uint16)
        if self.mono:
            self.rcb = np.zeros(1, np.uint16)
            self.rcr = np.zeros(1, np.uint16)
        else:
            self.rcb = np.zeros((self.mb_h * 8, self.mb_w * 8),
                                np.uint16)
            self.rcr = np.zeros((self.mb_h * 8, self.mb_w * 8),
                                np.uint16)
        self.planes = None
        # the slice's bytes cannot exceed three bytes a sample
        self.out_cap = self.mb_w * 16 * self.mb_h * 16 * 3 + 65536

    def encode_slice(self, hdr: SliceHeader) -> bytes:
        with trace.span("avc.encode.native"):
            return self._encode_slice(hdr)

    def _encode_slice(self, hdr: SliceHeader) -> bytes:
        lib = ND._lib()
        fn = lib.tpuheif_avc_encode_slice
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 26 + [ctypes.c_int64,
                                                    ctypes.c_char_p,
                                                    ctypes.c_int64]
            fn.restype = ctypes.c_int64
        tb = _enc_tables()
        ps, vm = T.init_cabac_states(hdr.qp)
        p_state = np.asarray(ps, np.uint8)
        val_mps = np.asarray(vm, np.uint8)
        params = np.array([self.mb_w, self.mb_h, int(self.mono), hdr.qp,
                           hdr.first_mb,
                           int(self.pps.transform_8x8_mode),
                           _TX8_POLICY_ID.get(self.tx8_policy, 3),
                           self.pps.chroma_qp_offset(0),
                           self.pps.chroma_qp_offset(1)], np.int64)
        cap = self.out_cap
        out = np.empty(cap, np.uint8)
        err = ctypes.create_string_buffer(256)
        mono_src = self.src[0][:1, :1] if self.mono else None
        u = self.src[1] if not self.mono else mono_src
        v = self.src[2] if not self.mono else mono_src
        arrays = (self.src[0], u, v, params, p_state, val_mps, tb.sig8,
                  tb.last8, tb.zz4, tb.zz8, tb.ls4, tb.ls8, tb.mf4, tb.mf8,
                  tb.chroma_qp, self.mb_state, self.mb_qp, self.i4_modes,
                  self.cbf_luma, self.cbf_luma_dc, self.cbf_cdc,
                  self.cbf_cac, self.ry, self.rcb, self.rcr)
        n = fn(*(a.ctypes.data for a in arrays), out.ctypes.data, cap, err,
               256)
        if n < 0:
            raise HeifError.invalid_input(
                msg="AVC native encode: " +
                err.value.decode("ascii", "replace"))
        self.planes = [self.ry.astype(np.int32)]
        if not self.mono:
            self.planes += [self.rcb.astype(np.int32),
                            self.rcr.astype(np.int32)]
        return bytes(out[:n].tobytes())

    def loop_filter(self) -> None:
        """Deblock the reconstruction in place with the decoder's C++
        in-loop filter (zero offsets, as write_idr_slice signals), over
        the per-MB state the encode left: ``planes`` becomes the picture
        a decoder shows."""
        tb = _enc_tables()
        params = np.array([self.mb_w, self.mb_h, int(self.mono), 0, 0,
                           self.pps.chroma_qp_offset(0),
                           self.pps.chroma_qp_offset(1)], np.int64)
        arrays = (params, self.mb_state, self.mb_qp, tb.alpha, tb.beta,
                  tb.tc0_col2, tb.chroma_qp, self.ry, self.rcb, self.rcr)
        ND._lib().tpuheif_avc_deblock(*(a.ctypes.data for a in arrays))
        self.planes = [p.astype(np.int32) for p in
                       ([self.ry] if self.mono
                        else [self.ry, self.rcb, self.rcr])]


def _enc_tables():
    """The decoder's flattened tables (native_decode), with the
    quantiser's multipliers added once."""
    if ND._tables is None:
        ND._tables = ND._Tables()
    tb = ND._tables
    if not hasattr(tb, "mf4"):
        tb.mf4 = ND._i32(MF4)
        tb.mf8 = ND._i32(MF8)
    return tb


# --------------------------------------------------------------------------
# parameter-set / slice-header writers
# --------------------------------------------------------------------------

def _ue(w: BitWriter, v: int) -> None:
    n = v + 1
    nbits = n.bit_length()
    w.write_bits(0, nbits - 1)
    w.write_bits(n, nbits)


def _se(w: BitWriter, v: int) -> None:
    _ue(w, 2 * v - 1 if v > 0 else -2 * v)


def _rbsp_trailing(w: BitWriter) -> None:
    w.write_bit(1)
    w.byte_align()


def add_emulation_prevention(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def write_sps(mb_w: int, mb_h: int, width: int, height: int,
              mono: bool = False, num_ref_frames: int = 0) -> bytes:
    """High-profile SPS (spec 7.3.2.1.1). Returns the full NAL."""
    w = BitWriter()
    w.write_bits(100, 8)        # profile_idc: High
    w.write_bits(0, 8)          # constraint flags + reserved
    w.write_bits(40, 8)         # level 4.0
    _ue(w, 0)                   # sps id
    _ue(w, 0 if mono else 1)    # chroma_format_idc
    _ue(w, 0)                   # bit_depth_luma_minus8
    _ue(w, 0)                   # bit_depth_chroma_minus8
    w.write_bit(0)              # qpprime_y_zero_transform_bypass
    w.write_bit(0)              # seq_scaling_matrix_present
    _ue(w, 0)                   # log2_max_frame_num_minus4
    _ue(w, 2)                   # pic_order_cnt_type = 2
    _ue(w, num_ref_frames)      # max_num_ref_frames
    w.write_bit(0)              # gaps_in_frame_num_allowed
    _ue(w, mb_w - 1)
    _ue(w, mb_h - 1)
    w.write_bit(1)              # frame_mbs_only
    w.write_bit(1)              # direct_8x8_inference
    crop_r = mb_w * 16 - width
    crop_b = mb_h * 16 - height
    if crop_r or crop_b:
        w.write_bit(1)
        cux = 1 if mono else 2
        cuy = 1 if mono else 2
        _ue(w, 0)
        _ue(w, crop_r // cux)
        _ue(w, 0)
        _ue(w, crop_b // cuy)
    else:
        w.write_bit(0)
    w.write_bit(0)              # vui_parameters_present
    _rbsp_trailing(w)
    return b"\x67" + add_emulation_prevention(w.data())


def write_pps(tx8: bool, qp: int) -> bytes:
    w = BitWriter()
    _ue(w, 0)                   # pps id
    _ue(w, 0)                   # sps id
    w.write_bit(1)              # entropy_coding_mode = CABAC
    w.write_bit(0)              # bottom_field_pic_order
    _ue(w, 0)                   # num_slice_groups_minus1
    _ue(w, 0)                   # num_ref_idx_l0_minus1
    _ue(w, 0)                   # num_ref_idx_l1_minus1
    w.write_bit(0)              # weighted_pred
    w.write_bits(0, 2)          # weighted_bipred_idc
    _se(w, qp - 26)             # pic_init_qp_minus26
    _se(w, 0)                   # pic_init_qs_minus26
    _se(w, 0)                   # chroma_qp_index_offset
    w.write_bit(1)              # deblocking_filter_control_present
    w.write_bit(0)              # constrained_intra_pred
    w.write_bit(0)              # redundant_pic_cnt_present
    w.write_bit(1 if tx8 else 0)  # transform_8x8_mode_flag
    w.write_bit(0)              # pic_scaling_matrix_present
    _se(w, 0)                   # second_chroma_qp_index_offset
    _rbsp_trailing(w)
    return b"\x68" + add_emulation_prevention(w.data())


def write_idr_slice(enc: SliceEncoder, qp: int,
                    deblock: bool = True) -> bytes:
    """IDR slice header (spec 7.3.3) + CABAC slice data → full NAL."""
    with trace.span("avc.encode.write"):
        w = BitWriter()
        _ue(w, 0)                   # first_mb_in_slice
        _ue(w, 7)                   # slice_type = I (all slices)
        _ue(w, 0)                   # pps id
        w.write_bits(0, 4)          # frame_num (log2_max_frame_num = 4)
        _ue(w, 0)                   # idr_pic_id
        # pic_order_cnt_type == 2 → no poc fields
        w.write_bit(0)              # no_output_of_prior_pics
        w.write_bit(0)              # long_term_reference
        _se(w, qp - qp)             # slice_qp_delta vs pic_init (init == qp)
        if deblock:
            _ue(w, 0)               # disable_deblocking_filter_idc = 0
            _se(w, 0)               # slice_alpha_c0_offset_div2
            _se(w, 0)               # slice_beta_offset_div2
        else:
            _ue(w, 1)
        w.byte_align(pad_bit=1)     # cabac_alignment_one_bit(s)
        hdr = SliceHeader()
        hdr.first_mb = 0
        hdr.qp = qp
    data = enc.encode_slice(hdr)
    with trace.span("avc.encode.write"):
        rbsp = w.data() + data
        return b"\x65" + add_emulation_prevention(rbsp)


# --------------------------------------------------------------------------
# frame-level API
# --------------------------------------------------------------------------

def encode_frame(y: np.ndarray, u: Optional[np.ndarray],
                 v: Optional[np.ndarray], qp: int = 26,
                 tx8: bool = True, tx8_policy: str = "auto",
                 deblock: bool = True, python_engine: bool = False):
    """Encode one 8-bit frame (numpy planes on the host) in the C++
    engine, or with ``python_engine`` in the Python ``SliceEncoder``.
    Returns (sps_nal, pps_nal, slice_nal, recon_planes): the uncropped
    reconstruction before the in-loop filter, as in the JAX package."""
    h, w = y.shape
    mono = u is None
    if not mono and (w % 2 or h % 2):
        # 4:2:0 frame cropping works in 2-sample units (spec 7.4.2.1.1)
        raise HeifError.invalid_input(
            msg="AVC 4:2:0 requires even dimensions")
    mb_w = (w + 15) // 16
    mb_h = (h + 15) // 16
    # pad to MB grid by edge replication
    def pad(pl, tw, th):
        ph, pw = pl.shape
        out = np.empty((th, tw), pl.dtype)
        out[:ph, :pw] = pl
        out[:ph, pw:] = pl[:, pw - 1:pw]
        out[ph:, :] = out[ph - 1:ph, :]
        return out
    src = [pad(y.astype(np.int32), mb_w * 16, mb_h * 16)]
    if not mono:
        src += [pad(u.astype(np.int32), mb_w * 8, mb_h * 8),
                pad(v.astype(np.int32), mb_w * 8, mb_h * 8)]

    sps_nal = write_sps(mb_w, mb_h, w, h, mono)
    pps_nal = write_pps(tx8, qp)
    sps = parse_sps(sps_nal)
    pps = parse_pps(pps_nal, {0: sps})
    pol = tx8_policy if tx8 else "never"
    if python_engine:
        enc = SliceEncoder(sps, pps, src, qp, tx8_policy=pol)
    else:
        enc = _NativeSliceEncoder(sps, pps, src, qp, tx8_policy=pol)
    slice_nal = write_idr_slice(enc, qp, deblock=deblock)
    return sps_nal, pps_nal, slice_nal, enc.planes


def encode_annexb(y, u=None, v=None, qp: int = 26, tx8: bool = True,
                  tx8_policy: str = "auto", deblock: bool = True,
                  python_engine: bool = False) -> bytes:
    sps, pps, sl, _ = encode_frame(y, u, v, qp=qp, tx8=tx8,
                                   tx8_policy=tx8_policy, deblock=deblock,
                                   python_engine=python_engine)
    sc = b"\x00\x00\x00\x01"
    return sc + sps + sc + pps + sc + sl


# --------------------------------------------------------------------------
# sequences and registry wiring (ref: heif_encoder_plugin boundary,
# encoder_x264.cc)
# --------------------------------------------------------------------------


class PSliceEncoder(SliceEncoder):
    """P slice encoder (IPPP): P_Skip / P_L0_16x16 with integer +
    quarter-pel ME against the previous reconstructed picture; mirrors
    the decoder's parse exactly (mb_skip, mb_type prefix, UEG3 mvd,
    cbp, inter residual, inter chroma)."""

    def __init__(self, sps: SPS, pps: PPS, src: List[np.ndarray],
                 qp: int, ref_planes: List[List[np.ndarray]],
                 search: int = 8):
        super().__init__(sps, pps, src, qp, tx8_policy="never")
        self.ref_planes = ref_planes
        self.num_ref_idx_l0 = 1
        self.search = search

    def _encode_slice(self, hdr: SliceHeader) -> bytes:
        self.first_mb = hdr.first_mb
        e = AvcCabacEncoder(hdr.qp, is_p=True,
                            cabac_init_idc=hdr.cabac_init_idc)
        self.e = e
        self.qp = hdr.qp
        self.prev_qp_delta = 0
        n = self.mb_w * self.mb_h
        for addr in range(hdr.first_mb, n):
            self.mbx = addr % self.mb_w
            self.mby = addr // self.mb_w
            self.cur = MBInfo()
            self.mb[addr] = self.cur
            self._encode_mb_p()
            e.encode_terminate(1 if addr == n - 1 else 0)
        e.flush()
        return e.data()

    # ------------------------------------------------------------- ME

    def _sad(self, x0, y0, mv) -> int:
        from .mb import _mc_luma
        pred = _mc_luma(self.ref_planes[0][0], x0, y0, 16, 16,
                        mv[0], mv[1])
        s = self.src[0][y0:y0 + 16, x0:x0 + 16]
        return int(np.abs(pred - s).sum())

    def _motion_search(self, x0, y0, seeds):
        tried = {}

        def ev(mv):
            if mv not in tried:
                tried[mv] = self._sad(x0, y0, mv)
            return tried[mv]

        best_mv, best = (0, 0), ev((0, 0))
        for mv in seeds:
            s = ev(mv)
            if s < best:
                best_mv, best = mv, s
        cx, cy = (best_mv[0] >> 2) << 2, (best_mv[1] >> 2) << 2
        r = self.search
        step = max(1, r // 4)
        for dy in range(-r, r + 1, step):
            for dx in range(-r, r + 1, step):
                s = ev((cx + 4 * dx, cy + 4 * dy))
                if s < best:
                    best_mv, best = (cx + 4 * dx, cy + 4 * dy), s
        bx, by = best_mv
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                s = ev((bx + dx, by + dy))
                if s < best:
                    best_mv, best = (bx + dx, by + dy), s
        return best_mv

    # ------------------------------------------------------------ MB

    def _encode_mb_p(self) -> None:
        from .mb import _mc_luma, _mc_chroma
        e = self.e
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        x0, y0 = mbx * 16, mby * 16
        gx0, gy0 = mbx * 4, mby * 4

        skip_mv = self._pskip_mv()
        mvp = self._mvp(0, 0, 16, 16, 0, 0)
        mv = self._motion_search(x0, y0, [skip_mv, mvp])

        ref = self.ref_planes[0]
        pred_y = _mc_luma(ref[0], x0, y0, 16, 16, mv[0], mv[1])
        pred_cb = _mc_chroma(ref[1], x0 // 2, y0 // 2, 8, 8, mv[0], mv[1])
        pred_cr = _mc_chroma(ref[2], x0 // 2, y0 // 2, 8, 8, mv[0], mv[1])

        qp = self.qp
        resid = self.src[0][y0:y0 + 16, x0:x0 + 16].astype(np.int64) - \
            pred_y
        blocks = resid.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
        levels = quant4(ftrans4(blocks), qp)            # (4,4,4,4)
        cbp_luma = 0
        for k8 in range(4):
            b8 = levels[(k8 >> 1) * 2:(k8 >> 1) * 2 + 2,
                        (k8 & 1) * 2:(k8 & 1) * 2 + 2]
            if b8.any():
                cbp_luma |= 1 << k8
        ch = self._chroma_levels_from_pred((pred_cb, pred_cr))
        cbp_chroma = ch[0]

        skip_inc = self._mb_skip_inc()
        if mv == skip_mv and cbp_luma == 0 and cbp_chroma == 0:
            # P_Skip
            e.encode_bin(T.CTX_MB_SKIP_P + skip_inc, 1)
            cur.is_inter = True
            cur.skipped = True
            cur.qp = self.qp
            self.prev_qp_delta = 0
            self._recon_inter_mb(pred_y, pred_cb, pred_cr, None, ch)
            self.mv[gy0:gy0 + 4, gx0:gx0 + 4] = mv
            self.ref[gy0:gy0 + 4, gx0:gx0 + 4] = 0
            self.mvd[gy0:gy0 + 4, gx0:gx0 + 4] = 0
            return

        e.encode_bin(T.CTX_MB_SKIP_P + skip_inc, 0)
        cur.is_inter = True
        cur.mb_type = -2
        # mb_type P_L0_16x16: prefix bins 0,0,0
        e.encode_bin(T.CTX_MB_TYPE_P, 0)
        e.encode_bin(T.CTX_MB_TYPE_P + 1, 0)
        e.encode_bin(T.CTX_MB_TYPE_P + 2, 0)
        mvd = (mv[0] - mvp[0], mv[1] - mvp[1])
        self._emit_mvd(0, mvd[0], gx0, gy0)
        self.mvd[gy0:gy0 + 4, gx0:gx0 + 4, 0] = mvd[0]
        self._emit_mvd(1, mvd[1], gx0, gy0)
        self.mvd[gy0:gy0 + 4, gx0:gx0 + 4, 1] = mvd[1]
        self.mv[gy0:gy0 + 4, gx0:gx0 + 4] = mv
        self.ref[gy0:gy0 + 4, gx0:gx0 + 4] = 0

        cur.cbp_luma = cbp_luma
        cur.cbp_chroma = cbp_chroma
        self._emit_cbp(cbp_luma, cbp_chroma)
        if cbp_luma or cbp_chroma:
            self._emit_qp_delta(0)
        else:
            cur.qp = self.qp
            self.prev_qp_delta = 0
        cur.qp = self.qp
        self._recon_inter_mb(pred_y, pred_cb, pred_cr,
                             levels if cbp_luma else None, ch)

    def _emit_mvd(self, comp: int, v: int, bx: int, by: int) -> None:
        """UEG3 mvd emission (mirror of the decoder's _decode_mvd)."""
        e = self.e
        base = T.CTX_MVD_X if comp == 0 else T.CTX_MVD_Y

        def amvd(x, y):
            if x < 0 or y < 0 or x >= self.mb_w * 4 or y >= self.mb_h * 4:
                return 0
            nb = self.mb_at(x // 4, y // 4)
            if nb is None or (nb is not self.cur and not nb.is_inter):
                return 0
            return abs(int(self.mvd[y, x, comp]))
        s = amvd(bx - 1, by) + amvd(bx, by - 1)
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        a = abs(v)
        if a == 0:
            e.encode_bin(base + inc, 0)
            return
        e.encode_bin(base + inc, 1)
        prefix = min(a, 9)
        for k in range(1, prefix):
            e.encode_bin(base + min(k + 2, 6), 1)
        if prefix < 9:
            e.encode_bin(base + min(prefix + 2, 6), 0)
        else:
            e.encode_eg_bypass(3, a - 9)
        e.encode_bypass(1 if v < 0 else 0)

    def _emit_cbp(self, cbp_luma: int, cbp_chroma: int) -> None:
        e = self.e
        cbp = 0
        for bit in range(4):
            b = (cbp_luma >> bit) & 1
            e.encode_bin(T.CTX_CBP_LUMA + self._cbp_luma_inc(cbp, bit), b)
            cbp |= b << bit
        if not self.mono:
            b0 = 1 if cbp_chroma else 0
            e.encode_bin(T.CTX_CBP_CHROMA + self._cbp_chroma_inc(0), b0)
            if b0:
                e.encode_bin(T.CTX_CBP_CHROMA + 4 + self._cbp_chroma_inc(1),
                             1 if cbp_chroma == 2 else 0)

    def _chroma_levels_from_pred(self, preds):
        """Inter variant of _chroma_levels: quantize the MC residual."""
        mbx, mby = self.mbx, self.mby
        x0, y0 = mbx * 8, mby * 8
        qp_y = self.qp
        per_plane = []
        any_dc = any_ac = False
        for pl in (1, 2):
            off = self.pps.chroma_qp_offset(pl - 1)
            q = int(T.CHROMA_QP[clip3(0, 51, qp_y + off)])
            p = preds[pl - 1]
            resid = self.src[pl][y0:y0 + 8, x0:x0 + 8].astype(np.int64) - p
            blocks = resid.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3)
            coef = ftrans4(blocks)
            dc = coef[:, :, 0, 0]
            fdc = np.array([[dc[0, 0] + dc[0, 1] + dc[1, 0] + dc[1, 1],
                             dc[0, 0] - dc[0, 1] + dc[1, 0] - dc[1, 1]],
                            [dc[0, 0] + dc[0, 1] - dc[1, 0] - dc[1, 1],
                             dc[0, 0] - dc[0, 1] - dc[1, 0] + dc[1, 1]]],
                           np.int64)
            dcq = quant_dc2(fdc, q)
            acq = quant4(coef, q)
            acq[:, :, 0, 0] = 0
            dc_scan = np.array([dcq[0, 0], dcq[0, 1], dcq[1, 0],
                                dcq[1, 1]], np.int32)
            ac_scans = [acq[k >> 1, k & 1].reshape(16)[T.ZIGZAG_4X4][1:]
                        for k in range(4)]
            if dc_scan.any():
                any_dc = True
            if any(s.any() for s in ac_scans):
                any_ac = True
            per_plane.append((p, dc_scan, ac_scans, q))
        cbp = 2 if any_ac else (1 if any_dc else 0)
        if cbp < 2:
            per_plane = [(p, dc, [np.zeros(15, np.int32)] * 4, q)
                         for (p, dc, _, q) in per_plane]
        if cbp == 0:
            per_plane = [(p, np.zeros(4, np.int32), ac, q)
                         for (p, _, ac, q) in per_plane]
        return cbp, 0, per_plane

    def _recon_inter_mb(self, pred_y, pred_cb, pred_cr, levels,
                        ch) -> None:
        """Emit luma residual (if coded) + chroma, closed-loop recon."""
        e = self.e
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        x0, y0 = mbx * 16, mby * 16
        qp = cur.qp
        Y = self.planes[0]
        if cur.skipped:
            Y[y0:y0 + 16, x0:x0 + 16] = pred_y
            self.planes[1][y0 // 2:y0 // 2 + 8,
                           x0 // 2:x0 // 2 + 8] = pred_cb
            self.planes[2][y0 // 2:y0 // 2 + 8,
                           x0 // 2:x0 // 2 + 8] = pred_cr
            self.cbf_luma[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
            self.cbf_luma_dc[mby, mbx] = 0
            self.cbf_chroma_dc[:, mby, mbx] = 0
            self.cbf_chroma[:, mby * 2:mby * 2 + 2,
                            mbx * 2:mbx * 2 + 2] = 0
            return
        for k in range(16):
            bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            blk8 = (by // 2) * 2 + (bx // 2)
            nz = 0
            res = 0
            if levels is not None and (cur.cbp_luma >> blk8) & 1:
                scan = levels[by, bx].reshape(16)[T.ZIGZAG_4X4]
                nz = 1 if scan.any() else 0
                inc = self._cbf_inc(T.CAT_LUMA_4X4, bx, by, 0)
                e.encode_bin(T.CTX_CBF + 4 * T.CAT_LUMA_4X4 + inc, nz)
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = nz
                if nz:
                    self._emit_residual(T.CAT_LUMA_4X4, scan)
                    blk = np.zeros(16, np.int32)
                    blk[T.ZIGZAG_4X4] = scan
                    from .mb import itrans4 as it4, dequant4 as dq4
                    res = it4(dq4(blk.reshape(4, 4), qp))
            else:
                self.cbf_luma[mby * 4 + by, mbx * 4 + bx] = 0
            px, py = x0 + bx * 4, y0 + by * 4
            Y[py:py + 4, px:px + 4] = np.clip(
                pred_y[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res,
                0, 255)
        self._emit_and_recon_chroma(ch)


def write_p_slice(enc: PSliceEncoder, qp: int, frame_num: int,
                  deblock: bool = True) -> bytes:
    """P slice header (spec 7.3.3) + CABAC slice data → full NAL
    (TRAIL, nal_ref_idc 2)."""
    with trace.span("avc.encode.write"):
        w = BitWriter()
        _ue(w, 0)                   # first_mb_in_slice
        _ue(w, 5)                   # slice_type = P (all slices)
        _ue(w, 0)                   # pps id
        w.write_bits(frame_num & 15, 4)  # frame_num
        # poc type 2 → no poc fields
        w.write_bit(0)              # num_ref_idx_active_override
        w.write_bit(0)              # ref_pic_list_modification_flag_l0
        w.write_bit(0)              # adaptive_ref_pic_marking_mode_flag
        _ue(w, 0)                   # cabac_init_idc
        _se(w, 0)                   # slice_qp_delta
        if deblock:
            _ue(w, 0)
            _se(w, 0)
            _se(w, 0)
        else:
            _ue(w, 1)
        w.byte_align(pad_bit=1)
        hdr = SliceHeader()
        hdr.first_mb = 0
        hdr.qp = qp
        hdr.slice_type = 5
        hdr.cabac_init_idc = 0
    data = enc.encode_slice(hdr)
    with trace.span("avc.encode.write"):
        rbsp = w.data() + data
        return b"\x41" + add_emulation_prevention(rbsp)  # nal_ref_idc=2, type 1


def _pad_edge(pl: np.ndarray, tw: int, th: int) -> np.ndarray:
    """``pl`` as int32, padded to ``th`` x ``tw`` by edge replication."""
    ph, pw = pl.shape
    out = np.empty((th, tw), np.int32)
    out[:ph, :pw] = pl
    out[:ph, pw:] = pl[:, pw - 1:pw]
    out[ph:, :] = out[ph - 1:ph, :]
    return out


def _ycc420_on_host(img: PixelImage) -> List[np.ndarray]:
    """The image's Y, Cb, Cr planes, converted to YCbCr 4:2:0 on the
    image's device where they are not, in one copy to the host."""
    if img.colorspace != Colorspace.YCbCr or img.chroma != Chroma.C420:
        img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                            device=next(iter(img.planes.values())).device)
    with trace.span("avc.encode.copy"):
        return host_planes([img.plane(Channel.Y), img.plane(Channel.Cb),
                            img.plane(Channel.Cr)])


def _avcC(sps_nal: bytes, pps_nal: bytes, length_size: bool) -> Box_avcC:
    cfg = Box_avcC()
    cfg.avc_profile = sps_nal[1]
    cfg.profile_compatibility = sps_nal[2]
    cfg.avc_level = sps_nal[3]
    if length_size:
        cfg.length_size = 4
    cfg.sps_list = [sps_nal]
    cfg.pps_list = [pps_nal]
    return cfg


class AvcSequenceEncodeSession:
    """IPPP avc1 track encoding (ref: encoder.h:76-89 sequence hooks):
    frame 0 is an IDR sync sample, later frames P slices referencing
    the previous reconstruction, deblocked on the host as the decoder
    will (the JAX session's choices, byte for byte).  ``ref`` holds the
    last reconstruction (uncropped int32 planes)."""

    def __init__(self, width: int, height: int, qp: int, gop: int = 32):
        self.width, self.height = width, height
        self.qp = qp
        self.gop = gop
        self.count = 0
        self.sps = None
        self.pps = None
        self.sps_nal = None
        self.pps_nal = None
        self.ref = None           # previous recon planes (uncropped)
        self.frame_num = 0

    def push_frames(self, img: PixelImage):
        """The track writer's interface: one sample a frame, in order
        (data, avcC-or-None, is_sync, composition offset 0)."""
        return [(*self.encode_frame(img), 0)]

    def flush_frames(self):
        return []

    def encode_frame(self, img: PixelImage):
        """Returns (length-prefixed sample, avcC-or-None, is_sync)."""
        with trace.span("avc.encode"):
            return self._encode_frame(img)

    def _closed_loop(self, enc) -> None:
        """The next reference: the reconstruction deblocked exactly as
        the decoder will."""
        with trace.span("avc.encode.deblock"):
            enc.last_hdr = SliceHeader()
            deblock_frame(enc)
            self.ref = [np.asarray(p, np.int32) for p in enc.planes]

    def _encode_frame(self, img: PixelImage):
        y, u, v = _ycc420_on_host(img)
        is_idr = self.count % self.gop == 0
        if is_idr:
            h, w = y.shape
            mbw, mbh = (w + 15) // 16, (h + 15) // 16
            src = [_pad_edge(y, mbw * 16, mbh * 16),
                   _pad_edge(u, mbw * 8, mbh * 8),
                   _pad_edge(v, mbw * 8, mbh * 8)]
            sps_nal = write_sps(mbw, mbh, w, h, num_ref_frames=1)
            pps_nal = write_pps(False, self.qp)
            self.sps = parse_sps(sps_nal)
            self.pps = parse_pps(pps_nal, {0: self.sps})
            self.sps_nal, self.pps_nal = sps_nal, pps_nal
            enc = SliceEncoder(self.sps, self.pps, src, self.qp,
                               tx8_policy="never")
            slice_nal = write_idr_slice(enc, self.qp)
            self._closed_loop(enc)
            self.frame_num = 1
            cfg = None
            if self.count == 0:
                cfg = _avcC(sps_nal, pps_nal, length_size=False)
            self.count += 1
            data = len(slice_nal).to_bytes(4, "big") + slice_nal
            return data, cfg, True
        # P frame
        mbw = self.sps.pic_width_in_mbs
        mbh = self.sps.pic_height_in_map_units
        src = [_pad_edge(y, mbw * 16, mbh * 16),
               _pad_edge(u, mbw * 8, mbh * 8),
               _pad_edge(v, mbw * 8, mbh * 8)]
        enc = PSliceEncoder(self.sps, self.pps, src, self.qp,
                            ref_planes=[self.ref])
        nal = write_p_slice(enc, self.qp, self.frame_num)
        self._closed_loop(enc)
        self.frame_num = (self.frame_num + 1) & 15
        self.count += 1
        data = len(nal).to_bytes(4, "big") + nal
        return data, None, False


class AvcEncoder(RegistryEncoder):
    """Registry encoder for `avc1` items and tracks (ref:
    encoder_x264.cc): quality q gives qp = 51 - q / 2, clamped to
    1..51."""

    id = "tpu-avc"
    format = "avc"
    lossy_supported = True

    def start_sequence_encode(self, width: int, height: int,
                              options=None, gop_struct: str = "ipp",
                              device=None) -> AvcSequenceEncodeSession:
        """An IPPP session; its frames are converted on their own device
        (``device`` is taken for the track writer's interface)."""
        if gop_struct not in ("ipp", "intra"):
            # The AVC sequence encoder only emits IPPP; silently
            # downgrading a requested B-frame GOP would misreport the
            # stream structure.
            raise HeifError.unsupported(
                SubError.Unsupported_parameter,
                "AVC sequence encoder supports only 'ipp'/'intra' GOPs, "
                "not %r" % (gop_struct,))
        quality = getattr(options, "quality", 50) if options else 50
        qp = max(1, min(51, 51 - quality * 50 // 100))
        return AvcSequenceEncodeSession(width, height, qp)

    def encode_single_image(self, img: PixelImage, options=None):
        with trace.span("avc.encode"):
            quality = getattr(options, "quality", 50) if options else 50
            qp = max(1, min(51, 51 - quality * 50 // 100))
            y, u, v = _ycc420_on_host(img)
            sps_nal, pps_nal, slice_nal, _ = encode_frame(y, u, v, qp=qp)
            cfg = _avcC(sps_nal, pps_nal, length_size=True)
            data = len(slice_nal).to_bytes(4, "big") + slice_nal
            return data, cfg, [(Box_ispe(img.width, img.height), False)]


def register():
    register_encoder(AvcEncoder())
