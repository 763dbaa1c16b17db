"""AV1 intra still-image encoder.

Counterpart of libheif_tpu/codecs/av1/encoder.py (``write_sequence_header``
:80, ``write_frame_header`` :108, ``TileEncoder`` :250,
``Av1IntraEncoder`` :623, ``Av1Encoder`` :674).  It replaces the
reference's aom plugin boundary (reference: libheif/plugins/
encoder_aom.cc) with a from-scratch intra encoder: lossless (DC
prediction, the Walsh-Hadamard transform) or lossy (a mode of least
prediction SSE among five, float forward DCT, uniform quantisation, the
largest transform), 4:2:0 8-bit, one tile.  The symbol side is the
decoder's own tile walk (tile.py) driven by a scripted entropy coder, so
syntax, contexts and adaptation are shared by construction; the output
equals the JAX encoder's byte for byte.

The encode runs on the host: the planes come from their device in one
copy (codecs/host_copy.py), and each transform block is reconstructed as
soon as it is parsed (host_recon.run_job), since the planner reads the
reconstructed neighbours.  ``Av1IntraEncoder.recon`` keeps that
reconstruction (int64 planes padded to a multiple of 8).  The parts are
the spans ``av1.encode`` with ``.copy`` and ``.tile`` (core/trace.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ...boxes.codec_cfg import Box_av1C
from ...boxes.meta import Box_ispe
from ...color import convert_image
from ...core import trace
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..host_copy import host_planes
from ..registry import Encoder as RegistryEncoder, register_encoder
from . import tables as T
from . import tile as TL
from .cdf import CdfContext
from .host_recon import inv_txfm2d, predict_intra, run_job
from .msac_enc import MsacEncoder
from .obu import (OBU_SEQUENCE_HEADER, _tile_log2, parse_frame_header,
                  parse_sequence_header, split_obus)


class BitWriterMSB:
    def __init__(self):
        self.bits: List[int] = []

    def f(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)

    def data(self) -> bytes:
        out = bytearray()
        acc, n = 0, 0
        for b in self.bits:
            acc = (acc << 1) | b
            n += 1
            if n == 8:
                out.append(acc)
                acc = n = 0
        if n:
            out.append(acc << (8 - n))
        return bytes(out)


def _leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _obu(obu_type: int, payload: bytes) -> bytes:
    return bytes([(obu_type << 3) | 2]) + _leb128(len(payload)) + payload


@dataclass
class Av1EncParams:
    base_q_idx: int = 0          # 0 = lossless
    tx_mode_select: bool = False
    sb128: bool = False
    lf_level: int = 0            # loop filter level for Y (both dirs)
    lf_level_u: int = 0
    lf_level_v: int = 0
    lf_sharpness: int = 0


def write_sequence_header(w: int, h: int, sb128: bool = False) -> bytes:
    b = BitWriterMSB()
    b.f(0, 3)      # seq_profile 0
    b.f(1, 1)      # still_picture
    b.f(1, 1)      # reduced_still_picture_header
    b.f(0, 5)      # seq_level_idx
    wbits, hbits = max(w - 1, 1).bit_length(), max(h - 1, 1).bit_length()
    b.f(wbits - 1, 4)
    b.f(hbits - 1, 4)
    b.f(w - 1, wbits)
    b.f(h - 1, hbits)
    b.f(1 if sb128 else 0, 1)   # use_128x128_superblock
    b.f(0, 1)      # enable_filter_intra
    b.f(1, 1)      # enable_intra_edge_filter (matches aom defaults)
    b.f(0, 1)      # enable_superres
    b.f(0, 1)      # enable_cdef
    b.f(0, 1)      # enable_restoration
    b.f(0, 1)      # high_bitdepth
    b.f(0, 1)      # monochrome
    b.f(0, 1)      # color_description_present
    b.f(1, 1)      # color_range full
    b.f(0, 2)      # chroma_sample_position
    b.f(0, 1)      # separate_uv_delta_q
    b.f(0, 1)      # film_grain_params_present
    b.f(1, 1)      # trailing bit
    return b.data()


def write_frame_header(w: int, h: int, p: Av1EncParams) -> BitWriterMSB:
    b = BitWriterMSB()
    b.f(0, 1)      # disable_cdf_update (adaptation on)
    b.f(0, 1)      # allow_screen_content_tools
    b.f(0, 1)      # render_and_frame_size_different
    # tile info: uniform 1x1 with parser-mirrored stop bits
    sb_cols = (w + 63) // 64
    sb_rows = (h + 63) // 64
    max_tile_width_sb = 4096 >> 6
    max_tile_area_sb = (4096 * 2304) >> 12
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    b.f(1, 1)      # uniform_tile_spacing
    if min_log2_cols < max_log2_cols:
        b.f(0, 1)
    min_log2_rows = max(min_log2_tiles - min_log2_cols, 0)
    if min_log2_rows < max_log2_rows:
        b.f(0, 1)
    # quantization
    b.f(p.base_q_idx, 8)
    b.f(0, 1)      # delta_q_y_dc
    b.f(0, 1)      # delta_q_u_dc
    b.f(0, 1)      # delta_q_u_ac
    b.f(0, 1)      # using_qmatrix
    b.f(0, 1)      # segmentation_enabled
    if p.base_q_idx > 0:
        b.f(0, 1)  # delta_q_present
    lossless = p.base_q_idx == 0
    if not lossless:
        b.f(p.lf_level, 6)       # loop_filter_level[0]
        b.f(p.lf_level, 6)       # loop_filter_level[1]
        if p.lf_level:
            b.f(p.lf_level_u, 6)
            b.f(p.lf_level_v, 6)
        b.f(p.lf_sharpness, 3)
        b.f(0, 1)  # loop_filter_delta_enabled
        b.f(1 if p.tx_mode_select else 0, 1)  # tx_mode
    b.f(0, 1)      # reduced_tx_set
    return b


def fwht4(block: np.ndarray) -> np.ndarray:
    """Forward 4x4 Walsh-Hadamard (vp9 heritage, without the final <<2;
    exact inverse pair of recon.iwht4's butterfly network)."""
    x = block.astype(np.int64)

    def one(v):   # over last axis: in a,b,c,d → out a,c,d,b
        a, b, c, d = (v[..., 0].copy(), v[..., 1].copy(),
                      v[..., 2].copy(), v[..., 3].copy())
        a = a + b
        d = d - c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a = a - c
        d = d + b
        return np.stack([a, c, d, b], axis=-1)

    x = one(x.T).T   # columns first
    x = one(x)       # then rows
    return x


def _fdct2d(x: np.ndarray) -> np.ndarray:
    """Orthonormal 2-D DCT-II (float, for encoder-side quantization)."""
    h, w = x.shape
    def m(n):
        M = np.zeros((n, n))
        for k in range(n):
            for i in range(n):
                M[k, i] = math.cos((2 * i + 1) * k * math.pi / (2 * n)) * \
                    (math.sqrt(1.0 / n) if k == 0 else math.sqrt(2.0 / n))
        return M
    return m(h) @ x @ m(w).T


_ITX_GAIN_CACHE = {}


def _itx_gain(w: int, h: int) -> float:
    """Measured linear gain of the integer inverse 2-D DCT at (w, h):
    fwd quantized level l reconstructs to ≈ l * dequant / gain … used
    to scale the float forward transform so level 1 ≈ one quant step."""
    key = (w, h)
    if key not in _ITX_GAIN_CACHE:
        probe = np.zeros((min(h, 32), min(w, 32)), np.int64)
        probe[0, 0] = 1024
        out = inv_txfm2d(probe, w, h, T.DCT_DCT)
        # orthonormal fdct of the impulse response recovers the gain
        g = _fdct2d(out.astype(np.float64))[0, 0] / 1024.0
        _ITX_GAIN_CACHE[key] = g
    return _ITX_GAIN_CACHE[key]


class ScriptedMsac:
    """Msac-interface shim that ENCODES a scripted symbol stream while
    the decoder code paths drive cdf selection and adaptation."""

    def __init__(self, enc: MsacEncoder, script: List[int]):
        self.enc = enc
        self.script = script
        self.idx = 0

    def _next(self) -> int:
        v = self.script[self.idx]
        self.idx += 1
        return v

    def read_symbol_n(self, icdf, n: int) -> int:
        v = self._next()
        self.enc.encode_symbol_n(icdf, n, v)
        return v

    def read_symbol(self, icdf) -> int:
        return self.read_symbol_n(icdf, len(icdf) - 1)

    def read_bool(self, icdf) -> int:
        return self.read_symbol_n(icdf, 2)

    def read_bit(self) -> int:
        v = self._next()
        self.enc.encode_bit(v)
        return v

    def read_literal(self, n: int) -> int:
        v = self._next()
        self.enc.encode_literal(v, n)
        return v

    def read_golomb(self) -> int:
        v = self._next()
        self.enc.encode_golomb(v)
        return v


class TileEncoder(TL.TileDecoder):
    """Runs the decoder's tile walk with a ScriptedMsac: the script is
    produced lazily per block from the source content, so syntax,
    contexts, and adaptation are shared with tile.py by construction."""

    def __init__(self, seq, fh, planes, src):
        super().__init__(seq, fh, planes)
        self.src = src

    def encode_tile(self, mi_col0, mi_col1, mi_row0, mi_row1) -> bytes:
        self._enc = MsacEncoder(not self.fh.disable_cdf_update)
        self.r = ScriptedMsac(self._enc, [])
        self.cdf = CdfContext(self.fh.quant.base_q_idx)
        self.mc0, self.mc1 = mi_col0, mi_col1
        self.mr0, self.mr1 = mi_row0, mi_row1
        self.above_part = np.zeros(self.mi_cols + 32, np.int32)
        self.left_part = np.zeros(self.sb_mi, np.int32)
        self.above_skip = np.zeros(self.mi_cols + 32, np.int32)
        self.left_skip = np.zeros(self.sb_mi, np.int32)
        self.above_lvl = [np.zeros(self.mi_cols + 32, np.int32)
                          for _ in range(3)]
        self.left_lvl = [np.zeros(self.sb_mi, np.int32) for _ in range(3)]
        self.above_sign = [np.zeros(self.mi_cols + 32, np.int32)
                           for _ in range(3)]
        self.left_sign = [np.zeros(self.sb_mi, np.int32) for _ in range(3)]
        for mr in range(mi_row0, mi_row1, self.sb_mi):
            self.left_part[:] = 0
            self.left_skip[:] = 0
            for p in range(3):
                self.left_lvl[p][:] = 0
                self.left_sign[p][:] = 0
            self.sb_mi_row = mr
            for mc in range(mi_col0, mi_col1, self.sb_mi):
                self.sb_mi_col = mc
                self._decode_partition(
                    mr, mc, T.BLOCK_128X128
                    if self.seq.use_128x128_superblock else T.BLOCK_64X64)
        return self._enc.done()

    # partition policy: (mr, mc, bsize) → PARTITION_*. Default: NONE,
    # except (a) blocks that extend past the padded source plane are
    # SPLIT so every transform block lies inside the frame (edge blocks
    # straddling the pad would otherwise produce shape-mismatched
    # residuals and be coded as all-zero), and (b) lossy blocks are
    # split to lossy_max_block so the largest-tx mode codes the full
    # coefficient field (TX_64X64 zeroes everything outside the low
    # 32x32 frequencies).
    lossy_max_block = 16

    def partition_policy(self, mr, mc, bsize):
        w, h = T.BLOCK_SIZES[bsize]
        src_h, src_w = self.src[0].shape
        if bsize != T.BLOCK_8X8:
            if mc * 4 + w > src_w or mr * 4 + h > src_h:
                return T.PARTITION_SPLIT
            if not self.fh.coded_lossless and \
                    max(w, h) > self.lossy_max_block:
                return T.PARTITION_SPLIT
        return T.PARTITION_NONE

    def _decode_partition(self, mr, mc, bsize):
        if mr >= self.mr1 or mc >= self.mc1:
            return super()._decode_partition(mr, mc, bsize)
        w, h = T.BLOCK_SIZES[bsize]
        mi_w, mi_h = w // 4, h // 4
        has_rows = mr + mi_h // 2 < self.mr1
        has_cols = mc + mi_w // 2 < self.mc1
        if bsize != T.BLOCK_4X4 and has_rows and has_cols:
            self.r.script.append(self.partition_policy(mr, mc, bsize))
        elif bsize != T.BLOCK_4X4 and (has_rows or has_cols):
            # edge: split bool (1 = SPLIT)
            p = self.partition_policy(mr, mc, bsize)
            self.r.script.append(1 if p == T.PARTITION_SPLIT else 0)
        return super()._decode_partition(mr, mc, bsize)

    def _decode_block(self, mr, mc, bsize):
        # plan the block's symbols: skip, y_mode, uv_mode (+ residual
        # scripts emitted lazily inside _read_coeffs via _plan_txb)
        self._plan_block(mr, mc, bsize)
        return super()._decode_block(mr, mc, bsize)

    # mode chooser hook: returns (y_mode, angle_y, uv_mode, angle_uv);
    # angles in [-3, 3], only used for directional modes
    def mode_policy(self, mr, mc, bsize):
        if self.fh.coded_lossless:
            return T.DC_PRED, 0, T.DC_PRED, 0
        # lossy: pick the luma mode with minimum prediction SSE against
        # the source (prediction uses the current recon state, exactly
        # what the decoder will see)
        w, h = T.BLOCK_SIZES[bsize]
        px, py = mc * 4, mr * 4
        tx = T.MAX_TX_SIZE_RECT[bsize]
        src = self.src[0][py:py + h, px:px + w]
        best_sse, best_mode = None, T.DC_PRED
        saved_angle = self._cur_angle
        self._cur_angle = 0
        for mode in (T.DC_PRED, T.V_PRED, T.H_PRED,
                     T.SMOOTH_PRED, T.PAETH_PRED):
            try:
                pred = self._pred_for(0, px, py, tx, mode)
            except Exception:
                continue
            if pred.shape != src.shape:
                continue
            sse = int(((src - pred) ** 2).sum())
            if best_sse is None or sse < best_sse:
                best_sse, best_mode = sse, mode
        self._cur_angle = saved_angle
        return best_mode, 0, T.DC_PRED, 0

    def _plan_block(self, mr, mc, bsize):
        # Skip: decide by checking all txbs have zero residual — requires
        # prediction, which depends on recon state; conservative check.
        w, h = T.BLOCK_SIZES[bsize]
        y_mode, ang_y, uv_mode, ang_uv = self.mode_policy(mr, mc, bsize)
        self._planned_skip = self._block_skippable(mr, mc, bsize)
        self.r.script.append(1 if self._planned_skip else 0)  # skip
        self.r.script.append(y_mode)                          # y mode
        if y_mode in T.MODE_TO_ANGLE and self._use_angle_delta(bsize):
            self.r.script.append(ang_y + 3)
        if self._has_chroma(mr, mc, bsize):
            self.r.script.append(uv_mode)                     # uv mode
            if uv_mode in T.MODE_TO_ANGLE and self._use_angle_delta(bsize):
                self.r.script.append(ang_uv + 3)
        if self.fh.tx_mode_select and not self.fh.coded_lossless and \
                not self._planned_skip and not (w <= 4 and h <= 4):
            self.r.script.append(self.tx_depth_policy(mr, mc, bsize))

    # depth of the coded tx below the block's max rect tx (0 = max)
    def tx_depth_policy(self, mr, mc, bsize):
        return 0

    def _block_skippable(self, mr, mc, bsize) -> bool:
        w, h = T.BLOCK_SIZES[bsize]
        x0, y0 = mc * 4, mr * 4
        # quick check: DC prediction of each 4x4 equals source?
        # conservative: skip only for fully flat regions matching the
        # top-left predictor — cheap approximation: compare the whole
        # block to its DC-predicted value chain is complex; only skip
        # when the source block and its outside border are uniform.
        reg = self.src[0][max(y0 - 1, 0):y0 + h, max(x0 - 1, 0):x0 + w]
        if not (reg == reg.flat[0]).all():
            return False
        cy0, cx0 = y0 // 2, x0 // 2
        for p in (1, 2):
            reg = self.src[p][max(cy0 - 1, 0):cy0 + h // 2,
                              max(cx0 - 1, 0):cx0 + w // 2]
            if not (reg == reg.flat[0]).all():
                return False
        # border values must match what DC prediction would produce
        if y0 == 0 and x0 == 0:
            return (self.src[0][0, 0] == 128 and
                    self.src[1][0, 0] == 128 and self.src[2][0, 0] == 128)
        return True

    def _read_coeffs(self, plane, px, py, tx, mode, blk_w, blk_h):
        # compute residual from prediction (current recon state), plan
        # the symbol script for this txb, then run the shared parser
        self._plan_txb(plane, px, py, tx, mode, blk_w, blk_h)
        return super()._read_coeffs(plane, px, py, tx, mode, blk_w, blk_h)

    # angle passed by the shared _transform_block path for planning
    _cur_angle = 0

    def _transform_block(self, plane, px, py, tx, mode, angle, skip,
                         mr, mc, bsize):
        # the planner reads reconstructed neighbours during the walk, so
        # the block's job runs as soon as it is parsed (what follows the
        # job in the parse only updates contexts)
        self._cur_angle = angle
        out = super()._transform_block(plane, px, py, tx, mode, angle,
                                       skip, mr, mc, bsize)
        for job in self.jobs:
            run_job(self, job)
        self.jobs.clear()
        return out

    def _plan_txb(self, plane, px, py, tx, mode, blk_w, blk_h):
        script = self.r.script
        tw, th = T.tx_w(tx), T.tx_h(tx)
        sub = 1 if plane else 0
        frame = self.planes[plane]
        if not self.fh.coded_lossless:
            return self._plan_txb_lossy(plane, px, py, tx, mode,
                                        blk_w, blk_h)
        # prediction with the same availability logic as the parser:
        # rather than duplicating it, recompute prediction by calling
        # the shared path later; here run it on the CURRENT state
        pred = self._pred_for(plane, px, py, tx, mode)
        src = self.src[plane][py:py + th, px:px + tw].astype(np.int64)
        resid = src - pred
        levels = fwht4(resid)
        # quantize for lossless: identity (dequant ×4, iwht >>2)
        coeffs = levels.flatten()
        scan = T.get_scan(tx, '2d')
        scanned = coeffs[scan]
        nz = np.nonzero(scanned)[0]
        if len(nz) == 0:
            script.append(1)          # all_zero = 1
            return
        script.append(0)              # all_zero = 0
        eob = int(nz[-1]) + 1
        # eob_pt: find group
        k = 1
        while k + 1 < len(TL._EOB_GROUP_START) and \
                TL._EOB_GROUP_START[k + 1] <= eob:
            k += 1
        script.append(k - 1)          # eob_pt symbol
        extra_bits = TL._EOB_OFFSET_BITS[k]
        if extra_bits > 0:
            rem = eob - TL._EOB_GROUP_START[k]
            script.append((rem >> (extra_bits - 1)) & 1)   # cdf-coded bit
            for b in range(1, extra_bits):
                script.append((rem >> (extra_bits - 1 - b)) & 1)
        # base/br reverse scan
        for c in range(eob - 1, -1, -1):
            level = abs(int(scanned[c]))
            if c == eob - 1:
                script.append(min(level, 3) - 1)
            else:
                script.append(min(level, 3))
            if level > 2:
                rem = level - 3
                for _ in range(4):
                    kk = min(rem, 3)
                    script.append(kk)
                    rem -= kk
                    if kk < 3:
                        break
        # signs + golomb forward
        for c in range(eob):
            v = int(scanned[c])
            if v == 0:
                continue
            script.append(1 if v < 0 else 0)
            if abs(v) > 14:
                script.append(abs(v) - 15)

    # ------------------------------------------------------ lossy path

    def coeff_policy(self, plane, px, py, tx, mode):
        """Quantized coefficient chooser for lossy encodes. Returns
        (tx_type, signed level block of shape (min(th,32), min(tw,32))).
        Default: float forward DCT of the prediction residual with
        uniform deadzone quantization (aom-compatible dequant pair)."""
        tw, th = min(T.tx_w(tx), 32), min(T.tx_h(tx), 32)
        ftw, fth = T.tx_w(tx), T.tx_h(tx)
        pred = self._pred_for(plane, px, py, tx, mode)
        src = self.src[plane][py:py + fth, px:px + ftw]
        if src.shape != pred.shape:
            return T.DCT_DCT, np.zeros((th, tw), np.int64)
        resid = (src.astype(np.float64) - pred)
        # orthonormal 2-D DCT-II, rescaled to match the integer
        # inverse's gain: inv gain ≈ sqrt(w*h) * 2^(-sh) built into the
        # quant step below via calibration constants
        f = _fdct2d(resid)
        q = self._quant_steps(plane)
        # invert the decoder's dequant chain (tile.py _dequant_itx):
        # itx input d satisfies fdct(itx(d)) = g*d with g = _itx_gain,
        # and d = level*q >> shift (av1_get_tx_scale by pixel count),
        # so level = F * 2^shift / (g * q)
        g = _itx_gain(ftw, fth)
        pels = ftw * fth
        shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
        qmat = np.full((th, tw), q[1], np.float64)
        qmat[0, 0] = q[0]
        lv = np.round(f[:th, :tw] * (1 << shift) / (g * qmat)).astype(np.int64)
        np.clip(lv, -(1 << 15), (1 << 15) - 1, out=lv)
        return T.DCT_DCT, lv

    def _quant_steps(self, plane):
        q = self.fh.quant
        if plane == 0:
            dc_d, ac_d = q.delta_q_y_dc, 0
        elif plane == 1:
            dc_d, ac_d = q.delta_q_u_dc, q.delta_q_u_ac
        else:
            dc_d, ac_d = q.delta_q_v_dc, q.delta_q_v_ac
        qidx = q.base_q_idx
        return (int(T.DC_QLOOKUP[np.clip(qidx + dc_d, 0, 255)]),
                int(T.AC_QLOOKUP[np.clip(qidx + ac_d, 0, 255)]))

    def _plan_txb_lossy(self, plane, px, py, tx, mode, blk_w, blk_h):
        script = self.r.script
        tx_type, lv = self.coeff_policy(plane, px, py, tx, mode)
        if plane != 0:
            # chroma tx type is implied by the uv mode (no symbol):
            # reuse the shared derivation so planner and reader agree
            tx_type = TL.TileDecoder._read_tx_type(self, plane, px, py,
                                                   tx, mode)
        tcls = TL._tx_class(tx_type)
        scan = T.get_scan(tx, tcls)
        scanned = lv.flatten()[scan]
        nz = np.nonzero(scanned)[0]
        if len(nz) == 0:
            script.append(1)          # all_zero
            return
        script.append(0)
        # tx_type symbol (luma, signalable sizes only — mirrors
        # _read_tx_type)
        if plane == 0:
            sqr_up_w = T.TX_SIZES[T.TX_SIZE_SQR_UP[tx]][0]
            if sqr_up_w <= 16:
                sq = T.TX_SIZES[T.TX_SIZE_SQR[tx]][0]
                if self.fh.reduced_tx_set or sq == 16:
                    tx_set = TL._EXT_TX_SET_INTRA_2
                else:
                    tx_set = TL._EXT_TX_SET_INTRA_1
                script.append(tx_set.index(tx_type))
        eob = int(nz[-1]) + 1
        k = 1
        while k + 1 < len(TL._EOB_GROUP_START) and \
                TL._EOB_GROUP_START[k + 1] <= eob:
            k += 1
        script.append(k - 1)
        extra_bits = TL._EOB_OFFSET_BITS[k]
        if extra_bits > 0:
            rem = eob - TL._EOB_GROUP_START[k]
            script.append((rem >> (extra_bits - 1)) & 1)
            for b in range(1, extra_bits):
                script.append((rem >> (extra_bits - 1 - b)) & 1)
        for c in range(eob - 1, -1, -1):
            level = abs(int(scanned[c]))
            if c == eob - 1:
                script.append(min(level, 3) - 1)
            else:
                script.append(min(level, 3))
            if level > 2:
                rem = level - 3
                for _ in range(4):
                    kk = min(rem, 3)
                    script.append(kk)
                    rem -= kk
                    if kk < 3:
                        break
        for c in range(eob):
            v = int(scanned[c])
            if v == 0:
                continue
            script.append(1 if v < 0 else 0)
            if abs(v) > 14:
                script.append(abs(v) - 15)

    def _pred_for(self, plane, px, py, tx, mode):
        """Duplicate of _transform_block's availability+prediction for
        planning (state inspected, not mutated)."""
        sub = 1 if plane else 0
        pw = (self.mi_cols * 4) >> sub
        ph = (self.mi_rows * 4) >> sub
        tw, th = T.tx_w(tx), T.tx_h(tx)
        frame = self.planes[plane]
        dec = self.block_decoded[plane]
        u_r, u_c = py // 4, px // 4
        n_w, n_h = max(tw // 4, 1), max(th // 4, 1)
        have_above = py > 0 and bool(dec[u_r, u_c + 1])
        have_left = px > 0 and bool(dec[u_r + 1, u_c])
        n_tr = 0
        if py > 0 and px + tw < pw:
            steps, cc = 0, u_c + n_w
            while steps < th and (cc * 4) < pw and dec[u_r, cc + 1]:
                steps += 4
                cc += 1
            n_tr = steps
        n_bl = 0
        if px > 0 and py + th < ph:
            steps, rr = 0, u_r + n_h
            while steps < tw and (rr * 4) < ph and dec[rr + 1, u_c]:
                steps += 4
                rr += 1
            n_bl = steps
        return predict_intra(
            frame, px, py, tw, th, mode, self._cur_angle, have_above,
            have_left, n_tr, n_bl, self.bd,
            enable_edge_filter=self.seq.enable_intra_edge_filter)


class Av1IntraEncoder:
    """Conformant AV1 still encoder (lossless or lossy intra, 1 tile).
    Lossy path: float forward transforms + uniform quantization,
    largest-tx mode."""

    def __init__(self, w: int, h: int, params: Av1EncParams):
        self.w, self.h = w, h
        self.p = params
        self.recon = None

    def encode(self, y: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor) -> bytes:
        """The OBUs (temporal delimiter, sequence header, frame) of the
        planes ``y``, ``u``, ``v`` (tensors on one device)."""
        with trace.span("av1.encode"):
            with trace.span("av1.encode.copy"):
                y, u, v = host_planes([y, u, v])
            return self._encode(y, u, v)

    def _encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> bytes:
        w, h = self.w, self.h
        seq_payload = write_sequence_header(w, h, self.p.sb128)
        seq = parse_sequence_header(seq_payload)
        fh_writer = write_frame_header(w, h, self.p)
        while len(fh_writer.bits) % 8:
            fh_writer.f(0, 1)
        fh_bytes = fh_writer.data()
        fh = parse_frame_header(fh_bytes + b"\x00" * 8, seq)

        pw = (w + 7) // 8 * 8
        ph = (h + 7) // 8 * 8
        planes = [np.zeros((ph, pw), np.int64),
                  np.zeros((ph // 2, pw // 2), np.int64),
                  np.zeros((ph // 2, pw // 2), np.int64)]

        def pad(a, tw, th):
            out = np.zeros((th, tw), np.int64)
            hh, ww = a.shape
            out[:hh, :ww] = a
            if ww < tw:
                out[:hh, ww:] = a[:, -1:]
            if hh < th:
                out[hh:, :] = out[hh - 1:hh, :]
            return out
        src = [pad(y.astype(np.int64), pw, ph),
               pad(u.astype(np.int64), pw // 2, ph // 2),
               pad(v.astype(np.int64), pw // 2, ph // 2)]
        te = TileEncoder(seq, fh, planes, src)
        with trace.span("av1.encode.tile"):
            tile = te.encode_tile(0, te.mi_cols, 0, te.mi_rows)
        self.recon = planes

        out = _obu(2, b"")
        out += _obu(1, seq_payload)
        out += _obu(6, fh_bytes + tile)
        return out


# --------------------------------------------------------------------------
# registry encoder
# --------------------------------------------------------------------------

class Av1Encoder(RegistryEncoder):
    """AVIF registry encoder (replaces the reference's aom plugin
    boundary, reference: libheif/plugins/encoder_aom.cc — quality →
    quantizer mapping at encoder_aom.cc `cq-level`)."""

    id = "tpu-av1"
    format = "av1"
    lossy_supported = True
    lossless_supported = True

    def encode_single_image(self, img: PixelImage, options=None):
        quality = getattr(options, "quality", 50) if options else 50
        lossless = bool(getattr(options, "lossless", False)) \
            or quality >= 100
        if img.colorspace != Colorspace.YCbCr or img.chroma != Chroma.C420:
            img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                                device=next(iter(img.planes.values()))
                                .device)
        base_q = 0 if lossless else max(1, min(255, (100 - quality) * 255 // 100))
        params = Av1EncParams(base_q_idx=base_q)
        y = img.plane(Channel.Y)
        u = img.plane(Channel.Cb)
        v = img.plane(Channel.Cr)
        data = Av1IntraEncoder(img.width, img.height, params).encode(y, u, v)
        cfg = Box_av1C()
        cfg.seq_profile = 0
        cfg.high_bitdepth = 0
        cfg.monochrome = 0
        cfg.chroma_subsampling_x = 1
        cfg.chroma_subsampling_y = 1
        # store the sequence-header OBU as configOBUs (ref: avif.cc
        # ImageItem_AVIF fills av1C from the first OBUs)
        for ob in split_obus(data):
            if ob.type == OBU_SEQUENCE_HEADER:
                cfg.config_obus = bytes([(OBU_SEQUENCE_HEADER << 3) | 2]) \
                    + _leb128(len(ob.payload)) + ob.payload
                break
        return data, cfg, [(Box_ispe(img.width, img.height), False)]


def register_enc():
    register_encoder(Av1Encoder())
