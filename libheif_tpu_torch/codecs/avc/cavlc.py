"""H.264 CAVLC entropy decoding (spec 9.1/9.2), baseline-profile slices.

A copy of libheif_tpu/codecs/avc/cavlc.py, unchanged but for this line.

Every baseline-profile H.264 stream is CAVLC; the reference decodes
them via openh264 (reference: libheif/plugins/decoder_openh264.cc:477).
CavlcSliceDecoder subclasses the CABAC SliceDecoder: prediction,
reconstruction and in-loop filtering are shared, only the entropy reads
(Exp-Golomb syntax + the table 9-5..9-10 VLCs) are replaced.  The VLC
tables are spec constants extracted from the system libavcodec by
tools/extract_avc_tables.py and pinned by the libavcodec difftests.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core.error import HeifError, SubError
from . import tables as T
from .mb import SliceDecoder, MBInfo, I_NXN, I_PCM

# ------------------------------------------------------------------ tables

_VLC_CACHE: Optional[dict] = None


def _build_vlc(lens: np.ndarray, bits: np.ndarray, values) -> Dict[
        Tuple[int, int], object]:
    out = {}
    for ln, b, v in zip(lens.tolist(), bits.tolist(), values):
        if ln > 0:
            out[(ln, b)] = v
    return out


def _tables() -> dict:
    global _VLC_CACHE
    if _VLC_CACHE is not None:
        return _VLC_CACHE
    z = T._NPZ
    t = {}
    ctl = z["cavlc_coeff_token_len"].reshape(4, 68)
    ctb = z["cavlc_coeff_token_bits"].reshape(4, 68)
    t["coeff_token"] = []
    for nc in range(4):
        vals = []
        lens = []
        bits = []
        for tc in range(17):
            for t1 in range(4):
                lens.append(ctl[nc, 4 * tc + t1])
                bits.append(ctb[nc, 4 * tc + t1])
                vals.append((tc, t1))
        t["coeff_token"].append(_build_vlc(np.asarray(lens),
                                           np.asarray(bits), vals))
    cdl = z["cavlc_cdc_token_len"].reshape(5, 4)
    cdb = z["cavlc_cdc_token_bits"].reshape(5, 4)
    vals = []
    lens = []
    bits = []
    for tc in range(5):
        for t1 in range(4):
            lens.append(cdl[tc, t1])
            bits.append(cdb[tc, t1])
            vals.append((tc, t1))
    t["cdc_token"] = _build_vlc(np.asarray(lens), np.asarray(bits), vals)
    tzl = z["cavlc_total_zeros_len"].reshape(16, 16)
    tzb = z["cavlc_total_zeros_bits"].reshape(16, 16)
    t["total_zeros"] = [
        _build_vlc(tzl[i], tzb[i], list(range(16))) for i in range(16)]
    czl = z["cavlc_cdc_tz_len"].reshape(3, 4)
    czb = z["cavlc_cdc_tz_bits"].reshape(3, 4)
    t["cdc_tz"] = [
        _build_vlc(czl[i], czb[i], list(range(4))) for i in range(3)]
    rl = z["cavlc_run_len"].reshape(7, 16)
    rb = z["cavlc_run_bits"].reshape(7, 16)
    t["run"] = [_build_vlc(rl[i], rb[i], list(range(16)))
                for i in range(7)]
    t["cbp_intra"] = z["cavlc_cbp_intra"].astype(np.int32)
    t["cbp_inter"] = z["cavlc_cbp_inter"].astype(np.int32)
    _VLC_CACHE = t
    return t


# ------------------------------------------------------------------ reader

class CavlcReader:
    """MSB-first bit reader over an RBSP with Exp-Golomb + VLC reads."""

    def __init__(self, rbsp: bytes, start_bits: int):
        self.data = rbsp
        self.pos = start_bits
        # last RBSP bit before the rbsp_stop_one_bit: locate the final
        # 1 bit of the payload (spec 7.4.1 more_rbsp_data)
        stop = -1
        for i in range(len(rbsp) - 1, -1, -1):
            b = rbsp[i]
            if b:
                for k in range(8):
                    if (b >> k) & 1:
                        stop = i * 8 + (7 - k)
                        break
                break
        self.stop_bit = stop          # bit index of the stop bit

    def more_rbsp_data(self) -> bool:
        return 0 <= self.pos < self.stop_bit

    def u(self, n: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        for _ in range(n):
            byte = data[pos >> 3] if (pos >> 3) < len(data) else 0
            v = (v << 1) | ((byte >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return v

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise HeifError.invalid_input(msg="ue(v) runaway")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def te(self, max_val: int) -> int:
        if max_val == 1:
            return 1 - self.u(1)
        return self.ue()

    def vlc(self, table: Dict[Tuple[int, int], object]):
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | self.u(1)
            v = table.get((ln, code))
            if v is not None:
                return v
        raise HeifError.invalid_input(msg="invalid CAVLC code")

    def level_prefix(self) -> int:
        n = 0
        while self.u(1) == 0:
            n += 1
            if n > 32:
                raise HeifError.invalid_input(msg="level_prefix runaway")
        return n

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def residual_cavlc(r: CavlcReader, nc: int, max_coeff: int) -> np.ndarray:
    """residual_block_cavlc (spec 7.3.5.3.2 / 9.2) → levels in scan
    order, plus total_coeff via .total_coeff attribute convention: the
    caller reads the returned array and the tc from _last_tc."""
    t = _tables()
    if nc == -1:
        tc, t1 = r.vlc(t["cdc_token"])
    else:
        if nc < 2:
            idx = 0
        elif nc < 4:
            idx = 1
        elif nc < 8:
            idx = 2
        else:
            idx = 3
        tc, t1 = r.vlc(t["coeff_token"][idx])
    out = np.zeros(max_coeff, np.int32)
    residual_cavlc.last_tc = tc
    if tc == 0:
        return out
    # ---- levels (spec 9.2.2.1)
    suffix_len = 1 if (tc > 10 and t1 < 3) else 0
    levels = []
    for i in range(tc):
        if i < t1:
            levels.append(-1 if r.u(1) else 1)
            continue
        prefix = r.level_prefix()
        if suffix_len == 0 and prefix == 14:
            suffix_size = 4
        elif prefix >= 15:
            suffix_size = prefix - 3
        else:
            suffix_size = suffix_len
        level_code = min(15, prefix) << suffix_len
        if suffix_size:
            level_code += r.u(suffix_size)
        if prefix >= 15 and suffix_len == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if i == t1 and t1 < 3:
            level_code += 2
        if level_code % 2 == 0:
            lv = (level_code + 2) >> 1
        else:
            lv = -((level_code + 1) >> 1)
        levels.append(lv)
        if suffix_len == 0:
            suffix_len = 1
        if abs(lv) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # ---- total_zeros (spec 9.2.3)
    if tc < max_coeff:
        if nc == -1:
            tz = r.vlc(t["cdc_tz"][tc - 1])
        else:
            tz = r.vlc(t["total_zeros"][tc - 1])
    else:
        tz = 0
    # ---- run_before + placement (spec 9.2.4)
    zeros_left = tz
    pos = tc - 1 + tz
    for i in range(tc):
        if i == tc - 1:
            run = zeros_left
        elif zeros_left > 0:
            run = r.vlc(t["run"][min(zeros_left, 7) - 1])
            zeros_left -= run
        else:
            run = 0
        out[pos] = levels[i]
        pos -= 1 + run
    return out


# ----------------------------------------------------------------- decoder

class CavlcSliceDecoder(SliceDecoder):
    """CAVLC front end over the shared prediction/recon engine."""

    def __init__(self, sps, pps, planes, ref_planes=None):
        super().__init__(sps, pps, planes, ref_planes=ref_planes)
        # per-4x4 total_coeff maps for nC prediction (spec 9.2.1)
        self.tc_luma = np.zeros((self.mb_h * 4, self.mb_w * 4), np.int16)
        self.tc_chroma = np.zeros((2, self.mb_h * 2, self.mb_w * 2),
                                  np.int16)

    # ------------------------------------------------------ slice decode

    def decode_slice(self, hdr, rbsp: bytes) -> None:
        self.first_mb = hdr.first_mb
        is_p = hdr.is_p
        if is_p and not self.ref_planes:
            raise HeifError.invalid_input(
                msg="P slice without reference pictures")
        r = CavlcReader(rbsp, hdr.header_bits)
        self.r = r
        self.d = None     # shared paths bind `d = self.d` but only the
        # entropy hooks (overridden here) actually read it
        self.qp = hdr.qp
        self.prev_qp_delta = 0
        addr = hdr.first_mb
        n = self.mb_w * self.mb_h
        more = r.more_rbsp_data()
        while addr < n and more:
            if is_p:
                run = r.ue()
                if run > n - addr:
                    raise HeifError.invalid_input(msg="mb_skip_run")
                for _ in range(run):
                    self._skip_mb(addr)
                    addr += 1
                more = r.more_rbsp_data()
                if not more or addr >= n:
                    break
            self.mbx = addr % self.mb_w
            self.mby = addr // self.mb_w
            self.cur = MBInfo()
            self.mb[addr] = self.cur
            if is_p:
                self._cavlc_mb_p()
            else:
                self._cavlc_mb_i()
            addr += 1
            more = r.more_rbsp_data()
        self.last_hdr = hdr

    def _skip_mb(self, addr: int) -> None:
        self.mbx = addr % self.mb_w
        self.mby = addr // self.mb_w
        cur = MBInfo()
        cur.is_inter = True
        cur.skipped = True
        cur.qp = self.qp
        self.cur = cur
        self.mb[addr] = cur
        self.prev_qp_delta = 0
        mv = self._pskip_mv()
        self._recon_inter(mv, (0, 0, 0))
        self._set_motion(mv, mvd=(0, 0))

    # ------------------------------------------------------- I slice MBs

    def _intra_mb(self, t: int) -> None:
        """Intra MB with mb_type value t (0 I_NxN, 1..24 I_16x16,
        25 PCM; spec table 7-11)."""
        cur = self.cur
        if t == 0:
            cur.mb_type = I_NXN
            cur.is_nxn = True
            self._cavlc_i_nxn()
        elif t == 25:
            cur.mb_type = I_PCM
            cur.is_pcm = True
            self._cavlc_pcm()
        elif t <= 24:
            m = t - 1
            mode = m % 4
            chroma = (m // 4) % 3
            luma_flag = m // 12
            cur.mb_type = t
            cur.is_i16 = True
            cur.i16_mode = mode
            cur.cbp_luma = 15 if luma_flag else 0
            cur.cbp_chroma = chroma
            cur.chroma_mode = 0 if self.mono else self._read_chroma_mode()
            self._decode_qp_delta()
            self._recon_i16()
        else:
            raise HeifError.invalid_input(msg=f"mb_type {t}")

    def _cavlc_mb_i(self) -> None:
        self._intra_mb(self.r.ue())

    def _cavlc_i_nxn(self) -> None:
        r = self.r
        cur = self.cur
        mbx, mby = self.mbx, self.mby
        if self.pps.transform_8x8_mode:
            cur.tx8 = r.flag()
        n_blocks = 4 if cur.tx8 else 16
        modes = []
        for k in range(n_blocks):
            if cur.tx8:
                bx, by = (k & 1) * 2, (k >> 1) * 2
            else:
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
            gx, gy = mbx * 4 + bx, mby * 4 + by
            pred = self._predict_i4_mode(gx, gy)
            if r.flag():
                mode = pred
            else:
                rem = r.u(3)
                mode = rem if rem < pred else rem + 1
            modes.append(mode)
            if cur.tx8:
                self.i4_modes[gy:gy + 2, gx:gx + 2] = mode
            else:
                self.i4_modes[gy, gx] = mode
        cur.chroma_mode = 0 if self.mono else self._read_chroma_mode()
        cur.cbp_luma, cur.cbp_chroma = self._decode_cbp()
        if cur.cbp_luma or cur.cbp_chroma:
            self._decode_qp_delta()
        else:
            cur.qp = self.qp
            self.prev_qp_delta = 0
        self._recon_i_nxn(modes)

    def _read_chroma_mode(self) -> int:
        m = self.r.ue()
        if m > 3:
            raise HeifError.invalid_input(msg="intra_chroma_pred_mode")
        return m

    def _cavlc_pcm(self) -> None:
        r = self.r
        r.byte_align()
        bd_y = self.sps.bit_depth_luma
        x0, y0 = self.mbx * 16, self.mby * 16
        Y = self.planes[0]
        for i in range(16):
            for j in range(16):
                Y[y0 + i, x0 + j] = r.u(bd_y)
        if not self.mono:
            bd_c = self.sps.bit_depth_chroma
            for pl in (1, 2):
                C = self.planes[pl]
                for i in range(8):
                    for j in range(8):
                        C[y0 // 2 + i, x0 // 2 + j] = r.u(bd_c)
        cur = self.cur
        cur.qp = self.qp
        self.prev_qp_delta = 0
        cur.cbp_luma = 15
        cur.cbp_chroma = 2
        # PCM blocks count as 16 coefficients for nC (spec 9.2.1)
        gx, gy = self.mbx * 4, self.mby * 4
        self.tc_luma[gy:gy + 4, gx:gx + 4] = 16
        self.tc_chroma[:, self.mby * 2:self.mby * 2 + 2,
                       self.mbx * 2:self.mbx * 2 + 2] = 16
        self.i4_modes[gy:gy + 4, gx:gx + 4] = -1

    # ------------------------------------------------------- P slice MBs

    def _cavlc_mb_p(self) -> None:
        r = self.r
        cur = self.cur
        t = r.ue()
        if t >= 5:
            self._intra_mb(t - 5)
            return
        cur.is_inter = True
        cur.mb_type = -2 - min(t, 3)
        num_ref = getattr(self, "num_ref_idx_l0", 1)
        gx0, gy0 = self.mbx * 4, self.mby * 4
        self.blk_done[gy0:gy0 + 4, gx0:gx0 + 4] = 0
        if t == 0:
            ref_parts = [(0, 0, 16, 16)]
            mv_parts = [[(0, 0, 16, 16)]]
        elif t == 1:
            ref_parts = [(0, 0, 16, 8), (0, 8, 16, 8)]
            mv_parts = [[p] for p in ref_parts]
        elif t == 2:
            ref_parts = [(0, 0, 8, 16), (8, 0, 8, 16)]
            mv_parts = [[p] for p in ref_parts]
        else:
            # P_8x8 (t=3) / P_8x8ref0 (t=4): sub_mb_type ue per 8x8
            ref_parts = [(0, 0, 8, 8), (8, 0, 8, 8),
                         (0, 8, 8, 8), (8, 8, 8, 8)]
            mv_parts = []
            for (sx, sy, _, _) in ref_parts:
                st = r.ue()
                if st == 0:
                    subs = [(sx, sy, 8, 8)]
                elif st == 1:
                    subs = [(sx, sy, 8, 4), (sx, sy + 4, 8, 4)]
                elif st == 2:
                    subs = [(sx, sy, 4, 8), (sx + 4, sy, 4, 8)]
                elif st == 3:
                    subs = [(sx, sy, 4, 4), (sx + 4, sy, 4, 4),
                            (sx, sy + 4, 4, 4), (sx + 4, sy + 4, 4, 4)]
                else:
                    raise HeifError.invalid_input(msg="sub_mb_type")
                mv_parts.append(subs)
        self._inter_mb_body(min(t, 3), ref_parts, mv_parts, num_ref,
                            ref0_forced=(t == 4))

    # -------------------------------------------------- entropy overrides

    def _read_tx8_flag(self) -> bool:
        return self.r.flag()

    def _decode_ref_idx(self, bx: int, by: int) -> int:
        num_ref = getattr(self, "num_ref_idx_l0", 1)
        return self.r.te(num_ref - 1)

    def _decode_mvd(self, comp: int, bx: int, by: int) -> int:
        return self.r.se()

    def _decode_cbp(self):
        code = self.r.ue()
        t = _tables()
        tab = t["cbp_inter"] if self.cur.is_inter else t["cbp_intra"]
        if code >= len(tab):
            raise HeifError.invalid_input(msg="coded_block_pattern")
        cbp = int(tab[code])
        return cbp & 15, cbp >> 4

    def _decode_qp_delta(self) -> None:
        delta = self.r.se()
        if not -27 <= delta <= 26:
            raise HeifError.invalid_input(msg="mb_qp_delta out of range")
        self.prev_qp_delta = delta
        self.qp = (self.qp + delta + 52) % 52
        self.cur.qp_delta = delta
        self.cur.qp = self.qp

    # nC derivation -----------------------------------------------------

    def _nc_luma(self, gx: int, gy: int) -> int:
        na = self._tc_luma_at(gx - 1, gy)
        nb = self._tc_luma_at(gx, gy - 1)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def _tc_luma_at(self, gx: int, gy: int) -> Optional[int]:
        if gx < 0 or gy < 0 or gx >= self.mb_w * 4 or gy >= self.mb_h * 4:
            return None
        if self.mb_at(gx // 4, gy // 4) is None:
            return None
        return int(self.tc_luma[gy, gx])

    def _nc_chroma(self, gx: int, gy: int, pl: int) -> int:
        na = self._tc_chroma_at(gx - 1, gy, pl)
        nb = self._tc_chroma_at(gx, gy - 1, pl)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def _tc_chroma_at(self, gx: int, gy: int, pl: int) -> Optional[int]:
        if gx < 0 or gy < 0 or gx >= self.mb_w * 2 or gy >= self.mb_h * 2:
            return None
        if self.mb_at(gx // 2, gy // 2) is None:
            return None
        return int(self.tc_chroma[pl - 1, gy, gx])

    # residual hooks ----------------------------------------------------

    def _cbf(self, cat: int, blk_x: int, blk_y: int, plane: int) -> int:
        # CAVLC has no coded_block_flag; the shared recon's outer CBP
        # gates are the only gating.  Record the position for nC.
        self._res_pos = (blk_x, blk_y, plane)
        return 1

    def _residual_block(self, cat: int, max_coeff: int) -> np.ndarray:
        r = self.r
        mbx, mby = self.mbx, self.mby
        if cat == T.CAT_LUMA_8X8:
            # CAVLC 8x8: four interleaved 4x4 scans (spec 8.5.6 /
            # 7.3.5.3.2 residual_luma), each with its own nC
            bx8, by8 = self._blk8_pos
            out = np.zeros(64, np.int32)
            blk8 = (by8 // 2) * 2 + (bx8 // 2)
            for i4 in range(4):
                k = blk8 * 4 + i4
                bx, by = int(T.BLK4_X[k]), int(T.BLK4_Y[k])
                gx, gy = mbx * 4 + bx, mby * 4 + by
                coeffs = residual_cavlc(r, self._nc_luma(gx, gy), 16)
                self.tc_luma[gy, gx] = residual_cavlc.last_tc
                out[i4::4] = coeffs
            return out
        if cat in (T.CAT_LUMA_4X4, T.CAT_LUMA_AC):
            bx, by, _pl = self._res_pos
            gx, gy = mbx * 4 + bx, mby * 4 + by
            coeffs = residual_cavlc(r, self._nc_luma(gx, gy), max_coeff)
            self.tc_luma[gy, gx] = residual_cavlc.last_tc
            return coeffs
        if cat == T.CAT_LUMA_DC:
            # Intra16x16DCLevel: nC from the blkIdx-0 luma neighbors
            gx, gy = mbx * 4, mby * 4
            return residual_cavlc(r, self._nc_luma(gx, gy), max_coeff)
        if cat == T.CAT_CHROMA_DC:
            return residual_cavlc(r, -1, max_coeff)
        # CAT_CHROMA_AC
        bx, by, pl = self._res_pos
        gx, gy = mbx * 2 + bx, mby * 2 + by
        coeffs = residual_cavlc(r, self._nc_chroma(gx, gy, pl), max_coeff)
        self.tc_chroma[pl - 1, gy, gx] = residual_cavlc.last_tc
        return coeffs
