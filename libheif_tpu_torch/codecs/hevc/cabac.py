"""CABAC: context-variable layout and initial states (spec §9.3.2.2),
and the arithmetic decoder (ITU-T H.265 §9.3.4.3).

Counterpart of libheif_tpu/codecs/hevc/cabac.py, whole.  The initial
states seed the C++ parser (host/hevc_parse.cc) of intra pictures; the
Python decoder runs the slice parser of P and B pictures (ctu.py
SliceParser), with the inter syntax's contexts.
"""

from __future__ import annotations

from typing import Dict, List

from ...core.error import HeifError
from .tables import (RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS,
                     INIT_VALUES, init_context_state)

_RANGE = RANGE_TAB_LPS.tolist()
_LPS = TRANS_IDX_LPS.tolist()
_MPS = TRANS_IDX_MPS.tolist()


class ContextModels:
    """All context variables, addressed as base_offset + ctxInc."""

    # layout: name -> (offset, count)
    LAYOUT = {}
    TOTAL = 0

    @classmethod
    def _build_layout(cls):
        names = ["sao_merge_flag", "sao_type_idx", "split_cu_flag",
                 "cu_transquant_bypass_flag", "cu_skip_flag",
                 "pred_mode_flag", "part_mode", "prev_intra_luma_pred_flag",
                 "intra_chroma_pred_mode", "rqt_root_cbf", "merge_flag",
                 "merge_idx", "inter_pred_idc", "ref_idx", "mvp_flag",
                 "abs_mvd_greater0_flag", "abs_mvd_greater1_flag",
                 "split_transform_flag", "cbf_luma", "cbf_chroma",
                 "cu_qp_delta_abs", "transform_skip_flag",
                 "last_sig_x_prefix", "last_sig_y_prefix",
                 "coded_sub_block_flag", "sig_coeff_flag",
                 "coeff_abs_level_greater1_flag",
                 "coeff_abs_level_greater2_flag"]
        off = 0
        for n in names:
            src = n
            if n in ("last_sig_x_prefix", "last_sig_y_prefix"):
                src = "last_sig_coeff_prefix"
            rows = INIT_VALUES[src]
            count = max(len(r) for r in rows if r)
            cls.LAYOUT[n] = (off, count)
            off += count
        cls.TOTAL = off

    def __init__(self, slice_type_init: int, qp: int):
        if not ContextModels.LAYOUT:
            ContextModels._build_layout()
        self.p_state = [0] * ContextModels.TOTAL
        self.val_mps = [0] * ContextModels.TOTAL
        for name, (off, count) in ContextModels.LAYOUT.items():
            src = name
            if name in ("last_sig_x_prefix", "last_sig_y_prefix"):
                src = "last_sig_coeff_prefix"
            row = INIT_VALUES[src][slice_type_init]
            if row is None:
                continue
            for i, iv in enumerate(row):
                st, mps = init_context_state(iv, qp)
                self.p_state[off + i] = st
                self.val_mps[off + i] = mps

    def idx(self, name: str, inc: int = 0) -> int:
        off, count = ContextModels.LAYOUT[name]
        assert 0 <= inc < count, (name, inc, count)
        return off + inc

    def snapshot(self):
        return (list(self.p_state), list(self.val_mps))

    def restore(self, snap) -> None:
        self.p_state = list(snap[0])
        self.val_mps = list(snap[1])


class CabacDecoder:
    """Binary arithmetic decoder over one substream (spec §9.3.4.3)."""

    __slots__ = ("data", "pos", "end", "range", "offset", "ctx")

    def __init__(self, data: bytes, start: int, end: int,
                 ctx: ContextModels):
        self.data = data
        self.pos = start
        self.end = end
        self.ctx = ctx
        # init (§9.3.4.3.1): 9 bits
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= 510:
            raise HeifError.invalid_input(msg="CABAC init offset invalid")

    def _read_bit(self) -> int:
        # bits beyond the substream read as 0 (rbsp trailing)
        p = self.pos
        if p >> 3 >= self.end:
            self.pos += 1
            return 0
        bit = (self.data[p >> 3] >> (7 - (p & 7))) & 1
        self.pos = p + 1
        return bit

    def decode_bin(self, ctx_idx: int) -> int:
        c = self.ctx
        p_state = c.p_state[ctx_idx]
        lps = _RANGE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            # LPS path
            self.offset -= self.range
            self.range = lps
            binval = 1 - c.val_mps[ctx_idx]
            if p_state == 0:
                c.val_mps[ctx_idx] = 1 - c.val_mps[ctx_idx]
            c.p_state[ctx_idx] = _LPS[p_state]
        else:
            binval = c.val_mps[ctx_idx]
            c.p_state[ctx_idx] = _MPS[p_state]
        # renormalize
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return binval

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return 0

    # ---- binarization helpers ----

    def decode_tu_ctx(self, ctx_indices: List[int], c_max: int) -> int:
        """Truncated unary with per-bin context indices."""
        v = 0
        while v < c_max:
            idx = ctx_indices[min(v, len(ctx_indices) - 1)]
            if not self.decode_bin(idx):
                break
            v += 1
        return v

    def decode_tu_bypass(self, c_max: int) -> int:
        v = 0
        while v < c_max and self.decode_bypass():
            v += 1
        return v

    def decode_eg_bypass(self, k: int) -> int:
        """Exp-Golomb k-th order, bypass bins (§9.3.3.3)."""
        leading = 0
        while self.decode_bypass():
            leading += 1
            if leading > 32:
                raise HeifError.invalid_input(msg="EGk runaway")
        value = ((1 << leading) - 1) << k
        value += self.decode_bypass_bits(leading + k)
        return value
