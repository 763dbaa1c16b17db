"""H.264 CABAC arithmetic decoder (Rec. ITU-T H.264 §9.3).

A copy of libheif_tpu/codecs/avc/cabac.py, unchanged but for this line.

The binary arithmetic engine (range subdivision, LPS table,
state-transition tables, bypass, terminate) is byte-for-byte the same
M-coder that H.265 inherited, so the range/transition tables are shared
with the HEVC core (codecs/hevc/tables.py, validated bit-exact against
libde265). Only context initialization differs: H.264 derives initial
states from per-context (m, n) pairs (spec 9.3.1.1), extracted from the
system libavcodec by tools/extract_avc_tables.py.
"""

from __future__ import annotations

from typing import List

from ...core.error import HeifError
from ..hevc.tables import RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS
from .tables import init_cabac_states

_RANGE = RANGE_TAB_LPS.tolist()
_LPS = TRANS_IDX_LPS.tolist()
_MPS = TRANS_IDX_MPS.tolist()


class AvcCabacDecoder:
    """Binary arithmetic decoder over one slice's data (spec 9.3.3.2).

    Contexts are addressed by absolute ctxIdx (0..1023, Table 9-34)."""

    __slots__ = ("data", "pos", "end", "range", "offset",
                 "p_state", "val_mps")

    def __init__(self, data: bytes, start_byte: int, qp: int,
                 is_p: bool = False, cabac_init_idc: int = 0):
        self.data = data
        self.pos = start_byte * 8
        self.end = len(data)
        self.p_state, self.val_mps = init_cabac_states(qp, is_p,
                                                       cabac_init_idc)
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= 510:
            raise HeifError.invalid_input(msg="CABAC init offset invalid")

    def _read_bit(self) -> int:
        p = self.pos
        if p >> 3 >= self.end:
            self.pos += 1
            return 0
        bit = (self.data[p >> 3] >> (7 - (p & 7))) & 1
        self.pos = p + 1
        return bit

    def decode_bin(self, ctx_idx: int) -> int:
        p_state = self.p_state[ctx_idx]
        lps = _RANGE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            self.offset -= self.range
            self.range = lps
            bin_val = 1 - self.val_mps[ctx_idx]
            if p_state == 0:
                self.val_mps[ctx_idx] = 1 - self.val_mps[ctx_idx]
            self.p_state[ctx_idx] = _LPS[p_state]
        else:
            bin_val = self.val_mps[ctx_idx]
            self.p_state[ctx_idx] = _MPS[p_state]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bit()
        return bin_val

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

    # unary / UEGk helpers -------------------------------------------------

    def decode_unary_ctx(self, ctx_indices: List[int], c_max: int) -> int:
        """Truncated unary with per-bin ctx list (last entry reused)."""
        v = 0
        while v < c_max:
            idx = ctx_indices[min(v, len(ctx_indices) - 1)]
            if self.decode_bin(idx) == 0:
                break
            v += 1
        return v

    def decode_eg_bypass(self, k: int) -> int:
        """Exp-Golomb order-k suffix, bypass coded (spec 9.3.2.3)."""
        v = 0
        while self.decode_bypass():
            v += 1 << k
            k += 1
            if k > 30:
                raise HeifError.invalid_input(msg="EGk runaway")
        if k:
            v += self.decode_bypass_bits(k)
        return v
