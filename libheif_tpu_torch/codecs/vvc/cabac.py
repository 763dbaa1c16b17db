"""VVC CABAC arithmetic decoder (H.266 §9.3.4.3).

Two-probability-state model: each context keeps a fast-adapting 10-bit
estimate (pStateIdx0) and a slow-adapting 14-bit estimate (pStateIdx1);
the LPS subrange is computed from their 15-bit combination.  Unlike
HEVC there is no 64-state FSM/transition table — adaptation is a
windowed exponential decay with per-context window sizes (shiftIdx).

Host-side entropy decode (inherently serial — SURVEY.md §7 hard
part (a)); transforms/prediction downstream run vectorized.

The port's copy of libheif_tpu/codecs/vvc/cabac.py.
"""

from __future__ import annotations

from typing import List

from ...core.error import HeifError
from .tables import CONTEXTS, ctx_layout, TOTAL_CONTEXTS


def _clip3(lo: int, hi: int, v: int) -> int:
    return lo if v < lo else (hi if v > hi else v)


class ContextModels:
    """All context variables for one slice (H.266 §9.3.2.2 init)."""

    __slots__ = ("state0", "state1", "shift0", "shift1")

    def __init__(self, qp: int):
        n = TOTAL_CONTEXTS
        self.state0: List[int] = [0] * n
        self.state1: List[int] = [0] * n
        self.shift0: List[int] = [0] * n
        self.shift1: List[int] = [0] * n
        layout = ctx_layout()
        for name, (count, init_value, shift_idx) in CONTEXTS.items():
            off, _ = layout[name]
            slope_idx = init_value >> 3
            offset_idx = init_value & 7
            m = slope_idx - 4
            nn = (offset_idx * 18) + 1
            pre = _clip3(1, 127, ((m * (_clip3(0, 51, qp) - 16)) >> 1) + nn)
            s0 = (shift_idx >> 2) + 2
            s1 = (shift_idx & 3) + 3 + s0
            for i in range(count):
                self.state0[off + i] = pre << 3     # 10-bit
                self.state1[off + i] = pre << 7     # 14-bit
                self.shift0[off + i] = s0
                self.shift1[off + i] = s1

    def idx(self, name: str, inc: int = 0) -> int:
        off, count = ctx_layout()[name]
        assert 0 <= inc < count, (name, inc, count)
        return off + inc

    def snapshot(self):
        return (list(self.state0), list(self.state1))

    def restore(self, snap) -> None:
        self.state0 = list(snap[0])
        self.state1 = list(snap[1])


class CabacDecoder:
    """Binary arithmetic decoder over one substream (H.266 §9.3.4.3)."""

    __slots__ = ("data", "pos", "end", "range", "offset", "ctx")

    def __init__(self, data: bytes, start_byte: int, end_byte: int,
                 ctx: ContextModels):
        self.data = data
        self.pos = start_byte * 8
        self.end = end_byte
        self.ctx = ctx
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._read_bit()
        if self.offset >= 510:
            raise HeifError.invalid_input(msg="VVC CABAC init offset invalid")

    def _read_bit(self) -> int:
        p = self.pos
        if p >> 3 >= self.end:
            self.pos += 1
            return 0
        bit = (self.data[p >> 3] >> (7 - (p & 7))) & 1
        self.pos = p + 1
        return bit

    def decode_bin(self, ctx_idx: int) -> int:
        c = self.ctx
        s0 = c.state0[ctx_idx]
        s1 = c.state1[ctx_idx]
        p_state = s1 + (s0 << 4)                 # 15-bit combined
        val_mps = p_state >> 14
        q = self.range >> 5
        lps = ((q * (((32767 - p_state) if val_mps else p_state) >> 9))
               >> 1) + 4
        self.range -= lps
        if self.offset >= self.range:
            self.offset -= self.range
            self.range = lps
            binval = 1 - val_mps
        else:
            binval = val_mps
        # window-rate adaptation (§9.3.4.3.2.2)
        sh0 = c.shift0[ctx_idx]
        sh1 = c.shift1[ctx_idx]
        if binval:
            c.state0[ctx_idx] = s0 + ((1023 - s0) >> sh0)
            c.state1[ctx_idx] = s1 + ((16383 - s1) >> sh1)
        else:
            c.state0[ctx_idx] = s0 - (s0 >> sh0)
            c.state1[ctx_idx] = s1 - (s1 >> sh1)
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

    # ---- binarization helpers (§9.3.3) ----

    def decode_tu_ctx(self, ctx_indices: List[int], c_max: int) -> int:
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
        """k-th order Exp-Golomb, bypass bins (§9.3.3.5)."""
        leading = 0
        while self.decode_bypass():
            leading += 1
            if leading > 32:
                raise HeifError.invalid_input(msg="VVC EGk runaway")
        value = ((1 << leading) - 1) << k
        value += self.decode_bypass_bits(leading + k)
        return value

    def decode_truncated_binary(self, c_max: int) -> int:
        """Truncated binary over [0, c_max] (§9.3.3.4)."""
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        v = self.decode_bypass_bits(k)
        if v >= u:
            v = (v << 1) | self.decode_bypass()
            v -= u
        return v
