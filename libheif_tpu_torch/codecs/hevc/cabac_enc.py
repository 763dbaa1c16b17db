"""CABAC arithmetic encoder (mirror of the §9.3.4.3 decoding engine).

Counterpart of libheif_tpu/codecs/hevc/cabac_enc.py, copied.  Used by the
HEVC intra encoder's Python loop (encoder.py): the classic low/range
encoder with outstanding-bit carry resolution; its byte stream is the
slice-data RBSP (emulation prevention is applied by the NAL writer).
"""

from __future__ import annotations

from typing import List

from .tables import RANGE_TAB_LPS, TRANS_IDX_LPS, TRANS_IDX_MPS
from .cabac import ContextModels

_RANGE = RANGE_TAB_LPS.tolist()
_LPS = TRANS_IDX_LPS.tolist()
_MPS = TRANS_IDX_MPS.tolist()


class CabacEncoder:
    def __init__(self, ctx: ContextModels):
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True
        self._bits: List[int] = []

    # ------------------------------------------------------------- output

    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self._bits.append(b)
        while self.bits_outstanding > 0:
            self._bits.append(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        # spec 9.3.4.3.3 RenormE: L is a 10-bit register here
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

    # ------------------------------------------------------------- encode

    def encode_bin(self, ctx_idx: int, binval: int) -> None:
        c = self.ctx
        p_state = c.p_state[ctx_idx]
        lps = _RANGE[p_state][(self.range >> 6) & 3]
        self.range -= lps
        if binval != c.val_mps[ctx_idx]:
            self.low += self.range
            self.range = lps
            if p_state == 0:
                c.val_mps[ctx_idx] = 1 - c.val_mps[ctx_idx]
            c.p_state[ctx_idx] = _LPS[p_state]
        else:
            c.p_state[ctx_idx] = _MPS[p_state]
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
            # no renormalization here — flush() completes the stream
            self.low += self.range
        else:
            self._renorm()

    def flush(self) -> None:
        """Finish after encoding terminate(1) (spec EncodeFlush)."""
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # final two bits of low, with rbsp stop bit
        self._bits.append((self.low >> 8) & 1)
        self._bits.append(1)  # rbsp_stop_one_bit

    # --------------------------------------------------------- binarization

    def encode_tu_ctx(self, ctx_indices: List[int], c_max: int,
                      value: int) -> None:
        for i in range(value):
            self.encode_bin(ctx_indices[min(i, len(ctx_indices) - 1)], 1)
        if value < c_max:
            self.encode_bin(ctx_indices[min(value, len(ctx_indices) - 1)], 0)

    def encode_tu_bypass(self, c_max: int, value: int) -> None:
        for _ in range(value):
            self.encode_bypass(1)
        if value < c_max:
            self.encode_bypass(0)

    def encode_eg_bypass(self, k: int, value: int) -> None:
        leading = 0
        while value >= ((1 << leading) << k):
            value -= (1 << leading) << k
            leading += 1
        # emitted: `leading` ones, a zero, then (leading + k) bits of value
        for _ in range(leading):
            self.encode_bypass(1)
        self.encode_bypass(0)
        self.encode_bypass_bits(value, leading + k)

    # ------------------------------------------------------------- result

    def data(self) -> bytes:
        bits = self._bits
        # pad to byte with zeros (cabac_zero_words not needed)
        out = bytearray()
        acc = 0
        n = 0
        for b in bits:
            acc = (acc << 1) | b
            n += 1
            if n == 8:
                out.append(acc)
                acc = n = 0
        if n:
            out.append(acc << (8 - n))
        return bytes(out)
