"""VVC CABAC arithmetic encoder (mirror of the H.266 §9.3.4.3 decoder).

Classic low/range encoder with outstanding-bit carry resolution; the
probability model is the two-state windowed estimator from cabac.py —
LPS subrange and state updates are computed identically on both sides
so encoder output is exactly decodable by CabacDecoder.

The port's copy of libheif_tpu/codecs/vvc/cabac_enc.py.
"""

from __future__ import annotations

from typing import List

from .cabac import ContextModels


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
        s0 = c.state0[ctx_idx]
        s1 = c.state1[ctx_idx]
        p_state = s1 + (s0 << 4)
        val_mps = p_state >> 14
        q = self.range >> 5
        lps = ((q * (((32767 - p_state) if val_mps else p_state) >> 9))
               >> 1) + 4
        self.range -= lps
        if binval != val_mps:
            self.low += self.range
            self.range = lps
        sh0 = c.shift0[ctx_idx]
        sh1 = c.shift1[ctx_idx]
        if binval:
            c.state0[ctx_idx] = s0 + ((1023 - s0) >> sh0)
            c.state1[ctx_idx] = s1 + ((16383 - s1) >> sh1)
        else:
            c.state0[ctx_idx] = s0 - (s0 >> sh0)
            c.state1[ctx_idx] = s1 - (s1 >> sh1)
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

    def flush(self) -> None:
        """Finish after encode_terminate(1)."""
        self.range = 2
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
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
        for _ in range(leading):
            self.encode_bypass(1)
        self.encode_bypass(0)
        self.encode_bypass_bits(value, leading + k)

    def encode_truncated_binary(self, c_max: int, value: int) -> None:
        """Truncated binary over [0, c_max] (§9.3.3.4 inverse)."""
        n = c_max + 1
        k = n.bit_length() - 1
        u = (1 << (k + 1)) - n
        if value < u:
            self.encode_bypass_bits(value, k)
        else:
            self.encode_bypass_bits(value + u, k + 1)

    # ------------------------------------------------------------- result

    def data(self) -> bytes:
        out = bytearray()
        acc = 0
        n = 0
        for b in self._bits:
            acc = (acc << 1) | b
            n += 1
            if n == 8:
                out.append(acc)
                acc = n = 0
        if n:
            out.append(acc << (8 - n))
        return bytes(out)
