"""AV1 multi-symbol arithmetic encoder (mirror of msac.py).

Counterpart of libheif_tpu/codecs/av1/msac_enc.py, copied.  Implemented
over a Python big-int low register, so byte carries propagate for free;
the final stream is any value inside [low, low+range) emitted MSB-first.
Interval math mirrors the decoder exactly (daala od_ec_encode_q15
semantics).
"""

from __future__ import annotations

from .msac import EC_PROB_SHIFT, EC_MIN_PROB, _floor_log2


class MsacEncoder:
    def __init__(self, allow_update_cdf: bool = True):
        self.low = 0
        self.rng = 1 << 15
        self.nbits = 0          # bits of `low` beyond the 15-bit window
        self.allow_update = allow_update_cdf

    def _cur(self, icdf, k: int, n: int) -> int:
        """Decoder threshold cur_k (k = -1 → range)."""
        if k < 0:
            return self.rng
        f = int(icdf[k])
        return ((self.rng >> 8) * (f >> EC_PROB_SHIFT)
                >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - 1 - k)

    def encode_symbol_n(self, icdf, n: int, symbol: int) -> None:
        hi = self._cur(icdf, symbol - 1, n)   # exclusive upper (value)
        lo = self._cur(icdf, symbol, n)       # inclusive lower
        # decoder: value ∈ [lo, hi) → symbol; then value -= lo, rng = hi-lo
        # value is the complement of the stream, so the stream interval
        # for this symbol is [rng - hi, rng - lo) relative to low
        self.low += self.rng - hi
        self.rng = hi - lo
        d = 15 - _floor_log2(self.rng)
        self.low <<= d
        self.rng <<= d
        self.nbits += d
        if self.allow_update:
            count = int(icdf[n])
            rate = 3 + (count > 15) + (count > 31) + min(_floor_log2(n), 2)
            for i in range(n - 1):
                v = int(icdf[i])
                if i < symbol:
                    icdf[i] = v + ((32768 - v) >> rate)
                else:
                    icdf[i] = v - (v >> rate)
            icdf[n] = count + (count < 32)

    def encode_symbol(self, icdf, symbol: int) -> None:
        self.encode_symbol_n(icdf, len(icdf) - 1, symbol)

    def encode_bool(self, icdf, v: int) -> None:
        self.encode_symbol_n(icdf, 2, v)

    def encode_bit(self, v: int) -> None:
        rng8 = self.rng >> 8
        cur = (rng8 << 7) + EC_MIN_PROB
        if v == 0:
            # decoder: bit 0 ↔ value ∈ [cur, rng) → stream offset 0
            self.rng = self.rng - cur
        else:
            # bit 1 ↔ value ∈ [0, cur) → stream offset rng − cur
            self.low += self.rng - cur
            self.rng = cur
        d = 15 - _floor_log2(self.rng)
        self.low <<= d
        self.rng <<= d
        self.nbits += d

    def encode_literal(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.encode_bit((v >> i) & 1)

    def encode_golomb(self, v: int) -> None:
        x = v + 1
        length = x.bit_length()
        for _ in range(length - 1):
            self.encode_bit(0)
        for i in range(length - 1, -1, -1):
            self.encode_bit((x >> i) & 1)

    def done(self) -> bytes:
        """Canonical daala flush (od_ec_enc_done): round `low` up to a
        multiple of 2^14 and set bit 14. This yields the trailing-bits
        pattern (one 1 bit at the decoder's tell position, zeros after)
        that conformant decoders verify after the last tile symbol."""
        total_bits = self.nbits + 15
        m = (1 << 14) - 1
        e = ((self.low + m) & ~m) | (m + 1)
        nbytes = max((total_bits + 7) // 8, (e.bit_length() + 7) // 8)
        e <<= (nbytes * 8 - total_bits)
        return e.to_bytes(nbytes, "big")
