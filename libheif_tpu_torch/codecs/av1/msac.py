"""AV1 multi-symbol arithmetic decoder (spec §8.2, daala EC).

CDF convention matches the extracted default tables (cdf.py): rows are
"inverse" CDFs — icdf[i] = 32768 − cumulative(i), strictly decreasing
to 0 — with one trailing adaptation counter slot. A row of width W
codes W−1 symbols.

Counterpart of libheif_tpu/codecs/av1/msac.py, copied.
"""

from __future__ import annotations

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4

_BOOL_HALF = [16384, 0, 0]   # equal-probability binary icdf (no adapt)


def _floor_log2(v: int) -> int:
    return v.bit_length() - 1


class Msac:
    def __init__(self, data: bytes, allow_update_cdf: bool = True):
        self.data = data
        self.bitpos = 0
        self.max_bits = len(data) * 8 - 15
        num_bits = min(len(data) * 8, 15)
        buf = self._read_bits(num_bits)
        padded = buf << (15 - num_bits)
        self.value = ((1 << 15) - 1) ^ padded
        self.range = 1 << 15
        self.allow_update = allow_update_cdf

    # ------------------------------------------------------------ raw bits

    def _read_bits(self, n: int) -> int:
        v = 0
        data = self.data
        ln = len(data)
        pos = self.bitpos
        for _ in range(n):
            byte_i = pos >> 3
            bit = (data[byte_i] >> (7 - (pos & 7))) & 1 if byte_i < ln else 0
            v = (v << 1) | bit
            pos += 1
        self.bitpos = pos
        return v

    # ------------------------------------------------------------- symbols

    def _renorm(self) -> None:
        rng = self.range
        bits = 15 - _floor_log2(rng)
        if bits == 0:
            return
        self.range = rng << bits
        num_bits = min(bits, max(0, self.max_bits))
        new_data = self._read_bits(num_bits)
        read_data = new_data << (bits - num_bits)
        self.value = ((self.value + 1) << bits) - read_data - 1
        self.max_bits -= bits

    def read_symbol_n(self, icdf, n: int) -> int:
        """Decode one symbol against an icdf row (first n symbols)."""
        rng8 = self.range >> 8
        value = self.value
        cur = self.range
        symbol = -1
        while True:
            symbol += 1
            prev = cur
            f = int(icdf[symbol])
            cur = ((rng8 * (f >> EC_PROB_SHIFT)) >> (7 - EC_PROB_SHIFT)) \
                + EC_MIN_PROB * (n - 1 - symbol)
            if value >= cur:
                break
        self.range = prev - cur
        self.value = value - cur
        self._renorm()
        if self.allow_update and icdf is not _BOOL_HALF:
            count = int(icdf[n])
            rate = 3 + (count > 15) + (count > 31) + \
                min(_floor_log2(n), 2)
            for i in range(n - 1):
                v = int(icdf[i])
                if i < symbol:
                    icdf[i] = v + ((32768 - v) >> rate)
                else:
                    icdf[i] = v - (v >> rate)
            icdf[n] = count + (count < 32)
        return symbol

    def read_symbol(self, icdf) -> int:
        """Row width W codes W−1 symbols (last slot is the counter)."""
        return self.read_symbol_n(icdf, len(icdf) - 1)

    def read_bool(self, icdf) -> int:
        return self.read_symbol_n(icdf, 2)

    def read_bit(self) -> int:
        """Equal-probability bit (spec read_bool / L(1))."""
        rng8 = self.range >> 8
        cur = (rng8 << 7) + EC_MIN_PROB
        if self.value >= cur:
            bit = 0
            self.range -= cur
            self.value -= cur
        else:
            bit = 1
            self.range = cur
        self._renorm()
        return bit

    def read_literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v

    def read_golomb(self) -> int:
        """(spec read_golomb, used by coefficient level tails)."""
        length = 0
        while not self.read_bit():
            length += 1
            if length > 20:
                break
        v = 1
        for _ in range(length):
            v = (v << 1) | self.read_bit()
        return v - 1
