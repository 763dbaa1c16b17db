"""JPEG entropy-layer bit input and canonical Huffman tables.

Counterpart of libheif_tpu/codecs/jpeg/bitio.py, decode side (T.81
Annex C/F): the port's Python scan reads with these, and it is the plain
reference of the C++ scan (host/jpeg_scan.cc), which builds its own
lookup tables.  The Huffman table uses a 16-bit lookahead, so each symbol
is one table lookup.  The bit writer waits for the encoder.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ...core.error import HeifError, SubError


class HuffTable:
    """Canonical Huffman table per T.81 Annex C."""

    def __init__(self, bits: List[int], values: List[int]):
        # bits[1..16] = number of codes of each length
        if len(bits) == 16:
            bits = [0] + list(bits)
        self.bits = list(bits)
        self.values = list(values)

        # generate canonical codes
        code = 0
        self.codes: List[Tuple[int, int]] = []  # (length, code) per value
        k = 0
        for ln in range(1, 17):
            for _ in range(self.bits[ln]):
                if k >= len(values):
                    raise HeifError.invalid_input(
                        SubError.Invalid_parameter_value,
                        "huffman bits/values mismatch")
                self.codes.append((ln, code))
                code += 1
                k += 1
            code <<= 1

        # encoder map: symbol -> (length, code)
        self.enc = {}
        for (ln, c), v in zip(self.codes, self.values):
            self.enc[v] = (ln, c)

        # 16-bit lookahead decode table, built lazily: the native scan
        # engine builds its own 9-bit LUT, so the Python fallback alone
        # pays this cost
        self._lut_sym = None
        self._lut_len = None

    def _build_lut(self):
        # Build into locals and publish only when complete: tables are
        # shared across images via the DHT cache, so a concurrent reader
        # must never observe a partially filled LUT.
        lut_sym = np.zeros(1 << 16, dtype=np.int16)
        lut_len = np.zeros(1 << 16, dtype=np.int8)
        for (ln, c), v in zip(self.codes, self.values):
            shift = 16 - ln
            base = c << shift
            lut_sym[base:base + (1 << shift)] = v
            lut_len[base:base + (1 << shift)] = ln
        self._lut_sym = lut_sym
        self._lut_len = lut_len

    @property
    def lut_sym(self):
        if self._lut_sym is None:
            self._build_lut()
        return self._lut_sym

    @property
    def lut_len(self):
        if self._lut_len is None:
            self._build_lut()
        return self._lut_len


def unstuff(segment: bytes) -> np.ndarray:
    """Remove 0x00 stuffing bytes after 0xFF (T.81 F.1.2.3)."""
    arr = np.frombuffer(segment, dtype=np.uint8)
    if len(arr) == 0:
        return arr
    # a 0x00 preceded by 0xFF is a stuffing byte
    prev_ff = np.concatenate(([False], arr[:-1] == 0xFF))
    keep = ~((arr == 0x00) & prev_ff)
    return arr[keep]


class BitReader:
    """MSB-first bit reader over an unstuffed entropy segment."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self.pos = 0          # next byte index
        self.acc = 0          # bit accumulator
        self.nbits = 0        # valid bits in acc
        self.exhausted = False  # read past the end (truncated stream)

    def _fill(self, need: int):
        while self.nbits < need:
            if self.pos < len(self.data):
                b = int(self.data[self.pos])
                self.pos += 1
            else:
                b = 0  # pad with zero bits past the end (T.81 F.2.2.5)
                self.exhausted = True
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFFFFFF
            self.nbits += 8

    def peek16(self) -> int:
        self._fill(16)
        return (self.acc >> (self.nbits - 16)) & 0xFFFF

    def skip(self, n: int):
        self.nbits -= n

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        return v

    def decode_symbol(self, table: HuffTable) -> int:
        look = self.peek16()
        ln = int(table.lut_len[look])
        if ln == 0:
            raise HeifError.invalid_input(SubError.Invalid_parameter_value,
                                          "invalid huffman code")
        self.skip(ln)
        return int(table.lut_sym[look])


def extend(value: int, size: int) -> int:
    """T.81 F.2.2.1 EXTEND: map `size`-bit magnitude to signed."""
    if size == 0:
        return 0
    if value < (1 << (size - 1)):
        return value - (1 << size) + 1
    return value
