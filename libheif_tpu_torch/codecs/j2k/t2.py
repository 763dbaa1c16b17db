"""Tier-2 coding: packet headers and tag trees (ISO/IEC 15444-1 B.9/B.10).

Packet-header bit IO uses 0xFF bit-stuffing (a byte following 0xFF
carries only 7 bits).  Tag trees encode inclusion layers and
missing-bit-plane counts hierarchically.  Reference analog: OpenJPEG
opj_t2.c / opj_tgt.c (libheif delegates via its OpenJPEG plugin).

A copy of libheif_tpu/codecs/j2k/t2.py.
"""

from __future__ import annotations

from typing import List, Optional


class HeaderBitReader:
    """MSB-first bit reader with 0xFF stuffing rule."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0       # current byte value
        self.ct = 0        # bits remaining in buf
        self.last = 0      # previously consumed byte

    def bit(self) -> int:
        if self.ct == 0:
            self.last = self.buf
            if self.pos >= len(self.data):
                raise EOFError("packet header overrun")
            self.buf = self.data[self.pos]
            self.pos += 1
            self.ct = 7 if self.last == 0xFF else 8
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """Byte-align; consume the stuffed byte after a trailing 0xFF.
        Returns the position of the first body byte."""
        if self.ct == 0 and self.buf == 0xFF:
            # last consumed byte was 0xFF → a stuffing byte follows
            self.pos += 1
        self.ct = 0
        self.buf = 0
        return self.pos


class HeaderBitWriter:
    """MSB-first bit writer with 0xFF stuffing rule: a byte written
    after an 0xFF carries only 7 data bits (its MSB is a stuffed 0)."""

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.nbits = 0   # bits accumulated in buf
        self.cap = 8     # capacity of the current byte (7 after 0xFF)

    def bit(self, b: int) -> None:
        self.buf = (self.buf << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == self.cap:
            self.out.append(self.buf)
            self.cap = 7 if self.buf == 0xFF else 8
            self.buf = 0
            self.nbits = 0

    def bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self) -> bytes:
        """Byte-align (pad with 0 bits); if the final byte is 0xFF a
        stuffing byte follows so a reader's align() stays in sync."""
        if self.nbits > 0:
            self.buf <<= self.cap - self.nbits
            self.out.append(self.buf)
            self.buf = 0
            self.nbits = 0
            self.cap = 8
            if self.out[-1] == 0xFF:
                self.out.append(0)
        elif self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class TagTree:
    """Tag tree over an (w × h) leaf grid (B.10.2)."""

    def __init__(self, w: int, h: int):
        self.w, self.h = max(w, 1), max(h, 1)
        self.levels = []  # list of (w, h) per level, leaf first
        lw, lh = self.w, self.h
        while True:
            self.levels.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.value = [[0] * (w_ * h_) for (w_, h_) in self.levels]
        self.known = [[False] * (w_ * h_) for (w_, h_) in self.levels]
        self.low = [[0] * (w_ * h_) for (w_, h_) in self.levels]

    def reset(self):
        for lv in range(len(self.levels)):
            n = len(self.value[lv])
            self.value[lv] = [0] * n
            self.known[lv] = [False] * n
            self.low[lv] = [0] * n

    def _path(self, x: int, y: int):
        out = []
        for lv, (w_, h_) in enumerate(self.levels):
            out.append((lv, y * w_ + x))
            x, y = x // 2, y // 2
        return list(reversed(out))  # root first

    # ---- decode ----
    def decode(self, rd: HeaderBitReader, x: int, y: int,
               threshold: int) -> bool:
        """Decode bits until leaf known relative to threshold.
        Returns True iff leaf value < threshold."""
        low = 0
        leaf_lv, leaf_i = None, None
        for lv, i in self._path(x, y):
            if self.low[lv][i] < low:
                self.low[lv][i] = low
            while not self.known[lv][i] and self.low[lv][i] < threshold:
                if rd.bit():
                    self.value[lv][i] = self.low[lv][i]
                    self.known[lv][i] = True
                else:
                    self.low[lv][i] += 1
            low = self.value[lv][i] if self.known[lv][i] else self.low[lv][i]
            leaf_lv, leaf_i = lv, i
        return self.known[leaf_lv][leaf_i] and \
            self.value[leaf_lv][leaf_i] < threshold

    def decode_value(self, rd: HeaderBitReader, x: int, y: int) -> int:
        """Decode until the leaf is fully known; returns its value."""
        t = 1
        while not self.decode(rd, x, y, t):
            t += 1
        lv, i = self._path(x, y)[-1]
        return self.value[lv][i]

    # ---- encode ----
    def finalize_values(self) -> None:
        """Recompute internal nodes as min of children.  Level 0 is the
        leaf level (populated via set_leaf); higher indices are coarser."""
        for lv in range(1, len(self.levels)):
            w_, h_ = self.levels[lv]
            cw, ch = self.levels[lv - 1]
            for yy in range(h_):
                for xx in range(w_):
                    mn = None
                    for (cx, cy) in ((2 * xx, 2 * yy), (2 * xx + 1, 2 * yy),
                                     (2 * xx, 2 * yy + 1),
                                     (2 * xx + 1, 2 * yy + 1)):
                        if cx < cw and cy < ch:
                            v_ = self.value[lv - 1][cy * cw + cx]
                            mn = v_ if mn is None else min(mn, v_)
                    self.value[lv][yy * w_ + xx] = 0 if mn is None else mn

    def set_leaf(self, x: int, y: int, v: int) -> None:
        w_, _ = self.levels[0]
        self.value[0][y * w_ + x] = v

    def leaf_known(self, x: int, y: int) -> bool:
        w_, _ = self.levels[0]
        return self.known[0][y * w_ + x]

    def encode(self, wr: HeaderBitWriter, x: int, y: int,
               threshold: int) -> None:
        """Emit bits so a decoder calling decode(threshold) learns
        whether leaf < threshold (B.10.2 encoder).  value[] holds the
        true node values (set_leaf + finalize_values); known[] tracks
        what has already been communicated."""
        low = 0
        for lv, i in self._path(x, y):
            if self.low[lv][i] < low:
                self.low[lv][i] = low
            while not self.known[lv][i] and self.low[lv][i] < threshold:
                if self.low[lv][i] == self.value[lv][i]:
                    wr.bit(1)
                    self.known[lv][i] = True
                else:
                    wr.bit(0)
                    self.low[lv][i] += 1
            low = self.value[lv][i] if self.known[lv][i] else self.low[lv][i]


def read_numpasses(rd: HeaderBitReader) -> int:
    """Table B.4 coding-pass count."""
    if not rd.bit():
        return 1
    if not rd.bit():
        return 2
    n = rd.bits(2)
    if n != 3:
        return 3 + n
    n = rd.bits(5)
    if n != 31:
        return 6 + n
    return 37 + rd.bits(7)


def write_numpasses(wr: HeaderBitWriter, n: int) -> None:
    if n == 1:
        wr.bit(0)
    elif n == 2:
        wr.bits(0b10, 2)
    elif n <= 5:
        wr.bits(0b11, 2)
        wr.bits(n - 3, 2)
    elif n <= 36:
        wr.bits(0b11, 2)
        wr.bits(3, 2)
        wr.bits(n - 6, 5)
    else:
        wr.bits(0b11, 2)
        wr.bits(3, 2)
        wr.bits(31, 5)
        wr.bits(n - 37, 7)
