"""Byte and bit readers and writers for ISOBMFF parsing and serialization.

Re-designed equivalents of the reference's bitstream layer
(reference: libheif/bitstream.h — StreamReader:39, BitstreamRange:258,
BitReader:408, StreamWriter:511).  The reference threads an error flag through a BitstreamRange; we instead keep explicit bounds
on a memoryview and raise :class:`HeifError` (End_of_data) on overrun,
which parse code catches at box isolation boundaries.

All multi-byte integers are big-endian (ISOBMFF network order) unless a
method says otherwise.
"""

from __future__ import annotations

import struct
from typing import Optional, Union

from .error import HeifError, SubError

_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_I16 = struct.Struct(">h")
_I32 = struct.Struct(">i")
_U64 = struct.Struct(">Q")
_I64 = struct.Struct(">q")


class ByteReader:
    """Bounded sequential big-endian byte reader (ref: BitstreamRange).

    A child reader created by :meth:`sub_reader` shares the underlying
    buffer but has its own tighter bounds — the analog of the
    reference's nested BitstreamRange construction for child boxes.
    """

    __slots__ = ("_buf", "pos", "end")

    def __init__(self, data: Union[bytes, bytearray, memoryview],
                 start: int = 0, end: Optional[int] = None):
        self._buf = memoryview(data)
        self.pos = start
        self.end = len(self._buf) if end is None else end
        if self.end > len(self._buf):
            raise HeifError.eof("reader bounds exceed buffer")

    # -- state ----------------------------------------------------------

    def remaining(self) -> int:
        return self.end - self.pos

    def eof(self) -> bool:
        return self.pos >= self.end

    def _need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise HeifError.eof(
                f"need {n} bytes at offset {self.pos}, only {self.remaining()} left")

    def skip_to_end(self) -> None:
        self.pos = self.end

    def sub_reader(self, size: int) -> "ByteReader":
        """Bounded child covering the next `size` bytes; advances self."""
        self._need(size)
        child = ByteReader(self._buf, self.pos, self.pos + size)
        self.pos += size
        return child

    # -- reads ----------------------------------------------------------

    def read8(self) -> int:
        self._need(1)
        v = self._buf[self.pos]
        self.pos += 1
        return v

    def read16(self) -> int:
        self._need(2)
        v = _U16.unpack_from(self._buf, self.pos)[0]
        self.pos += 2
        return v

    def read24(self) -> int:
        self._need(3)
        b = self._buf
        v = (b[self.pos] << 16) | (b[self.pos + 1] << 8) | b[self.pos + 2]
        self.pos += 3
        return v

    def read32(self) -> int:
        self._need(4)
        v = _U32.unpack_from(self._buf, self.pos)[0]
        self.pos += 4
        return v

    def read16s(self) -> int:
        self._need(2)
        v = _I16.unpack_from(self._buf, self.pos)[0]
        self.pos += 2
        return v

    def read32s(self) -> int:
        self._need(4)
        v = _I32.unpack_from(self._buf, self.pos)[0]
        self.pos += 4
        return v

    def read64(self) -> int:
        self._need(8)
        v = _U64.unpack_from(self._buf, self.pos)[0]
        self.pos += 8
        return v

    def read64s(self) -> int:
        self._need(8)
        v = _I64.unpack_from(self._buf, self.pos)[0]
        self.pos += 8
        return v

    def skip(self, n: int) -> None:
        self._need(n)
        self.pos += n

    def read_uint(self, nbytes: int) -> int:
        """Read an unsigned big-endian integer of 0/1/2/3/4/8 bytes.

        Used for iloc offset/length fields whose size is a header
        parameter (ref: Box_iloc parse, box.cc).
        """
        if nbytes == 0:
            return 0
        self._need(nbytes)
        v = int.from_bytes(self._buf[self.pos:self.pos + nbytes], "big")
        self.pos += nbytes
        return v

    def read_bytes(self, n: int) -> bytes:
        self._need(n)
        v = bytes(self._buf[self.pos:self.pos + n])
        self.pos += n
        return v

    def read_remaining(self) -> bytes:
        return self.read_bytes(self.remaining())

    def read_fixed_string(self, n: int) -> str:
        return self.read_bytes(n).decode("utf-8", errors="replace")

    def read_string(self) -> str:
        """NUL-terminated UTF-8 string (ref: BitstreamRange::read_string)."""
        start = self.pos
        buf = self._buf
        while self.pos < self.end and buf[self.pos] != 0:
            self.pos += 1
        s = bytes(buf[start:self.pos]).decode("utf-8", errors="replace")
        if self.pos < self.end:
            self.pos += 1  # consume NUL
        return s


class BitReader:
    """MSB-first bit reader with Exp-Golomb codes (ref: bitstream.h
    BitReader:408), for the HEVC and VVC parameter sets and slice headers
    and the bit-packed mini box."""

    __slots__ = ("_buf", "_bytepos", "_end", "_bitbuf", "_bits")

    def __init__(self, data: Union[bytes, bytearray, memoryview]):
        self._buf = memoryview(data)
        self._bytepos = 0
        self._end = len(self._buf)
        self._bitbuf = 0
        self._bits = 0

    def _fill(self, nbits: int) -> None:
        while self._bits < nbits:
            if self._bytepos >= self._end:
                raise HeifError.eof("bit reader underrun")
            self._bitbuf = (self._bitbuf << 8) | self._buf[self._bytepos]
            self._bytepos += 1
            self._bits += 8

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        self._bits -= n
        v = (self._bitbuf >> self._bits) & ((1 << n) - 1)
        self._bitbuf &= (1 << self._bits) - 1
        return v

    def read_flag(self) -> bool:
        return bool(self.read_bits(1))

    def read_ue(self) -> int:
        """Exp-Golomb ue(v) (ref: BitReader::get_uvlc)."""
        zeros = 0
        while self.read_bits(1) == 0:
            zeros += 1
            if zeros > 32:
                raise HeifError.invalid_input(msg="uvlc code too long")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read_bits(zeros)

    def read_se(self) -> int:
        """Exp-Golomb se(v) (ref: BitReader::get_svlc)."""
        u = self.read_ue()
        if u == 0:
            return 0
        sign = 1 if (u & 1) else -1
        return sign * ((u + 1) // 2)

    def skip_bits(self, n: int) -> None:
        self.read_bits(n)

    def bits_remaining(self) -> int:
        return (self._end - self._bytepos) * 8 + self._bits

    @property
    def bit_position(self) -> int:
        """Bits consumed from the start of the buffer."""
        return self._bytepos * 8 - self._bits

    def byte_align(self) -> None:
        self._bits -= self._bits % 8
        self._bitbuf &= (1 << self._bits) - 1

    def read_bytes_aligned(self, n: int) -> bytes:
        """Read n whole bytes; the position must be byte-aligned."""
        if self._bits % 8 != 0:
            raise HeifError.usage(msg="BitReader not byte-aligned")
        pos = self._bytepos - self._bits // 8
        if pos + n > self._end:
            raise HeifError.eof("bit reader byte read underrun")
        out = bytes(self._buf[pos:pos + n])
        self._bytepos = pos + n
        self._bitbuf = 0
        self._bits = 0
        return out


class ByteWriter:
    """Append/patch byte writer (ref: bitstream.h StreamWriter:511).

    A box header is written with a placeholder size that
    :meth:`patch32` fixes once the body is written, and :meth:`insert`
    widens it to a 64-bit size when needed (the reference's
    ``reserve_box_header_space``/``prepend_header``).
    """

    __slots__ = ("_data",)

    def __init__(self):
        self._data = bytearray()

    def __len__(self) -> int:
        return len(self._data)

    @property
    def pos(self) -> int:
        return len(self._data)

    def data(self) -> bytes:
        return bytes(self._data)

    def write8(self, v: int) -> None:
        self._data.append(v & 0xFF)

    def write16(self, v: int) -> None:
        self._data += _U16.pack(v & 0xFFFF)

    def write24(self, v: int) -> None:
        self._data += bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))

    def write32(self, v: int) -> None:
        self._data += _U32.pack(v & 0xFFFFFFFF)

    def write16s(self, v: int) -> None:
        self._data += _I16.pack(v)

    def write32s(self, v: int) -> None:
        self._data += _I32.pack(v)

    def write64(self, v: int) -> None:
        self._data += _U64.pack(v & 0xFFFFFFFFFFFFFFFF)

    def write_uint(self, v: int, nbytes: int) -> None:
        if nbytes:
            self._data += int(v).to_bytes(nbytes, "big")

    def write_bytes(self, b: Union[bytes, bytearray, memoryview]) -> None:
        self._data += b

    def write_string(self, s: str) -> None:
        """NUL-terminated UTF-8."""
        self._data += s.encode("utf-8") + b"\x00"

    def write_fixed_string(self, s: str, n: int) -> None:
        b = s.encode("utf-8")[:n]
        self._data += b + b"\x00" * (n - len(b))

    def insert(self, at: int, b: bytes) -> None:
        self._data[at:at] = b

    def patch32(self, at: int, v: int) -> None:
        self._data[at:at + 4] = _U32.pack(v & 0xFFFFFFFF)

    def patch_uint(self, at: int, v: int, nbytes: int) -> None:
        self._data[at:at + nbytes] = int(v).to_bytes(nbytes, "big")


class BitWriter:
    """MSB-first bit writer (ref: bitstream.h BitWriter:473); the HEVC
    encoder's parameter sets and slice headers.  Counterpart of
    libheif_tpu/core/bitstream.py:335."""

    __slots__ = ("_data", "_bitbuf", "_bits")

    def __init__(self):
        self._data = bytearray()
        self._bitbuf = 0
        self._bits = 0

    def write_bits(self, v: int, n: int) -> None:
        if n == 0:
            return
        self._bitbuf = (self._bitbuf << n) | (v & ((1 << n) - 1))
        self._bits += n
        while self._bits >= 8:
            self._bits -= 8
            self._data.append((self._bitbuf >> self._bits) & 0xFF)
        self._bitbuf &= (1 << self._bits) - 1

    def write_bit(self, v: int) -> None:
        self.write_bits(v, 1)

    @property
    def bit_position(self) -> int:
        """Bits written so far."""
        return len(self._data) * 8 + self._bits

    def byte_align(self, pad_bit: int = 0) -> None:
        while self._bits != 0:
            self.write_bits(pad_bit, 1)

    def data(self) -> bytes:
        if self._bits:
            raise HeifError.usage(msg="BitWriter not byte-aligned")
        return bytes(self._data)

    def data_padded(self) -> bytes:
        w = BitWriter()
        w._data = bytearray(self._data)
        w._bitbuf, w._bits = self._bitbuf, self._bits
        w.byte_align()
        return bytes(w._data)
