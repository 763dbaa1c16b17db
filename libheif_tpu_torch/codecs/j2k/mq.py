"""MQ arithmetic coder (ISO/IEC 15444-1 Annex C).

Adaptive binary arithmetic coder shared by EBCOT tier-1.  The state
machine is the 47-entry Qe table; decoder follows the software
conventions of Annex C.3 (Chigh in the upper 16 bits of C), encoder
Annex C.2 with 0xFF byte stuffing and the spec FLUSH procedure.

A copy of libheif_tpu/codecs/j2k/mq.py.
"""

from __future__ import annotations

from typing import List, Tuple

# (Qe, NMPS, NLPS, SWITCH) — Table C.2
QE_TABLE: Tuple[Tuple[int, int, int, int], ...] = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

N_CONTEXTS = 19
CTX_UNI = 18   # uniform context
CTX_RL = 17    # run-length context


def initial_states() -> List[List[int]]:
    """[index, mps] per context — D.2 initialisation."""
    st = [[0, 0] for _ in range(N_CONTEXTS)]
    st[CTX_UNI][0] = 46
    st[CTX_RL][0] = 3
    st[0][0] = 4
    return st


class MQDecoder:
    """Annex C.3 decoder over a byte segment."""

    __slots__ = ("data", "bp", "c", "a", "ct", "states")

    def __init__(self, data: bytes, states=None):
        self.data = data
        self.states = states if states is not None else initial_states()
        # INITDEC
        self.bp = 0
        b = data[0] if data else 0xFF
        self.c = b << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self) -> None:
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.states[cx]
        qe, nmps, nlps, switch = QE_TABLE[st[0]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = st[1]
                st[0] = nmps
            else:
                d = 1 - st[1]
                if switch:
                    st[1] = 1 - st[1]
                st[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return st[1]
            if self.a < qe:
                d = 1 - st[1]
                if switch:
                    st[1] = 1 - st[1]
                st[0] = nlps
            else:
                d = st[1]
                st[0] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


class MQEncoder:
    """Annex C.2 encoder."""

    __slots__ = ("out", "c", "a", "ct", "b", "bvalid", "states")

    def __init__(self, states=None):
        self.states = states if states is not None else initial_states()
        # INITENC
        self.out = bytearray()
        self.a = 0x8000
        self.c = 0
        self.ct = 12
        self.b = 0          # pending byte
        self.bvalid = False  # a byte is pending (BP >= BPST)

    def encode(self, cx: int, d: int) -> None:
        st = self.states[cx]
        qe, nmps, nlps, switch = QE_TABLE[st[0]]
        if d == st[1]:  # CODEMPS
            self.a -= qe
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            st[0] = nmps
        else:  # CODELPS
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                st[1] = 1 - st[1]
            st[0] = nlps
        # RENORME
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFF
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _emit(self, byte: int) -> None:
        if self.bvalid:
            self.out.append(self.b)
        self.b = byte
        self.bvalid = True

    def _byteout(self) -> None:
        if self.bvalid and self.b == 0xFF:
            # stuff
            self._emit((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if self.c < 0x8000000:
                self._emit((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                self.b += 1
                if self.b == 0xFF:
                    self.c &= 0x7FFFFFF
                    self._emit((self.c >> 20) & 0xFF)
                    self.c &= 0xFFFFF
                    self.ct = 7
                else:
                    self._emit((self.c >> 19) & 0xFF)
                    self.c &= 0x7FFFF
                    self.ct = 8

    def flush(self) -> bytes:
        """FLUSH (C.2.9): set as many 1 bits in C as possible, output."""
        # SETBITS
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xFFFFFFF
        self._byteout()
        self.c = (self.c << self.ct) & 0xFFFFFFF
        self._byteout()
        if self.bvalid and self.b != 0xFF:
            self.out.append(self.b)
        self.bvalid = False
        # spec: discard trailing 0xFF (decoder re-synthesises 1s)
        while self.out and self.out[-1] == 0xFF:
            self.out.pop()
        return bytes(self.out)
