"""Four-character-code helpers (reference: libheif/common_utils.h:52-90)."""

from __future__ import annotations


def fourcc(s: str) -> int:
    """'hvc1' → 0x68766331 big-endian packed code."""
    if len(s) != 4:
        raise ValueError(f"fourcc must be 4 chars, got {s!r}")
    b = s.encode("latin-1")
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


def fourcc_to_str(code: int) -> str:
    """0x68766331 → 'hvc1'; non-printable bytes rendered as '.'."""
    chars = []
    for shift in (24, 16, 8, 0):
        c = (code >> shift) & 0xFF
        chars.append(chr(c) if 32 <= c < 127 else ".")
    return "".join(chars)
