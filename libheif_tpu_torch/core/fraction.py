"""Signed 32-bit fraction (reference: libheif/box.h Fraction).

Used by clap clean-aperture math and overlay/grid offsets.  Matches the
reference behavior of reducing via gcd only when needed and validating
the int32 range.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


@dataclass(frozen=True)
class Fraction:
    numerator: int = 0
    denominator: int = 1

    def is_valid(self) -> bool:
        return (self.denominator != 0
                and _I32_MIN <= self.numerator <= _I32_MAX
                and _I32_MIN <= self.denominator <= _I32_MAX)

    def reduced(self) -> "Fraction":
        if self.denominator == 0:
            return self
        g = math.gcd(self.numerator, self.denominator) or 1
        n, d = self.numerator // g, self.denominator // g
        if d < 0:
            n, d = -n, -d
        return Fraction(n, d)

    def __add__(self, o: "Fraction") -> "Fraction":
        return Fraction(self.numerator * o.denominator + o.numerator * self.denominator,
                        self.denominator * o.denominator).reduced()

    def __sub__(self, o: "Fraction") -> "Fraction":
        return Fraction(self.numerator * o.denominator - o.numerator * self.denominator,
                        self.denominator * o.denominator).reduced()

    def __mul__(self, k: int) -> "Fraction":
        return Fraction(self.numerator * k, self.denominator).reduced()

    def __truediv__(self, k: int) -> "Fraction":
        return Fraction(self.numerator, self.denominator * k).reduced()

    def round_down(self) -> int:
        return self.numerator // self.denominator

    def round_up(self) -> int:
        return -((-self.numerator) // self.denominator)

    def round(self) -> int:
        # round half away from zero, like the reference's Fraction::round
        n, d = self.numerator, self.denominator
        if d < 0:
            n, d = -n, -d
        if n >= 0:
            return (2 * n + d) // (2 * d)
        return -((-2 * n + d) // (2 * d))

    def to_float(self) -> float:
        return self.numerator / self.denominator
