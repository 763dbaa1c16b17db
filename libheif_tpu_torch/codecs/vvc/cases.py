"""A seeded synthetic photo, the source of the committed VVC still and of
the card's VVC encodes.

``synthetic_photo`` draws an outdoor scene in integer arithmetic only
(numpy's seeded integer generator, no floating point), so every machine
makes the same RGB samples: a sky graded to the horizon, hills whose
ridge is a random walk, textured ground, buildings with lit windows and
a few discs.  The tests encode it with the JAX package's writer and
commit the files' hashes; ``chip_smoke.py`` makes the same pixels on the
card's host and encodes them with the port.
"""

from __future__ import annotations

import numpy as np


def synthetic_photo(w: int, h: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy = np.arange(h, dtype=np.int64)[:, None]
    xx = np.arange(w, dtype=np.int64)[None, :]
    ones = np.ones((h, w), np.int64)
    # sky: blue at the top, pale at the horizon
    r = ones * (70 + 110 * yy // h)
    g = ones * (120 + 90 * yy // h)
    b = ones * (225 - 20 * yy // h)
    # the ridge: a random walk in 8-column steps, smoothed by the steps
    steps = rng.integers(-6, 7, w // 8 + 2).cumsum()
    ridge = (h * 2 // 5 + steps - steps.min() // 2)
    ridge = np.repeat(ridge, 8)[:w][None, :]
    ground = yy >= ridge
    tex = rng.integers(-14, 15, (h, w))
    patches = np.kron(rng.integers(-20, 21, (h // 16 + 1, w // 16 + 1)),
                      np.ones((16, 16), np.int64))[:h, :w]
    depth = (yy - ridge).clip(0, None) * 60 // max(h, 1)
    r = np.where(ground, 80 + depth + patches + tex, r)
    g = np.where(ground, 110 + depth // 2 + patches + tex, g)
    b = np.where(ground, 50 + tex // 2, b)
    # buildings: dark blocks standing on the ground, lit windows in rows
    for _ in range(max(1, w // 240)):
        bw = int(rng.integers(w // 20, w // 8 + 2))
        bh = int(rng.integers(h // 8, h // 3 + 2))
        x0 = int(rng.integers(0, max(1, w - bw)))
        base = int(ridge[0, min(w - 1, x0 + bw // 2)]) + h // 10
        y0 = max(0, base - bh)
        shade = int(rng.integers(40, 120))
        body = (yy >= y0) & (yy < base) & (xx >= x0) & (xx < x0 + bw)
        lit = body & ((yy - y0) % 12 >= 4) & ((yy - y0) % 12 < 9) \
            & ((xx - x0) % 10 >= 3) & ((xx - x0) % 10 < 7)
        r = np.where(body, shade, r)
        g = np.where(body, shade + 5, g)
        b = np.where(body, shade + 15, b)
        r = np.where(lit, 235, r)
        g = np.where(lit, 215, g)
        b = np.where(lit, 140, b)
    # discs: a sun and a few balls, each one colour with a darker rim
    for _ in range(max(1, w // 320)):
        cx = int(rng.integers(0, w))
        cy = int(rng.integers(0, h))
        rad = int(rng.integers(max(2, h // 40), max(3, h // 10)))
        col = rng.integers(30, 256, 3)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        inside = d2 < rad * rad
        rim = inside & (d2 >= (rad - 3) * (rad - 3))
        r = np.where(inside, np.where(rim, col[0] // 2, col[0]), r)
        g = np.where(inside, np.where(rim, col[1] // 2, col[1]), g)
        b = np.where(inside, np.where(rim, col[2] // 2, col[2]), b)
    return np.stack([r, g, b], -1).clip(0, 255).astype(np.uint8)
