"""AV1 palette mode: color parsing, cache, and index-map tokens.

Spec §5.11.46 (palette_mode_info), §5.11.49-50 (palette colors /
tokens), §7.11.4 (palette prediction).  Semantics mirror libaom's
decoder (read_palette_colors_y/uv, av1_get_palette_cache,
av1_get_palette_color_index_context) and are validated bit-exactly
against libaom decodes.

Counterpart of libheif_tpu/codecs/av1/palette.py, copied.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

PALETTE_MAX_SIZE = 8

# context hash -> color index context (aom
# palette_color_index_context_lookup)
_CTX_LOOKUP = {2: 0, 5: 4, 6: 3, 7: 2, 8: 1}

_WEIGHTS = (2, 1, 2)           # left, above-left, above
_HASH_MULT = (1, 2, 2)


def _ceil_log2(n: int) -> int:
    if n < 2:
        return 0
    return (n - 1).bit_length()


def read_uniform(r, n: int) -> int:
    """(aom av1_read_uniform / spec decode_uniform):
    l = FloorLog2(n) + 1."""
    l = n.bit_length()
    m = (1 << l) - n
    v = r.read_literal(l - 1) if l > 1 else 0
    if v < m:
        return v
    return (v << 1) - m + r.read_literal(1)


def get_palette_cache(pal_map, mi_r: int, mi_c: int, mr0: int,
                      mc0: int) -> List[int]:
    """Merged sorted color cache from the above/left block palettes
    (aom av1_get_palette_cache); the above block is ignored on 64px
    superblock row boundaries."""
    above: List[int] = []
    left: List[int] = []
    if (mi_r * 4) % 64 != 0 and mi_r > mr0:
        above = pal_map[mi_r - 1][mi_c] or []
    if mi_c > mc0:
        left = pal_map[mi_r][mi_c - 1] or []
    out: List[int] = []
    i = j = 0
    while i < len(above) and j < len(left):
        va, vl = above[i], left[j]
        if vl < va:
            if not out or vl != out[-1]:
                out.append(vl)
            j += 1
        else:
            if not out or va != out[-1]:
                out.append(va)
            i += 1
            if vl == va:
                j += 1
    for v in above[i:]:
        if not out or v != out[-1]:
            out.append(v)
    for v in left[j:]:
        if not out or v != out[-1]:
            out.append(v)
    return out


def read_colors_y(r, cache: List[int], n: int, bd: int) -> List[int]:
    """(aom read_palette_colors_y): cache reuse bits, then increasing
    delta-coded new colors, merged sorted."""
    cached: List[int] = []
    for c in cache:
        if len(cached) >= n:
            break
        if r.read_literal(1):
            cached.append(c)
    rest: List[int] = []
    if len(cached) < n:
        rest.append(r.read_literal(bd))
        if len(cached) + len(rest) < n:
            min_bits = bd - 3
            bits = min_bits + r.read_literal(2)
            rng = (1 << bd) - rest[-1] - 1
            while len(cached) + len(rest) < n:
                delta = r.read_literal(bits) + 1
                v = min(max(rest[-1] + delta, 0), (1 << bd) - 1)
                rng -= v - rest[-1]
                rest.append(v)
                bits = min(bits, _ceil_log2(rng))
    return sorted(cached + rest)


def read_colors_uv(r, cache: List[int], n: int, bd: int
                   ) -> Tuple[List[int], List[int]]:
    """(aom read_palette_colors_uv): U like Y but with unsigned deltas
    (no +1), V either raw or signed wrap-around deltas."""
    cached: List[int] = []
    for c in cache:
        if len(cached) >= n:
            break
        if r.read_literal(1):
            cached.append(c)
    rest: List[int] = []
    if len(cached) < n:
        rest.append(r.read_literal(bd))
        if len(cached) + len(rest) < n:
            min_bits = bd - 3
            bits = min_bits + r.read_literal(2)
            rng = (1 << bd) - rest[-1]
            while len(cached) + len(rest) < n:
                delta = r.read_literal(bits)
                v = min(max(rest[-1] + delta, 0), (1 << bd) - 1)
                rng -= v - rest[-1]
                rest.append(v)
                bits = min(bits, _ceil_log2(rng))
    colors_u = sorted(cached + rest)

    colors_v: List[int] = []
    max_val = 1 << bd
    if r.read_literal(1):          # delta encoding
        bits = (bd - 4) + r.read_literal(2)
        colors_v.append(r.read_literal(bd))
        for _ in range(1, n):
            delta = r.read_literal(bits)
            if delta and r.read_literal(1):
                delta = -delta
            v = colors_v[-1] + delta
            if v < 0:
                v += max_val
            if v >= max_val:
                v -= max_val
            colors_v.append(v)
    else:
        for _ in range(n):
            colors_v.append(r.read_literal(bd))
    return colors_u, colors_v


def color_index_context(color_map: np.ndarray, row: int, col: int,
                        n: int) -> Tuple[int, List[int]]:
    """(aom av1_get_palette_color_index_context): returns (ctx,
    color_order); the decoded symbol maps through color_order."""
    scores = [0] * PALETTE_MAX_SIZE
    if col > 0:
        scores[int(color_map[row, col - 1])] += _WEIGHTS[0]
    if row > 0 and col > 0:
        scores[int(color_map[row - 1, col - 1])] += _WEIGHTS[1]
    if row > 0:
        scores[int(color_map[row - 1, col])] += _WEIGHTS[2]
    order = list(range(PALETTE_MAX_SIZE))
    # partial selection sort of the top 3 with stable shifting
    for i in range(3):
        max_v = scores[i]
        max_idx = i
        for j in range(i + 1, n):
            if scores[j] > max_v:
                max_v = scores[j]
                max_idx = j
        if max_idx != i:
            max_score = scores[max_idx]
            max_order = order[max_idx]
            for k in range(max_idx, i, -1):
                scores[k] = scores[k - 1]
                order[k] = order[k - 1]
            scores[i] = max_score
            order[i] = max_order
    h = sum(scores[i] * _HASH_MULT[i] for i in range(3))
    return _CTX_LOOKUP[h], order


def read_color_map(r, cdf_rows, n: int, rows: int, cols: int,
                   block_h: int, block_w: int) -> np.ndarray:
    """Wavefront-parse the (rows x cols) index map and extend it to the
    (block_h x block_w) block (aom decode_color_map_tokens)."""
    m = np.zeros((block_h, block_w), np.uint8)
    m[0, 0] = read_uniform(r, n)
    for i in range(1, rows + cols - 1):
        # aom decode_color_map_tokens: each anti-diagonal is visited
        # top-row first (empirically pinned against libaom decodes)
        for row in range(max(0, i - cols + 1), min(i, rows - 1) + 1):
            col = i - row
            ctx, order = color_index_context(m, row, col, n)
            sym = r.read_symbol_n(cdf_rows[n - 2][ctx], n)
            m[row, col] = order[sym]
    if cols < block_w:
        m[:rows, cols:] = m[:rows, cols - 1:cols]
    if rows < block_h:
        m[rows:, :] = m[rows - 1:rows, :]
    return m
