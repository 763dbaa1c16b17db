"""JPEG 2000 discrete wavelet transforms (ISO/IEC 15444-1 Annex F).

Reversible 5/3 integer lifting and irreversible 9/7 float lifting,
both directions, vectorized with numpy gather/slicing.  Arbitrary (odd) sizes
and subband origin parity follow the spec's i0/i1 index convention
with whole-sample symmetric extension; reflection preserves index
parity, so each lifting step is a single vectorized gather+axpy.

Reference behavior: libheif delegates this to OpenJPEG
(plugins/decoder_openjpeg.cc); validated bit-exact (5/3) against it.

A copy of libheif_tpu/codecs/j2k/dwt.py (numpy, on the host).
"""

from __future__ import annotations

import numpy as np

# 9/7 lifting constants (Table F.4)
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001


def _ext(idx: np.ndarray, n: int) -> np.ndarray:
    """Whole-sample symmetric extension of local indices into [0, n)."""
    if n == 1:
        return np.zeros_like(idx)
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    idx = np.where(idx < 0, -idx, idx)
    return idx


def _interleave(lo: np.ndarray, hi: np.ndarray, parity: int,
                axis: int) -> np.ndarray:
    """Merge subband samples: low band at even global indices, high at
    odd; parity = origin & 1 (local index l ↦ global origin+l)."""
    n = lo.shape[axis] + hi.shape[axis]
    shp = list(lo.shape)
    shp[axis] = n
    y = np.empty(shp, dtype=np.result_type(lo, hi))
    se = [slice(None)] * y.ndim
    so = [slice(None)] * y.ndim
    se[axis] = slice(parity, n, 2)       # even-global positions
    so[axis] = slice(1 - parity, n, 2)   # odd-global positions
    y[tuple(se)] = lo
    y[tuple(so)] = hi
    return y


def _deinterleave(y: np.ndarray, parity: int, axis: int):
    n = y.shape[axis]
    se = [slice(None)] * y.ndim
    so = [slice(None)] * y.ndim
    se[axis] = slice(parity, n, 2)
    so[axis] = slice(1 - parity, n, 2)
    return y[tuple(se)], y[tuple(so)]


def _sr_1d_53(y: np.ndarray, parity: int) -> np.ndarray:
    """5/3 synthesis along the LAST axis; y interleaved, origin parity."""
    n = y.shape[-1]
    if n == 1:
        return y >> 1 if parity else y.copy()
    ev = np.arange(parity, n, 2)
    od = np.arange(1 - parity, n, 2)
    x = np.empty_like(y)
    x[..., ev] = y[..., ev] - (
        (y[..., _ext(ev - 1, n)] + y[..., _ext(ev + 1, n)] + 2) >> 2)
    x[..., od] = y[..., od] + (
        (x[..., _ext(od - 1, n)] + x[..., _ext(od + 1, n)]) >> 1)
    return x


def _sd_1d_53(x: np.ndarray, parity: int):
    """5/3 analysis along the LAST axis → (low, high)."""
    n = x.shape[-1]
    if n == 1:
        if parity:
            return x[..., :0], x * 2
        return x.copy(), x[..., :0]
    ev = np.arange(parity, n, 2)
    od = np.arange(1 - parity, n, 2)
    y = np.empty_like(x)
    y[..., od] = x[..., od] - (
        (x[..., _ext(od - 1, n)] + x[..., _ext(od + 1, n)]) >> 1)
    y[..., ev] = x[..., ev] + (
        (y[..., _ext(ev - 1, n)] + y[..., _ext(ev + 1, n)] + 2) >> 2)
    return y[..., ev], y[..., od]


def _lift(y: np.ndarray, coef: float, t0: int, n: int) -> None:
    """In place: y[t] += coef*(y[t-1] + y[t+1]) for t = t0, t0+2, …"""
    t = np.arange(t0, n, 2)
    y[..., t] += coef * (y[..., _ext(t - 1, n)] + y[..., _ext(t + 1, n)])


def _sr_1d_97(y: np.ndarray, parity: int) -> np.ndarray:
    """9/7 synthesis along the LAST axis (float64)."""
    n = y.shape[-1]
    y = y.astype(np.float64, copy=True)
    if n == 1:
        return y
    ev, od = parity, 1 - parity
    y[..., ev::2] *= K
    y[..., od::2] *= 1.0 / K
    _lift(y, -DELTA, ev, n)
    _lift(y, -GAMMA, od, n)
    _lift(y, -BETA, ev, n)
    _lift(y, -ALPHA, od, n)
    return y


def _sd_1d_97(x: np.ndarray, parity: int):
    n = x.shape[-1]
    y = x.astype(np.float64, copy=True)
    if n == 1:
        if parity:
            return y[..., :0], y
        return y, y[..., :0]
    ev, od = parity, 1 - parity
    _lift(y, ALPHA, od, n)
    _lift(y, BETA, ev, n)
    _lift(y, GAMMA, od, n)
    _lift(y, DELTA, ev, n)
    y[..., ev::2] *= 1.0 / K
    y[..., od::2] *= K
    return y[..., ev::2], y[..., od::2]


def _apply_axis(f, a: np.ndarray, parity: int, axis: int):
    """Run a last-axis 1D transform along `axis`."""
    a = np.moveaxis(a, axis, -1)
    out = f(a, parity)
    if isinstance(out, tuple):
        return tuple(np.moveaxis(o, -1, axis) for o in out)
    return np.moveaxis(out, -1, axis)


def sr_2d(ll, hl, lh, hh, x0: int, y0: int, reversible: bool) -> np.ndarray:
    """One synthesis level: combine the 4 subbands into the parent
    resolution array whose origin on the reference grid is (x0, y0)."""
    px, py = x0 & 1, y0 & 1
    top = _interleave(ll, hl, px, axis=1)
    bot = _interleave(lh, hh, px, axis=1)
    y = _interleave(top, bot, py, axis=0)
    f = _sr_1d_53 if reversible else _sr_1d_97
    y = _apply_axis(f, y, px, axis=1)   # horizontal synthesis
    y = _apply_axis(f, y, py, axis=0)   # vertical synthesis
    return y


def sd_2d(x: np.ndarray, x0: int, y0: int, reversible: bool):
    """One analysis level → (ll, hl, lh, hh); mirror of sr_2d."""
    px, py = x0 & 1, y0 & 1
    f = _sd_1d_53 if reversible else _sd_1d_97
    lo_v, hi_v = _apply_axis(f, x, py, axis=0)    # vertical analysis
    ll, hl = _apply_axis(f, lo_v, px, axis=1)     # horizontal
    lh, hh = _apply_axis(f, hi_v, px, axis=1)
    return ll, hl, lh, hh
