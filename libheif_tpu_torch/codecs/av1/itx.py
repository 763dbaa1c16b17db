"""AV1 inverse transforms (spec §7.13.3, aom av1_inv_txfm2d heritage).

Counterpart of libheif_tpu/codecs/av1/itx.py, trimmed to the staged 1-D
transforms and their tables: DCT 4-64, ADST/FlipADST 4-16, identity
4-32, the rectangular scaling constant (2896, 2^12/sqrt 2) and the
per-size stage shifts.  The functions take lists of arrays and work on
numpy arrays and torch tensors alike; av1_dequant_itx's plain version
(cuda_fast.dequant_itx_plain) runs them on int32 tensors, and
csrc/av1_kernels.cu repeats them in CUDA.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

from . import tables as T

_COS_BIT = 12
_COSPI = [round(math.cos(i * math.pi / 128) * (1 << _COS_BIT))
          for i in range(64)]
# sinpi for the 4-point ADST: sin(k·π/9)·√2·(2/3)·2^12 (aom sinpi_arr:
# 1321, 2482, 3344, 3803)
_SINPI = [0] + [round(math.sin(i * math.pi / 9) * math.sqrt(2) *
                      (2.0 / 3.0) * (1 << _COS_BIT)) for i in range(1, 5)]
_INV_SQRT2 = 2896          # 2^12 / sqrt(2)
_NEW_SQRT2 = 5793          # 2^12 * sqrt(2)


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n > 0 else x


def _half_btf(w0, in0, w1, in1):
    return _round2(w0 * in0 + w1 * in1, _COS_BIT)


# ----------------------------------------------------------------- idct

def idct4(x):
    c = _COSPI
    s0 = _half_btf(c[32], x[0], c[32], x[2])
    s1 = _half_btf(c[32], x[0], -c[32], x[2])
    s2 = _half_btf(c[48], x[1], -c[16], x[3])
    s3 = _half_btf(c[16], x[1], c[48], x[3])
    return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]


def idct8(x):
    c = _COSPI
    # stage 1: even part via idct4 on [0,2,4,6]
    e = idct4([x[0], x[2], x[4], x[6]])
    # odd part
    s4 = _half_btf(c[56], x[1], -c[8], x[7])
    s7 = _half_btf(c[8], x[1], c[56], x[7])
    s5 = _half_btf(c[24], x[5], -c[40], x[3])
    s6 = _half_btf(c[40], x[5], c[24], x[3])
    t4 = s4 + s5
    t5 = s4 - s5
    t7 = s7 + s6
    t6 = s7 - s6
    u5 = _half_btf(c[32], t6, -c[32], t5)
    u6 = _half_btf(c[32], t6, c[32], t5)
    o = [t4, u5, u6, t7]
    return [e[0] + o[3], e[1] + o[2], e[2] + o[1], e[3] + o[0],
            e[3] - o[0], e[2] - o[1], e[1] - o[2], e[0] - o[3]]


def idct16(x):
    c = _COSPI
    e = idct8(x[0::2])
    # odd inputs 1,3,..,15 → stage network
    s8 = _half_btf(c[60], x[1], -c[4], x[15])
    s15 = _half_btf(c[4], x[1], c[60], x[15])
    s9 = _half_btf(c[28], x[9], -c[36], x[7])
    s14 = _half_btf(c[36], x[9], c[28], x[7])
    s10 = _half_btf(c[44], x[5], -c[20], x[11])
    s13 = _half_btf(c[20], x[5], c[44], x[11])
    s11 = _half_btf(c[12], x[13], -c[52], x[3])
    s12 = _half_btf(c[52], x[13], c[12], x[3])
    t8 = s8 + s9
    t9 = s8 - s9
    t10 = s11 - s10
    t11 = s11 + s10
    t12 = s12 + s13
    t13 = s12 - s13
    t14 = s15 - s14
    t15 = s15 + s14
    u9 = _half_btf(-c[16], t9, c[48], t14)
    u14 = _half_btf(c[48], t9, c[16], t14)
    u10 = _half_btf(-c[48], t10, -c[16], t13)
    u13 = _half_btf(-c[16], t10, c[48], t13)
    v8 = t8 + t11
    v9 = u9 + u10
    v10 = u9 - u10
    v11 = t8 - t11
    v12 = t15 - t12
    v13 = u14 - u13
    v14 = u14 + u13
    v15 = t15 + t12
    w10 = _half_btf(-c[32], v10, c[32], v13)
    w13 = _half_btf(c[32], v10, c[32], v13)
    w11 = _half_btf(-c[32], v11, c[32], v12)
    w12 = _half_btf(c[32], v11, c[32], v12)
    o = [v8, v9, w10, w11, w12, w13, v14, v15]
    return [e[i] + o[7 - i] for i in range(8)] + \
           [e[7 - i] - o[i] for i in range(8)]


def idct32(x):
    c = _COSPI
    e = idct16(x[0::2])
    xo = [x[1], x[3], x[5], x[7], x[9], x[11], x[13], x[15],
          x[17], x[19], x[21], x[23], x[25], x[27], x[29], x[31]]
    # stage 1 butterflies (inputs reordered per av1 idct32 stage network)
    s = [0] * 16
    # s16..s31 with av1 ordering:
    s[0] = _half_btf(c[62], xo[0], -c[2], xo[15])
    s[15] = _half_btf(c[2], xo[0], c[62], xo[15])
    s[1] = _half_btf(c[30], xo[8], -c[34], xo[7])
    s[14] = _half_btf(c[34], xo[8], c[30], xo[7])
    s[2] = _half_btf(c[46], xo[4], -c[18], xo[11])
    s[13] = _half_btf(c[18], xo[4], c[46], xo[11])
    s[3] = _half_btf(c[14], xo[12], -c[50], xo[3])
    s[12] = _half_btf(c[50], xo[12], c[14], xo[3])
    s[4] = _half_btf(c[54], xo[2], -c[10], xo[13])
    s[11] = _half_btf(c[10], xo[2], c[54], xo[13])
    s[5] = _half_btf(c[22], xo[10], -c[42], xo[5])
    s[10] = _half_btf(c[42], xo[10], c[22], xo[5])
    s[6] = _half_btf(c[38], xo[6], -c[26], xo[9])
    s[9] = _half_btf(c[26], xo[6], c[38], xo[9])
    s[7] = _half_btf(c[6], xo[14], -c[58], xo[1])
    s[8] = _half_btf(c[58], xo[14], c[6], xo[1])
    # stage 2
    t = [0] * 16
    t[0], t[1] = s[0] + s[1], s[0] - s[1]
    t[3], t[2] = s[3] + s[2], s[3] - s[2]
    t[4], t[5] = s[4] + s[5], s[4] - s[5]
    t[7], t[6] = s[7] + s[6], s[7] - s[6]
    t[8], t[9] = s[8] + s[9], s[8] - s[9]
    t[11], t[10] = s[11] + s[10], s[11] - s[10]
    t[12], t[13] = s[12] + s[13], s[12] - s[13]
    t[15], t[14] = s[15] + s[14], s[15] - s[14]
    # stage 3 rotations
    u = list(t)
    u[1] = _half_btf(-c[8], t[1], c[56], t[14])
    u[14] = _half_btf(c[56], t[1], c[8], t[14])
    u[2] = _half_btf(-c[56], t[2], -c[8], t[13])
    u[13] = _half_btf(-c[8], t[2], c[56], t[13])
    u[5] = _half_btf(-c[40], t[5], c[24], t[10])
    u[10] = _half_btf(c[24], t[5], c[40], t[10])
    u[6] = _half_btf(-c[24], t[6], -c[40], t[9])
    u[9] = _half_btf(-c[40], t[6], c[24], t[9])
    # stage 4
    v = [0] * 16
    v[0], v[3] = u[0] + u[3], u[0] - u[3]
    v[1], v[2] = u[1] + u[2], u[1] - u[2]
    v[7], v[4] = u[7] + u[4], u[7] - u[4]
    v[6], v[5] = u[6] + u[5], u[6] - u[5]
    v[8], v[11] = u[8] + u[11], u[8] - u[11]
    v[9], v[10] = u[9] + u[10], u[9] - u[10]
    v[15], v[12] = u[15] + u[12], u[15] - u[12]
    v[14], v[13] = u[14] + u[13], u[14] - u[13]
    # stage 5 rotations
    w = list(v)
    w[2] = _half_btf(-c[16], v[2], c[48], v[13])
    w[13] = _half_btf(c[48], v[2], c[16], v[13])
    w[3] = _half_btf(-c[16], v[3], c[48], v[12])
    w[12] = _half_btf(c[48], v[3], c[16], v[12])
    w[4] = _half_btf(-c[48], v[4], -c[16], v[11])
    w[11] = _half_btf(-c[16], v[4], c[48], v[11])
    w[5] = _half_btf(-c[48], v[5], -c[16], v[10])
    w[10] = _half_btf(-c[16], v[5], c[48], v[10])
    # stage 6
    a = [0] * 16
    a[0], a[7] = w[0] + w[7], w[0] - w[7]
    a[1], a[6] = w[1] + w[6], w[1] - w[6]
    a[2], a[5] = w[2] + w[5], w[2] - w[5]
    a[3], a[4] = w[3] + w[4], w[3] - w[4]
    a[8], a[15] = w[15] - w[8], w[15] + w[8]
    a[9], a[14] = w[14] - w[9], w[14] + w[9]
    a[10], a[13] = w[13] - w[10], w[13] + w[10]
    a[11], a[12] = w[12] - w[11], w[12] + w[11]
    # stage 7 rotations
    b = list(a)
    b[4] = _half_btf(-c[32], a[4], c[32], a[11])
    b[11] = _half_btf(c[32], a[4], c[32], a[11])
    b[5] = _half_btf(-c[32], a[5], c[32], a[10])
    b[10] = _half_btf(c[32], a[5], c[32], a[10])
    b[6] = _half_btf(-c[32], a[6], c[32], a[9])
    b[9] = _half_btf(c[32], a[6], c[32], a[9])
    b[7] = _half_btf(-c[32], a[7], c[32], a[8])
    b[8] = _half_btf(c[32], a[7], c[32], a[8])
    o = b
    return [e[i] + o[15 - i] for i in range(16)] + \
           [e[15 - i] - o[i] for i in range(16)]


def _brev(nbits: int, v: int) -> int:
    out = 0
    for i in range(nbits):
        out |= ((v >> i) & 1) << (nbits - 1 - i)
    return out


def idct64(x):
    """64-point inverse DCT. AV1 codes only the low 32 spectral inputs
    (the 2-D transform zero-pads the rest), but the network is complete.

    Constructed by the even/odd doubling that relates idct8→16→32
    (verified on those sizes): stage-1 pairs couple inputs (a, 64-a)
    with rotation angle a = brev6(32+j); each later stage is the
    previous size's stage with indices doubled, pairing (2i, 2j+1).
    """
    c = _COSPI
    e = idct32(x[0::2])
    # stage 1: 16 rotation pairs over the 32 odd inputs
    s = [0] * 32
    for j in range(16):
        a = _brev(6, 32 + j)                      # odd, 1..63
        xi, xj = x[a], x[64 - a]
        s[j] = _half_btf(c[64 - a], xi, -c[a], xj)
        s[31 - j] = _half_btf(c[a], xi, c[64 - a], xj)
    # stage 2: add/sub pairs, orientation alternating per pair
    t = [0] * 32
    for p in range(16):
        i0, i1 = 2 * p, 2 * p + 1
        if p % 2 == 0:
            t[i0], t[i1] = s[i0] + s[i1], s[i0] - s[i1]
        else:
            t[i1], t[i0] = s[i1] + s[i0], s[i1] - s[i0]
    # stage 3: finest rotations, quads (4k+1,4k+2) vs (30-4k,29-4k)
    u = list(t)
    for k in range(8):
        b = 4 * _brev(4, 8 + k)                   # 4,36,20,52,12,44,28,60
        i0, i1 = 4 * k + 1, 4 * k + 2
        j0, j1 = 30 - 4 * k, 29 - 4 * k
        u[i0] = _half_btf(c[b], t[i0], -c[64 - b], t[j0])
        u[j0] = _half_btf(-c[64 - b], t[i0], -c[b], t[j0])
        u[i1] = _half_btf(c[64 - b], t[i1], c[b], t[j1])
        u[j1] = _half_btf(c[b], t[i1], -c[64 - b], t[j1])
    # stage 4: add/sub groups of 4, orientation alternating per group
    v = [0] * 32
    for g in range(8):
        o = 4 * g
        if g % 2 == 0:
            v[o], v[o + 3] = u[o] + u[o + 3], u[o] - u[o + 3]
            v[o + 1], v[o + 2] = u[o + 1] + u[o + 2], u[o + 1] - u[o + 2]
        else:
            v[o + 3], v[o] = u[o + 3] + u[o], u[o + 3] - u[o]
            v[o + 2], v[o + 1] = u[o + 2] + u[o + 1], u[o + 2] - u[o + 1]
    # stage 5: rotations b∈{8,40}; indices (2i,2i+1) from size-16 (i,15-i)
    w = list(v)
    for (i, j, b, form) in ((2, 29, 8, 0), (3, 28, 8, 0),
                            (4, 27, 8, 1), (5, 26, 8, 1),
                            (10, 21, 40, 0), (11, 20, 40, 0),
                            (12, 19, 40, 1), (13, 18, 40, 1)):
        if form == 0:
            w[i] = _half_btf(-c[b], v[i], c[64 - b], v[j])
            w[j] = _half_btf(c[64 - b], v[i], c[b], v[j])
        else:
            w[i] = _half_btf(-c[64 - b], v[i], -c[b], v[j])
            w[j] = _half_btf(-c[b], v[i], c[64 - b], v[j])
    # stage 6: add/sub groups of 8
    a6 = [0] * 32
    for g in range(4):
        o = 8 * g
        for i in range(4):
            lo, hi = o + i, o + 7 - i
            if g % 2 == 0:
                a6[lo], a6[hi] = w[lo] + w[hi], w[lo] - w[hi]
            else:
                a6[hi], a6[lo] = w[hi] + w[lo], w[hi] - w[lo]
    # stage 7: rotations b=16 on (4..7 | 24..27 form0) and (8..11 form1)
    b7 = list(a6)
    for i in range(4, 8):
        j = 31 - i
        b7[i] = _half_btf(-c[16], a6[i], c[48], a6[j])
        b7[j] = _half_btf(c[48], a6[i], c[16], a6[j])
    for i in range(8, 12):
        j = 31 - i
        b7[i] = _half_btf(-c[48], a6[i], -c[16], a6[j])
        b7[j] = _half_btf(-c[16], a6[i], c[48], a6[j])
    # stage 8: add/sub groups of 16
    r8 = [0] * 32
    for i in range(8):
        lo, hi = i, 15 - i
        r8[lo], r8[hi] = b7[lo] + b7[hi], b7[lo] - b7[hi]
        lo2, hi2 = 16 + i, 31 - i
        r8[hi2], r8[lo2] = b7[hi2] + b7[lo2], b7[hi2] - b7[lo2]
    # stage 9: c32 rotations on the middle half (8..15 vs 23..16)
    q = list(r8)
    for i in range(8, 16):
        j = 31 - i
        q[i] = _half_btf(-c[32], r8[i], c[32], r8[j])
        q[j] = _half_btf(c[32], r8[i], c[32], r8[j])
    # final merge with the even part
    return [e[i] + q[31 - i] for i in range(32)] + \
           [e[31 - i] - q[i] for i in range(32)]


# ----------------------------------------------------------------- iadst

def iadst4(x):
    """(aom av1_iadst4 heritage: sinpi network, non-butterfly)."""
    sp = _SINPI
    x0, x1, x2, x3 = x[0], x[1], x[2], x[3]
    s0 = sp[1] * x0
    s1 = sp[2] * x0
    s2 = sp[3] * x1
    s3 = sp[4] * x2
    s4 = sp[1] * x2
    s5 = sp[2] * x3
    s6 = sp[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    x0 = s0 + s3
    x1 = s1 + s3
    x2 = s2
    x3 = (s0 + s1) - s3
    return [_round2(x0, _COS_BIT), _round2(x1, _COS_BIT),
            _round2(x2, _COS_BIT), _round2(x3, _COS_BIT)]


def iadst8(x):
    c = _COSPI
    # stage 1: reorder
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    # stage 2: rotations
    s = [_half_btf(c[4], b[0], c[60], b[1]),
         _half_btf(c[60], b[0], -c[4], b[1]),
         _half_btf(c[20], b[2], c[44], b[3]),
         _half_btf(c[44], b[2], -c[20], b[3]),
         _half_btf(c[36], b[4], c[28], b[5]),
         _half_btf(c[28], b[4], -c[36], b[5]),
         _half_btf(c[52], b[6], c[12], b[7]),
         _half_btf(c[12], b[6], -c[52], b[7])]
    # stage 3
    t = [s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
         s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7]]
    # stage 4
    u = [t[0], t[1], t[2], t[3],
         _half_btf(c[16], t[4], c[48], t[5]),
         _half_btf(c[48], t[4], -c[16], t[5]),
         _half_btf(-c[48], t[6], c[16], t[7]),
         _half_btf(c[16], t[6], c[48], t[7])]
    # stage 5
    v = [u[0] + u[2], u[1] + u[3], u[0] - u[2], u[1] - u[3],
         u[4] + u[6], u[5] + u[7], u[4] - u[6], u[5] - u[7]]
    # stage 6
    w = [v[0], v[1],
         _half_btf(c[32], v[2], c[32], v[3]),
         _half_btf(c[32], v[2], -c[32], v[3]),
         v[4], v[5],
         _half_btf(c[32], v[6], c[32], v[7]),
         _half_btf(c[32], v[6], -c[32], v[7])]
    # stage 7: output with sign alternation
    return [w[0], -w[4], w[6], -w[2], w[3], -w[7], w[5], -w[1]]


def iadst16(x):
    c = _COSPI
    b = [x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
         x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]]
    s = [0] * 16
    for k in range(8):
        ang = 2 + 8 * k
        s[2 * k] = _half_btf(c[ang], b[2 * k], c[64 - ang], b[2 * k + 1])
        s[2 * k + 1] = _half_btf(c[64 - ang], b[2 * k],
                                 -c[ang], b[2 * k + 1])
    t = [s[i] + s[i + 8] for i in range(8)] + \
        [s[i] - s[i + 8] for i in range(8)]
    u = list(t[:8])
    u += [_half_btf(c[8], t[8], c[56], t[9]),
          _half_btf(c[56], t[8], -c[8], t[9]),
          _half_btf(c[40], t[10], c[24], t[11]),
          _half_btf(c[24], t[10], -c[40], t[11]),
          _half_btf(-c[56], t[12], c[8], t[13]),
          _half_btf(c[8], t[12], c[56], t[13]),
          _half_btf(-c[24], t[14], c[40], t[15]),
          _half_btf(c[40], t[14], c[24], t[15])]
    v = [u[0] + u[4], u[1] + u[5], u[2] + u[6], u[3] + u[7],
         u[0] - u[4], u[1] - u[5], u[2] - u[6], u[3] - u[7],
         u[8] + u[12], u[9] + u[13], u[10] + u[14], u[11] + u[15],
         u[8] - u[12], u[9] - u[13], u[10] - u[14], u[11] - u[15]]
    w = list(v[:4])
    w += [_half_btf(c[16], v[4], c[48], v[5]),
          _half_btf(c[48], v[4], -c[16], v[5]),
          _half_btf(-c[48], v[6], c[16], v[7]),
          _half_btf(c[16], v[6], c[48], v[7])]
    w += list(v[8:12])
    w += [_half_btf(c[16], v[12], c[48], v[13]),
          _half_btf(c[48], v[12], -c[16], v[13]),
          _half_btf(-c[48], v[14], c[16], v[15]),
          _half_btf(c[16], v[14], c[48], v[15])]
    a = []
    for o in (0, 4, 8, 12):
        a += [w[o] + w[o + 2], w[o + 1] + w[o + 3],
              w[o] - w[o + 2], w[o + 1] - w[o + 3]]
    z = []
    for o in (0, 4, 8, 12):
        z += [a[o], a[o + 1],
              _half_btf(c[32], a[o + 2], c[32], a[o + 3]),
              _half_btf(c[32], a[o + 2], -c[32], a[o + 3])]
    return [z[0], -z[8], z[12], -z[4], z[6], -z[14], z[10], -z[2],
            z[3], -z[11], z[15], -z[7], z[5], -z[13], z[9], -z[1]]


# -------------------------------------------------------------- identity

def iidentity4(x):
    return [_round2(v * _NEW_SQRT2, 12) for v in x]


def iidentity8(x):
    return [v * 2 for v in x]


def iidentity16(x):
    return [_round2(v * 2 * _NEW_SQRT2, 12) for v in x]


def iidentity32(x):
    return [v * 4 for v in x]


# ---------------------------------------------------------- 2-D tables

# per-tx-size (shift_after_rows, shift_after_cols); aom
# av1_inv_txfm_shift_ls heritage, indexed by (w, h)
_SHIFTS: Dict[Tuple[int, int], Tuple[int, int]] = {
    (4, 4): (0, -4), (8, 8): (-1, -4), (16, 16): (-2, -4),
    (32, 32): (-2, -4), (64, 64): (-2, -4),
    (4, 8): (0, -4), (8, 4): (0, -4),
    (8, 16): (-1, -4), (16, 8): (-1, -4),
    (16, 32): (-1, -4), (32, 16): (-1, -4),
    (32, 64): (-1, -4), (64, 32): (-1, -4),
    (4, 16): (-1, -4), (16, 4): (-1, -4),
    (8, 32): (-2, -4), (32, 8): (-2, -4),
    (16, 64): (-2, -4), (64, 16): (-2, -4),
}

_DCT = {4: idct4, 8: idct8, 16: idct16, 32: idct32, 64: idct64}
_ADST = {4: iadst4, 8: iadst8, 16: iadst16}
_IDTX = {4: iidentity4, 8: iidentity8, 16: iidentity16, 32: iidentity32}

# tx_type → (vertical kind, horizontal kind, ud_flip, lr_flip);
# kinds: 'D' dct, 'A' adst, 'I' identity
_TX1D = {
    T.DCT_DCT: ('D', 'D', 0, 0),
    T.ADST_DCT: ('A', 'D', 0, 0),
    T.DCT_ADST: ('D', 'A', 0, 0),
    T.ADST_ADST: ('A', 'A', 0, 0),
    T.FLIPADST_DCT: ('A', 'D', 1, 0),
    T.DCT_FLIPADST: ('D', 'A', 0, 1),
    T.FLIPADST_FLIPADST: ('A', 'A', 1, 1),
    T.ADST_FLIPADST: ('A', 'A', 0, 1),
    T.FLIPADST_ADST: ('A', 'A', 1, 0),
    T.IDTX: ('I', 'I', 0, 0),
    T.V_DCT: ('D', 'I', 0, 0),
    T.H_DCT: ('I', 'D', 0, 0),
    T.V_ADST: ('A', 'I', 0, 0),
    T.H_ADST: ('I', 'A', 0, 0),
    T.V_FLIPADST: ('A', 'I', 1, 0),
    T.H_FLIPADST: ('I', 'A', 0, 1),
}


def _txfm1d(kind: str, size: int):
    if kind == 'D':
        return _DCT[size]
    if kind == 'A':
        return _ADST[size]
    return _IDTX[size]
