"""The islow 8x8 DCTs and the JPEG reconstruction and quantiser, in
plain PyTorch.

Counterpart of libheif_tpu/codecs/jpeg/idct.py (``idct8x8_islow``
:79-97, the IJG jidctint.c fixed-point algorithm that libjpeg uses;
``fdct8x8_islow`` :100-154, jfdctint.c), of the jnp ``_recon_program``
(libheif_tpu/codecs/jpeg/decoder.py:500-528) and of the encoder's
``_fdct_quant_program`` (codecs/jpeg/encoder.py:45-71, with ``_quantize``
:74-84).  These are the plain versions of the ``jpeg_dequant_idct`` and
``jpeg_fdct_quant`` kernels (csrc/jpeg_kernels.cu).  The inverse repeats
the jnp program's int32 arithmetic with wraparound: each product, sum and
shift is formed in int64 and wrapped to int32 at once, so 16-bit
quantisation tables, whose products overflow, give the jnp program's
samples.  The forward transform of 8-bit samples stays far inside int32
(its largest product is below 2^30), so it runs in int32 as the jnp one
does.
"""

from __future__ import annotations

import torch

from .tables import ZIGZAG

CONST_BITS = 13
PASS1_BITS = 2

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _w(x: torch.Tensor) -> torch.Tensor:
    """int64 → its int32 wraparound, kept in int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _descale(x, n):
    return _w(x + (1 << (n - 1))) >> n


def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7, descale_bits):
    """One islow IDCT butterfly over int64 vectors holding int32 values
    (jidctint.c pass body), every step wrapped to int32."""
    z1 = _w(_w(c2 + c6) * FIX_0_541196100)
    tmp2 = _w(z1 + _w(c6 * -FIX_1_847759065))
    tmp3 = _w(z1 + _w(c2 * FIX_0_765366865))
    tmp0 = _w(_w(c0 + c4) << CONST_BITS)
    tmp1 = _w(_w(c0 - c4) << CONST_BITS)
    tmp10 = _w(tmp0 + tmp3)
    tmp13 = _w(tmp0 - tmp3)
    tmp11 = _w(tmp1 + tmp2)
    tmp12 = _w(tmp1 - tmp2)
    t0, t1, t2, t3 = c7, c5, c3, c1
    z1 = _w(t0 + t3)
    z2 = _w(t1 + t2)
    z3 = _w(t0 + t2)
    z4 = _w(t1 + t3)
    z5 = _w(_w(z3 + z4) * FIX_1_175875602)
    t0 = _w(t0 * FIX_0_298631336)
    t1 = _w(t1 * FIX_2_053119869)
    t2 = _w(t2 * FIX_3_072711026)
    t3 = _w(t3 * FIX_1_501321110)
    z1 = _w(z1 * -FIX_0_899976223)
    z2 = _w(z2 * -FIX_2_562915447)
    z3 = _w(_w(z3 * -FIX_1_961570560) + z5)
    z4 = _w(_w(z4 * -FIX_0_390180644) + z5)
    t0 = _w(_w(t0 + z1) + z3)
    t1 = _w(_w(t1 + z2) + z4)
    t2 = _w(_w(t2 + z2) + z3)
    t3 = _w(_w(t3 + z1) + z4)
    return (_descale(tmp10 + t3, descale_bits),
            _descale(tmp11 + t2, descale_bits),
            _descale(tmp12 + t1, descale_bits),
            _descale(tmp13 + t0, descale_bits),
            _descale(tmp13 - t0, descale_bits),
            _descale(tmp12 - t1, descale_bits),
            _descale(tmp11 - t2, descale_bits),
            _descale(tmp10 - t3, descale_bits))


def idct8x8_islow(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) dequantised int32 coefficients → (N, 8, 8) int32 samples
    in [0, 255]: columns first, then rows, +128 and clip (the final clip
    stands in for libjpeg's range_limit table, identical on valid
    streams)."""
    b = blocks.to(torch.int64)
    r = _idct_1d(*(b[:, i, :] for i in range(8)), CONST_BITS - PASS1_BITS)
    ws = torch.stack(r, dim=1)
    r2 = _idct_1d(*(ws[:, :, i] for i in range(8)),
                  CONST_BITS + PASS1_BITS + 3)
    out = torch.stack(r2, dim=2)
    return torch.clamp(out + 128, 0, 255).to(torch.int32)


def recon_plain(coeffs: torch.Tensor, quant: torch.Tensor, blocks_h: int,
                blocks_w: int) -> torch.Tensor:
    """One component's reconstruction, the torch form of ``_recon_program``:
    zigzag int16 coefficients (blocks_h·blocks_w, 64) and the
    natural-order int32 quantisation table (64,) → the (blocks_h·8,
    blocks_w·8) uint8 plane."""
    nb = blocks_h * blocks_w
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=coeffs.device)
    q = quant.to(torch.int64)
    dq = torch.zeros((nb, 64), dtype=torch.int64, device=coeffs.device)
    dq[:, zz] = _w(coeffs.to(torch.int64) * q[zz][None, :])
    blocks = idct8x8_islow(dq.reshape(nb, 8, 8))
    plane = blocks.reshape(blocks_h, blocks_w, 8, 8).permute(0, 2, 1, 3)
    return plane.reshape(blocks_h * 8, blocks_w * 8).to(torch.uint8)


def _fdct_1d(v, first: bool):
    """One islow forward butterfly (jfdctint.c pass body) over int32
    vectors: the row pass (``first``) keeps PASS1_BITS of headroom, the
    column pass removes it."""
    i0, i1, i2, i3, i4, i5, i6, i7 = v
    tmp0, tmp7 = i0 + i7, i0 - i7
    tmp1, tmp6 = i1 + i6, i1 - i6
    tmp2, tmp5 = i2 + i5, i2 - i5
    tmp3, tmp4 = i3 + i4, i3 - i4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    if first:
        o0 = (tmp10 + tmp11) << PASS1_BITS
        o4 = (tmp10 - tmp11) << PASS1_BITS
    else:
        o0 = _descale_i32(tmp10 + tmp11, PASS1_BITS)
        o4 = _descale_i32(tmp10 - tmp11, PASS1_BITS)
    sh = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    o2 = _descale_i32(z1 + tmp13 * FIX_0_765366865, sh)
    o6 = _descale_i32(z1 + tmp12 * (-FIX_1_847759065), sh)
    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    return (o0, _descale_i32(tmp7 + z1 + z4, sh), o2,
            _descale_i32(tmp6 + z2 + z3, sh), o4,
            _descale_i32(tmp5 + z2 + z4, sh), o6,
            _descale_i32(tmp4 + z1 + z3, sh))


def _descale_i32(x, n):
    return (x + (1 << (n - 1))) >> n


def fdct8x8_islow(samples: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) level-shifted samples → (N, 8, 8) int32 DCT coefficients
    ×8 (jfdctint.c islow forward transform, batched): rows first, then
    columns."""
    b = samples.to(torch.int32)
    r1 = _fdct_1d([b[:, :, i] for i in range(8)], first=True)
    ws = torch.stack(r1, dim=2)
    r2 = _fdct_1d([ws[:, i, :] for i in range(8)], first=False)
    return torch.stack(r2, dim=1)


def fdct_quant_plain(blocks: torch.Tensor,
                     quant: torch.Tensor) -> torch.Tensor:
    """The torch form of ``_fdct_quant_program``: (N, 8, 8) level-shifted
    int32 samples and a natural-order (64,) or (8, 8) quantisation table →
    (N, 64) int16 coefficients in zigzag order, each the ×8 islow FDCT
    divided by 8·Q with rounding half away from zero."""
    coeffs = fdct8x8_islow(blocks)
    q8 = quant.to(torch.int32).reshape(1, 8, 8) * 8
    mag = torch.div(coeffs.abs() + (q8 >> 1), q8, rounding_mode="floor")
    out = torch.where(coeffs < 0, -mag, mag).reshape(-1, 64)
    zz = torch.as_tensor(ZIGZAG, dtype=torch.long, device=blocks.device)
    return out.to(torch.int16)[:, zz]
