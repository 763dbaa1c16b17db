"""The port's VVC codec against the JAX package's on the CPU: the larger
and rate cases of tests/test_vvc_codec.py (TestRoundTrip's
test_larger_image_rate_quality and test_rate_monotonic_in_qp) and its
10-bit cases (TestTenBit), each through both encoders and both decoders
on the same seeded planes, the NAL bytes equal and every plane
bit-exact (tests/vvc_streams.both_ways)."""

import numpy as np

try:
    from . import vvc_streams as S
except ImportError:                       # run as a script
    import vvc_streams as S


def test_larger_image_rate_quality():
    planes = S.make_planes(160, 128, "edges", seed=5)
    penc, _, _ = S.both_ways(planes, dict(qp=30))
    y = penc.recon.planes[0]
    mse = ((y[:128, :160].astype(np.int64) - planes[0]) ** 2).mean()
    assert 10 * np.log10(255 ** 2 / max(mse, 1e-9)) > 25


def test_rate_monotonic_in_qp():
    planes = S.make_planes(64, 64, "noise", seed=9)
    sizes = [len(S.both_ways(planes, dict(qp=qp))[2][2])
             for qp in (10, 30, 48)]
    assert sizes[0] > sizes[1] > sizes[2], sizes


def test_roundtrip_10bit():
    planes = S.ten_bit_planes(3)
    penc, _, nals = S.both_ways(planes, dict(qp=16, bit_depth=10), 10)
    from libheif_tpu_torch.codecs.vvc import headers as H
    assert H.parse_sps(nals[0]).bit_depth == 10
    assert S.nal_stream(nals) == S.nal_stream(S.stream_nals("10bit-64"))
    src = planes[0].astype(np.int64)
    yd = S.port_decode(nals)[0]
    psnr = 10 * np.log10(1023 ** 2 / max(((src - yd) ** 2).mean(), 1e-9))
    assert psnr > 40, psnr


def test_context_roundtrip_10bit():
    """TestTenBit.test_context_roundtrip_10bit: the port's file is the
    JAX writer's, and decodes to its 10-bit planes (uint16)."""
    import torch
    from libheif_tpu.context import HeifContext as JContext
    from libheif_tpu_torch import HeifContext
    w, h = 48, 40
    yy, xx = np.mgrid[0:h, 0:w]
    planes = (((xx * 13 + yy * 9) % 1024).astype(np.uint16),
              np.full((h // 2, w // 2), 512, np.uint16),
              np.full((h // 2, w // 2), 512, np.uint16))
    ctx = HeifContext(device="cpu")
    ctx.encode_image(S.port_image(planes, 10), "vvc")
    data = ctx.write()
    jctx = JContext()
    jctx.encode_image(S.jax_image(planes, 10), "vvc")
    assert data == jctx.write()
    out = HeifContext.read_from_bytes(data, device="cpu").decode_image()
    assert out.bit_depth("Y") == 10
    assert out.plane("Y").dtype == torch.uint16
    ref = JContext.read_from_bytes(data).decode_image()
    for ch in ("Y", "Cb", "Cr"):
        assert np.array_equal(out.np_plane(ch), np.asarray(ref.plane(ch)))
    src = planes[0].astype(np.int64)
    dec = out.np_plane("Y").astype(np.int64)
    psnr = 10 * np.log10(1023 ** 2 / max(((src - dec) ** 2).mean(), 1e-9))
    assert psnr > 35, psnr
