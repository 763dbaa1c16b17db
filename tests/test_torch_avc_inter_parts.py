"""AVC sequences of the PyTorch port against the JAX package and
libavcodec, on the CPU: the cases of tests/test_avc_inter.py::
test_x264_ippp_bitexact (x264 CABAC IPPP streams over partitions, motion
search, reference counts, deblocking, tx8, cropped sizes and an IDR
refresh), every frame of the port's ``AvcSequenceDecoder`` equal to the
JAX package's and libavcodec's (tests/avc_oracle.py).  Their contents
are seeded by the case's name (crc32), where the JAX tests use the
process's string hash.
"""

from __future__ import annotations

import zlib

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests import avc_oracle, avc_streams as S, jax_native  # noqa: E402

pytestmark = pytest.mark.skipif(not avc_oracle.available(),
                                reason="libavcodec oracle not available")

BASE = "partitions=i4x4:me=dia:subme=1:trellis=0"


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """Load the JAX package's native library as the other AVC tests do
    (tests/jax_native.py)."""
    jax_native.ensure_loaded()


IPPP_CASES = [
    ("nodeblock", (96, 64), 4, 28, 250, BASE + ":no-deblock=1"),
    ("deblock", (96, 64), 4, 28, 250, BASE),
    ("subme5", (96, 64), 5, 26, 250,
     "partitions=i4x4:me=hex:subme=5:trellis=0"),
    ("qp40", (96, 64), 4, 40, 250, BASE),
    ("gop2-idr-refresh", (96, 64), 6, 28, 2, BASE),
    ("cropped-dims", (100, 52), 4, 24, 250, BASE),
    ("two-refs", (96, 64), 5, 28, 250, BASE + ":ref=2"),
    ("p8x8-subparts", (96, 64), 5, 26, 250,
     "partitions=p8x8,i4x4:me=hex:subme=5:trellis=0"),
    ("p4x4-subparts", (96, 64), 5, 26, 250,
     "partitions=p8x8,p4x4,i4x4:me=hex:subme=6:trellis=0"),
    ("all-parts-umh", (96, 64), 6, 24, 250,
     "partitions=all:me=umh:subme=7:trellis=0"),
    ("x264-defaults", (112, 80), 6, 26, 250, ""),
    ("inter-tx8", (96, 64), 5, 26, 250,
     "partitions=p8x8,i4x4:8x8dct=1:me=hex:subme=5"),
]


@pytest.mark.parametrize("name,dims,n,qp,gop,extra", IPPP_CASES,
                         ids=[c[0] for c in IPPP_CASES])
def test_x264_ippp_bitexact(name, dims, n, qp, gop, extra):
    """tests/test_avc_inter.py::test_x264_ippp_bitexact (CABAC)."""
    W, Hh = dims
    frames = S.panned_frames(zlib.crc32(name.encode()) % 1000, W, Hh, n)
    stream = avc_oracle.encode_seq(frames, qp=qp, gop=gop,
                                   extra_params=extra)
    assert len(S.sequence_three_way(stream, name)) == n
