"""AVC sequences of the PyTorch port against the JAX package and
libavcodec, on the CPU: the CAVLC streams and the randomized sweep (the
CABAC cases are in test_torch_avc_inter.py).

The committed QCIF CAVLC IPPP stream (libheif_tpu_torch/testdata/avc/)
against the JAX decoder and the manifest, all of it through the Python
engine; the cases of tests/test_avc_cavlc.py::test_cavlc_ippp and
tests/test_avc_inter.py::test_randomized_p_sweep on x264 streams made
here, every frame of the port's ``AvcSequenceDecoder`` equal to the JAX
package's and libavcodec's.
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu_torch.core import trace  # noqa: E402
from tests import avc_oracle, avc_streams as S, jax_native  # noqa: E402

pytestmark = pytest.mark.skipif(not avc_oracle.available(),
                                reason="libavcodec oracle not available")


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """Load the JAX package's native library as the other AVC tests do
    (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def test_committed_qcif_sequence():
    """The committed QCIF 6-frame CAVLC IPPP stream (the card's track)."""
    S.check_committed_sequence(S.QCIF)


CAVLC_SEQ_CASES = [
    ("default", 96, 128, dict(qp=26, extra_params="cabac=0")),
    ("qp38", 96, 128, dict(qp=38, extra_params="cabac=0")),
    ("qp12", 64, 96, dict(qp=12, extra_params="cabac=0")),
    ("multiref", 96, 128, dict(qp=28, extra_params="cabac=0:ref=3")),
    ("subme7", 96, 128,
     dict(qp=24, extra_params="cabac=0:subme=7:me=umh")),
    ("p4x4", 96, 128, dict(qp=30, extra_params="cabac=0:partitions=all")),
    ("tx8", 96, 128, dict(qp=26, extra_params="cabac=0:8x8dct=1")),
    ("odd-100x52", 52, 100, dict(qp=28, extra_params="cabac=0")),
]


def _cavlc_seq_frames(h, w, n, rng):
    """tests/test_avc_cavlc.py _seq_frames."""
    big = np.kron(rng.integers(0, 256, (h // 8 + 8, w // 8 + 8)),
                  np.ones((8, 8))).astype(np.int64)
    big = np.clip(big + rng.integers(-10, 10, big.shape), 0, 255)
    frames = []
    for i in range(n):
        y = big[i:i + h, 2 * i:2 * i + w].astype(np.uint8)
        u = np.clip(big[i // 2:i // 2 + (h + 1) // 2,
                        i:i + (w + 1) // 2] + 5, 0, 255).astype(np.uint8)
        v = np.clip(big[i // 2 + 3:i // 2 + 3 + (h + 1) // 2,
                        i + 2:i + 2 + (w + 1) // 2], 0,
                    255).astype(np.uint8)
        frames.append((y, u, v))
    return frames


@pytest.mark.parametrize("name,h,w,kw", CAVLC_SEQ_CASES,
                         ids=[c[0] for c in CAVLC_SEQ_CASES])
def test_cavlc_ippp(name, h, w, kw):
    """tests/test_avc_cavlc.py::test_cavlc_ippp (all Python)."""
    frames = _cavlc_seq_frames(h, w, 5, np.random.default_rng(4))
    stream = avc_oracle.encode_seq(frames, gop=250, **kw)
    with trace.collect() as spans:
        assert len(S.sequence_three_way(stream, name)) == 5
    assert "avc.decode.native" not in spans


def test_randomized_p_sweep():
    """tests/test_avc_inter.py::test_randomized_p_sweep: tools, QPs,
    partitions and reference counts drawn from one seed."""
    rng = np.random.default_rng(42)
    part_sets = ["partitions=i4x4", "partitions=p8x8,i4x4",
                 "partitions=all", ""]
    for trial in range(6):
        qp = int(rng.integers(18, 42))
        noise = int(rng.integers(2, 12))
        extra = ":".join(x for x in
                         [part_sets[trial % len(part_sets)],
                          "me=dia:subme=2", f"ref={1 + trial % 3}",
                          f"8x8dct={trial % 2}", "trellis=0"] if x)
        frames = S.panned_frames(500 + trial, 80, 48, 4, noise=noise)
        stream = avc_oracle.encode_seq(frames, qp=qp, extra_params=extra)
        S.sequence_three_way(stream, f"trial {trial}")
