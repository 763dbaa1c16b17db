"""AVC sequences (I and P pictures) of the PyTorch port against the JAX
package and libavcodec, on the CPU: the committed CIF CABAC stream and
the refusals.

The port's ``AvcSequenceDecoder`` and the JAX package's decode the same
streams NAL by NAL; every frame's planes are compared exactly with the
JAX package's and, for the committed CIF IPPP stream
(libheif_tpu_torch/testdata/avc/), the manifest's hashes (libavcodec's).
The refusals raise the same errors in both packages.  The route: a
CABAC IDR through the C++ engine, the P pictures through Python (the
``avc.decode.*`` spans).  The cases of tests/test_avc_inter.py::
test_x264_ippp_bitexact are in test_torch_avc_inter_parts.py; the CAVLC
cases, the committed QCIF stream and the randomized sweep in
test_torch_avc_inter_sweep.py.
"""

from __future__ import annotations

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.avc.decoder import (  # noqa: E402
    AvcSequenceDecoder as JSeq)
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu_torch.codecs.avc import AvcSequenceDecoder  # noqa: E402
from libheif_tpu_torch.codecs.avc import headers as PH  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402
from tests import avc_oracle, avc_streams as S, jax_native  # noqa: E402
from tests.avc_streams import assert_frames  # noqa: E402

pytestmark = pytest.mark.skipif(not avc_oracle.available(),
                                reason="libavcodec oracle not available")


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX package's C++ AVC engine decodes its CABAC stills (not its
    sequences); load it as the other AVC tests do (tests/jax_native.py)."""
    jax_native.ensure_loaded()


# ------------------------------------------------------ committed streams

def test_committed_cif_sequence():
    """The committed CIF 9-frame CABAC IPPP stream (the card's track)."""
    S.check_committed_sequence(S.CIF)


def test_weighted_prediction_refused_as_jax():
    """tests/test_avc_inter.py::test_weighted_pred_rejected, on the
    committed fading stream whose P slices carry weight tables: both
    packages raise Unsupported naming it, after the same frames."""
    nals = PH.split_annexb(S.data("seq-weightp-96x64"))
    got = []
    for dec, err in ((AvcSequenceDecoder(), HeifError), (JSeq(), JHeifError)):
        out = []
        with pytest.raises(err, match="weighted prediction") as e:
            for nal in nals:
                f = dec.decode_nal(nal)
                if f is not None:
                    out.append(f)
        got.append((out, e.value.code.name, e.value.subcode.name))
    (mine, code, sub), (ref, jcode, jsub) = got
    assert (code, sub) == (jcode, jsub) == ("Unsupported_feature",
                                            "Unsupported_codec")
    assert len(mine) == 1
    assert_frames(mine, ref, "weighted")
    assert S.plane_hashes(mine[0]) == \
        S.entries()["seq-weightp-96x64"]["sha256"][0]


def test_multi_slice_picture_refused_as_jax():
    """A sequence picture of two slices: Unsupported in both packages (the
    C++ engine takes several slices in a still, not here)."""
    frames = S.seq_frames(S.QCIF)[:2]
    stream = avc_oracle.encode_seq(frames, qp=28, extra_params="slices=2")
    nals = PH.split_annexb(stream)
    for dec, err in ((AvcSequenceDecoder(), HeifError), (JSeq(), JHeifError)):
        with pytest.raises(err, match="multi-slice pictures"):
            dec.decode_stream(nals)
