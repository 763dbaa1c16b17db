"""The port's VVC codec against the JAX package's on the CPU: the MTT
cases of tests/test_vvc_codec.py (TestMttPartitioning: binary and
ternary splits in both directions, mixed content at depth 2, the QT-only
stream and dense detail), each through both encoders and both decoders
on the same planes, the NAL bytes equal, every plane bit-exact and the
split decisions the JAX encoder's (tests/vvc_streams.both_ways)."""

import pytest

try:
    from . import vvc_streams as S
except ImportError:                       # run as a script
    import vvc_streams as S


def _run(kind, mtt=2, qp=28):
    from libheif_tpu_torch.codecs.vvc import headers as H
    penc, _, nals = S.both_ways(S.mtt_planes(kind),
                                dict(qp=qp, mtt_depth=mtt))
    assert H.parse_sps(nals[0]).max_mtt_depth_intra == mtt
    return set(penc.plan.splits.values()), nals


@pytest.mark.parametrize("kind,split,stream", [
    ("left", "btv", "mtt-btv"), ("left-t", "bth", "mtt-bth"),
    ("mid", "ttv", "mtt-ttv"), ("mid-t", "tth", "mtt-tth")])
def test_binary_and_ternary(kind, split, stream):
    kinds, nals = _run(kind)
    assert split in kinds
    assert S.nal_stream(nals) == S.nal_stream(S.stream_nals(stream))


def test_mixed_content_depth2():
    _, nals = _run("mixed", mtt=2, qp=24)
    assert S.nal_stream(nals) == S.nal_stream(S.stream_nals("mtt-mixed"))


def test_qt_only_stream_still_decodes():
    kinds, _ = _run("left", mtt=0)
    assert kinds <= {"qt"}


def test_dense_detail_prefers_qt():
    kinds, _ = _run("dense", mtt=1, qp=34)
    assert kinds <= {"qt"}
