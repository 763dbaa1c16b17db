"""The port's VVC optional intra tools against the JAX package's on the
CPU: the cases of tests/test_vvc_tools.py (MIP, ISP and LFNST forced over
a content/size/QP matrix, all tools on auto, all forced on mixed
content, the SPS tool flags), each through both encoders and both
decoders on the same planes, the NAL bytes equal, every plane bit-exact
and each tool used as often as by the JAX encoder; and the tables of
codecs/vvc/tables.py equal to the JAX package's, entry for entry (the
CABAC initialisation values are the codec pair's own, not H.266's: the
port keeps them for parity)."""

import numpy as np
import pytest

try:
    from . import vvc_streams as S
except ImportError:                       # run as a script
    import vvc_streams as S

CASES = [(96, 64, 1, "waves"), (64, 96, 2, "edges"),
         (128, 80, 3, "waves")]


def _roundtrip(params, w, h, seed, kind="waves"):
    penc, _, nals = S.both_ways(S.tool_planes(w, h, seed, kind), params)
    return penc.tool_counts, nals


@pytest.mark.parametrize("w,h,seed,kind", CASES)
def test_mip_roundtrip(w, h, seed, kind):
    counts, _ = _roundtrip(dict(qp=30, mip="force", isp="off",
                                lfnst="off"), w, h, seed, kind)
    assert counts["mip"] > 0


@pytest.mark.parametrize("w,h,seed,kind", CASES)
def test_isp_roundtrip(w, h, seed, kind):
    counts, _ = _roundtrip(dict(qp=34, mip="off", isp="force",
                                lfnst="off", split_thresh=50.0,
                                mtt_depth=0), w, h, seed, kind)
    assert counts["isp"] > 0


@pytest.mark.parametrize("w,h,seed,kind", CASES)
def test_lfnst_roundtrip(w, h, seed, kind):
    counts, _ = _roundtrip(dict(qp=30, mip="off", isp="off",
                                lfnst="force"), w, h, seed, kind)
    assert counts["lfnst"] > 0


@pytest.mark.parametrize("qp", [22, 30, 40])
def test_all_tools_auto(qp):
    _roundtrip(dict(qp=qp, mip="auto", isp="auto", lfnst="auto"),
               96, 96, 7, "waves")


def test_all_tools_force_mixed_content():
    counts, nals = _roundtrip(dict(qp=34, mip="force", isp="force",
                                   lfnst="force", split_thresh=50.0,
                                   mtt_depth=0), 96, 64, 5, "edges")
    assert sum(counts.values()) > 0
    assert S.nal_stream(nals) == S.nal_stream(S.stream_nals("tools-mixed"))


def test_sps_flags_roundtrip():
    from libheif_tpu.codecs.vvc import headers as JH
    from libheif_tpu_torch.codecs.vvc import headers as H
    sps_nal = H.write_sps(H.SPS(pic_width=64, pic_height=64,
                                mip_enabled=True, isp_enabled=True,
                                lfnst_enabled=True))
    assert sps_nal == JH.write_sps(JH.SPS(pic_width=64, pic_height=64,
                                          mip_enabled=True,
                                          isp_enabled=True,
                                          lfnst_enabled=True))
    sps = H.parse_sps(sps_nal)
    assert sps.mip_enabled and sps.isp_enabled and sps.lfnst_enabled


def _same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)) and not (
            a and isinstance(a[0], (int, float, np.integer))):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif callable(a):
        pass
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), where


def test_tables_equal_the_jax_tables():
    """Every public value of codecs/vvc/tables.py, the CABAC contexts and
    their layout among them, equals the JAX package's."""
    import types
    from libheif_tpu.codecs.vvc import tables as JT
    from libheif_tpu_torch.codecs.vvc import tables as T
    names = [n for n in vars(JT) if not n.startswith("_")
             and not isinstance(getattr(JT, n), types.ModuleType)
             and n not in ("annotations", "Dict", "List", "Tuple")]
    assert names and set(names) <= set(vars(T))
    for n in names:
        _same(getattr(T, n), getattr(JT, n), n)
    assert T.ctx_layout() == JT.ctx_layout()
    sizes = [(lw, lh) for lw in range(2, 6) for lh in range(2, 6)]
    for m in range(67):
        assert T.lfnst_set_of_mode(m) == JT.lfnst_set_of_mode(m)
        for lw, lh in sizes:
            assert T.map_wide_angle(m, lw, lh) == \
                JT.map_wide_angle(m, lw, lh)
    for lw, lh in sizes:
        assert T.mip_size_id(lw, lh) == JT.mip_size_id(lw, lh)
    for a in range(-512, 513):
        if a:
            assert T.inv_angle(a) == JT.inv_angle(a)
    for c in (0, 1):
        for d in range(8):
            for k in range(8):
                assert T.sig_ctx(c, d, k) == JT.sig_ctx(c, d, k)
                assert T.gtx_par_ctx(c, d, k) == JT.gtx_par_ctx(c, d, k)
        for lg in range(2, 6):
            for b in range(10):
                assert T.last_prefix_ctx(bool(c), lg, b) == \
                    JT.last_prefix_ctx(bool(c), lg, b)
    for v in range(64):
        assert T.rice_param(v) == JT.rice_param(v)
    for start in range(-26, 10, 5):
        assert T.build_chroma_qp_table(start) == \
            JT.build_chroma_qp_table(start)
