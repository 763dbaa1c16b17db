"""AVC still decode of the PyTorch port against the JAX package and
libavcodec, on the CPU.

The committed streams (libheif_tpu_torch/testdata/avc/, made by
tests/avc_streams.py; ``python -m tests.test_torch_avc_decode
--write-fixtures`` writes them again) and streams x264 makes here at run
time go through the port's ``decode_intra_frame`` and the JAX package's
(its C++ engine loaded, tests/jax_native.py); every plane is compared
exactly, with libavcodec's decode (tests/avc_oracle.py) and the
manifest's hashes.  Also: the cases of tests/test_avc_native.py,
test_avc_cavlc.py::test_cavlc_intra and test_avc_conformance.py; the
port's two engines against each other on every CABAC still (the three
largest in test_torch_avc_engines*.py); the route by syntax, read from
the ``avc.decode.*`` spans; corrupt streams; avcC round trips; the
decoder's PixelImages and device rule.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.codec_cfg import Box_avcC as JBox_avcC  # noqa: E402
from libheif_tpu.codecs.avc import decoder as jdec  # noqa: E402
from libheif_tpu.core.bitstream import ByteReader as JByteReader  # noqa: E402
from libheif_tpu.boxes.box import read_box as jread_box  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu.core.limits import SecurityLimits as JLimits  # noqa: E402
from libheif_tpu_torch._build import AVC_HOST_LIBRARY  # noqa: E402
from libheif_tpu_torch.boxes.box import read_box  # noqa: E402
from libheif_tpu_torch.boxes.codec_cfg import Box_avcC  # noqa: E402
from libheif_tpu_torch.codecs.avc import AvcDecoder  # noqa: E402
from libheif_tpu_torch.codecs.avc import decoder as pdec  # noqa: E402
from libheif_tpu_torch.codecs.avc import headers as PH  # noqa: E402
from libheif_tpu_torch.codecs.host_copy import device_planes  # noqa: E402
from libheif_tpu_torch.core import trace  # noqa: E402
from libheif_tpu_torch.core.bitstream import ByteReader  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.core.limits import SecurityLimits  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    Channel, Chroma, Colorspace)
from tests import avc_oracle, avc_streams as S, jax_native  # noqa: E402
from tests.avc_difftest import DECODE_CONFIGS, make_planes  # noqa: E402

needs_oracle = pytest.mark.skipif(not avc_oracle.available(),
                                  reason="libavcodec oracle not available")
SC = b"\x00\x00\x00\x01"
STILLS = list(S.STILLS)
CABAC_STILLS = [n for n in STILLS if S.STILLS[n][3].get("cabac", True)]


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX package's C++ AVC engine is the oracle's twin here: load it
    first (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def assert_same(mine, ref, what=""):
    assert sorted(mine) == sorted(ref), what
    for k in ref:
        assert mine[k].dtype == np.uint8, (what, k)
        np.testing.assert_array_equal(mine[k], np.asarray(ref[k], np.uint8),
                                      err_msg=f"{what} {k}")


def n_slices(stream):
    return sum(PH.nal_type(n) in (PH.NAL_SLICE_IDR, PH.NAL_SLICE_NON_IDR)
               for n in PH.split_annexb(stream))


def first_slice_deblocks(stream) -> bool:
    """Whether the first slice header leaves the deblocking filter on."""
    sps, pps = {}, {}
    for n in PH.split_annexb(stream):
        t = PH.nal_type(n)
        if t == PH.NAL_SPS:
            s = PH.parse_sps(n)
            sps[s.seq_parameter_set_id] = s
        elif t == PH.NAL_PPS:
            p = PH.parse_pps(n, sps)
            pps[p.pic_parameter_set_id] = p
        elif t in (PH.NAL_SLICE_IDR, PH.NAL_SLICE_NON_IDR):
            return PH.parse_slice_header(n, sps, pps)[0] \
                .disable_deblocking_filter_idc != 1


# ------------------------------------------------------ committed streams

@needs_oracle
@pytest.mark.parametrize("name", STILLS + list(S.SEQUENCES))
def test_manifest_is_libavcodecs(name):
    """Every committed stream decodes in libavcodec to the manifest's
    hashes."""
    e = S.entries()[name]
    stream = S.data(name)
    if e["kind"] == "still":
        got = S.plane_hashes(S.still_reference(name, stream))
    else:
        got = [S.plane_hashes(f) for f in avc_oracle.decode_seq(stream)]
    assert got == e["sha256"]


@pytest.mark.parametrize("name", STILLS)
def test_still_matches_jax_and_manifest(name):
    """The port's planes equal the JAX package's and the manifest's, and
    the engine was chosen by the PPS: C++ for CABAC (a call a slice),
    Python for CAVLC."""
    stream = S.data(name)
    with trace.collect() as spans:
        mine = pdec.decode_annexb(stream)
    assert_same(mine, jdec.decode_annexb(stream), name)
    assert S.plane_hashes(mine) == S.entries()[name]["sha256"]
    engine, other = ("native", "python") if name in CABAC_STILLS else \
        ("python", "native")
    assert spans[f"avc.decode.{engine}"]["count"] == n_slices(stream)
    assert f"avc.decode.{other}" not in spans
    assert ("avc.decode.deblock" in spans) == first_slice_deblocks(stream)
    if "no-deblock" in S.STILLS[name][3].get("extra_params", ""):
        assert "avc.decode.deblock" not in spans


@pytest.mark.parametrize(
    "name", [n for n in CABAC_STILLS if n not in S.LARGE_CABAC])
def test_engines_agree(name):
    S.assert_engines_agree(name)


# -------------------------------------- cases of the JAX package's tests

def _noise(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))


def three_way(stream, what, engines=True):
    """The port (both engines when ``engines``), the JAX package and
    libavcodec on one stream."""
    mine = pdec.decode_annexb(stream)
    assert_same(mine, jdec.decode_annexb(stream), what)
    assert_same(mine, avc_oracle.decode(stream), what)
    if engines:
        assert_same(pdec.decode_annexb(stream, python_engine=True), mine,
                    f"{what} python engine")
    return mine


@needs_oracle
@pytest.mark.parametrize("qp,tx8", [(30, False), (26, True), (40, False)])
def test_native_matches_python(qp, tx8):
    """tests/test_avc_native.py::test_native_matches_python."""
    y, u, v = _noise(80, 96, qp)
    three_way(avc_oracle.encode(y, u, v, qp=qp, cabac=True, tx8=tx8),
              f"qp{qp}")


@needs_oracle
def test_native_pcm_and_multi_slice():
    """tests/test_avc_native.py::test_native_pcm_blocks and
    ::test_native_multi_slice: qp 0 noise (I_PCM macroblocks) and
    slices=3 (the C++ state arrays persist across three calls)."""
    y, u, v = _noise(48, 64, 9)
    three_way(avc_oracle.encode(y, u, v, qp=0, cabac=True, tx8=False),
              "pcm")
    y, u, v = _noise(96, 64, 17)
    stream = avc_oracle.encode(y, u, v, qp=30, cabac=True, tx8=False,
                               extra_params="slices=3")
    assert n_slices(stream) == 3
    with trace.collect() as spans:
        three_way(stream, "slices=3")
    assert spans["avc.decode.native"]["count"] == 3


@needs_oracle
@pytest.mark.parametrize("cfg", DECODE_CONFIGS,
                         ids=[c[0] for c in DECODE_CONFIGS])
def test_decode_config(cfg):
    """tests/test_avc_conformance.py::test_decode_config: x264 CABAC with
    and without tx8 and deblocking, four kinds of content."""
    name, w, h, qp, tx8, deblock, kind = cfg
    y, u, v = make_planes(w, h, 7, kind)
    three_way(avc_oracle.encode(y, u, v, qp=qp, cabac=True, tx8=tx8,
                                extra_params="" if deblock else
                                "no-deblock=1"), name)


def _cavlc_content(h, w, kind, rng):
    if kind == "noise":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    return S.blocks(h, w, rng)


CAVLC_CASES = [
    ("qp26", 64, 64, "photo", 26, False, ""),
    ("qp10-noise", 96, 64, "noise", 10, False, ""),
    ("qp40", 128, 96, "photo", 40, False, ""),
    ("tx8", 96, 96, "photo", 26, True, ""),
    ("i4-only", 64, 64, "photo", 30, False, "8x8dct=0"),
    ("odd-100x52", 100, 52, "photo", 28, False, ""),
]


@needs_oracle
@pytest.mark.parametrize("name,w,h,kind,qp,tx8,xp", CAVLC_CASES,
                         ids=[c[0] for c in CAVLC_CASES])
def test_cavlc_intra(name, w, h, kind, qp, tx8, xp):
    """tests/test_avc_cavlc.py::test_cavlc_intra (CAVLC goes to Python)."""
    rng = np.random.default_rng(3)
    y = _cavlc_content(h, w, kind, rng)
    u = _cavlc_content((h + 1) // 2, (w + 1) // 2, kind, rng)
    v = _cavlc_content((h + 1) // 2, (w + 1) // 2, kind, rng)
    stream = avc_oracle.encode(y, u, v, qp=qp, cabac=False, tx8=tx8,
                               extra_params=xp)
    with trace.collect() as spans:
        three_way(stream, name, engines=False)
    assert "avc.decode.native" not in spans


def _jax_encoded(y, u, v, **kw):
    from libheif_tpu.codecs.avc.encoder import encode_frame
    sps, pps, sl, recon = encode_frame(y, u, v, **kw)
    return SC + sps + SC + pps + SC + sl, recon


@needs_oracle
def test_mono():
    """tests/test_avc_conformance.py::test_mono_roundtrip: a monochrome
    stream of the JAX encoder gives Y alone, equal to its reconstruction
    and to libavcodec's Y."""
    y = np.random.default_rng(5).integers(0, 256, (64, 80)).astype(np.uint8)
    stream, recon = _jax_encoded(y, None, None, qp=28, tx8=True,
                                 deblock=False)
    mine = pdec.decode_annexb(stream)
    assert_same(mine, jdec.decode_annexb(stream), "mono")
    assert list(mine) == ["Y"]
    np.testing.assert_array_equal(mine["Y"],
                                  recon[0][:64, :80].astype(np.uint8))
    np.testing.assert_array_equal(mine["Y"], avc_oracle.decode(stream)["Y"])


def test_odd_size_crop():
    """tests/test_avc_conformance.py::test_avc_odd_size_crop: a 70x50
    picture crops its conformance window, chroma at half offsets."""
    rng = np.random.default_rng(8)
    w, h = 70, 50
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)).astype(np.uint8)
    v = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)).astype(np.uint8)
    stream, recon = _jax_encoded(y, u, v, qp=20, deblock=False)
    mine = pdec.decode_annexb(stream)
    assert mine["Y"].shape == (h, w) and mine["U"].shape == (25, 35)
    np.testing.assert_array_equal(mine["Y"], recon[0][:h, :w])
    assert_same(mine, jdec.decode_annexb(stream), "odd")


# ----------------------------------------------------- refusals, errors

def _both_outcomes(stream):
    """('raises', (exception class name, message)) or ('planes', planes)
    of each package."""
    out = []
    for fn in (pdec.decode_annexb, jdec.decode_annexb):
        try:
            out.append(("planes", fn(stream)))
        except Exception as e:  # noqa: BLE001 -- compared between packages
            out.append(("raises", (type(e).__name__, str(e))))
    return out


@needs_oracle
@pytest.mark.parametrize("cabac", [True, False], ids=["cabac", "cavlc"])
def test_corrupt_streams_as_jax(cabac):
    """tests/test_avc_native.py::test_native_corrupt_raises_heiferror,
    both packages: cut streams and random bytes give the same planes or
    the same exception, class and message, in both; through the C++
    engine (CABAC) always a HeifError.  Where the JAX package's Python
    CAVLC engine raises IndexError on random bytes (a coefficient placed
    outside its block, libheif_tpu/codecs/avc/cavlc.py:233; ROADMAP §3 D),
    the port's raises the HeifError Invalid_input that the contract asks
    for."""
    y, u, v = _noise(48, 64, 3)
    stream = avc_oracle.encode(y, u, v, qp=28, cabac=cabac, tx8=False)
    cases = [stream[:len(stream) // 2], stream[:len(stream) - 3]]
    for seed in range(12):
        r2 = np.random.default_rng(seed)
        bad = bytearray(stream)
        for _ in range(6):
            bad[int(r2.integers(50, len(bad)))] = int(r2.integers(0, 256))
        cases.append(bytes(bad))
    raised = 0
    for i, c in enumerate(cases):
        (pk, pv), (jk, jv) = _both_outcomes(c)
        assert pk == jk, (i, pv if pk == "raises" else jv)
        if pk == "raises":
            if jv[0] == "IndexError" and not cabac:
                assert pv == ("HeifError", "Invalid_input/Unspecified: "
                              "CAVLC coefficient position out of range"), \
                    (i, pv, jv)
            else:
                assert pv == jv, i
            if cabac:
                assert pv[0] == "HeifError", (i, pv)
            raised += 1
        else:
            assert_same(pv, jv, f"case {i}")
    assert raised > 0


def test_no_slice_raises_in_both():
    """Parameter sets without a slice: invalid input in both packages."""
    y = np.zeros((16, 16), np.uint8)
    stream, _ = _jax_encoded(y, y[:8, :8], y[:8, :8], qp=30)
    head = b"".join(SC + n for n in PH.split_annexb(stream)[:2])
    for fn, err in ((pdec.decode_annexb, HeifError),
                    (jdec.decode_annexb, JHeifError)):
        with pytest.raises(err, match="no decodable AVC slice found") as e:
            fn(head)
        assert e.value.code.name == "Invalid_input"


def test_failed_engine_load_raises(monkeypatch):
    """A CABAC picture never carries on in Python when the C++ engine
    does not load; a CAVLC one does not need it."""
    def broken():
        raise RuntimeError("c++ failed")
    monkeypatch.setattr(AVC_HOST_LIBRARY, "load", broken)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        pdec.decode_annexb(S.data("odd-100x52"))
    stream = b"".join(SC + n for n in pdec.H.split_annexb(
        S.data("seq-qcif-cavlc"))[:4])
    assert pdec.decode_annexb(stream)["Y"].shape == (144, 176)


# ------------------------------------------------------------- boxes

def test_avcc_round_trips_the_jax_writers_bytes():
    """Box_avcC parses the JAX writer's bytes (two SPS, one PPS, the
    high-profile trailer, 2-byte lengths) to the same fields and writes
    them back byte for byte; the JAX parser reads the port's."""
    sps, pps, _ = S.avcc_and_samples(S.data("tile512_s0"))
    j = JBox_avcC()
    j.avc_profile, j.profile_compatibility, j.avc_level = 100, 0, 31
    j.length_size = 2
    j.sps_list = [sps[0], sps[0][:-1] + b"\x80"]
    j.pps_list = list(pps)
    j.trailing = b"\xfd\xf8\xf8\x00"
    blob = j.serialize()
    p = read_box(ByteReader(blob), SecurityLimits(), 0)
    assert isinstance(p, Box_avcC)
    for f in ("configuration_version", "avc_profile",
              "profile_compatibility", "avc_level", "length_size",
              "sps_list", "pps_list", "trailing"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.all_nals() == j.all_nals()
    assert p.serialize() == blob
    back = jread_box(JByteReader(p.serialize()), JLimits(), 0)
    assert back.serialize() == blob


# ------------------------------------------------- images and devices

def _avcc(name):
    sps, pps, samples = S.avcc_and_samples(S.data(name))
    cfg = Box_avcC()
    cfg.sps_list, cfg.pps_list = sps, pps
    return cfg, b"".join(s for s, _ in samples)


@pytest.mark.parametrize("name", ["odd-100x52", "mono-128x96"])
def test_decode_single_image(name):
    """AvcDecoder on the CPU: the item path's PixelImage, uint8 planes of
    8 bits, YCbCr 4:2:0 or Monochrome, under the avc.decode span with
    its copy (none on the CPU: the planes are the host arrays)."""
    cfg, data = _avcc(name)
    with trace.collect() as spans:
        img = AvcDecoder("cpu").decode_single_image(cfg, data)
    ref = jdec.decode_annexb(S.data(name))
    mono = name == "mono-128x96"
    assert (img.colorspace, img.chroma) == (
        (Colorspace.Monochrome, Chroma.Monochrome) if mono else
        (Colorspace.YCbCr, Chroma.C420))
    chans = [Channel.Y] if mono else [Channel.Y, Channel.Cb, Channel.Cr]
    assert img.channels() == chans
    for ch, k in zip(chans, ("Y", "U", "V")):
        p = img.plane(ch)
        assert p.dtype == torch.uint8 and p.device.type == "cpu"
        assert img.bit_depth(ch) == 8
        np.testing.assert_array_equal(p.numpy(), ref[k])
    assert (img.width, img.height) == ref["Y"].shape[::-1]
    assert spans["avc.decode"]["count"] == 1
    assert spans["avc.decode.copy"]["count"] == 1


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AvcDecoder()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AvcDecoder(None)


def test_device_planes_on_the_cpu_share_the_arrays():
    a = [np.arange(12, dtype=np.uint8).reshape(3, 4),
         np.full((1, 2), 7, np.uint8)]
    t = device_planes(a, "cpu")
    assert [tuple(x.shape) for x in t] == [(3, 4), (1, 2)]
    a[0][0, 0] = 99
    assert int(t[0][0, 0]) == 99          # no copy on the CPU


def test_unsupported_refused_by_name():
    """Chroma other than 4:2:0 or monochrome: Unsupported in both
    packages (an SPS of chroma_format_idc 2, high 4:2:2 profile)."""
    y = np.zeros((16, 16), np.uint8)
    stream, _ = _jax_encoded(y, y[:8, :8], y[:8, :8], qp=30)
    nals = PH.split_annexb(stream)
    sps = PH.parse_sps(nals[0])
    assert sps.chroma_format_idc == 1
    bad = _sps_with_chroma_422(nals[0])
    assert PH.parse_sps(bad).chroma_format_idc == 2
    stream = b"".join(SC + n for n in [bad] + nals[1:])
    for fn, err in ((pdec.decode_annexb, HeifError),
                    (jdec.decode_annexb, JHeifError)):
        with pytest.raises(err, match="only 8-bit 4:2:0/monochrome") as e:
            fn(stream)
        assert e.value.subcode.name == SubError.Unsupported_bit_depth.name


def _sps_with_chroma_422(sps_nal: bytes) -> bytes:
    """The SPS rewritten as profile 122 (high 4:2:2) with chroma 2 and the
    rest of its fields as they were."""
    from libheif_tpu_torch.core.bitstream import BitReader
    rbsp = PH.unescape_rbsp(sps_nal[1:])
    br = BitReader(rbsp)
    profile = br.read_bits(8)
    rest = [br.read_bits(8), br.read_bits(8)]
    sps_id = br.read_ue()
    bits = []

    def put(v, n):
        bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def ue(v):
        v += 1
        n = v.bit_length()
        put(0, n - 1)
        put(v, n)
    put(122, 8)
    put(rest[0], 8)
    put(rest[1], 8)
    ue(sps_id)
    high = profile in (100, 110, 122, 244, 44, 83, 86, 118, 128)
    if high:
        br.read_ue()                      # chroma_format_idc
        ue(2)
    else:
        ue(2)
        ue(0)                             # bit_depth_luma_minus8
        ue(0)                             # bit_depth_chroma_minus8
        put(0, 1)                         # qpprime_y_zero_transform_bypass
        put(0, 1)                         # seq_scaling_matrix_present
    while br.bits_remaining() > 0:
        put(br.read_bits(1), 1)
    while bits and bits[-1] == 0:
        bits.pop()
    while len(bits) % 8:
        bits.append(0)
    raw = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                for i in range(0, len(bits), 8))
    out = bytearray()
    zeros = 0
    for b in raw:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return sps_nal[:1] + bytes(out)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        S.write_fixtures([a for a in sys.argv[1:] if not a.startswith("-")]
                         or None)
