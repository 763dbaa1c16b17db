"""The port's HEVC sequence encoder against the JAX one, on the CPU.

The same frames, made with numpy from a seed, go through the JAX
``SequenceEncoder`` and the port's (``device="cpu"``): every NAL must be
byte for byte the JAX encoder's, with the same sync flags and
composition offsets, and after every frame the port's DPB (decoded by
its own SequenceDecoder, the closed loop it runs on the card) must hold
the JAX encoder's reference pictures, sample for sample.  The cases are
the 15 of tests/test_hevc_inter.py and the four GOP structures of
tests/test_hevc_bframes.py, then two references, the session's IDR
refresh and the refusals.  At 10 bits the JAX encoder's host
reconstruction runs its MC at 8 bits and differs from what its own
decoder makes of its stream (ROADMAP §3 D): there the port keeps the
JAX bytes as far as they depend on decoded pictures alone, and its DPB
equals the JAX decoder's decode of its NALs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libheif_tpu.codecs.hevc.decoder import SequenceDecoder as JSeqDecoder
from libheif_tpu.codecs.hevc.encoder import (
    EncParams as JEncParams, HevcSequenceEncodeSession as JSession)
from libheif_tpu.codecs.hevc.inter_enc import SequenceEncoder as JSeqEncoder
from libheif_tpu.image.pixel_image import (PixelImage as JImage,
                                           Channel as JChannel,
                                           Colorspace as JColorspace,
                                           Chroma as JChroma)
from libheif_tpu_torch.codecs.hevc import inter_enc
from libheif_tpu_torch.codecs.hevc.encoder import (
    EncParams, HevcEncoder, HevcSequenceEncodeSession)
from libheif_tpu_torch.codecs.hevc.inter_cases import panning_scene
from libheif_tpu_torch.core import trace
from libheif_tpu_torch.core.error import HeifError, ErrorCode
from libheif_tpu_torch.image.pixel_image import (Colorspace, Chroma,
                                                 from_numpy_planes)
from tests.test_hevc_inter import CASES as INTER_CASES


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    # the JAX native HEVC engine's pipeline is not safe under load
    # (ROADMAP §3); one torch thread a process under xdist
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inter_frames(W, H, moves, noise, kind="photo", seed=5):
    """tests/test_hevc_inter.py's frames (its _run_case), as numpy
    planes: frame i is the window at moves[i] of a seeded canvas, its
    luma with noise after the first."""
    rng = np.random.default_rng(seed)
    if kind == "photo":
        canvas = rng.integers(0, 64, ((H * 3) // 8,
                                      (W * 3) // 8)).astype(np.float64)
        canvas = np.kron(canvas, np.ones((8, 8)))
        canvas = (canvas + np.arange(canvas.shape[1])[None, :] * 0.5) % 256
        base = canvas.astype(np.uint8)
    else:
        base = rng.integers(0, 256, (H * 3, W * 3)).astype(np.uint8)
    out = []
    for i, (dx, dy) in enumerate(moves):
        y = base[dy:dy + H, dx:dx + W].copy()
        nz = noise if i else 0
        if nz:
            y = np.clip(y.astype(int) + rng.integers(-nz, nz + 1, y.shape),
                        0, 255).astype(np.uint8)
        cb = base[dy // 2:dy // 2 + H // 2, dx // 2:dx // 2 + W // 2].copy()
        cr = base[dy // 2 + 7:dy // 2 + 7 + H // 2,
                  dx // 2 + 3:dx // 2 + 3 + W // 2].copy()
        out.append((y, cb, cr))
    return out


def bframe_frames(seed, w, h, n, noise=0):
    """tests/test_hevc_bframes.py's _frames, as numpy planes."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4 * n, w + 4 * n), np.int32)
    out = []
    for i in range(n):
        y = base[3 * i:3 * i + h, 2 * i:2 * i + w]
        if noise:
            y = y + rng.integers(-noise, noise + 1, y.shape)
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    np.clip(base[i:i + h // 2, i:i + w // 2] // 2 + 60,
                            0, 255).astype(np.uint8),
                    np.full((h // 2, w // 2), 128 + 5 * i, np.uint8)))
    return out


def jax_image(planes, bits=8):
    h, w = planes[0].shape
    img = JImage(w, h, JColorspace.YCbCr, JChroma.C420)
    for ch, a in zip((JChannel.Y, JChannel.Cb, JChannel.Cr), planes):
        img.set_plane(ch, a, bits)
    return img


def port_image(planes, bits=8):
    return from_numpy_planes(dict(zip(("Y", "Cb", "Cr"), planes)),
                             {"Y": bits, "Cb": bits, "Cr": bits},
                             Colorspace.YCbCr, Chroma.C420, device="cpu")


def assert_same_dpb(jenc, penc, what):
    assert [p for p, _ in penc.dpb] == [p for p, _ in jenc.dpb], what
    for (poc, jp), (_, pp) in zip(jenc.dpb, penc.dpb):
        for name, a, b in zip(("Y", "Cb", "Cr"), jp, pp):
            a = np.asarray(a)
            assert b.dtype == np.int32 and b.shape == a.shape
            n = int((a != b).sum())
            assert n == 0, f"{what}: POC {poc} {name}: {n} samples differ"


def run_both(frames, W, H, gop, bits=8, push=True, **kw):
    """Both encoders over ``frames``: the samples of each (decode order),
    with the DPBs held equal after every frame."""
    search = kw.pop("search", 4)
    frac = kw.pop("frac", True)
    n_refs = kw.pop("n_refs", 1)
    jenc = JSeqEncoder(W, H, JEncParams(bit_depth=bits, **kw),
                       search=search, frac=frac, gop_struct=gop,
                       n_refs=n_refs)
    penc = inter_enc.SequenceEncoder(W, H, EncParams(bit_depth=bits, **kw),
                                     search=search, frac=frac,
                                     gop_struct=gop, n_refs=n_refs,
                                     device="cpu")
    js, ps = [], []
    for i, f in enumerate(frames):
        if push:
            js += jenc.push_frame(jax_image(f, bits))
            ps += penc.push_frame(port_image(f, bits))
        else:
            js.append(jenc.encode_frame(jax_image(f, bits))[0])
            ps.append(penc.encode_frame(port_image(f, bits))[0])
        if bits == 8:
            assert_same_dpb(jenc, penc, f"frame {i}")
    if push:
        js += jenc.flush()
        ps += penc.flush()
    assert penc.config_nals == jenc.config_nals
    return jenc, penc, js, ps


def assert_same_samples(js, ps):
    assert len(ps) == len(js)
    for k, (a, b) in enumerate(zip(js, ps)):
        assert (b.data, b.is_sync, b.cts_offset) == \
            (a.data, a.is_sync, a.cts_offset), f"sample {k}"


@pytest.mark.parametrize("name,kw", INTER_CASES,
                         ids=[c[0] for c in INTER_CASES])
def test_inter_cases_match_jax(name, kw):
    """tests/test_hevc_inter.py's cases: the same NALs (encode_frame for
    "ipp", push_frame and flush otherwise, as that test drives them) and
    the same DPB after every frame."""
    kw = dict(kw)
    W, H = kw.pop("W"), kw.pop("H")
    frames = inter_frames(W, H, kw.pop("moves"), kw.pop("noise"),
                          kw.pop("kind", "photo"))
    gop = kw.pop("gop", "ipp")
    tmvp = kw.pop("tmvp", False)
    enc_kw = dict(qp=kw.pop("qp"), deblock=kw.pop("deblock"),
                  ctb_log2=kw.pop("ctb_log2", 5),
                  cu_log2=kw.pop("cu_log2", 4), temporal_mvp=tmvp,
                  search=kw.pop("search", 3), frac=kw.pop("frac", True))
    assert not kw
    push = gop != "ipp"
    _, _, js, ps = run_both(frames, W, H, gop, push=push, **enc_kw)
    if push:
        assert_same_samples(js, ps)
    else:
        assert ps == js


@pytest.mark.parametrize("gop,n,seed,noise,qp", [
    ("ipp", 5, 11, 6, 30), ("ldb", 5, 11, 6, 30),
    ("ibp", 6, 23, 4, 22), ("bpyr", 9, 19, 5, 30)])
def test_gop_structures_match_jax(gop, n, seed, noise, qp):
    """tests/test_hevc_bframes.py's streams of each GOP structure: the
    same samples (sync flags, composition offsets) and DPBs."""
    frames = bframe_frames(seed, 96, 64, n, noise)
    _, penc, js, ps = run_both(frames, 96, 64, gop, qp=qp, deblock=True)
    assert_same_samples(js, ps)
    assert [s.is_sync for s in ps] == [True] + [False] * (n - 1)
    if gop == "bpyr":
        assert [s.cts_offset for s in ps] == [0, 3, 0, -2, -1, 3, 0, -2, -1]
        # the closed loop decoded the IDR, both Ps and both kept Bs
        assert sorted(penc.decoder.dpb.slot) == [0, 2, 4, 6, 8]


def test_two_references_match_jax():
    """n_refs=2: P frames over the last two pictures (RPS of two
    negative pictures, ref_idx coding), TMVP off and on."""
    frames = bframe_frames(77, 96, 64, 6, noise=4)
    for tmvp in (False, True):
        jenc, penc, js, ps = run_both(frames, 96, 64, "ipp", qp=30,
                                      deblock=True, n_refs=2,
                                      temporal_mvp=tmvp)
        assert_same_samples(js, ps)


def test_ten_bit_stream_and_dpb():
    """10 bits: the IDR and the first P are the JAX encoder's NALs (the
    first P predicts from the decoded IDR alone); every DPB picture is
    what the JAX decoder makes of the port's NALs.  The JAX encoder's own
    DPB differs there (its 8-bit host MC, ROADMAP §3 D), so its later
    NALs do too."""
    W, H = 64, 64
    rng = np.random.default_rng(4)
    base = rng.integers(0, 1024, (H + 16, W + 16)).astype(np.uint16)
    frames = [(base[i:i + H, i:i + W].copy(),
               base[:H // 2, i:i + W // 2].copy(),
               base[i:i + H // 2, :W // 2].copy()) for i in range(4)]
    jenc, penc, js, ps = run_both(frames, W, H, "ipp", bits=10, qp=30,
                                  deblock=True)
    assert [s.data for s in ps[:2]] == [s.data for s in js[:2]]
    dec = JSeqDecoder(jenc.sps, jenc.pps)
    decoded = {}
    for s in ps:
        poc, planes = dec.decode_nal(s.data)
        decoded[poc] = [np.asarray(p) for p in planes]
    for poc, planes in penc.dpb:
        for a, b in zip(decoded[poc], planes):
            np.testing.assert_array_equal(b, a.astype(np.int32))
        assert max(int(p.max()) for p in planes) > 255


def test_session_idr_refresh_matches_jax():
    """HevcSequenceEncodeSession(gop=4) over 9 ipp frames: an IDR every
    4 frames (two refreshes after the first), the same samples and
    hvcC as the JAX session; the spans split its wall."""
    frames = [tuple(p[:64, :64] for p in f)
              for f in panning_scene(64, 64, 9, seed=3)]
    js = JSession(64, 64, qp=30, gop=4)
    ps = HevcSequenceEncodeSession(64, 64, qp=30, gop=4, device="cpu")
    with trace.collect() as spans:
        got = [ps.encode_frame(port_image(f)) for f in frames]
    want = [js.encode_frame(jax_image(f)) for f in frames]
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[2] for g in got] == [w[2] for w in want] == \
        [True, False, False, False] * 2 + [True]
    assert [g[1] is None for g in got] == [w[1] is None for w in want]
    assert got[0][1].serialize() == want[0][1].serialize()
    assert spans["hevc.encode.seq"]["count"] == 9
    assert spans["hevc.encode.seq.loop"]["count"] == 6
    assert spans["hevc.encode.seq.recon"]["count"] == 9


def test_registry_session_reorders():
    """HevcEncoder.start_sequence_encode: quality 50 gives qp 26; a bpyr
    session's push_frames and flush_frames give the JAX session's
    samples."""
    from libheif_tpu.codecs.hevc.encoder import HevcEncoder as JHevcEncoder
    frames = panning_scene(64, 64, 6, seed=8)
    js = JHevcEncoder().start_sequence_encode(64, 64, None,
                                              gop_struct="bpyr")
    ps = HevcEncoder().start_sequence_encode(64, 64, None,
                                             gop_struct="bpyr",
                                             device="cpu")
    assert ps.params.qp == js.params.qp == 26
    want = [s for f in frames for s in js.push_frames(jax_image(f))]
    got = [s for f in frames for s in ps.push_frames(port_image(f))]
    want += js.flush_frames()
    got += ps.flush_frames()
    assert [(d, s, c) for d, _, s, c in got] == \
        [(d, s, c) for d, _, s, c in want]


def test_sao_refused_by_name():
    with pytest.raises(HeifError) as e:
        inter_enc.SequenceEncoder(64, 64, EncParams(sao=True), device="cpu")
    assert e.value.code == ErrorCode.Unsupported_feature
    assert "SAO" in str(e.value)
