"""The port's AVC encoder against the JAX package's, on the CPU.

The C++ slice encoder (host/avc_native.cc, ``encode_frame``) byte for
byte against the port's Python ``SliceEncoder`` and against the JAX
``encode_frame`` on the cases of tests/test_avc_enc_native.py (a qp x
transform_8x8 grid, a monochrome smooth picture, a seeded sweep of sizes
and qps); then through the context on the same calls in both packages
(planes made with numpy from a seed): ``encode_image(img, "avc")`` with
an alpha plane, ``add_visual_track(..., fmt="avc")`` with IPPP and
all-intra frames, a ``tili`` of ``avc1`` tiles.  The port's ``write()``
must give the JAX writer's bytes, and each stream decoded by the port and
by libavcodec (tests/avc_oracle.py) must equal the encoder's
reconstruction.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from libheif_tpu.codecs.avc import encoder as JE
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.core.error import HeifError as JHeifError
from libheif_tpu.image.pixel_image import PixelImage as JaxImage
from libheif_tpu.option_types import EncodingOptions as JOptions
from libheif_tpu.sequences import track as jtrack
from libheif_tpu_torch import EncodingOptions, HeifContext, TrackOptions
from libheif_tpu_torch.codecs.avc import encoder as PE
from libheif_tpu_torch.codecs.hevc.inter_cases import panning_scene
from libheif_tpu_torch.core import trace
from libheif_tpu_torch.core.error import HeifError
from libheif_tpu_torch.image.pixel_image import from_numpy_planes
from tests import avc_oracle, card_encodes, jax_native
from tests.test_torch_item_write import photo
from tests.test_torch_sequences import assert_same_image

needs_oracle = pytest.mark.skipif(not avc_oracle.available(),
                                  reason="libavcodec oracle not available")
SC = b"\x00\x00\x00\x01"
QCIF = (176, 144)
TRACK_FRAMES = 4
TRACK_SEED = 22


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX encoder's C++ engine (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def filtered_frame(y, u, v, qp, python_engine=False):
    """``encode_frame`` with its reconstruction after the in-loop filter,
    the picture a decoder shows: the C++ engine's deblocked by its
    ``loop_filter``, the Python engine's by deblock.py."""
    cls = PE.SliceEncoder if python_engine else PE._NativeSliceEncoder
    real = cls.encode_slice
    made = []

    def spy(self, *args):
        made.append(self)
        return real(self, *args)
    cls.encode_slice = spy
    try:
        sps, pps, sl, _ = PE.encode_frame(y, u, v, qp=qp,
                                          python_engine=python_engine)
    finally:
        cls.encode_slice = real
    enc, = made
    if python_engine:
        enc.last_hdr = PE.SliceHeader()
        PE.deblock_frame(enc)
    else:
        enc.loop_filter()
    return sps, pps, sl, enc.planes


def jax_image(planes, colorspace="YCbCr", chroma="420"):
    h, w = planes["Y"].shape
    img = JaxImage(w, h, colorspace, chroma)
    for ch, a in planes.items():
        img.set_plane(ch, a, 8)
    return img


def port_image(planes, colorspace="YCbCr", chroma="420"):
    return from_numpy_planes(planes, {c: 8 for c in planes}, colorspace,
                             chroma, device="cpu")


def three_ways(y, u, v, qp, tx8):
    """encode_frame in the port's C++ engine, the port's Python engine and
    the JAX package (no deblocking, as tests/test_avc_enc_native.py)."""
    return (PE.encode_frame(y, u, v, qp=qp, tx8=tx8, deblock=False),
            PE.encode_frame(y, u, v, qp=qp, tx8=tx8, deblock=False,
                            python_engine=True),
            JE.encode_frame(y, u, v, qp=qp, tx8=tx8, deblock=False))


def assert_same_frames(native, python, jax):
    assert native[:3] == python[:3] == tuple(jax[:3])
    assert len(native[3]) == len(python[3]) == len(jax[3])
    for a, b, c in zip(native[3], python[3], jax[3]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))


@pytest.mark.parametrize("qp,tx8", [(26, True), (30, False), (46, True),
                                    (12, False)])
def test_native_matches_python_and_jax(qp, tx8):
    rng = np.random.default_rng(qp)
    y = rng.integers(0, 256, (64, 80)).astype(np.uint8)
    u = rng.integers(0, 256, (32, 40)).astype(np.uint8)
    v = rng.integers(0, 256, (32, 40)).astype(np.uint8)
    assert_same_frames(*three_ways(y, u, v, qp, tx8))


def test_native_matches_python_and_jax_mono_smooth():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (4, 5))
    y = np.kron(base, np.ones((16, 16), np.int64)).astype(np.uint8)
    assert_same_frames(*three_ways(y, None, None, 28, True))


@pytest.mark.parametrize("mono", [False, True], ids=["420", "mono"])
def test_filtered_recon_native_matches_python(mono):
    """The C++ engine's reconstruction after the in-loop filter (the C++
    deblock over the encode's per-MB state) equals the Python engine's
    (deblock.py)."""
    r = np.random.default_rng(17)
    y = np.clip(np.kron(r.integers(0, 256, (3, 5)), np.ones((16, 16)))
                + r.integers(-9, 10, (48, 80)), 0, 255).astype(np.uint8)
    u = None if mono else r.integers(90, 160, (24, 40)).astype(np.uint8)
    v = None if mono else r.integers(90, 160, (24, 40)).astype(np.uint8)
    for qp in (20, 38):
        a = filtered_frame(y, u, v, qp)
        b = filtered_frame(y, u, v, qp, python_engine=True)
        c = PE.encode_frame(y, u, v, qp=qp)
        assert a[2] == b[2]
        for pa, pb in zip(a[3], b[3]):
            np.testing.assert_array_equal(pa, pb)
        assert any(not np.array_equal(pa, pc) for pa, pc in zip(a[3], c[3]))


def test_native_matches_python_and_jax_seeded_sweep():
    for trial in range(8):
        r = np.random.default_rng(300 + trial)
        w = int(r.integers(2, 7)) * 16
        h = int(r.integers(2, 5)) * 16
        qp = int(r.integers(4, 50))
        tx8 = bool(r.integers(0, 2))
        y = r.integers(0, 256, (h, w)).astype(np.uint8)
        u = r.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        v = r.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        native, _, jax = three_ways(y, u, v, qp, tx8)
        assert native[2] == jax[2], (trial, w, h, qp, tx8)


def test_native_call_failure_raises():
    """A call the C++ engine fails raises, and nothing runs Python after
    it (here: an output buffer too small for the slice)."""
    y = np.random.default_rng(7).integers(0, 256, (32, 32)).astype(np.int32)
    sps = PE.parse_sps(PE.write_sps(2, 2, 32, 32, mono=True))
    pps = PE.parse_pps(PE.write_pps(True, 26), {0: sps})
    enc = PE._NativeSliceEncoder(sps, pps, [y], 26)
    enc.out_cap = 16
    with trace.collect() as spans, \
            pytest.raises(HeifError, match="output buffer too small"):
        PE.write_idr_slice(enc, 26)
    assert "avc.encode.python" not in spans


# ------------------------------------------------------------ the context

def encode_item(planes, quality, side):
    if side == "jax":
        ctx = JaxContext()
        ctx.encode_image(jax_image(planes), "avc", JOptions(quality=quality))
    else:
        ctx = HeifContext(device="cpu")
        ctx.encode_image(port_image(planes), "avc",
                         EncodingOptions(quality=quality))
    return ctx.write()


ITEM_CASES = {"q50-alpha-96x64": (96, 64, 50, True),
              "q90-100x52": (100, 52, 90, False)}


@pytest.fixture(scope="module")
def items():
    """name -> (planes, port file, JAX file) of ITEM_CASES."""
    out = {}
    for k, (name, (w, h, q, alpha)) in enumerate(ITEM_CASES.items()):
        planes = photo(w, h, 40 + k, alpha=alpha)
        out[name] = (planes, encode_item(planes, q, "port"),
                     encode_item(planes, q, "jax"))
    return out


@pytest.mark.parametrize("name", list(ITEM_CASES))
def test_encode_image_matches_jax(items, name):
    _, port, jax = items[name]
    assert port == jax


def item_stream(blob, item_id):
    """The annex-B stream of an avc1 item: its avcC's parameter sets and
    its slices."""
    ctx = HeifContext.read_from_bytes(blob, device="cpu")
    item = ctx.items[item_id]
    cfg = item.config_box()
    from libheif_tpu_torch.codecs.avc import headers as H
    nals = list(cfg.all_nals()) + H.split_length_prefixed(
        item.coded_data(), cfg.length_size)
    return b"".join(SC + n for n in nals)


@needs_oracle
@pytest.mark.parametrize("name", list(ITEM_CASES))
def test_item_decodes_to_the_reconstruction(items, name):
    """The item decoded through the port's context and by libavcodec:
    the encoder's reconstruction, cropped (the alpha item's too)."""
    planes, blob, _ = items[name]
    w, h, q, alpha = ITEM_CASES[name]
    qp = max(1, min(51, 51 - q * 50 // 100))
    _, _, _, recon = filtered_frame(planes["Y"], planes["Cb"], planes["Cr"],
                                    qp)
    img = HeifContext.read_from_bytes(blob, device="cpu").decode_image(
        None, "YCbCr", "420")
    ref = {"Y": recon[0][:h, :w], "Cb": recon[1][:h // 2, :w // 2],
           "Cr": recon[2][:h // 2, :w // 2]}
    for ch, r in ref.items():
        np.testing.assert_array_equal(img.plane(ch).to(torch.int32).numpy(),
                                      r)
    lib = avc_oracle.decode(item_stream(blob, 1))
    for ch, k in (("Y", "Y"), ("Cb", "U"), ("Cr", "V")):
        np.testing.assert_array_equal(lib[k].astype(np.int32), ref[ch])
    if alpha:
        a = np.zeros((h // 2, w // 2), np.uint8) + 128
        _, _, _, arecon = filtered_frame(planes["Alpha"], a, a, qp)
        np.testing.assert_array_equal(
            img.plane("Alpha").to(torch.int32).numpy(), arecon[0][:h, :w])
        lib = avc_oracle.decode(item_stream(blob, 2))
        np.testing.assert_array_equal(lib["Y"].astype(np.int32),
                                      arecon[0][:h, :w])


def test_memoryview_slice_with_emulation_prevention():
    """A slice NAL handed over as a memoryview (an item's payload read in
    place, as a single-extent item's is) decodes as its bytes do: its
    emulation-prevention bytes are removed.  A flat picture's slice
    holds some."""
    from libheif_tpu_torch.codecs.avc.decoder import decode_intra_frame
    h, w = 384, 512
    y = np.full((h, w), 128, np.uint8)
    c = np.full((h // 2, w // 2), 128, np.uint8)
    sps, pps, sl, recon = filtered_frame(y, c, c, 26)
    assert b"\x00\x00\x03" in sl
    got = decode_intra_frame([sps, pps, memoryview(sl)])
    np.testing.assert_array_equal(got["Y"].astype(np.int32), recon[0][:h, :w])
    ref = decode_intra_frame([sps, pps, sl])
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_encode_image_spans():
    """An item's encode: the copy, the C++ engine and the writers, no
    Python engine."""
    planes = photo(48, 32, 9)
    with trace.collect() as spans:
        HeifContext(device="cpu").encode_image(port_image(planes), "avc")
    assert spans["avc.encode"]["count"] == 1
    assert spans["avc.encode.copy"]["count"] == 1
    assert spans["avc.encode.native"]["count"] == 1
    assert spans["avc.encode.write"]["count"] == 2
    assert "avc.encode.python" not in spans


# ------------------------------------------------------------- the tracks

def track_frames():
    w, h = QCIF
    return [dict(zip(("Y", "Cb", "Cr"), f))
            for f in panning_scene(w, h, TRACK_FRAMES, TRACK_SEED)]


def write_track(side, inter, frames):
    """A QCIF avc track of ``frames`` at q 50; (file, the port session's
    reference after each frame or None)."""
    w, h = QCIF
    if side == "jax":
        ctx = JaxContext()
        tw = ctx.add_visual_track(w, h, fmt="avc", options=jtrack.TrackOptions(
            timescale=30, inter_frames=inter))
        for f in frames:
            tw.add_frame(jax_image(f), duration=1, options=JOptions(quality=50))
        return ctx.write(), None
    ctx = HeifContext(device="cpu")
    tw = ctx.add_visual_track(w, h, fmt="avc", options=TrackOptions(
        timescale=30, inter_frames=inter))
    refs = []
    for f in frames:
        tw.add_frame(port_image(f), duration=1,
                     options=EncodingOptions(quality=50))
        if inter:
            refs.append(tw._enc_session.ref)
    return ctx.write(), refs


@pytest.fixture(scope="module")
def tracks():
    """inter_frames -> (frames, port file, port references, JAX file)."""
    frames = track_frames()
    out = {}
    for inter in (True, False):
        port, refs = write_track("port", inter, frames)
        jax, _ = write_track("jax", inter, frames)
        out[inter] = (frames, port, refs, jax)
    return out


@pytest.mark.parametrize("inter", [True, False], ids=["ippp", "intra"])
def test_track_matches_jax(tracks, inter):
    _, port, _, jax = tracks[inter]
    assert port == jax


@needs_oracle
def test_ippp_track_decodes_to_the_references(tracks):
    """Every frame of the IPPP track read back by the port (in order) and
    by libavcodec equals the encoder's deblocked reference picture."""
    w, h = QCIF
    _, blob, refs, _ = tracks[True]
    t = HeifContext.read_from_bytes(blob, device="cpu").tracks[0]
    samples = []
    for i, ref in enumerate(refs):
        img = t.decode_next_image()
        for ch, r in zip(("Y", "Cb", "Cr"), ref):
            got = img.plane(ch).to(torch.int32).numpy()
            np.testing.assert_array_equal(got, r[:got.shape[0],
                                                 :got.shape[1]])
        samples.append(t.sample_data(i))
    cfg = t._config_box()
    stream = b"".join(SC + n for n in cfg.all_nals()) + b"".join(
        SC + s[4:] for s in samples)
    lib = avc_oracle.decode_seq(stream)
    assert len(lib) == len(refs)
    for frame, ref in zip(lib, refs):
        for k, r in zip(("Y", "U", "V"), ref):
            got = frame[k].astype(np.int32)
            np.testing.assert_array_equal(got, r[:got.shape[0],
                                                 :got.shape[1]])


def test_ippp_track_reopens_as_jax(tracks):
    """Both packages read the port's IPPP file to the same frames."""
    _, blob, _, _ = tracks[True]
    t = HeifContext.read_from_bytes(blob, device="cpu").tracks[0]
    j = JaxContext.read_from_bytes(blob).tracks[0]
    for i in range(TRACK_FRAMES):
        assert_same_image(t.decode_next_image(), j.decode_next_image(),
                          f"frame {i}")


def test_track_b_frames_refused_as_jax():
    w, h = QCIF
    frame = track_frames()[0]
    for ctx, opts, img, err in (
            (JaxContext(), jtrack.TrackOptions(inter_frames="bpyr"),
             jax_image(frame), JHeifError),
            (HeifContext(device="cpu"), TrackOptions(inter_frames="bpyr"),
             port_image(frame), HeifError)):
        tw = ctx.add_visual_track(w, h, fmt="avc", options=opts)
        with pytest.raises(err, match="only 'ipp'/'intra'"):
            tw.add_frame(img, duration=1)


def test_sequence_spans():
    """A sequence's IDR and P pictures run the Python engines, each
    reconstruction deblocked on the host."""
    frames = track_frames()[:2]
    with trace.collect() as spans:
        write_track("port", True, frames)
    assert spans["avc.encode"]["count"] == 2
    assert spans["avc.encode.python"]["count"] == 2
    assert spans["avc.encode.deblock"]["count"] == 2
    assert spans["avc.encode.copy"]["count"] == 2
    assert "avc.encode.native" not in spans


# -------------------------------------------------------------- the tiles

def tiled(side):
    """A 64x64 tili of four 32x32 avc1 tiles at q 60."""
    ctx = JaxContext() if side == "jax" else HeifContext(device="cpu")
    tid = ctx.add_tiled_image(64, 64, 32, 32, fmt="avc")
    for k, (tx, ty) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        planes = photo(32, 32, 60 + k)
        if side == "jax":
            ctx.add_image_tile_to_tiled(tid, tx, ty, jax_image(planes),
                                        JOptions(quality=60))
        else:
            ctx.add_image_tile_to_tiled(tid, tx, ty, port_image(planes),
                                        EncodingOptions(quality=60))
    return ctx.write(), tid


def test_avc_tiles_match_jax():
    port, tid = tiled("port")
    jax, _ = tiled("jax")
    assert port == jax
    pitem = HeifContext.read_from_bytes(port, device="cpu").items[tid]
    jitem = JaxContext.read_from_bytes(jax).get_item(tid)
    for tx, ty in [(0, 0), (1, 0), (0, 1), (1, 1)]:
        assert_same_image(pitem.decode_tile(tx, ty),
                          jitem.decode_tile(tx, ty), f"tile {tx},{ty}")


# --------------------------------------------------- the card's files

def test_card_track_matches_manifest():
    """The port's CPU write of phase 4l's QCIF IPPP avc track gives the
    JAX writer's SHA-256 in the manifest (the photo's files are held to
    theirs on the card, beside the same write on the CPU)."""
    man = card_encodes.read_avc_manifest()
    assert sorted(man["files"]) == sorted(card_encodes.AVC_FILES)
    assert all(len(e["sha256"]) == 64 for e in man["files"].values())
    assert (tuple(man["photo"]), man["quality"], man["tile"],
            tuple(man["track"]), man["track_seed"]) == (
        card_encodes.PHOTO, card_encodes.AVC_QUALITY, card_encodes.AVC_TILE,
        card_encodes.AVC_TRACK, card_encodes.AVC_TRACK_SEED)
    blob = card_encodes.avc_file("port", None, "qcif-ipp")
    assert len(blob) == man["files"]["qcif-ipp"]["bytes"]
    assert hashlib.sha256(blob).hexdigest() == \
        man["files"]["qcif-ipp"]["sha256"]
