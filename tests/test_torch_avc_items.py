"""avc1 items, grids, tili tiles and avc1/avc3 tracks of the PyTorch port
against the JAX package, on the CPU, through HeifContext.

Every file comes from the JAX package's writer: an ``encode_image(img,
"avc")`` item, a 2x2 grid of such items, a tili of avc1 tiles, items of
committed streams (the monochrome one, the 1920x1080 one cropped from
1088 rows), and an avc1 track muxed from an x264 IPPP stream with
``add_raw_sample`` (tests/test_avc_inter.py::test_avc1_track_mux_
roundtrip), then the same track as avc3 with its parameter sets in the
first sample.  Planes are compared exactly with the JAX context's and,
for the track, libavcodec's; RGB within the colour contract (at most 1
LSB on fewer than 1% of the samples).  Also: the port's AVC modules
import and decode with jax and libheif_tpu unimportable.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.codec_cfg import Box_avcC as JBox_avcC  # noqa: E402
from libheif_tpu.color import convert_image as jconvert  # noqa: E402
from libheif_tpu.boxes.meta import Box_ispe as JBox_ispe  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu_torch import HeifContext  # noqa: E402
from libheif_tpu_torch.color import convert_image  # noqa: E402
from libheif_tpu_torch.core import trace  # noqa: E402
from libheif_tpu_torch.items.codec_items import ImageItem_AVC  # noqa: E402
from tests import avc_oracle, avc_streams as S, jax_native  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_oracle = pytest.mark.skipif(not avc_oracle.available(),
                                  reason="libavcodec oracle not available")
RGB = (Colorspace.RGB, Chroma.InterleavedRGB)
TRACK_FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX package's C++ AVC engine and encoder: load them first
    (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def _image(w, h, seed):
    """A JAX YCbCr 4:2:0 image of 8x8 flat patches with a little noise."""
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    for ch, (pw, ph) in ((Channel.Y, (w, h)),
                         (Channel.Cb, ((w + 1) // 2, (h + 1) // 2)),
                         (Channel.Cr, ((w + 1) // 2, (h + 1) // 2))):
        base = np.kron(rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1)),
                       np.ones((8, 8), np.int64))[:ph, :pw]
        img.set_plane(ch, np.clip(base + rng.integers(-3, 4, (ph, pw)), 0,
                                  255).astype(np.uint8), 8)
    return img


def _stream_item_file(name):
    """One avc1 item of committed still ``name``: its SPS and PPS in the
    avcC, its slices length-prefixed in the item data."""
    sps, pps, samples = S.avcc_and_samples(S.data(name))
    cfg = JBox_avcC()
    cfg.avc_profile, cfg.avc_level = sps[0][1], sps[0][3]
    cfg.sps_list, cfg.pps_list = sps, pps
    e = S.entries()[name]
    ctx = JHeifContext()
    ctx.new_file()
    item = ctx._register_encoded_item("avc1")
    ctx.file.append_item_data(item, b"".join(s for s, _ in samples))
    ctx.file.add_property(item, JBox_ispe(e["width"], e["height"]), False)
    ctx.file.add_property(item, cfg, True)
    ctx.set_primary_item(item)
    return ctx.write()


def _track_stream():
    return avc_oracle.encode_seq(S.panned_frames(11, 96, 64, TRACK_FRAMES),
                                 qp=26, extra_params=(
                                     "partitions=i4x4:me=dia:subme=1:"
                                     "trellis=0"))


def _track_file(in_band, avc3=False):
    return S.mux_track(_track_stream(), 96, 64, in_band, avc3)


def _grid():
    ctx = JHeifContext()
    ids = [ctx.encode_image(_image(64, 48, seed=i), "avc")
           for i in range(4)]
    ctx.set_primary_item(ctx.add_grid_image(ids, 120, 90, 2, 2))
    return ctx.write()


def _tili():
    """A 2x2 tili of 64x48 avc1 tiles, (1, 1) left out."""
    ctx = JHeifContext()
    tid = ctx.add_tiled_image(128, 96, 64, 48, fmt="avc")
    for tx, ty in ((0, 0), (1, 0), (0, 1)):
        ctx.add_image_tile_to_tiled(tid, tx, ty, _image(64, 48, tx + 2 * ty))
    return ctx.write()


def _item():
    ctx = JHeifContext()
    ctx.encode_image(_image(128, 96, seed=7), "avc")
    return ctx.write()


FILES = {"item": _item, "grid": _grid, "tili": _tili,
         "mono": lambda: _stream_item_file(S.MONO),
         "hd": lambda: _stream_item_file("hd-1920x1080"),
         "track_avc1": lambda: _track_file(False),
         "track_in_band": lambda: _track_file(True),
         "track_avc3": lambda: _track_file(True, avc3=True)}


@functools.lru_cache(maxsize=None)
def blob(name):
    return FILES[name]()


def _same(ref, got, colour=False):
    assert (got.width, got.height) == (ref.width, ref.height)
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        have = got.np_plane(ch)
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert have.dtype == want.dtype and have.shape == want.shape, ch
        if colour:
            d = np.abs(have.astype(np.int64) - want.astype(np.int64))
            assert d.max(initial=0) <= 1, f"{ch}: maxdiff {d.max()}"
            assert (d > 0).mean() < 0.01, f"{ch}: {(d > 0).mean():.3%}"
        else:
            np.testing.assert_array_equal(have, want, err_msg=ch)


def _contexts(data):
    return JHeifContext.read_from_bytes(data), \
        HeifContext.read_from_bytes(data, device="cpu")


# ----------------------------------------------------------------- items

@pytest.mark.parametrize("name", ["item", "grid", "mono", "hd"])
def test_decode_image_matches_jax(name):
    """The item's planes as decoded equal the JAX context's; RGB within
    the colour contract."""
    jctx, pctx = _contexts(blob(name))
    assert isinstance(pctx.get_item(pctx.primary_item_id),
                      ImageItem_AVC) == (name != "grid")
    with trace.collect() as spans:
        got = pctx.decode_image(None)
    _same(jctx.decode_image(jctx.primary_item_id), got)
    assert spans["avc.decode"]["count"] == (4 if name == "grid" else 1)
    assert spans["avc.decode.copy"]["count"] == spans["avc.decode"]["count"]
    _same(jctx.decode_image(jctx.primary_item_id, *RGB),
          pctx.decode_image(None, *RGB), colour=True)


def test_hd_item_is_the_cropped_stream():
    """The 1920x1080 item (coded as 1088 rows) equals the manifest's
    planes: the conformance window, then ispe."""
    pctx = HeifContext.read_from_bytes(blob("hd"), device="cpu")
    img = pctx.decode_image(None)
    assert (img.width, img.height) == (1920, 1080)
    got = {k: img.np_plane(c) for k, c in
           (("Y", Channel.Y), ("U", Channel.Cb), ("V", Channel.Cr))}
    assert S.plane_hashes(got) == S.entries()["hd-1920x1080"]["sha256"]


def test_tili_tiles_match_jax():
    jctx, pctx = _contexts(blob("tili"))
    j, p = jctx.primary_item_id, pctx.primary_item_id
    assert vars(pctx.get_image_tiling(p)) == vars(jctx.get_image_tiling(j))
    for tx, ty in ((0, 0), (1, 0), (0, 1)):
        _same(jctx.decode_tile(j, tx, ty), pctx.decode_tile(p, tx, ty))
    _same(jctx.decode_tile(j, 1, 0, *RGB), pctx.decode_tile(p, 1, 0, *RGB),
          colour=True)
    with pytest.raises(Exception, match="not available"):
        pctx.decode_tile(p, 1, 1)


# ---------------------------------------------------------------- tracks

@needs_oracle
@pytest.mark.parametrize("name", ["track_avc1", "track_avc3"])
def test_track_matches_jax_and_libavcodec(name):
    """Every frame in order equals the JAX context's and libavcodec's; the
    IDR went through the C++ engine; random access restarts at the IDR:
    decode_sample(2) after the last frame equals frame 2.  The avc3
    track's parameter sets are in band; the JAX package opens no avc3
    track, so its frames are those of the same samples as avc1."""
    pctx = HeifContext.read_from_bytes(blob(name), device="cpu")
    if name == "track_avc3":
        assert JHeifContext.read_from_bytes(blob(name)).tracks == []
        jctx = JHeifContext.read_from_bytes(blob("track_in_band"))
    else:
        jctx = JHeifContext.read_from_bytes(blob(name))
    t, jt = pctx.tracks[0], jctx.tracks[0]
    assert t.coding == name[-4:] and jt.coding == "avc1"
    assert [s.is_sync for s in t.samples] == \
        [True] + [False] * (TRACK_FRAMES - 1)
    ref = avc_oracle.decode_seq(_track_stream())
    frames = []
    with trace.collect() as spans:
        while (img := t.decode_next_image()) is not None:
            frames.append(img)
    assert len(frames) == TRACK_FRAMES
    assert spans["avc.decode.native"]["count"] == 1
    assert spans["avc.decode.python"]["count"] == TRACK_FRAMES - 1
    for i, img in enumerate(frames):
        _same(jt.decode_sample(i), img)
        for k, ch in (("Y", Channel.Y), ("U", Channel.Cb),
                      ("V", Channel.Cr)):
            np.testing.assert_array_equal(img.np_plane(ch), ref[i][k])
        assert img.duration == 1
    again = t.decode_sample(2)
    _same(jt.decode_sample(2), again)
    _same(frames[2], again)
    _same(jt.decode_sample(4), t.decode_sample(4))
    _same(jconvert(jt.decode_sample(1), *RGB),
          convert_image(t.decode_sample(1), *RGB, device="cpu"), colour=True)


@pytest.mark.parametrize("name", S.TRACKS)
def test_committed_track_files(name):
    """The card's avc1 track files hold their stream a slice a sample,
    sync at the IDR; the QCIF one decodes in order to the manifest's
    hashes (the CIF one's frames are held on the card and, as a stream,
    in test_torch_avc_inter.py)."""
    e = S.entries()[name]
    with open(os.path.join(S.FIXTURES, e["track"]), "rb") as f:
        t = HeifContext.read_from_bytes(f.read(), device="cpu").tracks[0]
    _, _, samples = S.avcc_and_samples(S.data(name))
    assert (t.coding, t.width, t.height) == ("avc1", e["width"],
                                             e["height"])
    assert [t.sample_data(i) for i in range(t.num_samples)] == \
        [s for s, _ in samples]
    assert [s.is_sync for s in t.samples] == [sync for _, sync in samples]
    if name == S.QCIF:
        got = []
        while (img := t.decode_next_image()) is not None:
            got.append(S.plane_hashes({k: img.np_plane(c) for k, c in (
                ("Y", Channel.Y), ("U", Channel.Cb), ("V", Channel.Cr))}))
        assert got == e["sha256"]


# ------------------------------------------------------------ isolation

AVC_MODULES = ["libheif_tpu_torch.codecs.avc", "libheif_tpu_torch.codecs.avc."
               "decoder", "libheif_tpu_torch.codecs.avc.native_decode",
               "libheif_tpu_torch.codecs.avc.cavlc",
               "libheif_tpu_torch.codecs.avc.deblock"]


def test_avc_decodes_without_jax():
    """The port's AVC modules import, and a committed stream decodes
    through HeifContext and its C++ engine, where jax and libheif_tpu
    cannot be imported."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["libheif_tpu"] = None
        for name in {AVC_MODULES!r}:
            importlib.import_module(name)
        from libheif_tpu_torch.codecs.avc import decode_annexb
        data = open("libheif_tpu_torch/testdata/avc/odd-100x52.264",
                    "rb").read()
        assert decode_annexb(data)["Y"].shape == (52, 100)
        bad = [m for m in sys.modules if m.startswith("libheif_tpu.")]
        assert not bad and sys.modules["jax"] is None, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok"]
