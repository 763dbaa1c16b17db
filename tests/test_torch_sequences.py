"""Image sequences through the port: msf1 files written with the JAX
package's track writer (as tests/test_sequences.py writes them) must give
the same tracks, sample tables, timing, sync flags, TAI timestamps, GIMI
content ids, metadata bytes and decoded planes in the port as in the JAX
package.  The port decodes on the CPU here (``device="cpu"``); the HEVC
P and B pictures' own tests are in tests/test_torch_hevc_inter.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libheif_tpu.boxes.meta import (TaiClockInfo as JTaiClockInfo,
                                    TaiTimestampPacket as JTaiPacket)
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.image.pixel_image import (PixelImage as JaxImage,
                                           Channel as JChannel,
                                           Colorspace as JColorspace,
                                           Chroma as JChroma)
from libheif_tpu.sequences.track import (AUX_TYPE_ALPHA_MPEGB,
                                         RawSequenceSample as JRawSample,
                                         TrackOptions)
from libheif_tpu_torch import HeifContext
from libheif_tpu_torch.boxes.box import read_box
from libheif_tpu_torch.core.bitstream import ByteReader
from libheif_tpu_torch.core.error import HeifError, ErrorCode
from libheif_tpu_torch.core.limits import SecurityLimits
from libheif_tpu_torch.io.reader import MemoryReader
from libheif_tpu_torch.sequences import TrackMetadata, TrackVisual

CHANNELS = ("Y", "Cb", "Cr", "R", "G", "B", "Alpha")


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    # the JAX native HEVC engine's pipeline is not safe under load
    # (ROADMAP §3); one torch thread a process under xdist
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame(i, w=64, h=64, chroma=JChroma.C420):
    """tests/test_sequences.py's frame: noise luma, flat chroma."""
    img = JaxImage(w, h, JColorspace.YCbCr, chroma)
    rng = np.random.default_rng(100 + i)
    y = (rng.integers(0, 200, (h, w), np.uint8) + 10 * i).astype(np.uint8)
    img.set_plane(JChannel.Y, y, 8)
    cw, ch = (w // 2, h // 2) if chroma == JChroma.C420 else (w, h)
    img.set_plane(JChannel.Cb, np.full((ch, cw), 90 + 20 * i, np.uint8), 8)
    img.set_plane(JChannel.Cr, np.full((ch, cw), 150 - 20 * i, np.uint8), 8)
    return img


def moving(i, w=64, h=64):
    """A panning block pattern (tests/test_sequences.py inter frames)."""
    rng = np.random.default_rng(3)
    base = np.kron(rng.integers(0, 256, (24, 24)),
                   np.ones((8, 8))).astype(np.uint8)
    img = JaxImage(w, h, JColorspace.YCbCr, JChroma.C420)
    cb = base[i // 2:i // 2 + h // 2, i:i + w // 2].copy()
    img.set_plane(JChannel.Y, base[i:i + h, 2 * i:2 * i + w].copy(), 8)
    img.set_plane(JChannel.Cb, cb, 8)
    img.set_plane(JChannel.Cr, 255 - cb, 8)
    return img


def both(blob):
    """(port context on the CPU, JAX context) of one file."""
    return (HeifContext.read_from_bytes(blob, device="cpu"),
            JaxContext.read_from_bytes(blob))


def assert_same_image(got, ref, what=""):
    """Same size and planes (values and bit depths) in both packages."""
    assert (got.width, got.height) == (ref.width, ref.height), what
    for ch in CHANNELS:
        assert got.has_channel(ch) == ref.has_channel(ch), (what, ch)
        if got.has_channel(ch):
            np.testing.assert_array_equal(
                got.plane(ch).to(torch.int32).numpy(),
                np.asarray(ref.plane(ch)).astype(np.int32), f"{what} {ch}")
            assert got.bit_depth(ch) == ref.bit_depth(ch), (what, ch)


def assert_same_tables(t, j):
    """The sample tables of a port track and the JAX one."""
    assert (t.track_id, t.handler, t.timescale, t.num_samples,
            t.duration(), t.duration_in_movie_units(), t.num_repetitions) \
        == (j.track_id, j.handler, j.timescale, j.num_samples,
            j.duration(), j.duration_in_movie_units(), j.num_repetitions)
    assert [vars(s) for s in t.samples] == [vars(s) for s in j.samples]
    assert t.reference_types() == j.reference_types()
    assert t.sample_aux_info_types() == j.sample_aux_info_types()


def visual_file(fmt, n=3, w=64, h=64, **kw):
    ctx = JaxContext()
    tw = ctx.add_visual_track(w, h, fmt=fmt, timescale=30, **kw)
    frames = [frame(i, w, h) for i in range(n)]
    for f in frames:
        tw.add_frame(f, duration=1 + (frames.index(f) % 2))
    return ctx.write()


@pytest.mark.parametrize("fmt", ["hevc", "unc", "av1", "jpeg"])
def test_visual_track_matches_jax(fmt):
    """An all-intra hvc1, an uncv, an av01 and an mjpg track: the same
    tracks, sample tables and decoded frames in both packages, each frame
    carrying its sample duration."""
    ctx, jctx = both(visual_file(fmt))
    assert ctx.has_sequence() and jctx.has_sequence()
    assert (ctx.sequence_timescale(), ctx.sequence_duration()) == \
        (jctx.sequence_timescale(), jctx.sequence_duration())
    assert len(ctx.tracks) == len(jctx.tracks) == 1
    t, j = ctx.tracks[0], jctx.tracks[0]
    assert isinstance(t, TrackVisual)
    assert (t.width, t.height, t.coding) == (j.width, j.height, j.coding)
    assert_same_tables(t, j)
    assert ctx.get_track(t.track_id) is t and ctx.get_track(99) is None
    for i in range(t.num_samples):
        got, ref = t.decode_sample(i), j.decode_sample(i)
        assert_same_image(got, ref, f"{fmt} sample {i}")
        assert got.duration == ref.duration == t.samples[i].duration


def test_sequential_reader_and_raw_samples():
    """decode_next_image to the end, seek, and the raw samples as the JAX
    package gives them."""
    ctx, jctx = both(visual_file("hevc", n=3, w=32, h=32))
    t, j = ctx.tracks[0], jctx.tracks[0]
    n = 0
    while (img := t.decode_next_image()) is not None:
        assert_same_image(img, j.decode_next_image(), f"frame {n}")
        n += 1
    assert n == 3 and j.decode_next_image() is None
    t.seek(1)
    j.seek(1)
    while (raw := t.get_next_raw_sample()) is not None:
        ref = j.get_next_raw_sample()
        assert (raw.data, raw.duration, raw.timestamp,
                raw.gimi_sample_content_id) == \
            (ref.data, ref.duration, ref.timestamp,
             ref.gimi_sample_content_id)
    assert j.get_next_raw_sample() is None
    t.seek(-5)
    assert t.get_next_raw_sample().data == t.sample_data(0)


def test_raw_samples_muxed_track():
    """A track of raw samples (is_sync on and off) written by the JAX
    package's add_raw_sample: the same data and sync flags."""
    src = JaxContext.read_from_bytes(visual_file("hevc", n=2, w=32, h=32))
    jt = src.tracks[0]
    ctx = JaxContext()
    tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    tw.config_box = jt._config_box()
    for i in range(2):
        tw.add_raw_sample(JRawSample(data=jt.sample_data(i), duration=4,
                                     is_sync=i == 0))
    port, jax = both(ctx.write())
    assert_same_tables(port.tracks[0], jax.tracks[0])
    assert [s.is_sync for s in port.tracks[0].samples] == [True, False]
    assert port.tracks[0].sample_data(1) == jt.sample_data(1)


def test_tai_timestamps_and_gimi():
    """Per-sample TAI timestamps ('stai'), GIMI sample content ids
    ('suid'), taic clock info and the track-level GIMI content id, and
    the decoded frames carrying them."""
    opts = TrackOptions(
        timescale=30, with_tai_timestamps=1,
        tai_clock_info=JTaiClockInfo(time_uncertainty=500,
                                     clock_resolution=1000,
                                     clock_drift_rate=-2, clock_type=2),
        with_gimi_content_ids=1,
        gimi_track_content_id="urn:uuid:track-level-id")
    jctx = JaxContext()
    tw = jctx.add_visual_track(64, 64, fmt="hevc", options=opts)
    base_ns = 2_145_916_800_000_000_000
    for i in range(3):
        tw.add_frame(frame(i), duration=1,
                     tai=JTaiPacket(tai_timestamp=base_ns + i,
                                    synchronization_state=i != 1,
                                    timestamp_is_modified=i == 2),
                     gimi_content_id=f"urn:uuid:sample-{i}")
    ctx, jctx = both(jctx.write())
    t, j = ctx.tracks[0], jctx.tracks[0]
    assert_same_tables(t, j)
    assert t.sample_aux_info_types() == [("stai", 0), ("suid", 0)]
    for i in range(3):
        assert vars(t.sample_tai_timestamp(i)) == \
            vars(j.sample_tai_timestamp(i))
        assert t.sample_gimi_content_id(i) == j.sample_gimi_content_id(i) \
            == f"urn:uuid:sample-{i}"
    assert vars(t.tai_clock_info()) == vars(j.tai_clock_info())
    assert t.tai_clock_info().clock_drift_rate == -2
    assert t.gimi_track_content_id() == j.gimi_track_content_id() == \
        "urn:uuid:track-level-id"
    img = t.decode_sample(2)
    assert img.tai_timestamp.tai_timestamp == base_ns + 2
    assert img.tai_timestamp.timestamp_is_modified
    assert img.gimi_sample_content_id == "urn:uuid:sample-2"


def test_optional_tai_not_present():
    jctx = JaxContext()
    tw = jctx.add_visual_track(32, 32, fmt="hevc", options=TrackOptions(
        timescale=10, with_tai_timestamps=2))
    tw.add_frame(frame(0, 32, 32), duration=1,
                 tai=JTaiPacket(tai_timestamp=77))
    tw.add_frame(frame(1, 32, 32), duration=1)
    ctx, jctx = both(jctx.write())
    t = ctx.tracks[0]
    assert t.sample_tai_timestamp(0).tai_timestamp == 77
    assert t.sample_tai_timestamp(1) is None
    assert not hasattr(t.decode_sample(1), "tai_timestamp")
    assert_same_tables(t, jctx.tracks[0])


def test_uri_metadata_track():
    """A URI metadata track referring to a visual track ('cdsc')."""
    jctx = JaxContext()
    vt = jctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    vt.add_frame(frame(0, 32, 32), duration=5)
    mt = jctx.add_uri_metadata_track("urn:test:telemetry", timescale=10)
    mt.add_metadata_sample(b"gps=1.5,2.5", duration=5)
    mt.add_metadata_sample(b"gps=1.6,2.4\x00\xff", duration=3)
    mt.add_reference_to_track("cdsc", vt.track_id)
    ctx, jctx = both(jctx.write())
    metas = [t for t in ctx.tracks if isinstance(t, TrackMetadata)]
    assert len(metas) == 1 and metas[0].handler == "meta"
    m, jm = metas[0], [t for t in jctx.tracks if t.handler == "meta"][0]
    assert_same_tables(m, jm)
    assert m.uri() == jm.uri() == "urn:test:telemetry"
    assert [m.metadata_sample(i) for i in range(2)] == \
        [jm.metadata_sample(i) for i in range(2)] == \
        [b"gps=1.5,2.5", b"gps=1.6,2.4\x00\xff"]
    assert m.references_of_type("cdsc") == [vt.track_id]


def test_alpha_aux_track_merge():
    """An alpha aux track ('auxv', 'auxl' to its master): the master's
    decode_next_image carries the alpha plane, as in the JAX package."""
    jctx = JaxContext()
    vt = jctx.add_visual_track(64, 64, fmt="hevc", timescale=10)
    at = jctx.add_visual_track(64, 64, fmt="hevc", timescale=10,
                               handler="auxv",
                               aux_type_urn=AUX_TYPE_ALPHA_MPEGB)
    at.add_reference_to_track("auxl", vt.track_id)
    for i in range(2):
        vt.add_frame(frame(i), duration=1)
        a = JaxImage(64, 64, JColorspace.Monochrome, JChroma.Monochrome)
        a.set_plane(JChannel.Y, np.full((64, 64), 30 + 100 * i, np.uint8), 8)
        at.add_frame(a, duration=1)
    ctx, jctx = both(jctx.write())
    masters = [t for t in ctx.tracks if t.alpha_track is not None]
    jmasters = [t for t in jctx.tracks
                if getattr(t, "alpha_track", None) is not None]
    assert len(masters) == len(jmasters) == 1
    t, j = masters[0], jmasters[0]
    assert t.alpha_track.is_alpha_aux() and not t.is_alpha_aux()
    assert t.alpha_track.auxiliary_info_type_urn() == AUX_TYPE_ALPHA_MPEGB
    for i in range(2):
        img = t.decode_next_image()
        assert img.has_channel("Alpha")
        assert_same_image(img, j.decode_next_image(), f"frame {i}")


def test_repetitions_and_timescale():
    """The edit list's repeat mode → num_repetitions; the movie's
    timescale and duration."""
    jctx = JaxContext()
    jctx.set_sequence_timescale(30)
    jctx.set_number_of_sequence_repetitions(5)
    tw = jctx.add_visual_track(32, 32, fmt="hevc", timescale=30)
    for i in range(2):
        tw.add_frame(frame(i, 32, 32), duration=3)
    ctx, jctx = both(jctx.write())
    assert ctx.has_sequence()
    assert ctx.sequence_timescale() == jctx.sequence_timescale() == 30
    assert ctx.sequence_duration() == jctx.sequence_duration() == 30
    assert ctx.tracks[0].num_repetitions == 5
    assert_same_tables(ctx.tracks[0], jctx.tracks[0])


@pytest.mark.parametrize("gop", ["ipp", "ldb", "ibp", "bpyr"])
def test_inter_track_matches_jax(gop):
    """An hvc1 track of P and B pictures from the JAX writer
    (TrackOptions.inter_frames): the same sync flags, composition offsets
    and frames in output order as the JAX package's."""
    n = 9 if gop == "bpyr" else 5
    jctx = JaxContext()
    tw = jctx.add_visual_track(64, 64, fmt="hevc", options=TrackOptions(
        timescale=30, inter_frames=gop))
    for i in range(n):
        tw.add_frame(moving(i), duration=1)
    ctx, jctx = both(jctx.write())
    t, j = ctx.tracks[0], jctx.tracks[0]
    assert_same_tables(t, j)
    assert [s.is_sync for s in t.samples] == [True] + [False] * (n - 1)
    for i in range(n):
        assert_same_image(t.decode_sample(i), j.decode_sample(i),
                          f"{gop} frame {i}")


def test_still_and_track_in_one_file():
    """A file with an unci still and an hvc1 track: both open."""
    jctx = JaxContext()
    rng = np.random.default_rng(7)
    still = JaxImage(16, 16, JColorspace.YCbCr, JChroma.C444)
    for ch in (JChannel.Y, JChannel.Cb, JChannel.Cr):
        still.set_plane(ch, rng.integers(0, 256, (16, 16), np.uint8), 8)
    jctx.encode_image(still, fmt="unci")
    tw = jctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    tw.add_frame(frame(0, 32, 32), duration=1)
    ctx, jctx = both(jctx.write())
    assert_same_image(ctx.decode_image(), jctx.decode_image(
        jctx.primary_item_id))
    assert len(ctx.tracks) == 1 and ctx.tracks[0].num_samples == 1
    assert_same_image(ctx.tracks[0].decode_sample(0),
                      jctx.tracks[0].decode_sample(0))


def test_file_without_moov_has_no_sequence():
    jctx = JaxContext()
    still = JaxImage(16, 16, JColorspace.Monochrome, JChroma.Monochrome)
    still.set_plane(JChannel.Y, np.zeros((16, 16), np.uint8), 8)
    jctx.encode_image(still, fmt="unci")
    ctx, jctx = both(jctx.write())
    assert not ctx.has_sequence() and ctx.tracks == []
    assert ctx.sequence_timescale() == jctx.sequence_timescale()
    assert ctx.sequence_duration() == 0


def test_streaming_reader_reads_tracks():
    """Through a streaming reader the moov is read at open, and samples
    by their byte ranges."""
    blob = visual_file("hevc", n=2, w=32, h=32)
    ctx = HeifContext.read_from_reader(MemoryReader(blob), device="cpu")
    ref = HeifContext.read_from_bytes(blob, device="cpu")
    assert_same_tables(ctx.tracks[0], ref.tracks[0])
    for i in range(2):
        a, b = ctx.tracks[0].decode_sample(i), ref.tracks[0].decode_sample(i)
        assert torch.equal(a.plane("Y"), b.plane("Y"))


def test_moov_boxes_write_back_unchanged():
    """Every box of the moov tree parses and writes its payload: the
    port's moov of a JAX-written file (TAI, GIMI, an alpha aux track, a
    metadata track, ctts, an edit list) serialises to the same bytes."""
    opts = TrackOptions(timescale=30, with_tai_timestamps=1,
                        tai_clock_info=JTaiClockInfo(clock_type=1),
                        with_gimi_content_ids=1,
                        gimi_track_content_id="urn:uuid:x",
                        inter_frames="ibp")
    jctx = JaxContext()
    jctx.set_number_of_sequence_repetitions(2)
    tw = jctx.add_visual_track(64, 64, fmt="hevc", options=opts)
    at = jctx.add_visual_track(64, 64, fmt="unc", timescale=30,
                               handler="auxv",
                               aux_type_urn=AUX_TYPE_ALPHA_MPEGB)
    at.add_reference_to_track("auxl", tw.track_id)
    mt = jctx.add_uri_metadata_track("urn:test:m", timescale=30)
    for i in range(3):
        tw.add_frame(moving(i), duration=1, tai=JTaiPacket(tai_timestamp=i),
                     gimi_content_id=f"s{i}")
        a = JaxImage(64, 64, JColorspace.Monochrome, JChroma.Monochrome)
        a.set_plane(JChannel.Y, np.full((64, 64), 9 * i, np.uint8), 8)
        at.add_frame(a, duration=1)
        mt.add_metadata_sample(bytes([i]) * 3, duration=1)
    blob = jctx.write()
    ctx = HeifContext.read_from_bytes(blob, device="cpu")
    moov = ctx.file.moov
    start = bytes(blob).index(b"moov") - 4
    size = int.from_bytes(blob[start:start + 4], "big")
    assert moov.serialize() == bytes(blob[start:start + size])
    again = read_box(ByteReader(moov.serialize()), SecurityLimits(), 0)
    assert again.serialize() == moov.serialize()
    assert len(ctx.tracks) == 3
    assert ctx.tracks[1].coding == "uncv" and ctx.tracks[1].is_alpha_aux()


def test_unported_codings_raise_by_name():
    """A track of a codec the port does not decode (j2ki: the JAX package
    has no decoder for it; here a vvc1 track's sample entry renamed)
    raises Unsupported naming it; its tables still read.  The vvc1 track
    itself decodes as in the JAX package."""
    blob = visual_file("vvc", n=1, w=32, h=32)
    ctx, jctx = both(blob)
    assert ctx.tracks[0].coding == "vvc1"
    assert_same_image(ctx.tracks[0].decode_sample(0),
                      jctx.tracks[0].decode_sample(0), "vvc1 sample 0")
    at = blob.index(b"stsd") + 16
    assert blob[at:at + 4] == b"vvc1"
    ctx, jctx = both(blob[:at] + b"j2ki" + blob[at + 4:])
    t = ctx.tracks[0]
    assert t.coding == "j2ki"
    assert_same_tables(t, jctx.tracks[0])
    with pytest.raises(HeifError, match="JPEG 2000") as e:
        t.decode_sample(0)
    assert e.value.code == ErrorCode.Unsupported_feature


def test_tracks_default_to_cuda(monkeypatch):
    """A context opened without device= (CUDA) raises without a card."""
    blob = visual_file("hevc", n=1, w=32, h=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HeifContext.read_from_bytes(blob)
