"""The port's track writers against the JAX package's, on the CPU.

Each case drives the same calls on a JAX ``HeifContext`` and on the
port's (``device="cpu"``) with the same frames, made with numpy from a
seed: ``add_visual_track`` (hevc all-intra and inter in all four GOP
structures, av1, jpeg, unc), ``add_uri_metadata_track``, TAI timestamps
and GIMI content ids (mandatory and optional), an alpha aux track with
its ``auxl`` reference, the sequence timescale and repetitions (the
indefinite 0xFFFFFFFF too), raw samples, a still beside a track.  The
port's ``write()`` must give the JAX writer's bytes, a second ``write()``
the same bytes, and both packages must reopen the file to the same
tracks, sample tables and frames.  These are the calls of
tests/test_sequences.py's ten tests and of tests/test_hevc_bframes.py's
track tests.  A duration of 0 and a missing mandatory TAI timestamp raise
in both.

``python -m tests.test_torch_track_write --write-fixtures`` writes
``libheif_tpu_torch/testdata/seq/encode_manifest.json``: the SHA-256 of
the inter tracks that chip_smoke.py encodes on the card (CIF and QCIF
panning scenes), each written here by the JAX writer.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from libheif_tpu.boxes.meta import (TaiClockInfo as JTaiClockInfo,
                                    TaiTimestampPacket as JTaiPacket)
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.core.error import HeifError as JHeifError
from libheif_tpu.image.pixel_image import PixelImage as JaxImage
from libheif_tpu.sequences import track as jtrack
from libheif_tpu_torch import HeifContext
from libheif_tpu_torch.boxes.meta import TaiClockInfo, TaiTimestampPacket
from libheif_tpu_torch.codecs.hevc.inter_cases import panning_scene
from libheif_tpu_torch.core import trace
from libheif_tpu_torch.core.error import HeifError, SubError
from libheif_tpu_torch.image.pixel_image import from_numpy_planes
from libheif_tpu_torch.sequences import track as ptrack
from tests.test_torch_sequences import assert_same_image, assert_same_tables

MANIFEST = os.path.join(os.path.dirname(__file__), "..",
                        "libheif_tpu_torch", "testdata", "seq",
                        "encode_manifest.json")

# the inter tracks chip_smoke.py encodes on the card: name -> (width,
# height, frames, GOP structure); quality 50, 30 frames a second, the
# panning scene of seed 20 and step (3, 1)
CARD_TRACKS = {
    "cif-bpyr": (352, 288, 9, "bpyr"),
    "qcif-ipp": (176, 144, 5, "ipp"),
    "qcif-ldb": (176, 144, 5, "ldb"),
    "qcif-ibp": (176, 144, 5, "ibp"),
}
CARD_SEED = 20


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    # the JAX native HEVC engine's pipeline is not safe under load
    # (ROADMAP §3); one torch thread a process under xdist
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Jax:
    """The JAX package's side of a case."""
    TrackOptions = jtrack.TrackOptions
    RawSample = jtrack.RawSequenceSample
    Tai = JTaiPacket
    Clock = JTaiClockInfo
    Error = JHeifError

    @staticmethod
    def context():
        return JaxContext()

    @staticmethod
    def reopen(blob):
        return JaxContext.read_from_bytes(blob)

    @staticmethod
    def image(planes, colorspace="YCbCr", chroma="420", bits=8):
        h, w = planes[next(iter(planes))].shape
        img = JaxImage(w, h, colorspace, chroma)
        for ch, a in planes.items():
            img.set_plane(ch, a, bits)
        return img


class Port:
    """The port's side of a case, on the CPU."""
    TrackOptions = ptrack.TrackOptions
    RawSample = ptrack.RawSequenceSample
    Tai = TaiTimestampPacket
    Clock = TaiClockInfo
    Error = HeifError

    @staticmethod
    def context():
        return HeifContext(device="cpu")

    @staticmethod
    def reopen(blob):
        return HeifContext.read_from_bytes(blob, device="cpu")

    @staticmethod
    def image(planes, colorspace="YCbCr", chroma="420", bits=8):
        return from_numpy_planes(planes, {c: bits for c in planes},
                                 colorspace, chroma, device="cpu")


def seq_frame(i, w=64, h=64):
    """tests/test_sequences.py's _frame: noise luma, flat chroma."""
    rng = np.random.default_rng(100 + i)
    y = (rng.integers(0, 200, (h, w), np.uint8) + 10 * i).astype(np.uint8)
    return {"Y": y,
            "Cb": np.full((h // 2, w // 2), 90 + 20 * i, np.uint8),
            "Cr": np.full((h // 2, w // 2), 150 - 20 * i, np.uint8)}


def pan_frame(f):
    return dict(zip(("Y", "Cb", "Cr"), f))


def mono(value, w=64, h=64):
    return {"Y": np.full((h, w), value, np.uint8)}


# ----------------------------------------------------------------- cases
# each takes a side (Jax or Port) and returns its context, ready to write

def case_intra(pk, fmt="hevc", n=3, w=64, h=64):
    ctx = pk.context()
    tw = ctx.add_visual_track(w, h, fmt=fmt, timescale=30)
    for i in range(n):
        tw.add_frame(pk.image(seq_frame(i, w, h)), duration=1 + i % 2)
    return ctx


def case_inter(pk, gop="ipp", n=5, w=64, h=64, seed=3):
    ctx = pk.context()
    tw = ctx.add_visual_track(w, h, fmt="hevc", options=pk.TrackOptions(
        timescale=30, inter_frames=gop))
    for f in panning_scene(w, h, n, seed):
        tw.add_frame(pk.image(pan_frame(f)), duration=1)
    return ctx


def case_inter_true(pk):
    """inter_frames=True means "ipp" (test_visual_track_inter_frames)."""
    ctx = pk.context()
    tw = ctx.add_visual_track(64, 64, fmt="hevc", options=pk.TrackOptions(
        timescale=30, inter_frames=True))
    for f in panning_scene(64, 64, 5, seed=4, step=(2, 1), noise=0):
        tw.add_frame(pk.image(pan_frame(f)), duration=1)
    return ctx


def case_sequential_reader(pk):
    ctx = pk.context()
    tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    for i in range(2):
        tw.add_frame(pk.image(seq_frame(i, 32, 32)), duration=5)
    return ctx


def case_still_and_track(pk):
    ctx = pk.context()
    rng = np.random.default_rng(7)
    still = {c: rng.integers(0, 256, (16, 16), np.uint8)
             for c in ("Y", "Cb", "Cr")}
    ctx.encode_image(pk.image(still, chroma="444"), "unci")
    tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    tw.add_frame(pk.image(seq_frame(0, 32, 32)), duration=1)
    return ctx


def case_tai_gimi(pk, mandatory=True, inter=False):
    ctx = pk.context()
    opts = pk.TrackOptions(
        timescale=30, with_tai_timestamps=1 if mandatory else 2,
        tai_clock_info=pk.Clock(time_uncertainty=500, clock_resolution=1000,
                                clock_drift_rate=-2, clock_type=2),
        with_gimi_content_ids=1 if mandatory else 2,
        gimi_track_content_id="urn:uuid:track-level-id",
        inter_frames="ibp" if inter else False)
    tw = ctx.add_visual_track(64, 64, fmt="hevc", options=opts)
    base_ns = 2_145_916_800_000_000_000
    for i in range(4 if inter else 3):
        keep = mandatory or i % 2 == 0
        tw.add_frame(pk.image(seq_frame(i)), duration=1,
                     tai=pk.Tai(tai_timestamp=base_ns + i,
                                synchronization_state=True)
                     if keep else None,
                     gimi_content_id=f"urn:uuid:sample-{i}" if keep
                     else None)
    return ctx


def case_metadata_track(pk):
    ctx = pk.context()
    vt = ctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    vt.add_frame(pk.image(seq_frame(0, 32, 32)), duration=5)
    mt = ctx.add_uri_metadata_track("urn:test:telemetry", timescale=10)
    mt.add_metadata_sample(b"gps=1.5,2.5", duration=5)
    mt.add_metadata_sample(b"gps=1.6,2.4", duration=5)
    mt.add_reference_to_track("cdsc", vt.track_id)
    return ctx


def case_alpha_track(pk, fmt="hevc"):
    ctx = pk.context()
    vt = ctx.add_visual_track(64, 64, fmt="hevc", timescale=10)
    at = ctx.add_visual_track(64, 64, fmt=fmt, timescale=10,
                              handler="auxv",
                              aux_type_urn=ptrack.AUX_TYPE_ALPHA_MPEGB)
    at.add_reference_to_track("auxl", vt.track_id)
    for i in range(2):
        vt.add_frame(pk.image(seq_frame(i)), duration=1)
        at.add_frame(pk.image(mono(30 + 100 * i), "monochrome",
                              "monochrome"), duration=1)
    return ctx


def case_repetitions(pk, reps=5, timescale=30):
    ctx = pk.context()
    ctx.set_sequence_timescale(timescale)
    ctx.set_number_of_sequence_repetitions(reps)
    tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=30)
    for i in range(2):
        tw.add_frame(pk.image(seq_frame(i, 32, 32)), duration=3)
    return ctx


def case_raw_samples(pk):
    """A track of raw samples: an hvc1 sample copied from a written
    file, with the source track's hvcC, and a sync flag off."""
    src = case_intra(pk, n=2, w=32, h=32).write()
    t = pk.reopen(src).tracks[0]
    ctx = pk.context()
    tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
    tw.config_box = t._config_box()
    for k in range(2):
        raw = t.get_next_raw_sample()
        tw.add_raw_sample(pk.RawSample(data=raw.data, duration=4,
                                       is_sync=k == 0))
    return ctx


def case_everything(pk):
    """A still, an ibp track with mandatory TAI/GIMI, a metadata track,
    an alpha aux track, 3 repetitions, timescale 25."""
    ctx = case_still_and_track(pk)
    ctx.set_number_of_sequence_repetitions(3)
    ctx.set_sequence_timescale(25)
    opts = pk.TrackOptions(timescale=25, with_tai_timestamps=1,
                           tai_clock_info=pk.Clock(clock_type=1),
                           with_gimi_content_ids=1,
                           gimi_track_content_id="urn:uuid:x",
                           inter_frames="ibp")
    tw = ctx.add_visual_track(64, 64, fmt="hevc", options=opts)
    at = ctx.add_visual_track(64, 64, fmt="unc", timescale=25,
                              handler="auxv",
                              aux_type_urn=ptrack.AUX_TYPE_ALPHA_MPEGB)
    at.add_reference_to_track("auxl", tw.track_id)
    mt = ctx.add_uri_metadata_track("urn:test:m", timescale=25)
    for i, f in enumerate(panning_scene(64, 64, 3, seed=6)):
        tw.add_frame(pk.image(pan_frame(f)), duration=1,
                     tai=pk.Tai(tai_timestamp=i), gimi_content_id=f"s{i}")
        at.add_frame(pk.image(mono(9 * i), "monochrome", "monochrome"),
                     duration=1)
        mt.add_metadata_sample(bytes([i]) * 3, duration=1)
    return ctx


CASES = {
    # the calls of tests/test_sequences.py's ten tests
    "visual-roundtrip": case_intra,
    "sequential-reader": case_sequential_reader,
    "still-and-track": case_still_and_track,
    "tai-gimi": case_tai_gimi,
    "tai-gimi-optional": lambda pk: case_tai_gimi(pk, mandatory=False),
    "metadata-track": case_metadata_track,
    "alpha-track": case_alpha_track,
    "repetitions-timescale": case_repetitions,
    "raw-samples": case_raw_samples,
    "inter-frames-true": case_inter_true,
    # tests/test_hevc_bframes.py's tracks and every GOP structure
    "ipp": lambda pk: case_inter(pk, "ipp"),
    "ldb": lambda pk: case_inter(pk, "ldb", n=4, seed=37),
    "ibp": lambda pk: case_inter(pk, "ibp", n=6, seed=31),
    "bpyr": lambda pk: case_inter(pk, "bpyr", n=6, seed=41),
    "bpyr-9": lambda pk: case_inter(pk, "bpyr", n=9, seed=19),
    # the other codecs, and what a track can carry
    "av1": lambda pk: case_intra(pk, "av1", n=2, w=32, h=32),
    "jpeg": lambda pk: case_intra(pk, "jpeg"),
    "unc": lambda pk: case_intra(pk, "unc"),
    "tai-gimi-ibp": lambda pk: case_tai_gimi(pk, inter=True),
    "alpha-unc-track": lambda pk: case_alpha_track(pk, "unc"),
    "repeat-forever": lambda pk: case_repetitions(pk, 0xFFFFFFFF, 0),
    "repeat-once": lambda pk: case_repetitions(pk, 1, 600),
    "everything": case_everything,
}


def assert_same_reopened(blob):
    """Both packages reopen ``blob`` to the same sequence, tracks,
    tables, aux info and frames (every sample by random access, then in
    order through decode_next_image for visual tracks)."""
    ctx = HeifContext.read_from_bytes(blob, device="cpu")
    jctx = JaxContext.read_from_bytes(blob)
    assert ctx.has_sequence() == jctx.has_sequence()
    assert (ctx.sequence_timescale(), ctx.sequence_duration()) == \
        (jctx.sequence_timescale(), jctx.sequence_duration())
    assert len(ctx.tracks) == len(jctx.tracks)
    for t, j in zip(ctx.tracks, jctx.tracks):
        assert_same_tables(t, j)
        if isinstance(t, ptrack.TrackMetadata):
            assert t.uri() == j.uri()
            assert [t.metadata_sample(i) for i in range(t.num_samples)] \
                == [j.metadata_sample(i) for i in range(j.num_samples)]
            continue
        assert t.gimi_track_content_id() == j.gimi_track_content_id()
        assert (t.tai_clock_info() is None) == (j.tai_clock_info() is None)
        for i in range(t.num_samples):
            assert t.sample_gimi_content_id(i) == j.sample_gimi_content_id(i)
            a, b = t.sample_tai_timestamp(i), j.sample_tai_timestamp(i)
            assert (a is None and b is None) or \
                a.tai_timestamp == b.tai_timestamp
            assert_same_image(t.decode_sample(i), j.decode_sample(i),
                              f"track {t.track_id} sample {i}")
        if getattr(j, "alpha_track", None) is not None:
            assert t.alpha_track.track_id == j.alpha_track.track_id
            t.seek(0)
            j.seek(0)
            assert_same_image(t.decode_next_image(), j.decode_next_image(),
                              f"track {t.track_id} with alpha")
    for iid in ctx.top_level_image_ids():
        assert_same_image(ctx.decode_image(iid), jctx.decode_image(iid),
                          f"item {iid}")
    return ctx


# Cases whose reordering lookahead still holds frames at the first write:
# the JAX writer sums the mvhd duration before the trak's finalize drains
# them (context.py:185-202), so its first file's mvhd misses their
# duration and a second write differs from the first (ROADMAP §3 D).
# The port writes the same bytes each time.
LOOKAHEAD_AT_WRITE = {"ibp", "bpyr", "tai-gimi-ibp"}


@pytest.mark.parametrize("name", list(CASES))
def test_track_file_matches_jax(name):
    """The port's file equals the JAX writer's, a second write gives the
    same bytes (but where the JAX writer's does not), and both packages
    reopen it alike."""
    jctx, pctx = CASES[name](Jax), CASES[name](Port)
    want = [jctx.write(), jctx.write()]
    got = [pctx.write(), pctx.write()]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert (got[1] == got[0]) == (name not in LOOKAHEAD_AT_WRITE)
    assert pctx.has_sequence()
    for blob in got[:2 if name in LOOKAHEAD_AT_WRITE else 1]:
        assert_same_reopened(blob)


def test_inter_track_spans_and_dpb():
    """An ibp track written on the CPU: the spans split the encode, the
    sync flags and composition offsets are those of the GOP, and every
    frame reopened in display order equals the encoder's DPB picture
    where the picture is a reference one."""
    ctx = Port.context()
    tw = ctx.add_visual_track(64, 64, fmt="hevc", options=Port.TrackOptions(
        timescale=30, inter_frames="ibp"))
    recon = {}
    with trace.collect() as spans:
        for f in panning_scene(64, 64, 5, seed=3):
            tw.add_frame(Port.image(pan_frame(f)), duration=1)
            recon.update(dict(tw._enc_session.enc.dpb))
        blob = ctx.write()
        recon.update(dict(tw._enc_session.enc.dpb))
    assert spans["track.write"]["count"] == 5
    assert spans["track.write.finalize"]["count"] == 1
    assert spans["hevc.encode.seq.recon"]["count"] == 3    # I0 P2 P4
    t = HeifContext.read_from_bytes(blob, device="cpu").tracks[0]
    assert [s.pts for s in t.samples] == [0, 2, 1, 4, 3]
    assert sorted(recon) == [0, 2, 4]
    for i, planes in recon.items():
        img = t.decode_sample(i)
        for ch, p in zip(("Y", "Cb", "Cr"), planes):
            got = img.plane(ch).to(torch.int32).numpy()
            np.testing.assert_array_equal(got, p[:got.shape[0],
                                                 :got.shape[1]])


def test_duration_zero_raises_as_jax():
    for pk in (Jax, Port):
        ctx = pk.context()
        tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=10)
        with pytest.raises(pk.Error, match="duration may not be 0"):
            tw.add_frame(pk.image(seq_frame(0, 32, 32)), duration=0)
        mt = ctx.add_uri_metadata_track("urn:x", timescale=10)
        with pytest.raises(pk.Error, match="duration may not be 0"):
            mt.add_metadata_sample(b"x", duration=0)
        with pytest.raises(pk.Error, match="duration may not be 0"):
            tw.add_raw_sample(pk.RawSample(data=b"x", duration=0))


def test_missing_mandatory_aux_raises_as_jax():
    for pk in (Jax, Port):
        for kw, what in (({"with_tai_timestamps": 1}, "TAI timestamp"),
                         ({"with_gimi_content_ids": 1}, "ContentID")):
            ctx = pk.context()
            tw = ctx.add_visual_track(32, 32, fmt="hevc",
                                      options=pk.TrackOptions(timescale=10,
                                                              **kw))
            with pytest.raises(pk.Error, match=f"Mandatory {what} missing"):
                tw.add_frame(pk.image(seq_frame(0, 32, 32)), duration=1)


@pytest.mark.parametrize("fmt", ["vvc", "j2k"])
def test_host_only_track_codecs_refused_by_name(fmt):
    """j2k tracks are refused by name (the JAX package writes a j2ki
    entry it cannot fill); vvc tracks are ported and write a vvc1 sample
    entry, as the JAX writer does."""
    if fmt == "vvc":
        for pk in (Jax, Port):
            tw = pk.context().add_visual_track(32, 32, fmt=fmt)
            assert tw.sample_entry_type == "vvc1"
        return
    with pytest.raises(HeifError) as e:
        Port.context().add_visual_track(32, 32, fmt=fmt)
    assert e.value.subcode == SubError.Unsupported_codec
    assert fmt in str(e.value)


def test_writer_timescale_and_ids_as_jax():
    """Track ids count up from 1, the timescale argument overrides the
    options', a context without a file makes one."""
    for pk in (Jax, Port):
        ctx = pk.context()
        a = ctx.add_visual_track(16, 16, fmt="unc", timescale=12)
        b = ctx.add_uri_metadata_track("urn:y",
                                       options=pk.TrackOptions(timescale=7))
        c = ctx.add_visual_track(16, 16, fmt="unc",
                                 options=pk.TrackOptions(timescale=5),
                                 timescale=9)
        assert [w.track_id for w in (a, b, c)] == [1, 2, 3]
        assert [w.timescale for w in (a, b, c)] == [12, 7, 9]
        assert ctx.has_sequence() and ctx.sequence_timescale() == 90000


def card_track_blobs():
    """The JAX writer's files of CARD_TRACKS (chip_smoke.py phase 4j)."""
    from libheif_tpu.option_types import EncodingOptions as JOpts
    out = {}
    for name, (w, h, n, gop) in CARD_TRACKS.items():
        ctx = JaxContext()
        tw = ctx.add_visual_track(w, h, fmt="hevc",
                                  options=jtrack.TrackOptions(
                                      timescale=30, inter_frames=gop))
        for f in panning_scene(w, h, n, CARD_SEED):
            tw.add_frame(Jax.image(pan_frame(f)), duration=1,
                         options=JOpts(quality=50))
        out[name] = ctx.write()
    return out


def test_card_manifest_entries():
    """The manifest names every card track, with its shape, and a
    SHA-256 of 64 hex digits."""
    with open(MANIFEST) as f:
        man = json.load(f)
    assert man["seed"] == CARD_SEED
    assert sorted(man["tracks"]) == sorted(CARD_TRACKS)
    for name, (w, h, n, gop) in CARD_TRACKS.items():
        e = man["tracks"][name]
        assert (e["width"], e["height"], e["frames"], e["gop"]) == \
            (w, h, n, gop)
        assert len(e["sha256"]) == 64


def write_fixtures() -> None:
    man = {"seed": CARD_SEED, "quality": 50, "step": [3, 1],
           "writer": "libheif_tpu HeifContext.add_visual_track",
           "tracks": {}}
    for name, blob in card_track_blobs().items():
        w, h, n, gop = CARD_TRACKS[name]
        man["tracks"][name] = {"width": w, "height": h, "frames": n,
                               "gop": gop, "bytes": len(blob),
                               "sha256": hashlib.sha256(blob).hexdigest()}
        print(name, len(blob), man["tracks"][name]["sha256"])
    with open(MANIFEST, "w") as f:
        json.dump(man, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
    else:
        sys.exit("usage: python -m tests.test_torch_track_write "
                 "--write-fixtures")
