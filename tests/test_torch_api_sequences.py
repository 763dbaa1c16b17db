"""The port's C-named sequence API against the JAX package's, on the CPU.

Tracks written through both packages' API (visual tracks of hevc intra
and ipp frames, jpeg and uncv frames with per-sample TAI timestamps and
GIMI content ids, a URI metadata track referring to the visual track,
raw samples copied from one file into another) are equal byte for byte;
every read of the sequence API answers the same, and the frames that
heif_track_decode_next_image gives are equal sample for sample (it
ignores ``colorspace`` and ``chroma`` in both, ROADMAP §3 D).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
import jax_native  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.codecs.hevc import inter_cases  # noqa: E402

SIDES = ((japi, lambda im: im, {}), (papi, af.port_image, {"device": "cpu"}))


def frames(w, h, n, seed):
    from libheif_tpu.image.pixel_image import PixelImage
    out = []
    for y, cb, cr in inter_cases.panning_scene(w, h, n, seed):
        img = PixelImage(w, h, "YCbCr", "420")
        for ch, p in (("Y", y), ("Cb", cb), ("Cr", cr)):
            img.set_plane(ch, p, 8)
        out.append(img)
    return out


def track_file(api, image, kw, fmt, gop):
    ctx = api.heif_context_alloc(**kw)
    api.heif_context_set_sequence_timescale(ctx, 30)
    api.heif_context_set_number_of_sequence_repetitions(ctx, 2)
    opts = api.heif_track_options_alloc()
    api.heif_track_options_set_timescale(opts, 30)
    api.heif_track_options_set_gop_structure(opts, gop)
    clock = api.heif_tai_clock_info_alloc()
    clock.clock_resolution = 1000
    api.heif_track_options_enable_sample_tai_timestamps(
        opts, clock, api.heif_sample_aux_info_presence_optional)
    api.heif_track_options_enable_sample_gimi_content_ids(
        opts, api.heif_sample_aux_info_presence_mandatory)
    api.heif_track_options_set_gimi_track_id(opts, "urn:uuid:track")
    api.heif_track_options_set_interleaved_sample_aux_infos(opts, False)
    tw = api.heif_context_add_visual_sequence_track(ctx, 64, 48, "vide",
                                                    fmt, opts)
    seq = api.heif_sequence_encoding_options_alloc()
    seq2 = api.heif_sequence_encoding_options_copy(seq)
    for i, f in enumerate(frames(64, 48, 3, 7)):
        img = image(f)
        api.heif_image_set_duration(img, 2 + i)
        if i != 1:
            ts = api.heif_tai_timestamp_packet_alloc()
            ts.tai_timestamp = 1000 + i
            api.heif_image_set_tai_timestamp(img, ts)
        api.heif_image_set_gimi_sample_content_id(img, f"urn:uuid:s{i}")
        api.heif_track_encode_sequence_image(tw, img, None, seq2)
    api.heif_track_encode_end_of_sequence(tw)
    mopts = api.heif_track_options_alloc()
    api.heif_track_options_set_timescale(mopts, 30)
    mt = api.heif_context_add_uri_metadata_sequence_track(
        ctx, "urn:example:telemetry", mopts)
    mt.add_metadata_sample(b"gps=1,2", 3)
    api.heif_track_add_reference_to_track(mt, "cdsc", tw.track_id)
    api.heif_sequence_encoding_options_release(seq)
    api.heif_track_options_release(opts)
    return api.heif_context_write(ctx)


CASES = (("hevc", "intra"), ("hevc", "ipp"), ("jpeg", ""), ("unc", ""))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(
    x for x in c if x))
def written(request):
    fmt, gop = request.param
    blobs = [track_file(api, image, kw, fmt, gop)
             for api, image, kw in SIDES]
    return request.param, blobs


def test_track_files_equal_jax(written):
    _, (jblob, pblob) = written
    assert jblob == pblob


def call(fn, *args):
    """af.call, with any other error as its type (the JAX track calls
    raise AttributeError on a track of the other kind; the port's too)."""
    try:
        return af.call(fn, *args)
    except Exception as e:  # noqa: BLE001 -- compared by type
        return ["raised", type(e).__name__]


def track_reads(api, ctx):
    out = {name: af.call(getattr(api, name), ctx) for name in (
        "heif_context_has_sequence", "heif_context_get_sequence_timescale",
        "heif_context_get_sequence_duration",
        "heif_context_number_of_sequence_tracks",
        "heif_context_get_track_ids")}
    for tid in api.heif_context_get_track_ids(ctx) + [0]:
        t = api.heif_context_get_track(ctx, tid)
        out[f"track_{tid}"] = [call(getattr(api, name), t) for name in (
            "heif_track_get_id", "heif_track_get_track_handler_type",
            "heif_track_get_timescale",
            "heif_track_get_number_of_repetitions",
            "heif_track_get_duration_in_media_units",
            "heif_track_get_number_of_output_samples",
            "heif_track_get_image_resolution",
            "heif_track_get_auxiliary_info_type",
            "heif_track_get_auxiliary_info_type_urn",
            "heif_track_has_alpha_channel",
            "heif_track_get_sample_entry_type_of_first_cluster",
            "heif_track_get_urim_sample_entry_uri_of_first_cluster",
            "heif_track_get_number_of_sample_aux_infos",
            "heif_track_get_sample_aux_info_types",
            "heif_track_get_gimi_track_content_id",
            "heif_track_get_tai_clock_info_of_first_cluster",
            "heif_track_get_number_of_track_reference_types",
            "heif_track_get_track_reference_types")] + [
            call(api.heif_track_get_number_of_track_reference_of_type,
                    t, "cdsc"),
            call(api.heif_track_get_references_from_track, t, "cdsc"),
            call(api.heif_track_find_referring_tracks, ctx, t, "cdsc")]
    return out


def test_track_reads_match_jax(written):
    _, (blob, _) = written
    got = []
    for api, _, kw in SIDES:
        ctx = api.heif_context_alloc(**kw)
        api.heif_context_read_from_memory(ctx, blob)
        got.append(track_reads(api, ctx))
    assert got[0] == got[1]
    assert got[0]["heif_context_number_of_sequence_tracks"] == 2


def decoded(api, kw, blob):
    ctx = api.heif_context_alloc(**kw)
    api.heif_context_read_from_memory(ctx, blob)
    t = api.heif_context_get_track(ctx, 0)
    out = []
    while True:
        img = api.heif_track_decode_next_image(t, "RGB", "interleaved RGB")
        if img is None:
            return out
        out.append(img)


def test_decode_next_image_matches_jax(written):
    """Each frame equal, in its coded colorspace (the colour arguments are
    ignored in both), with its duration, TAI timestamp and GIMI id."""
    (fmt, _), (blob, _) = written
    jimgs, pimgs = (decoded(api, kw, blob) for api, _, kw in SIDES)
    assert len(jimgs) == len(pimgs) == 3
    for j, p in zip(jimgs, pimgs):
        af.assert_same_image(j, p)
        assert p.colorspace != "RGB"
        for fn in ("heif_image_get_duration", "heif_image_get_tai_timestamp",
                   "heif_image_get_gimi_sample_content_id"):
            assert af.plain(getattr(papi, fn)(p)) == \
                af.plain(getattr(japi, fn)(j)), fn
        assert all(t.device.type == "cpu" for t in p.planes.values())


def raw_copy(api, kw, blob):
    ctx = api.heif_context_alloc(**kw)
    api.heif_context_read_from_memory(ctx, blob)
    t = api.heif_context_get_track(ctx, 0)
    out = api.heif_context_alloc(**kw)
    tw = api.heif_context_add_visual_sequence_track(out, 64, 48, "vide",
                                                    "hevc")
    tw.config_box = t._config_box()
    answers = []
    while True:
        s = api.heif_track_get_next_raw_sequence_sample(t)
        if s is None:
            break
        answers.append([af.plain(getattr(
            api, f"heif_raw_sequence_sample_{name}")(s)) for name in (
                "get_data_size", "get_duration", "has_tai_timestamp",
                "get_tai_timestamp", "get_gimi_sample_content_id")])
        c = api.heif_raw_sequence_sample_alloc()
        api.heif_raw_sequence_sample_set_data(
            c, api.heif_raw_sequence_sample_get_data(s))
        api.heif_raw_sequence_sample_set_duration(c, 5)
        api.heif_raw_sequence_sample_set_tai_timestamp(
            c, api.heif_raw_sequence_sample_get_tai_timestamp(s))
        api.heif_raw_sequence_sample_set_gimi_sample_content_id(c, "urn:c")
        api.heif_track_add_raw_sequence_sample(tw, c)
        api.heif_raw_sequence_sample_release(c)
    return answers, api.heif_context_write(out)


@pytest.mark.parametrize("gop", ("intra", "ipp"))
def test_raw_samples_match_jax(gop):
    blob = track_file(japi, lambda im: im, {}, "hevc", gop)
    got = [raw_copy(api, kw, blob) for api, _, kw in SIDES]
    assert got[0] == got[1]
    assert [a[4] for a in got[0][0]] == ["urn:uuid:s0", "urn:uuid:s1",
                                         "urn:uuid:s2"]


def test_track_option_errors_match_jax():
    out = []
    for api, _, _ in SIDES:
        opts = api.heif_track_options_alloc()
        got = [af.call(api.heif_track_options_set_gop_structure, opts, g)
               for g in ("", "intra", "ipp", "bpyr", "nope")]
        got.append(opts.inter_frames)
        s = api.heif_raw_sequence_sample_alloc()
        got.append([api.heif_raw_sequence_sample_get_data_size(s),
                    api.heif_raw_sequence_sample_has_tai_timestamp(s)])
        out.append(got)
    assert out[0] == out[1]


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    jax_native.ensure_loaded()
