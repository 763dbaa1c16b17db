"""The port's C-named API write side against the JAX package's, on the CPU:
encoding (heif_context_encode_image, thumbnails, overlay, the encoder
parameter introspection), tiling (grids from handles and from
heif_context_encode_grid, tili images, tiles decoded one at a time) and
uncompressed (heif_context_add_empty_unci_image).  The same seeded
images go through both packages' calls: the written files are equal
byte for byte, and every image read back through either package's API
is equal sample for sample.
"""

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
import jax_native  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.api import encoding as JE  # noqa: E402
from libheif_tpu.codecs import registry as jreg  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.api import encoding as PE  # noqa: E402

FORMATS = ("jpeg", "hevc", "unci", "avc", "av1")
SIZES = {"av1": (32, 32)}


def both():
    return ((japi, japi.heif_context_alloc(), lambda im: im),
            (papi, papi.heif_context_alloc(device="cpu"), af.port_image))


def read_back(api, blob, **kw):
    ctx = api.heif_context_alloc(**kw)
    api.heif_context_read_from_memory(ctx, blob)
    return ctx


def contexts(blob):
    return read_back(japi, blob), read_back(papi, blob, device="cpu")


def assert_decodes_equal(blob, ids=None, tiles=()):
    """Every image of ``blob`` (or ``ids``) and the tiles ``tiles`` of the
    primary decoded through both packages' API: equal."""
    jc, pc = contexts(blob)
    if ids is None:
        ids = japi.heif_context_get_list_of_top_level_image_IDs(jc)
    for iid in ids:
        jh = japi.heif_context_get_image_handle(jc, iid)
        ph = papi.heif_context_get_image_handle(pc, iid)
        af.assert_same_image(japi.heif_decode_image(jh),
                             papi.heif_decode_image(ph))
    jh = japi.heif_context_get_primary_image_handle(jc)
    ph = papi.heif_context_get_primary_image_handle(pc)
    for tx, ty in tiles:
        af.assert_same_image(
            japi.heif_image_handle_decode_image_tile(jh, "undefined",
                                                     "undefined", None,
                                                     tx, ty),
            papi.heif_image_handle_decode_image_tile(ph, "undefined",
                                                     "undefined", None,
                                                     tx, ty))
    return jc, pc


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_image_and_thumbnail_match_jax(fmt):
    w, h = SIZES.get(fmt, (64, 48))
    blobs = []
    for api, ctx, image in both():
        enc = api.heif_context_get_encoder_for_format(ctx, fmt)
        api.heif_encoder_set_lossy_quality(enc, 70)
        img = image(af.gradient(w, h, 3, alpha=fmt != "av1"))
        hd = api.heif_context_encode_image(ctx, img, enc)
        th = api.heif_context_encode_thumbnail(ctx, img, hd, enc, None, 16)
        assert th is not None
        # a box at least as large as the image makes no thumbnail
        assert api.heif_context_encode_thumbnail(ctx, img, hd, enc, None,
                                                 max(w, h)) is None
        blobs.append(api.heif_context_write(ctx))
    assert blobs[0] == blobs[1]
    jc, pc = assert_decodes_equal(blobs[0])
    thumbs = japi.heif_image_handle_get_list_of_thumbnail_IDs(
        japi.heif_context_get_primary_image_handle(jc))
    assert len(thumbs) == 1
    assert_decodes_equal(blobs[0], ids=thumbs)


@pytest.mark.parametrize("fmt,registry_encoder", (
    ("jpeg", True), ("unci", True), ("hevc", True), ("hevc", False)))
def test_encode_grid_matches_jax(fmt, registry_encoder):
    """heif_context_encode_grid reads ``encoder.format``: the registry
    encoder's, or "hevc" for a heif_encoder, as in JAX."""
    blobs, answers = [], []
    for api, ctx, image in both():
        enc = api.heif_context_get_encoder_for_format(ctx, fmt)
        tiles = [image(af.gradient(32, 32, 10 + i)) for i in range(4)]
        hd = api.heif_context_encode_grid(
            ctx, tiles, 2, 2, enc.impl if registry_encoder else enc,
            api.heif_encoding_options_alloc())
        api.heif_context_set_primary_image(ctx, hd)
        blobs.append(api.heif_context_write(ctx))
    assert blobs[0] == blobs[1]
    jc, pc = assert_decodes_equal(blobs[0], tiles=[(0, 0), (1, 0), (1, 1)])
    for api, ctx in ((japi, jc), (papi, pc)):
        answers.append(grid_reads(api, ctx))
    assert answers[0] == answers[1]
    assert answers[0]["tiling"][1]["num_columns"] == 2


def test_encode_grid_usage_errors():
    """No tiles, or a count that is not rows x columns: a usage HeifError
    in the port; the JAX module names HeifError without importing it
    (ROADMAP §3 D), so its call raises NameError."""
    ctx = papi.heif_context_alloc(device="cpu")
    tiles = [af.port_image(af.gradient(8, 8, i)) for i in range(3)]
    for args in (([], 2, 2), (tiles, 2, 2), (tiles, 0, 3)):
        assert af.call(papi.heif_context_encode_grid, ctx, *args) == \
            ["HeifError", "Usage_error", "Unspecified"]
        with pytest.raises(NameError):
            japi.heif_context_encode_grid(japi.heif_context_alloc(), *args)


def grid_reads(api, ctx):
    hd = api.heif_context_get_primary_image_handle(ctx)
    out = {"tiling": af.call(api.heif_image_handle_get_image_tiling, hd)}
    out["ids"] = [af.call(api.heif_image_handle_get_grid_image_tile_id, hd,
                          True, tx, ty) for ty in (0, 1) for tx in (0, 1)]
    return out


def test_grid_from_handles_and_overlay_match_jax():
    blobs = []
    for api, ctx, image in both():
        enc = api.heif_context_get_encoder_for_format(ctx, "jpeg")
        handles = [api.heif_context_encode_image(
            ctx, image(af.gradient(32, 32, 20 + i)), enc) for i in range(4)]
        grid = api.heif_context_add_grid_image(ctx, 64, 64, 2, 2, handles)
        api.heif_context_set_primary_image(ctx, grid)
        ov = api.heif_context_add_overlay_image(
            ctx, 80, 72, [h.item_id for h in handles[:2]],
            [(0, 0), (40, 30)], (10, 20, 30, 255))
        thumb = api.heif_context_encode_image(
            ctx, image(af.gradient(16, 16, 25)), enc)
        api.heif_context_assign_thumbnail(ctx, grid, thumb)
        api.heif_context_set_unif(ctx, 0)
        assert ov.item_id > grid.item_id
        blobs.append(api.heif_context_write(ctx))
    assert blobs[0] == blobs[1]
    jc, _ = assert_decodes_equal(blobs[0], tiles=[(1, 1)])
    assert_decodes_equal(blobs[0], ids=japi.heif_context_get_list_of_item_IDs(
        jc)[-1:])


@pytest.mark.parametrize("fmt", ("unci", "hevc", "jpeg"))
def test_tiled_image_matches_jax(fmt):
    blobs = []
    for api, ctx, image in both():
        p = api.heif_tiled_image_parameters_alloc()
        p.image_width, p.image_height = 64, 48
        p.tile_width, p.tile_height = 32, 24
        enc = None if fmt == "unci" else \
            api.heif_context_get_encoder_for_format(ctx, fmt)
        hd = api.heif_context_add_tiled_image(ctx, p, None, enc)
        for ty in (0, 1):
            for tx in (0, 1):
                api.heif_context_add_image_tile(
                    ctx, hd, tx, ty,
                    image(af.gradient(32, 24, 30 + 2 * ty + tx)), enc)
        blobs.append(api.heif_context_write(ctx))
    assert blobs[0] == blobs[1]
    jc, pc = contexts(blobs[0])
    assert grid_reads(japi, jc)["tiling"] == grid_reads(papi, pc)["tiling"]
    assert_decodes_equal(blobs[0], ids=[],
                         tiles=[(0, 0), (1, 0), (0, 1), (1, 1)])


def test_empty_unci_image_matches_jax():
    blobs = []
    for api, ctx, image in both():
        p = api.heif_unci_image_parameters_alloc()
        p.image_width, p.image_height, p.tile_width, p.tile_height = \
            96, 64, 32, 32
        q = api.heif_unci_image_parameters_copy(p)
        assert q is not p and q.tile_width == 32
        hd = api.heif_context_add_empty_unci_image(ctx, p)
        for ty in range(2):
            for tx in range(3):
                api.heif_context_add_image_tile(
                    ctx, hd, tx, ty, image(af.gradient(32, 32, tx + 3 * ty)),
                    None)
        api.heif_unci_image_parameters_release(p)
        blobs.append(api.heif_context_write(ctx))
    assert blobs[0] == blobs[1]
    assert_decodes_equal(blobs[0], ids=[],
                         tiles=[(tx, ty) for ty in range(2)
                                for tx in range(3)])


def encoder_answers(api, mod, desc):
    enc = api.heif_context_get_encoder(None, desc)
    out = {"name": api.heif_encoder_get_name(enc),
           "params": af.plain(api.heif_encoder_list_parameters(enc))}
    for p in api.heif_encoder_list_parameters(enc):
        n = api.heif_encoder_parameter_get_name(p)
        t = api.heif_encoder_parameter_get_type(p)
        out[n] = [t] + [af.call(getattr(api, fn), enc, n) for fn in (
            "heif_encoder_get_parameter", "heif_encoder_has_default",
            "heif_encoder_parameter_integer_valid_range",
            "heif_encoder_parameter_string_valid_values",
            "heif_encoder_parameter_integer_valid_values",
            f"heif_encoder_get_parameter_{t}")]
    out["descriptor"] = [getattr(api, fn)(desc) for fn in (
        "heif_encoder_descriptor_get_name",
        "heif_encoder_descriptor_get_id_name",
        "heif_encoder_descriptor_get_compression_format",
        "heif_encoder_descriptor_supports_lossy_compression",
        "heif_encoder_descriptor_supports_lossless_compression",
        "heif_encoder_descriptor_supportes_lossy_compression",
        "heif_encoder_descriptor_supportes_lossless_compression")]
    return out


def test_encoder_parameter_listings_match_jax():
    """Every registered encoder's parameters, descriptors and defaults."""
    descs = japi.heif_get_encoder_descriptors()
    assert sorted(papi.heif_get_encoder_descriptors()) == sorted(descs)
    assert len(descs) >= 8
    for d in descs:
        assert encoder_answers(papi, PE, d) == encoder_answers(japi, JE, d), d
    for fmt in ("jpeg", "hevc", "nope", None):
        for flt in (None, "tpu"):
            assert sorted(papi.heif_context_get_encoder_descriptors(
                None, fmt, flt)) == sorted(
                    japi.heif_context_get_encoder_descriptors(None, fmt, flt))


def _typed(api):
    enc = api.heif_context_get_encoder_for_format(None, "unci")
    q = next(p for p in api.heif_encoder_list_parameters(enc)
             if p.name == "quality")
    return [isinstance(q, api.HeifEncoderParameter), q.type,
            q.have_minimum_maximum, (q.minimum, q.maximum), q["name"],
            q.get("maximum"), "minimum" in q, "valid_values" in q]


def _range(api):
    enc = api.heif_context_get_encoder_for_format(None, "unci")
    api.heif_encoder_set_parameter_integer(enc, "quality", 80)
    return [api.heif_encoder_get_parameter_integer(enc, "quality"),
            af.call(api.heif_encoder_set_parameter_integer, enc, "quality",
                    101),
            af.call(api.heif_encoder_set_parameter_integer, enc, "quality",
                    -1),
            af.call(api.heif_encoder_set_lossy_quality, enc, 101),
            af.call(api.heif_encoder_set_parameter, enc, "quality", "55"),
            api.heif_encoder_get_parameter(enc, "quality")]


def _strings(api):
    out = []
    for fmt in ("unci", "jpeg", "hevc", "av1", "avc"):
        enc = api.heif_context_get_encoder_for_format(None, fmt)
        for p in api.heif_encoder_list_parameters(enc):
            if p.type != "string":
                continue
            vals = list(p.valid_values or ())
            out.append([fmt, p.name, vals, af.call(
                api.heif_encoder_set_parameter_string, enc, p.name,
                "bogus")])
            if vals:
                api.heif_encoder_set_parameter_string(enc, p.name, vals[-1])
                out.append(api.heif_encoder_get_parameter_string(enc,
                                                                 p.name))
    return out


def _unknown(api):
    enc = api.heif_context_get_encoder_for_format(None, "jpeg")
    return [af.call(getattr(api, fn), enc, "nope", *args) for fn, args in (
        ("heif_encoder_set_parameter_integer", (1,)),
        ("heif_encoder_set_parameter_boolean", (True,)),
        ("heif_encoder_set_parameter_string", ("x",)),
        ("heif_encoder_get_parameter_integer", ()),
        ("heif_encoder_has_default", ()))] + [
        af.call(api.heif_context_get_encoder_for_format, None, "nope"),
        af.call(api.heif_context_get_encoder, None, ("nope", "x"))]


def _lossless(api):
    enc = api.heif_context_get_encoder_for_format(None, "unci")
    api.heif_encoder_set_lossless(enc, 1)
    api.heif_encoder_set_logging_level(enc, 2)
    api.heif_encoder_set_parameter(enc, "lossless", "off")
    api.heif_encoder_set_parameter_boolean(enc, "lossless", True)
    return [dict(enc.values),
            api.heif_encoder_get_parameter_boolean(enc, "lossless"),
            repr(enc).split("(")[1]]


@pytest.mark.parametrize("case", (_typed, _range, _strings, _unknown,
                                  _lossless))
def test_encoder_parameter_errors_match_jax(case):
    """TestEncoderParameterDescriptors' cases (typed descriptors, the
    integer range, the string sets) and the unknown-name errors, on both
    packages."""
    assert case(papi) == case(japi)


def test_encoding_helpers_match_jax():
    for api in (japi, papi):
        o = api.heif_encoding_options_alloc()
        o.quality = 73
        o2 = api.heif_encoding_options_copy(o)
        assert o2.quality == 73 and o2 is not o
        api.heif_encoding_options_free(o)
        api.heif_encoder_release(None)
    table = [[f(a, b) for a in range(1, 9) for b in range(1, 9)]
             for f in (japi.heif_orientation_concat,
                       papi.heif_orientation_concat)]
    assert table[0] == table[1]
    for param in ({"name": "q", "type": "integer", "minimum": 1,
                   "maximum": 9, "valid_values": [1, 5]},
                  {"name": "s", "type": "string",
                   "valid_values": ["a", "b"]}, object()):
        for fn in ("heif_encoder_parameter_get_valid_integer_range",
                   "heif_encoder_parameter_get_valid_integer_values",
                   "heif_encoder_parameter_get_valid_string_values"):
            assert getattr(papi, fn)(param) == getattr(japi, fn)(param)
    ctx = papi.heif_context_alloc(device="cpu")
    papi.heif_context_set_unif(ctx, 1)
    assert ctx.write_unif is True


def test_thumbnail_scaled_on_the_image_device():
    """heif_context_encode_thumbnail scales with the image's
    scale_nearest, on the image's device; the port registry is the one
    the encoder came from."""
    ctx = papi.heif_context_alloc(device="cpu")
    enc = papi.heif_context_get_encoder_for_format(ctx, "unci")
    assert enc.impl in [e for lst in
                        __import__("libheif_tpu_torch.codecs.registry",
                                   fromlist=["x"])._encoders.values()
                        for e in lst]
    assert enc.impl not in [e for lst in jreg._encoders.values()
                            for e in lst]
    img = af.port_image(af.gradient(40, 20, 1))
    seen = []
    real = type(img).scale_nearest

    def spy(self, w, h):
        out = real(self, w, h)
        seen.append((w, h, {p.device.type for p in out.planes.values()}))
        return out
    type(img).scale_nearest = spy
    try:
        hd = papi.heif_context_encode_image(ctx, img, enc)
        papi.heif_context_encode_thumbnail(ctx, img, hd, enc, None, 10)
    finally:
        type(img).scale_nearest = real
    assert seen == [(10, 5, {"cpu"})]


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    jax_native.ensure_loaded()
