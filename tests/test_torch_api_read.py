"""The port's read-side C-named API against the JAX package's, on the CPU.

Files written by the JAX writer (tests/api_files.py: hvc1, av01, jpeg,
avc1, j2k1, vvc1 and unci primaries with alpha, depth, a generic aux
image, a thumbnail, Exif/XMP/URI/mime metadata, pasp/udes/gimi/elng and
HDR properties, a grid and ster/altr/pymd entity groups; the committed
mini files) are read through both packages' ``heif_context_*`` calls and
every read function of the API is called on both: the answers (ints,
strings, lists, boxes as their fields, HeifError codes and subcodes) are
equal.  The decodes are in tests/test_torch_api_decode.py.
"""

import functools
import os

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
import jax_native  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.io import reader as jreader  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.io import reader as preader  # noqa: E402

ITEMS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "libheif_tpu_torch", "testdata", "items")


@functools.lru_cache(maxsize=None)
def rich(fmt):
    return af.rich_file(fmt)


def contexts(blob):
    jc = japi.heif_context_alloc()
    japi.heif_context_read_from_memory(jc, blob)
    pc = papi.heif_context_alloc(device="cpu")
    papi.heif_context_read_from_memory(pc, blob)
    return jc, pc


def assert_same(jw, pw):
    assert set(jw) == set(pw)
    for k in jw:
        assert pw[k] == jw[k], k


@pytest.mark.parametrize("fmt", af.FORMATS)
def test_read_functions_match_jax(fmt):
    blob = rich(fmt)
    jc, pc = contexts(blob)
    assert pc.device.type == "cpu"
    jw, pw = af.walk(japi, jc, blob), af.walk(papi, pc, blob)
    assert_same(jw, pw)
    # the file carries what the walk is meant to see
    primary = jw["primary"]
    h = jw[f"handle_{primary}"]
    assert h["heif_image_handle_has_alpha_channel"] is True
    assert h["heif_image_handle_get_list_of_depth_image_IDs"] != []
    assert h["heif_image_handle_get_pixel_aspect_ratio"] == [True, 4, 3]
    assert h["heif_image_handle_get_gimi_content_id"] == \
        "urn:uuid:content-1"
    assert len(h["heif_image_handle_get_list_of_metadata_block_IDs"]) == 3
    assert [g[1]["entity_group_type"] for g in jw["groups_None_0"]] == \
        ["ster", "altr", "pymd"]
    assert "udes" in jw["dump"] and "grpl" in jw["dump"]
    # and what the write side's read functions are meant to see
    assert h["heif_image_handle_get_number_of_region_items"] == 1
    assert len([k for k in h if k.startswith("region_")]) == 1 + 7
    assert h["heif_image_handle_get_number_of_text_items"] == 1
    assert h["heif_image_handle_has_camera_intrinsic_matrix"] is True
    assert jw["sequence"][3] == 1 and len(
        jw[f"track_raw_{jw['sequence'][4][0]}"]) == 2


@pytest.mark.parametrize("how", ("file", "memory_without_copy", "reader"))
def test_read_paths_match_jax(how, tmp_path):
    blob = rich("hevc")
    out = []
    for api, reader_mod, kw in ((japi, jreader, {}),
                                (papi, preader, {"device": "cpu"})):
        ctx = api.heif_context_alloc(**kw)
        if how == "file":
            path = tmp_path / "f.heif"
            path.write_bytes(blob)
            api.heif_context_read_from_file(ctx, str(path))
        elif how == "memory_without_copy":
            api.heif_context_read_from_memory_without_copy(ctx, blob)
        else:
            api.heif_context_read_from_reader(
                ctx, reader_mod.MemoryReader(blob))
        out.append(af.walk(api, ctx, blob))
    assert_same(*out)


@pytest.mark.parametrize("name", ("mini_av1_alpha_exif", "mini_hevc"))
def test_mini_files_match_jax(name):
    with open(os.path.join(ITEMS_DIR, name + ".heif"), "rb") as f:
        blob = f.read()
    jc, pc = contexts(blob)
    assert_same(af.walk(japi, jc, blob), af.walk(papi, pc, blob))


def test_descriptors_match_jax():
    for fn in ("heif_get_decoder_descriptors",):
        assert getattr(papi, fn)() == getattr(japi, fn)()
    # the port's unci package registers while the HEVC package imports
    # it, so its encoders come first in the list: the same entries
    assert sorted(papi.heif_get_encoder_descriptors()) == \
        sorted(japi.heif_get_encoder_descriptors())
    formats = ("hevc", "av1", "jpeg", "avc", "jpeg2000", "htj2k", "vvc",
               "unci", "mski", "nope")
    for fmt in formats:
        for fn in ("heif_have_decoder_for_format",
                   "heif_have_encoder_for_format",
                   "heif_get_decoder_descriptors",
                   "heif_get_encoder_descriptors"):
            assert getattr(papi, fn)(fmt) == getattr(japi, fn)(fmt), \
                (fn, fmt)
        assert papi.decoding.heif_get_decoder_descriptors(fmt) == \
            japi.decoding.heif_get_decoder_descriptors(fmt)
        assert papi.decoding.heif_have_decoder_for_format(fmt) == \
            japi.decoding.heif_have_decoder_for_format(fmt)
    for d in japi.heif_get_decoder_descriptors():
        assert papi.heif_decoder_descriptor_get_name(d) == \
            japi.heif_decoder_descriptor_get_name(d)
        assert papi.heif_decoder_descriptor_get_id_name(d) == \
            japi.heif_decoder_descriptor_get_id_name(d)
    assert ("jpeg2000", "tpu-j2k") in papi.heif_get_decoder_descriptors()
    assert ("unci", "tpu-unci") in papi.heif_get_encoder_descriptors("unci")


def test_library_and_security_match_jax():
    for fn in ("heif_get_version", "heif_get_version_number",
               "heif_get_version_number_major",
               "heif_get_version_number_minor",
               "heif_get_version_number_maintenance",
               "heif_get_global_security_limits",
               "heif_get_disabled_security_limits", "heif_error_success"):
        assert af.plain(getattr(papi, fn)()) == \
            af.plain(getattr(japi, fn)()), fn
    jc, pc = contexts(rich("jpeg"))
    for api, ctx in ((japi, jc), (papi, pc)):
        api.heif_context_set_max_decoding_threads(ctx, 3)
        api.heif_context_set_maximum_image_size_limit(ctx, 100)
        lim = api.heif_get_disabled_security_limits()
        api.heif_security_limits_copy(
            lim, api.heif_context_get_security_limits(ctx))
    assert papi.heif_context_get_max_decoding_threads(pc) == \
        japi.heif_context_get_max_decoding_threads(jc) == 3
    assert af.plain(pc.limits) == af.plain(jc.limits)
    papi.heif_init()
    papi.heif_init()
    papi.heif_deinit()
    papi.heif_deinit()
    papi.heif_deinit()
    papi.heif_string_release("s")
    papi.heif_free_plugin_directories([])


@pytest.mark.parametrize("call", (
    lambda api: api.heif_load_plugin("x.py"),
    lambda api: api.heif_load_plugins("/nonexistent"),
    lambda api: api.heif_unload_plugin(None),
    lambda api: api.heif_get_plugin_directories(),
    lambda api: api.heif_get_plugin_paths(),
    lambda api: api.heif_register_decoder(None, None)))
def test_plugin_functions_raise_by_name(call, monkeypatch):
    """The plugin functions (which raised by name until the plugin
    modules were ported) answer as the JAX package's do: the same value,
    or an error of the same type, code and subcode."""
    monkeypatch.delenv("LIBHEIF_TPU_PLUGIN_PATH", raising=False)
    got = []
    for api in (japi, papi):
        try:
            got.append(af.plain(call(api)))
        except Exception as e:  # noqa: BLE001 -- compared by type
            got.append([type(e).__name__,
                        *((e.code.name, e.subcode.name)
                          if hasattr(e, "subcode") else ())])
    assert got[0] == got[1]


def test_init_refuses_plugin_directories(tmp_path, monkeypatch):
    """heif_init loads the plugins of LIBHEIF_TPU_PLUGIN_PATH into its
    own package's registry (it refused them until the plugin modules were
    ported), and the last heif_deinit unloads them, as in JAX."""
    from libheif_tpu.codecs import registry as jreg
    from libheif_tpu_torch.codecs import registry as preg
    monkeypatch.setenv("LIBHEIF_TPU_PLUGIN_PATH", str(tmp_path))
    papi.heif_init()            # an empty directory: nothing to load
    papi.heif_deinit()
    for pkg in ("libheif_tpu", "libheif_tpu_torch"):
        (tmp_path / f"{pkg}_plugin.py").write_text(
            f"from {pkg}.codecs.registry import Decoder, register_decoder\n"
            "class Toy(Decoder):\n"
            f"    id, format = 'toy-{pkg}', 'toyfmt'\n"
            "def register():\n"
            f"    if __name__.startswith('{pkg}_plugin_'):\n"
            "        register_decoder(Toy())\n")
    before = (jreg.list_decoders(), preg.list_decoders())
    for api, reg, other in ((papi, preg, jreg), (japi, jreg, preg)):
        api.heif_init()
        try:
            assert [d for d in reg.list_decoders() if d[0] == "toyfmt"] == \
                [("toyfmt", f"toy-{api.__name__.split('.')[0]}")]
            assert ("toyfmt" in dict(other.list_decoders())) is False
        finally:
            api.heif_deinit()
        assert (jreg.list_decoders(), preg.list_decoders()) == before


def test_metadata_compression_matches_jax():
    for method in ("off", "undefined", None, "deflate", "zlib", "brotli",
                   "lzma"):
        assert papi.heif_metadata_compression_method_supported(method) == \
            japi.heif_metadata_compression_method_supported(method), method
    jc, pc = contexts(rich("jpeg"))
    for compression in ("brotli", "lzma"):
        got = [af.call(api.heif_context_add_XMP_metadata2, ctx,
                       api.heif_context_get_primary_image_handle(ctx),
                       af.XMP, compression)
               for api, ctx in ((japi, jc), (papi, pc))]
        assert got[0] == got[1] and got[0][0] == "HeifError", compression


def test_error_mapping_matches_jax():
    jc, pc = contexts(rich("unci"))
    out = []
    for api, ctx in ((japi, jc), (papi, pc)):
        with api.catching() as c:
            api.heif_context_get_image_handle(ctx, 12345)
        with api.catching() as ok:
            api.heif_context_get_primary_image_ID(ctx)
        out.append((af.plain(c.error), c.error.ok, ok.error.ok,
                    af.plain(api.error_ok)))
    assert out[0] == out[1]


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    jax_native.ensure_loaded()
