"""heif_decode_image through the port's C-named API against the JAX
package's, on the CPU.

Every image of the files of tests/api_files.py (the primary with its
alpha, the second image, the thumbnail, the 2x2 grid, the depth and the
generic aux image) decodes through both packages' ``heif_decode_image``:
to the codec's own colourspace bit-exact (the integer stages), and to
interleaved RGB (and RGBA) within the colour contract of
tests/test_pallas_fast.py (at most 1 LSB on fewer than 1% of the
samples).  ``decoder_id`` pins the registry's decoder: a built-in id
decodes, an id that names no decoder raises as in JAX.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
import jax_native  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402

DECODER_IDS = {"hevc": "tpu-hevc", "av1": "tpu-av1", "jpeg": "tpu-jpeg",
               "avc": "tpu-avc", "jpeg2000": "tpu-j2k", "vvc": "tpu-vvc"}


@functools.lru_cache(maxsize=None)
def rich(fmt):
    return af.rich_file(fmt)


@functools.lru_cache(maxsize=None)
def contexts(fmt):
    blob = rich(fmt)
    jc = japi.heif_context_alloc()
    japi.heif_context_read_from_memory(jc, blob)
    pc = papi.heif_context_alloc(device="cpu")
    papi.heif_context_read_from_memory(pc, blob)
    return jc, pc


def planes(api, img):
    """channel -> (bit depth, host array) through the API's plane
    getters; the port's planes must lie on the context's device."""
    out = {}
    for ch in api.heif_image_list_channels(img):
        p = api.heif_image_get_plane_readonly(img, ch)
        if isinstance(p, torch.Tensor):
            assert p.device.type == "cpu"
            p = p.numpy()
        out[ch] = (api.heif_image_get_bits_per_pixel_range(img, ch),
                   np.asarray(p))
    return out


def decode_both(fmt, iid, colorspace, chroma, **options):
    got = []
    for api, ctx in zip((japi, papi), contexts(fmt)):
        h = api.heif_context_get_image_handle(ctx, iid)
        opts = api.heif_decoding_options_alloc()
        for k, v in options.items():
            setattr(opts, k, v)
        try:
            got.append(api.heif_decode_image(h, colorspace, chroma, opts))
        except api.HeifError as e:
            got.append(("HeifError", e.code.name, e.subcode.name))
    return got


def assert_images(jimg, pimg, exact):
    for fn in ("heif_image_get_colorspace", "heif_image_get_chroma_format",
               "heif_image_get_primary_width",
               "heif_image_get_primary_height",
               "heif_image_is_premultiplied_alpha"):
        assert getattr(papi, fn)(pimg) == getattr(japi, fn)(jimg), fn
    jp, pp = planes(japi, jimg), planes(papi, pimg)
    assert list(pp) == list(jp)
    for ch in jp:
        (jb, ja), (pb, pa) = jp[ch], pp[ch]
        assert pb == jb and pa.shape == ja.shape and pa.dtype == ja.dtype, ch
        for fn in ("heif_image_get_width", "heif_image_get_height",
                   "heif_image_get_bits_per_pixel"):
            assert getattr(papi, fn)(pimg, ch) == getattr(japi, fn)(jimg, ch)
        d = np.abs(pa.astype(np.int64) - ja.astype(np.int64))
        if exact:
            assert not d.any(), ch
        else:
            assert d.max() <= 1 and np.count_nonzero(d) < 0.01 * d.size, ch


def images(fmt):
    jc, _ = contexts(fmt)
    primary = japi.heif_context_get_primary_image_ID(jc)
    h = japi.heif_context_get_primary_image_handle(jc)
    top = japi.heif_context_get_list_of_top_level_image_IDs(jc)
    return (primary, [primary] + [i for i in top if i != primary] +
            japi.heif_image_handle_get_list_of_thumbnail_IDs(h) +
            japi.heif_image_handle_get_list_of_auxiliary_image_IDs(h))


@pytest.mark.parametrize("fmt", af.FORMATS)
def test_decode_matches_jax(fmt):
    primary, ids = images(fmt)
    assert len(ids) == 7
    for iid in ids:
        assert_images(*decode_both(fmt, iid, "undefined", "undefined"),
                      exact=True)
        if iid in ids[:4]:          # the colour images
            assert_images(*decode_both(fmt, iid, "RGB", "interleaved RGB"),
                          exact=False)
    assert_images(*decode_both(fmt, primary, "RGB", "interleaved RGBA"),
                  exact=False)
    assert_images(*decode_both(fmt, primary, "undefined", "undefined",
                               ignore_aux_alpha=True), exact=True)


@pytest.mark.parametrize("fmt", sorted(DECODER_IDS))
def test_decoder_id(fmt):
    primary, ids = images(fmt)
    grid = ids[2]
    # a built-in id decodes, as with no id
    assert_images(*decode_both(fmt, primary, "undefined", "undefined",
                               decoder_id=DECODER_IDS[fmt]), exact=True)
    assert_images(*decode_both(fmt, grid, "undefined", "undefined",
                               decoder_id=DECODER_IDS[fmt]), exact=True)
    # an id that names no decoder of the format raises as in JAX: on the
    # item, and on every tile of the grid
    for iid in (primary, grid):
        for bad in ("no-such-decoder", "tpu-unci"):
            got = decode_both(fmt, iid, "undefined", "undefined",
                              decoder_id=bad)
            assert isinstance(got[0], tuple), (iid, bad, got[0])
            assert got[1] == got[0]


def test_decode_keeps_the_context_device():
    """A CPU context stays on the CPU through every read function, and
    its decodes give CPU planes (checked in ``planes``)."""
    _, pc = contexts("unci")
    assert pc.device.type == "cpu"
    for item in pc.items.values():
        assert item.ctx.device.type == "cpu"


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    jax_native.ensure_loaded()


@pytest.fixture(autouse=True)
def serial_native_engine(monkeypatch):
    """The JAX native HEVC engine's serial form is the reference
    (tests/test_torch_hevc.py: its two-thread pipeline can give wrong
    samples under load)."""
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
