"""The port's pixel-image API (libheif_tpu_torch/api/image.py) on the CPU.

The plane contract: ``heif_image_get_plane`` returns the image's own
tensor, so a write through it reaches the image (and the readonly getter
sees it); ``add_plane`` has the JAX signature (width, height, bit depth,
datatype) and its security limits; the geometry functions give the JAX
package's planes; an image made by ``heif_image_create`` records its
device and allocates its planes there; without a card
``heif_context_alloc()`` and ``heif_image_create()`` raise unless the
caller passes ``device="cpu"``.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.core.limits import SecurityLimits as JLimits  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.core.limits import SecurityLimits  # noqa: E402

# (colorspace, chroma, [(channel, width, height, bit depth)])
LAYOUTS = {
    "ycbcr420_odd": ("YCbCr", "420", [("Y", 37, 29, 8), ("Cb", 19, 15, 8),
                                      ("Cr", 19, 15, 8)]),
    "rgb444_10bit": ("RGB", "444", [("R", 24, 18, 10), ("G", 24, 18, 10),
                                    ("B", 24, 18, 10)]),
    "mono_alpha": ("monochrome", "monochrome", [("Y", 33, 20, 8),
                                                ("Alpha", 33, 20, 8)]),
}


def _samples(w, h, bits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, (h, w)).astype(
        np.uint8 if bits <= 8 else np.uint16)


def make_pair(layout):
    """The same image made through both packages' API calls: create,
    add_plane, then a write through heif_image_get_plane."""
    cs, chroma, planes = LAYOUTS[layout]
    w, h = planes[0][1], planes[0][2]
    jimg = japi.heif_image_create(w, h, cs, chroma)
    pimg = papi.heif_image_create(w, h, cs, chroma, device="cpu")
    for i, (ch, pw, ph, bits) in enumerate(planes):
        data = _samples(pw, ph, bits, i)
        japi.heif_image_add_plane(jimg, ch, pw, ph, bits)
        japi.heif_image_get_plane(jimg, ch)[:] = data
        papi.heif_image_add_plane(pimg, ch, pw, ph, bits)
        papi.heif_image_get_plane(pimg, ch)[:] = torch.from_numpy(data)
    return jimg, pimg


def same_planes(jimg, pimg):
    assert (pimg.width, pimg.height, pimg.colorspace, pimg.chroma) == \
        (jimg.width, jimg.height, jimg.colorspace, jimg.chroma)
    assert papi.heif_image_list_channels(pimg) == \
        japi.heif_image_list_channels(jimg)
    for ch in japi.heif_image_list_channels(jimg):
        j = np.asarray(jimg.plane(ch))
        p = papi.heif_image_get_plane_readonly(pimg, ch)
        assert p.device.type == "cpu"
        p = p.numpy()
        assert p.dtype == j.dtype and p.shape == j.shape, ch
        assert np.array_equal(p, j), ch
        assert papi.heif_image_get_bits_per_pixel_range(pimg, ch) == \
            japi.heif_image_get_bits_per_pixel_range(jimg, ch)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_write_through_get_plane_reaches_the_image(layout):
    jimg, pimg = make_pair(layout)
    same_planes(jimg, pimg)
    for ch, pw, ph, _ in LAYOUTS[layout][2]:
        plane = papi.heif_image_get_plane(pimg, ch)
        assert plane is pimg.plane(ch)
        assert plane.data_ptr() == \
            papi.heif_image_get_plane_readonly(pimg, ch).data_ptr()
        assert plane.stride() == (pw, 1)
        plane[1, 2] = 7
        assert int(pimg.plane(ch)[1, 2]) == 7
        assert int(papi.heif_image_get_plane_readonly2(pimg, ch)[1, 2]) == 7
        papi.heif_image_get_plane2(pimg, ch)[0, 0] = 3
        assert int(pimg.plane(ch)[0, 0]) == 3
        assert (papi.heif_image_get_width(pimg, ch),
                papi.heif_image_get_height(pimg, ch)) == (pw, ph)


GEOMETRY = {
    "crop": lambda api, img: api.heif_image_crop(img, 3, 2, 5, 4),
    "scale": lambda api, img: api.heif_image_scale_image(img, 17, 11),
    "rotate90": lambda api, img: api.heif_image_rotate_ccw(img, 90),
    "rotate180": lambda api, img: api.heif_image_rotate_ccw(img, 180),
    "rotate270": lambda api, img: api.heif_image_rotate_ccw(img, 270),
    "mirror_h": lambda api, img: api.heif_image_mirror_horizontal(img),
    "mirror_v": lambda api, img: api.heif_image_mirror_vertical(img),
    "extract": lambda api, img: api.heif_image_extract_area(img, 4, 2, 13,
                                                            9),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("op", sorted(GEOMETRY))
def test_geometry_matches_jax(op, layout):
    jimg, pimg = make_pair(layout)
    same_planes(GEOMETRY[op](japi, jimg), GEOMETRY[op](papi, pimg))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("op", ("extend_padding", "extend_zero"))
def test_extend_in_place_matches_jax(op, layout):
    jimg, pimg = make_pair(layout)
    for api, img in ((japi, jimg), (papi, pimg)):
        w, h = img.width + 11, img.height + 6
        if op == "extend_padding":
            api.heif_image_extend_padding_to_size(img, w, h)
        else:
            api.heif_image_extend_to_size_fill_with_zero(img, w, h)
    same_planes(jimg, pimg)


def test_crop_errors_match_jax():
    jimg, pimg = make_pair("ycbcr420_odd")
    for args in ((20, 0, 20, 0), (0, 0, 0, 29)):
        assert af.call(papi.heif_image_crop, pimg, *args) == \
            af.call(japi.heif_image_crop, jimg, *args)
    assert af.call(papi.heif_image_extract_area, pimg, 30, 0, 10, 5) == \
        af.call(japi.heif_image_extract_area, jimg, 30, 0, 10, 5)


@pytest.mark.parametrize("datatype,bits", (("unsigned", 8),
                                           ("unsigned", 12),
                                           ("unsigned", 24),
                                           ("signed", 8), ("signed", 16),
                                           ("float", 32)))
def test_add_plane_signature_matches_jax(datatype, bits):
    jimg = japi.heif_image_create(16, 8, "YCbCr", "420")
    pimg = papi.heif_image_create(16, 8, "YCbCr", "420", device="cpu")
    for img in (jimg, pimg):
        img.add_plane("Y", 16, 8, bits, datatype)
        img.add_plane("Cb")             # the channel's subsampled size
        img.add_plane("Cr", bit_depth=bits, datatype=datatype)
    for ch in ("Y", "Cb", "Cr"):
        j, p = np.asarray(jimg.plane(ch)), pimg.plane(ch)
        assert tuple(p.shape) == j.shape, ch
        assert str(p.dtype).split(".")[-1] == j.dtype.name, ch
        assert pimg.plane_info[ch] == pimg.plane_info[ch].__class__(
            jimg.plane_info[ch].bit_depth, jimg.plane_info[ch].datatype)
        assert pimg.plane_size(ch) == jimg.plane_size(ch)


@pytest.mark.parametrize("limits", ({"max_image_size_pixels": 100},
                                    {"max_memory_block_size": 200}))
def test_add_plane_limits_match_jax(limits):
    jimg = japi.heif_image_create(32, 32, "monochrome", "monochrome",
                                  JLimits(**limits))
    pimg = papi.heif_image_create(32, 32, "monochrome", "monochrome",
                                  SecurityLimits(**limits), device="cpu")
    for args in (("Y", 32, 32, 8), ("Y", 8, 8, 8), ("Y", 12, 12, 16)):
        assert af.call(papi.heif_image_add_plane, pimg, *args) == \
            af.call(japi.heif_image_add_plane, jimg, *args), args
    for args in (("Y", 32, 32, 8, SecurityLimits(max_image_size_pixels=64)),
                 ("Y", 4, 4, 8, SecurityLimits())):
        jargs = args[:4] + (JLimits(**vars(args[4])),)
        assert af.call(papi.heif_image_add_plane_safe, pimg, *args) == \
            af.call(japi.heif_image_add_plane_safe, jimg, *jargs), args


def test_image_functions_match_jax():
    jimg, pimg = make_pair("ycbcr420_odd")
    for api, img in ((japi, jimg), (papi, pimg)):
        api.heif_image_set_premultiplied_alpha(img, True)
        api.heif_image_set_raw_color_profile(img, "rICC", af.ICC)
        api.heif_image_set_pixel_aspect_ratio(img, 3, 2)
        api.heif_image_set_content_light_level(img, "clli")
        api.heif_image_set_mastering_display_colour_volume(img, "mdcv")
        api.heif_image_set_ambient_viewing_environment(img, "amve")
        api.heif_image_set_nominal_diffuse_white_luminance(img, 250)
        api.heif_image_add_decoding_warning(img, "w")
    for fn in ("heif_image_get_colorspace", "heif_image_get_chroma_format",
               "heif_image_get_primary_width",
               "heif_image_get_primary_height",
               "heif_image_is_premultiplied_alpha",
               "heif_image_get_raw_color_profile_size",
               "heif_image_get_raw_color_profile",
               "heif_image_get_color_profile_type",
               "heif_image_get_nclx_color_profile",
               "heif_image_get_pixel_aspect_ratio",
               "heif_image_has_content_light_level",
               "heif_image_get_content_light_level",
               "heif_image_has_mastering_display_colour_volume",
               "heif_image_get_mastering_display_colour_volume",
               "heif_image_has_ambient_viewing_environment",
               "heif_image_get_ambient_viewing_environment",
               "heif_image_has_nominal_diffuse_white_luminance",
               "heif_image_get_nominal_diffuse_white_luminance",
               "heif_image_get_decoding_warnings"):
        assert af.plain(getattr(papi, fn)(pimg)) == \
            af.plain(getattr(japi, fn)(jimg)), fn
    for ch in ("Y", "Cb", "Alpha"):
        for fn in ("heif_image_has_channel",):
            assert getattr(papi, fn)(pimg, ch) == getattr(japi, fn)(jimg, ch)
    assert af.call(papi.heif_image_get_plane, pimg, "Alpha") == \
        af.call(japi.heif_image_get_plane, jimg, "Alpha")
    assert papi.heif_color_conversion_options_ext_alloc().__dict__ == \
        papi.heif_color_conversion_options_ext_copy(
            papi.heif_color_conversion_options_ext_alloc()).__dict__


def test_image_create_records_its_device():
    img = papi.heif_image_create(8, 4, "YCbCr", "422", device="cpu")
    assert img.device == torch.device("cpu")
    papi.heif_image_add_plane(img, "Cb", 4, 4, 8)
    assert img.plane("Cb").device.type == "cpu"
    assert papi.heif_image_crop(img, 0, 0, 2, 0).device == img.device


def test_no_card_raises_without_cpu(monkeypatch):
    """As tests/test_torch_port.py's ``_no_cuda``: with CUDA hidden, the
    API's entry points raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        papi.heif_context_alloc()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        papi.heif_image_create(4, 4, "monochrome", "monochrome")
    img = papi.heif_image_create(4, 4, "monochrome", "monochrome",
                                 device="cpu")
    papi.heif_image_add_plane(img, "Y", 4, 4, 8)
    ctx = papi.heif_context_alloc(device="cpu")
    papi.heif_context_read_from_memory(ctx, af.rich_file("unci"))
    out = papi.heif_decode_image(
        papi.heif_context_get_primary_image_handle(ctx))
    assert all(p.device.type == "cpu" for p in out.planes.values())
    # a plane added without a device to an image that records none goes
    # to the card, and so raises here
    from libheif_tpu_torch.image.pixel_image import PixelImage
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PixelImage(4, 4).add_plane("Y", 4, 4, 8)
