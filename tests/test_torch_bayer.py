"""Bayer (filter-array) unci items in the port against the JAX package,
on the CPU: files written by the JAX writer (``HeifContext.encode_image``
with a ``cpat``), decoded by both packages raw and to RGB (unci
extraction, then BayerToRGB: exact), the ``cpat`` box and its limits,
and the pattern carried through the image transforms.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.meta import Box_irot as JBox_irot  # noqa: E402
from libheif_tpu.boxes.unc import Box_cpat as JBox_cpat  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.bitstream import ByteWriter as JByteWriter  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    BayerPattern as JBayerPattern, PixelImage as JPixelImage, Channel,
    Colorspace, Chroma)

from libheif_tpu_torch import HeifContext  # noqa: E402
from libheif_tpu_torch.boxes import read_all_boxes  # noqa: E402
from libheif_tpu_torch.boxes.unc import Box_cpat  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.core.limits import SecurityLimits  # noqa: E402

PATTERNS = {
    "RGGB": (2, 2, "RGGB"), "BGGR": (2, 2, "BGGR"), "GRBG": (2, 2, "GRBG"),
    "quad4x4": (4, 4, "GGRRGGRRBBGGBBGG"),
}
_CH = {"R": Channel.R, "G": Channel.G, "B": Channel.B, "Y": Channel.Y}


def bayer_file(ph, pw, cells, bits, w=67, h=45, seed=0, gains=None,
               irot=None):
    """A JAX-written unci file of one filter-array image with a cpat."""
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.FilterArray, Chroma.Monochrome)
    img.set_plane(Channel.FilterArray,
                  rng.integers(0, 1 << bits, (h, w),
                               dtype=np.uint8 if bits <= 8 else np.uint16),
                  bits)
    img.bayer_pattern = JBayerPattern(pw, ph, [_CH[c] for c in cells],
                                      gains)
    ctx = JHeifContext()
    iid = ctx.encode_image(img, "unci")
    if irot is not None:
        ctx.file.add_property(iid, JBox_irot(irot), True)
    return ctx.write()


def _same(ref, got):
    assert (got.width, got.height, got.colorspace, got.chroma) == \
        (ref.width, ref.height, ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert got.np_plane(ch).dtype == want.dtype, ch
        np.testing.assert_array_equal(got.np_plane(ch), want, err_msg=ch)


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_bayer_file_decodes_like_jax(pattern, bits):
    ph, pw, cells = PATTERNS[pattern]
    blob = bayer_file(ph, pw, cells, bits, seed=bits)
    j = JHeifContext.read_from_bytes(blob)
    p = HeifContext.read_from_bytes(blob, device="cpu")
    raw_ref, raw = j.decode_image(None), p.decode_image(None)
    _same(raw_ref, raw)
    assert raw.bayer_pattern.channels == raw_ref.bayer_pattern.channels
    assert (raw.bayer_pattern.pattern_width,
            raw.bayer_pattern.pattern_height) == (pw, ph)
    _same(j.decode_image(None, Colorspace.RGB, Chroma.C444),
          p.decode_image(None, Colorspace.RGB, Chroma.C444))


@pytest.mark.parametrize("chroma", [Chroma.InterleavedRGB,
                                    Chroma.InterleavedRGBA])
def test_bayer_file_to_interleaved(chroma):
    blob = bayer_file(2, 2, "RGGB", 16, seed=3)
    ref = JHeifContext.read_from_bytes(blob).decode_image(
        None, Colorspace.RGB, chroma)
    got = HeifContext.read_from_bytes(blob, device="cpu").decode_image(
        None, Colorspace.RGB, chroma)
    _same(ref, got)


@pytest.mark.parametrize("irot", [1, 2])
def test_bayer_pattern_follows_the_transforms(irot):
    """The pattern rides along irot's rotated copy (PixelImage._like), so
    the rotated mosaic still demosaics, as in the JAX package."""
    blob = bayer_file(2, 2, "GRBG", 12, w=20, h=12, seed=irot, irot=irot)
    j = JHeifContext.read_from_bytes(blob)
    p = HeifContext.read_from_bytes(blob, device="cpu")
    raw = p.decode_image(None)
    assert raw.bayer_pattern is not None
    _same(j.decode_image(None, Colorspace.RGB, Chroma.C444),
          p.decode_image(None, Colorspace.RGB, Chroma.C444))


def test_gains_are_carried():
    blob = bayer_file(2, 2, "RGGB", 8, gains=[2.0, 1.0, 1.0, 3.0])
    p = HeifContext.read_from_bytes(blob, device="cpu").decode_image(None)
    j = JHeifContext.read_from_bytes(blob).decode_image(None)
    assert p.bayer_pattern.gains == j.bayer_pattern.gains == \
        [2.0, 1.0, 1.0, 3.0]


def test_luma_cell_refused_as_jax():
    blob = bayer_file(2, 2, "RGYB", 8)
    with pytest.raises(Exception) as jerr:
        JHeifContext.read_from_bytes(blob).decode_image(
            None, Colorspace.RGB, Chroma.C444)
    with pytest.raises(HeifError) as perr:
        HeifContext.read_from_bytes(blob, device="cpu").decode_image(
            None, Colorspace.RGB, Chroma.C444)
    assert perr.value.subcode == SubError.Unsupported_data_version
    assert perr.value.subcode.name == jerr.value.subcode.name


# ------------------------------------------------------------------ cpat

def _cpat_bytes(pw, ph, comps, gains=None, den=1):
    w = JByteWriter()
    box = JBox_cpat()
    box.pattern_width, box.pattern_height = pw, ph
    box.components = list(comps)
    box.component_gains = list(gains or [1.0] * len(comps))
    box.write(w)
    data = bytearray(w.data())
    if den != 1:          # the last cell's gain denominator
        data[-2:] = den.to_bytes(2, "big", signed=True)
    return bytes(data)


def test_cpat_parses_like_jax():
    from libheif_tpu.boxes.box import read_box as jread_box
    from libheif_tpu.core.bitstream import ByteReader as JByteReader
    from libheif_tpu.core.limits import SecurityLimits as JLimits
    data = _cpat_bytes(4, 2, [0, 1, 1, 2, 2, 1, 1, 0],
                       [1.0, 2.0, -3.0, 4.0, 1.0, 1.0, 5.0, 1.0])
    ref = jread_box(JByteReader(data), JLimits(), 0)
    got, = read_all_boxes(data)
    assert isinstance(got, Box_cpat)
    assert (got.pattern_width, got.pattern_height, got.components,
            got.component_gains) == (ref.pattern_width, ref.pattern_height,
                                     ref.components, ref.component_gains)


@pytest.mark.parametrize("fault", ["too-large", "zero-size", "gain-den-0"])
def test_cpat_refusals(fault):
    """A pattern over max_bayer_pattern_pixels raises (a security limit;
    0 lifts it); a zero size or a zero gain denominator leaves the
    property unparsed (Box_Error), as in the JAX package."""
    from libheif_tpu.boxes.box import read_box as jread_box
    from libheif_tpu.core.bitstream import ByteReader as JByteReader
    from libheif_tpu.core.limits import SecurityLimits as JLimits
    if fault == "too-large":
        data = _cpat_bytes(17, 16, [0] * 272)
        with pytest.raises(HeifError) as e:
            read_all_boxes(data)
        assert "cpat pattern of 272 pixels" in str(e.value)
        box, = read_all_boxes(data, SecurityLimits(
            max_bayer_pattern_pixels=0))
        assert len(box.components) == 272
        return
    data = (_cpat_bytes(0, 2, []) if fault == "zero-size"
            else _cpat_bytes(2, 2, [0, 1, 1, 2], den=0))
    box, = read_all_boxes(data)
    ref = jread_box(JByteReader(data), JLimits(), 0)
    assert not isinstance(box, Box_cpat)
    assert box.error.subcode == SubError.Invalid_parameter_value
    assert box.error.subcode.name == ref.error.subcode.name


def test_cpat_index_out_of_cmpd_range():
    """A cpat cell naming a component that cmpd does not have raises at
    decode, as in the JAX package."""
    blob = bytearray(bayer_file(2, 2, "RGGB", 8))
    j = JHeifContext.read_from_bytes(bytes(blob))
    cpat = j.file.get_property(j.primary_item_id, JBox_cpat)
    w = JByteWriter()
    cpat.write(w)
    old = w.data()
    at = bytes(blob).index(old)
    cpat.components[0] = 99
    w = JByteWriter()
    cpat.write(w)
    blob[at:at + len(old)] = w.data()
    with pytest.raises(Exception) as jerr:
        JHeifContext.read_from_bytes(bytes(blob)).decode_image(None)
    with pytest.raises(HeifError) as perr:
        HeifContext.read_from_bytes(bytes(blob), device="cpu") \
            .decode_image(None)
    assert perr.value.subcode == SubError.Invalid_parameter_value
    assert perr.value.subcode.name == jerr.value.subcode.name
