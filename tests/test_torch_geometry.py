"""The PyTorch port's PixelImage geometry and grid paste against the JAX
package's, on the CPU: rotate_ccw, mirror, crop (with its chroma
rounding), scale_nearest, extend and copy_into (with its clipping and
halved chroma offsets), over 4:4:4/4:2:2/4:2:0/mono, odd and even
sizes, 8 and 16 bits.  All exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)

from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    PixelImage, from_numpy_planes)

SUB = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
CHROMAS = [Chroma.C444, Chroma.C422, Chroma.C420, Chroma.Monochrome]
SIZES = [(8, 6), (9, 7)]


def _planes(w, h, chroma, bits, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits <= 8 else np.uint16
    out = {Channel.Y: rng.integers(0, 1 << bits, (h, w), dtype=dt)}
    if chroma != Chroma.Monochrome:
        sx, sy = SUB[chroma]
        for ch in (Channel.Cb, Channel.Cr):
            out[ch] = rng.integers(0, 1 << bits, ((h + sy - 1) // sy,
                                                  (w + sx - 1) // sx),
                                   dtype=dt)
    return out


def _both(w, h, chroma, bits, seed=0):
    planes = _planes(w, h, chroma, bits, seed)
    cs = Colorspace.Monochrome if chroma == Chroma.Monochrome \
        else Colorspace.YCbCr
    jimg = JPixelImage(w, h, cs, chroma)
    for ch, a in planes.items():
        jimg.set_plane(ch, a, bits)
    pimg = from_numpy_planes(planes, {c: bits for c in planes}, cs, chroma,
                             device="cpu")
    return jimg, pimg


def _same(jimg, pimg):
    assert (pimg.width, pimg.height) == (jimg.width, jimg.height)
    assert (pimg.colorspace, pimg.chroma) == (jimg.colorspace, jimg.chroma)
    assert pimg.channels() == jimg.channels()
    for ch in jimg.channels():
        ref = np.asarray(jimg.plane(ch))
        got = pimg.plane(ch)
        assert got.is_contiguous(), ch
        assert pimg.bit_depth(ch) == jimg.bit_depth(ch)
        assert got.numpy().dtype == ref.dtype, ch
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=ch)


def _cases():
    return [pytest.param(c, s, b, id=f"{c.replace(' ', '')}-{s[0]}x{s[1]}-{b}")
            for c in CHROMAS for s in SIZES for b in (8, 16)]


@pytest.mark.parametrize("chroma,size,bits", _cases())
@pytest.mark.parametrize("degrees", [0, 90, 180, 270])
def test_rotate_ccw(chroma, size, bits, degrees):
    jimg, pimg = _both(*size, chroma, bits, seed=degrees)
    _same(jimg.rotate_ccw(degrees), pimg.rotate_ccw(degrees))


@pytest.mark.parametrize("chroma,size,bits", _cases())
@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
def test_mirror(chroma, size, bits, direction):
    jimg, pimg = _both(*size, chroma, bits, seed=len(direction))
    _same(jimg.mirror(direction), pimg.mirror(direction))


@pytest.mark.parametrize("chroma,size,bits", _cases())
@pytest.mark.parametrize("rect", [(1, 1, 5, 3), (0, 0, 8, 6), (3, 2, 4, 4),
                                  (2, 1, 1, 1)],
                         ids=["odd-offset", "whole", "even", "one-pixel"])
def test_crop(chroma, size, bits, rect):
    jimg, pimg = _both(*size, chroma, bits, seed=sum(rect))
    _same(jimg.crop(*rect), pimg.crop(*rect))


def test_crop_outside_raises():
    _, pimg = _both(8, 6, Chroma.C420, 8)
    with pytest.raises(HeifError) as e:
        pimg.crop(4, 0, 5, 6)
    assert e.value.subcode == SubError.Invalid_clean_aperture


@pytest.mark.parametrize("chroma,size,bits", _cases())
@pytest.mark.parametrize("new", [(13, 5), (4, 11), (3, 2)],
                         ids=["wider", "taller", "smaller"])
def test_scale_nearest(chroma, size, bits, new):
    jimg, pimg = _both(*size, chroma, bits, seed=new[0])
    _same(jimg.scale_nearest(*new), pimg.scale_nearest(*new))


@pytest.mark.parametrize("chroma,size,bits", _cases())
@pytest.mark.parametrize("mode", ["edge", "constant"])
def test_extend(chroma, size, bits, mode):
    jimg, pimg = _both(*size, chroma, bits, seed=len(mode))
    _same(jimg.extend(size[0] + 5, size[1] + 3, mode),
          pimg.extend(size[0] + 5, size[1] + 3, mode))


@pytest.mark.parametrize("chroma,size,bits", _cases())
@pytest.mark.parametrize("at", [(0, 0), (3, 1), (6, 5), (16, 4)],
                         ids=["origin", "odd", "clipped", "outside"])
def test_copy_into(chroma, size, bits, at):
    w, h = size
    jsrc, psrc = _both(w, h, chroma, bits, seed=at[0] + 7)
    jdst, pdst = _both(20, 11, chroma, bits, seed=at[1] + 3)
    jdst.copy_into(jsrc, *at)
    pdst.copy_into(psrc, *at)
    _same(jdst, pdst)


@pytest.mark.parametrize("chroma", CHROMAS)
@pytest.mark.parametrize("bits", [8, 10, 16])
def test_add_plane(chroma, bits):
    jimg = JPixelImage(9, 7, Colorspace.YCbCr, chroma)
    pimg = PixelImage(9, 7, Colorspace.YCbCr, chroma)
    for ch in (Channel.Y, Channel.Cb, Channel.Alpha):
        jimg.add_plane(ch, bit_depth=bits)
        pimg.add_plane(ch, bit_depth=bits, device="cpu")
    _same(jimg, pimg)
