"""The six colour ops of the output conversion that need more than a copy
(MonoToYCbCr, ChromaResample, RGBToYCbCr, RGBToMono, FlattenAlpha,
BayerToRGB) against the JAX ops, on the CPU, op by op.

Tolerances: the integer stages are exact (MonoToYCbCr, FlattenAlpha,
ChromaResample by nearest, bilinear up and average down, BayerToRGB for
patterns up to 8x8 at 16 bits, where the JAX f32 convolution's sums stay
below 2**24); the f32 matrices (RGBToYCbCr, RGBToMono) and the sharp-yuv
iterations keep the colour contract (tests/test_pallas_fast.py:1-9): at
most 1 LSB, on fewer than 1% of the samples.  Inputs are 67x45 (odd in
both directions) unless a case says otherwise.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.color import ops as jops  # noqa: E402
from libheif_tpu.color.nclx import NclxProfile as JNclx  # noqa: E402
from libheif_tpu.color.state import ColorState as JColorState  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    BayerPattern as JBayerPattern, PixelImage as JPixelImage, Colorspace,
    Chroma, Channel)

from libheif_tpu_torch.color import ops  # noqa: E402
from libheif_tpu_torch.color.nclx import NclxProfile  # noqa: E402
from libheif_tpu_torch.color.state import ColorState  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    BayerPattern, from_numpy_planes)

W, H = 67, 45
SUB = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
CHROMAS = [Chroma.C420, Chroma.C422, Chroma.C444]
RGB = (Channel.R, Channel.G, Channel.B)


def _assert_lsb_contract(a, b, what=""):
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    assert a.shape == b.shape, what
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, f"{what}: maxdiff {d.max()}"
    assert (d > 0).mean() < 0.01, f"{what}: {(d > 0).mean():.3%} differ"


def _rand(rng, bits, shape):
    return rng.integers(0, 1 << bits, shape,
                        dtype=np.uint8 if bits <= 8 else np.uint16)


def _pair(planes, bits, colorspace, chroma, mc=6, full_range=True):
    """The same planes as a JAX and a port image (the port's on the CPU),
    with an nclx profile."""
    h, w = next(iter(planes.values())).shape
    if Channel.Y in planes:
        h, w = planes[Channel.Y].shape
    jimg = JPixelImage(w, h, colorspace, chroma)
    for ch, a in planes.items():
        jimg.set_plane(ch, a, bits[ch])
    pimg = from_numpy_planes(planes, bits, colorspace, chroma, device="cpu")
    jimg.color_profile_nclx = JNclx(matrix_coefficients=mc,
                                    full_range_flag=full_range)
    pimg.color_profile_nclx = NclxProfile(matrix_coefficients=mc,
                                          full_range_flag=full_range)
    return jimg, pimg


def _apply(op_name, jimg, pimg, target, **options):
    """One op's apply in each package, from the image's state to the
    op's output state for ``target`` (a dict of ColorState fields)."""
    jin, pin = JColorState.of(jimg), ColorState.of(pimg)
    jout = getattr(jops, op_name)().output_state(jin, JColorState(**target))
    pout = getattr(ops, op_name)().output_state(pin, ColorState(**target))
    assert jout is not None and ColorState(**vars(jout)) == pout
    ref = getattr(jops, op_name)().apply(
        jimg, jin, jout, jops.ColorConversionOptions(**options))
    got = getattr(ops, op_name)().apply(
        pimg, pin, pout, ops.ColorConversionOptions(**options))
    return ref, got


def _compare(ref, got, exact):
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        have = got.np_plane(ch)
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert have.dtype == want.dtype, ch
        assert got.plane(ch).device.type == "cpu", ch
        if exact:
            np.testing.assert_array_equal(have, want, err_msg=ch)
        else:
            _assert_lsb_contract(want, have, ch)


def _ycc(bits, chroma, seed, alpha_bits=None, w=W, h=H):
    rng = np.random.default_rng(seed)
    sx, sy = SUB[chroma]
    cw, chh = (w + sx - 1) // sx, (h + sy - 1) // sy
    planes = {Channel.Y: _rand(rng, bits, (h, w)),
              Channel.Cb: _rand(rng, bits, (chh, cw)),
              Channel.Cr: _rand(rng, bits, (chh, cw))}
    depth = {c: bits for c in planes}
    if alpha_bits:
        planes[Channel.Alpha] = _rand(rng, alpha_bits, (h, w))
        depth[Channel.Alpha] = alpha_bits
    return planes, depth


def _rgb(bits, seed, alpha_bits=None, w=W, h=H):
    rng = np.random.default_rng(seed)
    planes = {c: _rand(rng, bits, (h, w)) for c in RGB}
    depth = {c: bits for c in planes}
    if alpha_bits:
        planes[Channel.Alpha] = _rand(rng, alpha_bits, (h, w))
        depth[Channel.Alpha] = alpha_bits
    return planes, depth


# ------------------------------------------------------------ MonoToYCbCr

@pytest.mark.parametrize("chroma", CHROMAS)
@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_mono_to_ycbcr_is_exact(bits, chroma):
    rng = np.random.default_rng(bits)
    planes = {Channel.Y: _rand(rng, bits, (H, W)),
              Channel.Alpha: _rand(rng, 8, (H, W))}
    jimg, pimg = _pair(planes, {Channel.Y: bits, Channel.Alpha: 8},
                       Colorspace.Monochrome, Chroma.Monochrome)
    ref, got = _apply("MonoToYCbCr", jimg, pimg,
                      dict(colorspace=Colorspace.YCbCr, chroma=chroma,
                           has_alpha=True))
    _compare(ref, got, exact=True)


# --------------------------------------------------------- ChromaResample

PAIRS_UP = [(Chroma.C420, Chroma.C422), (Chroma.C420, Chroma.C444),
            (Chroma.C422, Chroma.C444)]
PAIRS_DOWN = [(b, a) for a, b in PAIRS_UP]


@pytest.mark.parametrize("bits", [8, 10, 12, 16])
@pytest.mark.parametrize("method", ["nearest-neighbor", "bilinear"])
@pytest.mark.parametrize("pair", PAIRS_UP, ids=lambda p: f"{p[0]}to{p[1]}")
def test_chroma_upsample_is_exact(pair, method, bits):
    src, dst = pair
    planes, depth = _ycc(bits, src, seed=bits + len(method), alpha_bits=bits)
    jimg, pimg = _pair(planes, depth, Colorspace.YCbCr, src)
    ref, got = _apply("ChromaResample", jimg, pimg,
                      dict(colorspace=Colorspace.YCbCr, chroma=dst,
                           has_alpha=True, bits_per_pixel=bits),
                      chroma_upsampling=method)
    _compare(ref, got, exact=True)


@pytest.mark.parametrize("bits", [8, 10, 12, 16])
@pytest.mark.parametrize("method", ["nearest-neighbor", "average",
                                    "sharp-yuv"])
@pytest.mark.parametrize("pair", PAIRS_DOWN, ids=lambda p: f"{p[0]}to{p[1]}")
def test_chroma_downsample_matches_jax(pair, method, bits):
    """Nearest and average exact; sharp-yuv's f32 iterations within the
    colour contract."""
    src, dst = pair
    planes, depth = _ycc(bits, src, seed=3 * bits + len(method))
    jimg, pimg = _pair(planes, depth, Colorspace.YCbCr, src)
    ref, got = _apply("ChromaResample", jimg, pimg,
                      dict(colorspace=Colorspace.YCbCr, chroma=dst,
                           bits_per_pixel=bits),
                      chroma_downsampling=method)
    _compare(ref, got, exact=method != "sharp-yuv")


@pytest.mark.parametrize("size", [(1, 1), (2, 1), (1, 3), (3, 2), (8, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_chroma_resample_at_tiny_sizes(size):
    """4:4:4 -> 4:2:0 -> 4:4:4 at sizes of one and two samples, where the
    factors and the edge padding degenerate."""
    w, h = size
    planes, depth = _ycc(8, Chroma.C444, seed=w * 10 + h, w=w, h=h)
    jimg, pimg = _pair(planes, depth, Colorspace.YCbCr, Chroma.C444)
    for method in ("average", "sharp-yuv"):
        ref, got = _apply("ChromaResample", jimg, pimg,
                          dict(colorspace=Colorspace.YCbCr,
                               chroma=Chroma.C420),
                          chroma_downsampling=method)
        _compare(ref, got, exact=method == "average")
        ref2, got2 = _apply("ChromaResample", ref, got,
                            dict(colorspace=Colorspace.YCbCr,
                                 chroma=Chroma.C444))
        _compare(ref2, got2, exact=method == "average")


def test_downsample_helpers_match_jax():
    """_downsample (both methods, every factor pair) and _sharp_downsample
    on f32 planes that are not integers."""
    rng = np.random.default_rng(7)
    a = (rng.random((H, W), dtype=np.float32) * 1000).astype(np.float32)
    t = torch.from_numpy(a)
    for fx, fy in ((1, 1), (2, 1), (1, 2), (2, 2)):
        for method in ("nearest-neighbor", "average"):
            ref = np.asarray(jops._downsample(jax.numpy.asarray(a), fx, fy,
                                              method))
            got = ops._downsample(t, fx, fy, method).numpy()
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    ref = np.asarray(jops._sharp_downsample(jax.numpy.asarray(a), 23, 34))
    got = ops._sharp_downsample(t, 23, 34).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------ RGBToYCbCr

@pytest.mark.parametrize("matrix", [1, 6, 9])
@pytest.mark.parametrize("full_range", [True, False], ids=["full", "limited"])
@pytest.mark.parametrize("chroma", CHROMAS)
@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_rgb_to_ycbcr_matches_jax(bits, chroma, full_range, matrix):
    planes, depth = _rgb(bits, seed=bits * 7 + matrix, alpha_bits=8)
    jimg, pimg = _pair(planes, depth, Colorspace.RGB, Chroma.C444)
    ref, got = _apply("RGBToYCbCr", jimg, pimg,
                      dict(colorspace=Colorspace.YCbCr, chroma=chroma,
                           has_alpha=True, bits_per_pixel=bits,
                           matrix_coefficients=matrix,
                           full_range=full_range))
    _compare(ref, got, exact=False)


@pytest.mark.parametrize("method", ["nearest-neighbor", "sharp-yuv"])
def test_rgb_to_ycbcr_downsampling_modes(method):
    """Nearest picks the top-left sample; sharp-yuv is the average here,
    as in the JAX op (its _downsample knows two methods)."""
    planes, depth = _rgb(8, seed=11)
    jimg, pimg = _pair(planes, depth, Colorspace.RGB, Chroma.C444)
    ref, got = _apply("RGBToYCbCr", jimg, pimg,
                      dict(colorspace=Colorspace.YCbCr, chroma=Chroma.C420),
                      chroma_downsampling=method)
    _compare(ref, got, exact=False)


# -------------------------------------------------------------- RGBToMono

@pytest.mark.parametrize("alpha", [False, True], ids=["no-alpha", "alpha"])
@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_rgb_to_mono_matches_jax(bits, alpha):
    planes, depth = _rgb(bits, seed=bits, alpha_bits=bits if alpha else None)
    jimg, pimg = _pair(planes, depth, Colorspace.RGB, Chroma.C444)
    ref, got = _apply("RGBToMono", jimg, pimg,
                      dict(colorspace=Colorspace.Monochrome,
                           chroma=Chroma.Monochrome, has_alpha=alpha,
                           bits_per_pixel=bits))
    _compare(ref, got, exact=False)


# ----------------------------------------------------------- FlattenAlpha

FLATTEN = {
    "solid-default": dict(alpha_composition_mode="solid-color"),
    "solid-red": dict(alpha_composition_mode="solid-color",
                      background_rgb=(0xFFFF, 0x1234, 0x0000)),
    "checker-default": dict(alpha_composition_mode="checkerboard"),
    "checker-5": dict(alpha_composition_mode="checkerboard",
                      checkerboard_square_size=5,
                      background_rgb=(0x0000, 0x8000, 0xFFFF),
                      secondary_background_rgb=(0xABCD, 0x0101, 0x7FFF)),
    "checker-0": dict(alpha_composition_mode="checkerboard",
                      checkerboard_square_size=0),
}


@pytest.mark.parametrize("alpha_bits", ["same", 8])
@pytest.mark.parametrize("mode", list(FLATTEN))
@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_flatten_alpha_is_exact(bits, mode, alpha_bits):
    """Includes c·a = 65535² at 16 bits (int64) and a square size of 0
    (solid)."""
    abits = bits if alpha_bits == "same" else alpha_bits
    planes, depth = _rgb(bits, seed=bits + abits, alpha_bits=abits)
    planes[Channel.R][0, :4] = (1 << bits) - 1
    planes[Channel.Alpha][0, :4] = (1 << abits) - 1
    jimg, pimg = _pair(planes, depth, Colorspace.RGB, Chroma.C444)
    ref, got = _apply("FlattenAlpha", jimg, pimg,
                      dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                           has_alpha=False, bits_per_pixel=bits),
                      **FLATTEN[mode])
    _compare(ref, got, exact=True)


def test_flatten_alpha_checkerboard_parity():
    """A transparent image shows the secondary colour in the top-left
    square and the primary one beside it (each bkg·255 >> 8)."""
    planes, depth = _rgb(8, seed=1, alpha_bits=8, w=8, h=4)
    planes[Channel.Alpha][:] = 0
    _, pimg = _pair(planes, depth, Colorspace.RGB, Chroma.C444)
    opts = ops.ColorConversionOptions(
        alpha_composition_mode="checkerboard", checkerboard_square_size=4,
        background_rgb=(0xFF00, 0xFF00, 0xFF00),
        secondary_background_rgb=(0x1000, 0x1000, 0x1000))
    pin = ColorState.of(pimg)
    out = ops.FlattenAlpha().apply(pimg, pin, pin.with_(has_alpha=False),
                                   opts)
    r = out.np_plane(Channel.R)
    assert (r[:, :4] == (0x10 * 255) >> 8).all()
    assert (r[:, 4:] == (0xFF * 255) >> 8).all()
    assert not out.has_channel(Channel.Alpha)


# ------------------------------------------------------------- BayerToRGB

BAYER = {
    "RGGB": (2, 2, "RGGB"), "BGGR": (2, 2, "BGGR"), "GRBG": (2, 2, "GRBG"),
    "quad4x4": (4, 4, "GGRRGGRRBBGGBBGG"),
}
_CH = {"R": Channel.R, "G": Channel.G, "B": Channel.B}


def _bayer_pair(ph, pw, cells, bits, seed, w=W, h=H):
    rng = np.random.default_rng(seed)
    plane = {Channel.FilterArray: _rand(rng, bits, (h, w))}
    jimg, pimg = _pair(plane, {Channel.FilterArray: bits},
                       Colorspace.FilterArray, Chroma.Monochrome)
    chans = [_CH[c] for c in cells]
    jimg.bayer_pattern = JBayerPattern(pw, ph, chans)
    pimg.bayer_pattern = BayerPattern(pw, ph, chans)
    return jimg, pimg


def _bayer_numpy(plane, ph, pw, cells):
    """Bilinear demosaic in int64 and float64 (exact sums, then one
    rounding division), the reference for patterns whose sums pass 2**24."""
    h, w = plane.shape
    a = plane.astype(np.int64)
    idx = {"R": 0, "G": 1, "B": 2}
    pix = np.array([idx[c] for c in cells])[
        (np.arange(h) % ph)[:, None] * pw + (np.arange(w) % pw)[None, :]]
    maxval = (1 << 16) - 1 if plane.dtype == np.uint16 else 255
    out = []
    for ci in range(3):
        m = (pix == ci).astype(np.int64)
        pad = lambda x: np.pad(x, ((ph - 1, ph - 1), (pw - 1, pw - 1)))
        pn, pd = pad(a * m), pad(m)
        num = sum(pn[i:i + h, j:j + w] for i in range(2 * ph - 1)
                  for j in range(2 * pw - 1))
        den = sum(pd[i:i + h, j:j + w] for i in range(2 * ph - 1)
                  for j in range(2 * pw - 1))
        avg = np.float32(num.astype(np.float32) /
                         np.maximum(den, 1).astype(np.float32))
        v = np.where(m > 0, a, np.clip(np.round(avg), 0, maxval))
        out.append(v.astype(plane.dtype))
    return out


@pytest.mark.parametrize("bits", [8, 12, 16])
@pytest.mark.parametrize("pattern", list(BAYER))
def test_bayer_to_rgb_is_exact(pattern, bits):
    ph, pw, cells = BAYER[pattern]
    jimg, pimg = _bayer_pair(ph, pw, cells, bits, seed=bits + ph)
    ref, got = _apply("BayerToRGB", jimg, pimg,
                      dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                           bits_per_pixel=bits))
    _compare(ref, got, exact=True)


@pytest.mark.parametrize("pattern", ["8x8-16bit", "16x16-8bit", "3x5-12bit"])
def test_bayer_large_patterns_are_exact(pattern):
    """Up to 8x8 at 16 bits (225 taps x 65535 < 2**24) and 16x16 at 8 bits
    the JAX f32 convolution is exact, and so equal to the port; an odd
    3x5 pattern checks the box's centring."""
    dims, bits = pattern.split("-")
    ph, pw = (int(v) for v in dims.split("x"))
    bits = int(bits[:-3])
    cells = "".join(np.random.default_rng(ph * pw).choice(list("RGB"),
                                                          ph * pw))
    jimg, pimg = _bayer_pair(ph, pw, cells, bits, seed=ph, w=41, h=37)
    ref, got = _apply("BayerToRGB", jimg, pimg,
                      dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                           bits_per_pixel=bits))
    _compare(ref, got, exact=True)


def test_bayer_16x16_at_16_bits_is_exact_where_f32_sums_are_not():
    """A 16x16 pattern at 16 bits sums up to 961 x 65535 > 2**24: the
    port's int32 sums equal an int64 reference; the JAX op's f32 sums
    may not (a fault on the reference side, recorded in ROADMAP §3)."""
    ph = pw = 16
    cells = "".join(np.random.default_rng(5).choice(list("RGB"), 256))
    rng = np.random.default_rng(9)
    plane = rng.integers(60000, 1 << 16, (40, 36), dtype=np.uint16)
    img = from_numpy_planes({Channel.FilterArray: plane},
                            {Channel.FilterArray: 16}, Colorspace.FilterArray,
                            Chroma.Monochrome, device="cpu")
    img.bayer_pattern = BayerPattern(pw, ph, [_CH[c] for c in cells])
    pin = ColorState.of(img)
    out = ops.BayerToRGB().apply(
        img, pin, pin.with_(colorspace=Colorspace.RGB, chroma=Chroma.C444),
        ops.ColorConversionOptions())
    for ch, want in zip(RGB, _bayer_numpy(plane, ph, pw, cells)):
        np.testing.assert_array_equal(out.np_plane(ch), want, err_msg=ch)


def test_box_sum_is_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 16, (19, 23)).astype(np.int32)
    for kh, kw in ((1, 1), (3, 3), (7, 3), (31, 31)):
        got = ops._box_sum(torch.from_numpy(x), kh, kw).numpy()
        p = np.pad(x.astype(np.int64), ((kh // 2,) * 2, (kw // 2,) * 2))
        want = sum(p[i:i + 19, j:j + 23] for i in range(kh)
                   for j in range(kw))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fault", ["no-pattern", "luma-cell"])
def test_bayer_refusals_match_jax(fault):
    jimg, pimg = _bayer_pair(2, 2, "RGGB", 8, seed=1)
    if fault == "no-pattern":
        jimg.bayer_pattern = pimg.bayer_pattern = None
    else:
        jimg.bayer_pattern = JBayerPattern(2, 2, [Channel.R, Channel.Y,
                                                  Channel.G, Channel.B])
        pimg.bayer_pattern = BayerPattern(2, 2, [Channel.R, Channel.Y,
                                                 Channel.G, Channel.B])
    target = dict(colorspace=Colorspace.RGB, chroma=Chroma.C444)
    with pytest.raises(Exception) as jerr:
        _apply("BayerToRGB", jimg, pimg, target)
    with pytest.raises(HeifError) as perr:
        pin = ColorState.of(pimg)
        ops.BayerToRGB().apply(pimg, pin, ops.BayerToRGB().output_state(
            pin, ColorState(**target)), ops.ColorConversionOptions())
    assert perr.value.subcode.name == jerr.value.subcode.name
    assert perr.value.subcode == (SubError.Unspecified if fault == "no-pattern"
                                  else SubError.Unsupported_data_version)


def test_options_defaults_match_jax():
    j, p = jops.ColorConversionOptions(), ops.ColorConversionOptions()
    assert vars(p) == vars(j)
    for name in ("NEAREST", "BILINEAR", "AVERAGE", "SHARP_YUV", "ALPHA_NONE",
                 "ALPHA_SOLID", "ALPHA_CHECKERBOARD"):
        assert getattr(ops.ColorConversionOptions, name) == \
            getattr(jops.ColorConversionOptions, name)
