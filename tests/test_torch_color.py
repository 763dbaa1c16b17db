"""The PyTorch port's colour kernels and YCbCr→RGB op against the JAX
package, on the CPU.

Contract (tests/test_pallas_fast.py:1-9): integer stages are exact; the
f32 H.273 matrix may differ by at most 1 LSB, on fewer than 1% of the
pixels, where a value sits on a .5 rounding boundary and the two
compilers order or contract the f32 operations differently.  Within the
port, the kernels' plain versions and the op's matrix path are held to
each other exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.codecs.unc import pallas_fast  # noqa: E402
from libheif_tpu.color import ops as jops  # noqa: E402
from libheif_tpu.color import pipeline as jpipeline  # noqa: E402
from libheif_tpu.color.nclx import (  # noqa: E402
    NclxProfile as JNclx, get_kr_kb)
from libheif_tpu.color.state import ColorState as JColorState  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    BayerPattern as JBayerPattern, PixelImage as JPixelImage, Colorspace,
    Chroma, Channel, subsampled_size as jsubsampled_size)

from libheif_tpu_torch.codecs.unc import cuda_fast, kernels  # noqa: E402
from libheif_tpu_torch.color import ops, pipeline  # noqa: E402
from libheif_tpu_torch.color.nclx import NclxProfile  # noqa: E402
from libheif_tpu_torch.color.state import ColorState  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    BayerPattern, PixelImage, from_numpy_planes)

SUB = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
KR, KB = get_kr_kb(6)


def _assert_lsb_contract(a, b, what=""):
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    assert a.shape == b.shape, what
    d = np.abs(a - b)
    assert d.max(initial=0) <= 1, f"{what}: maxdiff {d.max()}"
    assert (d > 0).mean() < 0.01, f"{what}: {(d > 0).mean():.3%} differ"


def _tiles(t, nbytes, seed):
    return np.random.default_rng(seed).integers(0, 256, (t, nbytes + 8),
                                                dtype=np.uint8)


def _ref_tiles(tiles, sub_x, sub_y, *, tile_rows, tile_cols, tile_h,
               tile_w, kr, kb, full_range):
    """numpy float32 reference in the order of libheif_tpu/color/ops.py
    (plane slices, nearest upsample, matrix), tiles pasted in place.

    In limited range with subsampled chroma, JAX's Pallas tile kernels
    scale the chroma before their bf16 upsample matmul
    (pallas_fast.py:88-111), which rounds it to bf16; the port keeps it
    in f32 as ops.py does, so there the port is held to this reference
    and not to the Pallas output."""
    t = tile_rows * tile_cols
    ch, cw = tile_h // sub_y, tile_w // sub_x
    ys, cs = tile_h * tile_w, ch * cw
    f = np.float32
    y = tiles[:, :ys].reshape(t, tile_h, tile_w).astype(f)

    def up(off):
        c = tiles[:, off:off + cs].reshape(t, ch, cw).astype(f) - f(128)
        return c.repeat(sub_y, 1).repeat(sub_x, 2)

    cb, cr = up(ys), up(ys + cs)
    if not full_range:
        y = (y - f(16)) * f(255.0 / 219.0)
        cb = cb * f(255.0 / 224.0)
        cr = cr * f(255.0 / 224.0)
    r = y + f(2 * (1 - kr)) * cr
    b = y + f(2 * (1 - kb)) * cb
    g = (y - f(kr) * r - f(kb) * b) / f(1 - kr - kb)
    rgb = np.stack([np.clip(np.round(c), 0, 255) for c in (r, g, b)])
    return rgb.astype(np.uint8).reshape(3, tile_rows, tile_cols, tile_h,
                                        tile_w) \
        .transpose(0, 1, 3, 2, 4).reshape(3, tile_rows * tile_h,
                                          tile_cols * tile_w)


# -------------------------------------------------- (d) tile colour kernels

@pytest.mark.parametrize("grid", [(2, 2, 64, 128), (3, 1, 18, 34)],
                         ids=["2x2x64x128", "3x1x18x34"])
@pytest.mark.parametrize("full_range", [True, False])
def test_yuv420_tiles_to_rgb_matches_jax(grid, full_range):
    tr, tc, th, tw = grid
    tiles = _tiles(tr * tc, th * tw * 3 // 2, seed=th + tw)
    kw = dict(tile_rows=tr, tile_cols=tc, tile_h=th, tile_w=tw,
              kr=float(KR), kb=float(KB), full_range=full_range)
    got = cuda_fast.yuv420_tiles_to_rgb(torch.from_numpy(tiles), **kw)
    assert got.dtype == torch.uint8
    _assert_lsb_contract(_ref_tiles(tiles, 2, 2, **kw), got.numpy())
    if full_range:
        ref = pallas_fast.yuv420_tiles_to_rgb(tiles, interpret=True, **kw)
        _assert_lsb_contract(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("sub", [(2, 2), (2, 1), (1, 1)],
                         ids=["420", "422", "444"])
@pytest.mark.parametrize("full_range", [True, False])
def test_yuv_tiles_to_rgb_matches_jax(sub, full_range):
    sx, sy = sub
    th, tw = 32, 64
    tiles = _tiles(4, th * tw + 2 * (th // sy) * (tw // sx), seed=5)
    kw = dict(tile_rows=2, tile_cols=2, tile_h=th, tile_w=tw, sub_x=sx,
              sub_y=sy, kr=float(KR), kb=float(KB), full_range=full_range)
    got = cuda_fast.yuv_tiles_to_rgb(torch.from_numpy(tiles), **kw)
    _assert_lsb_contract(_ref_tiles(tiles, **kw), got.numpy())
    if full_range or sub == (1, 1):
        ref = pallas_fast.yuv_tiles_to_rgb(tiles, interpret=True, **kw)
        _assert_lsb_contract(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("num_comps", [1, 3])
def test_planar8_tiles_to_image_exact(num_comps):
    th, tw = 16, 24
    tiles = _tiles(6, num_comps * th * tw, seed=num_comps)
    kw = dict(tile_rows=3, tile_cols=2, tile_h=th, tile_w=tw,
              num_comps=num_comps)
    ref = pallas_fast.planar8_tiles_to_image(tiles, interpret=True, **kw)
    got = cuda_fast.planar8_tiles_to_image(torch.from_numpy(tiles), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bad", ["dtype", "short", "odd_tile"])
def test_tile_wrapper_rejects(bad):
    tiles = torch.zeros((4, 64 * 64 * 3 // 2 + 8), dtype=torch.uint8)
    kw = dict(tile_rows=2, tile_cols=2, tile_h=64, tile_w=64, kr=0.299,
              kb=0.114)
    if bad == "dtype":
        tiles = tiles.to(torch.int16)
    elif bad == "short":
        tiles = tiles[:, :100]
    else:
        kw["tile_w"] = 63
    with pytest.raises((ValueError, TypeError)):
        cuda_fast.yuv420_tiles_to_rgb(tiles, **kw)


@pytest.mark.parametrize("bad", ["dtype", "cb_cr_differ", "empty_chroma"])
def test_planes_wrapper_rejects(bad):
    y = torch.zeros((8, 8), dtype=torch.uint8)
    cb = cr = torch.zeros((4, 4), dtype=torch.uint8)
    if bad == "dtype":
        y = y.to(torch.int16)
    elif bad == "cb_cr_differ":
        cr = torch.zeros((4, 3), dtype=torch.uint8)
    else:
        cb = cr = torch.zeros((0, 0), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_fast.ycbcr8_planes_to_rgb(y, cb, cr, kr=0.299, kb=0.114)


# ------------------------------------- planes_ycbcr8_to_rgb index arithmetic

def _emulate_chroma_taps(p, out_h, out_w, method):
    """The planes_ycbcr8_to_rgb kernel's chroma taps (csrc/unc_kernels.cu)
    replayed in numpy: the scaled chroma value of every output pixel.

    As the kernel does, it combines the chroma rows of an output row first
    (DOUBLE: 3 * row[y >> 1] + the row above or below, edge-clamped; HALF:
    row y >> 1; SAME: row y; GATHER: row (y*h)//out_h), then the columns
    of each 16-pixel run a thread owns: DOUBLE reads the run's 8 chroma
    columns, clamps those past the last one to it, and takes the halo
    column on each side from the neighbouring run (a shuffle, or the edge
    lane's own load) or, at the plane's edges, from its own end columns;
    HALF and SAME index by shift or identity; GATHER reads a per-block
    table of (o*w)//out_w for the block's 512 columns."""
    h, w = p.shape
    x_rule, y_rule, scale = cuda_fast.upsample_plan(h, w, out_h, out_w,
                                                    method)
    a = p.astype(np.int64)

    def row(y):
        if y_rule == cuda_fast.DOUBLE:
            m = y >> 1
            other = max(m - 1, 0) if y % 2 == 0 else min(m + 1, h - 1)
            return 3 * a[m] + a[other]
        if y_rule == cuda_fast.SAME:
            return a[y]
        if y_rule == cuda_fast.HALF:
            return a[y >> 1]
        return a[(y * h) // out_h]

    out = np.zeros((out_h, out_w), np.int64)
    for y in range(out_h):
        v = row(y)
        for x0 in range(0, out_w, 16):
            k = np.arange(x0, min(x0 + 16, out_w))
            if x_rule == cuda_fast.DOUBLE:
                c0 = x0 // 2
                cols = v[c0:c0 + 8]
                cols = np.concatenate([cols, np.repeat(cols[-1:],
                                                       8 - len(cols))])
                left = v[c0 - 1] if c0 > 0 else cols[0]
                right = v[c0 + 8] if c0 + 8 < w else cols[-1]
                ext = np.concatenate([[left], cols, [right]])
                j = (k - x0) // 2 + 1
                out[y, k] = 3 * ext[j] + np.where((k - x0) & 1, ext[j + 1],
                                                  ext[j - 1])
            elif x_rule == cuda_fast.HALF:
                out[y, k] = v[k >> 1]
            elif x_rule == cuda_fast.SAME:
                out[y, k] = v[k]
            else:
                block = (x0 // 512) * 512
                table = ((block + np.arange(512)) * w) // out_w
                out[y, k] = v[table[k - block]]
    return out, scale


@pytest.mark.parametrize("geom", [
    (32, 16, 64, 32), (34, 17, 67, 33), (5, 9, 5, 18), (5, 9, 9, 17),
    (1, 1, 2, 2), (1, 1, 1, 3), (8, 8, 8, 8), (4, 6, 13, 7),
    (10, 20, 32, 64), (16, 64, 32, 64), (32, 32, 32, 64), (20, 600, 40, 1200),
    (7, 301, 13, 601)])
@pytest.mark.parametrize("method", ["bilinear", "nearest-neighbor"])
def test_chroma_upsample_index_math(geom, method):
    h, w, out_h, out_w = geom
    p = np.random.default_rng(h * w).integers(0, 256, (h, w), dtype=np.uint8)
    plain, scale = cuda_fast._upsample_int_plain(torch.from_numpy(p), out_h,
                                                 out_w, method)
    emu, emu_scale = _emulate_chroma_taps(p, out_h, out_w, method)
    assert scale == emu_scale
    np.testing.assert_array_equal(plain.numpy(), emu)


@pytest.mark.parametrize("gap", [0, 1], ids=["N=2n", "N=2n-1"])
def test_half_tap_rule_is_a_shift(gap):
    """(o*n)//N == o >> 1 for every n <= 4096, N = 2n - gap and o < N: the
    kernel's HALF rule replaces the division by a shift."""
    for lo in range(1, 4097, 256):
        n = np.arange(lo, min(lo + 256, 4097), dtype=np.int64)
        N = 2 * n - gap
        starts = np.cumsum(N) - N
        ns = np.repeat(n, N)
        Ns = np.repeat(N, N)
        o = np.arange(int(N.sum()), dtype=np.int64) - np.repeat(starts, N)
        assert np.array_equal((o * ns) // Ns, o >> 1), lo


def test_tap_rules():
    plan = cuda_fast.upsample_plan
    D, H, S, G = (cuda_fast.DOUBLE, cuda_fast.HALF, cuda_fast.SAME,
                  cuda_fast.GATHER)
    assert plan(2048, 2048, 4096, 4096, "bilinear") == (D, D, 16)
    assert plan(34, 65, 67, 129, "bilinear") == (D, D, 16)
    assert plan(32, 32, 32, 64, "bilinear") == (D, S, 4)
    assert plan(2048, 2048, 4096, 4096, "nearest-neighbor") == (H, H, 1)
    assert plan(10, 20, 32, 64, "bilinear") == (G, G, 1)
    assert plan(32, 64, 32, 64, "bilinear") == (S, S, 1)


@pytest.mark.parametrize("case", [
    ("flagship 512x512 4:2:0 tiles", "tile", (512 * 512 * 3 // 2 + 8, 512, 2,
                                               8), 8),
    ("flagship tiles, 16-byte pitch", "tile", (393232, 512, 2, 8), 16),
    ("18x34 tiles", "tile", (18 * 34 * 3 // 2 + 8, 34, 2, 1), 1),
    ("6x10 tiles", "tile", (6 * 10 * 3 // 2 + 8, 10, 2, 3), 1),
    ("24-wide tiles", "tile", (8 * 24 * 3 // 2 + 8, 24, 2, 3), 4),
    ("4096-wide planes", "planes", (4096, 2048), 16),
    ("4100-wide planes", "planes", (4100, 2050), 1),
    ("4097-wide planes", "planes", (4097, 2049), 1),
    ("odd address", "planes", (4096, 2048, 0x7f0000001001), 1)],
    ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_vector_width_choice(case):
    _, kind, args, want = case
    fn = cuda_fast.tile_vector_width if kind == "tile" \
        else cuda_fast.planes_vector_width
    assert fn(*args) == want


def test_tile_store_width():
    """Tile outputs take 16-byte stores whatever the tile pitch allows
    the loads; otherwise the load width."""
    assert kernels._GATHER_PAD == 8      # the flagship pitch is 393,224
    assert cuda_fast.tile_store_width(8, 512, 8, 0x7f0000000000) == 16
    assert cuda_fast.tile_store_width(1, 512, 8, 0x7f0000000000) == 16
    assert cuda_fast.tile_store_width(4, 24, 3, 0x7f0000000000) == 4
    assert cuda_fast.tile_store_width(1, 34, 1, 0x7f0000000000) == 1


# ------------------------------------------- (e) YCbCrToRGB and the pipeline

def _planes(w, h, chroma, bits=8, seed=0):
    rng = np.random.default_rng(seed)
    sx, sy = SUB[chroma]
    cw, ch = (w + sx - 1) // sx, (h + sy - 1) // sy
    dt = np.uint8 if bits <= 8 else np.uint16
    return {Channel.Y: rng.integers(0, 1 << bits, (h, w), dtype=dt),
            Channel.Cb: rng.integers(0, 1 << bits, (ch, cw), dtype=dt),
            Channel.Cr: rng.integers(0, 1 << bits, (ch, cw), dtype=dt)}


def _both_images(planes, chroma, bits, mc=6, full_range=True):
    jimg = JPixelImage(planes[Channel.Y].shape[1], planes[Channel.Y].shape[0],
                       Colorspace.YCbCr, chroma)
    for ch, a in planes.items():
        jimg.set_plane(ch, a, bits)
    pimg = from_numpy_planes(planes, {c: bits for c in planes},
                             Colorspace.YCbCr, chroma, device="cpu")
    jimg.color_profile_nclx = JNclx(matrix_coefficients=mc,
                                    full_range_flag=full_range)
    pimg.color_profile_nclx = NclxProfile(matrix_coefficients=mc,
                                          full_range_flag=full_range)
    return jimg, pimg


def _apply_both(jimg, pimg, upsampling, use_kernel):
    """YCbCrToRGB.apply in each package, the kernel path forced on or off
    (JAX: Pallas in interpret mode; port: the kernel's plain version)."""
    jin, pin = JColorState.of(jimg), ColorState.of(pimg)
    jout = JColorState(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                       bits_per_pixel=jin.bits_per_pixel)
    pout = ColorState(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                      bits_per_pixel=pin.bits_per_pixel)
    try:
        jops.YCbCrToRGB.USE_PALLAS = use_kernel
        ops.YCbCrToRGB.USE_KERNEL = use_kernel
        ref = jops.YCbCrToRGB().apply(
            jimg, jin, jout,
            jops.ColorConversionOptions(chroma_upsampling=upsampling))
        got = ops.YCbCrToRGB().apply(
            pimg, pin, pout,
            ops.ColorConversionOptions(chroma_upsampling=upsampling))
    finally:
        jops.YCbCrToRGB.USE_PALLAS = None
        ops.YCbCrToRGB.USE_KERNEL = None
    return ref, got


@pytest.mark.parametrize("chroma", [Chroma.C420, Chroma.C422, Chroma.C444])
@pytest.mark.parametrize("upsampling", ["bilinear", "nearest-neighbor"])
@pytest.mark.parametrize("size", [(64, 32), (129, 67)])
@pytest.mark.parametrize("full_range", [True, False])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["matrix", "kernel"])
def test_ycbcr_to_rgb_matches_jax(chroma, upsampling, size, full_range,
                                  use_kernel):
    w, h = size
    planes = _planes(w, h, chroma, seed=w + h)
    jimg, pimg = _both_images(planes, chroma, 8, full_range=full_range)
    ref, got = _apply_both(jimg, pimg, upsampling, use_kernel)
    for ch in (Channel.R, Channel.G, Channel.B):
        assert got.plane(ch).dtype == torch.uint8
        assert got.plane(ch).shape == (h, w)
        _assert_lsb_contract(np.asarray(ref.plane(ch)), got.np_plane(ch), ch)
    # the kernel's plain version and the matrix path agree exactly
    _, other = _apply_both(jimg, pimg, upsampling, not use_kernel)
    for ch in (Channel.R, Channel.G, Channel.B):
        np.testing.assert_array_equal(got.np_plane(ch), other.np_plane(ch))


@pytest.mark.parametrize("chroma", [Chroma.C420, Chroma.C444])
@pytest.mark.parametrize("full_range", [True, False])
def test_ycbcr10_to_rgb_matches_jax(chroma, full_range):
    planes = _planes(33, 18, chroma, bits=10, seed=3)
    jimg, pimg = _both_images(planes, chroma, 10, full_range=full_range)
    ref, got = _apply_both(jimg, pimg, "bilinear", None)
    for ch in (Channel.R, Channel.G, Channel.B):
        assert got.plane(ch).dtype == torch.uint16
        assert got.bit_depth(ch) == 10
        _assert_lsb_contract(np.asarray(ref.plane(ch)), got.np_plane(ch), ch)


@pytest.mark.parametrize("upsampling", ["bilinear", "nearest-neighbor"])
def test_identity_matrix_matches_jax(upsampling):
    planes = _planes(20, 14, Chroma.C420, seed=9)
    jimg, pimg = _both_images(planes, Chroma.C420, 8, mc=0)
    ref, got = _apply_both(jimg, pimg, upsampling, True)
    for ch in (Channel.R, Channel.G, Channel.B):
        np.testing.assert_array_equal(got.np_plane(ch),
                                      np.asarray(ref.plane(ch)))


@pytest.mark.parametrize("chroma,bits", [(Chroma.C420, 8), (Chroma.C422, 8),
                                         (Chroma.C444, 10)])
def test_convert_image_chain_and_pixels(chroma, bits):
    planes = _planes(40, 24, chroma, bits=bits, seed=11)
    jimg, pimg = _both_images(planes, chroma, bits)
    jin, pin = JColorState.of(jimg), ColorState.of(pimg)
    jt = JColorState(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                     has_alpha=False, bits_per_pixel=0,
                     color_primaries=jin.color_primaries)
    pt = ColorState(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                    has_alpha=False, bits_per_pixel=0,
                    color_primaries=pin.color_primaries)
    jchain = jpipeline.find_pipeline(jin, jt)
    pchain = pipeline.find_pipeline(pin, pt)
    assert [type(op).__name__ for op, _ in pchain] == \
        [type(op).__name__ for op, _ in jchain]
    ref = jpipeline.convert_image(jimg, Colorspace.RGB, Chroma.C444)
    got = pipeline.convert_image(pimg, Colorspace.RGB, Chroma.C444,
                                 device="cpu")
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    for ch in (Channel.R, Channel.G, Channel.B):
        _assert_lsb_contract(np.asarray(ref.plane(ch)), got.np_plane(ch), ch)


# ---------------------------------- the ops of the output conversion, chains

CHAIN_INPUTS = {
    "ycc420": dict(colorspace=Colorspace.YCbCr, chroma=Chroma.C420),
    "ycc444_10": dict(colorspace=Colorspace.YCbCr, chroma=Chroma.C444,
                      bits_per_pixel=10),
    "ycc422_alpha": dict(colorspace=Colorspace.YCbCr, chroma=Chroma.C422,
                         has_alpha=True),
    "rgb444": dict(colorspace=Colorspace.RGB, chroma=Chroma.C444),
    "rgb444_16_alpha": dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                            bits_per_pixel=16, has_alpha=True),
    "mono": dict(colorspace=Colorspace.Monochrome,
                 chroma=Chroma.Monochrome),
    "mono_alpha": dict(colorspace=Colorspace.Monochrome,
                       chroma=Chroma.Monochrome, has_alpha=True),
    "interleaved_rgba": dict(colorspace=Colorspace.RGB,
                             chroma=Chroma.InterleavedRGBA, has_alpha=True),
    "filter_array": dict(colorspace=Colorspace.FilterArray,
                         chroma=Chroma.Monochrome),
}
CHAIN_TARGETS = {
    "rgb444": dict(colorspace=Colorspace.RGB, chroma=Chroma.C444),
    "rgb444_8bit": dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                        bits_per_pixel=8),
    "rgb_no_alpha": dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                         has_alpha=False),
    "rgb_alpha": dict(colorspace=Colorspace.RGB, chroma=Chroma.C444,
                      has_alpha=True),
    "interleaved_rgb": dict(colorspace=Colorspace.RGB,
                            chroma=Chroma.InterleavedRGB, has_alpha=False),
    "interleaved_rgba": dict(colorspace=Colorspace.RGB,
                             chroma=Chroma.InterleavedRGBA, has_alpha=True),
    "interleaved_rgba_8bit": dict(colorspace=Colorspace.RGB,
                                  chroma=Chroma.InterleavedRGBA,
                                  has_alpha=True, bits_per_pixel=8),
    "ycc420": dict(colorspace=Colorspace.YCbCr, chroma=Chroma.C420),
    "ycc444": dict(colorspace=Colorspace.YCbCr, chroma=Chroma.C444),
    "mono": dict(colorspace=Colorspace.Monochrome,
                 chroma=Chroma.Monochrome),
    "same_8bit": dict(bits_per_pixel=8),
}
# alpha composition modes (DropAlpha or FlattenAlpha in the search)
CHAIN_OPTIONS = {"none": "none", "flatten": "solid-color"}


def _states(inp, target):
    """The (JAX, port) input and target states; a target without
    has_alpha keeps the input's, as convert_image does."""
    t = dict(target)
    t.setdefault("has_alpha", inp.get("has_alpha", False))
    t.setdefault("bits_per_pixel", 0)
    return (JColorState(**inp), JColorState(**t)), \
        (ColorState(**inp), ColorState(**t))


def _chain_names(chain):
    return None if chain is None else [type(op).__name__ for op, _ in chain]


@pytest.mark.parametrize("mode", list(CHAIN_OPTIONS))
@pytest.mark.parametrize("target", list(CHAIN_TARGETS))
@pytest.mark.parametrize("inp", list(CHAIN_INPUTS))
def test_chain_matches_jax(inp, target, mode):
    """The port's Dijkstra search picks the JAX chain, op by op and state
    by state, for every (input, target) of the matrix."""
    (jin, jt), (pin, pt) = _states(CHAIN_INPUTS[inp], CHAIN_TARGETS[target])
    jopts = jops.ColorConversionOptions(
        alpha_composition_mode=CHAIN_OPTIONS[mode])
    popts = ops.ColorConversionOptions(
        alpha_composition_mode=CHAIN_OPTIONS[mode])
    jchain = jpipeline.find_pipeline(jin, jt, jopts)
    pchain = pipeline.find_pipeline(pin, pt, popts)
    assert _chain_names(pchain) == _chain_names(jchain)
    if pchain is not None:
        assert [s for _, s in pchain] == [ColorState(**vars(s))
                                          for _, s in jchain]


F32_OPS = {"YCbCrToRGB", "RGBToYCbCr", "RGBToMono"}


def _chain_image(state, w=67, h=45, seed=0):
    """A JAX and a port image in ``state`` (a CHAIN_INPUTS entry) with
    random samples; a filter-array image carries an RGGB pattern."""
    rng = np.random.default_rng(seed)
    bits = state.get("bits_per_pixel", 8)
    dt = np.uint8 if bits <= 8 else np.uint16
    cs, chroma = state["colorspace"], state["chroma"]
    if chroma == Chroma.InterleavedRGBA:
        names = [Channel.Interleaved]
    elif cs == Colorspace.YCbCr:
        names = [Channel.Y, Channel.Cb, Channel.Cr]
    elif cs == Colorspace.RGB:
        names = [Channel.R, Channel.G, Channel.B]
    elif cs == Colorspace.FilterArray:
        names = [Channel.FilterArray]
    else:
        names = [Channel.Y]
    if state.get("has_alpha") and chroma != Chroma.InterleavedRGBA:
        names.append(Channel.Alpha)
    planes = {}
    for ch in names:
        pw, ph = jsubsampled_size(w, h, ch, chroma)
        if ch == Channel.Interleaved:
            pw *= 4
        planes[ch] = rng.integers(0, 1 << bits, (ph, pw), dtype=dt)
    jimg = JPixelImage(w, h, cs, chroma)
    pimg = PixelImage(w, h, cs, chroma)
    for ch, a in planes.items():
        jimg.set_plane(ch, a, bits)
        pimg.set_plane(ch, torch.from_numpy(a), bits)
    if cs == Colorspace.FilterArray:
        jimg.bayer_pattern = JBayerPattern.rggb()
        pimg.bayer_pattern = BayerPattern.rggb()
    return jimg, pimg


@pytest.mark.parametrize("mode", list(CHAIN_OPTIONS))
@pytest.mark.parametrize("target", list(CHAIN_TARGETS))
@pytest.mark.parametrize("inp", list(CHAIN_INPUTS))
def test_convert_image_matches_jax(inp, target, mode):
    """convert_image end to end against the JAX convert_image for every
    (input, target, alpha mode) of the matrix: the same chain, output
    state, planes and depths; exact unless the chain runs an f32 matrix
    (then the colour contract).  Where the JAX package finds no chain,
    the port raises too."""
    jimg, pimg = _chain_image(CHAIN_INPUTS[inp], seed=len(inp + target))
    t = CHAIN_TARGETS[target]
    kw = dict(target_has_alpha=t.get("has_alpha"),
              target_bits=t.get("bits_per_pixel", 0))
    args = (t.get("colorspace", Colorspace.Undefined),
            t.get("chroma", Chroma.Undefined))
    jopts = jops.ColorConversionOptions(
        alpha_composition_mode=CHAIN_OPTIONS[mode])
    popts = ops.ColorConversionOptions(
        alpha_composition_mode=CHAIN_OPTIONS[mode])
    try:
        ref = jpipeline.convert_image(jimg, *args, options=jopts, **kw)
    except Exception as e:
        with pytest.raises(HeifError) as perr:
            pipeline.convert_image(pimg, *args, options=popts,
                                   device="cpu", **kw)
        assert perr.value.subcode.name == e.subcode.name
        return
    got = pipeline.convert_image(pimg, *args, options=popts, device="cpu",
                                 **kw)
    (_, _), (pin, pt) = _states(CHAIN_INPUTS[inp], t)
    names = _chain_names(pipeline.find_pipeline(pin, pt, popts))
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert got.np_plane(ch).dtype == want.dtype, ch
        if F32_OPS.isdisjoint(names):
            np.testing.assert_array_equal(got.np_plane(ch), want,
                                          err_msg=f"{ch} {names}")
        else:
            _assert_lsb_contract(want, got.np_plane(ch), f"{ch} {names}")


def test_all_ops_in_jax_order():
    assert [type(op).__name__ for op in ops.ALL_OPS] == \
        [type(op).__name__ for op in jops.ALL_OPS]
    assert [op.cost for op in ops.ALL_OPS] == \
        [op.cost for op in jops.ALL_OPS]


def _rgb_image(w, h, bits, alpha_bits=None, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits <= 8 else np.uint16
    planes = {c: rng.integers(0, 1 << bits, (h, w), dtype=dt)
              for c in (Channel.R, Channel.G, Channel.B)}
    bit_map = {c: bits for c in planes}
    if alpha_bits:
        planes[Channel.Alpha] = rng.integers(
            0, 1 << alpha_bits, (h, w),
            dtype=np.uint8 if alpha_bits <= 8 else np.uint16)
        bit_map[Channel.Alpha] = alpha_bits
    return planes, bit_map


def _pair(planes, bit_map, colorspace, chroma):
    h, w = next(iter(planes.values())).shape
    jimg = JPixelImage(w, h, colorspace, chroma)
    for ch, a in planes.items():
        jimg.set_plane(ch, a, bit_map[ch])
    return jimg, from_numpy_planes(planes, bit_map, colorspace, chroma,
                                   device="cpu")


@pytest.mark.parametrize("case", [
    ("rgb8", Colorspace.RGB, Chroma.InterleavedRGBA, False, 0),
    ("rgb8", Colorspace.RGB, Chroma.InterleavedRGB, None, 0),
    ("rgb10_a8", Colorspace.RGB, Chroma.InterleavedRGBA, True, 0),
    ("rgb8_a10", Colorspace.RGB, Chroma.InterleavedRGBA, True, 0),
    ("rgb10_a8", Colorspace.RGB, Chroma.C444, False, 8),
    ("rgb8", Colorspace.RGB, Chroma.C444, True, 0),
    ("rgb12", Colorspace.RGB, Chroma.C444, None, 8),
    ("rgb8", Colorspace.RGB, Chroma.C444, None, 10),
    ("rgb8", Colorspace.RGB, Chroma.InterleavedRGB, None, 16),
    ("mono8_a8", Colorspace.RGB, Chroma.InterleavedRGBA, True, 0),
    ("mono16", Colorspace.RGB, Chroma.C444, None, 8),
    ("irgba8", Colorspace.RGB, Chroma.C444, None, 0),
    ("irgba8", Colorspace.RGB, Chroma.C444, False, 0),
    ("irgb10", Colorspace.RGB, Chroma.C444, None, 8),
], ids=lambda c: "-".join(str(x).replace(" ", "") for x in c))
def test_output_ops_match_jax(case):
    """MonoToRGB, BitDepthConvert (down and up), DropAlpha, AddAlpha and
    the two interleave ops through convert_image: exact, and the same
    chain as the JAX package."""
    src, colorspace, chroma, has_alpha, bits = case
    if src.startswith("mono"):
        b = int(src[4:].split("_")[0])
        rng = np.random.default_rng(b)
        dt = np.uint8 if b <= 8 else np.uint16
        planes = {Channel.Y: rng.integers(0, 1 << b, (7, 9), dtype=dt)}
        bit_map = {Channel.Y: b}
        if src.endswith("_a8"):
            planes[Channel.Alpha] = rng.integers(0, 256, (7, 9),
                                                 dtype=np.uint8)
            bit_map[Channel.Alpha] = 8
        jimg, pimg = _pair(planes, bit_map, Colorspace.Monochrome,
                           Chroma.Monochrome)
    elif src.startswith("irgb"):
        n = 4 if src.startswith("irgba") else 3
        b = int(src[4 if n == 3 else 5:])
        rng = np.random.default_rng(n + b)
        dt = np.uint8 if b <= 8 else np.uint16
        planes = {Channel.Interleaved: rng.integers(0, 1 << b, (7, 9 * n),
                                                    dtype=dt)}
        jimg, pimg = _pair(planes, {Channel.Interleaved: b}, Colorspace.RGB,
                           Chroma.InterleavedRGBA if n == 4
                           else Chroma.InterleavedRGB)
    else:
        parts = src[3:].split("_a")
        planes, bit_map = _rgb_image(9, 7, int(parts[0]),
                                     int(parts[1]) if len(parts) > 1 else None,
                                     seed=len(src))
        jimg, pimg = _pair(planes, bit_map, Colorspace.RGB, Chroma.C444)
    kw = dict(target_has_alpha=has_alpha, target_bits=bits)
    ref = jpipeline.convert_image(jimg, colorspace, chroma, **kw)
    got = pipeline.convert_image(pimg, colorspace, chroma, device="cpu", **kw)
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert got.np_plane(ch).dtype == want.dtype, ch
        np.testing.assert_array_equal(got.np_plane(ch), want, err_msg=ch)
