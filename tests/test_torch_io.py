"""The PyTorch port's image-file codecs (``libheif_tpu_torch.io``) against
the JAX package's (``libheif_tpu.io``), on the CPU: every case of
tests/test_io_tools.py that is not a tool run, through both packages.

* PNG, Y4M and PPM: each writer's bytes equal the JAX writer's for the
  same numpy array and for the same samples as a torch tensor; each read
  equals the JAX read (PNG with every scanline filter);
* TIFF: the writer's bytes equal the JAX writer's (8 and 16 bits, RGB,
  RGBA, grey); reads equal the JAX reads, of its files, of PIL's and of a
  big-endian file; PIL opens the files;
* JPEG: ``write_jpeg`` gives the JAX bytes and ``read_jpeg`` the JAX
  planes; PIL opens the files;
* WebP: through the system libwebp, lossless and lossy with alpha, the
  JAX bytes and planes; bad data raises a HeifError;
* brands: computed and read as the JAX package does, on freshly written
  files (the reference corpus is not in the repository).
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu import brands as jbrands  # noqa: E402
from libheif_tpu import io as jio  # noqa: E402
from libheif_tpu.color.pipeline import convert_image as jconvert  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)

from libheif_tpu_torch import brands  # noqa: E402
from libheif_tpu_torch import io as pio  # noqa: E402
from libheif_tpu_torch.color import convert_image  # noqa: E402
from libheif_tpu_torch.context import HeifContext  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import PixelImage  # noqa: E402

CPU = "cpu"


def image_pair(cs, chroma, planes, depth):
    """The same image for the JAX package and for the port (CPU)."""
    h, w = next(iter(planes.values())).shape
    j = JPixelImage(w, h, cs, chroma)
    p = PixelImage(w, h, cs, chroma)
    for ch, a in planes.items():
        j.set_plane(ch, a, depth)
        p.set_plane(ch, torch.from_numpy(a.copy()), depth)
    return j, p


def rgb_pair(w=40, h=30, seed=9, alpha=False, depth=8):
    rng = np.random.default_rng(seed)
    dt = np.uint16 if depth > 8 else np.uint8
    names = [Channel.R, Channel.G, Channel.B] + \
        ([Channel.Alpha] if alpha else [])
    return image_pair(Colorspace.RGB, Chroma.C444,
                      {ch: rng.integers(0, 1 << depth, (h, w), dt)
                       for ch in names}, depth)


def same_planes(jimg, pimg):
    assert (pimg.width, pimg.height, pimg.colorspace, pimg.chroma) == \
        (jimg.width, jimg.height, jimg.colorspace, jimg.chroma)
    assert pimg.channels() == jimg.channels()
    for ch in jimg.channels():
        assert pimg.bit_depth(ch) == jimg.bit_depth(ch), ch
        assert pimg.plane(ch).device.type == "cpu"
        np.testing.assert_array_equal(pimg.np_plane(ch),
                                      np.asarray(jimg.plane(ch)), err_msg=ch)


# ------------------------------------------------------------ PNG, Y4M, PPM

@pytest.mark.parametrize("shape,bd", [
    ((7, 5), 8), ((7, 5, 3), 8), ((4, 4, 4), 8), ((3, 9, 2), 8),
    ((5, 6, 3), 16),
])
def test_png_roundtrip(shape, bd):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 2 ** bd, shape,
                       np.uint16 if bd == 16 else np.uint8)
    data = jio.write_png(arr, bd)
    assert pio.write_png(arr, bd) == data
    assert pio.write_png(torch.from_numpy(arr.copy()), bd) == data
    out, obd = pio.read_png(data)
    jout, jbd = jio.read_png(data)
    ref = arr[:, :, None] if arr.ndim == 2 else arr
    assert obd == jbd == bd and np.array_equal(out, ref)
    assert out.dtype == jout.dtype and np.array_equal(out, jout)


def _png_with_filter(arr, ft, color_type=2):
    h, w, c = arr.shape
    raw = arr.reshape(h, -1)
    lines = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        lines.append(ft)
        cur = raw[y].astype(np.int32)
        enc = np.zeros(w * c, np.int32)
        for x in range(w * c):
            a = cur[x - c] if x >= c else 0
            b = prev[x]
            cc = prev[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) >> 1][ft] if ft < 4 else None
            if ft == 4:
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else \
                    (b if pb <= pc else cc)
            enc[x] = (cur[x] - pred) & 0xFF
        lines.extend(enc.astype(np.uint8).tobytes())
        prev = cur

    def ck(t, p):
        return struct.pack(">I", len(p)) + t + p + \
            struct.pack(">I", zlib.crc32(t + p) & 0xFFFFFFFF)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + ck(b"IHDR", ihdr) +
            ck(b"IDAT", zlib.compress(bytes(lines))) + ck(b"IEND", b""))


@pytest.mark.parametrize("ft", range(5))
@pytest.mark.parametrize("channels", [3, 4])
def test_png_all_filters(ft, channels):
    rng = np.random.default_rng(ft)
    arr = rng.integers(0, 256, (6, 5, channels), np.uint8)
    data = _png_with_filter(arr, ft, {3: 2, 4: 6}[channels])
    out, _ = pio.read_png(data)
    assert np.array_equal(out, arr)
    assert np.array_equal(out, jio.read_png(data)[0])


def test_png_bad_filter_and_signature_raise_alike():
    good = _png_with_filter(np.zeros((2, 2, 3), np.uint8), 0)
    at = good.index(b"IDAT")
    ln = struct.unpack(">I", good[at - 4:at])[0]
    idat = zlib.compress(bytes([5]) + bytes(6) + bytes([0]) + bytes(6))
    bad = good[:at - 4] + struct.pack(">I", len(idat)) + b"IDAT" + idat + \
        struct.pack(">I", zlib.crc32(b"IDAT" + idat)) + good[at + 8 + ln:]
    for data in (bad, b"GIF89a" + bytes(20)):
        with pytest.raises(ValueError) as j:
            jio.read_png(data)
        with pytest.raises(ValueError) as p:
            pio.read_png(data)
        assert str(p.value) == str(j.value)


def test_y4m_roundtrip():
    rng = np.random.default_rng(1)
    frames = [(rng.integers(0, 256, (8, 12), np.uint8),
               rng.integers(0, 256, (4, 6), np.uint8),
               rng.integers(0, 256, (4, 6), np.uint8)) for _ in range(2)]
    data = jio.write_y4m(frames, (25, 1))
    assert pio.write_y4m(frames, (25, 1)) == data
    assert pio.write_y4m([tuple(torch.from_numpy(p.copy()) for p in f)
                          for f in frames], (25, 1)) == data
    r, jr = pio.read_y4m(data), jio.read_y4m(data)
    assert r["fps"] == jr["fps"] == (25, 1) and len(r["frames"]) == 2
    assert {k: r[k] for k in ("width", "height", "chroma")} == \
        {k: jr[k] for k in ("width", "height", "chroma")}
    for a, b, c in zip(frames, r["frames"], jr["frames"]):
        assert all(np.array_equal(x, y) and np.array_equal(y, z)
                   for x, y, z in zip(a, b, c))


def test_ppm_roundtrip():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (4, 7, 3), np.uint8)
    g = rng.integers(0, 256, (4, 7), np.uint8)
    for a in (rgb, g):
        data = jio.write_ppm(a)
        assert pio.write_ppm(a) == data
        assert pio.write_ppm(torch.from_numpy(a.copy())) == data
        assert np.array_equal(pio.read_ppm(data), a)
        assert np.array_equal(pio.read_ppm(b"# c\n" + data), a)


# ------------------------------------------------------------------ brands

def test_brands_computation():
    for args in ((["hvc1"], "hvc1"), ([], None, ["hvc1"]),
                 (["av01"], "av01"), (["unci"], "unci")):
        assert brands.compute_brands(*args) == jbrands.compute_brands(*args)
    m, c = brands.compute_brands(["hvc1"], "hvc1")
    assert m == "heic" and "mif1" in c and "miaf" in c


def _written(fmt):
    j, p = image_pair(Colorspace.YCbCr, Chroma.C444, {
        ch: np.full((16, 16), 100, np.uint8)
        for ch in (Channel.Y, Channel.Cb, Channel.Cr)}, 8)
    jc, pc = JHeifContext(), HeifContext(device=CPU)
    jc.encode_image(j, fmt=fmt)
    pc.encode_image(p, fmt=fmt)
    return jc.write(), pc.write()


@pytest.mark.parametrize("fmt", ["hevc", "unci"])
def test_brands_reading_and_writing(fmt):
    jd, d = _written(fmt)
    assert d == jd
    for fn in ("read_main_brand", "list_compatible_brands",
               "has_compatible_filetype"):
        assert getattr(brands, fn)(d[:64]) == getattr(jbrands, fn)(d[:64])
    if fmt == "hevc":
        assert brands.read_main_brand(d) == "heic"
        assert "MiHB" in brands.list_compatible_brands(d)
    assert not brands.has_compatible_filetype(b"\0" * 32)


# -------------------------------------------------------------------- TIFF

@pytest.mark.parametrize("alpha,depth", [(False, 8), (True, 8),
                                         (False, 16), (True, 16)])
def test_tiff_roundtrip(alpha, depth):
    j, p = rgb_pair(alpha=alpha, depth=depth)
    data = jio.write_tiff(j)
    assert pio.write_tiff(p) == data
    same_planes(jio.read_tiff(data), pio.read_tiff(data, CPU))
    PIL = pytest.importorskip("PIL.Image")
    pim = PIL.open(io.BytesIO(data))
    pim.load()
    assert pim.size == (p.width, p.height)


def test_tiff_monochrome():
    rng = np.random.default_rng(6)
    j, p = image_pair(Colorspace.Monochrome, Chroma.Monochrome,
                      {Channel.Y: rng.integers(0, 256, (9, 13), np.uint8)},
                      8)
    data = jio.write_tiff(j)
    assert pio.write_tiff(p) == data
    same_planes(jio.read_tiff(data), pio.read_tiff(data, CPU))


def test_tiff_pil_and_big_endian_read():
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (12, 17, 3), np.uint8)
    buf = io.BytesIO()
    PIL.fromarray(arr, "RGB").save(buf, format="TIFF")
    out = pio.read_tiff(buf.getvalue(), CPU)
    np.testing.assert_array_equal(out.np_plane(Channel.R), arr[:, :, 0])
    same_planes(jio.read_tiff(buf.getvalue()), out)
    # the same samples, big-endian, 16 bits, one strip
    a16 = arr.astype(np.uint16) * 257
    h, w = a16.shape[:2]
    pix = a16.astype(">u2").tobytes()
    tags = [(256, 3, 1, w << 16), (257, 3, 1, h << 16),
            (258, 3, 3, 8 + len(pix) + 2 + 6 * 12 + 4),
            (262, 3, 1, 2 << 16), (273, 4, 1, 8), (277, 3, 1, 3 << 16)]
    mm = b"MM" + struct.pack(">HI", 42, 8 + len(pix)) + pix + \
        struct.pack(">H", len(tags)) + \
        b"".join(struct.pack(">HHII", *t) for t in tags) + \
        struct.pack(">I", 0) + struct.pack(">HHH", 16, 16, 16)
    out = pio.read_tiff(mm, CPU)
    np.testing.assert_array_equal(out.np_plane(Channel.B), a16[:, :, 2])
    same_planes(jio.read_tiff(mm), out)


@pytest.mark.parametrize("data", [b"II", b"XX" + bytes(10),
                                  b"II" + struct.pack("<HI", 43, 8),
                                  b"II" + struct.pack("<HI", 42, 100)])
def test_tiff_bad_data_raises_alike(data):
    with pytest.raises(JHeifError) as j:
        jio.read_tiff(data)
    with pytest.raises(HeifError) as p:
        pio.read_tiff(data, CPU)
    assert (p.value.code, p.value.subcode) == (j.value.code, j.value.subcode)


# -------------------------------------------------------------------- JPEG

def test_jpeg_roundtrip_via_own_codec():
    rng = np.random.default_rng(11)
    j, p = image_pair(Colorspace.YCbCr, Chroma.C420, {
        Channel.Y: rng.integers(40, 200, (32, 48), np.uint8),
        Channel.Cb: np.full((16, 24), 110, np.uint8),
        Channel.Cr: np.full((16, 24), 150, np.uint8)}, 8)
    data = jio.write_jpeg(j, quality=92)
    assert pio.write_jpeg(p, quality=92) == data
    assert data[:2] == b"\xff\xd8"
    out = pio.read_jpeg(data, CPU)
    same_planes(jio.read_jpeg(data), out)
    a = p.np_plane(Channel.Y).astype(np.float64)
    b = out.np_plane(Channel.Y).astype(np.float64)
    psnr = 10 * np.log10(255 ** 2 / max(1e-9, np.mean((a - b) ** 2)))
    assert psnr > 30


@pytest.mark.parametrize("quality", [50, 90])
def test_jpeg_pil_crosscheck(quality):
    PIL = pytest.importorskip("PIL.Image")
    j, p = rgb_pair()
    jy = jconvert(j, Colorspace.YCbCr, Chroma.C420)
    py = convert_image(p, Colorspace.YCbCr, Chroma.C420, device=CPU)
    data = jio.write_jpeg(jy, quality=quality)
    assert pio.write_jpeg(py, quality=quality) == data
    # an RGB image is converted by the encoder, as in JAX
    assert pio.write_jpeg(p, quality=quality) == \
        jio.write_jpeg(j, quality=quality)
    pim = PIL.open(io.BytesIO(data))
    pim.load()
    assert pim.size == (p.width, p.height)
    same_planes(jio.read_jpeg(data), pio.read_jpeg(data, CPU))


def test_jpeg_files(tmp_path):
    _, p = rgb_pair()
    path = str(tmp_path / "a.jpg")
    pio.write_jpeg_file(p, path, quality=80)
    assert open(path, "rb").read() == pio.write_jpeg(p, 80)
    same_planes(jio.read_jpeg_file(path), pio.read_jpeg_file(path, CPU))


# -------------------------------------------------------------------- WebP

def webp_pair(w=40, h=24, alpha=False):
    rng = np.random.default_rng(5)
    planes = {Channel.R: (np.mgrid[0:h, 0:w][1] * 6 % 256).astype(np.uint8),
              Channel.G: np.full((h, w), 77, np.uint8),
              Channel.B: rng.integers(0, 256, (h, w), dtype=np.uint8)}
    if alpha:
        planes[Channel.Alpha] = rng.integers(0, 255, (h, w), dtype=np.uint8)
    return image_pair(Colorspace.RGB, Chroma.C444, planes, 8)


def test_webp_lossless_roundtrip():
    j, p = webp_pair()
    data = jio.write_webp(j, lossless=True)
    assert pio.write_webp(p, lossless=True) == data
    assert data[:4] == b"RIFF" and data[8:12] == b"WEBP"
    out = pio.read_webp(data, CPU)
    same_planes(jio.read_webp(data), out)
    for ch in (Channel.R, Channel.G, Channel.B):
        assert np.array_equal(out.np_plane(ch), p.np_plane(ch)), ch


def test_webp_lossy_alpha():
    j, p = webp_pair(alpha=True)
    data = jio.write_webp(j, quality=85)
    assert pio.write_webp(p, quality=85) == data
    out = pio.read_webp(data, CPU)
    same_planes(jio.read_webp(data), out)
    assert out.has_channel(Channel.Alpha)
    r0 = p.np_plane(Channel.R).astype(np.int64)
    r1 = out.np_plane(Channel.R).astype(np.int64)
    assert ((r0 - r1) ** 2).mean() < 2000     # lossy but sane


def test_webp_from_ycbcr_and_16_bits(tmp_path):
    j, p = rgb_pair(w=20, h=16, depth=10)
    assert pio.write_webp(p, lossless=True) == \
        jio.write_webp(j, lossless=True)
    jy = jconvert(rgb_pair(w=20, h=16)[0], Colorspace.YCbCr, Chroma.C444)
    py = convert_image(rgb_pair(w=20, h=16)[1], Colorspace.YCbCr,
                       Chroma.C444, device=CPU)
    path = str(tmp_path / "y.webp")
    pio.write_webp_file(py, path, quality=70)
    assert open(path, "rb").read() == jio.write_webp(jy, quality=70)
    same_planes(jio.read_webp_file(path), pio.read_webp_file(path, CPU))


def test_webp_bad_data_raises():
    with pytest.raises(JHeifError) as j:
        jio.read_webp(b"not a webp file at all")
    with pytest.raises(HeifError) as p:
        pio.read_webp(b"not a webp file at all", CPU)
    assert (p.value.code, p.value.subcode) == (j.value.code, j.value.subcode)


def test_io_exports_match_jax():
    assert sorted(pio.__all__) == sorted(jio.__all__)
    for name in pio.__all__:
        assert callable(getattr(pio, name)), name
