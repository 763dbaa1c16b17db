"""The PyTorch port's still-image encode against the JAX package, on the
CPU: the same images, made with numpy from a seed, go through both.

* ``fdct8x8_islow`` and ``fdct_quant_plain`` equal the JAX
  ``fdct8x8_islow`` and ``_fdct_quant_program`` exactly; the wrapper's
  clamped-coordinate padding equals ``_pad_to``'s edge replication;
* ``encode_jpeg`` gives the JAX bytes at qualities 1-100, 4:4:4, 4:2:2,
  4:2:0 and mono, and sizes 8x8 to 509x301; the C++ encode scan gives the
  Python emission's bytes; the port decodes its streams as the JAX
  ``decode_jpeg`` does;
* ``HeifContext(device="cpu")`` with ``new_file``, ``encode_image`` and
  ``write`` gives the JAX context's file byte for byte, for unci (8 and
  16 bits, every colourspace and sampling, tiles with whole and per-tile
  compression, Bayer with its cpat, nclx and ICC), mski and jpeg (with
  and without alpha, quality set and defaulted); each file reopens in both
  packages to the same items and planes.  At 10-14 bits both write 16-bit
  words under a uncC of that depth (ROADMAP §3 D): equal bytes and equal
  decodes, which are not the source;
* HEVC and AV1 have no encoder in the port yet and raise
  ``Unsupported_codec``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu import brands as jbrands  # noqa: E402
from libheif_tpu.codecs import registry as jregistry  # noqa: E402
from libheif_tpu.codecs.jpeg import decoder as jdec  # noqa: E402
from libheif_tpu.codecs.jpeg import encoder as jenc  # noqa: E402
from libheif_tpu.codecs.jpeg.idct import (  # noqa: E402
    fdct8x8_islow as j_fdct)
from libheif_tpu.codecs import unc as junc_codec  # noqa: E402
from libheif_tpu.color.nclx import NclxProfile as JNclx  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.bitstream import ByteWriter as JByteWriter  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    BayerPattern as JBayerPattern, PixelImage as JPixelImage, Channel,
    Colorspace, Chroma)
from libheif_tpu.option_types import (  # noqa: E402
    EncodingOptions as JEncodingOptions)

from libheif_tpu_torch import EncodingOptions, HeifContext  # noqa: E402
from libheif_tpu_torch import brands  # noqa: E402
from libheif_tpu_torch import context as pcontext  # noqa: E402
from libheif_tpu_torch.codecs import registry  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import cuda_fast as F  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import decoder as pdec  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import encoder as penc  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import native_scan  # noqa: E402
from libheif_tpu_torch.codecs.jpeg.idct import (  # noqa: E402
    fdct8x8_islow, fdct_quant_plain)
from libheif_tpu_torch.codecs.jpeg.tables import (  # noqa: E402
    STD_CHROMA_QUANT, STD_LUMA_QUANT, quality_scaled_quant)
from libheif_tpu_torch.codecs.unc import UnciEncoder  # noqa: E402
from libheif_tpu_torch.color.nclx import NclxProfile  # noqa: E402
from libheif_tpu_torch.core.bitstream import ByteWriter  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import (  # noqa: E402
    BayerPattern, PixelImage)
from tests import jax_native  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX encoder's native FDCT and scan are the oracle of the JPEG
    cases: load the library first (tests/jax_native.py)."""
    jax_native.ensure_loaded()


# ------------------------------------------------------------------ images

KINDS = {  # kind -> (colourspace, chroma, channels)
    "mono": (Colorspace.Monochrome, Chroma.Monochrome, [Channel.Y]),
    "rgb": (Colorspace.RGB, Chroma.C444, [Channel.R, Channel.G, Channel.B]),
    "rgba": (Colorspace.RGB, Chroma.C444,
             [Channel.R, Channel.G, Channel.B, Channel.Alpha]),
    "444": (Colorspace.YCbCr, Chroma.C444, [Channel.Y, Channel.Cb,
                                            Channel.Cr]),
    "422": (Colorspace.YCbCr, Chroma.C422, [Channel.Y, Channel.Cb,
                                            Channel.Cr]),
    "420": (Colorspace.YCbCr, Chroma.C420, [Channel.Y, Channel.Cb,
                                            Channel.Cr]),
}
SUB = {Chroma.C420: (2, 2), Chroma.C422: (2, 1)}


def planes_of(kind, w, h, bits=8, seed=0, alpha=False):
    """Numpy planes of a photo-like image (a smooth field plus noise) of
    ``kind``; chroma planes of ceil(w / sx) x ceil(h / sy)."""
    rng = np.random.default_rng(seed)
    cs, chroma, chans = KINDS[kind]
    if alpha and Channel.Alpha not in chans:
        chans = chans + [Channel.Alpha]
    top = (1 << bits) - 1
    out = {}
    for i, ch in enumerate(chans):
        sx, sy = SUB.get(chroma, (1, 1)) if ch in (Channel.Cb, Channel.Cr) \
            else (1, 1)
        pw, ph = -(-w // sx), -(-h // sy)
        yy, xx = np.mgrid[0:ph, 0:pw]
        field = 0.5 + 0.35 * np.sin(xx / (7.0 + i) + yy / 13.0) + \
            0.1 * np.cos((xx - 2 * yy) / 5.0)
        v = field * top + rng.normal(0, top / 16, (ph, pw))
        out[ch] = np.clip(np.rint(v), 0, top).astype(
            np.uint8 if bits <= 8 else np.uint16)
    return cs, chroma, out


def image_pair(kind, w, h, bits=8, seed=0, alpha=False):
    """The same image for the JAX package and for the port."""
    cs, chroma, planes = planes_of(kind, w, h, bits, seed, alpha)
    j = JPixelImage(w, h, cs, chroma)
    p = PixelImage(w, h, cs, chroma)
    for ch, a in planes.items():
        j.set_plane(ch, a, bits)
        p.set_plane(ch, torch.from_numpy(a.copy()), bits)
    return j, p


def write_both(j, p, fmt, jopts=None, popts=None):
    """The file each package's context writes for one encoded image."""
    jc = JHeifContext()
    jc.new_file()
    jc.encode_image(j, fmt, jopts)
    pc = HeifContext(device="cpu")
    pc.new_file()
    pc.encode_image(p, fmt, popts)
    return jc.write(), pc.write()


def same_image(ref, got):
    assert (got.width, got.height, got.colorspace, got.chroma) == \
        (ref.width, ref.height, ref.colorspace, ref.chroma)
    assert sorted(got.channels()) == sorted(ref.channels())
    for ch in ref.channels():
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        np.testing.assert_array_equal(got.np_plane(ch),
                                      np.asarray(ref.plane(ch)), err_msg=ch)


def reopened_equal(blob):
    """The file opens in both packages to the same items, primary and
    top-level images, and each top-level image decodes to the same
    planes (its alpha attached)."""
    j = JHeifContext.read_from_bytes(blob)
    p = HeifContext.read_from_bytes(blob, device="cpu")
    ids = p.file.item_ids
    assert ids == j.file.item_ids
    assert [p.file.get_infe(i).item_type for i in ids] == \
        [j.file.get_infe(i).item_type for i in ids]
    assert [p.file.get_infe(i).hidden for i in ids] == \
        [j.file.get_infe(i).hidden for i in ids]
    assert p.primary_item_id == j.primary_item_id
    assert p.top_level_image_ids() == j.top_level_image_ids()
    out = {}
    for iid in p.top_level_image_ids():
        ref, got = j.decode_image(iid), p.decode_image(iid)
        same_image(ref, got)
        out[iid] = got
    return out


# --------------------------------------------------------- FDCT, quantiser

def level_shifted_blocks(seed, n=300):
    rng = np.random.default_rng(seed)
    b = rng.integers(-128, 128, (n, 8, 8)).astype(np.int32)
    b[0], b[1] = -128, 127                           # the extremes
    b[2, ::2], b[2, 1::2] = -128, 127
    b[3] = np.where((np.arange(8)[:, None] + np.arange(8)) % 2, 127, -128)
    return b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fdct_matches_jax(seed):
    b = level_shifted_blocks(seed)
    got = fdct8x8_islow(torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fdct(b)))


@pytest.mark.parametrize("quality", [1, 25, 50, 75, 90, 100])
@pytest.mark.parametrize("table", ["luma", "chroma"])
def test_fdct_quant_plain_matches_jax_program(quality, table):
    b = level_shifted_blocks(quality)
    q = quality_scaled_quant(
        STD_LUMA_QUANT if table == "luma" else STD_CHROMA_QUANT, quality)
    want = np.asarray(jenc._fdct_quant_program(b.shape[0])(b, np.asarray(q)))
    got = fdct_quant_plain(torch.from_numpy(b), torch.from_numpy(
        np.asarray(q, np.int32)))
    assert got.dtype == torch.int16 and tuple(got.shape) == (b.shape[0], 64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw", [(1, 1), (5, 13), (16, 16), (17, 9)])
def test_padded_blocks_match_pad_to(hw):
    """The wrapper's clamped coordinates give ``_pad_to``'s samples."""
    h, w = hw
    plane = np.random.default_rng(h * w).integers(0, 256, (h, w),
                                                  dtype=np.uint8)
    bh, bw = -(-h // 8) + 1, -(-w // 8) + 1
    job = F.FdctJob(torch.from_numpy(plane), bw, bh, 0)
    want = jenc._blocks_of(jenc._pad_to(plane, bh * 8, bw * 8)
                           .astype(np.int32) - 128)
    np.testing.assert_array_equal(F.padded_blocks(job).numpy(), want)


def test_fdct_quant_one_call_for_all_planes():
    """fdct_quant on CPU tensors: views at odd offsets of one buffer, two
    tables, the output job after job, as fdct_quant_plain block by block."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.integers(0, 256, (80, 90), dtype=np.uint8))
    jobs = [F.FdctJob(buf[3:20, 5:38], 5, 3, 0),
            F.FdctJob(buf[41:42, 1:2], 1, 1, 1),
            F.FdctJob(buf[7:71, 11:75], 8, 8, 1)]
    quant = torch.from_numpy(rng.integers(1, 256, (2, 64)).astype(np.int32))
    before = F.JPEG_FDCT_QUANT.launches
    got = F.fdct_quant(jobs, quant)
    assert F.JPEG_FDCT_QUANT.launches == before      # the plain version
    assert tuple(got.shape) == (15 + 1 + 64, 64)
    first = 0
    for j in jobs:
        n = j.blocks_w * j.blocks_h
        want = fdct_quant_plain(F.padded_blocks(j), quant[j.qidx])
        assert torch.equal(got[first:first + n], want)
        first += n


def test_fdct_quant_refusals():
    plane = torch.zeros((8, 8), dtype=torch.uint8)
    q = torch.ones((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        F.fdct_quant([F.FdctJob(plane.to(torch.int16), 1, 1, 0)], q)
    with pytest.raises(ValueError):
        F.fdct_quant([F.FdctJob(plane, 1, 1, 1)], q)
    with pytest.raises(ValueError):
        F.fdct_quant([F.FdctJob(plane, 1, 1, 0)], torch.ones((5, 64),
                                                           dtype=torch.int32))
    with pytest.raises(ValueError):
        F.fdct_quant([], q)


# --------------------------------------------------------------- JPEG bytes

SIZES = [(8, 8), (17, 9), (33, 31), (64, 48), (509, 301)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["444", "422", "420", "mono"])
@pytest.mark.parametrize("quality", [1, 50, 75, 90, 100])
def test_encode_jpeg_bytes_match_jax(size, kind, quality):
    j, p = image_pair(kind, *size, seed=quality + size[0])
    assert penc.encode_jpeg(p, quality) == jenc.encode_jpeg(j, quality)


def plans_of(p, quality):
    """The encoder's component plans of a port image (coefficients from
    the plain FDCT), as ``encode_jpeg`` hands them to the scan."""
    captured = {}
    real = native_scan.encode_scan

    def spy(plans, mcus_w, mcus_h):
        captured.update(plans=plans, mcus=(mcus_w, mcus_h))
        return real(plans, mcus_w, mcus_h)
    native_scan.encode_scan = spy
    try:
        penc.encode_jpeg(p, quality)
    finally:
        native_scan.encode_scan = real
    return captured["plans"], captured["mcus"]


@pytest.mark.parametrize("kind,quality", [("420", 75), ("444", 100),
                                          ("422", 1), ("mono", 100),
                                          ("mono", 30)])
def test_cxx_encode_scan_matches_python(kind, quality):
    """The C++ scan's bytes equal the Python emission's (long codes,
    zero runs past 16, 0xFF stuffing and the 1-bit padding among them)."""
    _, p = image_pair(kind, 77, 45, seed=quality)
    plans, (mw, mh) = plans_of(p, quality)
    got = native_scan.encode_scan(plans, mw, mh)
    assert got == penc._entropy_encode(plans, mw, mh)
    assert b"\xFF\x00" in got or quality < 50


def test_cxx_encode_scan_noise_blocks():
    """Random coefficients of every size class, in one component."""
    rng = np.random.default_rng(9)
    blocks = rng.integers(-1023, 1024, (12, 64)).astype(np.int16)
    blocks[::3, 1:] = 0
    blocks[1::3, 20:] = 0
    blocks[2::3, 1:40] = 0
    _, p = image_pair("mono", 32, 24)
    plans, (mw, mh) = plans_of(p, 50)
    plans[0].blocks = blocks
    assert native_scan.encode_scan(plans, mw, mh) == \
        penc._entropy_encode(plans, mw, mh)


@pytest.mark.parametrize("kind", ["444", "422", "420", "mono"])
@pytest.mark.parametrize("size", [(33, 31), (509, 301)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_port_decodes_its_streams_as_jax(kind, size):
    _, p = image_pair(kind, *size, seed=7)
    data = penc.encode_jpeg(p, 85)
    got = pdec.decode_jpeg(data, device="cpu")
    ref = jdec.decode_jpeg(data)
    same_image(ref, got)


def test_encode_jpeg_refusals():
    _, p = image_pair("rgb", 16, 16)
    with pytest.raises(HeifError):
        penc.encode_jpeg(p, 50)
    _, p = image_pair("420", 16, 16, bits=10)
    with pytest.raises(HeifError) as e:
        penc.encode_jpeg(p, 50)
    assert e.value.subcode == SubError.Unsupported_bit_depth


def test_jpeg_encoder_is_registered():
    enc = registry.get_encoder("jpeg")
    assert isinstance(enc, penc.JpegEncoder)
    assert ("jpeg", "tpu-jpeg") in registry.list_encoders()
    assert registry.have_encoder("jpeg")
    assert not registry.have_encoder("hevc")
    assert not registry.have_encoder("av1")


# ------------------------------------------------------------ unci files

UNCI_CASES = [(k, b) for b in (8, 16)
              for k in ("mono", "rgb", "rgba", "444", "422", "420")]


@pytest.mark.parametrize("kind,bits", UNCI_CASES)
def test_unci_file_matches_jax(kind, bits):
    j, p = image_pair(kind, 64, 48, bits, seed=bits)
    a, b = write_both(j, p, "unci")
    assert a == b
    reopened_equal(a)


@pytest.mark.parametrize("method", ["zlib", "defl"])
@pytest.mark.parametrize("per_tile", [False, True],
                         ids=["whole", "per-tile"])
@pytest.mark.parametrize("kind", ["rgb", "420"])
def test_unci_tiles_compressed_match_jax(monkeypatch, method, per_tile,
                                         kind):
    """2x2 tiles with zlib or deflate over the whole payload, or a unit a
    tile (icef): each context's unci encoder made with compress_per_tile,
    as the JAX writer's UnciEncoder takes it."""
    if per_tile:
        class JPerTile(junc_codec.UnciEncoder):
            def __init__(self, *a, **kw):
                super().__init__(*a, compress_per_tile=True, **kw)

        class PPerTile(UnciEncoder):
            def __init__(self, *a, **kw):
                super().__init__(*a, compress_per_tile=True, **kw)
        monkeypatch.setattr(junc_codec, "UnciEncoder", JPerTile)
        monkeypatch.setattr(pcontext, "UnciEncoder", PPerTile)
    j, p = image_pair(kind, 64, 48, seed=3)
    a, b = write_both(
        j, p, "unci", JEncodingOptions(tile_cols=2, tile_rows=2,
                                       compression=method),
        EncodingOptions(tile_cols=2, tile_rows=2, compression=method))
    assert a == b
    assert (b"icef" in a) == per_tile
    reopened_equal(a)


@pytest.mark.parametrize("per_tile", [False, True], ids=["whole", "per-tile"])
def test_unci_encoder_boxes_match_jax(per_tile):
    """UnciEncoder.encode: the payload and each box, byte for byte."""
    j, p = image_pair("420", 32, 32, seed=4)
    ja = junc_codec.UnciEncoder(2, 2, "zlib", per_tile).encode(j)
    pa = UnciEncoder(2, 2, "zlib", per_tile).encode(p)
    assert pa[0] == ja[0]
    for jb, pb in zip(ja[1:], pa[1:]):
        assert (jb is None) == (pb is None)
        if jb is None:
            continue
        jw, pw = JByteWriter(), ByteWriter()
        jb.write(jw)
        pb.write(pw)
        assert pw.data() == jw.data()


def test_unci_brotli_refused():
    _, p = image_pair("mono", 16, 16)
    with pytest.raises(HeifError) as e:
        UnciEncoder(compression="brot").encode(p)
    assert e.value.subcode == SubError.Unsupported_generic_compression_method


def test_unci_tiles_must_divide():
    _, p = image_pair("rgb", 30, 30)
    with pytest.raises(HeifError):
        UnciEncoder(4, 1).encode(p)


@pytest.mark.parametrize("bits", [8, 16])
def test_unci_bayer_with_cpat_matches_jax(bits):
    rng = np.random.default_rng(bits)
    w, h = 66, 44
    raw = rng.integers(0, 1 << bits, (h, w),
                       dtype=np.uint8 if bits <= 8 else np.uint16)
    j = JPixelImage(w, h, Colorspace.FilterArray, Chroma.Monochrome)
    j.set_plane(Channel.FilterArray, raw, bits)
    j.bayer_pattern = JBayerPattern(2, 2, [Channel.R, Channel.G, Channel.G,
                                           Channel.B], [1.0, 0.5, 0.5, 2.0])
    p = PixelImage(w, h, Colorspace.FilterArray, Chroma.Monochrome)
    p.set_plane(Channel.FilterArray, torch.from_numpy(raw.copy()), bits)
    p.bayer_pattern = BayerPattern(2, 2, [Channel.R, Channel.G, Channel.G,
                                          Channel.B], [1.0, 0.5, 0.5, 2.0])
    a, b = write_both(j, p, "unci")
    assert a == b and b"cpat" in a
    reopened_equal(a)


@pytest.mark.parametrize("profile", ["nclx-image", "nclx-option", "icc",
                                     "both"])
def test_unci_colour_profiles_match_jax(profile):
    j, p = image_pair("444", 32, 16, seed=6)
    jopts, popts = JEncodingOptions(), EncodingOptions()
    if profile == "nclx-image":
        j.color_profile_nclx = JNclx(1, 13, 1, False)
        p.color_profile_nclx = NclxProfile(1, 13, 1, False)
    if profile == "nclx-option":
        jopts.output_nclx = JNclx(9, 16, 9, True)
        popts.output_nclx = NclxProfile(9, 16, 9, True)
    if profile in ("icc", "both"):
        icc = bytes(range(200))
        j.color_profile_icc = p.color_profile_icc = icc
    if profile == "both":
        j.color_profile_nclx = JNclx(12, 13, 6, True)
        p.color_profile_nclx = NclxProfile(12, 13, 6, True)
    a, b = write_both(j, p, "unci", jopts, popts)
    assert a == b and b"colr" in a
    reopened_equal(a)


@pytest.mark.parametrize("bits", [10, 12, 14])
def test_unci_10_to_14_bits_as_jax(bits):
    """ROADMAP §3 D: the JAX unci writer writes 16-bit words under a uncC
    that declares ``bits``; the port copies it for byte parity.  Both
    packages decode the file alike, and not to the source."""
    j, p = image_pair("rgb", 32, 16, bits, seed=bits)
    a, b = write_both(j, p, "unci")
    assert a == b
    got = reopened_equal(a)[1]
    src = p.np_plane(Channel.R)
    assert not np.array_equal(got.np_plane(Channel.R), src)


# ------------------------------------------------------------- mski, jpeg

@pytest.mark.parametrize("bits", [8, 16])
def test_mski_file_matches_jax(bits):
    j, p = image_pair("mono", 40, 24, bits, seed=bits)
    a, b = write_both(j, p, "mski")
    assert a == b
    reopened_equal(a)


def test_mski_needs_monochrome():
    _, p = image_pair("rgb", 8, 8)
    ctx = HeifContext(device="cpu")
    with pytest.raises(HeifError) as e:
        ctx.encode_image(p, "mski")
    assert e.value.subcode == SubError.Unsupported_image_type


JPEG_FILES = [("420", False, None), ("420", True, None), ("444", True, 90),
              ("422", False, 90), ("mono", False, 75), ("rgb", False, None),
              ("rgba", False, 60)]


@pytest.mark.parametrize("kind,alpha,quality", JPEG_FILES)
def test_jpeg_file_matches_jax(kind, alpha, quality):
    """jpeg items: with and without an alpha aux item (auxC, auxl,
    hidden), quality set or defaulted (EncodingOptions.quality, 50); an
    RGB image goes to YCbCr 4:2:0 first."""
    j, p = image_pair(kind, 61, 35, seed=11, alpha=alpha)
    if quality is None:
        a, b = write_both(j, p, "jpeg")
    else:
        a, b = write_both(j, p, "jpeg", JEncodingOptions(quality=quality),
                          EncodingOptions(quality=quality))
    assert a == b
    got = reopened_equal(a)
    if alpha or kind == "rgba":
        assert b"auxC" in a and b"auxl" in a
        assert all(img.has_alpha() for img in got.values())


def test_jpeg_default_quality_is_50():
    j, p = image_pair("420", 40, 24, seed=2)
    ctx = HeifContext(device="cpu")
    iid = ctx.encode_image(p, "jpeg")
    assert bytes(ctx.file.get_item_data(iid)) == penc.encode_jpeg(p, 50)


def test_encoded_items_decode_in_the_same_context():
    """An encoding context holds its items: they decode before write."""
    _, p = image_pair("420", 32, 32, seed=8, alpha=True)
    ctx = HeifContext(device="cpu")
    uid = ctx.encode_image(p, "unci")
    assert ctx.primary_item_id == uid
    img = ctx.decode_image(uid)
    for ch in (Channel.Y, Channel.Cb, Channel.Cr, Channel.Alpha):
        assert torch.equal(img.plane(ch), p.plane(ch)), ch


def test_premultiplied_alpha_reference():
    j, p = image_pair("rgba", 16, 16, seed=1)
    p.premultiplied_alpha = True
    ctx = HeifContext(device="cpu")
    iid = ctx.encode_image(p, "unci")
    alpha_id = [i for i in ctx.file.item_ids if i != iid][0]
    prem = ctx.file.get_references_from(iid, "prem")
    assert [r.to_item_ids for r in prem] == [[alpha_id]]
    assert ctx.file.get_infe(alpha_id).hidden


def test_save_alpha_channel_off():
    j, p = image_pair("420", 16, 16, seed=1, alpha=True)
    a, b = write_both(j, p, "jpeg", JEncodingOptions(save_alpha_channel=False),
                      EncodingOptions(save_alpha_channel=False))
    assert a == b and b"auxl" not in a


def test_brands_and_primary_of_several_items():
    """Two images: the first stays primary until set_primary_item; ftyp
    follows the content."""
    j1, p1 = image_pair("420", 16, 16, seed=1)
    j2, p2 = image_pair("mono", 16, 16, seed=2)
    jc = JHeifContext()
    jc.new_file()
    jc.encode_image(j1, "unci")
    second = jc.encode_image(j2, "jpeg")
    jc.set_primary_item(second)
    pc = HeifContext(device="cpu")
    pc.new_file()
    pc.encode_image(p1, "unci")
    assert pc.encode_image(p2, "jpeg") == second
    pc.set_primary_item(second)
    a, b = jc.write(), pc.write()
    assert a == b
    assert pc.file.ftyp.major_brand == "jpeg"
    reopened_equal(a)


@pytest.mark.parametrize("fmt", ["unci", "jpeg"])
def test_encode_into_a_read_context_matches_jax(fmt):
    """An image encoded into a context read from bytes joins the file's
    items; the read file keeps its brands; the rewrite equals the JAX
    package's."""
    j0, _ = image_pair("420", 32, 16, seed=4)
    jc = JHeifContext()
    jc.new_file()
    jc.encode_image(j0, "unci")
    blob = jc.write()
    j, p = image_pair("mono", 16, 16, seed=5)
    jr = JHeifContext.read_from_bytes(blob)
    pr = HeifContext.read_from_bytes(blob, device="cpu")
    assert pr.encode_image(p, fmt) == jr.encode_image(j, fmt)
    a, b = jr.write(), pr.write()
    assert a == b
    assert not pr.file.created_for_writing
    reopened_equal(a)


def test_write_to_file(tmp_path):
    _, p = image_pair("mono", 16, 16)
    ctx = HeifContext(device="cpu")
    ctx.encode_image(p, "unci")
    ctx.write_to_file(str(tmp_path / "a.heif"))
    ctx.file.write_to_file(str(tmp_path / "b.heif"))
    assert (tmp_path / "a.heif").read_bytes() == ctx.write()
    assert (tmp_path / "b.heif").read_bytes() == ctx.write()


def test_write_without_a_file_raises():
    with pytest.raises(HeifError):
        HeifContext(device="cpu").write()


@pytest.mark.parametrize("fmt", ["hevc", "av1"])
def test_hevc_av1_have_no_encoder_yet(fmt):
    _, p = image_pair("420", 16, 16)
    ctx = HeifContext(device="cpu")
    with pytest.raises(HeifError) as e:
        ctx.encode_image(p, fmt)
    assert e.value.subcode == SubError.Unsupported_codec
    assert fmt in str(e.value)


# ------------------------------------------- options, registry, brands

def test_encoding_options_match_jax():
    assert EncodingOptions().__dict__ == JEncodingOptions().__dict__
    assert EncodingOptions().quality == 50


def test_registry_encoder_half_matches_jax():
    """Priority order, lookup by id, unregister: as the JAX registry."""
    made = []
    for reg in (registry, jregistry):
        class Low(reg.Encoder):
            id, format, priority = "low", "test-fmt", 10

        class High(reg.Encoder):
            id, format, priority = "high", "test-fmt", 90
        low, high = Low(), High()
        reg.register_encoder(low)
        reg.register_encoder(high)
        try:
            made.append((reg.get_encoder("test-fmt").id,
                         reg.get_encoder("test-fmt", "low").id,
                         reg.get_encoder("test-fmt", "none"),
                         reg.have_encoder("test-fmt"),
                         [e for e in reg.list_encoders()
                          if e[0] == "test-fmt"],
                         high.parameters()))
        finally:
            reg.unregister_encoder(high)
            reg.unregister_encoder(low)
        assert not reg.have_encoder("test-fmt")
    assert made[0] == made[1] == ("high", "low", None, True,
                                  [("test-fmt", "high"), ("test-fmt", "low")],
                                  [])
    assert penc.JpegEncoder().parameters() == \
        jenc.JpegEncoder().parameters()


BRAND_CASES = [
    (["hvc1"], "hvc1", []), (["av01", "av01"], "av01", []),
    (["jpeg", "unci"], "unci", []), (["unci", "mski"], None, []),
    ([], None, ["hvc1"]), ([], None, ["av01", "mett"]),
    (["grid", "hvc1"], "grid", ["hvc1"]), (["vvc1"], "vvc1", []),
    (["xyz1"], "xyz1", []), ([], None, [])]


@pytest.mark.parametrize("items,primary,tracks", BRAND_CASES)
def test_compute_brands_matches_jax(items, primary, tracks):
    assert brands.compute_brands(items, primary, tracks) == \
        jbrands.compute_brands(items, primary, tracks)


@pytest.mark.parametrize("data", [
    b"", b"\x00\x00\x00\x18ftypheic\x00\x00\x00\x00mif1heic",
    b"\x00\x00\x00\x14ftypavif\x00\x00\x00\x01miaf",
    b"\x00\x00\x00\x10ftypabcd\x00\x00\x00\x00",
    b"\x00\x00\x00\x18ftypxxxx\x00\x00\x00\x00abcdmsf1",
    b"\x00\x00\x00\x08free\x00\x00\x00\x00", b"\x00\x00\x00\x40ftypmif1"])
def test_brand_readers_match_jax(data):
    for name in ("read_main_brand", "read_minor_version",
                 "list_compatible_brands", "has_compatible_filetype"):
        assert getattr(brands, name)(data) == getattr(jbrands, name)(data), \
            name


def test_nclx_colr_box_matches_jax():
    jw, pw = JByteWriter(), ByteWriter()
    JNclx(9, 16, 9, False).to_colr_box().write(jw)
    NclxProfile(9, 16, 9, False).to_colr_box().write(pw)
    assert pw.data() == jw.data()


# ---------------------------------------------------- the port's own rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_encode_runs_without_jax_or_the_jax_package():
    """jpeg, unci and mski encodes, a write and the mode search in a fresh
    interpreter where importing jax fails."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np, torch
        from libheif_tpu_torch import EncodingOptions, HeifContext
        from libheif_tpu_torch.codecs.hevc.device_modes import (
            plan_modes_device)
        from libheif_tpu_torch.image.pixel_image import PixelImage
        rng = np.random.default_rng(0)
        img = PixelImage(32, 16, "YCbCr", "420")
        for ch, shape in (("Y", (16, 32)), ("Cb", (8, 16)), ("Cr", (8, 16)),
                          ("Alpha", (16, 32))):
            img.set_plane(ch, torch.from_numpy(
                rng.integers(0, 256, shape, dtype=np.uint8)), 8)
        mono = PixelImage(32, 16, "monochrome", "monochrome")
        mono.set_plane("Y", img.plane("Y"), 8)
        ctx = HeifContext(device="cpu")
        ctx.encode_image(img, "jpeg", EncodingOptions(quality=80))
        ctx.encode_image(img, "unci")
        ctx.encode_image(mono, "mski")
        blob = ctx.write()
        assert HeifContext.read_from_bytes(blob, device="cpu") \\
            .decode_image(None).plane("Alpha").shape == (16, 32)
        assert set(plan_modes_device(img.plane("Y"), device="cpu")) == {3, 4}
        bad = [m for m in sys.modules
               if m == "libheif_tpu" or m.startswith("libheif_tpu.")]
        assert not bad, bad
        assert sys.modules["jax"] is None
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("entry", ["HeifContext", "plan_modes_device"])
def test_encode_entry_points_default_to_cuda(entry, monkeypatch):
    """Without CUDA, the encode side's entry points called without device=
    raise rather than running on the CPU."""
    from libheif_tpu_torch.codecs.hevc.device_modes import plan_modes_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"HeifContext": lambda: HeifContext(),
          "plan_modes_device": lambda: plan_modes_device(
              np.zeros((16, 16), np.uint8))}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn()


def test_encode_moves_planes_to_the_context_device():
    """encode_image works on a copy of the image with every plane on the
    context's device and leaves the caller's image as it is (a context on
    PyTorch's data-less "meta" device stands in for a card)."""
    _, p = image_pair("420", 16, 16, seed=3, alpha=True)
    assert HeifContext(device="cpu")._on_device(p) is p
    moved = HeifContext(device="meta")._on_device(p)
    assert moved is not p
    assert sorted(moved.channels()) == sorted(p.channels())
    for ch in p.channels():
        assert moved.plane(ch).device.type == "meta"
        assert p.plane(ch).device.type == "cpu"
        assert moved.bit_depth(ch) == p.bit_depth(ch)
