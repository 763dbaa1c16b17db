"""The port's JPEG 2000 codec against the JAX package's, on the CPU.

The cases of tests/test_j2k_codec.py as comparisons of the port with the
JAX package and with OpenJPEG (through PIL): the MQ coder, the 5/3 and
9/7 wavelets, the EBCOT block coder (its C++ engine, host/j2k_t1.cc,
against its Python passes and the JAX coder), decodes of OpenJPEG
codestreams (bit-exact for 5/3, the JAX tests' own bounds for 9/7 and
truncated layers, and equal to the JAX decode), encodes (codestream bytes
equal to the JAX encoder's, decoded by OpenJPEG to the source); then
``j2k1`` items and ``tili`` tiles through the context, with the JAX
writer's bytes, the ``j2kH``/``cdef`` property, a codestream of mixed
component depths and a 16-bit one through ``J2KImageDecoder``, and a
failed build, load or call of the C++ block coders raising.
"""

from __future__ import annotations

import hashlib
import io
import os

import numpy as np
import pytest
import torch

from libheif_tpu.codecs.j2k import dwt as jdwt
from libheif_tpu.codecs.j2k.codec import J2KDecoder_Registry
from libheif_tpu.codecs.j2k.decoder import decode_codestream as jdecode
from libheif_tpu.codecs.j2k.encoder import encode_codestream as jencode
from libheif_tpu.codecs.j2k.t1 import T1Encoder as JT1Encoder
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.image.pixel_image import PixelImage as JaxImage
from libheif_tpu.option_types import EncodingOptions as JOptions
from libheif_tpu_torch import EncodingOptions, HeifContext, _build
from libheif_tpu_torch.boxes.j2k import Box_cdef, Box_j2kH
from libheif_tpu_torch.codecs.host_copy import join_bytes, split_bytes
from libheif_tpu_torch.codecs.j2k import J2KImageDecoder, dwt, native
from libheif_tpu_torch.codecs.j2k.decoder import decode_codestream
from libheif_tpu_torch.codecs.j2k.encoder import encode_codestream
from libheif_tpu_torch.codecs.j2k.mq import MQDecoder, MQEncoder
from libheif_tpu_torch.codecs.j2k.t1 import T1Decoder, T1Encoder
from libheif_tpu_torch.core import trace
from libheif_tpu_torch.core.error import HeifError, SubError
from libheif_tpu_torch.image.pixel_image import from_numpy_planes
from libheif_tpu_torch.sequences import track as ptrack
from tests import card_encodes, jax_native
from tests.test_torch_sequences import assert_same_image

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX coder's C++ engines (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def _opj_encode(arr: np.ndarray, mode: str, **kw) -> bytes:
    im = PIL.fromarray(arr, mode)
    buf = io.BytesIO()
    im.save(buf, format="JPEG2000", irreversible=kw.pop("irreversible", False),
            **kw)
    return buf.getvalue()


def _opj_decode(data: bytes) -> np.ndarray:
    return np.asarray(PIL.open(io.BytesIO(data)))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, float) - np.asarray(b, float)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def both_decodes(data):
    """The port's and the JAX package's planes of ``data``, which must be
    equal; the port's."""
    mine, _ = decode_codestream(data)
    ref, _ = jdecode(data)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    return mine


def both_encodes(planes, **kw):
    """The port's codestream, equal to the JAX encoder's."""
    data = encode_codestream(planes, **kw)
    assert data == jencode(planes, **kw)
    return data


# --------------------------------------------------------------- the core

def test_mq_roundtrip_random():
    rng = np.random.default_rng(0)
    for _ in range(40):
        n = int(rng.integers(1, 1500))
        ctxs = rng.integers(0, 19, n)
        bits = (rng.random(n) < rng.random()).astype(int)
        enc = MQEncoder()
        for c, b in zip(ctxs, bits):
            enc.encode(int(c), int(b))
        dec = MQDecoder(enc.flush())
        assert [dec.decode(int(c)) for c in ctxs] == list(bits)


@pytest.mark.parametrize("shape", [(23, 37), (5, 7), (1, 9), (16, 17)])
@pytest.mark.parametrize("parity", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_dwt_53_roundtrip_as_jax(shape, parity):
    rng = np.random.default_rng(5)
    x = rng.integers(-500, 500, shape).astype(np.int32)
    subs = dwt.sd_2d(x, parity[0], parity[1], True)
    for a, b in zip(subs, jdwt.sd_2d(x, parity[0], parity[1], True)):
        np.testing.assert_array_equal(a, b)
    x2 = dwt.sr_2d(*subs, parity[0], parity[1], True)
    assert (x2 == x).all()


def test_dwt_97_roundtrip_as_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(33, 41)) * 100
    subs = dwt.sd_2d(x, 0, 0, False)
    for a, b in zip(subs, jdwt.sd_2d(x, 0, 0, False)):
        np.testing.assert_array_equal(a, b)
    x2 = dwt.sr_2d(*subs, 0, 0, False)
    assert np.abs(x2 - x).max() < 1e-8


@pytest.mark.parametrize("shape", [(23, 37), (3, 5), (4, 4), (64, 64)])
def test_t1_roundtrip(shape):
    rng = np.random.default_rng(7)
    for orient in range(4):
        c = rng.integers(-300, 300, shape).astype(np.int32)
        data, npasses, nplanes = T1Encoder(shape[1], shape[0],
                                           orient).encode(c)
        out = T1Decoder(shape[1], shape[0], orient).decode(
            data, npasses, 12, 12 - nplanes)
        assert (out == c).all()


def test_t1_native_matches_python_and_jax():
    """The C++ EBCOT coder byte for byte (and plane for plane, with
    truncated pass counts) against the Python passes and the JAX coder."""
    rng = np.random.default_rng(11)
    for _ in range(12):
        h, w = [int(v) for v in rng.integers(1, 65, 2)]
        orient = int(rng.integers(0, 4))
        coeffs = rng.integers(-500, 501, (h, w)).astype(np.int32)
        py = T1Encoder(w, h, orient).encode_python(coeffs)
        nat = T1Encoder(w, h, orient).encode(coeffs)
        assert nat == py == tuple(JT1Encoder(w, h, orient).encode(coeffs))
        data, npass, npl = py
        mb = npl + 2
        for n in (npass, max(1, npass - 2)):
            np.testing.assert_array_equal(
                T1Decoder(w, h, orient).decode(data, n, mb, mb - npl),
                T1Decoder(w, h, orient).decode_python(data, n, mb,
                                                      mb - npl))


def test_t1_large_block_takes_python(monkeypatch):
    """A block the C++ coder refuses by shape (wider than 4096) goes to
    the Python passes before any call."""
    monkeypatch.setattr(native, "MAX_SIDE", 8)
    calls = []
    monkeypatch.setattr(native, "lib", lambda: calls.append(1))
    c = np.random.default_rng(3).integers(-9, 9, (4, 12)).astype(np.int32)
    data, npass, npl = T1Encoder(12, 4, 0).encode(c)
    out = T1Decoder(12, 4, 0).decode(data, npass, 12, 12 - npl)
    np.testing.assert_array_equal(out, c)
    assert calls == []


@pytest.mark.parametrize("htj2k", [False, True], ids=["t1", "ht"])
def test_wide_code_block_decodes_through_python(monkeypatch, htj2k):
    """Code-block exponents beyond the standard's limit (13 + 2 here)
    parse, as in the JAX package, so a non-conformant codestream can hold
    a block wider than the C++ coders take: it is coded and decoded by
    the Python passes, to the JAX encoder's bytes and the JAX decode's
    planes."""
    a = np.random.default_rng(8).integers(126, 130, (4, 4100)) \
        .astype(np.uint8)
    data = both_encodes([a], levels=0, cb_exp=(13, 2), htj2k=htj2k)
    assert (data[data.index(b"\xff\x52") + 10] & 0x0F) + 2 == 13
    assert not native.fits(4100, 4)
    monkeypatch.setattr(native, "lib", lambda: pytest.fail("C++ called"))
    planes = both_decodes(data)
    np.testing.assert_array_equal(planes[0], a)


# ---------------------------------------------- decodes against OpenJPEG

@pytest.mark.parametrize("shape,res", [
    ((16, 16), 2), ((23, 37), 4), ((96, 128), 6), ((1, 1), 1),
    ((255, 257), 6),
])
def test_gray_lossless_bitexact(shape, res):
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    data = _opj_encode(a, "L", num_resolutions=res)
    planes = both_decodes(data)
    assert (planes[0] == _opj_decode(data)).all()


def test_rgb_mct_lossless_bitexact():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    data = _opj_encode(a, "RGB", num_resolutions=4)
    planes = both_decodes(data)
    assert (np.stack(planes, -1) == _opj_decode(data)).all()


def test_multi_tile_bitexact():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (96, 96), dtype=np.uint8)
    data = _opj_encode(a, "L", num_resolutions=3, tile_size=(32, 32))
    planes = both_decodes(data)
    assert (planes[0] == _opj_decode(data)).all()


def smooth(h=120, w=160):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (np.sin(xx / 9) * 60 + np.cos(yy / 7) * 50 + 128)
    return img.clip(0, 255).astype(np.uint8)


def test_irreversible_97_close():
    img = smooth()
    data = _opj_encode(img, "L", irreversible=True, num_resolutions=5)
    planes = both_decodes(data)
    ref = _opj_decode(data)
    assert np.abs(planes[0].astype(int) - ref.astype(int)).max() <= 2
    assert _psnr(planes[0], ref) > 55


def test_rate_truncated_layers():
    yy, xx = np.mgrid[0:120, 0:160]
    img = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    data = _opj_encode(img, "L", irreversible=True, num_resolutions=5,
                       quality_mode="rates", quality_layers=[20])
    planes = both_decodes(data)
    assert _psnr(planes[0], _opj_decode(data)) > 35


# ---------------------------------------------- encodes against OpenJPEG

@pytest.mark.parametrize("shape,levels", [
    ((16, 16), 1), ((16, 16), 0), ((96, 128), 5), ((23, 37), 3),
    ((300, 400), 5),
])
def test_encode_gray_lossless(shape, levels):
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, shape).astype(np.int32)
    data = both_encodes([a], levels=levels)
    got = both_decodes(data)
    assert (got[0] == a).all()
    assert (_opj_decode(data) == a).all()


def test_encode_rgb_mct_lossless():
    rng = np.random.default_rng(9)
    planes = [rng.integers(0, 256, (48, 64)).astype(np.int32)
              for _ in range(3)]
    data = both_encodes(planes, levels=4)
    got = both_decodes(data)
    assert all((g == p).all() for g, p in zip(got, planes))
    assert (_opj_decode(data) == np.stack(planes, -1)).all()


def test_encode_16bit_lossless():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 65536, (33, 29)).astype(np.int32)
    data = both_encodes([a], depth=16, levels=4)
    got = both_decodes(data)
    assert (got[0] == a).all()
    assert (_opj_decode(data).astype(np.int64) == a).all()


def test_encode_lossy_97():
    img = smooth()
    data = both_encodes([img.astype(np.int32)], reversible=False,
                        quality=70, levels=5)
    ref = _opj_decode(data)
    got = both_decodes(data)
    assert _psnr(img, ref) > 38
    assert _psnr(got[0], ref) > 45


def test_encode_spans():
    a = np.random.default_rng(1).integers(0, 256, (40, 56)).astype(np.int32)
    with trace.collect() as spans:
        data = encode_codestream([a], levels=3)
        decode_codestream(data)
    for s in ("j2k.encode.dwt", "j2k.encode.t1", "j2k.encode.write",
              "j2k.decode.parse", "j2k.decode.t1", "j2k.decode.dwt"):
        assert spans[s]["count"] >= 1, s


# ------------------------------------------------ the C++ library itself

def test_failed_load_raises(monkeypatch):
    """Without its library the coder raises; it never carries on in
    Python."""
    def fail():
        raise RuntimeError("c++ failed (1): the JPEG 2000 block coders")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.J2K_HOST_LIBRARY, "load", fail)
    a = np.random.default_rng(2).integers(0, 256, (16, 16)).astype(np.int32)
    data = jencode([a], levels=2)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        decode_codestream(data)
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        encode_codestream([a], levels=2)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A host library whose source does not compile raises at its first
    use, naming the compiler's failure."""
    src = tmp_path / "broken.cc"
    src.write_text("int tpuheif_broken( { return 0; }\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build._HostLibrary("broken", "unused", b"", "broken coder")
    monkeypatch.setattr(lib, "sources", lambda: [src])
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        lib.load()


def test_library_built_from_the_checkout():
    native.lib()
    path = _build.J2K_HOST_LIBRARY.path
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("j2k_host-") and path.suffix == ".so"
    assert [s.name for s in _build.J2K_HOST_LIBRARY.sources()] == [
        "ht_j2k.cc", "j2k_t1.cc"]


# ----------------------------------------------------------- the context

def rgb_planes(w=51, h=37, seed=0):
    rng = np.random.default_rng(seed)
    return {c: rng.integers(0, 256, (h, w), dtype=np.uint8)
            for c in ("R", "G", "B")}


def jax_image(planes, space, chroma, bits=8):
    h, w = next(iter(planes.values())).shape
    img = JaxImage(w, h, space, chroma)
    for ch, a in planes.items():
        img.set_plane(ch, a, bits)
    return img


def port_image(planes, space, chroma, bits=8):
    return from_numpy_planes(planes, {c: bits for c in planes}, space,
                             chroma, device="cpu")


def item_files(planes, space, chroma, fmt="jpeg2000", bits=8, **opts):
    """(port file, JAX file) of one encode_image call."""
    ctx = HeifContext(device="cpu")
    ctx.encode_image(port_image(planes, space, chroma, bits), fmt,
                     EncodingOptions(**opts))
    jctx = JaxContext()
    jctx.encode_image(jax_image(planes, space, chroma, bits), fmt,
                      JOptions(**opts))
    return ctx.write(), jctx.write()


ITEM_CASES = {
    "rgb-lossless": (lambda: rgb_planes(), "RGB", "444", 8,
                     dict(lossless=True)),
    "rgb-97-q60": (lambda: rgb_planes(64, 40, 1), "RGB", "444", 8,
                   dict(lossless=False, quality=60)),
    "mono-12bit": (lambda: {"Y": np.random.default_rng(2).integers(
        0, 4096, (30, 44)).astype(np.uint16)}, "monochrome", "monochrome",
        12, dict(lossless=True)),
    "ycbcr444": (lambda: {c: np.random.default_rng(3 + k).integers(
        0, 256, (24, 32), dtype=np.uint8)
        for k, c in enumerate(("Y", "Cb", "Cr"))}, "YCbCr", "444", 8,
        dict(lossless=True)),
}


@pytest.mark.parametrize("name", list(ITEM_CASES))
def test_j2k1_item_matches_jax(name):
    make, space, chroma, bits, opts = ITEM_CASES[name]
    planes = make()
    port, jax = item_files(planes, space, chroma, bits=bits, **opts)
    assert port == jax
    got = HeifContext.read_from_bytes(port, device="cpu").decode_image()
    ref = JaxContext.read_from_bytes(jax).decode_image()
    assert_same_image(got, ref, name)
    if opts["lossless"]:
        # the components in order (a YCbCr 4:4:4 codestream reads back
        # as RGB, in the JAX package too)
        chans = ["Y"] if len(planes) == 1 else ["R", "G", "B"]
        for ch, a in zip(chans, planes.values()):
            np.testing.assert_array_equal(
                got.plane(ch).to(torch.int32).numpy(), a.astype(np.int32))


def test_ycbcr420_item_goes_through_rgb_as_jax():
    """YCbCr that is not 4:4:4 is converted to RGB 4:4:4 first, on the
    image's device, as the JAX encoder does; the files are equal."""
    from tests.test_torch_item_write import photo
    planes = photo(48, 32, 5)
    port, jax = item_files(planes, "YCbCr", "420", lossless=True)
    assert port == jax
    got = HeifContext.read_from_bytes(port, device="cpu").decode_image()
    assert got.colorspace == "RGB"


def test_j2kH_property_roundtrip():
    port, _ = item_files(rgb_planes(), "RGB", "444", lossless=True)
    ctx = HeifContext.read_from_bytes(port, device="cpu")
    item = ctx.items[ctx.primary_id]
    assert item.file.get_infe(item.item_id).item_type == "j2k1"
    j2kh = item.get_property(Box_j2kH)
    assert j2kh is not None
    assert j2kh.get_child(Box_cdef).channels == [(0, 0, 1), (1, 0, 2),
                                                 (2, 0, 3)]


def test_item_decode_spans():
    port, _ = item_files(rgb_planes(), "RGB", "444", lossless=True)
    with trace.collect() as spans:
        HeifContext.read_from_bytes(port, device="cpu").decode_image()
    for s in ("j2k.decode", "j2k.decode.parse", "j2k.decode.t1",
              "j2k.decode.dwt", "j2k.decode.copy"):
        assert spans[s]["count"] >= 1, s
    assert spans["j2k.decode.copy"]["count"] == 1


def mixed_depth_codestream():
    """Three components of 8, 12 and 12 bits: a 12-bit RCT-free
    codestream whose first component's SIZ depth is rewritten to 8 bits
    (its samples lie within 128 of the 12-bit midpoint, so they decode
    to 8-bit values)."""
    rng = np.random.default_rng(12)
    planes = [rng.integers(1920, 2176, (20, 28)).astype(np.int32),
              rng.integers(0, 4096, (20, 28)).astype(np.int32),
              rng.integers(0, 4096, (20, 28)).astype(np.int32)]
    data = bytearray(encode_codestream(planes, depth=12, levels=2,
                                       mct=False))
    # SOC, SIZ marker and length, Rsiz, eight 32-bit fields, Csiz
    assert data[2:4] == b"\xff\x51" and data[42] == 11
    data[42] = 7
    return bytes(data), [planes[0] - 2048 + 128, planes[1], planes[2]]


def test_mixed_depth_planes_through_device_planes():
    data, ref = mixed_depth_codestream()
    img = J2KImageDecoder("cpu").decode_single_image(None, data)
    jref = J2KDecoder_Registry().decode_single_image(None, data)
    assert_same_image(img, jref, "mixed depths")
    assert [img.plane(c).dtype for c in ("R", "G", "B")] == \
        [torch.uint8, torch.uint16, torch.uint16]
    assert [img.bit_depth(c) for c in ("R", "G", "B")] == [8, 12, 12]
    for c, r in zip(("R", "G", "B"), ref):
        np.testing.assert_array_equal(img.plane(c).to(torch.int32).numpy(), r)
    # the card's layout of the same planes: one buffer of bytes, each
    # plane at a multiple of 256 bytes, views of its dtype and shape
    arrays = [r.astype(np.uint8 if k == 0 else np.uint16)
              for k, r in enumerate(ref)]
    flat, starts = join_bytes(arrays, pin=False)
    assert all(s % 256 == 0 for s in starts)
    for got, a in zip(split_bytes(flat, arrays, starts), arrays):
        assert got.dtype == (torch.uint8 if a.dtype == np.uint8
                             else torch.uint16)
        np.testing.assert_array_equal(got.numpy(), a)


def test_16bit_planes_through_device_planes():
    rng = np.random.default_rng(13)
    a = rng.integers(0, 65536, (17, 23)).astype(np.int32)
    data = both_encodes([a], depth=16, levels=3)
    img = J2KImageDecoder("cpu").decode_single_image(None, data)
    assert img.plane("Y").dtype == torch.uint16 and img.bit_depth("Y") == 16
    np.testing.assert_array_equal(img.plane("Y").to(torch.int32).numpy(), a)
    flat, starts = join_bytes([a.astype(np.uint16)], pin=False)
    got, = split_bytes(flat, [a.astype(np.uint16)], starts)
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), a)


def test_decoder_resolves_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            J2KImageDecoder()


# ------------------------------------------------------------- the tiles

def tiled_files(fmt="jpeg2000", **opts):
    """(port, JAX) files of a 64x64 tili of four 32x32 tiles."""
    out = []
    for ctx, image, options in (
            (HeifContext(device="cpu"), port_image, EncodingOptions),
            (JaxContext(), jax_image, JOptions)):
        tid = ctx.add_tiled_image(64, 64, 32, 32, fmt=fmt)
        for k, (tx, ty) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
            ctx.add_image_tile_to_tiled(
                tid, tx, ty, image(rgb_planes(32, 32, 70 + k), "RGB", "444"),
                options(**opts))
        out.append(ctx.write())
    return tid, out


@pytest.mark.parametrize("lossless", [True, False], ids=["53", "97"])
def test_jpeg2000_tiles_match_jax(lossless):
    tid, (port, jax) = tiled_files(lossless=lossless, quality=60)
    assert port == jax
    pitem = HeifContext.read_from_bytes(port, device="cpu").items[tid]
    jitem = JaxContext.read_from_bytes(jax).get_item(tid)
    for k, (tx, ty) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        got = pitem.decode_tile(tx, ty)
        assert_same_image(got, jitem.decode_tile(tx, ty), f"tile {tx},{ty}")
        if lossless:
            for ch, a in rgb_planes(32, 32, 70 + k).items():
                np.testing.assert_array_equal(got.plane(ch).numpy(), a)


# ------------------------------------------------------------ the tracks

def test_j2ki_tracks_refused_by_name_beside_jax():
    """The JAX writer labels a ``j2k`` track ``j2ki`` but has no encoder
    for it (its first frame fails); the port refuses it by name, writing
    and reading."""
    jctx = JaxContext()
    tw = jctx.add_visual_track(32, 32, fmt="j2k", timescale=30)
    assert tw.sample_entry_type == "j2ki"
    planes = rgb_planes(32, 32, 9)
    with pytest.raises(AttributeError):
        tw.add_frame(jax_image(planes, "RGB", "444"), duration=1)
    with pytest.raises(HeifError) as e:
        HeifContext(device="cpu").add_visual_track(32, 32, fmt="j2k")
    assert e.value.subcode == SubError.Unsupported_codec
    assert "JPEG 2000" in str(e.value)
    # a j2ki track in a file (raw samples): the port refuses to decode it
    ctx = HeifContext(device="cpu")
    tw = ctx.add_visual_track(32, 32, fmt="hevc", timescale=30)
    tw.sample_entry_type = "j2ki"
    tw.add_raw_sample(ptrack.RawSequenceSample(data=b"\x00" * 8, duration=1))
    t = HeifContext.read_from_bytes(ctx.write(), device="cpu").tracks[0]
    with pytest.raises(HeifError, match="JPEG 2000 \\('j2ki'\\)"):
        t.decode_next_image()
    jt = JaxContext.read_from_bytes(ctx.write()).tracks[0]
    assert jt.coding == "j2ki"


# -------------------------------------- the card's streams and files

J2K_MANIFEST = card_encodes.read_j2k_manifest()


@pytest.mark.parametrize("e", J2K_MANIFEST["streams"],
                         ids=[e["name"] for e in J2K_MANIFEST["streams"]])
def test_committed_stream_matches_manifest(e):
    """Each committed codestream decoded by the port (as a j2k1 decoder
    does) and by the JAX package hashes to the manifest; OpenJPEG's
    decode too where the manifest says it agrees."""
    with open(os.path.join(card_encodes.J2K_DIR, e["file"]), "rb") as f:
        data = f.read()
    assert len(data) == e["bytes"]
    img = J2KImageDecoder("cpu").decode_single_image(None, data)
    chans = ("R", "G", "B") if e["components"] == 3 else ("Y",)
    got = [img.plane(c).numpy() for c in chans]
    assert [img.bit_depth(c) for c in chans] == e["depths"]
    assert card_encodes.plane_hashes(got, e["depths"]) == e["sha256_jax"]
    planes, _ = jdecode(data)
    assert card_encodes.plane_hashes(planes, e["depths"]) == e["sha256_jax"]
    opj = card_encodes.openjpeg_planes(data)
    assert (card_encodes.plane_hashes(opj, e["depths"]) ==
            e["sha256_openjpeg"])
    assert e["openjpeg_exact"] == (e["sha256_openjpeg"] == e["sha256_jax"])


def test_card_writes_in_manifest():
    """The manifest names every file of phase 4l's JPEG 2000 encodes with
    a SHA-256, and the sizes, crop and tile the card encodes (which the
    card holds to the CPU write and these hashes)."""
    man = J2K_MANIFEST
    assert sorted(man["writes"]) == sorted(card_encodes.J2K_FILES)
    assert all(len(e["sha256"]) == 64 for e in man["writes"].values())
    assert (tuple(man["photo"]), tuple(man["crop"]), tuple(man["crop_at"]),
            man["quality"], man["tile"]) == (
        card_encodes.PHOTO, card_encodes.J2K_CROP, card_encodes.J2K_CROP_AT,
        card_encodes.J2K_QUALITY, card_encodes.J2K_TILE)
