"""The port's HT-J2K (ISO/IEC 15444-15) block coder and codec against the
JAX package's, on the CPU.

The cases of tests/test_htj2k.py on the port: the MagSgn, MEL and VLC
streams, the cleanup pass (its C++ engine, host/ht_j2k.cc, against the
Python coder and the JAX coder, byte for byte both ways), the SigProp and
MagRef refinement passes likewise, codestreams whose bytes equal the JAX
encoder's and which OpenJPEG 2.5 (through PIL) decodes to the source,
``htj2k`` items through the context with the JAX writer's bytes, a failed
C++ call raising, and the ``htj2k`` tile refusal beside the JAX writer's
``htj2`` table.
"""

from __future__ import annotations

import io

import numpy as np
import pytest

from libheif_tpu.codecs.j2k import htj2k as jht
from libheif_tpu.codecs.j2k.decoder import decode_codestream as jdecode
from libheif_tpu.codecs.j2k.encoder import encode_codestream as jencode
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.core.error import HeifError as JHeifError
from libheif_tpu.image.pixel_image import PixelImage as JaxImage
from libheif_tpu.option_types import EncodingOptions as JOptions
from libheif_tpu_torch import EncodingOptions, HeifContext
from libheif_tpu_torch.codecs import registry
from libheif_tpu_torch.codecs.j2k.decoder import decode_codestream
from libheif_tpu_torch.codecs.j2k.encoder import encode_codestream
from libheif_tpu_torch.codecs.j2k.htj2k import (
    MagSgnReader, MagSgnWriter, MELDecoder, MELEncoder, VLCReader, VLCWriter,
    decode_cleanup, decode_cleanup_python, decode_refinement,
    decode_refinement_python, encode_cleanup, encode_cleanup_python,
    encode_refinement, encode_refinement_python)
from libheif_tpu_torch.core.error import HeifError, SubError
from libheif_tpu_torch.image.pixel_image import from_numpy_planes
from tests import jax_native
from tests.test_torch_sequences import assert_same_image

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True, scope="module")
def jax_native_library():
    """The JAX coder's C++ engines (tests/jax_native.py)."""
    jax_native.ensure_loaded()


def _opj_decode(data: bytes) -> np.ndarray:
    return np.asarray(PIL.open(io.BytesIO(data)))


def ht_stream(planes, **kw):
    """The port's HT codestream, equal to the JAX encoder's; its port
    decode equal to the JAX decode."""
    kw.setdefault("depth", 8)
    kw.setdefault("reversible", True)
    data = encode_codestream(planes, htj2k=True, **kw)
    assert data == jencode(planes, htj2k=True, **kw)
    mine, _ = decode_codestream(data)
    ref, _ = jdecode(data)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    return data


# ---------------------------------------------------------------- streams

def test_magsgn_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(1, 200))
        widths = rng.integers(0, 13, n)
        vals = [int(rng.integers(0, 1 << w)) if w else 0 for w in widths]
        wtr = MagSgnWriter()
        for v, w in zip(vals, widths):
            wtr.bits(v, int(w))
        rd = MagSgnReader(wtr.flush())
        assert [rd.bits(int(w)) for w in widths] == vals


def test_mel_roundtrip():
    rng = np.random.default_rng(1)
    for _ in range(50):
        n = int(rng.integers(1, 400))
        events = (rng.random(n) < rng.random()).astype(int).tolist()
        enc = MELEncoder()
        for e in events:
            enc.event(e)
        dec = MELDecoder(enc.flush())
        assert [dec.event() for _ in events] == events


def test_vlc_backward_roundtrip():
    rng = np.random.default_rng(2)
    for _ in range(100):
        n = int(rng.integers(1, 300))
        bits = rng.integers(0, 2, n).tolist()
        w = VLCWriter()
        for b in bits:
            w.bits.append(int(b))
        nib, tail = w.pack()
        scup = len(tail) + 2
        seg = bytes(reversed(tail)) + bytes([(nib << 4) | (scup & 0xF),
                                             scup >> 4])
        rd = VLCReader(seg, len(seg), scup)
        got = []
        for b in bits:
            got.append(rd.peek(1))
            rd.skip(1)
        assert got == bits


# ------------------------------------------------------- the block coders

def cleanup_both_ways(a, B):
    """The cleanup segment of ``a`` from the C++ coder, the Python coder
    and the JAX coder (all equal), decoded by the C++ and the Python
    decoders (both ``a``)."""
    h, w = a.shape
    seg, b = encode_cleanup(a)
    assert (seg, b) == encode_cleanup_python(a) == jht.encode_cleanup(a)
    np.testing.assert_array_equal(decode_cleanup(seg, w, h, B), a)
    np.testing.assert_array_equal(decode_cleanup_python(seg, w, h, B), a)
    return seg


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (3, 5), (64, 64),
                                   (17, 33), (1, 64), (64, 1)])
def test_cleanup_native_matches_python_and_jax(shape):
    rng = np.random.default_rng(3)
    h, w = shape
    a = rng.integers(-4000, 4000, (h, w))
    a[rng.random((h, w)) > 0.6] = 0
    if not a.any():
        a[0, 0] = 1
    cleanup_both_ways(a, 14)


def test_cleanup_seeded_sweep():
    rng = np.random.default_rng(4)
    for _ in range(120):
        h = int(rng.integers(1, 65))
        w = int(rng.integers(1, 65))
        mag = int(rng.integers(1, 15))
        a = rng.integers(-(1 << mag), 1 << mag, (h, w))
        a[rng.random((h, w)) > rng.random()] = 0
        if not a.any():
            continue
        cleanup_both_ways(a, mag + 2)


def test_refinement_native_matches_python_and_jax():
    """SigProp + MagRef segments: the C++ coder's bytes equal the Python
    and the JAX coders'; both decoders give the coefficients back (with
    and without the MagRef pass)."""
    rng = np.random.default_rng(5)
    for _ in range(40):
        h, w = [int(v) for v in rng.integers(1, 40, 2)]
        coef = rng.integers(-60, 61, (h, w))
        coef[rng.random((h, w)) > 0.7] = 0
        high = np.sign(coef) * (np.abs(coef) >> 1)
        seg = encode_refinement(coef, high)
        assert seg == encode_refinement_python(coef, high) == \
            jht.encode_refinement(coef, high)
        for magref in (True, False):
            np.testing.assert_array_equal(
                decode_refinement(seg, high, w, h, magref),
                decode_refinement_python(seg, high, w, h, magref))


def test_failed_call_raises():
    """A cleanup segment the C++ decoder refuses raises (code 2); nothing
    runs Python after it."""
    a = np.random.default_rng(6).integers(-900, 900, (16, 16))
    seg = bytearray(encode_cleanup(a)[0])
    # a quad exponent beyond its bound: claim one magnitude bit-plane
    with pytest.raises(HeifError, match="invalid HT cleanup segment"):
        decode_cleanup(bytes(seg), 16, 16, 1)
    with pytest.raises(HeifError):
        encode_cleanup(np.zeros((4, 4), np.int64))


# ------------------------------------------------------------ codestreams

def test_self_roundtrip_gray():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (57, 93)).astype(np.int32)
    data = ht_stream([img], levels=3)
    planes, cs = decode_codestream(data)
    assert cs.cod.cbstyle == 0x40
    assert cs.cap is not None and cs.cap.has_htj2k
    assert (planes[0] == img).all()


def test_self_roundtrip_rgb_mct():
    rng = np.random.default_rng(6)
    planes = [rng.integers(0, 256, (40, 61)).astype(np.int32)
              for _ in range(3)]
    out, _ = decode_codestream(ht_stream(planes, levels=4))
    for a, b in zip(out, planes):
        assert (a == b).all()


def test_self_roundtrip_12bit():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 1 << 12, (33, 47)).astype(np.int32)
    planes, _ = decode_codestream(ht_stream([img], depth=12, levels=2))
    assert (planes[0] == img).all()


@pytest.mark.parametrize("shape,levels", [((8, 8), 0), ((64, 64), 2),
                                          ((57, 93), 3), ((200, 317), 5)])
def test_opj_gray_lossless(shape, levels):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = ht_stream([img.astype(np.int32)], levels=levels)
    assert (_opj_decode(data) == img).all()


def test_opj_rgb_mct_lossless():
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (45, 77, 3), dtype=np.uint8)
    data = ht_stream([img[:, :, c].astype(np.int32) for c in range(3)],
                     levels=3)
    assert (_opj_decode(data) == img).all()


def smooth():
    y, x = np.mgrid[0:96, 0:128]
    return ((np.sin(x / 9.0) + np.cos(y / 7.0)) * 60 + 128).astype(np.uint8)


def test_opj_smooth_image():
    img = smooth()
    assert (_opj_decode(ht_stream([img.astype(np.int32)], levels=4))
            == img).all()


@pytest.mark.parametrize("quality", [90, 60])
def test_opj_lossy_97(quality):
    img = smooth()
    data = ht_stream([img.astype(np.int32)], levels=4, reversible=False,
                     quality=quality)
    ref = _opj_decode(data).astype(np.int64)
    mine, _ = decode_codestream(data)
    assert np.abs(mine[0].astype(np.int64) - ref).max() <= 1
    psnr = 10 * np.log10(
        255 ** 2 / max(((img.astype(float) - ref) ** 2).mean(), 1e-9))
    assert psnr > (55 if quality == 90 else 40)


def test_opj_sparse_extremes():
    img = np.full((32, 32), 128, np.uint8)
    img[0, 0] = 255
    img[31, 31] = 0
    img[13, 17] = 1
    assert (_opj_decode(ht_stream([img.astype(np.int32)], levels=2))
            == img).all()


def test_opj_seeded_sweep():
    rng = np.random.default_rng(20)
    for t in range(12):
        h = int(rng.integers(1, 130))
        w = int(rng.integers(1, 170))
        lv = int(rng.integers(0, 6))
        kind = t % 3
        if kind == 0:
            img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        elif kind == 1:
            yy, xx = np.mgrid[0:h, 0:w]
            img = ((np.sin(xx / (1 + rng.random() * 20))
                    * np.cos(yy / (1 + rng.random() * 20)))
                   * 100 + 128).astype(np.uint8)
        else:
            img = np.full((h, w), int(rng.integers(0, 256)), np.uint8)
            for _ in range(8):
                y0 = int(rng.integers(0, h))
                x0 = int(rng.integers(0, w))
                img[y0:y0 + int(rng.integers(1, 20)),
                    x0:x0 + int(rng.integers(1, 20))] = \
                    int(rng.integers(0, 256))
        data = ht_stream([img.astype(np.int32)], levels=lv)
        assert (_opj_decode(data) == img).all(), (h, w, lv, kind)


def refinement_image():
    rng = np.random.default_rng(7)
    return np.clip(np.kron(rng.integers(0, 256, (16, 16)).astype(float),
                           np.ones((8, 8))) +
                   rng.integers(-12, 13, (128, 128)), 0, 255).astype(np.int32)


def test_refinement_passes_roundtrip():
    img = refinement_image()
    planes, _ = decode_codestream(ht_stream([img], levels=3, ht_passes=3))
    assert (planes[0] == img).all()


def test_refinement_passes_opj_multilevel():
    img = refinement_image()
    assert (_opj_decode(ht_stream([img], levels=3, ht_passes=3))
            == img).all()


def test_refinement_passes_opj_sweep():
    rng = np.random.default_rng(31)
    n = 12
    for _ in range(n):
        h, w = [int(v) for v in rng.integers(2, 33, 2)]
        img = rng.integers(0, 256, (h, w)).astype(np.int32)
        if not (np.abs(img - 128) >> 1).any():
            continue
        data = ht_stream([img], levels=0, ht_passes=3)
        assert (_opj_decode(data) == img).all()


def test_refinement_passes_opj_sigprop_heavy():
    rng = np.random.default_rng(4)
    n = 12
    done = 0
    for _ in range(200):
        if done >= n:
            break
        h, w = [int(v) for v in rng.integers(2, 13, 2)]
        img = (128 + rng.integers(-4, 5, (h, w))).astype(np.int32)
        if not (np.abs(img - 128) >> 1).any():
            continue
        data = ht_stream([img], levels=0, ht_passes=3)
        assert (_opj_decode(data) == img).all()
        done += 1


def test_coarse_plane_convention():
    """Cleanup-only streams at p > 1 decode with OpenJPEG's midpoint
    reconstruction."""
    rng = np.random.default_rng(3)
    for k in (1, 2, 3):
        h, w = [int(v) for v in rng.integers(4, 33, 2)]
        img = rng.integers(0, 256, (h, w)).astype(np.int32)
        data = ht_stream([img], levels=0, ht_drop_planes=k)
        mine, _ = decode_codestream(data)
        np.testing.assert_array_equal(
            np.asarray(_opj_decode(data), np.int64),
            np.clip(mine[0], 0, 255), err_msg=f"drop_planes={k}")


# ------------------------------------------------------------ the context

def rgb_planes(w=61, h=39, seed=10):
    rng = np.random.default_rng(seed)
    return {c: rng.integers(0, 256, (h, w), dtype=np.uint8)
            for c in ("R", "G", "B")}


def jax_image(planes):
    h, w = planes["R"].shape
    img = JaxImage(w, h, "RGB", "444")
    for ch, a in planes.items():
        img.set_plane(ch, a, 8)
    return img


def port_image(planes):
    return from_numpy_planes(planes, {c: 8 for c in planes}, "RGB", "444",
                             device="cpu")


@pytest.mark.parametrize("lossless", [True, False], ids=["53", "97-q60"])
def test_htj2k_item_matches_jax(lossless):
    planes = rgb_planes()
    ctx = HeifContext(device="cpu")
    ctx.encode_image(port_image(planes), "htj2k",
                     EncodingOptions(lossless=lossless, quality=60))
    jctx = JaxContext()
    jctx.encode_image(jax_image(planes), "htj2k",
                      JOptions(lossless=lossless, quality=60))
    port = ctx.write()
    assert port == jctx.write()
    back = HeifContext.read_from_bytes(port, device="cpu")
    item = back.items[back.primary_id]
    assert item.file.get_infe(item.item_id).item_type == "j2k1"
    got = back.decode_image()
    assert_same_image(got, JaxContext.read_from_bytes(port).decode_image())
    if lossless:
        for ch, a in planes.items():
            np.testing.assert_array_equal(got.plane(ch).numpy(), a)


def test_encoder_registered():
    assert registry.have_encoder("htj2k")
    assert registry.get_encoder("htj2k").id == "tpu-htj2k"
    assert registry.get_encoder("jpeg2000").id == "tpu-j2k"


def test_htj2k_tiles_refused_by_name_beside_jax():
    """The JAX writer's ``htj2k`` tiles carry the format 'htj2' (the name
    cut to four letters), which its own reader refuses; the port refuses
    to write them, by name."""
    jctx = JaxContext()
    tid = jctx.add_tiled_image(64, 64, 32, 32, fmt="htj2k")
    for k, (tx, ty) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
        jctx.add_image_tile_to_tiled(tid, tx, ty,
                                     jax_image(rgb_planes(32, 32, 80 + k)))
    item = JaxContext.read_from_bytes(jctx.write()).get_item(tid)
    assert item._get_tilC().params.compression_format == "htj2"
    with pytest.raises(JHeifError, match="unsupported tili tile format"):
        item.decode_tile(0, 0)
    with pytest.raises(HeifError) as e:
        HeifContext(device="cpu").add_tiled_image(64, 64, 32, 32,
                                                  fmt="htj2k")
    assert e.value.subcode == SubError.Unsupported_codec
    assert "'htj2k'" in str(e.value) and "'htj2'" in str(e.value)
