"""Brotli ``unci`` payloads in the PyTorch port against the JAX package,
on the CPU.

Neither ``brotli`` nor ``brotlicffi`` is installed here, so a stub module
made in this file (zlib behind a three-byte mark; a stream without the
mark, or with a broken zlib body, raises) is monkeypatched into both
packages: the JAX codec's ``brotli`` and ``_HAS_BROTLI``, and the port's
one lookup, ``codecs/unc/codec._brotli``.  With the stub:
* a ``brot`` unci file written by each package has the same bytes, and
  its planes decode bit-exact in both (whole-image and per-tile units);
* the XMP compression of ``api/metadata.py`` asks the same lookup;
* a corrupt stream raises ``Decompression_invalid_data`` in both.
Without the module both refuse to write and to read a ``brot`` file with
the same ``HeifError`` code and subcode.
"""

from __future__ import annotations

import types
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.codecs.unc import codec as jcodec  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.error import HeifError as JHeifError  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.option_types import (  # noqa: E402
    EncodingOptions as JEncodingOptions)

from libheif_tpu_torch import EncodingOptions, HeifContext  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.codecs.unc import codec as pcodec  # noqa: E402
from libheif_tpu_torch.core.error import HeifError, SubError  # noqa: E402
from libheif_tpu_torch.image.pixel_image import PixelImage  # noqa: E402

MARK = b"BRT"


def _stub_brotli() -> types.ModuleType:
    mod = types.ModuleType("brotli")

    def compress(data):
        return MARK + zlib.compress(bytes(data), 9)

    def decompress(data):
        data = bytes(data)
        if not data.startswith(MARK):
            raise ValueError("not a brotli stream")
        return zlib.decompress(data[len(MARK):])

    mod.compress, mod.decompress = compress, decompress
    return mod


def _use(monkeypatch, module):
    monkeypatch.setattr(jcodec, "brotli", module)
    monkeypatch.setattr(jcodec, "_HAS_BROTLI", module is not None)
    monkeypatch.setattr(pcodec, "_brotli", lambda: module)


@pytest.fixture
def stub(monkeypatch):
    _use(monkeypatch, _stub_brotli())


@pytest.fixture
def absent(monkeypatch):
    _use(monkeypatch, None)


IMAGES = {
    "rgb8": (Colorspace.RGB, Chroma.C444, (Channel.R, Channel.G,
                                            Channel.B), 8),
    "ycbcr420": (Colorspace.YCbCr, Chroma.C420, (Channel.Y, Channel.Cb,
                                                  Channel.Cr), 8),
    "mono16": (Colorspace.Monochrome, Chroma.Monochrome, (Channel.Y,), 16),
}


def image_pair(kind, w=48, h=32, seed=3):
    cs, chroma, channels, bits = IMAGES[kind]
    rng = np.random.default_rng(seed)
    j = JPixelImage(w, h, cs, chroma)
    p = PixelImage(w, h, cs, chroma)
    for ch in channels:
        sh = 2 if chroma == Chroma.C420 and ch != Channel.Y else 1
        a = rng.integers(0, 1 << bits, (h // sh, w // sh),
                         dtype=np.uint16 if bits > 8 else np.uint8)
        j.set_plane(ch, a, bits)
        p.set_plane(ch, torch.from_numpy(a.copy()), bits)
    return j, p


def write_both(kind, tiles=(1, 1)):
    j, p = image_pair(kind)
    out = []
    for ctx, img, opts in ((JHeifContext(), j, JEncodingOptions()),
                           (HeifContext(device="cpu"), p,
                            EncodingOptions())):
        opts.compression = "brot"
        opts.tile_cols, opts.tile_rows = tiles
        ctx.new_file()
        ctx.encode_image(img, "unci", opts)
        out.append(ctx.write())
    return out


@pytest.mark.parametrize("kind,tiles", [("rgb8", (1, 1)),
                                        ("ycbcr420", (2, 2)),
                                        ("mono16", (3, 1))])
def test_brot_file_bytes_and_planes_match_jax(stub, kind, tiles):
    ja, pa = write_both(kind, tiles)
    assert pa == ja and MARK in pa
    jimg = JHeifContext.read_from_bytes(ja).decode_image(None)
    pimg = HeifContext.read_from_bytes(pa, device="cpu").decode_image(None)
    assert sorted(pimg.channels()) == sorted(jimg.channels())
    for ch in jimg.channels():
        np.testing.assert_array_equal(pimg.np_plane(ch),
                                      np.asarray(jimg.plane(ch)), err_msg=ch)


def _error(fn, *args):
    with pytest.raises((HeifError, JHeifError)) as e:
        fn(*args)
    return int(e.value.code), int(e.value.subcode), type(e.value).__module__


def test_without_brotli_both_refuse_alike(monkeypatch, absent):
    j, p = image_pair("rgb8")
    refused = []
    for ctx, img, opts in ((JHeifContext(), j, JEncodingOptions()),
                           (HeifContext(device="cpu"), p,
                            EncodingOptions())):
        opts.compression = "brot"
        ctx.new_file()
        refused.append(_error(ctx.encode_image, img, "unci", opts)[:2])
    assert refused[0] == refused[1] == (
        HeifError.unsupported(
            SubError.Unsupported_generic_compression_method).code,
        SubError.Unsupported_generic_compression_method)
    # a file written where the module was present, read where it is absent
    _use(monkeypatch, _stub_brotli())
    blob = write_both("rgb8")[0]
    _use(monkeypatch, None)
    got = [_error(JHeifContext.read_from_bytes(blob).decode_image, None),
           _error(HeifContext.read_from_bytes(blob, device="cpu")
                  .decode_image, None)]
    assert got[0][:2] == got[1][:2] == refused[0]
    assert got[0][2].startswith("libheif_tpu.") and \
        got[1][2].startswith("libheif_tpu_torch.")


def test_corrupt_brot_stream_is_invalid_data(stub):
    for data in (b"garbage", MARK + b"\x00\x01not zlib"):
        got = [_error(jcodec._decompress, "brot", data),
               _error(pcodec._decompress, "brot", data)]
        assert got[0][:2] == got[1][:2] == (
            HeifError.invalid_input().code,
            SubError.Decompression_invalid_data)
    blob = bytearray(write_both("ycbcr420")[0])
    at = blob.find(MARK) + len(MARK)
    blob[at:at + 4] = b"\xff\xff\xff\xff"
    got = [_error(JHeifContext.read_from_bytes(bytes(blob)).decode_image,
                  None),
           _error(HeifContext.read_from_bytes(bytes(blob), device="cpu")
                  .decode_image, None)]
    assert got[0][:2] == got[1][:2] == (HeifError.invalid_input().code,
                                        SubError.Decompression_invalid_data)


def test_xmp_brotli_through_the_same_lookup(stub):
    assert papi.heif_metadata_compression_method_supported("brotli") and \
        japi.heif_metadata_compression_method_supported("brotli")
    blobs = []
    for api, ctx in ((japi, JHeifContext()),
                     (papi, HeifContext(device="cpu"))):
        img = image_pair("rgb8")[0 if api is japi else 1]
        ctx.new_file()
        iid = ctx.encode_image(img, "unci")
        api.heif_context_add_XMP_metadata2(
            ctx, api.heif_image_handle(ctx, iid), b"<x:xmpmeta/>", "brotli")
        blobs.append(ctx.write())
    assert blobs[0] == blobs[1] and MARK in blobs[1]
