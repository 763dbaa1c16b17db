"""HEIF files with hvc1 items through the PyTorch port's context, against
the JAX package, on the CPU.

The files are written by the JAX package (``HeifContext.encode_image(img,
"hevc")``, ``add_grid_image``, transform properties); both packages read
and decode them, the JAX one with its device grid path for grids.  YCbCr
is held exact; YCbCr→RGB keeps the contract of tests/test_pallas_fast.py
(at most 1 LSB, on fewer than 1% of the samples).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes import meta as jmeta  # noqa: E402
from libheif_tpu.boxes.codec_cfg import Box_hvcC as JBox_hvcC  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.fraction import Fraction as JFraction  # noqa: E402
from libheif_tpu.file import HeifFile as JHeifFile  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.items import DecodingOptions as JDecodingOptions  # noqa: E402
from libheif_tpu.option_types import EncodingOptions  # noqa: E402

from libheif_tpu_torch import (  # noqa: E402
    HeifContext, HeifFile, DecodingOptions)
from libheif_tpu_torch.boxes.codec_cfg import Box_hvcC  # noqa: E402
from libheif_tpu_torch.items.codec_items import ImageItem_HEVC  # noqa: E402
from libheif_tpu_torch.parallel import coded_grid  # noqa: E402


def _image(w, h, bits=8, seed=0):
    """A smooth JAX 4:2:0 image (low-frequency content codes to few
    bytes at a mid quality)."""
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    dt = np.uint8 if bits <= 8 else np.uint16

    def plane(pw, ph):
        base = rng.integers(0, 1 << bits, (ph // 8 + 1, pw // 8 + 1))
        return np.kron(base, np.ones((8, 8), np.int64))[:ph, :pw].astype(dt)
    img.set_plane(Channel.Y, plane(w, h), bits)
    for ch in (Channel.Cb, Channel.Cr):
        img.set_plane(ch, plane((w + 1) // 2, (h + 1) // 2), bits)
    return img


def _hevc(ctx, img):
    return ctx.encode_image(img, "hevc", EncodingOptions(quality=60))


def _grid(ctx, size, out_w, out_h, seed):
    ids = [_hevc(ctx, _image(*size, seed=seed + i)) for i in range(4)]
    g = ctx.add_grid_image(ids, out_w, out_h, 2, 2)
    ctx.set_primary_item(g)
    return g, ids


def build_single():
    """One 72x40 hvc1 item: coded at CTB-padded size, cropped to ispe."""
    ctx = JHeifContext()
    _hevc(ctx, _image(72, 40, seed=1))
    return ctx.write()


def build_10bit():
    ctx = JHeifContext()
    _hevc(ctx, _image(64, 48, bits=10, seed=2))
    return ctx.write()


def build_grid_cropped():
    """2x2 grid of 64x64 hvc1 tiles under a 120x100 output."""
    ctx = JHeifContext()
    _grid(ctx, (64, 64), 120, 100, seed=10)
    return ctx.write()


def build_grid_transformed():
    """The cropped grid with irot 90, imir and a clap on the grid."""
    ctx = JHeifContext()
    g, _ = _grid(ctx, (64, 64), 120, 100, seed=20)
    ctx.file.add_property(g, jmeta.Box_irot(90), True)
    ctx.file.add_property(g, jmeta.Box_imir("vertical"), True)
    ctx.file.add_property(g, jmeta.Box_clap(
        JFraction(90, 1), JFraction(111, 1), JFraction(0, 1),
        JFraction(1, 1)), True)
    return ctx.write()


def build_grid_tile_transforms():
    """A grid whose tiles carry irot 180: the batch declines it and the
    tiles decode one by one."""
    ctx = JHeifContext()
    _, ids = _grid(ctx, (64, 64), 128, 128, seed=30)
    for i in ids:
        ctx.file.add_property(i, jmeta.Box_irot(180), True)
    return ctx.write()


FILES = {
    "single": build_single,
    "10bit": build_10bit,
    "grid_cropped": build_grid_cropped,
    "grid_transformed": build_grid_transformed,
    "grid_tile_transforms": build_grid_tile_transforms,
}
GRIDS = {"grid_cropped", "grid_transformed", "grid_tile_transforms"}
TARGETS = {
    "native": (Colorspace.Undefined, Chroma.Undefined),
    "rgb": (Colorspace.RGB, Chroma.C444),
    "rgba": (Colorspace.RGB, Chroma.InterleavedRGBA),
}


@functools.lru_cache(maxsize=None)
def blob(name):
    return FILES[name]()


@functools.lru_cache(maxsize=None)
def jax_image(name, target):
    ctx = JHeifContext.read_from_bytes(blob(name))
    return ctx.decode_image(None, *TARGETS[target], JDecodingOptions(
        prefer_device_grid=name in GRIDS))


def _assert_same_image(ref, got, colour):
    assert (got.width, got.height) == (ref.width, ref.height)
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        have = got.np_plane(ch)
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert have.dtype == want.dtype and have.shape == want.shape, ch
        if colour:
            d = np.abs(have.astype(np.int64) - want.astype(np.int64))
            assert d.max(initial=0) <= 1, f"{ch}: maxdiff {d.max()}"
            assert (d > 0).mean() < 0.01, f"{ch}: {(d > 0).mean():.3%}"
        else:
            np.testing.assert_array_equal(have, want, err_msg=ch)


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("name", list(FILES))
def test_decode_image_matches_jax(name, target):
    got = HeifContext.read_from_bytes(blob(name), device="cpu") \
        .decode_image(None, *TARGETS[target])
    _assert_same_image(jax_image(name, target), got,
                       colour=target != "native")


@pytest.mark.parametrize("name,batched", [("grid_cropped", True),
                                          ("grid_transformed", True),
                                          ("grid_tile_transforms", False)])
def test_grid_path(name, batched, monkeypatch):
    """An all-hvc1 grid reconstructs its tiles as one batch; a grid the
    batch declines decodes its tiles one by one."""
    calls = []
    real = coded_grid.decode_pictures_device

    def spy(syntaxes, raw_tus, device=None):
        calls.append(len(syntaxes))
        return real(syntaxes, raw_tus, device)
    monkeypatch.setattr(coded_grid, "decode_pictures_device", spy)
    ctx = HeifContext.read_from_bytes(blob(name), device="cpu")
    ctx.decode_image(None)
    assert calls == ([4] if batched else [])


def test_hvcC_property_and_write_back():
    """The port reads hvcC as Box_hvcC (the SPS and PPS NALs) and writes
    the file as the JAX package does."""
    data = blob("single")
    f = HeifFile.from_bytes(data)
    pid = f.primary_item_id
    cfg = f.get_property(pid, Box_hvcC)
    jf = JHeifFile.from_bytes(data)
    jcfg = jf.get_property(pid, JBox_hvcC)
    assert cfg.get_header_nals() == jcfg.get_header_nals()
    assert cfg.length_size == jcfg.length_size
    assert f.write() == jf.write()
    ctx = HeifContext.read_from_bytes(data, device="cpu")
    assert isinstance(ctx.get_item(pid), ImageItem_HEVC)

