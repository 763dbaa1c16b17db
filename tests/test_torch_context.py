"""The PyTorch port's file/context layer against the JAX package, on the
CPU: HEIF files built in memory by the JAX package's writer (unci, grid,
iden and overlay items; irot/imir/clap; alpha aux items; thumbnails),
then read and decoded by both packages.

Decoded planes, composition, transforms, alpha attach, interleave and
bit-depth conversion are held exact; a YCbCr→RGB conversion keeps the
contract of tests/test_pallas_fast.py:1-9 (at most 1 LSB, on fewer than
1% of the samples).
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes import meta as jmeta  # noqa: E402
from libheif_tpu.boxes import unc as junc  # noqa: E402
from libheif_tpu.color.ops import (  # noqa: E402
    ColorConversionOptions as JColorOptions)
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.core.fraction import Fraction as JFraction  # noqa: E402
from libheif_tpu.file import HeifFile as JHeifFile  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.items import DecodingOptions as JDecodingOptions  # noqa: E402
from libheif_tpu.option_types import EncodingOptions  # noqa: E402

from libheif_tpu_torch import (  # noqa: E402
    HeifContext, HeifFile, DecodingOptions)
from libheif_tpu_torch.boxes import meta, unc  # noqa: E402
from libheif_tpu_torch.color.ops import ColorConversionOptions  # noqa: E402
from libheif_tpu_torch.core.error import (  # noqa: E402
    ErrorCode, HeifError, SubError)
from libheif_tpu_torch.core.fraction import Fraction  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"


# --------------------------------------------------------------- test files

def _image(w, h, kind="420", bits=8, alpha_bits=None, seed=0):
    """A JAX PixelImage with random planes: kind is a chroma (YCbCr),
    'rgb' or 'mono'."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits <= 8 else np.uint16

    def plane(pw, ph, b=bits):
        return rng.integers(0, 1 << b, (ph, pw),
                            dtype=np.uint8 if b <= 8 else np.uint16)

    if kind == "rgb":
        img = JPixelImage(w, h, Colorspace.RGB, Chroma.C444)
        for ch in (Channel.R, Channel.G, Channel.B):
            img.set_plane(ch, plane(w, h), bits)
    elif kind == "mono":
        img = JPixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome)
        img.set_plane(Channel.Y, plane(w, h), bits)
    else:
        img = JPixelImage(w, h, Colorspace.YCbCr, kind)
        sx, sy = SUB[kind]
        img.set_plane(Channel.Y, plane(w, h), bits)
        for ch in (Channel.Cb, Channel.Cr):
            img.set_plane(ch, plane((w + sx - 1) // sx, (h + sy - 1) // sy),
                          bits)
    assert img.plane(Channel.R if kind == "rgb" else Channel.Y).dtype == dt
    if alpha_bits:
        img.set_plane(Channel.Alpha, plane(w, h, alpha_bits), alpha_bits)
    return img


def _encode(ctx, img, tiles=(1, 1)):
    return ctx.encode_image(img, "unci", EncodingOptions(
        tile_cols=tiles[0], tile_rows=tiles[1]))


def _clap(w, h, hoff=(0, 1), voff=(0, 1)):
    return jmeta.Box_clap(JFraction(w, 1), JFraction(h, 1), JFraction(*hoff),
                          JFraction(*voff))


def _grid(ctx, tile_imgs, out_w, out_h, rows, cols):
    ids = [_encode(ctx, t) for t in tile_imgs]
    return ctx.add_grid_image(ids, out_w, out_h, rows, cols), ids


def build_unci_odd():
    ctx = JHeifContext()
    _encode(ctx, _image(37, 23, seed=1))
    return ctx.write()


def build_unci_tiled():
    ctx = JHeifContext()
    _encode(ctx, _image(32, 24, seed=2), tiles=(2, 2))
    return ctx.write()


def build_grid_ragged():
    """3x2 grid of 15x11 4:2:0 tiles (odd: their chroma overlaps by a
    column and a row when pasted) under a 40x20 output: ragged right and
    bottom edges."""
    ctx = JHeifContext()
    g, _ = _grid(ctx, [_image(15, 11, seed=10 + i) for i in range(6)],
                 40, 20, 2, 3)
    ctx.set_primary_item(g)
    return ctx.write()


def build_grid_rgb_transformed():
    """2x2 grid of 16x12 RGB tiles with irot 90, imir and a centred clap."""
    ctx = JHeifContext()
    g, _ = _grid(ctx, [_image(16, 12, "rgb", seed=20 + i) for i in range(4)],
                 32, 24, 2, 2)
    ctx.set_primary_item(g)
    ctx.file.add_property(g, jmeta.Box_irot(90), True)
    ctx.file.add_property(g, jmeta.Box_imir("vertical"), True)
    ctx.file.add_property(g, _clap(20, 27), True)
    return ctx.write()


def build_iden():
    """iden (imir horizontal) → unci 4:2:2 with its own irot 270."""
    ctx = JHeifContext()
    src = _encode(ctx, _image(19, 13, Chroma.C422, seed=30))
    ctx.file.add_property(src, jmeta.Box_irot(270), True)
    infe = ctx.file.add_new_item("iden")
    ctx.file.add_reference("dimg", infe.item_id, [src])
    ctx.file.add_property(infe.item_id, jmeta.Box_ispe(13, 19), False)
    ctx.file.add_property(infe.item_id, jmeta.Box_imir("horizontal"), True)
    ctx.file.get_infe(src).hidden = True
    ctx.set_primary_item(infe.item_id)
    return ctx.write()


def build_overlay(with_alpha=True):
    """32x24 overlay over a coloured background: an RGB layer, a YCbCr
    4:2:0 layer (with alpha, partly transparent) hanging over the left
    edge, and a mono layer hanging over the top right corner."""
    ctx = JHeifContext()
    a = _encode(ctx, _image(20, 16, "rgb", seed=40))
    b = _encode(ctx, _image(12, 10, "420", seed=41,
                            alpha_bits=8 if with_alpha else None))
    c = _encode(ctx, _image(9, 7, "mono", seed=42))
    ov = ctx.add_overlay_image(32, 24, [a, b, c],
                               [(5, 3), (-3, 9), (27, -2)],
                               (0x1234, 0x5678, 0x9abc, 0xffff))
    ctx.set_primary_item(ov)
    return ctx.write()


def build_alpha(prem=False):
    """A 24x18 4:2:0 primary with an 8-bit alpha aux item (and 'prem'
    when premultiplied), a thumbnail, and an Exif item."""
    ctx = JHeifContext()
    img = _image(24, 18, seed=50, alpha_bits=8)
    img.premultiplied_alpha = prem
    main = _encode(ctx, img)
    ctx.add_thumbnail(main, _image(6, 4, seed=51))
    ctx.add_exif(main, b"II*\x00exif")
    return ctx.write()


def build_alpha_scaled(prem=False):
    """A 4:4:4 primary with a smaller 10-bit alpha item: attached through
    scale_nearest (and marked premultiplied by 'prem' when asked)."""
    ctx = JHeifContext()
    main = _encode(ctx, _image(22, 14, Chroma.C444, seed=60))
    alpha = _encode(ctx, _image(11, 7, "mono", bits=10, seed=61))
    ctx.file.add_property(alpha, jmeta.Box_auxC(ALPHA_URN), False)
    ctx.file.add_reference("auxl", alpha, [main])
    if prem:
        ctx.file.add_reference("prem", main, [alpha])
    ctx.file.get_infe(alpha).hidden = True
    return ctx.write()


def build_hdr10():
    ctx = JHeifContext()
    _encode(ctx, _image(20, 14, Chroma.C444, bits=10, seed=70,
                        alpha_bits=10))
    return ctx.write()


def build_mono():
    ctx = JHeifContext()
    _encode(ctx, _image(17, 13, "mono", seed=80))
    return ctx.write()


def build_missing_tile():
    """2x2 grid whose second tile is an item of an unknown type."""
    ctx = JHeifContext()
    ids = [_encode(ctx, _image(8, 8, seed=90 + i)) for i in range(3)]
    bad = ctx.file.add_new_item("zzzz").item_id
    g = ctx.add_grid_image([ids[0], bad, ids[1], ids[2]], 16, 16, 2, 2)
    ctx.set_primary_item(g)
    return ctx.write()


def build_clap_outside():
    ctx = JHeifContext()
    i = _encode(ctx, _image(16, 12, seed=100))
    ctx.file.add_property(i, _clap(10, 8, hoff=(5, 1)), True)
    return ctx.write()


def build_cycle():
    ctx = JHeifContext()
    _encode(ctx, _image(8, 8, seed=110))
    a = ctx.file.add_new_item("iden").item_id
    b = ctx.file.add_new_item("iden").item_id
    ctx.file.add_reference("dimg", a, [b])
    ctx.file.add_reference("dimg", b, [a])
    return ctx.write()


def build_transformed(angle, mirror):
    """An odd 4:2:0 unci with irot, optionally imir, and a clap of odd
    size at an odd offset."""
    ctx = JHeifContext()
    i = _encode(ctx, _image(21, 13, seed=angle + len(mirror)))
    if angle:
        ctx.file.add_property(i, jmeta.Box_irot(angle), True)
    if mirror:
        ctx.file.add_property(i, jmeta.Box_imir(mirror), True)
    w, h = (13, 21) if angle in (90, 270) else (21, 13)
    ctx.file.add_property(i, _clap(w - 6, h - 4, hoff=(-3, 2), voff=(1, 1)),
                          True)
    return ctx.write()


FILES = {
    "unci_odd": build_unci_odd,
    "unci_tiled": build_unci_tiled,
    "grid_ragged": build_grid_ragged,
    "grid_rgb_transformed": build_grid_rgb_transformed,
    "iden": build_iden,
    "overlay_alpha": build_overlay,
    "overlay_opaque": functools.partial(build_overlay, with_alpha=False),
    "alpha": build_alpha,
    "alpha_prem": functools.partial(build_alpha, prem=True),
    "alpha_scaled": build_alpha_scaled,
    "alpha_scaled_prem": functools.partial(build_alpha_scaled, prem=True),
    "hdr10": build_hdr10,
    "mono": build_mono,
}


@functools.lru_cache(maxsize=None)
def blob(name):
    return FILES[name]()


def _contexts(data):
    return JHeifContext.read_from_bytes(data), \
        HeifContext.read_from_bytes(data, device="cpu")


# The JAX package cannot read a file with premultiplied alpha, its own
# writer's included: its iref cycle check merges the 'auxl' reference
# (alpha → master) with the 'prem' one (master → alpha) into a cycle.
# Its reference for such a file is the same file without 'prem', with
# the master's flag set as 'prem' sets it.
JAX_STAND_IN = {"alpha_prem": "alpha", "alpha_scaled_prem": "alpha_scaled"}


def _named_contexts(name):
    pctx = HeifContext.read_from_bytes(blob(name), device="cpu")
    stand_in = JAX_STAND_IN.get(name)
    if stand_in is None:
        return JHeifContext.read_from_bytes(blob(name)), pctx
    jctx = JHeifContext.read_from_bytes(blob(stand_in))
    jctx.get_item(jctx.primary_item_id).premultiplied_alpha = True
    return jctx, pctx


def test_jax_package_rejects_premultiplied_alpha_files():
    """The fault that JAX_STAND_IN works around; the port reads the file
    and still rejects a cycle within one reference type."""
    with pytest.raises(Exception) as je:
        JHeifContext.read_from_bytes(blob("alpha_prem"))
    assert je.value.subcode == SubError.Item_reference_cycle
    pctx = HeifContext.read_from_bytes(blob("alpha_prem"), device="cpu")
    assert pctx.get_item(pctx.primary_item_id).premultiplied_alpha


# --------------------------------------------------------------- comparison

def _assert_same_image(ref, got, colour=False):
    """Every channel of the JAX image equal in the port's (exact), or
    within the 1-LSB contract where ``colour`` (YCbCr→RGB on the path)."""
    assert (got.width, got.height) == (ref.width, ref.height)
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
    assert got.premultiplied_alpha == ref.premultiplied_alpha
    assert len(got.warnings) == len(ref.warnings)
    for ch in ref.channels():
        want = np.asarray(ref.plane(ch))
        have = got.np_plane(ch)
        assert got.bit_depth(ch) == ref.bit_depth(ch), ch
        assert have.dtype == want.dtype and have.shape == want.shape, ch
        if colour and ch != Channel.Alpha:
            d = np.abs(have.astype(np.int64) - want.astype(np.int64))
            assert d.max(initial=0) <= 1, f"{ch}: maxdiff {d.max()}"
            assert (d > 0).mean() < 0.01, f"{ch}: {(d > 0).mean():.3%}"
        else:
            np.testing.assert_array_equal(have, want, err_msg=ch)


def _decode_both(name, item=None, colorspace=Colorspace.Undefined,
                 chroma=Chroma.Undefined, **opts):
    jctx, pctx = _named_contexts(name)
    ref = jctx.decode_image(item, colorspace, chroma, JDecodingOptions(**opts))
    got = pctx.decode_image(item, colorspace, chroma, DecodingOptions(**opts))
    return ref, got


TARGETS = {
    "native": (Colorspace.Undefined, Chroma.Undefined),
    "rgb": (Colorspace.RGB, Chroma.C444),
    "rgba": (Colorspace.RGB, Chroma.InterleavedRGBA),
    "rgb24": (Colorspace.RGB, Chroma.InterleavedRGB),
}
YCBCR = {"unci_odd", "unci_tiled", "grid_ragged", "iden", "alpha",
         "alpha_prem", "alpha_scaled", "alpha_scaled_prem", "hdr10"}


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("name", list(FILES))
def test_decode_image_matches_jax(name, target):
    colorspace, chroma = TARGETS[target]
    ref, got = _decode_both(name, None, colorspace, chroma)
    _assert_same_image(ref, got,
                       colour=name in YCBCR and target != "native")


@pytest.mark.parametrize("name", ["alpha", "alpha_scaled", "hdr10",
                                  "overlay_alpha"])
@pytest.mark.parametrize("opt", ["ignore_aux_alpha",
                                 "ignore_transformations",
                                 "convert_hdr_to_8bit"])
def test_decoding_options_match_jax(name, opt):
    ref, got = _decode_both(name, None, Colorspace.RGB,
                            Chroma.InterleavedRGBA, **{opt: True})
    _assert_same_image(ref, got, colour=name != "overlay_alpha")


@pytest.mark.parametrize("angle", [0, 90, 180, 270])
@pytest.mark.parametrize("mirror", ["", "vertical", "horizontal"])
def test_transforms_match_jax(angle, mirror):
    """irot × imir × an odd clap on an odd 4:2:0 image: the planes
    (ignore_transformations off and on) exact, and the RGB output within
    the contract, from the cropped planes the kernel path would take."""
    data = build_transformed(angle, mirror)
    jctx, pctx = _contexts(data)
    for opts in ({}, {"ignore_transformations": True}):
        _assert_same_image(jctx.decode_image(None,
                                             options=JDecodingOptions(**opts)),
                           pctx.decode_image(None,
                                             options=DecodingOptions(**opts)))
    got = pctx.decode_image()
    assert all(got.plane(c).is_contiguous() for c in got.channels())
    _assert_same_image(jctx.decode_image(None, Colorspace.RGB, Chroma.C444),
                       pctx.decode_image(None, Colorspace.RGB, Chroma.C444),
                       colour=True)
    # and the planes equal numpy's rot90/flip/slice of the source planes
    raw = pctx.decode_image(None, options=DecodingOptions(
        ignore_transformations=True))
    y = np.rot90(raw.np_plane(Channel.Y), angle // 90)
    if mirror:
        y = np.flip(y, 1 if mirror == "vertical" else 0)
    clap = pctx.get_item(pctx.primary_item_id).get_property(meta.Box_clap)
    left, top = clap.left(y.shape[1]), clap.top(y.shape[0])
    np.testing.assert_array_equal(
        got.np_plane(Channel.Y),
        y[top:top + clap.height_rounded(), left:left + clap.width_rounded()])


# ---------------------------------------------------------------- the graph

@pytest.mark.parametrize("name", list(FILES))
def test_item_graph_matches_jax(name):
    jctx, pctx = _named_contexts(name)
    assert list(pctx.items) == list(jctx.items)
    assert pctx.primary_item_id == jctx.primary_item_id
    assert pctx.top_level_image_ids() == jctx.top_level_image_ids()
    for item_id, jitem in jctx.items.items():
        pitem = pctx.get_item(item_id)
        assert pitem.item_type == jitem.item_type
        for flag in ("is_primary", "is_hidden", "is_thumbnail", "is_aux",
                     "premultiplied_alpha"):
            assert getattr(pitem, flag) == getattr(jitem, flag), flag
        for link in ("alpha_item", "depth_item"):
            j, p = getattr(jitem, link), getattr(pitem, link)
            assert (p and p.item_id) == (j and j.item_id), link
        assert [t.item_id for t in pitem.aux_items] == \
            [t.item_id for t in jitem.aux_items]
        assert pitem.metadata == jitem.metadata
        if jitem.is_image_item and jitem.init_error is None:
            assert pctx.get_image_info(item_id) == \
                jctx.get_image_info(item_id)
            assert vars(pctx.get_image_tiling(item_id)) == \
                vars(jctx.get_image_tiling(item_id))


def test_alpha_and_thumbnail_links():
    pctx = HeifContext.read_from_bytes(blob("alpha_prem"), device="cpu")
    main = pctx.get_item(pctx.primary_item_id)
    assert main.alpha_item is not None and main.premultiplied_alpha
    assert [t.item_type for t in main.thumbnails] == ["unci"]
    assert pctx.top_level_image_ids() == [pctx.primary_item_id]
    info = pctx.get_image_info(pctx.primary_item_id)
    assert info["has_alpha"] and len(info["thumbnails"]) == 1
    # the primary carries its own alpha component, so the aux item (and
    # its 'prem' flag) is not attached, as in the JAX package
    img = pctx.decode_image()
    assert img.has_channel(Channel.Alpha) and not img.premultiplied_alpha
    pctx = HeifContext.read_from_bytes(blob("alpha_scaled_prem"),
                                       device="cpu")
    img = pctx.decode_image()
    assert img.has_channel(Channel.Alpha) and img.premultiplied_alpha


# -------------------------------------------------------------------- tiles

@pytest.mark.parametrize("name,tile", [
    ("unci_tiled", (1, 1)), ("unci_tiled", (0, 1)), ("grid_ragged", (2, 1)),
    ("grid_ragged", (0, 0)), ("unci_odd", (0, 0))])
@pytest.mark.parametrize("target", ["native", "rgb"])
def test_decode_tile_matches_jax(name, tile, target):
    jctx, pctx = _contexts(blob(name))
    item = jctx.primary_item_id
    colorspace, chroma = TARGETS[target]
    ref = jctx.decode_tile(item, *tile, colorspace, chroma)
    got = pctx.decode_tile(item, *tile, colorspace, chroma)
    _assert_same_image(ref, got, colour=target != "native")


def test_decode_tile_out_of_range():
    for name, tile in (("unci_tiled", (2, 0)), ("grid_ragged", (3, 0)),
                       ("unci_odd", (1, 0))):
        jctx, pctx = _contexts(blob(name))
        with pytest.raises(Exception) as je:
            jctx.decode_tile(jctx.primary_item_id, *tile)
        with pytest.raises(HeifError) as pe:
            pctx.decode_tile(pctx.primary_item_id, *tile)
        assert pe.value.subcode == je.value.subcode == \
            SubError.Invalid_parameter_value


# ------------------------------------------------------------------- errors

def _raise_both(fn_j, fn_p):
    with pytest.raises(Exception) as je:
        fn_j()
    with pytest.raises(HeifError) as pe:
        fn_p()
    assert (int(pe.value.code), int(pe.value.subcode)) == \
        (int(je.value.code), int(je.value.subcode))
    return pe.value


@pytest.mark.parametrize("strict", [True, False])
def test_missing_grid_tile(strict):
    data = build_missing_tile()
    jctx, pctx = _contexts(data)
    if strict:
        e = _raise_both(
            lambda: jctx.decode_image(None, options=JDecodingOptions(
                strict_decoding=True)),
            lambda: pctx.decode_image(None, options=DecodingOptions(
                strict_decoding=True)))
        assert e.subcode == SubError.Unsupported_image_type
    else:
        ref = jctx.decode_image()
        got = pctx.decode_image()
        assert len(got.warnings) == 1
        _assert_same_image(ref, got)
        assert not got.np_plane(Channel.Y)[:8, 8:].any()   # skipped tile


@pytest.mark.parametrize("threads", [1, 3])
def test_grid_progress_cancel_and_threads(threads):
    """The grid path's on_progress, cancel and max_decoding_threads, as
    in the JAX package."""
    jctx, pctx = _named_contexts("grid_ragged")
    calls = {}
    for name, ctx, opts in (("jax", jctx, JDecodingOptions),
                            ("port", pctx, DecodingOptions)):
        seen = calls[name] = []
        img = ctx.decode_image(None, options=opts(
            max_decoding_threads=threads,
            on_progress=lambda done, total: seen.append((done, total))))
        calls[name + " image"] = img
    assert calls["port"] == calls["jax"] == [(i, 6) for i in range(1, 7)]
    _assert_same_image(calls["jax image"], calls["port image"])
    e = _raise_both(
        lambda: jctx.decode_image(None, options=JDecodingOptions(
            max_decoding_threads=threads, cancel=lambda: True)),
        lambda: pctx.decode_image(None, options=DecodingOptions(
            max_decoding_threads=threads, cancel=lambda: True)))
    assert e.code == ErrorCode.Canceled


def test_clap_outside_image():
    jctx, pctx = _contexts(build_clap_outside())
    e = _raise_both(jctx.decode_image, pctx.decode_image)
    assert e.subcode == SubError.Invalid_clean_aperture


def test_reference_cycle():
    data = build_cycle()
    e = _raise_both(lambda: JHeifContext.read_from_bytes(data),
                    lambda: HeifContext.read_from_bytes(data, device="cpu"))
    assert e.subcode == SubError.Item_reference_cycle


def test_decode_cycle_in_the_graph():
    """A cycle the parse does not see (iden → itself through the decode
    path) is caught by the decode's processed-ids set."""
    ctx = JHeifContext()
    src = _encode(ctx, _image(8, 8, seed=120))
    a = ctx.file.add_new_item("iden").item_id
    ctx.file.add_reference("dimg", a, [src])
    ctx.set_primary_item(a)
    jctx, pctx = _contexts(ctx.write())
    pitem = pctx.get_item(a)
    e = _raise_both(lambda: jctx.get_item(a).decode_image(None, {a}),
                    lambda: pitem.decode_image(None, {a}))
    assert e.subcode == SubError.Item_reference_cycle


def test_nonexistent_item():
    jctx, pctx = _contexts(blob("unci_odd"))
    e = _raise_both(lambda: jctx.decode_image(999),
                    lambda: pctx.decode_image(999))
    assert e.subcode == SubError.Nonexisting_item_referenced


@pytest.mark.parametrize("cut", [10, 100, "mid"])
def test_truncated_file(cut):
    data = blob("unci_odd")
    n = len(data) // 2 if cut == "mid" else cut
    _raise_both(lambda: JHeifContext.read_from_bytes(data[:n]),
                lambda: HeifContext.read_from_bytes(data[:n], device="cpu"))


def test_read_from_file(tmp_path):
    path = tmp_path / "grid.heif"
    path.write_bytes(blob("grid_rgb_transformed"))
    ref = JHeifContext.read_from_file(str(path)).decode_image(
        None, Colorspace.RGB, Chroma.InterleavedRGBA)
    got = HeifContext.read_from_file(str(path), device="cpu").decode_image(
        None, Colorspace.RGB, Chroma.InterleavedRGBA)
    _assert_same_image(ref, got)
    e = _raise_both(
        lambda: JHeifContext.read_from_file(str(tmp_path / "none.heif")),
        lambda: HeifContext.read_from_file(str(tmp_path / "none.heif"),
                                           device="cpu"))
    assert int(e.code) == 1      # Input_does_not_exist


def test_context_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: HeifContext(),
               lambda: HeifContext.read_from_bytes(blob("unci_odd"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_item_data_is_read_in_place():
    """A single-extent item's data is a view of the file buffer, with the
    same bytes as the JAX package's copy."""
    data = blob("unci_odd")
    jctx, pctx = _contexts(data)
    item = pctx.primary_item_id
    got = pctx.file.get_item_data(item)
    assert isinstance(got, memoryview)
    assert bytes(got) == jctx.file.get_item_data(item)


# ------------------------------------------------------------------- writer

def _write_both():
    """The same calls on both packages' HeifFile write side."""
    out = []
    for boxes, units, file_cls in ((jmeta, junc, JHeifFile),
                                   (meta, unc, HeifFile)):
        frac = JFraction if boxes is jmeta else Fraction
        f = file_cls()
        f.init_for_writing("mif1", ["mif1", "miaf"])
        a = f.add_new_item("unci", "tile").item_id
        b = f.add_new_item("unci").item_id
        g = f.add_new_item("grid").item_id
        f.append_item_data(a, bytes(range(48)))
        f.append_item_data(b, bytes(range(100, 148)))
        f.append_item_data(g, b"\x00\x00\x00\x01\x00\x08\x00\x04", 1)
        uncC = units.Box_uncC()
        uncC.components = [units.UncCComponent(0, 8, 0, 0)]
        for i in (a, b):
            f.add_property(i, boxes.Box_ispe(4, 4), False)
            f.add_property(i, units.Box_cmpd([units.CmpdComponent(0)]), False)
            f.add_property(i, uncC, True)
            f.get_infe(i).hidden = True
        f.add_property(g, boxes.Box_ispe(8, 4), False)
        f.add_property(g, boxes.Box_irot(270), True)
        f.add_property(g, boxes.Box_imir("horizontal"), True)
        f.add_property(g, boxes.Box_clap(frac(7, 1), frac(3, 1),
                                         frac(-1, 2), frac(1, 3)), True)
        f.add_property(b, boxes.Box_auxC(ALPHA_URN), False)
        f.add_reference("dimg", g, [a, b])
        f.add_reference("auxl", b, [a])
        f.set_primary_item(g)
        out.append(f.write())
    return out


def test_writer_matches_jax_bytes():
    jdata, pdata = _write_both()
    assert pdata == jdata
    # and the port reads its own file back as the JAX package does
    jctx, pctx = _contexts(pdata)
    assert pctx.get_image_info(3) == jctx.get_image_info(3)
    assert bytes(pctx.file.get_item_data(2)) == jctx.file.get_item_data(2)


def test_reread_and_rewrite_is_identical():
    data = blob("alpha")
    f = HeifFile.from_bytes(data)
    assert f.write() == JHeifFile.from_bytes(data).write()


# -------------------------------------------------------------------- no JAX

NEW_MODULES = [
    "libheif_tpu_torch", "libheif_tpu_torch.context",
    "libheif_tpu_torch.core.fraction", "libheif_tpu_torch.core.limits",
    "libheif_tpu_torch.boxes.meta", "libheif_tpu_torch.file",
    "libheif_tpu_torch.file.heif_file", "libheif_tpu_torch.items",
    "libheif_tpu_torch.items.item", "libheif_tpu_torch.items.unci_item",
    "libheif_tpu_torch.items.derived", "libheif_tpu_torch.image.pixel_image",
    "libheif_tpu_torch.color.ops", "libheif_tpu_torch.color.pipeline",
    "libheif_tpu_torch.boxes.codec_cfg", "libheif_tpu_torch.items.codec_items",
    "libheif_tpu_torch.parallel.coded_grid",
    "libheif_tpu_torch.codecs.hevc.decoder",
    "libheif_tpu_torch.codecs.hevc.device_recon",
    "libheif_tpu_torch.codecs.hevc.cuda_fast",
    "libheif_tpu_torch.codecs.hevc.native_parse",
]


@pytest.fixture(scope="module")
def isolated_imports():
    """Import every new module, then build and decode a grid file with
    the port alone, in an interpreter where jax and libheif_tpu cannot
    be imported.  Returns the modules that imported."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["libheif_tpu"] = None
        ok = []
        for name in {NEW_MODULES!r}:
            importlib.import_module(name)
            ok.append(name)
        from libheif_tpu_torch import HeifContext, HeifFile
        from libheif_tpu_torch.boxes import meta, unc
        from libheif_tpu_torch.items.derived import ImageGrid
        f = HeifFile()
        f.init_for_writing()
        ids = []
        for t in range(4):
            i = f.add_new_item("unci").item_id
            f.append_item_data(i, bytes([t * 40 + k for k in range(16)]))
            uncC = unc.Box_uncC()
            uncC.components = [unc.UncCComponent(0, 8, 0, 0)]
            f.add_property(i, meta.Box_ispe(4, 4), False)
            f.add_property(i, unc.Box_cmpd([unc.CmpdComponent(0)]), False)
            f.add_property(i, uncC, True)
            ids.append(i)
        g = f.add_new_item("grid").item_id
        f.append_item_data(g, ImageGrid(2, 2, 8, 8).write(), 1)
        f.add_property(g, meta.Box_ispe(8, 8), False)
        f.add_property(g, meta.Box_irot(90), True)
        f.add_reference("dimg", g, ids)
        f.set_primary_item(g)
        img = HeifContext.read_from_bytes(f.write(), device="cpu") \\
            .decode_image(None, "RGB", "interleaved RGBA")
        assert img.plane("interleaved").shape == (8, 32)
        bad = [m for m in sys.modules if m.startswith("libheif_tpu.")]
        assert not bad and sys.modules["jax"] is None, bad
        print(" ".join(ok))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


@pytest.mark.parametrize("module", NEW_MODULES)
def test_imports_without_jax(isolated_imports, module):
    assert module in isolated_imports
