"""The port's item writers against the JAX package's, on the CPU.

Each case drives the same calls on a JAX ``HeifContext`` and on the
port's (``device="cpu"``) with the same images, made with numpy from a
seed: grid and overlay items over encoded tiles, a tili item filled with
``add_image_tile_to_tiled`` (unci and hevc tiles), thumbnails, Exif and
XMP items, region items of every geometry kind (with a mask item),
text items, ``mini`` files and content that falls through to the normal
format, and ``HeifFile.replace_item_data``.  The port's ``write()`` must
give the JAX writer's bytes, and both packages must reopen the file to
the same items and decoded images; ``debug_dump_boxes`` must print the
same text.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.core.error import HeifError as JHeifError
from libheif_tpu.image.pixel_image import PixelImage as JaxImage
from libheif_tpu.items.region_item import RegionGeometry as JGeometry
from libheif_tpu.option_types import EncodingOptions as JOptions
from libheif_tpu_torch import EncodingOptions, HeifContext
from libheif_tpu_torch.core.error import HeifError
from libheif_tpu_torch.image.pixel_image import from_numpy_planes
from libheif_tpu_torch.items.region_item import RegionGeometry
from tests.test_torch_sequences import assert_same_image


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    # the JAX native HEVC engine's pipeline is not safe under load
    # (ROADMAP §3); one torch thread a process under xdist
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Jax:
    """The JAX package's side of a case."""
    Options = JOptions
    Geometry = JGeometry
    Error = JHeifError

    @staticmethod
    def context():
        return JaxContext()

    @staticmethod
    def reopen(blob):
        return JaxContext.read_from_bytes(blob)

    @staticmethod
    def image(planes, colorspace="YCbCr", chroma="420", bits=8):
        h, w = planes["Y" if "Y" in planes else "R"].shape
        img = JaxImage(w, h, colorspace, chroma)
        for ch, a in planes.items():
            img.set_plane(ch, a, bits)
        return img


class Port:
    """The port's side of a case, on the CPU."""
    Options = EncodingOptions
    Geometry = RegionGeometry
    Error = HeifError

    @staticmethod
    def context():
        return HeifContext(device="cpu")

    @staticmethod
    def reopen(blob):
        return HeifContext.read_from_bytes(blob, device="cpu")

    @staticmethod
    def image(planes, colorspace="YCbCr", chroma="420", bits=8):
        return from_numpy_planes(planes, {c: bits for c in planes},
                                 colorspace, chroma, device="cpu")


def photo(w, h, seed, chroma="420", alpha=False):
    """YCbCr planes of a smooth field plus noise (4:2:0 or 4:4:4)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = 128 + 90 * np.sin(xx / 9.0 + yy / 13.0 + seed)
    out = {"Y": np.clip(field + rng.normal(0, 8, (h, w)), 0,
                        255).astype(np.uint8)}
    cw, ch = (w // 2, h // 2) if chroma == "420" else (w, h)
    for k, c in enumerate(("Cb", "Cr")):
        out[c] = np.clip(128 + 40 * np.cos(np.mgrid[0:ch, 0:cw][1] / 7.0
                                           + k) +
                         rng.normal(0, 4, (ch, cw)), 0, 255).astype(np.uint8)
    if alpha:
        out["Alpha"] = np.clip(yy * 255 // max(1, h - 1) + xx % 3, 0,
                               255).astype(np.uint8)
    return out


# ----------------------------------------------------------------- cases
# each takes a side (Jax or Port) and returns its context, ready to write

def case_grid(pk, fmt="hevc"):
    ctx = pk.context()
    tiles = [ctx.encode_image(pk.image(photo(64, 64, k)), fmt,
                              pk.Options(quality=60)) for k in range(4)]
    gid = ctx.add_grid_image(tiles, 120, 100, 2, 2)
    ctx.set_primary_item(gid)
    return ctx


def case_overlay(pk):
    ctx = pk.context()
    a = ctx.encode_image(pk.image(photo(32, 32, 1, "444"), chroma="444"),
                         "unci")
    b = ctx.encode_image(pk.image(photo(16, 24, 2, "444"), chroma="444"),
                         "unci")
    oid = ctx.add_overlay_image(48, 40, [a, b], offsets=[(0, 0), (20, 10)],
                                background_rgba=(65535, 0, 32768, 65535))
    ctx.set_primary_item(oid)
    return ctx


def case_tiled(pk, fmt="unci"):
    ctx = pk.context()
    tid = ctx.add_tiled_image(96, 64, 32, 32, fmt=fmt)
    for k, (tx, ty) in enumerate([(0, 0), (2, 1), (1, 0), (0, 1), (2, 0)]):
        img = pk.image(photo(32, 32, 10 + k, "444" if fmt == "unci"
                             else "420"),
                       chroma="444" if fmt == "unci" else "420")
        ctx.add_image_tile_to_tiled(tid, tx, ty, img)
    return ctx


def case_thumbnail_exif_xmp(pk):
    ctx = pk.context()
    iid = ctx.encode_image(pk.image(photo(64, 48, 3)), "jpeg",
                           pk.Options(quality=80))
    ctx.add_thumbnail(iid, pk.image(photo(16, 12, 4)), "jpeg")
    ctx.add_exif(iid, b"MM\x00*\x00\x00\x00\x08" + bytes(range(20)))
    ctx.add_xmp(iid, b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    return ctx


def geometries(pk, mask_len):
    g = pk.Geometry
    return [g(kind="point", x=3, y=-4),
            g(kind="rect", x=1, y=2, width=30, height=20),
            g(kind="ellipse", x=40, y=30, radius_x=7, radius_y=5),
            g(kind="polygon", points=[(0, 0), (10, 0), (5, -9)]),
            g(kind="polyline", points=[(1, 1), (60, 2), (61, 40), (2, 39)]),
            g(kind="referenced_mask", x=4, y=5, width=16, height=8),
            g(kind="inline_mask", x=0, y=0, width=8, height=4,
              mask_data=bytes(range(mask_len)))]


def case_regions_text(pk, wide=False):
    ctx = pk.context()
    iid = ctx.encode_image(pk.image(photo(64, 48, 5, "444"), chroma="444"),
                           "unci")
    mask = ctx.encode_image(pk.image({"Y": np.tile(np.array(
        [[0, 255]], np.uint8), (8, 8))}, "monochrome", "monochrome"),
        "mski")
    ri = ctx.add_region_item(iid, 70000 if wide else 640, 480)
    ri.regions = geometries(pk, 4)
    ctx.file.add_reference("mask", ri.item_id, [mask])
    ri2 = ctx.add_region_item(iid, 64, 48)
    ri2.regions = [pk.Geometry(kind="rect", x=-40000 if wide else -4, y=0,
                               width=8, height=8)]
    ctx.add_text_item(iid, "caption: ünïcode ✓")
    ctx.add_text_item(iid, "<b>x</b>", content_type="text/html")
    return ctx


def case_mini(pk, alpha=True, exif=True, fmt="hevc"):
    ctx = pk.context()
    ctx.set_write_mini_format(True)
    iid = ctx.encode_image(pk.image(photo(64, 48, 6, alpha=alpha)), fmt,
                           pk.Options(quality=70))
    if exif:
        ctx.add_exif(iid, b"II*\x00\x08\x00\x00\x00")
        ctx.add_xmp(iid, b"<xmp/>")
    return ctx


def case_mini_fallthrough(pk):
    """A grid primary does not fit a mini box: the normal format."""
    ctx = case_grid(pk)
    ctx.set_write_mini_format(True)
    return ctx


def case_mini_unci(pk):
    """An unci primary does not fit a mini box: the normal format."""
    ctx = pk.context()
    iid = ctx.encode_image(pk.image(photo(16, 16, 7, "444"), chroma="444"),
                           "unci")
    ctx.add_exif(iid, b"II*\x00")
    ctx.set_write_mini_format(True)
    return ctx


def case_replace(pk):
    """replace_item_data over an item's data (the tili table's tool)."""
    ctx = pk.context()
    iid = ctx.encode_image(pk.image(photo(8, 8, 8, "444"), chroma="444"),
                           "unci")
    ctx.file.replace_item_data(iid, 10, b"\xAA\xBB\xCC")
    return ctx


def case_brands(pk):
    """A user's extra compatible brands and forced major brand."""
    ctx = case_thumbnail_exif_xmp(pk)
    ctx.extra_compatible_brands = ["tst1", "mif1"]
    ctx.forced_major_brand = "tst2"
    return ctx


CASES = {
    "grid-hevc": case_grid,
    "grid-jpeg": lambda pk: case_grid(pk, "jpeg"),
    "overlay": case_overlay,
    "tiled-unci": case_tiled,
    "tiled-hevc": lambda pk: case_tiled(pk, "hevc"),
    "thumbnail-exif-xmp": case_thumbnail_exif_xmp,
    "regions-text": case_regions_text,
    "regions-wide": lambda pk: case_regions_text(pk, wide=True),
    "mini-alpha-exif": case_mini,
    "mini-plain": lambda pk: case_mini(pk, alpha=False, exif=False),
    "mini-av1": lambda pk: case_mini(pk, alpha=False, exif=True, fmt="av1"),
    "mini-fallthrough-grid": case_mini_fallthrough,
    "mini-fallthrough-unci": case_mini_unci,
    "replace-item-data": case_replace,
    "extra-brands": case_brands,
}


def assert_same_items(blob):
    """Both packages reopen ``blob`` to the same items, references,
    metadata, regions, texts and decoded top-level images and tiles."""
    j, p = Jax.reopen(blob), Port.reopen(blob)
    ids = sorted(p.items)
    assert ids == sorted(j.items)
    assert [p.items[i].item_type for i in ids] == \
        [j.items[i].item_type for i in ids]
    assert p.primary_item_id == j.primary_item_id
    assert p.top_level_image_ids() == j.top_level_image_ids()
    for iid in p.top_level_image_ids():
        pi, ji = p.get_image_info(iid), j.get_image_info(iid)
        assert pi == ji
        assert p.get_exif(iid) == j.get_exif(iid)
        assert p.get_xmp(iid) == j.get_xmp(iid)
        regions = p.get_region_items(iid)
        assert len(regions) == len(j.get_region_items(iid))
        for pr, jr in zip(regions, j.get_region_items(iid)):
            assert (pr.reference_width, pr.reference_height) == \
                (jr.reference_width, jr.reference_height)
            assert [vars(g) for g in pr.regions] == \
                [vars(g) for g in jr.regions]
        assert [(t.item_id, t.text) for t in p.get_text_items(iid)] == \
            [(t.item_id, t.text) for t in j.get_text_items(iid)]
        if p.items[iid].item_type == "tili":
            tiling = p.get_image_tiling(iid)
            for ty in range(tiling.num_rows):
                for tx in range(tiling.num_columns):
                    try:
                        want = j.decode_tile(iid, tx, ty)
                    except JHeifError:
                        with pytest.raises(HeifError):
                            p.decode_tile(iid, tx, ty)
                        continue
                    assert_same_image(p.decode_tile(iid, tx, ty), want,
                                      f"tile {tx},{ty}")
            continue
        assert_same_image(p.decode_image(iid), j.decode_image(iid),
                          f"item {iid}")
    return p


@pytest.mark.parametrize("name", list(CASES))
def test_item_file_matches_jax(name):
    """The port's file equals the JAX writer's; a second write gives the
    same bytes; both packages reopen it alike."""
    jctx, pctx = CASES[name](Jax), CASES[name](Port)
    want = jctx.write()
    got = pctx.write()
    assert got == want
    assert pctx.write() == got
    assert_same_items(got)


@pytest.mark.parametrize("name", ["grid-hevc", "tiled-unci", "regions-text",
                                  "thumbnail-exif-xmp"])
def test_debug_dump_boxes_matches_jax(name):
    jctx, pctx = CASES[name](Jax), CASES[name](Port)
    jctx.write()
    pctx.write()
    assert pctx.debug_dump_boxes() == jctx.debug_dump_boxes()
    assert "meta" in pctx.debug_dump_boxes()


def test_mini_written_and_fallthrough():
    """With set_write_mini_format a plain hvc1 primary (with alpha and
    Exif) becomes ftyp('mif3') + mini; a grid or unci primary keeps the
    normal format."""
    assert case_mini(Port).write()[4:12] == b"ftypmif3"
    for case in (case_mini_fallthrough, case_mini_unci):
        blob = case(Port).write()
        assert blob[8:12] != b"mif3" and b"meta" in blob[:64]


def test_replace_item_data_refusals_as_jax():
    """A range outside the item, or over two extents, raises in both."""
    for pk in (Jax, Port):
        ctx = pk.context()
        iid = ctx.encode_image(pk.image(photo(8, 8, 8, "444"),
                                        chroma="444"), "unci")
        with pytest.raises(pk.Error):
            ctx.file.replace_item_data(iid, 10_000, b"x")
        ctx.file.append_item_data(iid, b"tail")
        n = 8 * 8 * 3
        with pytest.raises(pk.Error, match="spans iloc extents"):
            ctx.file.replace_item_data(iid, n - 1, b"xy")


def test_overlay_refusals_as_jax():
    for pk in (Jax, Port):
        ctx = pk.context()
        a = ctx.encode_image(pk.image(photo(8, 8, 1, "444"), chroma="444"),
                             "unci")
        with pytest.raises(pk.Error, match="at least one image"):
            ctx.add_overlay_image(8, 8, [])
        with pytest.raises(pk.Error, match="length mismatch"):
            ctx.add_overlay_image(8, 8, [a], offsets=[(0, 0), (1, 1)])


def test_tile_size_refused_as_jax():
    for pk in (Jax, Port):
        ctx = pk.context()
        tid = ctx.add_tiled_image(64, 64, 32, 32, fmt="unci")
        with pytest.raises(pk.Error, match="tile size"):
            ctx.add_image_tile_to_tiled(tid, 0, 0, pk.image(
                photo(16, 16, 1, "444"), chroma="444"))


def test_unported_tile_format_refused_by_name():
    """VVC tiles are ported: ``fmt="vvc"`` makes a tili of vvc1 tiles,
    as in the JAX package.  A format no codec writes is refused naming
    it."""
    for pk in (Jax, Port):
        ctx = pk.context()
        tid = ctx.add_tiled_image(64, 64, 32, 32, fmt="vvc")
        assert ctx.file.get_item_type(tid) == "tili"
        assert ctx.get_item(tid)._tilC.params.compression_format == "vvc1"
    with pytest.raises(HeifError, match="vvc2"):
        Port.context().add_tiled_image(64, 64, 32, 32, fmt="vvc2")
