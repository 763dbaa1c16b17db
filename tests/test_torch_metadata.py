"""The port's read-side metadata calls and its streaming reader against
the JAX package, on the CPU: files written by the JAX writer with Exif,
XMP, region (rgan, every geometry kind, a referenced mask) and text
(txti) items, read by both packages; ``read_from_reader`` over a memory,
file and callback reader against ``read_from_bytes``; and the reader's
byte ranges (the open fetches only the structural boxes, a tile decode
only its tile).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.items.region_item import RegionGeometry  # noqa: E402
from libheif_tpu.items.region_item import RegionItem as JRegionItem  # noqa: E402
from libheif_tpu.option_types import EncodingOptions  # noqa: E402

from libheif_tpu_torch import HeifContext  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402
from libheif_tpu_torch.io.reader import (  # noqa: E402
    CallbackReader, FileReader, GrowStatus, MemoryReader, StreamReader)
from libheif_tpu_torch.items.region_item import RegionItem  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(ROOT, "libheif_tpu_torch", "testdata", "items")

EXIF = b"II*\x00\x08\x00\x00\x00" + bytes(range(40))
XMP = (b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF/>'
       b'</x:xmpmeta>')


def _ycc(w=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)
    img.set_plane(Channel.Y, rng.integers(0, 256, (h, w), np.uint8), 8)
    for ch in (Channel.Cb, Channel.Cr):
        img.set_plane(ch, rng.integers(0, 256, (h // 2, w // 2), np.uint8),
                      8)
    return img


def _mask(w=16, h=8):
    img = JPixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome)
    img.set_plane(Channel.Y, (np.arange(w * h, dtype=np.uint8) * 7)
                  .reshape(h, w), 8)
    return img


GEOMETRIES = [
    RegionGeometry(kind="point", x=10, y=-5),
    RegionGeometry(kind="rect", x=1, y=2, width=100, height=50),
    RegionGeometry(kind="ellipse", x=320, y=240, radius_x=100, radius_y=60),
    RegionGeometry(kind="polygon", points=[(0, 0), (10, 0), (5, 9)]),
    RegionGeometry(kind="polyline", points=[(1, 1), (2, 2), (-3, 4)]),
    RegionGeometry(kind="referenced_mask", x=4, y=6, width=16, height=8),
]


def _metadata_file(wide=False, exif_offset=0):
    """An unci image with two Exif blocks (the first with a TIFF offset
    of ``exif_offset``), XMP, two region items (every geometry kind; a
    referenced mask linked to an mski item; the second with an inline
    mask, in 32-bit fields when ``wide``) and two text items; a second
    image with its own text.  Returns (blob, primary id, second id)."""
    ctx = JHeifContext()
    iid = ctx.encode_image(_ycc(), "unci")
    other = ctx.encode_image(_ycc(32, 16, seed=1), "unci")
    mask_id = ctx.encode_image(_mask(), "mski")
    ctx.file.get_infe(mask_id).hidden = True
    infe_id = ctx.add_exif(iid, EXIF)
    if exif_offset:
        # rewrite the 4-byte TIFF offset header of that block
        it = ctx.file.iloc.find_item(infe_id)
        start = it.extents[0].offset
        parts = b"".join(ctx.file._mdat_parts)
        parts = parts[:start] + exif_offset.to_bytes(4, "big") + \
            bytes(exif_offset) + parts[start + 4:]
        ctx.file._mdat_parts = [parts]
        ctx.file._mdat_size = len(parts)
        it.extents[0].length += exif_offset
    ctx.add_exif(iid, b"MM\x00*second")
    ctx.add_xmp(iid, XMP)
    ri = ctx.add_region_item(iid, 100000 if wide else 640, 480)
    ri.regions.extend(RegionGeometry(**vars(g)) for g in GEOMETRIES)
    ctx.file.add_reference("mask", ri.item_id, [mask_id])
    ri2 = ctx.add_region_item(iid, 64, 48)
    ri2.regions.append(RegionGeometry(kind="inline_mask", x=-2, y=3,
                                      width=8, height=8,
                                      mask_data=bytes(range(8))))
    ctx.add_text_item(iid, "hello région ⚡")
    ctx.add_text_item(iid, "second", content_type="text/html")
    ctx.add_text_item(other, "on the other image")
    return ctx.write(), iid, other


def _regions(items):
    return [(r.item_id, r.reference_width, r.reference_height,
             [tuple(sorted(vars(g).items())) for g in r.regions])
            for r in items]


def _answers(ctx, ids):
    """Every read-side metadata answer of a context, per image id, as
    plain values."""
    out = {}
    for i in ids:
        blocks = ctx.get_metadata_blocks(i)
        out[i] = {
            "blocks": [{k: (bytes(v) if k == "data" else v)
                        for k, v in b.items()} for b in blocks],
            "exif_blocks": len(ctx.get_metadata_blocks(i, "Exif")),
            "exif": ctx.get_exif(i), "xmp": ctx.get_xmp(i),
            "regions": _regions(ctx.get_region_items(i)),
            "texts": [(t.item_id, t.text) for t in ctx.get_text_items(i)],
        }
    return out


@pytest.mark.parametrize("case", ["narrow", "wide", "exif-offset"])
def test_metadata_answers_match_jax(case):
    blob, iid, other = _metadata_file(wide=case == "wide",
                                      exif_offset=6 if case == "exif-offset"
                                      else 0)
    ref = _answers(JHeifContext.read_from_bytes(blob), (iid, other))
    got = _answers(HeifContext.read_from_bytes(blob, device="cpu"),
                   (iid, other))
    assert got == ref
    assert got[iid]["exif"] == EXIF          # past the TIFF offset
    assert got[iid]["xmp"] == XMP
    assert len(got[iid]["regions"]) == 2 and len(got[iid]["texts"]) == 2
    mask = [g for g in HeifContext.read_from_bytes(blob, device="cpu")
            .get_region_items(iid)[0].regions if g.kind == "referenced_mask"]
    assert len(mask) == 1 and mask[0].mask_item_id > 0
    assert got[other]["texts"] == [(got[other]["texts"][0][0],
                                    "on the other image")]


def test_image_without_metadata():
    ctx = JHeifContext()
    iid = ctx.encode_image(_ycc(), "unci")
    blob = ctx.write()
    p = HeifContext.read_from_bytes(blob, device="cpu")
    assert p.get_metadata_blocks(iid) == []
    assert p.get_exif(iid) is None and p.get_xmp(iid) is None
    assert p.get_region_items(iid) == [] and p.get_text_items(iid) == []
    assert p.top_level_image_ids() == [iid]


@pytest.mark.parametrize("name", ["mini_av1_alpha_exif.heif",
                                  "mini_hevc.heif"])
def test_mini_inline_metadata_matches_jax(name):
    path = os.path.join(MINI, name)
    if not os.path.exists(path):
        pytest.fail(f"missing committed file {name}")
    blob = open(path, "rb").read()
    j = JHeifContext.read_from_bytes(blob)
    p = HeifContext.read_from_bytes(blob, device="cpu")
    pid = j.primary_item_id
    assert p.primary_item_id == pid
    assert _answers(p, [pid]) == _answers(j, [pid])


def test_region_parse_matches_jax_on_every_kind():
    """RegionItem.parse of the JAX serialisation, narrow and wide, with
    the transform to image space."""
    for ref_w in (640, 100000):
        ri = JRegionItem(7, ref_w, 480)
        ri.regions.extend(RegionGeometry(**vars(g)) for g in GEOMETRIES)
        ri.regions.append(RegionGeometry(kind="inline_mask", x=1, y=2,
                                         width=4, height=2,
                                         mask_data=b"\x0f\xf0"))
        data = ri.serialize()
        ref, got = JRegionItem.parse(7, data), RegionItem.parse(7, data)
        assert _regions([got]) == _regions([ref])
        for g_ref, g in zip(ref.regions, got.regions):
            a = ref.transform_to_image(g_ref, 64, 48)
            b = got.transform_to_image(g, 64, 48)
            assert vars(a) == vars(b)


def test_region_bad_version_raises():
    with pytest.raises(HeifError):
        RegionItem.parse(1, bytes([7, 0, 0, 1, 0, 1, 0]))


# ----------------------------------------------------------- the reader

class RangeTrackingReader(StreamReader):
    """A memory reader that records every range read."""

    def __init__(self, data):
        self._data = data
        self.read_ranges = []

    def file_size(self):
        return len(self._data)

    def read(self, start, size):
        self.read_ranges.append((start, start + size))
        return self._data[start:start + size]

    def fetched(self):
        return sum(e - s for s, e in self.read_ranges)


def _tiled_unci(w=256, h=256, tiles=4):
    ctx = JHeifContext()
    rng = np.random.default_rng(5)
    img = JPixelImage(w, h, Colorspace.RGB, Chroma.C444)
    for ch in (Channel.R, Channel.G, Channel.B):
        img.set_plane(ch, rng.integers(0, 256, (h, w), np.uint8), 8)
    ctx.encode_image(img, "unci",
                     EncodingOptions(tile_cols=tiles, tile_rows=tiles))
    return ctx.write()


def _same_image(a, b):
    assert (a.width, a.height, a.colorspace, a.chroma) == \
        (b.width, b.height, b.colorspace, b.chroma)
    assert a.channels() == b.channels()
    for ch in a.channels():
        assert a.bit_depth(ch) == b.bit_depth(ch)
        np.testing.assert_array_equal(a.np_plane(ch), b.np_plane(ch))


def _readers(blob, tmp_path):
    path = tmp_path / "f.heif"
    path.write_bytes(blob)
    return {
        "memory": lambda: MemoryReader(blob),
        "file": lambda: FileReader(str(path)),
        "callback": lambda: CallbackReader(
            read=lambda s, n: blob[s:s + n], file_size=lambda: len(blob)),
    }


@pytest.mark.parametrize("kind", ["memory", "file", "callback"])
def test_read_from_reader_equals_read_from_bytes(kind, tmp_path):
    blob, iid, other = _metadata_file()
    reader = _readers(blob, tmp_path)[kind]()
    r = HeifContext.read_from_reader(reader, device="cpu")
    b = HeifContext.read_from_bytes(blob, device="cpu")
    assert r.primary_item_id == b.primary_item_id
    assert r.top_level_image_ids() == b.top_level_image_ids()
    assert _answers(r, (iid, other)) == _answers(b, (iid, other))
    for i in (iid, other):
        _same_image(r.decode_image(i, "RGB", "444"),
                    b.decode_image(i, "RGB", "444"))
    # and the JAX package's reader gives the same answers
    from libheif_tpu.io.reader import MemoryReader as JMemoryReader
    j = JHeifContext.read_from_reader(JMemoryReader(blob))
    assert _answers(r, (iid, other)) == _answers(j, (iid, other))


@pytest.mark.parametrize("name", ["mini_av1_alpha_exif.heif",
                                  "mini_hevc.heif"])
def test_mini_file_through_a_reader(name):
    blob = open(os.path.join(MINI, name), "rb").read()
    r = HeifContext.read_from_reader(MemoryReader(blob), device="cpu")
    b = HeifContext.read_from_bytes(blob, device="cpu")
    pid = b.primary_item_id
    assert _answers(r, [pid]) == _answers(b, [pid])
    _same_image(r.decode_image(pid), b.decode_image(pid))


def test_reader_open_fetches_only_structural_boxes():
    blob = _tiled_unci()
    tr = RangeTrackingReader(blob)
    ctx = HeifContext.read_from_reader(tr, device="cpu")
    assert ctx.primary_item_id
    assert tr.fetched() < len(blob) // 4, \
        f"open fetched {tr.fetched()} of {len(blob)} bytes"


def test_reader_tile_decode_reads_its_tile():
    blob = _tiled_unci(256, 256, 4)        # 16 tiles of 64x64
    tr = RangeTrackingReader(blob)
    ctx = HeifContext.read_from_reader(tr, device="cpu")
    opened = tr.fetched()
    tile = ctx.decode_tile(ctx.primary_item_id, 1, 2)
    assert tr.fetched() - opened == 64 * 64 * 3
    full = HeifContext.read_from_bytes(blob, device="cpu").decode_image(None)
    for ch in (Channel.R, Channel.G, Channel.B):
        np.testing.assert_array_equal(tile.np_plane(ch),
                                      full.np_plane(ch)[128:192, 64:128])


def test_callback_reader_request_ranges_and_eof():
    """A callback reader's request_range is asked before every read; a
    truncated file raises as the JAX package does."""
    blob = _tiled_unci(64, 64, 1)
    calls = []
    cb = CallbackReader(
        read=lambda s, n: blob[s:s + n], file_size=lambda: len(blob),
        request_range=lambda s, e: (
            calls.append((s, e)),
            GrowStatus.SIZE_REACHED if e <= len(blob)
            else GrowStatus.SIZE_BEYOND_EOF)[1])
    img = HeifContext.read_from_reader(cb, device="cpu").decode_image(None)
    assert calls and (img.width, img.height) == (64, 64)
    cut = blob[:len(blob) - 100]
    ctx = HeifContext.read_from_reader(MemoryReader(cut), device="cpu")
    with pytest.raises(HeifError):
        ctx.decode_image(None)
    with pytest.raises(HeifError):
        HeifContext.read_from_reader(MemoryReader(blob[:6]), device="cpu")
    with pytest.raises(HeifError):
        FileReader(os.path.join(str(ROOT), "no-such-file.heif"))


def test_file_read_through_a_reader_writes_again():
    """A file opened through a reader keeps its items' data when written
    again (its extents are read from the reader first)."""
    blob, iid, other = _metadata_file()
    f = HeifContext.read_from_reader(MemoryReader(blob), device="cpu").file
    again = f.write()
    a = HeifContext.read_from_bytes(again, device="cpu")
    b = HeifContext.read_from_bytes(blob, device="cpu")
    assert _answers(a, (iid, other)) == _answers(b, (iid, other))
    _same_image(a.decode_image(iid), b.decode_image(iid))


def test_short_callback_read_raises():
    blob = _tiled_unci(64, 64, 1)
    cb = CallbackReader(read=lambda s, n: blob[s:s + n - 1],
                        file_size=lambda: len(blob))
    with pytest.raises(HeifError):
        HeifContext.read_from_reader(cb, device="cpu")
