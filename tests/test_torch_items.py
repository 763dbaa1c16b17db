"""jpeg, mini, tili and mski items of the PyTorch port against the JAX
package, on the CPU.

The files are written in memory by the JAX package's writer
(``encode_image`` with "jpeg" and "mski", ``add_grid_image``,
``set_write_mini_format``, ``add_tiled_image``/``add_image_tile_to_tiled``)
and decoded by both packages.  Decoded planes are held exact; a
YCbCr→RGB conversion keeps the contract of tests/test_pallas_fast.py:1-9
(at most 1 LSB, on fewer than 1% of the samples).  Errors keep the JAX
package's codes.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.codec_cfg import Box_jpgC as JBox_jpgC  # noqa: E402
from libheif_tpu.boxes.meta import Box_ispe as JBox_ispe  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)

from libheif_tpu_torch import HeifContext  # noqa: E402
from libheif_tpu_torch.codecs.jpeg import decoder as pdec  # noqa: E402
from libheif_tpu_torch.core.error import HeifError  # noqa: E402
from libheif_tpu_torch.items.mask_item import mask_plane  # noqa: E402
from tests.test_torch_jpeg import stream  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "libheif_tpu_torch", "testdata", "items")
# the mini files the card decodes (it has no JAX writer): written by
# write_fixtures with the JAX package's writer
COMMITTED = {"mini_av1_alpha_exif": "mini_av1_alpha_exif.heif",
             "mini_hevc": "mini_hevc.heif"}
SUB = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
EXIF = b"II*\x00" + bytes(range(40))


# --------------------------------------------------------------- test files

def _image(w, h, chroma=Chroma.C420, seed=0, alpha=False):
    """A JAX YCbCr PixelImage of 8x8 flat patches (codecs keep it close),
    with a half-transparent alpha plane where asked."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
    full = np.kron(base, np.ones((8, 8, 1), np.uint8))
    img = JPixelImage(w, h, Colorspace.YCbCr, chroma)
    sx, sy = SUB[chroma]
    img.set_plane(Channel.Y, full[:h, :w, 0].copy(), 8)
    for i, ch in ((1, Channel.Cb), (2, Channel.Cr)):
        img.set_plane(ch, full[:(h + sy - 1) // sy, :(w + sx - 1) // sx,
                               i].copy(), 8)
    if alpha:
        a = np.zeros((h, w), np.uint8)
        a[:, :w // 2] = 255
        img.set_plane(Channel.Alpha, a, 8)
    return img


def build_jpeg():
    ctx = JHeifContext()
    ctx.encode_image(_image(64, 48), "jpeg")
    return ctx.write()


def _jpeg_item_file(data: bytes, config: bytes = b""):
    """One jpeg item holding ``data``, with a jpgC of ``config`` if given."""
    ctx = JHeifContext()
    ctx.new_file()
    item = ctx._register_encoded_item("jpeg")
    ctx.file.append_item_data(item, data)
    frame = pdec.JpegParser(config + data).parse()
    ctx.file.add_property(item, JBox_ispe(frame.width, frame.height), False)
    if config:
        ctx.file.add_property(item, JBox_jpgC(config), True)
    ctx.set_primary_item(item)
    return ctx.write()


def build_jpeg_joined():
    return _jpeg_item_file(stream("c444"))


def build_jpeg_jpgc():
    """The same stream with SOI and its tables (everything before SOS) in
    a jpgC, as libheif's JPEG encoder splits it."""
    data = stream("c444")
    sos = data.index(b"\xff\xda")
    return _jpeg_item_file(data[sos:], data[:sos])


def _grid_file(tiles, out_w, out_h, rows, cols):
    ctx = JHeifContext()
    ids = [ctx.encode_image(t, "jpeg") for t in tiles]
    g = ctx.add_grid_image(ids, out_w, out_h, rows, cols)
    ctx.set_primary_item(g)
    return ctx.write()


def build_jpeg_grid():
    """3x2 grid of 32x24 4:2:0 jpeg tiles under a 90x40 output (ragged
    right and bottom edges): one batch."""
    return _grid_file([_image(32, 24, seed=i) for i in range(6)],
                      90, 40, 2, 3)


def build_jpeg_grid_mixed():
    """2x2 grid whose tiles differ in sampling: tile by tile."""
    tiles = [_image(32, 24, Chroma.C444 if i == 2 else Chroma.C420, seed=i)
             for i in range(4)]
    return _grid_file(tiles, 64, 48, 2, 2)


def build_jpeg_grid_odd():
    """2x2 grid of 33x24 4:2:0 tiles: their chroma would overlap by a
    column, so the batch is refused and they decode tile by tile."""
    return _grid_file([_image(33, 24, seed=i) for i in range(4)],
                      66, 48, 2, 2)


def _mini(fmt, alpha=False, exif=False):
    ctx = JHeifContext()
    ctx.encode_image(_image(64, 48, alpha=alpha), fmt)
    if exif:
        ctx.add_exif(ctx.primary_item_id, EXIF)
    ctx.set_write_mini_format(True)
    data = ctx.write()
    assert data[8:12] == b"mif3"
    return data


def build_mini_av1_alpha_exif():
    return _mini("av1", alpha=True, exif=True)


def build_mini_hevc():
    return _mini("hevc", exif=True)


def _tili(fmt, missing=(1, 1)):
    """A 2x2 tili of 64x48 tiles (one left out: "not available")."""
    ctx = JHeifContext()
    tid = ctx.add_tiled_image(128, 96, 64, 48, fmt=fmt)
    for ty in range(2):
        for tx in range(2):
            if (tx, ty) != missing:
                ctx.add_image_tile_to_tiled(tid, tx, ty,
                                            _image(64, 48, seed=tx + 2 * ty))
    return ctx.write()


def build_tili_unci():
    return _tili("unci")


def build_tili_hevc():
    return _tili("hevc")


def build_tili_jpeg():
    return _tili("jpeg")


def build_tili_av1():
    return _tili("av1")


def build_tili_vvc():
    """The unci tili with its tilC naming vvc1 tiles."""
    data = bytearray(_tili("unci"))
    at = data.index(b"tilC") + 4 + 4 + 8     # type, version/flags, w, h
    assert data[at:at + 4] == b"unci"
    data[at:at + 4] = b"vvc1"
    return bytes(data)


def _mask(bits):
    rng = np.random.default_rng(bits)
    m = JPixelImage(37, 21, Colorspace.Monochrome, Chroma.Monochrome)
    dt = np.uint8 if bits == 8 else np.uint16
    m.set_plane(Channel.Y, rng.integers(0, 1 << bits, (21, 37), dtype=dt),
                bits)
    ctx = JHeifContext()
    ctx.encode_image(m, "mski")
    return ctx.write()


def build_mski8():
    return _mask(8)


def build_mski16():
    return _mask(16)


FILES = {k[len("build_"):]: v for k, v in globals().items()
         if k.startswith("build_")}


@functools.lru_cache(maxsize=None)
def blob(name):
    return FILES[name]()


# --------------------------------------------------------------- comparison

def _same(ref, got, colour=False):
    assert (got.width, got.height) == (ref.width, ref.height)
    assert (got.colorspace, got.chroma) == (ref.colorspace, ref.chroma)
    assert got.channels() == ref.channels()
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


def _contexts(data):
    return JHeifContext.read_from_bytes(data), \
        HeifContext.read_from_bytes(data, device="cpu")


def _raise_both(fn_j, fn_p):
    with pytest.raises(Exception) as je:
        fn_j()
    with pytest.raises(HeifError) as pe:
        fn_p()
    assert (int(pe.value.code), int(pe.value.subcode)) == \
        (int(je.value.code), int(je.value.subcode))
    return je.value, pe.value


DECODED = ["jpeg", "jpeg_joined", "jpeg_grid", "jpeg_grid_mixed",
           "jpeg_grid_odd", "mini_av1_alpha_exif", "mini_hevc", "mski8",
           "mski16"]
TARGETS = {"native": (Colorspace.Undefined, Chroma.Undefined),
           "rgb24": (Colorspace.RGB, Chroma.InterleavedRGB)}


@pytest.mark.parametrize("target", list(TARGETS))
@pytest.mark.parametrize("name", DECODED)
def test_decode_image_matches_jax(name, target):
    colorspace, chroma = TARGETS[target]
    jctx, pctx = _contexts(blob(name))
    ref = jctx.decode_image(jctx.primary_item_id, colorspace, chroma)
    got = pctx.decode_image(None, colorspace, chroma)
    _same(ref, got, colour=target != "native" and not name.startswith(
        "mski"))


# -------------------------------------------------------------------- jpeg

def test_jpgc_goes_in_front_of_the_data():
    """A jpeg item whose tables sit in jpgC decodes as the joined stream
    does; the JAX package ignores jpgC and cannot decode it (ROADMAP §3,
    faults on the reference side)."""
    jctx, _ = _contexts(blob("jpeg_jpgc"))
    with pytest.raises(Exception, match="missing SOI"):
        jctx.decode_image(jctx.primary_item_id)
    jref, _ = _contexts(blob("jpeg_joined"))
    ref = jref.decode_image(jref.primary_item_id)
    pctx = HeifContext.read_from_bytes(blob("jpeg_jpgc"), device="cpu")
    _same(ref, pctx.decode_image(None))
    item = pctx.get_item(pctx.primary_item_id)
    assert item.config_box().data == stream("c444")[
        :stream("c444").index(b"\xff\xda")]


@pytest.fixture
def recon_calls(monkeypatch):
    """Count the reconstructions (one kernel launch each on the card)."""
    calls = []
    real = pdec.reconstruct

    def counted(frames, outs):
        calls.append(len(frames))
        return real(frames, outs)
    monkeypatch.setattr(pdec, "reconstruct", counted)
    return calls


@pytest.mark.parametrize("name,calls", [
    ("jpeg_grid", [6]), ("jpeg_grid_mixed", [1, 1, 1, 1]),
    ("jpeg_grid_odd", [1, 1, 1, 1])])
def test_jpeg_grid_batches(name, calls, recon_calls):
    """An all-jpeg grid reconstructs its tiles in one batch; a grid the
    batch refuses (mixed sampling, overlapping chroma) tile by tile,
    with the same planes as the JAX tile-by-tile decode."""
    jctx, pctx = _contexts(blob(name))
    got = pctx.decode_image(None)
    assert recon_calls == calls
    _same(jctx.decode_image(jctx.primary_item_id), got)


def test_jpeg_grid_spans_and_progress():
    from libheif_tpu_torch.core import trace
    from libheif_tpu_torch.items import DecodingOptions
    seen = []
    pctx = HeifContext.read_from_bytes(blob("jpeg_grid"), device="cpu")
    with trace.collect() as spans:
        pctx.decode_image(None, Colorspace.RGB, Chroma.InterleavedRGB,
                          DecodingOptions(on_progress=lambda i, n:
                                          seen.append((i, n))))
    assert seen == [(i, 6) for i in range(1, 7)]
    assert spans["jpeg.parse"]["count"] == 6
    assert spans["jpeg.scan"]["count"] == 6
    assert spans["jpeg.recon"]["count"] == 1
    assert spans["grid.compose"]["count"] == 1
    assert any(k.startswith("color.") for k in spans)


# -------------------------------------------------------------------- mini

@pytest.mark.parametrize("name", ["mini_av1_alpha_exif", "mini_hevc"])
def test_mini_items_match_jax(name):
    jctx, pctx = _contexts(blob(name))
    assert pctx.file.meta is None and pctx.file.mini is not None
    assert sorted(pctx.items) == sorted(jctx.items)
    for i, j in jctx.items.items():
        p = pctx.items[i]
        assert (p.item_type, p.role, p.is_primary, p.is_aux) == \
            (j.item_type, j.role, j.is_primary, j.is_aux)
        assert p.width_height() == j.width_height()
        assert p.luma_bits_per_pixel() == j.luma_bits_per_pixel()
        assert p.metadata == j.metadata
        a, b = p.nclx(), j.nclx()
        assert (a.color_primaries, a.transfer_characteristics,
                a.matrix_coefficients, a.full_range_flag) == \
            (b.color_primaries, b.transfer_characteristics,
             b.matrix_coefficients, b.full_range_flag)
    main = pctx.get_item(1)
    assert main.metadata[0]["data"].endswith(EXIF)   # after its offset
    assert (main.alpha_item is not None) == (name == "mini_av1_alpha_exif")
    with pytest.raises(HeifError):
        pctx.file.primary_item_id             # no meta box


def test_mini_box_fields_match_jax():
    from libheif_tpu_torch.boxes.mini import Box_mini
    jctx, pctx = _contexts(blob("mini_av1_alpha_exif"))
    a, b = pctx.file.mini, jctx.file.mini
    assert isinstance(a, Box_mini)
    skip = {"children", "raw"}
    for k, v in vars(b).items():
        if k not in skip:
            assert getattr(a, k) == v, k
    assert a.serialize() == b.serialize()


def plane_hashes(planes) -> dict:
    """SHA-256 of each numpy plane's bytes."""
    return {ch: hashlib.sha256(np.ascontiguousarray(p).tobytes())
            .hexdigest() for ch, p in planes.items()}


def jax_planes(img) -> dict:
    return {ch: np.asarray(img.plane(ch)) for ch in img.channels()}


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_mini_files(name):
    """The committed mini files decode, in the port and in JAX, to the
    manifest's hashes."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        e = {x["name"]: x for x in json.load(f)["files"]}[name]
    with open(os.path.join(FIXTURES, COMMITTED[name]), "rb") as f:
        data = f.read()
    jctx, pctx = _contexts(data)
    ref = jctx.decode_image(jctx.primary_item_id)
    got = pctx.decode_image(None)
    _same(ref, got)
    assert plane_hashes({ch: got.np_plane(ch) for ch in got.channels()}) \
        == plane_hashes(jax_planes(ref)) == e["sha256"]


def write_fixtures():
    """Write the mini files the card decodes, with the JAX decode's plane
    hashes."""
    os.makedirs(FIXTURES, exist_ok=True)
    entries = []
    for name, fn in sorted(COMMITTED.items()):
        data = FILES[name]()
        with open(os.path.join(FIXTURES, fn), "wb") as f:
            f.write(data)
        jctx = JHeifContext.read_from_bytes(data)
        img = jctx.decode_image(jctx.primary_item_id)
        entries.append(dict(name=name, file=fn, width=img.width,
                            height=img.height, channels=img.channels(),
                            sha256=plane_hashes(jax_planes(img))))
        print(name, len(data), flush=True)
    about = ("mini files written by the JAX package's writer "
             "(tests/test_torch_items.py write_fixtures); sha256 of each "
             "plane of the JAX decode (uint8)")
    with open(os.path.join(FIXTURES, "manifest.json"), "w") as f:
        json.dump({"about": about, "files": entries}, f, indent=1)
        f.write("\n")


# -------------------------------------------------------------------- tili

TILI = ["tili_unci", "tili_hevc", "tili_jpeg", "tili_av1"]


@pytest.mark.parametrize("name", TILI)
def test_tili_tiles_match_jax(name):
    jctx, pctx = _contexts(blob(name))
    jt = jctx.get_image_tiling(jctx.primary_item_id)
    pt = pctx.get_image_tiling(pctx.primary_item_id)
    assert vars(pt) == vars(jt)
    for tx, ty in ((0, 0), (1, 0), (0, 1)):
        ref = jctx.decode_tile(jctx.primary_item_id, tx, ty)
        got = pctx.decode_tile(pctx.primary_item_id, tx, ty)
        _same(ref, got)
    ref = jctx.decode_tile(jctx.primary_item_id, 1, 0, Colorspace.RGB,
                           Chroma.InterleavedRGB)
    got = pctx.decode_tile(pctx.primary_item_id, 1, 0, Colorspace.RGB,
                           Chroma.InterleavedRGB)
    _same(ref, got, colour=True)


@pytest.mark.parametrize("name", TILI)
def test_tili_refusals_match_jax(name):
    """The left-out tile is "not available", a tile outside the grid is
    refused, and a full-image decode is refused, as in JAX."""
    jctx, pctx = _contexts(blob(name))
    j, p = jctx.primary_item_id, pctx.primary_item_id
    _, e = _raise_both(lambda: jctx.decode_tile(j, 1, 1),
                       lambda: pctx.decode_tile(p, 1, 1))
    assert "not available" in e.message
    _raise_both(lambda: jctx.decode_tile(j, 2, 0),
                lambda: pctx.decode_tile(p, 2, 0))
    _, e = _raise_both(lambda: jctx.decode_image(j),
                       lambda: pctx.decode_image(p))
    assert "per tile" in e.message


def test_tili_offset_table_is_read_in_chunks():
    """A tile's decode reads its offset-table entries in one chunk
    (ranged reads of the item), not the whole item."""
    pctx = HeifContext.read_from_bytes(blob("tili_unci"), device="cpu")
    item = pctx.get_item(pctx.primary_item_id)
    reads = []
    real = pctx.file.get_item_data_range

    def ranged(item_id, offset, size):
        reads.append((offset, size))
        return real(item_id, offset, size)
    pctx.file.get_item_data_range = ranged
    pctx.file.get_item_data = None            # never the whole item
    item.decode_tile(0, 1)
    item.decode_tile(1, 0)
    esz = item._get_header().entry_size()
    assert reads[0] == (0, 4 * esz)           # the whole 2x2 table, once
    assert len(reads) == 3                    # then one read a tile


def test_tili_unported_codec_is_named():
    """VVC tiles are ported: a tili whose tilC names vvc1 tiles but
    carries no vvcC (the unci tili renamed) raises the JAX package's
    HeifError, No_vvcC_box."""
    jctx, pctx = _contexts(blob("tili_vvc"))
    _, err = _raise_both(
        lambda: jctx.decode_tile(jctx.primary_item_id, 0, 0),
        lambda: pctx.decode_tile(pctx.primary_item_id, 0, 0))
    assert err.subcode.name == "No_vvcC_box"


def test_item_data_range_matches_jax():
    jctx, pctx = _contexts(blob("tili_jpeg"))
    i = pctx.primary_item_id
    whole = bytes(pctx.file.get_item_data(i))
    for off, size in ((0, 7), (5, 100), (len(whole) - 9, 9)):
        got = pctx.file.get_item_data_range(i, off, size)
        assert got == whole[off:off + size]
        assert got == jctx.file.get_item_data_range(i, off, size)
    _raise_both(lambda: jctx.file.get_item_data_range(i, len(whole) - 1, 4),
                lambda: pctx.file.get_item_data_range(i, len(whole) - 1, 4))


# -------------------------------------------------------------------- mski

def test_mask_16_bit_samples_are_swapped():
    """16-bit masks are big-endian in the file: the plane holds the
    values, not their byte-swapped form."""
    vals = np.array([[0x0102, 0xA0B0, 0xFFFE]], np.uint16)
    plane = mask_plane(vals.astype(">u2").tobytes(), 3, 1, 16, "cpu")
    assert plane.dtype == torch.uint16 and plane.shape == (1, 3)
    assert plane.view(torch.int16).numpy().view(np.uint16).tolist() == \
        vals.tolist()
    assert mask_plane(b"\x01\x02\x03", 3, 1, 8, "cpu").tolist() == [[1, 2,
                                                                     3]]


# ----------------------------------------------------------------- imports

NEW_MODULES = [
    "libheif_tpu_torch.codecs.jpeg",
    "libheif_tpu_torch.codecs.jpeg.decoder",
    "libheif_tpu_torch.codecs.jpeg.cuda_fast",
    "libheif_tpu_torch.codecs.jpeg.idct",
    "libheif_tpu_torch.codecs.jpeg.native_scan",
    "libheif_tpu_torch.codecs.jpeg.bitio",
    "libheif_tpu_torch.codecs.jpeg.tables",
    "libheif_tpu_torch.boxes.mini",
    "libheif_tpu_torch.boxes.tild",
    "libheif_tpu_torch.items.mini_item",
    "libheif_tpu_torch.items.tiled_item",
    "libheif_tpu_torch.items.mask_item",
]


@pytest.fixture(scope="module")
def isolated_imports():
    """Import every new module and decode the committed JPEG tile through
    the port alone, in an interpreter where jax and libheif_tpu cannot be
    imported."""
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["libheif_tpu"] = None
        ok = []
        for name in {NEW_MODULES!r}:
            importlib.import_module(name)
            ok.append(name)
        from libheif_tpu_torch.codecs.jpeg import decode_jpeg
        data = open("libheif_tpu_torch/testdata/jpeg/c444.jpg", "rb").read()
        img = decode_jpeg(data, device="cpu")
        assert img.plane("Y").shape == (64, 96)
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


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv:
        write_fixtures()
