"""HEIF files with av01 items through the PyTorch port's context, against
the JAX package, on the CPU.

The files are written by the JAX package: ``HeifContext.encode_image(img,
"av1")`` for its own encoder, and for libaom streams (10 bits, or without
the intra edge filter) an ``av01`` item with its ``av1C`` and ``ispe``
added through the JAX context's item writer; grids with
``add_grid_image``.  Both packages read and decode them; the JAX package
decodes a grid tile by tile (its default), which the port's batched grid
path must equal sample for sample.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.codec_cfg import Box_av1C as JBox_av1C  # noqa: E402
from libheif_tpu.boxes.meta import Box_ispe as JBox_ispe  # noqa: E402
from libheif_tpu.codecs.av1 import obu as jobu  # noqa: E402
from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Channel, Colorspace, Chroma)
from libheif_tpu.option_types import EncodingOptions  # noqa: E402

from libheif_tpu_torch import HeifContext, HeifFile  # noqa: E402
from libheif_tpu_torch.boxes.codec_cfg import Box_av1C  # noqa: E402
from libheif_tpu_torch.codecs.av1 import device_recon  # noqa: E402
from libheif_tpu_torch.items.codec_items import ImageItem_AVIF  # noqa: E402
from tests.test_torch_av1 import mixed_planes  # noqa: E402


def _image(w, h, seed=0):
    rng = np.random.default_rng(seed)
    img = JPixelImage(w, h, Colorspace.YCbCr, Chroma.C420)

    def plane(pw, ph):
        base = rng.integers(0, 256, (ph // 8 + 1, pw // 8 + 1))
        return np.kron(base, np.ones((8, 8), np.int64))[:ph, :pw] \
            .astype(np.uint8)
    img.set_plane(Channel.Y, plane(w, h), 8)
    for ch in (Channel.Cb, Channel.Cr):
        img.set_plane(ch, plane((w + 1) // 2, (h + 1) // 2), 8)
    return img


def _aom(w, h, bits, seed, q, **extra):
    from tests import av1_oracle
    if not av1_oracle.available():
        pytest.skip("libaom not available")
    o = {"enable-filter-intra": "1", "enable-palette": "1",
         "enable-cfl-intra": "1", "enable-cdef": "1",
         "enable-restoration": "1", "enable-intrabc": "0",
         "cpu-used": "3", "_min_q": str(q), "_max_q": str(q)}
    o.update(extra)
    return av1_oracle.encode(mixed_planes(w, h, seed, bits), o, usage=0,
                             bit_depth=bits)


def _stream(name):
    from tests.test_torch_av1 import stream
    return stream(name)


def _add_stream(ctx, data, w, h, bits):
    """An av01 item holding the OBU stream, as the JAX encoder's items
    are written: av1C with the sequence header, ispe."""
    if ctx.file is None:
        ctx.new_file()
    item_id = ctx._register_encoded_item("av01")
    ctx.file.append_item_data(item_id, data)
    ctx.file.add_property(item_id, JBox_ispe(w, h), False)
    cfg = JBox_av1C()
    cfg.high_bitdepth = int(bits > 8)
    for ob in jobu.split_obus(data):
        if ob.type == jobu.OBU_SEQUENCE_HEADER:
            n = len(ob.payload)
            leb = bytearray()
            while True:
                b = n & 0x7F
                n >>= 7
                leb.append(b | (0x80 if n else 0))
                if not n:
                    break
            cfg.config_obus = bytes([(1 << 3) | 2]) + bytes(leb) + ob.payload
            break
    ctx.file.add_property(item_id, cfg, True)
    if ctx.primary_id is None:
        ctx.set_primary_item(item_id)
    return item_id


@functools.lru_cache(maxsize=None)
def build(kind):
    ctx = JHeifContext()
    if kind == "single":
        ctx.encode_image(_image(72, 40, 1), "av1", EncodingOptions(quality=60))
    elif kind == "single-aom":
        _add_stream(ctx, _aom(100, 60, 8, 4, 45), 100, 60, 8)
    elif kind == "single-10bit":
        _add_stream(ctx, _aom(96, 64, 10, 5, 40), 96, 64, 10)
    elif kind == "grid":
        ids = [ctx.encode_image(_image(64, 64, 10 + i), "av1",
                                EncodingOptions(quality=60))
               for i in range(4)]
        ctx.set_primary_item(ctx.add_grid_image(ids, 120, 100, 2, 2))
    elif kind == "grid-10bit":
        ids = [_add_stream(ctx, _aom(64, 64, 10, 20 + i, 40), 64, 64, 10)
               for i in range(4)]
        ctx.set_primary_item(ctx.add_grid_image(ids, 128, 128, 2, 2))
    elif kind == "single-grain":
        _add_stream(ctx, _stream("grain-tv4"), 128, 96, 8)
    elif kind == "grid-grain":
        # four film-grain tiles, each with its own parameters and seed
        ids = [_add_stream(ctx, _stream(n), 128, 96, b) for n, b in
               (("grain-tv1", 8), ("grain-tv7", 8), ("grain-tv15", 8),
                ("grain-tv12", 8))]
        ctx.set_primary_item(ctx.add_grid_image(ids, 250, 180, 2, 2))
    elif kind == "grid-edge-filter":
        # tiles 1 and 2 without the intra edge filter: two batches
        ids = [_add_stream(ctx, _aom(
            64, 64, 8, 30 + i, 50,
            **({"enable-intra-edge-filter": "0"} if i in (1, 2) else {})),
            64, 64, 8) for i in range(4)]
        ctx.set_primary_item(ctx.add_grid_image(ids, 128, 128, 2, 2))
    return ctx.write()


TARGETS = {
    "native": (Colorspace.Undefined, Chroma.Undefined),
    "rgb": (Colorspace.RGB, Chroma.C444),
    "rgba": (Colorspace.RGB, Chroma.InterleavedRGBA),
}
FILES = ["single", "single-aom", "single-10bit", "grid", "grid-10bit",
         "grid-edge-filter", "single-grain", "grid-grain"]


@functools.lru_cache(maxsize=None)
def jax_image(kind, target):
    ctx = JHeifContext.read_from_bytes(build(kind))
    return ctx.decode_image(None, *TARGETS[target])


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
@pytest.mark.parametrize("kind", FILES)
def test_decode_image_matches_jax(kind, target):
    """YCbCr exact against the JAX decode (grids: tile by tile); RGB
    within the colour contract."""
    got = HeifContext.read_from_bytes(build(kind), device="cpu") \
        .decode_image(None, *TARGETS[target])
    _assert_same_image(jax_image(kind, target), got,
                       colour=target != "native")


@pytest.mark.parametrize("kind,batches", [("grid", [4]), ("grid-10bit", [4]),
                                          ("grid-grain", [4]),
                                          ("grid-edge-filter", [2, 2]),
                                          ("single-aom", [1])])
def test_grid_batches(kind, batches, monkeypatch):
    """An all-av01 grid reconstructs as one batch per batch_key group
    (the edge-filter grid's tiles make two); a single item is a batch of
    one."""
    calls = []
    real = device_recon.decode_frames_device

    def spy(decs, device=None):
        calls.append(len(decs))
        return real(decs, device)
    monkeypatch.setattr(device_recon, "decode_frames_device", spy)
    from libheif_tpu_torch.codecs.av1 import decoder
    monkeypatch.setattr(decoder, "decode_frames_device", spy)
    HeifContext.read_from_bytes(build(kind), device="cpu").decode_image(None)
    assert sorted(calls) == batches


def test_grain_grid_equals_its_tiles():
    """A grid of film-grain tiles decodes in one batch, each tile with its
    own grain, to the tiles' single decodes pasted in place."""
    from libheif_tpu_torch.codecs.av1 import decoder
    img = HeifContext.read_from_bytes(build("grid-grain"), device="cpu") \
        .decode_image(None)
    names = ("grain-tv1", "grain-tv7", "grain-tv15", "grain-tv12")
    for i, n in enumerate(names):
        tile = decoder.decode_intra_frame(_stream(n), device="cpu")
        ty, tx = divmod(i, 2)
        for key, ch, sub in (("Y", Channel.Y, 1), ("U", Channel.Cb, 2),
                             ("V", Channel.Cr, 2)):
            th, tw = 96 // sub, 128 // sub
            got = img.np_plane(ch)[ty * th:(ty + 1) * th,
                                   tx * tw:(tx + 1) * tw]
            want = tile[key].numpy()[:got.shape[0], :got.shape[1]]
            assert np.array_equal(got.astype(np.int64), want), (n, key)


def test_av1C_property_and_write_back():
    """The port reads av1C as Box_av1C and writes the file as the JAX
    package does."""
    from libheif_tpu.file import HeifFile as JHeifFile
    data = build("single-10bit")
    f = HeifFile.from_bytes(data)
    pid = f.primary_item_id
    cfg = f.get_property(pid, Box_av1C)
    jcfg = JHeifFile.from_bytes(data).get_property(pid, JBox_av1C)
    assert cfg.bit_depth == jcfg.bit_depth == 10
    assert cfg.config_obus == jcfg.config_obus
    assert f.write() == JHeifFile.from_bytes(data).write()
    ctx = HeifContext.read_from_bytes(data, device="cpu")
    assert isinstance(ctx.get_item(pid), ImageItem_AVIF)


@pytest.mark.parametrize("kind,tiles,batches", [("grid-edge-filter", 4, 2),
                                                ("single-aom", 1, 1)])
def test_decode_spans(kind, tiles, batches):
    """Under trace.collect() the decode path names its parts (one parse
    a tile, one plan and one run of each stage a batch, the colour ops),
    and collecting them leaves the decoded samples as they are."""
    from libheif_tpu_torch.core import trace
    data = build(kind)
    ref = HeifContext.read_from_bytes(data, device="cpu").decode_image(
        None, *TARGETS["rgb"])
    with trace.collect() as spans:
        got = HeifContext.read_from_bytes(data, device="cpu").decode_image(
            None, *TARGETS["rgb"])
    counts = {k: v["count"] for k, v in spans.items()}
    assert counts["av1.parse"] == tiles
    for name in ("av1.plan", "av1.plan_host", "av1.plan_copies",
                 "av1.stage_a", "av1.stage_b"):
        assert counts[name] == batches, name
    assert counts["color.YCbCrToRGB"] == 1
    assert counts.get("grid.compose", 0) == (tiles > 1)
    assert all(counts.get(f, 0) <= tiles
               for f in ("av1.deblock", "av1.cdef", "av1.lr"))
    assert spans["av1.plan"]["ms"] >= spans["av1.plan_host"]["ms"] >= 0
    for ch in ref.channels():
        assert torch.equal(got.plane(ch), ref.plane(ch)), ch
