"""The PyTorch port's unci decode against the JAX package, on the CPU.

Every layout is built in code with the JAX package's boxes and encoder;
the port parses the same box bytes with its own box reader.  The decode
is an integer program, so port and JAX must agree bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.boxes.unc import (  # noqa: E402
    Box_uncC as JBox_uncC, Box_cmpd as JBox_cmpd, CmpdComponent as JCmpd,
    UncCComponent as JUncCComp, InterleaveMode, SamplingMode)
from libheif_tpu.codecs.unc import kernels as jkernels  # noqa: E402
from libheif_tpu.codecs.unc import pallas_fast  # noqa: E402
from libheif_tpu.codecs.unc.codec import (  # noqa: E402
    UnciDecoder as JUnciDecoder, UnciEncoder)
from libheif_tpu.codecs.unc.layout import (  # noqa: E402
    compute_layout as jcompute_layout)
from libheif_tpu.core.fourcc import fourcc  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Colorspace, Chroma, Channel, subsampled_size)

from libheif_tpu_torch.boxes import read_all_boxes  # noqa: E402
from libheif_tpu_torch.boxes.unc import (  # noqa: E402
    Box_uncC, Box_cmpd, Box_cmpC, Box_icef)
from libheif_tpu_torch.codecs.unc import UnciDecoder, cuda_fast  # noqa: E402
from libheif_tpu_torch.codecs.unc import kernels  # noqa: E402
from libheif_tpu_torch.codecs.unc.layout import compute_layout  # noqa: E402

CPU = "cpu"
YCC = [Channel.Y, Channel.Cb, Channel.Cr]
RGB = [Channel.R, Channel.G, Channel.B]


# ------------------------------------------------------------ case builders

def _encoded(w, h, colorspace, chroma, depth, channels, tiles=(1, 1),
             compression=None, per_tile=False):
    """Random planes through the JAX package's UnciEncoder."""
    rng = np.random.default_rng(w * 1000 + h + depth)
    img = JPixelImage(w, h, colorspace, chroma)
    dt = np.uint8 if depth <= 8 else np.uint16
    for ch in channels:
        pw, ph = subsampled_size(w, h, ch, chroma)
        img.set_plane(ch, rng.integers(0, 1 << depth, (ph, pw), dtype=dt),
                      depth)
    enc = UnciEncoder(tile_cols=tiles[0], tile_rows=tiles[1],
                      compression=compression, compress_per_tile=per_tile)
    data, cmpd, uncC, cmpC, icef = enc.encode(img)
    return dict(w=w, h=h, boxes=[b for b in (uncC, cmpd, cmpC, icef)
                                 if b is not None], data=data)


def _hand(w, h, types, comps, tiles=(1, 1), version=0, profile=None,
          **fields):
    """A uncC/cmpd pair built field by field, with random payload bytes
    of the size the JAX layout asks for."""
    uncC = JBox_uncC()
    uncC.version = version
    if profile is not None:
        uncC.profile = fourcc(profile)
    uncC.components = [JUncCComp(i, d, 0, a) for i, d, a in comps]
    uncC.num_tile_cols, uncC.num_tile_rows = tiles
    for k, v in fields.items():
        setattr(uncC, k, v)
    cmpd = JBox_cmpd([JCmpd(t) for t in types]) if types else None
    lay = jcompute_layout(uncC, cmpd if cmpd is not None else
                          jkernels_implied(uncC), w, h)
    rng = np.random.default_rng(lay.total_data_size() + w + 7 * h)
    data = rng.integers(0, 256, lay.total_data_size(),
                        dtype=np.uint8).tobytes()
    boxes = [uncC] + ([cmpd] if cmpd is not None else [])
    return dict(w=w, h=h, boxes=boxes, data=data)


def jkernels_implied(uncC):
    from libheif_tpu.codecs.unc.codec import _implied_cmpd_for_profile
    return _implied_cmpd_for_profile(uncC)


CASES = {
    # component interleave through the encoder
    "comp420_8_tiled": lambda: _encoded(64, 32, Colorspace.YCbCr,
                                        Chroma.C420, 8, YCC, (2, 2)),
    "comp422_8_tiled": lambda: _encoded(64, 32, Colorspace.YCbCr,
                                        Chroma.C422, 8, YCC, (2, 2)),
    "comp444_8_tiled": lambda: _encoded(48, 32, Colorspace.YCbCr,
                                        Chroma.C444, 8, YCC, (2, 1)),
    "comp_rgb16_tiled": lambda: _encoded(32, 32, Colorspace.RGB, Chroma.C444,
                                         16, RGB, (2, 2)),
    "comp420_odd_rowalign": lambda: _hand(
        31, 19, [1, 2, 3], [(0, 8, 0), (1, 8, 0), (2, 8, 0)],
        sampling_type=SamplingMode.s420, row_align_size=4),
    # pixel interleave
    "pixel_rgb8_tiled": lambda: _hand(
        32, 16, [4, 5, 6], [(0, 8, 0), (1, 8, 0), (2, 8, 0)], (2, 2),
        interleave_type=InterleaveMode.pixel),
    "pixel_ycbcr8_tiled": lambda: _hand(
        32, 16, [1, 2, 3], [(0, 8, 0), (1, 8, 0), (2, 8, 0)], (2, 2),
        interleave_type=InterleaveMode.pixel),
    "pixel_rgba16_tiled": lambda: _hand(
        32, 16, [4, 5, 6, 7], [(0, 16, 0), (1, 16, 0), (2, 16, 0),
                               (3, 16, 0)], (2, 1),
        interleave_type=InterleaveMode.pixel),
    "pixel_padded_size": lambda: _hand(
        16, 8, [4, 5, 6], [(0, 8, 0), (1, 8, 0), (2, 8, 0)],
        interleave_type=InterleaveMode.pixel, pixel_size=4),
    # row interleave
    "row_rgb8_tiled": lambda: _hand(
        32, 16, [4, 5, 6], [(0, 8, 0), (1, 8, 0), (2, 8, 0)], (2, 2),
        interleave_type=InterleaveMode.row),
    "row_rgb16": lambda: _hand(
        24, 8, [4, 5, 6], [(0, 16, 0), (1, 16, 0), (2, 16, 0)],
        interleave_type=InterleaveMode.row),
    # bit-packed, misaligned depths
    "comp_rgb10_packed_tiled": lambda: _hand(
        30, 12, [4, 5, 6], [(0, 10, 0), (1, 10, 0), (2, 10, 0)], (2, 2)),
    "pixel_rgb565": lambda: _hand(
        20, 6, [4, 5, 6], [(0, 5, 0), (1, 6, 0), (2, 5, 0)],
        interleave_type=InterleaveMode.pixel),
    "pixel_mixed_align": lambda: _hand(
        10, 4, [4, 5, 6], [(0, 5, 0), (1, 8, 1), (2, 3, 0)],
        interleave_type=InterleaveMode.pixel),
    "mono12_packed": lambda: _hand(
        21, 5, [0], [(0, 12, 0)]),
    # little-endian fields
    "block_le_10": lambda: _hand(
        16, 8, [1, 2, 3], [(0, 10, 0), (1, 10, 0), (2, 10, 0)],
        block_size=2, block_little_endian=True),
    "comp_le_16": lambda: _hand(
        16, 8, [4, 5, 6], [(0, 16, 0), (1, 16, 0), (2, 16, 0)],
        components_little_endian=True),
    "pixel_block_be_10": lambda: _hand(
        12, 4, [4, 5, 6], [(0, 10, 0), (1, 10, 0), (2, 10, 0)],
        interleave_type=InterleaveMode.pixel, block_size=4),
    # multi-Y, mixed and tile-component
    "multi_y_yuv2": lambda: _hand(32, 8, None, [], version=1,
                                  profile="yuv2"),
    # (a v1 uncC carries no tile grid, so these are single-tile)
    "multi_y_2vuy": lambda: _hand(16, 4, None, [], version=1, profile="2vuy"),
    "mixed_nv12": lambda: _hand(32, 16, None, [], version=1, profile="nv12"),
    "tile_component_420": lambda: _hand(
        32, 16, [1, 2, 3], [(0, 8, 0), (1, 8, 0), (2, 8, 0)], (2, 2),
        sampling_type=SamplingMode.s420,
        interleave_type=InterleaveMode.tile_component, tile_align_size=4),
    # generic compression
    "zlib_whole": lambda: _encoded(32, 32, Colorspace.YCbCr, Chroma.C420, 8,
                                   YCC, (2, 2), compression="zlib"),
    "zlib_per_tile": lambda: _encoded(32, 32, Colorspace.YCbCr, Chroma.C420,
                                      8, YCC, (2, 2), compression="zlib",
                                      per_tile=True),
    "deflate_whole": lambda: _encoded(32, 16, Colorspace.RGB, Chroma.C444, 8,
                                      RGB, (1, 2), compression="defl"),
}


def _port_boxes(case):
    """Parse the JAX boxes' bytes with the port's reader."""
    raw = b"".join(b.serialize() for b in case["boxes"])
    boxes = read_all_boxes(raw)
    found = {type(b): b for b in boxes}
    return raw, boxes, found


def _decoders(case):
    jb = {type(b).__name__: b for b in case["boxes"]}
    jdec = JUnciDecoder(jb["Box_uncC"], jb.get("Box_cmpd"), case["w"],
                        case["h"], cmpC=jb.get("Box_cmpC"),
                        icef=jb.get("Box_icef"))
    _, _, pb = _port_boxes(case)
    pdec = UnciDecoder(pb[Box_uncC], pb.get(Box_cmpd), case["w"], case["h"],
                       cmpC=pb.get(Box_cmpC), icef=pb.get(Box_icef),
                       device=CPU)
    return jdec, pdec


def _assert_same_planes(jimg, pimg):
    assert sorted(jimg.channels()) == sorted(pimg.channels())
    for ch in jimg.channels():
        a = np.asarray(jimg.plane(ch))
        b = pimg.np_plane(ch)
        assert a.dtype == b.dtype, ch
        np.testing.assert_array_equal(a, b, err_msg=ch)
        assert jimg.bit_depth(ch) == pimg.bit_depth(ch)
    assert (jimg.colorspace, jimg.chroma) == (pimg.colorspace, pimg.chroma)


# ----------------------------------------------------------------- (a) boxes

@pytest.mark.parametrize("name", list(CASES))
def test_boxes_round_trip_and_layout_key(name):
    case = CASES[name]()
    raw, boxes, found = _port_boxes(case)
    assert b"".join(b.serialize() for b in boxes) == raw
    jb = {type(b).__name__: b for b in case["boxes"]}
    jcmpd = jb.get("Box_cmpd") or jkernels_implied(jb["Box_uncC"])
    from libheif_tpu_torch.codecs.unc.codec import _implied_cmpd_for_profile
    pcmpd = found.get(Box_cmpd) or _implied_cmpd_for_profile(found[Box_uncC])
    jlay = jcompute_layout(jb["Box_uncC"], jcmpd, case["w"], case["h"])
    play = compute_layout(found[Box_uncC], pcmpd, case["w"], case["h"])
    assert kernels._layout_key(play) == jkernels._layout_key(jlay)


# ---------------------------------------------------------- (b) decode matrix

@pytest.mark.parametrize("name", list(CASES))
def test_decode_bit_exact(name):
    case = CASES[name]()
    jdec, pdec = _decoders(case)
    _assert_same_planes(jdec.decode(case["data"]), pdec.decode(case["data"]))


@pytest.mark.parametrize("name,tile", [
    ("comp420_8_tiled", (1, 1)), ("pixel_rgb8_tiled", (1, 0)),
    ("tile_component_420", (0, 1)), ("zlib_per_tile", (1, 1)),
    ("zlib_whole", (0, 1)), ("row_rgb8_tiled", (1, 1))])
def test_decode_tile_bit_exact(name, tile):
    case = CASES[name]()
    jdec, pdec = _decoders(case)
    _assert_same_planes(jdec.decode_tile(case["data"], *tile),
                        pdec.decode_tile(case["data"], *tile))


# ------------------------------------------------------ (c) strided decode

@pytest.mark.parametrize("name", list(CASES))
def test_strided_decode_matches_jax_and_generic(name):
    """The port's strided path (plain version on CPU tensors) takes the
    same layouts as JAX's fused_strided_decode and decodes them bit for
    bit like it (interpret mode) and like the generic program."""
    case = CASES[name]()
    jdec, pdec = _decoders(case)
    payload = pdec._uncompressed_payload(case["data"])
    tiles = kernels.assemble_tile_buffers(pdec.layout, payload)
    jtiles = jkernels.assemble_tile_buffers(jdec.layout, payload)
    np.testing.assert_array_equal(tiles, jtiles)
    ref = pallas_fast.fused_strided_decode(jdec.layout, jtiles,
                                           interpret=True)
    got = cuda_fast.fused_strided_decode(pdec.layout, torch.from_numpy(tiles))
    if ref is None:
        assert got is None
        return
    assert got is not None
    generic = kernels.decode_tiles(pdec.layout, tiles, device=CPU)
    assert set(got) == set(ref) == set(generic)
    for ch in ref:
        np.testing.assert_array_equal(got[ch].numpy(), np.asarray(ref[ch]),
                                      err_msg=ch)
        np.testing.assert_array_equal(got[ch].numpy(), generic[ch].numpy(),
                                      err_msg=ch)


def _emulate_strided_kernel(layout, tiles):
    """The strided_extract_paste kernel's per-element address arithmetic
    (csrc/unc_kernels.cu), replayed in numpy."""
    s = layout.tile_size_bytes
    out = {}
    for v in layout.views:
        H, W = layout.tile_rows * v.height, layout.tile_cols * v.width
        y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        ti, tj = y // v.height, x // v.width
        off = (v.base_bits // 8 + (y - ti * v.height) * (v.row_stride_bits // 8)
               + (x - tj * v.width) * (v.x_stride_bits // 8))
        t = ti * layout.tile_cols + tj

        def byte(o):
            return np.where(o < s, tiles[t, np.minimum(o, s - 1)], 0) \
                .astype(np.int64)

        val = byte(off) if v.depth == 8 else (byte(off) << 8) | byte(off + 1)
        out[v.channel] = val.astype(np.uint8 if v.depth == 8 else np.uint16)
    return out


@pytest.mark.parametrize("name", ["comp420_8_tiled", "comp_rgb16_tiled",
                                  "pixel_rgba16_tiled", "row_rgb8_tiled",
                                  "pixel_padded_size"])
def test_strided_kernel_addressing(name):
    case = CASES[name]()
    _, pdec = _decoders(case)
    tiles = kernels.assemble_tile_buffers(
        pdec.layout, pdec._uncompressed_payload(case["data"]))
    got = cuda_fast.fused_strided_decode(pdec.layout, torch.from_numpy(tiles))
    emu = _emulate_strided_kernel(pdec.layout, tiles)
    for ch in emu:
        np.testing.assert_array_equal(got[ch].numpy(), emu[ch], err_msg=ch)


def test_strided_short_last_row_reads_zero():
    """A view whose last row ends past the tile payload reads zeros
    there, not the buffer's padding bytes."""
    from libheif_tpu_torch.codecs.unc.layout import (ComponentView,
                                                     UncLayout)
    v = ComponentView(comp_index=0, channel=Channel.Y, depth=8, width=4,
                      height=3, base_bits=0, row_stride_bits=6 * 8,
                      x_stride_bits=8, read_bits=8, mask=0xFF)
    lay = UncLayout(width=4, height=3, tile_cols=1, tile_rows=1,
                    tile_width=4, tile_height=3, views=[v],
                    tile_size_bytes=14)
    tiles = np.full((1, 14 + 8), 0xAB, dtype=np.uint8)
    tiles[0, :14] = np.arange(1, 15)
    got = cuda_fast.fused_strided_decode(lay, torch.from_numpy(tiles))
    expect = np.array([[1, 2, 3, 4], [7, 8, 9, 10], [13, 14, 0, 0]],
                      dtype=np.uint8)
    np.testing.assert_array_equal(got[Channel.Y].numpy(), expect)
    np.testing.assert_array_equal(_emulate_strided_kernel(lay, tiles)[
        Channel.Y], expect)


@pytest.mark.parametrize("raw", [
    b"\x00\x00\x00\x0czzzz\x01\x02\x03\x04",
    b"\x00\x00\x00\x11cmpC\x00\x00\x00\x00zlib\x09",
    b"\x00\x00\x00\x10uncC\x01\x00\x00\x00yuv2",
], ids=["unknown", "parse_error", "uncC_v1"])
def test_box_reader_matches_jax(raw):
    """Unknown boxes pass through, a payload that fails to parse becomes
    a Box_Error, and both round-trip as in the JAX package."""
    from libheif_tpu.boxes.box import read_all_boxes as jread_all_boxes
    jb, pb = jread_all_boxes(raw), read_all_boxes(raw)
    assert [type(b).__name__ for b in pb] == [type(b).__name__ for b in jb]
    assert b"".join(b.serialize() for b in pb) == raw
