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


# csrc/unc_kernels.cu: threads of a block, units of a thread per item,
# output bytes of a unit
K_THREADS, K_UNITS, K_UNIT = 256, 8, 16


def _kernel_views(layout):
    """The view table that launch_strided_extract_paste builds: per
    non-empty view its unit slots per tile row (1 << lg),
    whole units per row, bands per tile and first work item; and the item
    count."""
    table, items = [], 0
    for v in layout.views:
        bps, xs = v.depth // 8, v.x_stride_bits // 8
        if not (v.width and v.height and layout.num_tiles):
            continue
        row_bytes = v.width * bps
        lg = 0
        while (1 << lg) * K_UNIT < row_bytes:
            lg += 1
        bands = -(-(v.height << lg) // (K_THREADS * K_UNITS))
        table.append(dict(view=v, bps=bps, base=v.base_bits // 8,
                          rs=v.row_stride_bits // 8, xs=xs,
                          row_bytes=row_bytes, full=row_bytes // K_UNIT,
                          lg=lg, bands=bands,
                          first=items))
        items += layout.num_tiles * bands
    return table, items


def _host_widths(layout, pitch, address):
    """The (load, store) widths the host picks (output planes as the
    CPU allocator aligns them)."""
    views = list(cuda_fast.strided_views(layout, CPU).values())
    return (cuda_fast.strided_load_width(pitch, address, views),
            cuda_fast.strided_store_width(views))


def _emulate_strided_kernel(layout, tiles, widths=None, address=0):
    """The strided_extract_paste kernel (csrc/unc_kernels.cu) replayed in
    numpy: its work items (view, tile, band of kThreads x kUnits unit
    slots), the slot → (row, unit) split by shift and mask, the whole
    units (16 output bytes stored in pieces of the store width;
    contiguous views loaded in pieces of the load width, 16-bit samples
    byte-swapped; pixel interleave gathered sample by sample) and the
    scalar path for a row's partial last unit and units that run past
    the tile size.
    Asserts that every vector access is aligned to its width (tile
    buffers at ``address``, output planes at 0) and that no load reaches
    a byte at or past the tile size."""
    S = layout.tile_size_bytes
    pitch = tiles.shape[1]
    load, store = widths or _host_widths(layout, pitch, address)
    table, items = _kernel_views(layout)
    planes = {e["view"].channel: np.full(
        (layout.tile_rows * e["view"].height,
         layout.tile_cols * e["row_bytes"]), 0xEE, np.uint8) for e in table}
    slots = (np.arange(K_UNITS)[:, None] * K_THREADS
             + np.arange(K_THREADS)[None, :]).ravel()

    def sample(t, off, bps):       # the scalar path's sample_at
        hi = int(tiles[t, off]) if off < S else 0
        if bps == 1:
            return [hi]
        lo = int(tiles[t, off + 1]) if off + 1 < S else 0
        return [lo, hi]            # little-endian uint16 in the plane

    for item in range(items):
        e = [e for e in table if e["first"] <= item][-1]
        v, bps, lg = e["view"], e["bps"], e["lg"]
        t, band = divmod(item - e["first"], e["bands"])
        ti, tj = divmod(t, layout.tile_cols)
        out = planes[v.channel]
        contiguous = e["xs"] == bps
        per = K_UNIT // bps
        for s in band * K_THREADS * K_UNITS + slots:
            r, c = s >> lg, s & ((1 << lg) - 1)
            if r >= v.height or c * K_UNIT >= e["row_bytes"]:
                continue
            step = bps if contiguous else e["xs"]
            off = e["base"] + r * e["rs"] + c * per * step
            y, x = ti * v.height + r, tj * e["row_bytes"] + c * K_UNIT
            if c < e["full"] and off + (per - 1) * step + bps <= S:
                if contiguous:
                    assert off + K_UNIT <= S
                    for p in range(0, K_UNIT, load):
                        assert (address + t * pitch + off + p) % load == 0
                    b = tiles[t, off:off + K_UNIT].copy()
                    if bps == 2:
                        b = b.reshape(-1, 2)[:, ::-1].ravel()
                else:
                    b = np.array([byte for j in range(per) for byte in
                                  sample(t, off + j * step, bps)], np.uint8)
                for p in range(0, K_UNIT, store):
                    assert (y * out.shape[1] + x + p) % store == 0
                out[y, x:x + K_UNIT] = b
            else:
                n = min(per, v.width - c * per)
                out[y, x:x + n * bps] = [
                    byte for j in range(n)
                    for byte in sample(t, off + j * step, bps)]
    return {e["view"].channel: planes[e["view"].channel] if e["bps"] == 1
            else planes[e["view"].channel].view("<u2").astype(np.uint16)
            for e in table}


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


# ------------------------------------------- (d) the payload read in place

def _payload_and_decoders(name):
    case = CASES[name]()
    jdec, pdec = _decoders(case)
    return case, jdec, pdec, pdec._uncompressed_payload(case["data"])


@pytest.mark.parametrize("name", list(CASES))
def test_strided_in_place_matches_jax(name):
    """The payload viewed in place as (T, S) tiles decodes through the
    strided path (plain version) exactly like the JAX package's
    fused_strided_decode (interpret mode) on the assembled buffers, and
    like the port's own padded decode; the layouts the gate declines
    stay declined."""
    case, jdec, pdec, payload = _payload_and_decoders(name)
    lay = pdec.layout
    if lay.comp_tile_sizes is not None:
        with pytest.raises(ValueError):
            kernels.payload_tiles(lay, payload, CPU)
        assert cuda_fast.fused_strided_decode(lay, torch.from_numpy(
            kernels.assemble_tile_buffers(lay, payload))) is None
        return
    inplace = kernels.payload_tiles(lay, payload, CPU)
    assert inplace.shape == (lay.num_tiles, lay.tile_size_bytes)
    got = cuda_fast.fused_strided_decode(lay, inplace)
    jtiles = jkernels.assemble_tile_buffers(jdec.layout, payload)
    ref = pallas_fast.fused_strided_decode(jdec.layout, jtiles,
                                           interpret=True)
    if ref is None:
        assert got is None and not cuda_fast._strided_gate(lay)
        return
    padded = cuda_fast.fused_strided_decode(lay, torch.from_numpy(
        kernels.assemble_tile_buffers(lay, payload)))
    assert set(got) == set(ref) == set(padded)
    for ch in ref:
        np.testing.assert_array_equal(got[ch].numpy(), np.asarray(ref[ch]),
                                      err_msg=ch)
        np.testing.assert_array_equal(got[ch].numpy(), padded[ch].numpy(),
                                      err_msg=ch)


def test_strided_short_last_row_in_place_reads_zero():
    """Two tiles at pitch S, the view's last row ending past S: the bytes
    past S read as zero -- not the next tile's first bytes, and not past
    the end of the payload after the last tile."""
    from libheif_tpu_torch.codecs.unc.layout import (ComponentView,
                                                     UncLayout)
    v = ComponentView(comp_index=0, channel=Channel.Y, depth=8, width=4,
                      height=3, base_bits=0, row_stride_bits=6 * 8,
                      x_stride_bits=8, read_bits=8, mask=0xFF)
    lay = UncLayout(width=8, height=3, tile_cols=2, tile_rows=1,
                    tile_width=4, tile_height=3, views=[v],
                    tile_size_bytes=14)
    tiles = kernels.payload_tiles(lay, bytes(range(1, 29)), CPU)
    assert tiles.shape == (2, 14)
    expect = np.array([[1, 2, 3, 4, 15, 16, 17, 18],
                       [7, 8, 9, 10, 21, 22, 23, 24],
                       [13, 14, 0, 0, 27, 28, 0, 0]], dtype=np.uint8)
    got = cuda_fast.fused_strided_decode(lay, tiles)
    np.testing.assert_array_equal(got[Channel.Y].numpy(), expect)
    for widths in (None, (1, 1), (1, 4)):
        np.testing.assert_array_equal(_emulate_strided_kernel(
            lay, tiles.numpy(), widths)[Channel.Y], expect)


REPLAY_LAYOUTS = ["comp420_8_tiled", "comp_rgb16_tiled", "pixel_rgba16_tiled",
                  "row_rgb8_tiled", "pixel_padded_size"]


@pytest.mark.parametrize("store", [16, 8, 4, 1])
@pytest.mark.parametrize("load", [16, 8, 4, 1])
@pytest.mark.parametrize("name", REPLAY_LAYOUTS)
def test_strided_kernel_replay_widths(name, load, store):
    """The kernel's replay at every forced (load, store) width, on the
    payload read in place (pitch S, a multiple of 16 for these layouts),
    equals the plain version."""
    _, _, pdec, payload = _payload_and_decoders(name)
    lay = pdec.layout
    tiles = kernels.payload_tiles(lay, payload, CPU)
    assert _host_widths(lay, tiles.shape[1], 0) == (16, 16)
    ref = cuda_fast.fused_strided_decode(lay, tiles)
    emu = _emulate_strided_kernel(lay, tiles.numpy(), (load, store))
    assert set(emu) == set(ref)
    for ch in ref:
        np.testing.assert_array_equal(emu[ch], ref[ch].numpy(), err_msg=ch)


def _sv(out, base, rs, xs, bps, h, w):
    return cuda_fast.StridedView(out, base, rs, xs, bps, h, w)


@pytest.mark.parametrize("case", [
    ("flagship at pitch S", 393216, 0, [(0, 512, 1, 1, 512, 512),
                                        (262144, 256, 1, 1, 256, 256),
                                        (327680, 256, 1, 1, 256, 256)],
     (16, 16)),
    ("flagship at pitch S+8", 393224, 0, [(0, 512, 1, 1, 512, 512),
                                          (262144, 256, 1, 1, 256, 256)],
     (8, 16)),
    ("odd address", 393216, 1, [(0, 512, 1, 1, 512, 512)], (1, 16)),
    ("pixel rgb8: bases and strides load bytes", 1536 * 512, 0,
     [(0, 1536, 3, 1, 512, 512), (1, 1536, 3, 1, 512, 512)], (16, 16)),
    ("contiguous base 4", 4096, 0, [(4, 64, 1, 1, 8, 64)], (4, 16)),
    ("16-bit rows of 27 samples", 162 * 9, 0, [(0, 162, 2, 2, 9, 27)],
     (1, 1)),
    ("rows of 24 bytes", 1024, 0, [(0, 24, 1, 1, 16, 24)], (8, 8))],
    ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_strided_width_choice(case):
    """Load and store widths are chosen apart: loads from the pitch,
    address and the contiguous views' bases and row strides; stores
    from each view's output row bytes and plane address."""
    _, pitch, address, views, want = case
    svs = [_sv(torch.empty(8 * w * bps, dtype=torch.uint8), *v)
           for v in views for w, bps in [(v[5], v[3])]]
    assert (cuda_fast.strided_load_width(pitch, 0x7f0000000000 + address,
                                         svs),
            cuda_fast.strided_store_width(svs)) == want


def test_strided_store_width_follows_the_plane_address():
    out = torch.empty(64, dtype=torch.uint8)
    assert cuda_fast.strided_store_width([_sv(out, 0, 16, 1, 1, 2, 16)]) == 16
    assert cuda_fast.strided_store_width([_sv(out[4:], 0, 16, 1, 1, 2, 16)]) \
        == 4


def test_payload_tiles_reads_in_place():
    """payload_tiles: the first T*S bytes as (T, S), no warning about the
    read-only payload, a tensor of its own, and the short-payload error
    of assemble_tile_buffers."""
    import warnings
    from libheif_tpu_torch.core.error import HeifError
    _, _, pdec, payload = _payload_and_decoders("comp420_8_tiled")
    lay = pdec.layout
    T, S = lay.num_tiles, lay.tile_size_bytes
    snapshot = bytearray(payload)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tiles = kernels.payload_tiles(lay, payload + b"tail", CPU)
    np.testing.assert_array_equal(
        tiles.numpy(), np.frombuffer(payload, np.uint8, T * S).reshape(T, S))
    np.testing.assert_array_equal(
        tiles.numpy(), kernels.assemble_tile_buffers(lay, payload)[:, :S])
    tiles.zero_()
    assert payload == snapshot
    with pytest.raises(HeifError):
        kernels.payload_tiles(lay, payload[:-1], CPU)


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
