"""The PyTorch port's tile-parallel decode (libheif_tpu_torch/parallel:
mesh, grid_decode, coded_grid's mesh path) against the JAX package, on
the CPU.

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port
runs on virtual meshes of the CPU (``make_mesh(n, device="cpu")``).
Unci items are built in the test: through the JAX package's UnciEncoder
(component interleave, 8 and 16 bits) and, for the layouts it does not
write, from JAX boxes built field by field with seeded random payloads.
Plane decodes are integer programs and must agree bit for bit; the
sharded pipeline's RGB conversion is held to the JAX pipeline's within
the colour contract (1 LSB on fewer than 1% of samples).
"""

import functools
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.boxes.unc import (  # noqa: E402
    Box_uncC as JBox_uncC, Box_cmpd as JBox_cmpd, CmpdComponent as JCmpd,
    UncCComponent as JUncCComp, InterleaveMode, SamplingMode)
from libheif_tpu.codecs.unc.codec import (  # noqa: E402
    UnciDecoder as JUnciDecoder, UnciEncoder)
from libheif_tpu.codecs.unc.layout import (  # noqa: E402
    compute_layout as jcompute_layout)
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Colorspace, Chroma, Channel, subsampled_size)
from libheif_tpu.items.item import (  # noqa: E402
    DecodingOptions as JDecodingOptions)
from libheif_tpu.parallel import grid_decode as jgrid_decode  # noqa: E402
from libheif_tpu.parallel import mesh as jmesh  # noqa: E402
from libheif_tpu.parallel.host_sharding import (  # noqa: E402
    shard_tiles as jshard_tiles)

from libheif_tpu_torch import DecodingOptions, HeifContext  # noqa: E402
from libheif_tpu_torch.boxes import read_all_boxes  # noqa: E402
from libheif_tpu_torch.boxes.unc import Box_uncC, Box_cmpd  # noqa: E402
from libheif_tpu_torch.codecs.unc import UnciDecoder, kernels  # noqa: E402
from libheif_tpu_torch.parallel import (  # noqa: E402
    build_sharded_pipeline, coded_grid, make_mesh, sharded_unci_decode,
    tile_sharding)
from libheif_tpu_torch.parallel.mesh import chunk_bounds  # noqa: E402
from tests import jax_native  # noqa: E402

CPU = "cpu"
YCC = [Channel.Y, Channel.Cb, Channel.Cr]
RGB = [Channel.R, Channel.G, Channel.B]


# ----------------------------------------------------------------- the mesh

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n):
    """1D and balanced 2D shapes, and a 2D mesh's chunks along its first
    axis equal to JAX's NamedSharding over the same axis."""
    assert make_mesh(n, device=CPU).shape == jmesh.make_mesh(n).devices.shape
    m2 = make_mesh(n, axis_names=("a", "b"), device=CPU)
    j2 = jmesh.make_mesh(n, axis_names=("a", "b"))
    assert m2.shape == j2.devices.shape and m2.size == n
    assert m2.axis_names == ("a", "b")
    t = 3 * m2.shape[0]
    idx = jmesh.tile_sharding(j2, "a").devices_indices_map((t,))
    want = [(idx[d][0].start or 0, idx[d][0].stop or t)
            for d in j2.devices.flat]
    assert tile_sharding(m2, "a").chunks(t) == want


def test_make_mesh_refusals():
    with pytest.raises(ValueError):
        make_mesh(8, axis_names=("a", "b", "c"), device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


@pytest.mark.parametrize("d", range(1, 10))
@pytest.mark.parametrize("t", range(21))
def test_tile_sharding_chunks_match_jax(t, d):
    """Each member's chunk of T tiles: JAX's chunked NamedSharding where
    it exists (d divides T, d <= 8 devices), and JAX's shard_tiles (the
    same ceil chunks, defined for every T and d)."""
    chunks = tile_sharding(make_mesh(d, device=CPU)).chunks(t)
    assert chunks == chunk_bounds(t, d)
    assert [list(range(lo, hi)) for lo, hi in chunks] == jshard_tiles(t, d)
    if d <= 8 and t % d == 0:
        sh = jmesh.tile_sharding(jmesh.make_mesh(d))
        idx = sh.devices_indices_map((t,))
        assert chunks == [(idx[dev][0].start or 0,
                           t if idx[dev][0].stop is None else
                           idx[dev][0].stop)
                          for dev in sh.mesh.devices.flat]


# --------------------------------------------------------------- unci items

def _encoded(w, h, colorspace, chroma, depth, channels, tiles):
    """Seeded random planes through the JAX package's UnciEncoder."""
    rng = np.random.default_rng(w * 1000 + h + depth + tiles[1])
    img = JPixelImage(w, h, colorspace, chroma)
    dt = np.uint8 if depth <= 8 else np.uint16
    for ch in channels:
        pw, ph = subsampled_size(w, h, ch, chroma)
        img.set_plane(ch, rng.integers(0, 1 << depth, (ph, pw), dtype=dt),
                      depth)
    data, cmpd, uncC, _, _ = UnciEncoder(tile_cols=tiles[0],
                                         tile_rows=tiles[1]).encode(img)
    return w, h, uncC, cmpd, data


def _hand(w, h, types, comps, tiles, **fields):
    """JAX boxes built field by field, with a seeded random payload of
    the size the JAX layout asks for."""
    uncC = JBox_uncC()
    uncC.components = [JUncCComp(i, d, 0, 0) for i, d in comps]
    uncC.num_tile_cols, uncC.num_tile_rows = tiles
    for k, v in fields.items():
        setattr(uncC, k, v)
    cmpd = JBox_cmpd([JCmpd(t) for t in types])
    size = jcompute_layout(uncC, cmpd, w, h).total_data_size()
    data = np.random.default_rng(size + tiles[1]).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    return w, h, uncC, cmpd, data


def _layouts(rows):
    """Unci items of two tile columns and ``rows`` tile rows of 16x8."""
    w, h, t = 32, 8 * rows, (2, rows)
    return {
        "rgb8": lambda: _encoded(w, h, Colorspace.RGB, Chroma.C444, 8, RGB,
                                 t),
        "abgr8_pixel": lambda: _hand(
            w, h, [7, 6, 5, 4], [(0, 8), (1, 8), (2, 8), (3, 8)], t,
            interleave_type=InterleaveMode.pixel),
        "b16r16g16": lambda: _hand(w, h, [6, 4, 5],
                                   [(0, 16), (1, 16), (2, 16)], t),
        "yuv420_8": lambda: _encoded(w, h, Colorspace.YCbCr, Chroma.C420, 8,
                                     YCC, t),
        # not byte-aligned per tile: the generic program's path
        "tile_component_420": lambda: _hand(
            w, h, [1, 2, 3], [(0, 8), (1, 8), (2, 8)], t,
            sampling_type=SamplingMode.s420,
            interleave_type=InterleaveMode.tile_component,
            tile_align_size=4),
    }


CASES = {f"{name}_{rows}rows": (rows, build)
         for rows in (4, 3) for name, build in _layouts(rows).items()}
CASES["yuv420_16"] = (4, lambda: _encoded(
    32, 32, Colorspace.YCbCr, Chroma.C420, 16, YCC, (2, 4)))


@functools.lru_cache(maxsize=None)
def case(name):
    return CASES[name][1]()


def decoders(name):
    w, h, uncC, cmpd, data = case(name)
    jdec = JUnciDecoder(uncC, cmpd, w, h)
    pb = {type(b): b for b in read_all_boxes(uncC.serialize()
                                             + cmpd.serialize())}
    pdec = UnciDecoder(pb[Box_uncC], pb[Box_cmpd], w, h, device=CPU)
    return jdec, pdec, data


def jax_sharded(jdec, data, n, convert_to_rgb=False):
    """JAX's sharded decode: over make_mesh(n) where n divides the tile
    rows (jit needs even shards), else over its own choice of mesh."""
    mesh = jmesh.make_mesh(n) if jdec.layout.tile_rows % n == 0 else None
    out = jgrid_decode.sharded_unci_decode(jdec, data, mesh=mesh,
                                           convert_to_rgb=convert_to_rgb)
    return {ch: np.asarray(p) for ch, p in out.items()}


def members_with_rows(rows, n):
    return sum(hi > lo for lo, hi in chunk_bounds(rows, n))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", [c for c in CASES if c != "yuv420_16"])
def test_sharded_unci_matches_jax_and_decode(name, n):
    jdec, pdec, data = decoders(name)
    planes = sharded_unci_decode(pdec, data,
                                 mesh=make_mesh(n, device=CPU))
    ref = jax_sharded(jdec, data, n)
    whole = pdec.decode(data)
    rows = pdec.layout.tile_rows
    assert sorted(planes) == sorted(ref)
    for ch, p in planes.items():
        assert len(p.shards) == len(p.devices) == members_with_rows(rows, n)
        got = p.numpy()
        assert got.dtype == ref[ch].dtype, ch
        np.testing.assert_array_equal(got, ref[ch], err_msg=ch)
        # the item's decode clips the planes to the image; these are whole
        dec = whole.np_plane(ch)
        np.testing.assert_array_equal(got[:dec.shape[0], :dec.shape[1]],
                                      dec, err_msg=ch)


@pytest.mark.parametrize("name", ["abgr8_pixel_3rows",
                                  "tile_component_420_4rows"])
def test_pipeline_takes_tile_buffers(name):
    """fn of build_sharded_pipeline takes the (T, S+pad) host tile buffers
    as well as the payload, with the same planes."""
    _, pdec, data = decoders(name)
    lay = pdec.layout
    fn, mesh, sharding = build_sharded_pipeline(lay,
                                                make_mesh(2, device=CPU))
    assert sharding.mesh is mesh
    a = fn(data)
    b = fn(kernels.assemble_tile_buffers(lay, data))
    for ch in a:
        np.testing.assert_array_equal(a[ch].numpy(), b[ch].numpy())


def test_short_payload_raises():
    from libheif_tpu_torch.core.error import HeifError
    _, pdec, data = decoders("rgb8_4rows")
    with pytest.raises(HeifError):
        sharded_unci_decode(pdec, data[:-1], mesh=make_mesh(2, device=CPU))


def test_default_mesh_on_a_device():
    """Without a mesh, ``device`` gives a one-member mesh on it."""
    _, pdec, data = decoders("yuv420_8_3rows")
    planes = sharded_unci_decode(pdec, data, device=CPU)
    whole = pdec.decode(data)
    for ch, p in planes.items():
        assert len(p.shards) == 1
        np.testing.assert_array_equal(p.numpy(), whole.np_plane(ch))


def test_2d_mesh_decodes_each_chunk_once():
    """On a (2, 2) mesh the tile rows split along the first axis; each
    chunk decodes once, on the first member holding it."""
    _, pdec, data = decoders("yuv420_8_4rows")
    planes = sharded_unci_decode(pdec, data, mesh=make_mesh(
        4, axis_names=("rows", "cols"), device=CPU))
    whole = pdec.decode(data)
    for ch, p in planes.items():
        assert len(p.shards) == 2 and p.shards[0].shape[0] == \
            p.shards[1].shape[0]
        np.testing.assert_array_equal(p.numpy(), whole.np_plane(ch))


def test_default_mesh_takes_the_cards():
    """Without a mesh or a device the decode runs over the cards, and
    without CUDA it raises rather than falling back to the CPU."""
    _, pdec, data = decoders("rgb8_4rows")
    if torch.cuda.is_available():
        planes = sharded_unci_decode(pdec, data)
        whole = pdec.decode(data)
        for ch, p in planes.items():
            assert all(d.type == "cuda" for d in p.devices)
            np.testing.assert_array_equal(p.numpy(), whole.np_plane(ch))
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sharded_unci_decode(pdec, data)


def _assert_colour_contract(got, ref, what):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and (d > 0).sum() < 0.01 * d.size, \
        f"{what}: max {d.max()}, {(d > 0).sum()} of {d.size} differ"


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("name", ["yuv420_8_4rows", "yuv420_8_3rows",
                                  "yuv420_16"])
def test_convert_to_rgb_matches_jax(name, n):
    jdec, pdec, data = decoders(name)
    planes = sharded_unci_decode(pdec, data, mesh=make_mesh(n, device=CPU),
                                 convert_to_rgb=True)
    ref = jax_sharded(jdec, data, n, convert_to_rgb=True)
    assert sorted(planes) == sorted(ref) == ["B", "G", "R"]
    for ch in planes:
        _assert_colour_contract(planes[ch].numpy(), ref[ch], f"{name} {ch}")
    want = np.uint16 if name == "yuv420_16" else np.uint8
    assert planes["R"].numpy().dtype == want


def test_convert_to_rgb_leaves_rgb_items():
    """An item without Y comes back as its planes."""
    _, pdec, data = decoders("rgb8_4rows")
    planes = sharded_unci_decode(pdec, data, mesh=make_mesh(2, device=CPU),
                                 convert_to_rgb=True)
    assert sorted(planes) == ["B", "G", "R"]
    whole = pdec.decode(data)
    for ch, p in planes.items():
        np.testing.assert_array_equal(p.numpy(), whole.np_plane(ch))


# ---------------------------------------------------------------- HEVC grid

@pytest.fixture(scope="module")
def jax_native_library():
    """The JAX encoder and parser run on its native library: load it
    first (tests/jax_native.py)."""
    jax_native.ensure_loaded()


@pytest.fixture(scope="module")
def hevc_grid(tmp_path_factory, jax_native_library):
    """A 12-tile hvc1 grid (4x3 tiles of 64x64) written by the JAX
    package's heif_enc, as tests/test_coded_grid.py writes it."""
    sys.path.insert(0, "tools")
    import heif_enc
    from libheif_tpu import io as hio
    d = tmp_path_factory.mktemp("torch_codedgrid")
    yy, xx = np.mgrid[0:192, 0:256]
    arr = np.dstack([(xx * 3) % 256, (yy * 5) % 256,
                     ((xx + yy) // 2) % 256]).astype(np.uint8)
    p = d / "in.png"
    p.write_bytes(hio.write_png(arr))
    out = d / "g.heic"
    assert heif_enc.main([str(p), "-o", str(out), "--cut-tiles", "64",
                          "-c", "hevc", "-q", "60"]) == 0
    return out.read_bytes()


def _port_decode(blob, options=None):
    return HeifContext.read_from_bytes(blob, device=CPU).decode_image(
        None, options=options)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_hevc_grid_matches_unsharded_and_jax(hevc_grid, n,
                                                     monkeypatch):
    """DecodingOptions(mesh=...) reaches decode_tiles_device: member k
    reconstructs the k-th chunk of ceil(12 / n) tiles (8 members: six
    chunks of two, two empty), and the composed planes equal the
    unsharded decode and JAX's sharded device grid bit for bit."""
    calls = []
    real = coded_grid.decode_pictures_device

    def spy(syntaxes, raw_tus, device=None):
        calls.append(len(syntaxes))
        return real(syntaxes, raw_tus, device)
    monkeypatch.setattr(coded_grid, "decode_pictures_device", spy)
    got = _port_decode(hevc_grid, DecodingOptions(
        mesh=make_mesh(n, device=CPU)))
    assert calls == [hi - lo for lo, hi in chunk_bounds(12, n) if hi > lo]
    calls.clear()
    plain = _port_decode(hevc_grid)
    assert calls == [12]
    jctx = JHeifContext.read_from_bytes(hevc_grid)
    ref = jctx.decode_image(jctx.primary_item_id, options=JDecodingOptions(
        prefer_device_grid=True, mesh=jmesh.make_mesh(n)))
    assert (got.width, got.height) == (ref.width, ref.height) == (256, 192)
    for ch in YCC:
        np.testing.assert_array_equal(got.np_plane(ch), plain.np_plane(ch),
                                      err_msg=f"{n} {ch}")
        np.testing.assert_array_equal(got.np_plane(ch),
                                      np.asarray(ref.plane(ch)),
                                      err_msg=f"{n} {ch}")


def test_decode_tiles_device_keeps_tile_order(hevc_grid):
    """decode_tiles_device over a mesh returns each tile's planes, in
    order, equal to the unsharded batch's."""
    from libheif_tpu_torch.boxes.codec_cfg import Box_hvcC
    from libheif_tpu_torch.file import HeifFile
    hf = HeifFile.from_bytes(hevc_grid)
    ids = hf.get_references_from(hf.primary_item_id, "dimg")[0].to_item_ids
    parsed = [coded_grid.parse_tile(hf.get_property(i, Box_hvcC),
                                    hf.get_item_data(i)) for i in ids]
    syn = [p[1] for p in parsed]
    raw = [p[2] for p in parsed]
    one = coded_grid.decode_tiles_device(syn, raw, device=CPU)
    many = coded_grid.decode_tiles_device(syn, raw,
                                          make_mesh(5, device=CPU))
    assert len(one) == len(many) == 12
    for a, b in zip(one, many):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ------------------------------------------------------- the launch device

def test_launch_restores_the_callers_device(monkeypatch):
    """An entry point sets the launch's card as the thread's device and
    leaves it so (cudaSetDevice); CudaKernel.launch runs it under
    torch.cuda.device, so the caller's current device is the same after
    a launch on another card as before.  Stands in the CUDA runtime's
    per-thread device with a variable."""
    from libheif_tpu_torch import _build
    state = {"device": 0}

    class Device:                      # torch.cuda.device's semantics
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            self.prev, state["device"] = state["device"], self.index

        def __exit__(self, *exc):
            state["device"] = self.prev
            return False

    class Stream:
        cuda_stream = 0

    def entry(*args):
        state["device"] = args[-2]     # the entry point's cudaSetDevice
        return 0

    class Out:
        device = torch.device("cuda", 1)

        def numel(self):
            return 1

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["device"])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda i=None: Stream())
    k = _build.CudaKernel("probe", "launch_probe", [])
    k._fn = entry
    k.launch(Out())
    assert state["device"] == 0 and k.launches == 1
