"""The PyTorch port's per-host byte-range decode
(libheif_tpu_torch/parallel/host_sharding.py) against the JAX package,
on the CPU: the tile byte ranges from the iloc and tili offset tables,
the per-host chunks, the shard reader's refusals, and the per-host
fetch and parse followed by the sharded device reconstruction, equal to
the context's decode and to the JAX function's tile planes bit for bit.
JAX runs on the 8 virtual CPU devices of tests/conftest.py, the port on
virtual meshes of the CPU.
"""

import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from libheif_tpu.context import HeifContext as JHeifContext  # noqa: E402
from libheif_tpu.file import HeifFile as JHeifFile  # noqa: E402
from libheif_tpu.image.pixel_image import (  # noqa: E402
    PixelImage as JPixelImage, Colorspace, Chroma, Channel)
from libheif_tpu.parallel import host_sharding as jhs  # noqa: E402
from libheif_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402

from libheif_tpu_torch import HeifContext  # noqa: E402
from libheif_tpu_torch.codecs.hevc.decoder import (  # noqa: E402
    crop_to_conformance)
from libheif_tpu_torch.file import HeifFile  # noqa: E402
from libheif_tpu_torch.parallel import host_sharding as hs  # noqa: E402
from libheif_tpu_torch.parallel import make_mesh  # noqa: E402
from tests import jax_native  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def grid_file(tmp_path_factory):
    """A 12-tile hvc1 grid (4x3 tiles of 64x64) written by the JAX
    package's heif_enc, as tests/test_host_sharding.py writes it."""
    jax_native.ensure_loaded()
    sys.path.insert(0, "tools")
    import heif_enc
    from libheif_tpu import io as hio
    d = tmp_path_factory.mktemp("torch_hostshard")
    yy, xx = np.mgrid[0:192, 0:256]
    arr = np.dstack([(xx * 3) % 256, (yy * 5) % 256,
                     ((xx + yy) // 2) % 256]).astype(np.uint8)
    p = d / "in.png"
    p.write_bytes(hio.write_png(arr))
    out = str(d / "g.heic")
    assert heif_enc.main([str(p), "-o", out, "--cut-tiles", "64",
                          "-c", "hevc", "-q", "60"]) == 0
    return out


def test_tile_ranges_cover_coded_data(grid_file):
    hf = HeifFile.from_file(grid_file)
    ranges = hs.grid_tile_ranges(hf, hf.primary_item_id)
    jhf = JHeifFile.from_file(grid_file)
    assert [tuple(vars(r).values()) for r in ranges] == \
        [tuple(vars(r).values())
         for r in jhs.grid_tile_ranges(jhf, jhf.primary_item_id)]
    assert len(ranges) == 12
    raw = open(grid_file, "rb").read()
    for r in ranges:
        assert raw[r.offset:r.offset + r.size] == bytes(
            hf.get_item_data(r.item_id))


def test_grid_without_tiles_has_no_ranges(grid_file):
    hf = HeifFile.from_file(grid_file)
    first_tile = hf.get_references_from(hf.primary_item_id,
                                        "dimg")[0].to_item_ids[0]
    assert hs.grid_tile_ranges(hf, first_tile) == []


def _tili_blob():
    """A 2x2 tili of 64x48 hvc1 tiles written by the JAX package."""
    ctx = JHeifContext()
    tid = ctx.add_tiled_image(128, 96, 64, 48, fmt="hevc")
    rng = np.random.default_rng(7)
    for ty in range(2):
        for tx in range(2):
            img = JPixelImage(64, 48, Colorspace.YCbCr, Chroma.C420)
            for ch, (w, h) in ((Channel.Y, (64, 48)), (Channel.Cb, (32, 24)),
                               (Channel.Cr, (32, 24))):
                img.set_plane(ch, rng.integers(0, 256, (h, w),
                                               dtype=np.uint8), 8)
            ctx.add_image_tile_to_tiled(tid, tx, ty, img)
    return ctx.write()


def test_tili_tile_ranges_match_jax(tmp_path):
    jax_native.ensure_loaded()
    blob = _tili_blob()
    ctx = HeifContext.read_from_bytes(blob, device=CPU)
    item = ctx.get_item(ctx.primary_item_id)
    table = item._get_header()
    table.read_full(ctx.file, item.item_id)
    jctx = JHeifContext.read_from_bytes(blob)
    jitem = jctx.get_item(jctx.primary_item_id)
    jtable = jitem._get_header()
    jtable.read_full(jctx.file, jitem.item_id)
    got = hs.tili_tile_ranges(table)
    assert [tuple(vars(r).values()) for r in got] == \
        [tuple(vars(r).values()) for r in jhs.tili_tile_ranges(jtable)]
    assert len(got) == 4 and all(r.size > 0 for r in got)
    assert len({r.offset for r in got}) == 4


@pytest.mark.parametrize("n_hosts", range(1, 10))
@pytest.mark.parametrize("n_tiles", [0, 1, 3, 10, 12, 13, 48])
def test_shard_tiles_match_jax(n_tiles, n_hosts):
    shards = hs.shard_tiles(n_tiles, n_hosts)
    assert shards == jhs.shard_tiles(n_tiles, n_hosts)
    assert len(shards) == n_hosts
    assert [i for s in shards for i in s] == list(range(n_tiles))


def test_reader_rejects_out_of_shard(grid_file):
    hf = HeifFile.from_file(grid_file)
    ranges = hs.grid_tile_ranges(hf, hf.primary_item_id)
    reader = hs.HostShardReader(grid_file, ranges[:3])
    fetched = reader.fetch_all()
    assert sorted(fetched) == [0, 1, 2]
    assert reader.tile_bytes(1) == bytes(hf.get_item_data(ranges[1].item_id))
    with pytest.raises(KeyError):
        reader.tile_bytes(5)


def test_reader_short_read_raises(grid_file, tmp_path):
    hf = HeifFile.from_file(grid_file)
    last = hs.grid_tile_ranges(hf, hf.primary_item_id)[-1]
    cut = tmp_path / "cut.heic"
    cut.write_bytes(open(grid_file, "rb").read()[:last.offset + 1])
    with pytest.raises(EOFError):
        hs.HostShardReader(str(cut), [last]).fetch_all()


def test_non_grid_primary_raises(tmp_path):
    jax_native.ensure_loaded()
    path = tmp_path / "tili.heic"
    path.write_bytes(_tili_blob())
    with pytest.raises(ValueError):
        hs.decode_grid_host_sharded(str(path), 2, device=CPU)


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_host_sharded_decode_matches_context_and_jax(grid_file, n_hosts,
                                                     monkeypatch):
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    planes, grid, sps = hs.decode_grid_host_sharded(
        grid_file, n_hosts=n_hosts, mesh=make_mesh(n_hosts, device=CPU))
    assert len(planes) == 12 and (grid.rows, grid.columns) == (3, 4)
    jplanes, jgrid, _ = jhs.decode_grid_host_sharded(
        grid_file, n_hosts=n_hosts, mesh=jmake_mesh(n_hosts))
    assert (jgrid.rows, jgrid.columns) == (grid.rows, grid.columns)
    for got, ref in zip(planes, jplanes):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    ctx = HeifContext.read_from_file(grid_file, device=CPU)
    whole = ctx.decode_image(None)
    tw, th = sps.cropped_size
    gw, gh = grid.output_width, grid.output_height
    for ch, sub in ((Channel.Y, 1), (Channel.Cb, 2), (Channel.Cr, 2)):
        out = np.zeros(((gh + sub - 1) // sub, (gw + sub - 1) // sub),
                       np.int32)
        for idx, pl in enumerate(planes):
            ty, tx = divmod(idx, grid.columns)
            p = crop_to_conformance(sps, *pl)[[Channel.Y, Channel.Cb,
                                               Channel.Cr].index(ch)]
            y0, x0 = ty * th // sub, tx * tw // sub
            h = min(p.shape[0], out.shape[0] - y0)
            w = min(p.shape[1], out.shape[1] - x0)
            out[y0:y0 + h, x0:x0 + w] = p[:h, :w].numpy()
        np.testing.assert_array_equal(out, whole.np_plane(ch), err_msg=ch)
