"""Multi-host input plane: per-host byte-range fetch of coded tiles.

Counterpart of libheif_tpu/parallel/host_sharding.py.  On a deployment
of several hosts, each host should only read the bytes of the tiles its
devices will decode.  This module plans that partition from the
container's own offset tables and drives it end to end:

  1. `grid_tile_ranges` / `tili_tile_ranges` recover each tile's
     (offset, size) byte range from the iloc extents of a `grid` item's
     references, or from a `tili` item's offset table (the reference's
     on-demand table reads: libheif/image-items/tiled.h:127
     get_tile_offsets, tiled.cc:436 get_tile_offset_table_range_to_read);
  2. `shard_tiles` splits the tile list into contiguous per-host chunks
     (host h gets tiles [h*ceil, (h+1)*ceil), clipped: the chunks
     mesh.tile_sharding gives the members of a mesh over the hosts);
  3. `HostShardReader` enforces that a host only touches its own byte
     ranges (reads outside the shard raise: the test double for "the
     bytes were never transferred to this host");
  4. `decode_grid_host_sharded` runs the whole path with the hosts as a
     loop in one process: per-host fetch, per-host entropy decode, then
     the device reconstruction of all tiles, sharded over a mesh
     (coded_grid.decode_tiles_device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..boxes.codec_cfg import Box_hvcC
from ..file import HeifFile
from ..items.derived import ImageGrid
from .coded_grid import decode_tiles_device, parse_tile
from .mesh import DeviceMesh, chunk_bounds


@dataclass(frozen=True)
class TileByteRange:
    """One tile's coded bytes inside the container file."""

    tile_index: int
    item_id: int          # 0 for tili tiles (all share the item)
    offset: int
    size: int


def grid_tile_ranges(hf: HeifFile, grid_item_id: int) -> List[TileByteRange]:
    """Byte ranges of a grid's tile items from their iloc entries.

    Only single-extent, file-offset-addressed tiles qualify (the normal
    layout heif-enc produces); any other tile raises ValueError."""
    refs = hf.get_references_from(grid_item_id, "dimg")
    if not refs:
        return []
    out = []
    for i, tid in enumerate(refs[0].to_item_ids):
        ext = _iloc_single_extent(hf, tid)
        if ext is None:
            raise ValueError(f"tile item {tid} is not single-extent")
        out.append(TileByteRange(i, tid, ext[0], ext[1]))
    return out


def _iloc_single_extent(hf: HeifFile, item_id: int):
    it = hf.iloc.find_item(item_id) if hf.iloc else None
    if it is None or len(it.extents) != 1:
        return None
    if it.construction_method != 0 or it.mdat_relative:
        return None
    ext = it.extents[0]
    return (it.base_offset + ext.offset, ext.length)


def tili_tile_ranges(table) -> List[TileByteRange]:
    """Byte ranges from a tili offset table (items/tiled_item.py
    TiledHeader, read in full); its offsets are absolute file positions
    already."""
    return [TileByteRange(i, 0, table.get_offset(i), table.get_size(i))
            for i in range(table.num_tiles)]


def shard_tiles(n_tiles: int, n_hosts: int) -> List[List[int]]:
    """Contiguous tile-index chunks, one per host: host h gets indices
    [h*ceil, (h+1)*ceil) clipped, ceil = ceil(n_tiles / n_hosts)."""
    return [list(range(lo, hi)) for lo, hi in chunk_bounds(n_tiles, n_hosts)]


class HostShardReader:
    """Byte-range reader for ONE host's shard; any read outside the
    shard's ranges raises (proving no cross-host bytes are needed)."""

    def __init__(self, path: str, ranges: Sequence[TileByteRange]):
        self.path = path
        self.ranges = {r.tile_index: r for r in ranges}
        self._data: Dict[int, bytes] = {}

    def fetch_all(self) -> Dict[int, bytes]:
        """Range-read every tile of this shard (one seek and read each:
        the storage fabric's access pattern)."""
        with open(self.path, "rb") as f:
            for idx, r in self.ranges.items():
                f.seek(r.offset)
                buf = f.read(r.size)
                if len(buf) != r.size:
                    raise EOFError(f"tile {idx}: short read")
                self._data[idx] = buf
        return dict(self._data)

    def tile_bytes(self, tile_index: int) -> bytes:
        if tile_index not in self.ranges:
            raise KeyError(
                f"tile {tile_index} is not in this host's shard")
        if tile_index not in self._data:
            self.fetch_all()
        return self._data[tile_index]


def decode_grid_host_sharded(path: str, n_hosts: int,
                             mesh: Optional[DeviceMesh] = None, device=None):
    """Each of ``n_hosts`` virtual hosts fetches and entropy-decodes only
    its chunk of an hvc1 grid's tiles; then every tile reconstructs on
    the device, sharded over ``mesh`` (on ``device`` without one; None
    means CUDA).  Returns (the uncropped (Y, Cb, Cr) int32 planes of each
    tile, on the device that decoded it; the grid spec; the first tile's
    SPS)."""
    hf = HeifFile.from_file(path)
    pid = hf.primary_item_id
    if hf.get_item_type(pid) != "grid":
        raise ValueError("primary item is not a grid")
    ranges = grid_tile_ranges(hf, pid)
    parsed: List[Optional[tuple]] = [None] * len(ranges)
    # in a deployment each host runs exactly one of these loop bodies
    for tile_idxs in shard_tiles(len(ranges), n_hosts):
        reader = HostShardReader(path, [ranges[i] for i in tile_idxs])
        reader.fetch_all()
        for i in tile_idxs:
            cfg = hf.get_property(ranges[i].item_id, Box_hvcC)
            parsed[i] = parse_tile(cfg, reader.tile_bytes(i))
    planes = decode_tiles_device([p[1] for p in parsed],
                                 [p[2] for p in parsed], mesh, device)
    grid = ImageGrid.parse(bytes(hf.get_item_data(pid)))
    return planes, grid, parsed[0][0]
