"""Tile-parallel decode: device meshes (mesh), the sharded unci pipeline
(grid_decode), batched and sharded decode of coded grid tiles
(coded_grid) and per-host byte-range decode (host_sharding)."""

from .mesh import make_mesh, tile_sharding
from .grid_decode import sharded_unci_decode, build_sharded_pipeline

__all__ = ["make_mesh", "tile_sharding", "sharded_unci_decode",
           "build_sharded_pipeline"]
