"""Mesh-sharded unci decode (the tile-parallel path).

Counterpart of libheif_tpu/parallel/grid_decode.py, the analog of the
reference's parallel grid decode (reference: grid.cc:285-453).  The JAX
package runs the tile batch as one jit program with the tile axis
sharded over the mesh and the planes sharded by rows.  Here each member
of the mesh takes whole tile rows (ceil(rows / members) each, the last
members fewer or none), so its output rows are contiguous, and decodes
them on its own device:

* its tiles go to its device as they lie in the payload
  (kernels.payload_tiles rows) where the layout is byte-aligned, and as
  rows of the padded host buffers (kernels.assemble_tile_buffers)
  otherwise;
* byte-aligned layouts decode in one strided_extract_paste launch per
  member (cuda_fast.fused_strided_decode), the other layouts through
  kernels.decode_tiles, as UnciDecoder.decode does;
* every member's copy and launches are issued before anything is read
  back, so members on different cards overlap; the members of a virtual
  mesh share their device's current stream.

``convert_to_rgb`` computes the JAX pipeline's own conversion
(grid_decode.py:39-61), not ops.YCbCrToRGB: matrix 6 and full range
always, nearest chroma upsampling by repetition, G as
(y - kr*r - kb*b) / (1 - kr - kb) in f32, round half to even, clip, then
uint8 at 8 bits and uint16 above.  At 8 bits that is the
planes_ycbcr8_to_rgb kernel's arithmetic in its nearest, full-range mode
(the same f32 constants, operations and rounding; an exact 2x or 1x
nearest tap is the repetition), so 8-bit planes go through
cuda_fast.ycbcr8_planes_to_rgb, one launch per member on the card.  The
kernel's offset is 128 and its clip 255, so deeper planes run the
formula in plain torch on the member's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .._build import resolve_device
from ..codecs.unc import cuda_fast, kernels
from ..codecs.unc.layout import UncLayout
from ..color.nclx import get_kr_kb
from ..core.error import HeifError
from .mesh import DeviceMesh, TileSharding, make_mesh, tile_sharding


class ShardedPlane:
    """A plane split by rows over a mesh: the counterpart of a row-sharded
    ``jax.Array``.  ``shards`` are the row blocks in mesh order, one for
    each member that had tile rows, each on that member's device
    (``devices``)."""

    def __init__(self, shards: List[torch.Tensor],
                 devices: List[torch.device]):
        self.shards = shards
        self.devices = devices

    def gather(self, device=None) -> torch.Tensor:
        """The whole plane on ``device`` (the first shard's by default)."""
        dev = self.devices[0] if device is None else torch.device(device)
        return torch.cat([s.to(dev) for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()


def _rows_layout(layout: UncLayout, rows: int) -> UncLayout:
    """The layout of ``rows`` whole tile rows of ``layout``."""
    return dataclasses.replace(layout, tile_rows=rows,
                               height=rows * layout.tile_height)


def _to_rgb(planes: Dict[str, torch.Tensor],
            bits: int) -> Dict[str, torch.Tensor]:
    """grid_decode.py:39-61 on one member's planes."""
    kr, kb = get_kr_kb(6)
    y, cb, cr = planes["Y"], planes["Cb"], planes["Cr"]
    if bits == 8 and all(p.dtype == torch.uint8 for p in (y, cb, cr)):
        rgb = cuda_fast.ycbcr8_planes_to_rgb(
            y.contiguous(), cb.contiguous(), cr.contiguous(), kr=kr, kb=kb,
            full_range=True, upsampling=cuda_fast.NEAREST)
        return {"R": rgb[0], "G": rgb[1], "B": rgb[2]}
    half = float(1 << (bits - 1))
    maxval = (1 << bits) - 1
    yf, cbf, crf = y.float(), cb.float(), cr.float()
    h, w = yf.shape
    if cbf.shape != yf.shape:           # nearest upsampling by repetition
        ry, rx = h // cbf.shape[0], w // cbf.shape[1]
        cbf = cbf.repeat_interleave(ry, 0).repeat_interleave(rx, 1)
        crf = crf.repeat_interleave(ry, 0).repeat_interleave(rx, 1)
    r = yf + 2 * (1 - kr) * (crf - half)
    b = yf + 2 * (1 - kb) * (cbf - half)
    g = cuda_fast.true_div(yf - kr * r - kb * b, 1 - kr - kb)
    out = torch.uint8 if bits <= 8 else torch.uint16
    return {ch: torch.clamp(torch.round(v), 0, maxval).to(torch.int32)
            .to(out) for ch, v in (("R", r), ("G", g), ("B", b))}


def build_sharded_pipeline(layout: UncLayout,
                           mesh: Optional[DeviceMesh] = None,
                           convert_to_rgb: bool = False):
    """``(fn, mesh, sharding)``: ``fn(tiles)`` decodes the item with its
    tile rows sharded over ``mesh`` (every card by default) and returns
    dict channel -> ShardedPlane.  ``tiles`` is the uncompressed payload
    (bytes-like), or the (T, >= S) uint8 tile buffers (numpy or a CPU
    tensor) in row-major tile order.  On a 2D mesh the rows split along
    its first axis; the members along the second would hold copies, so
    each chunk decodes once, on the first member holding it."""
    if mesh is None:
        mesh = make_mesh()
    sharding: TileSharding = tile_sharding(mesh, mesh.axis_names[0])
    strided = cuda_fast._strided_gate(layout)
    cols, size = layout.tile_cols, layout.tile_size_bytes
    bits = layout.views[0].depth
    work, seen = [], set()
    for dev, (r0, r1) in zip(mesh.members(),
                             sharding.chunks(layout.tile_rows)):
        if r1 > r0 and (r0, r1) not in seen:
            seen.add((r0, r1))
            work.append((dev, r0, _rows_layout(layout, r1 - r0)))

    def fn(tiles) -> Dict[str, ShardedPlane]:
        host = None
        if isinstance(tiles, (np.ndarray, torch.Tensor)):
            host = torch.as_tensor(tiles)
            if host.dim() != 2 or host.shape[0] != layout.num_tiles:
                raise ValueError(f"tiles has shape {tuple(host.shape)}, "
                                 f"need ({layout.num_tiles}, >= {size})")
        elif strided:
            tiles = memoryview(tiles).cast("B")
            if len(tiles) < layout.num_tiles * size:
                raise HeifError.eof(
                    f"unci data too short: have {len(tiles)}, need "
                    f"{layout.num_tiles * size}")
        else:
            host = torch.from_numpy(
                kernels.assemble_tile_buffers(layout, tiles))
        shards: Dict[str, List[torch.Tensor]] = {}
        for dev, r0, sub in work:
            t0 = r0 * cols
            if host is None:
                t = kernels.payload_tiles(sub, tiles[t0 * size:], dev)
            else:
                t = host[t0:t0 + sub.num_tiles].to(dev)
            planes = cuda_fast.fused_strided_decode(sub, t) if strided \
                else kernels.decode_tiles(sub, t, dev)
            if convert_to_rgb and "Y" in planes:
                planes = _to_rgb(planes, bits)
            for ch, p in planes.items():
                shards.setdefault(ch, []).append(p)
        devices = [dev for dev, _, _ in work]
        return {ch: ShardedPlane(s, devices) for ch, s in shards.items()}

    return fn, mesh, sharding


def sharded_unci_decode(decoder, data, mesh: Optional[DeviceMesh] = None,
                        convert_to_rgb: bool = False,
                        device=None) -> Dict[str, ShardedPlane]:
    """Decode an unci item (``decoder``: codecs.unc.UnciDecoder) with its
    tile rows sharded over ``mesh``; dict channel -> ShardedPlane.

    Without a mesh: over the largest number of cards, at most all of
    them, that divides the tile rows (JAX grid_decode.py:82-88), or with
    ``device`` given, on a one-member mesh of that device.  A mesh that
    does not divide the tile rows still decodes: ceil(rows / members)
    whole tile rows a member."""
    layout = decoder.layout
    payload = decoder._uncompressed_payload(memoryview(data))
    if mesh is None:
        if device is None:
            resolve_device(None)
            n_avail = torch.cuda.device_count()
            mesh = make_mesh(max(d for d in range(1, n_avail + 1)
                                 if layout.tile_rows % d == 0))
        else:
            mesh = make_mesh(1, device=device)
    fn, _, _ = build_sharded_pipeline(layout, mesh, convert_to_rgb)
    return fn(payload)
