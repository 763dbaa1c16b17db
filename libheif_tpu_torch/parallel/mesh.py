"""Device mesh and tile sharding for tile-parallel decode.

Counterpart of libheif_tpu/parallel/mesh.py, the replacement for the
reference's per-tile thread pool (reference: grid.cc:285-453 std::async
fan-out bounded by max_decoding_threads, context.h:72).  A
``DeviceMesh`` stands where ``jax.sharding.Mesh`` stands: a numpy object
array of ``torch.device`` with axis names.  There is no compiler to
place the shards, so the callers (grid_decode.py, coded_grid.py) launch
each member's part on its device themselves, every member's work issued
before any readback.

A mesh over the CUDA cards has one member a card.  A virtual mesh
repeats one device (the CPU, or one card) as several members: the
analog of the virtual CPU devices the JAX tests run on, and the way the
split, the per-member launches and the gather are checked on a machine
with one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._build import resolve_device


@dataclass(frozen=True, eq=False)
class DeviceMesh:
    """Devices (an object array of ``torch.device``, each with its
    index) laid out along ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def members(self) -> List[torch.device]:
        """The members' devices in mesh order (row-major)."""
        return list(self.devices.flat)


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index, so that a member's tensors never
    follow the caller's current device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("tiles",),
              device=None) -> DeviceMesh:
    """A 1D mesh, or a 2D one of the most balanced factorisation (as in
    JAX mesh.py:27-36), over the first ``n_devices`` CUDA cards (all of
    them by default; raises without CUDA), or, with ``device`` given
    ("cpu", "cuda:0", ...), a virtual mesh of ``n_devices`` members (1
    by default) on that one device."""
    if device is None:
        resolve_device(None)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devs = devs[:n_devices]
    else:
        devs = [_indexed(resolve_device(device))] * (n_devices or 1)
    n = len(devs)
    if len(axis_names) == 1:
        shape = (n,)
    elif len(axis_names) == 2:
        a = int(np.floor(np.sqrt(n)))
        while n % a:
            a -= 1
        shape = (n // a, a)
    else:
        raise ValueError("only 1D/2D meshes supported here")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), tuple(axis_names))


def chunk_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of ``parts`` contiguous chunks of ``n``
    items: ceil(n / parts) each, the last ones shorter or empty (the
    chunked layout of a NamedSharding over one mesh axis)."""
    per = -(-n // parts)
    return [(min(k * per, n), min((k + 1) * per, n)) for k in range(parts)]


@dataclass(frozen=True, eq=False)
class TileSharding:
    """The leading (tile) axis split along the mesh axis ``axis``: the
    counterpart of NamedSharding(mesh, P(axis)).  Members that differ
    only along the other axis hold the same chunk."""

    mesh: DeviceMesh
    axis: str

    def chunks(self, n: int) -> List[Tuple[int, int]]:
        """[start, stop) of the tiles of each member, in mesh order."""
        ax = self.mesh.axis_names.index(self.axis)
        bounds = chunk_bounds(n, self.mesh.shape[ax])
        coords = np.indices(self.mesh.shape)[ax].reshape(-1)
        return [bounds[c] for c in coords]


def tile_sharding(mesh: DeviceMesh, axis: str = "tiles") -> TileSharding:
    """The sharding of the leading (tile-batch) dimension over ``axis``."""
    return TileSharding(mesh, axis)


@dataclass(frozen=True, eq=False)
class Replicated:
    """Every member holds the whole array: NamedSharding(mesh, P())."""

    mesh: DeviceMesh


def replicated(mesh: DeviceMesh) -> Replicated:
    return Replicated(mesh)


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m
