"""unci extraction on torch tensors: the generic bit-gather program.

Counterpart of libheif_tpu/codecs/unc/kernels.py.  Every ISO 23001-17
interleave mode decodes as a batched gather + shift over the (T, S+pad)
uint8 tile buffers, driven by the static affine addressing of layout.py.
The gathers run as PyTorch indexing on the tiles' device; the shifts and
masks run in int64 and are cut to 32 bits after every shift, so values
wrap exactly where the JAX package's uint32 arithmetic wraps.

On CUDA, ``decode_tiles`` sends the layouts that
cuda_fast.fused_strided_decode accepts to the strided_extract_paste
kernel; every other layout, and every layout on the CPU, runs the
generic program, as the JAX package does off the TPU.  The strided
kernel also reads the payload in place (``payload_tiles``), which is how
``UnciDecoder.decode`` feeds it on CUDA.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ..._build import resolve_device
from . import cuda_fast
from .layout import UncLayout, ComponentView

_GATHER_PAD = 8  # safety bytes appended to each tile buffer
_U32 = 0xFFFFFFFF


def _layout_key(layout: UncLayout) -> Tuple:
    views = tuple(
        (v.comp_index, v.channel, v.depth, v.width, v.height, v.base_bits,
         v.row_stride_bits, v.x_stride_bits, v.read_bits, v.mask,
         v.le_bytes, v.le_shift, getattr(v, "multi_y_phase", None),
         v.col_offsets)
        for v in layout.views)
    return (layout.width, layout.height, layout.tile_cols, layout.tile_rows,
            layout.tile_width, layout.tile_height, layout.tile_size_bytes,
            tuple(layout.comp_tile_sizes or ()), views)


def _extract_view(tiles_u8: torch.Tensor, v: ComponentView) -> torch.Tensor:
    """Extract one component plane from all tile buffers at once.

    tiles_u8: (T, P) uint8.  Returns (T, v.height, v.width) int64 raw
    component values.  Gather indices past the buffer are clamped to its
    last byte, as XLA's gather clamps them.
    """
    dev = tiles_u8.device
    last = tiles_u8.shape[1] - 1
    y = torch.arange(v.height, dtype=torch.int64, device=dev) \
        * v.row_stride_bits
    if v.col_offsets is not None:
        x = torch.tensor(v.col_offsets, dtype=torch.int64, device=dev)
    else:
        x = torch.arange(v.width, dtype=torch.int64, device=dev) \
            * v.x_stride_bits
    bitpos = v.base_bits + y[:, None] + x[None, :]      # (H, W)
    byte0 = bitpos >> 3

    def byte(k):
        return tiles_u8[:, torch.clamp(byte0 + k, max=last)].to(torch.int64)

    if v.le_bytes:
        acc = None
        for k in range(v.le_bytes):
            g = (byte(k) << (8 * k)) & _U32
            acc = g if acc is None else (acc | g)
        return (acc >> v.le_shift) & v.mask

    # big-endian bit field, possibly byte-misaligned
    if v.col_offsets is not None:
        aligned = (v.base_bits % 8 == 0 and v.row_stride_bits % 8 == 0
                   and all(o % 8 == 0 for o in v.col_offsets))
    else:
        aligned = (v.base_bits % 8 == 0 and v.x_stride_bits % 8 == 0
                   and v.row_stride_bits % 8 == 0)
    max_misalign = 0 if aligned else 7
    nbytes = (v.read_bits + max_misalign + 7) // 8
    acc = None
    for k in range(nbytes):
        g = byte(k)
        acc = g if acc is None else (((acc << 8) & _U32) | g)
    shift = (nbytes * 8 - (bitpos & 7) - v.read_bits)[None, :, :]
    return (acc >> shift) & v.mask


@functools.lru_cache(maxsize=256)
def _build_extractor(key):
    """The per-layout extraction program.

    Returns fn(tiles_u8: (T, S+pad) uint8 tensor) -> dict channel -> full
    plane, on the tiles' device.
    """
    (width, height, tile_cols, tile_rows, tile_w, tile_h,
     tile_size, comp_sizes, views_t) = key

    views = [ComponentView(comp_index=vt[0], channel=vt[1], depth=vt[2],
                           width=vt[3], height=vt[4], base_bits=vt[5],
                           row_stride_bits=vt[6], x_stride_bits=vt[7],
                           read_bits=vt[8], mask=vt[9], le_bytes=vt[10],
                           le_shift=vt[11], col_offsets=vt[13])
             for vt in views_t]
    phases = [vt[12] for vt in views_t]

    def run(tiles_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        planes: Dict[str, list] = {}
        for v, phase in zip(views, phases):
            if not v.channel:
                continue  # padded/unmapped component
            arr = _extract_view(tiles_u8, v)              # (T, h, w)
            # (T,h,w) → (rows, cols, h, w) → (rows*h, cols*w)
            full = arr.reshape(tile_rows, tile_cols, v.height, v.width) \
                .permute(0, 2, 1, 3) \
                .reshape(tile_rows * v.height, tile_cols * v.width)
            out_dtype = torch.uint8 if v.depth <= 8 else torch.uint16
            planes.setdefault(v.channel, []).append(
                (phase, full.to(out_dtype)))

        out = {}
        for ch, parts in planes.items():
            if len(parts) == 1 and parts[0][0] is None:
                out[ch] = parts[0][1]
            else:
                # multi-Y: interleave phase views along x
                parts.sort(key=lambda p: (p[0] or (0, 1))[0])
                n = (parts[0][0] or (0, 1))[1]
                h, w = parts[0][1].shape
                stacked = torch.stack([p[1] for p in parts], dim=-1)
                out[ch] = stacked.reshape(h, w * n)
        return out

    return run


def as_tiles_tensor(tiles_u8, device: torch.device) -> torch.Tensor:
    """numpy array or tensor → uint8 tensor on ``device``."""
    if isinstance(tiles_u8, np.ndarray):
        tiles_u8 = torch.from_numpy(np.ascontiguousarray(tiles_u8))
    return tiles_u8.to(device)


def decode_tiles(layout: UncLayout, tiles_u8,
                 device=None) -> Dict[str, torch.Tensor]:
    """Decode stacked tile buffers → dict of full channel planes.

    tiles_u8: (num_tiles, tile_size + _GATHER_PAD) uint8, a numpy array or
    a tensor; it is moved to ``device`` (``None`` means CUDA).
    """
    dev = resolve_device(device)
    tiles = as_tiles_tensor(tiles_u8, dev)
    if dev.type == "cuda":
        out = cuda_fast.fused_strided_decode(layout, tiles)
        if out is not None:
            return out
    return _build_extractor(_layout_key(layout))(tiles)


def payload_tiles(layout: UncLayout, payload: bytes,
                  device=None) -> torch.Tensor:
    """The first T*S bytes of the uncompressed payload as a (T, S) uint8
    tensor on ``device`` (``None`` means CUDA), for the strided kernel
    (cuda_fast.fused_strided_decode), which reads it in place: no padding
    and no host copy, only the host→device one.

    At pitch S the byte after a tile's last row is the next tile's first
    byte (past the last tile, the end of the allocation); the strided
    kernel reads bytes at or past S as zero and never loads them.  The
    generic program needs the padded buffers of assemble_tile_buffers.
    """
    from ...core.error import HeifError

    if layout.comp_tile_sizes is not None:
        raise ValueError("tile-component layouts have no (T, S) payload view")
    T, S = layout.num_tiles, layout.tile_size_bytes
    if len(payload) < T * S:
        raise HeifError.eof(
            f"unci data too short: have {len(payload)}, need {T * S}")
    dev = resolve_device(device)
    if T * S == 0:
        return torch.zeros((T, S), dtype=torch.uint8, device=dev)
    with warnings.catch_warnings():
        # a bytes payload is read-only; the tensor is only read, then copied
        warnings.filterwarnings("ignore", "The given buffer is not writable",
                                UserWarning)
        host = torch.frombuffer(payload, dtype=torch.uint8, count=T * S)
    return host.view(T, S).to(dev, copy=True)


def assemble_tile_buffers(layout: UncLayout, data: bytes) -> np.ndarray:
    """Slice raw item data into the (T, S+pad) stacked tile buffer array
    (host numpy).

    Handles both contiguous tiles (component/pixel/row/mixed/multi-y:
    one chunk per tile) and tile-component interleave (mode 4:
    component-major scattered chunks, ref: unc_decoder.cc
    fetch_tile_data scattered branch).
    """
    from ...core.error import HeifError

    T = layout.num_tiles
    if layout.comp_tile_sizes is None:
        S = layout.tile_size_bytes
        need = S * T
        if len(data) < need:
            raise HeifError.eof(
                f"unci data too short: have {len(data)}, need {need}")
        raw = np.frombuffer(data, dtype=np.uint8, count=need).reshape(T, S)
        out = np.zeros((T, S + _GATHER_PAD), dtype=np.uint8)
        out[:, :S] = raw
        return out

    sizes = layout.comp_tile_sizes
    S = sum(sizes)
    need = S * T
    if len(data) < need:
        raise HeifError.eof(
            f"unci tile-component data too short: have {len(data)}, need {need}")
    src = np.frombuffer(data, dtype=np.uint8, count=need)
    out = np.zeros((T, S + _GATHER_PAD), dtype=np.uint8)
    comp_base = 0
    dst_off = 0
    for sz in sizes:
        chunk = src[comp_base:comp_base + sz * T].reshape(T, sz)
        out[:, dst_off:dst_off + sz] = chunk
        comp_base += sz * T
        dst_off += sz
    return out
