"""Planes between the host and the device in one copy.

The host encoders (the HEVC and AV1 loops, the C++ HEVC path, the JPEG
scan) read numpy arrays.  ``host_planes`` joins tensors on their device,
copies them in one transfer (through pinned memory from a card) and
splits them on the host.  The host decoders (AVC, JPEG 2000) write
numpy arrays: ``device_planes`` is the inverse, the arrays' bytes joined
in pinned memory on the host, one copy to the card and views of it
there.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def host_planes(planes: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """``planes`` (tensors on one device, of one dtype) as numpy arrays of
    their shapes, in one device-to-host copy."""
    if planes[0].dtype == torch.uint16:
        # moved as int16, the same bits (CUDA builds of torch lack most
        # uint16 kernels)
        return [a.view(np.uint16) for a in
                host_planes([p.view(torch.int16) for p in planes])]
    flat = planes[0].reshape(-1) if len(planes) == 1 else \
        torch.cat([p.reshape(-1) for p in planes])
    if flat.device.type == "cpu":
        host = flat.numpy()
    else:
        pinned = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        pinned.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(flat.device).synchronize()
        host = pinned.numpy()
    out, first = [], 0
    for p in planes:
        out.append(host[first:first + p.numel()].reshape(tuple(p.shape)))
        first += p.numel()
    return out


_ALIGN = 256      # bytes between the starts of two planes on the card


def device_planes(arrays: Sequence[np.ndarray],
                  device) -> List[torch.Tensor]:
    """``arrays`` (numpy arrays, of one dtype or several) as tensors of
    their shapes and dtypes on ``device``: on a card, their bytes joined
    in one pinned host buffer, each plane at a multiple of 256 bytes,
    copied in one host-to-device transfer of bytes and returned as views
    of it (so a ``uint16`` plane, for which CUDA builds of torch lack
    most kernels, and planes of several depths move in the same copy);
    on the CPU the arrays themselves, without a copy."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    host, starts = join_bytes(arrays, pin=True)
    # the caching host allocator keeps ``host`` until the copy is done
    return split_bytes(host.to(device, non_blocking=True), arrays, starts)


def join_bytes(arrays: Sequence[np.ndarray],
               pin: bool) -> Tuple[torch.Tensor, List[int]]:
    """The arrays' bytes in one uint8 host tensor (pinned if ``pin``),
    each at a multiple of 256 bytes, and their start offsets."""
    starts, end = [], 0
    for a in arrays:
        starts.append(end)
        end += max(1, -(-a.nbytes // _ALIGN)) * _ALIGN
    buf = torch.empty(end, dtype=torch.uint8, pin_memory=pin)
    host = buf.numpy()
    for a, first in zip(arrays, starts):
        host[first:first + a.nbytes] = \
            np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return buf, starts


def split_bytes(flat: torch.Tensor, arrays: Sequence[np.ndarray],
                starts: Sequence[int]) -> List[torch.Tensor]:
    """Views of ``flat`` (as ``join_bytes`` laid it out, on any device)
    with the arrays' dtypes and shapes."""
    return [flat[first:first + a.nbytes].view(_torch_dtype(a.dtype))
            .view(a.shape) for a, first in zip(arrays, starts)]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype
