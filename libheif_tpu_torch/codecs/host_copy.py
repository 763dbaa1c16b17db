"""Planes between the host and the device in one copy.

The host encoders (the HEVC and AV1 loops, the C++ HEVC path, the JPEG
scan) read numpy arrays.  ``host_planes`` joins tensors on their device,
copies them in one transfer (through pinned memory from a card) and
splits them on the host.  The host decoders (AVC) write numpy arrays:
``device_planes`` is the inverse, the arrays joined in pinned memory on
the host, one copy to the card and views of it there.
"""

from __future__ import annotations

from typing import List, Sequence

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
    """``arrays`` (numpy arrays of one dtype) as tensors of their shapes
    on ``device``: on a card, joined in one pinned host buffer, each
    plane at a multiple of 256 bytes, copied in one host-to-device
    transfer and returned as views of it; on the CPU the arrays
    themselves, without a copy."""
    device = torch.device(device)
    dtype = arrays[0].dtype
    assert all(a.dtype == dtype for a in arrays), "planes of one dtype"
    if device.type == "cpu":
        return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    step = max(1, _ALIGN // dtype.itemsize)
    starts, end = [], 0
    for a in arrays:
        starts.append(end)
        end += -(-a.size // step) * step
    pinned = torch.empty(end, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                         pin_memory=True)
    host = pinned.numpy()
    for a, first in zip(arrays, starts):
        host[first:first + a.size] = a.reshape(-1)
    # the caching host allocator keeps ``pinned`` until the copy is done
    flat = pinned.to(device, non_blocking=True)
    return [flat[first:first + a.size].view(a.shape)
            for a, first in zip(arrays, starts)]
