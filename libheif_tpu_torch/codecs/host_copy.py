"""Tensors from the device to the host in one copy.

The host encoders (the HEVC and AV1 loops, the C++ HEVC path, the JPEG
scan) read numpy arrays.  ``host_planes`` joins tensors on their device,
copies them in one transfer (through pinned memory from a card) and
splits them on the host.
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
