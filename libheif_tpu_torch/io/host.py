"""Host copies for the image-file codecs: their byte formats are built
and parsed in numpy, and a plane on the card crosses to the host once."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..image.pixel_image import _moved


def host_array(a) -> np.ndarray:
    """``a`` as a numpy array: a torch tensor is copied to the host once
    (a CPU tensor is viewed); anything else goes through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def interleaved_host(planes: Sequence[torch.Tensor]) -> np.ndarray:
    """The (H, W, C) host array of equal-sized planes of one dtype: stacked
    on their device, then copied to the host once."""
    return host_array(_moved(lambda *p: torch.stack(p, -1), *planes))


def planes_on_device(arr: np.ndarray, device) -> torch.Tensor:
    """An (H, W, C) host array as a (C, H, W) tensor on ``device`` (one
    copy); each ``[c]`` of it is a contiguous plane."""
    return torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(arr, -1, 0))).to(device)

