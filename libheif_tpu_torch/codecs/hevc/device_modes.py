"""Open-loop HEVC intra mode search on the device.

Counterpart of libheif_tpu/codecs/hevc/device_modes.py.  The encoder's
mode decision has no serial entropy dependency: the prediction cost of
every intra mode can be evaluated for every block at once, from the
source samples (open loop).  HEVC intra prediction is an (almost) linear
operator on the 4n+1 reference samples, so a mode's prediction is a
weight matrix (``weight_matrix``) times the references; the cost is the
SATD, the sum of absolute values of the residual's 2-D Hadamard transform
scaled by 1/n, and the chosen mode the first of least cost.  The integer
rounding of the spec predictor is dropped (float weights): the encoder
re-runs the exact prediction for the chosen mode, so the device only
chooses.

``extract_blocks`` gathers the blocks and their reference samples on the
device without a loop over blocks; ``plan_modes_device`` runs the search
as one launch of the ``hevc_mode_search`` kernel per block size
(``cuda_fast.mode_search``; its plain version on the CPU), and
``plan_modes_host`` is the JAX package's numpy loop over modes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict

import numpy as np
import torch

from ..._build import resolve_device
from .tables import INTRA_PRED_ANGLE, INTRA_INV_ANGLE

MODES = list(range(35))          # planar, DC, angular 2..34


# --------------------------------------------------------------------------
# per-mode float weight matrices (pred = W @ ref)
# --------------------------------------------------------------------------
# ref layout matches recon._gather_refs: [left bottom-up 2n] [corner]
# [top 2n]; index of (x0-1, y0-1) is 2n.

@lru_cache(maxsize=None)
def weight_matrix(mode: int, log2: int) -> np.ndarray:
    n = 1 << log2
    n_ref = 4 * n + 1
    corner = 2 * n
    W = np.zeros((n * n, n_ref), np.float32)

    def left_i(i):          # left[i] = (x0-1, y0+i)
        return corner - 1 - i

    def top_i(i):           # top[i] = (x0+i, y0-1)
        return corner + 1 + i

    if mode == 0:           # planar
        for y in range(n):
            for x in range(n):
                j = y * n + x
                W[j, left_i(y)] += (n - 1 - x) / (2.0 * n)
                W[j, top_i(n)] += (x + 1) / (2.0 * n)
                W[j, top_i(x)] += (n - 1 - y) / (2.0 * n)
                W[j, left_i(n)] += (y + 1) / (2.0 * n)
        return W
    if mode == 1:           # DC (without the edge filter)
        for i in range(n):
            W[:, left_i(i)] = 1.0 / (2.0 * n)
            W[:, top_i(i)] += 1.0 / (2.0 * n)
        return W

    angle = INTRA_PRED_ANGLE[mode]
    vertical = mode >= 18

    def main_i(i):
        return top_i(i) if vertical else left_i(i)

    def side_i(i):
        return left_i(i) if vertical else top_i(i)

    # extended main reference as index mapping ext[j] -> (ref idx, wgt)
    lo = min(0, (n * angle) >> 5) if angle < 0 else 0
    off = -lo
    ext = [None] * (off + 2 * n + 1)
    ext[off] = corner
    for i in range(2 * n):
        ext[off + 1 + i] = main_i(i)
    if angle < 0:
        inv = INTRA_INV_ANGLE[angle]
        for x in range(-1, lo - 1, -1):
            idx = (x * inv + 128) >> 8
            ext[off + x] = corner if idx == 0 else \
                side_i(min(idx - 1, 2 * n - 1))
    hi = len(ext) - 1

    for d in range(n):
        i_idx = ((d + 1) * angle) >> 5
        f = ((d + 1) * angle) & 31
        for pos in range(n):
            base = off + i_idx + 1 + pos
            j = (d * n + pos) if vertical else (pos * n + d)
            i0 = ext[min(base, hi)]
            if f == 0:
                W[j, i0] += 1.0
            else:
                i1 = ext[min(base + 1, hi)]
                W[j, i0] += (32 - f) / 32.0
                W[j, i1] += f / 32.0
    return W


@lru_cache(maxsize=None)
def all_weights(log2: int) -> np.ndarray:
    return np.stack([weight_matrix(m, log2) for m in MODES])


@lru_cache(maxsize=None)
def hadamard(n: int) -> np.ndarray:
    h = np.array([[1.0]], np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


# --------------------------------------------------------------------------
# batched reference/block extraction, on the plane's device
# --------------------------------------------------------------------------

def extract_blocks(y: torch.Tensor, log2: int):
    """(blocks[N, n*n], refs[N, 4n+1], grid shape) of the whole n x n
    blocks of the plane ``y`` (partial blocks at the right and bottom are
    dropped), float32 on ``y``'s device; refs come from the SOURCE (open
    loop): the plane edge-padded by one, the left column bottom-up, the
    corner and the top row, each side extended to 2n by repeating the
    padded plane's last sample.  The JAX function's loop over blocks
    becomes one gather of clamped coordinates."""
    n = 1 << log2
    h, w = y.shape
    gh, gw = h // n, w // n
    yf = y.to(torch.float32)
    blocks = (yf[:gh * n, :gw * n].reshape(gh, n, gw, n).permute(0, 2, 1, 3)
              .reshape(gh * gw, n * n))
    dev = y.device
    y0 = (torch.arange(gh, device=dev) * n)[:, None, None]
    x0 = (torch.arange(gw, device=dev) * n)[None, :, None]
    i = torch.arange(2 * n, device=dev)[None, None, :]
    above = torch.clamp(y0 - 1, min=0)
    left = torch.clamp(x0 - 1, min=0)
    # refs[2n - 1 - i] = (x0 - 1, y0 + i), refs[2n] = (x0 - 1, y0 - 1),
    # refs[2n + 1 + i] = (x0 + i, y0 - 1), coordinates clamped to the plane
    rows = torch.cat([torch.clamp(y0 + i, max=h - 1).flip(-1), above,
                      above.expand(gh, 1, 2 * n)], dim=-1)
    cols = torch.cat([left.expand(1, gw, 2 * n), left,
                      torch.clamp(x0 + i, max=w - 1)], dim=-1)
    rows, cols = torch.broadcast_tensors(rows, cols)
    refs = yf[rows, cols].reshape(gh * gw, 4 * n + 1)
    return blocks, refs, (gh, gw)


def mode_costs(blocks: torch.Tensor, refs: torch.Tensor, log2: int,
               modes: torch.Tensor) -> torch.Tensor:
    """The SATD of mode ``modes[i]`` for block i, in float64 from the
    dense weights: sum |H/sqrt(n) (W[m] refs - block) H/sqrt(n)|.  The
    checks of the searches recompute the chosen modes' costs with it where
    two searches disagree."""
    n = 1 << log2
    dev = blocks.device
    W = torch.from_numpy(all_weights(log2)).to(dev, torch.float64)
    H = torch.from_numpy(hadamard(n) / math.sqrt(n)).to(dev, torch.float64)
    pred = torch.einsum("kjr,kr->kj", W[modes.long()],
                        refs.to(torch.float64))
    res = (pred - blocks.to(torch.float64)).reshape(-1, n, n)
    return torch.einsum("ij,kjl,lm->kim", H, res, H).abs().sum(dim=(1, 2))


# --------------------------------------------------------------------------
# the searches
# --------------------------------------------------------------------------

def plan_modes_device(y, sizes=(3, 4, 5),
                      device=None) -> Dict[int, torch.Tensor]:
    """Mode maps {log2: (gh, gw) int32 tensor on ``device``} for each block
    size the plane holds, one ``hevc_mode_search`` launch per size (its
    plain version on the CPU).  ``y``: a luma plane, a tensor or a numpy
    array; ``device=None`` means CUDA."""
    from .cuda_fast import mode_search
    dev = resolve_device(device)
    y = torch.as_tensor(y).to(dev)
    out = {}
    for log2 in sizes:
        n = 1 << log2
        if y.shape[0] < n or y.shape[1] < n:
            continue
        blocks, refs, (gh, gw) = extract_blocks(y, log2)
        modes, _ = mode_search(blocks, refs, log2)
        out[log2] = modes.reshape(gh, gw)
    return out


def plan_modes_host(y: np.ndarray, sizes=(3, 4, 5)) -> Dict[int, np.ndarray]:
    """Same search on host numpy, mode after mode (the JAX package's
    measurement baseline); {log2: (gh, gw) int32 numpy array}."""
    out = {}
    for log2 in sizes:
        n = 1 << log2
        if y.shape[0] < n or y.shape[1] < n:
            continue
        blocks, refs, (gh, gw) = extract_blocks(torch.from_numpy(
            np.ascontiguousarray(y)), log2)
        blocks, refs = blocks.numpy(), refs.numpy()
        W = all_weights(log2)
        H = hadamard(n) / math.sqrt(n)
        best = np.zeros(blocks.shape[0], np.int32)
        cost = np.full(blocks.shape[0], np.inf, np.float32)
        for mi in range(len(MODES)):
            p = refs @ W[mi].T
            r = (p - blocks).reshape(-1, n, n)
            t = np.einsum("ij,njk,kl->nil", H, r, H)
            c = np.abs(t).sum(axis=(1, 2))
            upd = c < cost
            best[upd] = mi
            cost[upd] = c[upd]
        out[log2] = best.reshape(gh, gw)
    return out
