"""Synthetic inputs of hevc_inter_pred: PU tables chosen by shape and motion.

A decoded stream gives whatever motion its encoder chose.  To hold
hevc_inter_pred against its plain version (and that against the JAX
package's numpy MC) on what streams seldom show, ``phase_motion`` gives
motion covering every chroma phase pair (mv & 7 on both axes, hence
every luma phase pair), uni list 0, uni list 1 and bi prediction (the two
lists from one picture too), with vectors reaching up to two picture
sizes beyond every edge; ``partition`` tiles a picture with PUs of every
shape (2Nx2N, 2NxN, Nx2N, AMP at 16x16, NxN and 8x4/4x8 at 8x8), which
never overlap, so every order of the jobs gives the same samples; and
``synthetic`` joins them with random reference pictures into
``cuda_fast.inter_pred``'s arguments.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .cuda_fast import inter_jobs

Motion = Tuple[Tuple[int, int], int, Tuple[int, int], int]


def phase_motion(W: int, H: int, rng, refs: int = 3) -> List[Motion]:
    """64 motions (mv0, ref0, mv1, ref1), the k-th with chroma phase
    (k % 8, k // 8) in list 0; ref -1 leaves a list unused."""
    out = []
    for k in range(64):
        fx, fy = k % 8, k // 8
        far = (k % 5) - 2                    # -2..2 picture sizes away
        mv0 = (8 * int(rng.integers(-3, 4)) + 8 * far * W + fx,
               8 * int(rng.integers(-3, 4)) + 8 * far * H + fy)
        mv1 = (int(rng.integers(-40, 40)), int(rng.integers(-40, 40)))
        kind = k % 4                         # L0, L1, bi, bi one picture
        r0 = -1 if kind == 1 else int(rng.integers(0, refs))
        r1 = -1 if kind == 0 else (r0 if kind == 3 else
                                   int(rng.integers(0, refs)))
        out.append((mv0, r0, mv1, r1))
    return out


def partition(W: int, H: int, rng) -> List[Tuple[int, int, int, int]]:
    """Non-overlapping PUs (x, y, w, h) tiling a W x H picture (both
    multiples of 16): each 16x16 cell whole, split in two (2NxN, Nx2N,
    2NxnU, nLx2N) or into four 8x8 cells, each of those whole or split
    in two (8x4, 4x8)."""
    def split(x, y, s):
        q, h = s // 4, s // 2
        opts = [[(x, y, s, s)], [(x, y, s, h), (x, y + h, s, h)],
                [(x, y, h, s), (x + h, y, h, s)]]
        if s == 16:
            opts += [[(x, y, s, q), (x, y + q, s, s - q)],
                     [(x, y, q, s), (x + q, y, s - q, s)]]
        return opts[int(rng.integers(len(opts)))]
    out = []
    for cy in range(0, H, 16):
        for cx in range(0, W, 16):
            if rng.integers(2):
                out += split(cx, cy, 16)
            else:
                for dx, dy in ((0, 0), (8, 0), (0, 8), (8, 8)):
                    out += split(cx + dx, cy + dy, 8)
    return out


def pu_rows(pus, motion: List[Motion]) -> np.ndarray:
    """PU rows (n, 10) int32 [x y w h slot0 mv0x mv0y slot1 mv1x mv1y]:
    PU k takes motion k mod len(motion), an 8x4/4x8 PU uni list 0 (HEVC
    forbids it bi prediction)."""
    rows = []
    for k, (x, y, w, h) in enumerate(pus):
        mv0, r0, mv1, r1 = motion[k % len(motion)]
        if w + h == 12 and r0 >= 0:
            r1 = -1
        rows.append([x, y, w, h, r0, *mv0, r1, *mv1])
    return np.asarray(rows, np.int32).reshape(-1, 10)


def synthetic(W: int, H: int, bd: int, seed: int, device, refs: int = 3):
    """(jobs, ydpb, cdpb) for inter_pred: a partition of a W x H picture
    with phase_motion over ``refs`` random reference pictures of depth
    ``bd``, on ``device``."""
    rng = np.random.default_rng(seed)
    ydpb = rng.integers(0, 1 << bd, (refs, H, W)).astype(np.int32)
    cdpb = rng.integers(0, 1 << bd, (refs, 2, H // 2, W // 2)).astype(
        np.int32)
    rows = pu_rows(partition(W, H, rng), phase_motion(W, H, rng, refs))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (inter_jobs(rows), ydpb, cdpb))
