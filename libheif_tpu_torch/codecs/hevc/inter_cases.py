"""Synthetic inputs of hevc_inter_pred: PU tables chosen by shape and motion.

A decoded stream gives whatever motion its encoder chose.  To hold
hevc_inter_pred against its plain version (and that against the JAX
package's numpy MC) on what streams seldom show, ``phase_motion`` gives
motion covering every chroma phase pair (mv & 7 on both axes, hence
every luma phase pair), uni list 0, uni list 1 and bi prediction (the two
lists from one picture too), with vectors reaching up to two picture
sizes beyond every edge; ``local_motion`` gives the motion of a busy
picture, vectors within 64 luma samples, every phase pair and three PUs
in four bi predicted, to load the kernel at full size; ``partition``
tiles a picture with PUs of every shape (2Nx2N, 2NxN, Nx2N, AMP at
16x16, NxN and 8x4/4x8 at 8x8), which never overlap, so every order of
the jobs gives the same samples; and ``synthetic`` joins them with
random reference pictures into ``cuda_fast.inter_pred``'s arguments.

``panning_scene`` gives the source frames of the sequence encoder's
tracks: a seeded textured canvas panned a few samples a frame, with a
little noise, as YCbCr 4:2:0 planes.  The tests feed the same frames to
the JAX writer and the port's.
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


def local_motion(n: int, rng, refs: int = 3) -> List[Motion]:
    """n motions (mv0, ref0, mv1, ref1) of a picture with local motion:
    each vector uniform within 64 luma samples (256 quarter samples) of
    its block; the k-th one's list 0 with chroma phase (k % 8, k // 8 %
    8), so that every 64 in a row hold every phase pair (hence every
    luma one), list 1's phases uniform; each motion bi with probability
    3/4, else list 0 or list 1 alone."""
    k = np.arange(n)
    mv0 = np.stack([8 * rng.integers(-32, 32, n) + k % 8,
                    8 * rng.integers(-32, 32, n) + k // 8 % 8], 1)
    mv1 = rng.integers(-256, 257, (n, 2))
    r0 = rng.integers(0, refs, n)
    r1 = rng.integers(0, refs, n)
    kind = rng.integers(0, 8, n)             # 0: list 0 alone, 1: list 1
    r0[kind == 1] = -1
    r1[kind == 0] = -1
    return [((int(a), int(b)), int(p), (int(c), int(d)), int(q))
            for (a, b), p, (c, d), q in zip(mv0, r0, mv1, r1)]


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


def synthetic(W: int, H: int, bd: int, seed: int, device, refs: int = 3,
              motion: str = "phase"):
    """(jobs, ydpb, cdpb) for inter_pred: a partition of a W x H picture
    with phase_motion (``motion="phase"``) or local_motion (``"local"``)
    over ``refs`` random reference pictures of depth ``bd``, on
    ``device``."""
    rng = np.random.default_rng(seed)
    ydpb = rng.integers(0, 1 << bd, (refs, H, W)).astype(np.int32)
    cdpb = rng.integers(0, 1 << bd, (refs, 2, H // 2, W // 2)).astype(
        np.int32)
    pus = partition(W, H, rng)
    if motion == "phase":
        mo = phase_motion(W, H, rng, refs)
    elif motion == "local":
        mo = local_motion(len(pus), rng, refs)
    else:
        raise ValueError(f"motion {motion!r}: expected 'phase' or 'local'")
    rows = pu_rows(pus, mo)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (inter_jobs(rows), ydpb, cdpb))


def panning_scene(W: int, H: int, n: int, seed: int,
                  step: Tuple[int, int] = (3, 1),
                  noise: int = 2) -> List[Tuple[np.ndarray, ...]]:
    """``n`` frames (Y, Cb, Cr) of uint8 numpy planes, W x H and 4:2:0
    (W and H even): a canvas of 8x8 blocks of seeded random levels under
    a horizontal ramp, seen through a window that moves ``step`` = (dx,
    dy) luma samples a frame (the chroma windows half as far), the luma
    of every frame but the first with uniform noise in [-noise, noise]."""
    rng = np.random.default_rng(seed)
    dx, dy = step
    ch, cw = H + n * abs(dy) + 16, W + n * abs(dx) + 16
    blocks = rng.integers(0, 64, ((ch + 7) // 8, (cw + 7) // 8))
    canvas = np.kron(blocks, np.ones((8, 8), np.int64))[:ch, :cw]
    luma = ((canvas * 3 + np.arange(cw)[None, :] // 2) % 256).astype(
        np.uint8)
    chroma = [rng.integers(40, 216, (ch // 2, cw // 2)).astype(np.uint8)
              for _ in range(2)]
    chroma = [np.kron(c[::4, ::4], np.ones((4, 4), np.uint8))[:ch // 2,
                                                             :cw // 2]
              for c in chroma]
    x0, y0 = (0 if dx >= 0 else n * -dx), (0 if dy >= 0 else n * -dy)
    frames = []
    for i in range(n):
        x, y = x0 + i * dx, y0 + i * dy
        yp = luma[y:y + H, x:x + W].astype(np.int32)
        if i and noise:
            yp = yp + rng.integers(-noise, noise + 1, yp.shape)
        frames.append((np.clip(yp, 0, 255).astype(np.uint8),) + tuple(
            c[y // 2:y // 2 + H // 2, x // 2:x // 2 + W // 2].copy()
            for c in chroma))
    return frames
