"""Time the AV1 reconstruction kernels of several checkouts on one card.

    python libheif_tpu_torch/codecs/av1/kernel_times.py ROOT [ROOT ...]

For each ROOT in turn (a checkout of this repository; give a pair twice,
as A B B A, to see the spread), a process of its own imports ROOT's
``libheif_tpu_torch``, builds ROOT's kernels, builds the AVIF photo's
plan (48 512x512 tiles, tile i holding committed stream i mod 4, as
chip_smoke.py's photo) and times ``av1_dequant_itx`` (stage A, through
``device_recon.residuals``) and ``av1_intra_wave`` (stage B, through
``cuda_fast.intra_waves``) with CUDA events around back-to-back calls
queued behind a sleep kernel, so that host time between calls is not
counted.  Prints one JSON line a run, with the card's name and power
limit, then the runs as one JSON list.  Needs a card.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")
PICTURES = 48

# codecs/kernel_timing.py of this script's checkout (the worker imports
# another checkout's package, which may not have it)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import kernel_timing as T  # noqa: E402
del sys.path[0]


def worker(root: str) -> dict:
    sys.path[0] = root            # not this file's directory: ROOT's package
    import torch
    from libheif_tpu_torch import _build
    from libheif_tpu_torch.codecs.av1 import cuda_fast as F
    from libheif_tpu_torch.codecs.av1 import decoder
    from libheif_tpu_torch.codecs.av1 import device_recon as D

    _build.LIBRARY.load()
    data = os.path.join(root, "libheif_tpu_torch", "testdata", "av1")
    with open(os.path.join(data, "manifest.json")) as f:
        files = {e["name"]: e["file"] for e in json.load(f)["streams"]}
    parsed = {}
    for n in TILES:
        with open(os.path.join(data, files[n]), "rb") as f:
            parsed[n] = decoder.parse_frame(f.read())[2]
    plan = D.build_plan([parsed[TILES[i % 4]] for i in range(PICTURES)],
                        "cuda")
    res = D.residuals(plan)
    buf0, waves = D.palette_and_waves(plan, res)
    bufs = [buf0.clone() for _ in range(2)]
    return {
        "root": root, "card": T.card(), "waves": plan.n_waves,
        "jobs": sum(g.n for g in plan.groups),
        "av1_dequant_itx_ms": T.device_ms(
            torch, [lambda: D.residuals(plan)], 20),
        "av1_intra_wave_ms": T.device_ms(
            torch, [lambda b=b: F.intra_waves(
                b, waves, plan.wave_rows, **D.wave_args(plan))
                for b in bufs], 6)}


if __name__ == "__main__":
    sys.exit(T.run(__file__, sys.argv[1:], worker, __doc__))
