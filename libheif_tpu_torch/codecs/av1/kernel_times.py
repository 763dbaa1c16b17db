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
import subprocess
import sys
import time

TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")
PICTURES = 48


def device_ms(torch, fns, n):
    """Device time of a call: n calls behind a sleep kernel that holds
    the card while the host queues them."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    e.synchronize()
    cycles_per_ms = 10_000_000 / s.elapsed_time(e)
    for f in fns:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fns[i % len(fns)]()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_ms * cycles_per_ms) + 100_000)
    s.record()
    for i in range(n):
        fns[i % len(fns)]()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    return {
        "root": root, "card": card, "waves": plan.n_waves,
        "jobs": sum(g.n for g in plan.groups),
        "av1_dequant_itx_ms": device_ms(
            torch, [lambda: D.residuals(plan)], 20),
        "av1_intra_wave_ms": device_ms(
            torch, [lambda b=b: F.intra_waves(
                b, waves, plan.wave_rows, **D.wave_args(plan))
                for b in bufs], 6)}


def main(roots) -> int:
    runs = []
    for root in roots:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             os.path.abspath(root)], cwd=os.path.abspath(root),
            capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return out.returncode
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
