"""Time hevc_inter_pred of several checkouts on one card.

    python libheif_tpu_torch/codecs/hevc/inter_times.py ROOT [ROOT ...]

For each ROOT in turn (a checkout of this repository; give a pair twice,
as A B B A, to see the spread), a process of its own imports ROOT's
``libheif_tpu_torch``, builds ROOT's kernels and times ROOT's
``cuda_fast.inter_pred`` on two inputs that every ROOT gets alike:

* the largest P or B picture of the committed libx265 1920x1080 B
  pyramid (ROOT's ``testdata/seq``), its job table and DPB captured by
  spying on ``device_recon.inter_predict`` while ROOT's HeifContext
  decodes the track (the table's hash prints, to show the trees agree);
* the stress picture of chip_smoke.py (``INTER_STRESS``: 3840x2160
  8-bit, local motion over a partition, 3 reference slots, seed 16),
  made by this checkout's ``inter_cases.py`` on top of ROOT's
  ``inter_jobs``.

Each input is timed three ways: ``ms``, CUDA events around back-to-back
calls queued behind a sleep kernel (as chip_smoke.py's rows: the x265
picture's 25 MB then stay in the 50 MB L2); ``kernel_ms``, the kernel
alone from torch.profiler over the same calls; and ``flushed_ms``, the
kernel alone from torch.profiler with a 256 MB write before each call,
so that it finds its references cold, as a decoder's next picture does
(``flushed_event_ms``: CUDA events around each such call, where the
profiler records no kernel).  Prints one JSON line a run, with the
card's name and power limit and ptxas's figures for the kernel from
ROOT's build, then the runs as one JSON list.  Needs a card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

STREAM = "x265-1920x1080"
STRESS = (3840, 2160, 8, 3, 16)     # chip_smoke.py INTER_STRESS
FLUSH_BYTES = 256 << 20
CALLS = 50

# codecs/kernel_timing.py of this script's checkout (the worker imports
# another checkout's package, which may not have it)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import kernel_timing as T  # noqa: E402
del sys.path[0]


def inter_cases_here():
    """This checkout's inter_cases.py as a module of the imported
    (ROOT's) ``libheif_tpu_torch.codecs.hevc`` package, so that it
    builds its jobs with ROOT's ``inter_jobs``."""
    name = "libheif_tpu_torch.codecs.hevc._inter_cases_timing"
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "inter_cases.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def capture_x265(root):
    """(jobs, ydpb, cdpb, bd) of the libx265 sequence's P or B picture
    with the most jobs, decoded through ROOT's HeifContext."""
    from libheif_tpu_torch import HeifContext
    from libheif_tpu_torch.codecs.hevc import device_recon as D

    seq = os.path.join(root, "libheif_tpu_torch", "testdata", "seq")
    with open(os.path.join(seq, "manifest.json")) as f:
        e = {s["name"]: s for s in json.load(f)["streams"]}[STREAM]
    with open(os.path.join(seq, e["file"]), "rb") as f:
        blob = f.read()
    plans = []
    real = D.inter_predict

    def spy(plan, ydpb, cdpb, bufs):
        plans.append((plan.inter.jobs, ydpb.clone(), cdpb.clone(), plan.bd))
        return real(plan, ydpb, cdpb, bufs)
    D.inter_predict = spy
    try:
        t = HeifContext.read_from_bytes(blob).tracks[0]
        for _ in range(e["frames"]):
            t.decode_next_image()
    finally:
        D.inter_predict = real
    return max(plans, key=lambda p: len(p[0]))


def times(torch, F, jobs, ydpb, cdpb, bd, what):
    """The three timings of inter_pred on one input (module doc)."""
    H, W = ydpb.shape[1:]
    bufs = [(torch.zeros(H * W + 1, dtype=torch.int32, device="cuda"),
             torch.zeros(2 * (H >> 1) * (W >> 1) + 1, dtype=torch.int32,
                         device="cuda")) for _ in range(2)]
    fns = [lambda b=b: F.inter_pred(jobs, ydpb, cdpb, *b, bd=bd)
           for b in bufs]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def cold(i):
        flush.fill_(i & 255)
        fns[i % 2]()
    cold_fns = [lambda i=i: cold(i) for i in range(2)]
    torch.cuda.synchronize()
    ev = []
    for i in range(CALLS):
        flush.fill_(i & 255)
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        fns[i % 2]()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return {f"{what}_jobs": int(jobs.shape[0]),
            f"{what}_jobs_sha256": hashlib.sha256(
                jobs.cpu().numpy().tobytes()).hexdigest()[:16],
            f"{what}_ms": T.device_ms(torch, fns, CALLS),
            f"{what}_kernel_ms": T.kernel_ms(torch, fns, CALLS,
                                             "hevc_inter_pred")[0],
            f"{what}_flushed_ms": T.kernel_ms(torch, cold_fns, CALLS,
                                              "hevc_inter_pred")[0],
            f"{what}_flushed_event_ms": sum(
                s.elapsed_time(e) for s, e in ev) / len(ev)}


def worker(root: str) -> dict:
    sys.path[0] = root            # not this file's directory: ROOT's package
    import torch
    from libheif_tpu_torch import _build
    from libheif_tpu_torch.codecs.hevc import cuda_fast as F

    _build.LIBRARY.load()
    out = {"root": root, "card": T.card(),
           "ptxas": T.ptxas_resources(_build.LIBRARY.build_log,
                                      "hevc_inter_pred_kernel")}
    out.update(times(torch, F, *capture_x265(root), "x265"))
    W, H, bd, refs, seed = STRESS
    jobs, ydpb, cdpb = inter_cases_here().synthetic(
        W, H, bd, seed, "cuda", refs=refs, motion="local")
    out.update(times(torch, F, jobs, ydpb, cdpb, bd, "stress"))
    return out


if __name__ == "__main__":
    sys.exit(T.run(__file__, sys.argv[1:], worker, __doc__))
