"""Time the JPEG kernels of several checkouts on one card.

    python libheif_tpu_torch/codecs/jpeg/kernel_times.py ROOT [ROOT ...]

For each ROOT in turn (a checkout of this repository; give a pair twice,
as A B B A, to see the spread), a process of its own imports ROOT's
``libheif_tpu_torch``, builds ROOT's kernels and the JPEG photo's batch
(48 512x512 tiles, tile i holding committed stream i mod 4, as
chip_smoke.py's photo: 144 component planes, 294,912 blocks, one
launch), holds ROOT's ``jpeg_dequant_idct`` to ``recon_plain`` on it
(every sample equal), and times it: the call (its job table's copy and
the launch) with CUDA events around back-to-back calls queued behind a
sleep kernel, so that host time between calls is not counted, and the
kernel alone and the table copy from torch.profiler.  Each run also
gives the host time of one call (tables built, copy and launch queued,
not waited for), ptxas's registers, shared memory and stack for the
kernel, and its static SASS instructions per output sample
(``codecs/unc/sass_count.py`` over the whole function, divided by the
samples one thread computes).  Prints one JSON line a run, with the
card's name and power limit, then the runs as one JSON list.  Needs a
card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

TILES = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")
PICTURES = 48
PHOTO = (4032, 3024)        # the encode's photo, 4:2:0

# codecs/kernel_timing.py of this script's checkout (the worker imports
# another checkout's package, which may not have it)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import kernel_timing as T  # noqa: E402
del sys.path[0]


def photo_batch(torch, np, F, decoder, root):
    """The photo's (coefficients, tables, jobs) on the card, each job
    writing its whole (blocks_h*8, blocks_w*8) plane."""
    data = os.path.join(root, "libheif_tpu_torch", "testdata", "jpeg")
    with open(os.path.join(data, "manifest.json")) as f:
        files = {e["name"]: e["file"] for e in json.load(f)["streams"]}
    parsed = {}
    for n in TILES:
        with open(os.path.join(data, files[n]), "rb") as f:
            parsed[n] = decoder.parse_jpeg(f.read())
    coeffs, quant, jobs, first = [], [], [], 0
    for i in range(PICTURES):
        frame = parsed[TILES[i % 4]]
        rows = {}
        for c in frame.components:
            if c.tq not in rows:
                rows[c.tq] = len(quant)
                quant.append(frame.quant[c.tq])
            out = torch.empty((c.blocks_h * 8, c.blocks_w * 8),
                              dtype=torch.uint8, device="cuda")
            jobs.append(F.Job(first, c.blocks_w, c.blocks_h, rows[c.tq],
                              out))
            coeffs.append(c.coeffs)
            first += c.blocks_w * c.blocks_h
    return (torch.from_numpy(np.concatenate(coeffs)).cuda(),
            torch.from_numpy(np.stack(quant).astype(np.int32)).cuda(), jobs)


def fdct_photo(torch, np, F, encoder, dev="cuda"):
    """The photo's three planes as jobs on ``dev`` (4:2:0: the luma two
    blocks an MCU across and down, each chroma plane one), and the q 90
    tables."""
    g = np.random.default_rng(0)
    w, h = PHOTO
    mcu_w, mcu_h = -(-w // 16), -(-h // 16)
    jobs = []
    for k, (pw, ph, s) in enumerate(((w, h, 2), (w // 2, h // 2, 1),
                                     (w // 2, h // 2, 1))):
        plane = torch.from_numpy(g.integers(0, 256, (ph, pw),
                                            dtype=np.uint8)).to(dev)
        jobs.append(F.FdctJob(plane, mcu_w * s, mcu_h * s, min(k, 1)))
    return jobs, encoder.quant_tables(90, 2, dev)


def fdct_times(torch, np, F, encoder, idct, sass, path, build_log):
    """jpeg_fdct_quant at the photo (module doc), ``fdct_*`` keys."""
    sets = [fdct_photo(torch, np, F, encoder) for _ in range(2)]
    jobs, quant = sets[0]
    got = F.fdct_quant(jobs, quant)
    want = torch.cat([idct.fdct_quant_plain(F.padded_blocks(j),
                                            quant[j.qidx]) for j in jobs])
    differing = int((got != want).sum())
    assert differing == 0, f"{differing} coefficients differ"
    fns = [lambda s=s: F.fdct_quant(*s) for s in sets]
    kernel, copies = T.kernel_ms(torch, fns, 20, "jpeg_fdct_quant")
    # a thread of the earlier kernel computed one row of one block, of
    # this one a whole block
    per_thread = 64 if hasattr(F, "FQ_TILE_W") else 8
    count = sass.count(sass.cuobjdump_sass(path), "jpeg_fdct_quant_kernel",
                       per_thread, whole=True)
    return {"fdct_blocks": sum(j.blocks_w * j.blocks_h for j in jobs),
            "fdct_differing_coefficients": differing,
            "fdct_ms": T.device_ms(torch, fns, 50),
            "fdct_kernel_ms": kernel, "fdct_table_copy_ms": copies,
            "fdct_sass_per_sample": count["per_pixel"],
            "fdct_samples_per_thread": per_thread,
            **{f"fdct_{k}": v for k, v in T.ptxas_resources(
                build_log, "jpeg_fdct_quant_kernel").items()}}


def worker(root: str) -> dict:
    sys.path[0] = root            # not this file's directory: ROOT's package
    import numpy as np
    import torch
    from libheif_tpu_torch import _build
    from libheif_tpu_torch.codecs.jpeg import cuda_fast as F
    from libheif_tpu_torch.codecs.jpeg import decoder, encoder
    from libheif_tpu_torch.codecs.jpeg import idct

    _build.LIBRARY.load()
    sets = [photo_batch(torch, np, F, decoder, root) for _ in range(2)]
    coeffs, quant, jobs = sets[0]
    F.dequant_idct(coeffs, quant, jobs)
    differing = sum(int((j.out != idct.recon_plain(
        coeffs[j.first:j.first + j.blocks_w * j.blocks_h], quant[j.qidx],
        j.blocks_h, j.blocks_w)).sum()) for j in jobs)
    assert differing == 0, f"{root}: {differing} samples differ"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        F.dequant_idct(*sets[0])
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    kernel, copies = T.kernel_ms(
        torch, [lambda s=s: F.dequant_idct(*s) for s in sets], 20,
        "jpeg_dequant_idct")
    # a thread of the earlier kernel computed one row of one block
    per_thread = getattr(F, "SAMPLES_PER_THREAD", 8)
    sass = T.load("unc/sass_count.py")
    count = sass.count(sass.cuobjdump_sass(str(_build.LIBRARY.path)),
                       "jpeg_dequant_idct_kernel", per_thread, whole=True)
    return {
        "root": root, "card": T.card(), "planes": len(jobs),
        "blocks": sum(j.blocks_w * j.blocks_h for j in jobs),
        "differing_samples": differing,
        "jpeg_dequant_idct_ms": T.device_ms(
            torch, [lambda s=s: F.dequant_idct(*s) for s in sets], 50),
        "kernel_ms": kernel, "table_copy_ms": copies,
        "host_ms_per_call": host_ms,
        "sass_per_sample": count["per_pixel"],
        "sass_instructions": count["body_instructions"],
        "samples_per_thread": per_thread,
        **T.ptxas_resources(_build.LIBRARY.build_log,
                            "jpeg_dequant_idct_kernel"),
        **fdct_times(torch, np, F, encoder, idct, sass,
                     str(_build.LIBRARY.path), _build.LIBRARY.build_log)}


if __name__ == "__main__":
    sys.exit(T.run(__file__, sys.argv[1:], worker, __doc__))
