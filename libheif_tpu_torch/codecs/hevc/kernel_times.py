"""Time the HEVC reconstruction kernels of several checkouts on one card.

    python libheif_tpu_torch/codecs/hevc/kernel_times.py ROOT [ROOT ...]

For each ROOT in turn (a checkout of this repository; give a pair twice,
as A B B A, to see the spread), a process of its own imports ROOT's
``libheif_tpu_torch``, builds ROOT's kernels, and builds the plans of
chip_smoke.py's phone photos: the flat photo (48 512x512 tiles, tile i
holding committed stream tile512_s{i mod 4}) and, where ROOT commits
them, the slices photo (tile i holding the i mod 4-th of the scaling-list
and multi-slice tiles) and a plan of the two scaling-list tiles alone (48
tiles, alternating).  It times ``hevc_dequant_itx`` (stage A, through
``device_recon.residuals``) and ``hevc_intra_wave`` (stage B, through
``cuda_fast.intra_waves``) on each with CUDA events around back-to-back
calls queued behind a sleep kernel, so that host time between calls is
not counted, and gives stage A per coefficient (ns).  Then the flat
photo's HEIC (ROOT's ``chip_smoke.photo_file``) decoded through
``HeifContext`` to interleaved RGB seven times, each wall time (host
clock, ending in a device sync).  Prints one JSON line a run, with the
card's name and power limit and ptxas's figures for both kernels from
ROOT's build, then the runs as one JSON list.  Needs a card.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

FLAT = ("tile512_s0", "tile512_s1", "tile512_s2", "tile512_s3")
SLICES = ("tile512_slists_default", "tile512_slists_custom",
          "tile512_4slices", "tile512_8slices_deblock")
LISTS = ("tile512_slists_default", "tile512_slists_custom")
PICTURES = 48

# codecs/kernel_timing.py of this script's checkout (the worker imports
# another checkout's package, which may not have it)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import kernel_timing as T  # noqa: E402
del sys.path[0]


def slice_nals(data: str, e: dict):
    """A manifest entry's slice NALs: one file with the NAL, or (key
    "slices") one with each NAL behind a 4-byte big-endian length."""
    if "slices" not in e:
        with open(os.path.join(data, e["slice"]), "rb") as f:
            return [f.read()]
    with open(os.path.join(data, e["slices"]), "rb") as f:
        buf = f.read()
    out, pos = [], 0
    while pos < len(buf):
        n = int.from_bytes(buf[pos:pos + 4], "big")
        out.append(buf[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def worker(root: str) -> dict:
    sys.path[0] = root            # not this file's directory: ROOT's package
    import torch
    from libheif_tpu_torch import _build
    from libheif_tpu_torch.codecs.hevc import cuda_fast as F
    from libheif_tpu_torch.codecs.hevc import decoder, headers
    from libheif_tpu_torch.codecs.hevc import device_recon as D

    _build.LIBRARY.load()
    data = os.path.join(root, "libheif_tpu_torch", "testdata", "hevc")
    with open(os.path.join(data, "manifest.json")) as f:
        man = {e["name"]: e for e in json.load(f)["streams"]}
    parsed = {}

    def parse(n):
        if n not in parsed:
            e = man[n]
            parsed[n] = decoder.parse_picture(
                headers.parse_sps(bytes.fromhex(e["sps"])),
                headers.parse_pps(bytes.fromhex(e["pps"])),
                slice_nals(data, e))
        return parsed[n]

    def plan_of(tiles):
        pics = [parse(tiles[i % len(tiles)]) for i in range(PICTURES)]
        return D.build_plan([p[0] for p in pics], [p[1] for p in pics],
                            "cuda")

    def times(plan, what):
        waves = D.residuals(plan)
        T_, H, W = plan.t, plan.height, plan.width
        bufs = [(torch.zeros(T_ * H * W + 1, dtype=torch.int32,
                             device="cuda"),
                 torch.zeros(T_ * 2 * (H >> 1) * (W >> 1) + 1,
                             dtype=torch.int32, device="cuda"))
                for _ in range(2)]
        a = T.device_ms(torch, [lambda: D.residuals(plan)], 20)
        coeffs = sum(g.n << (2 * g.key[1]) for g in plan.groups)
        return {
            f"{what}_waves": plan.n_waves, f"{what}_coefficients": coeffs,
            f"{what}_hevc_dequant_itx_ms": a,
            f"{what}_hevc_dequant_itx_ns_per_coefficient": a * 1e6 / coeffs,
            f"{what}_hevc_intra_wave_ms": T.device_ms(torch, [
                lambda b=b: F.intra_waves(
                    b[0], b[1], waves, plan.wave_rows, bd=plan.bd,
                    strong=plan.strong_smoothing) for b in bufs], 6)}
    out = {"root": root, "card": T.card(), **times(plan_of(FLAT), "flat")}
    import chip_smoke as S        # ROOT's
    blob = S.photo_file(S.hevc_streams())
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        S.HeifContext.read_from_bytes(blob).decode_image(
            None, S.Colorspace.RGB, S.Chroma.InterleavedRGB)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["flat_photo_wall_ms"] = walls
    if all(n in man for n in SLICES):
        out.update(times(plan_of(SLICES), "slices_photo"))
        out.update(times(plan_of(LISTS), "lists"))
    # stage A since scaling lists: a flat (ILb0) and a lists (ILb1)
    # instantiation; before, one kernel
    for k in ("hevc_dequant_itx_kernel", "hevc_dequant_itx_kernelILb0",
              "hevc_dequant_itx_kernelILb1", "hevc_intra_wave_kernel"):
        out[f"{k}_ptxas"] = T.ptxas_resources(_build.LIBRARY.build_log, k)
    return out


if __name__ == "__main__":
    sys.exit(T.run(__file__, sys.argv[1:], worker, __doc__))
