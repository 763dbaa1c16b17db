"""hevc_inter_pred's CUDA source, run on the CPU.

``csrc/hevc_kernels.cu`` is compiled by g++ against the CUDA emulation of
``tests/torch_cuda_emu.h`` (one thread per CUDA thread, barriers for
``__syncthreads`` and ``__syncwarp``, cp.async as a plain copy, a card of
2 SMs holding one block each), and the HEVC wrappers take their CUDA
branch on CPU tensors.  The motion compensation kernel must give its
plain version's samples exactly at 8, 10 and 12 bits: on synthetic PU
partitions with every fractional phase, uni and bi prediction and
vectors beyond every edge; on windows wholly inside the picture (its
16-, 8- and 4-byte copies), on windows across each edge and corner (its
clamped gather), on each phase kind of luma and chroma (integer,
horizontal only, vertical only, both), on blocks of jobs mixing uni list
0, uni list 1 and bi with a job count that leaves a ragged last round,
and on inter_cases' local motion; and inside whole sequences, where
every HEVC kernel runs emulated and each frame must equal libde265's.
The card's own checks are in chip_smoke.py.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from libheif_tpu_torch import HeifContext
from libheif_tpu_torch.codecs.hevc import cuda_fast as hevc_fast
from libheif_tpu_torch.codecs.hevc import device_recon
from tests import torch_cuda_emu
from libheif_tpu_torch.codecs.hevc import inter_cases
from tests.test_torch_hevc_inter import blob_of, frame_hashes, manifest

SOURCE = os.path.join(os.path.dirname(hevc_fast.__file__), "csrc",
                      "hevc_kernels.cu")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(scope="module")
def emulated():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch_cuda_emu.bound(torch_cuda_emu.build(SOURCE)):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_emulated_inter_pred_matches_plain(emulated, monkeypatch, bd):
    """One launch for a picture's PUs: inter_cases.synthetic (every PU
    shape, every chroma and luma phase, uni L0/L1, bi, one picture in
    both lists, vectors beyond every edge), and one PU of the whole
    picture reaching far outside it in both lists."""
    W, H = 64, 48
    jobs, ydpb, cdpb = inter_cases.synthetic(W, H, bd, 100 + bd, "cpu")
    whole = torch.from_numpy(hevc_fast.inter_jobs(np.array(
        [[0, 0, W, H, 1, -8 * W - 3, 8 * H + 5, 2, 8 * W + 7, -8 * H]],
        np.int32)))
    for j in (jobs, whole):
        outs = []
        for cuda in (False, True):
            yb = torch.zeros(H * W + 1, dtype=torch.int32)
            cb = torch.zeros(2 * (H // 2) * (W // 2) + 1, dtype=torch.int32)
            if cuda:
                monkeypatch.setattr(hevc_fast, "_on_cpu", lambda *t: False)
                before = hevc_fast.HEVC_INTER_PRED.launches
            hevc_fast.inter_pred(j, ydpb, cdpb, yb, cb, bd=bd)
            if cuda:
                assert hevc_fast.HEVC_INTER_PRED.launches - before == 1
            outs.append((yb, cb))
        assert torch.equal(outs[0][0], outs[1][0]), "luma"
        assert torch.equal(outs[0][1], outs[1][1]), "chroma"


@pytest.mark.parametrize("name", ["x265-amp-sao",
                                  "x265-dqp-slists-lossless"])
def test_emulated_sequence(emulated, monkeypatch, name):
    """A whole sequence with every HEVC kernel emulated (stage A and B of
    the intra picture and of the intra CUs of P and B pictures, the motion
    compensation of every P and B picture): each frame equals libde265's,
    and each P or B picture launches hevc_inter_pred once."""
    monkeypatch.setattr(hevc_fast, "_on_cpu", lambda *t: False)
    calls = []
    real = device_recon.inter_predict

    def spy(plan, *a, **k):
        before = hevc_fast.HEVC_INTER_PRED.launches
        real(plan, *a, **k)
        calls.append(hevc_fast.HEVC_INTER_PRED.launches - before)
    monkeypatch.setattr(device_recon, "inter_predict", spy)
    e = manifest()[name]
    t = HeifContext.read_from_bytes(blob_of(name), device="cpu").tracks[0]
    for i in range(e["frames"]):
        assert frame_hashes(t.decode_next_image()) == e["sha256"][i], i
    assert calls == [1] * (e["frames"] - 1)


# ------------------------------------------------ hevc_inter_pred's paths

SIZES = [(16, 16), (8, 8), (16, 8), (8, 16), (12, 16), (16, 4), (4, 8),
         (8, 4)]
PW, PH = 192, 128                    # the path cases' picture


def luma_windows(rows):
    """Per job and used list: (x0, y0, ew, eh) of its luma window, as
    the kernel copies it (the taps' reach only along a fractional
    axis)."""
    out = []
    for x, y, w, h, *lists in rows:
        for s, mvx, mvy in (lists[:3], lists[3:]):
            if s < 0:
                continue
            fx, fy = mvx & 3, mvy & 3
            out.append((x + (mvx >> 2) - 3 * bool(fx),
                        y + (mvy >> 2) - 3 * bool(fy),
                        w + 7 * bool(fx), h + 7 * bool(fy)))
    return np.array(out)


def launches_of(rows):
    """Jobs given as (w, h, slot0, mv0, slot1, mv1) with mv relative to
    the job's place → launches of jobs at distinct 16x16 cells of the
    picture (jobs of one launch never overlap), each row's vectors
    turned from "window at" into motion by ``to_mv(x, y, ...)``."""
    per = (PW // 16) * (PH // 16)
    out = []
    for lo in range(0, len(rows), per):
        jobs = []
        for i, r in enumerate(rows[lo:lo + per]):
            x, y = 16 * (i % (PW // 16)), 16 * (i // (PW // 16))
            jobs.append(r(x, y))
        out.append(np.array(jobs, np.int32))
    return out


def inside_mv(rng, x, y, w, h, fx, fy, col4):
    """A quarter-sample vector moving a w x h block at (x, y) to a window
    wholly inside the picture whose first column is col4 modulo 4."""
    ew, eh = w + 7 * bool(fx), h + 7 * bool(fy)
    x0 = 4 * int(rng.integers(0, (PW - ew - 3) // 4)) + col4
    y0 = int(rng.integers(0, PH - eh + 1))
    return (4 * (x0 + 3 * bool(fx) - x) + fx, 4 * (y0 + 3 * bool(fy) - y) + fy)


def case_inside(rng):
    """Jobs whose windows lie wholly inside the picture, at every window
    column modulo 4 (16-, 8- and 4-byte copies), every luma phase pair,
    uni list 0, uni list 1 and bi."""
    rows = []
    for k in range(96):
        w, h = SIZES[k % len(SIZES)]
        fx, fy, col4, kind = k % 4, k // 4 % 4, k // 16 % 4, k % 3

        def row(x, y, w=w, h=h, fx=fx, fy=fy, col4=col4, kind=kind):
            s0 = -1 if kind == 1 else int(rng.integers(0, 3))
            s1 = -1 if kind == 0 else int(rng.integers(0, 3))
            return [x, y, w, h, s0, *inside_mv(rng, x, y, w, h, fx, fy, col4),
                    s1, *inside_mv(rng, x, y, w, h, fy, fx, 3 - col4)]
        rows.append(row)
    return launches_of(rows)


def case_edges(rng):
    """Jobs on each edge and corner, their windows reaching a few
    samples and far beyond it (the clamped gather), every phase kind;
    a launch for each reach and phase (its 8 jobs do not overlap)."""
    launches = []
    k = 0
    for reach in (2, 9, 4 * PW):
        for fx, fy in ((0, 0), (1, 0), (0, 3), (2, 2)):
            rows = []
            for ex, ey in ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0),
                           (-1, 1), (0, 1), (1, 1)):
                w, h = SIZES[k % len(SIZES)]
                x = {-1: 0, 0: (PW // 2) & ~3, 1: PW - w}[ex]
                y = {-1: 0, 0: (PH // 2) & ~3, 1: PH - h}[ey]
                mvx = 4 * ex * reach + fx
                mvy = 4 * ey * reach + fy
                s1 = -1 if k % 2 else (k + 1) % 3
                rows.append([x, y, w, h, k % 3, mvx, mvy, s1,
                             mvx - fx + fy, mvy - fy + fx])
                k += 1
            launches.append(np.array(rows, np.int32))
    return launches


def case_phases(rng):
    """One 16x16, one 8x8 and one 8x4 job for each chroma phase pair
    (mv & 7; mv & 3 its luma one): every kind, integer, horizontal only,
    vertical only and both, of luma and of chroma, inside the picture."""
    rows = []
    for p in range(64):
        for w, h in ((16, 16), (8, 8), (8, 4)):
            def row(x, y, w=w, h=h, p=p):
                return [x, y, w, h, p % 3,
                        8 * int(rng.integers(-2, 3)) + p % 8,
                        8 * int(rng.integers(-2, 3)) + p // 8, -1, 0, 0]
            rows.append(row)
    return launches_of(rows)


def case_mixed(rng):
    """53 jobs (the emulated card's 16 warps take 3 or 4 each; the blocks
    a ragged last round) cycling uni list 0, uni list 1 and bi, so every
    block mixes them, over a partition's PUs."""
    pus = inter_cases.partition(PW, PH, rng)
    jobs = hevc_fast.inter_jobs(inter_cases.pu_rows(
        pus, inter_cases.phase_motion(PW, PH, rng)))[:53]
    kind = np.arange(len(jobs)) % 3
    s = rng.integers(0, 3, (len(jobs), 2))
    jobs[:, 4] = np.where(kind == 1, -1, s[:, 0])
    jobs[:, 7] = np.where(kind == 0, -1, s[:, 1])
    return [jobs]


CASES = {"inside": case_inside, "edges": case_edges, "phases": case_phases,
         "mixed": case_mixed}


def run_both(monkeypatch, jobs, ydpb, cdpb, bd):
    """inter_pred's plain and emulated samples of one launch."""
    S, H, W = ydpb.shape
    outs = []
    for cuda in (False, True):
        yb = torch.zeros(H * W + 1, dtype=torch.int32)
        cb = torch.zeros(2 * (H // 2) * (W // 2) + 1, dtype=torch.int32)
        if cuda:
            monkeypatch.setattr(hevc_fast, "_on_cpu", lambda *t: False)
            before = hevc_fast.HEVC_INTER_PRED.launches
        hevc_fast.inter_pred(jobs, ydpb, cdpb, yb, cb, bd=bd)
        if cuda:
            assert hevc_fast.HEVC_INTER_PRED.launches - before == 1
        outs.append((yb, cb))
    return outs


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_inter_pred_paths(emulated, monkeypatch, case, bd):
    """Each path of the kernel gives its plain version's samples."""
    rng = np.random.default_rng(1000 * bd + sorted(CASES).index(case))
    ydpb = torch.from_numpy(rng.integers(0, 1 << bd, (3, PH, PW))
                            .astype(np.int32))
    cdpb = torch.from_numpy(rng.integers(
        0, 1 << bd, (3, 2, PH // 2, PW // 2)).astype(np.int32))
    launches = CASES[case](rng)
    win = luma_windows(np.concatenate(launches))
    inside = (win[:, 0] >= 0) & (win[:, 1] >= 0) & \
        (win[:, 0] + win[:, 2] <= PW) & (win[:, 1] + win[:, 3] <= PH)
    if case == "inside":
        assert inside.all() and set(win[:, 0] % 4) == {0, 1, 2, 3}
    if case == "edges":
        assert not inside.any()
    if case == "mixed":
        assert len(launches[0]) % 8 and len(launches[0]) % 16
    for rows in launches:
        jobs = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
        (y0, c0), (y1, c1) = run_both(monkeypatch, jobs, ydpb, cdpb, bd)
        assert torch.equal(y0, y1), "luma"
        assert torch.equal(c0, c1), "chroma"
        covered = int((jobs[:, 2] * jobs[:, 3]).sum())
        assert (y0[:-1] > 0).sum() > 0.9 * covered


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_emulated_inter_pred_local_motion(emulated, monkeypatch, bd):
    """inter_cases.synthetic with local motion (vectors within 64
    samples, every phase pair, three PUs in four bi) at 96x64."""
    jobs, ydpb, cdpb = inter_cases.synthetic(96, 64, bd, 16 + bd, "cpu",
                                             motion="local")
    (y0, c0), (y1, c1) = run_both(monkeypatch, jobs, ydpb, cdpb, bd)
    assert torch.equal(y0, y1), "luma"
    assert torch.equal(c0, c1), "chroma"
