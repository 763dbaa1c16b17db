"""The HEVC kernels' CUDA source, run on the CPU.

``csrc/hevc_kernels.cu`` is compiled by g++ against the CUDA emulation of
``tests/torch_cuda_emu.h`` (one thread per CUDA thread, barriers for
``__syncthreads`` and the warp exchanges), and the wrappers are made to
take their CUDA branch on CPU tensors.  Stage A (``hevc_dequant_itx``, one
launch for every TU group) and stage B (``hevc_intra_wave``, one launch
walking every picture's waves) must then give the plain versions' samples
exactly, on the committed streams and on batches of them.  This checks the
kernels' logic without a card; the card's own checks are in chip_smoke.py.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from libheif_tpu_torch.codecs.hevc import cuda_fast as hevc_fast
from libheif_tpu_torch.codecs.hevc import decoder, device_recon, headers
from tests.test_torch_hevc import fixture_nals
from tests import torch_cuda_emu
from tests.test_torch_hevc_slices import synthetic_group

FIXTURES = os.path.join(os.path.dirname(hevc_fast.__file__), os.pardir,
                        os.pardir, "testdata", "hevc")
SOURCE = os.path.join(os.path.dirname(hevc_fast.__file__), "csrc",
                      "hevc_kernels.cu")

# single pictures: 4x4 to 32x32 TUs, strong smoothing, transform skip and
# delta qp, 10 and 12 bits; batches: two pictures of different wave
# counts (112 and 12 waves), and three of one size.  Then scaling lists
# (default and custom, 8 to 12 bits: factor slots in stage A) and several
# slices (availability cut at slice boundaries: other waves in stage B),
# and a batch of flat, default and custom pictures (three slot sets)
BATCHES = [
    ("auto-qp26",), ("nxn-dqp-sh",), ("strongsmooth",), ("chromamodes",),
    ("big-ctb-auto",), ("x265full-smooth",), ("dqp-big-varcu",),
    ("10bit-x265full",), ("12bit-x265like",),
    ("nxn-dqp-sh", "rqt1-cu32"), ("sao", "deblock-smooth", "chromamodes"),
    ("slists-default-8bit",), ("slists-custom-8bit",),
    ("slists-default-10bit",), ("slists-custom-10bit",),
    ("slists-default-12bit",), ("slists-custom-12bit",),
    ("ms-8slices",), ("ms-slices-nxn",), ("x265-2slices-sao-wpp",),
    ("mr-noacross",), ("bypass-deblock-sao",),
    ("ms-2slices", "ms-slices-slists", "ms-slices-rqt"),
]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(scope="module")
def emulated():
    with torch_cuda_emu.bound(torch_cuda_emu.build(SOURCE)):
        yield


def streams():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return {e["name"]: e for e in json.load(f)["streams"]}


def plan_of(names):
    man = streams()
    syns, raws = [], []
    for n in names:
        sps, pps, slices = fixture_nals(man[n], FIXTURES)
        syn, raw = decoder.parse_picture(headers.parse_sps(sps),
                                         headers.parse_pps(pps), slices)
        syns.append(syn)
        raws.append(raw)
    return device_recon.build_plan(syns, raws, "cpu")


def buffers(plan):
    T, H, W = plan.t, plan.height, plan.width
    return (torch.zeros(T * H * W + 1, dtype=torch.int32),
            torch.zeros(T * 2 * (H >> 1) * (W >> 1) + 1, dtype=torch.int32))


@pytest.mark.parametrize("names", BATCHES, ids="+".join)
def test_emulated_kernels_match_plain(emulated, monkeypatch, names):
    plan = plan_of(names)
    plain = device_recon.residuals(plan)                # CPU: plain version
    y_ref, c_ref = buffers(plan)
    hevc_fast.intra_waves(y_ref, c_ref, plain, plan.wave_rows, bd=plan.bd,
                          strong=plan.strong_smoothing)

    monkeypatch.setattr(hevc_fast, "_on_cpu", lambda *t: False)
    a0 = hevc_fast.HEVC_DEQUANT_ITX.launches
    b0 = hevc_fast.HEVC_INTRA_WAVE.launches
    got = device_recon.residuals(plan)
    assert hevc_fast.HEVC_DEQUANT_ITX.launches - a0 == 1
    for g, w, ref in zip(plan.groups, got, plain):
        assert torch.equal(w.res, ref.res), f"stage A, group {g.key}"
    y, c = buffers(plan)
    hevc_fast.intra_waves(y, c, plain, plan.wave_rows, bd=plan.bd,
                          strong=plan.strong_smoothing)
    assert hevc_fast.HEVC_INTRA_WAVE.launches - b0 == 1
    assert torch.equal(y[:-1], y_ref[:-1]), "stage B, luma"
    assert torch.equal(c[:-1], c_ref[:-1]), "stage B, chroma"


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_emulated_dequant_extreme_group(emulated, monkeypatch, bd):
    """hevc_dequant_itx on synthetic groups of every size with |c| =
    32767, m = 255 and the top QP (a 64-bit product), some transform-skip
    and bypass TUs and flat slots among them: equal to the plain
    version."""
    rng = np.random.default_rng(bd)
    groups = []
    mtab = None
    for log2, luma in ((2, True), (3, True), (4, True), (5, True),
                       (2, False), (3, False), (4, False)):
        c, qp, ts, tqb, mslot, mt, _ = synthetic_group(
            rng, log2, luma, bd, 40 if log2 < 5 else 9, True)
        mtab = torch.from_numpy(mt) if mtab is None else mtab
        t = torch.from_numpy
        groups.append(hevc_fast.ItxGroup(luma, log2, t(c), t(qp), t(ts),
                                         t(tqb), t(mslot)))
    ref = hevc_fast.dequant_itx(groups, bd=bd, mtab=mtab)
    monkeypatch.setattr(hevc_fast, "_on_cpu", lambda *t: False)
    got = hevc_fast.dequant_itx(groups, bd=bd, mtab=mtab)
    for g, a, b in zip(groups, got, ref):
        assert torch.equal(a, b), (g.log2, g.luma)


def test_launch_rewrite():
    src = ("  k<<<static_cast<unsigned>(n), kT, 0,\n"
           "      static_cast<cudaStream_t>(s)>>>(a, b);\n"
           "  m<<<p, 32>>>(c);")
    assert torch_cuda_emu.rewrite_launches(src) == (
        "  emu_launch(k, dim3(static_cast<unsigned>(n)), dim3( kT), a, b);\n"
        "  emu_launch(m, dim3(p), dim3( 32), c);")
