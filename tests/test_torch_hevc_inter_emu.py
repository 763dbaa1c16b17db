"""hevc_inter_pred's CUDA source, run on the CPU.

``csrc/hevc_kernels.cu`` is compiled by g++ against the CUDA emulation of
``tests/torch_cuda_emu.h`` (one thread per CUDA thread, a barrier for
``__syncthreads``), and the HEVC wrappers take their CUDA branch on CPU
tensors.  The motion compensation kernel must give its plain version's
samples exactly: on synthetic PU partitions with every fractional phase,
uni and bi prediction and vectors beyond every edge at 8, 10 and 12 bits,
and inside whole sequences, where every HEVC kernel runs emulated and each
frame must equal libde265's.  The card's own checks are in chip_smoke.py.
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
