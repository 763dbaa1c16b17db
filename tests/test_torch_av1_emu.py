"""The AV1 kernels' CUDA source, run on the CPU.

``csrc/av1_kernels.cu`` is compiled by g++ against the CUDA emulation of
``tests/torch_cuda_emu.h`` (one thread per CUDA thread, barriers for
``__syncthreads`` and the warp exchanges), and the wrappers are made to
take their CUDA branch on CPU tensors.  Stage A (``av1_dequant_itx``, one
launch for every job group) and stage B (``av1_intra_wave``, one launch
walking every picture's waves) must then give the plain versions' samples
exactly, on the committed streams and on batches of them.  This checks the
kernels' logic without a card; the card's own checks are in chip_smoke.py.
"""

from __future__ import annotations

import shutil

import pytest
import torch

from libheif_tpu_torch.codecs.av1 import cuda_fast as F
from libheif_tpu_torch.codecs.av1 import decoder, device_recon as D
from tests import torch_cuda_emu
from tests.test_torch_av1 import CU, stream

# lossless (WHT), lossy self-encoded, every libaom tool, 10 bits, no edge
# filter, 64-point transforms; batches: two pictures of different wave
# counts, and three of one size
BATCHES = [
    ("self-lossless-64",), ("self-lossy-72x40",), ("aom-96x72-q40-c3",),
    ("aom-100x60-q50-c2",), ("aom-64-q35-c0-10bit",), ("aom-96-noedge",),
    ("aom-photo-128-tx64",), ("aom-128-q40-c1-10bit",),
    ("aom-128-q30-c0", "aom-128-q60-c2"),
    ("aom-128-q30-c0", "aom-128-q45-c1", "aom-128-q60-c2"),
]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def emulated():
    with torch_cuda_emu.bound(torch_cuda_emu.build(CU)):
        yield


@pytest.mark.parametrize("names", BATCHES, ids="+".join)
def test_emulated_kernels_match_plain(emulated, monkeypatch, names):
    decs = [decoder.parse_frame(stream(n))[2] for n in names]
    plan = D.build_plan(decs, "cpu")
    plain = D.residuals(plan)                   # CPU: the plain versions
    ref = D.predict_waves(plan, plain)

    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    a0 = F.AV1_DEQUANT_ITX.launches
    b0 = F.AV1_INTRA_WAVE.launches
    got = D.residuals(plan)
    assert F.AV1_DEQUANT_ITX.launches - a0 == 1
    for g, r, p in zip(plan.groups, got, plain):
        assert torch.equal(r, p), f"stage A, group {(g.kind, g.sq)}"
    buf = D.predict_waves(plan, plain)
    assert F.AV1_INTRA_WAVE.launches - b0 == 1
    assert torch.equal(buf[:-1], ref[:-1]), "stage B"
