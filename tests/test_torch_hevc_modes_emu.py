"""The HEVC intra mode search kernel, run on the CPU.

``hevc_mode_search`` (csrc/hevc_kernels.cu) is compiled by g++ against the
CUDA emulation of ``tests/torch_cuda_emu.h`` and the wrapper is made to
take its CUDA branch on CPU tensors.  Each launch (one a block size) must
give ``mode_search_plain``'s modes under the near-tie rule of
tests/test_torch_hevc_modes.py (a different mode only where the two
modes' float64 costs are within 1e-4 of each other) and its least costs
within float32 rounding, at n = 8, 16 and 32: on the reference test's
sinusoid-and-noise plane, a flat plane (every mode ties: the first wins),
a ramp, noise, and block counts that leave the last CTA partly empty;
and blocks that are each mode's own prediction, which the kernel must
find at cost 0 (every angle, projected side references, the transposed
horizontal path, planar, DC).
This checks the kernel's logic without a card; the card's own checks are
in chip_smoke.py.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from libheif_tpu_torch.codecs.hevc import cuda_fast as F
from libheif_tpu_torch.codecs.hevc import device_modes as P
from tests import torch_cuda_emu
from tests.test_torch_hevc_modes import each_mode_case, near_tie_count, plane

SOURCE = os.path.join(os.path.dirname(F.__file__), "csrc", "hevc_kernels.cu")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(scope="module")
def emulated():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch_cuda_emu.bound(torch_cuda_emu.build(SOURCE)):
        yield
    torch.set_num_threads(n)


def search_both(monkeypatch, y, log2):
    blocks, refs, _ = P.extract_blocks(torch.from_numpy(y), log2)
    ref_modes, ref_costs = F.mode_search_plain(blocks, refs, log2)
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    before = F.HEVC_MODE_SEARCH.launches
    modes, costs = F.mode_search(blocks, refs, log2)
    assert F.HEVC_MODE_SEARCH.launches - before == 1
    monkeypatch.undo()
    assert modes.dtype == torch.int32 and costs.dtype == torch.float32
    assert modes.shape == ref_modes.shape == (blocks.shape[0],)
    return modes, costs, ref_modes, ref_costs


CASES = [("frame", 100, 47, 3), ("frame", 130, 98, 5), ("flat", 64, 40, 0),
         ("ramp", 70, 66, 0), ("noise", 48, 48, 1)]


@pytest.mark.parametrize("log2", [3, 4, 5])
@pytest.mark.parametrize("kind,w,h,seed", CASES)
def test_emulated_search_matches_plain(emulated, monkeypatch, log2, kind, w,
                                       h, seed):
    y = plane(kind, w, h, seed)
    modes, costs, ref_modes, ref_costs = search_both(monkeypatch, y, log2)
    n_ties = near_tie_count(y, log2, modes.numpy(), ref_modes.numpy())
    print(f"{kind} {w}x{h} log2 {log2}: {modes.numel()} blocks, "
          f"{n_ties} admissible near-tie disagreements")
    assert torch.allclose(costs, ref_costs, rtol=1e-5, atol=1e-3)
    if kind == "flat":
        assert (modes == 0).all() and (costs == 0).all()


@pytest.mark.parametrize("log2", [3, 4, 5])
def test_emulated_each_mode_wins_its_own_prediction(emulated, monkeypatch,
                                                    log2):
    blocks, refs, want = each_mode_case(log2)
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    before = F.HEVC_MODE_SEARCH.launches
    modes, costs = F.mode_search(torch.from_numpy(blocks),
                                 torch.from_numpy(refs), log2)
    assert F.HEVC_MODE_SEARCH.launches - before == 1
    np.testing.assert_array_equal(modes.numpy(), want)
    assert (costs == 0).all()
