"""The JPEG kernel's CUDA source, run on the CPU.

``csrc/jpeg_kernels.cu`` is compiled by g++ against the CUDA emulation of
``tests/torch_cuda_emu.h`` (one thread per CUDA thread, barriers for the
warp exchanges), and the wrapper is made to take its CUDA branch on CPU
tensors.  ``jpeg_dequant_idct`` (one launch for every job) must then give
``recon_plain``'s samples exactly: on the committed small streams, on a
batch of frames with different quantisation tables written at offsets of
shared planes with crops, and on random int16 coefficients with 16-bit
tables (the int32 wraparound).  This checks the kernel's logic without a
card; the card's own checks are in chip_smoke.py.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from libheif_tpu_torch.codecs.jpeg import cuda_fast as F
from libheif_tpu_torch.codecs.jpeg import decoder as pdec
from libheif_tpu_torch.codecs.jpeg import idct as pidct
from tests import torch_cuda_emu
from tests.test_torch_jpeg import CU, random_jobs, stream

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(scope="module")
def emulated():
    with torch_cuda_emu.bound(torch_cuda_emu.build(CU)):
        yield


def launched(monkeypatch, fn):
    """Run ``fn`` with the wrapper taking its CUDA branch; one launch."""
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    before = F.JPEG_DEQUANT_IDCT.launches
    out = fn()
    assert F.JPEG_DEQUANT_IDCT.launches - before == 1
    return out


@pytest.mark.parametrize("name", ["c422", "c444", "gray", "odd-restarts",
                                  "dqt16", "truncated"])
def test_emulated_kernel_decodes_streams(emulated, monkeypatch, name):
    """decode_jpeg through the emulated kernel equals its plain decode."""
    data = stream(name)
    ref = pdec.decode_jpeg(data, device="cpu")
    got = launched(monkeypatch, lambda: pdec.decode_jpeg(data, device="cpu"))
    for ch in ref.channels():
        assert torch.equal(got.plane(ch), ref.plane(ch)), ch


def test_emulated_kernel_batch_with_crops(emulated, monkeypatch):
    """Several quantisation tables, offsets, crops and a skipped plane in
    one launch."""
    rng = np.random.default_rng(3)
    coeffs, quant, jobs, planes = random_jobs(rng)
    F.dequant_idct(coeffs, quant, jobs)
    ref = [p.clone() for p in planes]
    for p in planes:
        p.zero_()
    launched(monkeypatch, lambda: F.dequant_idct(coeffs, quant, jobs))
    for a, b in zip(planes, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_emulated_kernel_wraps(emulated, monkeypatch, seed):
    """Random int16 coefficients with 16-bit tables: int32 wraparound."""
    rng = np.random.default_rng(seed)
    bh, bw = 3, 5
    coeffs = torch.from_numpy(rng.integers(-32768, 32768, (bh * bw, 64),
                                           dtype=np.int16))
    quant = torch.from_numpy(rng.integers(1, 65536, (1, 64))
                             .astype(np.int32))
    ref = pidct.recon_plain(coeffs, quant[0], bh, bw)
    out = torch.zeros((bh * 8, bw * 8), dtype=torch.uint8)
    launched(monkeypatch, lambda: F.dequant_idct(
        coeffs, quant, [F.Job(0, bw, bh, 0, out)]))
    assert torch.equal(out, ref)


def test_emulated_kernel_composes_a_grid(emulated, monkeypatch):
    """compose: four tiles into one image, clipped at its edge."""
    frames = [pdec.parse_jpeg(stream("c422")) for _ in range(4)]
    ref = pdec.compose(frames, 2, 150, 100, "cpu")
    got = launched(monkeypatch,
                   lambda: pdec.compose(frames, 2, 150, 100, "cpu"))
    for ch in ref.channels():
        assert torch.equal(got.plane(ch), ref.plane(ch)), ch
