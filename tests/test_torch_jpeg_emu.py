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


def emulate_against_plain(monkeypatch, coeffs, quant, jobs):
    """The jobs once through recon_plain (the CPU branch) and once through
    the emulated kernel, into views that start out different; the views
    and everything around them must end equal."""
    roots = []
    for j in jobs:
        base = j.out
        while base._base is not None:
            base = base._base
        if all(base is not r for r in roots):
            roots.append(base)
    for r in roots:
        r.fill_(7)
    F.dequant_idct(coeffs, quant, jobs)
    ref = [r.clone() for r in roots]
    for r in roots:
        r.fill_(7)
    launched(monkeypatch, lambda: F.dequant_idct(coeffs, quant, jobs))
    for a, b in zip(roots, ref):
        assert torch.equal(a, b)


def random_coeffs(rng, n, lo=-300, hi=300):
    return torch.from_numpy(rng.integers(lo, hi, (n, 64), dtype=np.int16))


@pytest.mark.parametrize("bw", [5, 32, 37, 70])
def test_emulated_kernel_partial_tiles(emulated, monkeypatch, bw):
    """Block rows that are not a whole number of CTA tiles: the last tile
    of each row holds bw mod TILE_BLOCKS blocks."""
    rng = np.random.default_rng(bw)
    bh = 3
    coeffs = random_coeffs(rng, 2 * bh * bw)
    quant = torch.from_numpy(rng.integers(1, 256, (2, 64)).astype(np.int32))
    outs = [torch.empty((bh * 8, bw * 8), dtype=torch.uint8)
            for _ in range(2)]
    jobs = [F.Job(0, bw, bh, 0, outs[0]), F.Job(bh * bw, bw, bh, 1, outs[1])]
    emulate_against_plain(monkeypatch, coeffs, quant, jobs)


@pytest.mark.parametrize("x, pitch", [(8, 320), (16, 336), (3, 320),
                                      (8, 325), (1, 331)],
                         ids=["aligned", "aligned-16", "odd-offset",
                              "odd-pitch", "odd-both"])
def test_emulated_kernel_view_alignment(emulated, monkeypatch, x, pitch):
    """Views at 8-aligned offsets and pitches (the 8-byte store path) and
    at odd ones (the masked byte path) of a wider plane."""
    rng = np.random.default_rng(x * 1000 + pitch)
    bh, bw = 2, 36
    coeffs = random_coeffs(rng, bh * bw)
    quant = torch.from_numpy(rng.integers(1, 256, (1, 64)).astype(np.int32))
    plane = torch.empty((bh * 8 + 3, pitch), dtype=torch.uint8)
    view = plane[1:1 + bh * 8, x:x + bw * 8]
    assert plane.data_ptr() % 8 == 0
    assert (view.data_ptr() % 8 == 0 and view.stride(0) % 8 == 0) == \
        (x % 8 == 0 and pitch % 8 == 0)
    emulate_against_plain(monkeypatch, coeffs, quant,
                          [F.Job(0, bw, bh, 0, view)])


@pytest.mark.parametrize("h, w", [(13, 253), (21, 261), (1, 1), (7, 9),
                                  (24, 257)])
def test_emulated_kernel_mid_block_crops(emulated, monkeypatch, h, w):
    """Crops that end inside a block, down and across (blocks outside the
    crop get no CTA; the cut blocks take the masked path)."""
    rng = np.random.default_rng(h * 7 + w)
    bh, bw = 3, 33
    coeffs = random_coeffs(rng, bh * bw)
    quant = torch.from_numpy(rng.integers(1, 256, (1, 64)).astype(np.int32))
    plane = torch.empty((32, 272), dtype=torch.uint8)
    emulate_against_plain(monkeypatch, coeffs, quant,
                          [F.Job(0, bw, bh, 0, plane[:h, 8:8 + w])])


def test_emulated_kernel_many_jobs(emulated, monkeypatch):
    """150 jobs in one launch, eight tables (16-bit among them), varied
    sizes, offsets and crops: each CTA finds its own job."""
    rng = np.random.default_rng(150)
    quant = torch.from_numpy(np.concatenate([
        rng.integers(1, 256, (5, 64)), rng.integers(1, 65536, (3, 64))])
        .astype(np.int32))
    jobs, first = [], 0
    for k in range(150):
        bh, bw = int(rng.integers(1, 4)), int(rng.integers(1, 41))
        h = int(rng.integers(1, bh * 8 + 1))
        w = int(rng.integers(1, bw * 8 + 1))
        x = int(rng.integers(0, 3)) * (8 if k % 2 else 3)
        plane = torch.empty((h + 2, w + x + 5), dtype=torch.uint8)
        jobs.append(F.Job(first, bw, bh, k % 8, plane[1:1 + h, x:x + w]))
        first += bh * bw
    coeffs = random_coeffs(rng, first, -2000, 2000)
    emulate_against_plain(monkeypatch, coeffs, quant, jobs)


def test_emulated_kernel_wraps_across_tiles(emulated, monkeypatch):
    """Random int16 coefficients with 16-bit tables over several tiles a
    row (the int32 wraparound on the 8-byte store path)."""
    rng = np.random.default_rng(11)
    bh, bw = 3, 40
    coeffs = random_coeffs(rng, bh * bw, -32768, 32768)
    quant = torch.from_numpy(rng.integers(1, 65536, (1, 64))
                             .astype(np.int32))
    out = torch.empty((bh * 8, bw * 8), dtype=torch.uint8)
    launched(monkeypatch, lambda: F.dequant_idct(
        coeffs, quant, [F.Job(0, bw, bh, 0, out)]))
    assert torch.equal(out, pidct.recon_plain(coeffs, quant[0], bh, bw))
