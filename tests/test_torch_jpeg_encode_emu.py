"""The JPEG encoder's forward DCT and quantiser kernel, run on the CPU.

``jpeg_fdct_quant`` (csrc/jpeg_kernels.cu) is compiled by g++ against the
CUDA emulation of ``tests/torch_cuda_emu.h`` and the wrapper is made to
take its CUDA branch on CPU tensors.  One launch must then give
``fdct_quant_plain``'s coefficients exactly: for images at odd sizes in
every sampling (the MCU grid reaching past the planes, the samples there
the planes' clamped edges), for views at odd offsets and pitches of one
buffer, aligned and misaligned views side by side, planes of one and two
CTA tiles (FQ_TILE_W x FQ_TILE_H blocks) and one tile plus or minus a
block or a sample, last tiles partly inside the plane, many jobs of
different sizes in one launch (more than one 32-wide round of the job
lookup), and block counts that leave the last tile partly empty.  The
emulated 8-byte loads fault at a misaligned address, so a view that
cannot take them must take the byte path.  The
JPEG bytes that ``encode_jpeg`` writes from the kernel's coefficients
equal those of the plain path.  This checks the kernel's logic without a
card; the card's own checks are in chip_smoke.py.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from libheif_tpu_torch.codecs.jpeg import cuda_fast as F
from libheif_tpu_torch.codecs.jpeg import encoder as penc
from libheif_tpu_torch.codecs.jpeg.idct import fdct_quant_plain
from libheif_tpu_torch.codecs.jpeg.tables import (
    STD_CHROMA_QUANT, STD_LUMA_QUANT, quality_scaled_quant)
from libheif_tpu_torch.image.pixel_image import (
    Channel, Chroma, Colorspace, PixelImage)
from tests import torch_cuda_emu
from tests.test_torch_jpeg import CU

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="needs g++ (C++20) to emulate CUDA")


@pytest.fixture(scope="module")
def emulated():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch_cuda_emu.bound(torch_cuda_emu.build(CU)):
        yield
    torch.set_num_threads(n)


def launched(monkeypatch, fn):
    """Run ``fn`` with the wrapper taking its CUDA branch; one launch."""
    monkeypatch.setattr(F, "_on_cpu", lambda *t: False)
    before = F.JPEG_FDCT_QUANT.launches
    out = fn()
    assert F.JPEG_FDCT_QUANT.launches - before == 1
    return out


def plain(jobs, quant):
    return torch.cat([fdct_quant_plain(F.padded_blocks(j), quant[j.qidx])
                      for j in jobs])


def image(w, h, chroma, seed):
    rng = np.random.default_rng(seed)
    if chroma == "mono":
        img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome)
        chans = [(Channel.Y, 1, 1)]
    else:
        sx, sy = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[chroma]
        img = PixelImage(w, h, Colorspace.YCbCr,
                         {"444": Chroma.C444, "422": Chroma.C422,
                          "420": Chroma.C420}[chroma])
        chans = [(Channel.Y, 1, 1), (Channel.Cb, sx, sy),
                 (Channel.Cr, sx, sy)]
    for ch, sx, sy in chans:
        pw, ph = -(-w // sx), -(-h // sy)
        yy, xx = np.mgrid[0:ph, 0:pw]
        v = 128 + 90 * np.sin(xx / 9.0 + yy / 15.0) + \
            rng.normal(0, 12, (ph, pw))
        img.set_plane(ch, torch.from_numpy(
            np.clip(np.rint(v), 0, 255).astype(np.uint8)), 8)
    return img


@pytest.mark.parametrize("chroma", ["444", "422", "420", "mono"])
@pytest.mark.parametrize("size", [(509, 301), (17, 9), (1, 1), (33, 31)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_encode_matches_plain(emulated, monkeypatch, chroma, size):
    """encode_jpeg through the kernel (one launch for every component)
    writes the plain path's bytes."""
    img = image(*size, chroma, seed=size[0])
    ref = penc.encode_jpeg(img, 75)
    got = launched(monkeypatch, lambda: penc.encode_jpeg(img, 75))
    assert got == ref


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_emulated_extremes(emulated, monkeypatch, quality):
    """Planes of 0 and 255 (level shifts of -128 and 127), a checkerboard
    of both and noise, at the quantiser's extremes."""
    rng = np.random.default_rng(quality)
    planes = [torch.zeros((16, 16), dtype=torch.uint8),
              torch.full((16, 16), 255, dtype=torch.uint8),
              torch.from_numpy(((np.indices((16, 16)).sum(0) % 2) * 255)
                               .astype(np.uint8)),
              torch.from_numpy(rng.integers(0, 256, (16, 16),
                                            dtype=np.uint8))]
    quant = torch.from_numpy(np.stack([
        quality_scaled_quant(STD_LUMA_QUANT, quality),
        quality_scaled_quant(STD_CHROMA_QUANT, quality)]).astype(np.int32))
    jobs = [F.FdctJob(p, 2, 2, i % 2) for i, p in enumerate(planes)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


@pytest.mark.parametrize("x, pitch", [(0, 64), (3, 64), (1, 67), (8, 331)],
                         ids=["aligned", "odd-offset", "odd-both",
                              "wide-pitch"])
def test_emulated_views_of_one_buffer(emulated, monkeypatch, x, pitch):
    """Several planes at odd offsets of one buffer, tables 0-3, crops
    smaller than their block grids (clamped), one launch."""
    rng = np.random.default_rng(x * 100 + pitch)
    buf = torch.from_numpy(rng.integers(0, 256, (90, pitch),
                                        dtype=np.uint8))
    quant = torch.from_numpy(rng.integers(1, 256, (4, 64)).astype(np.int32))
    w = min(pitch - x - 2, 45)
    jobs = [F.FdctJob(buf[1:30, x:x + w], -(-w // 8), 4, 0),
            F.FdctJob(buf[31:32, x + 1:x + 2], 1, 1, 1),
            F.FdctJob(buf[33:50, x:x + 9], 3, 3, 2),
            F.FdctJob(buf[50:90:2, x:x + w], -(-w // 8) + 1, 3, 3)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


@pytest.mark.parametrize("n_blocks", [1, 7, 8, 9, 61])
def test_emulated_partial_last_cta(emulated, monkeypatch, n_blocks):
    """Block counts that leave the last CTA tile (FQ_TILE_W blocks
    across) partly empty."""
    rng = np.random.default_rng(n_blocks)
    plane = torch.from_numpy(rng.integers(0, 256, (8, 8 * n_blocks),
                                          dtype=np.uint8))
    quant = torch.from_numpy(rng.integers(1, 256, (1, 64)).astype(np.int32))
    jobs = [F.FdctJob(plane, n_blocks, 1, 0)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


TILE_PX = (8 * F.FQ_TILE_W, 8 * F.FQ_TILE_H)   # a CTA tile, in samples
TILE_SIDES = {"one tile": (1, 0), "two tiles": (2, 0),
              "-1 block": (1, -8), "+1 block": (1, 8),
              "-1 sample": (1, -1), "+1 sample": (1, 1)}


def aligned_plane(rng, w, h):
    """An (h, w) uint8 view at an aligned address with a pitch that is a
    multiple of 8 (the kernel's wide loads may take its whole blocks)."""
    pitch = -(-w // 8) * 8 + 8
    return torch.from_numpy(rng.integers(0, 256, (h, pitch),
                                         dtype=np.uint8))[:, :w]


@pytest.mark.parametrize("axis", ["width", "height"])
@pytest.mark.parametrize("side", list(TILE_SIDES))
def test_emulated_tile_sides(emulated, monkeypatch, axis, side):
    """A plane one or two CTA tiles wide (or high), or one tile plus or
    minus a block or a sample, the other side a tile and a half; the
    block grid that of the plane, and one block wider and higher (whole
    blocks past the plane)."""
    tiles, extra = TILE_SIDES[side]
    k = 0 if axis == "width" else 1
    dims = [TILE_PX[0] * 3 // 2, TILE_PX[1] * 3 // 2]
    dims[k] = TILE_PX[k] * tiles + extra
    w, h = dims
    rng = np.random.default_rng(w * 1000 + h)
    plane = aligned_plane(rng, w, h)
    quant = torch.from_numpy(rng.integers(1, 256, (2, 64)).astype(np.int32))
    jobs = [F.FdctJob(plane, -(-w // 8), -(-h // 8), 0),
            F.FdctJob(plane, -(-w // 8) + 1, -(-h // 8) + 1, 1)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


def test_emulated_last_tile_partly_inside(emulated, monkeypatch):
    """The last tile across and down holds blocks inside the plane, blocks
    cut by its edge and blocks wholly past it (an MCU grid wider than
    the plane), beside a job whose last tile is cut only by the grid."""
    rng = np.random.default_rng(7)
    plane = aligned_plane(rng, TILE_PX[0] + 37, TILE_PX[1] + 22)
    quant = torch.from_numpy(rng.integers(1, 256, (1, 64)).astype(np.int32))
    h, w = plane.shape
    jobs = [F.FdctJob(plane, -(-w // 8) + 2, -(-h // 8) + 1, 0),
            F.FdctJob(plane[:, :TILE_PX[0] + 24], F.FQ_TILE_W + 3,
                      F.FQ_TILE_H + 1, 0)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


@pytest.mark.parametrize("n_jobs", [3, 40])
def test_emulated_jobs_of_different_sizes(emulated, monkeypatch, n_jobs):
    """Jobs from one block to several tiles, with all four tables, in one
    launch; 40 jobs take two rounds of the 32-wide job lookup."""
    rng = np.random.default_rng(n_jobs)
    quant = torch.from_numpy(rng.integers(1, 256, (4, 64)).astype(np.int32))
    jobs = []
    for i in range(n_jobs):
        w, h = (int(rng.integers(1, 3 * TILE_PX[0])),
                int(rng.integers(1, 2 * TILE_PX[1])))
        if i % 3 == 0:
            w, h = 1 + i % 8, 1 + i % 5
        jobs.append(F.FdctJob(aligned_plane(rng, w, h), -(-w // 8),
                              -(-h // 8), i % 4))
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


def test_emulated_aligned_and_misaligned_views(emulated, monkeypatch):
    """Views of one buffer whose pitch is a multiple of 8, at aligned
    offsets (the wide loads) and at odd ones (the byte path), and every
    second row of it, several tiles each, in one launch."""
    rng = np.random.default_rng(136)
    buf = torch.from_numpy(rng.integers(0, 256, (300, 136), dtype=np.uint8))
    quant = torch.from_numpy(rng.integers(1, 256, (4, 64)).astype(np.int32))
    views = [buf[0:140, 0:72], buf[2:150, 8:136], buf[5:100, 4:100],
             buf[150:300:2, 0:128], buf[1:60, 1:70], buf[160:298, 64:128]]
    jobs = [F.FdctJob(v, -(-v.shape[1] // 8), -(-v.shape[0] // 8), k % 4)
            for k, v in enumerate(views)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


def test_fdct_table_tiles():
    """The job table: each job's tiles across, its first output block and
    its first CTA, the tiles of all jobs counted once."""
    planes = [torch.zeros((h, w), dtype=torch.uint8)
              for w, h in ((64, 128), (65, 129), (8, 8), (300, 20))]
    jobs = [F.FdctJob(p, -(-p.shape[1] // 8), -(-p.shape[0] // 8), 0)
            for p in planes]
    table, n_blocks, n_ctas = F.fdct_table(jobs)
    n = len(jobs)
    rows = table.numpy()[:n * F.FQ_JOB_COLS].reshape(n, F.FQ_JOB_COLS)
    tiles_w = [-(-j.blocks_w // F.FQ_TILE_W) for j in jobs]
    tiles = [tw * -(-j.blocks_h // F.FQ_TILE_H)
             for tw, j in zip(tiles_w, jobs)]
    assert tiles == [1, 4, 1, 5]
    assert list(rows[:, 9]) == tiles_w
    assert list(rows[:, 8]) == [0, 128, 128 + 153, 128 + 153 + 1]
    assert list(table.numpy()[n * F.FQ_JOB_COLS:]) == [0, 1, 5, 6]
    assert n_ctas == 11 and n_blocks == 128 + 153 + 1 + 38 * 3


def test_emulated_every_quantiser_step(emulated, monkeypatch):
    """Four tables holding every 8-bit step Q = 1..255 and the kernel's
    largest, 4,095, on flat planes of 0 and 255, a checkerboard and noise:
    the reciprocal division gives the plain version's coefficients."""
    rng = np.random.default_rng(4095)
    steps = np.append(np.arange(1, 256), 4095)
    quant = torch.from_numpy(rng.permutation(steps).reshape(4, 64)
                             .astype(np.int32))
    planes = [torch.zeros((16, 16), dtype=torch.uint8),
              torch.full((16, 16), 255, dtype=torch.uint8),
              torch.from_numpy(((np.indices((16, 16)).sum(0) % 2) * 255)
                               .astype(np.uint8)),
              torch.from_numpy(rng.integers(0, 256, (16, 16),
                                            dtype=np.uint8))]
    jobs = [F.FdctJob(p, 2, 2, t) for p in planes for t in range(4)]
    got = launched(monkeypatch, lambda: F.fdct_quant(jobs, quant))
    assert torch.equal(got, plain(jobs, quant))


def test_reciprocal_division_is_exact():
    """The kernel's quotient: for every step q = 8 Q, Q in 1..4,095, and
    every x = |c| + 4 Q it can see (|c| <= 2^16), __umulhi(x, m) with
    m = (2^32 - 1) // q + 1 equals x // q -- every x for the 8-bit steps,
    and for the rest the x at and just below each multiple of q, where
    the quotient's fraction is largest."""
    for Q in range(1, 4096):
        q = 8 * Q
        m = (2**32 - 1) // q + 1
        top = 2**16 + 4 * Q
        if Q <= 255:
            x = np.arange(top + 1, dtype=np.uint64)
        else:
            k = np.arange(1, top // q + 2, dtype=np.uint64) * np.uint64(q)
            x = np.concatenate([k - np.uint64(1), k, [0, top]]) \
                .astype(np.uint64)
            x = x[x <= top]
        assert np.array_equal((x * np.uint64(m)) >> np.uint64(32),
                              x // np.uint64(q)), Q
