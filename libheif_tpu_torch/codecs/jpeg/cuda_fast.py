"""Hand-written CUDA kernels of the JPEG reconstruction and of the
encoder's forward DCT and quantiser, and their plain PyTorch versions.

The JAX package's jnp ``_recon_program``
(libheif_tpu/codecs/jpeg/decoder.py:500-528, with ``idct8x8_islow``,
codecs/jpeg/idct.py:79-97) and its encoder's ``_fdct_quant_program``
(codecs/jpeg/encoder.py:45-84, with ``fdct8x8_islow``, idct.py:100-154)
are kernels in ``csrc/jpeg_kernels.cu``:

=================  ==========================================  ============
kernel             replaces                                    wrapper
=================  ==========================================  ============
jpeg_dequant_idct  ``_recon_program``: dequantise, de-zigzag,  dequant_idct
                   islow IDCT, +128, clip, reassembly; every
                   component plane of every tile of a batch
jpeg_fdct_quant    ``_fdct_quant_program``: edge padding,      fdct_quant
                   level shift, islow FDCT, quantise, zigzag;
                   every component plane of an image
=================  ==========================================  ============

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version (``idct.recon_plain``,
``idct.fdct_quant_plain``), which repeats the jnp program's int32
arithmetic.  Each kernel carries a launch count
(``KERNELS[name].launches``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..._build import CudaKernel
from ..unc.cuda_fast import _on_cpu
from .idct import fdct_quant_plain, recon_plain

_P, _I = ctypes.c_void_p, ctypes.c_int

JPEG_DEQUANT_IDCT = CudaKernel(
    "jpeg_dequant_idct", "launch_jpeg_dequant_idct",
    [_P, _P, _P, _I, _I])

JPEG_FDCT_QUANT = CudaKernel(
    "jpeg_fdct_quant", "launch_jpeg_fdct_quant",
    [_P, _I, _I, _P, _I, _P])

KERNELS: Dict[str, CudaKernel] = {k.name: k for k in (JPEG_DEQUANT_IDCT,
                                                      JPEG_FDCT_QUANT)}

JOB_COLS = 8            # kJobCols in csrc/jpeg_kernels.cu
TILE_BLOCKS = 32        # kTileBlocks: blocks of one block row a CTA
# what one thread computes: a row of eight samples in each of kPasses = 4
SAMPLES_PER_THREAD = 32


class Job(NamedTuple):
    """One component plane of a batch: its ``blocks_h`` x ``blocks_w``
    blocks start at block ``first`` of the coefficients, take row ``qidx``
    of the quantisation tables, and the top-left (h, w) of the
    reconstructed (blocks_h·8, blocks_w·8) plane goes to ``out``, a uint8
    (h, w) view with unit column stride (for a grid, the tile's place in
    the composed plane)."""
    first: int
    blocks_w: int
    blocks_h: int
    qidx: int
    out: torch.Tensor


def _check(coeffs: torch.Tensor, quant: torch.Tensor,
           jobs: Sequence[Job]) -> None:
    if coeffs.dtype != torch.int16 or coeffs.dim() != 2 or \
            coeffs.shape[1] != 64:
        raise ValueError(f"coeffs: expected (N, 64) int16, got "
                         f"{tuple(coeffs.shape)} {coeffs.dtype}")
    if quant.dtype != torch.int32 or quant.dim() != 2 or \
            quant.shape[1] != 64:
        raise ValueError(f"quant: expected (Q, 64) int32, got "
                         f"{tuple(quant.shape)} {quant.dtype}")
    for j in jobs:
        h, w = j.out.shape
        if j.out.dtype != torch.uint8 or (w > 1 and j.out.stride(1) != 1):
            raise ValueError("out: expected a uint8 view with unit column "
                             "stride")
        if not (0 <= j.first and j.first + j.blocks_w * j.blocks_h
                <= coeffs.shape[0] and 0 <= j.qidx < quant.shape[0]):
            raise ValueError(f"job {j[:4]} outside the coefficients or "
                             "tables")
        if h > 8 * j.blocks_h or w > 8 * j.blocks_w:
            raise ValueError(f"job {j[:4]}: output {h}x{w} larger than its "
                             "blocks")


def job_table(jobs: Sequence[Job], pin: bool = False
              ) -> Tuple[torch.Tensor, int]:
    """The kernel's table in one int32 buffer (pinned where ``pin``) and
    its CTA count: a row of JOB_COLS a job (output address low and high
    words, pitch, crop width and height, quantisation row, first block,
    blocks_w), then each job's first CTA.  A job's CTAs walk the block rows
    its crop shows, ceil(w / (8·TILE_BLOCKS)) a row, each taking up to
    TILE_BLOCKS blocks."""
    meta = np.array([(o.data_ptr(), o.stride(0), o.shape[1], o.shape[0], q,
                      f, b) for f, b, _, q, o in jobs], dtype=np.int64)
    if meta[:, 1:].max() >= 1 << 31:
        raise ValueError("a pitch or block index past the kernel's int32")
    ow, oh = meta[:, 2], meta[:, 3]
    count = (oh + 7) // 8 * ((ow + 8 * TILE_BLOCKS - 1) // (8 * TILE_BLOCKS))
    ends = np.cumsum(count)
    n, n_ctas = len(jobs), int(ends[-1])
    if n_ctas >= 1 << 31:
        raise ValueError("more than 2^31 - 1 CTAs")
    table = torch.empty(n * (JOB_COLS + 1), dtype=torch.int32,
                        pin_memory=pin)
    flat = table.numpy()
    rows = flat[:n * JOB_COLS].reshape(n, JOB_COLS)
    rows.view(np.int64)[:, 0] = meta[:, 0]
    rows[:, 2:] = meta[:, 1:]
    flat[n * JOB_COLS:] = ends - count
    return table, n_ctas


def dequant_idct(coeffs: torch.Tensor, quant: torch.Tensor,
                 jobs: Sequence[Job]) -> None:
    """Reconstruct every job's plane into its ``out`` view, one launch for
    all of them: dequantise each zigzag coefficient with the natural-order
    table, the islow IDCT, +128, clip to [0, 255]."""
    _check(coeffs, quant, jobs)
    jobs = [j for j in jobs if j.out.numel()]
    if not jobs:
        return
    for j in jobs:
        if j.out.device != coeffs.device:
            raise ValueError(f"out on {j.out.device}, coefficients on "
                             f"{coeffs.device}")
    if _on_cpu(coeffs.contiguous(), quant.contiguous()):
        for j in jobs:
            h, w = j.out.shape
            n = j.blocks_w * j.blocks_h
            j.out.copy_(recon_plain(coeffs[j.first:j.first + n],
                                    quant[j.qidx], j.blocks_h,
                                    j.blocks_w)[:h, :w])
        return
    coeffs = coeffs.contiguous()
    if coeffs.data_ptr() % 16:
        coeffs = coeffs.clone()
    quant = quant.contiguous()
    if coeffs.shape[0] >= 1 << 31:
        raise ValueError("more than 2^31 - 1 coefficient blocks")
    # the table goes through pinned memory, so its copy does not wait for
    # the stream (the CPU-tensor emulation of the tests has no pinning)
    table, n_ctas = job_table(jobs, pin=coeffs.device.type == "cuda")
    table_d = table.to(coeffs.device, non_blocking=True)
    JPEG_DEQUANT_IDCT.launch(coeffs, coeffs.data_ptr(), quant.data_ptr(),
                             table_d.data_ptr(), len(jobs), n_ctas)


# ------------------------------------------------------------- encode side

FQ_JOB_COLS = 12        # kFqJobCols in csrc/jpeg_kernels.cu
FQ_TILE_W = 8           # kFqTileW: blocks across a CTA's tile, a thread each
FQ_TILE_H = 16          # kFqTileH: block rows a CTA's tile
FQ_MAX_TABLES = 4


class FdctJob(NamedTuple):
    """One component plane of an encode: a uint8 (h, w) view with unit
    column stride, coded as ``blocks_h`` x ``blocks_w`` blocks (the MCU
    grid's, which may reach past the plane: the samples beyond it repeat
    its last row and column) with row ``qidx`` of the quantisation
    tables."""
    plane: torch.Tensor
    blocks_w: int
    blocks_h: int
    qidx: int


def padded_blocks(job: FdctJob) -> torch.Tensor:
    """The job's level-shifted (blocks_h·blocks_w, 8, 8) int32 blocks in
    row-major block order, the plane edge-replicated to the block grid
    (the JAX encoder.py's ``_pad_to`` and ``_blocks_of``) by clamped
    indices."""
    p = job.plane
    h, w = p.shape
    ys = torch.clamp(torch.arange(job.blocks_h * 8, device=p.device),
                     max=h - 1)
    xs = torch.clamp(torch.arange(job.blocks_w * 8, device=p.device),
                     max=w - 1)
    padded = p[ys[:, None], xs[None, :]].to(torch.int32) - 128
    return padded.reshape(job.blocks_h, 8, job.blocks_w, 8) \
        .permute(0, 2, 1, 3).reshape(-1, 8, 8)


def _check_fdct(jobs: Sequence[FdctJob], quant: torch.Tensor) -> None:
    if quant.dtype != torch.int32 or quant.dim() != 2 or \
            quant.shape[1] != 64 or not 1 <= quant.shape[0] <= FQ_MAX_TABLES:
        raise ValueError(f"quant: expected (Q <= {FQ_MAX_TABLES}, 64) int32, "
                         f"got {tuple(quant.shape)} {quant.dtype}")
    if not jobs:
        raise ValueError("no plane to encode")
    for j in jobs:
        h, w = j.plane.shape
        if j.plane.dtype != torch.uint8 or \
                (w > 1 and j.plane.stride(1) != 1) or h < 1 or w < 1:
            raise ValueError("plane: expected a non-empty uint8 view with "
                             "unit column stride")
        if j.plane.device != quant.device:
            raise ValueError(f"plane on {j.plane.device}, tables on "
                             f"{quant.device}")
        if j.blocks_w < 1 or j.blocks_h < 1 or \
                not 0 <= j.qidx < quant.shape[0]:
            raise ValueError(f"job {j[1:]}: no blocks or no table")


def fdct_table(jobs: Sequence[FdctJob], pin: bool = False
               ) -> Tuple[torch.Tensor, int, int]:
    """The kernel's job table (pinned where ``pin``), the block count and
    the CTA count: a row of FQ_JOB_COLS int32 a job (plane address low and
    high words, pitch, width, height, blocks_w, blocks_h, table, first
    output block, tiles across, 0, 0), then each job's first CTA.  Job
    i's blocks follow job i-1's in the output; a CTA takes a tile of
    FQ_TILE_W x FQ_TILE_H blocks of one job, the tiles of a job in row
    order."""
    counts = np.array([j.blocks_w * j.blocks_h for j in jobs], np.int64)
    firsts = np.cumsum(counts) - counts
    n_blocks = int(counts.sum())
    if n_blocks >= 1 << 31:
        raise ValueError("more than 2^31 - 1 blocks")
    tiles_w = np.array([-(-j.blocks_w // FQ_TILE_W) for j in jobs], np.int64)
    tiles = tiles_w * [-(-j.blocks_h // FQ_TILE_H) for j in jobs]
    first_cta = np.cumsum(tiles) - tiles
    n_ctas = int(tiles.sum())
    meta = np.array([(j.plane.data_ptr(), j.plane.stride(0),
                      j.plane.shape[1], j.plane.shape[0], j.blocks_w,
                      j.blocks_h, j.qidx, f, tw)
                     for j, f, tw in zip(jobs, firsts, tiles_w)],
                    dtype=np.int64)
    if meta[:, 1:].max() >= 1 << 31 or n_ctas >= 1 << 31:
        raise ValueError("a pitch or size past the kernel's int32")
    n = len(jobs)
    table = torch.zeros(n * (FQ_JOB_COLS + 1), dtype=torch.int32,
                        pin_memory=pin)
    rows = table.numpy()[:n * FQ_JOB_COLS].reshape(n, FQ_JOB_COLS)
    rows.view(np.int64)[:, 0] = meta[:, 0]
    rows[:, 2:10] = meta[:, 1:]
    table.numpy()[n * FQ_JOB_COLS:] = first_cta
    return table, n_blocks, n_ctas


def fdct_quant(jobs: Sequence[FdctJob], quant: torch.Tensor) -> torch.Tensor:
    """Every job's quantised coefficients, one launch for all of them:
    (sum of the jobs' blocks, 64) int16 in zigzag order, job after job,
    each block the ×8 islow FDCT of its level-shifted samples divided by
    8·Q with rounding half away from zero.  ``quant``: (Q, 64) int32
    natural-order tables, every entry in 1..4,095 (the kernel divides by
    exact reciprocals within that range; 8-bit tables hold 1..255)."""
    _check_fdct(jobs, quant)
    if _on_cpu(quant.contiguous()):
        return torch.cat([fdct_quant_plain(padded_blocks(j), quant[j.qidx])
                          for j in jobs])
    quant = quant.contiguous()
    table, n_blocks, n_ctas = fdct_table(jobs,
                                         pin=quant.device.type == "cuda")
    table_d = table.to(quant.device, non_blocking=True)
    out = torch.empty((n_blocks, 64), dtype=torch.int16, device=quant.device)
    JPEG_FDCT_QUANT.launch(out, table_d.data_ptr(), len(jobs), n_ctas,
                           quant.data_ptr(), quant.shape[0], out.data_ptr())
    return out
