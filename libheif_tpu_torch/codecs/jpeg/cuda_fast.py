"""Hand-written CUDA kernel of the JPEG reconstruction, and its plain
PyTorch version.

The JAX package's jnp ``_recon_program``
(libheif_tpu/codecs/jpeg/decoder.py:500-528, with ``idct8x8_islow``,
codecs/jpeg/idct.py:79-97) is one kernel in ``csrc/jpeg_kernels.cu``:

=================  ==========================================  ============
kernel             replaces                                    wrapper
=================  ==========================================  ============
jpeg_dequant_idct  ``_recon_program``: dequantise, de-zigzag,  dequant_idct
                   islow IDCT, +128, clip, reassembly; every
                   component plane of every tile of a batch
=================  ==========================================  ============

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain version (``idct.recon_plain``), which repeats
the jnp program's int32 arithmetic with its wraparound.  The kernel
carries a launch count (``KERNELS[name].launches``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence

import torch

from ..._build import CudaKernel
from ..unc.cuda_fast import _on_cpu
from .idct import recon_plain

_P, _I = ctypes.c_void_p, ctypes.c_int

JPEG_DEQUANT_IDCT = CudaKernel(
    "jpeg_dequant_idct", "launch_jpeg_dequant_idct",
    [_P, _P, _P, _I, ctypes.c_longlong])

KERNELS: Dict[str, CudaKernel] = {JPEG_DEQUANT_IDCT.name: JPEG_DEQUANT_IDCT}

JOB_COLS = 10           # kJobCols in csrc/jpeg_kernels.cu


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
    # the job table goes through pinned memory, so its copy does not wait
    # for the stream (the CPU-tensor emulation of the tests has no pinning)
    table = torch.zeros((len(jobs), JOB_COLS), dtype=torch.int64,
                        pin_memory=coeffs.device.type == "cuda")
    rows = table.numpy()
    work = 0
    for row, j in zip(rows, jobs):
        h, w = j.out.shape
        row[:9] = (work, j.first, j.blocks_w, j.blocks_h, j.qidx,
                   j.out.data_ptr(), j.out.stride(0), w, h)
        work += j.blocks_w * j.blocks_h
    table_d = table.to(coeffs.device, non_blocking=True)
    JPEG_DEQUANT_IDCT.launch(coeffs, coeffs.data_ptr(), quant.data_ptr(),
                             table_d.data_ptr(), len(jobs), work)
