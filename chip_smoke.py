#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (libheif_tpu_torch).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It needs no network and imports neither JAX nor the JAX package.  Phases:

1. print the card's name and power limit (nvidia-smi);
2. build the hand-written kernels from libheif_tpu_torch/codecs/unc/csrc;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes of the CPU tests, odd sizes, every vector width and tap rule of
   the colour kernels, and the full width: all exact (the count of
   differing pixels is printed); the strided kernel on the padded (T, S+8)
   tile buffers and on the payload read in place at pitch S, with every
   load and store width the alignment allows forced, a short last row at
   pitch S, an odd address and 4096x4096 pixel-interleaved RGB8 and
   component RGB16; then compare the colour kernels' f32 core with the
   straightforward per-pixel core over every reachable input (Y 0..255 x
   scaled Cb, Cr 0..255*s, s = 1, 4, 16) for five matrices in both
   ranges, and require 0 mismatches;
4. drive the main path at full width -- a 4096x4096 YCbCr 4:2:0 unci item
   in 8x8 tiles of 512x512: box bytes -> read_all_boxes -> UnciDecoder
   .decode -> convert_image to RGB -- check it against the plain path on
   the card, against numpy on a small input, and show through the launch
   counts that it ran planes_ycbcr8_to_rgb and strided_extract_paste, the
   latter exactly once, without assembling tile buffers on the host;
5. drive the fused yuv420_tiles_to_rgb path (the headline of bench.py) at
   the same shape, with its own launch count;
6. time kernels, plain versions, one-call PyTorch yardsticks (also for
   planar8_tiles_to_image, the copy case of strided_extract_paste, which
   is off the main path, and for the other 4096x4096 strided layouts), a
   device-to-device copy_ of as many bytes as each kernel moves, the
   access-width sweeps of the colour and strided kernels, and the main
   path and its host parts, with CUDA events, and print the numbers;
7. print the colour kernels' SASS instructions per output pixel and the
   strided kernel's per output byte (sass_count.py, cuobjdump).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from libheif_tpu_torch import _build
from libheif_tpu_torch.boxes import read_all_boxes
from libheif_tpu_torch.boxes.unc import (
    Box_uncC, Box_cmpd, CmpdComponent, UncCComponent, InterleaveMode,
    SamplingMode)
from libheif_tpu_torch.codecs.unc import (
    UnciDecoder, cuda_fast, kernels, sass_count)
from libheif_tpu_torch.codecs.unc.layout import (
    ComponentView, UncLayout, compute_layout)
from libheif_tpu_torch.color import convert_image, get_kr_kb
from libheif_tpu_torch.color.ops import ColorConversionOptions, YCbCrToRGB
from libheif_tpu_torch.core.fourcc import fourcc
from libheif_tpu_torch.image.pixel_image import Channel, Colorspace, Chroma

SEED = 0
W = H = 4096
TILES = 8                       # 8x8 grid of 512x512 tiles
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores, same sheet
PALLAS = "libheif_tpu/codecs/unc/pallas_fast.py"
SOURCE = "libheif_tpu_torch/codecs/unc/csrc/unc_kernels.cu"
KR, KB = get_kr_kb(6)
DEV = "cuda"
# mangled names of the flagship instantiations in csrc/unc_kernels.cu
SASS_TILE = r"tile_yuv_to_rgb_kernelILi8ELi16ELi2ELi2ELb1EE"
SASS_PLANES = r"planes_ycbcr8_to_rgb_kernelILi16ELi1ELb1ELb1EE"
SASS_STRIDED = r"strided_extract_paste_kernelILi16ELi16EE"


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ layouts

def make_boxes(comps, types, tiles=(1, 1), version=0, profile=None,
               **fields):
    uncC = Box_uncC()
    uncC.version = version
    if profile:
        uncC.profile = fourcc(profile)
    uncC.components = [UncCComponent(i, d, 0, 0) for i, d in comps]
    uncC.num_tile_cols, uncC.num_tile_rows = tiles
    for k, v in fields.items():
        setattr(uncC, k, v)
    cmpd = Box_cmpd([CmpdComponent(t) for t in types]) if types else None
    return uncC, cmpd


def implied_cmpd():
    return Box_cmpd([CmpdComponent(t) for t in (1, 2, 3)])


def ycc420(w, h, tiles):
    return make_boxes([(0, 8), (1, 8), (2, 8)], [1, 2, 3], tiles,
                      sampling_type=SamplingMode.s420)


# Byte-aligned layouts of the CPU tests (tests/test_torch_unc.py) that the
# strided kernel takes, plus odd sizes: (name, w, h, boxes).
STRIDED_CASES = [
    ("comp420_8_2x2", 64, 32, ycc420(64, 32, (2, 2))),
    ("comp422_8_2x2", 64, 32, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [1, 2, 3], (2, 2),
        sampling_type=SamplingMode.s422)),
    ("comp444_8_2x1", 48, 32, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [1, 2, 3], (2, 1))),
    ("comp_rgb16_2x2", 32, 32, make_boxes(
        [(0, 16), (1, 16), (2, 16)], [4, 5, 6], (2, 2))),
    ("comp420_odd_rowalign_31x19", 31, 19, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [1, 2, 3], sampling_type=SamplingMode.s420,
        row_align_size=4)),
    ("pixel_rgb8_2x2", 32, 16, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6], (2, 2),
        interleave_type=InterleaveMode.pixel)),
    ("pixel_rgba16_2x1", 32, 16, make_boxes(
        [(0, 16), (1, 16), (2, 16), (3, 16)], [4, 5, 6, 7], (2, 1),
        interleave_type=InterleaveMode.pixel)),
    ("pixel_padded_size_4", 16, 8, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6],
        interleave_type=InterleaveMode.pixel, pixel_size=4)),
    ("row_rgb8_2x2", 32, 16, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6], (2, 2),
        interleave_type=InterleaveMode.row)),
    ("row_rgb16_odd_27x9", 27, 9, make_boxes(
        [(0, 16), (1, 16), (2, 16)], [4, 5, 6],
        interleave_type=InterleaveMode.row)),
    ("mixed_nv12", 32, 16, make_boxes([], None, version=1, profile="nv12")),
    ("comp420_8_full_4096", W, H, ycc420(W, H, (TILES, TILES))),
    ("pixel_rgb8_full_4096", W, H, make_boxes(
        [(0, 8), (1, 8), (2, 8)], [4, 5, 6], (TILES, TILES),
        interleave_type=InterleaveMode.pixel)),
    ("comp_rgb16_full_4096", W, H, make_boxes(
        [(0, 16), (1, 16), (2, 16)], [4, 5, 6], (TILES, TILES))),
]
WIDTHS = (16, 8, 4, 1)          # vector widths of the strided kernel


def layout_and_tiles(w, h, boxes, seed):
    uncC, cmpd = boxes
    lay = compute_layout(uncC, cmpd or implied_cmpd(), w, h)
    data = np.random.default_rng(seed).integers(
        0, 256, lay.total_data_size(), dtype=np.uint8).tobytes()
    return lay, data, kernels.assemble_tile_buffers(lay, data)


def short_last_row():
    """Two tiles at pitch S (the payload read in place) whose view's last
    row ends past the tile size S = 14: the kernel must read zeros there,
    not the next tile's first bytes (or, after the last tile, past the
    allocation)."""
    v = ComponentView(comp_index=0, channel=Channel.Y, depth=8, width=4,
                      height=3, base_bits=0, row_stride_bits=6 * 8,
                      x_stride_bits=8, read_bits=8, mask=0xFF)
    lay = UncLayout(width=8, height=3, tile_cols=2, tile_rows=1,
                    tile_width=4, tile_height=3, views=[v],
                    tile_size_bytes=14)
    data = bytes(range(1, 29))
    return lay, data


def strided_widths(lay, t):
    """The (load, store) widths the host picks for a layout's views."""
    views = list(cuda_fast.strided_views(lay, t.device).values())
    return (cuda_fast.strided_load_width(t.shape[1], t.data_ptr(), views),
            cuda_fast.strided_store_width(views))


def strided_forced(lay, t, widths):
    """fused_strided_decode with the kernel's (load, store) widths
    forced."""
    views = cuda_fast.strided_views(lay, t.device)
    cuda_fast.strided_extract_paste(t, lay.tile_size_bytes, lay.tile_rows,
                                    lay.tile_cols, list(views.values()),
                                    widths)
    return {ch: v.out for ch, v in views.items()}


# --------------------------------------------------------------- comparison

class Tally:
    """Per-kernel check results."""

    def __init__(self):
        self.max_abs_err = {k: 0 for k in cuda_fast.KERNELS}
        self.checks = {k: 0 for k in cuda_fast.KERNELS}
        self.differing = {k: 0 for k in cuda_fast.KERNELS}

    def compare(self, kernel, what, got, ref, exact):
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == ref.dtype, \
            f"{kernel} {what}: {tuple(got.shape)} {got.dtype} vs " \
            f"{tuple(ref.shape)} {ref.dtype}"
        d = (got.to(torch.int64) - ref.to(torch.int64)).abs()
        err = int(d.max()) if d.numel() else 0
        ndiff = int((d > 0).sum())
        log(f"check {kernel:22s} {what:44s} max_abs_err {err} "
            f"differing {ndiff} of {d.numel()}")
        if exact:
            assert err == 0, f"{kernel} {what}: not exact"
        else:
            assert err <= 1 and ndiff < 0.01 * d.numel(), \
                f"{kernel} {what}: beyond 1 LSB on 1% of pixels"
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        self.checks[kernel] += 1
        self.differing[kernel] += ndiff


def check_kernels(tally):
    """Phase 3: every kernel against its plain version on the card."""
    rng = np.random.default_rng(SEED)
    # tile_yuv_to_rgb: the CPU tests' grids, odd widths, tile widths that
    # are not a multiple of 16, pitches aligned to 16 and 8 bytes and odd
    # ((tr, tc, th, tw, sx, sy, bytes of padding)), the full width
    tw, th = W // TILES, H // TILES
    grids = [(2, 2, 64, 128, 2, 2, 8), (2, 2, 64, 128, 2, 2, 16),
             (2, 2, 64, 128, 2, 2, 9), (3, 1, 18, 34, 2, 2, 8),
             (2, 2, 32, 64, 2, 1, 8), (2, 2, 32, 64, 1, 1, 8),
             (1, 3, 6, 10, 2, 2, 8), (2, 3, 8, 24, 2, 2, 8),
             (3, 2, 6, 40, 2, 2, 8), (TILES, TILES, th, tw, 2, 2, 8),
             (TILES, TILES, th, tw, 2, 1, 8), (TILES, TILES, th, tw, 1, 1, 8)]
    for tr, tc, th, tw, sx, sy, pad in grids:
        n = th * tw + 2 * (th // sy) * (tw // sx)
        tiles = torch.from_numpy(rng.integers(
            0, 256, (tr * tc, n + pad), dtype=np.uint8)).to(DEV)
        vec = cuda_fast.tile_vector_width(n + pad, tw, sx, tc,
                                          tiles.data_ptr())
        for full in (True, False):
            kw = dict(tile_rows=tr, tile_cols=tc, tile_h=th, tile_w=tw,
                      sub_x=sx, sub_y=sy, kr=float(KR), kb=float(KB),
                      full_range=full)
            tally.compare("tile_yuv_to_rgb",
                          f"{tr}x{tc} tiles {tw}x{th} sub {sx}x{sy} "
                          f"pitch {n + pad} ({vec} B) "
                          f"{'full' if full else 'limited'}",
                          cuda_fast.yuv_tiles_to_rgb(tiles, **kw),
                          cuda_fast.yuv_tiles_to_rgb_plain(tiles, **kw),
                          exact=True)
    # planes_ycbcr8_to_rgb: the CPU tests' sizes (odd 129x67 included),
    # widths of 16-, 4- and 1-byte vectors with odd heights, the full
    # width, then chroma of a general nearest ratio and identity axes
    sub = {Chroma.C420: (2, 2), Chroma.C422: (2, 1), Chroma.C444: (1, 1)}
    sizes = [(64, 32), (129, 67), (7, 5), (W, 33), (W + 4, 31), (W + 1, 29),
             (W, H)]
    geoms = [(w, h, (w + sx - 1) // sx, (h + sy - 1) // sy, chroma)
             for w, h in sizes for chroma, (sx, sy) in sub.items()
             if w < W or chroma == Chroma.C420]
    geoms += [(64, 32, 20, 10, "general ratio"), (64, 32, 64, 16, "x same"),
              (64, 32, 32, 32, "y same")]
    for w, h, cw, ch, what in geoms:
        y = torch.from_numpy(rng.integers(0, 256, (h, w),
                                          dtype=np.uint8)).to(DEV)
        cb, cr = (torch.from_numpy(rng.integers(
            0, 256, (ch, cw), dtype=np.uint8)).to(DEV) for _ in range(2))
        vec = cuda_fast.planes_vector_width(
            w, cw, *(t.data_ptr() for t in (y, cb, cr)))
        for up in ("bilinear", "nearest-neighbor"):
            rules = cuda_fast.upsample_plan(ch, cw, h, w, up)
            for full in (True, False):
                kw = dict(kr=float(KR), kb=float(KB), full_range=full,
                          upsampling=up)
                tally.compare(
                    "planes_ycbcr8_to_rgb",
                    f"{w}x{h} {cw}x{ch} {what} {up} rules {rules[:2]} "
                    f"({vec} B) {'full' if full else 'limited'}",
                    cuda_fast.ycbcr8_planes_to_rgb(y, cb, cr, **kw),
                    cuda_fast.ycbcr8_planes_to_rgb_plain(y, cb, cr, **kw),
                    exact=True)
    check_strided(tally, rng)


def check_strided(tally, rng):
    """strided_extract_paste: every byte-aligned layout on the padded
    (T, S+8) buffers and on the payload read in place at pitch S, every
    load and store width the alignment allows, a short last row at pitch
    S, an odd address, and the planar copy case."""
    def compare_planes(what, got, ref):
        for ch in ref:
            tally.compare("strided_extract_paste", f"{what} {ch}", got[ch],
                          ref[ch], exact=True)

    for i, (name, w, h, boxes) in enumerate(STRIDED_CASES):
        lay, data, tiles = layout_and_tiles(w, h, boxes, seed=i)
        padded = torch.from_numpy(tiles).to(DEV)
        inplace = kernels.payload_tiles(lay, data, DEV)
        got = cuda_fast.fused_strided_decode(lay, padded)
        assert got is not None, f"{name}: strided path declined"
        ref = cuda_fast.fused_strided_decode_plain(lay, padded)
        compare_planes(f"{name} S+8", got, ref)
        compare_planes(f"{name} S+8 vs generic", got,
                       kernels._build_extractor(kernels._layout_key(lay))(
                           padded))
        compare_planes(f"{name} S", cuda_fast.fused_strided_decode(
            lay, inplace), cuda_fast.fused_strided_decode_plain(lay, inplace))
        compare_planes(f"{name} S vs S+8", cuda_fast.fused_strided_decode(
            lay, inplace), ref)
        lo, st = strided_widths(lay, inplace)
        log(f"strided widths {name}: S+8 {strided_widths(lay, padded)} "
            f"S {(lo, st)}")
        for vl in WIDTHS:
            for vs in WIDTHS:
                if vl <= lo and vs <= st:
                    compare_planes(f"{name} S load {vl} store {vs}",
                                   strided_forced(lay, inplace, (vl, vs)),
                                   ref)
    lay, data = short_last_row()
    inplace = kernels.payload_tiles(lay, data, DEV)
    expect = torch.tensor([[1, 2, 3, 4, 15, 16, 17, 18],
                           [7, 8, 9, 10, 21, 22, 23, 24],
                           [13, 14, 0, 0, 27, 28, 0, 0]], dtype=torch.uint8,
                          device=DEV)
    compare_planes("short last row at pitch S",
                   cuda_fast.fused_strided_decode(lay, inplace),
                   {Channel.Y: expect})
    compare_planes("short last row at pitch S, 1-byte access",
                   strided_forced(lay, inplace, (1, 1)), {Channel.Y: expect})
    lay, data, tiles = layout_and_tiles(*STRIDED_CASES[0][1:], seed=0)
    flat = torch.zeros(tiles.size + 1, dtype=torch.uint8, device=DEV)
    odd = flat[1:].view(tiles.shape)
    odd.copy_(torch.from_numpy(tiles))
    assert strided_widths(lay, odd)[0] == 1
    compare_planes("odd address", cuda_fast.fused_strided_decode(lay, odd),
                   cuda_fast.fused_strided_decode_plain(lay, odd))
    try:        # a width the alignment forbids is refused, not run
        strided_forced(lay, odd, (16, 16))
        raise AssertionError("a misaligned 16-byte load was launched")
    except RuntimeError:
        pass
    for c in (1, 3):
        tiles = torch.from_numpy(rng.integers(
            0, 256, (6, c * 16 * 24 + 8), dtype=np.uint8)).to(DEV)
        kw = dict(tile_rows=3, tile_cols=2, tile_h=16, tile_w=24,
                  num_comps=c)
        tally.compare("strided_extract_paste", f"planar8 copy case C={c}",
                      cuda_fast.planar8_tiles_to_image(tiles, **kw),
                      cuda_fast.planar8_tiles_to_image_plain(tiles, **kw),
                      exact=True)


CORE_MATRICES = (1, 4, 6, 7, 9)     # every distinct named Kr/Kb pair


def check_colour_core():
    """Phase 3b: the colour kernels' f32 core against the straightforward
    per-pixel core over every reachable input; returns the counts."""
    counts = {}
    t0 = time.perf_counter()
    for mc in CORE_MATRICES:
        kr, kb = get_kr_kb(mc)
        for full in (True, False):
            for scale in (1, 4, 16):
                n = cuda_fast.colour_core_mismatches(kr, kb, full, scale)
                counts[f"mc{mc} {'full' if full else 'limited'} s{scale}"] = n
    torch.cuda.synchronize()
    log(f"colour core check: {json.dumps(counts)} "
        f"({time.perf_counter() - t0:.2f} s)")
    bad = {k: v for k, v in counts.items() if v}
    assert not bad, f"colour core differs from the reference core: {bad}"
    return counts


# ------------------------------------------------------------ numpy checks

def np_bilinear(a, out_h, out_w):
    """Bilinear 2x chroma upsample of libheif_tpu/color/ops.py:80-99 in
    numpy, for planes whose size doubles exactly."""
    a = a.astype(np.float32)
    lft = np.concatenate([a[:, :1], a[:, :-1]], 1)
    rgt = np.concatenate([a[:, 1:], a[:, -1:]], 1)
    a = np.stack([(3 * a + lft) / 4, (3 * a + rgt) / 4], -1) \
        .reshape(a.shape[0], -1)[:, :out_w]
    top = np.concatenate([a[:1], a[:-1]], 0)
    bot = np.concatenate([a[1:], a[-1:]], 0)
    return np.stack([(3 * a + top) / 4, (3 * a + bot) / 4], 1) \
        .reshape(-1, a.shape[1])[:out_h]


def np_planes(data, tiles, tw, th):
    """Component-interleaved 4:2:0 tiles → full Y, Cb, Cr in numpy."""
    s = tw * th * 3 // 2
    buf = np.frombuffer(data, np.uint8).reshape(tiles, tiles, s)
    out = []
    for off, (pw, ph) in ((0, (tw, th)), (tw * th, (tw // 2, th // 2)),
                          (tw * th * 5 // 4, (tw // 2, th // 2))):
        p = buf[:, :, off:off + pw * ph].reshape(tiles, tiles, ph, pw)
        out.append(p.transpose(0, 2, 1, 3).reshape(tiles * ph, tiles * pw))
    return out


def np_rgb(y, cb, cr):
    f = np.float32
    y = y.astype(f)
    cb = np_bilinear(cb, *y.shape) - f(128)
    cr = np_bilinear(cr, *y.shape) - f(128)
    r = y + f(2 * (1 - KR)) * cr
    b = y + f(2 * (1 - KB)) * cb
    g = (y - f(KR) * r - f(KB) * b) / f(1 - KR - KB)
    return np.stack([np.clip(np.round(c), 0, 255) for c in (r, g, b)]) \
        .astype(np.uint8)


def decode_and_convert(uncC, cmpd, w, h, data):
    """The main path as a user calls it, from box bytes."""
    boxes = {type(b): b for b in read_all_boxes(uncC.serialize()
                                                + cmpd.serialize())}
    dec = UnciDecoder(boxes[Box_uncC], boxes[Box_cmpd], w, h, device=DEV)
    img = dec.decode(data)
    return dec, img, convert_image(img, Colorspace.RGB, Chroma.C444)


def rgb_of(img):
    return torch.stack([img.plane(c) for c in (Channel.R, Channel.G,
                                               Channel.B)])


def small_input_check(tally):
    """The main path on a small input against numpy."""
    w, h, t = 128, 96, 2
    uncC, cmpd = ycc420(w, h, (t, t))
    data = np.random.default_rng(SEED + 1).integers(
        0, 256, w * h * 3 // 2, dtype=np.uint8).tobytes()
    _, img, rgb = decode_and_convert(uncC, cmpd, w, h, data)
    ref_planes = np_planes(data, t, w // t, h // t)
    for ch, ref in zip((Channel.Y, Channel.Cb, Channel.Cr), ref_planes):
        tally.compare("strided_extract_paste", f"main path {w}x{h} {ch} "
                      "vs numpy", img.plane(ch),
                      torch.from_numpy(ref).to(DEV), exact=True)
    tally.compare("planes_ycbcr8_to_rgb", f"main path {w}x{h} RGB vs numpy",
                  rgb_of(rgb), torch.from_numpy(np_rgb(*ref_planes)).to(DEV),
                  exact=False)


# ------------------------------------------------------------------- timing

class DeviceTimer:
    """Device time of a call, from CUDA events around `n` back-to-back
    calls.  A sleep kernel queued first holds the card while the host
    queues them, so host overhead between calls is not counted."""

    def __init__(self):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        self.cycles_per_ms = 10_000_000 / s.elapsed_time(e)

    def __call__(self, fns, n=20):
        fns = list(fns)
        for f in fns:           # warm-up: allocator, first launch
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fns[i % len(fns)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda._sleep(int(2 * host_ms * self.cycles_per_ms) + 100_000)
        s.record()
        for i in range(n):
            fns[i % len(fns)]()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def vector_width_sweep(timer, rng, fused_kw, plane_copies):
    """The colour kernels at 4096^2 with their access widths forced:
    (load, store) bytes for tile_yuv_to_rgb on the flagship tile buffers
    (pitch 393,224; 16-byte loads need a 393,232 pitch), and the one
    width of planes_ycbcr8_to_rgb.  Same arithmetic, other access
    widths; each is checked exactly against the plain version first,
    and each is timed twice, in opposite orders."""
    th, tw = H // TILES, W // TILES
    n = th * tw * 3 // 2
    mat = cuda_fast._matrix(float(KR), float(KB), True)
    bufs = {pad: [torch.from_numpy(rng.integers(
        0, 256, (TILES * TILES, n + pad), dtype=np.uint8)).to(DEV)
        for _ in range(4)] for pad in (8, 16)}

    def tile(t, load, store):
        out = torch.empty((3, H, W), dtype=torch.uint8, device=DEV)
        cuda_fast.TILE_YUV_TO_RGB.launch(
            out, t.data_ptr(), out.data_ptr(), t.shape[1], TILES, TILES, th,
            tw, 2, 2, load, store, *mat)
        return out

    def planes(p, vec):
        out = torch.empty((3, H, W), dtype=torch.uint8, device=DEV)
        cuda_fast.PLANES_YCBCR8_TO_RGB.launch(
            out, *(t.data_ptr() for t in p), out.data_ptr(), H, W, H // 2,
            W // 2, cuda_fast.DOUBLE, cuda_fast.DOUBLE, 16, vec, *mat)
        return out

    cases = {f"tile_load{lo}_store{st}": (
        lambda lo=lo, st=st, pad=pad: [lambda t=t: tile(t, lo, st)
                                       for t in bufs[pad]])
        for lo, st, pad in ((16, 16, 16), (8, 16, 8), (8, 8, 8), (4, 4, 8),
                            (1, 16, 8), (1, 1, 8))}
    cases.update({f"planes_{v}": (
        lambda v=v: [lambda p=p: planes(p, v) for p in plane_copies])
        for v in (16, 8, 4, 1)})
    for name, fns in cases.items():
        if name.startswith("tile"):
            t = bufs[16 if "load16" in name else 8][0]
            ref = cuda_fast.yuv_tiles_to_rgb_plain(t, sub_x=2, sub_y=2,
                                                   **fused_kw)
        else:
            ref = cuda_fast.ycbcr8_planes_to_rgb_plain(
                *plane_copies[0], kr=float(KR), kb=float(KB))
        assert torch.equal(fns()[0](), ref), name
    out = {name: [] for name in cases}
    for name in list(cases) + list(cases)[::-1]:
        out[name].append(timer(cases[name]()))
    log(f"access widths {json.dumps(out)}")
    return out


def as_strided_copy(lay, t):
    """One PyTorch call per channel: a strided view of the (T, pitch)
    tile stack, made contiguous (the strided kernel's yardstick; the port
    never calls it).  16-bit samples are copied as int16 without the
    byte swap, so they move the same bytes but stay big-endian."""
    out = {}
    for v in lay.views:
        nb = v.depth // 8
        src = t if nb == 1 else t.view(torch.int16)
        p = src.shape[1]
        out[v.channel] = torch.as_strided(
            src, (lay.tile_rows, v.height, lay.tile_cols, v.width),
            (lay.tile_cols * p, v.row_stride_bits // 8 // nb, p,
             v.x_stride_bits // 8 // nb), v.base_bits // 8 // nb) \
            .contiguous().view(lay.tile_rows * v.height,
                               lay.tile_cols * v.width)
    return out


def same_samples(got, lib):
    """A plane of the strided kernel against its as_strided yardstick
    (16-bit: with the yardstick's bytes swapped)."""
    if got.dtype == torch.uint8:
        return torch.equal(got, lib)
    return torch.equal(got.view(torch.uint8).view(-1, 2),
                       lib.view(torch.uint8).view(-1, 2).flip(1))


def strided_width_sweep(timer, lay, inplace):
    """strided_extract_paste at 4096^2 on the payload at pitch S with its
    (load, store) widths forced, every pair: same work, other access
    widths; each is checked against the plain version first and timed
    twice, in opposite orders."""
    ref = cuda_fast.fused_strided_decode_plain(lay, inplace[0])
    cases = {}
    for vl in WIDTHS:
        for vs in WIDTHS:
            got = strided_forced(lay, inplace[0], (vl, vs))
            for ch in ref:
                assert torch.equal(got[ch], ref[ch]), (vl, vs, ch)
            cases[f"load{vl}_store{vs}"] = [
                lambda t=t, w=(vl, vs): strided_forced(lay, t, w)
                for t in inplace]
    out = {name: [] for name in cases}
    for name in list(cases) + list(cases)[::-1]:
        out[name].append(timer(cases[name]))
    log(f"strided widths {json.dumps(out)}")
    return out


def strided_layout_timings(timer):
    """strided_extract_paste on the other 4096^2 layouts of STRIDED_CASES
    (pixel-interleaved 8-bit RGB, component 16-bit RGB) at pitch S,
    beside their as_strided().contiguous() yardstick."""
    out = {}
    for i, (name, w, h, boxes) in enumerate(STRIDED_CASES):
        if w < W or name.startswith("comp420"):
            continue
        lay, data, _ = layout_and_tiles(w, h, boxes, seed=i)
        ts = [kernels.payload_tiles(lay, data, DEV) for _ in range(4)]
        got = cuda_fast.fused_strided_decode(lay, ts[0])
        for ch, p in as_strided_copy(lay, ts[0]).items():
            assert same_samples(got[ch], p), (name, ch)
        nbytes = ts[0].numel() + sum(p.numel() * p.element_size()
                                     for p in got.values())
        out[name] = {
            "ms": timer([lambda t=t: cuda_fast.fused_strided_decode(lay, t)
                         for t in ts]),
            "library_ms": timer([lambda t=t: as_strided_copy(lay, t)
                                 for t in ts]),
            "bound_ms": bound(nbytes, 0)[0], "bytes": nbytes,
            "widths": strided_widths(lay, ts[0])}
        del ts, got
    log(f"strided layouts {json.dumps(out)}")
    return out


# -------------------------------------------------------------------- main

def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    # 1. the card
    card = nvidia_smi()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.LIBRARY.load()
    log(f"built {_build.LIBRARY.path} in {time.perf_counter() - t0:.1f} s")
    for line in _build.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("ptxas:", line.strip())

    # 3. each kernel against its plain version
    tally = Tally()
    check_kernels(tally)
    small_input_check(tally)
    core_counts = check_colour_core()

    # 4. the main path at full width
    uncC, cmpd = ycc420(W, H, (TILES, TILES))
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 256, W * H * 3 // 2, dtype=np.uint8).tobytes()
    assemble = kernels.assemble_tile_buffers
    assembled = []

    def counted_assemble(*args):
        assembled.append(1)
        return assemble(*args)

    kernels.assemble_tile_buffers = counted_assemble
    try:
        for k in cuda_fast.KERNELS.values():
            k.launches = 0
        dec, img, rgb = decode_and_convert(uncC, cmpd, W, H, data)
        torch.cuda.synchronize()
        main_launches = {n: k.launches for n, k in cuda_fast.KERNELS.items()}
    finally:
        kernels.assemble_tile_buffers = assemble
    log(f"main path launches {main_launches}, assemble_tile_buffers calls "
        f"{len(assembled)}")
    for name in ("strided_extract_paste", "planes_ycbcr8_to_rgb"):
        assert main_launches[name] > 0, f"main path did not launch {name}"
    assert main_launches["strided_extract_paste"] == 1, \
        "strided_extract_paste: not one launch per decode"
    assert not assembled, "the CUDA strided path assembled tile buffers"
    lay = dec.layout
    tiles_np = kernels.assemble_tile_buffers(lay, data)
    tiles = torch.from_numpy(tiles_np).to(DEV)
    generic = kernels._build_extractor(kernels._layout_key(lay))(tiles)
    for ch, ref in zip((Channel.Y, Channel.Cb, Channel.Cr),
                       np_planes(data, TILES, W // TILES, H // TILES)):
        tally.compare("strided_extract_paste", f"main path {W}x{H} {ch}",
                      img.plane(ch), generic[ch], exact=True)
        assert np.array_equal(img.np_plane(ch), ref), f"{ch} vs numpy"
    try:
        YCbCrToRGB.USE_KERNEL = False        # the plain path on the card
        plain_rgb = convert_image(img, Colorspace.RGB, Chroma.C444)
    finally:
        YCbCrToRGB.USE_KERNEL = None
    out = rgb_of(rgb)
    assert out.shape == (3, H, W) and out.dtype == torch.uint8
    tally.compare("planes_ycbcr8_to_rgb", f"main path {W}x{H} RGB",
                  out, rgb_of(plain_rgb), exact=True)

    # 5. the fused tile path at full width
    fused_kw = dict(tile_rows=TILES, tile_cols=TILES, tile_h=H // TILES,
                    tile_w=W // TILES, kr=float(KR), kb=float(KB))
    for k in cuda_fast.KERNELS.values():
        k.launches = 0
    fused = cuda_fast.yuv420_tiles_to_rgb(tiles, **fused_kw)
    torch.cuda.synchronize()
    fused_launches = {n: k.launches for n, k in cuda_fast.KERNELS.items()}
    log(f"fused path launches {fused_launches}")
    assert fused_launches["tile_yuv_to_rgb"] > 0
    nearest = convert_image(img, Colorspace.RGB, Chroma.C444,
                            options=ColorConversionOptions(
                                chroma_upsampling="nearest-neighbor"))
    tally.compare("tile_yuv_to_rgb", f"fused {W}x{H} vs main path, nearest",
                  fused, rgb_of(nearest), exact=False)
    tally.compare("tile_yuv_to_rgb", f"fused {W}x{H} vs plain",
                  fused, cuda_fast.yuv_tiles_to_rgb_plain(
                      tiles, sub_x=2, sub_y=2, **fused_kw), exact=True)

    # 6. timing
    timer = DeviceTimer()
    copies = [tiles.clone() for _ in range(4)]    # 100 MB: inputs not in L2
    plane_copies = [tuple(img.plane(c).clone() for c in
                          (Channel.Y, Channel.Cb, Channel.Cr))
                    for _ in range(4)]
    px = W * H
    in_bytes = px * 3 // 2
    kern = {}

    # the colour kernels' yardstick: a device-to-device copy_ that moves
    # as many bytes (half read, half written), over four copies
    colour_bytes = in_bytes + 3 * px
    srcs = [torch.empty(colour_bytes // 2, dtype=torch.uint8, device=DEV)
            for _ in range(4)]
    dst = torch.empty_like(srcs[0])
    copy_ms = timer([lambda s=s: dst.copy_(s) for s in srcs])

    def row(name, replaces, also, launches, fn, plain, lib, nbytes, nops,
            extra=None):
        ms, plain_ms = timer(fn), timer(plain)
        lib_ms = timer(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        kern[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "also_replaces": also,
            "launches": launches, "max_abs_err": tally.max_abs_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "checks": tally.checks[name],
            "differing_pixels": tally.differing[name],
            "bytes": nbytes, "ops": nops, **(extra or {})}

    # f32 operations per output pixel: tile 20 (2 offsets, 9 matrix, 9
    # round/clip), planes 22 (+2 scale); limited range is not timed
    row("tile_yuv_to_rgb", f"{PALLAS}:124",
        [f"{PALLAS}:370"], fused_launches["tile_yuv_to_rgb"],
        [lambda t=t: cuda_fast.yuv420_tiles_to_rgb(t, **fused_kw)
         for t in copies],
        [lambda t=t: cuda_fast.yuv_tiles_to_rgb_plain(
            t, sub_x=2, sub_y=2, **fused_kw) for t in copies],
        None, colour_bytes, 20 * px, {"copy_ms": copy_ms})
    row("planes_ycbcr8_to_rgb", f"{PALLAS}:236", [f"{PALLAS}:144"],
        main_launches["planes_ycbcr8_to_rgb"],
        [lambda p=p: cuda_fast.ycbcr8_planes_to_rgb(*p, kr=float(KR),
                                                    kb=float(KB))
         for p in plane_copies],
        [lambda p=p: cuda_fast.ycbcr8_planes_to_rgb_plain(*p, kr=float(KR),
                                                          kb=float(KB))
         for p in plane_copies],
        None, colour_bytes, 22 * px, {"copy_ms": copy_ms})

    # strided_extract_paste on the main path's input, the payload read in
    # place at pitch S; the yardstick copy_ moves the same 50.3 MB
    inplace = [kernels.payload_tiles(lay, data, DEV) for _ in range(4)]
    for ch, p in as_strided_copy(lay, tiles).items():
        tally.compare("strided_extract_paste", f"as_strided yardstick {ch}",
                      img.plane(ch), p, exact=True)
    srcs = [torch.empty(in_bytes, dtype=torch.uint8, device=DEV)
            for _ in range(4)]
    dst = torch.empty_like(srcs[0])
    strided_copy_ms = timer([lambda s=s: dst.copy_(s) for s in srcs])
    del srcs, dst
    row("strided_extract_paste", f"{PALLAS}:401",
        [f"{PALLAS}:415", f"{PALLAS}:282"],
        main_launches["strided_extract_paste"],
        [lambda t=t: cuda_fast.fused_strided_decode(lay, t) for t in inplace],
        [lambda t=t: cuda_fast.fused_strided_decode_plain(lay, t)
         for t in inplace],
        [lambda t=t: as_strided_copy(lay, t) for t in inplace],
        2 * in_bytes, 0, {
            "copy_ms": strided_copy_ms,
            "widths_pitch_s": strided_widths(lay, inplace[0]),
            "ms_pitch_s_plus_8": timer([
                lambda t=t: cuda_fast.fused_strided_decode(lay, t)
                for t in copies]),
            "widths_pitch_s_plus_8": strided_widths(lay, copies[0])})
    strided_sweep = strided_width_sweep(timer, lay, inplace)
    strided_layouts = strided_layout_timings(timer)

    # planar8_tiles_to_image, the copy case of strided_extract_paste (off
    # the main path): three 8-bit planes in the same 8x8 grid of tiles
    th, tw = H // TILES, W // TILES
    planar_kw = dict(tile_rows=TILES, tile_cols=TILES, tile_h=th, tile_w=tw,
                     num_comps=3)
    planar = [torch.from_numpy(rng.integers(
        0, 256, (TILES * TILES, 3 * th * tw + 8), dtype=np.uint8)).to(DEV)
        for _ in range(4)]

    def planar_copy(t):
        # one PyTorch call: the tile stack viewed as (C, H, W), made
        # contiguous (the yardstick; the port never calls it)
        return t[:, :3 * th * tw].view(TILES, TILES, 3, th, tw) \
            .permute(2, 0, 3, 1, 4).reshape(3, H, W)

    tally.compare("strided_extract_paste", f"planar8 copy case {W}x{H} C=3",
                  cuda_fast.planar8_tiles_to_image(planar[0], **planar_kw),
                  planar_copy(planar[0]), exact=True)
    planar_bound_ms, _ = bound(2 * 3 * px, 0)
    widths = vector_width_sweep(timer, rng, fused_kw, plane_copies)
    before = cuda_fast.STRIDED_EXTRACT_PASTE.launches
    cuda_fast.planar8_tiles_to_image(planar[0], **planar_kw)
    planar_launches = cuda_fast.STRIDED_EXTRACT_PASTE.launches - before
    planar8 = {
        "ms": timer([lambda t=t: cuda_fast.planar8_tiles_to_image(
            t, **planar_kw) for t in planar]),
        "plain_ms": timer([lambda t=t: cuda_fast.planar8_tiles_to_image_plain(
            t, **planar_kw) for t in planar]),
        "library_ms": timer([lambda t=t: planar_copy(t) for t in planar]),
        "bound_ms": planar_bound_ms,
        "launches_per_call": planar_launches}
    del planar

    # the library path end to end, and its parts
    def e2e():
        _, _, r = decode_and_convert(uncC, cmpd, W, H, data)
        return r
    e2e()
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        e2e()
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1e3 / reps
    # the parts on the path: the payload's host view and its host→device
    # copy (kernels.payload_tiles), then the device time; tile assembly is
    # timed for comparison only (the generic program's layouts need it)
    t0 = time.perf_counter()
    for _ in range(reps):
        kernels.payload_tiles(lay, data, DEV)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        kernels.assemble_tile_buffers(lay, data)
    assemble_ms = (time.perf_counter() - t0) * 1e3 / reps
    device_ms = timer([lambda t=t: convert_image(
        dec._to_image(cuda_fast.fused_strided_decode(lay, t), W, H),
        Colorspace.RGB, Chroma.C444) for t in inplace])
    fused_ms = kern["tile_yuv_to_rgb"]["ms"]

    # 7. SASS instructions per output pixel of the colour kernels' flagship
    # instantiations (tile: 8-byte vectors, 4:2:0; planes: 16-byte vectors,
    # bilinear 2x2), and per output byte of the strided kernel's (16-byte
    # loads and stores; a thread moves kUnits x 16 = 128 bytes per item)
    sass = sass_count.cuobjdump_sass(str(_build.LIBRARY.path))
    for name, pattern, per in (("tile_yuv_to_rgb", SASS_TILE, 32),
                               ("planes_ycbcr8_to_rgb", SASS_PLANES, 32),
                               ("strided_extract_paste", SASS_STRIDED, 128)):
        c = sass_count.count(sass, pattern, per)
        log(f"sass {name} {json.dumps(c)}")
        kern[name]["sass_per_pixel" if per == 32 else "sass_per_byte"] = \
            c["per_pixel"]
    summary = {
        "card": card, "shape": f"{W}x{H} YCbCr 4:2:0, {TILES}x{TILES} tiles",
        "fused_yuv420_tiles_to_rgb_mps": px / 1e3 / fused_ms,
        "library_path_ms": e2e_ms, "library_path_mps": px / 1e3 / e2e_ms,
        "payload_to_device_ms": h2d_ms,
        "assemble_tile_buffers_ms_off_path": assemble_ms,
        "device_decode_convert_ms": device_ms,
        "planar8_tiles_to_image": planar8,
        "strided_width_ms": strided_sweep,
        "strided_layouts_4096": strided_layouts,
        "copy_ms": copy_ms, "access_width_ms": widths,
        "colour_core_mismatches": sum(core_counts.values()),
        "elapsed_s": time.perf_counter() - t_start}
    log("summary " + json.dumps(summary))
    print(json.dumps({"kernels": list(kern.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
