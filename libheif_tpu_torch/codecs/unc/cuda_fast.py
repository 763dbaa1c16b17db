"""Hand-written CUDA kernels of the unci decode + colour path, and their
plain PyTorch versions.

Counterpart of libheif_tpu/codecs/unc/pallas_fast.py: the wrappers keep
its function names and keyword arguments.  Three kernels in
``csrc/unc_kernels.cu`` cover its five ``pallas_call`` sites:

=====================  ==================================================
kernel                 wrappers
=====================  ==================================================
tile_yuv_to_rgb        yuv420_tiles_to_rgb, yuv_tiles_to_rgb
planes_ycbcr8_to_rgb   ycbcr8_planes_to_rgb
strided_extract_paste  fused_strided_decode, planar8_tiles_to_image
=====================  ==================================================

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs the plain PyTorch version beside it, which computes the
same function with the same f32 operations in the same order.  Every
kernel carries a launch count (``KERNELS[name].launches``).

Colour arithmetic follows libheif_tpu/color/ops.py:215-226 with the
H.273 constants folded in f64 and cast once to f32 (pallas_fast.py:75-81),
rounding half to even.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..._build import CudaKernel

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_MATRIX_ARGS = [_F] * 7 + [_I]

TILE_YUV_TO_RGB = CudaKernel(
    "tile_yuv_to_rgb", "launch_tile_yuv_to_rgb",
    [_P, _P, _L] + [_I] * 8 + _MATRIX_ARGS)
PLANES_YCBCR8_TO_RGB = CudaKernel(
    "planes_ycbcr8_to_rgb", "launch_planes_ycbcr8_to_rgb",
    [_P] * 4 + [_I] * 8 + _MATRIX_ARGS)
STRIDED_EXTRACT_PASTE = CudaKernel(
    "strided_extract_paste", "launch_strided_extract_paste",
    [_P, _L, _L, _I, _I, _I, _P, _I, _I])

KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (TILE_YUV_TO_RGB, PLANES_YCBCR8_TO_RGB,
                        STRIDED_EXTRACT_PASTE)}

# The exhaustive check of the colour kernels' f32 core against the
# straightforward per-pixel core (a check, not a kernel of any path).
COLOUR_CORE_CHECK = CudaKernel(
    "colour_core_check", "launch_colour_core_check",
    _MATRIX_ARGS + [_I, _P])

NEAREST = "nearest-neighbor"

# Chroma tap rules per axis of planes_ycbcr8_to_rgb (csrc/unc_kernels.cu).
GATHER, DOUBLE, HALF, SAME = 0, 1, 2, 3


# ------------------------------------------------------------------ checks

def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors
    (kernel); raises for anything else or for mixed devices."""
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t).__name__}")
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return False


def _check_u8(t: torch.Tensor, name: str, ndim: int = 2) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor")
    if t.dtype != torch.uint8 or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-D uint8 tensor, got "
                         f"{t.dim()}-D {t.dtype}")


def vector_width(*sizes: int) -> int:
    """The widest access of a colour kernel, 16, 8, 4 or 1 bytes, that
    divides every given row pitch, width, plane offset and address, so
    that each vector load and store is aligned."""
    for v in (16, 8, 4):
        if all(int(s) % v == 0 for s in sizes):
            return v
    return 1


def tile_vector_width(pitch: int, tile_w: int, sub_x: int, tile_cols: int,
                      *addresses: int) -> int:
    """Load width of tile_yuv_to_rgb: the tile buffer's pitch, the luma
    and chroma row widths (the plane offsets are multiples of them), the
    output row width, and the tile buffer's address."""
    return vector_width(pitch, tile_w, tile_w // sub_x, tile_cols * tile_w,
                        *addresses)


def tile_store_width(load: int, tile_w: int, tile_cols: int,
                     address: int) -> int:
    """Store width of tile_yuv_to_rgb: 16 bytes where the output rows
    allow it (the tile pitch constrains only the loads), else the load
    width."""
    return 16 if vector_width(tile_w, tile_cols * tile_w, address) == 16 \
        else load


def planes_vector_width(w: int, cw: int, *addresses: int) -> int:
    """Vector width of planes_ycbcr8_to_rgb: the luma/output and chroma
    row widths."""
    return vector_width(w, cw, *addresses)


class StridedView(NamedTuple):
    """One view of strided_extract_paste: ``h`` rows of ``w`` samples of
    ``bps`` big-endian bytes at byte offsets base + y*row_stride +
    x*x_stride of every tile buffer, pasted into the plane ``out``."""
    out: torch.Tensor
    base: int
    row_stride: int
    x_stride: int
    bps: int
    h: int
    w: int


def strided_load_width(pitch: int, address: int, views) -> int:
    """Load width of strided_extract_paste: the tile buffers' pitch and
    address and, for each contiguous view (x stride == bytes per sample),
    its base and row stride.  Pixel-interleaved views load bytes."""
    return vector_width(pitch, address, *(
        n for v in views if v.x_stride == v.bps
        for n in (v.base, v.row_stride)))


def strided_store_width(views) -> int:
    """Store width of strided_extract_paste, chosen apart from the loads:
    each view's output bytes per tile row and plane address."""
    return vector_width(*(n for v in views
                          for n in (v.w * v.bps, v.out.data_ptr())))


# ------------------------------------------------------------------ matrix

def _matrix(kr: float, kb: float, full_range: bool) -> Tuple:
    """H.273 constants folded in f64 then cast once to f32
    (pallas_fast.py:75-81), plus the limited-range scales."""
    f = np.float32
    return (float(f(kr)), float(f(kb)), float(f(2.0 * (1.0 - kr))),
            float(f(2.0 * (1.0 - kb))), float(f(1.0 - kr - kb)),
            float(f(255.0 / 219.0)), float(f(255.0 / 224.0)),
            int(bool(full_range)))


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE f32 division on every device.  PyTorch's CUDA
    division by a Python scalar multiplies by the reciprocal instead,
    which can differ in the last bit; a 0-dim tensor on x's device
    avoids that."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def _matrix_plain(yf, cbf, crf, kr, kb, full_range) -> torch.Tensor:
    """f32 planes (offset already removed from chroma) → (3, ...) uint8."""
    krf, kbf, c_cr, c_cb, g_den, y_mul, c_mul, _ = _matrix(kr, kb, full_range)
    if not full_range:
        yf = (yf - 16.0) * y_mul
        cbf = cbf * c_mul
        crf = crf * c_mul
    r = yf + c_cr * crf
    b = yf + c_cb * cbf
    g = true_div(yf - krf * r - kbf * b, g_den)
    rgb = torch.stack([r, g, b])
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)


# ------------------------------------------------- tile_yuv_to_rgb wrappers

def yuv_tiles_to_rgb(tiles_u8: torch.Tensor, *, tile_rows: int,
                     tile_cols: int, tile_h: int, tile_w: int, sub_x: int,
                     sub_y: int, kr: float, kb: float,
                     full_range: bool = True) -> torch.Tensor:
    """(T, S+pad) uint8 tile buffers → (3, H, W) uint8 RGB.

    Each tile buffer holds the Y plane (tile_h*tile_w bytes) then Cb then
    Cr ((tile_h/sub_y)*(tile_w/sub_x) bytes each): byte-aligned 8-bit
    component interleave at 4:2:0 (2, 2), 4:2:2 (2, 1) or 4:4:4 (1, 1),
    with nearest chroma upsampling.  Counterpart of
    pallas_fast.yuv_tiles_to_rgb.
    """
    _check_u8(tiles_u8, "tiles_u8")
    if sub_x not in (1, 2) or sub_y not in (1, 2):
        raise ValueError(f"sub_x, sub_y must be 1 or 2, got {sub_x}, {sub_y}")
    if tile_h % sub_y or tile_w % sub_x:
        raise ValueError(f"tile {tile_w}x{tile_h} not divisible by the "
                         f"chroma subsampling {sub_x}x{sub_y}")
    T = tile_rows * tile_cols
    need = tile_h * tile_w + 2 * (tile_h // sub_y) * (tile_w // sub_x)
    if tiles_u8.shape[0] != T or tiles_u8.shape[1] < need:
        raise ValueError(f"tiles_u8 has shape {tuple(tiles_u8.shape)}, "
                         f"need ({T}, >= {need})")
    if _on_cpu(tiles_u8):
        return yuv_tiles_to_rgb_plain(
            tiles_u8, tile_rows=tile_rows, tile_cols=tile_cols,
            tile_h=tile_h, tile_w=tile_w, sub_x=sub_x, sub_y=sub_y, kr=kr,
            kb=kb, full_range=full_range)
    out = torch.empty((3, tile_rows * tile_h, tile_cols * tile_w),
                      dtype=torch.uint8, device=tiles_u8.device)
    pitch = tiles_u8.shape[1]
    vec = tile_vector_width(pitch, tile_w, sub_x, tile_cols,
                            tiles_u8.data_ptr())
    TILE_YUV_TO_RGB.launch(
        out, tiles_u8.data_ptr(), out.data_ptr(), pitch, tile_rows,
        tile_cols, tile_h, tile_w, sub_x, sub_y, vec,
        tile_store_width(vec, tile_w, tile_cols, out.data_ptr()),
        *_matrix(kr, kb, full_range))
    return out


def yuv420_tiles_to_rgb(tiles_u8: torch.Tensor, *, tile_rows: int,
                        tile_cols: int, tile_h: int, tile_w: int, kr: float,
                        kb: float, full_range: bool = True) -> torch.Tensor:
    """4:2:0 case of :func:`yuv_tiles_to_rgb`; counterpart of
    pallas_fast.yuv420_tiles_to_rgb, the headline of bench.py."""
    return yuv_tiles_to_rgb(tiles_u8, tile_rows=tile_rows,
                            tile_cols=tile_cols, tile_h=tile_h, tile_w=tile_w,
                            sub_x=2, sub_y=2, kr=kr, kb=kb,
                            full_range=full_range)


def yuv_tiles_to_rgb_plain(tiles_u8, *, tile_rows, tile_cols, tile_h, tile_w,
                           sub_x, sub_y, kr, kb, full_range=True):
    """Plain PyTorch version of the tile_yuv_to_rgb kernel."""
    T = tile_rows * tile_cols
    ch, cw = tile_h // sub_y, tile_w // sub_x
    ys, cs = tile_h * tile_w, ch * cw
    y = tiles_u8[:, :ys].reshape(T, tile_h, tile_w)
    cb = tiles_u8[:, ys:ys + cs].reshape(T, ch, cw)
    cr = tiles_u8[:, ys + cs:ys + 2 * cs].reshape(T, ch, cw)

    def up(p):
        return (p.float() - 128.0).repeat_interleave(sub_y, 1) \
            .repeat_interleave(sub_x, 2)

    rgb = _matrix_plain(y.float(), up(cb), up(cr), kr, kb, full_range)
    return rgb.reshape(3, tile_rows, tile_cols, tile_h, tile_w) \
        .permute(0, 1, 3, 2, 4) \
        .reshape(3, tile_rows * tile_h, tile_cols * tile_w)


# --------------------------------------------- planes_ycbcr8_to_rgb wrapper

def _tap_rule(n: int, N: int, double: bool) -> int:
    """The kernel's tap rule for an axis of n chroma samples under N
    output samples.  A nearest axis with N in {2n, 2n - 1} is HALF:
    there (o*n)//N == o >> 1 for every o < N."""
    if double:
        return DOUBLE
    if n == N:
        return SAME
    if N in (2 * n, 2 * n - 1):
        return HALF
    return GATHER


def upsample_plan(h: int, w: int, out_h: int, out_w: int,
                  method: str) -> Tuple[int, int, int]:
    """(x_rule, y_rule, scale) of the integer chroma upsample of
    pallas_fast._upsample_int16: a bilinear axis doubles with the (3a+b)
    taps when 2n - N is 0 or 1 (DOUBLE, scale x4); every other axis
    gathers at (o*n)//N, as a shift (HALF), as itself (SAME) or through
    a table (GATHER)."""
    x_double = y_double = False
    if method != NEAREST and (h, w) != (out_h, out_w):
        x_double = out_w == 2 * w or (w * 2 - out_w in (0, 1))
        y_double = out_h == 2 * h or (2 * h - out_h in (0, 1))
    return (_tap_rule(w, out_w, x_double), _tap_rule(h, out_h, y_double),
            4 ** (x_double + y_double))


def ycbcr8_planes_to_rgb(y_u8: torch.Tensor, cb_u8: torch.Tensor,
                         cr_u8: torch.Tensor, *, kr: float, kb: float,
                         full_range: bool = True,
                         upsampling: str = "bilinear") -> torch.Tensor:
    """Whole-plane 8-bit YCbCr→RGB: (H,W) + (ch,cw)×2 → (3,H,W) uint8.

    Chroma upsampling is nearest or bilinear (any other method name is
    treated as bilinear, as in the JAX function), kept exact in integers
    and fused into the kernel.  Counterpart of
    pallas_fast.ycbcr8_planes_to_rgb, which ops.YCbCrToRGB dispatches to.
    """
    for t, name in ((y_u8, "y_u8"), (cb_u8, "cb_u8"), (cr_u8, "cr_u8")):
        _check_u8(t, name)
    if cb_u8.shape != cr_u8.shape:
        raise ValueError(f"Cb {tuple(cb_u8.shape)} and Cr "
                         f"{tuple(cr_u8.shape)} differ")
    if y_u8.numel() and not cb_u8.numel():
        raise ValueError("empty chroma planes for a non-empty luma plane")
    if _on_cpu(y_u8, cb_u8, cr_u8):
        return ycbcr8_planes_to_rgb_plain(y_u8, cb_u8, cr_u8, kr=kr, kb=kb,
                                          full_range=full_range,
                                          upsampling=upsampling)
    H, W = y_u8.shape
    ch, cw = cb_u8.shape
    x_rule, y_rule, scale = upsample_plan(ch, cw, H, W, upsampling)
    out = torch.empty((3, H, W), dtype=torch.uint8, device=y_u8.device)
    ptrs = [t.data_ptr() for t in (y_u8, cb_u8, cr_u8, out)]
    PLANES_YCBCR8_TO_RGB.launch(
        out, *ptrs, H, W, ch, cw, x_rule, y_rule, scale,
        planes_vector_width(W, cw, *ptrs), *_matrix(kr, kb, full_range))
    return out


def colour_core_mismatches(kr: float, kb: float, full_range: bool,
                           scale: int, device=None) -> int:
    """On the card: the number of (Y, Cb, Cr) inputs, over all of Y in
    0..255 and scaled Cb, Cr in 0..255*scale, where the colour kernels'
    f32 core and the straightforward per-pixel core (rintf, fminf/fmaxf,
    IEEE division) give different RGB bytes."""
    count = torch.zeros(1, dtype=torch.int64,
                        device=device if device is not None else "cuda")
    if _on_cpu(count):
        raise ValueError("colour_core_mismatches runs on a CUDA device")
    COLOUR_CORE_CHECK.launch(count, *_matrix(kr, kb, full_range), scale,
                             count.data_ptr())
    return int(count.item())


def _upsample_int_plain(p: torch.Tensor, out_h: int, out_w: int,
                        method: str) -> Tuple[torch.Tensor, int]:
    """pallas_fast._upsample_int16 in PyTorch: (plane_i32, scale)."""
    a = p.to(torch.int32)
    h, w = a.shape
    dev = a.device
    if method == NEAREST or (h == out_h and w == out_w):
        if (h, w) != (out_h, out_w):
            ys = (torch.arange(out_h, device=dev) * h) // out_h
            xs = (torch.arange(out_w, device=dev) * w) // out_w
            a = a[ys[:, None], xs[None, :]]
        return a, 1
    scale = 1
    if out_w == 2 * w or (w * 2 - out_w in (0, 1)):
        left = torch.cat([a[:, :1], a[:, :-1]], dim=1)
        right = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
        a = torch.stack([3 * a + left, 3 * a + right], dim=-1) \
            .reshape(h, 2 * w)[:, :out_w]
        scale *= 4
    elif out_w != w:
        a = a[:, (torch.arange(out_w, device=dev) * w) // out_w]
    h2 = a.shape[0]
    if out_h == 2 * h2 or (2 * h2 - out_h in (0, 1)):
        top = torch.cat([a[:1], a[:-1]], dim=0)
        bottom = torch.cat([a[1:], a[-1:]], dim=0)
        a = torch.stack([3 * a + top, 3 * a + bottom], dim=1) \
            .reshape(2 * h2, a.shape[1])[:out_h]
        scale *= 4
    elif out_h != h2:
        a = a[(torch.arange(out_h, device=dev) * h2) // out_h]
    return a, scale


def ycbcr8_planes_to_rgb_plain(y_u8, cb_u8, cr_u8, *, kr, kb,
                               full_range=True, upsampling="bilinear"):
    """Plain PyTorch version of the planes_ycbcr8_to_rgb kernel."""
    H, W = y_u8.shape
    cb, scale = _upsample_int_plain(cb_u8, H, W, upsampling)
    cr, _ = _upsample_int_plain(cr_u8, H, W, upsampling)
    inv = float(np.float32(1.0 / scale))
    return _matrix_plain(y_u8.float(), cb.float() * inv - 128.0,
                         cr.float() * inv - 128.0, kr, kb, full_range)


# ------------------------------------------- strided_extract_paste wrappers

def _strided_gate(layout) -> bool:
    """The layouts pallas_fast.fused_strided_decode accepts
    (pallas_fast.py:428-453): byte-aligned big-endian 8/16-bit samples
    at constant strides, one view per channel."""
    if layout.comp_tile_sizes is not None:
        return False
    views = layout.views
    if not views or any(not v.channel for v in views):
        return False
    for v in views:
        if getattr(v, "multi_y_phase", None) is not None:
            return False
        if v.col_offsets is not None:
            return False
        if v.depth not in (8, 16) or v.read_bits != v.depth:
            return False
        if v.le_bytes:
            return False
        if v.mask != (1 << v.depth) - 1:
            return False
        if v.base_bits % 8 or v.row_stride_bits % 8 or v.x_stride_bits % 8:
            return False
    channels = [v.channel for v in views]
    return len(set(channels)) == len(channels)


MAX_VIEWS = 16     # views of one launch (kMaxViews, csrc/unc_kernels.cu)


def strided_extract_paste(tiles_u8: torch.Tensor, size: int, tile_rows: int,
                          tile_cols: int, views: Sequence[StridedView],
                          widths: Optional[Tuple[int, int]] = None) -> None:
    """Launch strided_extract_paste on CUDA tiles for all ``views`` at
    once (one launch per MAX_VIEWS views).  ``widths`` forces the (load,
    store) vector widths; by default they are the widest the alignment
    allows (strided_load_width, strided_store_width)."""
    views = [v for v in views if v.out.numel()]
    if not views:
        return
    pitch = tiles_u8.shape[1]
    load, store = widths or (
        strided_load_width(pitch, tiles_u8.data_ptr(), views),
        strided_store_width(views))
    for i in range(0, len(views), MAX_VIEWS):
        part = views[i:i + MAX_VIEWS]
        table = (ctypes.c_longlong * (7 * len(part)))(*(
            n for v in part for n in (v.out.data_ptr(), v.base, v.row_stride,
                                      v.x_stride, v.bps, v.h, v.w)))
        STRIDED_EXTRACT_PASTE.launch(
            part[0].out, tiles_u8.data_ptr(), pitch, size, tile_rows,
            tile_cols, len(part), ctypes.addressof(table), load, store)


def strided_views(layout, device) -> Dict[str, StridedView]:
    """Channel → the kernel's view of it, with a new output plane on
    ``device`` (layouts that passed _strided_gate)."""
    out = {}
    for v in layout.views:
        nbytes = v.depth // 8
        plane = torch.empty(
            (layout.tile_rows * v.height, layout.tile_cols * v.width),
            dtype=torch.uint8 if nbytes == 1 else torch.uint16,
            device=device)
        out[v.channel] = StridedView(plane, v.base_bits // 8,
                                     v.row_stride_bits // 8,
                                     v.x_stride_bits // 8, nbytes, v.height,
                                     v.width)
    return out


def fused_strided_decode(layout, tiles_u8: torch.Tensor
                         ) -> Optional[Dict[str, torch.Tensor]]:
    """Decode byte-aligned uniform-stride layouts (component, pixel and
    row interleave, 8/16-bit, any sampling) to dict channel → full plane
    (uint8 or uint16), pasting each tile at its place.  Returns None for
    the layouts that need the generic bit-gather program, exactly where
    pallas_fast.fused_strided_decode does.  ``tiles_u8`` is (T, pitch)
    with pitch >= the tile size: the padded tile buffers, or the payload
    itself (kernels.payload_tiles).  One launch for all channels."""
    if not _strided_gate(layout):
        return None
    _check_u8(tiles_u8, "tiles_u8")
    s = layout.tile_size_bytes
    if tiles_u8.shape[0] != layout.num_tiles or tiles_u8.shape[1] < s:
        raise ValueError(f"tiles_u8 has shape {tuple(tiles_u8.shape)}, need "
                         f"({layout.num_tiles}, >= {s})")
    if _on_cpu(tiles_u8):
        return fused_strided_decode_plain(layout, tiles_u8)
    views = strided_views(layout, tiles_u8.device)
    strided_extract_paste(tiles_u8, s, layout.tile_rows, layout.tile_cols,
                          list(views.values()))
    return {ch: v.out for ch, v in views.items()}


def _paste_plain(arr: torch.Tensor, tile_rows: int,
                 tile_cols: int) -> torch.Tensor:
    """(T, h, w) per-tile planes → (rows*h, cols*w)."""
    _, h, w = arr.shape
    return arr.reshape(tile_rows, tile_cols, h, w).permute(0, 2, 1, 3) \
        .reshape(tile_rows * h, tile_cols * w)


def fused_strided_decode_plain(layout, tiles_u8):
    """Plain PyTorch version of fused_strided_decode's kernel, sliced as
    pallas_fast.py:455-478 slices (assumes the gate passed)."""
    t = layout.num_tiles
    s = layout.tile_size_bytes
    data = tiles_u8[:, :s]
    out = {}
    for v in layout.views:
        base = v.base_bits // 8
        rs = v.row_stride_bits // 8
        xs = v.x_stride_bits // 8
        rows = data[:, base:min(base + v.height * rs, s)]
        pad = v.height * rs - rows.shape[1]
        if pad > 0:      # the last row may end before the row stride does
            rows = torch.nn.functional.pad(rows, (0, pad))
        cols = rows.reshape(t, v.height, rs)[:, :, :v.width * xs] \
            .reshape(t, v.height, v.width, xs)
        if v.depth == 8:
            plane = cols[..., 0]
        else:
            plane = ((cols[..., 0].to(torch.int32) << 8)
                     | cols[..., 1].to(torch.int32)).to(torch.uint16)
        out[v.channel] = _paste_plain(plane, layout.tile_rows,
                                      layout.tile_cols)
    return out


def planar8_tiles_to_image(tiles_u8: torch.Tensor, *, tile_rows: int,
                           tile_cols: int, tile_h: int, tile_w: int,
                           num_comps: int) -> torch.Tensor:
    """(T, S+pad) uint8 planar tiles → (C, H, W) uint8: the copy case of
    strided_extract_paste (x stride 1, row stride tile_w, one view per
    component, one launch).  Counterpart of
    pallas_fast.planar8_tiles_to_image."""
    _check_u8(tiles_u8, "tiles_u8")
    T = tile_rows * tile_cols
    ps = tile_h * tile_w
    if tiles_u8.shape[0] != T or tiles_u8.shape[1] < num_comps * ps:
        raise ValueError(f"tiles_u8 has shape {tuple(tiles_u8.shape)}, need "
                         f"({T}, >= {num_comps * ps})")
    if _on_cpu(tiles_u8):
        return planar8_tiles_to_image_plain(
            tiles_u8, tile_rows=tile_rows, tile_cols=tile_cols,
            tile_h=tile_h, tile_w=tile_w, num_comps=num_comps)
    out = torch.empty((num_comps, tile_rows * tile_h, tile_cols * tile_w),
                      dtype=torch.uint8, device=tiles_u8.device)
    strided_extract_paste(
        tiles_u8, num_comps * ps, tile_rows, tile_cols,
        [StridedView(out[c], c * ps, tile_w, 1, 1, tile_h, tile_w)
         for c in range(num_comps)])
    return out


def planar8_tiles_to_image_plain(tiles_u8, *, tile_rows, tile_cols, tile_h,
                                 tile_w, num_comps):
    """Plain PyTorch version of planar8_tiles_to_image."""
    T = tile_rows * tile_cols
    planes = tiles_u8[:, :num_comps * tile_h * tile_w].reshape(
        T, num_comps, tile_h, tile_w)
    return torch.stack([_paste_plain(planes[:, c], tile_rows, tile_cols)
                        for c in range(num_comps)])
