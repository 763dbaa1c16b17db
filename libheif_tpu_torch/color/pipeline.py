"""Colour conversion pipeline: minimum-cost op-chain search.

Counterpart of libheif_tpu/color/pipeline.py (reference:
libheif/color-conversion/colorconversion.{h,cc} — ColorConversionPipeline
colorconversion.h:103, Dijkstra search colorconversion.cc:302), over this
package's own ``ALL_OPS``: the JAX package's ops, in its order and with
its costs, so both packages pick the same chain.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

from ..core.error import HeifError, SubError
from ..core.trace import span
from ..image.pixel_image import PixelImage, Colorspace, Chroma
from .state import ColorState
from .ops import ALL_OPS, ColorOp, ColorConversionOptions

_MAX_CHAIN = 6


def find_pipeline(inp: ColorState, target: ColorState,
                  options: Optional[ColorConversionOptions] = None
                  ) -> Optional[List[Tuple[ColorOp, ColorState]]]:
    """Dijkstra over (state) nodes; returns [(op, out_state), ...]."""
    if inp.matches(target):
        return []
    ops = [op for op in ALL_OPS if op.enabled(options)]
    counter = 0
    heap = [(0, counter, inp, [])]
    best = {inp: 0}
    while heap:
        cost, _, state, chain = heapq.heappop(heap)
        if len(chain) >= _MAX_CHAIN:
            continue
        for op in ops:
            out = op.output_state(state, target)
            if out is None:
                continue
            ncost = cost + op.cost
            if best.get(out, 1 << 30) <= ncost:
                continue
            nchain = chain + [(op, out)]
            if out.matches(target):
                return nchain
            best[out] = ncost
            counter += 1
            heapq.heappush(heap, (ncost, counter, out, nchain))
    return None


def convert_image(img: PixelImage,
                  target_colorspace: str = Colorspace.Undefined,
                  target_chroma: str = Chroma.Undefined,
                  target_has_alpha: Optional[bool] = None,
                  target_bits: int = 0,
                  target_matrix: int = 0,
                  target_full_range: Optional[bool] = None,
                  options: Optional[ColorConversionOptions] = None,
                  device=None) -> PixelImage:
    """Convert `img` to the requested color state on ``device``
    (``None`` means CUDA); the image's planes are moved there first
    (ref: convert_colorspace colorconversion.cc / context.cc:1515)."""
    img = img.to_device(device)
    options = options or ColorConversionOptions()
    inp = ColorState.of(img)
    if target_chroma == Chroma.InterleavedRGBA:
        target_has_alpha = True      # the packed format carries alpha
    elif target_chroma == Chroma.InterleavedRGB:
        target_has_alpha = False
    target = ColorState(
        colorspace=target_colorspace,
        chroma=target_chroma,
        has_alpha=img.has_alpha() if target_has_alpha is None
        else target_has_alpha,
        bits_per_pixel=target_bits,
        matrix_coefficients=target_matrix,
        color_primaries=inp.color_primaries,
        full_range=inp.full_range if target_full_range is None
        else target_full_range,
    )
    chain = find_pipeline(inp, target, options)
    if chain is None:
        raise HeifError.unsupported(
            SubError.Unsupported_color_conversion,
            f"no conversion from {inp} to {target}")
    state = inp
    for op, out_state in chain:
        with span(f"color.{type(op).__name__}"):
            img = op.apply(img, state, out_state, options)
        img.colorspace = out_state.colorspace
        img.chroma = out_state.chroma
        state = out_state
    return img
