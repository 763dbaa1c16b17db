"""ISO 23001-17 tile layout computation: interleave → affine addressing.

This is the TPU-first re-design of the reference's six decoder classes
(reference: libheif/codecs/uncompressed/unc_decoder_*.cc — component
:103, pixel, mixed, row, block-pixel, block-component, bytealign).

Instead of per-sample bit-reader loops, every interleave mode reduces to
*affine bit addressing*: for each component, the bit position of sample
(x, y) inside a tile buffer is

    bitpos(x, y) = base_bits + y * row_stride_bits + x * x_stride_bits

with a static ``read_bits``/``mask``/byte-assembly rule.  The host
computes these static parameters once per layout; extraction on device
is a single vectorized gather+shift kernel batched over tiles
(see kernels.py).  This covers component/tile-component/pixel/row/mixed
interleaves, bit-packed samples (e.g. R7G7B7, R5G6B5), component
alignment, block packing with pad_lsb/little-endian/reversed flags, and
row/tile alignment — the exact semantics of the reference's row engine
(unc_decoder_legacybase.cc:90-135: MSB-first reads, per-sample
alignment padding, byte alignment at row ends).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ...core.error import HeifError, SubError
from ...boxes.unc import (
    Box_uncC, Box_cmpd, InterleaveMode, SamplingMode, ComponentFormat,
)
from ...image.pixel_image import (
    Channel, Colorspace, Chroma, COMPONENT_TYPE_TO_CHANNEL,
)


def _align_up(v: int, alignment: int) -> int:
    """skip_to_alignment (ref: unc_decoder_legacybase.h:120)."""
    if alignment == 0:
        return v
    r = v % alignment
    return v if r == 0 else v + alignment - r


@dataclass
class ComponentView:
    """Static addressing for one component within one tile buffer.

    Sample (x, y) of this component lives at bit position

        base_bits + y * row_stride_bits + X(x)

    where X(x) = x * x_stride_bits, or col_offsets[x] when the
    within-row positions are non-uniform (pixel interleave with mixed
    component alignment causes byte realignment mid-pixel, making the
    pixel stride cycle rather than stay constant — see
    unc_decoder_pixel_interleave.cc:88-99 skip_to_byte_boundary)."""

    comp_index: int            # index into uncC component list
    channel: str               # Channel.* name, or "" if not mapped to output
    depth: int                 # component bit depth
    width: int                 # subsampled tile width for this component
    height: int                # subsampled tile height
    base_bits: int
    row_stride_bits: int
    x_stride_bits: int
    read_bits: int             # bits to read at bitpos (BE path)
    mask: int
    le_bytes: int = 0          # >0: assemble N bytes little-endian instead
    le_shift: int = 0          # right-shift after LE assembly
    col_offsets: Optional[tuple] = None  # per-x bit offsets (overrides x_stride)

    @property
    def out_dtype_bits(self) -> int:
        return 8 if self.depth <= 8 else 16


@dataclass
class UncLayout:
    """Complete decode plan for one unci image."""

    width: int
    height: int
    tile_cols: int
    tile_rows: int
    tile_width: int
    tile_height: int
    views: List[ComponentView]
    tile_size_bytes: int                     # contiguous tile size (modes 0-3,5)
    comp_tile_sizes: Optional[List[int]] = None  # per-component (mode 4)
    colorspace: str = Colorspace.Undefined
    chroma: str = Chroma.Undefined
    interleave: InterleaveMode = InterleaveMode.component

    @property
    def num_tiles(self) -> int:
        return self.tile_cols * self.tile_rows

    def total_data_size(self) -> int:
        if self.comp_tile_sizes is not None:
            return sum(self.comp_tile_sizes) * self.num_tiles
        return self.tile_size_bytes * self.num_tiles


def _component_channel(uncC: Box_uncC, cmpd: Box_cmpd, comp_idx: int) -> Tuple[str, int]:
    """(channel name, cmpd component type) for a uncC component
    (ref: map_uncompressed_component_to_channel, unc_codec.cc:152)."""
    ci = uncC.components[comp_idx].component_index
    if ci >= len(cmpd.components):
        raise HeifError.invalid_input(
            SubError.Invalid_parameter_value,
            f"uncC component index {ci} out of range of cmpd")
    ctype = cmpd.components[ci].component_type
    channel = COMPONENT_TYPE_TO_CHANNEL.get(ctype, "")
    return channel, ctype


def determine_chroma(uncC: Box_uncC, cmpd: Box_cmpd) -> Tuple[str, str]:
    """Determine (colorspace, chroma) from the component set
    (ref: get_heif_chroma_uncompressed, unc_codec.cc)."""
    types = set()
    for c in uncC.components:
        if c.component_index < len(cmpd.components):
            types.add(cmpd.components[c.component_index].component_type)

    has_rgb = {4, 5, 6} <= types
    has_ycbcr = {1, 2, 3} <= types
    has_mono = 0 in types or (1 in types and not has_ycbcr)

    if has_rgb:
        return Colorspace.RGB, Chroma.C444
    if has_ycbcr:
        if uncC.sampling_type == SamplingMode.no_subsampling:
            return Colorspace.YCbCr, Chroma.C444
        if uncC.sampling_type == SamplingMode.s422:
            return Colorspace.YCbCr, Chroma.C422
        if uncC.sampling_type == SamplingMode.s420:
            return Colorspace.YCbCr, Chroma.C420
        raise HeifError.unsupported(SubError.Unsupported_image_type,
                                    "4:1:1 sampling not yet supported")
    if has_mono:
        return Colorspace.Monochrome, Chroma.Monochrome
    if 11 in types:      # CFA mosaic plane (ref: heif_colorspace_filter_array)
        return Colorspace.FilterArray, Chroma.Monochrome
    return Colorspace.Nonvisual, Chroma.Undefined


def _subsampled_tile_dims(channel: str, uncC: Box_uncC,
                          tw: int, th: int) -> Tuple[int, int]:
    """Per-channel tile dims (ref: buildChannelListEntry,
    unc_decoder_legacybase.cc:139-170: integer division)."""
    if channel in (Channel.Cb, Channel.Cr):
        if uncC.sampling_type == SamplingMode.s422:
            return tw // 2, th
        if uncC.sampling_type == SamplingMode.s420:
            return tw // 2, th // 2
        if uncC.sampling_type == SamplingMode.s411:
            return tw // 4, th
    return tw, th


def compute_layout(uncC: Box_uncC, cmpd: Box_cmpd,
                   width: int, height: int) -> UncLayout:
    """Build the affine decode plan.  Raises Unsupported_feature for
    combinations the engine does not handle yet (float/complex/palette
    components, 4:1:1)."""

    if uncC.version == 1:
        uncC = expand_v1_profile(uncC)

    if uncC.num_tile_cols == 0 or uncC.num_tile_rows == 0 or \
            width % uncC.num_tile_cols or height % uncC.num_tile_rows:
        raise HeifError.invalid_input(
            SubError.Invalid_parameter_value,
            f"image {width}x{height} not divisible into "
            f"{uncC.num_tile_cols}x{uncC.num_tile_rows} tiles")
    tw = width // uncC.num_tile_cols
    th = height // uncC.num_tile_rows

    for c in uncC.components:
        if c.component_format != ComponentFormat.unsigned:
            raise HeifError.unsupported(
                SubError.Unsupported_image_type,
                "only unsigned integer components supported currently")
        if c.component_bit_depth > 16:
            raise HeifError.unsupported(
                SubError.Unsupported_bit_depth,
                f"component depth {c.component_bit_depth} > 16")

    colorspace, chroma = determine_chroma(uncC, cmpd)
    mode = uncC.interleave_type

    if mode in (InterleaveMode.component, InterleaveMode.tile_component):
        layout = _layout_component(uncC, cmpd, tw, th)
    elif mode == InterleaveMode.pixel:
        layout = _layout_pixel(uncC, cmpd, tw, th)
    elif mode == InterleaveMode.row:
        layout = _layout_row(uncC, cmpd, tw, th)
    elif mode == InterleaveMode.mixed:
        layout = _layout_mixed(uncC, cmpd, tw, th)
    elif mode == InterleaveMode.multi_y:
        layout = _layout_multi_y(uncC, cmpd, tw, th)
    else:
        raise HeifError.unsupported(SubError.Unsupported_image_type,
                                    f"interleave mode {mode}")

    views, tile_size, comp_sizes = layout
    return UncLayout(
        width=width, height=height,
        tile_cols=uncC.num_tile_cols, tile_rows=uncC.num_tile_rows,
        tile_width=tw, tile_height=th,
        views=views, tile_size_bytes=tile_size, comp_tile_sizes=comp_sizes,
        colorspace=colorspace, chroma=chroma, interleave=mode,
    )


def _slot_bits(depth: int, align: int) -> int:
    """Bits a sample occupies: align pads to whole bytes
    (ref: processComponentRow pad-bit skipping)."""
    if align:
        return _align_up((depth + 7) // 8, align) * 8
    return depth


def _block_view_params(uncC: Box_uncC, comp_idx: int, block_bits: int,
                       shifts: List[int]) -> Tuple[int, int, int, int]:
    """(bit offset inside block, read_bits, le_bytes, le_shift) for a
    component packed in a block (ref: unc_decoder_block_*_interleave.cc
    shift/mask computation)."""
    depth = uncC.components[comp_idx].component_bit_depth
    shift = shifts[comp_idx]
    if uncC.block_little_endian:
        lo_byte = shift // 8
        hi_byte = (shift + depth - 1) // 8
        n = hi_byte - lo_byte + 1
        return lo_byte * 8, depth, n, shift - lo_byte * 8
    # big-endian block: value occupies BE bit range
    return block_bits - shift - depth, depth, 0, 0


def _block_shifts(uncC: Box_uncC, block_bits: int,
                  per_component_blocks: bool) -> List[int]:
    """LSB shift of each component inside its block
    (ref: block_component_interleave.cc:99, block_pixel_interleave.cc:112)."""
    n = len(uncC.components)
    shifts = [0] * n
    if per_component_blocks:
        for i, c in enumerate(uncC.components):
            shifts[i] = (block_bits - c.component_bit_depth
                         if uncC.block_pad_lsb else 0)
        return shifts
    if not uncC.block_pad_lsb:
        bit_offset = 0
        for i in range(n):
            idx = i if uncC.block_reversed else (n - 1 - i)
            shifts[idx] = bit_offset
            bit_offset += uncC.components[idx].component_bit_depth
    else:
        bit_offset = block_bits
        for i in range(n):
            idx = i if uncC.block_reversed else (n - 1 - i)
            bit_offset -= uncC.components[idx].component_bit_depth
            shifts[idx] = bit_offset
    return shifts


def _sample_view(depth: int, align: int, components_le: bool
                 ) -> Tuple[int, int, int, int, int]:
    """(bit offset within slot, read_bits, le_bytes, le_shift, slot_bits)
    for a non-block sample."""
    slot = _slot_bits(depth, align)
    if components_le and depth > 8:
        # sample stored little-endian in ceil(depth/8) bytes at slot end
        nbytes = (depth + 7) // 8
        return slot - nbytes * 8, depth, nbytes, 0, slot
    # MSB-first: pad bits first, value in the low `depth` bits of the slot
    return slot - depth, depth, 0, 0, slot


def _layout_component(uncC: Box_uncC, cmpd: Box_cmpd, tw: int, th: int):
    """Component + tile-component interleave
    (ref: unc_decoder_component_interleave.cc:29-140,
    unc_decoder_block_component_interleave.cc)."""
    views: List[ComponentView] = []
    comp_sizes: List[int] = []
    base = 0  # bits, from tile buffer start
    block = uncC.block_size
    shifts = _block_shifts(uncC, block * 8, True) if block else None

    for i, c in enumerate(uncC.components):
        channel, ctype = _component_channel(uncC, cmpd, i)
        cw, ch = _subsampled_tile_dims(channel, uncC, tw, th)
        if block:
            off, read, le_b, le_s = _block_view_params(uncC, i, block * 8, shifts)
            x_stride = block * 8
            row_bytes = _align_up(block * cw, uncC.row_align_size)
        else:
            off, read, le_b, le_s, slot = _sample_view(
                c.component_bit_depth, c.component_align_size,
                uncC.components_little_endian)
            x_stride = slot
            row_bytes = _align_up((slot * cw + 7) // 8, uncC.row_align_size)
        views.append(ComponentView(
            comp_index=i, channel=channel, depth=c.component_bit_depth,
            width=cw, height=ch,
            base_bits=base + off, row_stride_bits=row_bytes * 8,
            x_stride_bits=x_stride, read_bits=read,
            mask=(1 << c.component_bit_depth) - 1,
            le_bytes=le_b, le_shift=le_s))
        plane_size = row_bytes * ch
        if uncC.interleave_type == InterleaveMode.tile_component:
            comp_sizes.append(_align_up(plane_size, uncC.tile_align_size))
            base = 0  # each component chunk re-based (concatenated on fetch)
        else:
            base += plane_size * 8

    if uncC.interleave_type == InterleaveMode.tile_component:
        # rebase views: concatenated per-component chunks
        acc = 0
        for v, sz in zip(views, comp_sizes):
            v.base_bits += acc * 8
            acc += sz
        return views, 0, comp_sizes

    tile_size = _align_up(base // 8, uncC.tile_align_size)
    return views, tile_size, None


def _layout_pixel(uncC: Box_uncC, cmpd: Box_cmpd, tw: int, th: int):
    """Pixel interleave, incl. block-packed pixels
    (ref: unc_decoder_pixel_interleave.cc:29-115,
    unc_decoder_block_pixel_interleave.cc:64-135)."""
    if uncC.sampling_type != SamplingMode.no_subsampling:
        raise HeifError.unsupported(SubError.Unsupported_image_type,
                                    "subsampled pixel interleave")
    views: List[ComponentView] = []
    block = uncC.block_size
    block_flags = (uncC.block_pad_lsb or uncC.block_little_endian or
                   uncC.block_reversed)
    # Factory-order semantics (ref: unc_decoder.cc:437): the plain pixel
    # decoder wins whenever block_size==0 and no block flags are set —
    # pixel_size is then pure trailing padding.  The block-pixel path
    # applies only for real block packing.
    if block or block_flags:
        bsz = block if block else uncC.pixel_size
        if bsz == 0:
            raise HeifError.unsupported(
                SubError.Unsupported_image_type,
                "block flags set without block/pixel size")
        shifts = _block_shifts(uncC, bsz * 8, False)
        pixel_stride = (uncC.pixel_size if uncC.pixel_size else bsz) * 8
        for i, c in enumerate(uncC.components):
            channel, _ = _component_channel(uncC, cmpd, i)
            off, read, le_b, le_s = _block_view_params(uncC, i, bsz * 8, shifts)
            views.append(ComponentView(
                comp_index=i, channel=channel, depth=c.component_bit_depth,
                width=tw, height=th,
                base_bits=off, row_stride_bits=0,  # filled below
                x_stride_bits=pixel_stride, read_bits=read,
                mask=(1 << c.component_bit_depth) - 1,
                le_bytes=le_b, le_shift=le_s))
        row_bytes = _align_up(pixel_stride // 8 * tw, uncC.row_align_size)
    else:
        # Sequential per-pixel component fields.  Exactly replicate the
        # reference bit reader: each aligned component skips to a byte
        # boundary *at its current position*, so with mixed alignment the
        # pixel stride is not constant.  Simulate the whole row once
        # host-side and record explicit per-column offsets.
        field_meta = []
        for c in uncC.components:
            field_meta.append(_sample_view(
                c.component_bit_depth, c.component_align_size,
                uncC.components_little_endian))
        per_comp_offsets: List[List[int]] = [[] for _ in uncC.components]
        pos = 0
        for _x in range(tw):
            pixel_start_byte = pos // 8
            for i, c in enumerate(uncC.components):
                off, read, le_b, le_s, slot = field_meta[i]
                if c.component_align_size:
                    pos = _align_up(pos, 8)
                per_comp_offsets[i].append(pos + off)
                pos += slot
            if uncC.pixel_size:
                # handlePixelAlignment: pad pixel to pixel_size bytes
                pos = _align_up(pos, 8)
                bytes_in_pixel = pos // 8 - pixel_start_byte
                if uncC.pixel_size > bytes_in_pixel:
                    pos += (uncC.pixel_size - bytes_in_pixel) * 8
                elif uncC.pixel_size < bytes_in_pixel:
                    raise HeifError.invalid_input(
                        SubError.Invalid_parameter_value,
                        "uncC pixel_size smaller than pixel data")
        row_bytes = _align_up((pos + 7) // 8, uncC.row_align_size)

        for i, c in enumerate(uncC.components):
            channel, _ = _component_channel(uncC, cmpd, i)
            off0, read, le_b, le_s, slot = field_meta[i]
            offs = per_comp_offsets[i]
            uniform = (len(offs) < 2 or
                       all(offs[k + 1] - offs[k] == offs[1] - offs[0]
                           for k in range(len(offs) - 1)))
            views.append(ComponentView(
                comp_index=i, channel=channel, depth=c.component_bit_depth,
                width=tw, height=th,
                base_bits=offs[0] if uniform else 0,
                row_stride_bits=0,
                x_stride_bits=(offs[1] - offs[0]) if uniform and len(offs) > 1
                else (slot if uniform else 0),
                read_bits=read,
                mask=(1 << c.component_bit_depth) - 1,
                le_bytes=le_b, le_shift=le_s,
                col_offsets=None if uniform else tuple(offs)))

    for v in views:
        v.row_stride_bits = row_bytes * 8
    tile_size = _align_up(row_bytes * th, uncC.tile_align_size)
    return views, tile_size, None


def _layout_row(uncC: Box_uncC, cmpd: Box_cmpd, tw: int, th: int):
    """Row interleave (ref: unc_decoder_row_interleave.cc:28-110)."""
    if uncC.sampling_type != SamplingMode.no_subsampling:
        raise HeifError.unsupported(SubError.Unsupported_image_type,
                                    "subsampled row interleave")
    views: List[ComponentView] = []
    base = 0  # bits within the row group
    for i, c in enumerate(uncC.components):
        channel, _ = _component_channel(uncC, cmpd, i)
        off, read, le_b, le_s, slot = _sample_view(
            c.component_bit_depth, c.component_align_size,
            uncC.components_little_endian)
        comp_row_bytes = _align_up((slot * tw + 7) // 8, uncC.row_align_size)
        views.append(ComponentView(
            comp_index=i, channel=channel, depth=c.component_bit_depth,
            width=tw, height=th,
            base_bits=base + off, row_stride_bits=0,
            x_stride_bits=slot, read_bits=read,
            mask=(1 << c.component_bit_depth) - 1,
            le_bytes=le_b, le_shift=le_s))
        base += comp_row_bytes * 8

    row_group_bytes = _align_up(base // 8, uncC.row_align_size)
    for v in views:
        v.row_stride_bits = row_group_bytes * 8
    tile_size = _align_up(row_group_bytes * th, uncC.tile_align_size)
    return views, tile_size, None


def _layout_mixed(uncC: Box_uncC, cmpd: Box_cmpd, tw: int, th: int):
    """Mixed (semi-planar) interleave: planar luma + interleaved chroma
    (ref: unc_decoder_mixed_interleave.cc:28-130).  The chroma pair is
    stored interleaved in the order the components appear; each chroma
    sample is read as whole bytes."""
    views: List[ComponentView] = []
    base = 0
    chroma_done = False
    for i, c in enumerate(uncC.components):
        channel, _ = _component_channel(uncC, cmpd, i)
        cw, ch = _subsampled_tile_dims(channel, uncC, tw, th)
        if channel in (Channel.Cb, Channel.Cr):
            bps = (c.component_bit_depth + 7) // 8
            if not chroma_done:
                # interleaved pair section: first-listed chroma first
                other_idx = next(
                    (j for j, cj in enumerate(uncC.components)
                     if j != i and _component_channel(uncC, cmpd, j)[0]
                     in (Channel.Cb, Channel.Cr)), None)
                pair_row_bytes = 2 * cw * bps
                for k, (idx, chan) in enumerate(
                        [(i, channel)] +
                        ([(other_idx,
                           _component_channel(uncC, cmpd, other_idx)[0])]
                         if other_idx is not None else [])):
                    cc = uncC.components[idx]
                    views.append(ComponentView(
                        comp_index=idx, channel=chan,
                        depth=cc.component_bit_depth,
                        width=cw, height=ch,
                        base_bits=base + k * bps * 8,
                        row_stride_bits=pair_row_bytes * 8,
                        x_stride_bits=2 * bps * 8,
                        read_bits=bps * 8,
                        mask=(1 << (bps * 8)) - 1))
                base += pair_row_bytes * 8 * ch
                chroma_done = True
            # second chroma component consumes no additional data
        else:
            off, read, le_b, le_s, slot = _sample_view(
                c.component_bit_depth, c.component_align_size,
                uncC.components_little_endian)
            row_bytes = (slot * cw + 7) // 8  # mixed mode ignores row_align
            views.append(ComponentView(
                comp_index=i, channel=channel, depth=c.component_bit_depth,
                width=cw, height=ch,
                base_bits=base + off, row_stride_bits=row_bytes * 8,
                x_stride_bits=slot, read_bits=read,
                mask=(1 << c.component_bit_depth) - 1,
                le_bytes=le_b, le_shift=le_s))
            base += row_bytes * 8 * ch

    tile_size = _align_up(base // 8, uncC.tile_align_size)
    return views, tile_size, None


def _layout_multi_y(uncC: Box_uncC, cmpd: Box_cmpd, tw: int, th: int):
    """Multi-Y pixel interleave (YUYV-style packings from uncC v1
    profiles; ISO 23001-17 Table 4 mode 5).

    A pixel group covers `factor` luma samples (2 for 4:2:2, 4 for
    4:1:1) plus one Cb and one Cr, laid out in component order.  Y
    appears `factor` times; its x-stride is group_bits/factor only when
    the Y samples are evenly spaced, which holds for all defined
    profiles (yuv2/2vuy/yvyu/vyuy), so each Y offset is modelled as a
    separate strided view merged on output.
    """
    if uncC.sampling_type == SamplingMode.s422:
        factor = 2
    elif uncC.sampling_type == SamplingMode.s411:
        factor = 4
    else:
        raise HeifError.invalid_input(
            SubError.Invalid_parameter_value,
            "multi-Y interleave requires 4:2:2 or 4:1:1 sampling")

    # group structure: components in uncC order; Y components are the
    # repeated luma samples in raster order
    pos = 0
    y_offsets: List[int] = []
    chroma_fields = {}  # channel -> (offset, read, le_b, le_s)
    depth = uncC.components[0].component_bit_depth
    for i, c in enumerate(uncC.components):
        channel, _ = _component_channel(uncC, cmpd, i)
        off, read, le_b, le_s, slot = _sample_view(
            c.component_bit_depth, c.component_align_size,
            uncC.components_little_endian)
        if channel == Channel.Y:
            y_offsets.append(pos + off)
        else:
            chroma_fields[channel] = (pos + off, read, le_b, le_s)
        pos += slot
    group_bits = pos
    if uncC.pixel_size:
        group_bits = _align_up(_align_up(pos, 8) // 8, uncC.pixel_size) * 8
    groups_per_row = tw // factor
    row_bytes = _align_up((group_bits * groups_per_row + 7) // 8,
                          uncC.row_align_size)

    views: List[ComponentView] = []
    mask = (1 << depth) - 1
    # one view per Y slot position; kernels merge them by x-interleave
    for slot_idx, off in enumerate(y_offsets):
        views.append(ComponentView(
            comp_index=slot_idx, channel=Channel.Y, depth=depth,
            width=groups_per_row, height=th,
            base_bits=off, row_stride_bits=row_bytes * 8,
            x_stride_bits=group_bits, read_bits=depth, mask=mask))
        views[-1].multi_y_phase = (slot_idx, len(y_offsets))  # type: ignore
    for channel, (off, read, le_b, le_s) in chroma_fields.items():
        views.append(ComponentView(
            comp_index=0, channel=channel, depth=depth,
            width=groups_per_row, height=th,
            base_bits=off, row_stride_bits=row_bytes * 8,
            x_stride_bits=group_bits, read_bits=read, mask=mask,
            le_bytes=le_b, le_shift=le_s))

    tile_size = _align_up(row_bytes * th, uncC.tile_align_size)
    return views, tile_size, None


# --------------------------------------------------------------------------
# uncC v1 profile expansion (ref: unc_boxes.cc:500-710
# Box_uncC v1 profile → implied component/interleave configuration)
# --------------------------------------------------------------------------

def expand_v1_profile(uncC: Box_uncC) -> Box_uncC:
    """Expand a v1 profile fourcc into an equivalent v0 configuration."""
    from ...core.fourcc import fourcc_to_str
    from ...boxes.unc import UncCComponent

    prof = fourcc_to_str(uncC.profile)
    out = Box_uncC()
    out.version = 0
    out.profile = uncC.profile
    out.num_tile_cols = uncC.num_tile_cols
    out.num_tile_rows = uncC.num_tile_rows

    def comps(idxs, depth=8):
        return [UncCComponent(i, depth, 0, 0) for i in idxs]

    if prof == "rgb3":
        out.components = comps([0, 1, 2])
        out.interleave_type = InterleaveMode.pixel
    elif prof == "rgba":
        out.components = comps([0, 1, 2, 3])
        out.interleave_type = InterleaveMode.pixel
    elif prof == "abgr":
        out.components = comps([3, 2, 1, 0])
        out.interleave_type = InterleaveMode.pixel
    elif prof in ("yuv2", "2vuy", "yvyu", "vyuy"):
        order = {"yuv2": [0, 1, 2, 3],   # Y0 Cb Y1 Cr
                 "2vuy": [1, 0, 3, 2],   # Cb Y0 Cr Y1
                 "yvyu": [0, 3, 2, 1],   # Y0 Cr Y1 Cb — component idx list below
                 "vyuy": [3, 0, 1, 2]}
        # Component index sequences refer to a cmpd of [Y, Cb, Cr] with the
        # Y listed twice; we synthesize uncC components accordingly.
        seqs = {"yuv2": ["Y", "Cb", "Y", "Cr"],
                "2vuy": ["Cb", "Y", "Cr", "Y"],
                "yvyu": ["Y", "Cr", "Y", "Cb"],
                "vyuy": ["Cr", "Y", "Cb", "Y"]}
        name_to_idx = {"Y": 0, "Cb": 1, "Cr": 2}
        out.components = comps([name_to_idx[n] for n in seqs[prof]])
        out.interleave_type = InterleaveMode.multi_y
        out.sampling_type = SamplingMode.s422
    elif prof == "v308":
        out.components = comps([2, 0, 1])  # Cr Y Cb
        out.interleave_type = InterleaveMode.pixel
    elif prof == "v408":
        out.components = comps([2, 0, 1, 3])
        out.interleave_type = InterleaveMode.pixel
    elif prof == "i420":
        out.components = comps([0, 1, 2])
        out.interleave_type = InterleaveMode.component
        out.sampling_type = SamplingMode.s420
    elif prof in ("nv12", "nv21"):
        out.components = comps([0, 1, 2] if prof == "nv12" else [0, 2, 1])
        out.interleave_type = InterleaveMode.mixed
        out.sampling_type = SamplingMode.s420
    elif prof in ("yu22", "yv22"):
        out.components = comps([0, 1, 2] if prof == "yu22" else [0, 2, 1])
        out.interleave_type = InterleaveMode.component
        out.sampling_type = SamplingMode.s422
    elif prof == "yv20":
        out.components = comps([0, 2, 1])
        out.interleave_type = InterleaveMode.component
        out.sampling_type = SamplingMode.s420
    else:
        raise HeifError.unsupported(
            SubError.Unsupported_image_type,
            f"uncC v1 profile {prof!r} not supported")
    return out
