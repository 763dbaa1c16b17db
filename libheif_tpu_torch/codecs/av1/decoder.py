"""AV1 still-image decoder: OBUs → planes → PixelImage on the device.

Counterpart of libheif_tpu/codecs/av1/decoder.py (``parse_obus`` :20,
``parse_frame`` :54, ``finish_frame`` :89, ``decode_intra_frame_ex``
:116-143; reference: libheif/plugins/decoder_dav1d.cc, decoder_aom.cc).
The engine comes from the caller or ``LIBHEIF_TPU_AV1_ENGINE``, read at
each call (codecs/engines.py; nothing named means "device"):

* "device": the OBU walk and the tile parse on the host in Python; the
  reconstruction (device_recon, intra block copy included) and the
  in-loop filters (deblock, CDEF, loop restoration) on the decoder's
  device;
* "host": the same parse, its jobs replayed on the host
  (``TileDecoder.run_jobs``, span av1.recon.host), the planes copied to
  the device, then the same filters there;
* "native": the C++ decoder (native_decode.py, host/av1_native.cc; span
  av1.decode.native) parses, reconstructs and filters, and the planes
  reach the device in one pinned copy (span av1.decode.copy).  A stream
  with a feature it lacks raises Unsupported.

After every engine, film grain synthesis as an output stage on the
device (grain.py; the reference's ``_maybe_grain`` :146).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..._build import resolve_device
from ...core.error import HeifError
from ...core.trace import span
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..engines import av1_engine
from ..host_copy import device_samples
from . import obu as O
from .device_recon import decode_frames_device
from .grain import apply_film_grain
from .native_decode import decode_frame_native
from .tile import TileDecoder


def parse_obus(data: bytes):
    """OBU walk of the first (still) frame: headers + raw tile bytes.
    Returns (seq, fh, tiles)."""
    seq: Optional[O.SequenceHeader] = None
    fh: Optional[O.FrameHeader] = None
    tiles: List[bytes] = []
    for ob in O.split_obus(data):
        if ob.type == O.OBU_SEQUENCE_HEADER:
            seq = O.parse_sequence_header(ob.payload)
        elif ob.type == O.OBU_FRAME_HEADER:
            if seq is None:
                raise HeifError.invalid_input(msg="frame before seq header")
            fh = O.parse_frame_header(ob.payload, seq)
        elif ob.type == O.OBU_TILE_GROUP:
            if fh is None:
                raise HeifError.invalid_input(msg="tile group before header")
            tg = O.parse_tile_group(ob.payload, fh.tile_info, 0)
            tiles.extend(tg.tile_data)
        elif ob.type == O.OBU_FRAME:
            if seq is None:
                raise HeifError.invalid_input(msg="frame before seq header")
            fh = O.parse_frame_header(ob.payload, seq)
            hdr_bytes = (fh.header_bit_size + 7) // 8
            tg = O.parse_tile_group(ob.payload, fh.tile_info,
                                    hdr_bytes * 8)
            tiles.extend(tg.tile_data)
        if fh is not None and len(tiles) >= fh.tile_info.cols * \
                fh.tile_info.rows:
            break
    if seq is None or fh is None or not tiles:
        raise HeifError.invalid_input(msg="incomplete AV1 stream")
    return seq, fh, tiles


def parse_frame(data: bytes, limits=None):
    """Host entropy decode of the first (still) frame: OBU walk + tile
    parse into a TileDecoder with deferred reconstruction jobs.  Returns
    (seq, fh, dec); pair with decode_frames_device and finish_frame."""
    with span("av1.parse"):
        return _parse_frame(data, limits)


def _parse_frame(data: bytes, limits):
    seq, fh, tiles = parse_obus(data)
    if limits is not None:
        limits.check_image_size(fh.frame_width, fh.frame_height)
    w, h = fh.frame_width, fh.frame_height
    # decode into the padded mi area (blocks snap to the 8px mi grid),
    # crop to the frame size at the end
    pw = (w + 7) // 8 * 8
    ph = (h + 7) // 8 * 8
    ssx, ssy = seq.subsampling_x, seq.subsampling_y
    planes = [np.zeros((ph, pw), np.int32)]
    if not seq.monochrome:
        planes += [np.zeros((ph >> ssy, pw >> ssx), np.int32),
                   np.zeros((ph >> ssy, pw >> ssx), np.int32)]
    dec = TileDecoder(seq, fh, planes)
    ti = fh.tile_info
    sb_mi = dec.sb_mi
    idx = 0
    for trow in range(ti.rows):
        for tcol in range(ti.cols):
            mc0 = ti.col_starts[tcol] * sb_mi
            mc1 = min(ti.col_starts[tcol + 1] * sb_mi, dec.mi_cols)
            mr0 = ti.row_starts[trow] * sb_mi
            mr1 = min(ti.row_starts[trow + 1] * sb_mi, dec.mi_rows)
            dec.decode_tile(tiles[idx], mc0, mc1, mr0, mr1)
            idx += 1
    return seq, fh, dec


def finish_frame(seq, fh, dec, planes: List[torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """In-loop filters and crop of a reconstructed frame (its padded int32
    planes on the device): deblock → CDEF → loop restoration, which reads
    the deblocked frame at stripe boundaries (spec §7.17.1)."""
    w, h = fh.frame_width, fh.frame_height
    if not fh.coded_lossless and any(fh.loop_filter_levels):
        from .deblock import apply_deblock
        with span("av1.deblock"):
            planes = apply_deblock(planes, dec.edges, fh, w, h,
                                   bd=seq.bit_depth)
    deblocked = planes
    if not fh.coded_lossless and (any(fh.cdef.y_pri) or any(fh.cdef.y_sec)
                                  or any(fh.cdef.uv_pri)
                                  or any(fh.cdef.uv_sec)):
        from .cdef import apply_cdef
        with span("av1.cdef"):
            planes = apply_cdef(planes, dec, seq, fh, w, h)
    if any(t != 0 for t in fh.lr_type):
        from .lr import apply_lr
        with span("av1.lr"):
            planes = apply_lr(planes, deblocked, dec, seq, fh, w, h)
    if seq.monochrome:
        return {"Y": planes[0][:h, :w]}
    ssx, ssy = seq.subsampling_x, seq.subsampling_y
    cw, ch = (w + (1 << ssx) - 1) >> ssx, (h + (1 << ssy) - 1) >> ssy
    return {"Y": planes[0][:h, :w], "U": planes[1][:ch, :cw],
            "V": planes[2][:ch, :cw]}


def maybe_grain(planes: Dict[str, torch.Tensor], seq, fh
                ) -> Dict[str, torch.Tensor]:
    """Film grain synthesis (spec 7.18.3) on a frame's cropped output
    planes, where its header asks for it (JAX ``_maybe_grain`` :146)."""
    if fh.film_grain is None:
        return planes
    return apply_film_grain(planes, fh.film_grain, seq.bit_depth,
                            seq.subsampling_x, seq.subsampling_y)


def decode_intra_frame(data: bytes, device=None, limits=None,
                       engine: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """Decode the first (still) frame of a stream of OBUs → its cropped
    int32 planes ("Y", and "U", "V" unless monochrome) on ``device``
    (None means CUDA)."""
    return decode_intra_frame_ex(data, device, limits, engine)[0]


def decode_intra_frame_ex(data: bytes, device=None, limits=None,
                          engine: Optional[str] = None):
    """decode_intra_frame, also returning the SequenceHeader.

    engine: "native" (host C++), "host" (numpy job replay), "device", or
    None/"auto" (``LIBHEIF_TPU_AV1_ENGINE``, else "device")."""
    engine = av1_engine(engine)
    if engine == "native":
        device = resolve_device(device)
        seq, fh, tiles = parse_obus(data)
        if limits is not None:
            limits.check_image_size(fh.frame_width, fh.frame_height)
        with span("av1.decode.native"):
            planes = decode_frame_native(seq, fh, tiles)
        with span("av1.decode.copy"):
            planes = dict(zip(planes, device_samples(
                list(planes.values()), device)))
        return maybe_grain(planes, seq, fh), seq
    seq, fh, dec = parse_frame(data, limits)
    if engine == "host":
        device = resolve_device(device)
        with span("av1.recon.host"):
            dec.run_jobs()
        with span("av1.decode.copy"):
            planes = device_samples(dec.planes, device)
    else:
        planes = decode_frames_device([dec], device)[0]
    return maybe_grain(finish_frame(seq, fh, dec, planes), seq, fh), seq


def config_stream(config_box, data: bytes) -> bytes:
    """The av1C configuration OBUs followed by the item's OBUs."""
    if config_box is None:
        return data
    return (config_box.config_obus or b"") + data


def planes_to_image(planes: Dict[str, torch.Tensor], bd: int,
                    limits=None) -> PixelImage:
    """Cropped int32 planes → PixelImage (uint8, or uint16 above 8 bits)
    on the planes' device (JAX Av1Decoder.decode_single_image :175-196)."""
    y = planes["Y"]
    h, w = y.shape

    def cast(p):
        p = p.to(torch.uint8 if bd <= 8 else torch.int16).contiguous()
        return p if bd <= 8 else p.view(torch.uint16)
    if "U" not in planes:
        img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome,
                         limits)
        img.set_plane(Channel.Y, cast(y), bd)
        return img
    ch, cw = planes["U"].shape
    if cw == w and ch == h:
        chroma = Chroma.C444
    elif cw < w and ch == h:
        chroma = Chroma.C422
    else:
        chroma = Chroma.C420
    img = PixelImage(w, h, Colorspace.YCbCr, chroma, limits)
    img.set_plane(Channel.Y, cast(y), bd)
    img.set_plane(Channel.Cb, cast(planes["U"]), bd)
    img.set_plane(Channel.Cr, cast(planes["V"]), bd)
    return img


class Av1Decoder:
    """av01 item decoder (ref: decoder_dav1d.cc, decoder_aom.cc)."""

    def __init__(self, device=None):
        self.device = device

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        planes, seq = decode_intra_frame_ex(config_stream(config_box, data),
                                            self.device, limits)
        h, w = planes["Y"].shape
        if limits is not None:
            limits.check_image_size(w, h)
        return planes_to_image(planes, seq.bit_depth, limits)
