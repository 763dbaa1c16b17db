"""AVC (H.264) decoder: avcC and NALs to PixelImages on the device, for
stills and for sequences.

Counterpart of libheif_tpu/codecs/avc/decoder.py (reference:
libheif/plugins/decoder_openh264.cc; the sequence push/pull API,
libheif/codecs/decoder.h:132-149).  The decode runs on the host, as in
the JAX package, which has no device program for AVC; each picture's
cropped planes then reach the decoder's device as uint8 in one pinned
copy (``codecs/host_copy.device_planes``), and the colour conversion
there launches ``planes_ycbcr8_to_rgb``.

The engine is chosen by syntax, never by failure: a picture whose PPS
sets entropy_coding_mode_flag (CABAC) and whose slices are I slices
decodes in the C++ engine (host/avc_native.cc through native_decode,
several slices included); a CAVLC picture in cavlc.CavlcSliceDecoder,
and a P picture of a sequence in mb.SliceDecoder or CavlcSliceDecoder
(Python).  The two engines give the same planes on intra pictures, so a
sequence's CABAC IDR goes to C++ and its uncropped planes become the
first reference.  Refused by name, as in the JAX package: bit depths
above 8, chroma other than 4:2:0 or monochrome, ref_pic_list_modification,
a sequence picture of several slices, weighted prediction
(headers.parse_slice_header).

Spans (core/trace.py): ``avc.decode`` a picture, inside it
``avc.decode.native`` (the C++ slice calls), ``avc.decode.python``
(the Python slice decode), ``avc.decode.deblock`` (either engine's
filter) and ``avc.decode.copy`` (the host-to-device copy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..._build import resolve_device
from ...core.error import HeifError, SubError
from ...core.trace import span
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..host_copy import device_planes
from . import headers as H
from .cavlc import CavlcSliceDecoder
from .deblock import deblock_frame
from .mb import SliceDecoder
from .native_decode import NativeFrame

_SLICES = (H.NAL_SLICE_IDR, H.NAL_SLICE_NON_IDR)


def _check_format(sps: H.SPS) -> None:
    if sps.bit_depth_luma != 8 or sps.chroma_format_idc > 1:
        raise HeifError.unsupported(
            SubError.Unsupported_bit_depth,
            "only 8-bit 4:2:0/monochrome AVC supported")


def _zero_planes(sps: H.SPS) -> List[np.ndarray]:
    mbw, mbh = sps.pic_width_in_mbs, sps.pic_height_in_map_units
    planes = [np.zeros((mbh * 16, mbw * 16), np.int32)]
    if sps.chroma_format_idc == 1:
        planes += [np.zeros((mbh * 8, mbw * 8), np.int32),
                   np.zeros((mbh * 8, mbw * 8), np.int32)]
    return planes


def _python_decoder(sps: H.SPS, pps: H.PPS, refs=None):
    """The Python slice decoder of the PPS's entropy coder over fresh
    int32 planes, with ``refs`` as list 0."""
    cls = SliceDecoder if pps.entropy_coding_mode else CavlcSliceDecoder
    return cls(sps, pps, _zero_planes(sps), ref_planes=refs)


def decode_intra_planes(nals: List[bytes], python_engine: bool = False
                        ) -> Tuple[H.SPS, List[np.ndarray]]:
    """The first picture of ``nals``, deblocked and uncropped: (its SPS,
    [Y] or [Y, Cb, Cr]; uint16 from the C++ engine, int32 from Python).
    A CABAC picture decodes in C++, a CAVLC one in Python;
    ``python_engine`` sends a CABAC picture to Python too (the C++
    engine's reference in the tests).  The offsets of the last slice and
    the deblocking flag of the first apply to the whole picture, in both
    engines as in the JAX package's."""
    sps_map: Dict[int, H.SPS] = {}
    pps_map: Dict[int, H.PPS] = {}
    frame = None
    native = False
    hdr0 = hdr_last = None
    for nal in nals:
        if not nal:
            continue
        t = H.nal_type(nal)
        if t == H.NAL_SPS:
            s = H.parse_sps(nal)
            sps_map[s.seq_parameter_set_id] = s
        elif t == H.NAL_PPS:
            p = H.parse_pps(nal, sps_map)
            pps_map[p.pic_parameter_set_id] = p
        elif t in _SLICES:
            hdr, sps, pps, rbsp = H.parse_slice_header(nal, sps_map, pps_map)
            _check_format(sps)
            if frame is None:
                native = bool(pps.entropy_coding_mode) and not python_engine
                frame = NativeFrame(sps, pps) if native else \
                    _python_decoder(sps, pps)
                hdr0 = hdr
            with span("avc.decode.native" if native else
                      "avc.decode.python"):
                frame.decode_slice(hdr, rbsp)
            hdr_last = hdr
            if frame.all_decoded if native else \
                    all(m is not None for m in frame.mb):
                break
    if frame is None:
        raise HeifError.invalid_input(msg="no decodable AVC slice found")
    if hdr0.disable_deblocking_filter_idc != 1:
        with span("avc.decode.deblock"):
            if native:
                frame.deblock(hdr_last.slice_alpha_c0_offset,
                              hdr_last.slice_beta_offset)
            else:
                deblock_frame(frame)
    return frame.sps, frame.planes


def _crop(sps: H.SPS, planes) -> Dict[str, np.ndarray]:
    """Uncropped planes → the conformance window as uint8 ("Y", and "U",
    "V" at half the offsets for 4:2:0)."""
    w, h = sps.width, sps.height
    x0 = sps.crop_left * (2 if sps.chroma_format_idc == 1 else 1)
    y0 = sps.crop_top * (2 if sps.chroma_format_idc == 1 else 1)
    out = {"Y": planes[0][y0:y0 + h, x0:x0 + w].astype(np.uint8)}
    if len(planes) > 1:
        cw, ch = (w + 1) // 2, (h + 1) // 2
        cx, cy = x0 // 2, y0 // 2
        out["U"] = planes[1][cy:cy + ch, cx:cx + cw].astype(np.uint8)
        out["V"] = planes[2][cy:cy + ch, cx:cx + cw].astype(np.uint8)
    return out


def decode_intra_frame(nals: List[bytes], python_engine: bool = False
                       ) -> Dict[str, np.ndarray]:
    """Decode the first (intra) frame from a list of NAL units: its
    cropped uint8 planes on the host ("Y", and "U", "V" unless
    monochrome)."""
    sps, planes = decode_intra_planes(nals, python_engine)
    return _crop(sps, planes)


def decode_annexb(data: bytes, python_engine: bool = False
                  ) -> Dict[str, np.ndarray]:
    return decode_intra_frame(H.split_annexb(data), python_engine)


def planes_to_image(planes: Dict[str, np.ndarray], device,
                    limits=None) -> PixelImage:
    """Cropped uint8 planes → a PixelImage on ``device``: YCbCr 4:2:0, or
    Monochrome with Y alone, 8 bits, in one host-to-device copy."""
    y = planes["Y"]
    h, w = y.shape
    if limits is not None:
        limits.check_image_size(w, h)
    names = ("Y", "U", "V") if "U" in planes else ("Y",)
    with span("avc.decode.copy"):
        tensors = device_planes([planes[n] for n in names], device)
    if len(names) == 1:
        img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome,
                         limits)
        img.set_plane(Channel.Y, tensors[0], 8)
        return img
    img = PixelImage(w, h, Colorspace.YCbCr, Chroma.C420, limits)
    for ch, t in zip((Channel.Y, Channel.Cb, Channel.Cr), tensors):
        img.set_plane(ch, t, 8)
    return img


class AvcSequenceDecoder:
    """Stateful I/P sequence decoder: sliding-window single/multi ref
    DPB over full (uncropped) int32 pictures on the host, one slice per
    picture (JAX decoder.py :102-178; reference: the openh264 plugin for
    avc1 video tracks, sequences/track_visual.cc:175)."""

    def __init__(self):
        self.sps_map: Dict[int, H.SPS] = {}
        self.pps_map: Dict[int, H.PPS] = {}
        self.refs: List[List[np.ndarray]] = []   # most-recent first

    def decode_nal(self, nal: bytes) -> Optional[Dict[str, np.ndarray]]:
        """Decode one NAL; returns cropped uint8 planes for slice NALs,
        None for parameter sets / SEI."""
        t = H.nal_type(nal)
        if t == H.NAL_SPS:
            s = H.parse_sps(nal)
            self.sps_map[s.seq_parameter_set_id] = s
            return None
        if t == H.NAL_PPS:
            p = H.parse_pps(nal, self.sps_map)
            self.pps_map[p.pic_parameter_set_id] = p
            return None
        if t not in _SLICES:
            return None
        hdr, sps, pps, rbsp = H.parse_slice_header(nal, self.sps_map,
                                                   self.pps_map)
        _check_format(sps)
        if hdr.ref_idx_reorder is not None:
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "ref_pic_list_modification not supported")
        if hdr.first_mb != 0:
            # one slice per picture here: a second slice of the same
            # frame would allocate fresh planes and emit a corrupt extra
            # frame, so fail cleanly instead
            raise HeifError.unsupported(
                SubError.Unsupported_codec,
                "multi-slice pictures not supported in sequence decode")
        if t == H.NAL_SLICE_IDR:
            self.refs = []
        deblock = hdr.disable_deblocking_filter_idc != 1
        if pps.entropy_coding_mode and not hdr.is_p:
            frame = NativeFrame(sps, pps)
            with span("avc.decode.native"):
                frame.decode_slice(hdr, rbsp)
            if deblock:
                with span("avc.decode.deblock"):
                    frame.deblock(hdr.slice_alpha_c0_offset,
                                  hdr.slice_beta_offset)
            planes = [p.astype(np.int32) for p in frame.planes]
        else:
            # list 0 = refs by descending frame order (sliding window)
            dec = _python_decoder(sps, pps, self.refs)
            dec.num_ref_idx_l0 = hdr.num_ref_idx_l0
            with span("avc.decode.python"):
                dec.decode_slice(hdr, rbsp)
            if deblock:
                with span("avc.decode.deblock"):
                    deblock_frame(dec)
            planes = dec.planes
        if hdr.nal_ref_idc != 0:
            self.refs.insert(0, planes)
            del self.refs[max(sps.max_num_ref_frames, 1):]
        return _crop(sps, planes)

    def decode_stream(self, nals: List[bytes]) -> List[Dict[str,
                                                            np.ndarray]]:
        out = []
        for nal in nals:
            if not nal:
                continue
            planes = self.decode_nal(nal)
            if planes is not None:
                out.append(planes)
        return out


class AvcSequenceSession:
    """A track's decode session over AvcSequenceDecoder (the push/pull
    boundary of decoder.h:132-149), its frames on ``device``.  P-only
    streams carry no reorder, so frames come out in decode order.
    Parameter sets come from the avcC and, for avc3, from the samples."""

    def __init__(self, config_box, limits=None, device=None):
        self.seq = AvcSequenceDecoder()
        self.device = resolve_device(device)
        self.length_size = getattr(config_box, "length_size", 4)
        self.limits = limits
        self.pending: List[PixelImage] = []
        if config_box is not None:
            for nal in config_box.all_nals():
                self.seq.decode_nal(nal)

    def push_sample(self, data: bytes) -> None:
        for nal in H.split_length_prefixed(data, self.length_size):
            with span("avc.decode"):
                planes = self.seq.decode_nal(nal)
                if planes is not None:
                    self.pending.append(planes_to_image(
                        planes, self.device, self.limits))

    def pull(self) -> Optional[PixelImage]:
        return self.pending.pop(0) if self.pending else None

    def flush(self) -> None:
        pass


class AvcDecoder:
    """avc1 item and avc1/avc3 track decoder on ``device`` (``None``:
    CUDA, raising without a card)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._session: Optional[AvcSequenceSession] = None

    # --- sequence push/flush/pull API (ref: decoder.h:132-149) ---

    def start_sequence(self, config_box, limits=None) -> AvcSequenceSession:
        self._session = AvcSequenceSession(config_box, limits, self.device)
        return self._session

    def push_sequence_data(self, data: bytes) -> None:
        if self._session is None:
            raise HeifError.usage(msg="push before start_sequence")
        self._session.push_sample(data)

    def pull_next_frame(self) -> Optional[PixelImage]:
        return None if self._session is None else self._session.pull()

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None) -> PixelImage:
        nals = []
        if config_box is not None:
            nals.extend(config_box.all_nals())
            length_size = config_box.length_size
        else:
            length_size = 4
        nals.extend(H.split_length_prefixed(data, length_size))
        with span("avc.decode"):
            return planes_to_image(decode_intra_frame(nals), self.device,
                                   limits)
