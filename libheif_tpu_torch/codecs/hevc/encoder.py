"""HEVC intra still-image encoder, and the registry's HEVC encoder.

Counterpart of libheif_tpu/codecs/hevc/encoder.py.  Its sequence half,
``HevcSequenceEncodeSession`` (JAX :1296) and ``HevcEncoder.
start_sequence_encode`` (:1382), drives inter_enc.SequenceEncoder for
the track writer.  It replaces the reference's x265 plugin boundary for
still images (reference: libheif/plugins/encoder_x265.cc) with a
from-scratch intra encoder: a fixed CU-size quadtree, a per-CU intra mode
decision, forward transform and quantisation, CABAC entropy coding.  The
output equals the JAX encoder's byte for byte.

``IntraEncoder.encode`` takes a YCbCr 4:2:0 PixelImage whose planes lie
on any device.  With ``EncParams(mode="device")`` at 8 bits the luma,
padded to whole CTBs on its device, goes through
``device_modes.plan_modes_device`` (one ``hevc_mode_search`` launch a
block size) and the mode maps come to the host in one copy; then the
three planes come to the host in one copy (codecs/host_copy.py).  The
default parameter set runs the C++ path (host/hevc_enc.cc, built into
the ``hevc_host`` library; a failed build or load raises), every other
set the Python loop below, as in the JAX package; the
``TPUHEIF_HEVC_ENC_NATIVE=0`` switch forces the loop.  The encoder keeps
its closed-loop reconstruction in ``recon`` (uncropped int32 planes).
Its parts are the spans ``hevc.encode`` with ``.modes``, ``.copy``,
``.native`` or ``.loop``, and ``.write`` (core/trace.py).

Like the JAX encoder it pads the picture to whole CTBs and writes no
conformance window: a decoder shows the padded size, and the item's
``ispe`` gives the image's (ROADMAP §3 D).
"""

from __future__ import annotations

import ctypes
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..._build import HOST_LIBRARY
from ...boxes.codec_cfg import hvcC_from_sps, parse_hevc_sps
from ...boxes.meta import Box_ispe
from ...color import convert_image
from ...core import trace
from ...core.bitstream import BitWriter
from ...core.error import ErrorCode, HeifError, SubError
from ...image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from ..host_copy import host_planes
from ..registry import Encoder as RegistryEncoder, register_encoder
from . import headers as H
from .cabac import ContextModels
from .cabac_enc import CabacEncoder
from .ctu import (_SCANS, _SB_SCANS, INTRA_PLANAR, INTRA_DC,
                  INTRA_ANGULAR26, TU, SliceParser, SliceSyntax)
from .device_modes import plan_modes_device
from .native_parse import _FAMILIES, _get_recon_tables
from .recon import dequant, inverse_transform, IntraReconstructor
from .tables import DCT, DST4, chroma_qp

_QUANT_SCALE = [26214, 23302, 20560, 18396, 16384, 14564]


# --------------------------------------------------------------------------
# header writers
# --------------------------------------------------------------------------

def _write_ptl(w: BitWriter, bit_depth: int = 8) -> None:
    w.write_bits(0, 2)      # profile_space
    w.write_bits(0, 1)      # tier
    # Main profile for 8-bit, Main10 for 10-bit (spec A.3.2/A.3.3)
    w.write_bits(1 if bit_depth == 8 else 2, 5)
    if bit_depth == 8:
        w.write_bits(0b0110 << 28, 32)  # compatibility: Main + Main10
    else:
        w.write_bits(0b0010 << 28, 32)  # compatibility: Main10 only
    w.write_bits(1, 1)      # progressive_source
    w.write_bits(0, 1)      # interlaced
    w.write_bits(1, 1)      # non_packed
    w.write_bits(1, 1)      # frame_only
    w.write_bits(0, 22)     # reserved 43 bits total → 44 remaining
    w.write_bits(0, 21)
    w.write_bits(0, 1)      # inbld/reserved
    w.write_bits(120, 8)    # level 4.0


def _ue(w: BitWriter, v: int) -> None:
    n = v + 1
    nbits = n.bit_length()
    w.write_bits(0, nbits - 1)
    w.write_bits(n, nbits)


def _se(w: BitWriter, v: int) -> None:
    _ue(w, 2 * v - 1 if v > 0 else -2 * v)


def _rbsp_trailing(w: BitWriter) -> None:
    w.write_bits(1, 1)
    w.byte_align()


def add_emulation_prevention(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


@dataclass
class EncParams:
    qp: int = 26
    ctb_log2: int = 5          # 32x32 CTBs keep the quadtree simple
    cu_log2: int = 4           # fixed CU/TU size (16x16)
    mode: str = "auto"         # 'auto' | 'dc' | 'planar' | 'device' | int
    sao: bool = False          # signal + apply SAO (param cycle per CTB)
    sign_hiding: bool = False
    cu_qp_delta: bool = False
    qp_delta_pattern: tuple = (0, 1, -1, 2, 0, -2)  # per-QG deltas cycle
    nxn: bool = False          # use NxN partitions at min-CB CUs
    strong_smoothing: bool = False  # SPS strong_intra_smoothing
    rqt_depth: int = 0         # max_transform_hierarchy_depth_intra
    deblock: bool = False      # enable in-loop deblocking
    wpp: bool = False          # entropy_coding_sync + per-row substreams
    diff_qg_depth: Optional[int] = None  # diff_cu_qp_delta_depth override
    var_cu: bool = False       # position-hashed CU depths below cu_log2
    chroma_modes: bool = False  # cycle explicit intra_chroma_pred_mode
    num_reorder: int = 0       # sps_max_num_reorder_pics (B pyramids)
    bit_depth: int = 8         # 8 (Main) or 10/12 (Main10/RExt-style)
    temporal_mvp: bool = False  # sps_temporal_mvp_enabled (TMVP)
    scaling_lists: object = None  # None | 'default' | 'custom'
    num_slices: int = 1        # independent slice segments per picture


def write_sps(p: EncParams, width: int, height: int) -> bytes:
    w = BitWriter()
    w.write_bits(0, 4)      # vps id
    w.write_bits(0, 3)      # max_sub_layers_minus1
    w.write_bits(1, 1)      # temporal_id_nesting
    _write_ptl(w, p.bit_depth)
    _ue(w, 0)               # sps id
    _ue(w, 1)               # chroma 4:2:0
    _ue(w, width)
    _ue(w, height)
    w.write_bits(0, 1)      # no conformance window (caller pads)
    _ue(w, p.bit_depth - 8)  # bit_depth_luma - 8
    _ue(w, p.bit_depth - 8)  # bit_depth_chroma - 8
    _ue(w, 4)               # log2_max_poc_lsb - 4
    w.write_bits(1, 1)      # sub_layer_ordering_info_present
    _ue(w, 1 + p.num_reorder)  # max_dec_pic_buffering_minus1
    _ue(w, p.num_reorder)   # num_reorder
    _ue(w, 0)               # max_latency
    _ue(w, 0)               # log2_min_cb_size - 3  → 8
    _ue(w, p.ctb_log2 - 3)  # log2_diff_max_min
    _ue(w, 0)               # log2_min_tb - 2 → 4
    _ue(w, min(p.ctb_log2, 5) - 2)  # log2_diff_max_min_tb → max TB = CTB (≤32)
    _ue(w, p.rqt_depth)     # max_transform_hierarchy_depth_inter
    _ue(w, p.rqt_depth)     # max_transform_hierarchy_depth_intra
    if p.scaling_lists is None:
        w.write_bits(0, 1)  # scaling_list_enabled
    else:
        w.write_bits(1, 1)  # scaling_list_enabled
        if p.scaling_lists == "default":
            w.write_bits(0, 1)  # sps_scaling_list_data_present → defaults
        else:
            w.write_bits(1, 1)
            _write_scaling_list_data(w)
    w.write_bits(0, 1)      # amp_enabled
    w.write_bits(1 if p.sao else 0, 1)
    w.write_bits(0, 1)      # pcm_enabled
    _ue(w, 0)               # num_short_term_rps
    w.write_bits(0, 1)      # long_term_ref_pics_present
    w.write_bits(1 if p.temporal_mvp else 0, 1)  # sps_temporal_mvp
    w.write_bits(1 if p.strong_smoothing else 0, 1)
    # VUI: declare full-range video so container color handling is 1:1
    w.write_bits(1, 1)      # vui_present
    w.write_bits(0, 1)      # aspect_ratio_info_present
    w.write_bits(0, 1)      # overscan_info_present
    w.write_bits(1, 1)      # video_signal_type_present
    w.write_bits(5, 3)      # video_format unspecified
    w.write_bits(1, 1)      # video_full_range_flag
    w.write_bits(0, 1)      # colour_description_present
    w.write_bits(0, 1)      # chroma_loc_info_present
    w.write_bits(0, 1)      # neutral_chroma_indication
    w.write_bits(0, 1)      # field_seq
    w.write_bits(0, 1)      # frame_field_info_present
    w.write_bits(0, 1)      # default_display_window
    w.write_bits(0, 1)      # vui_timing_info_present
    w.write_bits(0, 1)      # bitstream_restriction
    w.write_bits(0, 1)      # sps_extension
    _rbsp_trailing(w)
    return b"\x42\x01" + add_emulation_prevention(w.data())


def _custom_scaling_list(size_id: int, matrix_id: int):
    """Deterministic non-flat lists for conformance coverage: legal
    values 1..255, varying per size/matrix (asymmetric so transposed
    application would be caught by the oracle)."""
    n = min(64, 1 << (4 + (size_id << 1)))
    vals = [max(1, min(255, 16 + ((i * 7 + matrix_id * 5 + size_id * 3)
                                  % 23) - 4)) for i in range(n)]
    dc = 16 + (matrix_id % 5)
    return vals, dc


def _write_scaling_list_data(w: BitWriter) -> None:
    """scaling_list_data (spec 7.3.4), all lists explicit."""
    for size_id in range(4):
        mids = (0, 3) if size_id == 3 else (0, 1, 2, 3, 4, 5)
        for matrix_id in mids:
            vals, dc = _custom_scaling_list(size_id, matrix_id)
            w.write_bits(1, 1)      # scaling_list_pred_mode_flag
            next_coef = 8
            if size_id > 1:
                _se(w, dc - 8)
                next_coef = dc
            for v in vals:
                delta = v - next_coef
                if delta < -128:
                    delta += 256
                elif delta > 127:
                    delta -= 256
                _se(w, delta)
                next_coef = v
            # next_coef tracking matches the decoder's mod-256 chain


def write_pps(p: EncParams) -> bytes:
    w = BitWriter()
    _ue(w, 0)               # pps id
    _ue(w, 0)               # sps id
    w.write_bits(0, 1)      # dependent_slice_segments
    w.write_bits(0, 1)      # output_flag_present
    w.write_bits(0, 3)      # num_extra_slice_header_bits
    w.write_bits(1 if p.sign_hiding else 0, 1)
    w.write_bits(0, 1)      # cabac_init_present
    _ue(w, 0)               # num_ref_idx_l0_default - 1
    _ue(w, 0)
    _se(w, p.qp - 26)       # init_qp - 26
    w.write_bits(0, 1)      # constrained_intra_pred
    w.write_bits(0, 1)      # transform_skip
    w.write_bits(1 if p.cu_qp_delta else 0, 1)
    if p.cu_qp_delta:
        diff = (p.diff_qg_depth if p.diff_qg_depth is not None
                else p.ctb_log2 - p.cu_log2)
        _ue(w, diff)        # diff_cu_qp_delta_depth
    _se(w, 0)               # cb_qp_offset
    _se(w, 0)               # cr_qp_offset
    w.write_bits(0, 1)      # slice_chroma_qp_offsets_present
    w.write_bits(0, 1)      # weighted_pred
    w.write_bits(0, 1)      # weighted_bipred
    w.write_bits(0, 1)      # transquant_bypass
    w.write_bits(0, 1)      # tiles_enabled
    w.write_bits(1 if p.wpp else 0, 1)  # entropy_coding_sync (WPP)
    # filtering across slice boundaries stays ON (x265 default); the
    # in-loop filters are slice-unaware by design
    w.write_bits(1, 1)      # pps_loop_filter_across_slices_enabled
    if p.deblock:
        w.write_bits(0, 1)  # deblocking_filter_control_present → on, offsets 0
    else:
        w.write_bits(1, 1)  # deblocking_filter_control_present
        w.write_bits(0, 1)  # deblocking_filter_override_enabled
        w.write_bits(1, 1)  # pps_deblocking_filter_disabled (keep exact)
    w.write_bits(0, 1)      # scaling_list_data_present
    w.write_bits(0, 1)      # lists_modification
    _ue(w, 0)               # log2_parallel_merge_level - 2
    w.write_bits(0, 1)      # slice_segment_header_extension
    w.write_bits(0, 1)      # pps_extension
    _rbsp_trailing(w)
    return b"\x44\x01" + add_emulation_prevention(w.data())


def write_slice_header(p: EncParams, sao_luma: bool, sao_chroma: bool,
                       entry_offsets: Optional[List[int]] = None,
                       first_slice: bool = True, address: int = 0,
                       n_ctbs: int = 0) -> BitWriter:
    w = BitWriter()
    w.write_bits(1 if first_slice else 0, 1)  # first_slice_in_pic
    w.write_bits(0, 1)      # no_output_of_prior_pics (IDR)
    _ue(w, 0)               # pps id
    if not first_slice:
        # slice_segment_address (dependent slices off in the PPS)
        bits = max(1, math.ceil(math.log2(max(n_ctbs, 2))))
        w.write_bits(address, bits)
    _ue(w, 2)               # slice_type I
    if p.sao:
        w.write_bits(1 if sao_luma else 0, 1)
        w.write_bits(1 if sao_chroma else 0, 1)
    _se(w, 0)               # slice_qp_delta
    # deblocking: either always-on defaults (control absent) or
    # control-present + override-disabled → nothing in either case
    if p.deblock or sao_luma or sao_chroma:
        # slice_loop_filter_across_slices_enabled_flag (coded because
        # the PPS enables cross-slice filtering and a filter is on)
        w.write_bits(1, 1)
    if p.wpp:
        offs = entry_offsets or []
        _ue(w, len(offs))   # num_entry_point_offsets
        if offs:
            ln = max(o - 1 for o in offs).bit_length() or 1
            _ue(w, ln - 1)  # offset_len_minus1
            for o in offs:
                w.write_bits(o - 1, ln)
    # alignment
    w.write_bits(1, 1)
    w.byte_align()
    return w


# --------------------------------------------------------------------------
# transforms
# --------------------------------------------------------------------------

def forward_transform(block: np.ndarray, log2: int, c_idx: int,
                      bit_depth: int = 8) -> np.ndarray:
    n = 1 << log2
    m = DST4 if (c_idx == 0 and n == 4) else DCT[n]
    shift1 = log2 + bit_depth - 9
    shift2 = log2 + 6
    t = m @ block.astype(np.int64)
    t = (t + (1 << (shift1 - 1)) if shift1 > 0 else t) >> max(shift1, 0)
    c = t @ m.T
    c = (c + (1 << (shift2 - 1))) >> shift2
    return c


def quantize(coeffs: np.ndarray, qp: int, log2: int,
             bit_depth: int = 8) -> np.ndarray:
    tshift = 15 - bit_depth - log2
    qbits = 14 + qp // 6 + tshift
    scale = _QUANT_SCALE[qp % 6]
    add = 171 << (qbits - 9)  # intra rounding
    mag = (np.abs(coeffs.astype(np.int64)) * scale + add) >> qbits
    return (np.sign(coeffs) * mag).astype(np.int32)


# --------------------------------------------------------------------------
# syntax writing
# --------------------------------------------------------------------------

class IntraEncoder:
    """Fixed-CU-size intra encoder with decode-loop reconstruction."""

    _device_plan = None

    def __init__(self, width: int, height: int, params: EncParams):
        self.p = params
        ctb = 1 << params.ctb_log2
        self.width = (width + ctb - 1) // ctb * ctb
        self.height = (height + ctb - 1) // ctb * ctb
        self.src_w, self.src_h = width, height
        # build SPS/PPS objects by parsing our own writers (guarantees
        # encoder/decoder agree on parameters)
        self.sps_nal = write_sps(params, self.width, self.height)
        self.pps_nal = write_pps(params)
        self.sps = H.parse_sps(self.sps_nal)
        self.pps = H.parse_pps(self.pps_nal)
        self._scaling = H.effective_scaling_factors(self.sps, self.pps)

    # ---------------------------------------------------------------- api

    def encode(self, img: PixelImage) -> Tuple[bytes, List[bytes]]:
        """Returns (slice NAL, [sps, pps] NALs)."""
        with trace.span("hevc.encode"):
            return self._encode(img)

    def _source(self, img: PixelImage):
        """The three planes on the host, int32, padded to whole CTBs by
        edge replication (one copy from the image's device)."""
        with trace.span("hevc.encode.copy"):
            y, cb, cr = (a.astype(np.int32) for a in host_planes(
                [img.plane(Channel.Y), img.plane(Channel.Cb),
                 img.plane(Channel.Cr)]))
        y = np.pad(y, ((0, self.height - y.shape[0]),
                       (0, self.width - y.shape[1])), mode="edge")
        cb = np.pad(cb, ((0, self.height // 2 - cb.shape[0]),
                         (0, self.width // 2 - cb.shape[1])), mode="edge")
        cr = np.pad(cr, ((0, self.height // 2 - cr.shape[0]),
                         (0, self.width // 2 - cr.shape[1])), mode="edge")
        return y, cb, cr

    def _plan_modes(self, luma: torch.Tensor) -> Dict[int, np.ndarray]:
        """The open-loop SATD mode maps of the luma padded to whole CTBs,
        searched on the luma's device, in one copy to the host."""
        with trace.span("hevc.encode.modes"):
            h, w = luma.shape
            dev = luma.device
            rows = torch.clamp(torch.arange(self.height, device=dev),
                               max=h - 1)
            cols = torch.clamp(torch.arange(self.width, device=dev),
                               max=w - 1)
            padded = luma.index_select(0, rows).index_select(1, cols)
            maps = plan_modes_device(padded, device=dev)
            flat = torch.cat([m.reshape(-1) for m in maps.values()]).cpu()
            out, first = {}, 0
            for lg, m in maps.items():
                out[lg] = flat[first:first + m.numel()].numpy().reshape(
                    tuple(m.shape))
                first += m.numel()
            return out

    def _encode(self, img: PixelImage) -> Tuple[bytes, List[bytes]]:
        self._device_plan = None
        if self.p.mode == "device" and self.p.bit_depth == 8:
            # batched open-loop SATD mode search on device; the host
            # path below re-runs exact in-loop prediction per block
            self._device_plan = self._plan_modes(img.plane(Channel.Y))
        y, cb, cr = self._source(img)
        self.src = [y, cb, cr]

        if self.p.mode != "device":
            with trace.span("hevc.encode.native"):
                payload = self._encode_native(y, cb, cr)
            if payload is not None:
                with trace.span("hevc.encode.write"):
                    sh_writer = write_slice_header(self.p, False, False,
                                                   None)
                    nal = bytes([19 << 1, 1]) + add_emulation_prevention(
                        sh_writer.data() + payload)
                return nal, [self.sps_nal, self.pps_nal]
        with trace.span("hevc.encode.loop"):
            substreams = self._encode_loop(y, cb, cr)
        with trace.span("hevc.encode.write"):
            # entry point offsets count post-emulation-prevention bytes;
            # each substream ends with a nonzero byte (CABAC flush emits
            # a final 1 bit), so the EPB zero-run never crosses a
            # boundary and per-substream EPB application equals
            # whole-payload application
            entry_offsets = [len(add_emulation_prevention(s))
                             for s in substreams[:-1]]
            sh_writer = write_slice_header(self.p, self.p.sao, self.p.sao,
                                           entry_offsets)
            payload = b"".join(substreams)
            # NAL: IDR_W_RADL (19), layer 0, tid 1
            nal = bytes([19 << 1, 1]) + add_emulation_prevention(
                sh_writer.data() + payload)
        return nal, [self.sps_nal, self.pps_nal]

    def _encode_loop(self, y, cb, cr) -> List[bytes]:
        """The Python loop over the CTBs; the slice data's substreams (one
        a CTB row with WPP, else one)."""
        self.recon = [np.zeros_like(y), np.zeros_like(cb), np.zeros_like(cr)]

        diff = (self.p.diff_qg_depth if self.p.diff_qg_depth is not None
                else self.p.ctb_log2 - self.p.cu_log2)
        self._qg_log2 = self.p.ctb_log2 - diff
        self._qg_serial = 0
        self._qg_origin = None
        self._qp_prev = self.p.qp
        self._qg_qp = self.p.qp
        self._qg_pred = self.p.qp
        self._qg_delta = 0
        self._qg_delta_written = True
        self._pending_qp_reset = False
        self.ctx = ContextModels(0, self.p.qp)
        self.enc = CabacEncoder(self.ctx)
        # decode-side helper state (mirrors SliceParser maps)
        sh = H.SliceHeader(qp=self.p.qp)
        self.syn = SliceSyntax(self.sps, self.pps, sh)
        # recon-side availability tracker for prediction
        self._recon_helper = IntraReconstructor(self.syn)
        self._recon_helper.planes = self.recon

        ctb = 1 << self.p.ctb_log2
        n_cols = self.width // ctb
        n_rows = self.height // ctb
        wpp = self.p.wpp
        substreams = []
        snap = None
        for row in range(n_rows):
            for col in range(n_cols):
                if self.p.sao:
                    self._emit_sao(col, row, n_cols)
                self._encode_ctb(col * ctb, row * ctb)
                if wpp and col == 1:
                    snap = self.ctx.snapshot()
                last = (row == n_rows - 1 and col == n_cols - 1)
                self.enc.encode_terminate(1 if last else 0)
            if wpp and row < n_rows - 1:
                # end_of_subset_one_bit + flush + byte-align per substream
                self.enc.encode_terminate(1)
                self.enc.flush()
                substreams.append(self.enc.data())
                if n_cols > 1 and snap is not None:
                    self.ctx.restore(snap)
                else:
                    # no above-right CTB: fresh context init (spec 9.3.1)
                    self.ctx = ContextModels(0, self.p.qp)
                self.enc = CabacEncoder(self.ctx)
                self._pending_qp_reset = True
        self.enc.flush()
        substreams.append(self.enc.data())
        return substreams

    def encode_slices(self, img: PixelImage):
        """Multi-slice encode (p.num_slices independent slice segments
        split at CTB-row boundaries) → (slice NAL list, cfg NALs).
        Spec 7.3.6.1 slice_segment_address; exercised by the oracle
        matrix for the multi-slice decode path."""
        p = self.p
        if p.num_slices <= 1:
            nal, cfg = self.encode(img)
            return [nal], cfg
        if p.sao or p.wpp or p.cu_qp_delta:
            raise HeifError.unsupported(
                SubError.Unsupported_parameter,
                "multi-slice encode excludes sao/wpp/cu_qp_delta")
        y, cb, cr = self._source(img)
        self.src = [y, cb, cr]
        self._device_plan = None
        self.recon = [np.zeros_like(y), np.zeros_like(cb),
                      np.zeros_like(cr)]
        self._qg_log2 = self.p.ctb_log2
        self._qg_serial = 0
        self._qg_origin = None
        self._qg_delta = 0
        self._qg_delta_written = True
        self._pending_qp_reset = False
        sh = H.SliceHeader(qp=self.p.qp)
        self.syn = SliceSyntax(self.sps, self.pps, sh)
        self._recon_helper = IntraReconstructor(self.syn)
        self._recon_helper.planes = self.recon

        ctb = 1 << self.p.ctb_log2
        n_cols = self.width // ctb
        n_rows = self.height // ctb
        n_ctbs = n_cols * n_rows
        n_slices = min(p.num_slices, n_rows)
        bounds = [n_rows * k // n_slices for k in range(n_slices + 1)]
        c4 = ctb >> 2
        nals = []
        for si in range(n_slices):
            self._cur_slice_idx = si
            self._qp_prev = self.p.qp
            self._qg_qp = self.p.qp
            self._qg_pred = self.p.qp
            self.ctx = ContextModels(0, self.p.qp)
            self.enc = CabacEncoder(self.ctx)
            for row in range(bounds[si], bounds[si + 1]):
                self.syn.slice_map4[row * c4:(row + 1) * c4, :] = si
                for col in range(n_cols):
                    self._encode_ctb(col * ctb, row * ctb)
                    last = (row == bounds[si + 1] - 1 and
                            col == n_cols - 1)
                    self.enc.encode_terminate(1 if last else 0)
            self.enc.flush()
            shw = write_slice_header(p, False, False, None,
                                     first_slice=(si == 0),
                                     address=bounds[si] * n_cols,
                                     n_ctbs=n_ctbs)
            nals.append(bytes([19 << 1, 1]) + add_emulation_prevention(
                shw.data() + self.enc.data()))
        self._cur_slice_idx = 0
        return nals, [self.sps_nal, self.pps_nal]

    def _encode_native(self, y, cb, cr) -> Optional[bytes]:
        """C++ path (host/hevc_enc.cc) for the default parameter set;
        byte-identical to the Python loop.  Returns the CABAC slice
        payload, or None where the parameters lie outside it (the Python
        loop then runs, as in the JAX package).  A failed build or load
        of the library, or a failed encode, raises."""
        p = self.p
        if os.environ.get("TPUHEIF_HEVC_ENC_NATIVE", "1") == "0":
            return None
        if (p.sao or p.sign_hiding or p.cu_qp_delta or p.nxn or
                p.rqt_depth or p.wpp or p.var_cu or p.chroma_modes or
                p.bit_depth != 8 or p.scaling_lists is not None):
            return None
        if isinstance(p.mode, str):
            if p.mode == "auto":
                fixed = -1
            elif p.mode == "dc":
                fixed = 1
            elif p.mode == "planar":
                fixed = 0
            else:
                return None
        else:
            fixed = int(p.mode)
        max_tb = min(p.ctb_log2, 5)
        if p.cu_log2 > max_tb or p.cu_log2 < 3:
            return None
        fn = _encode_slice_entry()

        cm = ContextModels(0, p.qp)
        fam = np.asarray([ContextModels.LAYOUT[n][0] for n in _FAMILIES],
                         np.int32)
        init_p = np.asarray(cm.p_state, np.uint8)
        init_m = np.asarray(cm.val_mps, np.uint8)
        t = _get_recon_tables()
        params = np.asarray([p.qp, p.ctb_log2, p.cu_log2, self.width,
                             self.height, fixed,
                             int(p.strong_smoothing), max_tb], np.int32)
        ya = np.ascontiguousarray(y, np.int32)
        cba = np.ascontiguousarray(cb, np.int32)
        cra = np.ascontiguousarray(cr, np.int32)
        cap = 8 * self.width * self.height + 65536
        out = np.empty(cap, np.uint8)
        out_len = np.zeros(1, np.int64)
        rec_y = np.zeros((self.height, self.width), np.int32)
        rec_cb = np.zeros((self.height // 2, self.width // 2), np.int32)
        rec_cr = np.zeros_like(rec_cb)
        err = ctypes.create_string_buffer(200)
        arrays = (params, fam, init_p, init_m, ya, cba, cra, t["dst4"],
                  t["dct4"], t["dct8"], t["dct16"], t["dct32"], out,
                  out_len, rec_y, rec_cb, rec_cr)
        ptrs = [a.ctypes.data for a in arrays]
        rc = fn(*ptrs[:4], len(init_p), *ptrs[4:12], ptrs[12], cap,
                ptrs[13], *ptrs[14:], err, len(err))
        if rc != 0:
            raise HeifError(ErrorCode.Encoding_error, SubError.Unspecified,
                            "HEVC C++ encoder: "
                            + err.value.decode(errors="replace"))
        self.recon = [rec_y, rec_cb, rec_cr]
        return out[:int(out_len[0])].tobytes()

    # ------------------------------------------------------------- blocks

    def _encode_ctb(self, x0: int, y0: int) -> None:
        self._quadtree(x0, y0, self.p.ctb_log2, 0)

    def _quadtree(self, x0: int, y0: int, log2: int, depth: int) -> None:
        sps = self.sps
        size = 1 << log2
        inside = (x0 + size <= self.width and y0 + size <= self.height)
        target = self.p.cu_log2
        split = log2 > target
        if self.p.var_cu and not split and log2 > sps.log2_min_cb_size:
            # position-hashed extra splits exercise mixed CU depths
            # (split_cu_flag ctx 1/2, depth-dependent neighbor contexts)
            split = ((x0 >> log2) * 3 + (y0 >> log2) * 5 + log2) % 3 == 0
        if inside and log2 > sps.log2_min_cb_size:
            ctx_inc = 0
            if self._avail(x0 - 1, y0) and \
                    self.syn.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx_inc += 1
            if self._avail(x0, y0 - 1) and \
                    self.syn.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx_inc += 1
            self.enc.encode_bin(self.ctx.idx("split_cu_flag", ctx_inc),
                                1 if split else 0)
        if split:
            half = size >> 1
            for (dy, dx) in ((0, 0), (0, 1), (1, 0), (1, 1)):
                x1, y1 = x0 + dx * half, y0 + dy * half
                if x1 < self.width and y1 < self.height:
                    self._quadtree(x1, y1, log2 - 1, depth + 1)
        else:
            self._cu(x0, y0, log2, depth)

    def _avail(self, x: int, y: int) -> bool:
        if x < 0 or y < 0 or x >= self.width or y >= self.height:
            return False
        if not self.syn.avail[y >> 2, x >> 2]:
            return False
        return int(self.syn.slice_map4[y >> 2, x >> 2]) == \
            getattr(self, "_cur_slice_idx", 0)

    def _choose_mode(self, x0: int, y0: int, log2: int) -> int:
        if self.p.mode == "dc":
            return INTRA_DC
        if self.p.mode == "planar":
            return INTRA_PLANAR
        if isinstance(self.p.mode, int):
            return self.p.mode
        if self._device_plan is not None:
            lg = min(max(log2, 3), 5)
            plan = self._device_plan.get(lg)
            if plan is not None:
                by, bx = y0 >> lg, x0 >> lg
                if by < plan.shape[0] and bx < plan.shape[1]:
                    return int(plan[by, bx])
        # auto: try a small candidate set, pick lowest SAD vs prediction.
        # 64x64 CUs are evaluated on their top-left 32x32 (the largest TB)
        log2 = min(log2, 5)
        n = 1 << log2
        best = (1 << 60, INTRA_DC)
        src = self.src[0][y0:y0 + n, x0:x0 + n]
        for mode in (INTRA_PLANAR, INTRA_DC, 10, 26, 2, 18, 34, 6, 14,
                     22, 30):
            tu = TU(x=x0, y=y0, log2=log2, c_idx=0, pred_mode=mode)
            pred = self._recon_helper._predict(tu)
            sad = int(np.abs(src - pred).sum())
            if sad < best[0]:
                best = (sad, mode)
        return best[1]

    def _cu(self, x0: int, y0: int, log2: int, depth: int) -> None:
        sps, enc, ctx = self.sps, self.enc, self.ctx
        size = 1 << log2
        nb = size >> 2
        bx0, by0 = x0 >> 2, y0 >> 2

        # ---- quantization group / delta QP ----
        if self.p.cu_qp_delta:
            self._maybe_open_qg(x0, y0)
        else:
            self._qg_qp = self.p.qp

        nxn = self.p.nxn and log2 == sps.log2_min_cb_size
        if log2 == sps.log2_min_cb_size:
            enc.encode_bin(ctx.idx("part_mode"), 0 if nxn else 1)

        half = size >> 1
        part_pos = ([(x0, y0), (x0 + half, y0), (x0, y0 + half),
                     (x0 + half, y0 + half)] if nxn else [(x0, y0)])

        # choose modes (z-order, using neighbor modes available so far)
        modes = []
        mpm_flags = []
        mpm_vals = []
        for (px, py) in part_pos:
            m = self._choose_mode(px, py, log2 - (1 if nxn else 0))
            modes.append(m)
            pb = max(1, (1 << (log2 - (1 if nxn else 0))) >> 2)
            self.syn.intra_mode_y[py >> 2:(py >> 2) + pb,
                                  px >> 2:(px >> 2) + pb] = m
            self.syn.avail[py >> 2:(py >> 2) + pb,
                           px >> 2:(px >> 2) + pb] = 1
        # derive mpm decisions in a second pass (uses final mode map,
        # matching the decoder which derives per-PU in z-order after all
        # prev flags; neighbor modes seen are those of earlier PUs)
        for i, (px, py) in enumerate(part_pos):
            mpm = self._mpm_list(px, py)
            if modes[i] in mpm:
                mpm_flags.append(1)
                mpm_vals.append(mpm.index(modes[i]))
            else:
                mpm_flags.append(0)
                rem = modes[i]
                for m in sorted(mpm, reverse=True):
                    if rem > m:
                        rem -= 1
                mpm_vals.append(rem)
        for f in mpm_flags:
            enc.encode_bin(ctx.idx("prev_intra_luma_pred_flag"), f)
        for f, v in zip(mpm_flags, mpm_vals):
            if f:
                enc.encode_tu_bypass(2, v)
            else:
                enc.encode_bypass_bits(v, 5)

        self.syn.ct_depth[by0:by0 + nb, bx0:bx0 + nb] = depth

        if self.p.chroma_modes:
            k = self._qg_serial + (x0 >> 3) + (y0 >> 3)
            if k % 5 == 4:
                enc.encode_bin(ctx.idx("intra_chroma_pred_mode"), 0)
                chroma_mode = modes[0]
            else:
                idx = k % 4
                enc.encode_bin(ctx.idx("intra_chroma_pred_mode"), 1)
                enc.encode_bypass_bits(idx, 2)
                cand = [INTRA_PLANAR, 26, 10, INTRA_DC]
                chroma_mode = 34 if cand[idx] == modes[0] else cand[idx]
        else:
            enc.encode_bin(ctx.idx("intra_chroma_pred_mode"), 0)
            chroma_mode = modes[0]

        qp = self._qg_qp
        cqp = chroma_qp(min(max(qp, 0), 57))

        # ---- transform tree (mirrors SliceParser._transform_tree) ----
        self._cur_modes = modes
        self._cur_nxn = nxn
        self._cur_cu = (x0, y0, log2)
        max_td = self.p.rqt_depth + (1 if nxn else 0)
        tree = self._plan_tt(x0, y0, log2, 0, max_td, nxn)
        self._chroma_prepass(tree, chroma_mode, cqp)
        self._emit_tt(tree, True, True, qp, None)

        self.syn.avail[by0:by0 + nb, bx0:bx0 + nb] = 1
        if self.p.cu_qp_delta:
            # per-CU QpY (spec 8.6.1, mirrors the decoder): a CU takes
            # pred + delta only once the delta has actually been written
            eff = (self._qg_pred + (self._qg_delta
                                    if self._qg_delta_written else 0)
                   + 52) % 52
            self.syn.qp_y[by0:by0 + nb, bx0:bx0 + nb] = eff
            self._qp_prev = eff

    # ----------------------------------------------- quantization groups

    def _maybe_open_qg(self, x0: int, y0: int) -> None:
        qgl = self._qg_log2
        org = (x0 >> qgl << qgl, y0 >> qgl << qgl)
        if org == self._qg_origin:
            return
        if self._pending_qp_reset:
            self._qp_prev = self.p.qp
            self._pending_qp_reset = False
        self._qg_origin = org
        self._qg_pred = self._qp_pred(org[0], org[1])
        delta = self.p.qp_delta_pattern[
            self._qg_serial % len(self.p.qp_delta_pattern)]
        self._qg_serial += 1
        self._qg_qp = (self._qg_pred + delta + 52) % 52
        self._qg_delta = delta
        self._qg_delta_written = False

    # ----------------------------------------------------- transform tree

    def _plan_tt(self, x0, y0, log2, depth, max_td, intra_split):
        """Decide the RQT structure; mirrors the decoder's forced/explicit
        split conditions (ctu.py _transform_tree)."""
        sps = self.sps
        if log2 > sps.log2_max_tb_size:
            split, explicit = 1, False
        elif intra_split and depth == 0:
            split, explicit = 1, False
        elif log2 == sps.log2_min_tb_size or depth >= max_td:
            split, explicit = 0, False
        else:
            explicit = True
            split = ((x0 >> log2) ^ (y0 >> log2) ^ depth) & 1 \
                if self.p.rqt_depth else 0
        node = dict(x0=x0, y0=y0, log2=log2, depth=depth, split=split,
                    explicit=explicit, children=None, blk_idx=0,
                    cb_tu=None, cr_tu=None, cbf_cb=False, cbf_cr=False)
        if split:
            half = 1 << (log2 - 1)
            ch = []
            for i, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                c = self._plan_tt(x0 + dx * half, y0 + dy * half, log2 - 1,
                                  depth + 1, max_td, intra_split)
                c["blk_idx"] = i
                ch.append(c)
            node["children"] = ch
        return node

    def _chroma_prepass(self, tree, cmode, cqp) -> None:
        """Prepare+reconstruct all chroma TBs of the CU in z-order.

        Chroma prediction availability is z-scan-positional (spec §6.4.1),
        so run it on a copy of the availability map that is advanced
        node-by-node — the luma plane is reconstructed later (lazily,
        during emission) and is never read by chroma prediction.
        """
        luma_avail = self._recon_helper.avail
        self._recon_helper.avail = luma_avail.copy()
        try:
            self._prepass_node(tree, cmode, cqp)
        finally:
            self._recon_helper.avail = luma_avail

    def _prepass_node(self, node, cmode, cqp) -> None:
        h = self._recon_helper
        log2 = node["log2"]
        x0, y0 = node["x0"], node["y0"]
        if node["split"] and log2 > 3:
            for c in node["children"]:
                self._prepass_node(c, cmode, cqp)
            node["cbf_cb"] = any(c["cbf_cb"] for c in node["children"])
            node["cbf_cr"] = any(c["cbf_cr"] for c in node["children"])
            return
        if node["split"]:          # log2 == 3: chroma 4x4 at the node
            clog2 = 2
        elif log2 > 2:
            clog2 = log2 - 1
        else:                      # 4x4 luma leaf: chroma lives at parent
            h.avail[y0 >> 2:(y0 + 4) >> 2, x0 >> 2:(x0 + 4) >> 2] = True
            return
        node["cb_tu"] = self._prepare_tu(x0, y0, clog2, 1, cmode, cqp)
        self._recon_tu(node["cb_tu"], bool(np.any(node["cb_tu"].coeffs)))
        node["cr_tu"] = self._prepare_tu(x0, y0, clog2, 2, cmode, cqp)
        self._recon_tu(node["cr_tu"], bool(np.any(node["cr_tu"].coeffs)))
        node["cbf_cb"] = bool(np.any(node["cb_tu"].coeffs))
        node["cbf_cr"] = bool(np.any(node["cr_tu"].coeffs))
        n = 1 << log2
        h.avail[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2] = True

    def _luma_mode_for(self, x: int, y: int) -> int:
        if not self._cur_nxn:
            return self._cur_modes[0]
        cx, cy, clog2 = self._cur_cu
        half = 1 << (clog2 - 1)
        idx = (1 if (x - cx) >= half else 0) + (2 if (y - cy) >= half else 0)
        return self._cur_modes[idx]

    def _emit_tt(self, node, parent_cbf_cb, parent_cbf_cr, qp,
                 parent) -> None:
        enc, ctx = self.enc, self.ctx
        log2, depth = node["log2"], node["depth"]
        if node["explicit"]:
            enc.encode_bin(ctx.idx("split_transform_flag", 5 - log2),
                           node["split"])
        cbf_cb, cbf_cr = parent_cbf_cb, parent_cbf_cr
        if log2 > 2:
            if depth == 0 or parent_cbf_cb:
                enc.encode_bin(ctx.idx("cbf_chroma", depth),
                               1 if node["cbf_cb"] else 0)
                cbf_cb = node["cbf_cb"]
            else:
                cbf_cb = False
            if depth == 0 or parent_cbf_cr:
                enc.encode_bin(ctx.idx("cbf_chroma", depth),
                               1 if node["cbf_cr"] else 0)
                cbf_cr = node["cbf_cr"]
            else:
                cbf_cr = False

        if node["split"]:
            for c in node["children"]:
                self._emit_tt(c, cbf_cb, cbf_cr, qp, node)
            return

        # ---- leaf: cbf_luma + transform_unit ----
        ltu = self._prepare_tu(node["x0"], node["y0"], log2, 0,
                               self._luma_mode_for(node["x0"], node["y0"]),
                               qp)
        cbf_luma = bool(np.any(ltu.coeffs))
        enc.encode_bin(ctx.idx("cbf_luma", 1 if depth == 0 else 0),
                       1 if cbf_luma else 0)

        chroma_here = log2 > 2 or node["blk_idx"] == 3
        if log2 > 2:
            cnode = node
            eff_cb, eff_cr = cbf_cb, cbf_cr
        else:
            cnode = parent
            eff_cb = parent_cbf_cb and chroma_here
            eff_cr = parent_cbf_cr and chroma_here

        # delta-QP gate mirrors spec 7.3.8.10: for 4x4 children the
        # parent's chroma cbf counts even when blk_idx < 3
        if log2 > 2:
            any_cbf = cbf_luma or eff_cb or eff_cr
        else:
            any_cbf = cbf_luma or parent_cbf_cb or parent_cbf_cr
        if any_cbf and self.p.cu_qp_delta and not self._qg_delta_written:
            self._write_delta_qp()

        if cbf_luma:
            self._write_residual(ltu)
        self._recon_tu(ltu, cbf_luma)

        if chroma_here:
            # chroma was reconstructed in the pre-pass; only the residual
            # bits are written here, in decoder order
            if eff_cb:
                self._write_residual(cnode["cb_tu"])
            if eff_cr:
                self._write_residual(cnode["cr_tu"])

    def _write_delta_qp(self) -> None:
        enc, ctx = self.enc, self.ctx
        delta = self._qg_delta
        v = abs(delta)
        prefix = min(v, 5)
        if prefix:
            enc.encode_bin(ctx.idx("cu_qp_delta_abs", 0), 1)
            for k in range(1, prefix):
                enc.encode_bin(ctx.idx("cu_qp_delta_abs", 1), 1)
            if prefix < 5:
                enc.encode_bin(ctx.idx("cu_qp_delta_abs", 1), 0)
            else:
                enc.encode_eg_bypass(0, v - 5)
        else:
            enc.encode_bin(ctx.idx("cu_qp_delta_abs", 0), 0)
        if v:
            enc.encode_bypass(1 if delta < 0 else 0)
        self._qg_delta_written = True

    # ----------------------------------------------------------------- SAO

    def _emit_sao(self, cx: int, cy: int, n_cols: int) -> None:
        """Per-CTB SAO parameter emission (spec §7.3.8.3), cycling
        through off/merge/band/edge to exercise every syntax path."""
        enc, ctx = self.enc, self.ctx
        k = (cx + cy * n_cols) % 6
        if k == 1 and cx > 0:
            enc.encode_bin(ctx.idx("sao_merge_flag"), 1)   # merge left
            return
        if cx > 0:
            enc.encode_bin(ctx.idx("sao_merge_flag"), 0)
        if k == 4 and cy > 0:
            enc.encode_bin(ctx.idx("sao_merge_flag"), 1)   # merge up
            return
        if cy > 0:
            enc.encode_bin(ctx.idx("sao_merge_flag"), 0)
        if k in (0, 1):
            enc.encode_bin(ctx.idx("sao_type_idx"), 0)     # luma off
            enc.encode_bin(ctx.idx("sao_type_idx"), 0)     # chroma off
            return
        if k in (2, 4):
            # band offsets, luma + chroma (cb signals type; cr copies)
            enc.encode_bin(ctx.idx("sao_type_idx"), 1)
            enc.encode_bypass(0)
            self._sao_band(cx + cy)
            enc.encode_bin(ctx.idx("sao_type_idx"), 1)
            enc.encode_bypass(0)
            self._sao_band(cx + cy + 1)
            self._sao_band(cx + cy + 2)
            return
        # k in (3, 5): edge offsets
        enc.encode_bin(ctx.idx("sao_type_idx"), 1)
        enc.encode_bypass(1)
        self._sao_edge((cx + cy) & 3)
        enc.encode_bin(ctx.idx("sao_type_idx"), 1)
        enc.encode_bypass(1)
        self._sao_edge((cx + 2 * cy) & 3)     # cb: offsets + shared class
        self._sao_edge(None)                  # cr: offsets only

    def _sao_band(self, seed: int) -> None:
        enc = self.enc
        offs = [(seed + i) % 3 for i in range(4)]
        for o in offs:
            enc.encode_tu_bypass(7, o)
        for i, o in enumerate(offs):
            if o:
                enc.encode_bypass((seed + i) & 1)
        enc.encode_bypass_bits((seed * 5) % 29, 5)

    def _sao_edge(self, eo_class) -> None:
        enc = self.enc
        for o in (2, 1, 1, 2):
            enc.encode_tu_bypass(7, o)
        if eo_class is not None:
            enc.encode_bypass_bits(eo_class, 2)

    def _qp_pred(self, xq: int, yq: int) -> int:
        ctb_mask = ~((1 << self.p.ctb_log2) - 1)
        qp_a = qp_b = None
        if xq - 1 >= 0 and (xq - 1) & ctb_mask == xq & ctb_mask and \
                self.syn.avail[yq >> 2, (xq - 1) >> 2]:
            qp_a = int(self.syn.qp_y[yq >> 2, (xq - 1) >> 2])
        if qp_a is None:
            qp_a = self._qp_prev
        if yq - 1 >= 0 and (yq - 1) & ctb_mask == yq & ctb_mask and \
                self.syn.avail[(yq - 1) >> 2, xq >> 2]:
            qp_b = int(self.syn.qp_y[(yq - 1) >> 2, xq >> 2])
        if qp_b is None:
            qp_b = self._qp_prev
        return (qp_a + qp_b + 1) >> 1

    def _prepare_tu(self, x0, y0, clog2, c_idx, cmode, qp):
        tu = TU(x=x0, y=y0, log2=clog2, c_idx=c_idx, pred_mode=cmode)
        # tu.qp is the dequant qP' incl. the bit-depth offset
        # (spec 8.6.1: qP = Qp + QpBdOffset); `qp` stays QpY/QpC
        tu.qp = qp + 6 * (self.p.bit_depth - 8)
        pred = self._recon_helper._predict(tu)
        shift = 1 if c_idx else 0
        n = 1 << clog2
        px, py = x0 >> shift, y0 >> shift
        src = self.src[c_idx][py:py + n, px:px + n]
        fwd = forward_transform(src - pred, clog2, c_idx, self.p.bit_depth)
        tu.coeffs = quantize(fwd, tu.qp, clog2, self.p.bit_depth)
        if self.p.sign_hiding:
            # adjust parity BEFORE reconstruction so the closed loop and
            # the written bitstream agree
            self._sign_hide_adjust(tu)
        tu._pred = pred
        return tu

    @staticmethod
    def _scan_sel(log2: int, c_idx: int, mode: int) -> int:
        scan_idx = 0
        if (c_idx == 0 and log2 in (2, 3)) or (c_idx > 0 and log2 == 2):
            if 6 <= mode <= 14:
                scan_idx = 2
            elif 22 <= mode <= 30:
                scan_idx = 1
        return scan_idx

    def _sign_hide_adjust(self, tu: TU) -> None:
        """Sign data hiding parity pre-pass (spec §7.4.9.11): the sign of
        the last-in-reverse-scan coefficient of each eligible sub-block is
        inferred from the level-sum parity; fix the parity by bumping that
        coefficient's magnitude (1→2 or n→n−1, never to zero)."""
        coeffs = tu.coeffs
        scan_idx = self._scan_sel(tu.log2, tu.c_idx, tu.pred_mode)
        n_sb = (1 << tu.log2) >> 2
        sb_scan = _SB_SCANS[(scan_idx, n_sb)]
        pos_scan = _SCANS[scan_idx]
        for i in range(n_sb * n_sb):
            sx_, sy_ = int(sb_scan[i][0]), int(sb_scan[i][1])
            sub = coeffs[sy_ << 2:(sy_ << 2) + 4, sx_ << 2:(sx_ << 2) + 4]
            nz = [n for n in range(16)
                  if sub[int(pos_scan[n][1]), int(pos_scan[n][0])]]
            if len(nz) < 2 or (max(nz) - min(nz)) <= 3:
                continue
            first_n = min(nz)
            total = int(np.abs(sub).sum())
            v = int(sub[int(pos_scan[first_n][1]),
                        int(pos_scan[first_n][0])])
            if (total & 1) != (1 if v < 0 else 0):
                adj = 1 if abs(v) == 1 else -1
                nv = (abs(v) + adj) * (1 if v > 0 else -1)
                sub[int(pos_scan[first_n][1]),
                    int(pos_scan[first_n][0])] = nv

    def _recon_tu(self, tu, cbf) -> None:
        bd = self.p.bit_depth
        if cbf:
            d = dequant(tu, bd, self._scaling)
            res = inverse_transform(tu, d, bd)
        else:
            res = 0
        shift = 1 if tu.c_idx else 0
        n = 1 << tu.log2
        px, py = tu.x >> shift, tu.y >> shift
        self.recon[tu.c_idx][py:py + n, px:px + n] = np.clip(
            tu._pred + res, 0, (1 << bd) - 1)
        if tu.c_idx == 0:
            self._recon_helper.avail[tu.y >> 2:(tu.y + n) >> 2,
                                     tu.x >> 2:(tu.x + n) >> 2] = True

    def _mpm_list(self, px: int, py: int) -> List[int]:
        syn = self.syn
        if self._avail(px - 1, py):
            cand_a = int(syn.intra_mode_y[py >> 2, (px - 1) >> 2])
        else:
            cand_a = INTRA_DC
        if self._avail(px, py - 1) and \
                (py - 1) >> self.p.ctb_log2 == py >> self.p.ctb_log2:
            cand_b = int(syn.intra_mode_y[(py - 1) >> 2, px >> 2])
        else:
            cand_b = INTRA_DC
        if cand_a == cand_b:
            if cand_a < 2:
                return [INTRA_PLANAR, INTRA_DC, INTRA_ANGULAR26]
            return [cand_a, 2 + ((cand_a + 29) % 32),
                    2 + ((cand_a - 2 + 1) % 32)]
        third = (INTRA_PLANAR if INTRA_PLANAR not in (cand_a, cand_b)
                 else (INTRA_DC if INTRA_DC not in (cand_a, cand_b)
                       else INTRA_ANGULAR26))
        return [cand_a, cand_b, third]

    # ----------------------------------------------------------- residual

    def _write_residual(self, tu: TU) -> None:
        enc, ctx = self.enc, self.ctx
        log2, c_idx = tu.log2, tu.c_idx
        size = 1 << log2
        coeffs = tu.coeffs
        mode = tu.pred_mode

        scan_idx = 0
        if (c_idx == 0 and log2 in (2, 3)) or (c_idx > 0 and log2 == 2):
            if 6 <= mode <= 14:
                scan_idx = 2
            elif 22 <= mode <= 30:
                scan_idx = 1

        n_sb = size >> 2
        sb_scan = _SB_SCANS[(scan_idx, n_sb)]
        pos_scan = _SCANS[scan_idx]

        # locate last significant coefficient in scan order
        last_scan = -1
        for i in range(n_sb * n_sb):
            sx, sy = int(sb_scan[i][0]), int(sb_scan[i][1])
            for n in range(16):
                qx, qy = int(pos_scan[n][0]), int(pos_scan[n][1])
                if coeffs[(sy << 2) + qy, (sx << 2) + qx]:
                    last_scan = i * 16 + n
        assert last_scan >= 0
        last_sb, last_pos = divmod(last_scan, 16)
        lx = (int(sb_scan[last_sb][0]) << 2) + int(pos_scan[last_pos][0])
        ly = (int(sb_scan[last_sb][1]) << 2) + int(pos_scan[last_pos][1])

        wx, wy = (ly, lx) if scan_idx == 2 else (lx, ly)

        def last_prefix_of(v: int) -> int:
            if v <= 3:
                return v
            p = 4
            while True:
                nbits = (p >> 1) - 1
                base = (2 + (p & 1)) << nbits
                if base <= v < base + (1 << nbits):
                    return p
                p += 1

        def write_last_prefix(which: str, prefix: int) -> None:
            c_max = (log2 << 1) - 1
            if c_idx == 0:
                offset = 3 * (log2 - 2) + ((log2 - 1) >> 2)
                shift = (log2 + 1) >> 2
            else:
                offset = 15
                shift = log2 - 2
            for i in range(prefix):
                enc.encode_bin(ctx.idx(which, offset + (i >> shift)), 1)
            if prefix < c_max:
                enc.encode_bin(ctx.idx(which, offset + (prefix >> shift)), 0)

        def write_last_suffix(prefix: int, v: int) -> None:
            if prefix > 3:
                nbits = (prefix >> 1) - 1
                base = (2 + (prefix & 1)) << nbits
                enc.encode_bypass_bits(v - base, nbits)

        # spec order: both prefixes, then both suffixes (§7.3.8.11)
        pfx = last_prefix_of(wx)
        pfy = last_prefix_of(wy)
        write_last_prefix("last_sig_x_prefix", pfx)
        write_last_prefix("last_sig_y_prefix", pfy)
        write_last_suffix(pfx, wx)
        write_last_suffix(pfy, wy)

        # (sign-hiding parity was already applied in _prepare_tu)
        csbf = np.zeros((n_sb, n_sb), np.uint8)
        for i in range(last_sb + 1):
            sx, sy = int(sb_scan[i][0]), int(sb_scan[i][1])
            if np.any(coeffs[sy << 2:(sy << 2) + 4, sx << 2:(sx << 2) + 4]):
                csbf[sy, sx] = 1
        csbf[int(sb_scan[last_sb][1]), int(sb_scan[last_sb][0])] = 1
        csbf[0, 0] = 1

        prev_sb_gt1 = False
        for i in range(last_sb, -1, -1):
            sx, sy = int(sb_scan[i][0]), int(sb_scan[i][1])
            explicit = not (i == last_sb or i == 0)
            sb_coded = bool(csbf[sy, sx])
            if explicit:
                right = csbf[sy, sx + 1] if sx + 1 < n_sb else 0
                below = csbf[sy + 1, sx] if sy + 1 < n_sb else 0
                ctx_inc = min(int(right) | int(below), 1) + (2 if c_idx else 0)
                enc.encode_bin(ctx.idx("coded_sub_block_flag", ctx_inc),
                               1 if sb_coded else 0)
            if not sb_coded:
                continue

            start_n = last_pos - 1 if i == last_sb else 15
            sig_pos = []
            vals = {}
            if i == last_sb:
                sig_pos.append(last_pos)
                qx, qy = int(pos_scan[last_pos][0]), int(pos_scan[last_pos][1])
                vals[last_pos] = int(coeffs[(sy << 2) + qy, (sx << 2) + qx])
            for n in range(start_n, -1, -1):
                qx, qy = int(pos_scan[n][0]), int(pos_scan[n][1])
                xc, yc = (sx << 2) + qx, (sy << 2) + qy
                v = int(coeffs[yc, xc])
                vals[n] = v
                sig = 1 if v else 0
                if n == 0 and explicit and not [k for k in sig_pos if k > 0]:
                    # DC sig inferred by the decoder (csbf guarantees a
                    # nonzero, and none was found at n>0)
                    pass
                else:
                    sctx = self._sig_ctx(xc, yc, log2, c_idx, scan_idx,
                                         sx, sy, csbf, n_sb)
                    enc.encode_bin(ctx.idx("sig_coeff_flag", sctx), sig)
                if sig:
                    sig_pos.append(n)

            ctx_set = (0 if (i == 0 or c_idx > 0) else 2)
            if prev_sb_gt1:
                ctx_set += 1
            greater1_ctx = 1
            gt1_flags = {}
            first_gt1_n = None
            for k, n in enumerate(sig_pos):
                level = abs(vals[n])
                if k < 8:
                    g1 = 1 if level > 1 else 0
                    inc = ctx_set * 4 + min(3, greater1_ctx) + \
                        (16 if c_idx else 0)
                    enc.encode_bin(
                        ctx.idx("coeff_abs_level_greater1_flag", inc), g1)
                    gt1_flags[n] = g1
                    if g1:
                        if first_gt1_n is None:
                            first_gt1_n = n
                        greater1_ctx = 0
                    elif greater1_ctx > 0:
                        greater1_ctx += 1
            if first_gt1_n is not None:
                g2 = 1 if abs(vals[first_gt1_n]) > 2 else 0
                enc.encode_bin(ctx.idx("coeff_abs_level_greater2_flag",
                                       ctx_set + (4 if c_idx else 0)), g2)
            else:
                g2 = 0
            prev_sb_gt1 = first_gt1_n is not None

            def lvl(n):
                return vals[n]

            sign_hidden = (self.p.sign_hiding and len(sig_pos) > 1 and
                           (sig_pos[0] - sig_pos[-1]) > 3)
            for n in sig_pos:
                if sign_hidden and n == sig_pos[-1]:
                    continue
                enc.encode_bypass(1 if lvl(n) < 0 else 0)

            rice = 0
            for k, n in enumerate(sig_pos):
                level = abs(lvl(n))
                if n in gt1_flags:
                    base = 1 + gt1_flags[n] + (g2 if n == first_gt1_n else 0)
                    max_base = 3 if n == first_gt1_n else 2
                else:
                    base = 1
                    max_base = 1
                if base == max_base:
                    rem = level - base
                    # inverse of the decoder's rice/prefix mapping
                    if rem < (4 << rice):
                        prefix = rem >> rice
                        for _ in range(prefix):
                            enc.encode_bypass(1)
                        enc.encode_bypass(0)
                        enc.encode_bypass_bits(rem & ((1 << rice) - 1), rice)
                    else:
                        p = 4
                        while True:
                            base2 = ((1 << (p - 3)) + 3 - 1) << rice
                            span = 1 << (p - 3 + rice)
                            if base2 <= rem < base2 + span:
                                break
                            p += 1
                        for _ in range(p):
                            enc.encode_bypass(1)
                        enc.encode_bypass(0)
                        enc.encode_bypass_bits(rem - base2, p - 3 + rice)
                if level > (3 << rice):
                    rice = min(rice + 1, 4)

    def _sig_ctx(self, xc, yc, log2, c_idx, scan_idx, sx, sy, csbf, n_sb):
        return SliceParser._sig_ctx(self, xc, yc, log2, c_idx, scan_idx,
                                    sx, sy, csbf, n_sb)


_P = ctypes.c_void_p
# tpuheif_hevc_encode_slice (host/hevc_enc.cc): params, families, the
# initial context states and their count, the three source planes, the
# five transform matrices, the output buffer and its capacity, the output
# length, the three reconstruction planes, the error text and its size
_ENCODE_ARGS = ([_P] * 4 + [ctypes.c_int32] + [_P] * 8 +
                [_P, ctypes.c_int64, _P] + [_P] * 3 +
                [ctypes.c_char_p, ctypes.c_int32])


def _encode_slice_entry():
    fn = HOST_LIBRARY.load().tpuheif_hevc_encode_slice
    if fn.argtypes is None:
        fn.argtypes = _ENCODE_ARGS
        fn.restype = ctypes.c_int
    return fn


# --------------------------------------------------------------------------
# registry encoder
# --------------------------------------------------------------------------

class HevcSequenceEncodeSession:
    """Stateful inter track encoding (ref: encoder.h:76-89 sequence
    hooks feeding x265's GOP): frame 0 is an IDR sync sample, later
    frames are P slices ("ipp"), low-delay B slices ("ldb"), or
    reordered B frames between I/P anchors ("ibp", "bpyr", which need
    ctts).  Every ``gop`` frames of "ipp" and "ldb" a new encoder starts
    with an IDR, as in the JAX session.  The encoder's references decode
    on ``device`` (``None`` means CUDA); a frame that is not YCbCr 4:2:0
    is converted on its own device first."""

    def __init__(self, width: int, height: int, qp: int,
                 gop: int = 32, gop_struct: str = "ipp", device=None):
        self.params = EncParams(qp=qp, deblock=True)
        self.gop_struct = gop_struct
        self.width, self.height = width, height
        self.gop = gop
        self.device = device
        self.enc = self._new_encoder()
        self.count = 0
        self.config = None

    def _new_encoder(self):
        from .inter_enc import SequenceEncoder
        return SequenceEncoder(self.width, self.height, self.params,
                               gop_struct=self.gop_struct,
                               device=self.device)

    def _cfg_box(self, cfg_nals):
        cfg = hvcC_from_sps(parse_hevc_sps(cfg_nals[0]))
        for n in cfg_nals:
            cfg.add_nal(n)
        return cfg

    def _prep(self, img: PixelImage) -> PixelImage:
        if img.colorspace != Colorspace.YCbCr or img.chroma != Chroma.C420:
            img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                                device=next(iter(img.planes.values())).device)
        if self.count and self.count % self.gop == 0 and \
                self.gop_struct not in ("ibp", "bpyr"):
            # periodic IDR refresh: reset the closed-loop encoder
            self.enc = self._new_encoder()
        return img

    def encode_frame(self, img: PixelImage):
        """IPPP/low-delay path (no reordering): returns
        (length-prefixed sample data, hvcC-or-None, is_sync)."""
        img = self._prep(img)
        nal, cfg_nals = self.enc.encode_frame(img)
        self.count += 1
        cfg = None
        if cfg_nals:
            cfg = self.config = self._cfg_box(cfg_nals)
        return len(nal).to_bytes(4, "big") + nal, cfg, bool(cfg_nals)

    def push_frames(self, img: PixelImage):
        """Reorder-aware path: returns a list of
        (sample data, hvcC-or-None, is_sync, cts_frame_offset) in
        decode order (possibly empty while the lookahead holds)."""
        img = self._prep(img)
        samples = self.enc.push_frame(img)
        self.count += 1
        out = []
        for s in samples:
            cfg = None
            if self.config is None and self.enc.config_nals:
                cfg = self.config = self._cfg_box(self.enc.config_nals)
            out.append((len(s.data).to_bytes(4, "big") + s.data, cfg,
                        s.is_sync, s.cts_offset))
        return out

    def flush_frames(self):
        """Drain the lookahead at end of track."""
        return [(len(s.data).to_bytes(4, "big") + s.data, None,
                 s.is_sync, s.cts_offset) for s in self.enc.flush()]


class HevcEncoder(RegistryEncoder):
    """Registry encoder for `hvc1` items and tracks (ref:
    encoder_x265.cc): quality q gives qp = 51 - q / 2, clamped to
    1..51."""

    id = "tpu-hevc"
    format = "hevc"
    lossy_supported = True

    def start_sequence_encode(self, width: int, height: int,
                              options=None, gop_struct: str = "ipp",
                              device=None) -> HevcSequenceEncodeSession:
        """A sequence session whose references decode on ``device``."""
        quality = getattr(options, "quality", 50) if options else 50
        qp = max(1, min(51, 51 - quality * 50 // 100))
        return HevcSequenceEncodeSession(width, height, qp,
                                         gop_struct=gop_struct,
                                         device=device)

    def encode_single_image(self, img: PixelImage, options=None):
        quality = getattr(options, "quality", 50) if options else 50
        qp = max(1, min(51, 51 - quality * 50 // 100))
        if img.colorspace != Colorspace.YCbCr or img.chroma != Chroma.C420:
            img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                                device=next(iter(img.planes.values())).device)
        # carry the source bit depth into the stream (Main / Main10)
        bd = img.bit_depth(Channel.Y)
        if bd not in (8, 10):
            raise HeifError.unsupported(
                SubError.Unsupported_bit_depth,
                "HEVC encoder supports 8- and 10-bit sources, not %d" % bd)
        params = EncParams(qp=qp, bit_depth=bd)
        enc = IntraEncoder(img.width, img.height, params)
        slice_nal, cfg_nals = enc.encode(img)
        cfg = hvcC_from_sps(parse_hevc_sps(cfg_nals[0]))
        for nal in cfg_nals:
            cfg.add_nal(nal)
        data = len(slice_nal).to_bytes(4, "big") + slice_nal
        return data, cfg, [(Box_ispe(img.width, img.height), False)]


def register():
    register_encoder(HevcEncoder())
