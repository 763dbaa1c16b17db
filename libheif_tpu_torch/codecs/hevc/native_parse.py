"""ctypes bridge to the C++ HEVC slice parser (host/hevc_parse.cc) and
reconstructor (host/hevc_recon.cc).

Counterpart of libheif_tpu/codecs/hevc/native_parse.py.  The parser is
the port's only one: it builds at first use (``_build.HOST_LIBRARY``)
and a failed build raises.  The device engine takes its output in flat
form, the TU columns and coefficient buffer that
``device_recon.build_plan`` consumes (``parse_slice_raw``).  The host
engines take it too: ``decode_picture_native`` (the "native" engine)
hands it to the C++ reconstructor, and ``parse_slice_native`` (the
"python" engine) turns it into TU objects for the numpy reconstructor
(recon.py, filters.py).  ``_get_recon_tables`` hands the transform
matrices and filter tables to the C++ reconstructor and to the
encoder's C++ path (host/hevc_enc.cc).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from ...core.error import HeifError, SubError
from ..._build import HOST_LIBRARY
from .headers import SPS, PPS, SliceHeader
from .cabac import ContextModels
from .ctu import SliceSyntax, tus_from_raw

# fixed family order shared with hevc_parse.cc (enum CtxFamily)
_FAMILIES = [
    "sao_merge_flag", "sao_type_idx", "split_cu_flag",
    "cu_transquant_bypass_flag", "part_mode", "prev_intra_luma_pred_flag",
    "intra_chroma_pred_mode", "split_transform_flag", "cbf_luma",
    "cbf_chroma", "cu_qp_delta_abs", "transform_skip_flag",
    "last_sig_x_prefix", "last_sig_y_prefix", "coded_sub_block_flag",
    "sig_coeff_flag", "coeff_abs_level_greater1_flag",
    "coeff_abs_level_greater2_flag",
]

_P = ctypes.c_void_p
_ARGS = ([_P, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int32, _P,
          ctypes.c_int32] + [_P] * 10 + [ctypes.c_int32, ctypes.c_int32,
                                        _P, ctypes.c_int64, _P,
                                        ctypes.c_int64, _P, _P, _P,
                                        ctypes.c_int32, _P, _P])


def _entry(name: str):
    fn = getattr(HOST_LIBRARY.load(), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGS + ([ctypes.c_int32] if name.endswith("_wpp")
                               else [])
        fn.restype = ctypes.c_int
    return fn


def _params_array(sps: SPS, pps: PPS, sh: SliceHeader, start_ctb: int = 0,
                  slice_idx: int = 0) -> np.ndarray:
    pcm = 0
    if sps.pcm_enabled:
        pcm = 1 | (sps.log2_min_pcm_cb_size << 8) | \
            (sps.log2_max_pcm_cb_size << 16)
    vals = [
        sps.pic_width, sps.pic_height, sps.log2_ctb_size,
        sps.log2_min_cb_size, sps.log2_min_tb_size, sps.log2_max_tb_size,
        sps.max_transform_hierarchy_depth_intra,
        int(sps.sample_adaptive_offset_enabled), pcm,
        int(pps.transquant_bypass_enabled),
        int(pps.cu_qp_delta_enabled), pps.diff_cu_qp_delta_depth,
        pps.cb_qp_offset, pps.cr_qp_offset,
        int(pps.transform_skip_enabled),
        int(pps.sign_data_hiding_enabled),
        int(pps.entropy_coding_sync_enabled),
        sh.qp, int(sh.sao_luma), int(sh.sao_chroma),
        sh.cb_qp_offset, sh.cr_qp_offset,
        sps.pic_width_in_ctbs, sps.pic_height_in_ctbs,
        sps.bit_depth_luma, sps.bit_depth_chroma, start_ctb, slice_idx,
    ]
    return np.asarray(vals, dtype=np.int32)


def _alloc_parse_bufs(sps: SPS, n_workers: int = 1):
    """Scratch buffers the C++ parser fills for one slice segment.  The
    threaded WPP parse gives each of its ``n_workers`` an equal segment
    of them for its rows (every n_workers-th CTB row), so each segment
    holds the worst case of that many rows."""
    w4 = (sps.pic_width + 63) // 4 + 16
    h4 = (sps.pic_height + 63) // 4 + 16
    # worst-case TU count: every 4x4 luma position + chroma entries
    tu_cap = 2 * w4 * h4 + 64
    coeff_cap = 2 * sps.pic_width * sps.pic_height + 4096
    if n_workers > 1:
        rows = -(-sps.pic_height_in_ctbs // n_workers)
        c4 = sps.ctb_size // 4
        tu_cap = n_workers * (2 * w4 * c4 * rows + 64)
        coeff_cap = n_workers * (2 * sps.pic_width * sps.ctb_size * rows
                                 + 4096)
    tu_meta = np.empty((tu_cap, 10), dtype=np.int32)
    coeff_buf = np.empty(coeff_cap, dtype=np.int32)
    counts = np.zeros(3, dtype=np.int64)
    return tu_meta, coeff_buf, counts


def _parse_raw(sps: SPS, pps: PPS, sh: SliceHeader, rbsp: bytes,
               substreams: List[Tuple[int, int]], out: SliceSyntax,
               slice_idx: int = 0, start_ctb: int = 0,
               one_slice: bool = True):
    """Run the C++ parser on one slice segment, from CTB ``start_ctb`` to
    its end, into the picture's maps and SAO records in ``out``; returns
    (tu_meta, n_tus, coeff_buf, last CTB).  ``one_slice``: the segment is
    the whole picture, which the threaded WPP parse needs."""
    ctx = ContextModels(0, sh.qp)
    fam = np.asarray([ContextModels.LAYOUT[n][0] for n in _FAMILIES],
                     dtype=np.int32)
    init_p = np.asarray(ctx.p_state, dtype=np.uint8)
    init_m = np.asarray(ctx.val_mps, dtype=np.uint8)
    params = _params_array(sps, pps, sh, start_ctb, slice_idx)
    subs = np.asarray([v for se in substreams for v in se], dtype=np.int64)
    rbsp_arr = np.frombuffer(rbsp, dtype=np.uint8)
    err = ctypes.create_string_buffer(200)

    # WPP wavefront-parallel entropy decode: rows interleave across
    # worker threads with the spec's 2-column lag, where the stream has
    # one entry point per CTB row and no cu_qp_delta, on hosts with at
    # least 3 cores (the JAX package's rule, native_parse.py:126-148)
    n_workers = 1
    cores = os.cpu_count() or 1
    if cores >= 3 and pps.entropy_coding_sync_enabled:
        n_workers = min(cores - 1, sps.pic_height_in_ctbs)
    extra = ()
    name = "tpuheif_hevc_parse_slice"
    if n_workers > 1 and pps.entropy_coding_sync_enabled and \
            not pps.cu_qp_delta_enabled and one_slice and \
            len(substreams) >= sps.pic_height_in_ctbs:
        name += "_wpp"
        extra = (n_workers,)
    tu_meta, coeff_buf, counts = _alloc_parse_bufs(
        sps, extra[0] if extra else 1)

    ptr = [a.ctypes.data for a in (
        rbsp_arr, params, fam, init_p, init_m, subs, out.intra_mode_y,
        out.intra_mode_c, out.ct_depth, out.cu_log2, out.tu_log2, out.qp_y,
        out.tqb_map, out.nonzero_y, out.avail, out.slice_map4, tu_meta,
        coeff_buf, out.sao_buf, counts)]
    if one_slice:       # no slice map to test or claim: slice 0 everywhere
        ptr[15] = None
    rc = _entry(name)(
        ptr[0], len(rbsp), ptr[1], ptr[2], ptr[3], ptr[4], len(init_p),
        ptr[5], len(substreams), *ptr[6:16], out.w4, out.h4,
        ptr[16], tu_meta.shape[0], ptr[17], coeff_buf.shape[0], ptr[18],
        ptr[19], err, len(err), None, None, *extra)
    if rc == 2:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    err.value.decode() or "unsupported")
    if rc != 0:
        raise HeifError.invalid_input(
            msg=err.value.decode() or "HEVC slice parse failed")
    return tu_meta, int(counts[0]), coeff_buf, int(counts[2])


def parse_slice_raw(sps: SPS, pps: PPS, sh: SliceHeader, rbsp: bytes,
                    substreams: List[Tuple[int, int]], out: SliceSyntax,
                    slice_idx: int = 0, start_ctb: int = 0,
                    one_slice: bool = True):
    """Parse one slice segment for the device reconstruction into the
    picture's ``out`` (decoder.parse_picture walks a picture's segments):
    returns (cols (N, 8) int32 [x y log2 c mode qp ts tqb], coeff_buf,
    offs (N,) int64 offsets into coeff_buf, -1 = no residual, the
    segment's last CTB)."""
    tu_meta, n_tus, coeff_buf, last_ctb = _parse_raw(
        sps, pps, sh, rbsp, substreams, out, slice_idx, start_ctb,
        one_slice)
    cols = np.ascontiguousarray(
        tu_meta[:n_tus][:, [0, 1, 2, 3, 4, 5, 7, 8]], np.int32)
    offs = tu_meta[:n_tus, 9].astype(np.int64)
    # trim the scratch coefficient buffer to its used length (it is
    # over-allocated and the tail is uninitialized)
    has = offs >= 0
    used = int((offs[has] + (1 << (2 * cols[has, 2].astype(np.int64)))
                ).max()) if has.any() else 0
    coeff_buf = np.ascontiguousarray(coeff_buf[:used])
    if sps.sample_adaptive_offset_enabled and (sh.sao_luma or sh.sao_chroma):
        out.sao_table = out.sao_buf.reshape(sps.pic_height_in_ctbs,
                                            sps.pic_width_in_ctbs, 20)
    return cols, coeff_buf, offs, last_ctb


def parse_slice_native(sps: SPS, pps: PPS, sh: SliceHeader, rbsp: bytes,
                       substreams: List[Tuple[int, int]]) -> SliceSyntax:
    """Parse a picture of one intra slice with the C++ parser into a
    SliceSyntax with TU objects (``tus``) and per-CTB SAO parameters
    (``sao``), the numpy engine's input (JAX native_parse.py:201-219; JAX
    ``parse_slice`` :253 also sends P and B slices to its Python parser,
    which the port's numpy engine, an intra one, does not need)."""
    out = SliceSyntax(sps, pps, sh)
    cols, coeff, offs, _ = parse_slice_raw(sps, pps, sh, rbsp, substreams,
                                           out)
    out.tus = tus_from_raw(cols, coeff, offs)
    out.sao_from_table()
    return out


# ------------------------------------------------------------ tables

_recon_tables = None


def _get_recon_tables():
    """int32 copies of the authoritative Python tables for the C++ code
    (tables.py stays the single source of truth): the reconstructor
    (host/hevc_recon.cc) takes all of them, the HEVC encoder's C++ path
    (host/hevc_enc.cc) the transform matrices.  JAX native_parse.py:270."""
    global _recon_tables
    if _recon_tables is None:
        from .tables import DCT, DST4, INTRA_PRED_ANGLE, INTRA_INV_ANGLE
        from .filters import BETA_TABLE, TC_TABLE
        pred_angle = np.zeros(35, np.int32)
        inv_angle = np.zeros(35, np.int32)
        for mode in range(2, 35):
            a = INTRA_PRED_ANGLE[mode]
            pred_angle[mode] = a
            if a < 0:
                inv_angle[mode] = INTRA_INV_ANGLE[a]
        _recon_tables = dict(
            dst4=np.ascontiguousarray(DST4, np.int32),
            dct4=np.ascontiguousarray(DCT[4], np.int32),
            dct8=np.ascontiguousarray(DCT[8], np.int32),
            dct16=np.ascontiguousarray(DCT[16], np.int32),
            dct32=np.ascontiguousarray(DCT[32], np.int32),
            beta=np.ascontiguousarray(BETA_TABLE, np.int32),
            tc=np.ascontiguousarray(TC_TABLE, np.int32),
            pred_angle=pred_angle, inv_angle=inv_angle)
    return _recon_tables


# ------------------------------------------------------------- recon

_RECON_ARGS = [_P] + [_P, ctypes.c_int64] + [_P] * 5 + \
    [ctypes.c_int32, ctypes.c_int32] + [_P] * 13 + \
    [ctypes.c_int32, _P, ctypes.c_int32]


def _recon_entry():
    fn = HOST_LIBRARY.load().tpuheif_hevc_recon
    if fn.argtypes is None:
        fn.argtypes = _RECON_ARGS
        fn.restype = ctypes.c_int
    return fn


def decode_picture_native(sps: SPS, pps: PPS, sh: SliceHeader, rbsp: bytes,
                          substreams: List[Tuple[int, int]]):
    """The "native" engine of a picture of one slice (JAX
    native_parse.py:296-396, serial): the C++ parse of the whole picture,
    then the C++ reconstruction, deblocking and SAO, with no per-TU Python
    objects.  Returns the uncropped (Y, Cb, Cr) uint16 planes.  A
    scaling-list picture raises Unsupported: the C++ dequantiser is
    flat."""
    if sps.scaling_list_enabled:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    "native engine unavailable")
    out = SliceSyntax(sps, pps, sh)
    tu_meta, n_tus, coeff_buf, _ = _parse_raw(sps, pps, sh, rbsp,
                                              substreams, out)
    sao_present = int(sps.sample_adaptive_offset_enabled and
                      (sh.sao_luma or sh.sao_chroma))
    rparams = np.asarray([
        sps.pic_width, sps.pic_height, sps.log2_ctb_size,
        sps.bit_depth_luma, sps.bit_depth_chroma,
        int(sps.strong_intra_smoothing),
        int(sh.deblocking_filter_disabled),
        sh.beta_offset_div2 * 2, sh.tc_offset_div2 * 2,
        pps.cb_qp_offset, pps.cr_qp_offset, sao_present,
    ], dtype=np.int32)
    t = _get_recon_tables()
    y = np.empty((sps.pic_height, sps.pic_width), np.uint16)
    cb = np.empty((sps.pic_height >> 1, sps.pic_width >> 1), np.uint16)
    cr = np.empty_like(cb)
    err = ctypes.create_string_buffer(200)
    rc = _recon_entry()(
        rparams.ctypes.data, tu_meta.ctypes.data, n_tus,
        coeff_buf.ctypes.data, *(a.ctypes.data for a in (
            out.tu_log2, out.cu_log2, out.qp_y, out.tqb_map)),
        out.w4, out.h4, out.sao_buf.ctypes.data,
        *(t[k].ctypes.data for k in ("dst4", "dct4", "dct8", "dct16",
                                     "dct32", "beta", "tc", "pred_angle",
                                     "inv_angle")),
        y.ctypes.data, cb.ctypes.data, cr.ctypes.data, 1, err, len(err))
    if rc != 0:
        raise HeifError.invalid_input(
            msg=err.value.decode() or "HEVC reconstruction failed")
    return y, cb, cr
