"""ctypes bridge to the C++ AVC intra engine (host/avc_native.cc).

Counterpart of libheif_tpu/codecs/avc/native_decode.py, without its
switch: the JAX package turns the engine off with TPUHEIF_AVC_NATIVE and
carries on in Python when its library is missing; here the library
builds at first use (``_build.AVC_HOST_LIBRARY``) and a failed build or
load raises.  The decoder (decoder.py) sends every CABAC intra picture
here by its PPS flag, never by failure.

The C++ core holds no global state: the per-frame state (per-MB flags,
QP map, intra mode map, coded-block flags, planes) lives in numpy arrays
owned by ``NativeFrame``, so a picture of several slices is one call a
slice over the same arrays.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..._build import AVC_HOST_LIBRARY
from ...core.error import HeifError
from . import headers as H
from . import tables as T

_MS_N = 8  # per-MB state stride in the C++ core (avc_native.cc enum)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_DECODE_ARGS = [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_char_p,
                _I64]
_DEBLOCK_ARGS = [_P] * 10


def _lib():
    lib = AVC_HOST_LIBRARY.load()
    if lib.tpuheif_avc_decode_slice.argtypes is None:
        lib.tpuheif_avc_decode_slice.argtypes = _DECODE_ARGS
        lib.tpuheif_avc_decode_slice.restype = ctypes.c_int64
        lib.tpuheif_avc_deblock.argtypes = _DEBLOCK_ARGS
        lib.tpuheif_avc_deblock.restype = None
    return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.int32).reshape(-1))


class _Tables:
    """Flattened table set shared by every decode (built once)."""

    def __init__(self):
        self.sig8 = _i32(T.SIG_CTX_8X8)
        self.last8 = _i32(T.LAST_CTX_8X8)
        self.zz4 = _i32(T.ZIGZAG_4X4)
        self.zz8 = _i32(T.ZIGZAG_8X8)
        self.ls4 = _i32(T.LEVEL_SCALE_4)
        self.ls8 = _i32(T.LEVEL_SCALE_8)
        self.chroma_qp = _i32(T.CHROMA_QP)
        self.alpha = np.ascontiguousarray(
            np.asarray(T.DEBLOCK_ALPHA, np.uint8))
        self.beta = np.ascontiguousarray(
            np.asarray(T.DEBLOCK_BETA, np.uint8))
        self.tc0_col2 = _i32(T.DEBLOCK_TC0[:, 2])


_tables: Optional[_Tables] = None


class NativeFrame:
    """One picture's decode state for the C++ engine (the fields of
    mb.SliceDecoder it needs); ``y``, ``cb``, ``cr`` are the uncropped
    uint16 planes (``cb``, ``cr`` one sample each when monochrome)."""

    def __init__(self, sps: H.SPS, pps: H.PPS):
        global _tables
        if _tables is None:
            _tables = _Tables()
        self.sps = sps
        self.pps = pps
        self.mb_w = sps.pic_width_in_mbs
        self.mb_h = sps.pic_height_in_map_units
        self.mono = sps.chroma_format_idc == 0
        n_mb = self.mb_w * self.mb_h
        self.mb_state = np.zeros(n_mb * _MS_N, np.int32)
        self.mb_qp = np.zeros(n_mb, np.int32)
        self.i4_modes = np.zeros((self.mb_h * 4) * (self.mb_w * 4),
                                 np.int32)
        self.cbf_luma = np.zeros((self.mb_h * 4) * (self.mb_w * 4),
                                 np.uint8)
        self.cbf_luma_dc = np.zeros(n_mb, np.uint8)
        self.cbf_cdc = np.zeros(2 * n_mb, np.uint8)
        self.cbf_cac = np.zeros(2 * (self.mb_h * 2) * (self.mb_w * 2),
                                np.uint8)
        self.y = np.zeros((self.mb_h * 16, self.mb_w * 16), np.uint16)
        if self.mono:
            self.cb = np.zeros(1, np.uint16)
            self.cr = np.zeros(1, np.uint16)
        else:
            self.cb = np.zeros((self.mb_h * 8, self.mb_w * 8), np.uint16)
            self.cr = np.zeros((self.mb_h * 8, self.mb_w * 8), np.uint16)
        self.decoded_mbs = 0

    @property
    def planes(self):
        """The uncropped planes, Y alone when monochrome."""
        return [self.y] if self.mono else [self.y, self.cb, self.cr]

    def decode_slice(self, hdr: H.SliceHeader, rbsp: bytes) -> None:
        tb = _tables
        start_byte = (hdr.header_bits + 7) // 8
        ps, vm = T.init_cabac_states(hdr.qp)
        p_state = np.asarray(ps, np.uint8)
        val_mps = np.asarray(vm, np.uint8)
        params = np.array([self.mb_w, self.mb_h, int(self.mono), hdr.qp,
                           hdr.first_mb,
                           int(self.pps.transform_8x8_mode),
                           self.pps.chroma_qp_offset(0),
                           self.pps.chroma_qp_offset(1)], np.int64)
        err = ctypes.create_string_buffer(256)
        buf = np.frombuffer(rbsp, np.uint8)
        arrays = (params, p_state, val_mps, tb.sig8, tb.last8, tb.zz4,
                  tb.zz8, tb.ls4, tb.ls8, tb.chroma_qp, self.mb_state,
                  self.mb_qp, self.i4_modes, self.cbf_luma,
                  self.cbf_luma_dc, self.cbf_cdc, self.cbf_cac, self.y,
                  self.cb, self.cr)
        n = _lib().tpuheif_avc_decode_slice(
            buf.ctypes.data, len(rbsp), start_byte,
            *(a.ctypes.data for a in arrays), err, 256)
        if n < 0:
            raise HeifError.invalid_input(
                msg="AVC native decode: " +
                err.value.decode("ascii", "replace"))
        self.decoded_mbs = int(n)

    @property
    def all_decoded(self) -> bool:
        flags = self.mb_state.reshape(-1, _MS_N)[:, 0]
        return bool(flags.all())

    def deblock(self, a_off: int, b_off: int) -> None:
        tb = _tables
        params = np.array([self.mb_w, self.mb_h, int(self.mono),
                           a_off, b_off, self.pps.chroma_qp_offset(0),
                           self.pps.chroma_qp_offset(1)], np.int64)
        arrays = (params, self.mb_state, self.mb_qp, tb.alpha, tb.beta,
                  tb.tc0_col2, tb.chroma_qp, self.y, self.cb, self.cr)
        _lib().tpuheif_avc_deblock(*(a.ctypes.data for a in arrays))
