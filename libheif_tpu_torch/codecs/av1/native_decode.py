"""ctypes bridge to the C++ AV1 frame decoder (host/av1_native.cc), the
"native" engine of ``decoder.decode_intra_frame_ex``.

Counterpart of libheif_tpu/codecs/av1/native_decode.py.  Python stays
the single source of truth for the tables: the default CDF set
(default_cdfs.npz via cdf.CdfContext) and the prediction tables are
flattened into one int32 buffer whose layout av1_native.cc mirrors
(CDF_SIZES / EXTRA_SIZES).  The library builds at first use
(``_build.AV1_HOST_LIBRARY``) and a failed build raises.  A stream with a
feature the C++ decoder lacks (delta_q_present, a bit depth other than 8,
10 or 12) raises Unsupported, where the JAX bridge returns None and its
decoder raises the same error for engine "native".

Replaces the external decode boundary of the reference (reference:
libheif/plugins/decoder_dav1d.cc:457, decoder_aom.cc:446).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import numpy as np

from ..._build import AV1_HOST_LIBRARY
from ...core.error import HeifError, SubError
from . import tables as T
from .cdf import CdfContext, _load

_cdf_cache: Dict[int, np.ndarray] = {}
_cdf_lock = threading.Lock()

_P = ctypes.c_void_p
_ARGS = [_P, ctypes.c_longlong, _P, ctypes.c_int, _P, ctypes.c_int, _P,
         ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_int]


def _entry():
    fn = AV1_HOST_LIBRARY.load().tpuheif_av1_decode_frame
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    return fn


def _unavailable() -> HeifError:
    return HeifError.unsupported(SubError.Unsupported_codec,
                                 "native AV1 engine unavailable")


def _q_bucket(base_q_idx: int) -> int:
    if base_q_idx <= 20:
        return 0
    if base_q_idx <= 60:
        return 1
    if base_q_idx <= 120:
        return 2
    return 3


def _flatten_cdf_buf(base_q_idx: int) -> np.ndarray:
    """Serialize the default CDFs + pred tables in the fixed order
    shared with av1_native.cc (CDF_SIZES/EXTRA_SIZES)."""
    q = _q_bucket(base_q_idx)
    with _cdf_lock:
        if q in _cdf_cache:
            return _cdf_cache[q]
        c = CdfContext(base_q_idx)
        d = _load()

        def arr(x):
            return np.asarray(x, np.int32).ravel()

        parts = [
            arr(c.txb_skip), arr(c.eob_extra), arr(c.dc_sign),
            arr(c.eob_pt[16]), arr(c.eob_pt[32]), arr(c.eob_pt[64]),
            arr(c.eob_pt[128]), arr(c.eob_pt[256]), arr(c.eob_pt[512]),
            arr(c.eob_pt[1024]),
            arr(c.coeff_base_eob), arr(c.coeff_base), arr(c.coeff_br),
            arr(c.kf_y_mode), arr(c.uv_mode), arr(c.partition),
            arr(c.intra_ext_tx), arr(c.cfl_sign), arr(c.cfl_alpha),
            arr(c.filter_intra_use), arr(c.filter_intra_mode),
            arr(c.tx_size), arr(c.angle_delta), arr(c.skip),
            arr(c.palette_y_mode), arr(c.palette_uv_mode),
            arr(c.palette_y_size), arr(c.palette_uv_size),
            arr(c.palette_y_color), arr(c.palette_uv_color),
            arr(c.restore_switchable), arr(c.restore_wiener),
            arr(c.restore_sgrproj),
            # intrabc / inter-tx tables (av1_native.cc CDF_SIZES tail)
            arr(c.intrabc), arr(c.txfm_partition), arr(c.dv_joints),
            arr(c.dv_sign), arr(c.dv_classes), arr(c.dv_class0),
            arr(c.dv_bits), arr(c.inter_ext_tx),
            # pred tables (extras)
            arr(d["sm_weights"]), arr(d["dr_intra_derivative"]),
            arr(d["filter_intra_taps"]),
        ]
        buf = np.ascontiguousarray(np.concatenate(parts), np.int32)
        _cdf_cache[q] = buf
        return buf


def _params_array(seq, fh) -> np.ndarray:
    mi_cols = (fh.frame_width + 7) // 8 * 2
    mi_rows = (fh.frame_height + 7) // 8 * 2

    def pad8(lst):
        out = list(lst) + [0] * (8 - len(lst))
        return out[:8]

    vals = [
        mi_cols, mi_rows, fh.frame_width, fh.frame_height,
        seq.bit_depth, seq.subsampling_x, seq.subsampling_y,
        int(seq.monochrome), int(seq.use_128x128_superblock),
        fh.quant.base_q_idx,
        fh.quant.delta_q_y_dc, fh.quant.delta_q_u_dc, fh.quant.delta_q_u_ac,
        fh.quant.delta_q_v_dc, fh.quant.delta_q_v_ac,
        int(fh.coded_lossless), int(fh.tx_mode_select),
        int(fh.reduced_tx_set), int(fh.allow_screen_content_tools),
        int(seq.enable_filter_intra), int(seq.enable_intra_edge_filter),
        int(seq.enable_cdef), int(fh.allow_intrabc),
        int(fh.disable_cdf_update), int(fh.delta_q_present),
        fh.cdef.damping, fh.cdef.bits,
        *pad8(fh.cdef.y_pri), *pad8(fh.cdef.y_sec),
        *pad8(fh.cdef.uv_pri), *pad8(fh.cdef.uv_sec),
        *list(fh.lr_type), *list(fh.lr_unit_size),
        *list(fh.loop_filter_levels), fh.loop_filter_sharpness,
        int(fh.loop_filter_delta_enabled), fh.loop_filter_ref_deltas[0],
        # bit-depth-matched dequant lookups (spec 7.12.2) so the C
        # engine needs no embedded 10/12-bit tables
        *T.dc_qlookup(seq.bit_depth).tolist(),
        *T.ac_qlookup(seq.bit_depth).tolist(),
    ]
    return np.asarray(vals, dtype=np.int32)


def decode_frame_native(seq, fh, tiles) -> Dict[str, np.ndarray]:
    """Decode one intra frame in C++ (parse + recon + in-loop filters).
    tiles: the tile byte strings in raster order.  Returns the cropped
    plane dict ("Y", and "U", "V" unless monochrome), uint8 at 8 bits
    and uint16 above, like the JAX bridge."""
    if seq.bit_depth not in (8, 10, 12) or fh.delta_q_present:
        raise _unavailable()
    mi_cols = (fh.frame_width + 7) // 8 * 2
    mi_rows = (fh.frame_height + 7) // 8 * 2
    sb_mi = 32 if seq.use_128x128_superblock else 16
    ti = fh.tile_info

    tile_bytes = b"".join(tiles)
    meta = []
    off = 0
    idx = 0
    for trow in range(ti.rows):
        for tcol in range(ti.cols):
            mc0 = ti.col_starts[tcol] * sb_mi
            mc1 = min(ti.col_starts[tcol + 1] * sb_mi, mi_cols)
            mr0 = ti.row_starts[trow] * sb_mi
            mr1 = min(ti.row_starts[trow + 1] * sb_mi, mi_rows)
            size = len(tiles[idx])
            meta += [off, size, mc0, mc1, mr0, mr1]
            off += size
            idx += 1
    meta_arr = np.asarray(meta, np.int64)
    tiles_arr = np.frombuffer(tile_bytes, np.uint8) if tile_bytes \
        else np.zeros(1, np.uint8)

    params = _params_array(seq, fh)
    cdf_buf = _flatten_cdf_buf(fh.quant.base_q_idx)

    pw, ph = mi_cols * 4, mi_rows * 4
    ssx, ssy = seq.subsampling_x, seq.subsampling_y
    out_dt = np.uint8 if seq.bit_depth <= 8 else np.uint16
    y = np.zeros((ph, pw), out_dt)
    if seq.monochrome:
        u = v = np.zeros(1, out_dt)
    else:
        u = np.zeros((ph >> ssy, pw >> ssx), out_dt)
        v = np.zeros_like(u)
    err = ctypes.create_string_buffer(200)

    rc = _entry()(
        tiles_arr.ctypes.data, len(tile_bytes), meta_arr.ctypes.data,
        len(meta) // 6, params.ctypes.data, len(params),
        cdf_buf.ctypes.data, len(cdf_buf), y.ctypes.data, u.ctypes.data,
        v.ctypes.data, err, len(err))
    if rc == 2:
        raise _unavailable()
    if rc != 0:
        raise HeifError.invalid_input(
            msg=err.value.decode() or "AV1 native decode failed")

    w, h = fh.frame_width, fh.frame_height
    if seq.monochrome:
        return {"Y": y[:h, :w]}
    cw = (w + (1 << ssx) - 1) >> ssx
    ch = (h + (1 << ssy) - 1) >> ssy
    return {"Y": y[:h, :w], "U": u[:ch, :cw], "V": v[:ch, :cw]}
