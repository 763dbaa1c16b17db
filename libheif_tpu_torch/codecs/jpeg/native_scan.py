"""ctypes bridge to the C++ JPEG scan (host/jpeg_scan.cc).

Counterpart of the native branch of libheif_tpu/codecs/jpeg/decoder.py
(``_decode_scan_entropy_native`` :324-426), without its fused host
reconstruction: the scan fills each component's zigzag int16
coefficients, and the reconstruction runs on the decoder's device.  The
library builds at first use (``_build.JPEG_HOST_LIBRARY``) and a failed
build raises.  ctypes releases the GIL for the call, so the tiles of a
grid scan in parallel on a thread pool.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import numpy as np

from ..._build import JPEG_HOST_LIBRARY

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, ctypes.c_size_t, _I, _P, _P, _P, _P, _P, _P, _P,
         _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]

# return codes of tpuheif_jpeg_decode_scan
OK = 0
INVALID_CODE = -1
AC_OUT_OF_RANGE = -2
BAD_TABLE = -3
SEGMENTS_RAN_OUT = -4


def _entry():
    fn = JPEG_HOST_LIBRARY.load().tpuheif_jpeg_decode_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    return fn


def _table_arrays(tables: Dict[int, object]):
    """(bits (4, 16) u8, values (4, 256) u8, nvals (4,) int32) of the
    table slots 0-3; an empty slot has nvals 0."""
    bits = np.zeros((4, 16), np.uint8)
    vals = np.zeros((4, 256), np.uint8)
    nvals = np.zeros(4, np.int32)
    for tid, t in tables.items():
        if not 0 <= tid <= 3:
            continue
        bits[tid] = t.bits[1:17]
        v = t.values[:256]
        vals[tid, :len(v)] = v
        nvals[tid] = len(t.values)
    return bits, vals, nvals


def decode_scan(entropy, comps: Sequence, huff_dc, huff_ac,
                interleaved: bool, mcus_w: int, total_mcus: int,
                restart_interval: int):
    """Run the scan over ``entropy`` (the bytes between SOS and the next
    marker, stuffing and RSTn included) into each component's
    ``coeffs``; ``comps`` holds (component, DC table id, AC table id).
    Returns (return code, whether the scan read past the end)."""
    n = len(comps)

    def ints(vals):
        return np.ascontiguousarray(vals, np.int32)
    h = ints([c.h for c, _, _ in comps])
    v = ints([c.v for c, _, _ in comps])
    bw = ints([c.blocks_w for c, _, _ in comps])
    bh = ints([c.blocks_h for c, _, _ in comps])
    td = ints([t for _, t, _ in comps])
    ta = ints([t for _, _, t in comps])
    ptrs = np.asarray([c.coeffs.ctypes.data for c, _, _ in comps],
                      np.uint64)
    dc_bits, dc_vals, dc_n = _table_arrays(huff_dc)
    ac_bits, ac_vals, ac_n = _table_arrays(huff_ac)
    exhausted = ctypes.c_int(0)
    arrays = (h, v, bw, bh, td, ta, ptrs, dc_bits, dc_vals, dc_n, ac_bits,
              ac_vals, ac_n)
    buf = np.frombuffer(entropy, np.uint8)
    rc = _entry()(buf.ctypes.data, buf.size, n,
                  *(a.ctypes.data for a in arrays),
                  int(interleaved), mcus_w, total_mcus, restart_interval,
                  ctypes.byref(exhausted))
    return rc, bool(exhausted.value)
