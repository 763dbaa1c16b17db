"""ctypes bridge to the C++ JPEG 2000 block coders (host/j2k_t1.cc, the
EBCOT tier-1 MQ coder, and host/ht_j2k.cc, the HT cleanup and refinement
passes).

Counterpart of ``_t1_native_lib`` (libheif_tpu/codecs/j2k/t1.py:120-131)
and ``_ht_native_lib`` (libheif_tpu/codecs/j2k/htj2k.py:46-73), without
their switch: the JAX package turns the engines off with
TPUHEIF_J2K_NATIVE and carries on in Python when its library is missing
or a call returns non-zero; here the library builds at first use
(``_build.J2K_HOST_LIBRARY``), a failed build or load raises, and so does
a failed call.  The only shape the C++ refuses, a block wider or taller
than ``MAX_SIDE``, goes to the Python coder by that condition before any
call (``fits``).  The standard keeps code-blocks to 1024 samples a side
(each exponent at most 10, their sum at most 12), but the parser takes
exponents up to 17, as the JAX one does, so a non-conformant codestream
can carry a larger block: it takes this route, in the JAX package too.

Every export returns 0 on success.  A non-zero code means:
- 1: a block larger than ``MAX_SIDE`` (routed away before the call), the
  HT tables not set (they are set when the library loads here), or an
  encoded block larger than the caller's buffer (each buffer holds the
  largest output the coder can write for its block);
- 2 (HT only): a cleanup segment that cannot be decoded, or a block that
  cannot be encoded in one segment (Scup beyond 4079 bytes).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..._build import J2K_HOST_LIBRARY
from ...core.error import ErrorCode, HeifError, SubError
from .ht_tables import VLC_TBL_INIT, VLC_TBL_NONINIT

MAX_SIDE = 4096

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    "tpuheif_j2k_t1_decode": [_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
                              _P],
    "tpuheif_j2k_t1_encode": [_P, _I32, _I32, _I32, _P, _I64, _P, _P, _P],
    "tpuheif_ht_decode_cleanup": [_P, _I64, _I32, _I32, _I32, _P],
    "tpuheif_ht_encode_cleanup": [_P, _I32, _I32, _P, _I64, _P, _P],
    "tpuheif_ht_encode_refinement": [_P, _P, _I32, _I32, _P, _I64, _P],
    "tpuheif_ht_decode_refinement": [_P, _I64, _P, _I32, _I32, _I32, _P],
}

_lib = None
_lock = threading.Lock()


def lib() -> ctypes.CDLL:
    """The loaded ``j2k_host`` library, its HT tables set (once)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = J2K_HOST_LIBRARY.load()
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            handle.tpuheif_ht_set_tables.argtypes = [_P, _P]
            handle.tpuheif_ht_set_tables.restype = None
            tbl_i = np.ascontiguousarray(VLC_TBL_INIT, np.uint16)
            tbl_n = np.ascontiguousarray(VLC_TBL_NONINIT, np.uint16)
            handle.tpuheif_ht_set_tables(tbl_i.ctypes.data,
                                         tbl_n.ctypes.data)
            _lib = handle
        return _lib


def fits(w: int, h: int) -> bool:
    """Whether the C++ coders take a ``w`` x ``h`` block."""
    return w <= MAX_SIDE and h <= MAX_SIDE


def check(rc: int, what: str, decode: bool) -> None:
    """Raise for a non-zero return code of export ``what``."""
    if rc == 0:
        return
    msg = f"JPEG 2000 {what} failed in the C++ block coder (code {rc})"
    if decode:
        raise HeifError.invalid_input(msg=msg)
    raise encoding_error(msg)


def encoding_error(msg: str) -> HeifError:
    """An Encoding_error (the JAX modules call ``HeifError.
    encoding_error``, which its HeifError lacks)."""
    return HeifError(ErrorCode.Encoding_error, SubError.Unspecified, msg)


def data_buffer(data: bytes) -> np.ndarray:
    """``data`` as a uint8 array with at least one element (a pointer the
    C++ may hold for an empty segment)."""
    return np.frombuffer(bytes(data), np.uint8) if data \
        else np.zeros(1, np.uint8)
