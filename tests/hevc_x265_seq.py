"""Encode HEVC sequences (I, P and B pictures) with libx265 through ctypes,
for the inter syntax the JAX package's SequenceEncoder does not write:
intra CUs inside P and B pictures, asymmetric and rectangular partitions
(AMP, 2NxN, Nx2N, 8x4), several reference pictures, SAO and WPP in P and
B pictures.

Built on tests/hevc_x265.py (the library, its options by name and the
``x265_picture`` layout: pts at byte 0, planes at 24, strides at 48).
8-bit 4:2:0 only.

    encode_sequence([(y, cb, cr), ...], qp=30, bframes=3) ->
        (config NALs [VPS, SPS, PPS], [(slice NAL, is_sync, cts offset in
        frames)] in decode order)
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tests.hevc_x265 import _Nal, _load, _split_annexb

# x265 defaults (medium preset) plus a fixed closed GOP: one IDR, then a
# B pyramid of three B pictures between P pictures
SEQUENCE_DEFAULTS: Dict[str, object] = {
    "fps": "25", "input-csp": "i420", "aq-mode": "0", "cutree": False,
    "frame-threads": "1", "pools": "1", "repeat-headers": True,
    "info": False, "hash": "0", "log-level": "none", "open-gop": False,
    "scenecut": "0", "b-adapt": "0", "bframes": "3", "b-pyramid": True,
    "weightp": False, "weightb": False, "psy-rd": "0", "psy-rdoq": "0",
    "lookahead-slices": "0", "rc-lookahead": "5"}


def encode_sequence(frames: Sequence[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]],
                    qp: int = 30, **opts):
    """8-bit 4:2:0 frames in display order → (config NALs, samples in
    decode order: (slice NAL, IDR, presentation minus decode index)).
    ``opts`` are x265 options by name (``amp=True``, ``ref=3``;
    underscores become dashes, booleans "1"/"0")."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libx265.so.199 not available")
    h, w = frames[0][0].shape
    p = lib.x265_param_alloc()
    try:
        if lib.x265_param_default_preset(p, b"medium", None) != 0:
            raise RuntimeError("x265_param_default_preset failed")
        base = dict(SEQUENCE_DEFAULTS, **{"input-res": f"{w}x{h}",
                                          "keyint": str(len(frames)),
                                          "qp": str(qp)})
        for k, v in opts.items():
            base[k.replace("_", "-")] = v
        for k, v in base.items():
            if isinstance(v, bool):
                v = "1" if v else "0"
            if lib.x265_param_parse(p, k.encode(), str(v).encode()) != 0:
                raise RuntimeError(f"x265_param_parse({k}={v}) failed")
        enc = lib.x265_encoder_open_199(p)
        if not enc:
            raise RuntimeError("x265_encoder_open failed")
        pic = lib.x265_picture_alloc()
        stream = b""
        try:
            lib.x265_picture_init(p, pic)
            raw = (ctypes.c_int32 * 20).from_address(pic)
            if raw[15] != 8 or raw[18] != 1:     # bitDepth, colorSpace
                raise RuntimeError("unexpected x265_picture layout")
            pts = ctypes.c_int64.from_address(pic)
            ptrs = (ctypes.c_void_p * 3).from_address(pic + 24)
            strides = (ctypes.c_int32 * 3).from_address(pic + 48)
            nals = ctypes.POINTER(_Nal)()
            n = ctypes.c_uint32(0)
            keep = []
            for i in range(len(frames) + 64):
                src: Optional[int] = None
                if i < len(frames):
                    planes = [np.ascontiguousarray(a, np.uint8)
                              for a in frames[i]]
                    keep.append(planes)
                    for k, a in enumerate(planes):
                        ptrs[k] = a.ctypes.data
                        strides[k] = a.strides[0]
                    pts.value = i
                    src = pic
                rc = lib.x265_encoder_encode(enc, ctypes.byref(nals),
                                             ctypes.byref(n), src, None)
                if rc < 0:
                    raise RuntimeError("x265_encoder_encode failed")
                for k in range(n.value):
                    stream += ctypes.string_at(nals[k].payload, nals[k].size)
                if src is None and rc == 0:
                    break
        finally:
            lib.x265_picture_free(pic)
            lib.x265_encoder_close(enc)
    finally:
        lib.x265_param_free(p)
    return _samples(_split_annexb(stream))


def _samples(nals: List[bytes]):
    """Config NALs and (slice NAL, IDR, cts offset) in decode order; the
    presentation index is the POC (one closed GOP from an IDR)."""
    from libheif_tpu_torch.codecs.hevc import headers as H
    cfg, slices = [], []
    sps = pps = None
    for nal in nals:
        t = H.nal_type(nal)
        if t in (32, 33, 34):
            if not any(c == nal for c in cfg):
                cfg.append(nal)
            if t == 33:
                sps = H.parse_sps(nal)
            elif t == 34:
                pps = H.parse_pps(nal)
        elif H.is_slice(t):
            slices.append(nal)
    out = []
    for k, nal in enumerate(slices):
        t = H.nal_type(nal)
        poc = 0 if t in (19, 20) else _poc_lsb(nal, sps, pps)
        out.append((nal, t in (19, 20), poc - k))
    return cfg, out


def _poc_lsb(nal: bytes, sps, pps) -> int:
    """slice_pic_order_cnt_lsb of a picture's first slice segment (the
    header's start, spec 7.3.6.1; read by hand, as the port's header
    parser refuses the streams of some tests before reaching it)."""
    from libheif_tpu_torch.boxes.codec_cfg import remove_emulation_prevention
    from libheif_tpu_torch.core.bitstream import BitReader
    from libheif_tpu_torch.codecs.hevc import headers as H
    br = BitReader(remove_emulation_prevention(nal[2:]))
    if not br.read_flag():
        raise ValueError("not the first slice segment of a picture")
    if H.is_irap(H.nal_type(nal)):
        br.read_flag()                  # no_output_of_prior_pics_flag
    br.read_ue()                        # slice_pic_parameter_set_id
    br.skip_bits(pps.num_extra_slice_header_bits)
    br.read_ue()                        # slice_type
    if pps.output_flag_present:
        br.read_flag()
    return br.read_bits(sps.log2_max_pic_order_cnt_lsb)
