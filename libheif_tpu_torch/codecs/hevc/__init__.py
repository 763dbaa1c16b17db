"""HEVC (hvc1) still-image decode: the C++ parser on the host, the
reconstruction on the device (device_recon, kernels in cuda_fast)."""

from .decoder import HevcDecoder, decode_intra_picture

__all__ = ["HevcDecoder", "decode_intra_picture"]
