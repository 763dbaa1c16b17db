"""AV1 (av01) still-image decode: the OBU and tile parse on the host, the
reconstruction and the in-loop filters on the device (device_recon,
kernels in cuda_fast)."""

from .decoder import Av1Decoder, decode_intra_frame

__all__ = ["Av1Decoder", "decode_intra_frame"]
