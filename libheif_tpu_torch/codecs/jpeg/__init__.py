"""JPEG (jpeg) decode: the marker parse and the Huffman scan on the host,
the dequantisation and IDCT on the device (kernel in cuda_fast)."""

from .decoder import JpegDecoder, decode_jpeg

__all__ = ["JpegDecoder", "decode_jpeg"]
