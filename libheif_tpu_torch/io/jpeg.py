"""JPEG/JFIF import/export (heifio equivalent); counterpart of
libheif_tpu/io/jpeg.py.

Re-designed equivalent of the reference's heifio JPEG converters
(reference: heifio/decoder_jpeg.cc, heifio/encoder_jpeg.cc): the file
codec is the port's own JPEG codec (codecs/jpeg), the one that decodes
'jpeg' items, so on a card ``read_jpeg`` is one ``jpeg_dequant_idct``
launch and ``write_jpeg`` one ``jpeg_fdct_quant`` launch.
"""

from __future__ import annotations


def read_jpeg(data: bytes, device=None):
    """JFIF bytes → PixelImage (YCbCr, subsampling preserved) on
    ``device`` (``None`` means CUDA)."""
    from ..codecs.jpeg.decoder import JpegDecoder
    return JpegDecoder(device).decode_single_image(None, data)


def write_jpeg(img, quality: int = 90) -> bytes:
    """PixelImage → JFIF bytes, encoded on the device of its planes."""
    from ..codecs.jpeg.encoder import JpegEncoder
    from ..option_types import EncodingOptions
    data, _cfg, _props = JpegEncoder().encode_single_image(
        img, EncodingOptions(quality=quality))
    return data


def read_jpeg_file(path: str, device=None):
    with open(path, "rb") as f:
        return read_jpeg(f.read(), device)


def write_jpeg_file(img, path: str, quality: int = 90) -> None:
    with open(path, "wb") as f:
        f.write(write_jpeg(img, quality))
