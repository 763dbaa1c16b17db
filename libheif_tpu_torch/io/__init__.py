"""Host I/O: the image-file codecs (PNG, Y4M, PPM, JPEG, TIFF, WebP) and
the streaming reader protocol; counterpart of libheif_tpu/io/__init__.py.

PNG, Y4M and PPM are byte codecs over numpy arrays (a tensor given to a
writer is copied to the host once).  JPEG goes through the port's JPEG
codec on the device of the image (``read_jpeg(data, device=None)``: one
``jpeg_dequant_idct`` launch on a card; ``write_jpeg``: one
``jpeg_fdct_quant``).  TIFF and WebP take and return PixelImages whose
planes stay on their device, with one host copy each way.  Every reader's
``device=None`` means CUDA; pass ``device="cpu"`` for the CPU.
"""

from .png import read_png, write_png
from .y4m import read_y4m, write_y4m
from .ppm import read_ppm, write_ppm
from .reader import (CallbackReader, FileReader, GrowStatus, MemoryReader,
                     StreamReader)
from .jpeg import read_jpeg, write_jpeg, read_jpeg_file, write_jpeg_file
from .tiff import read_tiff, write_tiff, read_tiff_file, write_tiff_file
from .webp import read_webp, write_webp, read_webp_file, write_webp_file

__all__ = ["read_png", "write_png", "read_y4m", "write_y4m",
           "read_ppm", "write_ppm", "read_jpeg", "write_jpeg",
           "read_jpeg_file", "write_jpeg_file", "read_tiff", "write_tiff",
           "read_tiff_file", "write_tiff_file", "read_webp", "write_webp",
           "read_webp_file", "write_webp_file", "StreamReader",
           "MemoryReader", "FileReader", "CallbackReader", "GrowStatus"]
