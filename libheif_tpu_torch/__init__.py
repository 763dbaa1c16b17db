"""PyTorch/CUDA port of libheif_tpu: HEIF files with unci (Bayer ones
too), hvc1 (HEVC intra), av01 (AV1 intra), jpeg, avc1 (AVC, decoded on
the host), grid, iden, overlay, tili and mski images, image sequences
(hvc1, av01, mjpg, uncv, avc1/avc3 tracks), mini files, their
transforms and alpha, the colour conversion, and the read-side metadata
(Exif, XMP, region and text items), from bytes, a path or a streaming
reader; and still-image files written with unci, mski, jpeg, hvc1 and
av01 items (``HeifContext.new_file``, ``encode_image``, ``write``).

The package mirrors the module names of ``libheif_tpu`` so each part can
be read beside its counterpart, but it imports nothing from it and never
imports JAX.  Planes are torch tensors.  Every entry point takes
``device=None``, which means ``"cuda"``: without CUDA it raises unless
the caller passes ``device="cpu"``.  The hand-written Hopper kernels
(``codecs/*/csrc/*.cu``) run on CUDA tensors; on CPU tensors each kernel
wrapper runs its plain PyTorch version.  The HEVC parser and encoder,
the JPEG scan and the AVC intra engine are host C++
(``codecs/{hevc,jpeg,avc}/host/``), built at first use on every device.
"""

__version__ = "0.1.0"

from ._build import resolve_device
from .codecs.hevc import decode_intra_picture
from .context import HeifContext
from .file import HeifFile
from .items import DecodingOptions
from .option_types import EncodingOptions
from .sequences import TrackOptions

__all__ = ["resolve_device", "HeifContext", "HeifFile", "DecodingOptions",
           "EncodingOptions", "TrackOptions", "decode_intra_picture"]
