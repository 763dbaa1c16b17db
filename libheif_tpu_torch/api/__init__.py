"""Public API package: the compatibility surface mirroring the
reference's C headers (ref: libheif/api/libheif/*); counterpart of
libheif_tpu/api/__init__.py.

Every function keeps its reference C name (`heif_context_read_from_file`
etc.) and the JAX package's signature, so code written against either
maps 1:1.  Objects are Python-native (HeifContext, PixelImage, torch
planes) instead of opaque pointers, and errors raise HeifError instead
of returning heif_error (see api.error.catching() for C-style capture).
A context allocated with ``heif_context_alloc(device=None)`` lives on
the card (it raises without one; pass ``device="cpu"`` for the CPU):
the planes that ``heif_decode_image`` gives lie there, the encoders
read an image's planes on its device, and the plane and component
getters return the image's own tensors (api/image.py,
api/components.py).  Plugins (``heif_load_plugin``) register with the
port's codec registry; native ones load through api/native_plugin.py,
which this package does not import, as in JAX.

Module ↔ reference header map:
  error          heif_error.h            library       heif_library.h
  context        heif_context.h          image_handle  heif_image_handle.h
  image          heif_image.h            decoding      heif_decoding.h
  encoding       heif_encoding.h         color         heif_color.h
  properties     heif_properties.h       items         heif_items.h
  metadata       heif_metadata.h         brands        heif_brands.h
  regions        heif_regions.h          text          heif_text.h
  tiling         heif_tiling.h           security      heif_security.h
  aux_images     heif_aux_images.h       entity_groups heif_entity_groups.h
  uncompressed   heif_uncompressed.h     experimental  heif_experimental.h
  components     heif_components.h       omaf          heif_omaf.h
  sequences      heif_sequences.h        tai_timestamps heif_tai_timestamps.h
  plugin         heif_plugin.h
"""

from .types import ImageTiling, EncodingOptions

from .error import *            # noqa: F401,F403
from .library import *          # noqa: F401,F403
from .context import *          # noqa: F401,F403
from .image_handle import *     # noqa: F401,F403
from .image import *            # noqa: F401,F403
from .decoding import *         # noqa: F401,F403
from .encoding import *         # noqa: F401,F403
from .color import *            # noqa: F401,F403
from .properties import *       # noqa: F401,F403
from .items import *            # noqa: F401,F403
from .metadata import *        # noqa: F401,F403
from .brands import *           # noqa: F401,F403
from .regions import *          # noqa: F401,F403
from .text import *             # noqa: F401,F403
from .tiling import *           # noqa: F401,F403
from .security import *         # noqa: F401,F403
from .aux_images import *       # noqa: F401,F403
from .entity_groups import *    # noqa: F401,F403
from .uncompressed import *     # noqa: F401,F403
from .experimental import *     # noqa: F401,F403
from .components import *       # noqa: F401,F403
from .omaf import *             # noqa: F401,F403
from .plugin import *           # noqa: F401,F403
from .sequences import *        # noqa: F401,F403
from .tai_timestamps import *   # noqa: F401,F403

from ..context import HeifContext  # noqa: F401  (pythonic entry point)

__all__ = ["HeifContext", "ImageTiling", "EncodingOptions"]
