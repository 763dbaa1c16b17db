"""Public API value types mirroring the reference C structs.

Counterpart of libheif_tpu/api/types.py: ``EncodingOptions`` lives in
:mod:`libheif_tpu_torch.option_types` and ``ImageTiling`` beside the
read side's other option types in :mod:`libheif_tpu_torch.items.item`,
outside the api package, so that the core modules use them without
importing it.
"""

from ..items.item import ImageTiling  # noqa: F401
from ..option_types import EncodingOptions  # noqa: F401
