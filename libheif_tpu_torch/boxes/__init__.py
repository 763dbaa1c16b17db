from .box import (
    Box, FullBox, BoxHeader, Box_other, Box_Error, register_box,
    register_uuid_box, read_box, read_all_boxes, BOX_REGISTRY,
    UUID_BOX_REGISTRY,
)
from . import meta  # noqa: F401  (registers the item and property boxes)
from . import unc  # noqa: F401  (registers the ISO 23001-17 boxes)
from . import codec_cfg  # noqa: F401  (registers hvcC, av1C, avcC, vvcC, jpgC)
from . import mini  # noqa: F401  (registers mini)
from . import tild  # noqa: F401  (registers tilC)
from . import seq  # noqa: F401  (registers the moov/trak/stbl family)
from . import j2k  # noqa: F401  (registers j2kH, cdef, cmap, pclr, j2kL)
from . import omaf  # noqa: F401  (registers prfr)

__all__ = [
    "Box", "FullBox", "BoxHeader", "Box_other", "Box_Error",
    "register_box", "register_uuid_box", "read_box", "read_all_boxes",
    "BOX_REGISTRY", "UUID_BOX_REGISTRY",
]
