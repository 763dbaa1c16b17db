from .item import (
    ImageItem, ImageItem_Error, DecodingOptions, ImageTiling, alloc_item,
)
from . import unci_item  # noqa: F401 (registers 'unci')
from . import codec_items  # noqa: F401 (registers 'hvc1', 'av01', 'jpeg')
from . import derived    # noqa: F401 (grid/iovl/iden)
from . import tiled_item  # noqa: F401 (registers 'tili')
from . import mask_item  # noqa: F401 (registers 'mski', mskC)

__all__ = ["ImageItem", "ImageItem_Error", "DecodingOptions", "ImageTiling",
           "alloc_item"]
