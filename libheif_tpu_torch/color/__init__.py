from .nclx import NclxProfile, get_kr_kb
from .state import ColorState
from .pipeline import convert_image, ColorConversionOptions

__all__ = ["NclxProfile", "get_kr_kb", "ColorState", "convert_image",
           "ColorConversionOptions"]
