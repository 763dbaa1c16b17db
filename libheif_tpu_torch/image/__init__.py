from .pixel_image import PixelImage, Channel, Colorspace, Chroma

__all__ = ["PixelImage", "Channel", "Colorspace", "Chroma"]
