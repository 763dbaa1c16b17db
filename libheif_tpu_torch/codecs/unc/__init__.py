from .codec import UnciDecoder

__all__ = ["UnciDecoder"]
