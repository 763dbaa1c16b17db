from .codec import UnciDecoder, UnciEncoder

__all__ = ["UnciDecoder", "UnciEncoder"]
