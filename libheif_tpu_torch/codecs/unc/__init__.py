from .codec import UnciDecoder, UnciEncoder
from .registry_shim import register as _register

_register()

__all__ = ["UnciDecoder", "UnciEncoder"]
