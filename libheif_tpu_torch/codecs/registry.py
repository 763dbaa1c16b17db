"""Codec registry, encoder half: the port's stand-in for the plugin system.

Counterpart of the encoder half of libheif_tpu/codecs/registry.py
(``Encoder`` :38, ``register_encoder``, ``get_encoder``, ``have_encoder``,
``list_encoders``, ``unregister_encoder``; reference:
libheif/plugin_registry.{h,cc}, priority-ordered encoder sets
plugin_registry.cc:115-128, plugin ABI heif_plugin.h:192).  Encoders
register with a priority; lookup returns the highest-priority encoder for
a compression format, optionally pinned by id.  ``HeifContext.
encode_image`` reaches every format but ``unci`` and ``mski`` through it;
the JPEG encoder registers itself when its module is imported.  The port
decodes without a registry: its items call their codecs directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class Encoder:
    """Encoder interface (ref: heif_encoder_plugin heif_plugin.h:192)."""

    id: str = "unknown"
    format: str = "unknown"
    priority: int = 100
    lossy_supported = True
    lossless_supported = False

    def encode_single_image(self, img, options=None):
        """Returns CodedImageData-like (data, config_box, extra_props)."""
        raise NotImplementedError

    def parameters(self) -> List[dict]:
        """Typed parameter introspection (ref: heif_encoding.h:154+)."""
        return []


_encoders: Dict[str, List[Encoder]] = {}


def register_encoder(enc: Encoder) -> None:
    lst = _encoders.setdefault(enc.format, [])
    lst.append(enc)
    lst.sort(key=lambda e: -e.priority)


def get_encoder(fmt: str,
                encoder_id: Optional[str] = None) -> Optional[Encoder]:
    for e in _encoders.get(fmt, []):
        if encoder_id is None or e.id == encoder_id:
            return e
    return None


def have_encoder(fmt: str) -> bool:
    return bool(_encoders.get(fmt))


def list_encoders() -> List[Tuple[str, str]]:
    return [(e.format, e.id) for lst in _encoders.values() for e in lst]


def unregister_encoder(enc: Encoder) -> None:
    lst = _encoders.get(enc.format, [])
    if enc in lst:
        lst.remove(enc)
