"""Codec registry: the port's stand-in for the plugin system.

Counterpart of libheif_tpu/codecs/registry.py (``Decoder`` :19,
``Encoder`` :38, ``register_decoder``, ``register_encoder``,
``get_decoder``, ``get_encoder``, ``have_decoder``, ``have_encoder``,
``list_decoders``, ``list_encoders``, ``unregister_decoder``,
``unregister_encoder``, ``snapshot``; reference:
libheif/plugin_registry.{h,cc}, priority-ordered decoder and encoder
sets plugin_registry.cc:115-128, plugin ABI heif_plugin.h:85,192).
Codecs register with a priority;
lookup returns the highest-priority codec for a compression format,
optionally pinned by id (``heif_decoding_options.decoder_id``).

``HeifContext.encode_image`` reaches every format but ``unci`` and
``mski`` through the encoders.  Each codec package registers its
built-in decoder when it is imported (``BuiltinDecoder``: the JAX id and
format, and the port's decoder class, made on the device of the item or
track that decodes); items, ``tili`` tiles, ``mini`` images and tracks
find their decoder through :func:`decoder_for`.  A decoder registered
from outside the port (a plugin: ``api/library.heif_load_plugin`` of a
``.py`` module or a ``.so`` of ``bindings/c/heif_tpu_plugin.h``) serves
the same lookups: :func:`decoder_for` wraps it so that every plane of
the image it returns reaches the caller on the item's device, one
host-to-device copy a plane.  The batched grid paths run the built-in
codecs only (:func:`selects_builtin`); a grid whose format a plugin took
over decodes tile by tile through the plugin, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .._build import resolve_device
from ..core.error import HeifError, SubError
from .host_copy import device_planes


class Decoder:
    """Decoder interface (ref: heif_decoder_plugin heif_plugin.h:85)."""

    id: str = "unknown"
    format: str = "unknown"
    priority: int = 100

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None):
        raise NotImplementedError

    # sequence push/flush/pull API (ref: decoder.h:132-149)
    def push_sequence_data(self, data: bytes) -> None:
        raise NotImplementedError

    def pull_next_frame(self):
        raise NotImplementedError


class BuiltinDecoder(Decoder):
    """The registry entry of one of the port's decoders: ``decoder_cls``
    (HevcDecoder, Av1Decoder, ...) takes the device it decodes on."""

    def __init__(self, id: str, format: str, decoder_cls,
                 priority: int = 100):
        self.id = id
        self.format = format
        self.decoder_cls = decoder_cls
        self.priority = priority

    def on_device(self, device):
        """The decoder, reconstructing on ``device``."""
        return self.decoder_cls(device)


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


_decoders: Dict[str, List[Decoder]] = {}
_encoders: Dict[str, List[Encoder]] = {}


def register_decoder(dec: Decoder) -> None:
    lst = _decoders.setdefault(dec.format, [])
    lst.append(dec)
    lst.sort(key=lambda d: -d.priority)


def register_encoder(enc: Encoder) -> None:
    lst = _encoders.setdefault(enc.format, [])
    lst.append(enc)
    lst.sort(key=lambda e: -e.priority)


def get_decoder(fmt: str,
                decoder_id: Optional[str] = None) -> Optional[Decoder]:
    for d in _decoders.get(fmt, []):
        if decoder_id is None or d.id == decoder_id:
            return d
    return None


def get_encoder(fmt: str,
                encoder_id: Optional[str] = None) -> Optional[Encoder]:
    for e in _encoders.get(fmt, []):
        if encoder_id is None or e.id == encoder_id:
            return e
    return None


def have_decoder(fmt: str) -> bool:
    return bool(_decoders.get(fmt))


def have_encoder(fmt: str) -> bool:
    return bool(_encoders.get(fmt))


def list_decoders() -> List[Tuple[str, str]]:
    return [(d.format, d.id) for lst in _decoders.values() for d in lst]


def list_encoders() -> List[Tuple[str, str]]:
    return [(e.format, e.id) for lst in _encoders.values() for e in lst]


def unregister_decoder(dec: Decoder) -> None:
    """Remove a previously registered decoder (plugin unload path)."""
    lst = _decoders.get(dec.format, [])
    if dec in lst:
        lst.remove(dec)


def unregister_encoder(enc: Encoder) -> None:
    lst = _encoders.get(enc.format, [])
    if enc in lst:
        lst.remove(enc)


def snapshot() -> Tuple[List[Decoder], List[Encoder]]:
    """Flat snapshot of all registered codecs, used by the plugin
    loader to diff what a plugin registered."""
    return ([d for lst in _decoders.values() for d in lst],
            [e for lst in _encoders.values() for e in lst])


class PluginOnDevice:
    """A plugin's decoder as :func:`decoder_for` hands it out: its
    ``decode_single_image`` result with every plane on ``device`` (a
    tensor elsewhere moved by one ``.to(device)``, numpy planes by one
    ``host_copy.device_planes`` transfer; a plane on ``device`` already
    is not copied)."""

    def __init__(self, plugin: Decoder, device):
        self.plugin = plugin
        self.device = device

    def decode_single_image(self, config_box, data: bytes,
                            declared_size=None, limits=None):
        img = self.plugin.decode_single_image(
            config_box, data, declared_size=declared_size, limits=limits)
        host = [ch for ch, p in img.planes.items()
                if isinstance(p, np.ndarray)]
        if host:
            for ch, t in zip(host, device_planes(
                    [img.planes[ch] for ch in host], self.device)):
                img.planes[ch] = t
        for ch, p in img.planes.items():
            img.planes[ch] = p.to(self.device)   # no copy where it lies
        img.device = self.device
        return img


def selects_builtin(fmt: str, decoder_id: Optional[str] = None) -> bool:
    """Whether a lookup of (``fmt``, ``decoder_id``) finds a built-in
    decoder: the batched grid paths run the built-in codecs only."""
    return isinstance(get_decoder(fmt, decoder_id), BuiltinDecoder)


def decoder_for(fmt: str, decoder_id: Optional[str], device,
                missing: str = ""):
    """The decoder a lookup of (``fmt``, ``decoder_id``) selects, made on
    ``device`` (None: CUDA).  None found raises ``Unsupported_codec`` (the
    JAX package's error where ``get_decoder`` returns None, with
    ``missing`` as its message); a decoder registered from outside the
    port comes wrapped in :class:`PluginOnDevice`."""
    dec = get_decoder(fmt, decoder_id)
    if dec is None:
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            missing or f"no decoder available for {fmt}")
    if not isinstance(dec, BuiltinDecoder):
        return PluginOnDevice(dec, resolve_device(device))
    return dec.on_device(device)
