"""Plugin API (ref: api/libheif/heif_plugin.h — decoder/encoder plugin
ABI heif_plugin.h:85,192); counterpart of libheif_tpu/api/plugin.py.

A plugin is a registry entry of the port's codec registry
(libheif_tpu_torch.codecs.registry): a decoder object with
decode_single_image() and an encoder object with encode_single_image(),
registered by priority (ref: plugin_registry.cc:115-230).  A plugin
decoder's image may hold its planes anywhere (torch tensors on any
device, or numpy arrays): the items that decode through it get them on
the context's device (registry.decoder_for).
"""

from __future__ import annotations

from ..codecs.registry import (Decoder, Encoder, register_decoder,
                               register_encoder, get_decoder,
                               get_encoder, list_decoders, list_encoders)

heif_decoder_plugin = Decoder
heif_encoder_plugin = Encoder


def heif_register_decoder_plugin(plugin: Decoder) -> None:
    register_decoder(plugin)


def heif_register_encoder_plugin(plugin: Encoder) -> None:
    register_encoder(plugin)
