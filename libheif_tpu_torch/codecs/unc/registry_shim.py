"""Registry shims exposing the built-in unci / mask codecs through the
codec registry; a copy of libheif_tpu/codecs/unc/registry_shim.py
(ref: libheif/plugins/decoder_uncompressed.cc,
encoder_uncompressed.cc:370, encoder_mask.cc — the reference likewise
publishes its built-in codec via the plugin ABI).

Encoding for these formats is context-managed (the item layer builds
cmpd/uncC properties and appends tile data, unc_image.cc:312), so the
registry objects carry discovery metadata + parameters; the context
dispatches by format string.
"""

from __future__ import annotations

from ..registry import Encoder, register_encoder


class UnciRegistryEncoder(Encoder):
    id = "tpu-unci"
    format = "unci"
    lossy_supported = False
    lossless_supported = True
    context_managed = True  # HeifContext.encode_image handles this fmt

    def parameters(self):
        return [
            {"name": "tile-cols", "type": "integer", "default": 1,
             "minimum": 1, "maximum": 4096,
             "have_minimum_maximum": True},
            {"name": "tile-rows", "type": "integer", "default": 1,
             "minimum": 1, "maximum": 4096,
             "have_minimum_maximum": True},
            {"name": "compression", "type": "string", "default": "none",
             "valid_values": ["none", "zlib", "defl", "brot"]},
        ]


class MaskRegistryEncoder(Encoder):
    id = "tpu-mask"
    format = "mski"
    lossy_supported = False
    lossless_supported = True
    context_managed = True

    def parameters(self):
        return []


def register():
    register_encoder(UnciRegistryEncoder())
    register_encoder(MaskRegistryEncoder())
