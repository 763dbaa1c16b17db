"""Encoding API (ref: api/libheif/heif_encoding.h, 45 fns).

Encoder discovery, typed parameter introspection (ref:
heif_encoding.h:154+), quality/lossless knobs, and the encode entry
points over HeifContext.encode_image; counterpart of
libheif_tpu/api/encoding.py.  The encoders are the port's registry's:
they read the image's planes on its device (a JPEG encode launches
``jpeg_fdct_quant`` there), and a thumbnail is scaled on that device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..codecs import registry
from ..core.error import HeifError, SubError
from .types import EncodingOptions
from .image_handle import heif_image_handle

heif_encoding_options = EncodingOptions


class heif_encoder:
    """Opaque encoder wrapper: a registry encoder + pending parameter
    values (ref: api_structs.h heif_encoder)."""

    def __init__(self, reg_encoder):
        self.impl = reg_encoder
        self.values = {"quality": 50, "lossless": False}

    def __repr__(self):
        return f"heif_encoder({self.impl.format}/{self.impl.id})"


# ------------------------------------------------------------- discovery

def heif_get_encoder_descriptors(compression_format: Optional[str] = None,
                                 name_filter: Optional[str] = None
                                 ) -> List[Tuple[str, str]]:
    out = registry.list_encoders()
    if compression_format is not None:
        out = [e for e in out if e[0] == compression_format]
    if name_filter:
        out = [e for e in out if name_filter in e[1]]
    return out


def heif_encoder_descriptor_get_name(descriptor) -> str:
    return f"{descriptor[1]} ({descriptor[0]})"


def heif_encoder_descriptor_get_id_name(descriptor) -> str:
    return descriptor[1]


def heif_encoder_descriptor_get_compression_format(descriptor) -> str:
    return descriptor[0]


def heif_encoder_descriptor_supports_lossy_compression(descriptor) -> bool:
    e = registry.get_encoder(descriptor[0], descriptor[1])
    return bool(e and e.lossy_supported)


def heif_encoder_descriptor_supports_lossless_compression(descriptor
                                                          ) -> bool:
    e = registry.get_encoder(descriptor[0], descriptor[1])
    return bool(e and e.lossless_supported)


def heif_have_encoder_for_format(compression_format: str) -> bool:
    return registry.have_encoder(compression_format)


def heif_context_get_encoder_for_format(ctx, compression_format: str
                                        ) -> heif_encoder:
    e = registry.get_encoder(compression_format)
    if e is None:
        raise HeifError.unsupported(
            SubError.Unsupported_codec,
            f"no encoder for format {compression_format}")
    return heif_encoder(e)


def heif_context_get_encoder(ctx, descriptor) -> heif_encoder:
    e = registry.get_encoder(descriptor[0], descriptor[1])
    if e is None:
        raise HeifError.unsupported(SubError.Unsupported_codec,
                                    f"no encoder {descriptor}")
    return heif_encoder(e)


def heif_encoder_release(encoder) -> None:
    pass


def heif_encoder_get_name(encoder: heif_encoder) -> str:
    return encoder.impl.id


# ------------------------------------------------------------- parameters

def heif_encoder_set_lossy_quality(encoder: heif_encoder,
                                   quality: int) -> None:
    if not 0 <= quality <= 100:
        raise HeifError.usage(msg="quality must be 0..100")
    encoder.values["quality"] = quality


def heif_encoder_set_lossless(encoder: heif_encoder,
                              enable: bool) -> None:
    encoder.values["lossless"] = bool(enable)


def heif_encoder_set_logging_level(encoder: heif_encoder,
                                   level: int) -> None:
    encoder.values["logging"] = level


@dataclass(frozen=True)
class HeifEncoderParameter:
    """Typed encoder parameter descriptor with validated ranges and
    string sets (ref: heif_encoder_parameter heif_encoding.h:154+,
    plugin side heif_plugin.h:232+).  Field access is attribute-style;
    dict-style access is kept for source compatibility."""

    name: str
    type: str                       # "integer" | "boolean" | "string"
    default: object = None
    minimum: Optional[int] = None
    maximum: Optional[int] = None
    have_minimum_maximum: bool = False
    valid_values: Optional[tuple] = None

    def __getitem__(self, key):
        v = getattr(self, key)
        if v is None:
            raise KeyError(key)
        return v

    def get(self, key, default=None):
        v = getattr(self, key, None)
        return default if v is None else v

    def __contains__(self, key):
        return getattr(self, key, None) is not None

    def validate(self, value) -> None:
        if self.type == "integer":
            if not isinstance(value, int):
                raise HeifError.usage(msg=f"{self.name} expects integer")
            if self.have_minimum_maximum and not \
                    (self.minimum <= value <= self.maximum):
                raise HeifError.usage(
                    msg=f"{self.name} out of range "
                        f"[{self.minimum}, {self.maximum}]")
            if self.valid_values and value not in self.valid_values:
                raise HeifError.usage(
                    msg=f"{self.name}: {value} not in valid set")
        elif self.type == "string":
            if self.valid_values and value not in self.valid_values:
                raise HeifError.usage(
                    msg=f"invalid value {value!r} for {self.name}")


def _as_param(p) -> "HeifEncoderParameter":
    if isinstance(p, HeifEncoderParameter):
        return p
    return HeifEncoderParameter(
        name=p["name"], type=p["type"], default=p.get("default"),
        minimum=p.get("minimum"), maximum=p.get("maximum"),
        have_minimum_maximum=bool(p.get("have_minimum_maximum")),
        valid_values=(tuple(p["valid_values"])
                      if p.get("valid_values") else None))


_BASE_PARAMS = (
    HeifEncoderParameter(name="quality", type="integer", default=50,
                         minimum=0, maximum=100,
                         have_minimum_maximum=True),
    HeifEncoderParameter(name="lossless", type="boolean", default=False),
)


def heif_encoder_list_parameters(encoder: heif_encoder
                                 ) -> List[HeifEncoderParameter]:
    """Typed parameter descriptors (ref: heif_encoding.h:154+,
    heif_plugin.h:232+)."""
    return list(_BASE_PARAMS) + [_as_param(p)
                                 for p in encoder.impl.parameters()]


def heif_encoder_parameter_get_name(param) -> str:
    return param.name if isinstance(param, HeifEncoderParameter) \
        else param["name"]


def heif_encoder_parameter_get_type(param) -> str:
    return param.type if isinstance(param, HeifEncoderParameter) \
        else param["type"]


def _param_desc(encoder, name):
    for p in heif_encoder_list_parameters(encoder):
        if p["name"] == name:
            return p
    raise HeifError.usage(msg=f"unknown parameter {name}")


def heif_encoder_set_parameter_integer(encoder, name: str,
                                       value: int) -> None:
    d = _param_desc(encoder, name)
    d.validate(int(value))
    encoder.values[name] = int(value)


def heif_encoder_get_parameter_integer(encoder, name: str) -> int:
    d = _param_desc(encoder, name)
    return int(encoder.values.get(name, d.get("default", 0)))


def heif_encoder_parameter_integer_valid_range(encoder, name: str
                                               ) -> Tuple[int, int]:
    d = _param_desc(encoder, name)
    return d.get("minimum", 0), d.get("maximum", 0)


def heif_encoder_set_parameter_boolean(encoder, name: str,
                                       value: bool) -> None:
    _param_desc(encoder, name)
    encoder.values[name] = bool(value)


def heif_encoder_get_parameter_boolean(encoder, name: str) -> bool:
    d = _param_desc(encoder, name)
    return bool(encoder.values.get(name, d.get("default", False)))


def heif_encoder_set_parameter_string(encoder, name: str,
                                      value: str) -> None:
    d = _param_desc(encoder, name)
    d.validate(str(value))
    encoder.values[name] = value


def heif_encoder_get_parameter_string(encoder, name: str) -> str:
    d = _param_desc(encoder, name)
    return str(encoder.values.get(name, d.get("default", "")))


def heif_encoder_parameter_string_valid_values(encoder, name: str
                                               ) -> List[str]:
    return list(_param_desc(encoder, name).get("valid_values", []))


def heif_encoder_parameter_integer_valid_values(encoder, name: str
                                                ) -> List[int]:
    return list(_param_desc(encoder, name).get("valid_values", []))


def heif_encoder_set_parameter(encoder, name: str, value: str) -> None:
    """String-form generic setter (ref: heif_encoder_set_parameter)."""
    d = _param_desc(encoder, name)
    t = d["type"]
    if t == "integer":
        heif_encoder_set_parameter_integer(encoder, name, int(value))
    elif t == "boolean":
        heif_encoder_set_parameter_boolean(
            encoder, name, value.lower() in ("1", "true", "on", "yes"))
    else:
        heif_encoder_set_parameter_string(encoder, name, value)


def heif_encoder_get_parameter(encoder, name: str) -> str:
    return str(encoder.values.get(name,
                                  _param_desc(encoder, name).get(
                                      "default", "")))


def heif_encoder_has_default(encoder, name: str) -> bool:
    return "default" in _param_desc(encoder, name)


# ------------------------------------------------------------- encoding

def _options_from_encoder(encoder: heif_encoder,
                          options: Optional[EncodingOptions]
                          ) -> EncodingOptions:
    o = options or EncodingOptions()
    o.quality = encoder.values.get("quality", o.quality)
    o.lossless = encoder.values.get("lossless", o.lossless)
    return o


def heif_encoding_options_alloc() -> EncodingOptions:
    return EncodingOptions()


def heif_encoding_options_free(options) -> None:
    pass


def heif_context_encode_image(ctx, image, encoder: heif_encoder,
                              options: Optional[EncodingOptions] = None
                              ) -> heif_image_handle:
    """(ref: heif_encoding.cc → HeifContext::encode_image
    context.cc:1600)."""
    o = _options_from_encoder(encoder, options)
    item_id = ctx.encode_image(image, encoder.impl.format, o)
    return heif_image_handle(ctx, item_id)


def heif_context_encode_thumbnail(ctx, image, master_handle,
                                  encoder: heif_encoder,
                                  options=None,
                                  bbox_size: int = 256
                                  ) -> Optional[heif_image_handle]:
    """Encode `image` scaled into bbox_size as a thumbnail of master
    (ref: heif_context_encode_thumbnail)."""
    w, h = image.width, image.height
    if max(w, h) > bbox_size:
        if w > h:
            nw, nh = bbox_size, max(1, h * bbox_size // w)
        else:
            nw, nh = max(1, w * bbox_size // h), bbox_size
        image = image.scale_nearest(nw, nh)
    elif max(w, h) <= bbox_size and (w, h) == (image.width, image.height):
        # reference skips thumbnails not smaller than the master
        master = master_handle.item
        mw, mh = master.width_height()
        if w >= mw and h >= mh:
            return None
    tid = ctx.add_thumbnail(master_handle.item_id, image,
                            fmt=encoder.impl.format,
                            options=_options_from_encoder(encoder,
                                                          options))
    return heif_image_handle(ctx, tid)


def heif_context_assign_thumbnail(ctx, master_handle,
                                  thumbnail_handle) -> None:
    """Link an already-encoded item as thumbnail of master (ref:
    heif_context_assign_thumbnail)."""
    ctx.file.add_reference("thmb", thumbnail_handle.item_id,
                           [master_handle.item_id])
    ctx.get_item(thumbnail_handle.item_id).is_thumbnail = True
    ctx.get_item(master_handle.item_id).thumbnails.append(
        ctx.get_item(thumbnail_handle.item_id))


def heif_context_get_encoder_descriptors(ctx,
                                         compression_format=None,
                                         name_filter=None,
                                         count: int = 0xFFFF):
    """Per-context listing collapses to the global registry
    (ref: heif_encoding.h heif_context_get_encoder_descriptors)."""
    return heif_get_encoder_descriptors(compression_format,
                                        name_filter)[:count]


def heif_encoder_descriptor_supportes_lossy_compression(descriptor
                                                        ) -> bool:
    """Deprecated typo-name alias kept for ABI parity."""
    return heif_encoder_descriptor_supports_lossy_compression(descriptor)


def heif_encoder_descriptor_supportes_lossless_compression(descriptor
                                                           ) -> bool:
    """Deprecated typo-name alias kept for ABI parity."""
    return heif_encoder_descriptor_supports_lossless_compression(
        descriptor)


def heif_encoder_parameter_get_valid_integer_range(param):
    """(have_min, min, have_max, max) from a parameter descriptor
    (ref: heif_encoding.h:154+ introspection)."""
    d = param if isinstance(param, dict) else getattr(param, "desc", {})
    return ("minimum" in d, d.get("minimum", 0),
            "maximum" in d, d.get("maximum", 0))


def heif_encoder_parameter_get_valid_integer_values(param):
    d = param if isinstance(param, dict) else getattr(param, "desc", {})
    vals = d.get("valid_values")
    return list(vals) if vals else None


def heif_encoder_parameter_get_valid_string_values(param):
    d = param if isinstance(param, dict) else getattr(param, "desc", {})
    vals = d.get("valid_values")
    return [str(v) for v in vals] if vals else None


def heif_encoding_options_copy(options: EncodingOptions
                               ) -> EncodingOptions:
    """Deep copy of the versioned options struct
    (ref: heif_encoding.h heif_encoding_options_copy)."""
    import copy
    return copy.deepcopy(options)


# EXIF-style orientation composition table: result of applying
# `second` after `first` (ref: heif_encoding.h:278).  Orientations are
# the heif_orientation values 1..8.
_ORIENT_OPS = {
    1: (0, False), 2: (0, True), 3: (2, False), 4: (2, True),
    5: (1, True), 6: (1, False), 7: (3, True), 8: (3, False),
}
_OPS_ORIENT = {v: k for k, v in _ORIENT_OPS.items()}


def heif_orientation_concat(first: int, second: int) -> int:
    """Combine two orientations: rotations in quarter turns CW plus an
    optional horizontal mirror, composed second-after-first."""
    r1, m1 = _ORIENT_OPS[first]
    r2, m2 = _ORIENT_OPS[second]
    # applying a mirror flips the sense of subsequent rotations
    r = (r1 + (-r2 if m1 else r2)) % 4
    return _OPS_ORIENT[(r, m1 != m2)]


def heif_context_set_unif(ctx, flag: int) -> None:
    """Prefer 'unif'-style brand signaling on write (experimental
    reference toggle, heif_encoding.h:395); recorded on the context."""
    ctx.write_unif = bool(flag)


def heif_context_add_overlay_image(ctx, image_width: int,
                                   image_height: int, image_ids,
                                   offsets=None, background_rgba=None):
    """(ref: heif_encoding.h:359) → handle of the new iovl item."""
    from .image_handle import heif_image_handle
    item_id = ctx.add_overlay_image(image_width, image_height,
                                    list(image_ids), offsets,
                                    background_rgba)
    return heif_image_handle(ctx, item_id)
