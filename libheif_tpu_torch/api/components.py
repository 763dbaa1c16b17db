"""Component-description API (ref: api/libheif/heif_components.h,
39 fns over ImageDescription/ComponentDescription,
image_description.h:131,156); counterpart of
libheif_tpu/api/components.py.

A component's plane is a torch tensor on the image's device
(``heif_image_add_component`` allocates it there); the getters return
that tensor itself.  The twelve datatypes map to torch dtypes as the
JAX package's map to numpy's, so the C suffix ``complex32`` (two 32-bit
floats) is ``torch.complex64`` and ``complex64`` is ``torch.complex128``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .._build import resolve_device
from ..core.error import HeifError
from ..image.pixel_image import _SIGNED_VIEW
from ..image.image_description import (ImageDescription,
                                       ComponentDescription,
                                       ComponentType, ComponentDatatype)
from .image_handle import heif_image_handle

heif_image_description = ImageDescription
heif_component_description = ComponentDescription
heif_component_type = ComponentType
heif_channel_datatype = ComponentDatatype


# --------------------------------------------------------- construction

def heif_image_description_create() -> ImageDescription:
    return ImageDescription()


def heif_image_description_release(desc) -> None:
    pass


def heif_image_description_add_component(desc: ImageDescription,
                                         component_type: str,
                                         name: str = "",
                                         datatype: str = "unsigned",
                                         bit_depth: int = 8) -> int:
    cid = len(desc.components)
    desc.add(ComponentDescription(component_id=cid,
                                  component_type=component_type,
                                  name=name, datatype=datatype,
                                  bit_depth=bit_depth))
    return cid


def heif_image_description_get_number_of_components(
        desc: ImageDescription) -> int:
    return len(desc.components)


def heif_image_description_get_component(desc: ImageDescription,
                                         idx: int
                                         ) -> ComponentDescription:
    if not 0 <= idx < len(desc.components):
        raise HeifError.usage(msg=f"bad component index {idx}")
    return desc.components[idx]


# ---------------------------------------------------------- accessors

def heif_component_description_get_id(comp) -> int:
    return comp.component_id


def heif_component_description_get_type(comp) -> str:
    return comp.component_type


def heif_component_description_get_name(comp) -> str:
    return comp.name


def heif_component_description_get_datatype(comp) -> str:
    return comp.datatype


def heif_component_description_get_bit_depth(comp) -> int:
    return comp.bit_depth


def heif_component_description_get_channel(comp) -> Optional[str]:
    return comp.channel


# ------------------------------------------------------- image / handle

def heif_image_get_image_description(img) -> ImageDescription:
    """Description of a decoded image's channels (attached by the item
    layer, or derived from the channel list)."""
    desc = getattr(img, "image_description", None)
    if desc is not None:
        return desc
    return ImageDescription.for_image(img)


def heif_image_set_image_description(img, desc: ImageDescription) -> None:
    img.image_description = desc


def heif_image_handle_get_image_description(handle: heif_image_handle
                                            ) -> ImageDescription:
    item = handle.item
    f = getattr(item, "component_descriptions", None)
    if f is not None:
        got = f() if callable(f) else f
        if got:
            return got
    # derive from pixi/item structure
    desc = ImageDescription()
    from ..boxes.meta import Box_pixi
    pixi = handle.ctx.file.get_property(handle.item_id, Box_pixi)
    bits = pixi.bits_per_channel if pixi else []
    names = (["Y", "Cb", "Cr"] if len(bits) == 3 else
             ["monochrome"] if len(bits) == 1 else
             [f"c{i}" for i in range(len(bits))])
    for i, b in enumerate(bits):
        desc.add(ComponentDescription(component_id=i, name=names[i],
                                      component_type=names[i]
                                      if names[i] in ("Y", "Cb", "Cr",
                                                      "monochrome")
                                      else ComponentType.Custom,
                                      bit_depth=b))
    return desc


# ---------------------------------------------------------------------------
# Typed component plane access (ref: heif_components.h
# heif_image_add_component / heif_image_get_component_* family).
#
# The reference exposes one C accessor per dtype because C has no
# dtype-carrying array type; here a component IS a torch tensor, so the
# typed variants are dtype-checked getters of one store.
# ---------------------------------------------------------------------------

from dataclasses import dataclass as _dataclass, field as _field


@_dataclass
class _Component:
    """One extra image component (ref: image_description.h:112
    ImageComponent: id + datatype + plane)."""

    component_id: int
    component_type: str = ComponentType.Custom
    channel: Optional[str] = None
    array: object = None                  # torch tensor, dtype-carrying
    gimi_content_id: str = ""


def _components(img) -> dict:
    if not hasattr(img, "_components"):
        img._components = {}
    return img._components


# (datatype, bits) -> torch dtype (the JAX package's numpy dtypes)
_DTYPES = {("unsigned", 8): torch.uint8, ("unsigned", 16): torch.uint16,
           ("unsigned", 32): torch.uint32, ("unsigned", 64): torch.uint64,
           ("signed", 8): torch.int8, ("signed", 16): torch.int16,
           ("signed", 32): torch.int32, ("signed", 64): torch.int64,
           ("float", 32): torch.float32, ("float", 64): torch.float64,
           ("complex", 32): torch.complex64,
           ("complex", 64): torch.complex128}
_KINDS = {torch.uint8: ComponentDatatype.Unsigned,
          torch.uint16: ComponentDatatype.Unsigned,
          torch.uint32: ComponentDatatype.Unsigned,
          torch.uint64: ComponentDatatype.Unsigned,
          torch.int8: ComponentDatatype.Signed,
          torch.int16: ComponentDatatype.Signed,
          torch.int32: ComponentDatatype.Signed,
          torch.int64: ComponentDatatype.Signed,
          torch.float32: ComponentDatatype.Float,
          torch.float64: ComponentDatatype.Float,
          torch.complex64: ComponentDatatype.Complex,
          torch.complex128: ComponentDatatype.Complex}


def heif_image_add_component(img, component_id: int, component_type: str,
                             datatype: str, bit_depth: int, width: int,
                             height: int, device=None):
    """(ref: heif_components.h heif_image_add_component).  The zeroed
    plane lies on ``device``, else on the image's device (the one it
    records, else its planes'), else the card."""
    key = (datatype, bit_depth)
    if key not in _DTYPES:
        raise HeifError.usage(msg=f"unsupported datatype {key}")
    dtype = _DTYPES[key]
    if device is None:
        device = img.device if img.device is not None else next(
            (p.device for p in img.planes.values()), None)
    dev = resolve_device(device)
    # CUDA builds of torch lack most kernels of the wide unsigned types,
    # fill among them: their zeros are the signed type's, viewed
    alloc = _SIGNED_VIEW.get(dtype, dtype)
    arr = torch.zeros((height, width), dtype=alloc, device=dev).view(dtype)
    _components(img)[component_id] = _Component(component_id,
                                                component_type,
                                                array=arr)
    return arr


def heif_image_get_number_of_used_components(img) -> int:
    return len(_components(img))


def heif_image_get_used_component_ids(img) -> List[int]:
    return sorted(_components(img))


def _component(img, component_id: int) -> _Component:
    comps = _components(img)
    if component_id not in comps:
        raise HeifError.usage(msg=f"no component {component_id}")
    return comps[component_id]


def heif_image_get_component(img, component_id: int):
    """Generic accessor: the dtype-carrying plane array."""
    return _component(img, component_id).array


def heif_image_get_component_readonly(img, component_id: int):
    """The component's tensor itself (torch has no read-only tensors:
    the caller does not write through it)."""
    return _component(img, component_id).array


def heif_image_get_component_width(img, component_id: int) -> int:
    return _component(img, component_id).array.shape[1]


def heif_image_get_component_height(img, component_id: int) -> int:
    return _component(img, component_id).array.shape[0]


def heif_image_get_component_type(img, component_id: int) -> str:
    return _component(img, component_id).component_type


def heif_image_get_component_channel(img, component_id: int):
    return _component(img, component_id).channel


def heif_image_get_component_datatype(img, component_id: int) -> str:
    return _KINDS[_component(img, component_id).array.dtype]


def heif_image_get_component_bits_per_pixel(img, component_id: int) -> int:
    a = _component(img, component_id).array
    bits = a.element_size() * 8
    return bits // 2 if a.dtype.is_complex else bits


def heif_image_set_gimi_component_content_id(img, component_id: int,
                                             content_id: str) -> None:
    _component(img, component_id).gimi_content_id = content_id


def _typed_accessor(dtype, suffix):
    def get(img, component_id: int):
        a = _component(img, component_id).array
        if a.dtype != dtype:
            raise HeifError.usage(
                msg=f"component {component_id} is {a.dtype}, "
                    f"not {suffix}")
        return a

    def get_ro(img, component_id: int):
        return get(img, component_id)
    get.__name__ = f"heif_image_get_component_{suffix}"
    get_ro.__name__ = f"heif_image_get_component_{suffix}_readonly"
    return get, get_ro


for _dtype, _suffix in ((torch.uint8, "uint8"), (torch.uint16, "uint16"),
                        (torch.uint32, "uint32"), (torch.uint64, "uint64"),
                        (torch.int8, "int8"), (torch.int16, "int16"),
                        (torch.int32, "int32"), (torch.int64, "int64"),
                        (torch.float32, "float32"),
                        (torch.float64, "float64"),
                        (torch.complex64, "complex32"),
                        (torch.complex128, "complex64")):
    _g, _gro = _typed_accessor(_dtype, _suffix)
    globals()[_g.__name__] = _g
    globals()[_gro.__name__] = _gro
del _g, _gro


# handle-level views (description travels with the encoded item)

def heif_image_handle_get_number_of_components(handle) -> int:
    desc = heif_image_handle_get_image_description(handle)
    return len(desc.components) if desc else 0


def heif_image_handle_get_used_component_ids(handle) -> List[int]:
    desc = heif_image_handle_get_image_description(handle)
    return [c.component_id for c in desc.components] if desc else []


def _handle_component(handle, component_id: int):
    desc = heif_image_handle_get_image_description(handle)
    if desc:
        c = desc.find_by_id(component_id)
        if c is not None:
            return c
    raise HeifError.usage(msg=f"no component {component_id}")


def heif_image_handle_get_component_type(handle, component_id: int) -> str:
    return _handle_component(handle, component_id).component_type


def heif_image_handle_get_component_datatype(handle,
                                             component_id: int) -> str:
    return _handle_component(handle, component_id).datatype


def heif_image_handle_get_component_bits_per_pixel(
        handle, component_id: int) -> int:
    return _handle_component(handle, component_id).bit_depth
