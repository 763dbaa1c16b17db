"""Canonical image/component descriptions (ref: libheif/image/
image_description.{h,cc} — ImageDescription image_description.h:156,
ComponentDescription :131); counterpart of
libheif_tpu/image/image_description.py.

A shared, codec-independent description of what each stored channel
means (color component, alpha, depth, filter-array position, custom
scientific bands …), carried between items and decoded images so
multi-band / non-photographic content survives round-trips.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


# well-known component ids (ref: heif_components.h:48 datatypes and the
# ISO 23001-17 cmpd component types the item layer maps onto these)
class ComponentType:
    Monochrome = "monochrome"
    Y = "Y"
    Cb = "Cb"
    Cr = "Cr"
    R = "R"
    G = "G"
    B = "B"
    Alpha = "alpha"
    Depth = "depth"
    Disparity = "disparity"
    Palette = "palette"
    FilterArray = "filter_array"
    Padded = "padded"
    Custom = "custom"


class ComponentDatatype:
    """(ref: heif_components.h:48 heif_channel_datatype)."""

    Unsigned = "unsigned"
    Signed = "signed"
    Float = "float"
    Complex = "complex"


@dataclass
class ComponentDescription:
    """(ref: ComponentDescription image_description.h:131)."""

    component_id: int = 0
    component_type: str = ComponentType.Custom
    name: str = ""
    datatype: str = ComponentDatatype.Unsigned
    bit_depth: int = 8
    # which PixelImage channel stores this component
    channel: Optional[str] = None


@dataclass
class ImageDescription:
    """(ref: ImageDescription image_description.h:156)."""

    components: List[ComponentDescription] = field(default_factory=list)

    def add(self, comp: ComponentDescription) -> None:
        self.components.append(comp)

    def find_by_type(self, component_type: str
                     ) -> Optional[ComponentDescription]:
        for c in self.components:
            if c.component_type == component_type:
                return c
        return None

    def find_by_id(self, component_id: int
                   ) -> Optional[ComponentDescription]:
        for c in self.components:
            if c.component_id == component_id:
                return c
        return None

    @staticmethod
    def for_image(img) -> "ImageDescription":
        """Derive a description from a PixelImage's channels (the
        default the context attaches when an item carries none; ref:
        populate_component_descriptions context.cc:602-631).  Reads the
        planes' recorded bit depths and datatypes, not their samples."""
        from .pixel_image import Channel
        desc = ImageDescription()
        mapping = {
            Channel.Y: ComponentType.Y,
            Channel.Cb: ComponentType.Cb,
            Channel.Cr: ComponentType.Cr,
            Channel.R: ComponentType.R,
            Channel.G: ComponentType.G,
            Channel.B: ComponentType.B,
            Channel.Alpha: ComponentType.Alpha,
        }
        for i, ch in enumerate(img.channels()):
            info = img.plane_info.get(ch)
            desc.add(ComponentDescription(
                component_id=i,
                component_type=mapping.get(ch, ComponentType.Custom),
                name=str(ch),
                datatype=getattr(info, "datatype",
                                 ComponentDatatype.Unsigned)
                if info else ComponentDatatype.Unsigned,
                bit_depth=img.bit_depth(ch),
                channel=ch))
        return desc
