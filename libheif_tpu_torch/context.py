"""HeifContext: the semantic image model over a parsed file.

Counterpart of libheif_tpu/context.py, read side only (reference:
libheif/context.{h,cc} — HeifContext context.h:65,
interpret_heif_file_images context.cc:584, decode orchestration
context.cc:1425).  A context lives on one device, ``None`` meaning CUDA
(which raises without a card; pass ``device="cpu"`` for the CPU): every
item decodes onto it and every decoded plane stays on it, through the
composition, the transforms and the output conversion.  A file is read
from a path, from bytes or through a streaming reader
(``read_from_reader``); the metadata, region and text items attached to
an image are host data.  An image sequence's tracks (``tracks``,
``get_track``, ``has_sequence``, JAX context.py:76-110) decode their
samples on the same device.  There is no encode or write API yet;
``HeifFile`` has the write side.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ._build import resolve_device
from .core.error import HeifError, ErrorCode, SubError
from .core.limits import SecurityLimits
from .file import HeifFile
from .boxes.meta import Box_auxC
from .image.pixel_image import PixelImage, Colorspace, Chroma
from .color import convert_image
from .color.ops import ColorConversionOptions
from .items import (
    ImageItem, ImageItem_Error, DecodingOptions, ImageTiling, alloc_item,
)
from .items.region_item import RegionItem
from .items.text_item import TextItem


class HeifContext:
    """Top-level engine object (mirrors heif_context)."""

    def __init__(self, limits: Optional[SecurityLimits] = None, device=None):
        self.device = resolve_device(device)
        self.limits = limits or SecurityLimits()
        self.file: Optional[HeifFile] = None
        self.items: Dict[int, ImageItem] = {}
        self.primary_id: Optional[int] = None
        self._tracks = None             # made at first use (``tracks``)
        self.max_decoding_threads = 4  # ref: context.h:72 (CPU grid tiles)

    # ================================================================ read

    @staticmethod
    def read_from_file(path: str, limits: Optional[SecurityLimits] = None,
                       device=None) -> "HeifContext":
        ctx = HeifContext(limits, device)
        ctx.file = HeifFile.from_file(path, ctx.limits)
        ctx._interpret()
        return ctx

    @staticmethod
    def read_from_bytes(data: bytes, limits: Optional[SecurityLimits] = None,
                        device=None) -> "HeifContext":
        ctx = HeifContext(limits, device)
        ctx.file = HeifFile.from_bytes(data, ctx.limits)
        ctx._interpret()
        return ctx

    @staticmethod
    def read_from_reader(reader, limits: Optional[SecurityLimits] = None,
                         device=None) -> "HeifContext":
        """Progressive open over a streaming reader (io/reader.py):
        structural boxes only; item and tile reads request exact byte
        ranges on demand (ref: heif_context_read_from_reader + heif_reader
        v2, heif_context.h:164-231)."""
        ctx = HeifContext(limits, device)
        ctx.file = HeifFile.from_reader(reader, ctx.limits)
        ctx._interpret()
        return ctx

    def _interpret(self) -> None:
        """Build the item graph (ref: interpret_heif_file context.cc:564)."""
        if self.file.mini is not None and self.file.meta is None:
            self._interpret_mini()
            return
        f = self.file
        for item_id in f.item_ids:
            infe = f.get_infe(item_id)
            try:
                item = alloc_item(self, item_id, infe.item_type)
            except HeifError as e:
                item = ImageItem_Error(self, item_id, infe.item_type, e)
            item.is_hidden = infe.hidden
            self.items[item_id] = item

        try:
            self.primary_id = f.primary_item_id
        except HeifError:
            self.primary_id = None
        if self.primary_id in self.items:
            self.items[self.primary_id].is_primary = True

        # --- link aux images via iref (ref: context.cc:800+)
        for item_id, item in self.items.items():
            # thumbnails: 'thmb' ref from thumbnail to master
            for ref in f.get_references_from(item_id, "thmb"):
                item.is_thumbnail = True
                for master_id in ref.to_item_ids:
                    m = self.items.get(master_id)
                    if m is not None:
                        m.thumbnails.append(item)
            # aux images: 'auxl' ref from aux item to master
            for ref in f.get_references_from(item_id, "auxl"):
                item.is_aux = True
                auxC = f.get_property(item_id, Box_auxC)
                for master_id in ref.to_item_ids:
                    m = self.items.get(master_id)
                    if m is None:
                        continue
                    if auxC is not None and auxC.is_alpha():
                        m.alpha_item = item
                        # premultiplied alpha: 'prem' ref master→alpha
                        for pref in f.get_references_from(master_id, "prem"):
                            if item_id in pref.to_item_ids:
                                m.premultiplied_alpha = True
                    elif auxC is not None and auxC.is_depth():
                        m.depth_item = item
                    else:
                        m.aux_items.append(item)
            # metadata: 'cdsc' ref from metadata item to image
            infe = f.get_infe(item_id)
            if infe.item_type in ("Exif", "mime", "uri "):
                for ref in f.get_references_from(item_id, "cdsc"):
                    for target in ref.to_item_ids:
                        m = self.items.get(target)
                        if m is None:
                            continue
                        m.metadata.append({
                            "item_id": item_id,
                            "item_type": infe.item_type,
                            "content_type": infe.content_type,
                            "item_uri_type": infe.item_uri_type,
                        })

    def _interpret_mini(self) -> None:
        """Make the items of a 'mini' file (ref: Box_mini::
        create_expanded_boxes mini.h:40 — the reference expands the box
        into real boxes; the items are made directly)."""
        from .items.mini_item import make_mini_items
        make_mini_items(self)

    # ============================================================ sequences

    @property
    def tracks(self):
        """The sequence tracks, decoding on the context's device (ref:
        heif_context_number_of_sequence_tracks /
        interpret_heif_file_sequences context.cc:2044)."""
        if self._tracks is None:
            from .sequences import interpret_tracks
            self._tracks = interpret_tracks(self.file, self.device) \
                if self.file is not None else []
        return self._tracks

    def get_track(self, track_id: int):
        """The track of ``track_id``, or None."""
        return next((t for t in self.tracks if t.track_id == track_id),
                    None)

    def has_sequence(self) -> bool:
        """(ref: heif_context_has_sequence)."""
        return len(self.tracks) > 0

    def sequence_timescale(self) -> int:
        """mvhd timescale; without one the writer's default, 90000, as
        the JAX package answers (ref: heif_context_get_sequence_timescale)."""
        mvhd = self._mvhd()
        return mvhd.timescale if mvhd is not None else 90000

    def sequence_duration(self) -> int:
        """mvhd duration in movie units
        (ref: heif_context_get_sequence_duration)."""
        mvhd = self._mvhd()
        return mvhd.duration if mvhd is not None else 0

    def _mvhd(self):
        moov = self.file.top_level_box("moov") if self.file else None
        return moov.get_child("mvhd") if moov is not None else None

    # ---------------------------------------------------------------- query

    def get_item(self, item_id: int) -> ImageItem:
        item = self.items.get(item_id)
        if item is None:
            raise HeifError.usage(SubError.Nonexisting_item_referenced,
                                  f"item {item_id} does not exist")
        return item

    @property
    def primary_item_id(self) -> int:
        if self.primary_id is None:
            raise HeifError(ErrorCode.Invalid_input,
                            SubError.No_or_invalid_primary_item)
        return self.primary_id

    def top_level_image_ids(self) -> List[int]:
        """(ref: heif_context_get_list_of_top_level_image_IDs)."""
        return [i for i, item in self.items.items()
                if item.is_image_item and not item.is_thumbnail
                and not item.is_aux and not item.is_hidden
                and item.item_type not in ("Exif", "mime", "uri ", "rgan",
                                           "txti")]

    def get_image_info(self, item_id: int) -> dict:
        item = self.get_item(item_id)
        w, h = item.width_height()
        return {
            "id": item_id,
            "type": item.item_type,
            "width": w,
            "height": h,
            "has_alpha": item.alpha_item is not None,
            "has_depth": item.depth_item is not None,
            "is_primary": item.is_primary,
            "thumbnails": [t.item_id for t in item.thumbnails],
            "luma_bits_per_pixel": item.luma_bits_per_pixel(),
        }

    # ---------------------------------------------------------------- decode

    def decode_image(self, item_id: Optional[int] = None,
                     colorspace: str = Colorspace.Undefined,
                     chroma: str = Chroma.Undefined,
                     options: Optional[DecodingOptions] = None) -> PixelImage:
        """(ref: HeifContext::decode_image context.cc:1425 +
        convert_to_output_colorspace context.cc:1515)."""
        if item_id is None:
            item_id = self.primary_item_id
        item = self.get_item(item_id)
        img = item.decode_image(options)
        return self._convert_output(img, colorspace, chroma, options)

    def decode_tile(self, item_id: int, tile_x: int, tile_y: int,
                    colorspace: str = Colorspace.Undefined,
                    chroma: str = Chroma.Undefined,
                    options: Optional[DecodingOptions] = None) -> PixelImage:
        """(ref: heif_image_handle_decode_image_tile heif_tiling.h:86)."""
        item = self.get_item(item_id)
        img = item.decode_tile(tile_x, tile_y, options)
        return self._convert_output(img, colorspace, chroma, options)

    def _convert_output(self, img, colorspace, chroma, options):
        opts = options or DecodingOptions()
        target_bits = 8 if opts.convert_hdr_to_8bit else 0
        conv = opts.color_conversion_options
        flatten = (conv is not None and conv.alpha_composition_mode !=
                   ColorConversionOptions.ALPHA_NONE and img.has_alpha())
        needs = ((colorspace != Colorspace.Undefined and
                  img.colorspace != colorspace) or
                 (chroma != Chroma.Undefined and img.chroma != chroma) or
                 flatten or
                 (target_bits and any(img.bit_depth(c) != 8
                                      for c in img.channels())))
        if needs:
            if flatten and colorspace == Colorspace.Undefined:
                colorspace = img.colorspace
            if flatten and chroma == Chroma.Undefined:
                chroma = img.chroma
            img = convert_image(img, colorspace, chroma,
                                target_has_alpha=False if flatten else None,
                                target_bits=target_bits,
                                options=conv, device=self.device)
        return img

    def get_image_tiling(self, item_id: int) -> ImageTiling:
        return self.get_item(item_id).get_tiling()

    # -------------------------------------------------------------- metadata

    def get_metadata_blocks(self, item_id: int,
                            type_filter: str = "") -> List[dict]:
        """The metadata items linked to an image by 'cdsc' (and a mini
        file's inline Exif/XMP), each with its ``data`` as bytes."""
        item = self.get_item(item_id)
        out = []
        for md in item.metadata:
            if type_filter and md["item_type"] != type_filter:
                continue
            entry = dict(md)
            if "data" not in entry:  # mini items carry data inline
                entry["data"] = bytes(self.file.get_item_data(md["item_id"]))
            out.append(entry)
        return out

    def get_exif(self, item_id: int) -> Optional[bytes]:
        """Exif payload with the 4-byte TIFF-offset header stripped
        (ref: heif_metadata.h exif access)."""
        for md in self.get_metadata_blocks(item_id, "Exif"):
            data = md["data"]
            if len(data) >= 4:
                offset = int.from_bytes(data[:4], "big")
                if 4 + offset <= len(data):
                    return data[4 + offset:]
            return data
        return None

    def get_xmp(self, item_id: int) -> Optional[bytes]:
        for md in self.get_metadata_blocks(item_id, "mime"):
            if md.get("content_type") in ("application/rdf+xml",):
                return md["data"]
        return None

    def get_region_items(self, image_id: int) -> List[RegionItem]:
        """Region annotations attached to an image via 'cdsc'; a
        referenced mask geometry takes the next id of the region item's
        'mask' references (ref: heif_image_handle_get_list_of_region_
        item_ids)."""
        out = []
        for ref in self.file.get_references_to(image_id, "cdsc"):
            rid = ref.from_item_id
            if self.file.get_infe(rid).item_type == "rgan":
                ri = RegionItem.parse(rid, self.file.get_item_data(rid))
                mask_ids = []
                for mref in self.file.get_references_from(rid, "mask"):
                    mask_ids.extend(mref.to_item_ids)
                for g in ri.regions:
                    if g.kind == "referenced_mask" and mask_ids:
                        g.mask_item_id = mask_ids.pop(0)
                out.append(ri)
        return out

    def get_text_items(self, image_id: int) -> List[TextItem]:
        """Text annotations attached via 'cdsc' (ref: text.h:31)."""
        out = []
        for ref in self.file.get_references_to(image_id, "cdsc"):
            tid = ref.from_item_id
            if self.file.get_infe(tid).item_type == "txti":
                out.append(TextItem.parse(tid, self.file.get_item_data(tid)))
        return out
