"""HeifContext: the semantic image model over a parsed file.

Counterpart of libheif_tpu/context.py (reference: libheif/context.{h,cc}
— HeifContext context.h:65, interpret_heif_file_images context.cc:584,
decode orchestration context.cc:1425, encode_image context.cc:1600).  A
context lives on one device, ``None`` meaning CUDA (which raises without
a card; pass ``device="cpu"`` for the CPU): every item decodes onto it and
every decoded plane stays on it, through the composition, the transforms
and the output conversion.  A file is read from a path, from bytes or
through a streaming reader (``read_from_reader``); the metadata, region
and text items attached to an image are host data.  An image sequence's
tracks (``tracks``, ``get_track``, ``has_sequence``, JAX
context.py:76-110) decode their samples on the same device.

The write side makes still-image files: ``new_file``, ``encode_image``
for ``unci``, ``mski`` and the registered encoders (``jpeg``; HEVC and AV1
have none yet and raise ``Unsupported_codec``), each image's alpha as a
hidden aux item, ``set_primary_item``, ``write`` and ``write_to_file``
(JAX context.py:400-552, :738-805).  An encode runs on the context's
device: planes that lie elsewhere are copied there first.  The JAX
writers of tracks, region and text items, thumbnails and metadata items
are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ._build import resolve_device
from .brands import compute_brands
from .core.error import HeifError, ErrorCode, SubError
from .core.limits import SecurityLimits
from .file import HeifFile
from .boxes.meta import Box_auxC, Box_colr, Box_ispe, Box_pixi
from .boxes.unc import Box_cpat, CmpdComponent
from .codecs import registry
from .codecs.unc import UnciEncoder
from .codecs.unc.codec import pack_samples
from .image.pixel_image import PixelImage, Channel, Colorspace, Chroma
from .color import convert_image
from .color.ops import ColorConversionOptions
from .items import (
    ImageItem, ImageItem_Error, DecodingOptions, ImageTiling, alloc_item,
)
from .items.mask_item import Box_mskC
from .items.region_item import RegionItem
from .items.text_item import TextItem
from .option_types import EncodingOptions


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

    # ================================================================ encode

    def new_file(self, major_brand: str = "mif1") -> None:
        self.file = HeifFile(self.limits)
        self.file.init_for_writing(major_brand, ["mif1", "heic", "miaf"])

    def encode_image(self, img: PixelImage, fmt: str = "unci",
                     options: Optional[EncodingOptions] = None) -> int:
        """Encode an image as a new item on the context's device; returns
        the item id (ref: HeifContext::encode_image context.cc:1600)."""
        options = options or EncodingOptions()
        if self.file is None:
            self.new_file()
        img = self._on_device(img)

        if fmt == "unci":
            item_id = self._encode_unci(img, options)
        elif fmt == "mski":
            item_id = self._encode_mask(img, options)
        else:
            enc = registry.get_encoder(fmt)
            if enc is None:
                raise HeifError.unsupported(
                    SubError.Unsupported_codec,
                    f"no encoder available for format {fmt!r}")
            item_id = self._encode_coded(img, enc, fmt, options)

        # alpha channel → separate aux item (ref: context.cc:1669-1708)
        if img.has_channel(Channel.Alpha) and options.save_alpha_channel and \
                fmt != "mski":
            alpha_id = self._encode_alpha_aux(img, fmt, options)
            self.file.add_reference("auxl", alpha_id, [item_id])
            self.file.get_infe(alpha_id).hidden = True
            if img.premultiplied_alpha:
                self.file.add_reference("prem", item_id, [alpha_id])

        if self.primary_id is None:
            self.set_primary_item(item_id)
        return item_id

    def _on_device(self, img: PixelImage) -> PixelImage:
        """``img``, or where a plane lies on another device than the
        context's, a copy of it with every plane on the context's device
        (the caller's image is left as it is)."""
        if all(p.device == self.device for p in img.planes.values()):
            return img
        out = img._like(img.width, img.height)
        for ch, p in img.planes.items():
            out.planes[ch] = p.to(self.device)
            out.plane_info[ch] = img.plane_info[ch]
        return out

    def _register_encoded_item(self, item_type: str) -> int:
        infe = self.file.add_new_item(item_type)
        item = alloc_item(self, infe.item_id, item_type)
        self.items[infe.item_id] = item
        return infe.item_id

    def _add_common_props(self, item_id: int, img: PixelImage,
                          options: EncodingOptions) -> None:
        self.file.add_property(item_id, Box_ispe(img.width, img.height), False)
        bits = [img.bit_depth(c) for c in img.channels()
                if c != Channel.Alpha]
        if bits:
            self.file.add_property(item_id, Box_pixi(bits), False)
        nclx = options.output_nclx or img.color_profile_nclx
        if nclx is not None:
            self.file.add_property(item_id, nclx.to_colr_box(), False)
        if img.color_profile_icc:
            b = Box_colr()
            b.colour_type = "prof"
            b.icc_profile = img.color_profile_icc
            self.file.add_property(item_id, b, False)

    def _encode_unci(self, img: PixelImage, options: EncodingOptions) -> int:
        enc = UnciEncoder(options.tile_cols, options.tile_rows,
                          compression=options.compression)
        data, cmpd, uncC, cmpC, icef = enc.encode(img)
        item_id = self._register_encoded_item("unci")
        self.file.append_item_data(item_id, data)
        self._add_common_props(item_id, img, options)
        cpat = self._make_cpat_property(img, cmpd)
        self.file.add_property(item_id, cmpd, False)
        self.file.add_property(item_id, uncC, True)
        if cpat is not None:
            self.file.add_property(item_id, cpat, False)
        if cmpC is not None:
            self.file.add_property(item_id, cmpC, True)
        if icef is not None:
            self.file.add_property(item_id, icef, True)
        return item_id

    def _make_cpat_property(self, img: PixelImage, cmpd):
        """Resolve an image's Bayer pattern into reference cmpd
        components + a cpat box (ref: heif_image_set_bayer_pattern →
        encoder cpat resolution, unc_encoder.cc; plane-less 'bayer
        reference components', heif_image.h:174)."""
        pattern = img.bayer_pattern
        if pattern is None or not img.has_channel(Channel.FilterArray):
            return None
        chan_to_type = {Channel.R: 4, Channel.G: 5, Channel.B: 6,
                        Channel.Y: 1}
        # append one plane-less reference component per distinct channel
        type_to_idx = {}
        for i, comp in enumerate(cmpd.components):
            type_to_idx.setdefault(comp.component_type, i)
        indices = []
        for ch in pattern.channels:
            ctype = chan_to_type.get(ch)
            if ctype is None:
                raise HeifError.usage(
                    msg=f"Bayer pattern cell {ch!r} has no component type")
            if ctype not in type_to_idx:
                type_to_idx[ctype] = len(cmpd.components)
                cmpd.components.append(CmpdComponent(ctype))
            indices.append(type_to_idx[ctype])
        cpat = Box_cpat()
        cpat.pattern_width = pattern.pattern_width
        cpat.pattern_height = pattern.pattern_height
        cpat.components = indices
        cpat.component_gains = list(pattern.gains)
        return cpat

    def _encode_mask(self, img: PixelImage, options: EncodingOptions) -> int:
        if img.colorspace != Colorspace.Monochrome:
            raise HeifError.unsupported(
                SubError.Unsupported_image_type,
                "mask encoding requires monochrome input")
        bpp = img.bit_depth(Channel.Y)
        # 16-bit masks as big-endian words, any other depth one byte a
        # sample (the JAX writer's astype(">u2") and astype(np.uint8))
        data = pack_samples(img.plane(Channel.Y),
                            16 if bpp == 16 else 8).cpu().numpy().tobytes()
        item_id = self._register_encoded_item("mski")
        self.file.append_item_data(item_id, data)
        self._add_common_props(item_id, img, options)
        self.file.add_property(item_id, Box_mskC(bpp), True)
        return item_id

    def _encode_coded(self, img, enc, fmt: str, options) -> int:
        data, config_box, extra = enc.encode_single_image(img, options)
        item_type = {"hevc": "hvc1", "av1": "av01", "vvc": "vvc1",
                     "avc": "avc1", "jpeg": "jpeg",
                     "jpeg2000": "j2k1", "htj2k": "j2k1"}.get(fmt, fmt)
        item_id = self._register_encoded_item(item_type)
        self.file.append_item_data(item_id, data)
        self._add_common_props(item_id, img, options)
        if config_box is not None:
            self.file.add_property(item_id, config_box, True)
        for prop, essential in (extra or []):
            self.file.add_property(item_id, prop, essential)
        return item_id

    def _encode_alpha_aux(self, img: PixelImage, fmt: str,
                          options: EncodingOptions) -> int:
        alpha = PixelImage(img.width, img.height, Colorspace.Monochrome,
                           Chroma.Monochrome, self.limits)
        alpha.set_plane(Channel.Y, img.plane(Channel.Alpha),
                        img.bit_depth(Channel.Alpha))
        opts2 = EncodingOptions(**{**options.__dict__,
                                   "save_alpha_channel": False})
        if fmt == "unci":
            alpha_id = self._encode_unci(alpha, opts2)
        else:
            # encode the alpha plane with the same coded codec
            # (ref: context.cc:1669 encode_image recursion)
            alpha_id = self._encode_coded(alpha, registry.get_encoder(fmt),
                                          fmt, opts2)
        self.file.add_property(
            alpha_id, Box_auxC("urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"),
            False)
        return alpha_id

    # ================================================================ write

    def set_primary_item(self, item_id: int) -> None:
        self.primary_id = item_id
        self.file.set_primary_item(item_id)
        for i, item in self.items.items():
            item.is_primary = (i == item_id)

    def write(self) -> bytes:
        """The file's bytes; a file made by ``new_file`` gets its ftyp
        from its content first (ref: HeifContext::write context.cc:382)."""
        if self.file is None:
            raise HeifError.usage(msg="no file to write: call new_file or "
                                      "encode an image first")
        self._finalize_brands()
        return self.file.write()

    def _finalize_brands(self) -> None:
        """Recompute ftyp from content (ref: brands.cc write path)."""
        f = self.file
        if not f.created_for_writing or f.ftyp is None:
            return      # read-mode file: preserve original brands
        item_types = []
        primary_type = None
        for iid in f.item_ids:
            t = f.get_infe(iid).item_type
            item_types.append(t)
            if self.primary_id == iid:
                primary_type = t
        major, compat = compute_brands(item_types, primary_type)
        f.ftyp.major_brand = major
        f.ftyp.compatible_brands = compat

    def write_to_file(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.write())
