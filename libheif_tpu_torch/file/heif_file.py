"""File-level HEIF model: box wiring, item data access, write path.

Counterpart of libheif_tpu/file/heif_file.py (reference: libheif/file.{h,cc}
— HeifFile file.h:60; top-level parse of FileLayout::read
file_layout.cc:38), read side: a file with a ``meta`` box, a ``mini``
box (whose items the context makes, items/mini_item.py) or a ``moov``
box (an image sequence, brand ``msf1``, whose tracks the context makes,
sequences/track.py; JAX heif_file.py:53, :107-114, :162-171), or several
of them.  A file is parsed over an in-memory buffer, or over a
streaming reader (``from_reader``: only the structural boxes are
fetched, and item data by the byte ranges of its extents when it is
read).  mdat payloads are never copied at parse time, and the data of an
item stored in one extent of an in-memory file is returned as a
memoryview of the file buffer, so a large unci payload reaches the
decoder without a host copy.  ``get_item_data_range`` reads part of an
item's data (a tili item's offset table and tiles), and
``get_item_data_view`` gives a lazy view over it (an unci tile).

The write side lays out items without an encoder: add items, append
their data (``append_item_data``; ``replace_item_data`` patches it, as a
tili item's offset table needs) and track samples
(``append_sample_data``), attach properties and references, then
:meth:`write`: ftyp, meta, the tracks' moov (its stco/saio offsets made
absolute, then restored, JAX :535-571), mdat; or ``ftyp('mif3') + mini``
where ``write_mini_format`` is set and the content fits (mini_write.py).
``dump`` gives the boxes as text.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, ErrorCode, SubError
from ..core.limits import SecurityLimits
from ..boxes.box import Box, read_box
from ..boxes.mini import Box_mini
from ..boxes.meta import (
    Box_ftyp, Box_meta, Box_hdlr, Box_pitm, Box_iloc, Box_iinf, Box_infe,
    Box_iprp, Box_ipco, Box_ipma, Box_iref, Box_idat, Box_grpl, Box_mdat,
    IlocItem, IlocExtent,
)
from ..io.reader import GrowStatus
from .file_layout import FileLayout
from .mini_write import build_mini_box

ItemData = Union[bytes, memoryview]


class HeifFile:
    """Parsed HEIF file: item tables + raw data access (ref: file.h:60):
    item IDs/types, iloc data access incl. idat construction, property
    get/add with dedup, and file writing with mdat assembly."""

    def __init__(self, limits: Optional[SecurityLimits] = None):
        self.limits = limits or SecurityLimits()
        self.buffer: Optional[memoryview] = None  # whole-file bytes (read path)
        self.reader = None    # StreamReader of a file opened by from_reader
        self.top_boxes: List[Box] = []
        self.ftyp: Optional[Box_ftyp] = None
        self.meta: Optional[Box_meta] = None
        self.mini: Optional[Box_mini] = None
        self.moov: Optional[Box] = None    # the sequence tracks' box tree
        self.write_mini_format = False     # ref: file.h:101

        # meta children (wired by _parse_meta)
        self.hdlr: Optional[Box_hdlr] = None
        self.pitm: Optional[Box_pitm] = None
        self.iloc: Optional[Box_iloc] = None
        self.iinf: Optional[Box_iinf] = None
        self.iprp: Optional[Box_iprp] = None
        self.ipco: Optional[Box_ipco] = None
        self.ipma: Optional[Box_ipma] = None
        self.iref: Optional[Box_iref] = None
        self.idat: Optional[Box_idat] = None
        self.grpl: Optional[Box_grpl] = None   # entity groups (JAX :66)

        self.infe_by_id: Dict[int, Box_infe] = {}
        self._next_item_id = 1
        # write side: item data waiting for the mdat that write() lays out
        self._mdat_parts: List[ItemData] = []
        self._mdat_size = 0
        self.created_for_writing = False   # set by init_for_writing

    # ================================================================ read

    @staticmethod
    def from_file(path: str, limits: Optional[SecurityLimits] = None) -> "HeifFile":
        if not os.path.exists(path):
            raise HeifError(ErrorCode.Input_does_not_exist, message=path)
        with open(path, "rb") as f:
            data = f.read()
        return HeifFile.from_bytes(data, limits)

    @staticmethod
    def from_bytes(data: bytes, limits: Optional[SecurityLimits] = None) -> "HeifFile":
        hf = HeifFile(limits)
        hf._read(data)
        return hf

    @staticmethod
    def from_reader(reader, limits: Optional[SecurityLimits] = None) -> "HeifFile":
        """Progressive open over a streaming reader (io/reader.py): only
        the structural boxes are fetched; item data stays with the
        reader until a read requests its byte ranges (ref:
        FileLayout::read file_layout.cc:38 + heif_reader v2,
        heif_context.h:164-231)."""
        hf = HeifFile(limits)
        layout = FileLayout()
        layout.read(reader, hf.limits)
        hf.reader = reader
        hf.top_boxes = list(layout.boxes)
        hf._wire_top_boxes()
        return hf

    def _fetch(self, start: int, length: int) -> ItemData:
        """A range of the file: a view of the buffer, without a copy, or
        the reader's bytes for that range."""
        if self.buffer is not None:
            if start + length > len(self.buffer):
                raise HeifError.eof(
                    f"file range [{start}+{length}] beyond file end")
            return self.buffer[start:start + length]
        if self.reader is not None:
            if self.reader.request_range(start, start + length) != \
                    GrowStatus.SIZE_REACHED:
                raise HeifError.eof(
                    f"file range [{start}+{length}] beyond file end")
            return self.reader.read(start, length)
        raise HeifError.invalid_input(SubError.No_item_data,
                                      "no file buffer or reader")

    def _fetch_method0(self, it: IlocItem, start: int,
                       length: int) -> ItemData:
        """A construction-method-0 range of an item: from the file, or for
        an item written into this file, from the mdat ``write`` will lay
        out (its offsets are mdat-relative until then), so that a context
        can decode what it encoded."""
        if not it.mdat_relative:
            return self._fetch(start, length)
        if start + length > self._mdat_size:
            raise HeifError.eof(f"pending-mdat extent [{start}+{length}] "
                                "out of range")
        out, pos = [], 0
        for part in self._mdat_parts:
            lo, hi = max(start, pos), min(start + length, pos + len(part))
            if lo < hi:
                out.append(part[lo - pos:hi - pos])
            pos += len(part)
        return out[0] if len(out) == 1 else b"".join(out)

    def _has_input(self) -> bool:
        return self.buffer is not None or self.reader is not None

    def _read(self, data: bytes) -> None:
        self.buffer = memoryview(data)
        r = ByteReader(self.buffer)
        if r.remaining() < 8:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_ftyp_box,
                            "file too small")
        while not r.eof():
            if r.remaining() < 8:
                break  # trailing garbage smaller than a header — ignore
            self.top_boxes.append(read_box(r, self.limits, 0))
        self._wire_top_boxes()

    def _wire_top_boxes(self) -> None:
        # --- locate top-level boxes (ref: FileLayout::read file_layout.cc:90)
        for b in self.top_boxes:
            if isinstance(b, Box_ftyp) and self.ftyp is None:
                self.ftyp = b
            elif isinstance(b, Box_meta) and self.meta is None:
                self.meta = b
            elif isinstance(b, Box_mini) and self.mini is None:
                self.mini = b
            elif b.box_type == "moov" and self.moov is None:
                self.moov = b

        if self.ftyp is None:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_ftyp_box,
                            "no ftyp box found")
        if self.meta is None and self.mini is None and self.moov is None:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_meta_box,
                            "no meta/mini/moov box found")
        if self.meta is not None:
            self._parse_meta()

    def _parse_meta(self) -> None:
        m = self.meta
        self.hdlr = m.get_child(Box_hdlr)
        if self.hdlr is None or self.hdlr.handler_type != "pict":
            raise HeifError(ErrorCode.Invalid_input, SubError.No_pict_handler,
                            "meta handler is not 'pict'")
        self.pitm = m.get_child(Box_pitm)
        self.iloc = m.get_child(Box_iloc)
        self.iinf = m.get_child(Box_iinf)
        self.iprp = m.get_child(Box_iprp)
        self.iref = m.get_child(Box_iref)
        self.idat = m.get_child(Box_idat)
        self.grpl = m.get_child(Box_grpl)
        if self.iprp is not None:
            self.ipco = self.iprp.get_child(Box_ipco)
            self.ipma = self.iprp.get_child(Box_ipma)
        if self.iloc is None:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_iloc_box)
        if self.iinf is None:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_iinf_box)
        if self.ipco is None or self.ipma is None:
            raise HeifError(ErrorCode.Invalid_input, SubError.No_ipco_box,
                            "missing ipco/ipma")

        self.limits.check_item_count(len(self.iinf.entries))
        for infe in self.iinf.entries:
            self.infe_by_id[infe.item_id] = infe
            self._next_item_id = max(self._next_item_id, infe.item_id + 1)

        if self.iref is not None:
            self.iref.check_for_cycles()

    def top_level_box(self, fourcc: str) -> Optional[Box]:
        """The first top-level box of type ``fourcc``, or None; for
        ``moov`` also the one a writer set (JAX heif_file.py:617)."""
        box = next((b for b in self.top_boxes if b.box_type == fourcc),
                   None)
        if box is None and fourcc == "moov":
            return self.moov
        return box

    def read_file_range(self, offset: int, size: int) -> ItemData:
        """``size`` bytes of the file at ``offset`` (a track sample or its
        aux info): a view of the buffer, or the reader's bytes."""
        try:
            return self._fetch(offset, size)
        except HeifError as e:
            if e.subcode == SubError.End_of_data:
                raise HeifError.invalid_input(
                    SubError.End_of_data, "sample range beyond file end")
            raise

    # ---------------------------------------------------------------- items

    @property
    def item_ids(self) -> List[int]:
        return list(self.infe_by_id.keys())

    @property
    def primary_item_id(self) -> int:
        if self.pitm is None:
            raise HeifError(ErrorCode.Invalid_input,
                            SubError.No_or_invalid_primary_item, "no pitm box")
        return self.pitm.item_id

    def has_item(self, item_id: int) -> bool:
        return item_id in self.infe_by_id

    def get_item_type(self, item_id: int) -> str:
        infe = self.infe_by_id.get(item_id)
        return infe.item_type if infe else ""

    def get_infe(self, item_id: int) -> Box_infe:
        infe = self.infe_by_id.get(item_id)
        if infe is None:
            raise HeifError.usage(SubError.Nonexisting_item_referenced,
                                  f"item {item_id} does not exist")
        return infe

    # ---------------------------------------------------------------- data

    def get_item_data(self, item_id: int) -> ItemData:
        """Item payload from its iloc extents (ref: HeifFile iloc data
        access file.h:122-134): construction method 0 (absolute file
        offset) and 1 (idat-relative); method 2 (dref/external) raises,
        like the reference for non-self-contained references.  One extent
        in the file comes back as a memoryview of the file buffer (the
        same bytes, no copy); anything else as bytes."""
        iloc_item = self.iloc.find_item(item_id) if self.iloc else None
        if iloc_item is None:
            raise HeifError.invalid_input(SubError.No_item_data,
                                          f"item {item_id} has no iloc entry")
        return self._read_iloc_item(iloc_item)

    def _read_iloc_item(self, it: IlocItem) -> ItemData:
        method = it.construction_method
        total = sum(e.length for e in it.extents)
        self.limits.check_block_size(total, f"item {it.item_id} data")
        parts: List[ItemData] = []
        for ext in it.extents:
            start = it.base_offset + ext.offset
            length = ext.length
            if method == 0:
                parts.append(self._fetch_method0(it, start, length))
            elif method == 1:
                if self.idat is None:
                    raise HeifError.invalid_input(SubError.No_idat_box)
                if start + length > len(self.idat.data):
                    raise HeifError.eof("idat extent out of range")
                parts.append(self.idat.data[start:start + length])
            else:
                raise HeifError.unsupported(
                    SubError.Unsupported_item_construction_method,
                    f"iloc construction method {method}")
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def get_item_data_view(self, item_id: int) -> "ItemDataView":
        """A lazy view over an item's data: its length, and slices read
        through ``get_item_data_range`` — the random access behind an
        unci tile's decode over a streaming reader (ref: heif_reader v2
        request_range + unc_codec.h:56 tile access)."""
        it = self.iloc.find_item(item_id) if self.iloc else None
        if it is None:
            raise HeifError.invalid_input(SubError.No_item_data,
                                          f"item {item_id} has no iloc entry")
        return ItemDataView(self, item_id, sum(e.length for e in it.extents))

    def get_item_data_range(self, item_id: int, offset: int,
                            size: int) -> bytes:
        """``size`` bytes of an item's data from ``offset``, read from the
        extents that hold them without assembling the item (ref:
        HeifFile::append_data_from_iloc with offset/size, file.h:122-134)
        — the access behind a tili item's offset table and tiles."""
        it = self.iloc.find_item(item_id) if self.iloc else None
        if it is None:
            raise HeifError.invalid_input(SubError.No_item_data,
                                          f"item {item_id} has no iloc entry")
        self.limits.check_block_size(size, f"item {item_id} range")
        method = it.construction_method
        parts: List[ItemData] = []
        want_start, want_end = offset, offset + size
        pos = 0
        for ext in it.extents:
            ext_start, ext_end = pos, pos + ext.length
            pos = ext_end
            lo, hi = max(want_start, ext_start), min(want_end, ext_end)
            if lo >= hi:
                continue
            src = it.base_offset + ext.offset + (lo - ext_start)
            length = hi - lo
            if method == 0:
                parts.append(self._fetch_method0(it, src, length))
            elif method == 1:
                if self.idat is None:
                    raise HeifError.invalid_input(SubError.No_idat_box)
                if src + length > len(self.idat.data):
                    raise HeifError.eof("idat extent out of range")
                parts.append(self.idat.data[src:src + length])
            else:
                raise HeifError.unsupported(
                    SubError.Unsupported_item_construction_method,
                    f"iloc construction method {method}")
        data = b"".join(parts)
        if len(data) < size:
            raise HeifError.eof(
                f"item {item_id} range [{offset}+{size}] incomplete")
        return data

    def replace_item_data(self, item_id: int, offset: int,
                          data: bytes) -> None:
        """Overwrite previously appended item payload bytes in write mode
        (ref: HeifFile::replace_iloc_data, used by ImageItem_Tiled::
        process_before_write tiled.cc:946-957 to patch the offset table).
        The range must lie in one extent, which must be one appended
        part."""
        it = self.iloc.find_item(item_id) if self.iloc else None
        if it is None:
            raise HeifError.usage(
                msg="replace_item_data requires a write-mode item")
        want_start, want_end = offset, offset + len(data)
        pos = 0
        for ext in it.extents:
            ext_start, ext_end = pos, pos + ext.length
            pos = ext_end
            if want_start >= ext_end or want_end <= ext_start:
                continue
            if want_start < ext_start or want_end > ext_end:
                raise HeifError.usage(
                    msg="replacement range spans iloc extents")
            # extent.offset is mdat-relative; find the backing part
            run = 0
            for i, part in enumerate(self._mdat_parts):
                if run == ext.offset and len(part) == ext.length:
                    buf = bytearray(part)
                    s = want_start - ext_start
                    buf[s:s + len(data)] = data
                    self._mdat_parts[i] = bytes(buf)
                    return
                run += len(part)
            raise HeifError.usage(msg="extent does not map to an mdat part")
        raise HeifError.usage(msg="replacement range outside item data")

    # ------------------------------------------------------------ properties

    def get_properties(self, item_id: int) -> List[Box]:
        """Properties associated with an item, in association order
        (ref: HeifFile::get_properties file.h:168)."""
        if self.ipma is None or self.ipco is None:
            return []
        props = []
        for assoc in self.ipma.get(item_id):
            p = self.ipco.get_property(assoc.property_index)
            if p is None:
                raise HeifError.invalid_input(
                    SubError.Ipma_box_references_nonexisting_property,
                    f"ipma references property {assoc.property_index}")
            props.append(p)
        return props

    def get_property(self, item_id: int, box_cls) -> Optional[Box]:
        for p in self.get_properties(item_id):
            if isinstance(p, box_cls):
                return p
        return None

    # ---------------------------------------------------------------- refs

    def get_references_from(self, item_id: int, ref_type: Optional[str] = None):
        if self.iref is None:
            return []
        return self.iref.get_references_from(item_id, ref_type)

    def get_references_to(self, item_id: int, ref_type: Optional[str] = None):
        if self.iref is None:
            return []
        return self.iref.get_references_to(item_id, ref_type)

    # ================================================================ write

    def init_for_writing(self, major_brand: str = "heic",
                         compatible: Optional[List[str]] = None) -> None:
        """Create the empty box skeleton for a new file
        (ref: HeifFile::new_empty_file)."""
        self.created_for_writing = True
        self.ftyp = Box_ftyp(major_brand, 0, compatible or
                             ["mif1", "heic", "miaf"])
        self.meta = Box_meta()
        self.hdlr = Box_hdlr("pict")
        self.pitm = Box_pitm()
        self.iloc = Box_iloc()
        self.iinf = Box_iinf()
        self.iprp = Box_iprp()
        self.ipco = Box_ipco()
        self.ipma = Box_ipma()
        self.iref = Box_iref()
        self.meta.children = [self.hdlr, self.pitm, self.iloc, self.iinf,
                              self.iprp]
        self.iprp.children = [self.ipco, self.ipma]
        self.top_boxes = [self.ftyp, self.meta]

    def add_new_item(self, item_type: str, name: str = "") -> Box_infe:
        item_id = self._next_item_id
        self._next_item_id += 1
        infe = Box_infe(item_id, item_type, name)
        self.iinf.children.append(infe)
        self.infe_by_id[item_id] = infe
        return infe

    def append_item_data(self, item_id: int, data: bytes,
                         construction_method: int = 0) -> None:
        """Append payload bytes for an item (ref: HeifFile::append_iloc_data
        file.h:232).  Method-0 offsets are mdat-relative until patched."""
        if self._has_input():
            self._materialize_read_extents()
        it = self.iloc.find_item(item_id)
        if it is None:
            it = IlocItem(item_id=item_id,
                          construction_method=construction_method,
                          mdat_relative=True)
            self.iloc.items.append(it)
        if construction_method == 0:
            it.extents.append(IlocExtent(0, self._mdat_size, len(data)))
            self._mdat_parts.append(data)
            self._mdat_size += len(data)
        else:
            if self.idat is None:
                self.idat = Box_idat()
                self.meta.children.append(self.idat)
            it.extents.append(IlocExtent(0, len(self.idat.data), len(data)))
            self.idat.data += data

    def add_property(self, item_id: int, prop: Box, essential: bool) -> int:
        """Add a property with ipco dedup (ref: file.h:168-216)."""
        index = self.ipco.find_or_append(prop)
        self.ipma.add(item_id, index, essential)
        return index

    def set_primary_item(self, item_id: int) -> None:
        self.pitm.item_id = item_id

    def add_reference(self, ref_type: str, from_id: int, to_ids: List[int]) -> None:
        if self.iref is None:
            self.iref = Box_iref()
        if self.iref not in self.meta.children:
            self.meta.children.append(self.iref)
        self.iref.add_reference(ref_type, from_id, to_ids)

    def _materialize_read_extents(self) -> None:
        """Rebase method-0 iloc extents that point into the source read
        buffer into in-memory mdat parts, so that a file read from disk
        can be modified and re-written (ref: HeifContext::write rewrites
        all item data into a fresh mdat, context.cc:382)."""
        if self.iloc is None:
            return
        for it in self.iloc.items:
            if it.mdat_relative or it.construction_method != 0:
                continue
            new_extents = []
            for ext in it.extents:
                start = it.base_offset + ext.offset
                new_extents.append(
                    IlocExtent(0, self._mdat_size, ext.length))
                self._mdat_parts.append(self._fetch(start, ext.length))
                self._mdat_size += ext.length
            it.extents = new_extents
            it.base_offset = 0
            it.mdat_relative = True

    def write(self) -> bytes:
        """Serialize the file: ftyp, meta, the tracks' moov, then the
        mdat, then patch the iloc offsets and the moov's mdat-relative
        stco/saio offsets (ref: HeifContext::write context.cc:382 + Box_iloc
        patching).  The moov's offsets are restored afterwards, so a
        second write gives the same bytes.

        When ``write_mini_format`` is set and the content fits the
        compact profile, the output is ``ftyp('mif3') + mini`` instead
        (ref: HeifFile::write file.cc:257-285); other content is written
        in the standard format.
        """
        if self.write_mini_format:
            mini_data = self._try_write_mini()
            if mini_data is not None:
                return mini_data
        if self.meta is None:
            raise HeifError.usage(msg="no meta box to write")
        if self._has_input():
            self._materialize_read_extents()
        w = ByteWriter()
        if self.iref is not None and not self.iref.references and \
                self.iref in self.meta.children:
            self.meta.children.remove(self.iref)

        self.ftyp.derive_version()
        self.ftyp.write(w)
        self.meta.derive_version()
        self.meta.write(w)
        moov_start = w.pos
        if self.moov is not None:
            self.moov.derive_version()
            self.moov.write(w)

        mdat_payload = b"".join(self._mdat_parts)
        mdat_header_start = w.pos
        Box_mdat(mdat_payload).write(w)
        # mdat payload begins after its 8-byte header (16 if largesize)
        payload_start = mdat_header_start + (
            16 if len(mdat_payload) + 8 > 0xFFFFFFFF else 8)
        self.iloc.patch_iloc_offsets(w, payload_start)
        if self.moov is None:
            return w.data()
        # rewrite the moov in place with absolute offsets, then restore
        # the mdat-relative ones
        offset_boxes = self._all_offset_boxes()
        for box in offset_boxes:
            box.offsets = [o + payload_start for o in box.offsets]
        w2 = ByteWriter()
        self.moov.write(w2)
        for box in offset_boxes:
            box.offsets = [o - payload_start for o in box.offsets]
        data = bytearray(w.data())
        data[moov_start:moov_start + len(w2.data())] = w2.data()
        return bytes(data)

    def _try_write_mini(self) -> Optional[bytes]:
        """ftyp('mif3') + mini, or None when the content does not fit
        (ref: file.cc:257-285)."""
        if self.meta is None:
            return None
        if self._has_input():
            self._materialize_read_extents()
        mini = build_mini_box(self)
        if mini is None:
            return None
        item_type = self.get_item_type(self.primary_item_id)
        codec_brand = "avif" if item_type == "av01" else "heic"
        ftyp = Box_ftyp("mif3",
                        int.from_bytes(codec_brand.encode("latin-1"),
                                       "big"), [])
        w = ByteWriter()
        ftyp.write(w)
        mini.write(w)
        return w.data()

    def _all_offset_boxes(self) -> List[Box]:
        """stco/co64 + saio: every box of the moov holding mdat-relative
        offsets that become absolute once the mdat position is known."""
        out: List[Box] = []

        def walk(b):
            if b.box_type in ("stco", "co64", "saio"):
                out.append(b)
            for c in b.children:
                walk(c)
        if self.moov is not None:
            walk(self.moov)
        return out

    def append_sample_data(self, data: bytes) -> int:
        """Append track sample bytes to the mdat; returns the
        mdat-relative offset (made absolute by ``write``)."""
        off = self._mdat_size
        self._mdat_parts.append(data)
        self._mdat_size += len(data)
        return off

    def write_to_file(self, path: str) -> None:
        data = self.write()
        with open(path, "wb") as f:
            f.write(data)

    def dump(self) -> str:
        """Every top-level box as indented text (``Box.dump``)."""
        return "\n".join(b.dump() for b in self.top_boxes)


class ItemDataView:
    """An item's data, read lazily: ``len()`` and slices (each slice one
    ``get_item_data_range`` call, bytes)."""

    def __init__(self, file: HeifFile, item_id: int, total: int):
        self._file = file
        self._item_id = item_id
        self._total = total

    def __len__(self) -> int:
        return self._total

    def __getitem__(self, key: slice) -> bytes:
        start, stop, step = key.indices(self._total)
        if step != 1:
            raise ValueError("an item data view is read in contiguous ranges")
        return self._file.get_item_data_range(self._item_id, start,
                                              max(0, stop - start))
