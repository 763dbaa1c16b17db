"""ISOBMFF box model: headers, base classes, registry, factory.

Re-designed equivalent of the reference's box layer (reference:
libheif/box.h — BoxHeader:110, Box:177, FullBox:310; factory switch
Box::read box.cc:469+).  Key behaviors replicated:

- unknown box types parse into :class:`Box_other` keeping raw payload
  (round-trips unchanged);
- a payload parse error yields a :class:`Box_Error` placeholder instead
  of failing the whole file (ref: box.h:370, parse_error_fatality
  box.h:170-174);
- version/flags handling for FullBoxes with unsupported-version capping;
- serialization reserves header space and patches the final size
  (ref: reserve_box_header_space / prepend_header).

Python-side the factory is a registry dict populated by the
``@register_box`` decorator instead of a switch statement.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from ..core.bitstream import ByteReader, ByteWriter
from ..core.error import HeifError, ErrorCode, SubError
from ..core.limits import SecurityLimits

MAX_BOX_RECURSION_DEPTH = 20  # ref: box.cc kMaxRecursionDepth

BOX_REGISTRY: Dict[str, Type["Box"]] = {}
UUID_BOX_REGISTRY: Dict[bytes, Type["Box"]] = {}


def register_box(*fourccs: str) -> Callable[[Type["Box"]], Type["Box"]]:
    def deco(cls: Type["Box"]) -> Type["Box"]:
        for fcc in fourccs:
            BOX_REGISTRY[fcc] = cls
        cls.box_type = fourccs[0]
        return cls
    return deco


def register_uuid_box(uuid: bytes) -> Callable[[Type["Box"]], Type["Box"]]:
    """Register a 'uuid' extension box by its 16-byte type
    (ref: Box_gimi_content_id, box.h:1957 set_uuid_type)."""
    def deco(cls: Type["Box"]) -> Type["Box"]:
        UUID_BOX_REGISTRY[uuid] = cls
        return cls
    return deco


class BoxHeader:
    """size/type/[largesize]/[uuid] header (ref: box.h:110)."""

    __slots__ = ("size", "type", "uuid", "header_size")

    def __init__(self, box_type: str = "????", size: int = 0,
                 uuid: Optional[bytes] = None, header_size: int = 8):
        self.type = box_type
        self.size = size          # full box size incl. header; 0 = to EOF
        self.uuid = uuid
        self.header_size = header_size

    @staticmethod
    def parse(r: ByteReader) -> "BoxHeader":
        start = r.pos
        size = r.read32()
        btype = r.read_bytes(4).decode("latin-1")
        uuid = None
        if size == 1:
            size = r.read64()
        elif size == 0:
            size = r.end - start  # box extends to end of enclosing range
        if btype == "uuid":
            uuid = r.read_bytes(16)
        header_size = r.pos - start
        if size < header_size:
            raise HeifError.invalid_input(
                SubError.Invalid_box_size,
                f"box '{btype}' size {size} smaller than header {header_size}")
        return BoxHeader(btype, size, uuid, header_size)


class Box:
    """Base box. Subclasses set ``box_type`` (via @register_box) and
    override ``parse_payload`` / ``write_payload`` / ``dump_fields``."""

    box_type: str = "????"
    is_full_box = False

    def __init__(self) -> None:
        self.children: List[Box] = []
        self.uuid: Optional[bytes] = None

    # ---------------------------------------------------------------- parse

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth: int = 0) -> None:
        """Default: container box — parse children until payload ends."""
        self.read_children(r, limits, depth)

    def read_children(self, r: ByteReader, limits: SecurityLimits,
                      depth: int = 0, max_children: Optional[int] = None) -> None:
        count = 0
        cap = max_children if max_children is not None else limits.max_children_per_box
        while not r.eof():
            self.children.append(read_box(r, limits, depth + 1))
            count += 1
            if cap and count > cap:
                raise HeifError.security(
                    f"more than {cap} child boxes in '{self.box_type}'")

    def get_child(self, key, required: bool = False) -> Optional["Box"]:
        """The first child box of class ``key``, or of box type ``key``
        when it is a four-character string (ref: Box::get_child_box);
        None, or with ``required`` invalid_input, when there is none."""
        c = next((c for c in self.children if _box_matches(c, key)), None)
        if c is None and required:
            raise HeifError.invalid_input(
                msg=f"required child '{key}' missing in '{self.box_type}'")
        return c

    def get_children(self, key) -> List["Box"]:
        """Every child box of class or box type ``key``."""
        return [c for c in self.children if _box_matches(c, key)]

    # ---------------------------------------------------------------- write

    def derive_version(self) -> None:
        """Hook: choose minimal FullBox version before writing
        (ref: Box::derive_box_version, box.h:195)."""
        for c in self.children:
            c.derive_version()

    def write(self, w: ByteWriter) -> None:
        start = w.pos
        w.write32(0)  # size placeholder
        w.write_bytes(self.box_type.encode("latin-1"))
        if self.uuid is not None:
            w.write_bytes(self.uuid)
        self.write_payload(w)
        size = w.pos - start
        if size > 0xFFFFFFFF:
            # switch to largesize: insert 8 bytes after the type field
            w.insert(start + 8, (size + 8).to_bytes(8, "big"))
            w.patch32(start, 1)
        else:
            w.patch32(start, size)

    def write_payload(self, w: ByteWriter) -> None:
        self.write_children(w)

    def write_children(self, w: ByteWriter) -> None:
        for c in self.children:
            c.write(w)

    def serialize(self) -> bytes:
        w = ByteWriter()
        self.derive_version()
        self.write(w)
        return w.data()

    # ---------------------------------------------------------------- dump

    def dump_fields(self) -> List[str]:
        return []

    def dump(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = [f"{pad}Box: {self.box_type} -----"]
        if self.is_full_box:
            lines.append(f"{pad}| version: {getattr(self, 'version', 0)}, "
                         f"flags: {getattr(self, 'flags', 0):#x}")
        for f in self.dump_fields():
            lines.append(f"{pad}| {f}")
        for c in self.children:
            lines.append(c.dump(indent + 1))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} '{self.box_type}'>"


class FullBox(Box):
    """Box with version + 24-bit flags (ref: box.h:310)."""

    is_full_box = True
    supported_versions = (0,)

    def __init__(self) -> None:
        super().__init__()
        self.version = 0
        self.flags = 0

    def parse_full_header(self, r: ByteReader) -> None:
        self.version = r.read8()
        self.flags = r.read24()

    def check_version(self) -> None:
        if self.version not in self.supported_versions:
            raise HeifError.unsupported(
                SubError.Unsupported_data_version,
                f"'{self.box_type}' version {self.version} not supported")

    def write_full_header(self, w: ByteWriter) -> None:
        w.write8(self.version)
        w.write24(self.flags)


class Box_other(Box):
    """Unknown box: raw payload passthrough (ref: box.h:346 Box_other)."""

    def __init__(self, box_type: str = "????", payload: bytes = b""):
        super().__init__()
        self.box_type = box_type
        self.payload = payload

    def parse_payload(self, r: ByteReader, limits: SecurityLimits,
                      depth: int = 0) -> None:
        self.payload = r.read_remaining()

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.payload)

    def dump_fields(self) -> List[str]:
        return [f"unknown box, {len(self.payload)} payload bytes"]


class Box_Error(Box):
    """Placeholder for a box whose payload failed to parse
    (ref: box.h:370).  Keeps the file loadable; accessing semantics of
    the failed box surfaces the stored error."""

    box_type = "ERR "

    def __init__(self, failed_type: str, error: HeifError, payload: bytes = b""):
        super().__init__()
        self.failed_type = failed_type
        self.error = error
        self.payload = payload

    def write_payload(self, w: ByteWriter) -> None:
        w.write_bytes(self.payload)

    def write(self, w: ByteWriter) -> None:
        # Round-trip the original bytes under the original type.
        start = w.pos
        w.write32(0)
        w.write_bytes(self.failed_type.encode("latin-1"))
        w.write_bytes(self.payload)
        w.patch32(start, w.pos - start)

    def dump_fields(self) -> List[str]:
        return [f"failed to parse '{self.failed_type}': {self.error}"]


# Box types whose parse failure is fatal for the whole file
# (ref: Box::parse_error_fatality box.h:170-174 — header-critical boxes).
_FATAL_BOXES = frozenset({"ftyp", "meta", "hdlr", "iloc", "iinf", "iprp",
                          "ipco", "ipma", "pitm"})


def read_box(r: ByteReader, limits: SecurityLimits, depth: int = 0) -> Box:
    """Factory: parse one box from the reader (ref: Box::read box.cc:469)."""
    if depth > MAX_BOX_RECURSION_DEPTH:
        raise HeifError.security("box nesting too deep")

    hdr = BoxHeader.parse(r)
    payload_size = hdr.size - hdr.header_size
    if payload_size > r.remaining():
        raise HeifError.invalid_input(
            SubError.Invalid_box_size,
            f"box '{hdr.type}' size {hdr.size} exceeds enclosing range")

    sub = r.sub_reader(payload_size)
    cls = BOX_REGISTRY.get(hdr.type)
    if hdr.type == "uuid" and hdr.uuid is not None:
        cls = UUID_BOX_REGISTRY.get(hdr.uuid, cls)
    if cls is None:
        box = Box_other(hdr.type)
        box.uuid = hdr.uuid
        box.parse_payload(sub, limits, depth)
        return box

    box = cls()
    box.uuid = hdr.uuid
    payload_start = sub.pos
    try:
        if box.is_full_box:
            box.parse_full_header(sub)
            box.check_version()
        box.parse_payload(sub, limits, depth)
    except HeifError as e:
        if e.code == ErrorCode.Memory_allocation_error or hdr.type in _FATAL_BOXES:
            raise
        raw = bytes(sub._buf[payload_start:sub.end])
        return Box_Error(hdr.type, e, raw)
    return box


def read_all_boxes(data: bytes, limits: Optional[SecurityLimits] = None) -> List[Box]:
    """Parse a sequence of top-level boxes from a byte buffer."""
    limits = limits or SecurityLimits()
    r = ByteReader(data)
    boxes: List[Box] = []
    while not r.eof():
        boxes.append(read_box(r, limits, 0))
    return boxes


def _box_matches(box: Box, key) -> bool:
    if isinstance(key, str):
        return box.box_type == key
    return isinstance(box, key)
