"""The 17 boxes the read-side API needs (libheif_tpu_torch/boxes/meta.py)
against the JAX package's: each box the JAX writer serialises parses in
the port to a box of the same class and fields, which writes the same
bytes and dumps the same text; a box the port writes parses in JAX to
the same fields.  A file with a ``grpl`` that the JAX writer made reads
back with the same entity groups, and its ``ster`` box with other than
two entities is refused by both packages alike.
"""

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

import api_files as af  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.boxes import box as jbox  # noqa: E402
from libheif_tpu.boxes import meta as jmeta  # noqa: E402
from libheif_tpu.core.bitstream import ByteWriter as JWriter  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.boxes import box as pbox  # noqa: E402
from libheif_tpu_torch.boxes import meta as pmeta  # noqa: E402
from libheif_tpu_torch.core.bitstream import (  # noqa: E402
    ByteWriter as PWriter)


def _iscl(m):
    b = m.Box_iscl()
    b.width_num, b.width_den, b.height_num, b.height_den = 3, 2, 5, 4
    return b


def _amve(m):
    b = m.Box_amve()
    b.ambient_illumination, b.ambient_light_x, b.ambient_light_y = \
        3140, 15635, 16450
    return b


def _pymd(m):
    b = m.Box_pymd()
    b.group_id, b.entity_ids = 7, [3, 4, 5]
    b.tile_size_x, b.tile_size_y = 512, 256
    b.layer_infos = [m.PymdLayerInfo(4, 0, 0), m.PymdLayerInfo(2, 1, 1),
                     m.PymdLayerInfo(1, 3, 2)]
    return b


def _itai(m):
    return m.Box_itai(m.TaiTimestampPacket(
        tai_timestamp=0x0123456789ABCDEF, synchronization_state=True,
        timestamp_is_modified=True))


def _cclv(m, full=True):
    b = m.Box_cclv()
    if full:
        b.primaries = [(35400, 14600), (-8500, 39850), (6550, 2300)]
        b.max_luminance = 10000000
    b.min_luminance, b.avg_luminance = 50, 2000000
    return b


def _cmin(m, flags):
    b = m.Box_cmin()
    b.flags = flags
    b.focal_length_x, b.principal_point_x, b.principal_point_y = \
        1200, -640, 480
    b.focal_length_y, b.skew = 1300, -7
    return b


def _cmex(m, version, flags):
    b = m.Box_cmex()
    b.version, b.flags = version, flags
    b.pos_x, b.pos_y, b.pos_z = 10, -20, 30
    b.quat = (1000, -2000, 3000)
    b.rotation = (65536, -131072, 196608)
    b.world_coordinate_system_id = 42
    return b


def _grpl(m):
    g = m.Box_grpl()
    g.children = [m.Box_altr(1, [2, 3]), m.Box_ster(4, [5, 6])]
    return g


CASES = {
    "grpl": _grpl,
    "EntityToGroup": lambda m: m.Box_altr(9, []),
    "altr": lambda m: m.Box_altr(12, [1, 2, 3, 4]),
    "ster": lambda m: m.Box_ster(13, [7, 8]),
    "pymd": _pymd,
    "amve": _amve,
    "ndwt": lambda m: m.Box_ndwt(203),
    "cclv": _cclv,
    "cclv_partial": lambda m: _cclv(m, full=False),
    "pasp": lambda m: m.Box_pasp(16, 9),
    "iscl": _iscl,
    "lsel": lambda m: m.Box_lsel(3),
    "udes": lambda m: m.Box_udes("fr", "nom", "une description", "a,b"),
    "udes_short": lambda m: m.Box_udes("en"),
    "cmin": lambda m: _cmin(m, 0x00030501),
    "cmin_no_y": lambda m: _cmin(m, 0x00000200),
    "cmex_v0_16": lambda m: _cmex(m, 0, 0x2F),
    "cmex_v0_32": lambda m: _cmex(m, 0, 0x3F),
    "cmex_v1": lambda m: _cmex(m, 1, 0x2B),
    "elng": lambda m: m.Box_elng("de-CH"),
    "itai": _itai,
    "gimi_content_id": lambda m: m.Box_gimi_content_id(
        "urn:uuid:01234567-89ab-cdef-0123-456789abcdef"),
}


def _bytes(box, writer):
    w = writer()
    box.write(w)
    return w.data()


def _fields(box):
    """A box's class name and public fields, children included."""
    return af.plain(box)


@pytest.mark.parametrize("name", sorted(CASES))
def test_box_matches_jax(name):
    jb = CASES[name](jmeta)
    raw = _bytes(jb, JWriter)
    (pb,) = pbox.read_all_boxes(raw)
    assert type(pb).__name__ == type(jb).__name__, name
    (jback,) = jbox.read_all_boxes(raw)
    assert _fields(pb) == _fields(jback)
    assert _bytes(pb, PWriter) == raw
    assert pb.dump() == jback.dump()
    # and the port's own box, made the same way, is the JAX one
    pown = CASES[name](pmeta)
    assert _bytes(pown, PWriter) == raw
    (jfrom,) = jbox.read_all_boxes(_bytes(pown, PWriter))
    assert _fields(jfrom) == _fields(jback)


@pytest.mark.parametrize("entities", ([7], [7, 8, 9]))
def test_ster_needs_two_images(entities):
    """A ster group of other than two images is refused alike (the
    property's parse error keeps the box as a Box_Error)."""
    raw = _bytes(jmeta.Box_EntityToGroup(5, entities), JWriter)
    raw = raw[:4] + b"ster" + raw[8:]
    (jb,) = jbox.read_all_boxes(raw)
    (pb,) = pbox.read_all_boxes(raw)
    assert type(jb).__name__ == type(pb).__name__ == "Box_Error"
    assert (pb.error.code, pb.error.subcode) == \
        (jb.error.code, jb.error.subcode)


def test_entity_group_limit_matches_jax():
    """More entities than max_size_entity_group (64) is a security
    error, raised by both packages alike."""
    raw = _bytes(jmeta.Box_altr(5, list(range(70))), JWriter)
    got = [af.call(m.read_all_boxes, raw) for m in (jbox, pbox)]
    assert got[0] == got[1] and got[0][0] == "HeifError"


def test_file_entity_groups_match_jax():
    blob = af.rich_file("jpeg")
    jc = japi.heif_context_alloc()
    japi.heif_context_read_from_memory(jc, blob)
    pc = papi.heif_context_alloc(device="cpu")
    papi.heif_context_read_from_memory(pc, blob)
    assert type(pc.file.grpl).__name__ == "Box_grpl"
    assert _fields(pc.file.grpl) == _fields(jc.file.grpl)
    primary = japi.heif_context_get_primary_image_ID(jc)
    for flt in (None, "ster", "altr", "pymd", "grpl"):
        for item in (0, primary, 999):
            got = [af.plain(api.heif_context_get_entity_groups(c, flt,
                                                               item))
                   for api, c in ((japi, jc), (papi, pc))]
            assert got[0] == got[1], (flt, item)
    assert len(papi.heif_context_get_entity_groups(pc)) == 3
    # the properties the API reads are the port's own boxes, not Box_other
    for iid in pc.file.item_ids:
        for p in pc.file.get_properties(iid):
            assert type(p).__name__ != "Box_other", p.box_type
