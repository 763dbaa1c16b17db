"""HDR metadata in ``mini`` files, the port against the JAX package on
the CPU: a primary hvc1 or av01 item carrying a content light level
(``clli``), a mastering display colour volume (``mdcv``) or both, written
with ``set_write_mini_format``.  The port's ``write()`` must give the JAX
writer's bytes (the boxes go into the mini box's HDR fields), its
``debug_dump_boxes`` the JAX text, and the file must read back in both
packages with the same values.  The boxes themselves parse, write and
dump as the JAX boxes do, in the normal format too."""

from __future__ import annotations

import pytest
import torch

from libheif_tpu.boxes.meta import Box_clli as JBox_clli
from libheif_tpu.boxes.meta import Box_mdcv as JBox_mdcv
from libheif_tpu_torch.boxes import read_all_boxes
from libheif_tpu_torch.boxes.meta import Box_clli, Box_mdcv
from libheif_tpu_torch.file.mini_write import can_convert_to_mini
from tests.test_torch_item_write import Jax, Port, photo

CLLI = (1000, 400)
MDCV = ([(35400, 14600), (8500, 39850), (6550, 2300)], (15635, 16450),
        10_000_000, 50)


@pytest.fixture(autouse=True)
def _serial(monkeypatch):
    # the JAX native HEVC engine's pipeline is not safe under load
    # (ROADMAP §3); one torch thread a process under xdist
    monkeypatch.setenv("TPUHEIF_HEVC_PIPELINE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes(pk, hdr):
    clli_cls, mdcv_cls = (JBox_clli, JBox_mdcv) if pk is Jax else \
        (Box_clli, Box_mdcv)
    out = []
    if hdr in ("clli", "both"):
        out.append(clli_cls(*CLLI))
    if hdr in ("mdcv", "both"):
        m = mdcv_cls()
        (m.display_primaries, m.white_point,
         m.max_display_mastering_luminance,
         m.min_display_mastering_luminance) = MDCV
        out.append(m)
    return out


def case(pk, fmt, hdr, mini=True):
    ctx = pk.context()
    ctx.set_write_mini_format(mini)
    iid = ctx.encode_image(pk.image(photo(64, 48, 3)), fmt,
                           pk.Options(quality=60))
    for box in _boxes(pk, hdr):
        ctx.file.add_property(iid, box, False)
    return ctx


CASES = [(fmt, hdr) for fmt in ("hevc", "av1")
         for hdr in ("clli", "mdcv", "both")]


@pytest.mark.parametrize("fmt,hdr", CASES)
def test_mini_with_hdr_matches_jax(fmt, hdr):
    """The bytes, the dump and the values read back."""
    jctx, pctx = case(Jax, fmt, hdr), case(Port, fmt, hdr)
    assert can_convert_to_mini(pctx.file) == (True, "")
    want = jctx.write()
    got = pctx.write()
    assert got[4:12] == b"ftypmif3"
    assert got == want
    assert pctx.debug_dump_boxes() == jctx.debug_dump_boxes()
    j, p = Jax.reopen(got), Port.reopen(got)
    pm, jm = p.file.mini, j.file.mini
    assert pm.clli == jm.clli and pm.mdcv == jm.mdcv
    assert pm.clli == ({"max_cll": CLLI[0], "max_pall": CLLI[1]}
                       if hdr != "mdcv" else None)
    if hdr == "clli":
        assert pm.mdcv is None
    else:
        assert [tuple(x) for x in pm.mdcv["primaries"]] == MDCV[0]
        assert tuple(pm.mdcv["white_point"]) == MDCV[1]
        assert (pm.mdcv["max_lum"], pm.mdcv["min_lum"]) == MDCV[2:]
    assert pm.hdr_flag and jm.hdr_flag
    from tests.test_torch_sequences import assert_same_image
    assert_same_image(p.decode_image(), j.decode_image(), "mini image")


@pytest.mark.parametrize("hdr", ["clli", "mdcv", "both"])
def test_normal_format_boxes_match_jax(hdr):
    """Without mini the boxes are item properties: the same bytes, the
    same dump, and each box parses back to its values and writes the same
    bytes."""
    jctx, pctx = case(Jax, "hevc", hdr, False), case(Port, "hevc", hdr,
                                                     False)
    want = jctx.write()
    got = pctx.write()
    assert got == want
    assert pctx.debug_dump_boxes() == jctx.debug_dump_boxes()
    p = Port.reopen(got)
    iid = p.primary_item_id
    props = {b.box_type: b for b in p.file.get_properties(iid)}
    for box in _boxes(Port, hdr):
        back = props[box.box_type]
        assert type(back) is type(box)
        assert back.serialize() == box.serialize()
    if "clli" in props:
        assert (props["clli"].max_content_light_level,
                props["clli"].max_pic_average_light_level) == CLLI
    if "mdcv" in props:
        m = props["mdcv"]
        assert ([tuple(x) for x in m.display_primaries],
                tuple(m.white_point), m.max_display_mastering_luminance,
                m.min_display_mastering_luminance) == \
            (MDCV[0], MDCV[1], MDCV[2], MDCV[3])


def test_boxes_parse_write_dump_as_jax():
    """Each box alone: the JAX bytes, read back by the port's box reader
    to the same values and dump."""
    for pbox, jbox in zip(_boxes(Port, "both"), _boxes(Jax, "both")):
        data = pbox.serialize()
        assert data == jbox.serialize()
        back, = read_all_boxes(data)
        assert back.serialize() == data
        assert back.dump() == jbox.dump()
