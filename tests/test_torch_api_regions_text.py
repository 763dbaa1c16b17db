"""The port's C-named API for regions and text items against the JAX
package's, on the CPU.

Every region kind (point, rectangle, ellipse, polygon, polyline, an
inline mask from bytes and from a mask image, a referenced mask) and
text items with an extended language go into a file through both
packages' API: the files are equal byte for byte, and every read (the
geometries, their coordinates transformed to the image, the masks as
images, the text and its parent) answers the same.  The port packs an
inline mask on the mask plane's device and unpacks it onto the region's
context's device.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.items import region_item as jregion  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.items import region_item as pregion  # noqa: E402

JRegionItem, PRegionItem = jregion.RegionItem, pregion.RegionItem

SIDES = ((japi, lambda im: im, {}), (papi, af.port_image, {"device": "cpu"}))


def mask_image(w, h, seed, image):
    from libheif_tpu.image.pixel_image import (Channel, Chroma, Colorspace,
                                               PixelImage)
    m = np.random.default_rng(seed).integers(0, 256, (h, w), dtype=np.uint8)
    img = PixelImage(w, h, Colorspace.Monochrome, Chroma.Monochrome)
    img.set_plane(Channel.Y, m, 8)
    return image(img)


def region_file(api, image, kw):
    ctx = api.heif_context_alloc(**kw)
    enc = api.heif_context_get_encoder_for_format(ctx, "unci")
    h = api.heif_context_encode_image(ctx, image(af.gradient(64, 48, 1)),
                                      enc)
    mski = api.heif_context_encode_image(
        ctx, mask_image(20, 10, 2, image),
        api.heif_context_get_encoder_for_format(ctx, "mski"))
    ri = api.heif_image_handle_add_region_item(h, 128, 96)
    api.heif_region_item_add_region_point(ri, 10, 20)
    api.heif_region_item_add_region_rectangle(ri, 4, 6, 30, 20)
    api.heif_region_item_add_region_ellipse(ri, 50, 40, 12, 7)
    api.heif_region_item_add_region_polygon(ri, [(1, 2), (30, 4), (9, 40)])
    api.heif_region_item_add_region_polyline(ri, [(0, 0), (127, 95)])
    api.heif_region_item_add_region_referenced_mask(ri, 7, 8, 20, 10,
                                                    mski.item_id)
    # neither writer records the mask item as the region item's 'mask'
    # reference (ROADMAP §3 D): the file gets it here
    ctx.file.add_reference("mask", ri.item_id, [mski.item_id])
    # an inline mask's bytes run to the end of the rgan payload: it comes
    # last in its region item (ROADMAP §3 D)
    api.heif_region_item_add_region_inline_mask_data(
        ri, 3, 4, 8, 2, b"\xa5\x0f")
    ri2 = api.heif_image_handle_add_region_item(h, 64, 48)
    api.heif_region_item_add_region_point(ri2, 63, 47)
    api.heif_region_item_add_region_inline_mask(
        ri2, 5, 6, 19, 13, mask_image(16, 11, 3, image))
    t1 = api.heif_image_handle_add_text_item(h, "text/plain", "a caption")
    t2 = api.heif_image_handle_add_text_item(h, "text/html", "<b>x</b>")
    return ctx, (t1, t2), api.heif_context_write(ctx)


@pytest.fixture(scope="module")
def files():
    out = [region_file(api, image, kw) for api, image, kw in SIDES]
    assert out[0][1] == out[1][1]
    return out


def region_reads(api, ctx):
    out = {}
    h = api.heif_context_get_primary_image_handle(ctx)
    out["n"] = api.heif_image_handle_get_number_of_region_items(h)
    ids = api.heif_image_handle_get_list_of_region_item_ids(h)
    out["ids"] = ids
    for rid in ids:
        ri = api.heif_context_get_region_item(ctx, rid)
        out[f"item_{rid}"] = [api.heif_region_item_get_id(ri),
                              api.heif_region_item_get_reference_size(ri),
                              api.heif_region_item_get_number_of_regions(ri)]
        for k, g in enumerate(api.heif_region_item_get_list_of_regions(ri)):
            t = api.heif_region_get_type(g)
            out[f"region_{rid}_{k}"] = [t] + [af.call(getattr(api, fn), g)
                                              for fn in (
                "heif_region_get_point", "heif_region_get_rectangle",
                "heif_region_get_ellipse",
                "heif_region_get_polygon_num_points",
                "heif_region_get_polygon_points",
                "heif_region_get_polyline_num_points",
                "heif_region_get_polyline_points",
                "heif_region_get_referenced_mask_ID",
                "heif_region_get_inline_mask_data_len",
                "heif_region_get_inline_mask_data",
                "heif_region_get_inline_mask")] + [af.call(
                    getattr(api, fn), g, ri, h) for fn in (
                "heif_region_get_point_transformed",
                "heif_region_get_rectangle_transformed",
                "heif_region_get_ellipse_transformed",
                "heif_region_get_polygon_points_transformed",
                "heif_region_get_polyline_points_transformed")]
        api.heif_region_item_release(ri)
    return out


def text_reads(api, ctx, ids):
    h = api.heif_context_get_primary_image_handle(ctx)
    out = [api.heif_image_handle_get_number_of_text_items(h),
           api.heif_image_handle_get_list_of_text_item_ids(h)]
    for tid in ids + [999]:
        out.append([af.call(lambda: api.heif_text_item_get_content(
            api.heif_context_get_text_item(ctx, tid))),
            af.call(lambda: api.heif_text_item_get_id(
                api.heif_context_get_text_item(ctx, tid))),
            af.call(api.heif_text_item_get_content_type, ctx, tid),
            af.call(api.heif_text_item_get_parent_image_id, ctx, tid)])
    return out


def test_region_and_text_files_equal_jax(files):
    assert files[0][2] == files[1][2]


@pytest.mark.parametrize("source", ("written", "read"))
def test_region_and_text_reads_match_jax(files, source):
    (jc, ids, blob), (pc, _, _) = files
    if source == "read":
        jc = japi.heif_context_alloc()
        japi.heif_context_read_from_memory(jc, blob)
        pc = papi.heif_context_alloc(device="cpu")
        papi.heif_context_read_from_memory(pc, blob)
    jr, pr = region_reads(japi, jc), region_reads(papi, pc)
    if source == "read":
        assert jr == pr
        assert jr["n"] == 2 and len([k for k in jr if
                                     k.startswith("region_")]) == 9
    t = [text_reads(api, c, list(ids)) for api, c in ((japi, jc),
                                                       (papi, pc))]
    assert t[0] == t[1]
    assert t[0][0] == 2 and t[0][2][0] == "a caption"


def test_text_item_extended_language_matches_jax():
    out = []
    for api, image, kw in SIDES:
        ctx = api.heif_context_alloc(**kw)
        h = api.heif_context_encode_image(
            ctx, image(af.gradient(8, 8, 1)),
            api.heif_context_get_encoder_for_format(ctx, "unci"))
        tid = api.heif_image_handle_add_text_item(h, "text/plain", "hi")
        item = api.heif_context_get_text_item(ctx, tid)
        got = [api.heif_text_item_get_property_extended_language(item)]
        api.heif_text_item_set_extended_language(item, "fr-CA")
        got.append(api.heif_text_item_get_property_extended_language(item))
        item.ctx = ctx
        api.heif_text_item_set_extended_language(item, "de")
        got.append(api.heif_text_item_get_property_extended_language(item))
        api.heif_text_item_release(item)
        got.append(api.heif_context_write(ctx))
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("w,h,mw,mh,dtype", (
    (16, 8, 16, 8, np.uint8), (19, 13, 16, 11, np.uint8),
    (5, 3, 9, 9, np.uint8), (12, 7, 12, 7, np.uint16)))
def test_inline_mask_from_image_matches_jax(w, h, mw, mh, dtype):
    """The mask bit of each sample is its bit 7 (& 0x80, as in JAX, for
    8- and 16-bit planes), packed MSB first as np.packbits packs; the
    region's bytes equal the JAX ones and unpack to 0/255."""
    from libheif_tpu.image.pixel_image import PixelImage
    rng = np.random.default_rng(w * h)
    m = rng.integers(0, 256 if dtype == np.uint8 else 65536, (mh, mw),
                     dtype=dtype)
    jimg = PixelImage(mw, mh, "monochrome", "monochrome")
    jimg.set_plane("Y", m, 8 if dtype == np.uint8 else 16)
    pimg = af.port_image(jimg)
    jg = japi.heif_region_item_add_region_inline_mask(
        JRegionItem(1, 64, 64), 1, 2, w, h, jimg)
    pg = papi.heif_region_item_add_region_inline_mask(
        PRegionItem(1, 64, 64), 1, 2, w, h, pimg)
    assert pg.mask_data == jg.mask_data
    jx, px = japi.heif_region_get_mask_image(jg), \
        papi.heif_region_get_mask_image(pg, device="cpu")
    assert px[:4] == jx[:4]
    af.assert_same_image(jx[4], px[4])
    assert px[4].plane("Y").device.type == "cpu"


def test_mask_images_match_jax(files):
    """heif_region_get_mask_image of every mask region of the read file:
    an inline mask unpacked on the region's context's device, a
    referenced mask decoded through the context (``region.ctx``, which the
    caller sets, as in JAX); a region of another kind raises as in JAX."""
    blob = files[0][2]
    got = []
    for api, _, kw in SIDES:
        ctx = api.heif_context_alloc(**kw)
        api.heif_context_read_from_memory(ctx, blob)
        h = api.heif_context_get_primary_image_handle(ctx)
        # the referenced mask's item id comes from the region item's
        # 'mask' reference, which get_region_items resolves
        regions = [g for ri in ctx.get_region_items(h.item_id)
                   for g in ri.regions]
        masks = [g for g in regions if g.kind.endswith("_mask")]
        out = []
        for g in masks:
            g.ctx = ctx
            out.append(api.heif_region_get_mask_image(g))
        out.append(af.call(api.heif_region_get_mask_image, regions[0]))
        got.append(out)
    for jx, px in zip(*got):
        if isinstance(jx, list):
            assert px == jx
            continue
        assert px[:4] == jx[:4]
        af.assert_same_image(jx[4], px[4])
        assert all(p.device.type == "cpu" for p in px[4].planes.values())
    assert len(got[0]) == 4


def test_mask_image_device_without_a_context():
    """An inline mask region with no context unpacks on ``device``, else
    the card (which raises here)."""
    g = papi.heif_region_item_add_region_inline_mask_data(
        PRegionItem(1, 8, 8), 0, 0, 4, 4, b"\xff\x00")
    out = papi.heif_region_get_mask_image(g, device="cpu")[4].plane("Y")
    assert out.tolist() == [[255] * 4, [255] * 4, [0] * 4, [0] * 4]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            papi.heif_region_get_mask_image(g)
    # a payload shorter than the region pads with zeros, as np.unpackbits
    short = papi.heif_region_item_add_region_inline_mask_data(
        PRegionItem(1, 8, 8), 0, 0, 8, 3, b"\x80")
    jshort = japi.heif_region_item_add_region_inline_mask_data(
        JRegionItem(1, 8, 8), 0, 0, 8, 3, b"\x80")
    af.assert_same_image(japi.heif_region_get_mask_image(jshort)[4],
                         papi.heif_region_get_mask_image(short,
                                                         device="cpu")[4])
