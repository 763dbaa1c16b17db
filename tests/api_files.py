"""Files and walks for the read-side API tests (tests/test_torch_api_*.py).

``rich_file(fmt)`` writes, with the JAX package's writer, a small file
whose primary image (``fmt``: hevc, av1, jpeg, avc, jpeg2000, vvc, unci)
carries alpha, a thumbnail, a depth image, a generic aux image, Exif,
XMP, a URI and a mime metadata item, pasp, udes, gimi, elng, clli, mdcv,
amve and ndwt properties, beside a second top-level image and a 2x2 grid
of ``fmt`` tiles, grouped by ``ster``, ``altr`` and ``pymd`` entity
groups.  ``walk(api, ctx)`` calls every read function of the C-named API
on a context read from such a file and returns the answers as plain
values (errors as their code and subcode), so that the JAX package's
answers and the port's compare with ``==``.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib

import numpy as np

from libheif_tpu import api as japi
from libheif_tpu.boxes.meta import (
    Box_amve, Box_auxC, Box_clli, Box_colr, Box_elng, Box_gimi_content_id,
    Box_grpl, Box_mdcv, Box_ndwt, Box_pasp, Box_altr, Box_ster, Box_udes)
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.image.pixel_image import (
    Channel, Chroma, Colorspace, PixelImage as JaxImage)
from libheif_tpu.option_types import EncodingOptions

FORMATS = ("hevc", "av1", "jpeg", "avc", "jpeg2000", "vvc", "unci")
EXIF = b"MM\x00*\x00\x00\x00\x08" + bytes(range(24))
XMP = b'<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF/></x:xmpmeta>'
DEPTH_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:depth"
OTHER_URN = "urn:example:aux:segmentation"
ICC = bytes(range(64)) * 2


def gradient(w, h, seed=0, alpha=False, mono=False):
    """A JAX PixelImage: smooth YCbCr 4:2:0 (or monochrome) planes with a
    seeded texture, and an Alpha plane where ``alpha``."""
    rng = np.random.default_rng(seed)
    y = (np.add.outer(np.arange(h) * 3, np.arange(w) * 2) +
         rng.integers(0, 24, (h, w))) % 256
    if mono:
        img = JaxImage(w, h, Colorspace.Monochrome, Chroma.Monochrome)
        img.set_plane(Channel.Y, y.astype(np.uint8), 8)
        return img
    img = JaxImage(w, h, Colorspace.YCbCr, Chroma.C420)
    img.set_plane(Channel.Y, y.astype(np.uint8), 8)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    img.set_plane(Channel.Cb, (96 + rng.integers(0, 40, (ch, cw)))
                  .astype(np.uint8), 8)
    img.set_plane(Channel.Cr, (140 + rng.integers(0, 40, (ch, cw)))
                  .astype(np.uint8), 8)
    if alpha:
        a = np.add.outer(np.arange(h) * 4, np.zeros(w, int)) % 256
        img.set_plane(Channel.Alpha, a.astype(np.uint8), 8)
    return img


def rich_file(fmt, w=64, h=48, alpha=True):
    ctx = JaxContext()
    ctx.new_file()
    opts = EncodingOptions(quality=80)
    primary = ctx.encode_image(gradient(w, h, 1, alpha=alpha), fmt, opts)
    ctx.set_primary_item(primary)
    second = ctx.encode_image(gradient(w, h, 2), fmt, opts)
    ctx.add_thumbnail(primary, gradient(w // 2, h // 2, 3), fmt, opts)
    tiles = [ctx.encode_image(gradient(32, 32, 10 + i), fmt, opts)
             for i in range(4)]
    for t in tiles:
        ctx.file.get_infe(t).hidden = True
    grid = ctx.add_grid_image(tiles, 64, 64, 2, 2)
    f = ctx.file
    depth = ctx.encode_image(gradient(w, h, 4, mono=True), "unci")
    f.add_property(depth, Box_auxC(DEPTH_URN), True)
    f.add_reference("auxl", depth, [primary])
    f.get_infe(depth).hidden = True
    other = ctx.encode_image(gradient(w, h, 5, mono=True), "unci")
    f.add_property(other, Box_auxC(OTHER_URN), True)
    f.add_reference("auxl", other, [primary])
    f.get_infe(other).hidden = True
    ctx.add_exif(primary, EXIF)
    ctx.add_xmp(primary, XMP)
    japi.heif_context_add_generic_uri_metadata(
        ctx, japi.heif_image_handle(ctx, primary), b"\x01\x02uri",
        "urn:example:meta")
    japi.heif_context_add_generic_metadata(
        ctx, japi.heif_image_handle(ctx, second), b'{"a": 1}', "mime",
        "application/json")
    f.add_property(primary, Box_pasp(4, 3), False)
    f.add_property(primary, Box_udes("en", "name", "a description",
                                     "tag1,tag2"), False)
    f.add_property(primary, Box_gimi_content_id("urn:uuid:content-1"),
                   False)
    f.add_property(primary, Box_elng("en-GB"), False)
    clli = Box_clli()
    clli.max_content_light_level, clli.max_pic_average_light_level = \
        1000, 400
    f.add_property(primary, clli, False)
    mdcv = Box_mdcv()
    mdcv.display_primaries = [(35400, 14600), (8500, 39850), (6550, 2300)]
    mdcv.white_point = (15635, 16450)
    mdcv.max_display_mastering_luminance = 10000000
    mdcv.min_display_mastering_luminance = 50
    f.add_property(primary, mdcv, False)
    amve = Box_amve()
    amve.ambient_illumination, amve.ambient_light_x = 314, 15635
    amve.ambient_light_y = 16450
    f.add_property(primary, amve, False)
    f.add_property(primary, Box_ndwt(203), False)
    icc = Box_colr()
    icc.colour_type, icc.icc_profile = "prof", ICC
    f.add_property(second, icc, False)
    japi.heif_item_set_item_name(ctx, second, "the second image")
    f.grpl = Box_grpl()
    f.meta.children.append(f.grpl)
    f.grpl.children += [Box_ster(100, [primary, second]),
                        Box_altr(101, [second, primary, grid])]
    japi.heif_context_add_pyramid_entity_group(ctx, [second, primary])
    return ctx.write()


# ------------------------------------------------------------------- walk

def plain(x):
    """``x`` as plain comparable values: boxes, dataclasses and other
    objects as their class name and public attributes."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return [type(x).__name__, plain(dataclasses.asdict(x))]
    if hasattr(x, "__dict__"):
        return [type(x).__name__, {k: plain(v) for k, v in vars(x).items()
                                   if not k.startswith("_")}]
    return repr(x)


def call(fn, *args, **kw):
    """The answer of ``fn`` as plain values, or ("HeifError", code,
    subcode) where it raised a HeifError of either package."""
    try:
        return plain(fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 -- either package's HeifError
        if type(e).__name__ != "HeifError":
            raise
        return ["HeifError", e.code.name, e.subcode.name]


HANDLE_READS = (
    "heif_image_handle_get_item_id", "heif_image_handle_is_primary_image",
    "heif_image_handle_get_width", "heif_image_handle_get_height",
    "heif_image_handle_get_ispe_width", "heif_image_handle_get_ispe_height",
    "heif_image_handle_has_alpha_channel",
    "heif_image_handle_is_premultiplied_alpha",
    "heif_image_handle_get_luma_bits_per_pixel",
    "heif_image_handle_get_chroma_bits_per_pixel",
    "heif_image_handle_get_preferred_decoding_colorspace",
    "heif_image_handle_get_number_of_thumbnails",
    "heif_image_handle_get_list_of_thumbnail_IDs",
    "heif_image_handle_has_depth_image",
    "heif_image_handle_get_number_of_depth_images",
    "heif_image_handle_get_list_of_depth_image_IDs",
    "heif_image_handle_get_pixel_aspect_ratio",
    "heif_image_handle_get_gimi_content_id",
    "heif_image_handle_get_number_of_cmpd_components",
    "heif_image_handle_has_gimi_component_content_ids",
    "heif_image_handle_get_color_profile_type",
    "heif_image_handle_get_raw_color_profile_size",
    "heif_image_handle_get_raw_color_profile",
    "heif_image_handle_get_nclx_color_profile",
    "heif_image_handle_get_number_of_color_profiles",
    "heif_image_handle_has_content_light_level",
    "heif_image_handle_get_content_light_level",
    "heif_image_handle_has_mastering_display_colour_volume",
    "heif_image_handle_get_mastering_display_colour_volume",
    "heif_image_handle_has_ambient_viewing_environment",
    "heif_image_handle_get_ambient_viewing_environment",
    "heif_image_handle_has_nominal_diffuse_white_luminance",
    "heif_image_handle_get_nominal_diffuse_white_luminance",
    "heif_image_handle_get_number_of_auxiliary_images",
    "heif_image_handle_get_list_of_auxiliary_image_IDs",
    "heif_image_handle_get_auxiliary_type",
    "heif_image_handle_get_number_of_metadata_blocks",
    "heif_image_handle_get_list_of_metadata_block_IDs",
    "heif_image_handle_get_exif", "heif_image_handle_get_xmp",
)


def _item_id(handle):
    return None if handle is None else handle.item_id


def walk_handle(api, ctx, iid):
    h = api.heif_context_get_image_handle(ctx, iid)
    out = {name: call(getattr(api, name), h) for name in HANDLE_READS}
    out["context_is_ctx"] = api.heif_image_handle_get_context(h) is ctx
    for flt in (1, 2, 3):
        out[f"aux_ids_{flt}"] = call(
            api.heif_image_handle_get_list_of_auxiliary_image_IDs, h, flt)
    # image_handle and aux_images both define these; the package holds
    # the aux_images ones
    ih, ax = api.image_handle, api.aux_images
    out["both_modules"] = [
        call(ih.heif_image_handle_has_alpha_channel, h),
        call(ih.heif_image_handle_has_depth_image, h),
        call(lambda: _item_id(ax.heif_image_handle_get_alpha_image_handle(h))),
        call(lambda: _item_id(ax.heif_image_handle_get_depth_image_handle(h)))]
    for tid in api.heif_image_handle_get_list_of_thumbnail_IDs(h) + [999]:
        out[f"thumb_{tid}"] = call(
            lambda: api.heif_image_handle_get_thumbnail(h, tid).item_id)
    for did in api.heif_image_handle_get_list_of_depth_image_IDs(h) + [999]:
        out[f"depth_{did}"] = call(
            lambda: ih.heif_image_handle_get_depth_image_handle(
                h, did).item_id)
        out[f"depth_info_{did}"] = call(
            api.heif_image_handle_get_depth_image_representation_info, h,
            did)
    for aid in api.heif_image_handle_get_list_of_auxiliary_image_IDs(h) + \
            [999]:
        out[f"aux_{aid}"] = call(
            lambda: api.heif_image_handle_get_auxiliary_image_handle(
                h, aid).item_id)
    for flt in (None, "Exif", "mime", "uri "):
        ids = api.heif_image_handle_get_list_of_metadata_block_IDs(h, flt)
        n = api.heif_image_handle_get_number_of_metadata_blocks(h, flt)
        out[f"metadata_{flt}"] = [ids, n]
    for mid in api.heif_image_handle_get_list_of_metadata_block_IDs(h) + \
            [999]:
        out[f"metadata_block_{mid}"] = [call(getattr(api, name), h, mid)
                                        for name in (
            "heif_image_handle_get_metadata_type",
            "heif_image_handle_get_metadata_content_type",
            "heif_image_handle_get_metadata_item_uri_type",
            "heif_image_handle_get_metadata_size",
            "heif_image_handle_get_metadata")]
    for idx in (0, 1):
        out[f"cmpd_{idx}"] = [call(getattr(api, name), h, idx) for name in (
            "heif_image_handle_get_cmpd_component_type",
            "heif_image_handle_get_cmpd_component_type_uri",
            "heif_image_handle_get_gimi_component_content_id")]
    mdcv = api.heif_image_handle_get_mastering_display_colour_volume(h)
    if mdcv is not None:
        out["mdcv_decoded"] = plain(
            api.heif_mastering_display_colour_volume_decode(mdcv))
    nclx = api.heif_image_handle_get_nclx_color_profile(h)
    if nclx is not None:
        out["kr_kb"] = call(api.heif_nclx_color_profile_get_kr_kb, nclx)
    return out


def walk(api, ctx, blob):
    """Every read function of the API on ``ctx`` (read from ``blob``)."""
    out = {}
    ids = api.heif_context_get_list_of_item_IDs(ctx)
    out["items"] = [ids, api.heif_context_get_number_of_items(ctx)]
    out["top"] = [api.heif_context_get_list_of_top_level_image_IDs(ctx),
                  api.heif_context_get_number_of_top_level_images(ctx)]
    out["primary"] = call(api.heif_context_get_primary_image_ID, ctx)
    out["primary_handle"] = call(
        lambda: api.heif_context_get_primary_image_handle(ctx).item_id)
    out["max_threads"] = api.heif_context_get_max_decoding_threads(ctx)
    out["limits"] = plain(api.heif_context_get_security_limits(ctx))
    for iid in ids + [999]:
        out[f"item_{iid}"] = [
            api.heif_context_is_top_level_image_ID(ctx, iid),
            *(call(getattr(api, name), ctx, iid) for name in (
                "heif_item_get_item_type", "heif_item_is_item_hidden",
                "heif_item_get_mime_item_content_type",
                "heif_item_get_mime_item_content_encoding",
                "heif_item_get_uri_item_uri_type", "heif_item_get_item_name",
                "heif_context_get_item_references",
                "heif_item_get_property_extended_language"))]
        data = call(api.heif_item_get_item_data, ctx, iid)
        out[f"item_data_{iid}"] = hashlib.sha256(data).hexdigest() \
            if isinstance(data, bytes) else data
    for iid in ids + [999]:
        if iid in ctx.items and ctx.items[iid].is_image_item or iid == 999:
            out[f"handle_{iid}"] = call(walk_handle, api, ctx, iid)
    for flt, item in ((None, 0), ("ster", 0), ("altr", 0), ("pymd", 0),
                      (None, out["primary"]), ("altr", 999)):
        if isinstance(item, list):
            item = 0
        out[f"groups_{flt}_{item}"] = call(
            api.heif_context_get_entity_groups, ctx, flt, item)
    with api.catching() as c:
        api.heif_context_get_image_handle(ctx, 999)
    out["catching"] = plain(c.error)
    out["brands"] = walk_brands(api, blob)
    out["dump"] = ctx.debug_dump_boxes()
    return out


def walk_brands(api, blob):
    out = {name: call(getattr(api, name), blob) for name in (
        "heif_read_main_brand", "heif_read_minor_version_brand",
        "heif_list_compatible_brands", "heif_get_file_mime_type",
        "heif_check_filetype", "heif_check_jpeg_filetype",
        "heif_main_brand", "heif_has_compatible_filetype")}
    for b in ("mif1", "heic", "avif", "miaf", "xxxx"):
        out[f"has_{b}"] = api.heif_has_compatible_brand(blob, b)
    out["fourcc"] = [api.heif_fourcc_to_brand("heic"),
                     api.heif_brand_to_fourcc("avif")]
    return out
