"""Files and walks for the read-side API tests (tests/test_torch_api_*.py).

``rich_file(fmt)`` writes, with the JAX package's writer, a small file
whose primary image (``fmt``: hevc, av1, jpeg, avc, jpeg2000, vvc, unci)
carries alpha, a thumbnail, a depth image, a generic aux image, Exif,
XMP, a URI and a mime metadata item, pasp, udes, gimi, elng, clli, mdcv,
amve, ndwt, cmin, cmex, prfr, taic and itai properties, two region items
(every geometry kind, an inline mask last) and two text items, beside a
second top-level image, a 2x2 grid of ``fmt`` tiles and a two-frame
``uncv`` track, grouped by ``ster``, ``altr`` and ``pymd`` entity
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
    Box_amve, Box_auxC, Box_clli, Box_cmex, Box_colr, Box_elng,
    Box_gimi_content_id,
    Box_grpl, Box_mdcv, Box_ndwt, Box_pasp, Box_altr, Box_ster, Box_udes)
from libheif_tpu.context import HeifContext as JaxContext
from libheif_tpu.image.pixel_image import (
    Channel, Chroma, Colorspace, PixelImage as JaxImage)
from libheif_tpu.option_types import EncodingOptions
from libheif_tpu.sequences.track import TrackOptions

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


def port_image(jimg, device="cpu"):
    """The port's PixelImage holding a JAX PixelImage's planes."""
    from libheif_tpu_torch.image.pixel_image import PixelImage
    import torch
    img = PixelImage(jimg.width, jimg.height, jimg.colorspace, jimg.chroma,
                     device=device)
    for ch in jimg.channels():
        img.set_plane(ch, torch.from_numpy(np.array(jimg.plane(ch))).to(
            device), jimg.bit_depth(ch))
    img.premultiplied_alpha = jimg.premultiplied_alpha
    return img


def image_planes(img):
    """{channel: (bit depth, host array)} of either package's image."""
    out = {}
    for ch in img.channels():
        p = img.plane(ch)
        p = p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)
        out[ch] = (img.bit_depth(ch), p)
    return out


def assert_same_image(jimg, pimg):
    """Equal size, colorspace, chroma, channels and samples."""
    assert (pimg.width, pimg.height, pimg.colorspace, pimg.chroma) == \
        (jimg.width, jimg.height, jimg.colorspace, jimg.chroma)
    jp, pp = image_planes(jimg), image_planes(pimg)
    assert list(pp) == list(jp)
    for ch, (bits, a) in jp.items():
        assert pp[ch][0] == bits, ch
        assert pp[ch][1].shape == a.shape and \
            np.array_equal(pp[ch][1].astype(np.int64), a.astype(np.int64)), ch


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
    ph = japi.heif_image_handle(ctx, primary)
    m = japi.heif_property_camera_intrinsic_matrix_alloc()
    japi.heif_property_camera_intrinsic_matrix_set_full(m, 900.5, 880.25,
                                                        31.5, 23.0, 0.5)
    japi.heif_item_add_property_camera_intrinsic_matrix(ctx, primary, m)
    cmex = Box_cmex()
    cmex.flags = 0x3F
    cmex.pos_x, cmex.pos_y, cmex.pos_z = 10, -20, 30
    cmex.quat = (1 << 29, -(1 << 28), 1 << 27)
    f.add_property(primary, cmex, False)
    japi.heif_image_handle_set_omaf_image_projection(
        ph, japi.heif_projection_format_equirectangular)
    japi.heif_item_set_property_tai_clock_info(
        ctx, primary, japi.heif_tai_clock_info_alloc())
    ts = japi.heif_tai_timestamp_packet_alloc()
    ts.tai_timestamp = 987654321
    japi.heif_item_set_property_tai_timestamp(ctx, second, ts)
    ri = japi.heif_image_handle_add_region_item(ph, 2 * w, 2 * h)
    japi.heif_region_item_add_region_point(ri, 3, 4)
    japi.heif_region_item_add_region_rectangle(ri, 5, 6, 20, 10)
    japi.heif_region_item_add_region_ellipse(ri, 30, 20, 9, 5)
    japi.heif_region_item_add_region_polygon(ri, [(1, 1), (40, 3), (7, 30)])
    japi.heif_region_item_add_region_polyline(ri, [(0, 0), (2 * w - 1, 5)])
    japi.heif_region_item_add_region_referenced_mask(ri, 2, 2, 8, 8, depth)
    japi.heif_region_item_add_region_inline_mask_data(ri, 1, 2, 8, 2,
                                                      b"\x5a\xf0")
    ri2 = japi.heif_image_handle_add_region_item(
        japi.heif_image_handle(ctx, second), w, h)
    japi.heif_region_item_add_region_point(ri2, w - 1, h - 1)
    japi.heif_image_handle_add_text_item(ph, "text/plain", "a caption")
    japi.heif_image_handle_add_text_item(
        japi.heif_image_handle(ctx, grid), "text/html", "<i>grid</i>")
    tw = ctx.add_visual_track(16, 16, fmt="unc", options=TrackOptions(
        timescale=10))
    for seed in (40, 41):
        tw.add_frame(gradient(16, 16, seed), duration=2)
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
    out.update(walk_handle_write_side(api, ctx, h))
    return out


HANDLE_WRITE_SIDE_READS = (
    "heif_image_handle_get_number_of_region_items",
    "heif_image_handle_get_list_of_region_item_ids",
    "heif_image_handle_get_number_of_text_items",
    "heif_image_handle_get_list_of_text_item_ids",
    "heif_image_handle_has_camera_intrinsic_matrix",
    "heif_image_handle_get_camera_intrinsic_matrix",
    "heif_image_handle_has_camera_extrinsic_matrix",
    "heif_image_handle_get_camera_extrinsic_matrix",
    "heif_image_handle_has_projection",
    "heif_image_handle_get_projection_format",
    "heif_image_handle_get_omaf_image_projection",
    "heif_image_handle_get_image_description",
    "heif_image_handle_get_number_of_components",
    "heif_image_handle_get_used_component_ids",
    "heif_image_handle_get_image_tiling")
REGION_READS = (
    "heif_region_get_type", "heif_region_get_point",
    "heif_region_get_rectangle", "heif_region_get_ellipse",
    "heif_region_get_polygon_num_points", "heif_region_get_polygon_points",
    "heif_region_get_polyline_num_points", "heif_region_get_polyline_points",
    "heif_region_get_referenced_mask_ID",
    "heif_region_get_inline_mask_data_len",
    "heif_region_get_inline_mask_data", "heif_region_get_inline_mask")
REGION_TRANSFORMED_READS = (
    "heif_region_get_point_transformed",
    "heif_region_get_rectangle_transformed",
    "heif_region_get_ellipse_transformed",
    "heif_region_get_polygon_points_transformed",
    "heif_region_get_polyline_points_transformed")


def walk_handle_write_side(api, ctx, h):
    """The read functions of the write side's modules on a handle:
    regions, text, camera matrices, projection, components."""
    out = {name: call(getattr(api, name), h)
           for name in HANDLE_WRITE_SIDE_READS}
    for cid in (0, 1, 2, 9):
        out[f"component_{cid}"] = [call(getattr(api, name), h, cid)
                                   for name in (
            "heif_image_handle_get_component_type",
            "heif_image_handle_get_component_datatype",
            "heif_image_handle_get_component_bits_per_pixel")]
    for ty in (0, 1):
        for tx in (0, 1):
            out[f"grid_tile_{tx}_{ty}"] = call(
                api.heif_image_handle_get_grid_image_tile_id, h, True, tx,
                ty)
    for rid in api.heif_image_handle_get_list_of_region_item_ids(h):
        ri = api.heif_context_get_region_item(ctx, rid)
        out[f"region_item_{rid}"] = [
            api.heif_region_item_get_id(ri),
            api.heif_region_item_get_reference_size(ri),
            api.heif_region_item_get_number_of_regions(ri)]
        for k, g in enumerate(api.heif_region_item_get_list_of_regions(ri)):
            out[f"region_{rid}_{k}"] = [
                call(getattr(api, name), g) for name in REGION_READS] + [
                call(getattr(api, name), g, ri, h)
                for name in REGION_TRANSFORMED_READS]
    for tid in api.heif_image_handle_get_list_of_text_item_ids(h):
        item = api.heif_context_get_text_item(ctx, tid)
        out[f"text_{tid}"] = [
            api.heif_text_item_get_id(item),
            api.heif_text_item_get_content(item),
            api.heif_text_item_get_content_type(ctx, tid),
            api.heif_text_item_get_parent_image_id(ctx, tid),
            api.heif_text_item_get_property_extended_language(item)]
    return out


ITEM_WRITE_SIDE_READS = (
    "heif_item_get_transformation_properties",
    "heif_item_get_properties_of_type",
    "heif_item_get_property_content_light_level",
    "heif_item_get_property_mastering_display",
    "heif_item_get_property_pixel_aspect_ratio",
    "heif_item_get_property_camera_intrinsic_matrix",
    "heif_item_get_property_camera_extrinsic_matrix",
    "heif_item_get_property_tai_clock_info",
    "heif_item_get_property_tai_timestamp")
TRACK_READS = (
    "heif_track_get_id", "heif_track_get_track_handler_type",
    "heif_track_get_timescale", "heif_track_get_number_of_repetitions",
    "heif_track_get_duration_in_media_units",
    "heif_track_get_number_of_output_samples",
    "heif_track_get_image_resolution", "heif_track_get_auxiliary_info_type",
    "heif_track_get_auxiliary_info_type_urn", "heif_track_has_alpha_channel",
    "heif_track_get_sample_entry_type_of_first_cluster",
    "heif_track_get_urim_sample_entry_uri_of_first_cluster",
    "heif_track_get_number_of_sample_aux_infos",
    "heif_track_get_sample_aux_info_types",
    "heif_track_get_gimi_track_content_id",
    "heif_track_get_tai_clock_info_of_first_cluster",
    "heif_track_get_number_of_track_reference_types",
    "heif_track_get_track_reference_types")


def walk_write_side(api, ctx):
    """The read functions of the write side's modules on the context:
    item properties, the pyramid groups, the tracks and their raw
    samples."""
    out = {}
    for iid in api.heif_context_get_list_of_item_IDs(ctx) + [999]:
        out[f"item_props_{iid}"] = [call(getattr(api, name), ctx, iid)
                                    for name in ITEM_WRITE_SIDE_READS]
        ids = call(api.heif_item_get_properties_of_type, ctx, iid)
        for pid in (ids if isinstance(ids, list) else []):
            out[f"item_prop_{iid}_{pid}"] = [
                call(getattr(api, name), ctx, iid, pid) for name in (
                    "heif_item_get_property_type",
                    "heif_item_get_property_raw_size",
                    "heif_item_get_property_raw_data",
                    "heif_item_get_property_uuid_type")]
    for g in api.heif_context_get_entity_groups(ctx, "pymd"):
        gid = g.entity_group_id
        out[f"pyramid_{gid}"] = call(
            api.heif_context_get_pyramid_entity_group_info, ctx, gid)
    out["sequence"] = [call(getattr(api, name), ctx) for name in (
        "heif_context_has_sequence", "heif_context_get_sequence_timescale",
        "heif_context_get_sequence_duration",
        "heif_context_number_of_sequence_tracks",
        "heif_context_get_track_ids")]
    for tid in api.heif_context_get_track_ids(ctx):
        t = api.heif_context_get_track(ctx, tid)
        out[f"track_{tid}"] = [call(getattr(api, name), t)
                               for name in TRACK_READS]
        raws = []
        while True:
            r = api.heif_track_get_next_raw_sequence_sample(t)
            if r is None:
                break
            raws.append([hashlib.sha256(
                api.heif_raw_sequence_sample_get_data(r)).hexdigest(),
                api.heif_raw_sequence_sample_get_duration(r),
                api.heif_raw_sequence_sample_has_tai_timestamp(r)])
        out[f"track_raw_{tid}"] = raws
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
    out.update(walk_write_side(api, ctx))
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
