"""The port's C-named API for properties, experimental calls, components,
image descriptions, OMAF and TAI against the JAX package's, on the CPU.

The same calls add properties (raw, udes, irot/imir/clap, clli, mdcv,
pasp, cmin, cmex, prfr, taic, itai, the unci sensor boxes splz, sbpm,
snuc, cloc) and a pyramid group to a file through both packages' API:
the files are equal byte for byte, and every read function answers the
same on both.  Components and the sensor descriptions ride on images:
the port's components are torch tensors of the twelve datatypes' torch
dtypes, and each answer equals the JAX one.
"""

import math

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import api_files as af  # noqa: E402
from libheif_tpu import api as japi  # noqa: E402
from libheif_tpu.boxes import meta as jmeta  # noqa: E402
from libheif_tpu.boxes import unc as junc  # noqa: E402
from libheif_tpu.image import image_description as jdesc  # noqa: E402
from libheif_tpu_torch import api as papi  # noqa: E402
from libheif_tpu_torch.boxes import meta as pmeta  # noqa: E402
from libheif_tpu_torch.boxes import unc as punc  # noqa: E402
from libheif_tpu_torch.image import image_description as pdesc  # noqa: E402

SIDES = ((japi, jmeta, junc, lambda im: im, {}),
         (papi, pmeta, punc, af.port_image, {"device": "cpu"}))


def sensor_boxes(unc):
    splz = unc.Box_splz()
    splz.component_ids, splz.pattern_width, splz.pattern_height = [0], 2, 1
    splz.polarization_angles = [45.0, float("nan")]
    sbpm = unc.Box_sbpm()
    sbpm.component_ids, sbpm.correction_applied = [0, 1], True
    sbpm.bad_rows, sbpm.bad_columns = [3], [5, 7]
    sbpm.bad_pixels = [unc.BadPixel(1, 2), unc.BadPixel(4, 6)]
    snuc = unc.Box_snuc()
    snuc.component_ids, snuc.nuc_is_applied = [0], False
    snuc.image_width, snuc.image_height = 2, 2
    snuc.nuc_gains, snuc.nuc_offsets = [1.0, 1.5, 2.0, 0.5], [0.0, 1, 2, 3]
    cloc = unc.Box_cloc()
    cloc.chroma_location = 2
    return [splz, sbpm, snuc, cloc]


def property_file(api, meta, unc, image, kw):
    ctx = api.heif_context_alloc(**kw)
    enc = api.heif_context_get_encoder_for_format(ctx, "unci")
    h = api.heif_context_encode_image(ctx, image(af.gradient(32, 24, 1)),
                                      enc)
    small = api.heif_context_encode_image(
        ctx, image(af.gradient(16, 12, 2)), enc)
    iid = h.item_id
    api.heif_item_add_raw_property(ctx, iid, "xtra", None, b"\x01\x02\x03",
                                   False)
    api.heif_item_add_property_user_description(
        ctx, iid, api.heif_property_user_description(
            "en", "name", "a description", "t1,t2"))
    api.heif_item_add_transform_property_rotation(ctx, iid, 90)
    api.heif_item_add_transform_property_mirror(ctx, iid, "horizontal")
    api.heif_item_add_transform_property_crop(ctx, iid, 2, 4, 6, 2, 32, 24)
    api.heif_item_add_property_content_light_level(ctx, iid, 1000, 400)
    mdcv = meta.Box_mdcv()
    mdcv.display_primaries = [(35400, 14600), (8500, 39850), (6550, 2300)]
    mdcv.white_point = (15635, 16450)
    mdcv.max_display_mastering_luminance = 10000000
    mdcv.min_display_mastering_luminance = 50
    api.heif_item_add_property_mastering_display(ctx, iid, mdcv)
    api.heif_item_add_property_pixel_aspect_ratio(ctx, iid, 4, 3)
    m = api.heif_property_camera_intrinsic_matrix_alloc()
    api.heif_property_camera_intrinsic_matrix_set_full(m, 1200.5, 1180.25,
                                                       16.5, 12.0, 0.125)
    api.heif_item_add_property_camera_intrinsic_matrix(ctx, iid, m)
    m2 = api.heif_property_camera_intrinsic_matrix_alloc()
    api.heif_property_camera_intrinsic_matrix_set_simple(m2, 16, 12, 800.0,
                                                         8.0, 6.0)
    api.heif_item_add_property_camera_intrinsic_matrix(ctx, small.item_id,
                                                       m2)
    cmex = meta.Box_cmex()
    cmex.flags = 0x3F
    cmex.pos_x, cmex.pos_y, cmex.pos_z = 10, -20, 30
    cmex.quat = (1 << 29, -(1 << 28), 1 << 27)
    cmex.world_coordinate_system_id = 7
    ctx.file.add_property(iid, cmex, False)
    cmex1 = meta.Box_cmex()
    cmex1.version, cmex1.flags = 1, 0x08
    cmex1.rotation = (90 << 16, 30 << 16, -(45 << 16))
    ctx.file.add_property(small.item_id, cmex1, False)
    api.heif_item_add_projection_format(
        ctx, iid, api.heif_projection_format_equirectangular)
    api.heif_image_handle_set_omaf_image_projection(
        small, api.heif_projection_format_cubemap)
    clock = api.heif_tai_clock_info_alloc()
    clock.time_uncertainty, clock.clock_resolution = 100, 10
    clock.clock_type = \
        api.heif_tai_clock_info_clock_type_can_sync_to_atomic_source
    api.heif_item_set_property_tai_clock_info(ctx, iid, clock)
    ts = api.heif_tai_timestamp_packet_alloc()
    ts.tai_timestamp, ts.synchronization_state = 123456789012345, True
    api.heif_item_set_property_tai_timestamp(ctx, iid, ts)
    for box in sensor_boxes(unc):
        ctx.file.add_property(small.item_id, box, False)
    gid = api.heif_context_add_pyramid_entity_group(
        ctx, [small.item_id, iid])
    return ctx, gid, api.heif_context_write(ctx)


@pytest.fixture(scope="module")
def files():
    out = [property_file(api, meta, unc, image, kw)
           for api, meta, unc, image, kw in SIDES]
    assert out[0][2] == out[1][2]
    assert out[0][1] == out[1][1]
    return out


def property_reads(api, ctx, gid):
    out = {}
    for iid in api.heif_context_get_list_of_item_IDs(ctx) + [999]:
        ids = af.call(api.heif_item_get_properties_of_type, ctx, iid)
        out[f"props_{iid}"] = ids
        out[f"xform_{iid}"] = af.call(
            api.heif_item_get_transformation_properties, ctx, iid)
        for t in (None, "udes", "pasp", "nope"):
            out[f"of_type_{iid}_{t}"] = af.call(
                api.heif_item_get_properties_of_type, ctx, iid, t)
        for pid in (ids if isinstance(ids, list) else []) + [0, 99]:
            out[f"prop_{iid}_{pid}"] = [af.call(getattr(api, fn), ctx, iid,
                                                pid) for fn in (
                "heif_item_get_property_type",
                "heif_item_get_property_raw_size",
                "heif_item_get_property_raw_data",
                "heif_item_get_property_uuid_type",
                "heif_item_get_property_transform_rotation_ccw",
                "heif_item_get_property_transform_mirror",
                "heif_item_get_property_user_description")] + [af.call(
                    api.heif_item_get_property_transform_crop_borders, ctx,
                    iid, pid, 32, 24)]
        out[f"typed_{iid}"] = [af.call(getattr(api, fn), ctx, iid) for fn in (
            "heif_item_get_property_content_light_level",
            "heif_item_get_property_mastering_display",
            "heif_item_get_property_pixel_aspect_ratio",
            "heif_item_get_property_camera_intrinsic_matrix",
            "heif_item_get_property_camera_extrinsic_matrix",
            "heif_item_get_property_tai_clock_info",
            "heif_item_get_property_tai_timestamp")]
        if iid in ctx.items and ctx.items[iid].is_image_item:
            h = api.heif_context_get_image_handle(ctx, iid)
            out[f"handle_{iid}"] = [af.call(getattr(api, fn), h) for fn in (
                "heif_image_handle_has_camera_intrinsic_matrix",
                "heif_image_handle_get_camera_intrinsic_matrix",
                "heif_image_handle_has_camera_extrinsic_matrix",
                "heif_image_handle_get_camera_extrinsic_matrix",
                "heif_image_handle_has_projection",
                "heif_image_handle_get_projection_format",
                "heif_image_handle_get_omaf_image_projection",
                "heif_image_handle_get_image_description",
                "heif_image_handle_get_number_of_components",
                "heif_image_handle_get_used_component_ids")]
            out[f"handle_components_{iid}"] = [
                af.call(getattr(api, fn), h, cid) for cid in (0, 1, 2, 9)
                for fn in ("heif_image_handle_get_component_type",
                           "heif_image_handle_get_component_datatype",
                           "heif_image_handle_get_component_bits_per_pixel")]
            try:
                ext = api.heif_image_handle_get_camera_extrinsic_matrix(h)
            except Exception:   # noqa: BLE001 -- none on this item
                continue
            out[f"extrinsic_{iid}"] = [af.plain(getattr(api, fn)(ext)) for fn
                                       in (
                "heif_property_camera_extrinsic_matrix_get_position_vector",
                "heif_property_camera_extrinsic_matrix_get_rotation_matrix",
                "heif_property_camera_extrinsic_matrix_get_world_coordinate_"
                "system_id",
                "heif_camera_extrinsic_matrix_get_rotation_matrix")]
            intr = api.heif_image_handle_get_camera_intrinsic_matrix(h)
            out[f"intrinsic_{iid}"] = [af.plain(getattr(api, fn)(intr))
                                       for fn in (
                "heif_property_camera_intrinsic_matrix_get_focal_length",
                "heif_property_camera_intrinsic_matrix_get_principal_point",
                "heif_property_camera_intrinsic_matrix_get_skew")]
    out["pyramid"] = af.call(api.heif_context_get_pyramid_entity_group_info,
                             ctx, gid)
    out["pyramid_none"] = af.call(
        api.heif_context_get_pyramid_entity_group_info, ctx, 12345)
    out["sensor_boxes"] = [af.plain(p) for iid in
                           api.heif_context_get_list_of_item_IDs(ctx)
                           for p in ctx.file.get_properties(iid)
                           if p.box_type in ("splz", "sbpm", "snuc", "cloc")]
    return out


def test_property_file_bytes_equal_jax(files):
    (jc, jgid, jblob), (pc, pgid, pblob) = files
    assert jblob == pblob and jgid == pgid


@pytest.mark.parametrize("source", ("written", "read"))
def test_property_reads_match_jax(files, source):
    (jc, gid, blob), (pc, _, _) = files
    if source == "read":
        jc = japi.heif_context_alloc()
        japi.heif_context_read_from_memory(jc, blob)
        pc = papi.heif_context_alloc(device="cpu")
        papi.heif_context_read_from_memory(pc, blob)
        # the sensor boxes parse as the port's own classes; prfr's parser
        # reads its full box header twice, so it parses as a Box_Error in
        # both packages (ROADMAP §3 D)
        kinds = {type(p).__name__ for iid in pc.file.item_ids
                 for p in pc.file.get_properties(iid)}
        assert {"Box_splz", "Box_sbpm", "Box_snuc", "Box_cloc",
                "Box_cmin", "Box_cmex"} <= kinds
        for c in (jc, pc):
            assert [type(p).__name__ for iid in c.file.item_ids
                    for p in c.file.get_properties(iid)
                    if getattr(p, "failed_type", "") == "prfr"] == \
                ["Box_Error"] * 2
    jr, pr = property_reads(japi, jc, gid), property_reads(papi, pc, gid)
    assert set(jr) == set(pr)
    for k in jr:
        assert _nan_safe(pr[k]) == _nan_safe(jr[k]), k
    assert jr[f"intrinsic_{japi.heif_context_get_primary_image_ID(jc)}"]


def _nan_safe(x):
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, list):
        return [_nan_safe(v) for v in x]
    if isinstance(x, dict):
        return {k: _nan_safe(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("name", ("Box_splz", "Box_sbpm", "Box_snuc",
                                  "Box_cloc"))
def test_sensor_boxes_write_and_parse_as_jax(name):
    """Each unci sensor box written alone: the JAX writer's bytes; parsed
    back by both packages: the same fields."""
    from libheif_tpu.boxes.box import read_all_boxes as jread
    from libheif_tpu.core.bitstream import ByteWriter as JW
    from libheif_tpu_torch.boxes.box import read_all_boxes as pread
    from libheif_tpu_torch.core.bitstream import ByteWriter as PW
    out = []
    for unc, W, read in ((junc, JW, jread), (punc, PW, pread)):
        box = next(b for b in sensor_boxes(unc) if type(b).__name__ == name)
        w = W()
        box.write(w)
        raw = w.data()
        out.append((raw, _nan_safe(af.plain(af.call(read, raw))),
                    box.dump_fields()))
    assert out[0] == out[1]


def test_sensor_box_limits_match_jax():
    """The security refusals of the sensor boxes' parsers."""
    from libheif_tpu.boxes.box import read_all_boxes as jread
    from libheif_tpu.core.bitstream import ByteWriter as JW
    from libheif_tpu_torch.boxes.box import read_all_boxes as pread
    bad = []
    for box in sensor_boxes(junc)[:3]:
        box.component_ids = list(range(300))
        w = JW()
        box.write(w)
        bad.append(w.data())
    sbpm = sensor_boxes(junc)[1]
    sbpm.bad_rows = list(range(1200))
    w = JW()
    sbpm.write(w)
    bad.append(w.data())
    for raw in bad:
        got = [af.call(read, raw) for read in (pread, jread)]
        assert got[0] == got[1] and got[0][0] == "HeifError"


# ----------------------------------------------------------- image level

def sensor_answers(api, unc, img):
    out = []
    cpat = unc.Box_cpat()
    cpat.pattern_width = cpat.pattern_height = 2
    cpat.components, cpat.component_gains = [0, 1, 1, 2], [1.0] * 4
    out.append(api.heif_image_get_bayer_pattern_size(img))
    api.heif_image_set_bayer_pattern(img, cpat)
    out.append(api.heif_image_get_bayer_pattern_size(img))
    out.append(af.plain(api.heif_image_get_bayer_pattern(img)))
    out.append([api.heif_image_has_chroma_location(img),
                api.heif_image_get_chroma_location(img)])
    out.append(af.call(api.heif_image_set_chroma_location, img, 7))
    api.heif_image_set_chroma_location(img, 3)
    out.append([api.heif_image_has_chroma_location(img),
                api.heif_image_get_chroma_location(img)])
    splz, sbpm, snuc, _ = sensor_boxes(unc)
    out.append(api.heif_polarization_angle_is_no_filter(
        api.heif_polarization_angle_no_filter()))
    api.heif_image_add_polarization_pattern(img, splz)
    out.append([api.heif_image_get_number_of_polarization_patterns(img),
                _nan_safe(api.heif_image_get_polarization_pattern_data(img,
                                                                       0)),
                api.heif_image_get_polarization_pattern_index_for_component(
                    img, 0),
                api.heif_image_get_polarization_pattern_index_for_component(
                    img, 5)])
    out.append(api.heif_image_get_polarization_pattern_info(img, 0)
               .pattern_width)
    api.heif_image_add_sensor_bad_pixels_map(img, sbpm)
    out.append([api.heif_image_get_number_of_sensor_bad_pixels_maps(img),
                api.heif_image_get_sensor_bad_pixels_map_data(img, 0),
                api.heif_image_get_sensor_bad_pixels_map_info(img, 0)
                .correction_applied])
    api.heif_image_add_sensor_nuc(img, snuc)
    out.append([api.heif_image_get_number_of_sensor_nucs(img),
                api.heif_image_get_sensor_nuc_data(img, 0),
                api.heif_image_get_sensor_nuc_info(img, 0).image_width])
    out.append([api.heif_image_add_bayer_component(img, "red"),
                api.heif_image_add_bayer_component(img, "green"),
                api.heif_image_get_used_component_ids(img),
                api.heif_image_get_component_type(img, 1)])
    return out


def test_sensor_descriptions_match_jax():
    got = [sensor_answers(api, unc, image(af.gradient(8, 8, 1)))
           for api, _, unc, image, _ in SIDES]
    assert got[0] == got[1]


COMPONENTS = (("unsigned", 8, "uint8", torch.uint8, np.uint8),
              ("unsigned", 16, "uint16", torch.uint16, np.uint16),
              ("unsigned", 32, "uint32", torch.uint32, np.uint32),
              ("unsigned", 64, "uint64", torch.uint64, np.uint64),
              ("signed", 8, "int8", torch.int8, np.int8),
              ("signed", 16, "int16", torch.int16, np.int16),
              ("signed", 32, "int32", torch.int32, np.int32),
              ("signed", 64, "int64", torch.int64, np.int64),
              ("float", 32, "float32", torch.float32, np.float32),
              ("float", 64, "float64", torch.float64, np.float64),
              ("complex", 32, "complex32", torch.complex64, np.complex64),
              ("complex", 64, "complex64", torch.complex128, np.complex128))


@pytest.mark.parametrize("datatype,bits,suffix,tdtype,ndtype", COMPONENTS)
def test_component_datatypes_match_jax(datatype, bits, suffix, tdtype,
                                       ndtype):
    """heif_image_add_component of each datatype: a zeroed torch tensor of
    the numpy dtype's torch counterpart on the image's device, returned
    itself by the generic and the typed getters; every other typed getter
    refuses it, as in JAX."""
    jimg = af.gradient(8, 8, 1)
    pimg = af.port_image(jimg)
    ja = japi.heif_image_add_component(jimg, 4, "custom", datatype, bits,
                                       5, 3)
    pa = papi.heif_image_add_component(pimg, 4, "custom", datatype, bits,
                                       5, 3)
    assert ja.dtype == ndtype
    assert pa.dtype == tdtype and pa.device.type == "cpu" and \
        tuple(pa.shape) == (3, 5)
    assert pa.cpu().numpy().dtype == ndtype and not pa.view(torch.uint8).any()
    for fn in ("heif_image_get_component", "heif_image_get_component_readonly",
               f"heif_image_get_component_{suffix}",
               f"heif_image_get_component_{suffix}_readonly"):
        assert getattr(papi, fn)(pimg, 4) is pa, fn
    for fn in ("heif_image_get_component_datatype",
               "heif_image_get_component_bits_per_pixel",
               "heif_image_get_component_width",
               "heif_image_get_component_height",
               "heif_image_get_component_type",
               "heif_image_get_component_channel",
               "heif_image_get_number_of_used_components",
               "heif_image_get_used_component_ids"):
        args = (4,) if "number" not in fn and "used" not in fn else ()
        assert getattr(papi, fn)(pimg, *args) == \
            getattr(japi, fn)(jimg, *args), fn
    for other in COMPONENTS:
        if other[2] == suffix:
            continue
        fn = f"heif_image_get_component_{other[2]}"
        assert af.call(getattr(papi, fn), pimg, 4) == \
            af.call(getattr(japi, fn), jimg, 4) == \
            ["HeifError", "Usage_error", "Unspecified"]


def test_component_errors_and_gimi_match_jax():
    out = []
    for api, _, _, image, _ in SIDES:
        img = image(af.gradient(8, 8, 1))
        out.append([af.call(api.heif_image_add_component, img, 0, "custom",
                            "complex", 16, 2, 2),
                    af.call(api.heif_image_get_component, img, 3)])
        api.heif_image_add_component(img, 2, "depth", "float", 32, 4, 4)
        api.heif_image_set_gimi_component_content_id(img, 2, "urn:x")
        out[-1].append(img._components[2].gimi_content_id)
    assert out[0] == out[1]


def test_component_device_follows_the_image():
    """The plane lies on ``device``, else the image's recorded device,
    else its planes'; an image on no device allocates on the card, which
    raises here."""
    from libheif_tpu_torch.image.pixel_image import PixelImage
    img = papi.heif_image_create(4, 4, "monochrome", "monochrome",
                                 device="cpu")
    assert papi.heif_image_add_component(img, 0, "custom", "unsigned", 8, 2,
                                         2).device.type == "cpu"
    planes_only = af.port_image(af.gradient(8, 8, 1))
    planes_only.device = None
    assert papi.heif_image_add_component(
        planes_only, 0, "custom", "unsigned", 8, 2, 2).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            papi.heif_image_add_component(PixelImage(4, 4), 0, "custom",
                                          "unsigned", 8, 2, 2)


def description_answers(api, desc_mod, image):
    d = api.heif_image_description_create()
    ids = [api.heif_image_description_add_component(d, "Y", "luma"),
           api.heif_image_description_add_component(d, "depth", "z",
                                                    "float", 32)]
    out = [ids, api.heif_image_description_get_number_of_components(d),
           af.call(api.heif_image_description_get_component, d, 5)]
    for i in ids:
        c = api.heif_image_description_get_component(d, i)
        out.append([getattr(api, f"heif_component_description_get_{f}")(c)
                    for f in ("id", "type", "name", "datatype", "bit_depth",
                              "channel")])
    img = image(af.gradient(8, 6, 1, alpha=True))
    out.append(af.plain(api.heif_image_get_image_description(img)))
    out.append(af.plain(desc_mod.ImageDescription.for_image(img)
                        .find_by_type("alpha")))
    out.append(af.plain(desc_mod.ImageDescription.for_image(img)
                        .find_by_id(9)))
    api.heif_image_set_image_description(img, d)
    out.append(af.plain(api.heif_image_get_image_description(img)))
    return out


def test_image_descriptions_match_jax():
    assert description_answers(papi, pdesc, af.port_image) == \
        description_answers(japi, jdesc, lambda im: im)


def tai_answers(api, image):
    c = api.heif_tai_clock_info_alloc()
    c.clock_resolution = 5
    c2 = api.heif_tai_clock_info_copy(None, c)
    c3 = api.heif_tai_clock_info_copy(api.heif_tai_clock_info_alloc(), c)
    t = api.heif_tai_timestamp_packet_alloc()
    t.tai_timestamp, t.timestamp_is_modified = 99, True
    t2 = api.heif_tai_timestamp_packet_copy(None, t)
    t3 = api.heif_tai_timestamp_packet_copy(
        api.heif_tai_timestamp_packet_alloc(), t)
    img = image(af.gradient(4, 4, 1))
    before = api.heif_image_get_tai_timestamp(img)
    api.heif_image_set_tai_timestamp(img, t)
    api.heif_tai_clock_info_release(c)
    api.heif_tai_timestamp_packet_release(t)
    return [af.plain(x) for x in (c2, c3, t2, t3, before,
                                  api.heif_image_get_tai_timestamp(img))] + [
        c2 is not c, api.heif_tai_clock_info_clock_type_unknown]


def test_tai_and_omaf_image_calls_match_jax():
    assert tai_answers(papi, af.port_image) == \
        tai_answers(japi, lambda im: im)
    out = []
    for api, _, _, image, _ in SIDES:
        img = image(af.gradient(4, 4, 1))
        before = api.heif_image_get_omaf_image_projection(img)
        api.heif_image_set_omaf_image_projection(img, 1)
        api.heif_image_handle_release_projection(None, None)
        out.append([before, api.heif_image_get_omaf_image_projection(img),
                    api.heif_projection_format_cubemap])
    assert out[0] == out[1]
