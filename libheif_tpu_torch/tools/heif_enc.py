"""heif-enc equivalent (reference: examples/heif_enc.cc, 2850 LoC);
counterpart of tools/heif_enc.py.

Encodes PNG / PPM / Y4M / JPEG / TIFF / WebP inputs to HEIF/AVIF with
the reference CLI's feature set: codec selection, quality/lossless,
thumbnails, alpha control, bit depth, nclx colour options, clli/pasp
properties, rotation/mirroring, tiling (--cut-tiles with grid / tili /
unci methods, --tiled-input), multi-resolution pyramids
(--add-pyramid-group), sequences (-S), benchmarking (--benchmark) and
encoder parameter introspection (-P / -p NAME=VALUE).  The inputs are
read on the host and go to the context's device (``--device``, CUDA by
default) once; conversion and encoding run there.

Usage: python -m libheif_tpu_torch.tools.heif_enc [options]
    [--device cpu] input.png -o output.heic
"""

import argparse
import os
import sys
import time

from . import add_device_argument

CODEC_CHOICES = ["hevc", "av1", "vvc", "avc", "jpeg", "j2k", "htj2k",
                 "unci", "mski"]


def build_parser():
    ap = argparse.ArgumentParser(
        prog="heif-enc",
        description="encode images/sequences to HEIF/AVIF "
                    "(ref: examples/heif_enc.cc)")
    ap.add_argument("inputs", nargs="*",
                    help=".png/.ppm/.y4m/.jpg/.tif/.webp input(s)")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-v", "--version", action="store_true")
    ap.add_argument("--verbose", action="count", default=0)
    # codec selection (ref long_options heif_enc.cc:345-420)
    ap.add_argument("-c", "--codec", default=None, choices=CODEC_CHOICES)
    ap.add_argument("-A", "--avif", action="store_true",
                    help="encode AV1 (AVIF)")
    ap.add_argument("--hevc", action="store_true")
    ap.add_argument("--vvc", action="store_true")
    ap.add_argument("--avc", action="store_true")
    ap.add_argument("--jpeg", action="store_true")
    ap.add_argument("--jpeg2000", action="store_true")
    ap.add_argument("--htj2k", action="store_true")
    ap.add_argument("-U", "--uncompressed", action="store_true")
    ap.add_argument("--unci-compression-method", default=None,
                    choices=["none", "deflate", "zlib", "brotli"])
    ap.add_argument("--list-encoders", action="store_true")
    ap.add_argument("-e", "--encoder", default=None,
                    help="select encoder by id name")
    ap.add_argument("-P", "--params", action="store_true",
                    help="show encoder parameters and exit")
    ap.add_argument("-p", dest="param", action="append", default=[],
                    metavar="NAME=VALUE", help="set encoder parameter")
    # quality
    ap.add_argument("-q", "--quality", type=int, default=50)
    ap.add_argument("-L", "--lossless", action="store_true")
    ap.add_argument("-b", "--bit-depth", type=int, default=8,
                    choices=[8, 10, 12])
    ap.add_argument("-E", "--even-size", action="store_true",
                    help="crop images to even width/height")
    ap.add_argument("-C", "--chroma-downsampling", default="average",
                    choices=["nearest-neighbor", "average", "sharp-yuv"])
    # alpha / thumbs
    ap.add_argument("--no-alpha", action="store_true")
    ap.add_argument("-t", "--thumb", type=int, default=0, metavar="SIZE",
                    help="add thumbnail with max size SIZE")
    ap.add_argument("--no-thumb-alpha", action="store_true")
    ap.add_argument("--premultiplied-alpha", action="store_true")
    # colour
    ap.add_argument("--color-profile", default=None,
                    choices=["srgb", "bt709", "bt601", "bt2020",
                             "p3", "identity"],
                    help="nclx preset (ref: heif_enc.cc:514-540)")
    ap.add_argument("--matrix_coefficients", type=int, default=None)
    ap.add_argument("--colour_primaries", type=int, default=None)
    ap.add_argument("--transfer_characteristic", type=int, default=None)
    ap.add_argument("--full_range_flag", type=int, default=None)
    ap.add_argument("--enable-two-colr-boxes", action="store_true")
    ap.add_argument("--clli", default=None, metavar="MAX_CLL,MAX_PALL")
    ap.add_argument("--pasp", default=None, metavar="H,V")
    # transforms
    ap.add_argument("--rotate-cw", type=int, default=0,
                    choices=[0, 90, 180, 270])
    ap.add_argument("--flip-h", action="store_true")
    ap.add_argument("--flip-v", action="store_true")
    # metadata
    ap.add_argument("--exif", default=None, metavar="FILE")
    ap.add_argument("--xmp", default=None, metavar="FILE")
    ap.add_argument("--enable-metadata-compression", default=None,
                    choices=["off", "zlib", "deflate", "brotli"])
    ap.add_argument("--pitm-description", default=None,
                    help="udes user description on the primary item")
    # tiling (ref: heif_enc.cc:391-398)
    ap.add_argument("--cut-tiles", type=int, default=0, metavar="SIZE",
                    help="cut input into SIZExSIZE tiles")
    ap.add_argument("--tiling-method", default="grid",
                    choices=["grid", "tili", "unci"])
    ap.add_argument("-T", "--tiled-input", action="store_true",
                    help="inputs are tiles named ...-Y-X.ext (or -X-Y "
                         "with --tiled-input-x-y)")
    ap.add_argument("--tiled-image-width", type=int, default=0)
    ap.add_argument("--tiled-image-height", type=int, default=0)
    ap.add_argument("--tiled-input-x-y", action="store_true")
    ap.add_argument("--add-pyramid-group", action="store_true")
    # sequences (ref: heif_enc.cc:398-421)
    ap.add_argument("-S", "--sequence", action="store_true",
                    help="encode a Y4M input as a video track")
    ap.add_argument("--fps", default=None, help="frame rate N or N/D")
    ap.add_argument("--timebase", type=int, default=0)
    ap.add_argument("--duration", type=int, default=0,
                    help="per-frame duration in timebase units")
    ap.add_argument("--repetitions", default=None,
                    help="number or 'infinite'")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--gop", default=None,
                    choices=["intra", "ipp", "ldb", "ibp", "bpyr"],
                    help="sequence GOP structure: all-intra (default), "
                         "IPPP, low-delay B, reordered IBP, or hierarchical "
                         "B pyramid with ctts "
                         "(hevc; avc supports ipp)")
    ap.add_argument("--vmt-metadata", default=None, metavar="FILE",
                    help="encode metadata track from a WebVMT file "
                         "(ref: heif_enc.cc --vmt-metadata)")
    ap.add_argument("--vmt-uri", default="vmt:metadata",
                    help="uri for the VMT metadata track")
    ap.add_argument("--vmt-binary", action="store_true",
                    help="VMT cue bodies are hex binary data")
    ap.add_argument("--sai-data-file", default=None, metavar="FILE",
                    help="per-frame SAI data (gimi ids / TAI "
                         "timestamps; ref: heif_enc.cc "
                         "--sai-data-file)")
    # misc
    ap.add_argument("--mini", action="store_true",
                    help="write compact 'mini' format when possible")
    ap.add_argument("--benchmark", action="store_true",
                    help="measure encode time and PSNR "
                         "(ref: examples/benchmark.cc)")
    add_device_argument(ap)
    return ap


def pick_codec(args):
    if args.codec:
        return args.codec
    for flag, name in [("avif", "av1"), ("hevc", "hevc"), ("vvc", "vvc"),
                       ("avc", "avc"), ("jpeg", "jpeg"),
                       ("jpeg2000", "j2k"), ("htj2k", "htj2k"),
                       ("uncompressed", "unci")]:
        if getattr(args, flag):
            return name
    return "hevc"


def ycbcr_frame(y, u, v, device):
    """A YCbCr PixelImage of one Y4M frame's host planes on ``device``
    (one copy a plane)."""
    import torch
    from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
    h, w = y.shape
    chroma = Chroma.C420 if u.shape[0] < h else \
        (Chroma.C422 if u.shape[1] < w else Chroma.C444)
    img = PixelImage(w, h, Colorspace.YCbCr, chroma, device=device)
    for ch, p in ((Channel.Y, y), (Channel.Cb, u), (Channel.Cr, v)):
        img.set_plane(ch, torch.from_numpy(p.copy()).to(device), 8)
    return img


def load_input(path, device):
    """Read any supported input file into a PixelImage (RGB or YCbCr)
    whose planes lie on ``device``."""
    import numpy as np
    from .. import io as hio
    from ..image.pixel_image import PixelImage, Channel, Colorspace, Chroma
    from ..io.host import planes_on_device
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        data = f.read()

    def rgb_to_image(arr, bits=8):
        if arr.ndim == 2:
            arr = np.dstack([arr] * 3)
        h, w = arr.shape[:2]
        img = PixelImage(w, h, Colorspace.RGB, Chroma.C444, device=device)
        names = (Channel.R, Channel.G, Channel.B, Channel.Alpha)
        for ch, p in zip(names, planes_on_device(arr[:, :, :4], device)):
            img.set_plane(ch, p, bits)
        return img

    if ext == ".y4m":
        return ycbcr_frame(*hio.read_y4m(data)["frames"][0], device)
    if ext in (".jpg", ".jpeg"):
        return hio.read_jpeg(data, device)
    if ext in (".tif", ".tiff"):
        return hio.read_tiff(data, device)
    if ext == ".webp":
        return hio.read_webp(data, device)
    if ext == ".png":
        arr, bd = hio.read_png(data)
        return rgb_to_image(arr, bd)
    return rgb_to_image(hio.read_ppm(data))


def apply_param(enc_params, spec):
    if "=" not in spec:
        raise SystemExit(f"bad -p argument {spec!r}, want NAME=VALUE")
    name, value = spec.split("=", 1)
    enc_params[name] = value
    return name, value


def psnr(a, b):
    import numpy as np
    from ..io.host import host_array
    a = host_array(a).astype(np.float64)
    b = host_array(b).astype(np.float64)
    mse = ((a - b) ** 2).mean()
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 * 255.0 / mse)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .. import __version__
    from .. import io as hio
    from ..api import HeifContext, EncodingOptions
    from ..api import encoding as enc_api
    from ..api import properties as prop_api
    from ..api import experimental as exp_api
    from ..color import (NclxProfile, convert_image,
                         ColorConversionOptions)
    from ..image.pixel_image import Channel, Colorspace, Chroma
    from ..sequences.track import TrackOptions

    if args.version:
        print(f"heif-enc (libheif_tpu_torch {__version__})")
        return 0

    codec = pick_codec(args)
    if args.cut_tiles and args.tiling_method == "unci":
        codec = "unci"   # unci tiling stores raw planes; skip YCbCr conv

    if args.list_encoders:
        for d in enc_api.heif_get_encoder_descriptors():
            name = enc_api.heif_encoder_descriptor_get_name(d)
            idn = enc_api.heif_encoder_descriptor_get_id_name(d)
            fmt = enc_api.heif_encoder_descriptor_get_compression_format(d)
            print(f"{fmt:8s} {idn:16s} {name}")
        return 0

    ctx = HeifContext(device=args.device)
    if args.params:
        encoder = enc_api.heif_context_get_encoder_for_format(ctx, codec)
        for p in enc_api.heif_encoder_list_parameters(encoder):
            line = f"  {p['name']} ({p['type']})"
            if "minimum" in p:
                line += f" [{p['minimum']};{p['maximum']}]"
            if p.get("valid_values"):
                line += " {" + ",".join(map(str, p["valid_values"])) + "}"
            if "default" in p:
                line += f" default={p['default']}"
            print(line)
        return 0

    if not args.inputs:
        print("error: no input files", file=sys.stderr)
        return 1

    out = args.output or os.path.splitext(args.inputs[0])[0] + \
        (".avif" if codec == "av1" else ".heic")

    options = EncodingOptions()
    options.quality = args.quality
    options.lossless = args.lossless
    options.save_alpha_channel = not args.no_alpha
    options.save_two_colr_boxes_when_ICC_and_nclx_available = \
        args.enable_two_colr_boxes
    if args.unci_compression_method and \
            args.unci_compression_method != "none":
        options.compression = {"deflate": "defl", "zlib": "zlib",
                               "brotli": "brot"}[
            args.unci_compression_method]

    # nclx output profile (ref: heif_enc.cc:514-540 presets)
    presets = {"srgb": (1, 13, 6, True), "bt709": (1, 1, 1, False),
               "bt601": (6, 6, 6, False), "bt2020": (9, 14, 9, False),
               "p3": (12, 13, 6, True), "identity": (2, 2, 0, True)}
    nclx = None
    if args.color_profile:
        cp, tc, mc, fr = presets[args.color_profile]
        nclx = NclxProfile(cp, tc, mc, fr)
    if any(v is not None for v in (args.matrix_coefficients,
                                   args.colour_primaries,
                                   args.transfer_characteristic,
                                   args.full_range_flag)):
        nclx = nclx or NclxProfile()
        if args.colour_primaries is not None:
            nclx.color_primaries = args.colour_primaries
        if args.transfer_characteristic is not None:
            nclx.transfer_characteristics = args.transfer_characteristic
        if args.matrix_coefficients is not None:
            nclx.matrix_coefficients = args.matrix_coefficients
        if args.full_range_flag is not None:
            nclx.full_range_flag = bool(args.full_range_flag)
    if nclx is not None:
        options.output_nclx = nclx

    enc_params = {}
    for spec in args.param:
        apply_param(enc_params, spec)
    if enc_params:
        encoder = enc_api.heif_context_get_encoder_for_format(ctx, codec)
        for name, value in enc_params.items():
            enc_api.heif_encoder_set_parameter(encoder, name, value)
        options = enc_api._options_from_encoder(encoder, options)

    conv_opts = ColorConversionOptions(
        chroma_downsampling=args.chroma_downsampling)

    def prepare(img):
        """even-size crop, premultiplied flag, codec colour conversion."""
        if args.even_size and (img.width % 2 or img.height % 2):
            img = img.crop(0, 0, img.width & ~1, img.height & ~1)
        if args.premultiplied_alpha and img.has_channel(Channel.Alpha):
            img.premultiplied_alpha = True
        if codec in ("hevc", "av1", "vvc", "avc", "jpeg") and \
                img.colorspace != Colorspace.YCbCr:
            mc = nclx.matrix_coefficients if nclx else 6
            fr = nclx.full_range_flag if nclx else True
            img = convert_image(img, Colorspace.YCbCr, Chroma.C420,
                                target_bits=args.bit_depth,
                                target_matrix=mc, target_full_range=fr,
                                options=conv_opts, device=ctx.device)
        elif args.bit_depth > 8 and img.bit_depth(
                img.channels()[0]) != args.bit_depth:
            img = convert_image(img, img.colorspace, img.chroma,
                                target_bits=args.bit_depth,
                                options=conv_opts, device=ctx.device)
        return img

    def add_transform_props(item_id):
        if args.rotate_cw:
            ccw = (360 - args.rotate_cw) % 360
            prop_api.heif_item_add_transform_property_rotation(
                ctx, item_id, ccw)
        if args.flip_h:
            prop_api.heif_item_add_transform_property_mirror(
                ctx, item_id, "vertical")
        if args.flip_v:
            prop_api.heif_item_add_transform_property_mirror(
                ctx, item_id, "horizontal")

    def add_extra_props(item_id):
        add_transform_props(item_id)
        if args.clli:
            cll, pall = (int(x) for x in args.clli.split(","))
            prop_api.heif_item_add_property_content_light_level(
                ctx, item_id, cll, pall)
        if args.pasp:
            hsp, vsp = (int(x) for x in args.pasp.split(","))
            prop_api.heif_item_add_property_pixel_aspect_ratio(
                ctx, item_id, hsp, vsp)

    def cut_tile(img, tx, ty, tile_size):
        """Crop one tile, edge-padding partial right/bottom tiles (the
        grid output size crops the padding back, as in the reference)."""
        w = min(tile_size, img.width - tx * tile_size)
        h = min(tile_size, img.height - ty * tile_size)
        tile = img.crop(tx * tile_size, ty * tile_size, w, h)
        if w != tile_size or h != tile_size:
            tile = tile.extend(tile_size, tile_size, mode="edge")
        return tile

    def encode_tiled(img, tile_size, method):
        """--cut-tiles: split into tiles, encode via grid/tili/unci."""
        cols = (img.width + tile_size - 1) // tile_size
        rows = (img.height + tile_size - 1) // tile_size
        if method == "unci":
            if img.width % tile_size or img.height % tile_size:
                raise SystemExit(
                    "--tiling-method unci requires the image size to be "
                    "a multiple of the tile size (ISO 23001-17 tiles "
                    "partition the image exactly)")
            topt = EncodingOptions(**vars(options))
            topt.tile_cols = cols
            topt.tile_rows = rows
            return ctx.encode_image(img, fmt="unci", options=topt)
        if method == "tili":
            tid = ctx.add_tiled_image(img.width, img.height,
                                      tile_size, tile_size, fmt=codec)
            for ty in range(rows):
                for tx in range(cols):
                    ctx.add_image_tile_to_tiled(
                        tid, tx, ty, cut_tile(img, tx, ty, tile_size),
                        options)
            return tid
        tile_ids = []
        topt = EncodingOptions(**vars(options))
        topt.save_alpha_channel = False
        for ty in range(rows):
            for tx in range(cols):
                tile_ids.append(ctx.encode_image(
                    cut_tile(img, tx, ty, tile_size), fmt=codec,
                    options=topt))
        return ctx.add_grid_image(tile_ids, img.width, img.height,
                                  rows, cols)

    def add_thumbnail_for(item_id, img):
        if not args.thumb:
            return
        if max(img.width, img.height) <= args.thumb:
            return
        scale = args.thumb / max(img.width, img.height)
        tw = max(2, int(img.width * scale)) & ~1
        th = max(2, int(img.height * scale)) & ~1
        thumb = img.scale_nearest(tw, th)
        topt = EncodingOptions(**vars(options))
        topt.save_alpha_channel = (not args.no_thumb_alpha and
                                   not args.no_alpha)
        tfmt = codec if codec not in ("mski",) else "unci"
        ctx.add_thumbnail(item_id, thumb, fmt=tfmt, options=topt)

    # ---- sequence mode -------------------------------------------------
    if args.sequence:
        with open(args.inputs[0], "rb") as f:
            r = hio.read_y4m(f.read())
        fps_n, fps_d = r["fps"]
        if args.fps:
            if "/" in args.fps:
                fps_n, fps_d = (int(x) for x in args.fps.split("/"))
            else:
                fps_n, fps_d = int(args.fps), 1
        timescale = args.timebase or fps_n
        sai = None
        track_opts = None
        if args.gop and args.gop != "intra":
            track_opts = TrackOptions(timescale=timescale,
                                      inter_frames=args.gop)
        if args.sai_data_file:
            from .sai_datafile import SAIDatafile
            sai = SAIDatafile().load(args.sai_data_file)
            if track_opts is None:
                track_opts = TrackOptions(timescale=timescale)
            if sai.tai_clock_info is not None:
                track_opts.with_tai_timestamps = 2
                track_opts.tai_clock_info = sai.tai_clock_info
            if any(g is not None for g in sai.gimi_content_ids):
                track_opts.with_gimi_content_ids = 2
        tw = ctx.add_visual_track(r["width"], r["height"], fmt=codec,
                                  timescale=timescale,
                                  options=track_opts)
        frames = r["frames"]
        if args.max_frames:
            frames = frames[:args.max_frames]
        dur = args.duration or fps_d
        for fidx, (y, u, v) in enumerate(frames):
            fr = ycbcr_frame(y, u, v, ctx.device)
            if sai is not None:
                sai.apply_to_image(fr, fidx)
            tw.add_frame(fr, duration=dur)
        if args.vmt_metadata:
            from .vmt import encode_vmt_metadata_track
            encode_vmt_metadata_track(ctx, tw, args.vmt_metadata,
                                      args.vmt_uri,
                                      binary=args.vmt_binary)
        if args.repetitions:
            n = 0xFFFFFFFF if args.repetitions == "infinite" \
                else int(args.repetitions)
            ctx.set_number_of_sequence_repetitions(n)
        ctx.write_to_file(out)
        print(f"wrote {out}")
        return 0

    # ---- tiled input: many files, one image ----------------------------
    if args.tiled_input:
        tiles = {}
        for path in args.inputs:
            stem = os.path.splitext(os.path.basename(path))[0]
            parts = stem.replace("_", "-").split("-")
            try:
                a, b = int(parts[-2]), int(parts[-1])
            except (ValueError, IndexError):
                print(f"cannot parse tile position from {path!r}",
                      file=sys.stderr)
                return 1
            ty, tx = (b, a) if args.tiled_input_x_y else (a, b)
            tiles[(ty, tx)] = path
        rows = max(t[0] for t in tiles) + 1
        cols = max(t[1] for t in tiles) + 1
        first = prepare(load_input(tiles[(0, 0)], ctx.device))
        tw_, th_ = first.width, first.height
        iw = args.tiled_image_width or tw_ * cols
        ih = args.tiled_image_height or th_ * rows
        if args.tiling_method == "tili":
            tid = ctx.add_tiled_image(iw, ih, tw_, th_, fmt=codec)
            for (ty, tx), path in sorted(tiles.items()):
                img = prepare(load_input(path, ctx.device))
                ctx.add_image_tile_to_tiled(tid, tx, ty, img, options)
        else:
            topt = EncodingOptions(**vars(options))
            topt.save_alpha_channel = False
            ids = []
            for (ty, tx) in sorted(tiles):
                img = prepare(load_input(tiles[(ty, tx)], ctx.device))
                ids.append(ctx.encode_image(img, fmt=codec, options=topt))
            tid = ctx.add_grid_image(ids, iw, ih, rows, cols)
        ctx.set_primary_item(tid)
        add_extra_props(tid)
        if args.pitm_description:
            prop_api.heif_item_add_property_user_description(
                ctx, tid, prop_api.heif_property_user_description(
                    description=args.pitm_description))
        ctx.write_to_file(out)
        print(f"wrote {out}")
        return 0

    # ---- normal mode: encode each input --------------------------------
    primary = None
    for path in args.inputs:
        img = prepare(load_input(path, ctx.device))
        t0 = time.time()
        if args.cut_tiles:
            item_id = encode_tiled(img, args.cut_tiles,
                                   args.tiling_method)
        else:
            item_id = ctx.encode_image(img, fmt=codec, options=options)
        enc_time = time.time() - t0
        if args.benchmark:
            # decode back BEFORE transform properties are attached so the
            # round-trip is comparable to the input (ref: benchmark.cc)
            dec = ctx.decode_image(item_id)
            vals = {}
            for ch in (Channel.Y, Channel.R):
                if img.has_channel(ch) and dec.has_channel(ch):
                    vals[ch] = psnr(img.plane(ch), dec.plane(ch))
            ps = ", ".join(f"PSNR({c})={v:.2f} dB"
                           for c, v in vals.items())
            print(f"{path}: encode {enc_time*1000:.1f} ms, {ps}")
        add_extra_props(item_id)
        add_thumbnail_for(item_id, img)
        if args.exif:
            with open(args.exif, "rb") as f:
                ctx.add_exif(item_id, f.read())
        if args.xmp:
            with open(args.xmp, "rb") as f:
                ctx.add_xmp(item_id, f.read())
        if primary is None:
            primary = item_id

        if args.add_pyramid_group:
            layers = [item_id]
            cur = img
            while min(cur.width, cur.height) >= 128:
                cur = cur.scale_nearest(max(2, cur.width // 2) & ~1,
                                        max(2, cur.height // 2) & ~1)
                if args.cut_tiles and \
                        max(cur.width, cur.height) > args.cut_tiles:
                    lid = encode_tiled(cur, args.cut_tiles,
                                       args.tiling_method)
                else:
                    lid = ctx.encode_image(cur, fmt=codec,
                                           options=options)
                ctx.get_item(lid)
                infe = ctx.file.get_infe(lid)
                infe.hidden = True
                layers.append(lid)
            layers.reverse()   # smallest → largest, per pymd ordering
            exp_api.heif_context_add_pyramid_entity_group(ctx, layers)

    if primary is not None:
        ctx.set_primary_item(primary)
        if args.pitm_description:
            prop_api.heif_item_add_property_user_description(
                ctx, primary, prop_api.heif_property_user_description(
                    description=args.pitm_description))
    if args.mini:
        ctx.set_write_mini_format(True)
    ctx.write_to_file(out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
