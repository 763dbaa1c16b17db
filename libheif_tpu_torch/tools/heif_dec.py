"""heif-dec equivalent (reference: examples/heif_dec.cc, 1141 LoC);
counterpart of tools/heif_dec.py.

Decode HEIF/AVIF to PNG / PPM / Y4M / JPEG / TIFF / WebP (chosen by
output extension) with the reference CLI's feature set: strict mode,
decoder selection, aux-image / Exif / XMP extraction, per-tile output
(--tiles), sequence decode (--sequence), chroma-upsampling choice,
security-limit override and MIME-item extraction.  Decoding and colour
conversion run on the context's device (``--device``, CUDA by default);
each output crosses to the host once, in the file writer.

Usage: python -m libheif_tpu_torch.tools.heif_dec [options]
    [--device cpu] input.heic [output.png]
"""

import argparse
import os
import sys

from . import add_device_argument, rgb_array


def build_parser():
    ap = argparse.ArgumentParser(
        prog="heif-dec",
        description="decode HEIF/AVIF images "
                    "(ref: examples/heif_dec.cc)")
    ap.add_argument("input", nargs="?")
    ap.add_argument("output", nargs="?", default=None,
                    help="output file (.png/.ppm/.y4m/.jpg/.tif/.webp);"
                         " default <input>.png")
    ap.add_argument("-v", "--version", action="store_true")
    ap.add_argument("-q", "--quality", type=int, default=None,
                    help="output quality for lossy targets (jpeg/webp)")
    ap.add_argument("-s", "--strict", action="store_true",
                    help="fail on missing grid tiles etc.")
    ap.add_argument("-d", "--decoder", default=None,
                    help="use the decoder with this id")
    ap.add_argument("--list-decoders", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="decode all top-level images (suffix -N)")
    ap.add_argument("--with-aux", action="store_true",
                    help="also write auxiliary images")
    ap.add_argument("--with-exif", action="store_true",
                    help="also write Exif metadata to <out>.exif")
    ap.add_argument("--with-xmp", action="store_true",
                    help="also write XMP metadata to <out>.xmp")
    ap.add_argument("--skip-exif-offset", action="store_true",
                    help="strip the 4-byte TIFF-offset prefix from the "
                         "written Exif")
    ap.add_argument("--no-colons", action="store_true",
                    help="replace ':' in derived filenames (Windows)")
    ap.add_argument("--tiles", action="store_true",
                    help="write each tile as a separate image")
    ap.add_argument("--sequence", action="store_true",
                    help="decode the sequence track instead of images")
    ap.add_argument("-C", "--chroma-upsampling", default="bilinear",
                    choices=["nearest-neighbor", "bilinear"])
    ap.add_argument("--png-compression-level", type=int, default=None,
                    help="0-9 or -1 (default)")
    ap.add_argument("--disable-limits", action="store_true",
                    help="disable all security limits")
    ap.add_argument("--ignore-transformations", action="store_true",
                    help="skip irot/imir/clap")
    ap.add_argument("--codec-threads", type=int, default=None)
    ap.add_argument("--tile-threads", type=int, default=None)
    ap.add_argument("--extract-mime-item", default=None,
                    metavar="CONTENT_TYPE",
                    help="extract the first MIME item with this "
                         "content type to the output path")
    ap.add_argument("--json", action="store_true",
                    help="print primary-image metadata as one JSON "
                         "line (machine interface for bindings/js)")
    ap.add_argument("--rgba-out", default=None, metavar="PATH",
                    help="write the primary image as raw interleaved "
                         "RGBA bytes to PATH (bindings/js backend)")
    add_device_argument(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    from .. import __version__
    from .. import io as hio
    from ..api import HeifContext
    from ..api import decoding as dec_api
    from ..color import ColorConversionOptions, convert_image
    from ..core.limits import SecurityLimits
    from ..image.pixel_image import Channel, Colorspace, Chroma
    from ..items.item import DecodingOptions

    if args.version:
        print(f"heif-dec (libheif_tpu_torch {__version__})")
        return 0
    if args.list_decoders:
        for fmt, name in dec_api.heif_get_decoder_descriptors():
            print(f"{fmt:8s} {name}")
        return 0
    if not args.input:
        print("error: no input file", file=sys.stderr)
        return 1

    out = args.output or os.path.splitext(args.input)[0] + ".png"
    ext = os.path.splitext(out)[1].lower()

    limits = SecurityLimits.disabled() if args.disable_limits else None
    ctx = HeifContext.read_from_file(args.input, limits=limits,
                                     device=args.device)

    options = DecodingOptions()
    options.strict_decoding = args.strict
    options.decoder_id = args.decoder
    options.ignore_transformations = args.ignore_transformations

    if args.rgba_out or args.json:
        import json as _json
        img = ctx.decode_image(ctx.primary_item_id,
                               colorspace=Colorspace.RGB,
                               chroma=Chroma.InterleavedRGBA,
                               options=options)
        if args.rgba_out:
            data = np.ascontiguousarray(img.np_plane(Channel.Interleaved))
            with open(args.rgba_out, "wb") as f:
                f.write(data.astype(np.uint8).tobytes())
        if args.json:
            print(_json.dumps({"width": img.width, "height": img.height,
                               "channels": 4}))
        return 0

    def log(msg):
        if not args.quiet:
            print(msg)

    def fname(base, suffix):
        stem, e = os.path.splitext(base)
        name = f"{stem}{suffix}{e}"
        if args.no_colons:
            name = name.replace(":", "_")
        return name

    if args.extract_mime_item:
        for iid in ctx.file.item_ids:
            infe = ctx.file.get_infe(iid)
            if infe.item_type == "mime" and \
                    infe.content_type == args.extract_mime_item:
                with open(out, "wb") as f:
                    f.write(ctx.file.get_item_data(iid))
                log(f"wrote {out}")
                return 0
        print(f"no MIME item with content type "
              f"{args.extract_mime_item!r}", file=sys.stderr)
        return 1

    def save_one(img, path):
        conv = ColorConversionOptions(
            chroma_upsampling=args.chroma_upsampling)

        def to_rgb(i):
            if i.colorspace == Colorspace.RGB:
                return i
            return convert_image(i, Colorspace.RGB, Chroma.C444,
                                 options=conv, device=ctx.device)

        if ext in (".jpg", ".jpeg"):
            src = img
            if not img.has_channel(Channel.Y):
                src = ctx._convert_output(img, Colorspace.YCbCr,
                                          Chroma.C420, None)
            hio.write_jpeg_file(src, path, quality=args.quality or 90)
            return
        if ext in (".tif", ".tiff"):
            hio.write_tiff_file(to_rgb(img), path)
            return
        if ext == ".webp":
            hio.write_webp_file(to_rgb(img), path,
                                quality=args.quality or 90)
            return
        if ext == ".y4m":
            y = img.plane(Channel.Y)
            u = img.plane(Channel.Cb)
            v = img.plane(Channel.Cr)
            with open(path, "wb") as f:
                f.write(hio.write_y4m([(y, u, v)]))
            return
        arr = rgb_array(to_rgb(img))
        if ext == ".png":
            data = hio.write_png(arr)
        else:
            data = hio.write_ppm(arr)
        with open(path, "wb") as f:
            f.write(data)

    def write_metadata(iid, path):
        if args.with_exif:
            exif = ctx.get_exif(iid)
            if exif:
                if args.skip_exif_offset and len(exif) >= 4:
                    exif = exif[4:]
                p = os.path.splitext(path)[0] + ".exif"
                with open(p, "wb") as f:
                    f.write(exif)
                log(f"wrote {p}")
        if args.with_xmp:
            xmp = ctx.get_xmp(iid)
            if xmp:
                p = os.path.splitext(path)[0] + ".xmp"
                with open(p, "wb") as f:
                    f.write(xmp)
                log(f"wrote {p}")

    def write_aux(iid, path):
        if not args.with_aux:
            return
        item = ctx.get_item(iid)
        aux_items = []
        if getattr(item, "alpha_item", None) is not None:
            aux_items.append(("alpha", item.alpha_item))
        if getattr(item, "depth_item", None) is not None:
            aux_items.append(("depth", item.depth_item))
        for aux in getattr(item, "aux_items", []):
            aux_items.append((getattr(aux, "aux_type", "aux")
                              .split(":")[-1], aux))
        for kind, aux in aux_items:
            aimg = ctx.decode_image(aux.item_id)
            p = fname(path, f"-{kind}")
            save_one(aimg, p)
            log(f"wrote {p}")

    # ---- sequence mode --------------------------------------------------
    if args.sequence:
        if not ctx.tracks:
            print("no sequence track in file", file=sys.stderr)
            return 1
        t = ctx.tracks[0]
        if ext == ".y4m":
            frames = []
            while True:
                img = t.decode_next_image()
                if img is None:
                    break
                if not img.has_channel(Channel.Y):
                    img = ctx._convert_output(img, Colorspace.YCbCr,
                                              Chroma.C420, None)
                frames.append((img.plane(Channel.Y),
                               img.plane(Channel.Cb),
                               img.plane(Channel.Cr)))
            with open(out, "wb") as f:
                f.write(hio.write_y4m(frames))
            log(f"wrote {out} ({len(frames)} frames)")
        else:
            n = 0
            while True:
                img = t.decode_next_image()
                if img is None:
                    break
                p = fname(out, f"-{n:04d}")
                save_one(img, p)
                log(f"wrote {p}")
                n += 1
        return 0

    # ---- image mode -----------------------------------------------------
    if args.all:
        ids = ctx.top_level_image_ids()
    else:
        try:
            ids = [ctx.primary_item_id] \
                if ctx.primary_item_id in ctx.items else []
        except Exception:   # noqa: BLE001  sequence-only file
            ids = []

    for n, iid in enumerate(ids):
        base = out if len(ids) == 1 else fname(out, f"-{n}")
        if args.tiles:
            tiling = ctx.get_image_tiling(iid)
            for ty in range(tiling.num_rows):
                for tx in range(tiling.num_columns):
                    timg = ctx.decode_tile(iid, tx, ty, options=options)
                    p = fname(base, f"-tile-{ty}-{tx}")
                    save_one(timg, p)
                    log(f"wrote {p}")
        else:
            img = ctx.decode_image(iid, options=options)
            save_one(img, base)
            log(f"wrote {base}")
        write_metadata(iid, base)
        write_aux(iid, base)

    if not ids and ctx.tracks:
        print("file contains only a sequence; use --sequence",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
